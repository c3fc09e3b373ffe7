"""The merge engine on the stacked layout: merge functions, the MergePlan
IR, the defer schedule and the CCache cascade."""
