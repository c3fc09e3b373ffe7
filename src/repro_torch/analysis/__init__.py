"""Static commutativity & collective-placement verifier for MergePlan
programs, on the port's stacked executor.

The twin of the JAX package's ``repro/analysis``. Layer 1 checks programs
run on stacked example tensors: merge-fn trait certification (randomized
algebraic probes + the aten ops ``apply`` runs that ``combine`` does not)
and privatization checks (collectives or settled/pending taint escaping a
non-commit region). Layer 2 checks a tick's recorded collectives against
the ``ccache`` manifest and the wire cost model, isolates ranks on the
device, and watches that no donated state is copied whole (the reference
reads these off compiled HLO, which the port does not have).

Run the full sweep with ``python -m repro_torch.analysis [--device cpu]``
(or ``scripts/lint_plans_torch.py``); ``--fixtures`` runs the
seeded-violation canaries.
"""

from repro_torch.analysis.diagnostics import CATALOG, Diagnostic, Report
from repro_torch.analysis.durability import (check_checkpoint_coverage,
                                             check_step_durability)
from repro_torch.analysis.placement import (check_commit_walk,
                                            check_donation,
                                            check_noncommit_record,
                                            check_noncommit_walk,
                                            check_rank_isolation,
                                            check_walk_bytes, walk_of)
from repro_torch.analysis.trace import (CollectiveRecorder, audit_plan,
                                        audit_stages, check_kv_tick_taint,
                                        check_noncommit_region, out_deps,
                                        record)
from repro_torch.analysis.traits import certify_merge_fn

__all__ = [
    "CATALOG", "Diagnostic", "Report",
    "certify_merge_fn",
    "check_checkpoint_coverage", "check_step_durability",
    "CollectiveRecorder", "record", "out_deps",
    "audit_plan", "audit_stages",
    "check_noncommit_region", "check_kv_tick_taint",
    "walk_of", "check_noncommit_record", "check_noncommit_walk",
    "check_commit_walk", "check_walk_bytes", "check_rank_isolation",
    "check_donation",
]
