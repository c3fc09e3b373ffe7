"""The paper's applications as sharded MergePlan programs, on the stacked
executor (every shard on one device) or on a mesh of processes, one a
shard (``spmd=``: ``sharded.mesh_spmd``).

BFS (MIN merge), PageRank (ADD merge with deferred commits across
supersteps), and k-means (a defer/overlap client) — each a scatter phase
for the executor's shards at once (the CUDA ``cscatter`` kernel on the
card, its plain version on the CPU) followed by a cross-shard merge through
the hierarchical engine. ``sharded.run_app`` runs one against its
reference.
"""

from repro_torch.apps.common import default_plan, scatter  # noqa: F401
from repro_torch.apps.bfs import (  # noqa: F401
    bfs_reference, bfs_superstep, run_bfs)
from repro_torch.apps.pagerank import (  # noqa: F401
    pagerank_reference, pagerank_superstep, run_pagerank)
from repro_torch.apps.kmeans import (  # noqa: F401
    kmeans_reference, kmeans_step, run_kmeans)
