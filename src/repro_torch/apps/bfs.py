"""BFS as a sharded MIN-merge MergePlan program (paper §6.1's bfs).

Frontier expansion is the MIN merge: every edge (u, v) proposes the
candidate distance ``dist[u] + 1`` for ``v``, all proposals to a vertex
commute under ``min``, and a superstep is one privatize-and-merge round:

    every shard  cand = cscatter(INF-table, dst, dist[src] + 1, kind=min)
    cross shard  merged = hierarchical_merge(cand, plan, MIN)
    everywhere   dist = min(dist, merged)

On the stacked layout ``dist`` is ``[S, n]``, the edges ``[S, E/S]``, and a
superstep's scatter is one ``cscatter`` call for all shards, into an
``[S, n, 1]`` table; on a mesh executor each process holds its ``[1, ...]``
rows and scatters into its own ``[1, n, 1]`` table. The MIN algebra is
idempotent, so the top plan level may be ``:defer``-ed (commits every K
supersteps; a deferred commit settles by *re-apply* — re-joining
already-seen candidates is harmless). Distances
converge to the same fixpoint in more supersteps, bitwise equal to the
single-device reference (integer distances, lattice join).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.common import scatter
from repro_torch.core import ccache
from repro_torch.core.merge_functions import MIN
from repro_torch.core.stacked import StackedSPMD

INF = torch.iinfo(torch.int32).max


def bfs_reference(n: int, src, dst, source: int) -> np.ndarray:
    """Single-device BFS distances (int32; unreachable = INF)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    dist = np.full((n,), INF, np.int64)
    dist[source] = 0
    for _ in range(n):
        ok = (src >= 0) & (dst >= 0) & (dist[np.maximum(src, 0)] < INF)
        cand = np.where(ok, dist[np.maximum(src, 0)] + 1, INF)
        nxt = dist.copy()
        np.minimum.at(nxt, np.maximum(dst, 0), np.where(ok, cand, INF))
        if np.array_equal(nxt, dist):
            break
        dist = nxt
    return dist.astype(np.int32)


def bfs_superstep(dist: torch.Tensor, src_ids: torch.Tensor,
                  dst_ids: torch.Tensor) -> torch.Tensor:
    """Every local shard's scatter phase: propose dist[src]+1 to every dst.

    ``dist [s, n]`` int32, ``src_ids``/``dst_ids [s, E]`` int32 (``s`` the
    executor's local rows). Returns each shard's candidate table ``[s, n]``
    (MIN identity where no edge lands). Padded edges (id -1) are dropped by
    the scatter."""
    s, n = dist.shape
    ok = src_ids >= 0
    d_src = dist.gather(1, torch.where(ok, src_ids, 0).long())
    reachable = ok & (d_src < INF)
    vals = torch.where(reachable, d_src + 1, INF).to(torch.int32)
    ids = torch.where(reachable, dst_ids, -1)
    table = torch.full((s, n, 1), INF, dtype=torch.int32, device=dist.device)
    return scatter(table, ids, vals[..., None], kind="min")[..., 0]


def run_bfs(dist0: torch.Tensor, src_sh: torch.Tensor, dst_sh: torch.Tensor,
            plan, *, supersteps: int, defer_k: int | None = None,
            spmd=None) -> torch.Tensor:
    """Drive BFS supersteps over sharded edges on the executor ``spmd``
    (the stacked one on the edges' device by default; a mesh executor,
    one process a shard, as JAX's apps take ``spmd``).

    ``dist0 [S, n]`` and ``src_sh``/``dst_sh [S, E]`` are shard-major,
    int32 (tensors or numpy arrays), every process handed all of them
    (each takes its rows); each
    superstep runs under the executor with the distances (and the pending)
    donated. ``defer_k`` routes the plan's deferred levels through a
    pending committed every ``defer_k`` supersteps; the trailing partial
    cycle is flushed after the loop. Returns the final shard-major
    distances ``[S, n]``, gathered on a mesh (``dist0`` is left as it was).
    """
    spmd = spmd or StackedSPMD(dist0.shape[0], dist0.device)
    axis = spmd.axis
    n_def = len(ccache.deferred_stages_of(plan, axis.size, merge_fn=MIN))
    if defer_k is not None and n_def == 0:
        raise ValueError("defer_k given but the plan has no deferred levels")
    dist, src_sh, dst_sh = (torch.as_tensor(spmd.local(x), device=spmd.device)
                            for x in (dist0, src_sh, dst_sh))
    dist = dist.clone()

    if defer_k is None:
        def step(dist, src_ids, dst_ids):
            cand = bfs_superstep(dist, src_ids, dst_ids)
            merged = ccache.hierarchical_merge(cand, axis, MIN, plan)
            return torch.minimum(dist, merged, out=dist)

        for _ in range(supersteps):
            dist = spmd(step, dist, src_sh, dst_sh, donate=(0,))
        return spmd.gather(dist)

    # Idempotent merge-on-evict: each superstep's eager-scope join is
    # consumed at once (the frontier keeps advancing within the pod) AND
    # folded into a pod-scope pending; every K supersteps the pending
    # settles through the deferred stages and is *re-applied* — re-joining
    # contributions the pod already saw is harmless for a lattice join,
    # which is what the ``idempotent`` trait licenses.
    def make_step(due: bool):
        def step(dist, pending, src_ids, dst_ids):
            cand = bfs_superstep(dist, src_ids, dst_ids)
            u = ccache.partial_merge(cand, axis, MIN, plan)
            torch.minimum(dist, u, out=dist)
            torch.minimum(pending, u, out=pending)
            if due:
                settled = ccache.settle_deferred(pending, axis, MIN, plan)
                torch.minimum(dist, settled, out=dist)
                pending.fill_(INF)
            return dist, pending
        return step

    steps = {False: make_step(False), True: make_step(True)}
    pending = torch.full_like(dist, INF)
    for t in range(1, supersteps + 1):
        dist, pending = spmd(steps[t % defer_k == 0], dist, pending,
                             src_sh, dst_sh, donate=(0, 1))
    if supersteps % defer_k != 0:
        def flush(dist, pending):
            settled = ccache.settle_deferred(pending, axis, MIN, plan)
            return torch.minimum(dist, settled, out=dist)
        dist = spmd(flush, dist, pending, donate=(0, 1))
    return spmd.gather(dist)
