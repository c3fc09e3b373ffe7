"""PageRank as a sharded ADD-merge program with deferred supersteps.

Each superstep of the power iteration scatters ``alpha * r[src] / deg[src]``
along every edge (the privatize-and-merge phase — ``cscatter`` with the
additive merge, one call for all shards into an ``[S, n, 1]`` table), then
merges the partial contribution tables across shards:

    r' = (1 - alpha) / n  +  merge_all_shards(scattered contributions)

With the plan's top level ``:defer``-ed, the expensive cross-pod exchange
runs only every K supersteps. Between commits each pod iterates on its
eager-scope aggregate plus a *stale remote term* R captured at the last
commit — extracting R from a settled aggregate is ``settled - own``, which
is where the ADD algebra's ``invertible`` trait earns its keep. The
iteration becomes an asynchronous fixed-point scheme with bounded
staleness; since the PageRank operator is an alpha-contraction, it
converges to the synchronous reference's ranks (within float tolerance) in
more supersteps. Ending the loop on a commit step makes the final view the
fully-merged one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.common import scatter
from repro_torch.core import ccache
from repro_torch.core.merge_functions import ADD
from repro_torch.core.stacked import StackedAxis, StackedSPMD


def pagerank_reference(n: int, src, dst, *, alpha: float = 0.85,
                       iters: int = 60) -> np.ndarray:
    """Single-device synchronous power iteration (float64 for a tight gold)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    ok = (src >= 0) & (dst >= 0)
    deg = np.zeros((n,), np.float64)
    np.add.at(deg, src[ok], 1.0)
    r = np.full((n,), 1.0 / n, np.float64)
    base = (1.0 - alpha) / n
    for _ in range(iters):
        contrib = np.zeros((n,), np.float64)
        w = alpha * r[src[ok]] / np.maximum(deg[src[ok]], 1.0)
        np.add.at(contrib, dst[ok], w)
        r = base + contrib
    return r


def _out_degree(n: int, src_ids: torch.Tensor, axis: StackedAxis,
                plan) -> torch.Tensor:
    """Every vertex's out-degree ``[s, n]`` f32 (``s`` local rows), merged
    over all shards."""
    ones = (src_ids >= 0).to(torch.float32)
    table = torch.zeros((src_ids.shape[0], n, 1), dtype=torch.float32,
                        device=src_ids.device)
    local = scatter(table, src_ids, ones[..., None], kind="add")[..., 0]
    return ccache.hierarchical_merge(local, axis, ADD, plan)


def pagerank_superstep(r: torch.Tensor, src_ids: torch.Tensor,
                       dst_ids: torch.Tensor, deg: torch.Tensor, *,
                       alpha: float) -> torch.Tensor:
    """Every shard's scatter phase: push alpha * r[src]/deg[src] to dst.

    Returns each local shard's partial contribution table ``[s, n]``."""
    s, n = r.shape
    ok = src_ids >= 0
    safe = torch.where(ok, src_ids, 0).long()
    w = alpha * r.gather(1, safe) / torch.clamp(deg.gather(1, safe), min=1.0)
    vals = torch.where(ok, w, 0.0).to(torch.float32)
    table = torch.zeros((s, n, 1), dtype=torch.float32, device=r.device)
    out = scatter(table, torch.where(ok, dst_ids, -1), vals[..., None],
                  kind="add")
    return out[..., 0]


def run_pagerank(n: int, src_sh: torch.Tensor, dst_sh: torch.Tensor, plan,
                 *, alpha: float = 0.85, supersteps: int = 60,
                 defer_k: int | None = None, spmd=None) -> torch.Tensor:
    """Drive sharded PageRank supersteps on the executor ``spmd`` (the
    stacked one on the edges' device by default, or a mesh executor; every
    process is handed all of ``src_sh``/``dst_sh [S, E]`` and takes its
    rows); returns shard-major ranks ``[S, n]`` f32, gathered on a mesh.

    ``defer_k`` defers the plan's ``:defer`` levels to every K-th superstep
    (asynchronous iteration with a stale remote term between commits). The
    loop is extended to end on a commit step so the returned ranks are the
    fully-merged view. The ranks and the remote term are donated to each
    superstep.
    """
    spmd = spmd or StackedSPMD(src_sh.shape[0], src_sh.device)
    axis = spmd.axis
    ADD.check_deferrable("run_pagerank")  # trivially true; documents intent
    n_def = len(ccache.deferred_stages_of(plan, axis.size, merge_fn=ADD))
    if defer_k is not None and n_def == 0:
        raise ValueError("defer_k given but the plan has no deferred levels")
    src_sh, dst_sh = (torch.as_tensor(spmd.local(x), device=spmd.device)
                      for x in (src_sh, dst_sh))

    deg = spmd(lambda src_ids: _out_degree(n, src_ids, axis, plan), src_sh)
    base = (1.0 - alpha) / n
    r = torch.full((spmd.stack, n), 1.0 / n, dtype=torch.float32,
                   device=spmd.device)

    if defer_k is None:
        def step(r, src_ids, dst_ids, deg):
            contrib = pagerank_superstep(r, src_ids, dst_ids, deg,
                                         alpha=alpha)
            return base + ccache.hierarchical_merge(contrib, axis, ADD, plan)

        for _ in range(supersteps):
            r = spmd(step, r, src_sh, dst_sh, deg, donate=(0,))
        return spmd.gather(r)

    # Deferred supersteps: r_view = base + (eager-scope aggregate u) + (stale
    # remote term R). At a commit, the full-scope aggregate is settled and
    # R is re-extracted as full - u (ADD is invertible).
    total = ((supersteps + defer_k - 1) // defer_k) * defer_k

    def make_step(commit: bool):
        def step(r, remote, src_ids, dst_ids, deg):
            contrib = pagerank_superstep(r, src_ids, dst_ids, deg,
                                         alpha=alpha)
            u = ccache.partial_merge(contrib, axis, ADD, plan)
            if commit:
                full = ccache.settle_deferred(u, axis, ADD, plan)
                return base + full, full - u
            return base + u + remote, remote
        return step

    steps = {False: make_step(False), True: make_step(True)}
    remote = torch.zeros((spmd.stack, n), dtype=torch.float32,
                         device=spmd.device)
    for t in range(1, total + 1):
        r, remote = spmd(steps[t % defer_k == 0], r, remote, src_sh,
                         dst_sh, deg, donate=(0, 1))
    return spmd.gather(r)
