"""Minibatch k-means as a defer/overlap client of the merge engine.

The update stream is the classic commutative pair: per minibatch each shard
scatters its points into per-centroid ``(sum, count)`` accumulators (the
``cscatter`` additive merge over the assignment ids; on the stacked layout
one call for all shards per table), and the centroid move ``c = sum /
count`` only needs the *aggregate* — so commits can ride the deferred
cascade (accumulate K minibatches, settle the cross-pod exchange once per
cycle) or the overlapped pipeline (the commit's exchange is launched at the
cycle boundary and lands one step later, so shards assign the next
minibatch against one-step-stale centroids — the standard asynchronous
minibatch trade).

The single-device reference runs the *same* commit schedule, so sharding +
the hierarchical/deferred/overlapped merge machinery must reproduce it to
float tolerance. The assignment's product stays in f32 (``torch.matmul``,
no TF32), or the assignments drift from the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.common import scatter
from repro_torch.core import ccache
from repro_torch.core.merge_functions import ADD
from repro_torch.core.stacked import StackedSPMD


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids ``[S, B]`` int32 for points ``[S, B, d]`` given
    centroids ``[S, k, d]``."""
    d2 = ((points * points).sum(-1)[..., None]
          - 2.0 * points @ centroids.transpose(-1, -2)
          + (centroids * centroids).sum(-1)[..., None, :])
    return torch.argmin(d2, dim=-1).to(torch.int32)


def kmeans_step(points: torch.Tensor,
                centroids: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every shard's minibatch: assign + scatter into (sum, count) tables,
    ``sum [S, k, d]`` and ``count [S, k, 1]``."""
    s, k, d = centroids.shape
    ids = _assign(points, centroids)
    sums = scatter(torch.zeros((s, k, d), dtype=torch.float32,
                               device=points.device), ids,
                   points.to(torch.float32).contiguous(), kind="add")
    ones = torch.ones((s, points.shape[1], 1), dtype=torch.float32,
                      device=points.device)
    counts = scatter(torch.zeros((s, k, 1), dtype=torch.float32,
                                 device=points.device), ids, ones, kind="add")
    return {"sum": sums, "count": counts}


def _move(centroids: torch.Tensor, settled: dict) -> torch.Tensor:
    cnt = settled["count"][..., 0]
    moved = settled["sum"] / torch.clamp(cnt, min=1.0)[..., None]
    return torch.where((cnt > 0)[..., None], moved, centroids)


def kmeans_reference(points_by_step, centroids0, *, commit_k: int,
                     overlap: bool = False) -> np.ndarray:
    """Single-device mirror of the sharded commit schedule.

    ``points_by_step`` is [T, N, d] (all shards' minibatches concatenated
    per step). Accumulates ``commit_k`` steps per commit; with ``overlap``
    each commit is applied one step late (after the next step's
    assignment), with a final flush.
    """
    pts = np.asarray(points_by_step, np.float32)
    t_total, _, d = pts.shape
    c = np.asarray(centroids0, np.float32).copy()
    k = c.shape[0]
    acc_s = np.zeros((k, d), np.float64)
    acc_n = np.zeros((k,), np.float64)
    inflight = None
    for t in range(1, t_total + 1):
        p = pts[t - 1]
        d2 = ((p * p).sum(1)[:, None] - 2.0 * p @ c.T
              + (c * c).sum(1)[None, :])
        ids = np.argmin(d2, axis=1)
        np.add.at(acc_s, ids, p.astype(np.float64))
        np.add.at(acc_n, ids, 1.0)
        if overlap and inflight is not None:
            s, cnt = inflight
            c = np.where((cnt > 0)[:, None],
                         s / np.maximum(cnt, 1.0)[:, None], c)
            inflight = None
        if t % commit_k == 0:
            if overlap:
                inflight = (acc_s.copy(), acc_n.copy())
            else:
                c = np.where((acc_n > 0)[:, None],
                             acc_s / np.maximum(acc_n, 1.0)[:, None], c)
            acc_s[:] = 0.0
            acc_n[:] = 0.0
    if overlap and inflight is not None:
        s, cnt = inflight
        c = np.where((cnt > 0)[:, None],
                     s / np.maximum(cnt, 1.0)[:, None], c)
    return c.astype(np.float32)


def run_kmeans(points_sh: torch.Tensor, centroids0: torch.Tensor, plan, *,
               commit_k: int, overlap: bool = False,
               spmd=None) -> torch.Tensor:
    """Drive sharded minibatch k-means on the executor ``spmd`` (the
    stacked one on the points' device by default, or a mesh executor);
    returns shard-major centroids ``[S, k, d]``, gathered on a mesh.

    ``points_sh`` is ``[S, T, B, d]`` (per-shard minibatch stream; every
    process is handed all of it and takes its rows). The
    commit schedule routes through ``defer_cascade`` (or ``overlap_cascade``
    with ``overlap`` — commits land one step stale, the final launch
    flushed via ``settle_inflight``). The plan must carry the ``:defer``
    levels the schedule commits. The centroids, the in-flight aggregate and
    the pendings are donated to each step.
    """
    n_shards, t_total, _, d = points_sh.shape
    k = centroids0.shape[0]
    spmd = spmd or StackedSPMD(n_shards, points_sh.device)
    axis, rows, device = spmd.axis, spmd.stack, spmd.device
    points_sh = torch.as_tensor(spmd.local(points_sh), device=device)
    n_def = len(ccache.deferred_stages_of(plan, n_shards, merge_fn=ADD))
    if n_def == 0:
        raise ValueError("run_kmeans needs a plan with :defer levels (the "
                         "commit schedule rides the deferred cascade)")
    if t_total % commit_k != 0:
        raise ValueError(f"steps ({t_total}) must be a multiple of "
                         f"commit_k ({commit_k})")

    def zeros() -> dict[str, torch.Tensor]:
        return {"sum": torch.zeros((rows, k, d), dtype=torch.float32,
                                   device=device),
                "count": torch.zeros((rows, k, 1), dtype=torch.float32,
                                     device=device)}

    def make_step(due: int, land: bool):
        def step(points, centroids, inflight, *pends):
            delta = kmeans_step(points, centroids)
            if overlap:
                new_p, new_if, landed = ccache.overlap_cascade(
                    delta, list(pends), inflight, due, land, axis, ADD, plan)
            else:
                new_p, landed = ccache.defer_cascade(
                    delta, list(pends), due, axis, ADD, plan)
                new_if = inflight
            if landed is not None:
                centroids = _move(centroids, landed)
            return (centroids, new_if) + tuple(new_p)
        return step

    steps = {}
    centroids = centroids0.to(device=device, dtype=torch.float32
                              ).expand(rows, k, d).clone()
    inflight = zeros()
    pendings = tuple(zeros() for _ in range(n_def))
    for t in range(1, t_total + 1):
        due = n_def if t % commit_k == 0 else 0
        land = overlap and t > 1 and (t - 1) % commit_k == 0
        if (due, land) not in steps:
            steps[due, land] = make_step(due, land)
        out = spmd(steps[due, land], points_sh[:, t - 1], centroids,
                   inflight, *pendings, donate=tuple(range(1, 3 + n_def)))
        centroids, inflight = out[0], out[1]
        pendings = tuple(out[2:])
    if overlap:
        def flush(centroids, inflight):
            landed = ccache.settle_inflight(inflight, axis, ADD, plan)
            return _move(centroids, landed)
        centroids = spmd(flush, centroids, inflight, donate=(0, 1))
    return spmd.gather(centroids)
