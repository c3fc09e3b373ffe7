"""Shared plumbing of the sharded apps: the per-shard scatter phase, the
default merge-plan geometry and the edge partition.

Every app runs a *scatter phase* (privatize-and-merge into a local table —
the ``cscatter`` kernel) and a *cross-shard merge phase* (the hierarchical
engine over a :class:`~repro_torch.core.merge_plan.MergePlan`). On the
stacked layout one scatter call covers every shard: ``table [S, R, D]``,
``ids [S, N]``, ``vals [S, N, D]`` is one kernel launch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.merge_plan import MergePlan
from repro_torch.kernels.ops import commutative_scatter


def scatter(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor, *,
            kind: str) -> torch.Tensor:
    """Fold ``vals`` into ``table`` rows by id, in place, and return it:
    the CUDA kernel on the card, its plain version on the CPU.
    Out-of-range/negative ids are ignored (the padding convention)."""
    return commutative_scatter(table, ids, vals, kind=kind)


def default_plan(n_shards: int, defer_top: bool = False,
                 lane_parallel: bool = True) -> MergePlan:
    """A chip/host/pod factorization of an ``n_shards`` merge axis.

    8 -> chip:2,host:2,pod:2 ; 16 -> chip:4,host:2,pod:2 ; odd or small
    counts degrade to fewer levels. ``defer_top`` marks the pod level
    ``:defer`` (commits ride a schedule instead of every superstep).
    """
    if n_shards < 2:
        return MergePlan.parse(f"chip:{max(n_shards, 1)}")
    if n_shards % 4 == 0 and n_shards >= 8:
        chip, host, pod = n_shards // 4, 2, 2
    elif n_shards % 2 == 0 and n_shards >= 4:
        chip, host, pod = n_shards // 2, 1, 2
    else:
        chip, host, pod = n_shards, 1, 1
    spec = f"chip:{chip},host:{host},pod:{pod}"
    if defer_top and pod > 1:
        spec += ":defer"
    return MergePlan.parse(spec, lane_parallel=lane_parallel)


def shard_edges(src, dst, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Partition an edge list across shards, padding with id -1.

    Returns ``(src_sh, dst_sh)``, int32 numpy arrays of shape
    ``[n_shards, ceil(E / n_shards)]``; padded entries carry -1 and are
    dropped by the scatter phase.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = src.shape[0]
    per = -(-e // n_shards)
    pad = per * n_shards - e
    src_p = np.concatenate([src, np.full((pad,), -1, np.int32)])
    dst_p = np.concatenate([dst, np.full((pad,), -1, np.int32)])
    return src_p.reshape(n_shards, per), dst_p.reshape(n_shards, per)
