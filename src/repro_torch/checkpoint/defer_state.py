"""Durable identity of deferred-commit state: plan and schedule fingerprints.

A store's volatile state is only meaningful relative to the compiled
:class:`~repro_torch.core.merge_plan.MergePlan` and the commit schedule
that produced it, so snapshots record content fingerprints of both. The
digests are the JAX package's (``repro/checkpoint/defer_state.py``): the
same plan and schedule give the same fingerprint in either package.
Checkpoints of a deferred train step record a *durability manifest*
(:func:`defer_manifest`: the fingerprints plus the geometry a host-side
settle needs), and :func:`defer_state_spec` says what ``state["defer"]``
holds. Everything here is host-side metadata.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.defer_schedule import AdaptiveDeferSchedule

PyTree = Any


def _digest(obj: dict) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]


def plan_fingerprint(plan, axis_size: int, merge_name: Optional[str] = None
                     ) -> str:
    """Content fingerprint of a MergePlan *as compiled* for ``axis_size``
    ranks. Two plans with the same fingerprint produce pendings with
    identical replication geometry, so their defer state is exchangeable."""
    desc = {
        "axis_size": int(axis_size),
        "axis_name": str(getattr(plan, "axis_name", "")),
        "lane_parallel": bool(getattr(plan, "lane_parallel", False)),
        "merge": merge_name,
        "levels": [
            [lv.name, int(lv.size), str(lv.transport),
             str(getattr(lv, "combine_mode", "")), bool(lv.compress),
             bool(lv.defer)]
            for lv in plan.levels
        ],
    }
    return _digest(desc)


def schedule_fingerprint(schedule) -> str:
    """Content fingerprint of a commit schedule.

    A fixed ``DeferSchedule`` hashes its intervals; an
    :class:`AdaptiveDeferSchedule` hashes its *envelope* (level names,
    overlap, K bounds) because its solved intervals drift with load — two
    adaptive schedules with the same envelope produce interchangeable state.
    """
    desc = {
        "level_names": list(schedule.level_names),
        "overlap": bool(schedule.overlap),
    }
    if isinstance(schedule, AdaptiveDeferSchedule):
        desc["adaptive"] = [int(schedule.k_min), int(schedule.k_max)]
        desc["max_period"] = int(schedule.max_period)
    else:
        desc["intervals"] = [int(k) for k in schedule.intervals]
    return _digest(desc)


def defer_manifest(plan, schedule, dp: int, merge_fn,
                   strides: Sequence[int], settle_mode: str) -> dict:
    """The durability manifest recorded next to a defer-state checkpoint:
    the plan's and the schedule's fingerprints, the rank count, the commit
    period, the per-deferred-level strides (one representative per
    ``stride`` ranks holds the level's combined value), and how a settled
    cycle reaches the optimizer (``"mean"`` or ``"reapply"``)."""
    return {
        "plan": plan_fingerprint(plan, dp, merge_name=merge_fn.name),
        "schedule": schedule_fingerprint(schedule),
        "dp": int(dp),
        "period": int(schedule.period),
        "level_names": list(schedule.level_names),
        "strides": [int(s) for s in strides],
        "settle_mode": str(settle_mode),
        "overlap": bool(getattr(schedule, "overlap", False)),
        "merge": merge_fn.name,
    }


def defer_state_spec(params_spec: PyTree, n_levels: int, dp: int,
                     overlap: bool, mesh=None,
                     merge_dims: Sequence[str] = ("data",)) -> dict:
    """``state["defer"]`` of a deferred train step as meta tensors (shape
    and dtype, no storage: the counterpart of JAX's ``ShapeDtypeStruct``):
    the step counter, one ``(dp,)``-leading pending per deferred level, and
    the overlap in-flight buffer. It mirrors
    ``DeferredTrainStep.init_defer_state`` (``launch/steps.py``). With a
    ``mesh`` (a step over a process group) each pending is a meta DTensor
    of that global shape, ``Shard(0)`` over ``merge_dims`` (JAX's
    ``P(axis)``), this process holding a ``[1, ...]`` slice."""
    if n_levels < 1:
        raise ValueError(f"n_levels must be >= 1, got {n_levels}")

    def stack(p):
        shape = (dp,) + tuple(p.shape)
        if mesh is None:
            return torch.empty(shape, dtype=p.dtype, device="meta")
        from torch.distributed.tensor import DTensor, Replicate, Shard
        names = list(mesh.mesh_dim_names)
        split = [n for n in merge_dims if n in names]
        local = (dp // max(1, math.prod(mesh.size(names.index(n))
                                        for n in split)),) + shape[1:]
        return DTensor.from_local(
            torch.empty(local, dtype=p.dtype, device="meta"), mesh,
            [Shard(0) if n in split else Replicate() for n in names],
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    def pending_like():
        return pytree.tree_map(stack, params_spec)

    spec = {"t": torch.empty((), dtype=torch.int32, device="meta"),
            "pending": tuple(pending_like() for _ in range(n_levels))}
    if overlap:
        spec["inflight"] = pending_like()
    return spec


def manifests_compatible(saved: Optional[dict], current: Optional[dict]
                         ) -> bool:
    """Whether defer state checkpointed under ``saved`` can be restored
    verbatim into a run described by ``current``: the compiled plan, the
    schedule and the rank count must all be the same."""
    if saved is None or current is None:
        return False
    return (saved.get("plan") == current.get("plan")
            and saved.get("schedule") == current.get("schedule")
            and saved.get("dp") == current.get("dp"))
