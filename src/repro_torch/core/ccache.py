"""The CCache merge engine on the stacked layout.

The PyTorch counterpart of the JAX package's ``repro/core/ccache.py``: the
MergePlan stage executors and the scheduled merge-on-evict cascade, with
every shard on one device as dim 0 of each tensor and the collectives taken
from a :class:`~repro_torch.core.stacked.StackedAxis` (see ``stacked.py``).
Each function takes and returns stacked tensors (or pytrees of them): where
the reference's per-shard program sees ``x[...]`` with ``axis_name`` bound,
this one sees ``x[S, ...]`` and an ``axis``.

* ``hierarchical_merge`` — N-level all-reduce over a ``MergePlan``: fused
  grouped reduction at the innermost level for add/max/min, representative-
  or lane-parallel ppermute exchanges above it, unit broadcasts.
* ``defer_cascade`` — one step of the scheduled multi-level merge-on-evict
  cascade over a ``DeferSchedule``'s due prefix.
* ``launch_inflight`` / ``settle_inflight`` — the two halves of an
  overlapped full commit; ``settle_deferred`` runs all deferred stages.
* ``StageManifest`` / ``collective_manifest`` / ``program_manifest`` /
  ``overlap_program_manifest`` — the per-stage collective schedule, pure.

Only ``MergePlan`` topologies are taken (the two-level ``MergeTopology``
shorthand, ``tree_merge``, ``partial_merge``, ``overlap_cascade`` and the
``commit_*`` / ``soft_merge`` helpers are not ported yet). A compressing
level needs a codec merge, and none is ported yet: those branches raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core import permutes
from repro_torch.core.merge_functions import MergeFn
from repro_torch.core.merge_plan import (LevelStage, MergePlan, compile_plan,
                                         split_eager_deferred)
from repro_torch.core.stacked import StackedAxis

PyTree = Any

_FUSED_REDUCERS = {"add": "psum", "max": "pmax", "min": "pmin"}


def _no_codec(merge: MergeFn) -> NotImplementedError:
    return NotImplementedError(
        f"merge {merge.name!r}: compressed (encode/decode) exchanges are not "
        f"ported yet")


def _resolve_plan(plan: MergePlan, axis: StackedAxis,
                  compress: bool) -> MergePlan:
    """Validate ``plan`` against the axis. The function-level ``compress``
    flag maps onto the *outermost* executing level, as in the reference."""
    if not isinstance(plan, MergePlan):
        raise TypeError(f"expected a MergePlan, got {type(plan).__name__} "
                        f"(MergeTopology is not ported yet)")
    plan.validate(axis.size)
    if compress and not any(lv.compress for lv in plan.levels):
        idx = max((i for i, lv in enumerate(plan.levels) if lv.size > 1),
                  default=None)
        if idx is not None:
            levels = (plan.levels[:idx]
                      + (dataclasses.replace(plan.levels[idx],
                                             compress=True),)
                      + plan.levels[idx + 1:])
            plan = dataclasses.replace(plan, levels=levels)
    return plan


# -- stage executors --------------------------------------------------------


def _stage_innermost(u: PyTree, axis: StackedAxis, merge: MergeFn,
                     stage: LevelStage, force_tree: bool,
                     use_compress: bool) -> PyTree:
    """stride == 1: every rank combines directly within its aligned block.

    Fixed-op merges take one grouped reduction over dim 0 (the reference's
    grouped ``psum``/``pmax``/``pmin``; bitwise equal for integers, another
    summation order for floats); everything else runs the block-confined
    butterfly (power-of-two fanout) or ring.
    """
    if use_compress:
        raise _no_codec(merge)
    fanout, size = stage.fanout, axis.size
    if (stage.combine_mode == "xla" and not force_tree
            and merge.xla_reduce in _FUSED_REDUCERS):
        return getattr(axis, _FUSED_REDUCERS[merge.xla_reduce])(u, fanout)

    if permutes.is_pow2(fanout):
        step = 1
        while step < fanout:
            # Steps below the block size keep i ^ step inside the aligned
            # block, so the flat butterfly perm doubles as the confined one.
            other = axis.ppermute(u, permutes.butterfly_perms(size, step))
            u = merge.tree_combine(u, other)
            step <<= 1
        return u

    # Any block size: circulate contributions around the block ring, folding
    # as they pass — fanout-1 rounds, each rank sees every member once.
    perm = permutes.ring_perm(size, fanout)
    recv = acc = u
    for _ in range(fanout - 1):
        recv = axis.ppermute(recv, perm)
        acc = merge.tree_combine(acc, recv)
    return acc


def _broadcast_within_units(u: PyTree, axis: StackedAxis, stride: int,
                            lane: torch.Tensor) -> PyTree:
    """Binomial broadcast of lane 0's value over each aligned
    ``stride``-sized unit — ceil(log2 stride) swap rounds."""
    for k, perm in permutes.binomial_broadcast_perms(axis.size, stride):
        recv = axis.ppermute(u, perm)
        u = axis.where(lane < k, u, recv)
    return u


def _stage_rep(u: PyTree, axis: StackedAxis, merge: MergeFn,
               stage: LevelStage, rank: torch.Tensor,
               use_compress: bool) -> PyTree:
    """Representative-only cross-unit exchange + broadcast down the unit.

    Unit leaders (rank % stride == 0) carry their unit's aggregate through
    the butterfly/ring across sibling units; non-representatives ride
    identity self-pairs.
    """
    if use_compress:
        raise _no_codec(merge)
    stride, fanout = stage.stride, stage.fanout
    lane = rank % stride
    is_rep = lane == 0
    perms = permutes.rep_exchange_perms(axis.size, stride, fanout)
    if permutes.is_pow2(fanout):
        for perm in perms:
            other = axis.ppermute(u, perm)
            u = axis.where(is_rep, merge.tree_combine(u, other), u)
    else:
        recv = u
        for _ in range(fanout - 1):
            recv = axis.ppermute(recv, perms[0])
            u = axis.where(is_rep, merge.tree_combine(u, recv), u)
    return _broadcast_within_units(u, axis, stride, lane)


def _atom_rows(x: torch.Tensor, atom: int) -> torch.Tensor:
    """A stacked leaf as ``[S, rows]`` or ``[S, rows, atom]``."""
    per_shard = x[0].numel() if x.dim() > 1 else 1
    if atom > 1 and per_shard % atom == 0:
        return x.reshape(x.shape[0], -1, atom)
    return x.reshape(x.shape[0], -1)


def _lane_chunk(x: torch.Tensor, stride: int, lane: torch.Tensor,
                atom: int) -> torch.Tensor:
    """Each rank's 1/stride slice of its leaf (zero-padded to divide).

    The payload flattens to rows of ``atom`` trailing elements — the unit a
    structure-sensitive combine treats as one value — and rows are dealt in
    contiguous blocks across the unit's lanes.
    """
    flat = _atom_rows(x, atom)
    n = flat.shape[1]
    c = -(-n // stride)
    if stride * c != n:
        pad = [0, 0] * (flat.dim() - 2) + [0, stride * c - n]
        flat = F.pad(flat, pad)
    blocks = flat.reshape((flat.shape[0], stride, c) + tuple(flat.shape[2:]))
    return blocks[torch.arange(flat.shape[0], device=x.device), lane]


def _lane_all_gather(chunks: list[torch.Tensor], axis: StackedAxis,
                     stride: int, lane: torch.Tensor) -> list[torch.Tensor]:
    """Reassemble each unit's ``(stride, chunk)`` buffer from per-lane
    chunks: recursive doubling for power-of-two units, ring otherwise. All
    traffic stays inside the unit."""
    size = axis.size
    ranks = axis.index()
    bufs = []
    for ch in chunks:
        b = ch.new_zeros((size, stride) + tuple(ch.shape[1:]))
        b[ranks, lane] = ch
        bufs.append(b)
    if permutes.is_pow2(stride):
        seg = 1
        for perm in permutes.lane_gather_doubling_perms(size, stride):
            start = (lane // seg) * seg
            rows = start[:, None] + torch.arange(seg, device=lane.device)
            segs = [b[ranks[:, None], rows] for b in bufs]
            other = axis.ppermute(segs, perm)
            theirs = (start ^ seg)[:, None] + torch.arange(seg,
                                                          device=lane.device)
            for b, o in zip(bufs, other):
                b[ranks[:, None], theirs] = o
            seg <<= 1
        return bufs
    perm = permutes.ring_perm(size, stride)
    cur = chunks
    for s in range(1, stride):
        cur = axis.ppermute(cur, perm)
        src = (lane - s) % stride
        for b, ch in zip(bufs, cur):
            b[ranks, src] = ch
    return bufs


def _stage_lane(u: PyTree, axis: StackedAxis, merge: MergeFn,
                stage: LevelStage, rank: torch.Tensor,
                use_compress: bool) -> PyTree:
    """Lane-parallel cross-unit exchange: the representative role is sharded
    over the unit's lanes. Each lane carries a 1/stride chunk of the payload
    through the butterfly/ring across sibling units (same-lane pairing),
    then the unit all-gathers the combined chunks."""
    if use_compress:
        raise _no_codec(merge)
    stride, fanout = stage.stride, stage.fanout
    lane = rank % stride
    leaves, treedef = pytree.tree_flatten(u)
    chunks = [_lane_chunk(x, stride, lane, merge.wire_atom) for x in leaves]
    perms = permutes.lane_exchange_perms(axis.size, stride, fanout)
    if permutes.is_pow2(fanout):
        for perm in perms:
            other = axis.ppermute(chunks, perm)
            chunks = [merge.combine(a, b) for a, b in zip(chunks, other)]
    else:
        recv = chunks
        for _ in range(fanout - 1):
            recv = axis.ppermute(recv, perms[0])
            chunks = [merge.combine(a, b) for a, b in zip(chunks, recv)]

    bufs = _lane_all_gather(chunks, axis, stride, lane)
    out = []
    for x, b in zip(leaves, bufs):
        full = b.reshape((b.shape[0], b.shape[1] * b.shape[2])
                         + tuple(b.shape[3:]))
        rows = _atom_rows(x, merge.wire_atom).shape[1]
        out.append(full[:, :rows].reshape(x.shape))
    return pytree.tree_unflatten(out, treedef)


def _run_stages(update: PyTree, axis: StackedAxis, merge: MergeFn,
                stages: list[LevelStage], force_tree: bool) -> PyTree:
    """Execute compiled stages in order. Invariant: entering stage i every
    rank holds its stride-sized unit's combination (replicated within the
    unit); leaving it, its block's."""
    u = update
    rank = axis.index()
    for st in stages:
        use_compress = st.compress and merge.encode is not None
        if st.stride == 1:
            u = _stage_innermost(u, axis, merge, st, force_tree, use_compress)
        elif st.lane_parallel:
            u = _stage_lane(u, axis, merge, st, rank, use_compress)
        else:
            u = _stage_rep(u, axis, merge, st, rank, use_compress)
    return u


def hierarchical_merge(update: PyTree, axis: StackedAxis, merge: MergeFn,
                       topology: MergePlan, compress: bool = False,
                       force_tree: bool = False) -> PyTree:
    """N-level all-reduce of ``update``: every rank ends with the full
    combination. Runs ALL levels eagerly, including ones marked ``defer``."""
    plan = _resolve_plan(topology, axis, compress)
    stages = compile_plan(plan, axis.size, merge_fn=merge)
    return _run_stages(update, axis, merge, stages, force_tree)


def _deferred(topology: MergePlan, axis: StackedAxis, merge_fn: MergeFn,
              compress: bool, caller: str) -> list[LevelStage]:
    plan = _resolve_plan(topology, axis, compress)
    _, deferred = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge_fn))
    if not deferred:
        raise ValueError(f"{caller}: plan has no deferred stages")
    return deferred


def settle_deferred(update: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: MergePlan, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run every DEFERRED stage of the plan on ``update`` (already settled
    through the eager levels). Does not touch memory."""
    plan = _resolve_plan(topology, axis, compress)
    _, deferred = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge_fn))
    return _run_stages(update, axis, merge_fn, deferred, force_tree)


def settle_inflight(inflight: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: MergePlan, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run only the TOP deferred stage's exchange on a launched aggregate —
    the land half of an overlapped full commit."""
    deferred = _deferred(topology, axis, merge_fn, compress,
                         "settle_inflight")
    return _run_stages(inflight, axis, merge_fn, [deferred[-1]], force_tree)


def launch_inflight(update: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: MergePlan, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run every deferred stage EXCEPT the top on ``update`` — the launch
    half of an overlapped full commit. ``launch_inflight`` then
    ``settle_inflight`` composes to exactly :func:`settle_deferred`."""
    deferred = _deferred(topology, axis, merge_fn, compress,
                         "launch_inflight")
    return _run_stages(update, axis, merge_fn, deferred[:-1], force_tree)


@dataclasses.dataclass(frozen=True)
class StageManifest:
    """What one compiled stage is *scheduled* to put on the wire.

    ``exchange_rounds`` are ppermute rounds at the stage's own plan level;
    ``intra_rounds`` are the stage's sub-level rounds (rep-stage unit
    broadcast, lane-stage unit all-gather). ``fused_ops`` is 1 when the
    stage rides the fused grouped reduction (zero ppermutes).
    """

    index: int          # plan level index the stage executes
    name: str
    defer: bool
    stride: int
    fanout: int
    kind: str           # "fused" | "butterfly" | "ring"
    fused_ops: int
    exchange_rounds: int
    intra_rounds: int

    @property
    def permute_rounds(self) -> int:
        return self.exchange_rounds + self.intra_rounds


def _cross_unit_rounds(fanout: int) -> tuple[str, int]:
    if permutes.is_pow2(fanout):
        return "butterfly", fanout.bit_length() - 1
    return "ring", fanout - 1


def collective_manifest(topology: MergePlan, axis_size: int,
                        merge_fn: Optional[MergeFn] = None,
                        compress: bool = False,
                        force_tree: bool = False) -> list[StageManifest]:
    """The per-level collective schedule of ``topology`` on ``axis_size``:
    one :class:`StageManifest` per compiled stage, in execution order."""
    if not isinstance(topology, MergePlan):
        raise TypeError(f"expected a MergePlan, got {type(topology).__name__}")
    out: list[StageManifest] = []
    for st in compile_plan(topology, axis_size, merge_fn=merge_fn):
        use_compress = (st.compress and merge_fn is not None
                        and merge_fn.encode is not None)
        if st.stride == 1:
            fused = (st.combine_mode == "xla" and not force_tree
                     and not use_compress and merge_fn is not None
                     and merge_fn.xla_reduce in _FUSED_REDUCERS)
            if fused:
                kind, fused_ops, rounds = "fused", 1, 0
            else:
                kind, rounds = _cross_unit_rounds(st.fanout)
                fused_ops = 0
            intra = 0
        else:
            kind, rounds = _cross_unit_rounds(st.fanout)
            fused_ops = 0
            if st.lane_parallel:
                intra = (st.stride.bit_length() - 1
                         if permutes.is_pow2(st.stride) else st.stride - 1)
            else:
                intra = max(0, (st.stride - 1).bit_length())
        out.append(StageManifest(
            index=st.index, name=st.name, defer=st.defer, stride=st.stride,
            fanout=st.fanout, kind=kind, fused_ops=fused_ops,
            exchange_rounds=rounds, intra_rounds=intra))
    return out


def program_manifest(topology: MergePlan, axis_size: int, due: int,
                     merge_fn: Optional[MergeFn] = None,
                     compress: bool = False,
                     force_tree: bool = False) -> list[StageManifest]:
    """Manifest of the stages a ``defer_cascade(due=...)`` tick executes:
    every eager stage plus the leading ``due`` deferred stages."""
    manifest = collective_manifest(topology, axis_size, merge_fn=merge_fn,
                                   compress=compress, force_tree=force_tree)
    eager = [m for m in manifest if not m.defer]
    deferred = [m for m in manifest if m.defer]
    if not 0 <= due <= len(deferred):
        raise ValueError(f"program_manifest: due={due} out of range "
                         f"[0, {len(deferred)}]")
    return eager + deferred[:due]


def overlap_program_manifest(topology: MergePlan, axis_size: int, half: str,
                             merge_fn: Optional[MergeFn] = None,
                             compress: bool = False,
                             force_tree: bool = False) -> list[StageManifest]:
    """Manifest of one half of an *overlapped* full commit: ``"launch"``
    (every eager stage plus every deferred stage below the top) or
    ``"land"`` (the top deferred stage alone)."""
    if half not in ("launch", "land"):
        raise ValueError(f"half must be 'launch' or 'land', got {half!r}")
    manifest = collective_manifest(topology, axis_size, merge_fn=merge_fn,
                                   compress=compress, force_tree=force_tree)
    deferred = [m for m in manifest if m.defer]
    if not deferred:
        raise ValueError("overlap_program_manifest: topology has no "
                         "deferred stages to overlap")
    if half == "land":
        return [deferred[-1]]
    eager = [m for m in manifest if not m.defer]
    return eager + deferred[:-1]


def defer_cascade(delta: PyTree, pendings: Sequence[PyTree], due: int,
                  axis: StackedAxis, merge_fn: MergeFn, topology: MergePlan,
                  compress: bool = False, force_tree: bool = False
                  ) -> tuple[list[PyTree], Optional[PyTree]]:
    """One step of the scheduled multi-level merge-on-evict cascade.

    ``pendings`` holds one accumulator per compiled deferred stage,
    innermost first. ``due`` is the number of leading deferred stages
    committing this step (a nested ``DeferSchedule`` makes the due set a
    prefix, so no contribution is ever counted twice). The step's ``delta``
    settles through the eager levels and coalesces into ``pendings[0]``;
    each due stage exchanges its pending across its units and folds the
    result into the pending above. Returns the new accumulators and, when
    every deferred stage committed, the full-scope combination (else
    ``None``).
    """
    plan = _resolve_plan(topology, axis, compress)
    eager, deferred = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge_fn))
    if not deferred:
        raise ValueError("defer_cascade: plan has no deferred stages "
                         "(no :defer levels, or they all have size 1)")
    pendings = list(pendings)
    if len(pendings) != len(deferred):
        raise ValueError(
            f"defer_cascade: {len(pendings)} pendings for "
            f"{len(deferred)} deferred stages "
            f"({[s.name for s in deferred]})")
    if not 0 <= due <= len(deferred):
        raise ValueError(f"defer_cascade: due={due} out of range "
                         f"[0, {len(deferred)}]")

    u = _run_stages(delta, axis, merge_fn, eager, force_tree)
    x = merge_fn.tree_combine(pendings[0], u)
    if due == 0:
        return [x] + pendings[1:], None

    new_pendings = list(pendings)
    for i in range(due):
        new_pendings[i] = merge_fn.tree_identity(pendings[i])
        x = _run_stages(x, axis, merge_fn, [deferred[i]], force_tree)
        if i + 1 < len(deferred):
            if i + 1 < due:
                x = merge_fn.tree_combine(pendings[i + 1], x)
            else:
                new_pendings[i + 1] = merge_fn.tree_combine(pendings[i + 1], x)
    settled = x if due == len(deferred) else None
    return new_pendings, settled
