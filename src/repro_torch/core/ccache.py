"""The CCache merge engine on the stacked layout.

The PyTorch counterpart of the JAX package's ``repro/core/ccache.py``, with
every shard on one device as dim 0 of each tensor and the collectives taken
from a :class:`~repro_torch.core.stacked.StackedAxis` (see ``stacked.py``).
Each function takes and returns stacked tensors (or pytrees of them): where
the reference's per-shard program sees ``x[...]`` with ``axis_name`` bound,
this one sees ``x[S, ...]`` and an ``axis``. The same functions run once a
device over a :class:`~repro_torch.core.mesh_axis.MeshAxis`, each device
holding its ``[1, ...]`` slice of the stack: ``axis.size`` is the logical
rank count the plan and the permutations are built over, ``axis.stack``
the ranks a local tensor stacks.

* ``privatize`` / ``c_read`` / ``c_write`` / ``c_update`` — the ``CView``
  of a privatized copy: preserved source plus mutable update copy.
* ``tree_merge`` / ``reduce_update`` — the flat all-reduce with an arbitrary
  commutative combine (recursive doubling, or a gather and fold on a
  non-power-of-two axis); the fused grouped reduction for add/max/min.
* ``hierarchical_merge`` — N-level all-reduce over a ``MergePlan`` (or the
  two-level ``MergeTopology`` shorthand): fused grouped reduction at the
  innermost level for add/max/min, representative- or lane-parallel
  ppermute exchanges above it, unit broadcasts. A ``compress`` level moves
  the merge's ``encode``d wire format, rank by rank.
* ``partial_merge`` — only the plan's eager levels; ``settle_deferred`` /
  ``commit_launch`` / ``commit_land`` / ``commit_deferred`` — the deferred
  levels and their landing in memory.
* ``defer_cascade`` / ``overlap_cascade`` — one step of the scheduled
  multi-level merge-on-evict cascade over a ``DeferSchedule``'s due
  prefix, serialized or with the top stage's exchange landing one step
  late; ``launch_inflight`` / ``settle_inflight`` — the two halves of an
  overlapped full commit.
* ``merge`` / ``soft_merge`` / ``PendingUpdate`` / ``commit`` — the view
  API: merge now, or coalesce into a pending update and commit later.
* ``StageManifest`` / ``collective_manifest`` / ``program_manifest`` /
  ``overlap_program_manifest`` / ``deferred_stages_of`` — the per-stage
  collective schedule, pure.

A keyed merge (``needs_key``) takes a ``torch.Generator`` as ``key`` and
applies the same draw on every rank, as the reference's ranks do with one
replicated PRNG key, so the replicas of memory stay equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence, Union

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


@dataclasses.dataclass
class CView:
    """A privatized view of CData: preserved source + mutable update copy."""

    src: PyTree
    upd: PyTree


pytree.register_dataclass(CView)


def privatize(mem: PyTree) -> CView:
    """First-touch duplication (the c_read miss path)."""
    return CView(src=mem, upd=mem)


def c_read(view: CView) -> PyTree:
    return view.upd


def c_write(view: CView, value: PyTree) -> CView:
    return CView(src=view.src, upd=value)


def c_update(view: CView, fn) -> CView:
    return CView(src=view.src, upd=fn(view.upd))


# -- the wire codec, rank by rank -------------------------------------------


def _encode(merge: MergeFn, x: torch.Tensor) -> PyTree:
    """Each rank's leaf in the merge's wire format (a per-rank scale)."""
    return torch.func.vmap(merge.encode)(x)


def _decode(merge: MergeFn, wire: PyTree) -> torch.Tensor:
    return torch.func.vmap(merge.decode)(wire)


def _codec_combine(merge: MergeFn, mine: PyTree, theirs: PyTree
                   ) -> torch.Tensor:
    """Fold a received wire into our own, decoding both so that both ranks
    of a pair fold identically-quantized values."""
    return merge.combine(_decode(merge, mine), _decode(merge, theirs))


def _codec_butterfly(leaves: list, axis: StackedAxis, merge: MergeFn,
                     perms: Sequence) -> list:
    """Compressed butterfly rounds: each round encodes every rank's leaves,
    exchanges the wires over ``perm`` and folds both decoded wires."""
    for perm in perms:
        wire = [_encode(merge, x) for x in leaves]
        other = axis.ppermute(wire, perm)
        leaves = [_codec_combine(merge, w, o) for w, o in zip(wire, other)]
    return leaves


def _codec_ring(leaves: list, axis: StackedAxis, merge: MergeFn, perm,
                rounds: int) -> list:
    """Compressed ring: encode each rank's contribution once, circulate the
    wires ``rounds`` times over ``perm`` and fold each as it arrives; our
    own wire is decoded too, so all ranks fold identically-quantized
    values."""
    wire = [_encode(merge, x) for x in leaves]
    acc = [_decode(merge, w) for w in wire]
    for _ in range(rounds):
        wire = axis.ppermute(wire, perm)
        acc = [merge.combine(a, _decode(merge, w)) for a, w in zip(acc, wire)]
    return acc


def _butterfly_steps(size: int, fanout: int) -> list:
    """The flat butterfly perms of steps 1, 2, .. < fanout. Steps below the
    block size keep i ^ step inside the aligned block, so the flat perm
    doubles as the block-confined one."""
    return [permutes.butterfly_perms(size, 1 << i)
            for i in range(fanout.bit_length() - 1)]


# ---------------------------------------------------------------------------
# Flexible tree merge: all-reduce with an arbitrary commutative combine.
# ---------------------------------------------------------------------------


def tree_merge(update: PyTree, axis: StackedAxis, merge: MergeFn,
               compress: bool = False) -> PyTree:
    """Recursive-doubling all-reduce of ``update`` over the axis.

    log2(S) ``ppermute`` rounds; every rank ends with the full combination.
    A non-power-of-two axis gathers and folds instead (uncompressed, as the
    reference's fallback). With ``compress`` each round exchanges the
    merge's encoded wire format.
    """
    if compress and (merge.encode is None or merge.decode is None):
        raise ValueError(
            f"compress=True but merge {merge.name!r} defines no "
            f"encode/decode wire format — the exchange would silently stay "
            f"uncompressed; use a codec merge (e.g. int8_compressed_add) or "
            f"drop compress")
    size = axis.size
    if not permutes.is_pow2(size):  # gather + local fold, in rank order
        if axis.stack != size:
            raise NotImplementedError(
                f"tree_merge over a non-power-of-two axis of {size} ranks "
                f"gathers every rank's value: it runs on a stacked axis, "
                f"not on a mesh axis (one rank a device)")
        def _fold(x):
            acc = x[0]
            for i in range(1, size):
                acc = merge.combine(acc, x[i])
            return acc.expand_as(x).clone()
        return pytree.tree_map(_fold, update)

    perms = _butterfly_steps(size, size)
    if compress:
        leaves, treedef = pytree.tree_flatten(update)
        return pytree.tree_unflatten(
            _codec_butterfly(leaves, axis, merge, perms), treedef)

    u = update
    for perm in perms:
        u = merge.tree_combine(u, axis.ppermute(u, perm))
    return u


# ---------------------------------------------------------------------------
# Hierarchical (topology-aware) merging on the MergePlan IR.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MergeTopology:
    """Two-level shorthand: groups of ``group_size`` ranks + one inter level.

    Compiles onto the N-level ``MergePlan`` IR via ``to_plan``.
    ``use_xla_intra=False`` forces the software ppermute path at the intra
    level; ``lane_parallel=True`` shards the representative role over a
    group's lanes for the inter exchange. (The reference's ``axis_name``
    field has no counterpart: the stacked engine has one axis.)
    """

    group_size: int
    use_xla_intra: bool = True
    lane_parallel: bool = False

    def validate(self, size: int) -> None:
        if self.group_size < 1:
            raise ValueError(f"group_size must be >= 1: {self.group_size}")
        if size % self.group_size != 0:
            raise ValueError(
                f"axis size {size} not divisible by group_size "
                f"{self.group_size}")

    def groups(self, size: int) -> list[list[int]]:
        g = self.group_size
        return [list(range(i * g, (i + 1) * g)) for i in range(size // g)]

    def to_plan(self, size: int, compress: bool = False) -> MergePlan:
        self.validate(size)
        return MergePlan.two_level(
            self.group_size, size, use_xla_intra=self.use_xla_intra,
            compress_inter=compress, lane_parallel=self.lane_parallel)


Topology = Union[MergeTopology, MergePlan]


def resolve_plan(topology: Topology, size: int,
                 compress: bool = False) -> Optional[MergePlan]:
    """Normalize (MergeTopology | MergePlan) to a plan validated against
    an axis of ``size`` ranks; ``None`` for the degenerate flat dispatch
    (group_size <= 1 or a single rank). The function-level ``compress``
    flag maps onto the *outermost* executing level, as in the reference:
    the plan the engine runs."""
    if isinstance(topology, MergeTopology):
        if topology.group_size <= 1 or size == 1:
            return None
        topology = topology.to_plan(size)
    if not isinstance(topology, MergePlan):
        raise TypeError(f"expected a MergePlan or MergeTopology, got "
                        f"{type(topology).__name__}")
    plan = topology
    plan.validate(size)
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
    fanout, size = stage.fanout, axis.size
    if (stage.combine_mode == "xla" and not force_tree and not use_compress
            and merge.xla_reduce in _FUSED_REDUCERS):
        return getattr(axis, _FUSED_REDUCERS[merge.xla_reduce])(u, fanout)

    if permutes.is_pow2(fanout):
        perms = _butterfly_steps(size, fanout)
        if use_compress:
            leaves, treedef = pytree.tree_flatten(u)
            return pytree.tree_unflatten(
                _codec_butterfly(leaves, axis, merge, perms), treedef)
        for perm in perms:
            u = merge.tree_combine(u, axis.ppermute(u, perm))
        return u

    # Any block size: circulate contributions around the block ring, folding
    # as they pass — fanout-1 rounds, each rank sees every member once.
    perm = permutes.ring_perm(size, fanout)
    if use_compress:
        leaves, treedef = pytree.tree_flatten(u)
        return pytree.tree_unflatten(
            _codec_ring(leaves, axis, merge, perm, fanout - 1), treedef)
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
    identity self-pairs. ``use_compress`` puts the merge's encode/decode
    wire format on these expensive rounds only.
    """
    stride, fanout = stage.stride, stage.fanout
    lane = rank % stride
    is_rep = lane == 0
    perms = permutes.rep_exchange_perms(axis.size, stride, fanout)
    butterfly = permutes.is_pow2(fanout)
    if use_compress:
        # A representative's rounds read only representatives' values, so
        # the non-representatives' (self-paired) folds are dropped at the end.
        leaves, treedef = pytree.tree_flatten(u)
        if butterfly:
            acc = _codec_butterfly(leaves, axis, merge, perms)
        else:
            acc = _codec_ring(leaves, axis, merge, perms[0], fanout - 1)
        u = pytree.tree_unflatten(
            [axis.where(is_rep, a, x) for a, x in zip(acc, leaves)], treedef)
    elif butterfly:
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
    # the local stack's rows (every rank stacked, or this device's one)
    ranks = torch.arange(axis.stack, device=lane.device)
    bufs = []
    for ch in chunks:
        b = ch.new_zeros((axis.stack, stride) + tuple(ch.shape[1:]))
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
    stride, fanout = stage.stride, stage.fanout
    lane = rank % stride
    leaves, treedef = pytree.tree_flatten(u)
    chunks = [_lane_chunk(x, stride, lane, merge.wire_atom) for x in leaves]
    perms = permutes.lane_exchange_perms(axis.size, stride, fanout)
    butterfly = permutes.is_pow2(fanout)
    if use_compress:
        if butterfly:
            chunks = _codec_butterfly(chunks, axis, merge, perms)
        else:
            chunks = _codec_ring(chunks, axis, merge, perms[0], fanout - 1)
    elif butterfly:
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
        # a profiler trace names each level's share of a merge; untraced,
        # no range is entered
        with (torch.profiler.record_function(f"merge.{st.name}")
              if torch.autograd.profiler._is_profiler_enabled
              else contextlib.nullcontext()):
            if st.stride == 1:
                u = _stage_innermost(u, axis, merge, st, force_tree,
                                     use_compress)
            elif st.lane_parallel:
                u = _stage_lane(u, axis, merge, st, rank, use_compress)
            else:
                u = _stage_rep(u, axis, merge, st, rank, use_compress)
    return u


def merge_stage(update: PyTree, axis: StackedAxis, merge: MergeFn,
                stage: LevelStage) -> PyTree:
    """One compiled stage's exchange alone: a level's merge, as
    ``launch/kv_serve.py`` times it to measure the level's rate."""
    return _run_stages(update, axis, merge, [stage], force_tree=False)


def hierarchical_merge(update: PyTree, axis: StackedAxis, merge: MergeFn,
                       topology: Topology, compress: bool = False,
                       force_tree: bool = False) -> PyTree:
    """N-level all-reduce of ``update``: every rank ends with the full
    combination, as with ``tree_merge``, but each level's exchange stays on
    its link class. Runs ALL levels eagerly, including ones marked
    ``defer`` (``partial_merge`` + ``commit_deferred`` defer them)."""
    plan = resolve_plan(topology, axis.size, compress)
    if plan is None:  # every rank is its own group: flat dispatch
        return reduce_update(update, axis, merge, compress=compress,
                             force_tree=force_tree)
    stages = compile_plan(plan, axis.size, merge_fn=merge)
    return _run_stages(update, axis, merge, stages, force_tree)


def partial_merge(update: PyTree, axis: StackedAxis, merge: MergeFn,
                  topology: Topology, compress: bool = False,
                  force_tree: bool = False) -> PyTree:
    """Run only the plan's EAGER (non-deferred) levels: every rank ends with
    its eager-scope block's combination and no deferred-level traffic has
    occurred. Accumulate the results into a ``PendingUpdate`` and settle
    the deferred levels with ``commit_deferred`` every K steps."""
    plan = resolve_plan(topology, axis.size, compress)
    if plan is None:
        return update if axis.size == 1 else reduce_update(
            update, axis, merge, compress=compress, force_tree=force_tree)
    eager, _ = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge))
    return _run_stages(update, axis, merge, eager, force_tree)


def _split(topology: Topology, axis: StackedAxis, merge_fn: MergeFn,
           compress: bool, caller: str) -> tuple[list, list]:
    """The eager and deferred stages of a plan that has deferred ones."""
    plan = resolve_plan(topology, axis.size, compress)
    if plan is None:
        raise ValueError(f"{caller} needs a MergePlan with deferred levels "
                         f"(got a degenerate/flat topology)")
    eager, deferred = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge_fn))
    if not deferred:
        raise ValueError(f"{caller}: plan has no deferred stages "
                         "(no :defer levels, or they all have size 1)")
    return eager, deferred


def settle_deferred(update: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: Topology, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run every DEFERRED stage of the plan on ``update`` (already settled
    through the eager levels, a ``partial_merge`` output). Does not touch
    memory."""
    plan = resolve_plan(topology, axis.size, compress)
    if plan is None:
        return update
    _, deferred = split_eager_deferred(
        compile_plan(plan, axis.size, merge_fn=merge_fn))
    return _run_stages(update, axis, merge_fn, deferred, force_tree)


def settle_inflight(inflight: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: Topology, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run only the TOP deferred stage's exchange on a launched aggregate —
    the land half of an overlapped full commit, as a call of its own (the
    flush of an overlapped loop)."""
    _, deferred = _split(topology, axis, merge_fn, compress,
                         "settle_inflight")
    return _run_stages(inflight, axis, merge_fn, [deferred[-1]], force_tree)


def launch_inflight(update: PyTree, axis: StackedAxis, merge_fn: MergeFn,
                    topology: Topology, compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Run every deferred stage EXCEPT the top on ``update`` — the launch
    half of an overlapped full commit. ``launch_inflight`` then
    ``settle_inflight`` composes to exactly :func:`settle_deferred`."""
    _, deferred = _split(topology, axis, merge_fn, compress,
                         "launch_inflight")
    return _run_stages(update, axis, merge_fn, deferred[:-1], force_tree)


def _apply_replicated(merge_fn: MergeFn, mem: PyTree, u: PyTree,
                      key: Optional[torch.Generator]) -> PyTree:
    """``merge_fn.tree_apply`` on stacked memory. A keyed merge draws the
    same noise for every rank (the generator's state is rewound before each
    rank's draw), as every rank of the reference applies the combined
    update with the same key: replicated memory stays replicated."""
    if not merge_fn.needs_key:
        return merge_fn.tree_apply(mem, u, key=key)
    if key is None:
        raise ValueError(f"merge {merge_fn.name!r} needs a key: pass a "
                         f"torch.Generator")
    ranks = pytree.tree_leaves(mem)[0].shape[0]
    state = key.get_state()
    out = []
    for r in range(ranks):
        key.set_state(state)
        out.append(merge_fn.tree_apply(pytree.tree_map(lambda x: x[r], mem),
                                       pytree.tree_map(lambda x: x[r], u),
                                       key=key))
    return pytree.tree_map(lambda *xs: torch.stack(xs), *out)


def commit_launch(pending: "PendingUpdate", axis: StackedAxis,
                  merge_fn: MergeFn, topology: Topology,
                  compress: bool = False, force_tree: bool = False) -> PyTree:
    """Launch half of a deferred commit: run the deferred levels' exchange
    and return the settled full-scope aggregate *without* touching memory
    — the in-flight value. Land it with :func:`commit_land`."""
    return settle_deferred(pending.update, axis, merge_fn, topology,
                           compress=compress, force_tree=force_tree)


def commit_land(inflight: PyTree, mem: PyTree, merge_fn: MergeFn,
                key: Optional[torch.Generator] = None) -> PyTree:
    """Land half of a deferred commit: fold a launched (already exchanged)
    aggregate into memory. Pure local work — no collectives."""
    return _apply_replicated(merge_fn, mem, inflight, key)


def commit_deferred(pending: "PendingUpdate", mem: PyTree, axis: StackedAxis,
                    merge_fn: MergeFn, topology: Topology,
                    key: Optional[torch.Generator] = None,
                    compress: bool = False,
                    force_tree: bool = False) -> PyTree:
    """Settle the DEFERRED levels of a plan and apply to memory.

    ``pending`` must have been accumulated from ``partial_merge`` outputs
    (or ``soft_merge(..., plan=...)``), so only the deferred upper levels'
    exchange remains, paid once per K steps. The serialized composition of
    :func:`commit_launch` + :func:`commit_land`.
    """
    u = commit_launch(pending, axis, merge_fn, topology, compress=compress,
                      force_tree=force_tree)
    return commit_land(u, mem, merge_fn, key=key)


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


def collective_manifest(topology: Topology, axis_size: int,
                        merge_fn: Optional[MergeFn] = None,
                        compress: bool = False,
                        force_tree: bool = False) -> list[StageManifest]:
    """The per-level collective schedule of ``topology`` on ``axis_size``:
    one :class:`StageManifest` per compiled stage, in execution order."""
    if isinstance(topology, MergeTopology):
        if topology.group_size <= 1 or axis_size == 1:
            # flat dispatch (reduce_update): fused when available,
            # butterfly/ring otherwise
            if axis_size == 1:
                return []
            fused = (not force_tree and not compress and merge_fn is not None
                     and merge_fn.xla_reduce in _FUSED_REDUCERS)
            if fused:
                kind, fused_ops, rounds = "fused", 1, 0
            elif permutes.is_pow2(axis_size):
                kind, fused_ops = "butterfly", 0
                rounds = axis_size.bit_length() - 1
            else:
                # tree_merge's non-power-of-two fallback gathers and folds:
                # one all-gather, no ppermutes
                kind, fused_ops, rounds = "gather", 0, 0
            return [StageManifest(index=0, name="flat", defer=False,
                                  stride=1, fanout=axis_size, kind=kind,
                                  fused_ops=fused_ops,
                                  exchange_rounds=rounds, intra_rounds=0)]
        topology = topology.to_plan(axis_size, compress=compress)
    if not isinstance(topology, MergePlan):
        raise TypeError(f"expected a MergePlan or MergeTopology, got "
                        f"{type(topology).__name__}")
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


def program_manifest(topology: Topology, axis_size: int, due: int,
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


def overlap_program_manifest(topology: Topology, axis_size: int, half: str,
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


def deferred_stages_of(topology: Topology, axis_size: int,
                       merge_fn: Optional[MergeFn] = None
                       ) -> list[LevelStage]:
    """The compiled deferred stages of ``topology`` on an ``axis_size``
    axis (size-1 levels compile away, so this can be shorter than the
    plan's ``num_deferred``)."""
    if not isinstance(topology, MergePlan):
        return []
    _, deferred = split_eager_deferred(
        compile_plan(topology, axis_size, merge_fn=merge_fn))
    return deferred


def _cascade_stages(topology: Topology, axis: StackedAxis, merge_fn: MergeFn,
                    compress: bool, pendings: Sequence[PyTree], due: int,
                    caller: str) -> tuple[list, list]:
    """The eager and deferred stages of a cascade step, after the checks
    both cascades make on their pendings and ``due``."""
    eager, deferred = _split(topology, axis, merge_fn, compress, caller)
    if len(pendings) != len(deferred):
        raise ValueError(
            f"{caller}: {len(pendings)} pendings for "
            f"{len(deferred)} deferred stages "
            f"({[s.name for s in deferred]})")
    if not 0 <= due <= len(deferred):
        raise ValueError(f"{caller}: due={due} out of range "
                         f"[0, {len(deferred)}]")
    return eager, deferred


def defer_cascade(delta: PyTree, pendings: Sequence[PyTree], due: int,
                  axis: StackedAxis, merge_fn: MergeFn, topology: Topology,
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
    pendings = list(pendings)
    eager, deferred = _cascade_stages(topology, axis, merge_fn, compress,
                                      pendings, due, "defer_cascade")
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


def overlap_cascade(delta: PyTree, pendings: Sequence[PyTree],
                    inflight: PyTree, due: int, land: bool,
                    axis: StackedAxis, merge_fn: MergeFn, topology: Topology,
                    compress: bool = False, force_tree: bool = False
                    ) -> tuple[list[PyTree], PyTree, Optional[PyTree]]:
    """One step of the *overlapped* scheduled merge-on-evict cascade.

    Like :func:`defer_cascade`, but the TOP deferred stage is split into
    launch/land halves one step apart: on a full-commit step (``due ==
    len(deferred)``) the aggregate that would enter the top stage's
    exchange is returned as the new ``inflight`` instead, with no top-level
    traffic; on the following step (``land=True``) the top stage's exchange
    runs on ``inflight`` — independent of that step's delta — and the
    settled full-scope aggregate comes back as ``landed``, one step stale.
    Inner deferred stages still commit inline. Returns ``(new_pendings,
    new_inflight, landed)``; ``landed`` is ``None`` unless ``land``.
    """
    pendings = list(pendings)
    eager, deferred = _cascade_stages(topology, axis, merge_fn, compress,
                                      pendings, due, "overlap_cascade")
    n = len(deferred)
    # Land first: the previous step's launched aggregate takes the top
    # stage's exchange. It depends only on carried state, never on this
    # step's delta.
    landed = None
    new_inflight = inflight
    if land:
        landed = _run_stages(inflight, axis, merge_fn, [deferred[-1]],
                             force_tree)
        new_inflight = merge_fn.tree_identity(inflight)

    u = _run_stages(delta, axis, merge_fn, eager, force_tree)
    x = merge_fn.tree_combine(pendings[0], u)
    if due == 0:
        return [x] + pendings[1:], new_inflight, landed

    new_pendings = list(pendings)
    for i in range(due):
        new_pendings[i] = merge_fn.tree_identity(pendings[i])
        if i == n - 1:
            # Top stage: launch instead of exchange. x already holds
            # pendings[n-1], so inflight carries the cycle's whole
            # pre-exchange aggregate.
            new_inflight = x
            break
        x = _run_stages(x, axis, merge_fn, [deferred[i]], force_tree)
        if i + 1 < due:
            x = merge_fn.tree_combine(pendings[i + 1], x)
        else:
            new_pendings[i + 1] = merge_fn.tree_combine(pendings[i + 1], x)
    return new_pendings, new_inflight, landed


def reduce_update(update: PyTree, axis: StackedAxis, merge: MergeFn,
                  compress: bool = False, force_tree: bool = False,
                  topology: Optional[Topology] = None) -> PyTree:
    """Cross-rank combination of per-rank updates.

    The fused reduction (COUP's fast path) for add/max/min when not
    overridden; the flexible ``tree_merge`` otherwise. A ``topology``
    (a ``MergeTopology`` with ``group_size > 1``, or any ``MergePlan``)
    routes through the N-level hierarchical engine instead.
    """
    if topology is not None and (isinstance(topology, MergePlan)
                                 or topology.group_size > 1):
        return hierarchical_merge(update, axis, merge, topology,
                                  compress=compress, force_tree=force_tree)
    if compress:
        return tree_merge(update, axis, merge, compress=True)
    if not force_tree and merge.xla_reduce in _FUSED_REDUCERS:
        return getattr(axis, _FUSED_REDUCERS[merge.xla_reduce])(update)
    return tree_merge(update, axis, merge)


def merge(view: CView, mem: PyTree, axis: StackedAxis, merge_fn: MergeFn,
          key: Optional[torch.Generator] = None, compress: bool = False,
          force_tree: bool = False,
          topology: Optional[Topology] = None) -> PyTree:
    """Full CCache merge: delta -> cross-rank combine -> apply to memory.

    Every rank computes the identical combined update, so applying it to
    the (replicated) memory copy leaves memory consistent.
    """
    u = merge_fn.tree_delta(view.src, view.upd)
    u = reduce_update(u, axis, merge_fn, compress=compress,
                      force_tree=force_tree, topology=topology)
    return _apply_replicated(merge_fn, mem, u, key)


# ---------------------------------------------------------------------------
# soft_merge: deferred, locally-coalesced merging (merge-on-evict analog).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PendingUpdate:
    """Locally coalesced updates awaiting a cross-rank merge."""

    update: PyTree


pytree.register_dataclass(PendingUpdate)


def soft_merge(view: CView, pending: Optional[PendingUpdate],
               merge_fn: MergeFn, axis: Optional[StackedAxis] = None,
               plan: Optional[Topology] = None,
               force_tree: bool = False) -> tuple[CView, PendingUpdate]:
    """Coalesce the view's delta into ``pending``; reset the view's source.

    The cross-rank merge is postponed (cf. the mergeable bit): call
    ``commit`` at the merge boundary. With a ``plan`` (and its ``axis``)
    the delta is first settled through the plan's EAGER levels, so
    ``pending`` accumulates eager-scope aggregates and only the deferred
    upper levels remain for ``commit_deferred``.
    """
    u = merge_fn.tree_delta(view.src, view.upd)
    if plan is not None:
        u = partial_merge(u, axis, merge_fn, plan, force_tree=force_tree)
    if pending is None:
        pending = PendingUpdate(update=u)
    else:
        pending = PendingUpdate(update=merge_fn.tree_combine(pending.update,
                                                             u))
    return CView(src=view.upd, upd=view.upd), pending


def commit(pending: PendingUpdate, mem: PyTree, axis: StackedAxis,
           merge_fn: MergeFn, key: Optional[torch.Generator] = None,
           compress: bool = False,
           topology: Optional[Topology] = None) -> PyTree:
    """Apply a deferred pending update to memory (the eviction-time merge).

    Runs the FULL cross-rank reduction — for pendings accumulated without
    a plan. For plan-accumulated pendings use ``commit_deferred``.
    """
    u = reduce_update(pending.update, axis, merge_fn, compress=compress,
                      topology=topology)
    return _apply_replicated(merge_fn, mem, u, key)
