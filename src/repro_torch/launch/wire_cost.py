"""The per-level wire vector of a merge plan's synchronized tick.

``solve_defer_schedule`` amortizes each deferred level's exchange over its
commit interval, so it needs the bytes every level moves per tick. The JAX
package walks the compiled HLO of the synchronized (eager) tick for them:
every collective's ring-model bytes, classified by the hierarchy level of
each link it crosses, summed machine-wide. This module derives the same
vector from the plan itself, stage by stage of ``ccache.collective_manifest``
(which decides each stage's kind), with the permutations the stacked
executor (``core/ccache``) runs:

* a ``fused`` stage (stride 1): one all-reduce of the ``[R, D]`` payload
  over each aligned block of ``fanout`` ranks — the ring model's
  ``2 (g - 1) / g`` bytes a rank, over the block's ring links;
* any other stride-1 stage: ``log2(fanout)`` butterfly rounds (or
  ``fanout - 1`` ring rounds) of the payload;
* a lane-parallel stage: the cross-unit exchange of each lane's
  ``1 / stride`` chunk, then the unit's all-gather of the chunks (recursive
  doubling: round ``k`` sends ``2^k`` chunks; ring otherwise);
* a representative stage: the leaders' exchange of the payload, then the
  binomial broadcast down the unit.

A permutation round moves its payload once over every pair whose ends
differ; a pair's bytes land on the level where its two ranks first share a
block (level 0 = the innermost). Every level of the plan gets an entry,
size-1 levels included (they move nothing). ``defer`` flags are ignored:
the vector is the eager twin's, as the solver wants it.

A compressed level (a merge with a wire format) is sized when the
payload's ``dtype`` is given: its exchange rounds move the codec's wire
(``merge_fn.encode`` of the payload, or of a lane's chunk: the int8 merge's
int8 values and f32 scale), its broadcast or all-gather the decoded
payload, which stays in the decode's dtype for the stages after it, as
the engine's rounds carry it (``core/ccache._codec_butterfly``).
"""

from __future__ import annotations

from typing import Collection, Optional, Sequence

from repro_torch.core import permutes
from repro_torch.core.ccache import collective_manifest
from repro_torch.core.merge_functions import MergeFn
from repro_torch.core.merge_plan import MergePlan, compile_plan


def _bounds(plan: MergePlan) -> list[int]:
    """Block sizes B_1..B_{N-1}: ranks in one block of each inner level."""
    out, acc = [], 1
    for lv in plan.levels[:-1]:
        acc *= lv.size
        out.append(acc)
    return out


def _link_level(s: int, t: int, bounds: list[int]) -> int:
    """The level of a link: the first whose block holds both ends."""
    for i, b in enumerate(bounds):
        if s // b == t // b:
            return i
    return len(bounds)


def _permute(vec: list[float], perm: Sequence[tuple[int, int]],
             nbytes: float, bounds: list[int]) -> None:
    """One permutation round of ``nbytes`` a rank; self-pairs move nothing."""
    for s, t in perm:
        if s != t:
            vec[_link_level(s, t, bounds)] += nbytes


def _all_reduce(vec: list[float], size: int, group: int, nbytes: float,
                bounds: list[int]) -> None:
    """A ring all-reduce of ``nbytes`` a rank over each aligned ``group``:
    ``2 (g - 1)`` payloads a group, spread evenly over the group's ring
    links (consecutive ranks, wrapping)."""
    if group < 2:
        return
    total = 2.0 * (group - 1) * nbytes
    for base in range(0, size, group):
        ring = list(range(base, base + group))
        for a, b in zip(ring, ring[1:] + ring[:1]):
            vec[_link_level(a, b, bounds)] += total / group


def _cross_unit(vec, perms, fanout: int, nbytes: float, bounds) -> None:
    """Butterfly rounds for a power-of-two fanout, else ``fanout - 1``
    rounds of the ring permutation."""
    rounds = perms if permutes.is_pow2(fanout) else [perms[0]] * (fanout - 1)
    for perm in rounds:
        _permute(vec, perm, nbytes, bounds)


def _codec(merge_fn: MergeFn, shape: Sequence[int], dtype
           ) -> tuple[float, object]:
    """(bytes a rank's wire of a ``shape`` payload of ``dtype`` carries,
    the dtype a fold of two decoded wires gives), by encoding a meta
    payload as the engine does, rank by rank."""
    import torch
    from torch.utils import _pytree as pytree
    x = torch.empty((1,) + tuple(int(n) for n in shape), dtype=dtype,
                    device="meta")
    wire = torch.func.vmap(merge_fn.encode)(x)
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves(wire))
    dec = torch.func.vmap(merge_fn.decode)(wire)
    return float(nbytes), merge_fn.combine(dec, dec).dtype


def wire_bytes_by_level(plan: MergePlan, axis_size: int,
                        payload_shape: Sequence[int], itemsize: int,
                        merge_fn: Optional[MergeFn] = None,
                        levels: Optional[Collection[int]] = None,
                        dtype=None) -> list[float]:
    """Machine-wide bytes each level of ``plan`` carries in one synchronized
    merge of a ``payload_shape`` tensor of ``itemsize``-byte elements on
    every one of ``axis_size`` ranks (a KV store's tick: ``(R, D)``).
    ``levels`` keeps only the stages of those plan level indices (the
    stages a deferred tick runs: its manifest's). A compressed level needs
    the payload's ``dtype`` (a ``torch.dtype`` of ``itemsize`` bytes), to
    size its codec's wire (module doc)."""
    bounds = _bounds(plan)
    vec = [0.0] * len(plan.levels)
    elems = 1
    for n in payload_shape:
        elems *= int(n)
    atom = merge_fn.wire_atom if merge_fn is not None else 1
    rows = elems // atom if atom > 1 and elems % atom == 0 else elems
    S = axis_size
    for st, m in zip(compile_plan(plan, S, merge_fn=merge_fn),
                     collective_manifest(plan, S, merge_fn=merge_fn)):
        lanes = -(-rows // st.stride)          # a lane's rows
        payload = float(elems * itemsize)
        chunk = lanes * itemsize * (elems // rows)
        # the exchange's bytes a round: the payload (a lane's chunk), or
        # the codec's wire of it
        wire, lane_wire = payload, chunk
        if (st.compress and merge_fn is not None
                and merge_fn.encode is not None):
            if dtype is None:
                raise ValueError(
                    f"level {st.name!r} is compressed: its wire carries the "
                    f"codec's format, which this cost model sizes only "
                    f"given the payload's dtype")
            lane_wire, _ = _codec(merge_fn, (lanes, elems // rows)
                                  if elems // rows > 1 else (lanes,), dtype)
            wire, dtype = _codec(merge_fn, tuple(payload_shape), dtype)
            itemsize = dtype.itemsize
            payload = float(elems * itemsize)
            chunk = lanes * itemsize * (elems // rows)
        if levels is not None and st.index not in levels:
            continue
        if st.stride == 1:
            if m.kind == "fused":
                _all_reduce(vec, S, st.fanout, payload, bounds)
            elif permutes.is_pow2(st.fanout):
                for i in range(st.fanout.bit_length() - 1):
                    _permute(vec, permutes.butterfly_perms(S, 1 << i),
                             wire, bounds)
            else:
                for _ in range(st.fanout - 1):
                    _permute(vec, permutes.ring_perm(S, st.fanout), wire,
                             bounds)
        elif st.lane_parallel:
            _cross_unit(vec, permutes.lane_exchange_perms(S, st.stride,
                                                          st.fanout),
                        st.fanout, lane_wire, bounds)
            if permutes.is_pow2(st.stride):
                for k, perm in enumerate(
                        permutes.lane_gather_doubling_perms(S, st.stride)):
                    _permute(vec, perm, chunk * (1 << k), bounds)
            else:
                for _ in range(st.stride - 1):
                    _permute(vec, permutes.ring_perm(S, st.stride), chunk,
                             bounds)
        else:
            _cross_unit(vec, permutes.rep_exchange_perms(S, st.stride,
                                                         st.fanout),
                        st.fanout, wire, bounds)
            for _, perm in permutes.binomial_broadcast_perms(S, st.stride):
                _permute(vec, perm, payload, bounds)
    return vec


def tree_wire_bytes_by_level(plan: MergePlan, axis_size: int, leaves,
                             merge_fn: Optional[MergeFn] = None,
                             levels: Optional[Collection[int]] = None
                             ) -> list[float]:
    """:func:`wire_bytes_by_level` summed over ``leaves`` (anything with a
    ``shape`` and a ``dtype``: a gradient tree's tensors, the parameters'
    specs), each merged on its own, as a train step merges leaf by leaf."""
    vec = [0.0] * len(plan.levels)
    for leaf in leaves:
        for i, b in enumerate(wire_bytes_by_level(
                plan, axis_size, tuple(leaf.shape), leaf.dtype.itemsize,
                merge_fn=merge_fn, levels=levels, dtype=leaf.dtype)):
            vec[i] += b
    return vec
