"""Blocked on-demand privatization: the source buffer + ways + evict-merge.

The PyTorch counterpart of the JAX package's ``repro/core/blocked.py``, on
the stacked layout: every state tensor carries a leading shard dim ``S``
and every function runs all shards at once. A shard privatizes at most
``ways`` *blocks* of ``block_rows`` rows of a large table at a time (the
paper's w-way source buffer); touching a new block with all ways full
forces an **evict-merge** of the LRU way, and ``flush`` is the explicit
merge instruction. Clean ways are dropped silently (the dirty-merge
optimization); both events are counted, which reproduces the paper's
Fig. 9.

Merges go through the ``cmerge`` kernel (``kernels.ops.merge_buffer``)
when the merge has a kind for it — ADD, MAX, MIN and BITWISE_OR give the
same result as ``apply(mem, delta(src, upd))``: add's delta is
``upd - src``, max's and min's is ``upd``, and or's is ``upd | src`` with
``upd`` a superset of ``src``. Any other merge (MUL, COMPLEX_MUL,
BITWISE_AND, ``saturating_add``, whose apply clips in the table's dtype
and not in f32) runs the same merge as plain tensor ops: the flexible path
the engine exists for.

:func:`cop_scatter` and :func:`spill_scatter` are serial models — one
access at a time, as the reference's ``lax.scan`` — because the hit, miss
and eviction counts depend on that order. Each access is a handful of
tensor ops over the ``[S, ...]`` state, every ``lax.cond`` a mask, with
nothing read back to the host. State is updated **in place**; the
functions return it as the reference returns its new state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.merge_functions import (ADD, BITWISE_OR, MAX, MIN,
                                              MergeFn)
from repro_torch.kernels.ops import merge_buffer

Tensor = torch.Tensor

# the merges whose evict/flush merge is one cmerge kind
CMERGE_KINDS = {ADD.name: "add", MAX.name: "max", MIN.name: "min",
                BITWISE_OR.name: "or"}


def _register(cls):
    """A dataclass of tensors as a pytree, so that ``StackedSPMD`` guards
    its leaves like any other argument's."""
    names = [f.name for f in dataclasses.fields(cls)]
    pytree.register_pytree_node(
        cls, lambda x: ([getattr(x, n) for n in names], None),
        lambda leaves, _: cls(*leaves))
    return cls


@_register
@dataclasses.dataclass
class BlockedCache:
    """Every shard's privatization state for one table."""

    block_ids: Tensor   # i32[S, ways], -1 = invalid
    src_vals: Tensor    # [S, ways, block_rows, cols]  source-buffer copies
    upd_vals: Tensor    # [S, ways, block_rows, cols]  update copies
    dirty: Tensor       # bool[S, ways]
    clock: Tensor       # i32[S, ways]  LRU timestamps
    tick: Tensor        # i32[S]
    n_evict_merges: Tensor   # i32[S]  dirty evictions (merge-on-evict)
    n_silent_evicts: Tensor  # i32[S]  clean evictions (dirty-merge skips)
    n_flush_merges: Tensor   # i32[S]  explicit merge-instruction merges


def init_cache(n_shards: int, ways: int, block_rows: int, cols: int, dtype,
               device) -> BlockedCache:
    def zeros(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)
    S = n_shards
    return BlockedCache(
        block_ids=torch.full((S, ways), -1, dtype=torch.int32,
                             device=device),
        src_vals=zeros(S, ways, block_rows, cols, dt=dtype),
        upd_vals=zeros(S, ways, block_rows, cols, dt=dtype),
        dirty=zeros(S, ways, dt=torch.bool),
        clock=zeros(S, ways), tick=zeros(S), n_evict_merges=zeros(S),
        n_silent_evicts=zeros(S), n_flush_merges=zeros(S))


@_register
@dataclasses.dataclass
class SpillBuffer:
    """Bounded home for the cache's evicted mass between commits.

    The partitioned store has no dense pending table to absorb evictions
    into, so evicted blocks *spill* here, as accumulated update deltas keyed
    by block id, and the commit drains the buffer. Capacity is ``slots``
    blocks per shard. An eviction that finds neither a matching nor a free
    slot increments ``n_overflow`` and its delta is LOST — the driver must
    check the counter at every commit and fail loudly (``ShardedKV`` does).
    """

    block_ids: Tensor   # i32[S, slots], -1 = free
    vals: Tensor        # [S, slots, block_rows, cols] accumulated deltas
    n_spills: Tensor    # i32[S]  evictions absorbed (incl. coalesced)
    n_overflow: Tensor  # i32[S]  evictions dropped for want of a slot


def init_spill(n_shards: int, slots: int, block_rows: int, cols: int, dtype,
               merge: MergeFn, device) -> SpillBuffer:
    return SpillBuffer(
        block_ids=torch.full((n_shards, slots), -1, dtype=torch.int32,
                             device=device),
        vals=merge.identity((n_shards, slots, block_rows, cols), dtype,
                            device=device),
        n_spills=torch.zeros(n_shards, dtype=torch.int32, device=device),
        n_overflow=torch.zeros(n_shards, dtype=torch.int32, device=device))


def _merge_ways(table: Tensor, block_ids: Tensor, dirty: Tensor, src: Tensor,
               upd: Tensor, merge: MergeFn) -> None:
    """``table[s, block] = apply(mem, delta(src, upd))`` in place for every
    valid dirty way: ``table [S, R, D]``, ``block_ids``/``dirty [S, W]``,
    ``src``/``upd [S, W, BR, D]``. One ``cmerge`` launch for the merges it
    has a kind for; else one masked tensor-op merge per way (one way of each
    shard at a time, so no two writes meet)."""
    kind = CMERGE_KINDS.get(merge.name)
    if kind is not None:
        merge_buffer(table, block_ids, dirty, src, upd, kind=kind)
        return
    S, R, D = table.shape
    br = src.shape[2]
    flat = table.view(S * R, D)
    base = torch.arange(S, device=table.device)[:, None] * R + torch.arange(
        br, device=table.device)
    for w in range(src.shape[1]):
        ok = (block_ids[:, w] >= 0) & dirty[:, w]
        rows = base + torch.where(ok, block_ids[:, w], 0).long()[:, None] * br
        mem = flat[rows]
        new = merge.apply(mem, merge.delta(src[:, w], upd[:, w]))
        flat[rows] = torch.where(ok[:, None, None], new, mem)


def _victims(cache: BlockedCache, block: Tensor):
    """The way each shard's access to ``block`` lands in — the hit way,
    else the first free way, else the least recently used (first minimum of
    ``clock``) — and whether it hit and whether it must evict. One
    ``argmin`` over a score picks all three, ties to the first way, as the
    reference's ``argmax``/``argmin`` do."""
    ids = cache.block_ids
    score = torch.where(ids == block[:, None], -2,
                        torch.where(ids < 0, -1, cache.clock))
    victim, best = _first_min(score)
    return victim, best == -2, best >= 0


def _first_min(score: Tensor) -> tuple[Tensor, Tensor]:
    """Index and value of each row's first minimum."""
    victim = score.argmin(1)
    return victim, score.gather(1, victim[:, None])[:, 0]


def _walk(cache: BlockedCache, rows: Tensor, vals: Tensor, merge: MergeFn,
          evict, fresh) -> None:
    """The serial access loop both walkers share: for each access ``i``,
    pick every shard's way, hand a dirty eviction's way to ``evict(old_ids,
    evict_dirty, src, upd)`` (all ``[S, ...]``, the mask saying which shards
    evict), refill a missed way from ``fresh(i)`` (``[S, BR, D]``, read
    after the eviction) and fold the COp into the way's update copy."""
    S, W, BR, D = cache.upd_vals.shape
    shards = torch.arange(S, device=rows.device)
    way0 = shards * W
    blocks = (rows.long() // BR).to(torch.int32)
    lines = rows.long() % BR
    ids, dirty, clock = (x.view(-1) for x in (cache.block_ids, cache.dirty,
                                               cache.clock))
    src = cache.src_vals.view(S * W, BR, D)
    upd = cache.upd_vals.view(S * W, BR, D)
    for i in range(rows.shape[1]):
        block = blocks[:, i]
        victim, hit, must_evict = _victims(cache, block)
        fv = way0 + victim
        was_dirty = dirty[fv]
        evict_dirty = must_evict & was_dirty
        s_old, u_old = src[fv], upd[fv]
        evict(ids[fv], evict_dirty, s_old, u_old)
        cache.n_evict_merges += evict_dirty
        cache.n_silent_evicts += must_evict & ~was_dirty
        # (re)fill on a miss: privatize the block, src and upd copies
        new = fresh(i)
        keep = hit[:, None, None]
        src[fv] = torch.where(keep, s_old, new)
        u_new = torch.where(keep, u_old, new)
        # the COp itself: update copy ⊕= val (no coherence, no lock)
        line = lines[:, i]
        u_new[shards, line] = merge.combine(u_new[shards, line], vals[:, i])
        upd[fv] = u_new
        ids[fv] = block
        dirty[fv] = True
        clock[fv] = cache.tick
        cache.tick += 1


def cop_scatter(cache: BlockedCache, table: Tensor, rows: Tensor,
                vals: Tensor, merge: MergeFn) -> tuple[BlockedCache, Tensor]:
    """Apply every shard's stream of COps ``table[s, rows[s, i]] ⊕=
    vals[s, i]`` through its cache, access by access, so that hit, miss and
    eviction behaviour — the Fig. 9 counters — are exact. ``table [S, R, D]``,
    ``rows`` int ``[S, n]`` (in range), ``vals [S, n, D]``. A dirty eviction
    merges its way into ``table`` (a ``cmerge`` with one way per shard and
    the eviction as its dirty mask); a miss refills the way from ``table``
    after that merge."""
    S, R, D = table.shape
    BR = cache.upd_vals.shape[2]
    # flat table rows of every access's block: [S, n, BR]
    fresh_rows = ((torch.arange(S, device=table.device)[:, None] * R
                   + rows.long() // BR * BR)[..., None]
                  + torch.arange(BR, device=table.device))
    flat = table.view(-1, D)

    def evict(old_ids, evict_dirty, s_old, u_old):
        _merge_ways(table, old_ids[:, None], evict_dirty[:, None],
                   s_old[:, None], u_old[:, None], merge)

    _walk(cache, rows, vals, merge, evict, lambda i: flat[fresh_rows[:, i]])
    return cache, table


def spill_scatter(cache: BlockedCache, spill: SpillBuffer, rows: Tensor,
                  vals: Tensor, merge: MergeFn
                  ) -> tuple[BlockedCache, SpillBuffer]:
    """:func:`cop_scatter` with no backing table: privatize over the merge
    identity, spill-through-eviction into ``spill``.

    Both copies of a way start at the identity, so ``delta(src, upd)`` is
    the way's unmerged mass. A dirty eviction folds it into the spill slot
    holding its block, else into the first free slot — a ``cmerge`` of one
    way per shard on the spill buffer viewed as a table of slots — and an
    eviction that finds neither is counted in ``n_overflow`` and dropped.
    """
    S, W, BR, D = cache.upd_vals.shape
    slots = spill.block_ids.shape[1]
    slot0 = torch.arange(S, device=rows.device) * slots
    ident = merge.identity((S, BR, D), cache.upd_vals.dtype,
                           device=rows.device)
    spill_ids = spill.block_ids.view(-1)
    spill_table = spill.vals.view(S, slots * BR, D)

    def evict(old_ids, evict_dirty, s_old, u_old):
        # the slot of the evicted block, else the first free one
        s_score = torch.where(spill.block_ids == old_ids[:, None], 0,
                              torch.where(spill.block_ids < 0, 1, 2))
        slot, s_best = _first_min(s_score)
        take = evict_dirty & (s_best < 2)
        _merge_ways(spill_table, slot.to(torch.int32)[:, None],
                   take[:, None], s_old[:, None], u_old[:, None], merge)
        fs = slot0 + slot
        spill_ids[fs] = torch.where(take, old_ids, spill_ids[fs])
        spill.n_spills += take
        spill.n_overflow += evict_dirty & ~take

    _walk(cache, rows, vals, merge, evict, lambda i: ident)
    return cache, spill


def spill_drain(spill: SpillBuffer, table: Tensor, merge: MergeFn
                ) -> tuple[SpillBuffer, Tensor]:
    """Fold every spilled block delta into ``table [S, R, D]`` — one
    ``cmerge`` over all slots, ``src`` the identity and ``upd`` the spilled
    delta — and empty the buffer (the commit-side half of
    spill-through-eviction). Slots hold distinct blocks, so no two merges
    meet."""
    ident = merge.identity(spill.vals.shape, spill.vals.dtype,
                           device=spill.vals.device)
    _merge_ways(table, spill.block_ids, spill.block_ids >= 0, ident,
               spill.vals, merge)
    spill.block_ids.fill_(-1)
    spill.vals.copy_(ident)
    return spill, table


def flush(cache: BlockedCache, table: Tensor, merge: MergeFn
          ) -> tuple[BlockedCache, Tensor]:
    """The explicit ``merge`` instruction: merge every valid dirty way into
    ``table`` (one ``cmerge`` over all ways) and invalidate every way.
    Clean ways are dropped without a merge (dirty-merge optimization)."""
    valid = cache.block_ids >= 0
    _merge_ways(table, cache.block_ids, cache.dirty, cache.src_vals,
               cache.upd_vals, merge)
    cache.n_flush_merges += (valid & cache.dirty).sum(1, dtype=torch.int32)
    cache.n_silent_evicts += (valid & ~cache.dirty).sum(1, dtype=torch.int32)
    cache.block_ids.fill_(-1)
    cache.dirty.fill_(False)
    return cache, table


def _resident_way(ids: Tensor, block: Tensor) -> tuple[Tensor, Tensor]:
    """Whether each block of ``block [S, n]`` sits in a slot of ``ids
    [S, W]`` (ways or spill slots), and its first such slot: ``[S, n]``
    each."""
    hits = ids[:, None, :] == block[..., None]
    return hits.any(-1), hits.to(torch.int8).argmax(-1)


def c_read_row(cache: BlockedCache, table: Tensor, rows: Tensor) -> Tensor:
    """Read rows through the cache: the update copy if a row's block is
    resident, else memory. ``rows`` int ``[S, n]`` (in range) ->
    ``[S, n, D]``."""
    br = cache.upd_vals.shape[2]
    shards = torch.arange(rows.shape[0], device=rows.device)[:, None]
    rows = rows.long()
    hit, way = _resident_way(cache.block_ids, rows // br)
    return torch.where(hit[..., None], cache.upd_vals[shards, way, rows % br],
                       table[shards, rows])


def resident_delta(cache: BlockedCache, rows: Tensor,
                   merge: MergeFn) -> Tensor:
    """Each row's unmerged mass in the cache: its resident way's
    ``delta(src, upd)``, the identity where its block is not resident.
    ``rows`` int ``[S, n]`` (in range) -> ``[S, n, D]``. (``upd`` alone
    would count again the src copy that memory already holds.)"""
    br = cache.upd_vals.shape[2]
    shards = torch.arange(rows.shape[0], device=rows.device)[:, None]
    rows = rows.long()
    line = rows % br
    hit, way = _resident_way(cache.block_ids, rows // br)
    res = merge.delta(cache.src_vals[shards, way, line],
                      cache.upd_vals[shards, way, line])
    return torch.where(hit[..., None], res,
                       merge.identity(res.shape[-1:], res.dtype,
                                      device=res.device))


def spill_read_row(cache: BlockedCache, spill: SpillBuffer, rows: Tensor,
                   merge: MergeFn) -> Tensor:
    """Rows' unmerged pending deltas in the table-less configuration:
    :func:`resident_delta` combined with any spilled mass for each row's
    block. ``rows`` int ``[S, n]`` (in range) -> ``[S, n, D]``."""
    br = spill.vals.shape[2]
    shards = torch.arange(rows.shape[0], device=rows.device)[:, None]
    rows = rows.long()
    hit, slot = _resident_way(spill.block_ids, rows // br)
    spilled = spill.vals[shards, slot, rows % br]
    return merge.combine(resident_delta(cache, rows, merge), torch.where(
        hit[..., None], spilled,
        merge.identity(spilled.shape[-1:], spilled.dtype,
                       device=spilled.device)))


def stats(cache: BlockedCache) -> dict[str, Any]:
    """The Fig. 9 counters, summed over shards."""
    out = {"evict_merges": int(cache.n_evict_merges.sum()),
           "silent_evicts": int(cache.n_silent_evicts.sum()),
           "flush_merges": int(cache.n_flush_merges.sum())}
    out["total_merges"] = out["evict_merges"] + out["flush_merges"]
    return out
