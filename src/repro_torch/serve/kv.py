"""A sharded commutative KV store: the paper's headline app as a serving tier.

The PyTorch counterpart of the JAX package's ``repro/serve/kv.py``. All
``S`` shards live on one device, stacked along dim 0 of every state tensor
(``repro_torch.core.stacked``); the collectives of the merge cascade are
tensor ops over that dim.

By default the table lives replicated per shard (every shard answers any
read from its *settled* copy); the **update stream** is what shards — each
shard privatizes the updates it receives and cross-shard agreement is an
explicit, batched merge through the MergePlan engine.

Two privatization engines, same algebra:

* ``engine="kernel"``: a tick's updates scatter into a table through the
  ``cscatter`` kernel (``apps.common.scatter``; one launch covers every
  shard). On a fully deferred plan they scatter straight into the resident
  pending, in place — the merge-on-evict hot path.
* ``engine="blocked"``: a resident ``core.blocked.BlockedCache`` (W ways of
  ``block_rows`` rows, LRU, merge-on-evict, dirty-merge skip) carries
  privatized blocks **across ticks**, one access at a time; only evicted
  mass enters the merge cascade each tick, and the cache's ``flush`` drains
  the rest at commits. Evict and flush merges run through the ``cmerge``
  kernel. It takes the merges ``cscatter`` has no kind for (MUL,
  BITWISE_AND, ...) and its Fig. 9 counters come out of ``counters()``.

* Cross-shard reconciliation is ``ccache.defer_cascade`` over a (by default
  fully) deferred plan on a :class:`DeferSchedule` (solve one with
  ``solve_defer_schedule`` from the wire vector and rates measured on the
  card, or re-solve K online with an :class:`AdaptiveDeferSchedule`):
  non-commit ticks run no collectives, commit ticks settle the pending
  cascade.
* ``consistency="read_your_writes"`` routes reads through the shard's own
  unmerged pendings on top of the settled table.
* ``KVConfig(partitioned=True)`` home-shards the settled table (global key
  ``k`` -> shard ``k % S``, local row ``k // S``) and buffers a cycle's raw
  updates in a bounded ring (kernel engine; a commit scatters the ring into
  a transient dense delta, one kernel launch) or lets the blocked cache
  spill evicted blocks into a bounded ``SpillBuffer``
  (spill-through-eviction; a commit drains cache and buffer into the
  delta), and settles the full cascade.
  ``DeferSchedule(overlap=True)`` splits that commit into launch/land
  halves (``ccache.launch_inflight`` / ``settle_inflight``) one tick apart.

uint32 tables are held as int32 bit patterns, because torch has no uint32
add, max, min or ``index_put`` (nor CUDA uint32 indexing): ADD, OR and AND
give the same bits on them, and MAX and MIN hold each value XOR
``0x80000000``, whose signed order is the value's unsigned order. Every
merge, kernel and cascade then runs unchanged on int32; values are
converted where they enter (``tick``, ``load_state``) and leave (``read``,
``table``, ``state_arrays``).

State tensors are updated in place where the reference donates their
buffers (the ``donate=`` of :meth:`ShardedKV._run`); ``stacked_spmd``
refuses an in-place write to anything not donated.

Durability: :meth:`ShardedKV.attach_journal` writes every acknowledged
batch ahead of the tick's device work (``serve.journal``), as the caller
gave it (int32 keys, values in the table's dtype — never the int32 bits
the state holds); :meth:`ShardedKV.snapshot` saves a flush-consistent
global table (``checkpoint.save``) and truncates the journal;
:meth:`ShardedKV.recover` reloads it into any shard count, engine and
layout and replays the journal since. Journals and snapshots are the JAX
package's formats, so either package recovers the other's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.apps.common import default_plan, scatter
from repro_torch.core import blocked, ccache
from repro_torch.core.defer_schedule import (AdaptiveDeferSchedule,
                                             DeferSchedule)
from repro_torch.core.merge_functions import ADD, MergeFn
from repro_torch.core.merge_plan import MergePlan, compile_plan
from repro_torch.core.stacked import StackedAxis, stacked_spmd
from repro_torch.serve.journal import UpdateJournal

_CONSISTENCY = ("eventual", "read_your_writes")
_ENGINES = ("kernel", "blocked")
# a MergeFn's fixed reduce op doubles as the scatter kernel's kind for these
_KERNEL_KINDS = ("add", "max", "min", "or")
# elements of the [S, reads, ring, cols] match tensor a partitioned
# read-your-writes overlay materializes at once
_OVERLAY_ELEMS = 1 << 26
# the merges a uint32 table takes (module doc), and the bit that biases
# MAX/MIN values into signed order
_U32_MERGES = ("add", "max", "min", "or", "and")
_SIGN_BIT = -(1 << 31)
# the blocked state's leaves that hold table values
_VALUE_LEAVES = ("cache_src_vals", "cache_upd_vals", "spill_vals")

DEFAULT_COMMIT_EVERY = 8


def sync_device(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(device) -> torch.device:
    """The device to run on: raises if the card is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def serving_plan(n_shards: int, defer: str = "all",
                 lane_parallel: bool = True) -> MergePlan:
    """The serving tier's merge plan: ``default_plan`` geometry, with the
    commit policy as a knob.

    ``defer="all"`` (the serving default) marks *every* level ``:defer`` —
    a non-commit tick runs no collectives at all.  ``"top"`` defers only
    the outermost level.  ``"none"`` is the fully-synchronized reference —
    every level exchanges every tick.
    """
    if defer not in ("all", "top", "none"):
        raise ValueError(f"defer must be all|top|none, got {defer!r}")
    base = default_plan(n_shards, lane_parallel=lane_parallel)
    exec_ix = [i for i, lv in enumerate(base.levels) if lv.size > 1]
    if defer == "none" or not exec_ix:
        return base
    start = exec_ix[0] if defer == "all" else exec_ix[-1]
    levels = tuple(
        dataclasses.replace(lv, defer=True) if i >= start else lv
        for i, lv in enumerate(base.levels))
    return dataclasses.replace(base, levels=levels)


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """Shape/policy of one :class:`ShardedKV` table."""

    n_keys: int
    cols: int = 1
    dtype: torch.dtype = torch.int32
    merge: MergeFn = ADD
    consistency: str = "eventual"
    engine: str = "kernel"
    # blocked engine: the paper's W-way source buffer geometry.
    ways: int = 8
    block_rows: int = 8
    # partitioned settled table: every global row on exactly one home shard
    # (key % n_shards); pendings become a bounded ring (kernel engine) or the
    # blocked cache's spill-through-eviction buffer (module doc).
    partitioned: bool = False
    spill_blocks: int = 64

    def __post_init__(self):
        if self.consistency not in _CONSISTENCY:
            raise ValueError(f"consistency must be one of {_CONSISTENCY}, "
                             f"got {self.consistency!r}")
        if self.engine not in _ENGINES:
            raise ValueError(f"engine must be one of {_ENGINES}, "
                             f"got {self.engine!r}")
        if self.engine == "kernel" and \
                self.merge.xla_reduce not in _KERNEL_KINDS:
            raise ValueError(
                f"engine='kernel' scatters through the cscatter kernel, "
                f"which has no kind for merge {self.merge.name!r} "
                f"(xla_reduce={self.merge.xla_reduce!r}); use "
                f"engine='blocked' for flexible-path merges")
        if self.engine == "blocked" and self.n_keys % self.block_rows != 0:
            raise ValueError(
                f"blocked engine: n_keys={self.n_keys} must be a multiple "
                f"of block_rows={self.block_rows}")
        if self.dtype == torch.uint32 and \
                self.merge.name not in _U32_MERGES:
            raise ValueError(
                f"uint32 tables take the merges {_U32_MERGES}, held as "
                f"int32 bit patterns; got {self.merge.name!r}")
        if self.spill_blocks < 1:
            raise ValueError(f"spill_blocks must be >= 1, "
                             f"got {self.spill_blocks}")
        if not 0 < self.n_keys < 2**31:
            raise ValueError(f"n_keys must be in [1, 2**31), got "
                             f"{self.n_keys}")


def _rechunk_records(records, S: int, batch: Optional[int] = None):
    """Re-chunk journaled ``(keys, vals)`` tick batches for replay into a
    store with ``S`` shards. When every record already has leading dim
    ``S`` and one common width (same-shaped store), records pass through
    untouched — bitwise-identical replay. Otherwise valid entries (key >=
    0) are flattened, re-padded, and regrouped into uniform ``[S, batch]``
    ticks (one record may become several); commutativity makes any
    regrouping settle to the same table."""
    records = [(np.asarray(k), np.asarray(v)) for k, v in records]
    if not records:
        return
    if (batch is None
            and all(k.shape[0] == S for k, _ in records)
            and len({k.shape[1] for k, _ in records}) == 1):
        yield from records
        return
    if batch is None:
        batch = max([1] + [int(np.ceil((k >= 0).sum() / S))
                           for k, _ in records])
    per = S * batch
    for k, v in records:
        kf = k.reshape(-1)
        vf = v.reshape(-1, v.shape[-1])
        ok = kf >= 0
        kf, vf = kf[ok], vf[ok]
        for lo in range(0, max(len(kf), 1), per):
            ck, cv = kf[lo:lo + per], vf[lo:lo + per]
            pk = np.full((per,), -1, np.int32)
            pv = np.zeros((per, v.shape[-1]), v.dtype)
            pk[:len(ck)] = ck
            pv[:len(ck)] = cv
            yield (pk.reshape(S, batch), pv.reshape(S, batch, v.shape[-1]))


class ShardedKV:
    """The store: a host-side driver around per-tick programs on stacked
    state (leading shard dim, one device)."""

    def __init__(self, config: KVConfig, n_shards: int, *,
                 device="cuda", plan: Optional[MergePlan] = None,
                 schedule: Optional[DeferSchedule] = None,
                 commit_every: Optional[int] = None):
        if n_shards < 2:
            raise ValueError("ShardedKV needs n_shards >= 2 (a single shard "
                             "has nothing to reconcile)")
        self.config = config
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.axis = StackedAxis(n_shards, self.device)
        # uint32 values live as int32 bits (module doc)
        self._u32 = config.dtype == torch.uint32
        self._dtype = torch.int32 if self._u32 else config.dtype
        self._bias = _SIGN_BIT if self._u32 and config.merge.name in (
            "max", "min") else 0
        self.plan = plan if plan is not None else serving_plan(n_shards)
        merge = config.merge

        all_stages = compile_plan(self.plan, n_shards, merge_fn=merge)
        stages = [s for s in all_stages if s.defer]
        self._deferred_names = tuple(s.name for s in stages)
        self.n_deferred = len(stages)
        self.synchronized = self.n_deferred == 0
        # fully deferred (no eager stages): a non-commit tick has no
        # exchange at all, so updates coalesce straight into the resident
        # pending — the merge-on-evict hot path, one table pass per tick
        self._fully_deferred = len(all_stages) == self.n_deferred > 0
        if self.synchronized:
            if schedule is not None or commit_every is not None:
                raise ValueError("plan has no deferred levels; a commit "
                                 "schedule is meaningless — drop it or use "
                                 "a :defer plan")
        else:
            if schedule is None:
                if commit_every is None:
                    commit_every = DEFAULT_COMMIT_EVERY
                if commit_every < 1:
                    raise ValueError(
                        f"commit_every must be >= 1 (got {commit_every}); "
                        f"a zero/negative interval has no commit ticks — "
                        f"use plan=serving_plan(n, 'none') for a "
                        f"synchronized store")
                schedule = DeferSchedule.fixed(commit_every,
                                               self._deferred_names)
            elif commit_every is not None:
                raise ValueError("pass schedule= or commit_every=, not both")
            if not isinstance(schedule, (DeferSchedule,
                                         AdaptiveDeferSchedule)):
                raise TypeError(
                    f"schedule must be a DeferSchedule or an "
                    f"AdaptiveDeferSchedule, got {type(schedule).__name__}")
            if tuple(schedule.level_names) != self._deferred_names:
                raise ValueError(
                    f"schedule levels {schedule.level_names} do not match "
                    f"the plan's deferred stages {self._deferred_names}")
        self.schedule = schedule
        if config.engine == "blocked" and not self.synchronized:
            eager = [lv.name for lv in self.plan.levels
                     if lv.size > 1 and not lv.defer]
            if eager:
                raise ValueError(
                    f"engine='blocked' needs a fully deferred plan: eager "
                    f"levels {eager} would settle per tick while the "
                    f"resident cache withholds unmerged mass from them; "
                    f"use serving_plan(n, 'all') or engine='kernel'")

        self.partitioned = config.partitioned
        self._overlap = bool(schedule is not None and schedule.overlap)
        if self._overlap and not config.partitioned:
            raise ValueError(
                "schedule.overlap=True: the overlapped (launch/land) commit "
                "is the partitioned store's pipeline — set "
                "KVConfig(partitioned=True) or drop overlap")
        if config.partitioned:
            if self.synchronized:
                raise ValueError(
                    "partitioned=True needs deferred commits (the "
                    "partitioned table only settles at commit ticks); "
                    "use a :defer plan")
            if not self._fully_deferred:
                raise ValueError(
                    "partitioned=True needs a fully deferred plan: the "
                    "partitioned pendings (ring/spill) only drain at "
                    "commits, so an eager level would never settle; use "
                    "serving_plan(n, 'all')")
            if config.n_keys % n_shards != 0:
                raise ValueError(
                    f"partitioned=True: n_keys={config.n_keys} must be a "
                    f"multiple of n_shards={n_shards} (each shard homes "
                    f"n_keys/n_shards rows)")
            if len(set(schedule.intervals)) > 1:
                raise ValueError(
                    f"partitioned=True commits all-or-nothing (one commit "
                    f"tick settles the whole cascade), so the schedule "
                    f"must be uniform; got nested intervals "
                    f"{schedule.intervals}")
            if self._overlap:
                merge.check_overlap("ShardedKV(partitioned, overlap)")

        # -- device state (leading shard dim; :meth:`_fresh_state`). The
        # partitioned kernel store's ring is sized at the first tick, when
        # the fixed batch shape is first seen (:meth:`_fresh_ring`).
        self.settled, self.pendings, self.cache, self.spill = \
            self._fresh_state()
        self.ring = None
        self._ring_batch = None
        self.inflight = None
        self._land_pending = False
        self._t = 0
        # durability (attach_journal / snapshot / recover)
        self._journal: Optional[UpdateJournal] = None
        self._dur_root: Optional[str] = None
        self._replaying = False
        self.last_snapshot_seconds: Optional[dict] = None

        # -- per-tick programs, created once -------------------------------
        self._tick_fns: dict[Any, Callable] = {}
        if self.synchronized:
            self._tick_fns["sync"] = self._make_sync_tick()
            self._read_fn = self._make_read()
        elif config.partitioned:
            for land in ((False, True) if self._overlap else (False,)):
                for full in (False, True):
                    self._tick_fns[("p", full, land)] = \
                        self._make_part_tick(full, land)
            self._flush_fn = self._make_part_flush(land=False)
            if self._overlap:
                self._flush_land_fn = self._make_part_flush(land=True)
            self._read_fns = {"plain": self._make_part_read("plain")}
            if config.consistency == "read_your_writes":
                self._read_fns["ryw"] = self._make_part_read("ryw")
                if self._overlap:
                    self._read_fns["ryw_inflight"] = \
                        self._make_part_read("ryw_inflight")
        else:
            for due in range(self.n_deferred + 1):
                self._tick_fns[due] = self._make_deferred_tick(due)
            self._flush_fn = self._make_flush()
            self._read_fn = self._make_read()

    # ------------------------------------------------------------------
    # per-tick program builders (closures created once)
    # ------------------------------------------------------------------

    def _identity(self, shape) -> torch.Tensor:
        return self.config.merge.identity(shape, self._dtype,
                                          device=self.device)

    def _fresh_state(self) -> tuple:
        """The state a new store holds, ``(settled, pendings, cache,
        spill)``: identity tables (the settled rows home-sharded when
        partitioned, no pending tables then) and, for the blocked engine, a
        cold cache and (partitioned) an empty spill buffer, else None. Real
        ``[S, ...]`` tensors, never broadcast views: the kernels write the
        pendings in place."""
        cfg, S = self.config, self.n_shards
        R, D = cfg.n_keys, cfg.cols
        if cfg.partitioned:
            settled, pendings = self._identity((S, R // S, D)), ()
        else:
            settled = self._identity((S, R, D))
            pendings = tuple(self._identity((S, R, D))
                             for _ in range(self.n_deferred))
        cache = spill = None
        if cfg.engine == "blocked":
            cache = blocked.init_cache(S, cfg.ways, cfg.block_rows, D,
                                       self._dtype, self.device)
            if cfg.partitioned:
                spill = blocked.init_spill(S, cfg.spill_blocks,
                                           cfg.block_rows, D, self._dtype,
                                           cfg.merge, self.device)
        return settled, pendings, cache, spill

    def _fresh_ring(self, batch: int) -> tuple:
        """An empty pending ring of the partitioned kernel store for ticks
        of ``batch`` updates a shard: keys ``[S, C]`` (-1), values ``[S, C,
        D]`` (identity) and the cursor 0, ``C = max_period * batch``. Every
        shard appends the same batch a tick, so one cursor serves all."""
        C = self.schedule.max_period * batch
        return (torch.full((self.n_shards, C), -1, dtype=torch.int32,
                           device=self.device),
                self._identity((self.n_shards, C, self.config.cols)), 0)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """Values of the table's dtype as the state holds them."""
        return x.view(torch.int32) ^ self._bias if self._u32 else x

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        """State values as values of the table's dtype."""
        return (x ^ self._bias).view(torch.uint32) if self._u32 else x

    def _identity_table(self) -> torch.Tensor:
        cfg = self.config
        return self._identity((self.n_shards, cfg.n_keys, cfg.cols))

    def _scatter_into(self, table: torch.Tensor, keys: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """Every shard's scatter phase, one kernel launch: fold this tick's
        updates into ``table`` in place (a fresh identity table for a delta,
        or the resident pending itself on the fully-deferred hot path — for
        the kernel kinds ``apply == combine``, so ``scatter(pending, ...)``
        equals ``combine(pending, scatter(identity, ...))``)."""
        return scatter(table, keys, vals, kind=self.config.merge.xla_reduce)

    def _scatter_delta(self, keys, vals) -> torch.Tensor:
        """This tick's updates as a privatized delta table."""
        return self._scatter_into(self._identity_table(), keys, vals)

    def _padded(self, keys, vals):
        """Padding keys become identity updates on row 0 — a combine no-op
        that still touches block 0 and moves the LRU clock, as in the
        reference (its scan model has no skip lane)."""
        cfg = self.config
        ok = (keys >= 0) & (keys < cfg.n_keys)
        vals = torch.where(ok[..., None], vals, self._identity((cfg.cols,)))
        return torch.where(ok, keys, 0), vals

    def _blocked_delta(self, cache, keys, vals):
        """Run the tick's updates through the resident BlockedCache; the
        returned table holds only the mass *evicted* this tick."""
        return blocked.cop_scatter(cache, self._identity_table(),
                                   *self._padded(keys, vals),
                                   self.config.merge)

    def _make_sync_tick(self):
        merge, axis, plan = self.config.merge, self.axis, self.plan

        def sync_tick(settled, keys, vals):
            delta = self._scatter_delta(keys, vals)
            full = ccache.hierarchical_merge(delta, axis, merge, plan)
            return merge.apply(settled, full)

        return sync_tick

    def _make_deferred_tick(self, due: int):
        merge, axis, plan = self.config.merge, self.axis, self.plan
        full = due == self.n_deferred

        if self.config.engine == "blocked":
            def tick(settled, pendings, cache, keys, vals):
                cache, delta = self._blocked_delta(cache, keys, vals)
                if due > 0:
                    # commit tick: the resident (unevicted) mass must
                    # enter the cascade too — the explicit merge instr.
                    cache, delta = blocked.flush(cache, delta, merge)
                new_p, agg = ccache.defer_cascade(delta, list(pendings),
                                                  due, axis, merge, plan)
                if full:
                    settled = merge.apply(settled, agg)
                return settled, tuple(new_p), cache
        elif self._fully_deferred:
            def tick(settled, pendings, keys, vals):
                # hot path: coalesce straight into the resident pending
                p0 = self._scatter_into(pendings[0], keys, vals)
                if due == 0:
                    return settled, (p0,) + tuple(pendings[1:])
                new_p, agg = ccache.defer_cascade(
                    self._identity_table(), [p0] + list(pendings[1:]),
                    due, axis, merge, plan)
                if full:
                    settled = merge.apply(settled, agg)
                return settled, tuple(new_p)
        else:
            def tick(settled, pendings, keys, vals):
                delta = self._scatter_delta(keys, vals)
                new_p, agg = ccache.defer_cascade(delta, list(pendings),
                                                  due, axis, merge, plan)
                if full:
                    settled = merge.apply(settled, agg)
                return settled, tuple(new_p)

        return tick

    def _make_flush(self):
        merge, axis, plan = self.config.merge, self.axis, self.plan
        due = self.n_deferred

        if self.config.engine == "kernel":
            def flush_fn(settled, pendings):
                new_p, agg = ccache.defer_cascade(
                    self._identity_table(), list(pendings), due, axis, merge,
                    plan)
                return merge.apply(settled, agg), tuple(new_p)
        else:
            def flush_fn(settled, pendings, cache):
                cache, delta = blocked.flush(cache, self._identity_table(),
                                             merge)
                new_p, agg = ccache.defer_cascade(delta, list(pendings),
                                                  due, axis, merge, plan)
                return merge.apply(settled, agg), tuple(new_p), cache

        return flush_fn

    # -- partitioned-mode builders ---------------------------------------

    def _home_rows(self, agg: torch.Tensor) -> torch.Tensor:
        """Each shard's home rows of a stacked ``[S, n_keys, cols]``
        aggregate: global row ``r`` lives on shard ``r % S`` at local index
        ``r // S`` — a diagonal gather ``agg[s, :, s, :]`` of the
        ``[S, R/S, S, D]`` view."""
        S = self.n_shards
        ranks = self.axis.index()
        return agg.reshape(S, self.config.n_keys // S, S,
                           self.config.cols)[ranks, :, ranks]

    def _ring_append(self, ring, keys, vals):
        rk, rv, cur = ring
        b = keys.shape[1]
        if cur + b > rk.shape[1]:
            raise RuntimeError(f"pending ring overflow: {cur} + {b} > "
                               f"{rk.shape[1]} slots")
        rk[:, cur:cur + b] = keys
        rv[:, cur:cur + b] = vals
        return rk, rv, cur + b

    def _ring_reset(self, ring):
        rk, rv, _ = ring
        rk.fill_(-1)
        rv.copy_(self._identity(rv.shape))
        return rk, rv, 0

    def _part_delta(self, ring) -> torch.Tensor:
        """The ring's buffered updates as a transient dense global delta
        (unwritten slots hold key ``-1`` — scatter's ignore convention)."""
        rk, rv, _ = ring
        return self._scatter_into(self._identity_table(), rk, rv)

    def _part_ingest(self, pending: tuple, keys, vals) -> tuple:
        """One tick into the partitioned pending state: a ring append
        (kernel engine), or the resident cache with evictions spilling into
        the bounded buffer (blocked engine; padding as in :meth:`_padded`)."""
        if self.config.engine == "kernel":
            return (self._ring_append(*pending, keys, vals),)
        return blocked.spill_scatter(*pending, *self._padded(keys, vals),
                                     self.config.merge)

    def _part_drain(self, pending: tuple):
        """Commit side: the pending state as a transient dense global delta,
        and the state emptied — the ring scattered (one kernel launch), or
        the cache's dirty ways and the spilled blocks merged."""
        if self.config.engine == "kernel":
            (ring,) = pending
            delta = self._part_delta(ring)
            return (self._ring_reset(ring),), delta
        merge = self.config.merge
        cache, spill = pending
        cache, delta = blocked.flush(cache, self._identity_table(), merge)
        spill, delta = blocked.spill_drain(spill, delta, merge)
        return (cache, spill), delta

    def _make_part_tick(self, full: bool, land: bool):
        merge, axis, plan = self.config.merge, self.axis, self.plan
        overlap = self._overlap
        n = 1 if self.config.engine == "kernel" else 2   # pending tensors

        def tick(settled, *args):
            # args: the pending state, the in-flight launch when landing,
            # keys, vals
            pending = self._part_ingest(args[:n], *args[-2:])
            if land:
                # land the previous commit's launched aggregate
                agg = ccache.settle_inflight(args[n], axis, merge, plan)
                settled = merge.apply(settled, self._home_rows(agg))
            if not full:
                return (settled, *pending)
            pending, delta = self._part_drain(pending)
            if overlap:
                return (settled, *pending,
                        ccache.launch_inflight(delta, axis, merge, plan))
            agg = ccache.settle_deferred(delta, axis, merge, plan)
            return (merge.apply(settled, self._home_rows(agg)), *pending)

        return tick

    def _make_part_flush(self, land: bool):
        merge, axis, plan = self.config.merge, self.axis, self.plan
        n = 1 if self.config.engine == "kernel" else 2

        def flush_fn(settled, *args):
            # args: the pending state, then the in-flight launch if landing
            if land:
                agg = ccache.settle_inflight(args[n], axis, merge, plan)
                settled = merge.apply(settled, self._home_rows(agg))
            pending, delta = self._part_drain(args[:n])
            agg = ccache.settle_deferred(delta, axis, merge, plan)
            return (merge.apply(settled, self._home_rows(agg)), *pending)

        return flush_fn

    def _reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Fold ``x`` along ``dim`` with the merge's combine (a monoid):
        pairwise halving, the identity padding odd lengths."""
        merge = self.config.merge
        while x.shape[dim] > 1:
            if x.shape[dim] % 2:
                pad = list(x.shape)
                pad[dim] = 1
                x = torch.cat([x, merge.identity(pad, x.dtype,
                                                 device=x.device)], dim)
            a, b = x.chunk(2, dim)
            x = merge.combine(a, b)
        return x.squeeze(dim)

    def _make_part_read(self, kind: str):
        cfg = self.config
        merge = cfg.merge
        S, R, D = self.n_shards, cfg.n_keys, cfg.cols
        ranks = self.axis.index()

        def base_gather(settled, keys):
            # routed reads: only keys homed on a shard answer there; off-home
            # or invalid keys return the merge identity (route with
            # BatchedFrontend, which shards traffic by key % n_shards)
            ok = (keys >= 0) & (keys < R) & (keys % S == ranks[:, None])
            local = torch.where(ok, keys // S, 0).long()
            rows = settled[ranks[:, None], local]
            return torch.where(ok[..., None], rows,
                               self._identity((D,))), ok

        if kind == "plain":
            def read(settled, keys):
                return base_gather(settled, keys)[0]
            return read

        def ring_overlay(ring, keys, ok):
            # each shard's own buffered updates for each key, folded with
            # the merge's combine; chunked over the reads to bound the
            # [S, reads, C, D] match tensor
            rk, rv, _ = ring
            out = self._identity(tuple(keys.shape) + (D,))
            step = max(1, _OVERLAY_ELEMS // (S * rk.shape[1] * D))
            for lo in range(0, keys.shape[1], step):
                k, o = keys[:, lo:lo + step], ok[:, lo:lo + step]
                match = ((rk[:, None, :] == k[:, :, None]) & o[:, :, None]
                         & (rk >= 0)[:, None, :])
                masked = torch.where(match[..., None], rv[:, None],
                                     self._identity(()))
                out[:, lo:lo + step] = self._reduce(masked, 2)
            return out

        def cache_overlay(cache, spill, keys, ok):
            # the resident way's delta(src, upd) plus any spilled mass
            return torch.where(ok[..., None], blocked.spill_read_row(
                cache, spill, torch.where(ok, keys, 0), merge),
                self._identity((D,)))

        def inflight_overlay(base, inflight, keys, ok):
            # launched-but-unlanded mass: includes this shard's own writes
            # (plus inner-group peers' — fresher, still monotone)
            safe = torch.where(ok, keys, 0).long()
            rows = inflight[ranks[:, None], safe]
            return merge.apply(base, torch.where(ok[..., None], rows,
                                                 self._identity((D,))))

        if cfg.engine == "blocked":
            def overlay(base, pending, keys, ok):
                return merge.apply(base, cache_overlay(*pending, keys, ok))
        else:
            def overlay(base, pending, keys, ok):
                return merge.apply(base, ring_overlay(*pending, keys, ok))

        if kind == "ryw":
            def read(settled, *args):
                *pending, keys = args
                base, ok = base_gather(settled, keys)
                return overlay(base, pending, keys, ok)
            return read

        if kind != "ryw_inflight":
            raise ValueError(f"unknown partitioned read kind {kind!r}")

        def read(settled, *args):
            *pending, inflight, keys = args
            base, ok = base_gather(settled, keys)
            base = inflight_overlay(base, inflight, keys, ok)
            return overlay(base, pending, keys, ok)
        return read

    def _make_read(self):
        cfg = self.config
        merge = cfg.merge
        ryw = cfg.consistency == "read_your_writes" and not self.synchronized
        ranks = self.axis.index()

        def rows_of(table, keys, ok):
            return table[ranks[:, None], torch.where(ok, keys, 0).long()]

        def masked(rows, ok):
            return torch.where(ok[..., None], rows,
                               self._identity((cfg.cols,)))

        if not ryw:
            def read(settled, keys):
                ok = (keys >= 0) & (keys < cfg.n_keys)
                return masked(rows_of(settled, keys, ok), ok)
            return read

        def pending_view(settled, pendings, keys, ok):
            # apply is elementwise, so gathering the rows first and then
            # overlaying each pending equals the reference's whole-table
            # apply followed by the gather
            view = rows_of(settled, keys, ok)
            for p in pendings:
                view = merge.apply(view, rows_of(p, keys, ok))
            return masked(view, ok)

        if cfg.engine == "kernel":
            def read(settled, pendings, keys):
                ok = (keys >= 0) & (keys < cfg.n_keys)
                return pending_view(settled, pendings, keys, ok)
            return read

        def read(settled, pendings, cache, keys):
            # a resident way's unmerged contribution overlays the settled +
            # pending view
            ok = (keys >= 0) & (keys < cfg.n_keys)
            res = blocked.resident_delta(cache, torch.where(ok, keys, 0),
                                         merge)
            return merge.apply(pending_view(settled, pendings, keys, ok),
                               masked(res, ok))
        return read

    # ------------------------------------------------------------------
    # host-side driver API
    # ------------------------------------------------------------------

    def _run(self, fn, *args, donate=()):
        return stacked_spmd(fn, *args, donate=donate)

    def _checked_keys(self, keys) -> torch.Tensor:
        """``keys`` as an int32 tensor where the caller holds it."""
        keys = torch.as_tensor(keys, dtype=torch.int32)
        if keys.dim() != 2 or keys.shape[0] != self.n_shards:
            raise ValueError(f"keys must be [n_shards={self.n_shards}, B], "
                             f"got {tuple(keys.shape)}")
        return keys

    def _keys(self, keys) -> torch.Tensor:
        return self._checked_keys(keys).to(self.device).contiguous()

    def tick(self, keys, vals) -> None:
        """Ingest one fixed-shape batch of updates: ``keys`` [S, B] int32
        (< 0 = padding), ``vals`` [S, B, cols] (numpy arrays or tensors).
        Commit policy rides the schedule; non-commit ticks of a fully
        deferred plan run zero collectives."""
        # the batch as acknowledged, where the caller holds it (host arrays
        # stay on the host until the journal has them)
        keys = self._checked_keys(keys)
        vals = torch.as_tensor(vals, dtype=self.config.dtype)
        if vals.shape != tuple(keys.shape) + (self.config.cols,):
            raise ValueError(f"vals must be {tuple(keys.shape)} + "
                             f"({self.config.cols},), got {tuple(vals.shape)}")
        if isinstance(self.schedule, AdaptiveDeferSchedule):
            # feed the real (non-padding) ingest count into the EMA before
            # the boundary re-solve can fire
            self.schedule.observe(int((keys >= 0).sum()))
        if self._journal is not None and not self._replaying:
            # write-ahead: the batch is on disk before any device work, so
            # a crash at any later point in this tick is recoverable —
            # tick() returning is the acknowledgement point
            self._journal.append(keys.cpu().numpy(), vals.cpu().numpy())
        keys = keys.to(self.device).contiguous()
        vals = self._encode(vals.to(self.device)).contiguous()
        if self.synchronized:
            self.settled = self._run(self._tick_fns["sync"], self.settled,
                                     keys, vals, donate=(0,))
            self._t += 1
            return
        if self.partitioned:
            return self._tick_partitioned(keys, vals)
        self._t += 1
        due = self.schedule.due_count(self._t)
        if self.config.engine == "kernel":
            self.settled, self.pendings = self._run(
                self._tick_fns[due], self.settled, self.pendings, keys, vals,
                donate=(0, 1))
        else:
            self.settled, self.pendings, self.cache = self._run(
                self._tick_fns[due], self.settled, self.pendings, self.cache,
                keys, vals, donate=(0, 1, 2))

    def _ensure_ring(self, shape) -> None:
        _, B = shape
        if self.ring is None:
            self.ring = self._fresh_ring(B)
            self._ring_batch = B
        elif B != self._ring_batch:
            raise ValueError(
                f"partitioned store takes one fixed tick shape: the pending "
                f"ring was sized for batch {self._ring_batch}, got {B}")

    def _check_spill_overflow(self) -> None:
        n = int(self.spill.n_overflow.sum())
        if n:
            raise RuntimeError(
                f"spill buffer overflowed {n} eviction(s) — pending mass "
                f"was dropped; raise KVConfig.spill_blocks (currently "
                f"{self.config.spill_blocks}) above the distinct blocks a "
                f"commit cycle can evict")

    def _pending_state(self) -> tuple:
        """The partitioned store's pending state: the ring, or the blocked
        engine's cache and spill buffer."""
        if self.config.engine == "kernel":
            return (self.ring,)
        return (self.cache, self.spill)

    def _set_pending_state(self, state) -> None:
        if self.config.engine == "kernel":
            (self.ring,) = state
        else:
            self.cache, self.spill = state

    def _tick_partitioned(self, keys, vals) -> None:
        if self.config.engine == "kernel":
            self._ensure_ring(keys.shape)
        self._t += 1
        due = self.schedule.due_count(self._t)
        if due not in (0, self.n_deferred):  # guarded at init (uniform)
            raise RuntimeError(f"partitioned commit must be all-or-nothing, "
                               f"got due={due}")
        full = due == self.n_deferred
        land = self._land_pending
        fn = self._tick_fns[("p", full, land)]
        pending = self._pending_state()
        extra = (self.inflight,) if land else ()
        out = self._run(fn, self.settled, *pending, *extra, keys, vals,
                        donate=tuple(range(1 + len(pending) + len(extra))))
        self.settled = out[0]
        self._set_pending_state(out[1:1 + len(pending)])
        if full and self._overlap:
            self.inflight = out[-1]
            self._land_pending = True
        elif land:
            self.inflight = None
            self._land_pending = False
        if full and self.spill is not None:
            self._check_spill_overflow()

    def read(self, keys) -> torch.Tensor:
        """Serve one fixed-shape batch of gets: ``keys`` [S, B] -> [S, B,
        cols] on the store's device.  Zero collectives either way:
        ``eventual`` reads the last settled table; ``read_your_writes``
        overlays the shard's own unmerged pendings (+ resident cache and
        spill, blocked engine)."""
        keys = self._keys(keys)
        if self.partitioned:
            out = self._read_partitioned(keys)
        elif self.synchronized or self.config.consistency == "eventual":
            out = self._run(self._read_fn, self.settled, keys)
        elif self.config.engine == "kernel":
            out = self._run(self._read_fn, self.settled, self.pendings, keys)
        else:
            out = self._run(self._read_fn, self.settled, self.pendings,
                            self.cache, keys)
        return self._decode(out)

    def _read_partitioned(self, keys) -> torch.Tensor:
        ryw = self.config.consistency == "read_your_writes"
        if not ryw or (self.config.engine == "kernel" and self.ring is None):
            # before the first tick there is nothing pending anywhere —
            # the settled-only read IS read-your-writes
            return self._run(self._read_fns["plain"], self.settled, keys)
        pending = self._pending_state()
        if self._land_pending:
            return self._run(self._read_fns["ryw_inflight"], self.settled,
                             *pending, self.inflight, keys)
        return self._run(self._read_fns["ryw"], self.settled, *pending,
                         keys)

    def flush(self) -> None:
        """Commit everything outstanding (pendings, ring, resident cache and
        spill, an in-flight launch). After a flush the settled table equals
        the fully-synchronized reference over the same update stream —
        bitwise, for integer ADD. Resets the schedule phase."""
        if self.synchronized:
            return
        if self.partitioned:
            self._flush_partitioned()
        elif self.config.engine == "kernel":
            self.settled, self.pendings = self._run(
                self._flush_fn, self.settled, self.pendings, donate=(0, 1))
        else:
            self.settled, self.pendings, self.cache = self._run(
                self._flush_fn, self.settled, self.pendings, self.cache,
                donate=(0, 1, 2))
        self._t = 0
        if isinstance(self.schedule, AdaptiveDeferSchedule):
            self.schedule.reset()

    def _flush_partitioned(self) -> None:
        land = self._land_pending
        if self.config.engine == "kernel" and self.ring is None:
            return  # nothing ever ingested (land implies a prior tick)
        fn = self._flush_land_fn if land else self._flush_fn
        pending = self._pending_state()
        extra = (self.inflight,) if land else ()
        out = self._run(fn, self.settled, *pending, *extra,
                        donate=tuple(range(1 + len(pending) + len(extra))))
        self.settled = out[0]
        self._set_pending_state(out[1:])
        self.inflight = None
        self._land_pending = False
        if self.spill is not None:
            self._check_spill_overflow()

    def table(self) -> np.ndarray:
        """The settled table on the host.  Replicated mode returns shard 0's
        copy; partitioned mode reassembles the home-sharded rows
        (``out[s::S] = shard s``)."""
        if not self.partitioned:
            return self._decode(self.settled[0]).cpu().numpy()
        parts = self._decode(self.settled).cpu().numpy()  # (S, R // S, D)
        out = np.empty((self.config.n_keys, self.config.cols), parts.dtype)
        for s in range(self.n_shards):
            out[s::self.n_shards] = parts[s]
        return out

    # ------------------------------------------------------------------
    # state transfer (the reference store's arrays, host-side)
    # ------------------------------------------------------------------

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The store's state as numpy arrays, with the JAX store's shapes:
        ``settled``, ``pending_{i}``, ``ring_keys``/``ring_vals``/
        ``ring_cursor`` once the ring exists, the blocked engine's
        ``cache_<field>`` and ``spill_<field>`` leaves (the fields of
        ``BlockedCache`` and ``SpillBuffer``), ``inflight`` while a launch
        is in flight, ``t`` and ``land_pending``."""
        def values(x):
            return self._decode(x).cpu().numpy()

        out = {"settled": values(self.settled)}
        for i, p in enumerate(self.pendings):
            out[f"pending_{i}"] = values(p)
        for name, leaf in self._blocked_leaves():
            out[name] = (values(leaf) if name in _VALUE_LEAVES
                         else leaf.cpu().numpy())
        if self.ring is not None:
            rk, rv, cur = self.ring
            out["ring_keys"] = rk.cpu().numpy()
            out["ring_vals"] = values(rv)
            out["ring_cursor"] = np.full((self.n_shards,), cur, np.int32)
        if self.inflight is not None:
            out["inflight"] = values(self.inflight)
        out["t"] = np.asarray(self._t, np.int64)
        out["land_pending"] = np.asarray(self._land_pending)
        return out

    def load_state(self, arrays: dict[str, np.ndarray]) -> None:
        """Install state read off a store of the same configuration (this
        port's :meth:`state_arrays`, or the JAX store's arrays under the
        same keys). Shapes are checked against this store's."""
        def put(name, like: torch.Tensor, values: bool = False
                ) -> torch.Tensor:
            a = np.array(arrays[name])    # a private, writable copy
            if a.shape != tuple(like.shape):
                raise ValueError(f"load_state: {name} has shape {a.shape}, "
                                 f"this store needs {tuple(like.shape)}")
            if values and self._u32:
                a = a.astype(np.uint32).view(np.int32) ^ np.int32(self._bias)
            return torch.as_tensor(a, device=self.device).to(like.dtype)

        self.settled = put("settled", self.settled, True)
        self.pendings = tuple(put(f"pending_{i}", p, True)
                              for i, p in enumerate(self.pendings))
        for prefix in ("cache", "spill"):
            state = getattr(self, prefix)
            if state is not None:
                setattr(self, prefix, type(state)(**{
                    f.name: put(name, getattr(state, f.name),
                                name in _VALUE_LEAVES)
                    for f in dataclasses.fields(state)
                    for name in [f"{prefix}_{f.name}"]}))
        if self.partitioned and "ring_keys" in arrays:
            S = self.n_shards
            rk = np.asarray(arrays["ring_keys"])
            C = rk.shape[1] if rk.ndim == 2 else -1
            if C % self.schedule.max_period:
                raise ValueError(f"load_state: ring of {C} slots is not a "
                                 f"multiple of the period "
                                 f"{self.schedule.max_period}")
            self._ring_batch = None
            self.ring = None
            self._ensure_ring((S, C // self.schedule.max_period))
            cursor = np.asarray(arrays["ring_cursor"]).reshape(-1)
            if len(set(cursor.tolist())) != 1:
                raise ValueError(f"load_state: shards disagree on the ring "
                                 f"cursor {cursor.tolist()}")
            self.ring = (put("ring_keys", self.ring[0]),
                         put("ring_vals", self.ring[1], True),
                         int(cursor[0]))
        self._land_pending = bool(np.asarray(arrays.get("land_pending",
                                                        False)))
        self.inflight = None
        if self._land_pending:
            cfg = self.config
            self.inflight = put("inflight", self._identity(
                (self.n_shards, cfg.n_keys, cfg.cols)), True)
        self._t = int(np.asarray(arrays.get("t", 0)))

    # ------------------------------------------------------------------
    # durability: write-ahead journal + flush-consistent snapshots
    # ------------------------------------------------------------------

    def attach_journal(self, root: str, sync: bool = False) -> None:
        """Journal every subsequent acknowledged tick under ``root``
        (write-ahead, see ``serve.journal``; ``sync=True`` also fsyncs each
        record). Call before serving traffic; :meth:`snapshot` and
        :meth:`recover` then lose no acknowledged mass to a crash. A tick
        handed tensors on the card pays a device-to-host copy of its batch
        for the journal."""
        self._dur_root = root
        self._journal = UpdateJournal(root, sync=sync)

    def durable_manifest(self) -> dict:
        """Identity of the durable state (the snapshot's extras), as the JAX
        store writes it. :meth:`recover` requires the table geometry and
        merge to match; shard count, engine and layout may differ (the
        saved table is global, the journal re-chunks to any shard count)."""
        cfg = self.config
        return {
            "n_keys": int(cfg.n_keys), "cols": int(cfg.cols),
            # numpy's name of the dtype, as the JAX store records it
            "dtype": str(cfg.dtype).removeprefix("torch."),
            "merge": cfg.merge.name,
            "engine": cfg.engine, "n_shards": int(self.n_shards),
            "partitioned": bool(self.partitioned),
            "plan": checkpoint.plan_fingerprint(self.plan, self.n_shards,
                                                merge_name=cfg.merge.name),
            "schedule": (checkpoint.schedule_fingerprint(self.schedule)
                         if self.schedule is not None else None),
        }

    def _check_durable_compat(self, saved: dict) -> None:
        mine = self.durable_manifest()
        for k in ("n_keys", "cols", "dtype", "merge"):
            if saved.get(k) != mine[k]:
                raise ValueError(
                    f"recover: snapshot {k}={saved.get(k)!r} does not match "
                    f"this store's {k}={mine[k]!r} — the settled table is "
                    f"not interpretable under a different {k}")

    def _install_table(self, table: np.ndarray) -> None:
        """Land a global ``(n_keys, cols)`` settled table, values of the
        table's dtype, into this store's layout (the inverse of
        :meth:`table`), encoded as the state holds them."""
        cfg, S = self.config, self.n_shards
        if table.shape != (cfg.n_keys, cfg.cols):
            raise ValueError(f"snapshot table shape {table.shape} != "
                             f"({cfg.n_keys}, {cfg.cols})")
        t = self._encode(torch.as_tensor(np.ascontiguousarray(table),
                                         dtype=cfg.dtype).to(self.device))
        if self.partitioned:
            # global row r lives on shard r % S at local row r // S
            t = t.reshape(cfg.n_keys // S, S, cfg.cols).transpose(0, 1)
        else:
            t = t.unsqueeze(0).expand(S, cfg.n_keys, cfg.cols)
        self.settled = t.contiguous()

    def snapshot(self) -> str:
        """Persist a flush-consistent snapshot and truncate the journal.

        Flushes (all volatile mass settles into the table), saves the
        *global* table with the two-phase-commit checkpoint writer, rotates
        the journal so replay after this snapshot starts at a fresh
        segment, and deletes the segments the snapshot made redundant.
        Crash-safe at every point: until the snapshot commits, the old
        snapshot and the full journal still reconstruct everything.
        ``last_snapshot_seconds`` keeps the host-clock seconds of its
        flush, of the table's copy to the host and of the write."""
        if self._journal is None:
            raise ValueError("snapshot() needs attach_journal(root) first — "
                             "without the journal, ticks after the snapshot "
                             "would be unrecoverable")
        t0 = time.perf_counter()
        self.flush()
        sync_device(self.device)
        t1 = time.perf_counter()
        table = self.table()
        t2 = time.perf_counter()
        seq = self._journal.segment
        next_seg = self._journal.rotate()
        path = checkpoint.save(os.path.join(self._dur_root, "snaps"), seq,
                               {"settled_global": table},
                               extras={"kv": self.durable_manifest(),
                                       "segment": next_seg,
                                       "ticks": int(self._t)})
        self._journal.gc(next_seg)
        self.last_snapshot_seconds = {"flush": t1 - t0, "copy": t2 - t1,
                                      "write": time.perf_counter() - t2}
        return path

    def recover(self, root: str, batch: Optional[int] = None,
                sync: bool = False) -> dict:
        """Rebuild a crashed store's state from ``root`` and re-attach.

        Loads the latest committed snapshot (if any) into this store's
        layout, then replays every intact journaled tick since through
        :meth:`tick`. Call on a fresh store; the table geometry and merge
        must match the snapshot's, but ``n_shards``, engine and layout may
        all differ: records re-chunk to this store's shard count
        (``batch`` sets the replayed tick width; a partitioned kernel
        engine store fixes its batch at its first tick). After recovery the
        *flushed* table equals the crashed store's acknowledged history,
        bitwise, and the journal is attached again. The report names the
        snapshot step, the replayed ticks and the host-clock seconds of
        the load, the install and the replay."""
        if self._t:
            raise ValueError("recover() must run on a fresh store (this "
                             "one has already ticked)")
        t0 = time.perf_counter()
        start_seg = 0
        report = {"snapshot_step": None, "replayed_ticks": 0}
        snaps = os.path.join(root, "snaps")
        step = checkpoint.latest_step(snaps) if os.path.isdir(snaps) else None
        raw = None
        if step is not None:
            raw, manifest = checkpoint.load_raw(snaps, step=step)
            extras = manifest.get("extras", {})
            self._check_durable_compat(extras.get("kv", {}))
            start_seg = int(extras.get("segment", 0))
            report["snapshot_step"] = step
        records = list(UpdateJournal.replay(root, start_segment=start_seg))
        t1 = time.perf_counter()
        if raw is not None:
            self._install_table(raw["settled_global"])
            sync_device(self.device)
        t2 = time.perf_counter()
        self._replaying = True
        try:
            for keys, vals in _rechunk_records(records, self.n_shards,
                                               batch):
                self.tick(keys, vals)
                report["replayed_ticks"] += 1
        finally:
            self._replaying = False
        sync_device(self.device)
        report["seconds"] = {"load": t1 - t0, "install": t2 - t1,
                             "replay": time.perf_counter() - t2}
        self.attach_journal(root, sync=sync)
        return report

    def _blocked_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """The blocked engine's cache and spill tensors, by state name."""
        out = []
        for prefix in ("cache", "spill"):
            state = getattr(self, prefix)
            if state is not None:
                out += [(f"{prefix}_{f.name}", getattr(state, f.name))
                        for f in dataclasses.fields(state)]
        return out

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def resident_state_bytes(self) -> int:
        """Per-shard bytes of long-lived store state: the settled shard plus
        the pending machinery (dense pendings, ring, cache, spill, an
        in-flight launched aggregate). Excludes the transient dense delta a
        commit tick materializes and frees within the tick. The ring cursor
        counts as one int32 per shard, as in the reference."""
        tensors = [self.settled, *self.pendings]
        tensors += [leaf for _, leaf in self._blocked_leaves()]
        if self.ring is not None:
            tensors += list(self.ring[:2])
        if self.inflight is not None:
            tensors.append(self.inflight)
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if self.ring is not None:
            nbytes += 4 * self.n_shards
        return nbytes // self.n_shards

    def counters(self) -> dict:
        out = {"ticks": self._t, "engine": self.config.engine,
               "consistency": self.config.consistency,
               "synchronized": self.synchronized,
               "partitioned": self.partitioned}
        if not self.synchronized:
            out["schedule"] = self.schedule.as_dict()
        if self.partitioned:
            out["resident_state_bytes"] = self.resident_state_bytes()
            if self._overlap:
                out["overlap"] = True
                out["land_pending"] = self._land_pending
        if self.spill is not None:
            out["spills"] = int(self.spill.n_spills.sum())
            out["spill_overflow"] = int(self.spill.n_overflow.sum())
        if self.cache is not None:
            out.update(blocked.stats(self.cache))
        return out

    # ------------------------------------------------------------------
    # the tick programs, for the verifier (``repro_torch.analysis``)
    # ------------------------------------------------------------------

    @property
    def supported_dues(self) -> tuple:
        """The due counts the store has tick programs for: one sync
        program, all-or-nothing for a partitioned store, every prefix
        otherwise."""
        if self.synchronized:
            return ("sync",)
        if self.partitioned:
            return (0, self.n_deferred)
        return tuple(range(self.n_deferred + 1))

    def _check_land(self, land: bool) -> None:
        if land and not (self.partitioned and self._overlap):
            raise ValueError("land=True is the overlapped partitioned "
                             "store's landing tick — needs "
                             "partitioned=True and schedule.overlap")

    def raw_tick_fn(self, due: Optional[int] = None,
                    land: bool = False) -> Callable:
        """The tick program :meth:`tick` runs, on stacked arguments (the
        order :meth:`tick_args` gives). ``due=None`` on a synchronized store
        is the sync tick, on a partitioned one the full commit;
        ``land=True`` is the overlapped store's landing variant (the tick
        that settles the in-flight aggregate)."""
        self._check_land(land)
        if self.synchronized:
            return self._tick_fns["sync"]
        if self.partitioned:
            if due is None:
                due = self.n_deferred
            if due not in self.supported_dues:
                raise ValueError(f"partitioned store commits all-or-"
                                 f"nothing: due must be one of "
                                 f"{self.supported_dues}, got {due}")
            return self._tick_fns[("p", due == self.n_deferred, land)]
        if due is None:
            raise ValueError("deferred store: pass due (0..n_deferred)")
        return self._tick_fns[due]

    def raw_flush_fn(self) -> Callable:
        """The flush program (a full commit of everything outstanding)."""
        if self.synchronized:
            raise ValueError("synchronized store has nothing to flush")
        return self._flush_fn

    def tick_args(self, batch: int, land: bool = False,
                  seed: int = 0) -> tuple:
        """Example stacked arguments of :meth:`raw_tick_fn` for a tick of
        ``batch`` updates a shard: the state a new store holds
        (:meth:`_fresh_state`; the partitioned kernel store's ring sized
        for ``batch``; an identity in-flight aggregate when ``land``) and
        keys and values drawn from ``seed``. The store's own state is not
        touched."""
        self._check_land(land)
        cfg, S = self.config, self.n_shards
        rng = np.random.default_rng(seed)
        keys = torch.as_tensor(rng.integers(0, cfg.n_keys, (S, batch)),
                               dtype=torch.int32, device=self.device)
        vals = torch.as_tensor(rng.integers(1, 9, (S, batch, cfg.cols)),
                               dtype=self._dtype, device=self.device)
        settled, pendings, cache, spill = self._fresh_state()
        if self.synchronized:
            return (settled, keys, vals)
        if self.partitioned:
            state = ((self._fresh_ring(batch),) if cfg.engine == "kernel"
                     else (cache, spill))
            inflight = (self._identity_table(),) if land else ()
            return (settled, *state, *inflight, keys, vals)
        if cfg.engine == "kernel":
            return (settled, pendings, keys, vals)
        return (settled, pendings, cache, keys, vals)

    @property
    def donate_argnums(self) -> tuple:
        """The state argument positions a plain (non-landing) tick donates
        (updated in place: every one comes back in its own storage). A
        landing tick donates one more, the in-flight aggregate right after
        these, which it consumes."""
        if self.synchronized:
            return (0,)
        return (0, 1) if self.config.engine == "kernel" else (0, 1, 2)

    def scheduled_manifest(self, due: Optional[int] = None,
                           land: bool = False) -> list:
        """The collective schedule a tick runs (``ccache.program_manifest``);
        ``due=None`` = full commit. For an overlapped partitioned store the
        halves split per ``ccache.overlap_program_manifest``: a full-commit
        tick runs the launch half, the landing tick the withheld top
        exchange (a landing tick that is itself a full commit runs both,
        land first)."""
        self._check_land(land)
        merge = self.config.merge
        if self.synchronized:
            return ccache.collective_manifest(self.plan, self.n_shards,
                                              merge_fn=merge)
        if due is None:
            due = self.n_deferred
        if self.partitioned and self._overlap:
            out = []
            if land:
                out += ccache.overlap_program_manifest(
                    self.plan, self.n_shards, "land", merge_fn=merge)
            if due == self.n_deferred:
                out += ccache.overlap_program_manifest(
                    self.plan, self.n_shards, "launch", merge_fn=merge)
            return out
        return ccache.program_manifest(self.plan, self.n_shards, due,
                                       merge_fn=merge)
