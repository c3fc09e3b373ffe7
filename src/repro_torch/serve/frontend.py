"""Batched request front end for :class:`~repro_torch.serve.kv.ShardedKV`.

Over a mesh of processes (the store's ``spmd=``), every process runs the
same front end on the same request stream: the store takes each process's
row of the batch, and its reads give every process every answer.

The store is driven with ONE fixed request-batch shape ``[n_shards,
slots_per_shard]`` every tick; the host side only queues, pads, and
unpads.  Requests are routed to shards **by key** (``key % n_shards``),
so all traffic for a key funnels through one shard — which is what makes
``read_your_writes`` hold end-to-end: the shard that buffered your add is
the shard that answers your get, through its own pendings.  Slots a shard
cannot fill are padded with key ``-1`` (the store's
ignore convention); overflow waits in the queue for the next tick.

Each shard's requests form ONE FIFO: a tick drains adds from the head
until the slots fill or a get is reached, and serves gets from the head
after the tick the same way.  A get therefore never overtakes an earlier
add to its shard — program order per key is preserved even when the add
queue overflows the tick's slots.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.kv import ShardedKV


class DrainBacklog(RuntimeError):
    """A bounded :meth:`BatchedFrontend.drain` ran out of steps with
    requests still queued. ``results`` holds every get answered before the
    budget ran out; ``backlog`` is the number of queued entries left."""

    def __init__(self, results: dict, backlog: int, steps: int):
        super().__init__(
            f"drain stopped after {steps} step(s) with {backlog} queued "
            f"request(s) unanswered; raise max_steps or loop step() for "
            f"best-effort serving")
        self.results = results
        self.backlog = backlog
        self.steps = steps


class BatchedFrontend:
    """Queue adds/gets, serve them in fixed-shape ticks.

    ``add(key, val)`` enqueues an update; ``get(key)`` enqueues a read and
    returns a request id; ``step()`` runs one store tick (adds first, then
    reads) and returns ``{request_id: value}`` for every get it served.
    """

    def __init__(self, store: ShardedKV, slots_per_shard: int = 64):
        if slots_per_shard < 1:
            raise ValueError("slots_per_shard must be >= 1")
        self.store = store
        self.slots = slots_per_shard
        S = store.n_shards
        cfg = store.config
        # one FIFO per shard, entries ("add", key, val) | ("get", rid, key)
        self._q: list[deque] = [deque() for _ in range(S)]
        self._next_id = 0
        self._pad_val = cfg.merge.identity((cfg.cols,), cfg.dtype).numpy()
        self._np_dtype = self._pad_val.dtype

    def _shard(self, key: int) -> int:
        return int(key) % self.store.n_shards

    def add(self, key: int, val) -> None:
        if not 0 <= int(key) < self.store.config.n_keys:
            raise KeyError(f"key {key} out of range "
                           f"[0, {self.store.config.n_keys})")
        v = np.broadcast_to(np.asarray(val, self._np_dtype),
                            (self.store.config.cols,))
        self._q[self._shard(key)].append(("add", int(key), np.array(v)))

    def get(self, key: int) -> int:
        if not 0 <= int(key) < self.store.config.n_keys:
            raise KeyError(f"key {key} out of range "
                           f"[0, {self.store.config.n_keys})")
        rid = self._next_id
        self._next_id += 1
        self._q[self._shard(key)].append(("get", rid, int(key)))
        return rid

    @property
    def backlog(self) -> int:
        return sum(map(len, self._q))

    def step(self) -> dict[int, np.ndarray]:
        """One serving tick: drain up to ``slots`` head-of-queue adds per
        shard into a store tick, then up to ``slots`` head-of-queue gets
        per shard through a store read (FIFO per shard, see module doc).
        Always ticks (all-padding when idle) so the commit schedule
        advances uniformly with wall-clock serving, not with load."""
        S, B = self.store.n_shards, self.slots
        D = self.store.config.cols

        keys = np.full((S, B), -1, np.int32)
        vals = np.broadcast_to(self._pad_val,
                               (S, B, D)).copy()
        for s in range(S):
            for b in range(B):
                if not self._q[s] or self._q[s][0][0] != "add":
                    break
                _, keys[s, b], vals[s, b] = self._q[s].popleft()
        self.store.tick(keys, vals)

        rkeys = np.full((S, B), -1, np.int32)
        rids = np.full((S, B), -1, np.int64)
        any_get = False
        for s in range(S):
            for b in range(B):
                if not self._q[s] or self._q[s][0][0] != "get":
                    break
                _, rids[s, b], rkeys[s, b] = self._q[s].popleft()
                any_get = True
        if not any_get:
            return {}
        out = self.store.read(rkeys).cpu().numpy()
        return {int(rid): out[s, b]
                for s in range(S) for b in range(B)
                if (rid := rids[s, b]) >= 0}

    def drain(self, max_steps: Optional[int] = None, retries: int = 0,
              backoff_s: float = 0.0) -> dict[int, np.ndarray]:
        """Step until both queues are empty, or raise after the budget.

        Each shard's queue is ONE FIFO (module doc): a step serves at most
        ``slots`` head-of-line adds then at most ``slots`` head-of-line
        gets per shard, so a deep queue needs ``ceil(len / slots)`` steps
        and a bounded drain can legitimately stop with gets still queued.
        Rather than silently returning without those answers, a drain that
        exhausts its budget with requests still queued raises
        :class:`DrainBacklog` carrying the partial results and the
        leftover count — callers that want best-effort batches should loop
        :meth:`step` against :attr:`backlog` themselves.

        ``retries`` grants up to that many further ``max_steps``-step
        attempts after the first, sleeping ``backoff_s * attempt`` between
        them (linear backoff — gives a concurrent producer time to stop
        enqueueing faster than the drain serves). Retrying preserves the
        FIFO guarantee trivially: the per-shard queues are untouched
        between attempts, and every attempt's results accumulate into one
        dict, so a get is still answered after every add that preceded it
        on its shard. The terminal :class:`DrainBacklog` carries the
        results and total step count across ALL attempts.
        """
        if retries < 0 or backoff_s < 0:
            raise ValueError("retries and backoff_s must be >= 0")
        results: dict[int, np.ndarray] = {}
        total_steps = 0
        for attempt in range(retries + 1):
            if attempt:
                time.sleep(backoff_s * attempt)
            steps = 0
            while self.backlog and (max_steps is None or steps < max_steps):
                results.update(self.step())
                steps += 1
            total_steps += steps
            if not self.backlog:
                return results
        raise DrainBacklog(results, self.backlog, total_steps)
