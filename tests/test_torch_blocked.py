"""The port's blocked engine (``repro_torch.core.blocked``) and the blocked
``ShardedKV`` against the JAX package's (``repro.core.blocked`` under vmap,
the JAX store under a jit-compiled vmap executor), on the same numpy inputs.

Integer merges are held bitwise: tables, every cache and spill field, reads
after every tick and after ``flush()``, and every counter. The evict and
flush merges here run ``cmerge``'s plain version (CPU tensors); the kernel
itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.serve import KVConfig as JKVConfig
from repro.serve import ShardedKV as JShardedKV
from repro_torch.core import blocked
from repro_torch.core import merge_functions as tmf
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.serve import KVConfig, ShardedKV, serving_plan

MERGES = {"add": (jmf.ADD, tmf.ADD), "max": (jmf.MAX, tmf.MAX),
          "or": (jmf.BITWISE_OR, tmf.BITWISE_OR),
          "and": (jmf.BITWISE_AND, tmf.BITWISE_AND)}
LEVELS = ("chip", "host", "pod")


def _stacked(tree, s):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (s,) + x.shape), tree)


def _assert_state_equal(port, ref):
    """Every field of a port cache/spill equals the JAX one, bitwise."""
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def _stream(seed, s, n, rows, cols, merge, dtype=np.int32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, (s, n)).astype(np.int32)
    if dtype == np.float32:
        return ids, rng.standard_normal((s, n, cols)).astype(np.float32)
    hi = 100 if merge in ("add", "max") else 1 << 30
    return ids, rng.integers(0, hi, (s, n, cols)).astype(dtype)


def _jax_stats(cache, s):
    per = [jblocked.stats(jax.tree.map(lambda x: x[i], cache))
           for i in range(s)]
    return {k: sum(p[k] for p in per) for k in per[0]}


@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("ways,block_rows,seed", [(2, 2, 0), (3, 4, 1),
                                                  (4, 2, 2), (8, 4, 3)])
def test_cop_scatter_and_flush_match_jax(merge, ways, block_rows, seed):
    S, R, D, n = 3, 32, 3, 48
    jm, tm = MERGES[merge]
    rows, vals = _stream(seed, S, n, R, D, merge)
    table = np.random.default_rng(seed + 9).integers(
        0, 1 << 20, (S, R, D)).astype(np.int32)
    jc = _stacked(jblocked.init_cache(ways, block_rows, D, jnp.int32), S)
    jc, jt = jax.vmap(lambda c, t, r, v: jblocked.cop_scatter(c, t, r, v, jm))(
        jc, jnp.asarray(table), jnp.asarray(rows), jnp.asarray(vals))
    tc = blocked.init_cache(S, ways, block_rows, D, torch.int32, "cpu")
    tc, tt = blocked.cop_scatter(tc, torch.from_numpy(table.copy()),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(vals), tm)
    _assert_state_equal(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jc, jt = jax.vmap(lambda c, t: jblocked.flush(c, t, jm))(jc, jt)
    tc, tt = blocked.flush(tc, tt, tm)
    _assert_state_equal(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert blocked.stats(tc) == _jax_stats(jc, S)


def test_cop_scatter_float_add_matches_jax_and_the_oracle():
    S, R, D, n = 2, 32, 4, 48
    rows, vals = _stream(4, S, n, R, D, "add", np.float32)
    table = np.random.default_rng(5).standard_normal((S, R, D)).astype(
        np.float32)
    jc = _stacked(jblocked.init_cache(4, 2, D, jnp.float32), S)
    jc, jt = jax.vmap(lambda c, t, r, v: jblocked.cop_scatter(
        c, t, r, v, jmf.ADD))(jc, jnp.asarray(table), jnp.asarray(rows),
                              jnp.asarray(vals))
    jc, jt = jax.vmap(lambda c, t: jblocked.flush(c, t, jmf.ADD))(jc, jt)
    tc = blocked.init_cache(S, 4, 2, D, torch.float32, "cpu")
    tc, tt = blocked.cop_scatter(tc, torch.from_numpy(table.copy()),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(vals), tmf.ADD)
    tc, tt = blocked.flush(tc, tt, tmf.ADD)
    # the same f32 ops in the same order as the reference
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)
    want = table.astype(np.float64)
    for s in range(S):
        np.add.at(want[s], rows[s], vals[s])
    np.testing.assert_allclose(tt.numpy(), want, rtol=1e-5, atol=1e-5)
    assert blocked.stats(tc) == _jax_stats(jc, S)


def test_lru_choice_breaks_ties_to_the_first_way():
    """A miss with every way valid evicts the first way of least clock; a
    miss with free ways fills the first free one (torch's argmin returns
    the first minimum, as jnp.argmin does)."""
    S, W, BR, D = 2, 4, 2, 1
    tc = blocked.init_cache(S, W, BR, D, torch.int32, "cpu")
    tc.block_ids.copy_(torch.tensor([[3, 1, 2, 0], [-1, 5, -1, 6]]))
    tc.clock.copy_(torch.tensor([[7, 4, 4, 9], [0, 2, 0, 1]]))
    tc.dirty.copy_(torch.tensor([[True, False, True, True],
                                 [False, True, False, True]]))
    tc.tick.fill_(10)
    jc = jblocked.BlockedCache(**{f.name: jnp.asarray(getattr(tc, f.name))
                                  for f in dataclasses.fields(tc)})
    rows = np.asarray([[14, 15, 9], [14, 15, 9]], np.int32)
    vals = np.ones((S, 3, D), np.int32)
    table = np.zeros((S, 32, D), np.int32)
    jc, jt = jax.vmap(lambda c, t, r, v: jblocked.cop_scatter(
        c, t, r, v, jmf.ADD))(jc, jnp.asarray(table), jnp.asarray(rows),
                              jnp.asarray(vals))
    tc, tt = blocked.cop_scatter(tc, torch.from_numpy(table),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(vals), tmf.ADD)
    _assert_state_equal(tc, jc)
    # shard 0: block 7 evicts way 1 (clock 4, first of the tie, clean)
    assert tc.block_ids[0].tolist()[1] == 7
    # shard 1: block 7 fills way 0 (the first free way)
    assert tc.block_ids[1].tolist()[0] == 7


def _ref_counts(rows, ways, block_rows, commits=()):
    """An independent LRU model of one shard's cache: hit way, else first
    free way, else first way of least clock. Counts dirty and clean
    evictions and the flush merges at each index in ``commits`` (a flush
    after that many accesses) and at the end."""
    ids, clock, dirty = [-1] * ways, [0] * ways, [False] * ways
    out = {"evict_merges": 0, "silent_evicts": 0, "flush_merges": 0}

    def flush():
        for w in range(ways):
            if ids[w] >= 0:
                out["flush_merges" if dirty[w] else "silent_evicts"] += 1
            ids[w], dirty[w] = -1, False

    for t, r in enumerate(rows):
        if t in commits:
            flush()
        b = int(r) // block_rows
        if b in ids:
            w = ids.index(b)
        else:
            free = [i for i, x in enumerate(ids) if x < 0]
            if free:
                w = free[0]
            else:
                w = min(range(ways), key=lambda i: clock[i])
                out["evict_merges" if dirty[w] else "silent_evicts"] += 1
            ids[w] = b
        dirty[w], clock[w] = True, t
    flush()
    out["total_merges"] = out["evict_merges"] + out["flush_merges"]
    return out


@pytest.mark.parametrize("ways,block_rows,seed", [(2, 2, 0), (3, 4, 1),
                                                  (8, 2, 2)])
def test_counters_follow_an_independent_lru_model(ways, block_rows, seed):
    """Fig. 9's bookkeeping on a write-only trace, with a flush midway:
    every install drains through exactly one merge, none is silent, and
    the table gets every value."""
    S, R, D, n = 4, 64, 2, 96
    rows, vals = _stream(seed, S, n, R, D, "add")
    tc = blocked.init_cache(S, ways, block_rows, D, torch.int32, "cpu")
    tt = torch.zeros((S, R, D), dtype=torch.int32)
    half = n // 2
    r_, v_ = torch.from_numpy(rows), torch.from_numpy(vals)
    tc, tt = blocked.cop_scatter(tc, tt, r_[:, :half], v_[:, :half], tmf.ADD)
    tc, tt = blocked.flush(tc, tt, tmf.ADD)
    tc, tt = blocked.cop_scatter(tc, tt, r_[:, half:], v_[:, half:], tmf.ADD)
    tc, tt = blocked.flush(tc, tt, tmf.ADD)
    want = {k: 0 for k in ("evict_merges", "silent_evicts", "flush_merges",
                           "total_merges")}
    for s in range(S):
        for k, v in _ref_counts(rows[s], ways, block_rows, (half,)).items():
            want[k] += v
    assert blocked.stats(tc) == want
    assert want["silent_evicts"] == 0
    gold = np.zeros((S, R, D), np.int64)
    for s in range(S):
        np.add.at(gold[s], rows[s], vals[s])
    np.testing.assert_array_equal(tt.numpy(), gold)


@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("ways,slots,seed", [(2, 16, 0), (4, 8, 1),
                                             (2, 2, 2)])
def test_spill_scatter_and_drain_match_jax(merge, ways, slots, seed):
    """Spill-through-eviction, coalescing and — with 2 slots — overflow,
    field by field; then the drain into an identity delta."""
    S, R, BR, D, n = 3, 32, 4, 3, 48
    jm, tm = MERGES[merge]
    rows, vals = _stream(seed, S, n, R, D, merge)
    jc = _stacked(jblocked.init_cache(ways, BR, D, jnp.int32), S)
    js = _stacked(jblocked.init_spill(slots, BR, D, jnp.int32, jm), S)
    jc, js = jax.vmap(lambda c, s, r, v: jblocked.spill_scatter(
        c, s, r, v, jm))(jc, js, jnp.asarray(rows), jnp.asarray(vals))
    tc = blocked.init_cache(S, ways, BR, D, torch.int32, "cpu")
    ts = blocked.init_spill(S, slots, BR, D, torch.int32, tm, "cpu")
    tc, ts = blocked.spill_scatter(tc, ts, torch.from_numpy(rows),
                                   torch.from_numpy(vals), tm)
    _assert_state_equal(tc, jc)
    _assert_state_equal(ts, js)
    if slots == 2:
        assert int(ts.n_overflow.sum()) > 0

    def drain(c, s):
        delta = jm.identity((R, D), jnp.int32)
        c, delta = jblocked.flush(c, delta, jm)
        s, delta = jblocked.spill_drain(s, delta, jm)
        return c, s, delta

    jc, js, jd = jax.vmap(drain)(jc, js)
    tc, td = blocked.flush(tc, tm.identity((S, R, D), torch.int32), tm)
    ts, td = blocked.spill_drain(ts, td, tm)
    _assert_state_equal(tc, jc)
    _assert_state_equal(ts, js)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int((ts.block_ids >= 0).sum()) == 0


def test_read_rows_match_jax():
    """c_read_row (memory or the resident update copy) and spill_read_row
    (resident delta combined with spilled mass) for every row."""
    S, R, BR, D = 2, 16, 2, 2
    rows, vals = _stream(6, S, 12, R, D, "add")
    table = np.random.default_rng(7).integers(0, 50, (S, R, D)).astype(
        np.int32)
    jc = _stacked(jblocked.init_cache(2, BR, D, jnp.int32), S)
    jc, jt = jax.vmap(lambda c, t, r, v: jblocked.cop_scatter(
        c, t, r, v, jmf.ADD))(jc, jnp.asarray(table), jnp.asarray(rows),
                              jnp.asarray(vals))
    tc = blocked.init_cache(S, 2, BR, D, torch.int32, "cpu")
    tc, tt = blocked.cop_scatter(tc, torch.from_numpy(table.copy()),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(vals), tmf.ADD)
    jc2 = _stacked(jblocked.init_cache(1, BR, D, jnp.int32), S)
    js = _stacked(jblocked.init_spill(8, BR, D, jnp.int32, jmf.ADD), S)
    jc2, js = jax.vmap(lambda c, s, r, v: jblocked.spill_scatter(
        c, s, r, v, jmf.ADD))(jc2, js, jnp.asarray(rows), jnp.asarray(vals))
    tc2 = blocked.init_cache(S, 1, BR, D, torch.int32, "cpu")
    ts = blocked.init_spill(S, 8, BR, D, torch.int32, tmf.ADD, "cpu")
    tc2, ts = blocked.spill_scatter(tc2, ts, torch.from_numpy(rows),
                                    torch.from_numpy(vals), tmf.ADD)
    # every shard reads every row, in one call of each port function
    all_rows = torch.arange(R, dtype=torch.int32).expand(S, R).contiguous()
    got = blocked.c_read_row(tc, tt, all_rows).numpy()
    got_spill = blocked.spill_read_row(tc2, ts, all_rows, tmf.ADD).numpy()
    for r in range(R):
        row = jnp.full((S,), r, jnp.int32)
        want = jax.vmap(jblocked.c_read_row)(jc, jt, row)
        np.testing.assert_array_equal(got[:, r], np.asarray(want))
        want = jax.vmap(lambda c, s, x: jblocked.spill_read_row(
            c, s, x, jmf.ADD))(jc2, js, row)
        np.testing.assert_array_equal(got_spill[:, r], np.asarray(want))


# ------------------------------------------------------------ the store

S, R, D, B, T = 8, 64, 2, 8, 11      # T: a cycle multiple plus a partial
GEOMETRY = {"ways": 2, "block_rows": 4, "spill_blocks": 16}
STORES = {
    "blocked_k3": ({"commit_every": 3}, {}),
    "blocked_k1": ({"commit_every": 1}, {"ways": 4, "block_rows": 2}),
    "blocked_partitioned_k3": ({"commit_every": 3}, {"partitioned": True}),
    "blocked_partitioned_overlap_k3": ({"overlap": 3},
                                       {"partitioned": True}),
}


class _JitSpmd:
    """The JAX store's executor: vmap over the shard axis, each per-shard
    program compiled once (the store creates its programs once)."""

    def __init__(self):
        self._fns = {}

    def __call__(self, fn, *args):
        if fn not in self._fns:
            self._fns[fn] = jax.jit(jax.vmap(fn, axis_name="shards"))
        return self._fns[fn](*args)


def _pair(name, consistency="eventual", merge="add", dtype="int32"):
    kw, ckw = STORES[name]
    ckw = {**GEOMETRY, **ckw}
    jk, tk = {}, {}
    if "commit_every" in kw:
        jk["commit_every"] = tk["commit_every"] = kw["commit_every"]
    if "overlap" in kw:
        jk["schedule"] = JDeferSchedule.fixed(kw["overlap"], LEVELS,
                                              overlap=True)
        tk["schedule"] = DeferSchedule.fixed(kw["overlap"], LEVELS,
                                             overlap=True)
    jm, tm = MERGES[merge]
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, consistency=consistency,
                             engine="blocked", merge=jm,
                             dtype=getattr(jnp, dtype), **ckw),
                   S, _JitSpmd(), **jk)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, consistency=consistency,
                           engine="blocked", merge=tm,
                           dtype=getattr(torch, dtype), **ckw),
                  S, device="cpu", **tk)
    return j, t


def _kv_stream(seed, merge="add"):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    keys[:, :, -1] = -1                 # every tick carries padding
    hi = 9 if merge == "add" else 1 << 30
    vals = rng.integers(1, hi, (T, S, B, D)).astype(np.int32)
    return keys, vals


def _read_keys(seed):
    return np.random.default_rng(seed).integers(-1, R + 1, (S, 6)).astype(
        np.int32)


def _assert_in_step(j, t, rk):
    np.testing.assert_array_equal(t.table(), j.table())
    np.testing.assert_array_equal(t.read(rk).numpy(), np.asarray(j.read(rk)))
    assert t.counters() == j.counters()


@pytest.mark.parametrize("consistency", ["eventual", "read_your_writes"])
@pytest.mark.parametrize("name", sorted(STORES))
def test_blocked_store_matches_jax_bitwise_every_tick(name, consistency):
    keys, vals = _kv_stream(1)
    j, t = _pair(name, consistency)
    rk = _read_keys(2)
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        _assert_in_step(j, t, rk)
    j.flush()
    t.flush()
    _assert_in_step(j, t, rk)
    assert t.resident_state_bytes() == j.resident_state_bytes()
    want = np.zeros((R, D), np.int64)
    m = keys >= 0
    np.add.at(want, keys[m], vals[m])
    np.testing.assert_array_equal(t.table().astype(np.int64), want)


@pytest.mark.parametrize("merge", ["max", "and"])
def test_blocked_store_lattice_and_flexible_merges_match_jax(merge):
    """MAX rides cmerge's max kind; BITWISE_AND has no cmerge (or cscatter)
    kind and takes the flexible path of plain tensor ops."""
    keys, vals = _kv_stream(3, merge)
    for name in ("blocked_k3", "blocked_partitioned_k3"):
        j, t = _pair(name, "read_your_writes", merge)
        rk = _read_keys(4)
        for i in range(T):
            j.tick(keys[i], vals[i])
            t.tick(keys[i], vals[i])
            _assert_in_step(j, t, rk)
        j.flush()
        t.flush()
        _assert_in_step(j, t, rk)
    if merge == "and":
        want = np.full((R, D), -1, np.int32)
        for k, v in zip(keys[keys >= 0], vals[keys >= 0]):
            want[k] &= v
        np.testing.assert_array_equal(t.table(), want)


@pytest.mark.parametrize("merge", ["add", "max", "or"])
@pytest.mark.parametrize("name", ["blocked_k3", "blocked_partitioned_k3"])
def test_blocked_store_uint32_matches_jax_bitwise_every_tick(name, merge):
    """uint32 tables over the whole 32-bit range: ADD wraps, MAX compares
    unsigned (values above 2**31 must win), OR sets the top bit. The port
    holds them as int32 bits; table, reads, counters and the state arrays
    equal the JAX store's after every tick, bitwise."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    keys[:, :, -1] = -1
    vals = rng.integers(0, 1 << 32, (T, S, B, D)).astype(np.uint32)
    j, t = _pair(name, "read_your_writes", merge, "uint32")
    rk = _read_keys(9)
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        _assert_in_step(j, t, rk)
        state = t.state_arrays()
        for k, v in _jax_state(j).items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)
    j.flush()
    t.flush()
    _assert_in_step(j, t, rk)
    assert t.table().dtype == np.uint32
    ok = keys >= 0
    if merge == "max":
        want = np.zeros((R, D), np.uint32)
        np.maximum.at(want, keys[ok], vals[ok])
        assert want.max() >= 1 << 31
    else:
        want = np.zeros((R, D), np.uint64)
        if merge == "add":
            np.add.at(want, keys[ok], vals[ok].astype(np.uint64))
        else:
            np.bitwise_or.at(want, keys[ok], vals[ok].astype(np.uint64))
        want = (want & 0xFFFFFFFF).astype(np.uint32)
    np.testing.assert_array_equal(t.table(), want)


def _jax_state(j) -> dict:
    """The JAX blocked store's state under the keys of
    ``ShardedKV.load_state``."""
    out = {"settled": np.asarray(j.settled)}
    for i, p in enumerate(j.pendings):
        out[f"pending_{i}"] = np.asarray(p)
    for prefix in ("cache", "spill"):
        state = getattr(j, prefix)
        if state is not None:
            for f in dataclasses.fields(state):
                out[f"{prefix}_{f.name}"] = np.asarray(getattr(state, f.name))
    if j.inflight is not None:
        out["inflight"] = np.asarray(j.inflight)
    out["t"] = np.asarray(j._t)
    out["land_pending"] = np.asarray(j._land_pending)
    return out


@pytest.mark.parametrize("name,at", [("blocked_k3", 4),
                                     ("blocked_partitioned_k3", 5),
                                     ("blocked_partitioned_overlap_k3", 3)])
def test_blocked_load_state_mid_cycle_then_tick_on_bitwise(name, at):
    keys, vals = _kv_stream(5)
    j, t = _pair(name, "read_your_writes")
    for i in range(at):
        j.tick(keys[i], vals[i])
    t.load_state(_jax_state(j))
    state = t.state_arrays()
    assert set(state) == set(_jax_state(j))
    for k, v in _jax_state(j).items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    rk = _read_keys(6)
    for i in range(at, T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        _assert_in_step(j, t, rk)
    j.flush()
    t.flush()
    _assert_in_step(j, t, rk)


def test_read_your_writes_overlays_the_resident_cache():
    """An RYW read sees mass still resident in the cache (never evicted,
    never flushed) on the writing shard only; invalid keys read the
    identity."""
    t = ShardedKV(KVConfig(n_keys=16, cols=1, engine="blocked", ways=4,
                           block_rows=4, consistency="read_your_writes"),
                  2, device="cpu", commit_every=8)
    t.tick(np.asarray([[3, 3], [-1, -1]], np.int32),
           np.ones((2, 2, 1), np.int32))
    assert t.counters()["evict_merges"] == 0
    got = t.read(np.asarray([[3], [3]], np.int32))
    assert got[:, 0, 0].tolist() == [2, 0]
    got = t.read(np.asarray([[-1], [99]], np.int32))
    assert got[:, 0, 0].tolist() == [0, 0]


def test_spill_overflow_raises_loudly():
    cfg = KVConfig(n_keys=64, cols=1, engine="blocked", partitioned=True,
                   ways=2, block_rows=4, spill_blocks=1)
    t = ShardedKV(cfg, 4, device="cpu", commit_every=4)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="spill"):
        for _ in range(8):
            keys = rng.permutation(64)[:32].reshape(4, 8).astype(np.int32)
            t.tick(keys, np.ones((4, 8, 1), np.int32))


def test_blocked_config_and_plan_validation():
    with pytest.raises(ValueError, match="multiple"):
        KVConfig(n_keys=9, engine="blocked", block_rows=4)
    with pytest.raises(ValueError, match="spill_blocks"):
        KVConfig(n_keys=32, spill_blocks=0)
    with pytest.raises(ValueError, match="uint32"):
        KVConfig(n_keys=32, engine="blocked", dtype=torch.uint32,
                 merge=tmf.saturating_add(100.0))
    with pytest.raises(ValueError, match="fully deferred"):
        ShardedKV(KVConfig(n_keys=8, engine="blocked", block_rows=8), 8,
                  device="cpu", plan=serving_plan(8, "top"))
    # the kernel engine still refuses what cscatter has no kind for
    with pytest.raises(ValueError, match="blocked"):
        KVConfig(n_keys=8, merge=tmf.BITWISE_AND)
    KVConfig(n_keys=8, engine="blocked", merge=tmf.BITWISE_AND)


def test_synchronized_blocked_store_scatters_like_the_kernel_engine():
    """On a plan with no deferred level there is nothing for the cache to
    hold: the blocked store ticks through the scatter kernel, as the
    reference's does."""
    keys, vals = _kv_stream(7)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, engine="blocked"), S,
                  device="cpu", plan=serving_plan(S, "none"))
    k = ShardedKV(KVConfig(n_keys=R, cols=D), S, device="cpu",
                  plan=serving_plan(S, "none"))
    for i in range(T):
        t.tick(keys[i], vals[i])
        k.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), k.table())
    assert t.counters()["total_merges"] == 0
