"""The port's ShardedKV (CPU, stacked layout) against the JAX ShardedKV
(vmap executor, kernel engine) on the same int32 ADD streams.

Tables are compared bitwise after every tick and after ``flush()``; reads,
the frontend's answers, state transfer, introspection and the CLI are held
to the reference as well.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.traces import key_stream as jax_key_stream
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.core.merge_functions import ADD as JADD
from repro.core.merge_functions import BITWISE_OR as JOR
from repro.core.merge_functions import MAX as JMAX
from repro.serve import BatchedFrontend as JFrontend
from repro.serve import KVConfig as JKVConfig
from repro.serve import ShardedKV as JShardedKV
from repro.serve import serving_plan as jserving_plan
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_functions import ADD, BITWISE_OR, MAX
from repro_torch.launch import kv_serve
from repro_torch.serve import BatchedFrontend, KVConfig, ShardedKV, \
    serving_plan

S, R, D, B, T = 8, 64, 2, 8, 11      # T: a cycle multiple plus a partial
LEVELS = ("chip", "host", "pod")


def _spmd(fn, *args):
    return jax.vmap(fn, axis_name="shards")(*args)


def _stream(seed, ticks=T):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R, (ticks, S, B)).astype(np.int32)
    keys[:, :, -1] = -1                 # every tick carries padding
    vals = rng.integers(1, 9, (ticks, S, B, D)).astype(np.int32)
    return keys, vals


STORES = {
    "sync": ({"plan": "none"}, {}),
    "deferred_k1": ({"commit_every": 1}, {}),
    "deferred_k3": ({"commit_every": 3}, {}),
    "deferred_k8": ({"commit_every": 8}, {}),
    "deferred_top_k3": ({"plan": "top", "commit_every": 3}, {}),
    "partitioned_k3": ({"commit_every": 3}, {"partitioned": True}),
    "partitioned_overlap_k3": ({"overlap": 3}, {"partitioned": True}),
}


def _pair(name, consistency="eventual"):
    """The JAX store and the port's, built from the same description."""
    kw, ckw = STORES[name]
    jk, tk = {}, {}
    if "plan" in kw:
        jk["plan"] = jserving_plan(S, kw["plan"])
        tk["plan"] = serving_plan(S, kw["plan"])
    if "commit_every" in kw:
        jk["commit_every"] = tk["commit_every"] = kw["commit_every"]
    if "overlap" in kw:
        jk["schedule"] = JDeferSchedule.fixed(kw["overlap"], LEVELS,
                                              overlap=True)
        tk["schedule"] = DeferSchedule.fixed(kw["overlap"], LEVELS,
                                             overlap=True)
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, consistency=consistency,
                             **ckw), S, _spmd, **jk)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, consistency=consistency, **ckw),
                  S, device="cpu", **tk)
    return j, t


def _jax_state(j) -> dict:
    """The JAX store's state under the keys of ``ShardedKV.load_state``."""
    out = {"settled": np.asarray(j.settled)}
    for i, p in enumerate(j.pendings):
        out[f"pending_{i}"] = np.asarray(p)
    if j.ring is not None:
        rk, rv, cur = j.ring
        out.update(ring_keys=np.asarray(rk), ring_vals=np.asarray(rv),
                   ring_cursor=np.asarray(cur))
    if j.inflight is not None:
        out["inflight"] = np.asarray(j.inflight)
    out["t"] = np.asarray(j._t)
    out["land_pending"] = np.asarray(j._land_pending)
    return out


def _read_keys(seed):
    return np.random.default_rng(seed).integers(-1, R + 1, (S, 6)).astype(
        np.int32)


@pytest.mark.parametrize("consistency", ["eventual", "read_your_writes"])
@pytest.mark.parametrize("name", sorted(STORES))
def test_store_matches_jax_bitwise_every_tick(name, consistency):
    keys, vals = _stream(1)
    j, t = _pair(name, consistency)
    rk = _read_keys(2)
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), j.table())
        np.testing.assert_array_equal(t.read(rk).numpy(),
                                      np.asarray(j.read(rk)))
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), j.table())
    np.testing.assert_array_equal(t.read(rk).numpy(), np.asarray(j.read(rk)))
    # after a flush every store holds the serialization of the stream
    want = np.zeros((R, D), np.int64)
    m = keys >= 0
    np.add.at(want, keys[m], vals[m])
    np.testing.assert_array_equal(t.table().astype(np.int64), want)


@pytest.mark.parametrize("name", sorted(STORES))
def test_introspection_matches_jax(name):
    keys, vals = _stream(3, ticks=4)
    j, t = _pair(name)
    for i in range(4):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
    assert t.supported_dues == j.supported_dues
    assert t.resident_state_bytes() == j.resident_state_bytes()
    jc, tc = j.counters(), t.counters()
    assert {k: v for k, v in tc.items() if k != "engine"} == \
        {k: v for k, v in jc.items() if k != "engine"}
    for due in (None,) + tuple(d for d in t.supported_dues if d != "sync"):
        lands = (False, True) if t._overlap else (False,)
        for land in lands:
            got = [dataclasses.asdict(m) for m in
                   t.scheduled_manifest(due, land=land)]
            want = [dataclasses.asdict(m) for m in
                    j.scheduled_manifest(due, land=land)]
            assert got == want


@pytest.mark.parametrize("name,at", [
    ("deferred_k3", 4), ("deferred_k8", 5), ("deferred_top_k3", 2),
    ("partitioned_k3", 4), ("partitioned_overlap_k3", 3),
    ("partitioned_overlap_k3", 5), ("sync", 2)])
def test_load_state_mid_cycle_then_tick_on_bitwise(name, at):
    """Read a JAX store's state mid-cycle (pendings, ring, an in-flight
    launch), load it into the port, and tick both on."""
    keys, vals = _stream(4)
    j, t = _pair(name, "read_your_writes")
    for i in range(at):
        j.tick(keys[i], vals[i])
    t.load_state(_jax_state(j))
    state = t.state_arrays()
    for k, v in _jax_state(j).items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    assert set(state) == set(_jax_state(j))
    rk = _read_keys(5)
    for i in range(at, T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), j.table())
        np.testing.assert_array_equal(t.read(rk).numpy(),
                                      np.asarray(j.read(rk)))
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), j.table())


def test_state_arrays_round_trip_between_ports():
    keys, vals = _stream(6)
    _, a = _pair("partitioned_overlap_k3")
    _, b = _pair("partitioned_overlap_k3")
    for i in range(3):
        a.tick(keys[i], vals[i])
    b.load_state(a.state_arrays())
    for i in range(3, T):
        a.tick(keys[i], vals[i])
        b.tick(keys[i], vals[i])
    a.flush()
    b.flush()
    np.testing.assert_array_equal(a.table(), b.table())
    with pytest.raises(ValueError, match="shape"):
        b.load_state({**a.state_arrays(), "settled": np.zeros((1, 2, 3))})


def _drive_frontend(fe, seed):
    rng = np.random.default_rng(seed)
    rids, out = [], {}
    for _ in range(300):
        key = int(rng.integers(0, R))
        if rng.random() < 0.6:
            fe.add(key, int(rng.integers(1, 9)))
        else:
            rids.append(fe.get(key))
        if rng.random() < 0.05:
            out.update(fe.step())
    out.update(fe.drain())
    return rids, out


@pytest.mark.parametrize("name", ["deferred_k3", "partitioned_k3",
                                  "partitioned_overlap_k3"])
def test_frontend_answers_match_jax(name):
    j, t = _pair(name, "read_your_writes")
    jr, jout = _drive_frontend(JFrontend(j, slots_per_shard=4), 7)
    tr, tout = _drive_frontend(BatchedFrontend(t, slots_per_shard=4), 7)
    assert jr == tr and set(jout) == set(tout) == set(tr)
    for rid in tr:
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))


def test_max_store_matches_jax():
    keys, vals = _stream(8)
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, merge=JMAX), S, _spmd,
                   commit_every=3)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, merge=MAX), S, device="cpu",
                  commit_every=3)
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), j.table())


def test_store_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedKV(KVConfig(n_keys=R, cols=D), S)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_serve.main(["--keys", "64", "--ticks", "2", "--batch", "4"])


def test_unported_engine_and_journal_raise(tmp_path):
    """Both engines and the journal are ported: each engine journals and
    snapshots, and what still raises is misuse — a snapshot without a
    journal, a recovery onto a store that has ticked."""
    keys, vals = _stream(15, ticks=3)
    for engine in ("kernel", "blocked"):
        t = ShardedKV(KVConfig(n_keys=R, cols=D, engine=engine), S,
                      device="cpu")
        with pytest.raises(ValueError, match="attach_journal"):
            t.snapshot()
        root = str(tmp_path / engine)
        t.attach_journal(root)
        for i in range(3):
            t.tick(keys[i], vals[i])
        assert t.snapshot().endswith("step_00000000")
        t.tick(keys[0], vals[0])
        with pytest.raises(ValueError, match="fresh"):
            t.recover(root)


@pytest.mark.parametrize("dist", ["uniform", "pareto"])
def test_key_stream_is_the_benchmark_stream(dist):
    np.testing.assert_array_equal(
        kv_serve.key_stream(5000, 1 << 20, dist, n_users=1 << 16, seed=3),
        jax_key_stream(5000, 1 << 20, dist, n_users=1 << 16, seed=3))


@pytest.mark.parametrize("flags", [
    ["--defer", "sync"], ["--defer", "4"], ["--defer", "4", "--partitioned"],
    ["--defer", "4", "--partitioned", "--overlap",
     "--consistency", "read_your_writes"],
    ["--defer", "4", "--engine", "blocked", "--ways", "4"],
    ["--defer", "sync", "--engine", "blocked"],
    ["--defer", "4", "--engine", "blocked", "--partitioned", "--overlap",
     "--spill-blocks", "32", "--consistency", "read_your_writes"]])
def test_cli_runs_on_the_cpu(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        kv_serve.main(["--device", "cpu", "--keys", "256", "--ticks", "9",
                       "--batch", "16", "--shards", "8", *flags])
    text = out.getvalue()
    assert "updates/s" in text
    assert f"settled mass col0: {9 * 8 * 16}" in text
    if "blocked" in flags:
        assert "engine=blocked" in text and "evict_merges:" in text
    if "--spill-blocks" in flags:
        assert "spill_overflow: 0" in text


@pytest.mark.parametrize("flags", [["--defer", "auto", "--overlap"],
                                   ["--defer", "sometimes"],
                                   ["--overlap"],
                                   ["--defer", "sync", "--partitioned"]])
def test_cli_refuses_what_is_not_ported_or_inconsistent(flags):
    """Every --defer mode is ported; inconsistent flags still exit."""
    with pytest.raises(SystemExit):
        kv_serve.main(["--device", "cpu", "--keys", "256", "--ticks", "2",
                       *flags])


@pytest.mark.parametrize("merge", ["add", "max", "or"])
@pytest.mark.parametrize("name", ["sync", "deferred_k3", "partitioned_k3"])
def test_uint32_store_matches_jax_bitwise_every_tick(name, merge):
    """The kernel engine on uint32 tables over the whole 32-bit range,
    held as int32 bits (MAX biased into signed order): table and reads
    equal the JAX store's after every tick."""
    kw, ckw = STORES[name]
    jk = {k: jserving_plan(S, v) if k == "plan" else v for k, v in kw.items()}
    tk = {k: serving_plan(S, v) if k == "plan" else v for k, v in kw.items()}
    jm, tm = {"add": (JADD, ADD), "max": (JMAX, MAX),
              "or": (JOR, BITWISE_OR)}[merge]
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, merge=jm, dtype=jnp.uint32,
                             consistency="read_your_writes", **ckw),
                   S, _spmd, **jk)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, merge=tm, dtype=torch.uint32,
                           consistency="read_your_writes", **ckw),
                  S, device="cpu", **tk)
    keys, _ = _stream(12)
    vals = np.random.default_rng(13).integers(
        0, 1 << 32, (T, S, B, D)).astype(np.uint32)
    rk = _read_keys(14)
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), j.table())
        np.testing.assert_array_equal(t.read(rk).numpy(),
                                      np.asarray(j.read(rk)))
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), j.table())
    assert t.table().dtype == np.uint32
