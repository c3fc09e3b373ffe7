"""The port's durability against the JAX package's: the write-ahead journal,
checkpoints, fingerprints, and the store's snapshot / recover.

The journal and checkpoint tests of ``tests/test_durability.py`` run on the
port; journals and snapshots written by either package recover through the
other; fingerprints and ``durable_manifest()`` equal JAX's; every recovery
is held bitwise against the JAX store recovering from the same directory
and against the numpy replay of the acknowledged stream.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import \
    AdaptiveDeferSchedule as JAdaptiveDeferSchedule
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.core.merge_plan import MergePlan as JMergePlan
from repro.serve import KVConfig as JKVConfig
from repro.serve import ShardedKV as JShardedKV
from repro.serve import UpdateJournal as JUpdateJournal
from repro.serve import serving_plan as jserving_plan
from repro.serve.kv import _rechunk_records as j_rechunk_records
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import (manifests_compatible, plan_fingerprint,
                                    schedule_fingerprint, tree_keys)
from repro_torch.core import merge_functions as tmf
from repro_torch.core.defer_schedule import (AdaptiveDeferSchedule,
                                             DeferSchedule)
from repro_torch.core.merge_plan import MergePlan, compile_plan
from repro_torch.serve import (KVConfig, ShardedKV, UpdateJournal,
                               serving_plan)
from repro_torch.serve.journal import list_segments
from repro_torch.serve.kv import _rechunk_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spmd(fn, *args):
    return jax.vmap(fn, axis_name="shards")(*args)


class _JitSpmd:
    """The JAX store's executor for the blocked engine: vmap over the shard
    axis, each per-shard program compiled once."""

    def __init__(self):
        self._fns = {}

    def __call__(self, fn, *args):
        if fn not in self._fns:
            self._fns[fn] = jax.jit(jax.vmap(fn, axis_name="shards"))
        return self._fns[fn](*args)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def _records(n, S=4, B=3, D=2, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-1, 16, (S, B)).astype(np.int32),
             rng.integers(0, 9, (S, B, D)).astype(np.int32))
            for _ in range(n)]


def test_journal_roundtrip_and_segments(tmp_path):
    root = str(tmp_path)
    j = UpdateJournal(root)
    recs = _records(3)
    for k, v in recs[:2]:
        j.append(k, v)
    seg0 = j.segment
    j.rotate()
    j.append(*recs[2])
    j.close()
    got = list(UpdateJournal.replay(root))
    assert len(got) == 3
    for (k, v), (gk, gv) in zip(recs, got):
        assert np.array_equal(k, gk) and np.array_equal(v, gv)
    tail = list(UpdateJournal.replay(root, start_segment=seg0 + 1))
    assert len(tail) == 1 and np.array_equal(tail[0][0], recs[2][0])


def test_journal_new_instance_opens_fresh_segment(tmp_path):
    root = str(tmp_path)
    j1 = UpdateJournal(root)
    j1.append(*_records(1)[0])
    s1 = j1.segment
    j1.close()
    j2 = UpdateJournal(root)
    assert j2.segment > s1
    j2.close()


def test_journal_gc_drops_old_segments(tmp_path):
    root = str(tmp_path)
    j = UpdateJournal(root)
    j.append(*_records(1)[0])
    new_seg = j.rotate()
    j.append(*_records(1, seed=1)[0])
    assert j.gc(new_seg) == 1
    j.close()
    assert list_segments(root) == [new_seg]
    assert len(list(UpdateJournal.replay(root))) == 1


def test_journal_torn_tail_tolerated(tmp_path):
    root = str(tmp_path)
    j = UpdateJournal(root)
    for k, v in _records(2):
        j.append(k, v)
    seg = j.segment
    j.close()
    with open(os.path.join(root, "segments", f"seg_{seg:08d}.log"),
              "ab") as f:
        f.write(b"KVJ1\x40\x00\x00\x00partial")
    assert len(list(UpdateJournal.replay(root))) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_through_the_other_package(tmp_path, writer):
    """Same framing: a journal written by either package (with a rotation
    and a torn tail) replays bitwise through the other."""
    root = str(tmp_path)
    W, Rd = ((JUpdateJournal, UpdateJournal) if writer == "jax"
             else (UpdateJournal, JUpdateJournal))
    recs = _records(4, seed=3) + [(np.arange(6, dtype=np.int32).reshape(2, 3),
                                   np.full((2, 3, 1), 1 << 31, np.uint32))]
    j = W(root)
    for k, v in recs[:2]:
        j.append(k, v)
    j.rotate()
    for k, v in recs[2:]:
        j.append(k, v)
    seg = j.segment
    j.close()
    with open(os.path.join(root, "segments", f"seg_{seg:08d}.log"),
              "ab") as f:
        f.write(b"KVJ1\x10\x00\x00\x00torn")
    got = list(Rd.replay(root))
    assert len(got) == len(recs)
    for (k, v), (gk, gv) in zip(recs, got):
        assert gk.dtype == k.dtype and gv.dtype == v.dtype
        assert np.array_equal(k, gk) and np.array_equal(v, gv)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_tree_keys_and_load_raw(tmp_path):
    pending = ({"w": torch.ones((8, 3), dtype=torch.int32)},)
    tree = {"params": {"w": np.arange(3, dtype=np.int32)},
            "defer": {"t": np.int32(2), "pending": pending}}
    keys = tree_keys(tree)
    assert keys == jckpt.tree_keys(
        {"params": {"w": np.arange(3, dtype=np.int32)},
         "defer": {"t": np.int32(2),
                   "pending": ({"w": np.ones((8, 3), np.int32)},)}})
    assert "defer/pending/0/w" in keys
    ckpt.save(str(tmp_path), 0, tree)
    leaves, manifest = ckpt.load_raw(str(tmp_path))
    assert sorted(leaves) == sorted(keys)
    assert np.array_equal(leaves["defer/pending/0/w"], np.ones((8, 3)))
    assert ckpt.latest_step(str(tmp_path)) == 0
    assert manifest["step"] == 0


def test_load_raw_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_raw(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) is None


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """bf16 and fp8 leaves round-trip through torch alone: the child
    process cannot import ml_dtypes at all."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None     # any import of it now fails
        import torch
        from repro_torch import checkpoint as ckpt
        x = torch.randn(5, 3).to(torch.bfloat16)
        f8 = torch.randn(7).to(torch.float8_e4m3fn)
        ckpt.save({str(tmp_path)!r}, 2, {{"x": x, "f8": f8}})
        leaves, man = ckpt.load_raw({str(tmp_path)!r})
        assert leaves["x"].dtype == torch.bfloat16
        assert torch.equal(leaves["x"].view(torch.int16),
                           x.view(torch.int16))
        assert torch.equal(leaves["f8"].view(torch.int8),
                           f8.view(torch.int8))
        assert "ml_dtypes" not in {{m for m, v in sys.modules.items() if v}}
        print("BF16_OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "BF16_OK" in r.stdout, r.stderr[-2000:]


def test_checkpoints_load_in_the_other_package(tmp_path):
    """A checkpoint written by either package loads in the other: integer
    and float arrays as they were, bf16 as the same bits."""
    bits = np.random.default_rng(0).integers(0, 1 << 16, (4, 3)).astype(
        np.uint16)
    ints = np.arange(12, dtype=np.uint32).reshape(3, 4) * 7919
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jax_dir, 5, {"b": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
                            "u": ints}, extras={"kv": {"n": 1}})
    ckpt.save(port_dir, 5, {"b": torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16), "u": torch.from_numpy(ints)},
        extras={"kv": {"n": 1}})
    got, man = ckpt.load_raw(jax_dir)
    assert got["b"].dtype == torch.bfloat16
    assert np.array_equal(got["b"].view(torch.int16).numpy().view(np.uint16),
                          bits)
    assert np.array_equal(got["u"], ints) and man["extras"]["kv"] == {"n": 1}
    got, man = jckpt.load_raw(port_dir)
    assert got["b"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(got["b"].view(np.uint16), bits)
    assert np.array_equal(got["u"], ints) and got["u"].dtype == np.uint32
    assert jckpt.latest_step(port_dir) == ckpt.latest_step(jax_dir) == 5


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,lane,n,merge", [
    ("chip:2,host:2,pod:2:defer", True, 8, "add"),
    ("chip:2,host:2:defer,pod:2:defer", True, 8, "max"),
    ("chip:4,pod:2:defer", False, 8, "add"),
    ("chip:2:xla,host:2:ici,pod:4:dci:defer", True, 16, "or"),
    ("chip:2:compress,pod:2", False, 4, None)])
def test_plan_fingerprint_equals_jax(spec, lane, n, merge):
    assert plan_fingerprint(MergePlan.parse(spec, lane_parallel=lane), n,
                            merge_name=merge) == \
        jckpt.plan_fingerprint(JMergePlan.parse(spec, lane_parallel=lane), n,
                               merge_name=merge)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("defer", ["all", "top", "none"])
def test_serving_plan_fingerprint_equals_jax(n, defer):
    assert plan_fingerprint(serving_plan(n, defer), n, merge_name="add") == \
        jckpt.plan_fingerprint(jserving_plan(n, defer), n, merge_name="add")


def test_schedule_fingerprints_equal_jax_fixed_and_adaptive():
    for k, names, overlap in ((2, ("pod",), False), (3, ("pod",), False),
                              (2, ("pod",), True),
                              (8, ("chip", "host", "pod"), True)):
        assert schedule_fingerprint(DeferSchedule.fixed(k, names, overlap)) \
            == jckpt.schedule_fingerprint(JDeferSchedule.fixed(k, names,
                                                               overlap))
    spec = "chip:2,host:2,pod:2:defer"
    nested = DeferSchedule(("host", "pod"), (2, 6))
    assert schedule_fingerprint(nested) == jckpt.schedule_fingerprint(
        JDeferSchedule(("host", "pod"), (2, 6)))
    seen = set()
    for k_min, k_max, overlap in ((1, 8, False), (1, 16, False),
                                  (2, 16, True)):
        port = AdaptiveDeferSchedule(MergePlan.parse(spec), [64.0] * 3,
                                     k_min=k_min, k_max=k_max,
                                     overlap=overlap, bandwidths=[1e9] * 3)
        ref = JAdaptiveDeferSchedule(JMergePlan.parse(spec), [64.0] * 3,
                                     k_min=k_min, k_max=k_max,
                                     overlap=overlap, bandwidths=[1e9] * 3)
        fp = schedule_fingerprint(port)
        assert fp == jckpt.schedule_fingerprint(ref)
        seen.add(fp)
    assert len(seen) == 3


def test_manifests_compatible_equals_jax():
    base = {"plan": "p", "schedule": "s", "dp": 8}
    cases = [(base, dict(base)), (base, None), (None, base),
             (base, {**base, "schedule": "t"}), (base, {**base, "dp": 4}),
             (base, {**base, "plan": "q", "extra": 1})]
    for a, b in cases:
        assert manifests_compatible(a, b) == jckpt.manifests_compatible(a, b)
    assert manifests_compatible(base, dict(base))


# ---------------------------------------------------------------------------
# snapshot / recover
# ---------------------------------------------------------------------------


def _kv_stream(T, S, B, D, R, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    keys[:, :, -1] = -1
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    oracle = np.zeros((R, D), np.int64)
    np.add.at(oracle, keys[keys >= 0], vals[keys >= 0])
    return keys, vals, oracle.astype(np.int32)


def _pair(S, R, D, spmd=_spmd, **kw):
    """A JAX store and the port's from one description (config keywords,
    plan/commit_every/overlap K)."""
    ckw = {k: v for k, v in kw.items()
           if k not in ("plan", "commit_every", "overlap")}
    jk, tk = {}, {}
    if "plan" in kw:
        jk["plan"], tk["plan"] = jserving_plan(S, kw["plan"]), \
            serving_plan(S, kw["plan"])
    if "commit_every" in kw:
        jk["commit_every"] = tk["commit_every"] = kw["commit_every"]
    if "overlap" in kw:
        names = tuple(s.name for s in compile_plan(
            tk.get("plan", serving_plan(S)), S) if s.defer)
        jk["schedule"] = JDeferSchedule.fixed(kw["overlap"], names, True)
        tk["schedule"] = DeferSchedule.fixed(kw["overlap"], names, True)
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, **ckw), S, spmd, **jk)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, **ckw), S, device="cpu", **tk)
    return j, t


def test_recover_replays_to_exact_oracle(tmp_path):
    S, B, D, R, T = 4, 6, 2, 32, 10
    keys, vals, oracle = _kv_stream(T, S, B, D, R)
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, device="cpu",
                   commit_every=3)
    kv.attach_journal(root)
    for t in range(T // 2):
        kv.tick(keys[t], vals[t])
    kv.snapshot()
    for t in range(T // 2, T):
        kv.tick(keys[t], vals[t])
    del kv
    j, t = _pair(S, R, D, commit_every=3)
    jrep, rep = j.recover(root), t.recover(root)
    j.flush()
    t.flush()
    assert rep["replayed_ticks"] == jrep["replayed_ticks"] == T - T // 2
    assert rep["snapshot_step"] == jrep["snapshot_step"] is not None
    np.testing.assert_array_equal(t.table(), oracle)
    np.testing.assert_array_equal(t.table(), j.table())


def test_recover_onto_different_shard_count_and_layout(tmp_path):
    S, B, D, R, T = 4, 6, 2, 64, 8
    keys, vals, oracle = _kv_stream(T, S, B, D, R, seed=3)
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, device="cpu",
                   commit_every=3)
    kv.attach_journal(root)
    for t in range(T):
        kv.tick(keys[t], vals[t])
    del kv
    j, t = _pair(2 * S, R, D, partitioned=True, plan="all", commit_every=2)
    j.recover(root)
    t.recover(root)
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), oracle)
    np.testing.assert_array_equal(t.table(), j.table())


def test_recover_without_snapshot_replays_everything(tmp_path):
    S, B, D, R, T = 2, 4, 1, 16, 5
    keys, vals, oracle = _kv_stream(T, S, B, D, R, seed=11)
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, device="cpu")
    kv.attach_journal(root)
    for t in range(T):
        kv.tick(keys[t], vals[t])
    del kv
    j, t = _pair(S, R, D)
    jrep, rep = j.recover(root), t.recover(root)
    j.flush()
    t.flush()
    assert rep == {**jrep, "seconds": rep["seconds"]}
    assert rep["snapshot_step"] is None and rep["replayed_ticks"] == T
    np.testing.assert_array_equal(t.table(), oracle)
    np.testing.assert_array_equal(t.table(), j.table())


def test_recover_refuses_incompatible_store(tmp_path):
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=16, cols=2), 2, device="cpu")
    kv.attach_journal(root)
    kv.tick(np.zeros((2, 2), np.int32), np.ones((2, 2, 2), np.int32))
    kv.snapshot()
    del kv
    for bad in (KVConfig(n_keys=16, cols=3), KVConfig(n_keys=32, cols=2),
                KVConfig(n_keys=16, cols=2, merge=tmf.MAX),
                KVConfig(n_keys=16, cols=2, dtype=torch.uint32)):
        with pytest.raises(ValueError, match="does not match"):
            ShardedKV(bad, 2, device="cpu").recover(root)
    with pytest.raises(ValueError):
        JShardedKV(JKVConfig(n_keys=16, cols=3), 2, _spmd).recover(root)


def test_recover_refuses_nonfresh_store(tmp_path):
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=16, cols=2), 2, device="cpu")
    kv.attach_journal(root)
    kv.tick(np.zeros((2, 2), np.int32), np.ones((2, 2, 2), np.int32))
    kv.snapshot()
    kv2 = ShardedKV(KVConfig(n_keys=16, cols=2), 2, device="cpu")
    kv2.tick(np.zeros((2, 2), np.int32), np.ones((2, 2, 2), np.int32))
    with pytest.raises(ValueError, match="fresh"):
        kv2.recover(root)
    with pytest.raises(ValueError, match="attach_journal"):
        ShardedKV(KVConfig(n_keys=16, cols=2), 2, device="cpu").snapshot()


@pytest.mark.parametrize("S2,batch", [(4, None), (8, None), (2, None),
                                      (8, 5)])
def test_rechunk_passthrough_and_regroup_equal_jax(S2, batch):
    recs = _records(3, S=4, B=3)
    out = list(_rechunk_records(recs, S2, batch))
    ref = list(j_rechunk_records(recs, S2, batch))
    assert len(out) == len(ref)
    for (k, v), (jk, jv) in zip(out, ref):
        assert np.array_equal(k, jk) and np.array_equal(v, jv)
    if S2 == 4 and batch is None:       # same shard count: untouched
        for (k, v), (rk, rv) in zip(recs, out):
            assert np.array_equal(k, rk) and np.array_equal(v, rv)
    want = sorted((int(k), tuple(int(x) for x in v)) for ks, vs in recs
                  for k, v in zip(ks.ravel(), vs.reshape(-1, 2)) if k >= 0)
    got = sorted((int(k), tuple(int(x) for x in v)) for ks, vs in out
                 for k, v in zip(ks.ravel(), vs.reshape(-1, 2)) if k >= 0)
    assert got == want
    for ks, vs in out:
        assert ks.shape[0] == S2 and vs.shape[:2] == ks.shape


# the four engine x layout pairs a journal recovers onto
TARGETS = {
    "kernel": {},
    "kernel_partitioned_overlap": {"partitioned": True, "overlap": 2},
    "blocked": {"engine": "blocked", "block_rows": 4, "ways": 2},
    "blocked_partitioned": {"engine": "blocked", "block_rows": 4, "ways": 2,
                            "partitioned": True, "spill_blocks": 64,
                            "commit_every": 3},
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_recover_onto_every_engine_and_layout(tmp_path, target, writer):
    """A journal and snapshot written by a 4-shard store of either package
    recover onto 8 shards of every engine x layout in both packages: the
    flushed tables equal each other and the oracle, bitwise."""
    S, B, D, R, T = 4, 6, 2, 64, 9
    keys, vals, oracle = _kv_stream(T, S, B, D, R, seed=21)
    root = str(tmp_path)
    j, t = _pair(S, R, D, commit_every=3)
    kv = t if writer == "port" else j
    kv.attach_journal(root)
    for i in range(T):
        kv.tick(keys[i], vals[i])
        if i == 3:
            kv.snapshot()
    del kv, j, t
    kw = dict(TARGETS[target])
    spmd = _JitSpmd() if kw.get("engine") == "blocked" else _spmd
    j, t = _pair(2 * S, R, D, spmd=spmd, plan="all", **kw)
    jrep, rep = j.recover(root), t.recover(root)
    assert rep["replayed_ticks"] == jrep["replayed_ticks"]
    for i in range(2):                   # serve on after the recovery
        t.tick(keys[i].reshape(2 * S, B // 2), vals[i].reshape(2 * S, B // 2,
                                                                D))
        j.tick(keys[i].reshape(2 * S, B // 2), vals[i].reshape(2 * S, B // 2,
                                                                D))
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), j.table())
    more = np.zeros((R, D), np.int64)
    ok = keys[:2] >= 0
    np.add.at(more, keys[:2][ok], vals[:2][ok])
    np.testing.assert_array_equal(t.table().astype(np.int64),
                                  oracle.astype(np.int64) + more)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_uint32_max_table_through_snapshot_and_recover(tmp_path, writer):
    """A uint32 MAX store over the whole 32-bit range: the journal holds the
    values as given (not the port's biased int32 bits), the snapshot the
    decoded table; both packages recover it onto a partitioned layout."""
    S, B, D, R, T = 4, 6, 2, 32, 8
    rng = np.random.default_rng(9)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 32, (T, S, B, D)).astype(np.uint32)
    want = np.zeros((R, D), np.uint32)
    np.maximum.at(want, keys[keys >= 0], vals[keys >= 0])
    root = str(tmp_path)
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, dtype=jnp.uint32,
                             merge=jmf.MAX), S, _spmd, commit_every=3)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, dtype=torch.uint32,
                           merge=tmf.MAX), S, device="cpu", commit_every=3)
    kv = t if writer == "port" else j
    kv.attach_journal(root)
    for i in range(T):
        kv.tick(keys[i], vals[i])
        if i == 4:
            kv.snapshot()
    for k, v in UpdateJournal.replay(root):
        assert k.dtype == np.int32 and v.dtype == np.uint32
    del kv, j, t
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, dtype=jnp.uint32,
                             merge=jmf.MAX, partitioned=True), 2 * S, _spmd,
                   plan=jserving_plan(2 * S, "all"), commit_every=2)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, dtype=torch.uint32,
                           merge=tmf.MAX, partitioned=True), 2 * S,
                  device="cpu", plan=serving_plan(2 * S, "all"),
                  commit_every=2)
    j.recover(root)
    t.recover(root)
    j.flush()
    t.flush()
    assert t.table().dtype == np.uint32
    np.testing.assert_array_equal(t.table(), want)
    np.testing.assert_array_equal(t.table(), j.table())


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
@pytest.mark.parametrize("kw", [{}, {"partitioned": True, "overlap": 3},
                                {"engine": "blocked", "block_rows": 4}])
def test_durable_manifest_equals_jax(dtype, kw):
    S, R, D = 4, 32, 2
    ckw = {k: v for k, v in kw.items() if k != "overlap"}
    jk, tk = {}, {}
    if "overlap" in kw:
        jk["schedule"] = JDeferSchedule.fixed(3, ("chip", "pod"), True)
        tk["schedule"] = DeferSchedule.fixed(3, ("chip", "pod"), True)
    j = JShardedKV(JKVConfig(n_keys=R, cols=D, dtype=getattr(jnp, dtype),
                             **ckw), S, _spmd, **jk)
    t = ShardedKV(KVConfig(n_keys=R, cols=D, dtype=getattr(torch, dtype),
                           **ckw), S, device="cpu", **tk)
    assert t.durable_manifest() == j.durable_manifest()
    assert t.durable_manifest()["dtype"] == dtype


def test_the_journal_records_the_batch_before_the_device_work(tmp_path):
    """Write-ahead: a tick whose device work fails has still journaled its
    batch; a batch the store refuses (wrong shape) is never journaled."""
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=16, cols=2), 2, device="cpu",
                   commit_every=4)
    kv.attach_journal(root)
    with pytest.raises(ValueError, match="vals"):
        kv.tick(np.zeros((2, 3), np.int32), np.ones((2, 2, 2), np.int32))
    assert list(UpdateJournal.replay(root)) == []

    def boom(*args):
        raise RuntimeError("device lost")
    kv._tick_fns = {k: boom for k in kv._tick_fns}
    with pytest.raises(RuntimeError, match="device lost"):
        kv.tick(np.ones((2, 3), np.int32), np.ones((2, 3, 2), np.int32))
    got = list(UpdateJournal.replay(root))
    assert len(got) == 1 and np.array_equal(got[0][0], np.ones((2, 3)))
