"""The KV store and the apps over a real process group: 8 CPU processes on
a gloo group, one shard each (the mesh executor, ``apps/sharded.mesh_spmd``:
the counterpart of JAX's ``mesh_spmd``, ``shard_map`` over ``"shards"``).

Every process builds the same store on its ``[1, ...]`` slice and is handed
the same numpy stream (replicated host inputs); the merge engine runs over
``core/mesh_axis.MeshAxis`` between the processes. After every tick and
after the flush, each process's ``table()`` and ``read()`` (gathered: the
whole store's value on every process) must equal, bitwise, the stacked
port's (every shard on one device) and JAX's ``ShardedKV`` under the vmap
executors of ``tests/test_torch_kv.py`` and ``tests/test_torch_blocked.py``
on the same stream. Covered: every ``STORES`` description of
``test_torch_kv.py`` under both consistencies, the max store, the uint32 max
and min stores (min against the stacked port and the oracle: JAX's
``ref_cscatter`` cannot take a uint32 min), the partitioned store under an
adaptive schedule, and the blocked and partitioned-blocked stores of
``test_torch_blocked.py``; their counters, ``resident_state_bytes`` and
``state_arrays()`` mid-cycle; a snapshot on the mesh recovered by a stacked
store and the reverse; BFS (bitwise), PageRank and k-means (within JAX's
``tests/test_apps_sharded.py`` tolerances of their references, and within
``TOL`` of the stacked run: gloo's all-reduce sums in another order); one
commit tick's recorded walk against ``wire_cost`` and the stacked store's;
the whole-store gathers heard by no listener; ``MeshAxis``'s collectives
and its gather against ``StackedAxis``.

The processes are this file run as a script (``--worker``), each writing
its output to its own log file and its results to ``rank{r}.npz``, with one
time limit for the spawn: a process that fails, or outlives the limit,
fails the module's fixture with its log's tail. Each process runs torch on
one intra-op thread and imports no ``jax``. While they run, the parent
process computes the stacked and the JAX results.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_shards

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
WORKER_TIMEOUT = 300          # seconds, every process of the spawn
S, R, D, B, T = WORLD, 64, 2, 8, 11    # test_torch_kv.py's geometry
MID = 4                       # state_arrays() and counters mid-cycle
TOL = 1e-5                    # tests/test_kernels.py TOL, float32
LEVELS = ("chip", "host", "pod")

# test_torch_kv.py STORES: (store kwargs, config kwargs)
KV_STORES = {
    "sync": ({"plan": "none"}, {}),
    "deferred_k1": ({"commit_every": 1}, {}),
    "deferred_k3": ({"commit_every": 3}, {}),
    "deferred_k8": ({"commit_every": 8}, {}),
    "deferred_top_k3": ({"plan": "top", "commit_every": 3}, {}),
    "partitioned_k3": ({"commit_every": 3}, {"partitioned": True}),
    "partitioned_overlap_k3": ({"overlap": 3}, {"partitioned": True}),
}
# test_torch_blocked.py's blocked stores and geometry
BLOCKED_STORES = {
    "blocked_k3": ({"commit_every": 3}, {}),
    "blocked_partitioned_k3": ({"commit_every": 3}, {"partitioned": True}),
}
GEOMETRY = {"ways": 2, "block_rows": 4, "spill_blocks": 16}
# the adaptive schedule of test_torch_schedule.py, over serving_plan(8)'s
# three deferred levels
ADAPTIVE = dict(base_compute_s=1e-6, per_update_s=1e-7, k_max=8,
                bandwidths=[1e9, 5e8, 2.5e8])
ADAPTIVE_WIRE = [1e3, 2e3, 4e3]


def _cases() -> dict:
    """name -> (store, consistency, merge, dtype, seed, jax): every store
    the processes run; ``jax`` is False where JAX cannot run the case."""
    out = {}
    for name in KV_STORES:
        for c in ("eventual", "read_your_writes"):
            out[f"{name}-{c}"] = (name, c, "add", "int32", 1, True)
    for name in BLOCKED_STORES:
        for c in ("eventual", "read_your_writes"):
            out[f"{name}-{c}"] = (name, c, "add", "int32", 7, True)
    out["max-deferred_k3"] = ("deferred_k3", "eventual", "max", "int32", 8,
                              True)
    out["u32_max-deferred_k3"] = ("deferred_k3", "read_your_writes", "max",
                                  "uint32", 12, True)
    out["u32_min-partitioned_k3"] = ("partitioned_k3", "read_your_writes",
                                     "min", "uint32", 12, False)
    out["partitioned_adaptive"] = ("adaptive", "eventual", "add", "int32", 5,
                                   True)
    return out


CASES = _cases()


def _stream(seed: int, dtype: str):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    keys[:, :, -1] = -1                 # every tick carries padding
    if dtype == "uint32":
        vals = np.random.default_rng(seed + 1).integers(
            0, 1 << 32, (T, S, B, D)).astype(np.uint32)
    else:
        vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    return keys, vals


def _read_keys(seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 100).integers(
        -1, R + 1, (S, 6)).astype(np.int32)


def _oracle(keys, vals, merge: str) -> np.ndarray:
    ok = keys >= 0
    if merge == "add":
        want = np.zeros((R, D), np.int64)
        np.add.at(want, keys[ok], vals[ok])
        return want
    lo = vals.dtype.type(np.iinfo(vals.dtype).min)
    hi = vals.dtype.type(np.iinfo(vals.dtype).max)
    want = np.full((R, D), lo if merge == "max" else hi, vals.dtype)
    (np.maximum if merge == "max" else np.minimum).at(want, keys[ok],
                                                      vals[ok])
    return want


def _store(case: str, spmd=None):
    """The port's store of ``case``: on the executor ``spmd``, or stacked
    on the CPU."""
    from repro_torch.core import merge_functions as mf
    from repro_torch.core.defer_schedule import (AdaptiveDeferSchedule,
                                                 DeferSchedule)
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan
    name, consistency, merge, dtype, _, _ = CASES[case]
    where = {"spmd": spmd} if spmd is not None else {"device": "cpu"}
    m = {"add": mf.ADD, "max": mf.MAX, "min": mf.MIN}[merge]
    cfg = dict(n_keys=R, cols=D, consistency=consistency, merge=m,
               dtype=getattr(torch, dtype))
    if name == "adaptive":
        return ShardedKV(KVConfig(**cfg, partitioned=True), S, **where,
                         schedule=AdaptiveDeferSchedule(
                             serving_plan(S), ADAPTIVE_WIRE, **ADAPTIVE))
    kw, ckw = {**KV_STORES, **BLOCKED_STORES}[name]
    if name in BLOCKED_STORES:
        ckw = {**GEOMETRY, **ckw, "engine": "blocked"}
    sk = {}
    if "plan" in kw:
        sk["plan"] = serving_plan(S, kw["plan"])
    if "commit_every" in kw:
        sk["commit_every"] = kw["commit_every"]
    if "overlap" in kw:
        sk["schedule"] = DeferSchedule.fixed(kw["overlap"], LEVELS,
                                             overlap=True)
    return ShardedKV(KVConfig(**cfg, **ckw), S, **where, **sk)


def _drive(kv, case: str, out: dict) -> None:
    """``case``'s stream through ``kv``: the table and a read after every
    tick and after the flush, ``state_arrays()`` and ``counters()`` after
    tick :data:`MID` and at the end, ``resident_state_bytes()``."""
    _, _, _, dtype, seed, _ = CASES[case]
    keys, vals = _stream(seed, dtype)
    rk = _read_keys(seed)
    for i in range(T):
        kv.tick(keys[i], vals[i])
        out[f"{case}/table/{i}"] = kv.table()
        out[f"{case}/read/{i}"] = kv.read(rk).numpy()
        if i == MID:
            for k, v in kv.state_arrays().items():
                out[f"{case}/state/{k}"] = v
            out[f"{case}/counters/mid"] = json.dumps(kv.counters(),
                                                     sort_keys=True)
    kv.flush()
    out[f"{case}/table/flush"] = kv.table()
    out[f"{case}/read/flush"] = kv.read(rk).numpy()
    out[f"{case}/counters/end"] = json.dumps(kv.counters(), sort_keys=True)
    out[f"{case}/rsb"] = kv.resident_state_bytes()


# the durability cases: (label, the writer's store, the recoverer's store)
DURABLE = [("mesh_to_stacked", "partitioned_overlap_k3-eventual",
            "deferred_k3-eventual"),
           ("stacked_to_mesh", "partitioned_k3-eventual",
            "deferred_k3-read_your_writes")]
SNAP_AT, DURABLE_TICKS = 4, 8


def _journal(kv, root: str) -> None:
    """Journal ticks 0..DURABLE_TICKS-1 of the durable stream, with a
    snapshot after :data:`SNAP_AT` of them; then stop, unflushed (the
    crash)."""
    keys, vals = _stream(21, "int32")
    kv.attach_journal(root)
    for i in range(DURABLE_TICKS):
        if i == SNAP_AT:
            kv.snapshot()
        kv.tick(keys[i], vals[i])


def _durable_want() -> np.ndarray:
    keys, vals = _stream(21, "int32")
    return _oracle(keys[:DURABLE_TICKS], vals[:DURABLE_TICKS], "add")


# the apps, at run_app's defaults (48 vertices, 160 edges, K = 4)
N_V, N_E, APP_K = 48, 160, 4


def _apps(spmd=None, device="cpu") -> dict:
    """BFS, PageRank and k-means on run_app's inputs (eager and deferred;
    k-means deferred and overlapped), on ``spmd`` or stacked."""
    from repro_torch.apps import run_bfs, run_kmeans, run_pagerank
    from repro_torch.apps.bfs import INF
    from repro_torch.apps.common import default_plan, shard_edges
    from repro_torch.apps.sharded import _graph
    plan, plan_d = default_plan(S), default_plan(S, defer_top=True)
    src, dst = _graph(N_V, N_E, 0)
    src_sh, dst_sh = (torch.from_numpy(x) for x in shard_edges(src, dst, S))
    dist0 = torch.full((S, N_V), INF, dtype=torch.int32)
    dist0[:, 0] = 0
    out = {
        "bfs/eager": run_bfs(dist0, src_sh, dst_sh, plan, supersteps=N_V,
                             spmd=spmd),
        "bfs/defer": run_bfs(dist0, src_sh, dst_sh, plan_d,
                             supersteps=APP_K * N_V, defer_k=APP_K,
                             spmd=spmd),
        "pagerank/eager": run_pagerank(N_V, src_sh, dst_sh, plan, alpha=0.5,
                                       supersteps=16 * APP_K, spmd=spmd),
        "pagerank/defer": run_pagerank(N_V, src_sh, dst_sh, plan_d,
                                       alpha=0.5, supersteps=16 * APP_K,
                                       defer_k=APP_K, spmd=spmd)}
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(S, 2 * APP_K, 16, 3)).astype(np.float32)
    c0 = rng.normal(size=(5, 3)).astype(np.float32)
    for label, overlap in (("defer", False), ("overlap", True)):
        out[f"kmeans/{label}"] = run_kmeans(
            torch.from_numpy(pts), torch.from_numpy(c0), plan_d,
            commit_k=APP_K, overlap=overlap, spmd=spmd)
    return {f"apps/{k}": v.numpy() for k, v in out.items()}


def _commit_walk(spmd=None) -> dict:
    """The recorded walks of a non-commit and a commit tick of the
    privatized K = 3 store (its third tick commits every level)."""
    from repro_torch.analysis.placement import walk_of
    from repro_torch.analysis.trace import record
    kv = _store("deferred_k3-eventual", spmd)
    keys, vals = _stream(1, "int32")
    sizes = [lv.size for lv in kv.plan.levels]
    walks = {}
    for i in range(3):
        _, calls = record(kv.tick, keys[i], vals[i])
        walks[f"walk/{i}"] = np.asarray(
            walk_of(calls, sizes)["wire_bytes_by_level_total"], np.float64)
    return walks


# ---------------------------------------------------------------------------
# the worker: one process, one shard
# ---------------------------------------------------------------------------


def _axis_ops(spmd, out: dict) -> None:
    """``MeshAxis``'s ppermute (with a round where rank 0 only receives
    and rank 1 only sends), psum / pmax / pmin over the axis and over
    groups of 2, and its gather, on this process's row of a seeded stack."""
    axis = spmd.axis
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -2**20, 2**20, (S, 5, 3)).astype(np.int32))
    mine = spmd.local(x)
    perms = {"shift": [(r, (r + 1) % S) for r in range(S)],
             "lone": [(1, 0)], "pairs": [(r, r ^ 1) for r in range(S)]}
    for name, perm in perms.items():
        out[f"axis/ppermute/{name}"] = spmd.gather(axis.ppermute(mine, perm))
    for kind in ("psum", "pmax", "pmin"):
        for group in (None, 2):
            out[f"axis/{kind}/{group}"] = spmd.gather(
                getattr(axis, kind)(mine, group))
    out["axis/gather"] = spmd.gather(mine)
    out["axis/index"] = spmd.gather(axis.index())


def _worker(rank: int, init: str, work: str) -> None:
    from repro_torch import hooks
    from repro_torch.apps.sharded import mesh_spmd
    from repro_torch.launch import mesh as pmesh

    torch.set_num_threads(1)
    mesh = pmesh.init_shards("gloo", "cpu", init_method=f"file://{init}",
                             rank=rank, world_size=WORLD)
    spmd = mesh_spmd(mesh)
    out = {"meta/axis": np.asarray([spmd.axis.size, spmd.axis.rank,
                                    spmd.axis.stack])}
    _axis_ops(spmd, out)
    out = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in out.items()}
    for case in CASES:
        _drive(_store(case, spmd), case, out)

    # durability: journal on the mesh for the parent to recover stacked,
    # and recover the parent's stacked journal on the mesh
    label, writer, _ = DURABLE[0]
    _journal(_store(writer, spmd), str(Path(work, label)))
    label, _, reader = DURABLE[1]
    kv = _store(reader, spmd)
    report = kv.recover(str(Path(work, label)))
    out[f"{label}/replayed"] = report["replayed_ticks"]
    kv.flush()
    out[f"{label}/table"] = kv.table()

    out.update(_apps(spmd))
    out.update(_commit_walk(spmd))

    # the whole-store gathers are not the merge's: no listener hears them
    heard = []
    kv = _store("partitioned_overlap_k3-read_your_writes", spmd)
    keys, vals = _stream(1, "int32")
    for i in range(3):
        kv.tick(keys[i], vals[i])
    with hooks.listening(lambda *e: heard.append(e[0])):
        kv.table()
        kv.read(_read_keys(1))
        kv.state_arrays()
        kv.counters()
        spmd.gather(torch.zeros(1, 1))
    out["gather/heard"] = len(heard)

    np.savez(Path(work, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    spmd.barrier()
    pmesh.shutdown()


# ---------------------------------------------------------------------------
# the parent: the spawn, the stacked and the JAX results
# ---------------------------------------------------------------------------


def _spawn(work: Path, during):
    """Run the :data:`WORLD` workers, ``during()`` here while they do
    (its value returned); a worker that fails or outlives
    :data:`WORKER_TIMEOUT` fails the spawn with its log's tail."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init = work / "init"
    return spawn_shards(lambda r: [sys.executable, __file__, "--worker",
                                   str(r), str(init), str(work)],
                        WORLD, work, WORKER_TIMEOUT, env=env, during=during)


def _jax_store(case: str):
    """JAX's ``ShardedKV`` of ``case`` under the vmap executors of
    ``test_torch_kv.py`` (kernel engine) and ``test_torch_blocked.py``
    (blocked engine), or None where JAX cannot run it."""
    import jax.numpy as jnp
    from repro.core import merge_functions as jmf
    from repro.core.defer_schedule import \
        AdaptiveDeferSchedule as JAdaptive
    from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
    from repro.serve import KVConfig as JKVConfig
    from repro.serve import ShardedKV as JShardedKV
    from repro.serve import serving_plan as jserving_plan
    from test_torch_blocked import _JitSpmd
    from test_torch_kv import _spmd
    name, consistency, merge, dtype, _, ok = CASES[case]
    if not ok:
        return None
    m = {"add": jmf.ADD, "max": jmf.MAX, "min": jmf.MIN}[merge]
    cfg = dict(n_keys=R, cols=D, consistency=consistency, merge=m,
               dtype=getattr(jnp, dtype))
    if name == "adaptive":
        return JShardedKV(JKVConfig(**cfg, partitioned=True), S, _spmd,
                          schedule=JAdaptive(jserving_plan(S), ADAPTIVE_WIRE,
                                             **ADAPTIVE))
    kw, ckw = {**KV_STORES, **BLOCKED_STORES}[name]
    spmd = _spmd
    if name in BLOCKED_STORES:
        ckw = {**GEOMETRY, **ckw, "engine": "blocked"}
        spmd = _JitSpmd()
    sk = {}
    if "plan" in kw:
        sk["plan"] = jserving_plan(S, kw["plan"])
    if "commit_every" in kw:
        sk["commit_every"] = kw["commit_every"]
    if "overlap" in kw:
        sk["schedule"] = JDeferSchedule.fixed(kw["overlap"], LEVELS,
                                              overlap=True)
    return JShardedKV(JKVConfig(**cfg, **ckw), S, spmd, **sk)


def _jax_drive(j, case: str, out: dict) -> None:
    """:func:`_drive` for JAX's store (its state under the port's keys)."""
    import test_torch_blocked
    import test_torch_kv
    _, _, _, dtype, seed, _ = CASES[case]
    keys, vals = _stream(seed, dtype)
    rk = _read_keys(seed)
    state = (test_torch_blocked._jax_state if j.config.engine == "blocked"
             else test_torch_kv._jax_state)
    for i in range(T):
        j.tick(keys[i], vals[i])
        out[f"{case}/table/{i}"] = np.asarray(j.table())
        out[f"{case}/read/{i}"] = np.asarray(j.read(rk))
        if i == MID:
            for k, v in state(j).items():
                out[f"{case}/state/{k}"] = np.asarray(v)
            out[f"{case}/counters/mid"] = j.counters()
    j.flush()
    out[f"{case}/table/flush"] = np.asarray(j.table())
    out[f"{case}/read/flush"] = np.asarray(j.read(rk))
    out[f"{case}/counters/end"] = j.counters()
    out[f"{case}/rsb"] = j.resident_state_bytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results (rank 0's and every rank's), the stacked
    port's, JAX's, and the work directory."""
    work = tmp_path_factory.mktemp("kv_mesh")
    # the stacked journal the mesh recovers, written before the spawn
    label, writer, _ = DURABLE[1]
    _journal(_store(writer), str(work / label))

    def parent():
        torch.set_num_threads(1)
        stacked, ref = {}, {}
        for case in CASES:
            _drive(_store(case), case, stacked)
        stacked.update(_apps())
        stacked.update(_commit_walk())
        for case in CASES:
            j = _jax_store(case)
            if j is not None:
                _jax_drive(j, case, ref)
        return stacked, ref

    stacked, ref = _spawn(work, parent)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, stacked, ref, work


def test_every_process_holds_the_whole_store(runs):
    """Gathered results are the whole store's on every process: every
    rank's results equal rank 0's, bitwise, and each process holds its
    own rank of an 8-rank axis, one row stacked."""
    ranks, _, _, _ = runs
    for r, res in enumerate(ranks):
        assert res["meta/axis"].tolist() == [S, r, 1]
        assert sorted(res) == sorted(ranks[0])
        for k, v in res.items():
            if not k.startswith("meta/"):
                np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


def test_cases_cover_the_stacked_tests_stores():
    """Every STORES description of test_torch_kv.py runs on the mesh
    under both consistencies, and the blocked stores are
    test_torch_blocked.py's."""
    import test_torch_blocked
    import test_torch_kv
    assert KV_STORES == test_torch_kv.STORES
    assert GEOMETRY == test_torch_blocked.GEOMETRY
    for name in BLOCKED_STORES:
        assert BLOCKED_STORES[name] == test_torch_blocked.STORES[name]
    for name in KV_STORES:
        for c in ("eventual", "read_your_writes"):
            assert f"{name}-{c}" in CASES


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_store_equals_stacked_and_jax_every_tick(runs, case):
    """The table and a read after every tick and after the flush, bitwise
    against the stacked port and JAX; the flushed table against the
    oracle of the stream."""
    ranks, stacked, ref, _ = runs
    mesh = ranks[0]
    keys = [f"{case}/{what}/{i}" for i in (*range(T), "flush")
            for what in ("table", "read")]
    for k in keys:
        np.testing.assert_array_equal(mesh[k], stacked[k], err_msg=k)
        if CASES[case][5]:
            np.testing.assert_array_equal(mesh[k], ref[k], err_msg=k)
    _, _, merge, dtype, seed, _ = CASES[case]
    stream_keys, vals = _stream(seed, dtype)
    want = _oracle(stream_keys, vals, merge)
    got = mesh[f"{case}/table/flush"]
    if dtype == "uint32" or merge != "add":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_store_counters_and_state_equal_stacked_and_jax(runs, case):
    """``counters()`` mid-cycle and at the end, ``resident_state_bytes()``
    and ``state_arrays()`` mid-cycle: the mesh store's equal the stacked
    store's (every key), and JAX's (on JAX's keys; the engine's name
    aside)."""
    ranks, stacked, ref, _ = runs
    mesh = ranks[0]
    for when in ("mid", "end"):
        k = f"{case}/counters/{when}"
        got = json.loads(str(mesh[k]))
        assert got == json.loads(stacked[k])
        if CASES[case][5]:
            want = json.loads(json.dumps(ref[k], default=lambda o: (
                o.item() if hasattr(o, "item") else str(o))))
            assert {a: b for a, b in got.items() if a in want
                    and a != "engine"} == {a: b for a, b in want.items()
                                           if a != "engine"}
    assert int(mesh[f"{case}/rsb"]) == stacked[f"{case}/rsb"]
    if CASES[case][5]:
        assert int(mesh[f"{case}/rsb"]) == ref[f"{case}/rsb"]
    prefix = f"{case}/state/"
    names = sorted(k for k in mesh if k.startswith(prefix))
    assert names == sorted(k for k in stacked if k.startswith(prefix))
    for k in names:
        np.testing.assert_array_equal(mesh[k], stacked[k], err_msg=k)
    if CASES[case][5]:
        jnames = [k for k in ref if k.startswith(prefix)]
        assert jnames and set(jnames) <= set(names)
        for k in jnames:
            np.testing.assert_array_equal(mesh[k], ref[k], err_msg=k)


def test_mesh_snapshot_recovers_into_a_stacked_store(runs):
    """A snapshot and journal written on the mesh (rank 0 alone writes)
    recover into a stacked store of another layout: flushed, bitwise the
    oracle of every journaled tick."""
    _, _, _, work = runs
    label, _, reader = DURABLE[0]
    kv = _store(reader)
    report = kv.recover(str(work / label))
    assert report["snapshot_step"] is not None
    assert report["replayed_ticks"] == DURABLE_TICKS - SNAP_AT
    kv.flush()
    np.testing.assert_array_equal(kv.table().astype(np.int64),
                                  _durable_want())


def test_stacked_snapshot_recovers_into_the_mesh(runs):
    """A stacked store's snapshot and journal recover on the mesh (every
    process reads the same files and installs its slice): flushed,
    bitwise the oracle."""
    ranks, _, _, _ = runs
    label = DURABLE[1][0]
    assert int(ranks[0][f"{label}/replayed"]) == DURABLE_TICKS - SNAP_AT
    np.testing.assert_array_equal(
        ranks[0][f"{label}/table"].astype(np.int64), _durable_want())


def test_bfs_on_the_mesh_is_bitwise(runs):
    """BFS eager and deferred: every shard's distances bitwise the stacked
    run's and the reference's."""
    from repro_torch.apps import bfs_reference
    from repro_torch.apps.sharded import _graph
    ranks, stacked, _, _ = runs
    want = bfs_reference(N_V, *_graph(N_V, N_E, 0), 0)
    for k in ("apps/bfs/eager", "apps/bfs/defer"):
        np.testing.assert_array_equal(ranks[0][k], stacked[k], err_msg=k)
        for row in ranks[0][k]:
            np.testing.assert_array_equal(row, want, err_msg=k)


def test_pagerank_and_kmeans_on_the_mesh(runs):
    """PageRank within JAX's run_app bound (1e-4) of the float64
    reference and k-means within 1e-3 of the schedule mirror; both within
    TOL of the stacked run."""
    from repro_torch.apps import kmeans_reference, pagerank_reference
    from repro_torch.apps.sharded import _graph
    ranks, stacked, _, _ = runs
    mesh = ranks[0]
    ref = pagerank_reference(N_V, *_graph(N_V, N_E, 0), alpha=0.5,
                             iters=16 * APP_K)
    for k in ("apps/pagerank/eager", "apps/pagerank/defer"):
        np.testing.assert_allclose(mesh[k], stacked[k], rtol=TOL, atol=TOL)
        assert np.abs(mesh[k].astype(np.float64) - ref).max() < 1e-4
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(S, 2 * APP_K, 16, 3)).astype(np.float32)
    c0 = rng.normal(size=(5, 3)).astype(np.float32)
    pts_ref = pts.transpose(1, 0, 2, 3).reshape(2 * APP_K, S * 16, 3)
    for label, overlap in (("defer", False), ("overlap", True)):
        k = f"apps/kmeans/{label}"
        np.testing.assert_allclose(mesh[k], stacked[k], rtol=TOL, atol=TOL)
        want = kmeans_reference(pts_ref, c0, commit_k=APP_K, overlap=overlap)
        assert np.abs(mesh[k].astype(np.float64) - want).max() < 1e-3


def test_commit_tick_walk_equals_wire_cost_and_the_stacked_walk(runs):
    """Each process's recorded walk of the privatized store's ticks:
    zero on the two non-commit ticks, the commit tick's bytes by level
    equal to ``wire_cost`` and to the stacked store's recorded walk."""
    from repro_torch.core.merge_functions import ADD
    from repro_torch.launch.wire_cost import wire_bytes_by_level
    from repro_torch.serve import serving_plan
    ranks, stacked, _, _ = runs
    want = wire_bytes_by_level(serving_plan(S), S, (R, D), 4, ADD)
    assert sum(want) > 0
    for res in ranks:
        for i in range(3):
            np.testing.assert_array_equal(res[f"walk/{i}"],
                                          stacked[f"walk/{i}"])
        assert not res["walk/0"].any() and not res["walk/1"].any()
        assert res["walk/2"].tolist() == want


def test_whole_store_gathers_are_heard_by_no_listener(runs):
    """``table()``, ``read()``, ``state_arrays()``, ``counters()`` and the
    executor's gather move data between the processes but are not the
    merge's collectives: the listeners hear none of them."""
    ranks, _, _, _ = runs
    for res in ranks:
        assert int(res["gather/heard"]) == 0


def test_mesh_axis_collectives_equal_the_stacked_axis(runs):
    """``MeshAxis`` over the 8 processes against ``StackedAxis`` on the
    same stack: ppermute over a full shift, a lone pair (rank 0 only
    receives, rank 1 only sends, the rest idle and receive zeros) and
    pairs; psum / pmax / pmin over the axis and over groups of 2; the
    gather and the index, bitwise."""
    from repro_torch.core.stacked import StackedAxis
    ranks, _, _, _ = runs
    mesh = ranks[0]
    axis = StackedAxis(S, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -2**20, 2**20, (S, 5, 3)).astype(np.int32))
    perms = {"shift": [(r, (r + 1) % S) for r in range(S)],
             "lone": [(1, 0)], "pairs": [(r, r ^ 1) for r in range(S)]}
    for name, perm in perms.items():
        np.testing.assert_array_equal(mesh[f"axis/ppermute/{name}"],
                                      axis.ppermute(x, perm).numpy())
    for kind in ("psum", "pmax", "pmin"):
        for group in (None, 2):
            np.testing.assert_array_equal(
                mesh[f"axis/{kind}/{group}"],
                getattr(axis, kind)(x, group).numpy())
    np.testing.assert_array_equal(mesh["axis/gather"], x.numpy())
    np.testing.assert_array_equal(mesh["axis/index"], np.arange(S))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
