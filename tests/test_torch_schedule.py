"""The port's solved and adaptive commit schedules against the JAX package's.

``solve_defer_schedule`` and ``AdaptiveDeferSchedule`` on the same inputs
(wire vectors, explicit per-level rates) give equal ``as_dict()``, float
for float; the port's wire vector (``launch/wire_cost.py``) equals the JAX
walk of the compiled synchronized tick's HLO on 8 forced host devices; the
stores under an adaptive schedule equal the JAX store bitwise after every
tick; and ``kv_serve --defer auto|adaptive`` runs on the CPU.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from benchmarks.simulator import default_fabric
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import \
    AdaptiveDeferSchedule as JAdaptiveDeferSchedule
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.core.defer_schedule import \
    solve_defer_schedule as jsolve_defer_schedule
from repro.core.merge_plan import MergePlan as JMergePlan
from repro.serve import KVConfig as JKVConfig
from repro.serve import ShardedKV as JShardedKV
from repro.serve import serving_plan as jserving_plan
from repro_torch.core import merge_functions as tmf
from repro_torch.core.defer_schedule import (AdaptiveDeferSchedule,
                                             DeferSchedule,
                                             solve_defer_schedule)
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import kv_serve
from repro_torch.launch.wire_cost import wire_bytes_by_level
from repro_torch.serve import KVConfig, ShardedKV, serving_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-level rates (bytes/s) handed to both solvers: innermost fastest
BWS = [1.5e12, 2.5e11, 6e10]
NAMES = ("chip", "host", "pod")
PLANS = ["chip:4,host:4,pod:2:defer", "chip:2,host:2:defer,pod:2:defer",
         "chip:2:defer,host:2:defer,pod:2:defer"]
VECS = [[1e9, 5e8, 4e8], [1e9, 7.5e8, 8e8], [2e6, 0.0, 3e7]]


def _solve_both(spec, vec, **kw):
    """Both solvers' ``as_dict()``, or both raised errors' (type, text)."""
    out = []
    for plan, solve in ((JMergePlan.parse(spec), jsolve_defer_schedule),
                        (MergePlan.parse(spec), solve_defer_schedule)):
        try:
            out.append(solve(plan, vec, NAMES, **kw).as_dict())
        except ValueError as e:
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("spec", PLANS)
def test_solver_matches_jax_float_for_float(spec, overlap):
    """The sweep of compute_s, memory_s, target_fraction and the K window
    over three wire vectors: every solved schedule (and every refusal,
    the nested clamp included) is JAX's."""
    n = 0
    for vec in VECS:
        for compute_s in (0.0, 1e-5, 2e-4, 3e-3, 10.0):
            for memory_s in (0.0, 5e-3):
                for target in (0.25, 0.5, 1.0):
                    for k_min, k_max in ((1, 64), (2, 16), (3, 9), (1, 2)):
                        j, t = _solve_both(
                            spec, vec, bandwidths=BWS, compute_s=compute_s,
                            memory_s=memory_s, target_fraction=target,
                            k_min=k_min, k_max=k_max, overlap=overlap)
                        assert t == j, (vec, compute_s, memory_s, target,
                                        k_min, k_max)
                        n += isinstance(t, dict)
    assert n > 200          # most of the sweep solves


def test_solver_nested_clamp_matches_jax():
    spec = "chip:2,host:2:defer,pod:2:defer"
    j, t = _solve_both(spec, [1e9, 7.5e8, 8e8], bandwidths=[5e10, 2.5e10,
                                                            1.25e10],
                       k_max=5)
    assert t == j and t["intervals"] == [3, 3]
    j, t = _solve_both(spec, [1e9, 7.5e8, 8e8], bandwidths=[5e10, 2.5e10,
                                                            1.25e10],
                       k_min=3, k_max=2)
    assert t == j and t[0] is ValueError and "k_max" in t[1]


@pytest.mark.parametrize("case", ["k_max_0", "k_min_0", "empty_window",
                                  "no_deferred", "missing_name",
                                  "vector_length", "bandwidth_count",
                                  "nested_clamp"])
def test_solver_refuses_as_jax_does(case):
    spec, vec, names = "chip:4,host:4,pod:2:defer", [1.0, 1.0, 1e12], NAMES
    kw = {"bandwidths": BWS}
    if case == "k_max_0":
        kw["k_max"] = 0
    elif case == "k_min_0":
        kw["k_min"] = 0
    elif case == "empty_window":
        kw.update(k_min=8, k_max=4)
    elif case == "no_deferred":
        spec = "chip:4,host:4,pod:2"
    elif case == "missing_name":
        names = ("chip", "host", "WRONG")
    elif case == "vector_length":
        vec = [1.0, 1.0]
    elif case == "bandwidth_count":
        kw["bandwidths"] = BWS[:2]
    else:
        spec, vec = "chip:2,host:2:defer,pod:2:defer", [1e9, 7.5e8, 8e8]
        kw.update(bandwidths=[5e10, 2.5e10, 1.25e10], k_min=3, k_max=2)
    errs = []
    for plan, solve in ((JMergePlan.parse(spec), jsolve_defer_schedule),
                        (MergePlan.parse(spec), solve_defer_schedule)):
        with pytest.raises(ValueError) as e:
            solve(plan, vec, names, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("merge,overlap", [
    ("sat_add", False), ("sat_add", True), ("dropping_add", False),
    ("dropping_add", True), ("add", True), ("max", True), ("and", True)])
def test_merge_trait_gates_match_jax(merge, overlap):
    """Non-deferrable merges raise before any K is solved, and an
    overlapped schedule needs a stale-tolerant merge, in both packages."""
    pair = {"sat_add": (jmf.saturating_add(100.0),
                        tmf.saturating_add(100.0)),
            "dropping_add": (jmf.dropping_add(0.25), tmf.dropping_add(0.25)),
            "add": (jmf.ADD, tmf.ADD), "max": (jmf.MAX, tmf.MAX),
            "and": (jmf.BITWISE_AND, tmf.BITWISE_AND)}[merge]
    spec, vec = "chip:4,host:4,pod:2:defer", [1e9, 5e8, 4e8]
    out = []
    for (plan, solve), fn in zip(
            ((JMergePlan.parse(spec), jsolve_defer_schedule),
             (MergePlan.parse(spec), solve_defer_schedule)), pair):
        try:
            out.append(solve(plan, vec, NAMES, bandwidths=BWS,
                             overlap=overlap, merge_fn=fn).as_dict())
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]
    if merge in ("sat_add", "dropping_add"):
        assert isinstance(out[1], str)


def test_port_solver_needs_rates():
    """The JAX solver falls back to a TPU pod's link rates; the port has
    no default and says to pass rates measured on the card."""
    plan = MergePlan.parse("chip:4,host:4,pod:2:defer")
    with pytest.raises(ValueError, match="bandwidths=.*measured on the card"):
        solve_defer_schedule(plan, [1e9, 5e8, 4e8], NAMES)
    with pytest.raises(ValueError, match="measured on the card"):
        AdaptiveDeferSchedule(plan, [1e9, 5e8, 4e8], NAMES)


def test_solver_takes_a_fabric_as_jax_does():
    fabric = default_fabric(scale=4)
    j, t = _solve_both("chip:4,host:4,pod:2:defer", [1e9, 5e8, 4e8],
                       fabric=fabric, compute_s=1e-3)
    assert t == j and t["level_names"] == ["pod"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("spec,k_max", [
    ("chip:2:defer,pod:2:defer", 16), ("chip:2,host:2:defer,pod:2:defer", 64),
    ("chip:4,host:4,pod:2:defer", 8)])
def test_adaptive_schedule_matches_jax_step_by_step(spec, k_max, overlap):
    """The same observe / due_count / reset sequence: equal period, due
    counts, describe() and as_dict() at every step."""
    names = tuple(n.split(":")[0] for n in spec.split(","))
    vec = [1e6, 4e6, 2e6][:len(names)]
    kw = dict(base_compute_s=1e-6, per_update_s=1e-6, k_max=k_max,
              overlap=overlap, bandwidths=BWS[:len(names)])
    j = JAdaptiveDeferSchedule(JMergePlan.parse(spec), vec, names, **kw)
    t = AdaptiveDeferSchedule(MergePlan.parse(spec), vec, names, **kw)
    loads = np.random.default_rng(0).integers(0, 6000, 120)
    periods = set()
    for i, n in enumerate(loads):
        if i == 70:
            j.reset()
            t.reset()
        j.observe(int(n))
        t.observe(int(n))
        assert t.due_count(i + 1) == j.due_count(i + 1)
        assert t.period == j.period and t.intervals == j.intervals
        assert t.max_period == j.max_period == k_max
        assert t.as_dict() == j.as_dict()
        assert t.describe() == j.describe()
        periods.add(t.period)
    assert len(periods) > 1         # the load moved K


def test_adaptive_schedule_validates_inputs_as_jax_does():
    plan = MergePlan.parse("chip:2:defer,pod:2:defer")
    with pytest.raises(ValueError, match="ema_alpha"):
        AdaptiveDeferSchedule(plan, [1e6, 4e6], ("chip", "pod"),
                              ema_alpha=0.0, bandwidths=BWS[:2])
    with pytest.raises(ValueError, match=">= 0"):
        AdaptiveDeferSchedule(plan, [1e6, 4e6], ("chip", "pod"),
                              per_update_s=-1.0, bandwidths=BWS[:2])


# ---------------------------------------------------------------------------
# the wire vector against the JAX HLO walk
# ---------------------------------------------------------------------------

# (plan spec or serving_plan defer mode, lane_parallel, merge, n_keys)
WIRE_CASES = [("none", True, "add", 4096), ("all", True, "add", 4096),
              ("chip:2,host:2,pod:2", False, "add", 4096),
              ("chip:4,pod:2", True, "add", 1000),
              ("chip:2,host:4", True, "max", 4096),
              ("chip:8", False, "add", 512)]

_WALK = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.apps.sharded import build_mesh, mesh_spmd
    from repro.core import merge_functions as mf
    from repro.core.merge_plan import MergePlan
    from repro.launch import hlo_cost
    from repro.serve import KVConfig, ShardedKV, serving_plan
    S, D, B = 8, 4, 64
    mesh = build_mesh(S, "shards")
    out = []
    for spec, lane, merge, R in json.loads(sys.argv[1]):
        plan = (serving_plan(S, spec) if spec in ("all", "none")
                else MergePlan.parse(spec, lane_parallel=lane))
        eager = (serving_plan(S, "none") if spec == "all" else plan)
        cfg = KVConfig(n_keys=R, cols=D, merge=getattr(mf, merge.upper()))
        probe = ShardedKV(cfg, S, mesh_spmd(mesh, "shards"), plan=eager)

        def region(tbl, keys, vals):
            loc = [jax.tree.map(lambda x: x[0], a)
                   for a in (tbl, keys, vals)]
            return jax.tree.map(lambda x: x[None],
                                probe.raw_tick_fn()(*loc))

        f = jax.jit(shard_map(region, mesh=mesh, in_specs=(P("shards"),) * 3,
                              out_specs=P("shards"), check_rep=False))
        hlo = f.lower(jax.ShapeDtypeStruct((S, R, D), jnp.int32),
                      jax.ShapeDtypeStruct((S, B), jnp.int32),
                      jax.ShapeDtypeStruct((S, B, D), jnp.int32)
                      ).compile().as_text()
        walk = hlo_cost.analyze_hlo(
            hlo, level_sizes=tuple(lv.size for lv in plan.levels),
            level_names=tuple(lv.name for lv in plan.levels))
        out.append(walk["wire_bytes_by_level_total"])
    print("WIRE" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_walks():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    r = subprocess.run([sys.executable, "-c", _WALK, json.dumps(WIRE_CASES)],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("WIRE"))
    return json.loads(line[4:])


def _port_plan(spec, lane):
    return (serving_plan(8, spec) if spec in ("all", "none")
            else MergePlan.parse(spec, lane_parallel=lane))


@pytest.mark.parametrize("i", range(len(WIRE_CASES)),
                         ids=[f"{c[0]}-{c[2]}-R{c[3]}" for c in WIRE_CASES])
def test_wire_vector_equals_the_jax_hlo_walk(jax_walks, i):
    spec, lane, merge, R = WIRE_CASES[i]
    got = wire_bytes_by_level(_port_plan(spec, lane), 8, (R, 4), 4,
                              getattr(tmf, merge.upper()))
    assert got == jax_walks[i]


@pytest.mark.parametrize("overlap", [False, True])
def test_solved_schedules_from_both_vectors_are_equal(jax_walks, overlap):
    """The JAX solver on the HLO walk's vector and the port's on its own,
    with the same rates, at several compute bounds."""
    spec, lane, _, R = WIRE_CASES[1]
    port_vec = wire_bytes_by_level(_port_plan(spec, lane), 8, (R, 4), 4,
                                   tmf.ADD)
    for compute_s in (0.0, 1e-7, 1e-6, 5e-6, 2e-5, 1e-4, 1e-3):
        kw = dict(bandwidths=[2e12, 2e11, 5e10], compute_s=compute_s,
                  overlap=overlap)
        j = jsolve_defer_schedule(jserving_plan(8, "all"), jax_walks[1],
                                  NAMES, merge_fn=jmf.ADD, **kw)
        t = solve_defer_schedule(serving_plan(8, "all"), port_vec, NAMES,
                                 merge_fn=tmf.ADD, **kw)
        assert t.as_dict() == j.as_dict()


def test_wire_vector_refuses_a_compressed_level():
    plan = MergePlan.parse("chip:2,host:2,pod:2:compress", lane_parallel=True)
    with pytest.raises(ValueError, match="compressed"):
        wire_bytes_by_level(plan, 8, (64, 4), 4,
                            tmf.int8_compressed_add())


# ---------------------------------------------------------------------------
# the store under an adaptive schedule
# ---------------------------------------------------------------------------

class _JitSpmd:
    """The JAX store's executor: vmap over the shard axis, each per-shard
    program compiled once."""

    def __init__(self):
        self._fns = {}

    def __call__(self, fn, *args):
        if fn not in self._fns:
            self._fns[fn] = jax.jit(jax.vmap(fn, axis_name="shards"))
        return self._fns[fn](*args)


def _load_stream(seed, T, S, B, R, D):
    """Keys whose load swings between full and light batches (the rest
    padding), so the adaptive K moves."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    for t in range(T):
        if (t // 6) % 2:
            keys[t, :, rng.integers(1, 3):] = -1
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("engine,partitioned", [
    ("kernel", False), ("kernel", True), ("blocked", False),
    ("blocked", True)])
def test_store_under_an_adaptive_schedule_matches_jax_bitwise(engine,
                                                              partitioned):
    S, R, D, B, T = 4, 32, 2, 8, 30
    keys, vals = _load_stream(5, T, S, B, R, D)
    kw = dict(base_compute_s=1e-6, per_update_s=1e-6, k_max=8,
              bandwidths=[1e9, 2.5e8], overlap=partitioned)
    geo = dict(n_keys=R, cols=D, engine=engine, partitioned=partitioned,
               block_rows=4, ways=2, spill_blocks=64)
    j = JShardedKV(JKVConfig(**geo), S, _JitSpmd(),
                   schedule=JAdaptiveDeferSchedule(jserving_plan(S), [1e3,
                                                                      4e3],
                                                   **kw))
    t = ShardedKV(KVConfig(**geo), S, device="cpu",
                  schedule=AdaptiveDeferSchedule(serving_plan(S), [1e3, 4e3],
                                                 **kw))
    periods = set()
    for i in range(T):
        j.tick(keys[i], vals[i])
        t.tick(keys[i], vals[i])
        np.testing.assert_array_equal(t.table(), j.table())
        assert t.counters()["schedule"] == j.counters()["schedule"]
        periods.add(t.schedule.period)
    j.flush()
    t.flush()
    np.testing.assert_array_equal(t.table(), j.table())
    want = np.zeros((R, D), np.int64)
    np.add.at(want, keys[keys >= 0], vals[keys >= 0])
    np.testing.assert_array_equal(t.table().astype(np.int64), want)
    assert len(periods) > 1
    assert t.counters()["schedule"]["adaptive"]["n_resolves"] >= 3


def test_partitioned_adaptive_schedule_bitwise():
    """The JAX suite's test of the same name, on the port: the partitioned
    store under an adaptive schedule flushes to the oracle."""
    S, R, D, B, T = 4, 32, 2, 8, 20
    rng = np.random.default_rng(5)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    sched = AdaptiveDeferSchedule(serving_plan(S), [1e3, 4e3],
                                  base_compute_s=1e-6, per_update_s=1e-7,
                                  k_max=8, bandwidths=[1e9, 2.5e8])
    kv = ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=True), S,
                   device="cpu", schedule=sched)
    for t in range(T):
        kv.tick(keys[t], vals[t])
    kv.flush()
    want = np.zeros((R, D), np.int64)
    np.add.at(want, keys.reshape(-1), vals.reshape(-1, D))
    np.testing.assert_array_equal(kv.table().astype(np.int64), want)
    assert kv.counters()["schedule"]["adaptive"]["n_resolves"] >= 2


def test_store_refuses_a_schedule_of_another_kind():
    with pytest.raises(TypeError, match="DeferSchedule"):
        ShardedKV(KVConfig(n_keys=32, cols=2), 4, device="cpu",
                  schedule=JDeferSchedule.fixed(2, ("chip", "pod")))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--defer", "auto"], ["--defer", "adaptive", "--partitioned",
                          "--overlap"],
    ["--defer", "auto", "--partitioned"],
    ["--defer", "adaptive", "--engine", "blocked"]])
def test_cli_solves_and_serves_on_the_cpu(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        kv_serve.main(["--device", "cpu", "--keys", "256", "--ticks", "9",
                       "--batch", "16", "--shards", "8", *flags])
    text = out.getvalue()
    assert "solved schedule:" in text
    assert "level merges on cpu (median of 5)" in text
    assert "wire vector" in text and "deferred tick on cpu" in text
    assert f"settled mass col0: {9 * 8 * 16}" in text
    if "adaptive" in flags:
        assert "adaptive (ema" in text


def test_measured_inputs_are_the_wire_vector_and_positive_times():
    plan = serving_plan(8, "all")
    cfg = KVConfig(n_keys=512, cols=4)
    inputs = kv_serve.measure_schedule_inputs(cfg, 8, 16, plan, "cpu")
    assert inputs["wire"] == wire_bytes_by_level(plan, 8, (512, 4), 4,
                                                 tmf.ADD)
    assert all(t > 0 for t in inputs["level_s"]) and inputs["tick_s"] > 0
    assert inputs["rates"] == [b / t for b, t in zip(inputs["wire"],
                                                     inputs["level_s"])]
    assert inputs["device"] == "cpu"
    auto = kv_serve.schedule_from("auto", plan, inputs, cfg.merge, 8, 16,
                                  partitioned=True)
    assert isinstance(auto, DeferSchedule) and len(set(auto.intervals)) == 1
    adaptive = kv_serve.schedule_from("adaptive", plan, inputs, cfg.merge,
                                      8, 16, overlap=True)
    assert adaptive.as_dict()["adaptive"]["per_update_s"] == \
        inputs["tick_s"] / (8 * 16)


def test_cli_schedules_need_the_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for mode in ("auto", "adaptive"):
        with pytest.raises(RuntimeError, match="CUDA"):
            kv_serve.main(["--keys", "64", "--ticks", "2", "--batch", "4",
                           "--defer", mode])
