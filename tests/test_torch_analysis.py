"""The port's static verifier (``repro_torch.analysis``) against the JAX
package's ``repro.analysis``.

* Every seeded-violation fixture trips its code, and each one that twins a
  reference fixture trips the code the reference's own fixture table lists
  (the reference's three jaxpr fixtures fail on this container's jax, so
  the table, not their run, is the expectation).
* The trait certifier gives the reference's codes for every shipped merge
  and every mislabeled one, on the same probes.
* The walk checks give the reference's diagnostics for equal walk dicts.
* Every serving tick's recorded walk equals ``wire_cost`` level by level
  and is clean against ``scheduled_manifest``; the stores' tick programs
  take the reference's argument shapes (a shard dim ahead).
* The taint tracker flags both leaky ticks and passes the real due-0
  tick; the rank-isolation probe flags a hidden ``roll`` over the shard
  dim and passes every real non-commit tick; the donation check flags
  each whole copy of donated state and passes every real commit tick.
* ``python -m repro_torch.analysis --device cpu`` (and ``--fixtures``)
  exits 0.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.analysis import cli as jcli
from repro.analysis import diagnostics as jdiag
from repro.analysis import durability as jdurability
from repro.analysis import placement as jplacement
from repro.analysis.traits import certify_merge_fn as jcertify
from repro.core import ccache as jccache
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.serve import KVConfig as JKVConfig
from repro.serve import ShardedKV as JShardedKV
from repro.serve import serving_plan as jserving_plan
from repro_torch.analysis import (CATALOG, Report, certify_merge_fn,
                                  check_commit_walk, check_donation,
                                  check_kv_tick_taint, check_noncommit_region,
                                  check_noncommit_walk, check_rank_isolation,
                                  out_deps, record, walk_of)
from repro_torch.analysis import cli
from repro_torch.analysis import diagnostics as tdiag
from repro_torch.analysis.durability import check_checkpoint_coverage
from repro_torch.analysis.traits import op_names
from repro_torch.apps.common import scatter
from repro_torch import hooks
from repro_torch.core import ccache
from repro_torch.core import merge_functions as tmf
from repro_torch.core.stacked import StackedAxis
from repro_torch.launch.wire_cost import wire_bytes_by_level
from repro_torch.serve.kv import KVConfig, ShardedKV, serving_plan

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
S = cli.SERVE_SHARDS


# ---------------------------------------------------------------------------
# fixtures: each trips its code, the reference's code where it has a twin
# ---------------------------------------------------------------------------

_FIXTURES = cli.fixture_checks("cpu")
_JAX_CODES = {name.split(":", 1)[1]: code
              for name, code, _ in jcli.fixture_checks()}


@pytest.mark.parametrize("name,code,thunk", _FIXTURES,
                         ids=[f[0] for f in _FIXTURES])
def test_fixture_trips_its_code(name, code, thunk):
    twin = name.split(":", 1)[1]
    if not name.startswith("probe:"):
        assert _JAX_CODES[twin] == code, (name, _JAX_CODES.get(twin))
    diags = thunk()
    assert any(d.code == code for d in diags), (
        f"seeded violation {name!r} did not trip {code}: "
        f"{[d.format() for d in diags]}")
    for d in diags:
        assert d.code in CATALOG


def test_every_code_but_the_records_one_has_a_fixture():
    """CC030 checks benchmark records, which wait for the benchmark twins;
    every other code of the catalog is seeded."""
    assert {code for _, code, _ in _FIXTURES} == set(CATALOG) - {"CC030"}
    assert set(_JAX_CODES.values()) == set(CATALOG)


def test_catalog_equals_the_reference():
    assert CATALOG == jdiag.CATALOG


# ---------------------------------------------------------------------------
# traits: the reference's codes on every merge, honest or mislabeled
# ---------------------------------------------------------------------------


def _merge_pairs():
    pairs = list(zip(jmf.standard_merges(), tmf.standard_merges()))
    for (j, t) in pairs:
        assert j.name == t.name
    relabels = [
        ("sat_add", lambda m: m.saturating_add(8.0), {"scalable": True}),
        ("sat_add", lambda m: m.saturating_add(8.0), {"deferrable": True}),
        ("sat_add_1e9", lambda m: m.saturating_add(1e9),
         {"deferrable": True}),
        ("drop_add", lambda m: m.dropping_add(0.25), {"deferrable": True}),
        ("add", lambda m: m.ADD, {"idempotent": True}),
        ("max", lambda m: m.MAX, {"invertible": True}),
        ("mul", lambda m: m.MUL, {"idempotent": True, "scalable": True}),
        ("min", lambda m: m.MIN, {"scalable": True, "invertible": True}),
        ("or", lambda m: m.BITWISE_OR, {"invertible": True}),
        ("cmul", lambda m: m.COMPLEX_MUL, {"idempotent": True}),
        ("int8", lambda m: m.int8_compressed_add(), {"idempotent": True}),
    ]
    for label, make, traits in relabels:
        pairs.append((dataclasses.replace(make(jmf), **traits),
                      dataclasses.replace(make(tmf), **traits)))
    return pairs


_MERGES = _merge_pairs()


@pytest.mark.parametrize("jfn,tfn", _MERGES,
                         ids=[f"{t.name}:{i}" for i, (_, t)
                              in enumerate(_MERGES)])
def test_certify_gives_the_reference_codes(jfn, tfn):
    want = sorted(d.code for d in jcertify(jfn, site="s"))
    got = sorted(d.code for d in certify_merge_fn(tfn, site="s"))
    assert got == want


def test_shipped_merges_certify_clean():
    for fn in tmf.standard_merges():
        assert not certify_merge_fn(fn), fn.name


def test_op_classification_sees_the_clamp_combine_lacks():
    fn = tmf.saturating_add(8.0)
    x = torch.ones(3)
    assert "clamp" in op_names(fn.apply, x, x)
    assert "clamp" not in op_names(fn.combine, x, x)
    assert op_names(tmf.MAX.apply, x, x) == op_names(tmf.MAX.combine, x, x)


# ---------------------------------------------------------------------------
# walk checks: the reference's diagnostics for equal walk dicts
# ---------------------------------------------------------------------------


def _key(diags):
    return sorted((d.code, d.site, str(d.level), d.severity) for d in diags)


_WALKS = [
    {"wire_bytes_by_level_total": [0.0, 0.0, 0.0],
     "level_names": ["chip", "host", "pod"], "per_collective": {}},
    {"wire_bytes_by_level_total": [28672.0, 16384.0, 4096.0],
     "level_names": ["chip", "host", "pod"],
     "per_collective": {"all-reduce": {"count": 1},
                        "collective-permute": {"count": 5}}},
    {"wire_bytes_by_level_total": [16384.0, 0.0, 4096.0],
     "level_names": ["chip", "host", "pod"],
     "per_collective": {"all-reduce": {"count": 2},
                        "collective-permute": {"count": 3},
                        "all-gather": {"count": 1}}},
    {"wire_bytes_by_level_total": [0.0, 0.0, 8.0], "level_names": [],
     "per_collective": {"collective-permute": {"count": 1}}},
]


@pytest.mark.parametrize("walk", _WALKS, ids=range(len(_WALKS)))
@pytest.mark.parametrize("defer,due", [("all", 0), ("all", 1), ("all", 3),
                                       ("top", 0), ("none", None)])
def test_walk_checks_equal_the_reference(walk, defer, due):
    jplan, tplan = jserving_plan(S, defer), serving_plan(S, defer)
    if due is None:
        jm = jccache.collective_manifest(jplan, S, merge_fn=jmf.ADD)
        tm = ccache.collective_manifest(tplan, S, merge_fn=tmf.ADD)
    else:
        jm = jccache.program_manifest(jplan, S, due, merge_fn=jmf.ADD)
        tm = ccache.program_manifest(tplan, S, due, merge_fn=tmf.ADD)
    assert [dataclasses.asdict(m) for m in jm] == \
        [dataclasses.asdict(m) for m in tm]
    assert _key(check_commit_walk(walk, tm, "w")) == \
        _key(jplacement.check_commit_walk(walk, jm, "w"))
    assert _key(check_noncommit_walk(walk, "w")) == \
        _key(jplacement.check_noncommit_walk(walk, "w"))


def test_walk_of_counts_each_leaf_and_places_bytes_by_link():
    axis = StackedAxis(8, CPU)
    x = torch.zeros((8, 4, 2), dtype=torch.int32)
    _, calls = record(lambda: (axis.ppermute([x, x], [(0, 1), (1, 0)]),
                               axis.psum(x, 2), axis.pmax(x)))
    assert [c.kind for c in calls] == ["ppermute", "psum", "pmax"]
    w = walk_of(calls, (2, 2, 2), ("chip", "host", "pod"))
    assert w["per_collective"]["collective-permute"]["count"] == 2
    assert w["per_collective"]["all-reduce"]["count"] == 2
    # 2 leaves x 2 pairs x 32 bytes on chip; a ring all-reduce of 32 bytes
    # over each pair moves 2 * 32 a pair, 4 pairs on chip; the 8-rank
    # ring's 2 * 7 * 32 bytes spread over 8 links, 4 on chip, 2 on host,
    # 2 on pod
    ring = 2 * 7 * 32 / 8
    assert w["wire_bytes_by_level_total"] == [128 + 4 * 64 + 4 * ring,
                                              2 * ring, 2 * ring]
    assert not hooks.LISTENERS
    with pytest.raises(ValueError, match="multiply"):
        walk_of(calls, (2, 2), ("chip", "host"))


def test_the_recorder_detaches_on_an_error():
    with pytest.raises(RuntimeError):
        record(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert not hooks.LISTENERS


# ---------------------------------------------------------------------------
# recorded walks of every serving tick
# ---------------------------------------------------------------------------

_STORES = cli.serving_stores("cpu")
_TICKS = [(label, store, due, land) for label, store in _STORES
          for due, land in cli._tick_variants(store)]


@pytest.mark.parametrize("label,store,due,land", _TICKS,
                         ids=[f"{t[0]}:{t[2]}{',land' if t[3] else ''}"
                              for t in _TICKS])
def test_recorded_walk_equals_wire_cost_and_the_manifest(label, store, due,
                                                         land):
    fn = (store.raw_tick_fn() if due == "sync"
          else store.raw_tick_fn(due, land=land))
    manifest = (store.scheduled_manifest() if due == "sync"
                else store.scheduled_manifest(due, land=land))
    _, calls = record(fn, *store.tick_args(16, land=land))
    walk = walk_of(calls, [lv.size for lv in store.plan.levels],
                   [lv.name for lv in store.plan.levels])
    assert not check_commit_walk(walk, manifest, label)
    want = wire_bytes_by_level(store.plan, S, (cli.SERVE_KEYS,
                                               cli.SERVE_COLS), 4,
                               merge_fn=store.config.merge,
                               levels={m.index for m in manifest})
    assert walk["wire_bytes_by_level_total"] == want
    if not manifest:
        assert not calls


def _jax_store(label):
    cfg = dict(n_keys=cli.SERVE_KEYS, cols=cli.SERVE_COLS, dtype=jnp.int32)
    spmd = lambda fn, *a: None
    plan = jserving_plan(S, "all")
    if label.startswith("kv[") and label[3:-1] in ("all", "top", "none"):
        defer = label[3:-1]
        return JShardedKV(JKVConfig(**cfg), S, spmd,
                          plan=jserving_plan(S, defer),
                          **({} if defer == "none" else {"commit_every": 4}))
    kw = {"engine": "blocked"} if "blocked" in label else {}
    if "part" in label:
        kw["partitioned"] = True
    store = JShardedKV(JKVConfig(**cfg, **kw), S, spmd, plan=plan,
                       commit_every=4)
    if label == "kv[part-ov]":
        store = JShardedKV(JKVConfig(**cfg, partitioned=True), S, spmd,
                           plan=plan, schedule=JDeferSchedule.fixed(
                               4, store._deferred_names, overlap=True))
    return store


@pytest.mark.parametrize("label,store", _STORES, ids=[s[0] for s in _STORES])
def test_tick_programs_take_the_reference_argument_shapes(label, store):
    jstore = _jax_store(label)
    assert store.supported_dues == jstore.supported_dues
    assert store.donate_argnums == jstore.donate_argnums
    lands = (False, True) if label == "kv[part-ov]" else (False,)
    for land in lands:
        specs = jstore.tick_arg_specs(16, land=land)
        args = store.tick_args(16, land=land)
        want = [tuple(x.shape) for x in
                __import__("jax").tree.leaves(specs)]
        got = [tuple(x.shape[1:]) if isinstance(x, torch.Tensor) else ()
               for x in torch.utils._pytree.tree_leaves(args)]
        assert got == want


# ---------------------------------------------------------------------------
# probes: taint, rank isolation, donation
# ---------------------------------------------------------------------------


def _fixture(name):
    return next(thunk for n, _, thunk in _FIXTURES if n == name)


def test_taint_passes_the_real_due0_tick_and_flags_both_leaks():
    store = dict(_STORES)["kv[all]"]
    settled, pendings, keys, vals = store.tick_args(16)
    assert not check_kv_tick_taint(store.raw_tick_fn(0), settled, pendings,
                                   keys, vals, "kv[all]")
    deps = out_deps(store.raw_tick_fn(0), (settled, pendings, keys, vals))
    # settled <- settled; pending 0 <- pending 0, keys, vals; the rest kept
    n = len(pendings)
    assert deps[0] == {0} and deps[1] == {1, n + 1, n + 2}
    assert [d == {i + 2} for i, d in enumerate(deps[2:])] == [True] * (n - 1)
    assert [d.code for d in _fixture("trace:settled_read_escape")()] == \
        ["CC011"]
    assert [d.code for d in _fixture("trace:pending_escape")()] == ["CC012"]


def test_taint_follows_in_place_writes_and_views():
    def tick(settled, pendings, keys, vals):
        p = pendings[0]
        p[:, :2] += settled[:, :2]          # a view, written in place
        return settled, (p,)
    x = torch.zeros((2, 4, 1), dtype=torch.int32)
    assert [d.code for d in check_kv_tick_taint(
        tick, x, (x,), torch.zeros((2, 1), dtype=torch.int32), x,
        "s")] == ["CC011"]


def test_taint_ignores_arguments_that_give_only_a_shape():
    # a jaxpr's zeros_like has no input; the port's must carry no taint
    def tick(settled, pendings, keys, vals):
        fresh = torch.zeros_like(settled) + torch.empty_like(settled).zero_()
        return settled, (pendings[0] + fresh,)
    x = torch.zeros((2, 4, 1), dtype=torch.int32)
    deps = out_deps(tick, (x, (x,), torch.zeros((2, 1), dtype=torch.int32),
                           x))
    assert deps == [{0}, {1}]


@pytest.mark.parametrize("label,store", _STORES, ids=[s[0] for s in _STORES])
def test_real_noncommit_ticks_are_rank_isolated(label, store):
    for due, land in cli._tick_variants(store):
        if due == "sync" or store.scheduled_manifest(due, land=land):
            continue
        args = store.tick_args(16, land=land)
        fn = store.raw_tick_fn(due, land=land)
        assert not check_rank_isolation(
            fn, args, (len(args) - 2, len(args) - 1), S, label,
            ranks=range(S))
        assert not check_noncommit_region(fn, args, label)


def test_rank_isolation_flags_a_hidden_roll_the_recorder_misses():
    diags = _fixture("probe:cross_rank_roll_in_noncommit_tick")()
    assert {d.code for d in diags} == {"CC020"}
    tbl = torch.zeros((S, 8, 2), dtype=torch.int32)
    _, calls = record(lambda: torch.roll(tbl, 1, 0))
    assert not calls


def test_donation_flags_a_copy_and_passes_every_commit_tick():
    assert [d.code for d in _fixture("storage:donation_fallback")()] == \
        ["CC022"]
    for label, store in _STORES:
        fn = (store.raw_tick_fn() if store.synchronized
              else store.raw_tick_fn(store.n_deferred))
        assert not check_donation(fn, store.tick_args(16),
                                  store.donate_argnums, label), label
    # the flush program donates the store's state too
    store = dict(_STORES)["kv[all]"]
    assert not check_donation(store.raw_flush_fn(), store.tick_args(16)[:2],
                              (0, 1), "kv[all]:flush")


def test_audit_stages_flags_a_deferred_stage_of_a_nondeferrable_merge():
    from repro.analysis.jaxpr import audit_stages as jaudit
    from repro.core.merge_plan import MergePlan as JMergePlan
    from repro.core.merge_plan import compile_plan as jcompile
    from repro_torch.analysis import audit_stages
    from repro_torch.core.merge_plan import MergePlan, compile_plan

    spec = "chip:2,host:2:defer,pod:2:defer"
    stages = compile_plan(MergePlan.parse(spec), 8, merge_fn=tmf.ADD)
    jstages = jcompile(JMergePlan.parse(spec), 8, merge_fn=jmf.ADD)
    for tfn, jfn in ((tmf.saturating_add(8.0), jmf.saturating_add(8.0)),
                     (tmf.dropping_add(0.5), jmf.dropping_add(0.5)),
                     (tmf.ADD, jmf.ADD)):
        got = audit_stages(stages, tfn, "s")
        assert _key(got) == _key(jaudit(jstages, jfn, "s"))
        assert [d.level for d in got] == (
            [] if tfn is tmf.ADD else ["host", "pod"])


def _add_rows(t, keys, vals):
    return scatter(t, keys, vals, kind="add")


# (tick, whether it copies the donated table whole)
_DONATION_TICKS = {
    "clone": (lambda s, k, v: _add_rows(s.clone(), k, v), True),
    "copy_back": (lambda s, k, v: s.copy_(
        s + _add_rows(torch.zeros_like(s), k, v)), True),
    "copy_out": (lambda s, k, v: _add_rows(
        torch.empty_like(s).copy_(s), k, v), True),
    "to_copy": (lambda s, k, v: _add_rows(
        s.to(s.dtype, copy=True), k, v), True),
    "cast": (lambda s, k, v: _add_rows(
        s.to(torch.float32), k, v.float()).to(s.dtype), False),
    "fresh_result": (lambda s, k, v: s + _add_rows(
        torch.zeros_like(s), k, v), False),
    "in_place": (lambda s, k, v: _add_rows(s, k, v), False),
    "row_write": (lambda s, k, v: s.__setitem__(
        (slice(None), slice(0, 2)), v[:, :2]) or s, False),
    "reset": (lambda s, k, v: s.copy_(torch.zeros_like(s)), False),
}


@pytest.mark.parametrize("name", list(_DONATION_TICKS))
def test_donation_flags_each_whole_copy_of_donated_state(name):
    tick, copies = _DONATION_TICKS[name]
    tbl = torch.zeros((S, 16, 2), dtype=torch.int32)
    keys = torch.arange(S * 4, dtype=torch.int32).reshape(S, 4) % 16
    vals = torch.ones((S, 4, 2), dtype=torch.int32)
    got = check_donation(tick, (tbl, keys, vals), (0,), name)
    assert [d.code for d in got] == (["CC022"] if copies else [])


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("engine", ["kernel", "blocked"])
def test_tick_args_hold_the_state_a_new_store_holds(engine, partitioned):
    kv = ShardedKV(KVConfig(n_keys=64, cols=2, engine=engine,
                            partitioned=partitioned), 4, device="cpu",
                   plan=serving_plan(4, "all"), commit_every=2)
    args = kv.tick_args(8)
    if partitioned and engine == "kernel":
        kv._ensure_ring((4, 8))
    state = (kv.settled, *kv._pending_state()) if partitioned else (
        (kv.settled, kv.pendings) if engine == "kernel"
        else (kv.settled, kv.pendings, kv.cache))
    want = pytree.tree_leaves(state)
    got = pytree.tree_leaves(args[:len(state)])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        else:
            assert a == b


# ---------------------------------------------------------------------------
# durability and the report
# ---------------------------------------------------------------------------


def test_checkpoint_coverage_equals_the_reference():
    import jax
    from repro.checkpoint import defer_state_spec as jspec
    from repro_torch.checkpoint import defer_state_spec as tspec

    jparams = {"w": jax.ShapeDtypeStruct((4,), jnp.int32)}
    tparams = {"w": torch.zeros((4,), dtype=torch.int32)}
    for n_levels, overlap, keep in ((2, True, 1), (2, False, 2),
                                    (3, True, 0)):
        js, ts = (jspec(jparams, n_levels=n_levels, dp=8, overlap=overlap),
                  tspec(tparams, n_levels=n_levels, dp=8, overlap=overlap))
        jsaved = {"params": jparams, "opt": {},
                  "defer": {"t": js["t"], "pending": js["pending"][:keep]}}
        tsaved = {"params": tparams, "opt": {},
                  "defer": {"t": ts["t"], "pending": ts["pending"][:keep]}}
        want = jdurability.check_checkpoint_coverage("s", js, jsaved)
        got = check_checkpoint_coverage("s", ts, tsaved)
        assert [d.message for d in got] == [d.message for d in want]


def test_report_formats_as_the_reference():
    diags = [("CC021", "kv[all]:tick", "error"),
             ("CC020", "kv[part]:tick", "warning"),
             ("CC010", "app:bfs", "error")]
    outs = []
    for mod in (jdiag, tdiag):
        r = mod.Report(["CC021@kv[all]"])
        r.mark_checked("a")
        r.extend(mod.Diagnostic(code=c, site=s, message="m", severity=v)
                 for c, s, v in diags)
        outs.append((r.format(), r.ok(), r.as_dict()))
    assert outs[0] == outs[1]
    assert not outs[1][1]
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        tdiag.Diagnostic(code="CC999", site="x", message="m")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--device", "cpu", *argv], env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_sweep_exits_clean_on_the_cpu(tmp_path):
    out = _cli("--json", str(tmp_path / "r.json"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: OK" in out.stdout
    import json
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["ok"] and not report["diagnostics"]
    sites = report["checked"]
    assert len(sites) == len(set(sites)) > 100
    for want in ("kv[all]:taint[due=0]", "kv[part-ov]:tick[due=3,land]",
                 "kv[blocked]:isolation[due=0]", "kv[none]:donation",
                 "app:kmeans.step", "merge:sat_add[8.0]"):
        assert want in sites


def test_the_fixtures_exit_clean_on_the_cpu():
    out = _cli("--fixtures")
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"fixtures: OK ({len(_FIXTURES)}/{len(_FIXTURES)} tripped)" \
        in out.stdout


def test_a_finding_fails_the_sweep_unless_suppressed():
    store = ShardedKV(KVConfig(n_keys=64, cols=2), S, device="cpu",
                      plan=serving_plan(S, "none"))
    tick = store._tick_fns["sync"]
    # the sync tick, after a whole copy of its donated table
    store._tick_fns["sync"] = lambda settled, keys, vals: tick(
        settled.clone(), keys, vals)
    report = Report()
    cli.sweep_store(report, "kv[none]", store)
    assert [d.code for d in report.failures()] == ["CC022"]
    assert Report(["CC022@kv[none]"]).ok()
    suppressed = Report(["CC022@kv[none]"])
    suppressed.extend(report.diagnostics)
    assert suppressed.ok() and suppressed.diagnostics


def test_lint_plans_torch_wraps_the_cli():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "lint_plans_torch.py"),
                          "--device", "cpu", "--fixtures"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
