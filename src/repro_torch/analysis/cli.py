"""``python -m repro_torch.analysis`` — the static MergePlan verifier's sweep.

The port's twin of the JAX package's ``repro/analysis/cli.py``, with the
same sweeps, one report (``scripts/lint_plans_torch.py`` is the thin
wrapper):

* **merges** — every merge fn the port ships (``standard_merges``) through
  the trait certifier (CC00x);
* **configs** — every arch in ``repro_torch/configs/`` audited against the
  production mesh geometries the reference's dryrun lowers on (single-
  and multi-pod), eager and defer-top, with the plain and the compressed
  gradient merge (CC013/CC014): pure plan audits;
* **apps** — the paper apps' scatter supersteps (BFS, PageRank, k-means)
  run under the collective recorder and held collective-free (CC010),
  plus their plan audits;
* **serve** — the ``ShardedKV`` serving stores at S = 8 shards stacked on
  one device (no subprocess: the reference respawns on a forced host
  mesh): ``kv[all|top|none]``, ``kv[part]`` and ``kv[part-ov]`` as the
  reference sweeps them, and the blocked engine's ``kv[blocked]`` and
  ``kv[part-blocked]``, which it does not. Every supported due (and land)
  tick runs on example tensors: its recorded walk is held to
  ``scheduled_manifest`` (CC020/CC021) and a commit's bytes on each level
  to ``launch/wire_cost.py``; every non-commit tick is held collective-free
  (CC010) and rank-isolated on the device (CC020); ``kv[all]``'s due-0
  tick is taint-checked (CC011/CC012); the full-commit tick may copy none
  of its donated state whole (CC022). On the card the ticks
  launch the CUDA ``cscatter``, and the blocked stores ``cmerge``;
* **durability** — the chaos toy's declared volatile spec against the
  defer state it really initializes (CC040).

``--fixtures`` runs the seeded-violation suite instead: each known-bad
input must trip its stable CC code (the twin of the reference's
``fixture_checks``; CC030 checks benchmark records and waits for the
benchmark twins). ``--suppress CODE[@SITE]`` keeps a finding visible but
non-fatal; ``--json PATH`` writes the machine-readable report.
``--device`` is the card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.diagnostics import Diagnostic, Report

SERVE_SHARDS = 8
# the reference's serve sweep geometry: keys, columns, batch, commit K
SERVE_KEYS, SERVE_COLS, SERVE_BATCH, SERVE_K = 256, 2, 32, 4


def _log(msg: str) -> None:
    print(f"lint_plans: {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def sweep_merges(report: Report) -> None:
    """CC00x: certify every shipped merge fn's declared traits."""
    from repro_torch.analysis.traits import certify_merge_fn
    from repro_torch.core.merge_functions import standard_merges

    for fn in standard_merges():
        site = f"merge:{fn.name}"
        report.mark_checked(site)
        report.extend(certify_merge_fn(fn, site=site))


def _production_plans():
    """The merge-plan geometries the reference's dryrun lowers every config
    on: per mesh, the all-eager plan and the defer-top what-if."""
    from repro_torch.core.merge_plan import MergeLevel, MergePlan

    out = []
    for multi_pod in (False, True):
        sizes = (16, 16) + ((2,) if multi_pod else ())
        names = ("chip", "host") + (("pod",) if multi_pod else ())
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        eager = MergePlan(levels=tuple(
            MergeLevel(nm, sz) for nm, sz in zip(names, sizes)))
        defer_top = MergePlan(levels=tuple(
            MergeLevel(nm, sz, defer=(i == len(sizes) - 1))
            for i, (nm, sz) in enumerate(zip(names, sizes))))
        out.append((mesh_name, sizes, (("eager", eager),
                                       ("defer_top", defer_top))))
    return out


def sweep_configs(report: Report) -> None:
    """CC013/CC014: audit every config's production plan geometries with
    the gradient merges the train step routes through them."""
    from repro_torch.analysis.trace import audit_plan
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.core.merge_functions import ADD, int8_compressed_add

    merges = (ADD, int8_compressed_add())
    for arch in ARCH_IDS:
        for mesh_name, sizes, variants in _production_plans():
            axis_size = int(np.prod(sizes))
            for kind, plan in variants:
                for m in merges:
                    site = f"config:{arch}:{mesh_name}:{kind}:{m.name}"
                    report.mark_checked(site)
                    report.extend(audit_plan(plan, axis_size, merge_fn=m,
                                             site=site))


def sweep_apps(report: Report, device, axis_size: int = SERVE_SHARDS) -> None:
    """CC010 on the paper apps' scatter supersteps (privatized phases must
    make no collective) + CC013/CC014 on their default plan."""
    from repro_torch.analysis.trace import audit_plan, check_noncommit_region
    from repro_torch.apps.bfs import bfs_superstep
    from repro_torch.apps.common import default_plan
    from repro_torch.apps.kmeans import kmeans_step
    from repro_torch.apps.pagerank import pagerank_superstep
    from repro_torch.core.merge_functions import ADD, MIN

    n, e, k, d = 64, 128, 4, 3
    S = axis_size
    g = torch.Generator().manual_seed(0)
    ids = lambda: torch.randint(0, n, (S, e), generator=g,
                                dtype=torch.int32).to(device)
    f32 = lambda *shape: torch.rand(shape, generator=g).to(device)
    cases = [
        ("app:bfs.superstep", bfs_superstep,
         (torch.randint(0, 5, (S, n), generator=g,
                        dtype=torch.int32).to(device), ids(), ids())),
        ("app:pagerank.superstep",
         functools.partial(pagerank_superstep, alpha=0.85),
         (f32(S, n), ids(), ids(), 1.0 + 3.0 * f32(S, n))),
        ("app:kmeans.step", kmeans_step, (f32(S, e, d), f32(S, k, d))),
    ]
    for site, fn, args in cases:
        report.mark_checked(site)
        report.extend(check_noncommit_region(fn, args, site))
    plan = default_plan(axis_size)
    for m in (ADD, MIN):
        site = f"app:default_plan[{axis_size}]:{m.name}"
        report.mark_checked(site)
        report.extend(audit_plan(plan, axis_size, merge_fn=m, site=site))


def serving_stores(device) -> list:
    """(label, store) of every serving store the sweep lints, at the
    reference's geometry (S = 8, R = 256, D = 2 int32, K = 4)."""
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.serve.kv import KVConfig, ShardedKV, serving_plan

    S = SERVE_SHARDS
    cfg = dict(n_keys=SERVE_KEYS, cols=SERVE_COLS, dtype=torch.int32)
    out = []
    for defer in ("all", "top", "none"):
        out.append((f"kv[{defer}]", ShardedKV(
            KVConfig(**cfg), S, device=device, plan=serving_plan(S, defer),
            **({} if defer == "none" else {"commit_every": SERVE_K}))))
    plan = serving_plan(S, "all")
    part = ShardedKV(KVConfig(**cfg, partitioned=True), S, device=device,
                     plan=plan, commit_every=SERVE_K)
    out.append(("kv[part]", part))
    out.append(("kv[part-ov]", ShardedKV(
        KVConfig(**cfg, partitioned=True), S, device=device, plan=plan,
        schedule=DeferSchedule.fixed(SERVE_K, part._deferred_names,
                                     overlap=True))))
    out.append(("kv[blocked]", ShardedKV(
        KVConfig(**cfg, engine="blocked"), S, device=device, plan=plan,
        commit_every=SERVE_K)))
    out.append(("kv[part-blocked]", ShardedKV(
        KVConfig(**cfg, engine="blocked", partitioned=True), S,
        device=device, plan=plan, commit_every=SERVE_K)))
    return out


def _tick_variants(store) -> list[tuple]:
    """(due, land) of every tick program the store has."""
    out = [(due, False) for due in store.supported_dues]
    if store.partitioned and store._overlap:
        out += [(0, True), (store.n_deferred, True)]
    return out


def sweep_store(report: Report, label: str, store,
                batch: int = SERVE_BATCH) -> None:
    """Every check of the serve sweep on one store (module doc)."""
    from repro_torch.analysis import placement
    from repro_torch.analysis.trace import (audit_plan, check_kv_tick_taint,
                                            check_noncommit_region, record)
    from repro_torch.launch.wire_cost import wire_bytes_by_level

    cfg, S = store.config, store.n_shards
    sizes = [lv.size for lv in store.plan.levels]
    names = [lv.name for lv in store.plan.levels]
    site = label
    report.mark_checked(f"{site}:plan")
    report.extend(audit_plan(store.plan, S, merge_fn=cfg.merge,
                             site=f"{site}:plan"))

    for due, land in _tick_variants(store):
        tag = f"due={due}" + (",land" if land else "")
        prog_site = f"{site}:tick[{tag}]"
        report.mark_checked(prog_site)
        fn = (store.raw_tick_fn() if due == "sync"
              else store.raw_tick_fn(due, land=land))
        args = store.tick_args(batch, land=land)
        manifest = (store.scheduled_manifest() if due == "sync"
                    else store.scheduled_manifest(due, land=land))
        _, calls = record(fn, *args)
        walk = placement.walk_of(calls, sizes, names)
        report.extend(placement.check_commit_walk(walk, manifest,
                                                  prog_site))
        if manifest:
            want = wire_bytes_by_level(
                store.plan, S, (cfg.n_keys, cfg.cols),
                args[0].element_size(), merge_fn=cfg.merge,
                levels={m.index for m in manifest})
            report.extend(placement.check_walk_bytes(walk, want, prog_site))
            continue
        # a non-commit tick: no collective, no cross-rank movement
        region_site = f"{site}:region[{tag}]"
        report.mark_checked(region_site)
        report.extend(check_noncommit_region(fn, args, region_site))
        probe_site = f"{site}:isolation[{tag}]"
        report.mark_checked(probe_site)
        report.extend(placement.check_rank_isolation(
            fn, args, (len(args) - 2, len(args) - 1), S, probe_site))
        if label == "kv[all]":
            taint_site = f"{site}:taint[{tag}]"
            report.mark_checked(taint_site)
            settled, pendings, keys, vals = args
            report.extend(check_kv_tick_taint(fn, settled, pendings, keys,
                                              vals, taint_site))

    # donation: the full-commit tick with the driver's donations
    don_site = f"{site}:donation"
    report.mark_checked(don_site)
    fn = (store.raw_tick_fn() if store.synchronized
          else store.raw_tick_fn(store.n_deferred))
    report.extend(placement.check_donation(fn, store.tick_args(batch),
                                           store.donate_argnums, don_site))


def sweep_serve(report: Report, device) -> None:
    for label, store in serving_stores(device):
        sweep_store(report, label, store)


def sweep_durability(report: Report, device) -> None:
    """CC040 over representative deferred train steps: the declared
    volatile spec (``volatile_spec``) must cover the REAL defer state the
    step initializes — drift between the two would let a checkpoint pass
    the lint while dropping mass at restore."""
    from repro_torch.analysis.durability import check_step_durability
    from repro_torch.core import ccache
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.runtime.chaos import ToyDeferredStep

    cases = [("chip:2,host:2:defer,pod:2:defer", (1, 2), 8, False),
             ("chip:2,host:2:defer,pod:2:defer", (2, 4), 8, True),
             ("chip:4,pod:2:defer", (4,), 8, False)]
    for spec, intervals, dp, overlap in cases:
        plan = MergePlan.parse(spec)
        names = tuple(s.name for s in ccache.deferred_stages_of(plan, dp))
        sched = DeferSchedule(names, intervals, overlap=overlap)
        step = ToyDeferredStep(plan, sched, dp, width=4, device=device)
        site = (f"durability:{spec}@dp={dp}"
                + (",overlap" if overlap else ""))
        report.mark_checked(site)
        report.extend(check_step_durability(site, step, step.init_params()))


# ---------------------------------------------------------------------------
# seeded-violation fixtures: each must trip its CC code
# ---------------------------------------------------------------------------


def fixture_checks(device="cpu"
                   ) -> list[tuple[str, str, Callable[[], list]]]:
    """(name, expected CC code, thunk) per seeded violation. The part of a
    name after its ``:`` is the reference fixture's it twins (the
    ``probe:`` one has no twin: it is the port's own device-level CC020)."""
    from repro_torch.analysis import placement
    from repro_torch.analysis.trace import (audit_plan, check_kv_tick_taint,
                                            check_noncommit_region, record)
    from repro_torch.analysis.traits import certify_merge_fn
    from repro_torch.apps.common import scatter
    from repro_torch.core.ccache import StageManifest
    from repro_torch.core.merge_functions import (ADD, MAX, dropping_add,
                                                  saturating_add)
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.core.stacked import StackedAxis

    dev = torch.device(device)
    S = SERVE_SHARDS
    axis = StackedAxis(S, dev)
    g = torch.Generator().manual_seed(0)
    tbl = torch.zeros((S, 8, 2), dtype=torch.int32, device=dev)
    keys = torch.randint(0, 8, (S, 4), generator=g,
                         dtype=torch.int32).to(dev)
    vals = torch.randint(1, 9, (S, 4, 2), generator=g,
                         dtype=torch.int32).to(dev)
    sizes, names = (2, 2, 2), ("chip", "host", "pod")

    def relabel(fn, **traits):
        return dataclasses.replace(fn, **traits)

    def leaky_read_tick(settled, pendings, keys, vals):
        # privatization violation: the pending update path reads settled
        return settled, (pendings[0] + settled,)

    def leaky_write_tick(settled, pendings, keys, vals):
        # pending mass reaches the settled table on a non-commit tick
        return settled + pendings[0], (pendings[0],)

    def psum_tick(settled, pendings, keys, vals):
        # a "non-commit" tick that reduces across ranks
        return settled, (axis.psum(scatter(pendings[0], keys, vals,
                                           kind="add")),)

    def rolled_tick(settled, pendings, keys, vals):
        # hides a cross-rank move from the recorder: a roll over ranks
        p0 = scatter(pendings[0], keys, vals, kind="add")
        return settled, (torch.roll(p0, 1, 0),)

    def spurious_tick(settled, pendings, keys, vals):
        # the scheduled fused reduction, then an unscheduled exchange
        x = axis.psum(scatter(pendings[0], keys, vals, kind="add"))
        return settled, (axis.ppermute(x, [(i, i ^ 1) for i in range(S)]),)

    def copying_tick(settled, keys, vals):
        # the donated table copied whole before the update
        return scatter(settled.clone(), keys, vals, kind="add")

    def spurious_manifest():
        # the plan scheduled ONE fused all-reduce and nothing else
        return [StageManifest(index=0, name="chip", defer=False, stride=1,
                              fanout=8, kind="fused", fused_ops=1,
                              exchange_rounds=0, intra_rounds=0)]

    def walk_fixture(fn, check):
        _, calls = record(fn, tbl.clone(), (tbl.clone(),), keys, vals)
        return check(placement.walk_of(calls, sizes, names))

    parse_plan = MergePlan.parse
    return [
        ("trait:sat_add_declared_scalable", "CC002",
         lambda: certify_merge_fn(relabel(saturating_add(8.0), scalable=True),
                                  site="fixture:sat_add")),
        ("trait:sat_add_declared_deferrable", "CC004",
         lambda: certify_merge_fn(
             relabel(saturating_add(8.0), deferrable=True),
             site="fixture:sat_add")),
        ("trait:sat_add_huge_threshold_deferrable", "CC005",
         lambda: certify_merge_fn(
             relabel(saturating_add(1e9), deferrable=True),
             site="fixture:sat_add_1e9")),
        ("trait:drop_add_declared_deferrable", "CC006",
         lambda: certify_merge_fn(
             relabel(dropping_add(0.25), deferrable=True),
             site="fixture:drop_add")),
        ("trait:add_declared_idempotent", "CC001",
         lambda: certify_merge_fn(relabel(ADD, idempotent=True),
                                  site="fixture:add")),
        ("trait:max_declared_invertible", "CC003",
         lambda: certify_merge_fn(relabel(MAX, invertible=True),
                                  site="fixture:max")),
        ("trace:collective_in_noncommit", "CC010",
         lambda: check_noncommit_region(lambda x: axis.psum(x), (tbl,),
                                        "fixture:psum_region")),
        ("trace:settled_read_escape", "CC011",
         lambda: check_kv_tick_taint(leaky_read_tick, tbl, (tbl,), keys,
                                     vals, "fixture:leaky_read")),
        ("trace:pending_escape", "CC012",
         lambda: check_kv_tick_taint(leaky_write_tick, tbl, (tbl,), keys,
                                     vals, "fixture:leaky_write")),
        ("plan:defer_nondeferrable", "CC013",
         lambda: audit_plan(parse_plan("chip:2,host:4:defer"), 8,
                            merge_fn=saturating_add(8.0),
                            site="fixture:sat_defer_plan")),
        ("plan:geometry_mismatch", "CC014",
         lambda: audit_plan(parse_plan("chip:2,host:2"), 8,
                            site="fixture:bad_geometry")),
        ("walk:collective_in_noncommit_tick", "CC020",
         lambda: walk_fixture(psum_tick, lambda w: (
             placement.check_noncommit_walk(w, "fixture:noncommit_walk")))),
        ("probe:cross_rank_roll_in_noncommit_tick", "CC020",
         lambda: placement.check_rank_isolation(
             rolled_tick, (tbl, (tbl,), keys, vals), (2, 3), S,
             "fixture:rolled_tick")),
        ("walk:spurious_collective_vs_manifest", "CC021",
         lambda: walk_fixture(spurious_tick, lambda w: (
             placement.check_commit_walk(w, spurious_manifest(),
                                         "fixture:spurious_walk")))),
        ("storage:donation_fallback", "CC022",
         lambda: placement.check_donation(copying_tick, (tbl, keys, vals),
                                          (0,), "fixture:donation")),
        ("durability:defer_not_checkpointed", "CC040",
         lambda: durability_fixture(device)),
    ]


def durability_fixture(device="cpu") -> list[Diagnostic]:
    """A driver that checkpoints params/opt + only the INNERMOST pending
    level of a 2-level overlapped cascade: the outer pending and the
    in-flight launch are volatile-only — restore would drop their mass."""
    from repro_torch.analysis.durability import check_checkpoint_coverage
    from repro_torch.checkpoint import defer_state_spec

    params = {"w": torch.zeros((4,), dtype=torch.int32, device=device)}
    spec = defer_state_spec(params, n_levels=2, dp=8, overlap=True)
    saved = {"params": params, "opt": {},
             "defer": {"t": spec["t"], "pending": (spec["pending"][0],)}}
    return check_checkpoint_coverage("fixture:defer_ckpt", spec, saved)


def run_fixtures(device="cpu") -> list[dict]:
    results = []
    for name, code, thunk in fixture_checks(device):
        diags = thunk()
        results.append({
            "name": name, "code": code,
            "tripped": any(d.code == code for d in diags),
            "diags": [d.as_dict() for d in diags],
        })
    return results


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_report(suppressions=(), device="cuda",
                 serve: bool = True) -> Report:
    from repro_torch.serve.kv import resolve_device

    device = resolve_device(device)
    report = Report(suppressions)
    _log("trait certification sweep (standard merges)")
    sweep_merges(report)
    _log("config plan audits (production mesh geometries)")
    sweep_configs(report)
    _log(f"app supersteps under the collective recorder on {device}")
    sweep_apps(report, device)
    _log("defer-state checkpoint coverage (CC040)")
    sweep_durability(report, device)
    if serve:
        _log(f"serve sweep: {SERVE_SHARDS} shards stacked on {device}")
        sweep_serve(report, device)
    return report


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static commutativity & collective-placement verifier "
                    "of the PyTorch port")
    p.add_argument("--device", default="cuda",
                   help="where the programs run: cuda (the default; raises "
                        "without a card) or cpu")
    p.add_argument("--json", metavar="PATH",
                   help="also write the machine-readable report/results")
    p.add_argument("--suppress", action="append", default=[],
                   metavar="CODE[@SITE]",
                   help="keep matching findings visible but non-fatal "
                        "(repeatable); e.g. CC021 or CC021@kv[all]")
    p.add_argument("--fixtures", action="store_true",
                   help="run the seeded-violation suite: every known-bad "
                        "input must trip its CC code")
    p.add_argument("--no-serve", action="store_true",
                   help="skip the serve sweep (fast dev loop)")
    args = p.parse_args(argv)

    if args.fixtures:
        from repro_torch.serve.kv import resolve_device
        results = run_fixtures(resolve_device(args.device))
        missed = [r for r in results if not r["tripped"]]
        for r in results:
            status = "TRIPPED" if r["tripped"] else "MISSED"
            print(f"fixture {r['name']}: {r['code']} {status} "
                  f"({len(r['diags'])} finding(s))")
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"ok": not missed, "fixtures": results}, f,
                          indent=1)
        print(f"fixtures: {'OK' if not missed else 'FAIL'} "
              f"({len(results) - len(missed)}/{len(results)} tripped)")
        return 1 if missed else 0

    report = build_report(args.suppress, device=args.device,
                          serve=not args.no_serve)
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.as_json() + "\n")
    print(report.format())
    return 0 if report.ok() else 1
