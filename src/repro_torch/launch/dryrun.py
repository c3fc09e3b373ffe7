"""Production-mesh dry-run: trace every (arch x shape x mesh) cell without
devices and count its work.

The port of the JAX package's ``repro/launch/dryrun.py``. For each cell:

* build the step plan (``launch/steps.py``) on the production mesh
  (``launch/mesh.py``: a ``DeviceMesh`` of 256 or 512 ranks over a fake
  process group);
* trace the step once on meta DTensors under the op-level walk
  (``launch/op_cost.py``): per-device FLOPs, HBM bytes, the collectives
  DTensor inserted with their wire bytes by level of the cluster, and the
  peak of live bytes a device holds (nothing is allocated);
* derive the three roofline terms at the H100's rates
  (``launch/hw_analysis.py``) twice: ``roofline`` with the walk's HBM
  bytes, the eager program's traffic (JAX's record counts its compiled
  program's), and ``roofline_floor`` with the step's boundary bytes (its
  inputs read once and its outputs written once), the least time any
  implementation could take, which a measured step's roofline share is
  taken against; the useful-FLOPs ratio (6ND train, 2ND forward) and, on
  the two-pod mesh, the defer schedule of the top level;
* write ``<out>/<arch>__<shape>__<mesh>.json`` and print
  ``[arch x shape x mesh] compute=... dominant=... floor=...``.

A cell deeper than :data:`SCALE_ABOVE` layers is traced at 2 and 3 layers
and every count extrapolated linearly to its depth (``trip_counts``,
``traced_layers``), as the HLO walk scales a loop body by its trip count.
A family whose model walks time in a Python loop (:data:`TIME_LOOPS`: the
xLSTM's sLSTM steps token by token, its mLSTM 256-token chunks) is traced,
for a train or prefill cell longer than 3 chunks, at 2 and 3 chunks and
extrapolated linearly to the cell's length (``trip_counts`` the chunks,
``traced_lengths``): JAX's walk scales a ``lax.scan`` body by its trip
count the same way. That is exact because no op of the family grows
faster than the sequence (the one count that grows slower is
``cscatter``'s row term, ``min(N, R)``, in the train cells' embedding
backward). ``trace_cell(..., exact=True)`` traces the whole depth and
length (the tests hold both extrapolations to it).

Every family is planned: the 64 cells of ``ARCH_IDS`` x each config's
``applicable_shapes`` x both meshes. There is no ``--dump-hlo``: there is
no HLO.

Run one cell:     python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
Multi-pod:        ... --multipod
Everything:       python -m repro_torch.launch.dryrun --all --mesh both
(--all spawns one subprocess per cell.)

Nothing runs on any device, so no card is needed: the plan is the same on
a card's host and anywhere else.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

SCALE_ABOVE = 32        # deeper cells are traced at 2 and 3 layers, scaled
# family -> the step of its Python loop over time; longer train and prefill
# cells are traced at 2 and 3 steps, scaled
TIME_LOOPS = {"ssm": 256}
_NUMERIC = (int, float)


def _extrapolate(a, b, steps: int):
    """``a + steps * (b - a)`` through nested dicts and lists of numbers
    (a key missing on one side counts 0)."""
    if isinstance(a, bool) or isinstance(b, bool):
        return b
    if isinstance(a, _NUMERIC) and isinstance(b, _NUMERIC):
        return a + steps * (b - a)
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), steps)
                for k in {**a, **b}}
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [_extrapolate(x, y, steps) for x, y in zip(a, b)]
    return b


def _scaled(walks: list, steps: int) -> dict:
    """Two walks extrapolated ``steps`` past the first, in the second's
    levels."""
    walk = _extrapolate(walks[0], walks[1], steps)
    walk["level_names"] = walks[1]["level_names"]
    walk["level_sizes"] = walks[1]["level_sizes"]
    return walk


def trace_cell(cfg, shape_cfg, mesh, level_sizes, level_names,
               extra_rules=None, exact: bool = False, **kw) -> dict:
    """The op walk of one cell: traced whole; or, when not ``exact``, at 2
    and 3 layers and extrapolated to the config's depth when it is deeper
    than :data:`SCALE_ABOVE`, or at 2 and 3 steps of its loop over time
    (:data:`TIME_LOOPS`) and extrapolated to the cell's length."""
    from repro_torch.launch.steps import lowering_rules, plan_for
    depth = cfg.n_layers
    step = TIME_LOOPS.get(cfg.family)
    over_time = (step is not None and shape_cfg.kind != "decode"
                 and shape_cfg.seq_len > 3 * step)
    if exact or (depth <= SCALE_ABOVE and not over_time):
        walk = plan_for(cfg, shape_cfg, mesh, extra_rules=extra_rules,
                        **kw).trace(level_sizes, level_names)
        walk["trip_counts"] = []
        return walk
    # the full cell's rules (depth, length and size pick some of them)
    rules = lowering_rules(cfg, shape_cfg, mesh)
    rules.update(extra_rules or {})
    if over_time:
        if depth > SCALE_ABOVE or shape_cfg.seq_len % step:
            raise ValueError(f"{cfg.name} x {shape_cfg.name}: no linear "
                             f"scaling over both depth and time, or over a "
                             f"length that is not a multiple of {step}")
        lengths = [2 * step, 3 * step]
        walk = _scaled(
            [plan_for(cfg, dataclasses.replace(shape_cfg, seq_len=n), mesh,
                      extra_rules=rules, **kw).trace(level_sizes,
                                                     level_names)
             for n in lengths], (shape_cfg.seq_len - lengths[0]) // step)
        walk["trip_counts"] = [shape_cfg.seq_len // step]
        walk["traced_lengths"] = lengths
        return walk
    walk = _scaled(
        [plan_for(dataclasses.replace(cfg, n_layers=n), shape_cfg, mesh,
                  extra_rules=rules, **kw).trace(level_sizes, level_names)
         for n in (2, 3)], depth - 2)
    walk["trip_counts"] = [depth]
    walk["traced_layers"] = [2, 3]
    return walk


def model_flops(cfg, shape_cfg) -> float:
    """MODEL_FLOPS: 6ND train, 2ND forward-only (N_active for MoE), D the
    tokens the step processes."""
    n_active = cfg.n_active_params()
    if shape_cfg.kind == "train":
        return 6.0 * n_active * shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "prefill":
        return 2.0 * n_active * shape_cfg.global_batch * shape_cfg.seq_len
    return 2.0 * n_active * shape_cfg.global_batch


def _defer_schedules(walk: dict, terms: dict, rec: dict) -> None:
    """The two-pod what-if: were the top level deferred, the per-level
    roofline picks its commit interval (and with the overlapped commit)."""
    from repro_torch.core.defer_schedule import solve_defer_schedule
    from repro_torch.core.merge_plan import MergeLevel, MergePlan
    from repro_torch.launch.hw_analysis import level_bandwidths
    names, sizes = walk["level_names"], walk["level_sizes"]
    what_if = MergePlan(levels=tuple(
        MergeLevel(nm, sz, defer=(i == len(sizes) - 1))
        for i, (nm, sz) in enumerate(zip(names, sizes))))
    bws = level_bandwidths(len(sizes), names)
    for key, overlap in (("defer_schedule", False),
                         ("defer_schedule_overlap", True)):
        sched = solve_defer_schedule(
            what_if, walk["wire_bytes_by_level"], names, bandwidths=bws,
            compute_s=terms["compute_s"], memory_s=terms["memory_s"],
            overlap=overlap)
        rec[key] = sched.as_dict()
        print(f"{key}:", sched.describe())


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             extra_rules: dict | None = None, tag: str = "",
             microbatches: int | None = None, smoke: bool = False,
             overrides: dict | None = None) -> dict:
    from repro_torch.configs.base import (SHAPES, ShapeConfig, get_config,
                                          get_smoke_config)
    from repro_torch.launch import hw_analysis as hw
    from repro_torch.launch.mesh import make_production_mesh, mesh_name

    if smoke:
        cfg = get_smoke_config(arch)
        base = SHAPES[shape]
        shape_cfg = ShapeConfig(base.name, min(base.seq_len, 512),
                                min(base.global_batch, 32), base.kind)
    else:
        cfg = get_config(arch)
        shape_cfg = SHAPES[shape]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch, "shape": shape, "mesh": name,
                 "chips": 512 if multi_pod else 256, "status": "running",
                 "kind": shape_cfg.kind}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh_name(mesh) == name
        sizes, names = hw.mesh_levels(dict(zip(mesh.mesh_dim_names,
                                               mesh.shape)))
        kw = ({"num_microbatches": microbatches}
              if microbatches is not None and shape_cfg.kind == "train"
              else {})
        walk = trace_cell(cfg, shape_cfg, mesh, sizes, names,
                          extra_rules=extra_rules, **kw)
        rec["trace_s"] = time.time() - t0
        live = int(walk["peak_live_bytes"])
        rec["memory"] = {"live_bytes_per_device": live,
                         "input_bytes_per_device": int(walk["input_bytes"]),
                         "boundary_bytes_per_device":
                             int(walk["boundary_bytes"]),
                         "fits_80gb_hbm": bool(live < hw.HBM_BYTES)}
        rec["op_walk"] = {k: walk[k] for k in (
            "flops", "hbm_bytes", "wire_bytes", "wire_bytes_by_level",
            "level_names", "level_sizes", "trip_counts", "kernels")}
        for key in ("traced_layers", "traced_lengths"):
            if key in walk:
                rec["op_walk"][key] = walk[key]
        rec["op_walk"]["per_collective"] = walk["per_collective"]
        rec["per_collective"] = walk["per_collective"]
        rec["op_walk"]["wire_bytes_inter_derived"] = hw.dci_bytes(
            walk["wire_bytes_by_level"], walk["level_names"])
        rec["op_walk"]["top_ops"] = dict(list(walk["by_op"].items())[:12])
        terms = hw.roofline_terms(
            walk["flops"], walk["hbm_bytes"], walk["wire_bytes"],
            wire_bytes_by_level=walk["wire_bytes_by_level"],
            level_names=walk["level_names"])
        rec["roofline"] = terms
        floor = hw.roofline_terms(
            walk["flops"], walk["boundary_bytes"], walk["wire_bytes"],
            wire_bytes_by_level=walk["wire_bytes_by_level"],
            level_names=walk["level_names"])
        rec["roofline_floor"] = floor
        if multi_pod and walk["wire_bytes_by_level"][-1] > 0:
            _defer_schedules(walk, terms, rec)
        rec["model_flops"] = model_flops(cfg, shape_cfg)
        total = walk["flops"] * rec["chips"]
        rec["useful_flops_ratio"] = (rec["model_flops"] / total
                                     if total else None)
        rec["hw"] = hw.H100.as_dict()
        rec["status"] = "ok"
        useful = rec["useful_flops_ratio"]
        print(f"[{arch} x {shape} x {name}] "
              f"compute={terms['compute_s']:.4f}s "
              f"memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s "
              f"dominant={terms['dominant']} "
              f"useful={useful and round(useful, 3)} "
              f"floor={floor['bound_s']:.4f}s ({floor['dominant']}; "
              f"memory {floor['memory_s']:.4f}s)")
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()
        print(f"[{arch} x {shape} x {name}] FAILED: {e!r}", file=sys.stderr)
    return _write(rec, out_dir, tag, t0)


def _write(rec: dict, out_dir: str, tag: str, t0: float) -> dict:
    rec["total_s"] = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                                 f"{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    print("wrote", path)
    return rec


def orchestrate(meshes: list[bool], out_dir: str, force: bool,
                timeout: int, only_arch: str | None = None) -> int:
    """Every cell of ``ARCH_IDS`` x its shapes x ``meshes``, one subprocess
    a cell -> the number of failed cells."""
    from repro_torch.configs.base import ARCH_IDS, applicable_shapes, \
        get_config
    failures = 0
    for arch in ARCH_IDS:
        if only_arch and arch != only_arch.replace("-", "_"):
            continue
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            for multi_pod in meshes:
                name = "pod2x16x16" if multi_pod else "pod16x16"
                path = os.path.join(out_dir, f"{arch}__{shape}__{name}.json")
                if os.path.exists(path) and not force:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            print("cached:", path)
                            continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out_dir]
                if multi_pod:
                    cmd.append("--multipod")
                print(">>>", " ".join(cmd), flush=True)
                try:
                    r = subprocess.run(cmd, timeout=timeout)
                    failures += r.returncode != 0
                except subprocess.TimeoutExpired:
                    failures += 1
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": name, "status": "timeout",
                                   "timeout_s": timeout}, f)
                    print(f"TIMEOUT: {arch} x {shape} x {name}",
                          file=sys.stderr)
    return failures


def _overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multipod", action="store_true")
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single")
    p.add_argument("--all", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--timeout", type=int, default=3600)
    p.add_argument("--tag", default="",
                   help="suffix for experiment variants")
    p.add_argument("--rules", default="",
                   help="JSON dict of extra logical->mesh rules")
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config on the production mesh (tests)")
    p.add_argument("--set", action="append", default=[],
                   help="config overrides, e.g. --set remat=full")
    args = p.parse_args(argv)

    if args.all:
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
        failures = orchestrate(meshes, args.out, args.force, args.timeout,
                               only_arch=args.arch)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        p.error("--arch and --shape are required without --all")
    extra_rules = json.loads(args.rules) if args.rules else None
    if extra_rules:
        extra_rules = {k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in extra_rules.items()}
    rec = run_cell(args.arch.replace("-", "_"), args.shape, args.multipod,
                   args.out, extra_rules=extra_rules, tag=args.tag,
                   microbatches=args.microbatches, smoke=args.smoke,
                   overrides=_overrides(args.set) or None)
    sys.exit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
