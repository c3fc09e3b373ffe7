"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1-5-0-5b \\
        --steps 200 --batch 16 --seq 512 --ckpt-dir ckpt/run1 \\
        [--merge-topology chip:2,host:2:defer,pod:2:defer --merge-defer 4 \\
         --merge-overlap] [--device cpu --smoke] [--layers N] \\
        [--model-ranks N] [--donate]

The counterpart of the JAX package's ``repro/launch/train.py``, with its
flags and its output lines, on one device (``--device``, the card unless
the caller asks for the CPU). The data-parallel ranks of a merge plan live
on that device as a leading dim (``launch/steps.py``); their count is the
plan's ``num_ranks``, or 1. Weights are random from ``--seed``; the data is
the pipeline's synthetic Zipf stream. ``--layers`` cuts the config's depth
(a full-width model that does not fit the card whole).

The JAX CLI's mesh sets the size of the ``"model"`` axis that an
expert-parallel MoE config (``moe_impl="ep"``) runs its experts over:
``--mesh host`` has ``model=1``, ``--mesh prod`` ``model=16``. One card
has no mesh, so ``--model-ranks N`` stands for that axis: the MoE layers
run ``models/moe_ep.apply_ep`` over N model ranks stacked on the device
(default 1 for an ``"ep"`` config, as the host mesh; refused where N does
not split the experts). ``--donate`` makes the optimizer update the
parameters and its moments in place, the counterpart of XLA's buffer
donation, so that no second copy of the state is alive at the optimizer
step; the driver then rewinds a poisoned step to its last checkpoint.

Fault tolerance comes from ``runtime.TrainDriver``: periodic checkpoints,
SIGTERM save-and-exit, NaN skip-batch, straggler logging. Restart the same
command and it resumes from the last committed checkpoint through
``checkpoint.restore``.

``--merge-defer auto`` solves the deferred levels' commit intervals from
what this device measures, where the JAX CLI walks the compiled step's HLO
against a TPU pod's link rates: the wire vector of ``launch/wire_cost.py``
over the gradient tree's bytes, each level's merge timed on the device,
and a probe of the step's own per-rank forward and backward.

``--procs N [--model-ranks M] [--backend gloo|nccl]`` runs the CLI over a
real process group, one process a device of JAX's ``("data", "model")``
mesh of shape ``(N / M, M)`` (``make_host_mesh(data, model)``; ``M`` is 1
by default, as ``--mesh host``; ``--mesh prod`` has ``model=16``): the
command spawns N workers of itself (``launch/mesh.spawn_command``, rank 0
to this output, each other's output to a file) and runs nothing on the
card itself. Each worker joins the train mesh
(``launch/mesh.init_train_mesh``), lays the seeded state out by JAX's
rules (``steps.lay_out_state``: the heads, ``mlp``, ``vocab`` and the
experts over ``"model"``, FSDP over ``"data"``, the moments alike,
``Shard(0)`` pendings), computes every batch whole from the step index and
keeps its data rank's rows (``steps.shard_batch``), and steps
``make_train_step(mesh=)``: tensor-parallel blocks, the vocab-parallel
embedding (its gradient through ``cscatter`` into each process's rows of
the table) and, for an ``"ep"`` config, the expert-parallel MoE
(``moe_ep.apply_ep_mesh``, its combine through ``cscatter``). ``dp`` is
the mesh's ``data`` size. ``--model-ranks`` must divide N and split an MoE
config's experts; with an explicit merge it is refused, as JAX refuses a
non-merge mesh axis above 1; without ``--procs`` only an MoE config takes
it (its stacked model ranks, above). Checkpoints are written by rank 0
from each leaf gathered in turn, in the one on-disk layout, so a run
resumes over another mesh or stacked, and the reverse. The backend is NCCL
on ``--device cuda`` (one card a process) and gloo on ``--device cpu`` by
default; gloo on the card shares it among the processes. A SIGTERM or
SIGINT to the command reaches every worker, which agree on it and save the
same step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.merge_functions import ADD, int8_compressed_add
from repro_torch.data.pipeline import Prefetcher, batch_at, data_config_for
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.serve.kv import resolve_device, sync_device


def measure_defer_inputs(trainer: "Trainer", runs: int = 5) -> dict:
    """What ``--merge-defer auto`` solves from, measured on the trainer's
    device: ``wire`` (machine-wide bytes each plan level moves in one
    eager merge of the gradient tree: ``wire_cost.wire_bytes_by_level``
    summed over its leaves), ``level_s`` (each level's merge alone over a
    ``[dp, n]`` payload of the tree's element count and dtype, median of
    ``runs``), ``rates`` (``wire / level_s``), and ``step_s`` (the per-rank
    forward and backward of step 0's batch, after a warm-up). Over a
    process group each level's merge runs over the step's own
    ``MeshAxis`` on this process's ``[1, n]`` slice, the probe on its own
    rows, and every process takes each time's largest over the processes
    (gathered), so that all of them step one schedule; ``backend`` names
    the group's."""
    from repro_torch.launch.schedule_inputs import (device_name,
                                                    time_level_merges)
    from repro_torch.launch.wire_cost import wire_bytes_by_level

    plan, dp, device = trainer.topology, trainer.dp, trainer.device
    params = trainer.state["params"]
    merge = trainer.merge_fn
    names = tuple(lv.name for lv in plan.levels)
    wire = [0.0] * len(names)
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        for i, b in enumerate(wire_bytes_by_level(
                plan, dp, tuple(p.shape), p.element_size(), merge)):
            wire[i] += b
    n = sum(p.numel() for p in leaves)
    mesh, axis = trainer.mesh, None
    if mesh is not None:
        from repro_torch.core.mesh_axis import MeshAxis, redistribute
        axis = MeshAxis(mesh, ("data",), device)
    payload = torch.ones((dp if axis is None else 1, n),
                         dtype=leaves[0].dtype, device=device)
    level_s = time_level_merges(plan, payload, merge, runs, axis=axis)
    del payload
    grads_of = steps.grads_fn(trainer.model, trainer.microbatches)
    batch = batch_at(trainer.dcfg, 0)
    if mesh is None:
        batch = steps.to_device(batch, device)
        probe = lambda: steps.rank_grads(grads_of, params, batch, dp)
    else:
        # this process's rank: its rows against the parameters whole
        whole = pytree.tree_map(lambda p: redistribute(
            p, steps.replicated(mesh)).to_local(), params)
        rows = pytree.tree_map(lambda x: x.to_local(),
                               steps.shard_batch(batch, mesh))
        probe = lambda: grads_of(whole, rows)
    probe()                                             # warm-up
    sync_device(device)
    t0 = time.perf_counter()
    probe()
    sync_device(device)
    step_s = time.perf_counter() - t0
    backend = {}
    if axis is not None:
        # every process solves from the same (the slowest process's) times
        times = axis.all_gather(torch.tensor([level_s + [step_s]],
                                             dtype=torch.float64,
                                             device=device))
        *level_s, step_s = times.amax(0).tolist()
        backend = {"backend": f"{axis.backend} ({dp} processes)"}
    rates = [b / t if b > 0 else float("inf") for b, t in zip(wire, level_s)]
    return {"names": names, "wire": wire, "level_s": level_s,
            "rates": rates, "step_s": step_s,
            "device": device_name(device), **backend}


def solve_defer_for_cli(merge_defer: str, trainer: "Trainer",
                        overlap: bool = False):
    """Resolve ``--merge-defer`` into a ``DeferSchedule`` for the trainer's
    plan: an integer fixes every deferred level's K; ``auto`` solves the
    intervals from :func:`measure_defer_inputs`. Algebra-invalid
    defer/overlap combinations fail first."""
    from repro_torch.core.ccache import deferred_stages_of
    from repro_torch.core.defer_schedule import (DeferSchedule,
                                                 solve_defer_schedule)
    from repro_torch.launch.schedule_inputs import describe_inputs

    topology, dp, merge_fn = trainer.topology, trainer.dp, trainer.merge_fn
    if overlap:
        merge_fn.check_overlap("--merge-defer with --merge-overlap")
    else:
        merge_fn.check_deferrable("--merge-defer")
    deferred_names = tuple(
        s.name for s in deferred_stages_of(topology, dp, merge_fn=merge_fn))
    if not deferred_names:
        raise SystemExit("--merge-defer: the :defer levels all have size 1 "
                         "and compile away; drop the flags")
    if merge_defer != "auto":
        try:
            k = int(merge_defer)
        except ValueError:
            raise SystemExit(f"--merge-defer must be 'auto' or an integer, "
                             f"got {merge_defer!r}")
        if k < 1:
            raise SystemExit("--merge-defer: K must be >= 1")
        return DeferSchedule.fixed(k, deferred_names, overlap=overlap)

    print("merge-defer auto: measuring the level merges and the step on "
          "the device...")
    inputs = measure_defer_inputs(trainer)
    for line in describe_inputs(inputs, "per-rank step", "step_s"):
        print(line)
    return solve_defer_schedule(
        topology, inputs["wire"], inputs["names"],
        compute_s=inputs["step_s"], overlap=overlap, merge_fn=merge_fn,
        bandwidths=inputs["rates"])


def model_ranks_for(cfg, ranks: Optional[int],
                    procs: Optional[int] = None) -> Optional[int]:
    """``--model-ranks``: the size of the model axis ``cfg``'s MoE layers
    run over, 1 for an ``"ep"`` config when not given (the JAX host
    mesh's), ``None`` (no model axis) for any other config. With
    ``procs`` (the train mesh over processes) it is the mesh's ``"model"``
    size, which a dense config takes too (JAX's ``--mesh prod`` layout:
    heads, ``mlp``, ``vocab`` and the experts over ``"model"``); it must
    divide the processes."""
    if ranks is None:
        return 1 if cfg.moe_impl == "ep" else None
    if procs is not None:
        if ranks < 1 or procs % ranks:
            raise SystemExit(f"--model-ranks {ranks} does not divide "
                             f"--procs {procs} (the mesh is (data, model) "
                             f"= (procs / model-ranks, model-ranks))")
        if cfg.family != "moe":
            return ranks
    elif cfg.family != "moe":
        raise SystemExit(f"--model-ranks: {cfg.name} has no MoE layers "
                         f"(with --procs it is the mesh's model axis)")
    if ranks < 1 or cfg.n_experts % ranks:
        raise SystemExit(f"--model-ranks {ranks} does not split "
                         f"{cfg.name}'s {cfg.n_experts} experts")
    return ranks


@dataclasses.dataclass
class Trainer:
    """What the flags build: the model, the step, the initial state and
    the data config (``state`` is fresh from the seed, not resumed; a run
    takes it over, so that the initial buffers are freed as it moves)."""

    cfg: Any
    model: Any
    optimizer: Any
    step_fn: Any
    state: dict
    dcfg: Any
    device: torch.device
    dp: int
    microbatches: int
    topology: Any = None
    merge_fn: Any = None
    schedule: Any = None
    mesh: Any = None            # the train mesh over processes, or None

    @property
    def deferred(self) -> Optional[steps.DeferredTrainStep]:
        return self.step_fn if self.schedule is not None else None


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--merge-group-size", type=int, default=0,
                   help="explicit hierarchical gradient merge: ranks per "
                        "intra-group level (0 = implicit reduction); "
                        "two-level shorthand for --merge-topology")
    p.add_argument("--merge-topology", default="",
                   help="N-level MergePlan over the data-parallel ranks, "
                        "innermost level first: 'chip:2,host:2,pod:2' "
                        "(level flags: :compress :software :defer); the "
                        "product of sizes is the rank count, stacked on "
                        "the device; :defer levels need --merge-defer")
    p.add_argument("--merge-defer", default="",
                   help="commit schedule of the topology's :defer levels: "
                        "'auto' solves per-level intervals K from the wire "
                        "vector, the level merges and the step timed on the "
                        "device; an integer fixes K for every deferred "
                        "level. The optimizer steps once per full commit on "
                        "the cycle's mean gradient (K-step gradient "
                        "accumulation)")
    p.add_argument("--merge-overlap", action="store_true",
                   help="overlap the deferred top-level commit with the "
                        "next step: the full-commit step launches the "
                        "exchange and it lands one step later (the "
                        "optimizer steps one step stale). Requires "
                        "--merge-defer; only additive gradient merges")
    p.add_argument("--merge-lane-parallel", action="store_true",
                   help="shard the representative role over each unit's "
                        "lanes (requires --merge-topology)")
    p.add_argument("--merge-compress", action="store_true",
                   help="int8-compress the outermost-level gradient "
                        "exchange (requires --merge-group-size or "
                        "--merge-topology)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the config's depth to this many layers")
    p.add_argument("--model-ranks", type=int, default=None,
                   help="the JAX mesh's 'model' axis: with --procs N the "
                        "mesh is (N / M, M), one process a device; without "
                        "it, the model ranks an expert-parallel MoE "
                        "config's layers run over, stacked on the device "
                        "(default 1 for an 'ep' config)")
    p.add_argument("--donate", action="store_true",
                   help="update the parameters and the optimizer's moments "
                        "in place (buffer donation); a poisoned step then "
                        "rewinds to the last checkpoint")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--procs", type=int, default=None,
                   help="run over this many processes, one a device of "
                        "the train mesh (data, model)")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="with --procs: the process group's backend (nccl "
                        "on --device cuda, gloo on --device cpu by default)")
    # one spawned process of --procs: its rank and the group's file init
    p.add_argument("--worker", nargs=2, metavar=("RANK", "INIT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.procs is None:
        if args.backend is not None:
            p.error("--backend is the process group's: add --procs N")
        return args
    if args.procs < 2:
        p.error("--procs needs at least 2 processes")
    device_type = torch.device(args.device).type
    if args.backend is None:
        args.backend = "nccl" if device_type == "cuda" else "gloo"
    if args.backend == "nccl" and device_type != "cuda":
        p.error("--backend nccl runs on the card: it takes --device cuda "
                "(gloo runs on the CPU)")
    return args


@dataclasses.dataclass
class Flags:
    """What the flags decide before anything is built: the config, the
    merge topology, the data-parallel rank count and whether the plan
    defers."""

    cfg: Any
    model_ranks: Optional[int]
    topology: Any
    dp: int
    has_deferred: bool
    model: int = 1             # the train mesh's "model" size (--procs)


def check_flags(args) -> Flags:
    """The JAX CLI's refusals of bad flag combinations, made before any
    model is built or process started. ``dp`` is the train mesh's
    ``data`` size over ``--procs`` (``--procs / --model-ranks``, as the
    JAX CLI reads its mesh), else the merge plan's rank count stacked on
    the device, or 1."""
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.layers is not None:
        if not cfg.first_dense_layers < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers, "
                             f"{cfg.first_dense_layers} of them dense")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    procs = getattr(args, "procs", None)
    model_ranks = model_ranks_for(cfg, args.model_ranks, procs)
    # over processes the mesh is (data, model): the data axis is the rest
    model = (model_ranks or 1) if procs is not None else 1
    if model > 1 and cfg.family not in ("dense", "moe", "vlm"):
        raise SystemExit(f"--model-ranks {model} with --procs: the model "
                         f"axis over processes runs the decoder families "
                         f"(dense, moe, vlm), not {cfg.family!r}")
    if model > 1 and (args.merge_group_size or args.merge_topology):
        raise SystemExit(
            f"--model-ranks {model} with an explicit merge: explicit "
            f"hierarchical gradient merge needs the non-merge mesh axes to "
            f"be trivial, but ['model'] have size > 1 (JAX's "
            f"NotImplementedError); use the implicit reduction (no merge "
            f"flag) for the model axis over processes")
    if args.merge_group_size and args.merge_topology:
        raise SystemExit("--merge-group-size and --merge-topology are "
                         "mutually exclusive")
    if args.merge_compress and not (args.merge_group_size
                                    or args.merge_topology):
        raise SystemExit("--merge-compress requires --merge-group-size or "
                         "--merge-topology")
    if args.merge_lane_parallel and not args.merge_topology:
        raise SystemExit("--merge-lane-parallel requires --merge-topology")
    topology, dp = None, (procs // model if procs else 1)
    if args.merge_group_size:
        from repro_torch.core.ccache import MergeTopology
        if dp % args.merge_group_size != 0:
            raise SystemExit(
                f"--merge-group-size {args.merge_group_size} does not divide "
                f"the data axis ({dp} devices)")
        topology = MergeTopology(group_size=args.merge_group_size)
    elif args.merge_topology:
        from repro_torch.core.merge_plan import MergePlan
        try:
            topology = MergePlan.parse(args.merge_topology,
                                       lane_parallel=args.merge_lane_parallel)
        except ValueError as e:
            raise SystemExit(f"--merge-topology: {e}")
        if procs is None:
            dp = topology.num_ranks
        else:
            try:
                topology.validate(dp)
            except ValueError as e:
                raise SystemExit(f"--merge-topology: {e} (data-parallel "
                                 f"axes ('data',))")
        if args.batch % dp != 0:
            raise SystemExit(
                f"--batch {args.batch} must be divisible by the merge "
                f"topology's {dp} ranks (each rank takes an equal batch "
                f"shard)")
    if args.batch % dp != 0:
        raise SystemExit(
            f"--batch {args.batch} must be divisible by --procs {dp} (each "
            f"process takes an equal batch shard)" if model == 1 else
            f"--batch {args.batch} must be divisible by the mesh's {dp} data"
            f" ranks (--procs {procs} / --model-ranks {model})")
    if (args.batch // dp) % args.microbatches != 0:
        raise SystemExit(
            f"--batch {args.batch} over {dp} rank(s) gives {args.batch // dp}"
            f" rows a rank, which --microbatches {args.microbatches} does not"
            f" divide")
    has_deferred = topology is not None and getattr(topology, "has_deferred",
                                                    False)
    if args.merge_defer and not has_deferred:
        raise SystemExit("--merge-defer requires a --merge-topology with "
                         ":defer levels")
    if args.merge_overlap and not args.merge_defer:
        raise SystemExit("--merge-overlap requires --merge-defer (the "
                         "launch/land pipeline splits a *deferred* commit "
                         "across two steps)")
    if has_deferred and not args.merge_defer:
        raise SystemExit(
            "--merge-topology has :defer levels; pass --merge-defer "
            "auto|K to schedule the commits (the optimizer steps once "
            "per commit on the K-step mean gradient), or drop the "
            ":defer flags for an eager merge every step")
    return Flags(cfg, model_ranks, topology, dp, has_deferred, model)


def build(args, mesh=None) -> Trainer:
    """The model, optimizer, step and initial state the flags describe,
    with the JAX CLI's refusals of bad flag combinations. With ``mesh``
    (the train mesh over processes) the state is laid out on it and the
    step runs over it."""
    device = (steps.mesh_device(mesh) if mesh is not None
              else resolve_device(args.device))
    flags = check_flags(args)
    cfg, topology, dp = flags.cfg, flags.topology, flags.dp
    shape_cfg = ShapeConfig("cli", args.seq, args.batch, "train")
    optimizer = make_optimizer(
        cfg, warmup_cosine(args.lr, args.warmup, args.steps))
    model = build_model(cfg, device=device, seed=args.seed,
                        model_ranks=flags.model_ranks)
    params = model.params()
    if mesh is None:
        state = {"params": params, "opt": optimizer.init(params)}
    else:
        # each process keeps its slices: the moments are made split, and
        # the module's whole parameters are let go once laid out
        meta = pytree.tree_map(lambda p: p.to("meta"), params)
        state = steps.lay_out_state(
            {"params": params, "opt": optimizer.init(meta)}, cfg, shape_cfg,
            mesh)
        params = state["params"]
        model.to("meta")
    merge_fn = int8_compressed_add() if args.merge_compress else ADD
    trainer = Trainer(
        cfg=cfg, model=model, optimizer=optimizer, step_fn=None,
        state=state, dcfg=data_config_for(cfg, shape_cfg, seed=args.seed),
        device=device, dp=dp, microbatches=args.microbatches,
        topology=topology, merge_fn=merge_fn, mesh=mesh)
    if flags.has_deferred:
        trainer.schedule = solve_defer_for_cli(args.merge_defer, trainer,
                                               overlap=args.merge_overlap)
        print("merge-defer schedule:", trainer.schedule.describe())
        if args.steps % trainer.schedule.period != 0:
            print(f"note: --steps {args.steps} is not a multiple of the "
                  f"commit period {trainer.schedule.period}; the trailing "
                  f"partial cycle is settled by the final flush")
    trainer.step_fn = steps.make_train_step(
        model, cfg, optimizer, args.microbatches,
        dp=dp if mesh is None else None, mesh=mesh,
        merge_topology=topology, merge_compress=args.merge_compress,
        defer_schedule=trainer.schedule, donate=args.donate)
    if trainer.schedule is not None:
        trainer.state["defer"] = trainer.step_fn.init_defer_state(params)
    return trainer


@dataclasses.dataclass
class TrainResult:
    state: dict
    start: int
    end: int
    events: list
    flushed: Optional[dict]


def main(argv=None) -> Optional[TrainResult]:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.procs is not None and args.worker is None:
        # refuse before any process starts (a missing card too)
        check_flags(args)
        resolve_device(args.device)
        from repro_torch.launch.mesh import spawn_command
        return spawn_command("repro_torch.launch.train", argv, args.procs)
    mesh = None
    if args.worker is not None:
        from repro_torch.launch import mesh as pmesh
        torch.set_num_threads(1)
        mesh = pmesh.init_train_mesh(
            args.backend, torch.device(args.device).type,
            init_method=args.worker[1], rank=int(args.worker[0]),
            world_size=args.procs, model=check_flags(args).model)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            pmesh.shutdown()


def _train(args, mesh) -> TrainResult:
    """The run the flags describe, on one device or, over ``mesh``, as one
    process of the group (every process prints; the command shows rank
    0's output)."""
    trainer = build(args, mesh)
    # the run holds the only reference: the initial buffers go as it moves
    state, trainer.state = trainer.state, None
    device = trainer.device

    # Resume from the last committed checkpoint if present.
    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None:
        state, extras = ckpt.restore(args.ckpt_dir, state)
        start = extras.get("next_step", last)
        print(f"resumed from checkpoint step {last} -> start {start}")

    prefetch = Prefetcher(trainer.dcfg, start_step=start)

    def step_fn(s, b):
        if mesh is not None:
            b = steps.shard_batch(b, mesh)
        out = trainer.step_fn(s, b)
        sync_device(device)        # the driver's dt is the step's own time
        return out
    step_fn.donates = args.donate

    from repro_torch.runtime import DriverConfig, TrainDriver
    driver = TrainDriver(
        DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     log_path=args.log),
        step_fn=step_fn, batch_fn=lambda i: prefetch.get()[1],
        # deferred runs record the durability manifest next to each
        # boundary save
        defer_step=trainer.deferred)
    if trainer.schedule is not None:
        driver._log({"event": "defer_schedule",
                     "schedule": trainer.schedule.describe()})
    try:
        state, end = driver.run(state, start, args.steps - start)
    finally:
        prefetch.stop()
    fmetrics = None
    if trainer.deferred is not None:
        # Drain the deferred machinery: land any in-flight overlapped
        # commit and settle the trailing partial cycle, so no gradient
        # mass is dropped at the end of the run.
        state, fmetrics = trainer.deferred.flush(state)
        if fmetrics is not None:
            parts = []
            if fmetrics.get("flushed_inflight"):
                parts.append("landed the in-flight commit")
            if "flushed_steps" in fmetrics:
                parts.append(f"settled a {fmetrics['flushed_steps']}-step"
                             f" partial cycle")
            print("final flush:", ", ".join(parts))
    # what the run launched and held on the card, in this process's log
    from repro_torch.kernels import launch_counts
    driver._log({"event": "run_end", "step": end,
                 "launches": launch_counts(),
                 "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                       if device.type == "cuda" else 0)})
    losses = [e for e in driver.events if e.get("event") == "step"]
    if losses:
        print(f"steps {start}..{end}: loss {losses[0]['loss']:.4f} -> "
              f"{losses[-1]['loss']:.4f}")
    return TrainResult(state, start, end, driver.events, fmetrics)


if __name__ == "__main__":
    main()
