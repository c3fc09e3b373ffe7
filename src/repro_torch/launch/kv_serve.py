"""Sharded commutative KV serving driver, on one GPU or over processes.

    PYTHONPATH=src python -m repro_torch.launch.kv_serve --shards 8 \\
        --keys 65536 --ticks 64 --batch 512 --dist pareto --defer 8

Runs the :mod:`repro_torch.serve` tier with every shard stacked on one
device (``--device``, default ``cuda``; ``--device cpu`` runs the kernels'
plain versions on the CPU). Prints the ingest rate and checks the flushed
table's mass against the stream.

``--procs N`` runs the store over a process group instead, one process a
shard (``--shards`` must equal ``N``; the JAX CLI's store on its device
mesh): this command spawns the ``N`` processes, every one of which builds
the same store on the mesh executor (``apps/sharded.mesh_spmd``) and is
handed the same stream; rank 0 alone prints. ``--backend`` is the group's,
the caller's choice: ``nccl`` (the default on ``--device cuda``: one card a
process, refused on a host with fewer cards) or ``gloo`` (the default on
``--device cpu``; on the card it stages its exchanges through the host, so
several processes may share a card). ``nccl`` with ``--device cpu`` is
refused.

``--defer`` picks the commit policy:

* ``sync`` — the fully-synchronized reference (merge every tick);
* an integer ``K`` — fixed commit interval over a fully deferred plan;
* ``auto`` — derive the per-level wire vector of the synchronized tick
  (``launch/wire_cost.py``), measure each level's rate on the device (the
  time of that level's merge alone over the ``[S, R, D]`` payload, median
  of 5 runs) and the time of a never-committing deferred tick, and serve
  with ``solve_defer_schedule``'s schedule (printed before the run);
* ``adaptive`` — the same inputs, with the commit interval re-solved
  online from the measured ingest rate (``AdaptiveDeferSchedule``).

``--partitioned`` home-shards the settled
table (each row on exactly one shard; reads route by ``key % shards``) and
bounds pending state with a ring (or, with ``--engine blocked``, a spill
buffer of ``--spill-blocks`` blocks); ``--overlap`` additionally pipelines
the commit's launch/land halves (requires ``--partitioned``).

``--engine blocked`` privatizes through the W-way source buffer
(``--ways`` ways of 8 rows, merge-on-evict through the ``cmerge`` kernel)
instead of the ``cscatter`` kernel, and prints its eviction counters.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.launch.schedule_inputs import (describe_inputs, device_name,
                                                time_level_merges)
from repro_torch.serve.kv import resolve_device, sync_device


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--keys", type=int, default=1 << 16,
                   help="table rows (counter keys)")
    p.add_argument("--cols", type=int, default=4, help="columns per key")
    p.add_argument("--shards", type=int, default=8, help="shards")
    p.add_argument("--ticks", type=int, default=64,
                   help="update batches to ingest")
    p.add_argument("--batch", type=int, default=512,
                   help="updates per shard per tick")
    p.add_argument("--defer", default="8",
                   help="sync | auto | adaptive | K (fixed commit "
                        "interval)")
    p.add_argument("--partitioned", action="store_true",
                   help="home-shard the settled table (routed reads, ring "
                        "pendings)")
    p.add_argument("--overlap", action="store_true",
                   help="overlap the commit's launch/land halves "
                        "(requires --partitioned)")
    p.add_argument("--spill-blocks", type=int, default=64,
                   help="blocked engine, partitioned: spill buffer slots")
    p.add_argument("--consistency", default="eventual",
                   choices=["eventual", "read_your_writes"])
    p.add_argument("--engine", default="kernel",
                   choices=["kernel", "blocked"])
    p.add_argument("--dist", default="pareto", choices=["uniform", "pareto"],
                   help="simulated user key distribution")
    p.add_argument("--users", type=int, default=1 << 20,
                   help="simulated user population")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ways", type=int, default=8,
                   help="blocked engine: cache ways")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--procs", type=int, default=None,
                   help="run over this many processes, one a shard "
                        "(--shards must equal it)")
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
    if args.shards != args.procs:
        p.error(f"--procs {args.procs} runs one process a shard: --shards "
                f"must equal it (got {args.shards})")
    device_type = torch.device(args.device).type
    if args.backend is None:
        args.backend = "nccl" if device_type == "cuda" else "gloo"
    if args.backend == "nccl" and device_type != "cuda":
        p.error("--backend nccl runs on the card: it takes --device cuda "
                "(gloo runs on the CPU)")
    return args


def key_stream(n: int, n_keys: int, dist: str = "uniform",
               n_users: int = 1 << 20, skew: float = 1.05,
               seed: int = 0) -> np.ndarray:
    """``n`` update keys in ``[0, n_keys)`` from a simulated user population:
    ``uniform`` (every user equally active) or ``pareto`` (Pareto(``skew``)
    activity, a few users dominate), each user's row spread over the table
    by a Fibonacci hash. The same stream as the JAX package's
    ``benchmarks/traces.py`` ``key_stream`` for the same arguments."""
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        users = rng.integers(0, n_users, n, dtype=np.int64)
    elif dist == "pareto":
        ranks = (rng.pareto(skew, n) * n_users / 20).astype(np.int64)
        users = np.minimum(ranks, n_users - 1)
    else:
        raise ValueError(f"dist must be uniform|pareto, got {dist!r}")
    return ((users * 2654435761) % n_keys).astype(np.int32)


def measure_schedule_inputs(cfg, n_shards: int, batch: int, plan,
                            device, runs: int = 5, spmd=None) -> dict:
    """What ``--defer auto|adaptive`` solves from, measured on ``device``
    over the executor ``spmd``'s wire (the stacked axis by default; a
    mesh executor's process group, ``backend`` naming it).

    * ``wire``: machine-wide bytes each level of ``plan`` moves in one
      synchronized tick (``wire_cost.wire_bytes_by_level`` of the
      ``[R, D]`` payload), by level ``names``;
    * ``level_s``: the time of each level's merge alone over the ``[S, R,
      D]`` payload (``ccache.merge_stage``), median of ``runs``; ``rates``
      is ``wire / level_s`` (a level that moves nothing gets ``inf``);
    * ``tick_s``: a deferred tick that never commits, on the replicated
      store (a partitioned probe that never commits would overflow its
      ring), the mean of 4 ticks synchronized at both ends.

    Over a mesh every process measures, and every one solves from the
    largest of each time over the processes (gathered), so that all of
    them serve the same schedule.
    """
    from repro_torch.launch.wire_cost import wire_bytes_by_level
    from repro_torch.serve import ShardedKV

    from repro_torch.core.stacked import StackedSPMD

    if spmd is None:
        spmd = StackedSPMD(n_shards, device)
    device = spmd.device
    S, R, D = n_shards, cfg.n_keys, cfg.cols
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    names = tuple(lv.name for lv in plan.levels)
    wire = wire_bytes_by_level(plan, S, (R, D), itemsize, cfg.merge)

    state_dtype = torch.int32 if cfg.dtype == torch.uint32 else cfg.dtype
    payload = torch.ones((spmd.stack, R, D), dtype=state_dtype,
                         device=device)
    level_s = time_level_merges(plan, payload, cfg.merge, runs,
                                axis=spmd.axis)
    del payload

    probe_cfg = dataclasses.replace(cfg, partitioned=False)
    timer = ShardedKV(probe_cfg, S, spmd=spmd, plan=plan,
                      commit_every=1 << 20)       # never commits
    k0 = torch.zeros((S, batch), dtype=torch.int32, device=device)
    v0 = torch.ones((S, batch, D), dtype=cfg.dtype, device=device)
    timer.tick(k0, v0)                            # warm-up
    sync_device(device)
    t0 = time.perf_counter()
    for _ in range(4):
        timer.tick(k0, v0)
    sync_device(device)
    tick_s = (time.perf_counter() - t0) / 4
    del timer, k0, v0
    if device.type == "cuda":
        torch.cuda.empty_cache()   # the probe held S replicated tables
    # every process solves from the same (the slowest process's) times
    times = spmd.gather(torch.tensor([level_s + [tick_s]],
                                     dtype=torch.float64, device=device))
    *level_s, tick_s = times.amax(0).tolist()
    rates = [b / t if b > 0 else float("inf")
             for b, t in zip(wire, level_s)]
    backend = (f"{spmd.backend} ({S} processes)"
               if spmd.backend != "stacked" else "the stacked axis")
    return {"names": names, "wire": wire, "level_s": level_s,
            "rates": rates, "tick_s": tick_s,
            "device": device_name(device), "backend": backend}


def schedule_from(mode: str, plan, inputs: dict, merge, n_shards: int,
                  batch: int, overlap: bool = False,
                  partitioned: bool = False):
    """The ``auto`` or ``adaptive`` schedule of ``plan`` from
    :func:`measure_schedule_inputs`. ``adaptive`` charges the measured
    tick to ``per_update_s = tick_s / (S * B)``, so a full batch
    reproduces the probe's compute bound; a partitioned ``auto`` collapses
    the nested solution to its period (the partitioned store commits every
    level at once)."""
    from repro_torch.core.defer_schedule import (AdaptiveDeferSchedule,
                                                 DeferSchedule,
                                                 solve_defer_schedule)
    wire, names = inputs["wire"], inputs["names"]
    if mode == "adaptive":
        return AdaptiveDeferSchedule(
            plan, wire, names,
            per_update_s=inputs["tick_s"] / (n_shards * batch),
            overlap=overlap, merge_fn=merge, bandwidths=inputs["rates"])
    if mode != "auto":
        raise ValueError(f"mode must be auto|adaptive, got {mode!r}")
    schedule = solve_defer_schedule(
        plan, wire, names, compute_s=inputs["tick_s"], overlap=overlap,
        merge_fn=merge, bandwidths=inputs["rates"])
    if partitioned:
        schedule = DeferSchedule(
            level_names=schedule.level_names,
            intervals=(schedule.period,) * len(schedule.level_names),
            predicted=schedule.predicted, overlap=overlap)
    return schedule


def build_store(args, spmd=None, say=print):
    """The store the flags describe, on the executor ``spmd`` (the
    stacked one on ``--device`` by default); ``auto`` and ``adaptive``
    print (through ``say``) the measured inputs and the solved schedule."""
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan

    S, R = args.shards, args.keys
    device = spmd.device if spmd is not None else resolve_device(args.device)
    sync_mode = args.defer == "sync"
    if args.partitioned and sync_mode:
        raise SystemExit("--partitioned needs deferred commits; pick "
                         "--defer K|auto|adaptive")
    if args.overlap and not args.partitioned:
        raise SystemExit("--overlap pipelines the partitioned store's "
                         "commit; add --partitioned")
    if args.partitioned and R % S:
        raise SystemExit(f"--partitioned needs --keys divisible by "
                         f"--shards (got {R} % {S} = {R % S})")
    cfg = KVConfig(n_keys=R, cols=args.cols, dtype=torch.int32,
                   consistency=args.consistency, engine=args.engine,
                   ways=args.ways, partitioned=args.partitioned,
                   spill_blocks=args.spill_blocks)
    plan = serving_plan(S, "none" if sync_mode else "all")
    schedule = commit_every = None
    if args.defer in ("auto", "adaptive"):
        inputs = measure_schedule_inputs(cfg, S, args.batch, plan, device,
                                         spmd=spmd)
        schedule = schedule_from(args.defer, plan, inputs, cfg.merge, S,
                                 args.batch, overlap=args.overlap,
                                 partitioned=args.partitioned)
        for line in describe_inputs(inputs):
            say(line)
        say("solved schedule:")
        say(schedule.describe())
    elif not sync_mode:
        try:
            commit_every = int(args.defer)
        except ValueError:
            raise SystemExit(f"--defer must be sync|auto|adaptive|K, got "
                             f"{args.defer!r}")
        if args.overlap:
            from repro_torch.core.merge_plan import compile_plan
            deferred = tuple(s.name for s in compile_plan(
                plan, S, merge_fn=cfg.merge) if s.defer)
            schedule = DeferSchedule.fixed(commit_every, deferred,
                                           overlap=True)
            commit_every = None
    return ShardedKV(cfg, S, device=device, spmd=spmd, plan=plan,
                     schedule=schedule, commit_every=commit_every)


def main(argv=None) -> None:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse_args(argv)
    if args.procs is not None and args.worker is None:
        from repro_torch.launch.mesh import spawn_command
        return spawn_command("repro_torch.launch.kv_serve", argv, args.procs)
    spmd, say = None, print
    if args.worker is not None:
        from repro_torch.apps.sharded import mesh_spmd
        from repro_torch.launch import mesh as pmesh
        rank = int(args.worker[0])
        torch.set_num_threads(1)
        mesh = pmesh.init_shards(args.backend, torch.device(args.device).type,
                                 init_method=args.worker[1], rank=rank,
                                 world_size=args.procs)
        spmd = mesh_spmd(mesh)
        if rank:
            def say(*a, **k):
                pass
    try:
        _serve(args, spmd, say)
    finally:
        if spmd is not None:
            pmesh.shutdown()


def _serve(args, spmd, say) -> None:
    """The store the flags describe, fed the stream: the ingest rate, the
    settled-mass check and the counters, printed through ``say``."""
    S, R, D, B = args.shards, args.keys, args.cols, args.batch
    kv = build_store(args, spmd, say)
    keys = key_stream(args.ticks * S * B, R, args.dist, n_users=args.users,
                      seed=args.seed).reshape(args.ticks, S, B)
    vals = torch.ones((S, B, D), dtype=torch.int32, device=kv.device)
    keys_dev = torch.as_tensor(keys, device=kv.device)

    kv.tick(keys_dev[0], vals)  # warm-up: builds the kernel on the card
    sync_device(kv.device)
    kv.spmd.barrier()           # over processes: every rank starts at once
    t0 = time.perf_counter()
    for t in range(1, args.ticks):
        kv.tick(keys_dev[t], vals)
    sync_device(kv.device)
    kv.spmd.barrier()
    wall = time.perf_counter() - t0
    ups = S * B * (args.ticks - 1) / max(wall, 1e-12)

    kv.flush()
    tbl = kv.table()
    total = int(tbl[:, 0].astype(np.int64).sum())
    name = device_name(kv.device)
    over = (f", {args.procs} processes over {args.backend}"
            if spmd is not None else "")
    say(f"{args.dist} stream: {args.ticks} ticks x {S} shards x {B} "
        f"updates, engine={args.engine}, defer={args.defer}, "
        f"device={name}{over}")
    say(f"ingest: {wall:.6f}s  ({ups:,.0f} updates/s, "
        f"{ups / 1e9:.6f} GUPS)")
    say(f"settled mass col0: {total} "
        f"(= {S * B * args.ticks} updates ingested)")
    for k, v in kv.counters().items():
        if k != "schedule":
            say(f"  {k}: {v}")
    if total != S * B * args.ticks:
        raise SystemExit("settled mass does not match the ingested stream")


if __name__ == "__main__":
    main()
