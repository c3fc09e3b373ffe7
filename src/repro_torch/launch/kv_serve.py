"""Sharded commutative KV serving driver, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.kv_serve --shards 8 \\
        --keys 65536 --ticks 64 --batch 512 --dist pareto --defer 8

Runs the :mod:`repro_torch.serve` tier with every shard stacked on one
device (``--device``, default ``cuda``; ``--device cpu`` runs the kernels'
plain versions on the CPU). Prints the ingest rate and checks the flushed
table's mass against the stream.

``--defer`` picks the commit policy: ``sync`` (the fully-synchronized
reference, merge every tick) or an integer ``K`` (fixed commit interval
over a fully deferred plan). ``--partitioned`` home-shards the settled
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
import time

import numpy as np
import torch


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
                   help="sync | K (fixed commit interval)")
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
    return p.parse_args(argv)


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


def build_store(args):
    """The store the flags describe."""
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan

    S, R = args.shards, args.keys
    if args.defer in ("auto", "adaptive"):
        raise SystemExit(f"--defer {args.defer}: solved and adaptive commit "
                         f"schedules are not ported yet; pick sync or K")
    sync_mode = args.defer == "sync"
    if args.partitioned and sync_mode:
        raise SystemExit("--partitioned needs deferred commits; pick "
                         "--defer K")
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
    if not sync_mode:
        try:
            commit_every = int(args.defer)
        except ValueError:
            raise SystemExit(f"--defer must be sync|K, got {args.defer!r}")
        if args.overlap:
            from repro_torch.core.merge_plan import compile_plan
            deferred = tuple(s.name for s in compile_plan(
                plan, S, merge_fn=cfg.merge) if s.defer)
            schedule = DeferSchedule.fixed(commit_every, deferred,
                                           overlap=True)
            commit_every = None
    return ShardedKV(cfg, S, device=args.device, plan=plan,
                     schedule=schedule, commit_every=commit_every)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    args = _parse_args(argv)
    S, R, D, B = args.shards, args.keys, args.cols, args.batch
    kv = build_store(args)
    keys = key_stream(args.ticks * S * B, R, args.dist, n_users=args.users,
                      seed=args.seed).reshape(args.ticks, S, B)
    vals = torch.ones((S, B, D), dtype=torch.int32, device=kv.device)
    keys_dev = torch.as_tensor(keys, device=kv.device)

    kv.tick(keys_dev[0], vals)  # warm-up: builds the kernel on the card
    sync(kv.device)
    t0 = time.perf_counter()
    for t in range(1, args.ticks):
        kv.tick(keys_dev[t], vals)
    sync(kv.device)
    wall = time.perf_counter() - t0
    ups = S * B * (args.ticks - 1) / max(wall, 1e-12)

    kv.flush()
    tbl = kv.table()
    total = int(tbl[:, 0].astype(np.int64).sum())
    name = (torch.cuda.get_device_name(kv.device) if kv.device.type == "cuda"
            else "cpu")
    print(f"{args.dist} stream: {args.ticks} ticks x {S} shards x {B} "
          f"updates, engine={args.engine}, defer={args.defer}, "
          f"device={name}")
    print(f"ingest: {wall:.6f}s  ({ups:,.0f} updates/s, "
          f"{ups / 1e9:.6f} GUPS)")
    print(f"settled mass col0: {total} "
          f"(= {S * B * args.ticks} updates ingested)")
    for k, v in kv.counters().items():
        if k != "schedule":
            print(f"  {k}: {v}")
    if total != S * B * args.ticks:
        raise SystemExit("settled mass does not match the ingested stream")


if __name__ == "__main__":
    main()
