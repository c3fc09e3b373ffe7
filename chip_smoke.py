#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Drives the port's main path — the sharded commutative KV store of
``src/repro_torch`` — on the card at the serving geometry (S = 8 shards,
R = 2**22 keys, D = 4 int32 columns, B = 1024 updates per shard per tick,
K = 8 over ``serving_plan(8, "all")``), and:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every CUDA kernel of the path from ``src/repro_torch/csrc``;
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (integers bitwise, floats to the JAX package's ``TOL``) and times
   kernel, plain version and one library call with CUDA events;
4. runs the privatized K = 8, sync, partitioned and partitioned+overlap
   stores over 3 commit cycles plus a partial one: each flushed table must
   equal a numpy int64 oracle bitwise, and the kernel's launch count must be
   what the schedule predicts (counts are zeroed just before each store is
   driven and read just after);
5. pushes a few thousand add/get requests through a read-your-writes store
   behind ``BatchedFrontend`` against a sequential numpy oracle;
6. prints one ``{"kernels": [...]}`` line;
7. ends with ``{"ok": true, "device": {...}}``.

Nothing is caught: any failure exits non-zero before the last line. Without
a card, or without the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S, R, D, B, K = 8, 1 << 22, 4, 1024, 8
RING_N = K * B                      # a partitioned commit scatters the ring
TICKS = 3 * K + 3                   # three commit cycles plus a partial one
USERS = 1 << 20
SEED = 0
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py TOL
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_OPS_PER_S = 67e12               # non-tensor-core f32 peak, H100 SXM
REPLACES = "src/repro/kernels/cscatter.py:133 (cscatter -> _kernel :64)"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, samples: int = 21, inner: int = 5) -> float:
    """Median over ``samples`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def scatter_bound_ms(ids, d: int, itemsize: int) -> tuple[float, str]:
    """The least time the card needs for one scatter of these inputs: ids
    and vals read once, each touched row read and written once (bytes), or
    one combine per update element (operations), whichever is larger."""
    import torch
    s, n = ids.shape
    r = R
    ok = (ids >= 0) & (ids < r)
    gid = (ids.long() + r * torch.arange(s, device=ids.device)[:, None])[ok]
    touched = int(torch.unique(gid).numel())
    nbytes = s * n * 4 + s * n * d * itemsize + 2 * touched * d * itemsize
    ops = s * n * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_card() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build("cscatter")
    print(f"build: {secs} ({time.perf_counter() - t0:.3f} s in all)")


def _rand_table(g, shape, dtype, lo, hi):
    import torch
    if dtype.is_floating_point:
        return torch.randn(shape, device="cuda", generator=g).to(dtype)
    x = torch.randint(lo, hi, shape, device="cuda", generator=g,
                      dtype=torch.int64)
    return (x & 0xFFFFFFFF).to(torch.int32).view(dtype) \
        if dtype == torch.uint32 else x.to(dtype)


def _compare(got, want) -> float:
    import torch
    if got.dtype.is_floating_point:
        tol = TOL[str(got.dtype).split(".")[1]]
        g, w = got.float(), want.float()
        require(bool(torch.all((g - w).abs() <= tol * 8 + tol * w.abs())),
                f"float kernel disagrees beyond TOL={tol}")
        return float((g - w).abs().max())
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            "integer kernel disagrees with its plain version")
    return 0.0


def phase_kernel_checks() -> dict:
    """Every kind and dtype against the plain version; returns the worst
    errors. Launches here are comparisons and are not counted."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for n in (B, RING_N):                         # a tick and a ring flush
        for kind in ("add", "sat_add", "max", "min", "or"):
            cases.append((torch.int32, R, D, n, kind))
    for kind in ("add", "sat_add", "max", "min", "or"):
        cases.append((torch.uint32, R, D, B, kind))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((R, D), (1 << 16, 128)):
            for kind in ("add", "sat_add", "max", "min"):
                cases.append((dtype, rows, d, B, kind))
    worst = {"int": 0.0, "float": 0.0}
    for dtype, rows, d, n, kind in cases:
        if dtype.is_floating_point:
            lo, hi, sat = None, None, (-2.0, 2.0)
            vals = torch.randn((S, n, d), device="cuda", generator=g).to(dtype)
        elif kind == "sat_add":       # values above 2**24: the int add first
            lo, hi, sat = 1 << 26, 1 << 28, (-float(1 << 29), float(1 << 29))
            vals = _rand_table(g, (S, n, d), dtype, -(1 << 27), 1 << 27)
        else:
            lo, hi, sat = 0, 1 << 32, (0.0, 0.0)
            vals = _rand_table(g, (S, n, d), dtype, 0, 1 << 32)
        table = _rand_table(g, (S, rows, d), dtype, lo, hi)
        if dtype == torch.uint32 and kind == "min":
            table.view(torch.int32).fill_(-1)     # uint32 max everywhere
        ids = torch.randint(-3, rows + 3, (S, n), device="cuda", generator=g,
                            dtype=torch.int32)
        want = cscatter_plain(table, ids, vals, kind=kind, sat_min=sat[0],
                              sat_max=sat[1])
        got = cscatter(table.clone(), ids, vals, kind=kind, sat_min=sat[0],
                       sat_max=sat[1])
        torch.cuda.synchronize()
        err = _compare(got, want)
        key = "float" if dtype.is_floating_point else "int"
        worst[key] = max(worst[key], err)
        print(f"check cscatter {str(dtype)[6:]} [{S},{rows},{d}] N={n} "
              f"{kind}: ok (max abs err {err})")
    # an all-padding batch leaves the table bit-exact
    table = _rand_table(g, (S, R, D), torch.int32, 0, 1 << 32)
    before = table.clone()
    cscatter(table, torch.full((S, B), -1, dtype=torch.int32, device="cuda"),
             torch.ones((S, B, D), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    require(torch.equal(table, before), "all-padding batch changed the table")
    print("check cscatter all-padding batch: ok")
    return worst


def phase_kernel_times(stream_keys: np.ndarray) -> list[dict]:
    """Kernel, plain version and library call at the main path's shapes
    (one tick, one ring flush), on main-path ids from the key stream."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    out = []
    table = torch.zeros((S, R, D), dtype=torch.int32, device="cuda")
    flat = table.view(S * R, D)
    for n in (B, RING_N):
        ids = torch.as_tensor(stream_keys[:S * n].reshape(S, n),
                              device="cuda")
        vals = torch.ones((S, n, D), dtype=torch.int32, device="cuda")
        gid = (ids.long() + R * torch.arange(S, device="cuda")[:, None]
               ).reshape(-1)
        flat_vals = vals.reshape(-1, D)
        bound, bound_by = scatter_bound_ms(ids, D, 4)
        for kind, lib in (("add", lambda: flat.index_add_(0, gid, flat_vals)),
                          ("max", lambda: flat.scatter_reduce_(
                              0, gid[:, None].expand(-1, D), flat_vals,
                              "amax")),
                          ("min", lambda: flat.scatter_reduce_(
                              0, gid[:, None].expand(-1, D), flat_vals,
                              "amin"))):
            row = {"kind": kind, "shape": [S, R, D], "n": n,
                   "ms": time_ms(lambda: cscatter(table, ids, vals,
                                                  kind=kind)),
                   "plain_ms": time_ms(lambda: cscatter_plain(
                       table, ids, vals, kind=kind)),
                   "library_ms": time_ms(lib),
                   "bound_ms": bound, "bound_by": bound_by}
            print(f"time cscatter {kind} [{S},{R},{D}] N={n}: kernel "
                  f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, "
                  f"library {row['library_ms']:.6f} ms, bound "
                  f"{bound:.6f} ms")
            out.append(row)
    return out


def _oracle(keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    ref = np.zeros((R, D), np.int64)
    np.add.at(ref, keys.reshape(-1), vals.reshape(-1, D))
    return ref


def phase_stores(keys: np.ndarray, vals: np.ndarray) -> dict:
    """The main path end to end: four stores, flushed tables vs the oracle,
    kernel launches vs the schedule. Returns the summed launch count."""
    import torch
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.kernels.cscatter import cscatter
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan

    want = _oracle(keys, vals)
    names = ("chip", "host", "pod")
    stores = {
        "privatized_k8": (lambda: ShardedKV(KVConfig(n_keys=R, cols=D), S,
                                            commit_every=K), TICKS),
        "sync": (lambda: ShardedKV(KVConfig(n_keys=R, cols=D), S,
                                   plan=serving_plan(S, "none")), TICKS),
        "partitioned_k8": (lambda: ShardedKV(
            KVConfig(n_keys=R, cols=D, partitioned=True), S,
            commit_every=K), TICKS // K + 1),
        "partitioned_overlap_k8": (lambda: ShardedKV(
            KVConfig(n_keys=R, cols=D, partitioned=True), S,
            schedule=DeferSchedule.fixed(K, names, overlap=True)),
            TICKS // K + 1),
    }
    keys_dev = torch.as_tensor(keys, device="cuda")
    vals_dev = torch.as_tensor(vals, device="cuda")
    launches = 0
    for name, (make, predicted) in stores.items():
        kv = make()
        # one event after each tick splits the device timeline by tick
        # without synchronizing the host inside the timed loop
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(TICKS + 1)]
        torch.cuda.synchronize()
        cscatter.launches = 0
        t0 = time.perf_counter()
        marks[0].record()
        for t in range(TICKS):
            kv.tick(keys_dev[t], vals_dev[t])
            marks[t + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tick_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        commit = [t for t in range(TICKS)
                  if kv.synchronized or (t + 1) % K == 0]
        kv.flush()
        torch.cuda.synchronize()
        n = cscatter.launches
        launches += n
        require(n == predicted, f"{name}: cscatter launched {n} times, the "
                                f"schedule predicts {predicted}")
        got = kv.table().astype(np.int64)
        require(np.array_equal(got, want),
                f"{name}: flushed table differs from the numpy oracle")
        ups = S * B * TICKS / wall
        print(f"store {name}: table == oracle bitwise; cscatter launches "
              f"{n} (predicted {predicted}); {ups:.1f} updates/s over "
              f"{TICKS} ticks ({wall:.6f} s); resident_state_bytes "
              f"{kv.resident_state_bytes()} per shard")
        print(f"store {name} ticks: commit ticks {commit} take "
              f"{sum(tick_ms[t] for t in commit):.6f} ms, the other "
              f"{TICKS - len(commit)} take "
              f"{sum(tick_ms) - sum(tick_ms[t] for t in commit):.6f} ms "
              f"(median {statistics.median(tick_ms):.6f} ms, max "
              f"{max(tick_ms):.6f} ms at tick {tick_ms.index(max(tick_ms))})")
        del kv
        torch.cuda.empty_cache()
    return {"launches": launches}


def phase_frontend(stream_keys: np.ndarray) -> None:
    from repro_torch.serve import BatchedFrontend, KVConfig, ShardedKV
    rng = np.random.default_rng(SEED + 1)
    kv = ShardedKV(KVConfig(n_keys=R, cols=D, consistency="read_your_writes"),
                   S, commit_every=K)
    fe = BatchedFrontend(kv, slots_per_shard=64)
    running: dict[int, int] = {}
    expect = {}
    hot = stream_keys[:4096]
    for i in range(4000):
        key = int(hot[rng.integers(0, len(hot))])
        if rng.random() < 0.6:
            v = int(rng.integers(1, 9))
            fe.add(key, v)
            running[key] = running.get(key, 0) + v
        else:
            expect[fe.get(key)] = running.get(key, 0)
    out = fe.drain()
    require(fe.backlog == 0 and set(out) == set(expect),
            "frontend left requests unanswered")
    for rid, v in expect.items():
        require(out[rid].astype(np.int64).tolist() == [v] * D,
                f"frontend get {rid}: {out[rid].tolist()} != {v}")
    print(f"frontend: {len(expect)} gets after {4000 - len(expect)} adds "
          f"match the sequential oracle")


def main() -> None:
    kind = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.kv_serve import key_stream

    phase_build()
    worst = phase_kernel_checks()
    stream = key_stream(TICKS * S * B, R, "pareto", n_users=USERS, seed=SEED)
    times = phase_kernel_times(stream)
    keys = stream.reshape(TICKS, S, B)
    vals = np.random.default_rng(SEED).integers(
        1, 9, (TICKS, S, B, D)).astype(np.int32)
    main_path = phase_stores(keys, vals)
    phase_frontend(stream)

    tick_add = next(t for t in times if t["kind"] == "add" and t["n"] == B)
    print(json.dumps({"kernels": [{
        "name": "cscatter", "route": "cuda",
        "source": "src/repro_torch/csrc/cscatter.cu",
        "replaces": REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": worst["int"],
        "max_abs_err_float": worst["float"],
        "matched": True,
        "ms": tick_add["ms"], "kernel_ms": tick_add["ms"],
        "plain_ms": tick_add["plain_ms"],
        "bound_ms": tick_add["bound_ms"],
        "bound_us": 1e3 * tick_add["bound_ms"],
        "bound_by": tick_add["bound_by"],
        "library_ms": tick_add["library_ms"],
        "variants": times}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
