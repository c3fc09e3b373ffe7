#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Drives the port's main paths on the card — the sharded commutative KV
store of ``src/repro_torch`` with its kernel engine and with its blocked
engine at the serving geometry (S = 8 shards, R = 2**22 keys, D = 4 int32
columns, B = 1024 updates per shard per tick, K = 8 over
``serving_plan(8, "all")``; the blocked engine with W = 8 ways of BR = 8
rows), its solved and adaptive commit schedules, its write-ahead journal,
snapshots and crash recovery, LM serving (prefill + greedy decode) of
qwen1.5-0.5b, the paper's BFS, PageRank and k-means, training of
qwen1.5-0.5b with gradient accumulation as a CCache merge, its elastic
resume after a kill onto another rank count, and the xLSTM and Hymba
families (hymba-1.5b and xlstm-125m served, xlstm-125m trained, killed
and resumed bit for bit) — and:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every CUDA kernel of the paths from ``src/repro_torch/csrc``, all
   ``nvcc`` processes at once;
3. holds each kernel against its plain PyTorch version at the main paths'
   shapes and at the edges of the bucketed ``cscatter`` (a hot row, Pareto
   ids, N > R, two column tiles, N = 0, the bucket pass's direct-write and
   multi-round branches; integers bitwise, floats to the JAX package's
   ``TOL``) and times with CUDA events the kernel (its device time from a
   CUDA graph of 100 launches, and the time of a call through its
   wrapper), the plain version (in place, as the kernel) and one library
   call (its device time from a CUDA graph, ``library_ms``, and an eager
   call, ``library_call_ms``); ``cscatter`` add also with its bucket pass
   unstaged (``unstaged_ms``); ``cmerge`` (several ways a CTA, 16-byte
   accesses) at W in {1, 8, 8192} and D in {4, 128}, every kind, against
   its plain version, and timed for add, max and min at the evict, flush
   and drain shapes against ``index_add_`` / ``index_reduce_``; and
   holds float ``cscatter`` (f32 and bf16, add and sat_add) to the bit
   over 5 repeated calls on hot and cold streams at every shape the port
   launches (``DET_STREAMS``);
4. runs the privatized K = 8, sync, partitioned and partitioned+overlap
   stores over 3 commit cycles plus a partial one, and the blocked
   replicated and blocked partitioned stores over 2 cycles plus a tick: each
   flushed table must equal a numpy int64 oracle bitwise, each kernel's
   launch count must be what the schedule predicts (counts are zeroed just
   before each store is driven and read just after), and the blocked
   stores' eviction counters must equal a pure-Python LRU model of the
   same stream;
5. solves the commit schedule as ``kv_serve --defer auto|adaptive`` does
   (the wire vector of ``launch/wire_cost.py``, each level's merge timed on
   the card, a never-committing probe tick), runs ``auto`` on the
   privatized store for max(27, 2 period + 1) ticks and ``adaptive`` on the
   partitioned overlapped store for 2 k_max + 1 ticks (the stream's second
   half at a quarter load): tables bitwise against the oracle, ``cscatter``
   launches against the due ticks (the adaptive store's from a host twin of
   its schedule);
6. crashes a journaled store for real: a child process (this script with
   ``--crash-child``) journals ticks 0-19, snapshots after tick 12 and
   SIGKILLs itself after its 20th ack; with a torn record appended, an S =
   16 partitioned overlapped store recovers (7 ticks replayed, re-chunked to
   [16, 512]), serves ticks 20-26 and must equal the oracle of all 27 ticks,
   and an S = 8 privatized store recovers the same journal to the oracle of
   ticks 0-19; then times the journal (updates/s without it, with it and
   fsynced; an append's ms and bytes), the snapshot (flush, copy, write)
   and the recoveries (load, install, replay);
7. pushes a few thousand add/get requests through a read-your-writes store
   behind ``BatchedFrontend`` against a sequential numpy oracle;
8. holds ``flash_attention`` and ``decode_attention`` against their plain
   versions in f32 (to ``TOL``) and bf16 (to ``ATTN_BF16_TOL`` per element
   and ``ATTN_BF16_ROW`` per output row) at qwen1.5-0.5b's and
   internlm2-1.8b's attention shapes, with sliding windows (hymba-1.5b's
   prefill, W = 1024, and windows of 100, 64 and 1 over ragged S), decode
   at hymba-1.5b's ring and global caches (G = 5),
   and the bf16 tensor-core flash kernel at the edges of
   its tiling (d of 8 to 256, ragged S != T, GQA groups of 2 and 8,
   strided views), printing the variant each shape ran; holds each pass of
   ``decode_attention`` (a split pass over ``plan_splits``'s split count,
   then a combine pass) against its plain version at both cache shapes;
   times them beside their bounds and one ``scaled_dot_product_attention``
   call, printing the split count each decode shape ran;
9. serves qwen1.5-0.5b at full width (bf16, random weights from the seed,
   batch 8, prompts of 512 ids, 64 greedy tokens) through
   ``launch/serve.generate``: the attention kernels' launches must be one a
   layer at prefill, all of them through the bf16 tensor-core variant, and
   two a layer a decode step (``decode_attention``'s split and combine
   passes), and the logits of every
   step must match the same tokens teacher-forced through the plain
   attention;
10. runs the paper's apps through ``repro_torch.apps``: BFS and PageRank on
   a Graph500 Kronecker graph (SCALE 20, edgefactor 16, 33.5M directed
   edges over 8 shards), eager and with a deferred pod level, and k-means
   on a 491,520 x 34 stream with deferred and overlapped commits, against
   numpy oracles (BFS bitwise on every shard, PageRank against float64
   iterations, k-means against the schedule mirror), each run's
   ``cscatter`` launches held to the schedule, ``run_app`` at its defaults;
   then times ``cscatter`` at each app's shapes against its plain version,
   one library call and the bound, with its two passes split by a
   ``torch.profiler`` trace;
11. trains qwen1.5-0.5b at full width and depth (bf16, remat "dots",
   random weights from the seed) through ``launch/train.py`` on the data
   pipeline's Zipf stream, batch 16 x 512 over 8 stacked ranks: 4 eager
   steps over chip:2,host:2,pod:2, then 9 deferred steps (K = 4 on two
   deferred levels, a partial cycle that the flush settles) and the same
   overlapped; every loss finite, the first deferred cycle equal to AdamW
   on the mean of its batches' eager merges, the overlapped run's first
   landing equal to the deferred commit a step earlier, the embedding
   backward through the CUDA ``cscatter`` equal to it through the plain
   version, ``cscatter`` launches equal to 2 x ranks x steps; prints ms a
   step by kind (eager, accumulate, commit, launch, land, flush),
   tokens/s, peak memory, a ``torch.profiler`` split of one eager step
   and the device's idle share; ``cscatter`` is also checked and timed at
   the embedding backward's shape ([151936, 1024], N = 1024, bf16 and
   f32) beside ``index_add_``;
12. runs the chaos harness and elastic restore on the card: the integer
   toy's preempt and kill sweeps over every boundary of 6 steps (``[8,
   2^20]`` int32 pendings, without and with overlap) bitwise against the
   uninterrupted run, and resolves of overlapped toy checkpoints at t = 4
   and 5 onto another plan bitwise against a verbatim restore flushed;
   then kills the deferred qwen1.5-0.5b run of 11 (full width and depth,
   K = 4 over 8 ranks) by SIGKILL in a child process (this script with
   ``--train-crash-child``) after its checkpoint of step 6 (about 20 GB),
   resumes it through ``TrainDriver.resume`` verbatim (every leaf bit for
   bit, then flushed: the oracle) and onto 4 ranks with K = 2 (the two
   outstanding steps settled into the parameters and AdamW): the settled
   gradient against an f32 sum of the raw pendings, params, mu and nu
   against the oracle, a control with the pendings dropped that must fail
   the mu bound, and two more steps at ``rescale_hyperparams``' lr with
   the predicted ``cscatter`` launches; prints the checkpoint's bytes, the
   save's ms, each resume's ms and peak device memory by part, and the
   free disk before the save;
13. (``phase_families``) serves hymba-1.5b at full width (bf16, batch 8,
   prompts of 2048, 64 tokens: 32 ``flash_attention`` launches at prefill,
   29 with the window of 1024, and a ``decode_attention`` call a layer a
   step over the windowed layers' rings and the global layers' caches),
   held against the same tokens teacher-forced through the plain
   attention; serves xlstm-125m at full width (batch 8, prompts of 256,
   257 tokens), its recurrent decode held against one chunkwise forward
   over the 512 tokens; serves the GELU MLP (``DecoderLM`` at granite-34b's
   smoke config with ``mlp="gelu"``) against its plain path; each with a
   traced prefill and decode step; then runs the real-model chaos at full
   width (xlstm-125m, the example's 5 steps of batch 8 x 32 over 8 stacked
   ranks, an overlapped K = 2 commit, a checkpoint every step): the twin
   twice, bitwise equal to itself in every leaf, a kill before step 2
   resumed and flushed bitwise equal to the twin, a control with fresh
   defer state that must differ, ``cscatter`` launches = 2 x 8 x steps;
14. prints every kernel's registers and spills (``ptxas -v``),
   one ``{"kernels": [...]}`` line and the card's name and power limit;
15. ends with ``{"ok": true, "device": {...}}``.

Each phase prints its seconds. Nothing is caught: any failure exits
non-zero before the last line. Without a card, or without the repository
beside it, it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S, R, D, B, K = 8, 1 << 22, 4, 1024, 8
RING_N = K * B                      # a partitioned commit scatters the ring
TICKS = 3 * K + 3                   # three commit cycles plus a partial one
WAYS, BR = 8, 8                     # blocked engine: benchmarks/kv_gups.py
BLOCKED_TICKS = 2 * K + 1           # two commit cycles plus a tick
SPILL = K * B                       # spill slots: a cycle's distinct blocks
USERS = 1 << 20
SEED = 0
# durability: the crashing store snapshots after this tick and is killed
# after acknowledging CRASH_AT ticks
SNAPSHOT_AT, CRASH_AT = 12, 20
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py TOL
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
COLD_BYTES = 150e6                  # inputs rotated through: 3x the L2
F32_OPS_PER_S = 67e12               # non-tensor-core f32 peak, H100 SXM
REPLACES = "src/repro/kernels/cscatter.py:133 (cscatter -> _kernel :64)"
REPLACES_CMERGE = "src/repro/kernels/cmerge.py:56 (cmerge -> _kernel :30)"
REPLACES_FLASH = ("src/repro/kernels/flash_attention.py:66 "
                  "(flash_attention -> _kernel :25)")
REPLACES_DECODE = ("src/repro/kernels/decode_attention.py:58 "
                   "(decode_attention -> _kernel :22)")
BF16_OPS_PER_S = 989e12             # dense bf16 tensor-core peak, H100 SXM
# LM serving: qwen1.5-0.5b at full width, as the JAX serve CLI would run it
ARCH, SERVE_BATCH, PROMPT, GEN = "qwen1-5-0-5b", 8, 512, 64
# attention kernels vs their plain versions in bf16: both round an f32 result
# to bf16, so they differ by about one bf16 ulp (2**-8 of the value); the worst
# seen at every checked shape is 0.0039 (NVIDIA H100 80GB HBM3, 700.00 W).
# TOL's absolute 4 * 2e-2 is the size of a typical output element and would
# pass a kv tile dropped for a band of rows: hold each element to 1e-2 + 1e-2
# * |want| and each output row's error RMS to 1e-2 of the row's RMS.
ATTN_BF16_TOL = (1e-2, 1e-2)
# hymba-1.5b serving: batch 8, prompts of 2048 (past the window of 1024, so
# the windows bite at prefill and the rings are full at decode), 64 tokens
HYMBA_W, HYMBA_PROMPT, HYMBA_GEN, FAMILY_BATCH = 1024, 2048, 64, 8
# xlstm-125m serving: prompts of 256 and 257 tokens, so that the prompt and
# the 256 tokens fed back make 512, two mLSTM chunks of 256
XLSTM_PROMPT, XLSTM_GEN = 256, 257
# the real-model chaos at full width: the example's 5 steps, a kill before
# step 2 (its --quick point). A kill before step 3 as well, the other side
# of an overlapped landing, passed too but took the phase past its budget:
# every run saves a 7.1 GB checkpoint a step, 8.5-12.2 s each (NVIDIA H100
# 80GB HBM3, 700.00 W); the CPU tests kill before each of steps 1-4
CHAOS_STEPS, CHAOS_KILLS = 5, (2,)
ATTN_BF16_ROW = 1e-2
# kernel-path vs plain-attention logits (teacher-forced, same weights)
LOGIT_TOL = 0.1
# The paper's apps. BFS and PageRank run on Graph500's Kronecker graph
# (initiator A, B, C = 0.57, 0.19, 0.19; edgefactor 16), cut from Graph500's
# smallest class, SCALE 26, to SCALE 20 to keep the run short: 2^20 vertices,
# 16.8M undirected edges, 33.5M directed, over S = 8 shards.
GRAPH_SCALE, EDGEFACTOR, KRONECKER = 20, 16, (0.57, 0.19, 0.19)
APP_K = 4                           # deferred commits every 4 supersteps
PR_ALPHA, PR_EAGER, PR_DEFER = 0.85, 50, 192
# PageRank against a float64 power iteration at the same count: eager per
# vertex, and the deferred run to the JAX test's bound. The deferred loop
# contracts more slowly: a vertex whose in-mass all comes from the other pod
# (a self-loop stored there is enough) sees it only at commits, so its
# error shrinks by alpha once per K supersteps, about alpha^(T / K): 4.9e-3
# at 128 supersteps on this graph (NVIDIA H100 80GB HBM3, 700 W), 3.5e-4 at
# 192 in the float64 mirror on the same generator at SCALE 14 and 16. The
# deferred run is also held per vertex, to the eager bound, to a float64
# mirror of its own schedule.
PR_RTOL_EAGER, PR_RTOL_DEFER = 1e-4, 2e-3
# k-means: the shape of Rodinia kmeans's kdd_cup input (34 features) with
# its default 5 clusters; S x T x B = 8 x 8 x 7680 points
KM_D, KM_K, KM_T, KM_B = 34, 5, 8, 7680
KM_TOL = 1e-3                       # atol = rtol against the numpy mirror
# Training: qwen1.5-0.5b at full width and depth, batch 16 x 512 over 8
# stacked data-parallel ranks (2 rows a rank); eager over TRAIN_PLAN,
# deferred over TRAIN_DEFER_PLAN with K = TRAIN_K on both deferred levels
TRAIN_BATCH, TRAIN_SEQ, TRAIN_DP = 16, 512, 8
TRAIN_PLAN = "chip:2,host:2,pod:2"
TRAIN_DEFER_PLAN = "chip:2,host:2:defer,pod:2:defer"
TRAIN_K, TRAIN_LR, TRAIN_WARMUP = 4, 3e-4, 2
TRAIN_V, TRAIN_D = 151936, 1024     # the embedding table, [vocab, d_model]
# Elastic restore. (a) the chaos harness's integer toy on the card: a
# [8, 2^20] int32 pending a level over TRAIN_DEFER_PLAN with intervals
# (1, 2), swept over every boundary of 6 steps, and resolved onto
# ELASTIC_PLAN with K = 3. (b) the deferred qwen1.5-0.5b run of phase_train
# (K = TRAIN_K over TRAIN_DP ranks, a RESUME_STEPS-step schedule) killed by
# SIGKILL during step RESUME_KILL_AT after its checkpoint at RESUME_CKPT,
# then resumed on the same topology and on RESUME_PLAN (a pod left: 4
# ranks) with K = RESUME_K
TOY_WIDTH, TOY_STEPS, TOY_INTERVALS = 1 << 20, 6, (1, 2)
ELASTIC_PLAN, ELASTIC_K = "chip:4,pod:2:defer", 3
RESUME_STEPS, RESUME_CKPT, RESUME_KILL_AT = 12, 6, 7
RESUME_PLAN, RESUME_K, RESUME_RANKS = "chip:2,host:2:defer", 2, 4
KILL_DELAY_S = 1.0                  # into step RESUME_KILL_AT (~3 s a step)


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


def graph_ms(fn, launches: int = 100, samples: int = 11) -> float:
    """The device time of one call: ``launches`` calls captured once in a
    CUDA graph, the graph replayed and timed with CUDA events, the median
    over ``samples`` replays divided by ``launches``. No host work runs
    between the kernels, so this is the kernel's own time (with the graph's
    gap between two launches), not the wrapper's launch rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(out)


def rotating(fn, sets: list):
    """``fn`` over ``sets`` of arguments in turn, one set a call: timed by
    ``graph_ms``, each launch of the graph reads inputs that the launches
    before it have pushed out of the 50 MB L2 (``COLD_BYTES`` in all), as
    a caller finds them that touched other data in between."""
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % len(sets)
        return fn(*sets[turn[0]])
    return call


def scatter_bound_ms(ids, d: int, itemsize: int,
                     r: int = R) -> tuple[float, str]:
    """The least time the card needs for one scatter of these inputs into
    ``r`` rows: ids and vals read once, each touched row read and written
    once (bytes), or one combine per update element (operations), whichever
    is larger. Padding ids (< 0) touch nothing but are read."""
    import torch
    s, n = ids.shape
    ok = (ids >= 0) & (ids < r)
    gid = (ids.long() + r * torch.arange(s, device=ids.device)[:, None])[ok]
    touched = int(torch.unique(gid).numel())
    nbytes = s * n * 4 + s * n * d * itemsize + 2 * touched * d * itemsize
    ops = s * n * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_card() -> tuple[str, str]:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    # f32 products of the attention checks and their plain versions in
    # full f32, not TF32 (also PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch.backends.cuda.matmul.allow_tf32 = False")
    return name, smi


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its (mangled)
    name, registers, and stack and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used ")[1].split(",")[0]
            out.append(f"{name}: {regs}; {spill}")
            name, spill = None, ""
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build("cscatter", "cmerge", "flash_attention",
                        "decode_attention")
    print(f"build: {secs} ({time.perf_counter() - t0:.3f} s in all)")
    for name in ("flash_attention", "cscatter", "decode_attention",
                 "cmerge"):
        for line in ptxas_report(_build.LOGS.get(name, "")):
            print(f"ptxas {name}: {line}")


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


def phase_kernel_checks(stream_keys: np.ndarray) -> dict:
    """Every kind and dtype against the plain version, at the main path's
    shapes and at the bucketed kernel's edges: every id on one row (one
    bucket of RING_N ids, integer kinds), the key stream's Pareto ids at
    N = 8192, N > R (R = 1000), D = 33 and D = 128 (two and four column
    tiles), N = 0 and all padding, and the bucket pass's direct-write and
    multi-round branches; returns the worst errors. Launches here are
    comparisons and are not counted."""
    import torch
    from repro_torch.kernels.cscatter import (cscatter, cscatter_plain,
                                              launch, plan)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kinds = ("add", "sat_add", "max", "min", "or")
    cases = []                            # (dtype, rows, d, n, kind, ids)
    for n in (B, RING_N):                         # a tick and a ring flush
        for kind in kinds:
            cases.append((torch.int32, R, D, n, kind, "random"))
    for kind in kinds:
        cases.append((torch.uint32, R, D, B, kind, "random"))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((R, D), (1 << 16, 128)):
            for kind in kinds[:4]:
                cases.append((dtype, rows, d, B, kind, "random"))
    for dtype in (torch.int32, torch.uint32):
        for kind in kinds:
            cases.append((dtype, R, D, RING_N, kind, "one row"))
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        for kind in kinds if dtype == torch.int32 else kinds[:4]:
            cases.append((dtype, R, D, RING_N, kind, "pareto"))
            cases.append((dtype, 1000, D, RING_N, kind, "random"))
            cases.append((dtype, 5000, 33, B, kind, "random"))
            cases.append((dtype, 1 << 16, 128, B, kind, "random"))
    worst = {"int": 0.0, "float": 0.0}
    for dtype, rows, d, n, kind, how in cases:
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
        if how == "one row":
            ids = torch.full((S, n), rows // 3, dtype=torch.int32,
                             device="cuda")
        elif how == "pareto":
            ids = torch.as_tensor(stream_keys[:S * n].reshape(S, n),
                                  device="cuda")
        else:
            ids = torch.randint(-3, rows + 3, (S, n), device="cuda",
                                generator=g, dtype=torch.int32)
        want = cscatter_plain(table, ids, vals, kind=kind, sat_min=sat[0],
                              sat_max=sat[1])
        got = cscatter(table.clone(), ids, vals, kind=kind, sat_min=sat[0],
                       sat_max=sat[1])
        torch.cuda.synchronize()
        err = _compare(got, want)
        key = "float" if dtype.is_floating_point else "int"
        worst[key] = max(worst[key], err)
        print(f"check cscatter {str(dtype)[6:]} [{S},{rows},{d}] N={n} "
              f"{kind} {how} ids: ok (max abs err {err})")
    # the bucket pass's other branches, int32 bitwise: positions written
    # straight to device memory, where plan picks it (40000 ids a shard no
    # longer fit its shared memory), and the histogram counted in rounds,
    # through a plan that forces four (only a table of more than 2^30 rows
    # needs them; tests/test_torch_gpu.py runs one)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    direct = plan(S, R, 40_000, D, n_sm)
    require(not direct.stage, "plan stages 40000 ids a shard")
    rounds = plan(S, R, RING_N, D, n_sm)
    rounds = dataclasses.replace(rounds, stage=False, hist_cap=200,
                                 chunks=-(-rounds.n_blocks // 200))
    for n, p in ((40_000, direct), (RING_N, rounds)):
        ids = torch.randint(-3, R + 3, (S, n), device="cuda", generator=g,
                            dtype=torch.int32)
        ids[:, ::5] = R // 3                                   # a hot row
        for kind in kinds:
            lo, hi, sat = ((1 << 26, 1 << 28, (-float(1 << 29),
                                               float(1 << 29)))
                           if kind == "sat_add" else (0, 1 << 32, (0.0, 0.0)))
            vals = _rand_table(g, (S, n, D), torch.int32, -(1 << 27), 1 << 27)
            table = _rand_table(g, (S, R, D), torch.int32, lo, hi)
            want = cscatter_plain(table, ids, vals, kind=kind, sat_min=sat[0],
                                  sat_max=sat[1])
            launch(table, ids, vals, kind, sat[0], sat[1], p)
            torch.cuda.synchronize()
            _compare(table, want)
        print(f"check cscatter int32 [{S},{R},{D}] N={n} "
              f"{','.join(kinds)}, bucket pass {p.chunks} round(s), "
              f"{'staged' if p.stage else 'direct'} positions: ok")
    # an all-padding batch leaves the table bit-exact
    table = _rand_table(g, (S, R, D), torch.int32, 0, 1 << 32)
    before = table.clone()
    cscatter(table, torch.full((S, B), -1, dtype=torch.int32, device="cuda"),
             torch.ones((S, B, D), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    require(torch.equal(table, before), "all-padding batch changed the table")
    print("check cscatter all-padding batch: ok")
    cscatter(table, torch.zeros((S, 0), dtype=torch.int32, device="cuda"),
             torch.zeros((S, 0, D), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    require(torch.equal(table, before), "an empty batch changed the table")
    print("check cscatter N=0: ok")
    worst["float"] = max(worst["float"], embedding_kernel_checks())
    return worst


# Float cscatter streams held to the bit over repeated calls: (table shape,
# ids a shard, law): a KV tick's shape with hot Zipf ids (units of more
# than 32 ids: the CTA's exact fold) and cold uniform ones (warp units), a
# ring flush, the graph apps' [8, 2^20, 1] at 4M ids, k-means's 5 hot rows,
# and the embedding backward of qwen1.5-0.5b and of xlstm-125m (one rank)
DET_STREAMS = (((S, R, D), B, "zipf"), ((S, R, D), B, "uniform"),
               ((S, R, D), RING_N, "zipf"),
               ((S, 1 << 20, 1), 1 << 22, "zipf"),
               ((S, KM_K, KM_D), KM_B, "uniform"),
               ((TRAIN_V, TRAIN_D), 1024, "zipf"),
               ((50304, 768), 32, "zipf"))
DET_CALLS = 5


def phase_determinism() -> dict:
    """Float cscatter is the same bits on every call: for f32 and bf16
    tables under add and sat_add, each of ``DET_STREAMS`` goes through
    ``cscatter`` ``DET_CALLS`` times from the same table, ids and values,
    and every result must equal the first bit for bit (and stay within
    TOL of the plain version, as every kernel check). Launches here are
    checks and are not counted."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    rng = np.random.default_rng(SEED + 9)
    checked = 0
    for shape, n, law in DET_STREAMS:
        r, lead = shape[-2], shape[:-2]
        ids = ((rng.zipf(1.2, lead + (n,)) - 1) % r if law == "zipf"
               else rng.integers(0, r, lead + (n,)))
        ids = torch.as_tensor(ids.astype(np.int32), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(checked)
            table = torch.randn(shape, device="cuda", generator=g).to(dtype)
            vals = torch.randn(lead + (n, shape[-1]), device="cuda",
                               generator=g).to(dtype)
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            for kind, sat in (("add", (0.0, 0.0)), ("sat_add", (-3.0, 3.0))):
                first = None
                for _ in range(DET_CALLS):
                    got = cscatter(table.clone(), ids, vals, kind=kind,
                                   sat_min=sat[0], sat_max=sat[1])
                    if first is None:
                        first = got
                    else:
                        require(torch.equal(got.view(bits),
                                            first.view(bits)),
                                f"cscatter {dtype} {kind} {list(shape)} "
                                f"N={n} {law}: a repeated call differs")
                torch.cuda.synchronize()
                if n <= RING_N:
                    _compare(first, cscatter_plain(table, ids, vals,
                                                   kind=kind, sat_min=sat[0],
                                                   sat_max=sat[1]))
                del first, got
                checked += 1
            print(f"check cscatter determinism {list(shape)} N={n} {law} "
                  f"ids: f32 and bf16, add and sat_add, {DET_CALLS} calls "
                  f"each bit-identical")
            del table, vals
    return {"cases": checked, "calls": DET_CALLS}


def phase_kernel_times(stream_keys: np.ndarray) -> list[dict]:
    """Kernel, plain version and library call at the main path's shapes
    (one tick, one ring flush), on main-path ids from the key stream. For
    add, also the kernel with the bucket pass's positions written straight
    to device memory (``unstaged_ms``), the A/B of its shared-memory
    staging."""
    import torch
    from repro_torch.kernels.cscatter import (cscatter, cscatter_plain_,
                                              launch, plan)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
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
            def kernel():
                cscatter(table, ids, vals, kind=kind)
            row = {"kind": kind, "shape": [S, R, D], "n": n,
                   "ms": graph_ms(kernel), "call_ms": time_ms(kernel),
                   "plain_ms": time_ms(lambda: cscatter_plain_(
                       table, ids, vals, kind=kind)),
                   "library_ms": graph_ms(lib),
                   "library_call_ms": time_ms(lib),
                   "bound_ms": bound, "bound_by": bound_by}
            if kind == "add":
                p = plan(S, R, n, D, n_sm)
                require(p.stage, f"plan does not stage N={n}")
                direct = dataclasses.replace(p, stage=False)
                row["unstaged_ms"] = graph_ms(lambda: launch(
                    table, ids, vals, kind, 0.0, 0.0, direct))
            print(f"time cscatter {kind} [{S},{R},{D}] N={n}: kernel "
                  f"{row['ms']:.6f} ms (a call {row['call_ms']:.6f} ms"
                  + (f"; unstaged {row['unstaged_ms']:.6f} ms"
                     if "unstaged_ms" in row else "")
                  + f"), plain {row['plain_ms']:.6f} ms, library "
                  f"{row['library_ms']:.6f} ms (a call "
                  f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms")
            out.append(row)
    return out + embedding_kernel_times()


def _ways(g, s: int, n_blocks: int, w: int):
    """``w`` distinct block ids of ``n_blocks`` for each of ``s`` shards,
    int32 ``[s, w]`` on the card."""
    import torch
    order = torch.rand((s, n_blocks), device="cuda", generator=g).argsort(1)
    return order[:, :w].to(torch.int32).contiguous()


def phase_cmerge_checks() -> dict:
    """Every kind and dtype against the plain version, at W in {1, 8, 8192}
    ways of BR = 8 rows and D in {4, 128}, with invalid, clean and dirty
    ways; returns the worst errors. Launches here are comparisons and are
    not counted."""
    import torch
    from repro_torch.kernels.cmerge import cmerge, cmerge_plain
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"int": 0.0, "float": 0.0}
    checks = 0
    for dtype in (torch.int32, torch.uint32, torch.float32, torch.bfloat16):
        kinds = ("add", "sat_add", "max", "min") + (
            () if dtype.is_floating_point else ("or",))
        for d in (D, 128):
            rows = R if d == D else 1 << 16
            table = _rand_table(g, (S, rows, d), dtype, 0, 1 << 32)
            for w in (1, 8, 8192):
                ids = _ways(g, S, rows // BR, w)
                ids[torch.rand((S, w), device="cuda", generator=g)
                    < 0.2] = -1                               # invalid
                dirty = torch.rand((S, w), device="cuda", generator=g) < 0.7
                src = _rand_table(g, (S, w, BR, d), dtype, 0, 1 << 32)
                upd = _rand_table(g, (S, w, BR, d), dtype, 0, 1 << 32)
                if not dtype.is_floating_point:
                    upd.view(torch.int32).bitwise_or_(src.view(torch.int32))
                for kind in kinds:
                    sat = (-2.0, 2.0) if dtype.is_floating_point else (
                        0.0, float(1 << 30))
                    want = cmerge_plain(table, ids, dirty, src, upd,
                                        kind=kind, sat_min=sat[0],
                                        sat_max=sat[1])
                    got = cmerge(table.clone(), ids, dirty, src, upd,
                                 kind=kind, sat_min=sat[0], sat_max=sat[1])
                    torch.cuda.synchronize()
                    err = _compare(got, want)
                    key = "float" if dtype.is_floating_point else "int"
                    worst[key] = max(worst[key], err)
                    checks += 1
            print(f"check cmerge {str(dtype)[6:]} [{S},{rows},{d}] W=1,8,8192"
                  f" BR={BR} {','.join(kinds)}: ok (max abs err "
                  f"{worst['float' if dtype.is_floating_point else 'int']})")
    print(f"check cmerge: {checks} cases ok")
    return worst


def cmerge_bound_ms(ids, dirty, d: int, itemsize: int,
                    kind: str) -> tuple[float, str]:
    """The least time the card needs for one merge of these inputs: every
    way's id and dirty bit read once, and for each way that merges its
    memory block read and written once and the copies its kind reads read
    once — src and upd for add and sat_add, upd alone for max, min and or —
    (bytes), or the kind's operations per merged element, two for add
    (upd − src, then + mem) and one otherwise (operations)."""
    s, w = ids.shape
    merged = int(((ids >= 0) & dirty).sum())
    reads_src = kind in ("add", "sat_add")
    nbytes = s * w * 5 + (4 if reads_src else 3) * merged * BR * d * itemsize
    ops = (2 if reads_src else 1) * merged * BR * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_cmerge_times() -> list[dict]:
    """Kernel, plain version and library call at the blocked stores'
    shapes, int32 ``[8, 2^22, 4]``, every way valid and dirty: an
    evict-merge (W = 1, launched once per access), a cache flush (W = 8) and
    a spill drain (W = 8192 slots). The drain is also timed from inputs
    that are not in the L2 (``cold_ms``, ``library_cold_ms``)."""
    import torch
    from repro_torch.kernels.cmerge import cmerge, cmerge_plain_
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    table = torch.zeros((S, R, D), dtype=torch.int32, device="cuda")
    blocks = table.view(S * (R // BR), BR * D)
    out = []
    for what, w in (("evict", 1), ("flush", WAYS), ("drain", SPILL)):
        ids = _ways(g, S, R // BR, w)
        dirty = torch.ones((S, w), dtype=torch.bool, device="cuda")
        src = _rand_table(g, (S, w, BR, D), torch.int32, 0, 100)
        upd = src + _rand_table(g, (S, w, BR, D), torch.int32, 0, 100)
        gidx = (ids.long() + (R // BR) * torch.arange(
            S, device="cuda")[:, None]).reshape(-1)
        delta = (upd - src).reshape(-1, BR * D)
        upd_rows = upd.reshape(-1, BR * D)
        if what == "drain":     # other ways and copies, COLD_BYTES in all
            n_sets = int(COLD_BYTES // (2 * src.numel() * 4)) + 1
            drain_sets, lib_sets = [], []
            for _ in range(n_sets):
                i = _ways(g, S, R // BR, w)
                s_ = _rand_table(g, (S, w, BR, D), torch.int32, 0, 100)
                u_ = s_ + _rand_table(g, (S, w, BR, D), torch.int32, 0, 100)
                drain_sets.append((i, s_, u_))
                lib_sets.append(((i.long() + (R // BR) * torch.arange(
                    S, device="cuda")[:, None]).reshape(-1),
                    (u_ - s_).reshape(-1, BR * D), u_.reshape(-1, BR * D)))
        for kind, lib in (
                ("add", lambda: blocks.index_add_(0, gidx, delta)),
                ("max", lambda: blocks.index_reduce_(0, gidx, upd_rows,
                                                     "amax")),
                ("min", lambda: blocks.index_reduce_(0, gidx, upd_rows,
                                                     "amin"))):
            def kernel():
                cmerge(table, ids, dirty, src, upd, kind=kind)
            bound, bound_by = cmerge_bound_ms(ids, dirty, D, 4, kind)
            row = {"kind": kind, "what": what, "shape": [S, R, D], "w": w,
                   "br": BR, "ms": graph_ms(kernel),
                   "call_ms": time_ms(kernel),
                   "plain_ms": time_ms(lambda: cmerge_plain_(
                       table, ids, dirty, src, upd, kind=kind)),
                   "library_ms": graph_ms(lib),
                   "library_call_ms": time_ms(lib),
                   "bound_ms": bound, "bound_by": bound_by}
            cold = ""
            if what == "drain":
                # the drain's 34 MB fit the L2: also from cold inputs
                row["cold_ms"] = graph_ms(rotating(
                    lambda i, s_, u_: cmerge(table, i, dirty, s_, u_,
                                             kind=kind), drain_sets))
                row["library_cold_ms"] = graph_ms(rotating(
                    lambda gi, dl, ur: blocks.index_add_(0, gi, dl)
                    if kind == "add" else blocks.index_reduce_(
                        0, gi, ur, "amax" if kind == "max" else "amin"),
                    lib_sets))
                cold = (f"; from cold inputs kernel {row['cold_ms']:.6f} ms,"
                        f" library {row['library_cold_ms']:.6f} ms")
            print(f"time cmerge {kind} {what} [{S},{R},{D}] W={w} BR={BR}: "
                  f"kernel {row['ms']:.6f} ms (a call {row['call_ms']:.6f} "
                  f"ms), plain {row['plain_ms']:.6f} ms, library "
                  f"{row['library_ms']:.6f} ms (a call "
                  f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms"
                  f"{cold}")
            out.append(row)
    return out


def _oracle(keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The serial replay of a stream in int64; padding keys (< 0) drop."""
    ref = np.zeros((R, D), np.int64)
    ok = keys >= 0
    np.add.at(ref, keys[ok], vals[ok])
    return ref


def phase_stores(keys: np.ndarray, vals: np.ndarray) -> dict:
    """The main path end to end: four stores, flushed tables vs the oracle,
    kernel launches vs the schedule (its cscatter calls, each
    ``LAUNCHES_PER_CALL`` launches). Returns the summed launch count."""
    import torch
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
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
    for name, (make, calls) in stores.items():
        predicted = calls * LAUNCHES_PER_CALL
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


def _drive(kv, keys, vals) -> float:
    """Every tick of ``keys``/``vals`` (on the card) through ``kv``; the
    host-clock seconds, synchronized at both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(keys.shape[0]):
        kv.tick(keys[t], vals[t])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_schedules() -> dict:
    """The solved and adaptive commit schedules at the serving geometry,
    through ``launch/kv_serve.py``'s own functions: the wire vector, each
    level's rate measured on the card and the probe tick, then ``auto`` on
    the privatized store for max(27, 2 period + 1) ticks and ``adaptive``
    on the partitioned store with the overlapped commit for ``2 k_max + 1``
    ticks. The Pareto stream's second half carries a quarter of the load
    (the rest of each batch is padding), so the adaptive K moves. Flushed
    tables vs the oracle, bitwise; ``cscatter`` launches vs the schedule
    (the adaptive store's due ticks from a host twin of its schedule fed
    the same ``observe`` counts)."""
    import torch
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch.kv_serve import (key_stream,
                                             measure_schedule_inputs,
                                             schedule_from)
    from repro_torch.launch.schedule_inputs import describe_inputs
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan

    plan = serving_plan(S, "all")
    cfg = KVConfig(n_keys=R, cols=D)
    inputs = measure_schedule_inputs(cfg, S, B, plan, "cuda")
    for line in describe_inputs(inputs):
        print(f"schedules: {line}")
    auto = schedule_from("auto", plan, inputs, cfg.merge, S, B)
    print(f"schedules: solved auto schedule: {auto.describe()}")

    def adaptive():
        return schedule_from("adaptive", plan, inputs, cfg.merge, S, B,
                             overlap=True, partitioned=True)

    out = {"wire": inputs["wire"], "level_ms": [1e3 * t for t in
                                                 inputs["level_s"]],
           "rates": inputs["rates"], "tick_ms": 1e3 * inputs["tick_s"],
           "auto": auto.as_dict(), "launches": 0}
    twin = adaptive()     # the host twin of the adaptive store's schedule
    n_adapt = 2 * twin.max_period + 1
    n_auto = max(27, 2 * auto.period + 1)
    n_all = max(n_adapt, n_auto)
    keys_all = key_stream(n_all * S * B, R, "pareto", n_users=USERS,
                          seed=SEED).reshape(n_all, S, B)
    keys_all[n_all // 2:, :, B // 4:] = -1
    vals_all = np.random.default_rng(SEED).integers(
        1, 9, (n_all, S, B, D)).astype(np.int32)
    n_valid = [int((keys_all[t] >= 0).sum()) for t in range(n_all)]
    commits, ks = 0, [twin.period]
    for t in range(n_adapt):
        twin.observe(n_valid[t])
        if twin.due_count(t + 1):
            commits += 1
            ks.append(twin.period)
    runs = {
        "auto_privatized": (lambda: ShardedKV(cfg, S, plan=plan,
                                              schedule=auto),
                            n_auto, None),
        "adaptive_partitioned_overlap": (lambda: ShardedKV(
            KVConfig(n_keys=R, cols=D, partitioned=True), S, plan=plan,
            schedule=adaptive()), n_adapt, commits + 1),
    }
    for name, (make, n, calls) in runs.items():
        keys_dev = torch.as_tensor(keys_all[:n], device="cuda")
        vals_dev = torch.as_tensor(vals_all[:n], device="cuda")
        want = _oracle(keys_all[:n], vals_all[:n])
        kv = make()
        # the privatized store scatters every tick into its pending; the
        # partitioned one scatters its ring at each commit and at the flush
        predicted = (n if calls is None else calls) * LAUNCHES_PER_CALL
        cscatter.launches = 0
        wall = _drive(kv, keys_dev, vals_dev)
        sched = kv.schedule.as_dict()       # before the flush resets it
        kv.flush()
        torch.cuda.synchronize()
        got_launches = cscatter.launches
        out["launches"] += got_launches
        require(got_launches == predicted,
                f"{name}: cscatter launched {got_launches} times, the "
                f"schedule predicts {predicted}")
        require(np.array_equal(kv.table().astype(np.int64), want),
                f"{name}: flushed table differs from the numpy oracle")
        ups = sum(n_valid[:n]) / wall
        line = (f"store {name}: table == oracle bitwise over {n} ticks; "
                f"cscatter launches {got_launches} (predicted {predicted}); "
                f"{ups:.1f} updates/s ({wall:.6f} s)")
        if calls is not None:
            sched = sched["adaptive"]
            require(sched["n_resolves"] == twin.as_dict()["adaptive"][
                "n_resolves"], f"{name}: n_resolves differs from the twin")
            line += (f"; K by cycle {ks} ({commits} commits), n_resolves "
                     f"{sched['n_resolves']}")
            out["adaptive"] = {"ks": ks, "commits": commits,
                               "n_resolves": sched["n_resolves"],
                               "updates_per_s": ups}
        else:
            out["auto_updates_per_s"] = ups
        print(line)
        del kv, keys_dev, vals_dev
        torch.cuda.empty_cache()
    return out


def _segment(root: str, n: int) -> str:
    return os.path.join(root, "segments", f"seg_{n:08d}.log")


def crash_child(root: str) -> None:
    """The crashing store of :func:`phase_durability`, in its own process:
    the privatized K = 8 store with its journal under ``root`` serves ticks
    0-19 of the stream, snapshots after tick 12, prints an ack after each
    tick, and kills itself right after the last ack."""
    import torch
    from repro_torch.serve import KVConfig, ShardedKV

    stream, vals = main_stream()
    keys_dev = torch.as_tensor(stream.reshape(TICKS, S, B), device="cuda")
    vals_dev = torch.as_tensor(vals, device="cuda")
    kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, commit_every=K)
    kv.attach_journal(root)
    for t in range(CRASH_AT):
        kv.tick(keys_dev[t], vals_dev[t])
        print(f"ack {t}", flush=True)
        if t == SNAPSHOT_AT:
            kv.snapshot()
            print(f"snapshot {json.dumps(kv.last_snapshot_seconds)}",
                  flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def phase_durability(keys: np.ndarray, vals: np.ndarray) -> dict:
    """A real crash, then recovery onto another layout and onto the same.

    A child process (:func:`crash_child`) journals ticks 0-19, snapshots
    after tick 12 and dies by SIGKILL with no flush; a torn record is then
    appended to its last segment. A fresh S = 16 partitioned store with the
    overlapped commit recovers (the 7 journaled ticks re-chunked to [16,
    512]), serves ticks 20-26 and must equal the oracle of all 27 ticks; a
    fresh S = 8 privatized store recovers a copy of the same root (records
    passed through) and must equal the oracle of ticks 0-19. Then the
    journal's cost: updates/s of the privatized store over the 27 ticks
    without the journal, with it, and with it fsynced; an append's ms and
    bytes."""
    import torch
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.serve import KVConfig, ShardedKV, UpdateJournal
    from repro_torch.serve.journal import list_segments

    work = tempfile.mkdtemp(prefix="kv-durability-")
    root = os.path.join(work, "crashed")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--crash-child", root], capture_output=True,
                           text=True, timeout=300)
    child_s = time.perf_counter() - t0
    lines = child.stdout.splitlines()
    acks = [ln for ln in lines if ln.startswith("ack ")]
    require(child.returncode == -signal.SIGKILL,
            f"crash child: return code {child.returncode}, want "
            f"{-signal.SIGKILL}: {child.stderr[-2000:]}")
    require(acks == [f"ack {t}" for t in range(CRASH_AT)],
            f"crash child: {len(acks)} acks, want {CRASH_AT}")
    snap = json.loads(next(ln for ln in lines
                           if ln.startswith("snapshot "))[len("snapshot "):])
    with open(_segment(root, list_segments(root)[-1]), "ab") as f:
        f.write(b"KVJ1" + struct.pack("<I", 64) + b"torn")
    same = os.path.join(work, "same_layout")
    shutil.copytree(root, same)
    print(f"durability: child killed (return code {child.returncode}) "
          f"after {len(acks)} acks in {child_s:.6f} s; snapshot after tick "
          f"{SNAPSHOT_AT}: flush {1e3 * snap['flush']:.6f} ms, copy "
          f"{1e3 * snap['copy']:.6f} ms, write {1e3 * snap['write']:.6f} "
          f"ms; a torn record appended")

    keys_dev = torch.as_tensor(keys, device="cuda")
    vals_dev = torch.as_tensor(vals, device="cuda")
    s2, b2 = 2 * S, B // 2
    names = ("chip", "host", "pod")
    recoveries = {
        "partitioned_overlap_s16": (
            lambda: ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=True),
                              s2, schedule=DeferSchedule.fixed(
                                  K, names, overlap=True)),
            root, TICKS,
            # the ring scatters at the commit (tick 8 after recovery) and
            # at the flush
            2),
        "privatized_k8": (lambda: ShardedKV(KVConfig(n_keys=R, cols=D), S,
                                            commit_every=K),
                          same, CRASH_AT, CRASH_AT - SNAPSHOT_AT - 1),
    }
    out = {"child_s": child_s, "acks": len(acks), "snapshot_s": snap,
           "launches": 0}
    for name, (make, where, upto, calls) in recoveries.items():
        kv = make()
        cscatter.launches = 0
        report = kv.recover(where)
        for t in range(CRASH_AT, upto):
            kv.tick(keys_dev[t].reshape(s2, b2),
                    vals_dev[t].reshape(s2, b2, D))
        kv.flush()
        torch.cuda.synchronize()
        n = cscatter.launches
        out["launches"] += n
        require(report["snapshot_step"] is not None
                and report["replayed_ticks"] == CRASH_AT - SNAPSHOT_AT - 1,
                f"recover {name}: {report}")
        require(n == calls * LAUNCHES_PER_CALL,
                f"recover {name}: cscatter launched {n} times, the schedule "
                f"predicts {calls * LAUNCHES_PER_CALL}")
        require(np.array_equal(kv.table().astype(np.int64),
                               _oracle(keys[:upto], vals[:upto])),
                f"recover {name}: flushed table differs from the oracle of "
                f"ticks 0-{upto - 1}")
        sec = report["seconds"]
        print(f"durability: recover onto {name}: snapshot step "
              f"{report['snapshot_step']}, {report['replayed_ticks']} ticks "
              f"replayed; load {1e3 * sec['load']:.6f} ms, install "
              f"{1e3 * sec['install']:.6f} ms, replay "
              f"{1e3 * sec['replay']:.6f} ms; table == oracle of ticks "
              f"0-{upto - 1} bitwise; cscatter launches {n}")
        out[name] = {"report": report, "launches": n}
        del kv
        torch.cuda.empty_cache()

    want = _oracle(keys, vals)
    rates = {}
    for label, sync in (("no journal", None), ("journal", False),
                        ("journal fsync", True), ("no journal again", None)):
        kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, commit_every=K)
        if sync is not None:
            kv.attach_journal(os.path.join(work, label.replace(" ", "_")),
                              sync=sync)
        wall = _drive(kv, keys_dev, vals_dev)
        kv.flush()
        require(np.array_equal(kv.table().astype(np.int64), want),
                f"journal cost run ({label}): table differs from the oracle")
        rates[label] = S * B * TICKS / wall
        del kv
        torch.cuda.empty_cache()
    appends = {}
    for sync in (False, True):
        jroot = os.path.join(work, f"appends_{sync}")
        journal = UpdateJournal(jroot, sync=sync)
        t0 = time.perf_counter()
        for t in range(TICKS):
            journal.append(keys_dev[t].cpu().numpy(),
                           vals_dev[t].cpu().numpy())
        ms = 1e3 * (time.perf_counter() - t0) / TICKS
        journal.close()
        appends[sync] = (ms, os.path.getsize(_segment(jroot, 0)) / TICKS)
    print("durability: privatized store over 27 ticks: " + ", ".join(
        f"{k} {v:.1f} updates/s" for k, v in rates.items()))
    print(f"durability: a journal append from the card: "
          f"{appends[False][0]:.6f} ms ({appends[True][0]:.6f} ms fsynced), "
          f"{appends[False][1]:.1f} bytes a tick")
    out.update(updates_per_s=rates, append_ms=appends[False][0],
               append_fsync_ms=appends[True][0],
               journal_bytes_per_tick=appends[False][1])
    shutil.rmtree(work)
    return out


def lru_model(keys: np.ndarray, slots: int | None = None) -> dict:
    """The blocked engine's counters from a pure-Python model of each
    shard's cache over ``keys [ticks, S, B]``: the hit way, else the first
    free way, else the first way of least clock, the clock running on
    across ticks; every way invalidated by the flush at each commit tick and
    at the end. With ``slots``, dirty evictions spill into a buffer of that
    many distinct blocks, emptied at each commit."""
    out = {"evict_merges": 0, "silent_evicts": 0, "flush_merges": 0}
    if slots is not None:
        out.update(spills=0, spill_overflow=0)
    ticks, shards, _ = keys.shape
    for s in range(shards):
        ids, clock, dirty = [-1] * WAYS, [0] * WAYS, [False] * WAYS
        spilled: set = set()
        now = 0

        def flush():
            for w in range(WAYS):
                if ids[w] >= 0:
                    out["flush_merges" if dirty[w] else "silent_evicts"] += 1
                ids[w], dirty[w] = -1, False
            spilled.clear()

        for t in range(ticks):
            for key in keys[t, s].tolist():
                b = max(key, 0) // BR     # padding touches row 0
                if b in ids:
                    w = ids.index(b)
                else:
                    free = [i for i, x in enumerate(ids) if x < 0]
                    if free:
                        w = free[0]
                    else:
                        w = min(range(WAYS), key=clock.__getitem__)
                        if not dirty[w]:
                            out["silent_evicts"] += 1
                        elif slots is None:
                            out["evict_merges"] += 1
                        else:
                            out["evict_merges"] += 1
                            if ids[w] in spilled or len(spilled) < slots:
                                spilled.add(ids[w])
                                out["spills"] += 1
                            else:
                                out["spill_overflow"] += 1
                    ids[w] = b
                dirty[w], clock[w] = True, now
                now += 1
            if (t + 1) % K == 0:
                flush()
        flush()
    out["total_merges"] = out["evict_merges"] + out["flush_merges"]
    return out


def phase_blocked_stores(keys: np.ndarray, vals: np.ndarray) -> dict:
    """The blocked engine end to end: the replicated and the partitioned
    store over the first ``BLOCKED_TICKS`` ticks of the stream. Flushed
    tables vs the oracle, ``cmerge`` launches vs the schedule (one per
    access, plus one per cache flush and one per spill drain), counters vs
    :func:`lru_model`. Returns the summed launch counts."""
    import torch
    from repro_torch.kernels.cmerge import cmerge
    from repro_torch.kernels.cscatter import cscatter
    from repro_torch.serve import KVConfig, ShardedKV

    keys, vals = keys[:BLOCKED_TICKS], vals[:BLOCKED_TICKS]
    want = _oracle(keys, vals)
    flushes = BLOCKED_TICKS // K + 1              # commits + the final flush
    stores = {
        "blocked_k8": (KVConfig(n_keys=R, cols=D, engine="blocked",
                                ways=WAYS, block_rows=BR),
                       BLOCKED_TICKS * B + flushes, None),
        "blocked_partitioned_k8": (
            KVConfig(n_keys=R, cols=D, engine="blocked", ways=WAYS,
                     block_rows=BR, partitioned=True, spill_blocks=SPILL),
            BLOCKED_TICKS * B + 2 * flushes, SPILL),
    }
    keys_dev = torch.as_tensor(keys, device="cuda")
    vals_dev = torch.as_tensor(vals, device="cuda")
    launches = {"cmerge": 0, "cscatter": 0}
    for name, (cfg, predicted, slots) in stores.items():
        kv = ShardedKV(cfg, S, commit_every=K)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(BLOCKED_TICKS + 1)]
        torch.cuda.synchronize()
        cmerge.launches = cscatter.launches = 0
        t0 = time.perf_counter()
        marks[0].record()
        for t in range(BLOCKED_TICKS):
            kv.tick(keys_dev[t], vals_dev[t])
            marks[t + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tick_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        commit = [t for t in range(BLOCKED_TICKS) if (t + 1) % K == 0]
        kv.flush()
        torch.cuda.synchronize()
        n, n_scatter = cmerge.launches, cscatter.launches
        launches["cmerge"] += n
        launches["cscatter"] += n_scatter
        require(n == predicted, f"{name}: cmerge launched {n} times, the "
                                f"schedule predicts {predicted}")
        require(n_scatter == 0, f"{name}: cscatter launched {n_scatter} "
                                f"times, the blocked path predicts 0")
        got = kv.table().astype(np.int64)
        require(np.array_equal(got, want),
                f"{name}: flushed table differs from the numpy oracle")
        model = lru_model(keys, slots)
        counters = {k: v for k, v in kv.counters().items() if k in model}
        require(counters == model, f"{name}: counters {counters} != the LRU "
                                   f"model's {model}")
        ups = S * B * BLOCKED_TICKS / wall
        print(f"store {name}: table == oracle bitwise; counters == LRU model "
              f"{counters}; cmerge launches {n} (predicted {predicted}); "
              f"{ups:.1f} updates/s over {BLOCKED_TICKS} ticks "
              f"({wall:.6f} s); resident_state_bytes "
              f"{kv.resident_state_bytes()} per shard")
        print(f"store {name} ticks: commit ticks {commit} take "
              f"{sum(tick_ms[t] for t in commit):.6f} ms, the other "
              f"{BLOCKED_TICKS - len(commit)} take "
              f"{sum(tick_ms) - sum(tick_ms[t] for t in commit):.6f} ms "
              f"(median {statistics.median(tick_ms):.6f} ms, max "
              f"{max(tick_ms):.6f} ms at tick {tick_ms.index(max(tick_ms))})")
        del kv
        torch.cuda.empty_cache()
    return launches


def _attn_rand(g, dtype, *shapes):
    import torch
    return [torch.randn(s, device="cuda", generator=g).to(dtype)
            for s in shapes]


def _attn_compare(got, want) -> tuple[float, float]:
    """The kernel against its plain version: f32 to ``TOL`` (absolute
    4 * TOL); bf16 to ``ATTN_BF16_TOL`` per element and ``ATTN_BF16_ROW``
    per output row. Returns the max abs error and the worst row's error
    RMS over its output RMS."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    row = float((diff.square().mean(-1).sqrt()
                 / w.square().mean(-1).sqrt().clamp_min(1e-6)).max())
    if got.dtype == torch.bfloat16:
        atol, rtol = ATTN_BF16_TOL
        require(bool(torch.all(diff <= atol + rtol * w.abs())),
                f"attention kernel disagrees beyond {atol} + {rtol} * |want| "
                f"(max abs err {err})")
        require(row <= ATTN_BF16_ROW, f"attention kernel: an output row's "
                f"error RMS is {row} of its RMS, above {ATTN_BF16_ROW}")
    else:
        tol = TOL[str(got.dtype).split(".")[1]]
        require(bool(torch.all(diff <= tol * 4 + tol * w.abs())),
                f"attention kernel disagrees beyond TOL={tol} (max abs err "
                f"{err})")
    return err, row


def phase_attention_checks() -> dict:
    """flash_attention and decode_attention against their plain versions in
    f32 and bf16 (f32 to ``TOL``, bf16 to ``ATTN_BF16_TOL`` and
    ``ATTN_BF16_ROW``; see ``_attn_compare``):
    flash at qwen1.5-0.5b prefill, at internlm2-1.8b shapes (causal and
    bidirectional) and ragged S = T = 100, with sliding windows at
    hymba-1.5b's prefill (W = 1024, G = 5) and at windows of 100, 64 and 1
    over ragged S; the bf16 tensor-core kernel also
    at d in {8, 64, 72, 128, 256}, causal and not, with ragged S != T (S =
    100 against T = 37, and 37 against 100), GQA groups of 2 and 8, and
    through strided [B, S, H, d] views; decode at both models' cache shapes
    and at hymba-1.5b's ring (T = W = 1024) and global cache (T = 2112),
    G = 5, at positions 0, 1, mid and T - 1, and each of its two passes against
    the plain split and combine passes there. Prints the variant each
    flash shape ran and the split count of each decode shape. Returns the
    worst errors."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0, "row_float32": 0.0,
             "row_bfloat16": 0.0}
    flash_cases = [((8, 16, 512, 512, 64), 16, True),
                   ((2, 16, 1024, 1024, 128), 8, True),
                   ((2, 16, 1024, 1024, 128), 8, False),
                   ((2, 8, 100, 100, 64), 4, True)]
    edge_cases = [((1, 8, s, t, d), kv, causal)
                  for d in (8, 64, 72, 128, 256) for causal in (True, False)
                  for (s, t), kv in (((100, 37), 4), ((37, 100), 1))]
    # hymba-1.5b: G = 5; the ring of W = 1024 slots and a global cache
    decode_cases = [((8, 16, 64), 576, 16), ((8, 16, 128), 4096, 8),
                    ((8, 25, 64), HYMBA_W, 5), ((8, 25, 64), 2112, 5)]
    # sliding windows (causal): hymba-1.5b's prefill, and windows that end
    # inside a tile, cover one tile or only the diagonal, at ragged S
    window_cases = [((8, 25, 2048, 2048, 64), 5, HYMBA_W),
                    ((1, 8, 1000, 1000, 64), 2, 100),
                    ((1, 4, 257, 257, 128), 4, 64),
                    ((1, 4, 130, 130, 256), 1, 1)]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        cases = [(shape, kv, True, w) for shape, kv, w in window_cases] + [
            (shape, kv, causal, 0) for shape, kv, causal in flash_cases + (
                edge_cases if dtype == torch.bfloat16 else [])]
        for (b, h, s, t, d), kv, causal, window in cases:
            q, k, v = _attn_rand(g, dtype, (b, h, s, d), (b, kv, t, d),
                                 (b, kv, t, d))
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            # contiguous, then strided [B, S, H, d] views as the model's
            for view in ("contiguous", "strided"):
                args = (q, k, v) if view == "contiguous" else (
                    x.transpose(1, 2).contiguous().transpose(1, 2)
                    for x in (q, k, v))
                before = dict(flash_attention.launches_by_variant)
                got = flash_attention(*args, causal=causal, window=window)
                torch.cuda.synchronize()
                ran = [name for name, n in
                       flash_attention.launches_by_variant.items()
                       if n != before[name]]
                err, row = _attn_compare(got, want)
                worst[key] = max(worst[key], err)
                worst["row_" + key] = max(worst["row_" + key], row)
                print(f"check flash_attention {key} q [{b},{h},{s},{d}] "
                      f"T={t} KV={kv} causal={causal} window={window} "
                      f"{view}: ok via "
                      f"{ran} (max abs err {err}, worst row {row})")
        for (b, h, d), t, kv in decode_cases:
            q, k, v = _attn_rand(g, dtype, (b, h, d), (b, t, kv, d),
                                 (b, t, kv, d))
            splits = da.plan_splits(b, kv, t, d, n_sm)
            for pos in (0, 1, t // 2, t - 1):
                want = decode_attention_plain(q, k, v, pos)
                got = decode_attention(q, k, v, pos)
                torch.cuda.synchronize()
                err, row = _attn_compare(got, want)
                worst[key] = max(worst[key], err)
                worst["row_" + key] = max(worst["row_" + key], row)
                # each pass: the split pass's f32 partials against the
                # plain split pass (f32 sums in another order: the f32
                # TOL), the combine against the plain combine of them
                _, m, l, acc = da.launch(q, k, v, pos, splits)
                torch.cuda.synchronize()
                pm, pl, pa = da.decode_attention_partials_plain(
                    q, k, v, pos, splits)
                require(bool(torch.equal(m == da.NEG_INF, pm == da.NEG_INF)),
                        "decode_attention: the split pass's empty splits "
                        "differ from the plain split pass's")
                tol = TOL["float32"]
                for name, x, y in (("m", m, pm), ("l", l, pl),
                                   ("acc", acc, pa)):
                    require(bool(torch.all((x - y).abs()
                                           <= tol * 4 + tol * y.abs())),
                            f"decode_attention split pass: {name} differs "
                            f"from the plain split pass beyond TOL={tol}")
                _attn_compare(got, da.decode_attention_combine_plain(
                    m, l, acc, dtype))
            print(f"check decode_attention {key} q [{b},{h},{d}] T={t} "
                  f"KV={kv} positions 0,1,{t // 2},{t - 1}, {splits} "
                  f"splits: ok, each pass too (max abs err {worst[key]}, "
                  f"worst row {worst['row_' + key]})")
    return worst


def flash_bound_ms(b, h, kv, s, t, d, causal, itemsize,
                   window: int = 0) -> tuple[float, str]:
    """q, k, v read once and o written once (bytes), or the two products
    over the visible (query, key) pairs (operations; a sliding window
    keeps at most ``window`` keys a query) at the bf16 tensor rate (f32
    inputs: the f32 rate), whichever is larger."""
    pairs = (sum(min(i + 1, t, window or t) for i in range(s)) if causal
             else s * t)
    nbytes = (2 * b * h * s * d + 2 * b * kv * t * d) * itemsize
    ops = 4 * b * h * pairs * d
    rate = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def decode_bound_ms(b, h, kv, d, position, itemsize) -> tuple[float, str]:
    """q read and o written once and the K and V of slots [0, position]
    read once (bytes), or the two products over those slots (operations),
    whichever is larger."""
    n = position + 1
    nbytes = (2 * b * h * d + 2 * b * kv * n * d) * itemsize
    ops = 4 * b * h * n * d
    rate = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_attention_times() -> dict:
    """Kernel (CUDA graph of 100 launches), a call through the wrapper, the
    plain version and one scaled_dot_product_attention call (the yardstick;
    the port never calls it) at the serve path's shapes: qwen1.5-0.5b
    prefill (B 8, H = KV = 16, S = T = 512, d 64, causal) and its last
    decode step (cache T = 576, position 575), in bf16; the same at
    internlm2-1.8b's attention shapes (H 16, KV 8, d 128); and hymba-1.5b's
    (H 25, KV 5, d 64): its prefill of 2048 with a window of 1024 and, at
    the same shape, causal (SDPA with an explicit mask beside the window),
    and its decode over a full ring of 1024 slots and over a global layer's
    cache of 2112 at its last position. A decode row's
    times cover both of its launches; it is also timed, with SDPA, from a
    cache that is not in the L2 (``cold_ms``, ``library_cold_ms``), and at
    split counts around the plan's (``ms_by_splits``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        MAX_SPLITS, decode_attention, decode_attention_plain, launch,
        plan_splits)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    out = {"flash": [], "decode": []}
    for model, (b, h, kv, s, d), w in (
            ("qwen1.5-0.5b", (8, 16, 16, 512, 64), 0),
            ("internlm2-1.8b", (2, 16, 8, 1024, 128), 0),
            ("hymba-1.5b", (8, 25, 5, HYMBA_PROMPT, 64), HYMBA_W),
            ("hymba-1.5b", (8, 25, 5, HYMBA_PROMPT, 64), 0)):
        q, k, v = _attn_rand(g, bf16, (b, h, s, d), (b, kv, s, d),
                             (b, kv, s, d))
        bound, bound_by = flash_bound_ms(b, h, kv, s, s, d, True, 2, w)
        if w:       # SDPA has no window: an explicit mask
            diff = (torch.arange(s, device="cuda")[:, None]
                    - torch.arange(s, device="cuda")[None, :])
            mask = (diff >= 0) & (diff < w)

        def sdpa():
            if w:
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=kv != h)
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=kv != h)
        row = {"model": model, "q": [b, h, s, d], "kv_heads": kv,
               "causal": True, "window": w,
               "ms": graph_ms(lambda: flash_attention(q, k, v, window=w)),
               "call_ms": time_ms(lambda: flash_attention(q, k, v,
                                                          window=w)),
               "plain_ms": time_ms(lambda: flash_attention_plain(
                   q, k, v, window=w), **({"samples": 5, "inner": 1}
                                          if s >= HYMBA_PROMPT else {})),
               "library_ms": graph_ms(sdpa),
               "library_call_ms": time_ms(sdpa),
               "bound_ms": bound, "bound_by": bound_by}
        out["flash"].append(row)
        print(f"time flash_attention {model} bf16 q [{b},{h},{s},{d}] "
              f"KV={kv} causal window={w}: kernel {row['ms']:.6f} ms (a call "
              f"{row['call_ms']:.6f} ms), plain {row['plain_ms']:.6f} ms, "
              f"sdpa {row['library_ms']:.6f} ms (a call "
              f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms "
              f"({bound_by})")
    for model, (b, h, kv, t, d) in (
            ("qwen1.5-0.5b", (8, 16, 16, 576, 64)),
            ("internlm2-1.8b", (8, 16, 8, 4096, 128)),
            ("hymba-1.5b ring", (8, 25, 5, HYMBA_W, 64)),
            ("hymba-1.5b global", (8, 25, 5, HYMBA_PROMPT + HYMBA_GEN, 64))):
        q, k, v = _attn_rand(g, bf16, (b, h, d), (b, t, kv, d),
                             (b, t, kv, d))
        pos = t - 1
        ks, vs = (x[:, :pos + 1].transpose(1, 2) for x in (k, v))
        bound, bound_by = decode_bound_ms(b, h, kv, d, pos, 2)

        def sdpa():
            return F.scaled_dot_product_attention(q[:, :, None], ks, vs,
                                                  enable_gqa=kv != h)
        splits = plan_splits(b, kv, t, d, torch.cuda.get_device_properties(
            0).multi_processor_count)
        # copies of the cache, COLD_BYTES in all: each launch of a graph
        # reads a cache that is not in the L2, as a decode step does
        caches = [(k.clone(), v.clone()) for _ in range(
            max(2, int(COLD_BYTES // (2 * k.numel() * 2)) + 1))]
        row = {"model": model, "q": [b, h, d], "cache": [b, t, kv, d],
               "position": pos, "splits": splits,
               "ms": graph_ms(lambda: decode_attention(q, k, v, pos)),
               "call_ms": time_ms(lambda: decode_attention(q, k, v, pos)),
               "plain_ms": time_ms(lambda: decode_attention_plain(
                   q, k, v, pos)),
               "library_ms": graph_ms(sdpa),
               "library_call_ms": time_ms(sdpa),
               "cold_ms": graph_ms(rotating(
                   lambda kc, vc: decode_attention(q, kc, vc, pos), caches)),
               "library_cold_ms": graph_ms(rotating(
                   lambda kc, vc: F.scaled_dot_product_attention(
                       q[:, :, None], kc[:, :pos + 1].transpose(1, 2),
                       vc[:, :pos + 1].transpose(1, 2), enable_gqa=kv != h),
                   caches)),
               "bound_ms": bound, "bound_by": bound_by}
        del caches
        # the plan's split count beside its neighbours (device ms)
        row["ms_by_splits"] = {
            n: graph_ms(lambda: launch(q, k, v, pos, n))
            for n in sorted({1, splits // 2, splits - 1, splits, splits + 1,
                             2 * splits} & set(range(1, MAX_SPLITS + 1)))}
        out["decode"].append(row)
        print(f"time decode_attention {model} bf16 q [{b},{h},{d}] cache "
              f"[{b},{t},{kv},{d}] position {pos}, {splits} splits "
              f"({splits * kv * b} CTAs): kernel {row['ms']:.6f} "
              f"ms (a call {row['call_ms']:.6f} ms), plain "
              f"{row['plain_ms']:.6f} ms, sdpa {row['library_ms']:.6f} ms "
              f"(a call {row['library_call_ms']:.6f} ms), bound "
              f"{bound:.6f} ms ({bound_by}); from a cold cache kernel "
              f"{row['cold_ms']:.6f} ms, sdpa {row['library_cold_ms']:.6f} "
              f"ms; kernel ms by split count {row['ms_by_splits']}")
    return out


def phase_serve(card: str) -> dict:
    """The LM serving path at full width: qwen1.5-0.5b in bf16 with random
    weights from a seeded generator, a batch of SERVE_BATCH prompts of
    PROMPT random ids, GEN greedy tokens (cache PROMPT + GEN), through the
    port's serve entry point (``launch/serve.generate``). The attention
    kernels' counts are zeroed just before and read just after: one
    flash_attention a layer, and one decode_attention call a layer a decode
    step, of ``LAUNCHES_PER_CALL`` (2) launches.
    Then the same tokens go teacher-forced through the same weights with
    the plain attention versions, and every step's logits must agree to
    ``LOGIT_TOL`` (absolute): the two paths differ only in the attention's
    f32 summation order, whose bf16 outputs may round one way or the other
    (the kernel checks above), and that moves tied-embedding logits of
    magnitude about 1 by far less. Where the plain path's top-2 margin
    exceeds 2 * LOGIT_TOL the greedy tokens must be equal."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import (LAUNCHES_PER_CALL,
                                                      decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, prompts
    from repro_torch.models.registry import build_model
    cfg = get_config(ARCH)
    gc.collect()                 # what earlier phases left unreferenced
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda", seed=SEED)
    ids = prompts(cfg, SERVE_BATCH, PROMPT, SEED)
    generate(model, ids[:, :16], 2)                 # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = decode_attention.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(
        flash_attention.launches_by_variant, 0)
    res = generate(model, ids, GEN, keep_logits=True)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    by_variant = dict(flash_attention.launches_by_variant)
    # the serve path's own peak: weights, cache, activations, kept logits
    peak = torch.cuda.max_memory_allocated() - base
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (GEN - 1)
            * LAUNCHES_PER_CALL}
    require(launches == want, f"serve: launches {launches}, the path "
                              f"predicts {want}")
    require(by_variant["bf16_mma"] == cfg.n_layers,
            f"serve: flash_attention variants {by_variant}: every prefill "
            f"launch must run the bf16 tensor-core kernel")
    require(tuple(res.tokens.shape) == (SERVE_BATCH, GEN),
            f"serve: generated {tuple(res.tokens.shape)}")
    steps = GEN - 1
    out = {"prefill_ms": 1e3 * res.prefill_s,
           "prefill_tok_s": SERVE_BATCH * PROMPT / res.prefill_s,
           "decode_ms_per_step": 1e3 * res.decode_s / steps,
           "decode_tok_s": SERVE_BATCH * steps / res.decode_s,
           "peak_bytes": peak, "allocated_before_bytes": base,
           "launches": launches, "flash_launches_by_variant": by_variant}
    print(f"serve {cfg.name} bf16 batch {SERVE_BATCH} prompt {PROMPT} gen "
          f"{GEN} on {card}: prefill {out['prefill_ms']:.3f} ms "
          f"({out['prefill_tok_s']:.1f} tok/s), decode "
          f"{out['decode_ms_per_step']:.6f} ms a step "
          f"({out['decode_tok_s']:.1f} tok/s), peak memory {peak} bytes; "
          f"launches {launches} (predicted {want}), flash_attention by "
          f"variant {by_variant}")
    # teacher-forced through the plain attention, same weights and tokens
    model.attention = "plain"
    tokens = torch.as_tensor(ids, device="cuda")
    logits, caches = model.prefill(tokens, PROMPT + GEN)
    worst, checked, argmax_ok = 0.0, 0, 0
    for i, got in enumerate(res.logits):
        if i:
            logits, caches = model.decode_step(res.tokens[:, i - 1], caches,
                                               PROMPT + i - 1)
        require(bool(torch.isfinite(got).all()), f"serve step {i}: "
                                                 f"non-finite logits")
        err = float((got - logits).abs().max())
        worst = max(worst, err)
        require(err <= LOGIT_TOL, f"serve step {i}: kernel logits differ "
                                  f"from the plain path's by {err}")
        top2 = logits.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        same = got.argmax(-1) == logits.argmax(-1)
        require(bool(same[sure].all()), f"serve step {i}: greedy token "
                                        f"differs where the margin is sure")
        checked += int(sure.sum())
        argmax_ok += int(same.sum())
    require(launches == {"flash_attention": flash_attention.launches,
                         "decode_attention": decode_attention.launches},
            "the plain path launched an attention kernel")
    out.update(max_logit_err=worst, sure_tokens=checked,
               same_tokens=argmax_ok)
    print(f"serve vs plain attention, teacher-forced over {GEN} steps: max "
          f"|logit diff| {worst} <= {LOGIT_TOL}; greedy tokens equal at "
          f"{argmax_ok} of {SERVE_BATCH * GEN} positions, required at the "
          f"{checked} with a top-2 margin above {2 * LOGIT_TOL}")
    model.attention = "kernel"
    del model, caches, res
    torch.cuda.empty_cache()
    return out


def _teacher_forced(model, ids, res, prompt: int) -> list:
    """The logits of every step of ``res`` (a ``generate`` run) with its
    tokens teacher-forced through ``model`` as it is set now."""
    import torch
    logits, caches = model.prefill(torch.as_tensor(ids, device="cuda"),
                                   prompt + len(res.logits))
    out = [logits]
    for i in range(1, len(res.logits)):
        logits, caches = model.decode_step(res.tokens[:, i - 1], caches,
                                           prompt + i - 1)
        out.append(logits)
    del caches
    return out


def _greedy_check(got, want, margin: float, label: str) -> tuple[int, int]:
    """Greedy tokens of ``got`` equal to ``want``'s wherever ``want``'s
    top-2 margin exceeds ``margin`` -> (positions required, equal)."""
    import torch
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > margin
    same = got.argmax(-1) == want.argmax(-1)
    require(bool(same[sure].all()), f"{label}: greedy token differs where "
                                    f"the margin is sure")
    return int(sure.sum()), int(same.sum())


def _f32_floor_check(label: str, got: list, other: list, ref: list,
                     steps: int) -> dict:
    """Each step's served bf16 logits ``got[i]`` held against ``ref[i]``,
    the same function computed in f32 from the same weights, no farther
    than ``other[i]`` (the same function in bf16 another way) is: RMS
    error within 1.25 x ``other``'s plus 1e-3, largest error within
    ``max(LOGIT_TOL, 1.5 x`` ``other``'s largest``)``, greedy tokens equal
    to ``ref``'s wherever its top-2 margin exceeds twice that bound. At
    the families' depths the bf16 rounding of either path moves the
    logits by about ``LOGIT_TOL`` on its own (the readings this prints at
    step 0), so a fixed bound between two bf16 paths would test their
    rounding rather than the kernels or the recurrence."""
    worst_apart, worst_other, checked, same_n = 0.0, 0.0, 0, 0
    for i in range(steps):
        g, o, f = got[i], other[i], ref[i]
        k_err, p_err = (g - f).abs(), (o - f).abs()
        k_max, p_max = float(k_err.max()), float(p_err.max())
        k_rms = float(k_err.square().mean().sqrt())
        p_rms = float(p_err.square().mean().sqrt())
        apart = (g - o).abs()
        worst_apart = max(worst_apart, float(apart.max()))
        worst_other = max(worst_other, p_max)
        bound = max(LOGIT_TOL, 1.5 * p_max)
        require(k_rms <= 1.25 * p_rms + 1e-3 and k_max <= bound,
                f"{label} step {i}: served logits are farther from the f32 "
                f"reference (max {k_max}, RMS {k_rms}) than the other bf16 "
                f"path's (max {p_max}, RMS {p_rms}) allow")
        n, m = _greedy_check(g, f, 2 * bound, f"{label} step {i}")
        checked += n
        same_n += m
        if i == 0:
            print(f"{label} step 0 logits: served bf16 vs f32 max {k_max} "
                  f"RMS {k_rms}; other bf16 vs f32 max {p_max} RMS {p_rms}; "
                  f"the two bf16 paths apart max {float(apart.max())} RMS "
                  f"{float(apart.square().mean().sqrt())}")
    return {"max_logit_err": worst_apart, "other_vs_f32_max": worst_other,
            "sure_tokens": checked, "same_tokens": same_n}


def _plain_teacher_forced(model, ids, res, prompt: int, label: str,
                          f32_floor: bool = False) -> dict:
    """``res`` (a ``generate`` run through the kernels) against the same
    tokens teacher-forced through the plain attention versions: every
    step's logits within ``LOGIT_TOL``, greedy tokens equal where the plain
    path's top-2 margin exceeds ``2 * LOGIT_TOL`` (``phase_serve``'s
    bounds). No attention kernel may launch meanwhile. With ``f32_floor``
    (hymba-1.5b: 32 layers, prompts of 2048) both bf16 paths are held to
    the same weights in f32 through the plain attention instead
    (``_f32_floor_check``); the model ends in f32 and the caller drops
    it."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    before = (flash_attention.launches, decode_attention.launches)
    model.attention = "plain"
    plain = _teacher_forced(model, ids, res, prompt)
    ref = None
    if f32_floor:
        model.float()
        ref = _teacher_forced(model, ids, res, prompt)
    require(before == (flash_attention.launches, decode_attention.launches),
            f"{label}: the plain path launched an attention kernel")
    model.attention = "kernel"
    for i, got in enumerate(res.logits):
        require(bool(torch.isfinite(got).all()), f"{label} step {i}: "
                                                 f"non-finite logits")
    if ref is not None:
        out = _f32_floor_check(label, res.logits, plain, ref,
                               len(res.logits))
        print(f"{label} vs plain attention, teacher-forced over "
              f"{len(res.logits)} steps: the two bf16 paths apart by "
              f"{out['max_logit_err']} at most; each step within the plain "
              f"bf16 path's distance to the same weights in f32 (at most "
              f"{out['other_vs_f32_max']}); greedy tokens equal to the f32 "
              f"model's at {out['same_tokens']} of {res.tokens.numel()}, "
              f"required at the {out['sure_tokens']} with a sure margin")
        return out
    worst, checked, same_n = 0.0, 0, 0
    for i, (got, want) in enumerate(zip(res.logits, plain)):
        err = float((got - want).abs().max())
        worst = max(worst, err)
        require(err <= LOGIT_TOL, f"{label} step {i}: kernel logits differ "
                                  f"from the plain path's by {err}")
        n, m = _greedy_check(got, want, 2 * LOGIT_TOL, f"{label} step {i}")
        checked += n
        same_n += m
    print(f"{label} vs plain attention, teacher-forced over "
          f"{len(res.logits)} steps: max |logit diff| {worst} <= {LOGIT_TOL}"
          f"; greedy tokens equal at {same_n} of {res.tokens.numel()}, "
          f"required at the {checked} with a top-2 margin above "
          f"{2 * LOGIT_TOL}")
    return {"max_logit_err": worst, "sure_tokens": checked,
            "same_tokens": same_n}


def _serve_family(arch: str, cfg, prompt: int, gen: int, card: str,
                  want: dict) -> tuple:
    """``cfg`` at full width in bf16 with random weights from the seed,
    ``FAMILY_BATCH`` prompts of ``prompt`` random ids and ``gen`` greedy
    tokens through ``launch/serve.generate``, the attention kernels'
    counts zeroed just before and read just after and held to ``want``;
    then a ``--profile``-style trace of a prefill and one decode step.
    Returns (model, ids, result, the row to print)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, profile, prompts
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda", seed=SEED)
    ids = prompts(cfg, FAMILY_BATCH, prompt, SEED)
    generate(model, ids[:, :16], 2)                 # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = decode_attention.launches = 0
    flash_attention.launches_windowed = 0
    res = generate(model, ids, gen, keep_logits=True)
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_windowed": flash_attention.launches_windowed,
                "decode_attention": decode_attention.launches}
    peak = torch.cuda.max_memory_allocated() - base
    require(launches == want, f"{arch}: launches {launches}, the path "
                              f"predicts {want}")
    require(tuple(res.tokens.shape) == (FAMILY_BATCH, gen),
            f"{arch}: generated {tuple(res.tokens.shape)}")
    steps = gen - 1
    row = {"prefill_ms": 1e3 * res.prefill_s,
           "prefill_tok_s": FAMILY_BATCH * prompt / res.prefill_s,
           "decode_ms_per_step": 1e3 * res.decode_s / steps,
           "decode_tok_s": FAMILY_BATCH * steps / res.decode_s,
           "peak_bytes": peak, "launches": launches}
    print(f"serve {cfg.name} bf16 batch {FAMILY_BATCH} prompt {prompt} gen "
          f"{gen} on {card}: prefill {row['prefill_ms']:.3f} ms "
          f"({row['prefill_tok_s']:.1f} tok/s), decode "
          f"{row['decode_ms_per_step']:.6f} ms a step "
          f"({row['decode_tok_s']:.1f} tok/s), peak memory {peak} bytes; "
          f"launches {launches} (predicted {want})")
    row["profile"] = profile(model, ids, steps=1, rows=8)
    return model, ids, res, row


def _hymba_serve(card: str) -> dict:
    """(a) hymba-1.5b: 32 flash_attention launches at prefill (29 with the
    window), then a decode_attention call (2 launches) in each layer of
    every decode step; held against the plain attention."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    cfg = get_config("hymba-1-5b")
    n_win = cfg.n_layers - len(cfg.full_attn_layers)
    want = {"flash_attention": cfg.n_layers,
            "flash_attention_windowed": n_win,
            "decode_attention": cfg.n_layers * (HYMBA_GEN - 1)
            * LAUNCHES_PER_CALL}
    model, ids, res, row = _serve_family("hymba-1.5b", cfg, HYMBA_PROMPT,
                                         HYMBA_GEN, card, want)
    row.update(_plain_teacher_forced(model, ids, res, HYMBA_PROMPT,
                                     "serve hymba-1.5b", f32_floor=True))
    return row


def _xlstm_serve(card: str) -> dict:
    """(b) xlstm-125m: no attention kernel on the path. The recurrent
    decode is held against the chunkwise form: one ``forward`` over the
    prompt and the 256 tokens fed back (512, two mLSTM chunks) gives the
    logits at positions 255 .. 511, the reference of prefill's and every
    decode step's. In f32 the two forms must agree to 1e-3 (they are one
    function up to f32 summation order); the served bf16 run is then held
    to the f32 chunkwise logits no farther than the bf16 chunkwise ones
    are (``_f32_floor_check``: the two bf16 forms drift apart by about
    ``LOGIT_TOL`` through the rounding of 12 layers and 511 positions)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import module as nn
    cfg = get_config("xlstm-125m")
    want = {"flash_attention": 0, "flash_attention_windowed": 0,
            "decode_attention": 0}
    model, ids, res, row = _serve_family("xlstm-125m", cfg, XLSTM_PROMPT,
                                         XLSTM_GEN, card, want)
    seq = torch.cat([torch.as_tensor(ids, device="cuda").long(),
                     res.tokens[:, :-1]], dim=1)        # 256 + 256 = 512

    def chunkwise():
        with torch.no_grad():
            h, _ = model.forward(model.params(),
                                 nn.embed(model.embed["table"], seq))
            full = model._logits(h[:, XLSTM_PROMPT - 1:])
        return list(full.unbind(1))

    for i, got in enumerate(res.logits):
        require(bool(torch.isfinite(got).all()), f"xlstm-125m step {i}: "
                                                 f"non-finite logits")
    bf16_chunks = chunkwise()
    model.float()
    f32_chunks = chunkwise()
    f32_steps = _teacher_forced(model, ids, res, XLSTM_PROMPT)
    worst32 = max(float((a - b).abs().max())
                  for a, b in zip(f32_steps, f32_chunks))
    require(worst32 <= 1e-3, f"xlstm-125m in f32: recurrent logits differ "
                             f"from the chunkwise form's by {worst32}")
    out = _f32_floor_check("serve xlstm-125m", res.logits, bf16_chunks,
                           f32_chunks, len(res.logits))
    print(f"serve xlstm-125m: recurrent decode vs the chunkwise forward "
          f"over 512 tokens, positions 255..511: {worst32} <= 1e-3 apart in "
          f"f32; in bf16 {out['max_logit_err']} apart, the served recurrent "
          f"run within the bf16 chunkwise form's distance to f32 (at most "
          f"{out['other_vs_f32_max']}) at every step; greedy tokens "
          f"required equal to the f32 form's at {out['sure_tokens']}")
    row.update(out, max_logit_err_f32=worst32)
    return row


def _gelu_serve(card: str) -> dict:
    """(c) the dense family's GELU MLP: ``DecoderLM`` at granite-34b's
    smoke config with ``mlp="gelu"`` (a smoke width: the full config's 67
    GB of bf16 weights leave no room on one card) through the kernels,
    against its plain path."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    cfg = dataclasses.replace(get_smoke_config("granite-34b"), mlp="gelu")
    gen, prompt = 16, 64
    want = {"flash_attention": cfg.n_layers, "flash_attention_windowed": 0,
            "decode_attention": cfg.n_layers * (gen - 1) * LAUNCHES_PER_CALL}
    model, ids, res, row = _serve_family("granite-34b-smoke gelu", cfg,
                                         prompt, gen, card, want)
    require(sorted(model.params()["blocks"]["ffn"]) == ["wi", "wo"],
            "granite-34b gelu: the model did not build the GELU MLP")
    row.update(_plain_teacher_forced(model, ids, res, prompt,
                                     "serve granite-34b-smoke gelu"))
    return row


def _leaf_diff(a, b) -> list[str]:
    """The leaf paths at which two state trees differ in bits."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    fa, fb = dict(_flatten_with_paths(a)), dict(_flatten_with_paths(b))
    if sorted(fa) != sorted(fb):
        return ["<tree structure>"]
    return [k for k in fa if not torch.equal(torch.as_tensor(fa[k]),
                                             torch.as_tensor(fb[k]))]


def _real_model_chaos(card: str) -> dict:
    """(d) the real-model chaos at full width: xlstm-125m through
    ``runtime/chaos.real_model_run`` on the card, the example's 5 steps of
    batch 8 x 32 (one row a rank) over the 8 stacked ranks. The twin runs
    twice and must equal itself in every leaf (params, AdamW, the flushed
    defer state); kills before ``CHAOS_KILLS`` resume to parameters equal
    to the twin's bit for bit; the control (fresh defer state on resume)
    must differ. ``cscatter`` (the embedding backward) launches 2 a rank a
    step."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.runtime import chaos
    cfg = get_config("xlstm-125m")
    gc.collect()
    torch.cuda.empty_cache()
    cscatter.launches = 0
    runs, steps = {}, 0
    t0 = time.perf_counter()
    twin = chaos.real_model_twin(cfg, CHAOS_STEPS, device="cuda")
    torch.cuda.synchronize()
    runs["twin_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = chaos.real_model_twin(cfg, CHAOS_STEPS, device="cuda")
    torch.cuda.synchronize()
    runs["twin_again_s"] = time.perf_counter() - t0
    steps += 2 * CHAOS_STEPS
    # a checkpoint holds the state's leaves (params, AdamW, the pod level's
    # pending and in-flight [8, ...] stacks); the driver keeps 3
    from torch.utils import _pytree as pytree
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves(twin)
                      if isinstance(x, torch.Tensor))
    free = shutil.disk_usage(tempfile.gettempdir()).free
    print(f"chaos xlstm-125m: state {state_bytes} bytes, {free} bytes free "
          f"under {tempfile.gettempdir()}")
    require(free > 4 * state_bytes, "chaos: too little disk for the "
            "driver's three checkpoints")
    runs["state_bytes"] = state_bytes
    diff = _leaf_diff(twin, again)
    print(f"chaos xlstm-125m twin run twice: {'bitwise equal in every leaf' if not diff else 'differs at ' + ', '.join(diff)}")
    require(not diff, f"the twin is not bitwise repeatable: {diff}")
    del again
    for kill in CHAOS_KILLS + (None,):
        with tempfile.TemporaryDirectory() as d:
            out = chaos.real_model_run(cfg, CHAOS_STEPS, d,
                                       kill or CHAOS_KILLS[-1],
                                       device="cuda",
                                       fresh_defer=kill is None)
        steps += CHAOS_STEPS
        same = chaos.trees_bitwise_equal(out["state"]["params"],
                                         twin["params"])
        label = f"kill@{kill}" if kill else "control (fresh defer state)"
        rec = {"resume_action": out["report"].action,
               "params_bitwise": same, "seconds": out["seconds"],
               "ms_per_step": 1e3 * statistics.median(out["step_s"]),
               "save_ms": [1e3 * x for x in out["save_s"]],
               "ckpt_bytes": out["ckpt_bytes"]}
        runs[label] = rec
        print(f"chaos xlstm-125m {label}: resumed {rec['resume_action']} "
              f"in {1e3 * rec['seconds']['resume']:.3f} ms, "
              f"{rec['ms_per_step']:.3f} ms a step (median), checkpoint "
              f"{rec['ckpt_bytes']} bytes saved in "
              f"{statistics.median(rec['save_ms']):.3f} ms (median); "
              f"params {'BITWISE equal' if same else 'differ'} vs the twin")
        if kill:
            require(same, f"real-model chaos {label}: params diverged")
        else:
            require(not same, "real-model chaos: the control without the "
                              "defer state matched the twin")
        del out
    want = LAUNCHES_PER_CALL * 8 * steps
    require(cscatter.launches == want, f"chaos: cscatter launches "
            f"{cscatter.launches}, predicted {want} (2 a rank a step)")
    runs["cscatter_launches"] = cscatter.launches
    runs["steps"] = steps
    print(f"chaos xlstm-125m: {steps} steps, cscatter launches "
          f"{cscatter.launches} (predicted {want}) on {card}")
    del twin
    torch.cuda.empty_cache()
    return runs


def phase_families(card: str) -> dict:
    """This slice's paths, each with the kernels' counts zeroed just
    before and read just after: (a) hymba-1.5b served at full width, (b)
    xlstm-125m served at full width, (c) the GELU MLP, (d) the real-model
    chaos of xlstm-125m at full width."""
    out = {}
    for name, fn in (("hymba", _hymba_serve), ("xlstm", _xlstm_serve),
                     ("gelu", _gelu_serve), ("chaos", _real_model_chaos)):
        t0 = time.perf_counter()
        out[name] = fn(card)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"phase families/{name}: {out[name]['phase_s']:.3f} s")
    return out


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


def kronecker_edges(scale: int, edgefactor: int, seed: int,
                    device: str = "cuda"):
    """Graph500's Kronecker generator: ``edgefactor * 2^scale`` undirected
    edges, vertex labels and edge order permuted; returned in both
    directions as int32 ``(src, dst)`` tensors on ``device``. The draws are
    numpy's, from the seed; each bit's compare (``u > ab`` in float32, the
    second against a float64 threshold) and the edges' assembly run on
    ``device``."""
    import torch
    a, b, c = KRONECKER
    n, m = 1 << scale, edgefactor << scale
    rng = np.random.default_rng(seed)
    ab = float(np.float32(a + b))
    # float64 thresholds: [a_norm, c_norm], picked by the first bit
    thr = torch.tensor([a / (a + b), c / (1.0 - (a + b))],
                       dtype=torch.float64, device=device)
    i = torch.zeros(m, dtype=torch.int32, device=device)
    j = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        u = torch.from_numpy(rng.random(m, dtype=np.float32)).to(device)
        ii = u > ab
        u = torch.from_numpy(rng.random(m, dtype=np.float32)).to(device)
        jj = u.double() > thr[ii.long()]
        i |= ii.int() << bit
        j |= jj.int() << bit
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(device)
    order = torch.from_numpy(rng.permutation(m)).to(device)
    i, j = perm[i[order].long()], perm[j[order].long()]
    return torch.cat([i, j]), torch.cat([j, i])


def in_edges_csr(src, dst, n: int):
    """The float64 CSR whose row v lists the sources of the edges into v
    (duplicates summed): a ``torch`` sparse matrix, on the edges' device."""
    import torch
    ok = (src >= 0) & (dst >= 0)
    idx = torch.stack([dst[ok].long(), src[ok].long()])
    ones = torch.ones(idx.shape[1], dtype=torch.float64, device=src.device)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, ones, (n, n),
                                       check_invariants=False) \
            .coalesce().to_sparse_csr()


def bfs_oracle(at, root: int):
    """Level-synchronous BFS over the CSR ``at`` (row v lists the sources of
    the edges into v), a sparse matvec a level: int32 distances,
    INT32_MAX where unreachable."""
    import torch
    inf = np.iinfo(np.int32).max
    n = at.shape[0]
    dist = torch.full((n,), inf, dtype=torch.int32, device=at.device)
    dist[root] = 0
    frontier = torch.zeros(n, dtype=torch.float64, device=at.device)
    frontier[root] = 1.0
    level = 0
    while bool(frontier.any()):
        level += 1
        new = ((at @ frontier) > 0) & (dist == inf)
        dist[new] = level
        frontier = new.double()
    return dist


def pagerank_oracles(at, pod_at, deg, counts, defer: int, k: int):
    """Float64 PageRank on the card, by sparse matvecs independent of the
    port's apps: the synchronous power iteration's ranks after each of
    ``counts`` iterations, and a mirror of the deferred schedule — each pod
    (``pod_at``, the edges of the eager scope) iterates on its own edges
    plus the remote term it took at the last commit, every ``k``
    supersteps, as ``run_pagerank`` does — after ``defer``."""
    import torch
    n = at.shape[0]
    inv_deg = 1.0 / torch.clamp(deg, min=1).double()
    base = (1.0 - PR_ALPHA) / n
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=at.device)
    refs = {}
    for it in range(1, max(counts) + 1):
        r = base + PR_ALPHA * (at @ (r * inv_deg))
        if it in counts:
            refs[it] = r.clone()
    pods = len(pod_at)
    views = [torch.full_like(r, 1.0 / n) for _ in range(pods)]
    remote = [torch.zeros_like(r) for _ in range(pods)]
    for it in range(1, defer + 1):
        own = [PR_ALPHA * (a @ (v * inv_deg)) for a, v in zip(pod_at, views)]
        if it % k == 0:
            full = sum(own)
            views = [base + full for _ in range(pods)]
            remote = [full - o for o in own]
        else:
            views = [base + o + m for o, m in zip(own, remote)]
    return refs, views


def app_kernel_row(name: str, table, ids, vals, kind: str, lib) -> dict:
    """``cscatter`` at one app's shapes against its plain version (integers
    bitwise, floats to TOL) and timed beside the plain version, one
    library call and the bound. Launches here are comparisons and are not
    counted. These inputs (ids and vals of 8 x 4.2M at the graph apps)
    exceed the L2, so warm and cold times agree there."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain_
    want = cscatter_plain_(table.clone(), ids, vals, kind=kind)
    got = cscatter(table.clone(), ids, vals, kind=kind)
    torch.cuda.synchronize()
    err = _compare(got, want)
    big = ids.numel() > 1 << 20
    work = table.clone()
    s, r, d = table.shape
    bound, bound_by = scatter_bound_ms(ids, d, table.element_size(), r)
    row = {"app": name, "kind": kind, "dtype": str(table.dtype)[6:],
           "shape": [s, r, d], "n": ids.shape[1], "max_abs_err": err,
           "ms": graph_ms(lambda: cscatter(work, ids, vals, kind=kind),
                          launches=5 if big else 100,
                          samples=5 if big else 11),
           "call_ms": time_ms(lambda: cscatter(work, ids, vals, kind=kind),
                              samples=5 if big else 21,
                              inner=1 if big else 5),
           "plain_ms": time_ms(lambda: cscatter_plain_(work, ids, vals,
                                                       kind=kind),
                               samples=3 if big else 11, inner=1),
           "library_ms": graph_ms(lambda: lib(work),
                                  launches=5 if big else 100,
                                  samples=5 if big else 11),
           "bound_ms": bound, "bound_by": bound_by}
    row.update(pass_ms(lambda: cscatter(work, ids, vals, kind=kind)))
    print(f"time cscatter {name}: {kind} {row['dtype']} [{s},{r},{d}] "
          f"N={ids.shape[1]}: kernel {row['ms']:.6f} ms (a call "
          f"{row['call_ms']:.6f} ms; traced: bucket pass "
          f"{row['bucket_ms']} ms, fold pass {row['fold_ms']} ms), plain "
          f"{row['plain_ms']:.6f} ms, library {row['library_ms']:.6f} ms, "
          f"bound {bound:.6f} ms ({bound_by}); max abs err {err}")
    return row


def pass_ms(fn, calls: int = 3) -> dict:
    """Device ms a call of ``cscatter``'s two passes, from a
    ``torch.profiler`` trace of ``calls`` calls (None where the trace has
    no device time for a pass)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in ("bucket", "fold"):
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and f"{name}_kernel" in e.key)
        out[f"{name}_ms"] = us / 1e3 / calls if us else None
    return out


def _library(ids, vals, kind: str, r: int):
    """One PyTorch call of the same scatter into a ``[S, r, D]`` table, on
    flat inputs filtered once here: ``scatter_reduce_(..., "amin")`` for
    MIN, ``index_add_`` for ADD."""
    import torch
    s, d = ids.shape[0], vals.shape[-1]
    ok = (ids >= 0) & (ids < r)
    gid = (ids.long() + r * torch.arange(s, device=ids.device)[:, None])[ok]
    v = vals[ok].reshape(-1, d)

    def call(table):
        if kind == "min":
            table.view(-1, d).scatter_reduce_(0, gid[:, None].expand(-1, d),
                                              v, "amin")
        else:
            table.view(-1, d).index_add_(0, gid, v)
    return call


def phase_apps(card: str) -> dict:
    """The paper's BFS, PageRank and k-means on the card through the
    port's app drivers (``repro_torch.apps``), each run's ``cscatter``
    count zeroed just before and read just after and held to the schedule
    (2 launches a BFS superstep, 2 for the degrees plus 2 a PageRank
    superstep, 4 a k-means step); BFS bitwise on every shard against a
    level-synchronous BFS by sparse matvecs, PageRank against a float64
    power iteration (both on the card, independent of the apps), k-means
    against the numpy schedule mirror; ``run_app`` at its own defaults; and the
    kernel at each app's shapes against its plain version, timed."""
    import torch
    from repro_torch.apps import (bfs_superstep, kmeans_reference, run_bfs,
                                  run_kmeans, run_pagerank)
    from repro_torch.apps.bfs import INF
    from repro_torch.apps.common import default_plan, shard_edges
    from repro_torch.apps.kmeans import _assign
    from repro_torch.apps.sharded import run_app
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    gc.collect()
    torch.cuda.empty_cache()
    plan, plan_d = default_plan(S), default_plan(S, defer_top=True)
    n = 1 << GRAPH_SCALE
    t0 = time.perf_counter()
    src, dst = kronecker_edges(GRAPH_SCALE, EDGEFACTOR, SEED)
    at = in_edges_csr(src, dst, n)
    deg = torch.bincount(src, minlength=n)
    root = int(np.random.default_rng(SEED).choice(
        np.flatnonzero(deg.cpu().numpy())))
    want_dist = bfs_oracle(at, root)
    reached = want_dist < INF
    depth = int(want_dist[reached].max())
    src_np, dst_np = shard_edges(src.cpu().numpy(), dst.cpu().numpy(), S)
    src_sh = torch.as_tensor(src_np, device="cuda")
    dst_sh = torch.as_tensor(dst_np, device="cuda")
    # Graph500 TEPS counts the input (undirected) edges of the component
    edges_in_component = int(reached[src[:len(src) // 2].long()].sum())
    print(f"apps graph: Kronecker SCALE {GRAPH_SCALE} edgefactor "
          f"{EDGEFACTOR}: {n} vertices, {len(src) // 2} undirected edges "
          f"({len(src)} directed, {src_np.shape[1]} a shard), root {root}, "
          f"{int(reached.sum())} reached, depth {depth}, "
          f"{edges_in_component} edges in the component; generated and "
          f"oracle BFS in {time.perf_counter() - t0:.3f} s")
    out: dict = {"graph": {"vertices": n, "directed_edges": len(src),
                           "depth": depth, "root": root}}
    want = want_dist.expand(S, n)
    dist0 = torch.full((S, n), INF, dtype=torch.int32, device="cuda")
    dist0[:, root] = 0

    # one superstep of each graph app first, not counted or timed: the
    # first use of these shapes allocates the scatter's scratch
    run_bfs(dist0, src_sh, dst_sh, plan, supersteps=1)
    run_pagerank(n, src_sh, dst_sh, plan, alpha=PR_ALPHA, supersteps=1)

    def run(label, fn, predicted):
        torch.cuda.synchronize()
        cscatter.launches = 0
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = cscatter.launches
        require(got == predicted, f"{label}: cscatter launched {got} times, "
                                  f"the schedule predicts {predicted}")
        return res, secs, got

    for label, p, steps, k in (("bfs eager", plan, depth + 1, None),
                               ("bfs deferred", plan_d, 4 * (depth + 1),
                                APP_K)):
        dist, secs, launches = run(label, lambda: run_bfs(
            dist0, src_sh, dst_sh, p, supersteps=steps, defer_k=k),
            LAUNCHES_PER_CALL * steps)
        require(torch.equal(dist, want),
                f"{label}: distances differ from the oracle BFS on "
                f"{int((dist != want).any(1).sum())} of {S} shards")
        row = {"supersteps": steps, "s": secs, "launches": launches,
               "supersteps_per_s": steps / secs,
               "teps": edges_in_component / secs,
               "superstep_ms": 1e3 * secs / steps}
        out[label] = row
        print(f"app {label}: {steps} supersteps, every shard == oracle BFS "
              f"bitwise; cscatter launches {launches} (predicted "
              f"{LAUNCHES_PER_CALL * steps}); {secs:.6f} s, "
              f"{row['supersteps_per_s']:.3f} supersteps/s, "
              f"{row['teps']:.1f} TEPS")

    # PageRank: float64 power iteration over the same CSR, at both counts,
    # and a float64 mirror of the deferred schedule over the pods (the eager
    # scope, 4 shards each)
    t0 = time.perf_counter()
    pods = plan_d.levels[-1].size
    per_pod = S // pods
    pod_at = [in_edges_csr(src_sh[q * per_pod:(q + 1) * per_pod].reshape(-1),
                           dst_sh[q * per_pod:(q + 1) * per_pod].reshape(-1),
                           n) for q in range(pods)]
    refs, views = pagerank_oracles(at, pod_at, deg, (PR_EAGER, PR_DEFER),
                                   PR_DEFER, APP_K)
    del pod_at
    mirror = torch.stack(views).repeat_interleave(S // pods, dim=0)
    torch.cuda.synchronize()
    print(f"apps pagerank oracles: {max(PR_EAGER, PR_DEFER)} float64 "
          f"iterations, and the deferred schedule's mirror over {pods} pods, "
          f"on the card in {time.perf_counter() - t0:.3f} s; the mirror's "
          f"worst relative gap to the synchronous ranks "
          f"{((views[0] - refs[PR_DEFER]).abs() / refs[PR_DEFER]).max().item()}")
    for label, p, steps, k, rtol in (
            ("pagerank eager", plan, PR_EAGER, None, PR_RTOL_EAGER),
            ("pagerank deferred", plan_d, PR_DEFER, APP_K, PR_RTOL_DEFER)):
        ranks, secs, launches = run(label, lambda: run_pagerank(
            n, src_sh, dst_sh, p, alpha=PR_ALPHA, supersteps=steps,
            defer_k=k), LAUNCHES_PER_CALL * (1 + steps))
        ref = refs[steps]
        rel = ((ranks.double() - ref).abs() / ref).max().item()
        require(bool(torch.isfinite(ranks).all()) and rel <= rtol,
                f"{label}: worst relative error {rel} > {rtol}")
        row = {"supersteps": steps, "s": secs, "launches": launches,
               "supersteps_per_s": steps / secs, "max_rel_err": rel,
               "superstep_ms": 1e3 * secs / steps}
        if k is not None:
            row["max_rel_err_mirror"] = (
                (ranks.double() - mirror).abs() / mirror).max().item()
            require(row["max_rel_err_mirror"] <= PR_RTOL_EAGER,
                    f"{label}: worst relative error "
                    f"{row['max_rel_err_mirror']} from the float64 mirror "
                    f"of its schedule > {PR_RTOL_EAGER}")
        out[label] = row
        print(f"app {label}: {steps} supersteps, every shard within rtol "
              f"{rtol} of the float64 iteration (worst {rel})"
              + (f" and within {PR_RTOL_EAGER} of the mirror of its "
                 f"schedule (worst {row['max_rel_err_mirror']})"
                 if k is not None else "")
              + f"; cscatter launches {launches} (predicted "
              f"{LAUNCHES_PER_CALL * (1 + steps)}); {secs:.6f} s, "
              f"{row['supersteps_per_s']:.3f} supersteps/s")

    # k-means: 5 Gaussian clusters in 34 dimensions; Rodinia's init, the
    # first k points of the stream
    rng = np.random.default_rng(SEED + 2)
    centers = rng.normal(size=(KM_K, KM_D)).astype(np.float32) * 4
    label_of = rng.integers(0, KM_K, (S, KM_T, KM_B))
    pts = (centers[label_of] + rng.normal(size=(S, KM_T, KM_B, KM_D))
           ).astype(np.float32)
    c0 = pts[0, 0, :KM_K].copy()
    pts_ref = pts.transpose(1, 0, 2, 3).reshape(KM_T, S * KM_B, KM_D)
    pts_dev = torch.as_tensor(pts, device="cuda")
    c0_dev = torch.as_tensor(c0, device="cuda")
    for commit_k, overlap in ((4, False), (4, True), (2, True)):
        label = f"kmeans k{commit_k} {'overlap' if overlap else 'defer'}"
        ref = torch.as_tensor(kmeans_reference(
            pts_ref, c0, commit_k=commit_k, overlap=overlap), device="cuda")
        got, secs, launches = run(label, lambda: run_kmeans(
            pts_dev, c0_dev, plan_d, commit_k=commit_k, overlap=overlap),
            2 * LAUNCHES_PER_CALL * KM_T)
        diff = (got - ref).abs()
        worst = diff.max().item()
        require(bool((diff <= KM_TOL + KM_TOL * ref.abs()).all()),
                f"{label}: centroids differ from the mirror by {worst}")
        out[label] = {"steps": KM_T, "s": secs, "launches": launches,
                      "steps_per_s": KM_T / secs, "max_abs_err": worst,
                      "step_ms": 1e3 * secs / KM_T}
        print(f"app {label}: {KM_T} steps of {S} x {KM_B} points, every "
              f"shard within atol = rtol = {KM_TOL} of the numpy mirror "
              f"(worst {worst}); cscatter launches {launches} (predicted "
              f"{2 * LAUNCHES_PER_CALL * KM_T}); {secs:.6f} s")

    # the entry point at its own small defaults, on the card
    apps = {a: run_app(a, S) for a in ("bfs", "pagerank", "kmeans")}
    require(apps["bfs"]["eager_max_err"] == 0.0
            and apps["bfs"]["defer_max_err"] == 0.0, f"run_app bfs {apps}")
    require(apps["pagerank"]["eager_max_err"] < 1e-4
            and apps["pagerank"]["defer_max_err"] < 1e-4,
            f"run_app pagerank {apps['pagerank']}")
    require(apps["kmeans"]["defer_max_err"] < 1e-3
            and apps["kmeans"]["overlap_max_err"] < 1e-3,
            f"run_app kmeans {apps['kmeans']}")
    print(f"run_app on the card: {json.dumps(apps)}")
    out["run_app"] = apps

    # the kernel at each app's shapes: the last BFS superstep (every edge of
    # the component active), a PageRank superstep at the final ranks, and a
    # k-means step's two scatters
    d_src = dist.gather(1, torch.where(src_sh >= 0, src_sh, 0).long())
    ok = (src_sh >= 0) & (d_src < INF)
    bfs_ids = torch.where(ok, dst_sh, -1)
    bfs_vals = torch.where(ok, d_src + 1, INF).to(torch.int32)[..., None]
    del d_src, ok
    degs = deg.float().expand(S, n)
    okp = src_sh >= 0
    safe = torch.where(okp, src_sh, 0).long()
    w = PR_ALPHA * ranks.gather(1, safe) / torch.clamp(degs.gather(1, safe),
                                                       min=1.0)
    pr_ids = torch.where(okp, dst_sh, -1)
    pr_vals = torch.where(okp, w, 0.0).to(torch.float32)[..., None]
    del safe, w, okp
    km_pts = pts_dev[:, 0].contiguous()
    km_ids = _assign(km_pts, c0_dev.expand(S, KM_K, KM_D))
    rows = [
        app_kernel_row("bfs", torch.full((S, n, 1), INF, dtype=torch.int32,
                                         device="cuda"),
                       bfs_ids, bfs_vals, "min",
                       _library(bfs_ids, bfs_vals, "min", n)),
        app_kernel_row("pagerank", torch.zeros((S, n, 1), device="cuda"),
                       pr_ids, pr_vals, "add",
                       _library(pr_ids, pr_vals, "add", n)),
        app_kernel_row("kmeans sums", torch.zeros((S, KM_K, KM_D),
                                                  device="cuda"),
                       km_ids, km_pts, "add",
                       _library(km_ids, km_pts, "add", KM_K)),
        app_kernel_row("kmeans counts", torch.zeros((S, KM_K, 1),
                                                    device="cuda"),
                       km_ids, torch.ones((S, KM_B, 1), device="cuda"), "add",
                       _library(km_ids, torch.ones((S, KM_B, 1),
                                                   device="cuda"), "add",
                                KM_K))]
    # the same functions the apps call, at these inputs (bitwise for MIN)
    require(torch.equal(bfs_superstep(dist, src_sh, dst_sh)[..., None],
                        cscatter(torch.full((S, n, 1), INF, dtype=torch.int32,
                                            device="cuda"), bfs_ids, bfs_vals,
                                 kind="min")),
            "bfs_superstep differs from one cscatter of its inputs")
    # a superstep beside its cscatter call: PageRank's are all alike (the
    # run's mean); BFS's early ones scatter mostly padding, so time one at
    # the final state, every edge of the component active (the kernel
    # row's inputs)
    out["bfs eager"]["full_superstep_ms"] = time_ms(lambda: run_bfs(
        dist, src_sh, dst_sh, plan, supersteps=1), samples=5, inner=1)
    out["pagerank eager"]["full_superstep_ms"] = \
        out["pagerank eager"]["superstep_ms"]
    for key, row in (("bfs eager", rows[0]), ("pagerank eager", rows[1])):
        step_ms = out[key]["full_superstep_ms"]
        out[key]["cscatter_share"] = row["call_ms"] / step_ms
        print(f"app {key}: a superstep with every edge active {step_ms:.6f} "
              f"ms, of which a cscatter call {row['call_ms']:.6f} ms "
              f"({100 * out[key]['cscatter_share']:.1f} %)")
    out["kernel_rows"] = rows
    del src_sh, dst_sh, at
    torch.cuda.empty_cache()
    return out


def _embedding_ids():
    """One rank's ids of the train phase's first batch: TRAIN_ROWS rows of
    TRAIN_SEQ Zipf tokens, flattened (N = 1024)."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_at, data_config_for
    dcfg = data_config_for(get_config(ARCH), ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=SEED)
    tokens = batch_at(dcfg, 0)["tokens"][:TRAIN_BATCH // TRAIN_DP]
    return torch.as_tensor(tokens.reshape(-1), device="cuda")


def embedding_kernel_checks() -> float:
    """``cscatter`` at the embedding backward's shape, [V, D] = [151936,
    1024] with one rank's N = 1024 Zipf ids, bf16 (the table's dtype) and
    f32 (what the train path launches), against its plain version."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ids = _embedding_ids()
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.randn((TRAIN_V, TRAIN_D), device="cuda",
                            generator=g).to(dtype)
        vals = torch.randn((ids.numel(), TRAIN_D), device="cuda",
                           generator=g).to(dtype)
        want = cscatter_plain(table, ids, vals)
        got = cscatter(table.clone(), ids, vals)
        torch.cuda.synchronize()
        err = _compare(got, want)
        worst = max(worst, err)
        print(f"check cscatter {str(dtype)[6:]} [{TRAIN_V},{TRAIN_D}] "
              f"N={ids.numel()} add embedding-backward ids: ok (max abs err "
              f"{err})")
        del table, vals, want, got
    return worst


def embedding_kernel_times() -> list[dict]:
    """The embedding backward's ``cscatter`` timed as the other rows: the
    kernel (CUDA graph), a call, the plain version, ``index_add_`` (device
    time from a CUDA graph, and a call) and the bound in bytes."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain_
    ids = _embedding_ids()
    n = ids.numel()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.zeros((TRAIN_V, TRAIN_D), dtype=dtype, device="cuda")
        vals = torch.ones((n, TRAIN_D), dtype=dtype, device="cuda")
        lids = ids.long()
        bound, bound_by = scatter_bound_ms(ids[None], TRAIN_D,
                                           table.element_size(), r=TRAIN_V)

        def kernel():
            cscatter(table, ids, vals)

        def lib():
            table.index_add_(0, lids, vals)
        row = {"kind": "add", "what": "embedding_backward",
               "dtype": str(dtype)[6:], "shape": [TRAIN_V, TRAIN_D], "n": n,
               "ms": graph_ms(kernel), "call_ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: cscatter_plain_(table, ids, vals)),
               "library_ms": graph_ms(lib), "library_call_ms": time_ms(lib),
               "bound_ms": bound, "bound_by": bound_by}
        print(f"time cscatter add {row['dtype']} [{TRAIN_V},{TRAIN_D}] N={n} "
              f"(embedding backward): kernel {row['ms']:.6f} ms (a call "
              f"{row['call_ms']:.6f} ms), plain {row['plain_ms']:.6f} ms, "
              f"index_add_ {row['library_ms']:.6f} ms (a call "
              f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms "
              f"({bound_by})")
        rows.append(row)
        del table, vals
    return rows


def _train_argv(variant: str, n: int, ckpt_dir: str) -> list[str]:
    argv = ["--arch", ARCH, "--steps", str(n), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--warmup",
            str(TRAIN_WARMUP), "--seed", str(SEED), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(1 << 30), "--device", "cuda"]
    if variant == "eager":
        return argv + ["--merge-topology", TRAIN_PLAN]
    argv += ["--merge-topology", TRAIN_DEFER_PLAN, "--merge-defer",
             str(TRAIN_K)]
    return argv + (["--merge-overlap"] if variant == "overlapped" else [])


def _step_kind(trainer, state) -> str:
    step = trainer.deferred
    if step is None:
        return "eager"
    due, land = step.due(state), step.land_due(state)
    if due == step.schedule.num_levels:
        return "launch" if step.overlap else "commit"
    if land:
        return "land"
    return "accumulate" if due == 0 else f"commit{due}"


def _param_errs(got: dict, want: dict, lr_sum: float) -> dict:
    """The largest |got - want| over the parameter tree, and whether every
    element is within 2^-7 |want| (a bf16 rounding either way) plus
    2 * lr_sum (an AdamW step moves an element by about lr * sign(g), and
    a gradient element at rounding-noise level may take the other sign)."""
    import torch
    from torch.utils import _pytree as pytree
    worst, beyond_ulp, total, ok = 0.0, 0, 0, True
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        d = (g.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        ok = ok and bool((d <= 2 ** -7 * w.float().abs() + 2 * lr_sum).all())
        beyond_ulp += int((d > 2 ** -8 * w.float().abs()).sum())
        total += d.numel()
    return {"max_abs_err": worst, "ok": ok,
            "beyond_one_ulp_share": beyond_ulp / total,
            "bound": f"2^-7 |p| + {2 * lr_sum:.3g}"}


def _mu_err(got, want) -> dict:
    """AdamW's first moment after one step is 0.1 * the gradient, in f32:
    the largest error over each leaf's largest magnitude, held to 2^-5
    (the deferred pendings sum four bf16 gradients in bf16)."""
    from torch.utils import _pytree as pytree
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
    return {"max_rel_err": worst, "ok": worst <= 2 ** -5, "bound": 2 ** -5}


def _landing_check(state, snaps) -> dict:
    """Check 3: the overlapped run's state just after its first landing
    (step K + 1) against the deferred run's just after its first commit
    (step K): the largest |difference| of the parameters and of AdamW's
    moments, its step count, and whether all of it is equal bit for bit.
    The deferred snapshot's moments are freed: nothing later reads them."""
    import torch
    from torch.utils import _pytree as pytree
    got, want = state["opt"], snaps["opt"]

    def worst(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(pytree.tree_leaves(a),
                                   pytree.tree_leaves(b)))

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a),
                                                     pytree.tree_leaves(b)))
    out = {"params": worst(state["params"], snaps[("deferred", TRAIN_K)]),
           "mu": worst(got.mu, want.mu), "nu": worst(got.nu, want.nu),
           "count": [int(got.step), int(want.step)],
           "equal": (equal(state["params"], snaps[("deferred", TRAIN_K)])
                     and equal(got.mu, want.mu) and equal(got.nu, want.nu)
                     and int(got.step) == int(want.step) == 1)}
    snaps["opt"] = snaps["opt"]._replace(nu=None)
    return out


def profile_train_step(step_fn, state, batch) -> tuple[dict, dict]:
    """One step under ``torch.profiler``: kernel time by operator, and by
    the step's ranges: ``train.merge`` with its levels ``merge.<level>``
    and ``train.optimizer`` (the kernels of the operators inside each), and
    ``train.ranks``, the per-rank forward and backward loop, as the rest
    of the step's kernel time (the backward's operators run on autograd's
    thread, outside the range's tree of operators)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    avg = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CPU)
    by_range = {e.key: e.device_time_total / 1e3 for e in avg
                if e.key.startswith(("train.merge", "train.optimizer",
                                     "merge."))}
    by_range["train.ranks"] = (device_us / 1e3 - by_range["train.merge"]
                               - by_range["train.optimizer"])
    launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in avg
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    out = {"host_ms_traced": host_ms, "device_ms": device_us / 1e3,
           "launches": launches,
           "by_range_ms": by_range,
           "top_ops_ms": dict(ops[:12])}
    print(avg.table(sort_by="self_device_time_total", row_limit=15,
                    max_name_column_width=50))
    return out, state


def _embedding_backward_check(grads_of, params, batch) -> dict:
    """One rank's gradient of the embedding table (its rows of ``batch``)
    with the backward through the CUDA ``cscatter`` and through the plain
    version: each row to 1e-2 of its RMS (the kernel sums the row's ids in
    another order before the one bf16 rounding; the tied logits term is
    the same product in both)."""
    import torch
    from repro_torch.kernels.cscatter import cscatter_plain_
    from repro_torch.models import embedding
    shard = {k: v[:TRAIN_BATCH // TRAIN_DP] for k, v in batch.items()}
    _, got = grads_of(params, shard)
    got = got["embed"]["table"].float()

    class _Plain:
        embedding_grad_scatter = staticmethod(cscatter_plain_)
    kernel_ops, embedding.ops = embedding.ops, _Plain
    try:
        _, want = grads_of(params, shard)
    finally:
        embedding.ops = kernel_ops
    want = want["embed"]["table"].float()
    rms = want.pow(2).mean(1).sqrt()
    err = (got - want).pow(2).mean(1).sqrt()
    worst_row = float((err / rms.clamp(min=1e-30)).max())
    out = {"max_abs_err": float((got - want).abs().max()),
           "worst_row_rel_rms_err": worst_row, "row_tol": 1e-2}
    print(f"train embedding backward, CUDA cscatter vs plain, one rank's "
          f"{shard['tokens'].numel()} ids into [{TRAIN_V},{TRAIN_D}] (tied):"
          f" max |err| {out['max_abs_err']}, worst row error RMS "
          f"{worst_row:.3e} of the row's RMS (tol 1e-2)")
    require(bool((err <= 1e-2 * rms + 1e-30).all()),
            f"train: the embedding backward kernel disagrees with its plain "
            f"version: {out}")
    return out


def _logits_backward_check(table, labels: np.ndarray) -> dict:
    """The tied logits product ``h @ table.T`` with f32 output
    (``transformer._MatmulF32``) at one rank's shape, ``h`` ``[B/dp x
    seq, D]`` bf16 of unit RMS (a final rmsnorm's output): its backward
    rounds the f32 logits gradient to bf16 before both products, where the
    JAX package takes them in f32. The gradient is the cross entropy's,
    ``(softmax(logits) - onehot(labels)) / N``. Against the products of
    the f32 gradient with ``h`` and the table upcast (f32 on the CUDA
    cores, no TF32), each row of ``dh`` and of ``dtable`` to 1e-2 of its
    RMS, as the other bf16 checks; printed beside the floor, the f32
    products rounded once to bf16."""
    import torch
    from repro_torch.models.transformer import _matmul_f32
    n = TRAIN_BATCH // TRAIN_DP * TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn((n, TRAIN_D), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w = table.detach().clone().requires_grad_(True)
    logits = _matmul_f32(h, w.t())
    lab = torch.as_tensor(labels[:TRAIN_BATCH // TRAIN_DP].reshape(-1),
                          device="cuda").long()
    g = torch.softmax(logits.detach(), -1)
    g[torch.arange(n, device="cuda"), lab] -= 1.0
    g /= n
    gh, gw = torch.autograd.grad(logits, (h, w), g)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        want_h = g @ w.detach().float()
        want_w = g.t() @ h.detach().float()
    finally:
        torch.set_float32_matmul_precision(prec)
    out = {"row_tol": 1e-2}
    for name, got, want in (("dh", gh, want_h), ("dtable", gw, want_w)):
        rms = want.pow(2).mean(1).sqrt().clamp(min=1e-30)

        def worst_row(x):
            return float(((x.float() - want).pow(2).mean(1).sqrt()
                          / rms).max())
        out[name] = {"max_abs_err": float((got.float() - want).abs().max()),
                     "worst_row_rel_rms_err": worst_row(got),
                     "floor_bf16_rounding": worst_row(want.to(got.dtype))}
        print(f"train logits backward {name} {tuple(got.shape)} {got.dtype}"
              f" (bf16 gradient) vs the f32 products: max |err| "
              f"{out[name]['max_abs_err']:.3e}, worst row error RMS "
              f"{out[name]['worst_row_rel_rms_err']:.3e} of the row's RMS "
              f"(tol 1e-2; the f32 products rounded to bf16: "
              f"{out[name]['floor_bf16_rounding']:.3e})")
        require(out[name]["worst_row_rel_rms_err"] <= 1e-2,
                f"train: the logits backward {name} strays from the f32 "
                f"products: {out[name]}")
    return out


def phase_train(card: str) -> dict:
    """Training of qwen1.5-0.5b at full width and depth (bf16, tied,
    remat "dots", random weights from the seed) on the pipeline's Zipf
    stream, batch TRAIN_BATCH x TRAIN_SEQ over TRAIN_DP stacked ranks,
    AdamW under warmup_cosine(TRAIN_LR, TRAIN_WARMUP, steps), through
    ``launch/train.py``'s ``build`` (the CLI's flags): an eager run
    (TRAIN_PLAN, 4 steps), a deferred one (TRAIN_DEFER_PLAN, K =
    TRAIN_K, 9 steps: two cycles and a partial one that the flush
    settles) and the same overlapped. Checks: every loss finite; the first
    deferred cycle equals one AdamW step on the mean of its four batches'
    eagerly merged gradients (computed here from the same starting
    parameters); the overlapped run's parameters and AdamW moments after
    its first landing equal the deferred run's after its first commit, a
    step earlier, bit for bit (later cycles are printed: their first
    step's gradient is one step stale); the embedding backward through the
    CUDA ``cscatter`` equals it through the plain version; ``cscatter``
    launches equal 2 x ranks x steps (the flushes launch none). Also holds
    the f32 logits product's backward, which takes its two products in
    bf16, against the same products in f32 (``_logits_backward_check``)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.grad_merge import merge_gradients
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.core.stacked import StackedAxis
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch import steps, train
    from repro_torch.optim import warmup_cosine

    gc.collect()
    torch.cuda.empty_cache()
    runs, snaps = {}, {}
    out = {"config": {"arch": ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                      "ranks": TRAIN_DP, "eager_plan": TRAIN_PLAN,
                      "deferred_plan": TRAIN_DEFER_PLAN, "k": TRAIN_K,
                      "lr": TRAIN_LR, "warmup": TRAIN_WARMUP}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    lr = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, 2 * TRAIN_K + 1)
    try:
        for variant, n in (("eager", 4), ("deferred", 9),
                           ("overlapped", 9)):
            t = train.build(train.parse_args(_train_argv(variant, n, tmp)))
            require(t.dp == TRAIN_DP and t.cfg.remat == "dots",
                    f"train {variant}: {t.dp} ranks, remat {t.cfg.remat}")
            state, t.state = t.state, None      # the run's own reference
            batches = [batch_at(t.dcfg, i) for i in range(n)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cscatter.launches = 0
            rec = []
            for i, batch in enumerate(batches):
                kind = _step_kind(t, state)
                t0 = time.perf_counter()
                state, m = t.step_fn(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                loss = float(m["loss"])
                require(np.isfinite(loss), f"train {variant} step {i}: "
                                           f"loss {loss}")
                rec.append({"kind": kind, "ms": 1e3 * dt, "loss": loss})
                print(f"train {variant} step {i}: {kind} loss {loss:.6f} "
                      f"{1e3 * dt:.3f} ms")
                if variant == "deferred" and i + 1 in (TRAIN_K, 2 * TRAIN_K):
                    snaps[(variant, i + 1)] = pytree.tree_map(
                        torch.clone, state["params"])
                if variant == "deferred" and i + 1 == TRAIN_K:
                    snaps["opt"] = pytree.tree_map(torch.clone, state["opt"])
                if variant == "overlapped" and i == TRAIN_K:
                    landing = _landing_check(state, snaps)  # check 3
                if variant == "overlapped" and i == 2 * TRAIN_K:
                    snaps[(variant, i + 1)] = pytree.tree_map(
                        torch.clone, state["params"])
            flush_ms = None
            if t.deferred is not None:
                t0 = time.perf_counter()
                state, fm = t.deferred.flush(state)
                torch.cuda.synchronize()
                flush_ms = 1e3 * (time.perf_counter() - t0)
                require(fm is not None and fm.get("flushed_steps") == n % TRAIN_K,
                        f"train {variant}: flush {fm}")
                snaps[(variant, "final")] = state["params"]
            launches = cscatter.launches
            peak = torch.cuda.max_memory_allocated()
            want = LAUNCHES_PER_CALL * TRAIN_DP * t.microbatches * n
            require(launches == want, f"train {variant}: cscatter launched "
                                      f"{launches} times, the path predicts "
                                      f"{want}")
            by_kind = {}
            for r in rec[1:]:                         # step 0 warms up
                by_kind.setdefault(r["kind"], []).append(r["ms"])
            ms = {k: statistics.median(v) for k, v in by_kind.items()}
            if flush_ms is not None:
                ms["flush"] = flush_ms
            cycle_ms = (sum(r["ms"] for r in rec[1:2 * TRAIN_K + 1])
                        / (2 * TRAIN_K) if variant != "eager" else ms["eager"])
            runs[variant] = {
                "steps": rec, "ms_by_kind": ms, "flush_ms": flush_ms,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (cycle_ms / 1e3),
                "peak_bytes": peak, "cscatter_launches": launches,
                "cscatter_launches_predicted": want}
            print(f"train {variant} on {card}: ms a step by kind "
                  f"{ {k: round(v, 3) for k, v in ms.items()} }, "
                  f"{runs[variant]['tokens_per_s']:.1f} tokens/s, peak "
                  f"memory {peak} bytes, cscatter launches {launches} "
                  f"(predicted {want})")
            if variant == "eager":
                prof, state = profile_train_step(t.step_fn, state,
                                                 batches[-1])
                prof["idle_share"] = 1 - prof["device_ms"] / ms["eager"]
                out["profile_eager_step"] = prof
                print(f"train profile of one eager step: device "
                      f"{prof['device_ms']:.3f} ms against "
                      f"{ms['eager']:.3f} ms a step untraced (idle share "
                      f"{prof['idle_share']:.3f}), "
                      f"{prof['launches']} launches; by range (ms) "
                      f"{ {k: round(v, 3) for k, v in prof['by_range_ms'].items()} }")
            if variant == "deferred":
                model, opt, dcfg = t.model, t.optimizer, t.dcfg
                params0 = model.params()
            del t, state
            gc.collect()
            torch.cuda.empty_cache()

        # 2: the first deferred cycle against accumulated eager gradients
        axis = StackedAxis(TRAIN_DP, "cuda")
        grads_of = steps.grads_fn(model)
        acc = None
        for i in range(TRAIN_K):
            b = steps.to_device(batch_at(dcfg, i), "cuda")
            _, stack = steps.rank_grads(grads_of, params0, b, TRAIN_DP)
            merged = merge_gradients(stack, axis,
                                     topology=MergePlan.parse(TRAIN_PLAN))
            del stack
            g = pytree.tree_map(lambda x: x[0].float(), merged)
            del merged
            acc = g if acc is None else pytree.tree_map(torch.add, acc, g)
        mean = pytree.tree_map(lambda a, p: (a / TRAIN_K).to(p.dtype), acc,
                               params0)
        del acc
        ref, ref_opt, _ = opt.step(params0, mean, opt.init(params0))
        cyc = _param_errs(snaps[("deferred", TRAIN_K)], ref, float(lr(1)))
        mu = _mu_err(snaps["opt"].mu, ref_opt.mu)
        out["deferred_vs_accumulated"] = {"params": cyc, "mu": mu}
        print(f"train deferred cycle 1 vs AdamW on the mean of {TRAIN_K} "
              f"eager merges: params max |err| {cyc['max_abs_err']} (bound "
              f"{cyc['bound']}; {cyc['beyond_one_ulp_share']:.2e} of elements "
              f"beyond one bf16 ulp), mu max err {mu['max_rel_err']:.3e} of "
              f"each leaf's largest (bound {mu['bound']})")
        require(cyc["ok"] and mu["ok"], f"train: the deferred cycle is not "
                                        f"the accumulated eager step: {cyc}, "
                                        f"{mu}")
        del ref, ref_opt, mean
        # 3: the overlapped run is the deferred one, one step later. The
        # first cycle lands at step K + 1 on the same gradients, through
        # the same operations in the same order, as the deferred commit at
        # K: parameters and AdamW moments are held equal bit for bit (a
        # landing that applied nothing, part of the cycle, another scale or
        # another cycle moves the moments). From then on the overlapped
        # cycles differ by design: step K + 1's gradient is taken before
        # its landing, on the previous parameters (one step stale), so
        # later steps are printed, not held.
        stale = {f"overlapped_{TRAIN_K + 1}_vs_deferred_{TRAIN_K}": landing}
        print(f"train overlapped after step {TRAIN_K + 1} vs deferred after "
              f"step {TRAIN_K}: max |err| params {landing['params']}, mu "
              f"{landing['mu']}, nu {landing['nu']}, AdamW count "
              f"{landing['count']} (held: equal bit for bit)")
        require(landing["equal"], f"train: the first overlapped landing is "
                                  f"not the deferred commit: {landing}")
        for o, d, adamw_steps in ((2 * TRAIN_K + 1, 2 * TRAIN_K, 2),
                                  ("final", "final", 3)):
            lr_sum = sum(float(lr(j)) for j in range(1, adamw_steps + 1))
            e = _param_errs(snaps[("overlapped", o)], snaps[("deferred", d)],
                            lr_sum)
            stale[f"overlapped_{o}_vs_deferred_{d}"] = e
            print(f"train overlapped after step {o} vs deferred after step "
                  f"{d}: max |err| {e['max_abs_err']} "
                  f"({e['beyond_one_ulp_share']:.2e} beyond one bf16 ulp); "
                  f"not held: the overlapped cycle took a stale step's "
                  f"gradient")
        out["overlapped_vs_deferred"] = stale
        # 4: the embedding backward through the kernel and the plain version
        out["embedding_backward"] = _embedding_backward_check(
            grads_of, params0, steps.to_device(batch_at(dcfg, 0), "cuda"))
        out["logits_backward"] = _logits_backward_check(
            params0["embed"]["table"], batch_at(dcfg, 0)["labels"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["runs"] = runs
    out["launches"] = {k: v["cscatter_launches"] for k, v in runs.items()}
    del snaps, params0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _elastic_toy() -> dict:
    """(a) The chaos harness on the card: preempt and kill sweeps over every
    boundary of TOY_STEPS steps, without and with overlap, each outcome
    bitwise against the uninterrupted run (params, the fold count and the
    defer tree); then overlapped checkpoints at t = 4 (a launched cycle not
    landed) and t = 5 (mid-cycle) resolved onto ELASTIC_PLAN with K =
    ELASTIC_K, bitwise against the same checkpoint restored verbatim on the
    old plan and flushed."""
    import torch
    from repro_torch.runtime import DriverConfig, TrainDriver, chaos
    out = {"sweeps": {}, "resolves": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        for overlap in (False, True):
            fac = chaos.toy_factory(TRAIN_DEFER_PLAN, TOY_INTERVALS, TRAIN_DP,
                                    width=TOY_WIDTH, overlap=overlap,
                                    device="cuda")
            for mode in ("preempt", "kill"):
                name = f"{mode}{'_overlap' if overlap else ''}"
                root = os.path.join(work, name)
                t0 = time.perf_counter()
                _, outcomes = chaos.chaos_sweep(fac, TOY_STEPS, root,
                                                mode=mode)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                shutil.rmtree(root)
                actions = {}
                for o in outcomes:
                    key = str(o.resume_action)
                    actions[key] = actions.get(key, 0) + 1
                bitwise = sum(o.state_bitwise for o in outcomes)
                out["sweeps"][name] = {"outcomes": len(outcomes),
                                       "bitwise": bitwise,
                                       "resume_actions": actions, "ms": ms}
                print(f"elastic toy {name} sweep over {TOY_STEPS} boundaries "
                      f"([{TRAIN_DP}, {TOY_WIDTH}] int32 pendings on the "
                      f"card): {bitwise}/{len(outcomes)} bitwise, resumes "
                      f"{actions}, {ms:.3f} ms")
                require(bitwise == len(outcomes) == TOY_STEPS,
                        f"elastic toy {name}: {bitwise} of {len(outcomes)} "
                        f"recoveries bitwise")
        for t in (4, 5):
            root = os.path.join(work, f"resolve_{t}")
            old = chaos.toy_factory(TRAIN_DEFER_PLAN, TOY_INTERVALS, TRAIN_DP,
                                    width=TOY_WIDTH, overlap=True,
                                    device="cuda")
            step, bf, st0 = old()
            TrainDriver(DriverConfig(ckpt_dir=root, ckpt_every=t), step, bf,
                        defer_step=step).run(st0, 0, t)
            step, bf, like = old()
            oracle, _, rep = TrainDriver(DriverConfig(ckpt_dir=root), step,
                                         bf, defer_step=step).resume(like)
            require(rep.action == "verbatim", f"elastic toy t={t}: {rep}")
            oracle, _ = step.flush(oracle)
            step, bf, like = chaos.toy_factory(
                ELASTIC_PLAN, (ELASTIC_K,), TRAIN_DP, width=TOY_WIDTH,
                device="cuda")()
            t0 = time.perf_counter()
            state, start, rep = TrainDriver(DriverConfig(ckpt_dir=root), step,
                                            bf, defer_step=step).resume(like)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            shutil.rmtree(root)
            equal = (torch.equal(state["params"]["w"], oracle["params"]["w"])
                     and int(state["opt"]["count"])
                     == int(oracle["opt"]["count"]))
            fresh = int(state["defer"]["t"]) == 0 and not any(
                bool(p["w"].any()) for p in state["defer"]["pending"])
            out["resolves"][t] = {"report": rep.as_dict(), "ms": ms,
                                  "seconds": rep.seconds, "equal": equal}
            print(f"elastic toy resolve of the overlapped t={t} checkpoint "
                  f"onto {ELASTIC_PLAN} K={ELASTIC_K}: landed_inflight "
                  f"{rep.landed_inflight}, flushed_steps {rep.flushed_steps}, "
                  f"params and count == the verbatim restore flushed: "
                  f"{equal}; {ms:.3f} ms")
            require(rep.action == "resolved" and start == t
                    and rep.landed_inflight == (t == 4)
                    and rep.flushed_steps == t % TOY_INTERVALS[-1]
                    and (rep.k_old, rep.k_new) == (TOY_INTERVALS[-1],
                                                   ELASTIC_K),
                    f"elastic toy resolve t={t}: {rep}")
            require(equal and fresh, f"elastic toy resolve t={t}: params "
                                     f"equal {equal}, fresh defer {fresh}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def train_crash_child(root: str) -> None:
    """The killed run of :func:`phase_elastic`, in its own process: the
    deferred qwen1.5-0.5b trainer of ``phase_train`` under ``TrainDriver``
    with ``defer_save="checkpoint"``, a checkpoint every RESUME_CKPT steps
    under ``root`` and its log beside it; ``batch_fn(RESUME_KILL_AT)``
    starts a timer that SIGKILLs the process during that step."""
    import threading
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import train
    from repro_torch.runtime import DriverConfig, TrainDriver

    t = train.build(train.parse_args(_train_argv("deferred", RESUME_STEPS,
                                                 root)))
    state, t.state = t.state, None
    torch.cuda.reset_peak_memory_stats()

    def batch_fn(i):
        if i == RESUME_KILL_AT:
            threading.Timer(KILL_DELAY_S, os.kill,
                            (os.getpid(), signal.SIGKILL)).start()
        return batch_at(t.dcfg, i)

    def step_fn(s, b):
        t0 = time.perf_counter()
        s, m = t.step_fn(s, b)
        torch.cuda.synchronize()
        print(f"step {int(s['defer']['t']) - 1}: loss {float(m['loss']):.6f}"
              f" {1e3 * (time.perf_counter() - t0):.3f} ms, peak "
              f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
        return s, m

    drv = TrainDriver(DriverConfig(ckpt_dir=root, ckpt_every=RESUME_CKPT,
                                   log_path=root + ".log.jsonl",
                                   defer_save="checkpoint"),
                      step_fn, batch_fn, defer_step=t.deferred)
    drv.run(state, 0, RESUME_STEPS)
    raise SystemExit("train crash child: the kill did not fire")


def _part_peaks(drv) -> dict:
    """Wrap ``drv``'s log: at each ``elastic_part`` record (a part of a
    restore has ended), the device's peak allocated bytes since the last
    one is the part's; then the peak is reset. Reset it before the
    restore."""
    import torch
    peaks, log = {}, drv._log

    def logged(rec):
        log(rec)
        if rec.get("event") == "elastic_part":
            part = rec["part"]
            peaks[part] = max(peaks.get(part, 0),
                              torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
    drv._log = logged
    return peaks


def _resume(trainer, root: str) -> tuple:
    """``TrainDriver.resume`` of ``trainer``'s state from ``root`` -> (state,
    start, report, ms of the whole resume, peak bytes by part)."""
    import torch
    from repro_torch.runtime import DriverConfig, TrainDriver
    drv = TrainDriver(DriverConfig(ckpt_dir=root), trainer.step_fn, None,
                      defer_step=trainer.deferred)
    peaks = _part_peaks(drv)
    like, trainer.state = trainer.state, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, start, report = drv.resume(like)
    torch.cuda.synchronize()
    return state, start, report, 1e3 * (time.perf_counter() - t0), peaks


def _row_rms_err(got, want) -> float:
    """The worst row's error RMS over the row's RMS (a 1-D leaf is one
    row)."""
    g = got.float().reshape(got.shape[0] if got.dim() > 1 else 1, -1)
    w = want.float().reshape(g.shape)
    rms = w.pow(2).mean(1).sqrt()
    err = (g - w).pow(2).mean(1).sqrt()
    return float((err / rms.clamp(min=1e-30)).max())


def _settled_check(raw: dict, saved: dict, m: int) -> dict:
    """The settled gradient of each parameter leaf as the resolved restore
    folds it (``elastic.settle_pending_leaves`` on the card, scaled by
    1/(dp_old m) in the leaf's dtype) against the same sum in f32: the
    stride representatives of every level over the ranks, times 1/(dp_old
    m). Every row to 1e-2 of its RMS."""
    import torch
    from repro_torch.core.merge_functions import ADD
    from repro_torch.runtime.elastic import settle_pending_leaves
    strides, scale = saved["strides"], 1.0 / (saved["dp"] * m)
    rests = [k[len("params/"):] for k in raw if k.startswith("params/")]
    worst, worst_abs = 0.0, 0.0
    for r in rests:
        levels = [raw[f"defer/pending/{i}/{r}"] for i in range(len(strides))]
        got = settle_pending_leaves([[x] for x in levels], strides, ADD,
                                    device="cuda")[0]
        got = got * torch.tensor(scale, dtype=got.dtype)
        want = sum(torch.as_tensor(x).to("cuda")[::s].float().sum(0)
                   for x, s in zip(levels, strides)) * scale
        worst = max(worst, _row_rms_err(got, want))
        worst_abs = max(worst_abs, float((got.float() - want).abs().max()))
        del got, want
    return {"worst_row_rel_rms_err": worst, "max_abs_err": worst_abs,
            "row_tol": 1e-2, "ok": worst <= 1e-2, "leaves": len(rests)}


def _elastic_lm(card: str, work: str) -> dict:
    """(b) qwen1.5-0.5b at full width and depth, killed and resumed twice.
    See :func:`phase_elastic`."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime import rescale_hyperparams

    out = {}
    root = os.path.join(work, "ckpt")
    p = get_config(ARCH).n_params()
    need = p * (2 + 8 + 2 * TRAIN_DP * 2)      # bf16 params, f32 mu and nu,
    free = shutil.disk_usage(work).free          # two [dp, ...] bf16 levels
    out["disk_free_before_save"] = free
    print(f"elastic: {free} bytes free in the checkpoint directory before "
          f"the save; the checkpoint needs about {need}")
    require(free >= 1.05 * need, f"elastic: {free} bytes free, the "
                                 f"checkpoint needs about {need}")
    # 1. the child, killed during step RESUME_KILL_AT
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--train-crash-child", root], capture_output=True,
                           text=True, timeout=900)
    out["child_s"] = time.perf_counter() - t0
    print("\n".join(f"elastic child: {ln}" for ln in
                    child.stdout.splitlines() if ln.startswith("step ")))
    require(child.returncode == -signal.SIGKILL,
            f"elastic child: return code {child.returncode}, want "
            f"{-signal.SIGKILL}: {child.stderr[-3000:]}")
    require(ckpt.latest_step(root) == RESUME_CKPT,
            f"elastic child: latest committed step "
            f"{ckpt.latest_step(root)}, want {RESUME_CKPT}")
    path = os.path.join(root, f"step_{RESUME_CKPT:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        extras = json.load(f)["extras"]
    saved = extras.get("defer")
    require(saved is not None and saved["dp"] == TRAIN_DP
            and saved["period"] == TRAIN_K and extras["defer_t"] == RESUME_CKPT
            and extras["next_step"] == RESUME_CKPT,
            f"elastic child: the checkpoint's extras {extras}")
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    with open(root + ".log.jsonl") as f:
        log = [json.loads(ln) for ln in f]
    at = {e["event"]: e["t"] for e in log if e.get("step") == RESUME_CKPT
          and e["event"] in ("defer_save", "checkpoint")}
    save_ms = 1e3 * (at["checkpoint"] - at["defer_save"])
    out.update(checkpoint_bytes=nbytes, save_ms=save_ms,
               child_return_code=child.returncode)
    print(f"elastic: child killed (return code {child.returncode}) during "
          f"step {RESUME_KILL_AT} after {out['child_s']:.6f} s; checkpoint "
          f"of step {RESUME_CKPT}: {nbytes} bytes, saved in {save_ms:.6f} ms "
          f"(the child's log); manifest dp {saved['dp']} period "
          f"{saved['period']} strides {saved['strides']}")

    t0 = time.perf_counter()
    raw, _ = ckpt.load_raw(root)
    out["load_raw_ms"] = 1e3 * (time.perf_counter() - t0)
    cscatter.launches = 0
    # 2. verbatim, under the same flags
    t = train.build(train.parse_args(_train_argv("deferred", RESUME_STEPS,
                                                 root)))
    state, start, report, ms, peaks = _resume(t, root)
    differ = [k for k, v in _flatten_with_paths(state)
              if not torch.equal(v, torch.as_tensor(raw[k]).to(v.device))]
    n_leaves = len(_flatten_with_paths(state))
    require(report.action == "verbatim" and start == RESUME_CKPT
            and int(state["defer"]["t"]) == RESUME_CKPT,
            f"elastic verbatim: {report.as_dict()}, start {start}")
    require(n_leaves == len(raw) and not differ,
            f"elastic verbatim: {n_leaves} leaves against {len(raw)} stored, "
            f"{len(differ)} differ from load_raw's: {differ[:5]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, fm = t.deferred.flush(state)
    torch.cuda.synchronize()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    require(fm is not None and fm.get("flushed_steps") == RESUME_CKPT % TRAIN_K,
            f"elastic verbatim: flush {fm}")
    out["verbatim"] = {"report": report.as_dict(), "seconds": report.seconds,
                       "ms": ms, "peak_bytes": peaks, "flush_ms": flush_ms,
                       "flush_peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"elastic verbatim resume: start {start}, defer t {RESUME_CKPT}, "
          f"{n_leaves} leaves == load_raw's bit for bit; {ms:.6f} ms (seconds "
          f"by part {report.seconds}; peak bytes by part {peaks}); flush of "
          f"{fm['flushed_steps']} steps {flush_ms:.6f} ms")
    oracle = {"params": state["params"], "opt": state["opt"]}
    lr = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, RESUME_STEPS)
    del state, t
    gc.collect()
    torch.cuda.empty_cache()

    # 3. resolved: a pod left (4 ranks) and K was re-solved
    argv = _train_argv("deferred", RESUME_STEPS, root)
    argv[argv.index("--merge-topology") + 1] = RESUME_PLAN
    argv[argv.index("--merge-defer") + 1] = str(RESUME_K)
    t = train.build(train.parse_args(argv))
    require(t.dp == RESUME_RANKS, f"elastic resolved: {t.dp} ranks")
    state, start, report, ms, peaks = _resume(t, root)
    pend = pytree.tree_leaves(state["defer"]["pending"])
    fresh = (int(state["defer"]["t"]) == 0 and len(state["defer"]["pending"])
             == 1 and all(x.shape[0] == RESUME_RANKS and not bool(x.any())
                          for x in pend))
    count = [int(state["opt"].step), int(oracle["opt"].step)]
    out["resolved"] = {"report": report.as_dict(), "seconds": report.seconds,
                       "ms": ms, "peak_bytes": peaks, "fresh_defer": fresh,
                       "adamw_count": count}
    print(f"elastic resolved resume onto {RESUME_PLAN} ({RESUME_RANKS} "
          f"ranks, K={RESUME_K}): {report.as_dict()}, start {start}; fresh "
          f"defer state {fresh}; AdamW count {count[0]} (oracle {count[1]}); "
          f"{ms:.6f} ms (seconds by part {report.seconds}; peak bytes by "
          f"part {peaks})")
    require(report.action == "resolved" and start == RESUME_CKPT
            and report.flushed_steps == RESUME_CKPT % TRAIN_K
            and not report.landed_inflight
            and (report.k_old, report.k_new) == (TRAIN_K, RESUME_K),
            f"elastic resolved: {report.as_dict()}")
    require(fresh and count[0] == count[1],
            f"elastic resolved: fresh defer {fresh}, AdamW count {count}")

    # 4. the mass
    settled = _settled_check(raw, extras["defer"], RESUME_CKPT % TRAIN_K)
    del raw
    gc.collect()
    params = _param_errs(state["params"], oracle["params"], float(lr(count[1])))
    mu = _mu_err(state["opt"].mu, oracle["opt"].mu)
    nu = _mu_err(state["opt"].nu, oracle["opt"].nu)
    base, _ = ckpt.restore_resharded(
        root, {"params": state["params"], "opt": state["opt"]}, "cuda")
    control = {"mu": _mu_err(base["opt"].mu, oracle["opt"].mu),
               "nu": _mu_err(base["opt"].nu, oracle["opt"].nu),
               "params": _param_errs(base["params"], oracle["params"],
                                     float(lr(count[1])))}
    del base
    out["mass"] = {"settled": settled, "params": params, "mu": mu, "nu": nu,
                   "control_pendings_dropped": control}
    print(f"elastic mass: settled gradient ({settled['leaves']} leaves) vs "
          f"the f32 sum of the raw pendings' representatives: worst row "
          f"error RMS {settled['worst_row_rel_rms_err']:.3e} of the row's "
          f"RMS (tol 1e-2), max |err| {settled['max_abs_err']:.3e}; params "
          f"vs the verbatim restore flushed: max |err| "
          f"{params['max_abs_err']} (bound {params['bound']}, "
          f"{params['beyond_one_ulp_share']:.2e} beyond one bf16 ulp); mu "
          f"max err {mu['max_rel_err']:.3e}, nu {nu['max_rel_err']:.3e} of "
          f"each leaf's largest (bound {mu['bound']})")
    print(f"elastic control (the pendings dropped: params and AdamW restored "
          f"alone): mu max err {control['mu']['max_rel_err']:.3e}, nu "
          f"{control['nu']['max_rel_err']:.3e} of each leaf's largest (bound "
          f"{mu['bound']}, must fail), params max |err| "
          f"{control['params']['max_abs_err']}")
    require(settled["ok"], f"elastic: the settled gradient strays: {settled}")
    require(params["ok"] and mu["ok"] and nu["ok"],
            f"elastic: the resolved state is not the flushed one: {params}, "
            f"mu {mu}, nu {nu}")
    require(not control["mu"]["ok"],
            f"elastic: the check cannot see dropped pendings: {control}")
    del oracle
    gc.collect()
    torch.cuda.empty_cache()

    # 5. it trains on, at the rescaled hyperparameters
    h = rescale_hyperparams(TRAIN_K, RESUME_K, lr=TRAIN_LR)
    opt = adamw(warmup_cosine(h["lr"], TRAIN_WARMUP, RESUME_STEPS),
                b1=h["b1"], b2=h["b2"])
    step_fn = steps.make_train_step(
        t.model, t.cfg, opt, t.microbatches, dp=t.dp, merge_topology=t.topology,
        defer_schedule=t.schedule)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(RESUME_CKPT, RESUME_CKPT + 2):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch_at(t.dcfg, i))
        torch.cuda.synchronize()
        losses.append((float(m["loss"]), 1e3 * (time.perf_counter() - t0)))
    launches = cscatter.launches
    want = LAUNCHES_PER_CALL * RESUME_RANKS * t.microbatches * 2
    out["train_on"] = {"hyperparams": h, "losses_ms": losses,
                       "peak_bytes": torch.cuda.max_memory_allocated()}
    out["launches"] = launches
    print(f"elastic: 2 steps on {RESUME_RANKS} ranks at lr {h['lr']} b1 "
          f"{h['b1']:.6f} b2 {h['b2']:.6f} (rescale_hyperparams({TRAIN_K}, "
          f"{RESUME_K})): loss, ms {losses}; cscatter launches {launches} "
          f"(predicted {want})")
    require(all(np.isfinite(x) for x, _ in losses),
            f"elastic: losses {losses}")
    require(launches == want, f"elastic: cscatter launched {launches} times, "
                              f"the path predicts {want}")
    del state, t, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_elastic(card: str) -> dict:
    """Elastic restore and the chaos harness on the card: (a) the integer
    toy's sweeps and resolves (:func:`_elastic_toy`); (b) the deferred
    qwen1.5-0.5b run of ``phase_train`` at full width and depth killed by a
    real SIGKILL in a child process (:func:`train_crash_child`) after its
    checkpoint of step RESUME_CKPT, then resumed through
    ``TrainDriver.resume`` on the same topology (verbatim: every leaf bit
    for bit, then flushed: the oracle) and on RESUME_PLAN with K =
    RESUME_K (resolved: the outstanding two steps settled into the params
    and AdamW, fresh defer state). Checks: the settled gradient against an
    f32 sum of the raw pendings, the params, mu and nu against the oracle,
    a control with the pendings dropped that must fail the mu bound, two
    more steps at ``rescale_hyperparams``' lr with finite losses and the
    predicted ``cscatter`` launches."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    out = {"toy": _elastic_toy()}
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        out["lm"] = _elastic_lm(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = out["lm"]["launches"]
    return out


def main_stream() -> tuple[np.ndarray, np.ndarray]:
    """The main path's stream from the seed: ``TICKS * S * B`` Pareto keys
    (flat) and their values ``[TICKS, S, B, D]``."""
    from repro_torch.launch.kv_serve import key_stream
    stream = key_stream(TICKS * S * B, R, "pareto", n_users=USERS, seed=SEED)
    vals = np.random.default_rng(SEED).integers(
        1, 9, (TICKS, S, B, D)).astype(np.int32)
    return stream, vals


def timed(name: str, fn, *args):
    """``fn(*args)``, printing the phase's host-clock seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def main() -> None:
    if sys.argv[1:2] == ["--crash-child"]:      # phase_durability's child
        sys.path.insert(0, str(ROOT / "src"))
        crash_child(sys.argv[2])
    if sys.argv[1:2] == ["--train-crash-child"]:    # phase_elastic's child
        sys.path.insert(0, str(ROOT / "src"))
        train_crash_child(sys.argv[2])
    kind, smi = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    timed("build", phase_build)
    stream, vals = main_stream()
    worst = timed("kernel_checks", phase_kernel_checks, stream)
    determinism = timed("determinism", phase_determinism)
    worst_merge = timed("cmerge_checks", phase_cmerge_checks)
    times = timed("kernel_times", phase_kernel_times, stream)
    merge_times = timed("cmerge_times", phase_cmerge_times)
    keys = stream.reshape(TICKS, S, B)
    main_path = timed("stores", phase_stores, keys, vals)
    schedules = timed("schedules", phase_schedules)
    durability = timed("durability", phase_durability, keys, vals)
    blocked_path = timed("blocked_stores", phase_blocked_stores, keys, vals)
    timed("frontend", phase_frontend, stream)
    worst_attn = timed("attention_checks", phase_attention_checks)
    attn_times = timed("attention_times", phase_attention_times)
    serve = timed("serve", phase_serve, smi)
    apps = timed("apps", phase_apps, smi)
    trained = timed("train", phase_train, smi)
    elastic = timed("elastic", phase_elastic, smi)
    families = timed("families", phase_families, smi)

    tick_add = next(t for t in times if t["kind"] == "add" and t["n"] == B
                    and "what" not in t)
    train_add = next(t for t in times if t.get("what") == "embedding_backward"
                     and t["dtype"] == "float32")
    evict_add = next(t for t in merge_times
                     if t["kind"] == "add" and t["what"] == "evict")
    print(json.dumps({"kernels": [{
        "name": "cscatter", "route": "cuda",
        "source": "src/repro_torch/csrc/cscatter.cu",
        "replaces": REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": worst["int"],
        "max_abs_err_float": worst["float"],
        "matched": True,
        "ms": tick_add["ms"], "kernel_ms": tick_add["ms"],
        "call_ms": tick_add["call_ms"],
        "plain_ms": tick_add["plain_ms"],
        "bound_ms": tick_add["bound_ms"],
        "bound_us": 1e3 * tick_add["bound_ms"],
        "bound_by": tick_add["bound_by"],
        "library_ms": tick_add["library_ms"],
        "library_call_ms": tick_add["library_call_ms"],
        "launches_apps": {k: v["launches"] for k, v in apps.items()
                          if isinstance(v, dict) and "launches" in v},
        "launches_schedules": schedules["launches"],
        "launches_durability": durability["launches"],
        "launches_train": trained["launches"],
        "launches_elastic": elastic["launches"],
        "launches_families": families["chaos"]["cscatter_launches"],
        "determinism": determinism,
        "train_embedding_backward": train_add,
        "variants": times, "apps": apps["kernel_rows"]}, {
        "name": "cmerge", "route": "cuda",
        "source": "src/repro_torch/csrc/cmerge.cu",
        "replaces": REPLACES_CMERGE,
        "launches": blocked_path["cmerge"],
        "max_abs_err": worst_merge["int"],
        "max_abs_err_float": worst_merge["float"],
        "matched": True,
        "ms": evict_add["ms"], "kernel_ms": evict_add["ms"],
        "call_ms": evict_add["call_ms"],
        "plain_ms": evict_add["plain_ms"],
        "bound_ms": evict_add["bound_ms"],
        "bound_us": 1e3 * evict_add["bound_ms"],
        "bound_by": evict_add["bound_by"],
        "library_ms": evict_add["library_ms"],
        "library_call_ms": evict_add["library_call_ms"],
        "variants": merge_times}] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": serve["launches"][name],
        "launches_families": {k: families[k]["launches"][name]
                              for k in ("hymba", "gelu")},
        "launches_windowed_families": families["hymba"]["launches"][
            "flash_attention_windowed"],
        "max_abs_err": worst_attn["bfloat16"],
        "max_abs_err_f32": worst_attn["float32"],
        "worst_row_rel_err": worst_attn["row_bfloat16"],
        "matched": True,
        "ms": row["ms"], "kernel_ms": row["ms"],
        "call_ms": row["call_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_us": 1e3 * row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_call_ms": row["library_call_ms"],
        "variants": attn_times[key]}
        for name, replaces, key in (
            ("flash_attention", REPLACES_FLASH, "flash"),
            ("decode_attention", REPLACES_DECODE, "decode"))
        for row in attn_times[key][:1]], "serve": serve,
        "apps": {k: v for k, v in apps.items() if k != "kernel_rows"},
        "schedules": schedules, "durability": durability,
        "train": trained, "elastic": elastic,
        "families": {k: {x: y for x, y in v.items() if x != "profile"}
                     for k, v in families.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
