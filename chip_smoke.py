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
resume after a kill onto another rank count, the xLSTM and Hymba
families (hymba-1.5b and xlstm-125m served, xlstm-125m trained, killed
and resumed bit for bit; hymba-1.5b trained at full width and depth
through the selective scan's CUDA kernels), the encoder-decoder
(seamless-m4t-medium served and trained) and the MoE and VLM families
(qwen3-moe-235b and llava-next-34b served at full width, qwen3-moe-235b
trained at full width through the expert-parallel MoE layer, kimi-k2-1t's
smoke config) — and:

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
   launches (``DET_STREAMS``); holds the selective scan (``phase_scan``:
   hymba-1.5b's SSM, a kernel with no Pallas original) against its plain
   version at the prefill shape ``[8, 2048, 3200]`` (forward), one training
   rank's ``[2, 2048, 3200]`` (forward and backward), a ragged one (T = 2
   chunks and 3 steps, D = 100) and a smoke shape at S = 4, u in f32 and
   bf16: y and h_T to 1e-5 of their largest
   magnitude, every gradient to 1e-4 of its own, two backward calls
   bitwise; times it (warm, cold, a call, plain) beside its bound;
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
   at hymba-1.5b's ring and global caches (G = 5), seamless-m4t-medium's
   bidirectional encoder (S = T = 128) and cross-attention (S = 512, T =
   128) and its decode over the cross cache of 128 slots,
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
11. trains qwen1.5-0.5b at full width, 12 of its 24 layers (bf16, remat
   "dots", random weights from the seed) through ``launch/train.py`` on the
   data pipeline's Zipf stream, batch 16 x 512 over 8 stacked ranks: 4 eager
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
   the embedding backward's shapes ([151936, 1024] and seamless-m4t-medium's
   [256256, 1024], N = 1024, bf16 and f32) beside ``index_add_``;
12. runs the chaos harness and elastic restore on the card: the integer
   toy's preempt and kill sweeps over every boundary of 6 steps (``[8,
   2^20]`` int32 pendings, without and with overlap) bitwise against the
   uninterrupted run, and resolves of overlapped toy checkpoints at t = 4
   and 5 onto another plan bitwise against a verbatim restore flushed;
   then kills the deferred qwen1.5-0.5b run of 11 (full width, 6 of its 24
   layers, K = 4 over 8 ranks) by SIGKILL in a child process (this script
   with ``--train-crash-child``) after its checkpoint of step 6 (about 10
   GB),
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
   29 with the window of 1024, 32 ``selective_scan`` calls, and a
   ``decode_attention`` call a layer a step over the windowed layers'
   rings and the global layers' caches), held against the same tokens
   teacher-forced through the plain attention and the plain scan; (j)
   trains hymba-1.5b at full width and depth (bf16, remat "dots", batch 4
   x 2048 over chip:2's 2 stacked ranks, AdamW): 2 eager steps and 5
   deferred ones with K = 2, every loss finite, the first deferred cycle
   equal to AdamW on the mean of its two batches' eager merges, launches
   of ``cscatter`` (2 x ranks x steps) and of the scan (2 x 32 forward
   calls and 32 backward calls a rank and a step, ``LAUNCHES_PER_CALL``
   launches each) as predicted, one rank's gradient
   through the scan kernels against the plain scan's in f32; ms a step
   by kind, tokens/s, peak memory, the profiler's idle share of an eager
   step; serves xlstm-125m at full width (batch 8, prompts of 256, 257
   tokens), its recurrent decode held against one chunkwise forward
   over the 512 tokens; serves the GELU MLP (``DecoderLM`` at granite-34b's
   smoke config with ``mlp="gelu"``) against its plain path; each with a
   traced prefill and decode step; then runs the real-model chaos at full
   width (xlstm-125m, 4 of the example's 5 steps of batch 8 x 32 over 8
   stacked ranks, an overlapped K = 2 commit, a checkpoint every step):
   the twin twice, bitwise equal to itself in every leaf, a kill before
   step 2 resumed and flushed bitwise equal to the twin, a control with
   fresh defer state that must differ, ``cscatter`` launches = 2 x 8 x
   steps;
   then serves seamless-m4t-medium at full width (bf16, batch 8, prompts
   of 512 with frames [8, 128, 1024], 64 tokens: 36 ``flash_attention``
   launches at prefill, 24 of them bidirectional (the 12 encoder layers
   and the 12 cross-attentions, S = 512 against T = 128), all bf16_mma;
   3024 ``decode_attention`` launches, self and cross a layer a step),
   held against the same weights in f32 through the plain attention, and
   trains it 2 eager steps (batch 4 x 512 over 2 stacked ranks, AdamW):
   losses finite, 8 ``cscatter`` launches into the [256256, 1024] f32
   embedding gradient, held to the plain version's; then serves
   qwen3-moe-235b at full width, depth cut to 5 of 94 layers (bf16, batch
   8, prompts of 512, 64 tokens: each MoE layer's token combine through
   ``cscatter``, 640 launches; 5 flash launches at G = 16; 630
   ``decode_attention`` launches, its GMAX = 16 configuration), held to
   its f32 twin on the row-steps that every path routed alike (at least
   half of them; the share of flipped assignments printed); (k) trains
   qwen3-moe-235b at full width, 1 of 94 layers (bf16, remat "full",
   batch 2 x 2048 over chip:2's 2 stacked data ranks, ``--model-ranks
   4``: the MoE layer through ``moe_ep.apply_ep`` over 4 stacked model
   ranks, its combine one ``cscatter`` call over a [4, 2048, 4096] stack;
   ``--donate``: AdamW in place) 3 eager steps: losses finite, 36
   ``cscatter`` launches as predicted, no attention kernel, the peak
   memory, ms a step, the router's metrics, a profiled step's idle share
   and top operations; then one rank's f32 gradient through the kernel
   path against ``moe.apply`` with the plain combine (loss 1e-5, each
   leaf's error RMS 1e-3 of its RMS); at the smoke configs kimi-k2-1t's
   expert-parallel steps (Adafactor) against ``moe.apply``'s (1e-5 in
   f32), qwen3-moe-235b deferred K = 2 against the accumulated eager
   merges, and the donating optimizer bit for bit against the functional
   one; and llava-next-34b's backbone at full width, 24 of 60 layers, prefilled
   from embeds [8, 640, 7168] (576 seeded patch rows, then 64 prompt
   tokens' table rows), 64 tokens (24 flash launches at G = 7, 3024
   decode launches), held to its f32 twin on every row; and
   kimi-k2-1t's smoke config (a shared expert, a dense first layer) in
   f32, its kernel path against the plain attention and the plain
   combine: logits within 1e-4, the same expert ids; the combine's
   ``cscatter`` is also checked and timed at the prefill ([4096, 4096]
   bf16, N = 32768), decode ([8, 4096], N = 64) and expert-parallel train
   ([4, 2048, 4096], N = 16384 a shard) shapes beside ``index_add_``
   (warm and cold), and the attention kernels at G = 16 and G = 7;
14. (``phase_pipeline``) runs the GPipe schedule
   (``repro_torch.sharding.pipeline_apply``) over 4 stacked stages, each
   one consecutive decoder layer of a full-width qwen1.5-0.5b (bf16,
   random weights from the seed) through ``DecoderLM._block_prefill``,
   its attention the CUDA ``flash_attention``: 8 microbatches of 4 x 512
   tokens from the embedding, 11 ticks; the last stage's outputs bitwise
   against the same 4 layers run serially through the same function (each
   stage runs on its own slice, so the products see the same shapes);
   ``flash_attention`` launches (4 stages x 11 ticks, all bf16_mma); ms of
   the pipeline and of the serial run, their ratio beside the schedule's
   (n_micro + S - 1) / n_micro;
15. (``phase_lint``) runs the static verifier in-process, ``python -m
   repro_torch.analysis --device cuda`` (merges, configs, apps and the
   serve sweep on the card: every tick of 7 serving stores through the
   CUDA ``cscatter``, the blocked ones through ``cmerge``): any
   unsuppressed diagnostic fails the run; then the seeded fixtures on the
   card, each of which must trip its code. Before the sweep it holds
   ``cscatter`` and ``cmerge`` to their plain versions at the sweep's
   shapes; around the sweep it zeroes their counts and requires
   LINT_LAUNCHES. Prints the sites swept, the seconds and the launches;
16. prints every kernel's registers and spills (``ptxas -v``),
   one ``{"kernels": [...]}`` line and the card's name and power limit;
17. ends with ``{"ok": true, "device": {...}}``.

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
# exponentials (MUFU.EX2, one an expf) a second: 16 a clock on each of the
# 132 SMs (CUDA's throughput table, compute capability 9.0) at the H100
# SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
REPLACES_SCAN = ("no Pallas original: src/repro/models/ssm.py:75 "
                 "(_scan_chunk, jax.lax.associative_scan; with _ssm_params "
                 ":63 and the einsum of apply_seq :107)")
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
# the real-model chaos at full width: 4 steps (the example runs 5; cut to
# keep the script inside its time: one overlapped K = 2 launch at step 2
# and its landing at step 3 remain), a kill before step 2 (the example's
# --quick point). A kill before step 3 as well, the other side of an
# overlapped landing, passed too but took the phase past its budget: every
# run saves a 7.1 GB checkpoint a step, 8.5-12.2 s each (NVIDIA H100 80GB
# HBM3, 700.00 W); the CPU tests kill before each of steps 1-4 of 5
CHAOS_STEPS, CHAOS_KILLS = 4, (2,)
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
# Training: qwen1.5-0.5b at full width, TRAIN_LAYERS of its 24 layers, batch
# 16 x 512 over 8 stacked data-parallel ranks (2 rows a rank); eager over
# TRAIN_PLAN, deferred over TRAIN_DEFER_PLAN with K = TRAIN_K on both
# deferred levels. The step is host-bound (~50k launches at 24 layers,
# 2.7-5.5 s a step on NVIDIA H100 80GB HBM3, 700.00 W machines), and half
# the depth keeps the script inside its time
TRAIN_BATCH, TRAIN_SEQ, TRAIN_DP, TRAIN_LAYERS = 16, 512, 8, 12
TRAIN_PLAN = "chip:2,host:2,pod:2"
TRAIN_DEFER_PLAN = "chip:2,host:2:defer,pod:2:defer"
TRAIN_K, TRAIN_LR, TRAIN_WARMUP = 4, 3e-4, 2
TRAIN_V, TRAIN_D = 151936, 1024     # the embedding table, [vocab, d_model]
# seamless-m4t-medium (encoder-decoder): served at full width, batch
# FAMILY_BATCH, prompts of ENCDEC_PROMPT ids with enc_len(512) = 128 frames
# (ENCDEC_FRAMES), ENCDEC_GEN greedy tokens; trained ENCDEC_TRAIN_STEPS
# eager steps of ENCDEC_TRAIN_BATCH x TRAIN_SEQ over ENCDEC_TRAIN_PLAN's
# ENCDEC_TRAIN_DP stacked ranks. Its tied table is [256256, 1024] (vocab
# 256206 padded).
ENCDEC = "seamless-m4t-medium"
ENCDEC_PROMPT, ENCDEC_GEN, ENCDEC_FRAMES = 512, 64, 128
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS = 4, 2
ENCDEC_TRAIN_PLAN, ENCDEC_TRAIN_DP = "chip:2", 2
ENCDEC_V = 256256
# hymba-1.5b trained at full width and depth (bf16, remat "dots", random
# weights from the seed) on the pipeline's Zipf stream: batch
# HYMBA_TRAIN_BATCH x HYMBA_TRAIN_SEQ (past the window of 1024) over
# HYMBA_TRAIN_PLAN's 2 stacked ranks, 2 rows a rank (JAX's train_4k cell is
# 256 x 4096): HYMBA_TRAIN_EAGER eager steps, then HYMBA_TRAIN_DEFERRED
# deferred ones over HYMBA_TRAIN_DEFER_PLAN with K = HYMBA_TRAIN_K (two
# cycles and a partial one that the flush settles), AdamW under
# warmup_cosine(TRAIN_LR, TRAIN_WARMUP, steps)
HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_DP = 4, 2048, 2
HYMBA_TRAIN_PLAN, HYMBA_TRAIN_DEFER_PLAN = "chip:2", "chip:2:defer"
HYMBA_TRAIN_K, HYMBA_TRAIN_EAGER, HYMBA_TRAIN_DEFERRED = 2, 2, 5
# the selective scan's calls a layer, a rank and a step of that run, the
# prediction written down before the first run on the card: under remat
# "dots" the forward runs in the forward and again in the backward's
# recompute (the scan is no product), the backward once
HYMBA_SCAN_CALLS = {"forward": 2, "backward": 1}
# the selective scan held to its plain version: (what, B, T, D, S, u's
# dtype, backward too): hymba-1.5b's prefill (its 32 calls' shape), one
# training rank's, a ragged one (T = 2 L + 3 for the kernels' chunk L =
# selective_scan.SEGMENT = 64, a partial CTA of channels), the smoke
# config's d_inner at S = 4 over a ragged T, and small steps ("small_dt":
# dt = softplus(normal - 5), about 0.007, as a trained Mamba-style model's
# 1e-3 to 1e-1) at the training shape and ragged ones. At the init's dt of
# about 0.8 a chunk's decay product is below 1e-15, so only the small-dt
# rows hold the carry of the start state over chunks to the tolerance.
# The plain backward at the training shape takes ~15 GB; at the prefill
# shape it would take ~60 GB, so the prefill shape is checked forward only.
SCAN_SHAPES = [("prefill", 8, 2048, 3200, 16, "bfloat16", False),
               ("prefill", 8, 2048, 3200, 16, "float32", False),
               ("train", 2, 2048, 3200, 16, "bfloat16", True),
               ("train", 2, 2048, 3200, 16, "float32", True),
               ("ragged", 2, 131, 100, 16, "bfloat16", True),
               ("smoke", 2, 300, 128, 4, "float32", True),
               ("smoke", 2, 300, 128, 4, "bfloat16", True),
               ("small_dt", 2, 2048, 3200, 16, "bfloat16", True),
               ("small_dt", 2, 131, 100, 16, "float32", True),
               ("small_dt", 2, 300, 128, 4, "bfloat16", True)]
# y and h_T to 1e-5 of their largest magnitude, every gradient to 1e-4 of
# its own: two f32 orders of summation over 2048 steps (the kernel's
# sequential one, the plain version's Hillis-Steele tree and einsum); a
# bf16 u's gradient, rounded once in both, also to one bf16 ulp
SCAN_TOL = {"forward": 1e-5, "backward": 1e-4}
# qwen3-moe-235b served at full width (d 4096, 64 heads over 4 kv heads,
# 128 experts, top-8, d_ff_expert 1536, vocab 151936), its depth cut to
# MOE_LAYERS of 94 so that its f32 twin fits on the card (a layer is 4.98
# GB of bf16 weights, 4.83 of them experts; the tables 2.49 GB: 27.4 GB in
# bf16, 54.7 in f32); batch FAMILY_BATCH, prompts of MOE_PROMPT, MOE_GEN
# greedy tokens. At least MOE_UNFLIPPED_MIN of the row-steps must route
# every token alike in both bf16 paths and the f32 twin.
MOE, MOE_LAYERS, MOE_PROMPT, MOE_GEN = "qwen3-moe-235b", 5, 512, 64
MOE_UNFLIPPED_MIN = 0.5
# qwen3-moe-235b trained at full width (bf16, remat "full" as its config,
# random weights from the seed) through launch/train.py's build, its depth
# cut to MOE_TRAIN_LAYERS of 94: a layer's state is 7.47 GB of bf16
# parameters (4.83 GB of experts, 2.49 GB of tables), 29.9 GB of AdamW
# moments and a 14.9 GB [2, ...] gradient stack, and a second layer would
# add 40 GB. Batch MOE_TRAIN_BATCH x MOE_TRAIN_SEQ over MOE_TRAIN_PLAN's 2
# stacked data ranks (a row, MOE_TRAIN_TOKENS tokens, a rank: capacity
# 168), the MoE layer over MOE_MODEL_RANKS stacked model ranks (32 experts
# a rank; JAX's --mesh prod has 16), MOE_TRAIN_STEPS eager steps whose
# AdamW step donates the state (the functional step holds old and new
# parameters and moments at once: ~90 GB)
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 1, 2, 2048
MOE_TRAIN_PLAN, MOE_TRAIN_DP, MOE_MODEL_RANKS = "chip:2", 2, 4
MOE_TRAIN_STEPS = 3
MOE_TRAIN_TOKENS = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ // MOE_TRAIN_DP
# the prediction, written before the first run on the card: cscatter calls
# a rank and a step, the token combine once a MoE layer in the forward and
# once more in remat "full"'s recompute, the embedding backward once
MOE_TRAIN_CALLS = {"combine": 2, "embedding": 1}
# the smoke configs on the card, with moe_impl="ep" (theirs is "gshard",
# as JAX's) over MOE_SMOKE_RANKS model ranks, batch MOE_SMOKE_BATCH x
# MOE_SMOKE_SEQ over MOE_TRAIN_PLAN: kimi-k2-1t (Adafactor, a shared
# expert, a dense first layer) 2 eager steps in f32 against the same steps
# through moe.apply to MOE_SMOKE_TOL; qwen3-moe-235b deferred, K =
# MOE_SMOKE_K over chip:2:defer, 3 steps
MOE_SMOKE_RANKS, MOE_SMOKE_BATCH, MOE_SMOKE_SEQ = 2, 4, 64
MOE_SMOKE_K, MOE_SMOKE_TOL = 2, 1e-5
# llava-next-34b's backbone at full width (d 7168, 56 heads over 8 kv
# heads, ff 20480, vocab 64000), depth cut to VLM_LAYERS of 60 (1.116 GB a
# layer: 28.6 GB in bf16, 57.2 in f32), prefilled from embeds: VLM_PATCHES
# image-patch rows (LLaVA-NeXT's base 24 x 24 grid; standard normals x
# 0.02, the table's init scale, standing in for the vision frontend, a stub
# in the JAX package too), then VLM_TEXT prompt tokens' table rows;
# VLM_GEN greedy tokens
VLM, VLM_LAYERS, VLM_PATCHES, VLM_TEXT, VLM_GEN = (
    "llava-next-34b", 24, 576, 64, 64)
# kimi-k2-1t (shared expert, a dense first layer) at its smoke config in
# f32: the kernel path (flash, decode, the cscatter combine) against the
# plain path (plain attention, the plain combine) to KIMI_TOL, the same
# expert ids; at full width one MoE layer alone is 33.8 GB of experts
KIMI, KIMI_PROMPT, KIMI_GEN, KIMI_TOL = "kimi-k2-1t", 64, 16, 1e-4
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
# the killed run's depth: 6 of qwen1.5-0.5b's 24 layers at full width (an
# earlier path run at a smaller depth, to keep the script inside its time):
# the step-6 checkpoint ~10 GB, where all 24 layers wrote 19.5 GB, since
# the 0.31 GB embedding with its moments and two levels of [8, ...]
# pendings stays
ELASTIC_LAYERS = 6
# The pipeline schedule: PIPE_STAGES consecutive decoder layers of ARCH at
# full width, one a stage, over PIPE_MICRO microbatches of PIPE_MB x
# PROMPT tokens
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 8, 4
# The verifier's sweep on the card launches exactly these (its stores,
# shapes and seeds are fixed): cscatter 40 in the serve sweep (20 calls of
# LAUNCHES_PER_CALL) and 8 in the apps sweep, cmerge 520 in the blocked
# stores' ticks
LINT_LAUNCHES = {"cscatter": 48, "cmerge": 520}


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
                        "decode_attention", "selective_scan")
    print(f"build: {secs} ({time.perf_counter() - t0:.3f} s in all)")
    for name in ("flash_attention", "cscatter", "decode_attention",
                 "cmerge", "selective_scan"):
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
    worst["float"] = max(worst["float"], embedding_kernel_checks(),
                         moe_combine_kernel_checks())
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
    return out + embedding_kernel_times() + moe_combine_kernel_times()


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
    bidirectional), ragged S = T = 100 and seamless-m4t-medium's
    bidirectional encoder (S = T = 128) and cross-attention (S = 512, T =
    128), with sliding windows at
    hymba-1.5b's prefill (W = 1024, G = 5) and at windows of 100, 64 and 1
    over ragged S; the bf16 tensor-core kernel also
    at d in {8, 64, 72, 128, 256}, causal and not, with ragged S != T (S =
    100 against T = 37, and 37 against 100), GQA groups of 2 and 8, and
    through strided [B, S, H, d] views; decode at both models' cache shapes
    and at hymba-1.5b's ring (T = W = 1024) and global cache (T = 2112),
    G = 5, and seamless-m4t-medium's cross cache (T = 128, read at T - 1),
    at positions 0, 1, mid and T - 1, and each of its two passes against
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
                   ((2, 8, 100, 100, 64), 4, True),
                   # seamless-m4t-medium: the encoder, the prefill's cross
                   ((8, 16, ENCDEC_FRAMES, ENCDEC_FRAMES, 64), 16, False),
                   ((8, 16, ENCDEC_PROMPT, ENCDEC_FRAMES, 64), 16, False),
                   # qwen3-moe-235b's prefill (G = 16), llava-next-34b's
                   # (G = 7)
                   ((8, 64, MOE_PROMPT, MOE_PROMPT, 128), 4, True),
                   ((8, 56, VLM_PATCHES + VLM_TEXT, VLM_PATCHES + VLM_TEXT,
                     128), 8, True)]
    edge_cases = [((1, 8, s, t, d), kv, causal)
                  for d in (8, 64, 72, 128, 256) for causal in (True, False)
                  for (s, t), kv in (((100, 37), 4), ((37, 100), 1))]
    # hymba-1.5b: G = 5; the ring of W = 1024 slots and a global cache
    decode_cases = [((8, 16, 64), 576, 16), ((8, 16, 128), 4096, 8),
                    ((8, 25, 64), HYMBA_W, 5), ((8, 25, 64), 2112, 5),
                    ((8, 16, 64), ENCDEC_FRAMES, 16),   # seamless's cross
                    # qwen3-moe-235b (G = 16: GMAX = 16), llava (G = 7)
                    ((8, 64, 128), MOE_PROMPT + MOE_GEN, 4),
                    ((8, 56, 128), VLM_PATCHES + VLM_TEXT + VLM_GEN, 8)]
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
    cache of 2112 at its last position; and seamless-m4t-medium's (H = KV
    = 16, d 64), bidirectional: its encoder (S = T = 128 frames) and its
    prefill's cross-attention (S = 512 against T = 128), and its decode's
    cross-attention over the cross cache of 128 at position 127. A decode
    row's
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
    for model, (b, h, kv, s, t, d), causal, w in (
            ("qwen1.5-0.5b", (8, 16, 16, 512, 512, 64), True, 0),
            ("internlm2-1.8b", (2, 16, 8, 1024, 1024, 128), True, 0),
            ("hymba-1.5b", (8, 25, 5, HYMBA_PROMPT, HYMBA_PROMPT, 64), True,
             HYMBA_W),
            ("hymba-1.5b", (8, 25, 5, HYMBA_PROMPT, HYMBA_PROMPT, 64), True,
             0),
            ("seamless-m4t-medium encoder",
             (8, 16, 16, ENCDEC_FRAMES, ENCDEC_FRAMES, 64), False, 0),
            ("seamless-m4t-medium cross",
             (8, 16, 16, ENCDEC_PROMPT, ENCDEC_FRAMES, 64), False, 0),
            (MOE, (8, 64, 4, MOE_PROMPT, MOE_PROMPT, 128), True, 0),
            (VLM, (8, 56, 8, VLM_PATCHES + VLM_TEXT, VLM_PATCHES + VLM_TEXT,
                   128), True, 0)):
        q, k, v = _attn_rand(g, bf16, (b, h, s, d), (b, kv, t, d),
                             (b, kv, t, d))
        bound, bound_by = flash_bound_ms(b, h, kv, s, t, d, causal, 2, w)
        if w:       # SDPA has no window: an explicit mask
            diff = (torch.arange(s, device="cuda")[:, None]
                    - torch.arange(s, device="cuda")[None, :])
            mask = (diff >= 0) & (diff < w)

        def sdpa():
            if w:
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=kv != h)
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=kv != h)
        row = {"model": model, "q": [b, h, s, d], "kv_heads": kv, "t": t,
               "causal": causal, "window": w,
               "ms": graph_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                      window=w)),
               "call_ms": time_ms(lambda: flash_attention(
                   q, k, v, causal=causal, window=w)),
               "plain_ms": time_ms(lambda: flash_attention_plain(
                   q, k, v, causal=causal, window=w),
                   **({"samples": 5, "inner": 1}
                      if s >= HYMBA_PROMPT else {})),
               "library_ms": graph_ms(sdpa),
               "library_call_ms": time_ms(sdpa),
               "bound_ms": bound, "bound_by": bound_by}
        out["flash"].append(row)
        print(f"time flash_attention {model} bf16 q [{b},{h},{s},{d}] "
              f"KV={kv} T={t} {'causal' if causal else 'bidirectional'} "
              f"window={w}: kernel {row['ms']:.6f} ms (a call "
              f"{row['call_ms']:.6f} ms), plain {row['plain_ms']:.6f} ms, "
              f"sdpa {row['library_ms']:.6f} ms (a call "
              f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms "
              f"({bound_by})")
    for model, (b, h, kv, t, d) in (
            ("qwen1.5-0.5b", (8, 16, 16, 576, 64)),
            ("internlm2-1.8b", (8, 16, 8, 4096, 128)),
            ("hymba-1.5b ring", (8, 25, 5, HYMBA_W, 64)),
            ("hymba-1.5b global", (8, 25, 5, HYMBA_PROMPT + HYMBA_GEN, 64)),
            ("seamless-m4t-medium cross", (8, 16, 16, ENCDEC_FRAMES, 64)),
            (MOE, (8, 64, 4, MOE_PROMPT + MOE_GEN, 128)),
            (VLM, (8, 56, 8, VLM_PATCHES + VLM_TEXT + VLM_GEN, 128))):
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


def _scan_inputs(what: str, b: int, t: int, d: int, s: int, u_dtype: str,
                 seed: int) -> list:
    """The scan's inputs on the card from the seed: dt = softplus(normal)
    (softplus(normal - 5) for "small_dt"), u normal in ``u_dtype``, b and c
    normal, a = -(1..S) as the model's init, h0 zero as the model passes it
    for the prefill and train rows (normal for the others, so that its
    gradient and its carry over chunks are checked)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    a = -torch.arange(1, s + 1, dtype=torch.float32,
                      device="cuda").repeat(d, 1)
    h0 = (torch.zeros((b, d, s), device="cuda")
          if what in ("prefill", "train") else f(b, d, s))
    shift = -5.0 if what == "small_dt" else 0.0
    return [torch.nn.functional.softplus(f(b, t, d) + shift),
            f(b, t, d).to(getattr(torch, u_dtype)), f(b, t, s), f(b, t, s),
            a, h0]


def scan_bound_ms(b: int, t: int, d: int, s: int, u_item: int,
                  backward: bool) -> tuple[float, str]:
    """The least time the card needs for one selective-scan call: its
    inputs read and outputs written once (bytes), or its B T D S
    exponentials at the SFU rate (operations), whichever is larger. The
    forward reads dt, u, b, c, a, h0 and writes y, h_T; the backward reads
    dt, u, b, c, a, h0 (from which it may recompute every state), dy and
    dh and writes the six gradients. The kernels' own checkpoints are a
    choice of their design, not something the function needs, so neither
    direction counts them."""
    btd, bts, ds, bds = b * t * d, b * t * s, d * s, b * d * s
    ins = 4 * btd + u_item * btd + 8 * bts + 4 * ds + 4 * bds
    if backward:
        nbytes = ins + 4 * btd + 4 * bds + (4 * btd + u_item * btd + 8 * bts
                                            + 4 * ds + 4 * bds)
    else:
        nbytes = ins + 4 * btd + 4 * bds
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = b * t * d * s / SFU_EXP_PER_S
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _scan_err(got, want) -> tuple[float, float]:
    """The largest |got - want|, and it over the largest |want|."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def phase_scan() -> list[dict]:
    """The selective scan (``kernels/selective_scan``, hymba-1.5b's SSM)
    against its plain version at SCAN_SHAPES: y and h_T to
    SCAN_TOL["forward"] of their largest magnitude; where the row has a
    backward, the six gradients of ``sum(y dy) + sum(h_T dh)`` to
    SCAN_TOL["backward"] of theirs (a bf16 u's also to one bf16 ulp of
    each element) and two backward calls equal bit for bit. Then times,
    with CUDA events: the kernel (``ms``: a CUDA graph of 20 launches of
    the same inputs; ``cold_ms``: the same rotating over inputs past the
    L2), a call through the wrapper (``call_ms``: the forward under
    no_grad; for a backward row the Function's forward and backward), the
    plain version the same way (``plain_ms``) and the bound. No PyTorch
    call computes this function (``library_ms`` null). Prints the
    launches a call and every kernel's registers and spills."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as sc
    from repro_torch.kernels.ops import selective_scan
    require(any(r[0] == "ragged" and r[2] == 2 * sc.SEGMENT + 3
                for r in SCAN_SHAPES),
            f"SCAN_SHAPES' ragged row wants T = 2 x {sc.SEGMENT} + 3")
    rows = []
    for what, b, t, d, s, u_name, bwd in SCAN_SHAPES:
        torch.cuda.empty_cache()
        ins = _scan_inputs(what, b, t, d, s, u_name, SEED)
        u_item = ins[1].element_size()
        tag = f"selective_scan {what} [{b},{t},{d}] S {s} u {u_name}"
        with torch.no_grad():
            y, h = selective_scan(*ins)
            yp, hp = sc.selective_scan_plain(*ins)
            torch.cuda.synchronize()
        errs = {"y": _scan_err(y, yp), "h_T": _scan_err(h, hp)}
        del y, h, yp, hp
        err = {k: v[1] for k, v in errs.items()}
        require(max(err.values()) <= SCAN_TOL["forward"],
                f"{tag}: forward off its plain version: {err}")
        n_sets = max(2, -(-int(COLD_BYTES) // sum(
            x.numel() * x.element_size() for x in ins)))
        sets = [ins] + [_scan_inputs(what, b, t, d, s, u_name, SEED + i)
                        for i in range(1, n_sets)]
        n_cold = max(20, n_sets)
        fwd = dict(what=what, direction="forward", shape=[b, t, d, s],
                   u=u_name, max_rel_err=err, tol=SCAN_TOL["forward"],
                   max_abs_err=max(v[0] for v in errs.values()))
        fwd["bound_ms"], fwd["bound_by"] = scan_bound_ms(
            b, t, d, s, u_item, False)
        fwd["ms"] = graph_ms(lambda: sc.launch_forward(*ins, checkpoints=bwd),
                             launches=20, samples=5)
        fwd["cold_ms"] = graph_ms(rotating(
            lambda *x: sc.launch_forward(*x, checkpoints=bwd), sets),
            launches=n_cold, samples=5)
        with torch.no_grad():
            fwd["call_ms"] = time_ms(lambda: selective_scan(*ins), samples=7,
                                     inner=3)
            fwd["plain_ms"] = time_ms(lambda: sc.selective_scan_plain(*ins),
                                      samples=3, inner=1)
        fwd["library_ms"] = None
        rows.append(fwd)
        print(f"{tag} forward: max rel err {err} (tol {SCAN_TOL['forward']})"
              f"; kernel {fwd['ms']:.6f} ms (cold {fwd['cold_ms']:.6f}), "
              f"call {fwd['call_ms']:.6f}, plain {fwd['plain_ms']:.6f}, bound "
              f"{fwd['bound_ms']:.6f} ({fwd['bound_by']}), no library call")
        if not bwd:
            del sets, ins
            continue
        g = torch.Generator(device="cuda").manual_seed(SEED + 7)
        dy = torch.randn((b, t, d), generator=g, device="cuda")
        dh = torch.randn((b, d, s), generator=g, device="cuda")

        def grads(fn):
            xs = [x.detach().requires_grad_(True) for x in ins]
            y, h = fn(*xs)
            return torch.autograd.grad((y * dy).sum() + (h * dh).sum(), xs)
        got, again = grads(selective_scan), grads(selective_scan)
        bitwise = all(torch.equal(x, z) for x, z in zip(got, again))
        del again
        torch.cuda.reset_peak_memory_stats()
        want = grads(sc.selective_scan_plain)
        plain_peak = torch.cuda.max_memory_allocated()
        gerr, gabs, ulp_ok = {}, {}, True
        for name, x, w in zip(("dt", "u", "b", "c", "a", "h0"), got, want):
            gabs[name], gerr[name] = _scan_err(x, w)
            if name == "u" and u_name == "bfloat16":
                ulp_ok = bool(((x.float() - w.float()).abs()
                               <= 2 ** -7 * w.float().abs()
                               + SCAN_TOL["backward"]
                               * w.float().abs().max()).all())
            elif gerr[name] > SCAN_TOL["backward"]:
                ulp_ok = False
        del got, want
        require(ulp_ok and bitwise, f"{tag}: backward off its plain version "
                                    f"or not repeatable: {gerr}, bitwise "
                                    f"{bitwise}")
        y, h, ckpt = sc.launch_forward(*ins)
        back = dict(what=what, direction="backward", shape=[b, t, d, s],
                    u=u_name, max_rel_err=gerr, tol=SCAN_TOL["backward"],
                    max_abs_err=max(gabs.values()),
                    bitwise_repeat=bitwise, plain_peak_bytes=plain_peak)
        back["bound_ms"], back["bound_by"] = scan_bound_ms(
            b, t, d, s, u_item, True)
        back["ms"] = graph_ms(lambda: sc.launch_backward(
            *ins[:5], ckpt, dy, dh), launches=20, samples=5)
        ckpts = [sc.launch_forward(*x)[2] for x in sets]
        back["cold_ms"] = graph_ms(rotating(
            lambda x, ck: sc.launch_backward(*x[:5], ck, dy, dh),
            list(zip(sets, ckpts))), launches=n_cold, samples=5)
        del ckpts, y, h, ckpt
        back["call_ms"] = time_ms(lambda: grads(selective_scan), samples=7,
                                  inner=3)
        back["plain_ms"] = time_ms(lambda: grads(sc.selective_scan_plain),
                                   samples=3, inner=1)
        back["library_ms"] = None
        rows.append(back)
        print(f"{tag} backward: max rel err {gerr} (tol "
              f"{SCAN_TOL['backward']}; d u of bf16 also to one ulp), two "
              f"calls bitwise {bitwise}; kernel {back['ms']:.6f} ms (cold "
              f"{back['cold_ms']:.6f}), call (forward + backward) "
              f"{back['call_ms']:.6f}, plain (forward + backward) "
              f"{back['plain_ms']:.6f}, plain's peak {plain_peak} bytes, "
              f"bound {back['bound_ms']:.6f} ({back['bound_by']}), no "
              f"library call")
        del sets, ins
    rows[0]["ptxas"] = ptxas_report(_build.LOGS.get("selective_scan", ""))
    print(f"selective_scan: {sc.LAUNCHES_PER_CALL} launches a call, chunk "
          f"{sc.SEGMENT} steps")
    for line in rows[0]["ptxas"]:
        print(f"selective_scan ptxas: {line}")
    torch.cuda.empty_cache()
    return rows


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
    flash_attention.launches_bidirectional = 0
    flash_attention.launches_by_variant = dict.fromkeys(
        flash_attention.launches_by_variant, 0)
    res = generate(model, ids, GEN, keep_logits=True)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    by_variant = dict(flash_attention.launches_by_variant)
    require(flash_attention.launches_bidirectional == 0,
            f"serve: {flash_attention.launches_bidirectional} bidirectional "
            f"flash launches in a decoder-only model")
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
    model.impl = "plain"
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
    model.impl = "kernel"
    del model, caches, res
    torch.cuda.empty_cache()
    return out


def _teacher_forced(model, batch: dict, res, prompt: int) -> list:
    """The logits of every step of ``res`` (a ``generate`` run of
    ``batch``'s tokens, and frames for an encoder-decoder; the VLM's of its
    embeds) with its tokens teacher-forced through ``model`` as it is set
    now."""
    import torch
    frames = (batch["frames"],) if "frames" in batch else ()
    extra = {"embeds": batch["embeds"]} if "embeds" in batch else {}
    logits, caches = model.prefill(
        torch.as_tensor(batch["tokens"], device="cuda"),
        prompt + len(res.logits), *frames, **extra)
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
                     steps: int, rows: list | None = None) -> dict:
    """Each step's served bf16 logits ``got[i]`` held against ``ref[i]``,
    the same function computed in f32 from the same weights, no farther
    than ``other[i]`` (the same function in bf16 another way) is: RMS
    error within 1.25 x ``other``'s plus 1e-3, largest error within
    ``max(LOGIT_TOL, 1.5 x`` ``other``'s largest``)``, greedy tokens equal
    to ``ref``'s wherever its top-2 margin exceeds twice that bound. At
    the families' depths the bf16 rounding of either path moves the
    logits by about ``LOGIT_TOL`` on its own (the readings this prints at
    step 0), so a fixed bound between two bf16 paths would test their
    rounding rather than the kernels or the recurrence. ``rows[i]`` (a
    bool mask over the batch) keeps step ``i``'s check to those rows (the
    MoE's rows whose tokens every path routed alike); a step without one
    is not held."""
    worst_apart, worst_other, checked, same_n = 0.0, 0.0, 0, 0
    step0_apart = None
    for i in range(steps):
        g, o, f = got[i], other[i], ref[i]
        if rows is not None:
            if not bool(rows[i].any()):
                continue
            g, o, f = g[rows[i]], o[rows[i]], f[rows[i]]
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
        if step0_apart is None:
            step0_apart = float(apart.max())
            print(f"{label} step {i} (the first held) logits: served bf16 "
                  f"vs f32 max {k_max} RMS {k_rms}; other bf16 vs f32 max "
                  f"{p_max} RMS {p_rms}; the two bf16 paths apart max "
                  f"{float(apart.max())} RMS "
                  f"{float(apart.square().mean().sqrt())}")
    return {"max_logit_err": worst_apart, "other_vs_f32_max": worst_other,
            "step0_apart": step0_apart, "sure_tokens": checked,
            "same_tokens": same_n}


def _plain_teacher_forced(model, batch: dict, res, prompt: int, label: str,
                          f32_floor: bool = False) -> dict:
    """``res`` (a ``generate`` run through the kernels) against the same
    tokens teacher-forced through the plain attention versions: every
    step's logits within ``LOGIT_TOL``, greedy tokens equal where the plain
    path's top-2 margin exceeds ``2 * LOGIT_TOL`` (``phase_serve``'s
    bounds). No attention kernel may launch meanwhile. With ``f32_floor``
    (hymba-1.5b: 32 layers, prompts of 2048; seamless-m4t-medium: 24
    layers) both bf16 paths are held to
    the same weights in f32 through the plain attention instead
    (``_f32_floor_check``); the model ends in f32 and the caller drops
    it."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    before = (flash_attention.launches, decode_attention.launches)
    model.impl = "plain"
    plain = _teacher_forced(model, batch, res, prompt)
    ref = None
    if f32_floor:
        model.float()
        ref = _teacher_forced(model, batch, res, prompt)
    require(before == (flash_attention.launches, decode_attention.launches),
            f"{label}: the plain path launched an attention kernel")
    model.impl = "kernel"
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
                  want: dict, batch: dict | None = None,
                  variant: str = "bf16_mma", around=None) -> tuple:
    """``cfg`` at full width in bf16 with random weights from the seed,
    ``FAMILY_BATCH`` prompts of ``prompt`` random ids and ``gen`` greedy
    tokens (an encoder-decoder with the frames the serve CLI draws; the
    batch ``batch(model)`` makes instead, the VLM's with its embeds) through
    ``launch/serve.generate``, the attention kernels' and ``cscatter``'s
    counts zeroed just before and read just after and held to ``want``,
    every flash launch through ``variant``, the run inside ``around()``
    when given; then a ``--profile``-style trace of a prefill and one
    decode step. Returns (model, the serve batch, result, the row to
    print)."""
    import contextlib
    import torch
    from repro_torch.kernels.cscatter import cscatter
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.launch.serve import generate, profile, serve_batch
    want = {"selective_scan": 0, **want}    # a path without an SSM: none
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda", seed=SEED)
    if batch is None:
        batch = serve_batch(cfg, FAMILY_BATCH, prompt, SEED)
    elif callable(batch):
        batch = batch(model)
    ids, frames = batch["tokens"], batch.get("frames")
    embeds = batch.get("embeds")
    generate(model, ids[:, :16], 2, frames=frames,      # warm-up, not counted
             embeds=None if embeds is None else embeds[:, :16])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = decode_attention.launches = 0
    cscatter.launches = selective_scan.launches = 0
    flash_attention.launches_windowed = 0
    flash_attention.launches_bidirectional = 0
    flash_attention.launches_by_variant = dict.fromkeys(
        flash_attention.launches_by_variant, 0)
    with (around or contextlib.nullcontext)():
        res = generate(model, ids, gen, frames=frames, embeds=embeds,
                       keep_logits=True)
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_windowed": flash_attention.launches_windowed,
                "flash_attention_bidirectional":
                    flash_attention.launches_bidirectional,
                "decode_attention": decode_attention.launches,
                "cscatter": cscatter.launches,
                "selective_scan": selective_scan.launches}
    by_variant = dict(flash_attention.launches_by_variant)
    peak = torch.cuda.max_memory_allocated() - base
    require(launches == want, f"{arch}: launches {launches}, the path "
                              f"predicts {want}")
    require(by_variant[variant] == launches["flash_attention"],
            f"{arch}: flash_attention variants {by_variant}: every launch "
            f"must run {variant}")
    require(tuple(res.tokens.shape) == (FAMILY_BATCH, gen),
            f"{arch}: generated {tuple(res.tokens.shape)}")
    steps = gen - 1
    row = {"prefill_ms": 1e3 * res.prefill_s,
           "prefill_tok_s": FAMILY_BATCH * prompt / res.prefill_s,
           "decode_ms_per_step": 1e3 * res.decode_s / steps,
           "decode_tok_s": FAMILY_BATCH * steps / res.decode_s,
           "peak_bytes": peak, "weights_bytes": sum(
               p.numel() * p.element_size() for p in model.parameters()),
           "launches": launches, "flash_launches_by_variant": by_variant,
           "card": card}
    print(f"serve {cfg.name} {str(cfg.param_dtype)[6:]} batch "
          f"{FAMILY_BATCH} prompt {prompt} gen {gen} on {card}: prefill "
          f"{row['prefill_ms']:.3f} ms ({row['prefill_tok_s']:.1f} tok/s), "
          f"decode {row['decode_ms_per_step']:.6f} ms a step "
          f"({row['decode_tok_s']:.1f} tok/s), peak memory {peak} bytes "
          f"({row['weights_bytes']} of weights); launches {launches} "
          f"(predicted {want})")
    row["profile"] = profile(model, ids, steps=1, rows=8, frames=frames,
                             embeds=embeds)
    return model, batch, res, row


def _hymba_serve(card: str) -> dict:
    """(a) hymba-1.5b: 32 flash_attention launches at prefill (29 with the
    window) and a selective_scan forward in each layer, then a
    decode_attention call (2 launches) in each layer of every decode step
    (the SSM's decode is the elementwise step, no kernel); held against the
    plain attention and the plain scan."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    from repro_torch.kernels.selective_scan import (
        LAUNCHES_PER_CALL as SCAN_LAUNCHES)
    cfg = get_config("hymba-1-5b")
    n_win = cfg.n_layers - len(cfg.full_attn_layers)
    want = {"flash_attention": cfg.n_layers,
            "flash_attention_windowed": n_win,
            "flash_attention_bidirectional": 0,
            "decode_attention": cfg.n_layers * (HYMBA_GEN - 1)
            * LAUNCHES_PER_CALL, "cscatter": 0,
            "selective_scan": cfg.n_layers * SCAN_LAUNCHES["forward"]}
    model, batch, res, row = _serve_family("hymba-1.5b", cfg, HYMBA_PROMPT,
                                           HYMBA_GEN, card, want)
    row.update(_plain_teacher_forced(model, batch, res, HYMBA_PROMPT,
                                     "serve hymba-1.5b", f32_floor=True))
    return row


def _scan_backward_check(model, grads_of, params, batch, rows: int) -> dict:
    """One rank's loss and gradient of the whole model (the first ``rows``
    rows of ``batch``, the parameters upcast to f32) with every layer's SSM
    through the scan kernels (``impl="kernel"``) and through the plain scan
    (``"plain"``): the loss to 1e-5 relative and each leaf's error RMS to
    1e-3 of the leaf's RMS. The two scans agree to ~1e-7 in f32
    (``phase_scan``), and a wrong scan gradient is off by its own size. In
    bf16 the two paths round the scan's output into bf16 activations at
    other places, and over 32 layers their gradients part at bf16
    rounding's level (4.7e-2 of a leaf's RMS at ``blocks/ssm/x_bc/w``,
    NVIDIA H100 80GB HBM3, 700 W), so the check is made in f32."""
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    shard = {k: v[:rows] for k, v in batch.items()}
    tree = pytree.tree_map(lambda p: p.float(), params)
    try:
        model.impl = "plain"
        loss_p, want = grads_of(tree, shard)
        want = dict(_flatten_with_paths(want))
        model.impl = "kernel"
        loss_k, got = grads_of(tree, shard)
    finally:
        model.impl = "kernel"
    worst, worst_leaf = 0.0, None
    for name, g in _flatten_with_paths(got):
        w = want[name]
        rel = float((g - w).pow(2).mean().sqrt()
                    / w.pow(2).mean().sqrt().clamp_min(1e-30))
        if rel > worst:
            worst, worst_leaf = rel, name
    del got, want, tree
    out = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_err": abs(float(loss_k) - float(loss_p))
           / abs(float(loss_p)),
           "worst_leaf_rel_rms_err": worst, "worst_leaf": worst_leaf,
           "tol": {"loss_rel": 1e-5, "leaf_rel_rms": 1e-3}}
    print(f"train hymba-1.5b, one rank's gradient ({rows} x "
          f"{shard['tokens'].shape[1]}, all 32 layers, f32 parameters) "
          f"through the scan kernels vs the plain scan: loss "
          f"{out['loss_kernel']} vs {out['loss_plain']}, worst leaf error "
          f"RMS {worst:.3e} of its RMS ({worst_leaf}; tol 1e-3)")
    require(out["loss_rel_err"] <= 1e-5 and worst <= 1e-3,
            f"hymba train: the scan kernels' gradient disagrees with the "
            f"plain scan's: {out}")
    return out


def _first_cycle_check(label: str, model, opt, dcfg, params0, snaps: dict,
                       plan: str, k: int, dp: int, lr1: float) -> dict:
    """The first deferred cycle of a run from ``params0`` (its parameters
    and AdamW mu after the commit, ``snaps["params"]`` and ``snaps["mu"]``,
    kept on the host) against one AdamW step on the mean of its ``k``
    batches' eager merges over ``plan``'s ``dp`` stacked ranks from the
    same parameters: ``_param_errs`` at the first step's lr ``lr1`` and
    ``_mu_err`` (``phase_train``'s bounds)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.grad_merge import merge_gradients
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.core.stacked import StackedAxis
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import steps
    axis = StackedAxis(dp, "cuda")
    grads_of = steps.grads_fn(model)
    acc = None
    for i in range(k):
        b = steps.to_device(batch_at(dcfg, i), "cuda")
        _, stack = steps.rank_grads(grads_of, params0, b, dp)
        merged = merge_gradients(stack, axis, topology=MergePlan.parse(plan))
        del stack
        g = pytree.tree_map(lambda x: x[0].float(), merged)
        del merged
        acc = g if acc is None else pytree.tree_map(torch.add, acc, g)
    mean = pytree.tree_map(lambda a, p: (a / k).to(p.dtype), acc, params0)
    del acc
    ref, ref_opt, _ = opt.step(params0, mean, opt.init(params0))
    del mean
    ref_mu = ref_opt.mu
    del ref_opt
    got = pytree.tree_map(lambda x: x.to("cuda"), snaps.pop("params"))
    cyc = _param_errs(got, ref, lr1)
    del got, ref
    mu = _mu_err(pytree.tree_map(lambda x: x.to("cuda"), snaps.pop("mu")),
                 ref_mu)
    del ref_mu
    print(f"{label} deferred cycle 1 vs AdamW on the mean of {k} eager "
          f"merges: params max |err| {cyc['max_abs_err']} (bound "
          f"{cyc['bound']}; {cyc['beyond_one_ulp_share']:.2e} of elements "
          f"beyond one bf16 ulp), mu max err {mu['max_rel_err']:.3e} of each "
          f"leaf's largest (bound {mu['bound']})")
    require(cyc["ok"] and mu["ok"], f"{label}: the deferred cycle is not the "
                                    f"accumulated eager step: {cyc}, {mu}")
    return {"params": cyc, "mu": mu}


def _hymba_train(card: str) -> dict:
    """(j) hymba-1.5b trained at full width and depth (bf16, remat "dots",
    random weights from the seed) through ``launch/train.py``'s ``build``
    with the CLI's flags, as ``phase_train`` drives qwen1.5-0.5b: eager over
    HYMBA_TRAIN_PLAN for HYMBA_TRAIN_EAGER steps, then deferred over
    HYMBA_TRAIN_DEFER_PLAN with K = HYMBA_TRAIN_K for HYMBA_TRAIN_DEFERRED
    steps (two cycles and a partial one that the flush settles), batch
    HYMBA_TRAIN_BATCH x HYMBA_TRAIN_SEQ over 2 stacked ranks. Checks: every
    loss finite; the first deferred cycle equals one AdamW step on the mean
    of its batches' eager merges from the same starting parameters (the
    bounds of ``phase_train``); ``cscatter`` launches equal 2 x ranks x
    steps; the selective scan's forward and backward launches equal
    HYMBA_SCAN_CALLS a layer, a rank and a step. The overlapped variant is
    held on the CPU (``tests/test_torch_train_hymba.py``), not here.
    Records ms a step by kind, tokens/s, peak memory and the profiler's
    split and idle share of one eager step. The first cycle's parameters
    and AdamW mu are kept on the host until the check (device memory).
    Then holds one rank's gradient of the whole model through the scan
    kernels against the plain scan's, in f32 (``_scan_backward_check``)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import selective_scan as sc
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch import steps, train
    from repro_torch.optim import warmup_cosine

    gc.collect()
    torch.cuda.empty_cache()
    out, runs, snaps = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hymba_train_")
    lr = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, HYMBA_TRAIN_DEFERRED)
    try:
        for variant, n in (("eager", HYMBA_TRAIN_EAGER),
                           ("deferred", HYMBA_TRAIN_DEFERRED)):
            argv = ["--arch", "hymba-1-5b", "--steps", str(n), "--batch",
                    str(HYMBA_TRAIN_BATCH), "--seq", str(HYMBA_TRAIN_SEQ),
                    "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
                    "--seed", str(SEED), "--ckpt-dir", tmp, "--ckpt-every",
                    str(1 << 30), "--device", "cuda", "--merge-topology"]
            argv += ([HYMBA_TRAIN_PLAN] if variant == "eager" else
                     [HYMBA_TRAIN_DEFER_PLAN, "--merge-defer",
                      str(HYMBA_TRAIN_K)])
            t = train.build(train.parse_args(argv))
            cfg = t.cfg
            require(t.dp == HYMBA_TRAIN_DP and cfg.remat == "dots"
                    and (cfg.n_layers, cfg.d_model, cfg.ssm_state)
                    == (32, 1600, 16),
                    f"hymba train {variant}: {t.dp} ranks, remat "
                    f"{cfg.remat}, {cfg.n_layers} layers")
            state, t.state = t.state, None
            batches = [batch_at(t.dcfg, i) for i in range(n)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cscatter.launches = sc.selective_scan.launches = 0
            sc.selective_scan.launches_forward = 0
            sc.selective_scan.launches_backward = 0
            rec = []
            for i, batch in enumerate(batches):
                kind = _step_kind(t, state)
                t0 = time.perf_counter()
                state, m = t.step_fn(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                loss = float(m["loss"])
                require(np.isfinite(loss), f"hymba train {variant} step {i}:"
                                           f" loss {loss}")
                rec.append({"kind": kind, "ms": 1e3 * dt, "loss": loss})
                print(f"train hymba-1.5b {variant} step {i}: {kind} loss "
                      f"{loss:.6f} {1e3 * dt:.3f} ms")
                if variant == "deferred" and i + 1 == HYMBA_TRAIN_K:
                    host = lambda x: x.to("cpu", copy=True)   # noqa: E731
                    snaps["params"] = pytree.tree_map(host, state["params"])
                    snaps["mu"] = pytree.tree_map(host, state["opt"].mu)
            flush_ms = None
            if t.deferred is not None:
                t0 = time.perf_counter()
                state, fm = t.deferred.flush(state)
                torch.cuda.synchronize()
                flush_ms = 1e3 * (time.perf_counter() - t0)
                require(fm is not None and fm.get("flushed_steps")
                        == n % HYMBA_TRAIN_K,
                        f"hymba train {variant}: flush {fm}")
            peak = torch.cuda.max_memory_allocated()
            launches = {"cscatter": cscatter.launches,
                        "selective_scan_forward":
                            sc.selective_scan.launches_forward,
                        "selective_scan_backward":
                            sc.selective_scan.launches_backward}
            per = t.dp * t.microbatches * n * cfg.n_layers
            want = {"cscatter": LAUNCHES_PER_CALL * t.dp * t.microbatches * n,
                    "selective_scan_forward": per * HYMBA_SCAN_CALLS[
                        "forward"] * sc.LAUNCHES_PER_CALL["forward"],
                    "selective_scan_backward": per * HYMBA_SCAN_CALLS[
                        "backward"] * sc.LAUNCHES_PER_CALL["backward"]}
            require(launches == want, f"hymba train {variant}: launches "
                                      f"{launches}, predicted {want}")
            by_kind = {}
            for r in rec[1:]:                         # step 0 warms up
                by_kind.setdefault(r["kind"], []).append(r["ms"])
            ms = {k: statistics.median(v) for k, v in by_kind.items()}
            if flush_ms is not None:
                ms["flush"] = flush_ms
            cycle_ms = (statistics.mean(r["ms"] for r in rec[1:])
                        if variant == "deferred" else ms["eager"])
            runs[variant] = {
                "steps": rec, "ms_by_kind": ms, "flush_ms": flush_ms,
                "tokens_per_s": HYMBA_TRAIN_BATCH * HYMBA_TRAIN_SEQ
                / (cycle_ms / 1e3), "peak_bytes": peak,
                "launches": launches, "launches_predicted": want}
            print(f"train hymba-1.5b {variant} over {t.dp} ranks on {card}: "
                  f"ms a step by kind "
                  f"{ {k: round(v, 3) for k, v in ms.items()} }, "
                  f"{runs[variant]['tokens_per_s']:.1f} tokens/s, peak "
                  f"memory {peak} bytes; launches {launches} (predicted "
                  f"{want})")
            if variant == "eager":
                prof, state = profile_train_step(t.step_fn, state,
                                                 batches[-1])
                prof["idle_share"] = 1 - prof["device_ms"] / ms["eager"]
                out["profile_eager_step"] = prof
                ranges = {k: round(v, 3)
                          for k, v in prof["by_range_ms"].items()}
                print(f"train hymba-1.5b profile of one eager step: device "
                      f"{prof['device_ms']:.3f} ms against "
                      f"{ms['eager']:.3f} ms a step untraced (idle share "
                      f"{prof['idle_share']:.3f}), {prof['launches']} "
                      f"launches; by range (ms) {ranges}")
            else:
                model, opt, dcfg = t.model, t.optimizer, t.dcfg
                params0 = model.params()
            del t, state
            gc.collect()
            torch.cuda.empty_cache()

        out["deferred_vs_accumulated"] = _first_cycle_check(
            "train hymba-1.5b", model, opt, dcfg, params0, snaps,
            HYMBA_TRAIN_PLAN, HYMBA_TRAIN_K, HYMBA_TRAIN_DP, float(lr(1)))
        grads_of = steps.grads_fn(model)
        out["scan_backward"] = _scan_backward_check(
            model, grads_of, params0, steps.to_device(batch_at(dcfg, 0),
                                                      "cuda"),
            HYMBA_TRAIN_BATCH // HYMBA_TRAIN_DP)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["runs"] = runs
    out["launches"] = {k: v["launches"] for k, v in runs.items()}
    out["card"] = card
    del params0, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
            "flash_attention_bidirectional": 0, "decode_attention": 0,
            "cscatter": 0}
    model, batch, res, row = _serve_family("xlstm-125m", cfg, XLSTM_PROMPT,
                                           XLSTM_GEN, card, want)
    seq = torch.cat([torch.as_tensor(batch["tokens"], device="cuda").long(),
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
    f32_steps = _teacher_forced(model, batch, res, XLSTM_PROMPT)
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
            "flash_attention_bidirectional": 0,
            "decode_attention": cfg.n_layers * (gen - 1) * LAUNCHES_PER_CALL,
            "cscatter": 0}
    model, batch, res, row = _serve_family("granite-34b-smoke gelu", cfg,
                                           prompt, gen, card, want)
    require(sorted(model.params()["blocks"]["ffn"]) == ["wi", "wo"],
            "granite-34b gelu: the model did not build the GELU MLP")
    row.update(_plain_teacher_forced(model, batch, res, prompt,
                                     "serve granite-34b-smoke gelu"))
    return row


def _encdec_serve(card: str) -> dict:
    """(e) seamless-m4t-medium at full width and depth: FAMILY_BATCH
    prompts of ENCDEC_PROMPT ids and frames [8, 128, 1024], ENCDEC_GEN
    tokens. Prefill launches flash_attention 36 times: 12 encoder layers
    bidirectional (S = T = 128), 12 decoder self-attentions causal (S = T =
    512) and 12 cross-attentions bidirectional (S = 512, T = 128), all
    bf16_mma; each decode step two decode_attention calls a decoder layer
    (self and cross), 2 launches each. Held to the same weights in f32
    through the plain attention (24 layers: the f32 floor), with the
    fixed-bound reading against the plain bf16 path printed at step 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    cfg = get_config(ENCDEC)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
    want = {"flash_attention": n_enc + 2 * n_dec,
            "flash_attention_windowed": 0,
            "flash_attention_bidirectional": n_enc + n_dec,
            "decode_attention": 2 * n_dec * (ENCDEC_GEN - 1)
            * LAUNCHES_PER_CALL, "cscatter": 0}
    model, batch, res, row = _serve_family(ENCDEC, cfg, ENCDEC_PROMPT,
                                           ENCDEC_GEN, card, want)
    require(tuple(batch["frames"].shape) == (FAMILY_BATCH, ENCDEC_FRAMES,
                                             cfg.d_model),
            f"{ENCDEC}: frames {tuple(batch['frames'].shape)}")
    out = _plain_teacher_forced(model, batch, res, ENCDEC_PROMPT,
                                f"serve {ENCDEC}", f32_floor=True)
    row.update(out)
    print(f"serve {ENCDEC} step 0, the fixed bound for the record: kernel "
          f"vs plain bf16 logits {out['step0_apart']} apart (LOGIT_TOL "
          f"{LOGIT_TOL}: {'within' if out['step0_apart'] <= LOGIT_TOL else 'beyond'})")
    return row


def _encdec_train(card: str) -> dict:
    """(f) seamless-m4t-medium trained at full width and depth (bf16,
    remat "dots", random weights from the seed): ENCDEC_TRAIN_STEPS eager
    steps of ENCDEC_TRAIN_BATCH x TRAIN_SEQ (frames of 128) over
    ENCDEC_TRAIN_PLAN's 2 stacked ranks, AdamW, through
    ``launch/train.py``'s ``build`` as ``phase_train`` drives it. Every
    loss finite; ``cscatter`` launches (the embedding backward into the
    [256256, 1024] f32 gradient) equal 2 x ranks x steps; one rank's
    embedding gradient through the CUDA ``cscatter`` within 1e-2 of each
    row's RMS of the plain version's. The step functions run without the
    CLI's driver, so nothing is checkpointed."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch import steps, train
    gc.collect()
    torch.cuda.empty_cache()
    t = train.build(train.parse_args([
        "--arch", ENCDEC, "--steps", str(ENCDEC_TRAIN_STEPS), "--batch",
        str(ENCDEC_TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr",
        str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP), "--seed", str(SEED),
        "--device", "cuda", "--merge-topology", ENCDEC_TRAIN_PLAN]))
    require(t.dp == ENCDEC_TRAIN_DP and t.cfg.remat == "dots",
            f"{ENCDEC} train: {t.dp} ranks, remat {t.cfg.remat}")
    state, t.state = t.state, None
    batches = [batch_at(t.dcfg, i) for i in range(ENCDEC_TRAIN_STEPS)]
    require(batches[0]["frames"].shape == (ENCDEC_TRAIN_BATCH, ENCDEC_FRAMES,
                                           t.cfg.d_model),
            f"{ENCDEC} train: frames {batches[0]['frames'].shape}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cscatter.launches = 0
    rec = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = t.step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = float(m["loss"])
        require(np.isfinite(loss), f"{ENCDEC} train step {i}: loss {loss}")
        rec.append({"ms": 1e3 * dt, "loss": loss})
        print(f"train {ENCDEC} step {i}: loss {loss:.6f} {1e3 * dt:.3f} ms")
    launches = cscatter.launches
    peak = torch.cuda.max_memory_allocated()
    want = LAUNCHES_PER_CALL * t.dp * t.microbatches * ENCDEC_TRAIN_STEPS
    require(launches == want, f"{ENCDEC} train: cscatter launched "
                              f"{launches} times, the path predicts {want}")
    ms = rec[-1]["ms"]                        # step 0 warms up
    out = {"steps": rec, "ranks": t.dp, "ms_per_step": ms,
           "tokens_per_s": ENCDEC_TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
           "peak_bytes": peak, "cscatter_launches": launches,
           "cscatter_launches_predicted": want}
    print(f"train {ENCDEC} eager over {t.dp} ranks on {card}: "
          f"{ms:.3f} ms a step, {out['tokens_per_s']:.1f} tokens/s, peak "
          f"memory {peak} bytes, cscatter launches {launches} (predicted "
          f"{want})")
    out["embedding_backward"] = _embedding_backward_check(
        steps.grads_fn(t.model), state["params"],
        steps.to_device(batches[0], "cuda"),
        rows=ENCDEC_TRAIN_BATCH // t.dp)
    del t, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    ``runtime/chaos.real_model_run`` on the card, CHAOS_STEPS steps of
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


class _Routes:
    """The expert ids of every MoE layer routed while the context is open,
    in order: ``repro_torch.models.moe.top_k``'s, which ``moe.route`` and
    ``moe_ep.apply_ep`` both call (wrapping the module's function; the
    model code is unchanged)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.top_k, self.ids = moe, moe.top_k, []

    def __enter__(self):
        self.ids = []

        def recorded(*args):
            out = self.top_k(*args)
            self.ids.append(out[1])
            return out
        self.moe.top_k = recorded
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.top_k

    def steps(self, layers: int, batch: int) -> list:
        """Per step, per layer, the sorted ids ``[batch, tokens, k]``."""
        import torch
        require(len(self.ids) % layers == 0, f"{len(self.ids)} routes for "
                                             f"{layers} layers")
        return [[torch.sort(x, -1).values.reshape(batch, -1, x.shape[-1])
                 for x in self.ids[i:i + layers]]
                for i in range(0, len(self.ids), layers)]


class _PlainScatter:
    """Inside the context ``kernels.ops.commutative_scatter`` (the MoE
    combine, the embedding backward) runs ``cscatter_plain_``, the
    kernel's plain version, on the card."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.cscatter import cscatter_plain_
        self.ops, self.kernel = ops, ops.commutative_scatter
        ops.commutative_scatter = (lambda t, i, v, **kw:
                                   cscatter_plain_(t, i, v, **kw))
        return self

    def __exit__(self, *exc):
        self.ops.commutative_scatter = self.kernel


def _route_flips(paths: dict, ref: list) -> tuple[list, dict]:
    """Rows routed alike: per step, a bool mask over the batch of the rows
    whose every token took the f32 twin's experts in every layer, in every
    path of ``paths``; and per path the share of its assignments (token,
    layer, slot) that are not the f32 twin's."""
    import torch
    masks, flipped = [], {name: [0, 0] for name in paths}
    for i, want in enumerate(ref):
        ok = None
        for name, got in paths.items():
            for g, w in zip(got[i], want):
                same = (g == w).all(-1).all(-1)
                ok = same if ok is None else ok & same
                hit = (g[..., :, None] == w[..., None, :]).any(-1)
                flipped[name][0] += int((~hit).sum())
                flipped[name][1] += hit.numel()
        masks.append(ok)
    return masks, {name: n / total for name, (n, total) in flipped.items()}


def _moe_serve(card: str) -> dict:
    """(g) qwen3-moe-235b at full width, MOE_LAYERS layers, bf16: prefill
    of FAMILY_BATCH x MOE_PROMPT and MOE_GEN tokens. A MoE layer combines
    its tokens' expert outputs with one ``cscatter`` call (2 launches) a
    forward: MOE_LAYERS x MOE_GEN calls; one flash launch a layer at
    prefill (G = 16), a ``decode_attention`` call a layer a step (its
    ``GMAX = 16`` configuration). Held to the same weights in f32 through
    the plain attention (``_f32_floor_check``, the rule of the families)
    on the row-steps whose tokens every path routed as the f32 twin, at
    least MOE_UNFLIPPED_MIN of them: bf16 rounding moves the router's
    logits by about 1e-3, enough to swap an expert at the k-th boundary,
    and a swapped expert is another function, not an error."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL as CS_CALL
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_LAYERS)
    require((cfg.n_heads // cfg.n_kv_heads, cfg.n_experts, cfg.top_k) ==
            (16, 128, 8), f"{MOE}: G, experts, top-k of the config")
    want = {"flash_attention": MOE_LAYERS, "flash_attention_windowed": 0,
            "flash_attention_bidirectional": 0,
            "decode_attention": MOE_LAYERS * (MOE_GEN - 1)
            * LAUNCHES_PER_CALL,
            "cscatter": MOE_LAYERS * MOE_GEN * CS_CALL}
    served = _Routes()
    model, batch, res, row = _serve_family(MOE, cfg, MOE_PROMPT, MOE_GEN,
                                           card, want, around=lambda: served)
    before = (flash_attention.launches, decode_attention.launches)
    model.impl = "plain"
    with _Routes() as plain_ids:
        plain = _teacher_forced(model, batch, res, MOE_PROMPT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.float()                   # the f32 twin, converted in place
    torch.cuda.synchronize()
    row["f32_convert_s"] = time.perf_counter() - t0
    with _Routes() as ref_ids:
        ref = _teacher_forced(model, batch, res, MOE_PROMPT)
    model.impl = "kernel"
    require(before == (flash_attention.launches, decode_attention.launches),
            f"{MOE}: the plain path launched an attention kernel")
    for i, got in enumerate(res.logits):
        require(bool(torch.isfinite(got).all()), f"{MOE} step {i}: "
                                                 f"non-finite logits")
    paths = {"served": served.steps(MOE_LAYERS, FAMILY_BATCH),
             "plain": plain_ids.steps(MOE_LAYERS, FAMILY_BATCH)}
    ref_steps = ref_ids.steps(MOE_LAYERS, FAMILY_BATCH)
    require(len(ref_steps) == MOE_GEN and all(
        len(p) == MOE_GEN for p in paths.values()), f"{MOE}: routed steps")
    masks, flip_share = _route_flips(paths, ref_steps)
    held = sum(int(m.sum()) for m in masks)
    share = held / (FAMILY_BATCH * MOE_GEN)
    print(f"serve {MOE}: router assignments not the f32 twin's: served "
          f"{flip_share['served']}, plain {flip_share['plain']}; row-steps "
          f"routed alike in all three {held} of {FAMILY_BATCH * MOE_GEN} "
          f"({share}); at step 0 (the prompts) {int(masks[0].sum())} rows")
    require(share >= MOE_UNFLIPPED_MIN, f"{MOE}: only {share} of the "
            f"row-steps routed alike, fewer than {MOE_UNFLIPPED_MIN}")
    out = _f32_floor_check(f"serve {MOE}", res.logits, plain, ref, MOE_GEN,
                           rows=masks)
    print(f"serve {MOE} vs plain attention, teacher-forced over {MOE_GEN} "
          f"steps, on the {held} row-steps routed alike: the two bf16 paths "
          f"apart by {out['max_logit_err']} at most; each within the plain "
          f"bf16 path's distance to f32 (at most {out['other_vs_f32_max']}); "
          f"greedy tokens equal to f32's at {out['same_tokens']}, required "
          f"at the {out['sure_tokens']} with a sure margin")
    row.update(out, flipped_assignments=flip_share, rows_held=held,
               rows_held_share=share, layers=MOE_LAYERS)
    del model, res, plain, ref, served, plain_ids, ref_ids
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _leaf_rel_rms(got, want) -> tuple[float, str]:
    """The worst leaf's error RMS over its RMS between two gradient trees,
    and that leaf's path."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    want = dict(_flatten_with_paths(want))
    worst, worst_leaf = 0.0, None
    for name, g in _flatten_with_paths(got):
        w = want[name]
        rel = float((g - w).pow(2).mean().sqrt()
                    / w.pow(2).mean().sqrt().clamp_min(1e-30))
        if rel > worst:
            worst, worst_leaf = rel, name
    return worst, worst_leaf


def _moe_grad_check(dcfg) -> dict:
    """One data rank's loss and whole-model gradient of qwen3-moe-235b at
    full width (MOE_TRAIN_LAYERS layers, the train run's weights from the
    seed, upcast to f32; rank 0's row of batch 0) through ``apply_ep`` over
    MOE_MODEL_RANKS model ranks with the CUDA ``cscatter`` combine and
    embedding backward, against ``moe.apply`` with the plain combine and
    embedding backward (``cscatter_plain_``): the loss to 1e-5 relative,
    each leaf's error RMS to 1e-3 of its RMS (``_scan_backward_check``'s
    rule). The two paths' router products run as other GEMMs, so an
    assignment at a near-tie may differ: then the tokens routed otherwise
    in either path are left out of the loss (label -1; with one layer a
    token's expert outputs reach only its own logits) and both gradients
    taken again; their count is printed."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg, device="cuda", seed=SEED,
                        model_ranks=MOE_MODEL_RANKS).float()
    params = model.params()
    rows = MOE_TRAIN_BATCH // MOE_TRAIN_DP
    shard = {k: v[:rows] for k, v in steps.to_device(batch_at(dcfg, 0),
                                                     "cuda").items()}
    grads_of = steps.grads_fn(model)

    def run(ranks, labels):
        model.model_ranks = ranks
        with _Routes() as ids:
            if ranks is None:
                with _PlainScatter():
                    loss, g = grads_of(params, dict(shard, labels=labels))
            else:
                loss, g = grads_of(params, dict(shard, labels=labels))
        torch.cuda.synchronize()
        return float(loss), g, [torch.sort(x, -1).values for x in ids.ids]

    labels = shard["labels"]
    loss_k, got, ids_k = run(MOE_MODEL_RANKS, labels)
    loss_p, want, ids_p = run(None, labels)
    require(len(ids_k) == len(ids_p) > 0, f"{MOE} gradient check: "
                                          f"{len(ids_k)}, {len(ids_p)} routes")
    other = torch.zeros(labels.numel(), dtype=torch.bool, device="cuda")
    for a, b in zip(ids_k, ids_p):
        other |= (a != b).any(-1)
    n_other = int(other.sum())
    if n_other:
        del got, want
        labels = torch.where(other.reshape(labels.shape), -1, labels)
        loss_k, got, _ = run(MOE_MODEL_RANKS, labels)
        loss_p, want, _ = run(None, labels)
    model.model_ranks = MOE_MODEL_RANKS
    worst, worst_leaf = _leaf_rel_rms(got, want)
    del got, want, params, model
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "worst_leaf_rel_rms_err": worst, "worst_leaf": worst_leaf,
           "tokens_routed_otherwise": n_other,
           "tol": {"loss_rel": 1e-5, "leaf_rel_rms": 1e-3}}
    print(f"train {MOE}, one rank's gradient ({rows} x "
          f"{labels.shape[1]}, {MOE_TRAIN_LAYERS} layer at full width, f32) "
          f"through apply_ep over {MOE_MODEL_RANKS} model ranks and the "
          f"CUDA cscatter vs moe.apply and the plain combine: tokens routed "
          f"otherwise {n_other} (left out of the loss); loss {loss_k} vs "
          f"{loss_p}, worst leaf error RMS {worst:.3e} of its RMS "
          f"({worst_leaf}; tol 1e-3)")
    require(out["loss_rel_err"] <= 1e-5 and worst <= 1e-3,
            f"{MOE} train: the kernel path's gradient disagrees with the "
            f"plain path's: {out}")
    return out


def _smoke_data(cfg, steps_: int):
    """The smoke checks' optimizer (the config's, ``warmup_cosine`` over
    ``steps_``), its schedule and the Zipf data config of MOE_SMOKE_BATCH x
    MOE_SMOKE_SEQ."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import data_config_for
    from repro_torch.optim import make_optimizer, warmup_cosine
    lr = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, steps_)
    return (make_optimizer(cfg, lr), lr, data_config_for(cfg, ShapeConfig(
        "train", MOE_SMOKE_SEQ, MOE_SMOKE_BATCH, "train"), seed=SEED))


def _kimi_train() -> dict:
    """kimi-k2-1t's smoke config in f32 with ``moe_impl="ep"`` and the full
    config's Adafactor (the smoke config's is AdamW): 2 eager
    steps over MOE_TRAIN_PLAN (Adafactor), its MoE layers over
    MOE_SMOKE_RANKS model ranks, against the same steps through
    ``moe.apply`` on the same weights: each loss to MOE_SMOKE_TOL relative,
    each parameter leaf's largest error within MOE_SMOKE_TOL of 1 + its
    largest magnitude; ``cscatter`` launches of the ep run as the path
    predicts (remat "none": the combine once a MoE layer, the embedding
    backward once, a rank and a step)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_smoke_config(KIMI), dtype="float32",
                              moe_impl="ep",
                              optimizer=get_config(KIMI).optimizer)
    require(cfg.optimizer == "adafactor" and cfg.remat == "none"
            and cfg.first_dense_layers == 1 and cfg.n_shared_experts == 1,
            f"{KIMI} smoke: {cfg}")
    opt, _, dcfg = _smoke_data(cfg, 2)
    runs = {}
    for ranks in (MOE_SMOKE_RANKS, None):
        model = build_model(cfg, device="cuda", seed=SEED, model_ranks=ranks)
        step = steps.make_train_step(model, cfg, opt, merge_topology=(
            MergePlan.parse(MOE_TRAIN_PLAN)))
        params = model.params()
        state = {"params": params, "opt": opt.init(params)}
        cscatter.launches = 0
        losses = []
        for i in range(2):
            state, m = step(state, batch_at(dcfg, i))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs[ranks] = (losses, state["params"], cscatter.launches)
    (got_l, got_p, launches), (want_l, want_p, _) = (runs[MOE_SMOKE_RANKS],
                                                     runs[None])
    n_moe = cfg.n_layers - cfg.first_dense_layers
    want = LAUNCHES_PER_CALL * MOE_TRAIN_DP * 2 * (n_moe + 1)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_l, want_l))
    param_err = max(float((g - w).abs().max()) / (1 + float(w.abs().max()))
                    for g, w in zip(pytree.tree_leaves(got_p),
                                    pytree.tree_leaves(want_p)))
    out = {"losses": got_l, "losses_moe_apply": want_l,
           "loss_rel_err": loss_err, "param_err": param_err,
           "cscatter_launches": launches, "cscatter_predicted": want}
    print(f"train {KIMI} smoke f32, 2 eager steps over {MOE_TRAIN_DP} ranks "
          f"(Adafactor), apply_ep over {MOE_SMOKE_RANKS} model ranks vs "
          f"moe.apply: losses {got_l} vs {want_l} (rel err {loss_err:.3e}), "
          f"params {param_err:.3e} of 1 + each leaf's largest (tol "
          f"{MOE_SMOKE_TOL}); cscatter launches {launches} (predicted "
          f"{want})")
    require(all(np.isfinite(got_l)) and loss_err <= MOE_SMOKE_TOL
            and param_err <= MOE_SMOKE_TOL,
            f"{KIMI} train: apply_ep's steps are not moe.apply's: {out}")
    require(launches == want, f"{KIMI} train: cscatter launched {launches} "
                              f"times, the path predicts {want}")
    return out


def _moe_deferred_smoke() -> dict:
    """qwen3-moe-235b's smoke config (bf16, AdamW) with ``moe_impl="ep"``
    over MOE_SMOKE_RANKS model ranks, deferred with K = MOE_SMOKE_K over
    chip:2:defer: 3 steps (a commit at step K, a partial cycle the flush
    settles), every loss finite, the first cycle against AdamW on the mean
    of its batches' eager merges (``_first_cycle_check``)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_smoke_config(MOE), moe_impl="ep")
    n = MOE_SMOKE_K + 1
    opt, lr, dcfg = _smoke_data(cfg, n)
    model = build_model(cfg, device="cuda", seed=SEED,
                        model_ranks=MOE_SMOKE_RANKS)
    step = steps.make_train_step(
        model, cfg, opt, merge_topology=MergePlan.parse(
            MOE_TRAIN_PLAN + ":defer"),
        defer_schedule=DeferSchedule.fixed(MOE_SMOKE_K, ("chip",)))
    params0 = model.params()
    state = {"params": params0, "opt": opt.init(params0),
             "defer": step.init_defer_state(params0)}
    snaps, losses = {}, []
    for i in range(n):
        state, m = step(state, batch_at(dcfg, i))
        losses.append(float(m["loss"]))
        if i + 1 == MOE_SMOKE_K:
            host = lambda x: x.to("cpu", copy=True)   # noqa: E731
            snaps["params"] = pytree.tree_map(host, state["params"])
            snaps["mu"] = pytree.tree_map(host, state["opt"].mu)
    state, fm = step.flush(state)
    torch.cuda.synchronize()
    require(all(np.isfinite(losses)) and fm is not None
            and fm.get("flushed_steps") == n % MOE_SMOKE_K,
            f"{MOE} smoke deferred: losses {losses}, flush {fm}")
    print(f"train {MOE} smoke deferred K={MOE_SMOKE_K} over "
          f"{MOE_TRAIN_DP} ranks, apply_ep over {MOE_SMOKE_RANKS} model "
          f"ranks: losses {losses}; flush of {fm['flushed_steps']} step")
    return {"losses": losses, "first_cycle": _first_cycle_check(
        f"train {MOE} smoke", model, opt, dcfg, params0, snaps,
        MOE_TRAIN_PLAN, MOE_SMOKE_K, MOE_TRAIN_DP, float(lr(1)))}


def _donate_check() -> dict:
    """The donating optimizer step (``Optimizer.step(..., donate=True)``)
    against the functional one on the card: AdamW (qwen3-moe-235b's smoke
    tree) and Adafactor (kimi-k2-1t's, its full config's optimizer), bf16
    and f32, 3 steps on seeded
    gradients from the same state: the parameters and every moment equal
    bit for bit, the donated tensors updated in place. Held at the
    optimizer: the train step's backward need not repeat its bits on the
    card (atomics in PyTorch's index backward)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.models.registry import build_model
    out = {}
    for arch in (MOE, KIMI):
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                      optimizer=get_config(arch).optimizer)
            opt, _, _ = _smoke_data(cfg, 3)
            params = build_model(cfg, device="cuda", seed=SEED).params()
            g = torch.Generator(device="cuda").manual_seed(SEED + 11)
            func = (params, opt.init(params))
            clone = lambda t: pytree.tree_map(            # noqa: E731
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x, t)
            don = clone(func)
            mine = pytree.tree_leaves(don)
            for _ in range(3):
                grads = pytree.tree_map(lambda p: (torch.randn(
                    p.shape, device="cuda", generator=g) * 30).to(p.dtype),
                    params)
                p, o, _ = opt.step(func[0], clone(grads), func[1])
                func = (p, o)
                p, o, _ = opt.step(don[0], grads, don[1], donate=True)
                don = (p, o)
            torch.cuda.synchronize()
            got, want = pytree.tree_leaves(don), pytree.tree_leaves(func)
            tensors = [(a, b) for a, b in zip(got, want)
                       if isinstance(a, torch.Tensor) and a.dim() > 0]
            equal = all(torch.equal(a, b) for a, b in tensors)
            in_place = all(a is b for a, b in zip(
                [x for x in pytree.tree_leaves(don)
                 if isinstance(x, torch.Tensor) and x.dim() > 0],
                [x for x in mine if isinstance(x, torch.Tensor)
                 and x.dim() > 0]))
            out[f"{cfg.optimizer}_{dtype}"] = {"bitwise": equal,
                                               "in_place": in_place,
                                               "leaves": len(tensors)}
            require(equal and in_place, f"donated {cfg.optimizer} {dtype}: "
                                        f"bitwise {equal}, in place "
                                        f"{in_place}")
    print(f"donated optimizer steps vs functional ones, 3 steps each: "
          f"{out}")
    return out


def _moe_train(card: str) -> dict:
    """(k) qwen3-moe-235b trained at full width, MOE_TRAIN_LAYERS of 94
    layers (bf16, remat "full", random weights from the seed), through
    ``launch/train.py``'s ``build`` with the CLI's flags: ``--model-ranks
    MOE_MODEL_RANKS`` (the MoE layer through ``moe_ep.apply_ep``, its
    token combine one ``cscatter`` call over a ``[4, 2048, 4096]`` stack)
    and ``--donate``, MOE_TRAIN_STEPS eager steps of MOE_TRAIN_BATCH x
    MOE_TRAIN_SEQ over MOE_TRAIN_PLAN's 2 stacked data ranks. Checks: every
    loss finite; ``cscatter`` launches as MOE_TRAIN_CALLS predicts, no
    attention kernel launched (training attends through ``attend_full``);
    the peak device memory under the card's. Prints ms a step, the
    router's aux loss, z and drop share after the run, the profiler's idle
    share and top operations of one more step. Then, the bf16 state freed,
    the kernel path's f32 gradient against the plain path's
    (``_moe_grad_check``), and at the smoke configs the expert-parallel
    train steps (``_kimi_train``, ``_moe_deferred_smoke``) and the
    donating optimizer (``_donate_check``)."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL, cscatter
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps, train
    gc.collect()
    torch.cuda.empty_cache()
    t = train.build(train.parse_args([
        "--arch", MOE, "--layers", str(MOE_TRAIN_LAYERS), "--model-ranks",
        str(MOE_MODEL_RANKS), "--donate", "--steps", str(MOE_TRAIN_STEPS),
        "--batch", str(MOE_TRAIN_BATCH), "--seq", str(MOE_TRAIN_SEQ),
        "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP), "--seed",
        str(SEED), "--device", "cuda", "--merge-topology", MOE_TRAIN_PLAN]))
    cfg, model = t.cfg, t.model
    require(t.dp == MOE_TRAIN_DP and cfg.remat == "full"
            and cfg.moe_impl == "ep" and model.model_ranks == MOE_MODEL_RANKS
            and t.step_fn.donates and (cfg.n_layers, cfg.d_model,
                                       cfg.n_experts, cfg.top_k,
                                       cfg.d_ff_expert)
            == (MOE_TRAIN_LAYERS, 4096, 128, 8, 1536),
            f"{MOE} train: {t.dp} ranks, {cfg}, model ranks "
            f"{model.model_ranks}")
    state, t.state = t.state, None
    batches = [batch_at(t.dcfg, i) for i in range(MOE_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cscatter.launches = flash_attention.launches = 0
    decode_attention.launches = 0
    rec = []
    for i, batch in enumerate(batches[:MOE_TRAIN_STEPS]):
        t0 = time.perf_counter()
        state, m = t.step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = float(m["loss"])
        require(np.isfinite(loss), f"{MOE} train step {i}: loss {loss}")
        rec.append({"ms": 1e3 * dt, "loss": loss,
                    "grad_norm": float(m["grad_norm"])})
        print(f"train {MOE} step {i}: loss {loss:.6f} grad norm "
              f"{rec[-1]['grad_norm']:.6f} {1e3 * dt:.3f} ms")
    launches = {"cscatter": cscatter.launches,
                "flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    n_moe = cfg.n_layers - cfg.first_dense_layers
    calls = (t.dp * t.microbatches * MOE_TRAIN_STEPS
             * (MOE_TRAIN_CALLS["combine"] * n_moe
                + MOE_TRAIN_CALLS["embedding"]))
    want = {"cscatter": LAUNCHES_PER_CALL * calls, "flash_attention": 0,
            "decode_attention": 0}
    ms = statistics.median(r["ms"] for r in rec[1:])      # step 0 warms up
    print(f"train {MOE} ({MOE_TRAIN_LAYERS} of 94 layers, full width) eager"
          f" over {t.dp} data ranks x {MOE_MODEL_RANKS} model ranks, "
          f"donating AdamW, on {card}: {ms:.3f} ms a step, "
          f"{MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (ms / 1e3):.1f} tokens/s, "
          f"peak memory {peak} bytes of {total}; launches {launches} "
          f"(predicted {want})")
    require(launches == want, f"{MOE} train: launches {launches}, "
                              f"predicted {want}")
    require(peak < total, f"{MOE} train: peak {peak} of {total} bytes")
    with torch.no_grad():
        shard = steps.to_device({k: v[:MOE_TRAIN_BATCH // t.dp]
                                 for k, v in batches[0].items()}, "cuda")
        _, lm = model.loss(state["params"], shard)
    router = {k: float(lm[k]) for k in ("aux_loss", "router_z",
                                        "drop_frac")}
    print(f"train {MOE} after {MOE_TRAIN_STEPS} steps, rank 0's row of "
          f"batch 0: {router}")
    require(all(np.isfinite(v) for v in router.values()),
            f"{MOE} train: router metrics {router}")
    prof, state = profile_train_step(t.step_fn, state, batches[-1])
    prof["idle_share"] = 1 - prof["device_ms"] / ms
    print(f"train {MOE} profile of one eager step: device "
          f"{prof['device_ms']:.3f} ms against {ms:.3f} ms a step untraced "
          f"(idle share {prof['idle_share']:.3f}), {prof['launches']} "
          f"launches; by range (ms) "
          f"{ {k: round(v, 3) for k, v in prof['by_range_ms'].items()} }; "
          f"top operations (ms) "
          f"{ {k: round(v, 3) for k, v in prof['top_ops_ms'].items()} }")
    out = {"steps": rec, "ms_per_step": ms, "peak_bytes": peak,
           "card_bytes": total, "launches": launches,
           "launches_predicted": want, "router": router,
           "profile_eager_step": prof, "card": card,
           "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (ms / 1e3)}
    dcfg = t.dcfg
    del t, model, state
    gc.collect()
    torch.cuda.empty_cache()
    out["f32_gradient"] = _moe_grad_check(dcfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["kimi_smoke"] = _kimi_train()
    out["deferred_smoke"] = _moe_deferred_smoke()
    out["donate"] = _donate_check()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _vlm_batch(model) -> dict:
    """The VLM's serve batch: the text prompt ids (drawn as the serve CLI
    draws prompts) and embeds ``[FAMILY_BATCH, VLM_PATCHES + VLM_TEXT,
    d]`` in the parameters' dtype: seeded patch rows, then the prompt's
    rows of the model's table."""
    import torch
    from repro_torch.launch.serve import prompts
    cfg = model.cfg
    ids = torch.as_tensor(prompts(cfg, FAMILY_BATCH, VLM_TEXT, SEED),
                          device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    patches = torch.randn((FAMILY_BATCH, VLM_PATCHES, cfg.d_model),
                          device="cuda", generator=g) * 0.02
    table = model.embed["table"]
    return {"tokens": ids, "embeds": torch.cat(
        [patches.to(table.dtype), table[ids]], dim=1)}


def _vlm_serve(card: str) -> dict:
    """(h) llava-next-34b's backbone at full width, VLM_LAYERS layers,
    bf16, prefilled from embeds ``[8, 640, 7168]`` (patch rows, then the
    text prompt's table rows) and VLM_GEN tokens: one flash launch a layer
    (G = 7), a ``decode_attention`` call a layer a step (``GMAX = 8``), no
    ``cscatter``. Held to the same weights in f32 through the plain
    attention on every row (the families' rule)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    cfg = dataclasses.replace(get_config(VLM), n_layers=VLM_LAYERS)
    require(cfg.family == "vlm" and cfg.n_heads // cfg.n_kv_heads == 7,
            f"{VLM}: family {cfg.family}, heads {cfg.n_heads} over "
            f"{cfg.n_kv_heads}")
    prompt = VLM_PATCHES + VLM_TEXT
    want = {"flash_attention": VLM_LAYERS, "flash_attention_windowed": 0,
            "flash_attention_bidirectional": 0,
            "decode_attention": VLM_LAYERS * (VLM_GEN - 1)
            * LAUNCHES_PER_CALL, "cscatter": 0}
    model, batch, res, row = _serve_family(VLM, cfg, prompt, VLM_GEN, card,
                                           want, batch=_vlm_batch)
    require(tuple(batch["embeds"].shape) == (FAMILY_BATCH, prompt,
                                             cfg.d_model),
            f"{VLM}: embeds {tuple(batch['embeds'].shape)}")
    out = _plain_teacher_forced(model, batch, res, prompt, f"serve {VLM}",
                                f32_floor=True)
    row.update(out, layers=VLM_LAYERS, embeds=list(batch["embeds"].shape))
    del model, res, batch
    return row


def _kimi_serve(card: str) -> dict:
    """(i) kimi-k2-1t's smoke config (a shared expert, a dense first
    layer) in f32 on the card: the kernel path — flash at prefill, decode
    steps, the ``cscatter`` combine of each MoE layer — against the plain
    path (the plain attention and ``cscatter_plain_`` for the combine) on
    the same tokens: logits within KIMI_TOL, the same expert ids in every
    layer, no kernel launched by the plain path."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL as CS_CALL
    from repro_torch.kernels.cscatter import cscatter
    from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = dataclasses.replace(get_smoke_config(KIMI), dtype="float32")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    require(cfg.first_dense_layers == 1 and cfg.n_shared_experts == 1,
            f"{KIMI}: dense layers {cfg.first_dense_layers}, shared "
            f"experts {cfg.n_shared_experts}")
    want = {"flash_attention": cfg.n_layers, "flash_attention_windowed": 0,
            "flash_attention_bidirectional": 0,
            "decode_attention": cfg.n_layers * (KIMI_GEN - 1)
            * LAUNCHES_PER_CALL,
            "cscatter": n_moe * KIMI_GEN * CS_CALL}
    served = _Routes()
    model, batch, res, row = _serve_family(
        f"{KIMI} smoke f32", cfg, KIMI_PROMPT, KIMI_GEN, card, want,
        variant="f32_fma", around=lambda: served)
    require("dense" in model.prefill(torch.as_tensor(
        batch["tokens"][:, :4], device="cuda"), 8)[1], f"{KIMI}: no dense "
        f"caches")
    before = (flash_attention.launches, decode_attention.launches,
              cscatter.launches)
    model.impl = "plain"
    try:
        with _PlainScatter(), _Routes() as plain_ids:
            plain = _teacher_forced(model, batch, res, KIMI_PROMPT)
    finally:
        model.impl = "kernel"
    require(before == (flash_attention.launches, decode_attention.launches,
                       cscatter.launches),
            f"{KIMI}: the plain path launched a kernel")
    got_ids = served.steps(n_moe, FAMILY_BATCH)
    want_ids = plain_ids.steps(n_moe, FAMILY_BATCH)
    require(all(torch.equal(a, b) for x, y in zip(got_ids, want_ids)
                for a, b in zip(x, y)), f"{KIMI}: the kernel path routed a "
                                        f"token to other experts")
    worst = max(float((g - p).abs().max()) for g, p in zip(res.logits,
                                                           plain))
    require(worst <= KIMI_TOL, f"{KIMI}: kernel logits {worst} from the "
                               f"plain path's, above {KIMI_TOL}")
    print(f"serve {KIMI} smoke f32 vs its plain path (plain attention, "
          f"plain combine), teacher-forced over {KIMI_GEN} steps: max "
          f"|logit diff| {worst} <= {KIMI_TOL}; expert ids equal in all "
          f"{n_moe} MoE layers of every step")
    row.update(max_logit_err=worst, same_expert_ids=True)
    del model, res, plain
    return row


def phase_families(card: str) -> dict:
    """The model families' paths, each with the kernels' counts zeroed just
    before and read just after: (a) hymba-1.5b served at full width, (j)
    hymba-1.5b trained at full width and depth, (b)
    xlstm-125m served at full width, (c) the GELU MLP, (d) the real-model
    chaos of xlstm-125m at full width, (e) seamless-m4t-medium served and
    (f) trained at full width, (g) qwen3-moe-235b served and (k) trained
    at full width, (h) llava-next-34b served at full width, (i) kimi-k2-1t's
    smoke config in f32."""
    out = {}
    for name, fn in (("hymba", _hymba_serve), ("hymba_train", _hymba_train),
                     ("xlstm", _xlstm_serve),
                     ("gelu", _gelu_serve), ("chaos", _real_model_chaos),
                     ("encdec", _encdec_serve),
                     ("encdec_train", _encdec_train), ("moe", _moe_serve),
                     ("moe_train", _moe_train), ("vlm", _vlm_serve),
                     ("kimi", _kimi_serve)):
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


# The embedding backwards the train paths launch: (the model, its table's
# rows, the train batch, its ranks); N = one rank's rows x TRAIN_SEQ = 1024
EMBED_TABLES = ((ARCH, TRAIN_V, TRAIN_BATCH, TRAIN_DP),
                (ENCDEC, ENCDEC_V, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_DP))


def _embedding_ids(arch: str, batch: int, ranks: int):
    """One rank's ids of ``arch``'s train batch 0 (``batch`` rows of
    TRAIN_SEQ Zipf tokens over ``ranks``), flattened."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_at, data_config_for
    dcfg = data_config_for(get_config(arch), ShapeConfig(
        "train", TRAIN_SEQ, batch, "train"), seed=SEED)
    tokens = batch_at(dcfg, 0)["tokens"][:batch // ranks]
    return torch.as_tensor(tokens.reshape(-1), device="cuda")


def embedding_kernel_checks() -> float:
    """``cscatter`` at each embedding backward's shape of
    ``EMBED_TABLES`` ([151936, 1024] and [256256, 1024]) with one rank's N
    = 1024 Zipf ids, bf16 (the table's dtype) and f32 (what the train path
    launches), against its plain version."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for (arch, rows, batch, ranks), dtype in (
            (e, dt) for e in EMBED_TABLES
            for dt in (torch.bfloat16, torch.float32)):
        ids = _embedding_ids(arch, batch, ranks)
        table = torch.randn((rows, TRAIN_D), device="cuda",
                            generator=g).to(dtype)
        vals = torch.randn((ids.numel(), TRAIN_D), device="cuda",
                           generator=g).to(dtype)
        want = cscatter_plain(table, ids, vals)
        got = cscatter(table.clone(), ids, vals)
        torch.cuda.synchronize()
        err = _compare(got, want)
        worst = max(worst, err)
        print(f"check cscatter {str(dtype)[6:]} [{rows},{TRAIN_D}] "
              f"N={ids.numel()} add {arch} embedding-backward ids: ok (max "
              f"abs err {err})")
        del table, vals, want, got
    return worst


# qwen3-moe-235b's token combine: a zero bf16 [t, 4096] table, each
# token's 8 expert outputs (ids arange(8 t) // 8; a dropped assignment a
# zero row) at the prefill (t = 8 x 512) and decode (t = 8) shapes, and the
# expert-parallel train path's [4, 2048, 4096] stack (MOE_MODEL_RANKS
# shards, one a model rank, each with all of a data rank's 16384
# assignments, nonzero in the shard of the assignment's expert): (shards,
# t, d, k)
COMBINE_SHAPES = ((1, FAMILY_BATCH * MOE_PROMPT, 4096, 8),
                  (1, FAMILY_BATCH, 4096, 8),
                  (MOE_MODEL_RANKS, MOE_TRAIN_TOKENS, 4096, 8))


def _combine_inputs(s: int, t: int, d: int, k: int, g):
    """The combine's ids and bf16 vals: expert outputs of the scale of a
    hidden state, a tenth of the assignments dropped to zero rows; with s >
    1 shards, ids ``[s, t k]`` and vals ``[s, t k, d]``, each assignment
    nonzero in one shard (its expert's model rank), else ``[t k]`` and
    ``[t k, d]``."""
    import torch
    ids = (torch.arange(t * k, device="cuda") // k).to(torch.int32)
    vals = torch.randn((t * k, d), device="cuda", generator=g) * 0.1
    vals[torch.rand(t * k, device="cuda", generator=g) < 0.1] = 0
    if s == 1:
        return ids, vals.to(torch.bfloat16)
    owner = torch.randint(0, s, (t * k,), device="cuda", generator=g)
    mine = owner == torch.arange(s, device="cuda")[:, None]
    return (ids.expand(s, -1).contiguous(),
            torch.where(mine[..., None], vals.to(torch.bfloat16), 0))


def _combine_table(s: int, t: int, d: int):
    import torch
    return torch.zeros(((s,) if s > 1 else ()) + (t, d),
                       dtype=torch.bfloat16, device="cuda")


def moe_combine_kernel_checks() -> float:
    """``cscatter`` at the MoE combine's shapes (``COMBINE_SHAPES``) into
    a zero bf16 table, against its plain version."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst = 0.0
    for s, t, d, k in COMBINE_SHAPES:
        ids, vals = _combine_inputs(s, t, d, k, g)
        table = _combine_table(s, t, d)
        want = cscatter_plain(table, ids, vals)
        got = cscatter(table, ids, vals)
        torch.cuda.synchronize()
        err = _compare(got, want)
        worst = max(worst, err)
        print(f"check cscatter bf16 {list(table.shape)} N={t * k} a shard "
              f"add {MOE} token combine: ok (max abs err {err})")
        del ids, vals, table, want, got
    return worst


def moe_combine_kernel_times() -> list[dict]:
    """The MoE combine's ``cscatter`` timed as the other rows at
    ``COMBINE_SHAPES``: kernel (CUDA graph), a call, the plain version,
    ``index_add_`` over the flattened table (graph and a call), both
    graphs again from inputs out of the L2 (``cold_ms``,
    ``library_cold_ms``: sets of inputs rotated through, COLD_BYTES in
    all and at least two) and the bound."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain_
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    out = []
    for s, t, d, k in COMBINE_SHAPES:
        ids, vals = _combine_inputs(s, t, d, k, g)
        table = _combine_table(s, t, d)
        flat = table.view(-1, d)
        sets = [(ids, vals)] + [_combine_inputs(s, t, d, k, g) for _ in range(
            max(1, -(-int(COLD_BYTES) // vals.nbytes) - 1))]
        lib_sets = [((i.long() + t * torch.arange(
            s, device="cuda")[:, None]).reshape(-1) if s > 1 else i.long(),
            v.reshape(-1, d)) for i, v in sets]
        bound, bound_by = scatter_bound_ms(ids.reshape(s, -1), d, 2, r=t)

        def kernel():
            cscatter(table, ids, vals)

        def lib():
            flat.index_add_(0, *lib_sets[0])
        row = {"kind": "add", "what": "moe_combine", "arch": MOE,
               "dtype": "bfloat16", "shape": list(table.shape), "n": t * k,
               "ms": graph_ms(kernel), "call_ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: cscatter_plain_(table, ids, vals)),
               "library_ms": graph_ms(lib), "library_call_ms": time_ms(lib),
               "cold_ms": graph_ms(rotating(
                   lambda i, v: cscatter(table, i, v), sets)),
               "library_cold_ms": graph_ms(rotating(
                   lambda i, v: flat.index_add_(0, i, v), lib_sets)),
               "bound_ms": bound, "bound_by": bound_by}
        print(f"time cscatter add bf16 {row['shape']} N={t * k} a shard "
              f"({MOE} token combine): kernel {row['ms']:.6f} ms [cold "
              f"{row['cold_ms']:.6f}] (a call {row['call_ms']:.6f} ms), "
              f"plain {row['plain_ms']:.6f} ms, index_add_ "
              f"{row['library_ms']:.6f} ms [cold {row['library_cold_ms']:.6f}]"
              f" (a call {row['library_call_ms']:.6f} ms), bound "
              f"{bound:.6f} ms ({bound_by})")
        out.append(row)
        del table, flat, ids, vals, sets, lib_sets
    return out


def embedding_kernel_times() -> list[dict]:
    """The embedding backward's ``cscatter`` timed as the other rows: the
    kernel (CUDA graph), a call, the plain version, ``index_add_`` (device
    time from a CUDA graph, and a call) and the bound in bytes, at each
    table of ``EMBED_TABLES``."""
    import torch
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain_
    out = []
    for (arch, rows, batch, ranks), dtype in (
            (e, dt) for e in EMBED_TABLES
            for dt in (torch.bfloat16, torch.float32)):
        ids = _embedding_ids(arch, batch, ranks)
        n = ids.numel()
        table = torch.zeros((rows, TRAIN_D), dtype=dtype, device="cuda")
        vals = torch.ones((n, TRAIN_D), dtype=dtype, device="cuda")
        lids = ids.long()
        bound, bound_by = scatter_bound_ms(ids[None], TRAIN_D,
                                           table.element_size(), r=rows)

        def kernel():
            cscatter(table, ids, vals)

        def lib():
            table.index_add_(0, lids, vals)
        row = {"kind": "add", "what": "embedding_backward", "arch": arch,
               "dtype": str(dtype)[6:], "shape": [rows, TRAIN_D], "n": n,
               "ms": graph_ms(kernel), "call_ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: cscatter_plain_(table, ids, vals)),
               "library_ms": graph_ms(lib), "library_call_ms": time_ms(lib),
               "bound_ms": bound, "bound_by": bound_by}
        print(f"time cscatter add {row['dtype']} [{rows},{TRAIN_D}] N={n} "
              f"({arch} embedding backward): kernel {row['ms']:.6f} ms (a call "
              f"{row['call_ms']:.6f} ms), plain {row['plain_ms']:.6f} ms, "
              f"index_add_ {row['library_ms']:.6f} ms (a call "
              f"{row['library_call_ms']:.6f} ms), bound {bound:.6f} ms "
              f"({bound_by})")
        out.append(row)
        del table, vals
    return out


def _train_argv(variant: str, n: int, ckpt_dir: str,
                layers: int | None = None) -> list[str]:
    argv = ["--arch", ARCH, "--steps", str(n), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--warmup",
            str(TRAIN_WARMUP), "--seed", str(SEED), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(1 << 30), "--device", "cuda"]
    if layers is not None:
        argv += ["--layers", str(layers)]
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


def _embedding_backward_check(grads_of, params, batch,
                              rows: int = TRAIN_BATCH // TRAIN_DP) -> dict:
    """One rank's gradient of the embedding table (the first ``rows`` rows
    of ``batch``) with the backward through the CUDA ``cscatter`` and
    through the plain version: each row to 1e-2 of its RMS (the kernel sums
    the row's ids in another order before the one bf16 rounding; the tied
    logits term is the same product in both)."""
    import torch
    from repro_torch.kernels.cscatter import cscatter_plain_
    from repro_torch.models import embedding
    shard = {k: v[:rows] for k, v in batch.items()}
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
          f"{shard['tokens'].numel()} ids into {list(want.shape)} (tied):"
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
    """Training of qwen1.5-0.5b at full width, TRAIN_LAYERS of its 24
    layers (bf16, tied, remat "dots", random weights from the seed) on the
    pipeline's Zipf stream, batch TRAIN_BATCH x TRAIN_SEQ over TRAIN_DP
    stacked ranks,
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
            t = train.build(train.parse_args(_train_argv(variant, n, tmp,
                                                         TRAIN_LAYERS)))
            require(t.dp == TRAIN_DP and t.cfg.remat == "dots"
                    and t.cfg.n_layers == TRAIN_LAYERS,
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
                                                 root, ELASTIC_LAYERS)))
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
    """(b) qwen1.5-0.5b at full width (ELASTIC_LAYERS layers), killed and
    resumed twice.
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
    p = dataclasses.replace(get_config(ARCH),
                            n_layers=ELASTIC_LAYERS).n_params()
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
                                                 root, ELASTIC_LAYERS)))
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
    argv = _train_argv("deferred", RESUME_STEPS, root, ELASTIC_LAYERS)
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
    qwen1.5-0.5b run of ``phase_train`` at full width, ELASTIC_LAYERS of
    its 24 layers, killed by a real SIGKILL in a child process
    (:func:`train_crash_child`) after its checkpoint of step RESUME_CKPT,
    then resumed through
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


def phase_pipeline(card: str) -> dict:
    """The GPipe schedule on the card (module doc, item 14). The stage
    function runs each stage's layer on that stage's own slice of the
    stacked input, so the serial run through the same function is the
    bitwise reference. ``flash_attention``'s counts are zeroed just before
    the pipeline's run and read just after."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import get_config
    from repro_torch.core.stacked import StackedAxis
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import prompts
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import bubble_fraction, pipeline_apply
    cfg = dataclasses.replace(get_config(ARCH), n_layers=PIPE_STAGES)
    require(cfg.d_model == 1024, f"pipeline: {ARCH} is not at full width")
    model = build_model(cfg, device="cuda", seed=SEED)
    require(model.embed["table"].dtype == torch.bfloat16,
            "pipeline: the model is not in bf16")
    axis = StackedAxis(PIPE_STAGES, "cuda")
    ids = prompts(cfg, PIPE_MICRO * PIPE_MB, PROMPT, SEED)
    with torch.no_grad():
        x = model._input(model.embed["table"], torch.as_tensor(
            ids, device="cuda"), None).reshape(
                PIPE_MICRO, PIPE_MB, PROMPT, cfg.d_model)
    positions = torch.arange(PROMPT, dtype=torch.int32, device="cuda")
    scan = model._caches(PIPE_STAGES, PIPE_MB, PROMPT, x.dtype)
    caches = [attn.KVCache(k=scan.k[i], v=scan.v[i])
              for i in range(PIPE_STAGES)]
    params = model.params()["blocks"]

    def stage_fn(p, xs):
        return torch.stack([model._block_prefill(
            pytree.tree_map(lambda a: a[i], p), xs[i], positions, caches[i])
            for i in range(xs.shape[0])])

    def piped():
        stream = x[None].expand((PIPE_STAGES,) + tuple(x.shape))
        return pipeline_apply(stage_fn, params, stream, axis)

    def serial():
        out = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for i in range(PIPE_STAGES):
                h = model._block_prefill(
                    pytree.tree_map(lambda a: a[i], params), h, positions,
                    caches[i])
            out.append(h)
        return torch.stack(out)

    ticks = PIPE_MICRO + PIPE_STAGES - 1
    with torch.no_grad():
        piped()                                   # warm-up, not counted
        torch.cuda.synchronize()
        flash_attention.launches = 0
        flash_attention.launches_by_variant = dict.fromkeys(
            flash_attention.launches_by_variant, 0)
        got = piped()
        torch.cuda.synchronize()
        launches = flash_attention.launches
        by_variant = dict(flash_attention.launches_by_variant)
        want = serial()
        require(got.shape == (PIPE_STAGES, PIPE_MICRO, PIPE_MB, PROMPT,
                              cfg.d_model), f"pipeline: {tuple(got.shape)}")
        require(bool(torch.isfinite(got[-1]).all()),
                "pipeline: non-finite outputs")
        require(torch.equal(got[-1], want), "pipeline: the last stage's "
                f"outputs differ from the serial run by "
                f"{float((got[-1].float() - want.float()).abs().max())}")
        require(not bool(got[:-1].any()),
                "pipeline: a stage but the last banked outputs")
        require(launches == PIPE_STAGES * ticks
                and by_variant["bf16_mma"] == launches,
                f"pipeline: flash_attention launches {launches} "
                f"({by_variant}), the schedule predicts "
                f"{PIPE_STAGES * ticks} bf16_mma")
        ms = time_ms(piped, samples=5, inner=1)
        serial_ms = time_ms(serial, samples=5, inner=1)
    out = {"stages": PIPE_STAGES, "n_micro": PIPE_MICRO, "ticks": ticks,
           "microbatch": [PIPE_MB, PROMPT], "ms": ms, "serial_ms": serial_ms,
           "overhead": ms / serial_ms,
           "schedule_overhead": ticks / PIPE_MICRO,
           "bubble_fraction": bubble_fraction(PIPE_STAGES, PIPE_MICRO),
           "launches": {"flash_attention": launches},
           "flash_launches_by_variant": by_variant, "bitwise": True}
    print(f"pipeline {cfg.name} bf16, {PIPE_STAGES} stages x {PIPE_MICRO} "
          f"microbatches of {PIPE_MB} x {PROMPT} on {card}: {ms:.3f} ms "
          f"({ticks} ticks) against {serial_ms:.3f} ms serial: "
          f"{out['overhead']:.4f}x, the schedule's (n_micro + S - 1) / "
          f"n_micro {out['schedule_overhead']:.4f}x (bubble fraction "
          f"{out['bubble_fraction']:.4f}); outputs bitwise equal to the "
          f"serial run; flash_attention launches {launches} ({by_variant})")
    del model, got, want, x, scan, caches
    torch.cuda.empty_cache()
    return out


def _lint_kernel_checks() -> dict:
    """``cscatter`` and ``cmerge`` against their plain versions at the
    shapes the verifier's serve sweep gives them (``analysis/cli.py``: S =
    8 shards of a ``[256, 2]`` int32 add table, a tick of 32 updates a
    shard and a partitioned commit's ring of 4 ticks; the blocked stores'
    ways of 8 rows: one at an eviction, 8 at a cache flush, the 64-block
    spill at its drain). Launches here are comparisons and are not
    counted; returns the worst errors (integers: exact)."""
    import torch
    from repro_torch.analysis import cli
    from repro_torch.kernels.cmerge import cmerge, cmerge_plain
    from repro_torch.kernels.cscatter import cscatter, cscatter_plain
    from repro_torch.serve.kv import KVConfig
    s, r, d = cli.SERVE_SHARDS, cli.SERVE_KEYS, cli.SERVE_COLS
    cfg = KVConfig(n_keys=r, cols=d, engine="blocked")
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    table = _rand_table(g, (s, r, d), torch.int32, 0, 1 << 20)
    worst = {"cscatter": 0.0, "cmerge": 0.0}
    for n in (cli.SERVE_BATCH, cli.SERVE_K * cli.SERVE_BATCH):
        ids = torch.randint(0, r, (s, n), device="cuda", generator=g,
                            dtype=torch.int32)
        vals = _rand_table(g, (s, n, d), torch.int32, 1, 9)
        want = cscatter_plain(table, ids, vals, kind="add")
        got = cscatter(table.clone(), ids, vals, kind="add")
        torch.cuda.synchronize()
        worst["cscatter"] = max(worst["cscatter"], _compare(got, want))
    br = cfg.block_rows
    for w in (1, cfg.ways, cfg.spill_blocks):
        ids = _ways(g, s, r // br, min(w, r // br))
        if w > ids.shape[1]:            # the spill's unused slots: invalid
            ids = torch.cat([ids, torch.full((s, w - ids.shape[1]), -1,
                                             dtype=torch.int32,
                                             device="cuda")], 1)
        dirty = torch.rand(ids.shape, device="cuda", generator=g) < 0.7
        src = _rand_table(g, (s, ids.shape[1], br, d), torch.int32, 0, 9)
        upd = src + _rand_table(g, src.shape, torch.int32, 0, 9)
        want = cmerge_plain(table, ids, dirty, src, upd, kind="add")
        got = cmerge(table.clone(), ids, dirty, src, upd, kind="add")
        torch.cuda.synchronize()
        worst["cmerge"] = max(worst["cmerge"], _compare(got, want))
    print(f"check lint shapes: cscatter [{s},{r},{d}] int32 add N = "
          f"{cli.SERVE_BATCH}, {cli.SERVE_K * cli.SERVE_BATCH} and cmerge "
          f"W = 1, {cfg.ways}, {cfg.spill_blocks} (capped at {r // br} "
          f"blocks) BR = {br} equal their plain versions")
    return worst


def phase_lint() -> dict:
    """The static verifier on the card (module doc, item 15): the kernels
    at the sweep's shapes against their plain versions, the sweep
    in-process through the CLI's entry point with the kernels' counts
    zeroed just before and read just after (they must equal
    LINT_LAUNCHES), and the fixtures."""
    import torch
    from repro_torch.analysis import cli
    from repro_torch.kernels.cmerge import cmerge
    from repro_torch.kernels.cscatter import cscatter
    worst = _lint_kernel_checks()
    work = tempfile.mkdtemp(prefix="lint-")
    try:
        path = os.path.join(work, "lint.json")
        torch.cuda.synchronize()
        cscatter.launches = cmerge.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--device", "cuda", "--json", path])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = {"cscatter": cscatter.launches, "cmerge": cmerge.launches}
        with open(path) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(rc == 0 and report["ok"] and not report["diagnostics"],
            f"lint: the sweep found {report['diagnostics']}")
    require(launches == LINT_LAUNCHES,
            f"lint: the sweep launched {launches}, not {LINT_LAUNCHES}")
    t0 = time.perf_counter()
    fixtures = cli.run_fixtures("cuda")
    fixtures_s = time.perf_counter() - t0
    missed = [r["name"] for r in fixtures if not r["tripped"]]
    require(not missed, f"lint: fixtures {missed} did not trip their codes")
    out = {"sites": len(report["checked"]), "sweep_s": sweep_s,
           "fixtures": len(fixtures), "fixtures_s": fixtures_s,
           "launches": launches, "max_abs_err": worst}
    print(f"lint on the card: {out['sites']} sites swept in {sweep_s:.3f} "
          f"s, no finding, launching cscatter {launches['cscatter']} and "
          f"cmerge {launches['cmerge']} times (as LINT_LAUNCHES); "
          f"{len(fixtures)} fixtures tripped in {fixtures_s:.3f} s")
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
    scan_rows = timed("scan", phase_scan)
    serve = timed("serve", phase_serve, smi)
    apps = timed("apps", phase_apps, smi)
    trained = timed("train", phase_train, smi)
    elastic = timed("elastic", phase_elastic, smi)
    families = timed("families", phase_families, smi)
    pipeline = timed("pipeline", phase_pipeline, smi)
    lint = timed("lint", phase_lint)

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
        "launches_encdec_train": families["encdec_train"][
            "cscatter_launches"],
        "launches_moe": families["moe"]["launches"]["cscatter"],
        "launches_moe_train": families["moe_train"]["launches"]["cscatter"],
        "launches_vlm": families["vlm"]["launches"]["cscatter"],
        "launches_kimi": families["kimi"]["launches"]["cscatter"],
        "launches_lint": lint["launches"]["cscatter"],
        "moe_combine": [t for t in times if t.get("what") == "moe_combine"],
        "determinism": determinism,
        "train_embedding_backward": train_add,
        "variants": times, "apps": apps["kernel_rows"]}, {
        "name": "cmerge", "route": "cuda",
        "source": "src/repro_torch/csrc/cmerge.cu",
        "replaces": REPLACES_CMERGE,
        "launches": blocked_path["cmerge"],
        "launches_lint": lint["launches"]["cmerge"],
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
        "launches_encdec": families["encdec"]["launches"][name],
        "launches_moe": families["moe"]["launches"][name],
        "launches_moe_train": families["moe_train"]["launches"][name],
        "launches_vlm": families["vlm"]["launches"][name],
        "launches_kimi": families["kimi"]["launches"][name],
        "launches_pipeline": pipeline["launches"].get(name, 0),
        "launches_windowed_families": families["hymba"]["launches"][
            "flash_attention_windowed"],
        "launches_bidirectional_encdec": families["encdec"]["launches"][
            "flash_attention_bidirectional"],
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
        for row in attn_times[key][:1]] + [{
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": REPLACES_SCAN, "pallas_original": False,
        "launches": families["hymba"]["launches"]["selective_scan"],
        "launches_by_path": {
            "hymba_prefill": families["hymba"]["launches"]["selective_scan"],
            **{f"hymba_train_{k}": v for k, v in
               families["hymba_train"]["launches"].items()}},
        "max_abs_err": scan_rows[0]["max_abs_err"],
        "max_rel_err": max(max(r["max_rel_err"].values())
                           for r in scan_rows),
        "matched": True,
        "ms": scan_rows[0]["ms"], "kernel_ms": scan_rows[0]["ms"],
        "cold_ms": scan_rows[0]["cold_ms"],
        "call_ms": scan_rows[0]["call_ms"],
        "plain_ms": scan_rows[0]["plain_ms"],
        "bound_ms": scan_rows[0]["bound_ms"],
        "bound_us": 1e3 * scan_rows[0]["bound_ms"],
        "bound_by": scan_rows[0]["bound_by"],
        "library_ms": None, "library_call_ms": None,
        "ptxas": scan_rows[0]["ptxas"],
        "variants": [{k: v for k, v in r.items() if k != "ptxas"}
                     for r in scan_rows]}], "serve": serve,
        "apps": {k: v for k, v in apps.items() if k != "kernel_rows"},
        "schedules": schedules, "durability": durability,
        "train": trained, "elastic": elastic, "pipeline": pipeline,
        "lint": lint,
        "families": {k: {x: y for x, y in v.items() if x != "profile"}
                     for k, v in families.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
