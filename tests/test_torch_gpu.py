"""Tests of the port that need an NVIDIA GPU: the CUDA cscatter, cmerge,
flash_attention and decode_attention kernels against their plain versions
(the bucketed cscatter at its edges, the bf16 tensor-core flash kernel at
its tiling's edges), the stores and the LM on the card, and the card
against the CPU.

Marked ``gpu``; each skips with its reason where there is no card. This
file imports only PyTorch and the port, so that it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import cmerge as cm
from repro_torch.kernels import cscatter as cs
from repro_torch.kernels.ops import commutative_scatter, merge_buffer
from repro_torch.kernels.selective_scan import SEGMENT

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _case(dtype, s, r, d, n, seed, device):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(-3, r + 3, (s, n)).astype(np.int32),
                          device=device)
    if dtype.is_floating_point:
        table = torch.as_tensor(rng.standard_normal((s, r, d)),
                                dtype=torch.float32).to(device, dtype)
        vals = torch.as_tensor(rng.standard_normal((s, n, d)),
                               dtype=torch.float32).to(device, dtype)
        return table, ids, vals

    def bits(shape):  # every 32-bit pattern, as int32
        x = rng.integers(0, 1 << 32, shape).astype(np.uint32).view(np.int32)
        t = torch.as_tensor(x, device=device)
        return t.view(torch.uint32) if dtype == torch.uint32 else t
    return bits((s, r, d)), ids, bits((s, n, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint32])
@pytest.mark.parametrize("s,r,d,n", [(2, 1000, 4, 300), (2, 100, 4, 3000),
                                     (1, 3000, 130, 500)])
def test_kernel_matches_plain_and_counts_its_launches(cuda, dtype, s, r, d, n):
    table, ids, vals = _case(dtype, s, r, d, n, 0, cuda)
    kinds = ("add", "sat_add", "max", "min") + (
        () if dtype.is_floating_point else ("or",))
    for kind in kinds:
        want = cs.cscatter_plain(table, ids, vals, kind=kind, sat_min=-2.0,
                                 sat_max=float(1 << 30))
        before = cs.cscatter.launches
        got = commutative_scatter(table.clone(), ids, vals, kind=kind,
                                  sat_min=-2.0, sat_max=float(1 << 30))
        torch.cuda.synchronize()
        assert cs.cscatter.launches == before + cs.LAUNCHES_PER_CALL
        if dtype.is_floating_point:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype] * 8)
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _pareto_ids(s, n, r, seed):
    from repro_torch.launch.kv_serve import key_stream
    return key_stream(s * n, r, "pareto", n_users=1 << 20,
                      seed=seed).reshape(s, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint32])
@pytest.mark.parametrize("case", ["hot_row", "pareto", "n_above_r", "d33",
                                  "d128"])
def test_bucketed_cscatter_matches_plain_at_its_edges(cuda, dtype, case):
    """A hot row (every id on one row: one bucket of 8192), the key
    stream's Pareto ids, N > R (a dense table of 1000 rows), and D = 33 and
    128 (two and four column tiles). Integers bitwise, floats to TOL. For
    the hot row, float values are small integers, so that every order of
    summing 8192 of them gives the same f32 sum: the case checks that each
    contribution lands once, not the rounding of a long f32 sum."""
    s, r, d, n = {"hot_row": (4, 1 << 20, 4, 8192),
                  "pareto": (8, 1 << 22, 4, 8192),
                  "n_above_r": (8, 1000, 4, 8192),
                  "d33": (2, 5000, 33, 700),
                  "d128": (2, 1 << 16, 128, 1024)}[case]
    table, ids, vals = _case(dtype, s, r, d, n, 5, cuda)
    if case == "hot_row":
        ids = torch.full_like(ids, r // 3)
        if dtype.is_floating_point:
            vals = torch.randint(-8, 9, vals.shape, device=cuda,
                                 generator=torch.Generator(device=cuda)
                                 .manual_seed(5)).to(dtype)
    elif case == "pareto":
        ids = torch.as_tensor(_pareto_ids(s, n, r, 5), device=cuda)
    kinds = ("add", "sat_add", "max", "min") + (
        () if dtype.is_floating_point else ("or",))
    for kind in kinds:
        want = cs.cscatter_plain(table, ids, vals, kind=kind, sat_min=-2.0,
                                 sat_max=float(1 << 30))
        got = cs.cscatter(table.clone(), ids, vals, kind=kind, sat_min=-2.0,
                          sat_max=float(1 << 30))
        torch.cuda.synchronize()
        if dtype.is_floating_point:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype] * 8)
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _check_launch(table, ids, vals, p, kinds):
    """``cs.launch`` with plan ``p`` against the plain version, per kind:
    integers bitwise, floats to TOL."""
    for kind in kinds:
        want = cs.cscatter_plain(table, ids, vals, kind=kind, sat_min=-2.0,
                                 sat_max=float(1 << 30))
        got = table.clone()
        cs.launch(got, ids, vals, kind, -2.0, float(1 << 30), p)
        torch.cuda.synchronize()
        if table.dtype.is_floating_point:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[table.dtype],
                                       atol=TOL[table.dtype] * 8)
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint32])
@pytest.mark.parametrize("branch", ["direct", "rounds_3", "rounds_64"])
def test_bucket_pass_branches_on_a_forced_plan(cuda, dtype, branch):
    """Each branch of the bucket pass on a small table, by a plan that
    forces it: positions written straight to device memory (``stage``
    off), and the histogram counted in rounds of 3 or 64 of the table's 98
    row blocks. A quarter of the ids sit on one row, so big units (hot
    rows) and small ones both span the rounds."""
    s, r, d, n = 2, 100_000, 4, 3000
    table, ids, vals = _case(dtype, s, r, d, n, 8, cuda)
    ids[:, ::4] = r // 3
    p = cs.plan(s, r, n, d, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (p.n_blocks, p.chunks, p.stage) == (98, 1, True)
    if branch != "direct":
        cap = int(branch.split("_")[1])
        p = dataclasses.replace(p, hist_cap=cap, chunks=-(-p.n_blocks // cap))
    p = dataclasses.replace(p, stage=False)
    kinds = ("add", "sat_add", "max", "min") + (
        () if dtype.is_floating_point else ("or",))
    _check_launch(table, ids, vals, p, kinds)


@pytest.mark.parametrize("case", ["direct", "rounds"])
def test_bucket_pass_branches_that_plan_picks(cuda, case):
    """The branches where ``plan`` itself takes them, int32 bitwise: 40000
    ids a shard at R = 2^22 (a ring flush of a longer commit cycle) no
    longer fit in the bucket pass's shared memory, so positions go straight
    to device memory; a table of 2^30 + 1 rows (4.3 GB) has more row blocks
    than one histogram holds, so it is counted in two rounds. Ids reach the
    first and the last row."""
    s, r, d, n = {"direct": (2, 1 << 22, 4, 40_000),
                  "rounds": (1, (1 << 30) + 1, 1, 5000)}[case]
    p = cs.plan(s, r, n, d, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (p.stage, p.chunks) == ((False, 1) if case == "direct"
                                   else (False, 2))
    g = torch.Generator(device=cuda).manual_seed(9)
    table = torch.randint(-(1 << 31), 1 << 31, (s, r, d), generator=g,
                          device=cuda, dtype=torch.int32)
    ids = torch.randint(-3, r + 3, (s, n), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[:, :3] = torch.tensor([0, r - 1, r - 1], dtype=torch.int32)
    ids[:, 3::7] = r // 3                                   # a hot row
    vals = torch.randint(-(1 << 31), 1 << 31, (s, n, d), generator=g,
                         device=cuda, dtype=torch.int32)
    _check_launch(table, ids, vals, p, ("add", "sat_add", "max", "min", "or"))
    before = cs.cscatter.launches
    got = cs.cscatter(table.clone(), ids, vals, kind="add")
    want = cs.cscatter_plain(table, ids, vals, kind="add")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cs.cscatter.launches == before + cs.LAUNCHES_PER_CALL


def test_bucketed_cscatter_leaves_the_table_alone_without_updates(cuda):
    """All padding, and N = 0: the table stays bit-exact; N = 0 launches
    nothing."""
    table, _, _ = _case(torch.int32, 4, 1000, 4, 1, 6, cuda)
    before = table.clone()
    cs.cscatter(table, torch.full((4, 300), -1, dtype=torch.int32,
                                  device=cuda),
                torch.ones((4, 300, 4), dtype=torch.int32, device=cuda))
    launches = cs.cscatter.launches
    cs.cscatter(table, torch.zeros((4, 0), dtype=torch.int32, device=cuda),
                torch.zeros((4, 0, 4), dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(table, before)
    assert cs.cscatter.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint32])
@pytest.mark.parametrize("s,w,br,d", [(2, 1, 8, 4), (3, 8, 8, 4),
                                      (2, 300, 4, 130), (8, 8192, 8, 4),
                                      (3, 33, 8, 4), (2, 37, 3, 5)])
def test_cmerge_matches_plain_and_counts_its_launches(cuda, dtype, s, w, br,
                                                      d):
    """The evict (W = 1), flush (W = 8) and drain (W = 8192) shapes of the
    blocked store, a W that is not a multiple of the ways a CTA takes (33),
    and blocks whose byte length is no multiple of 16 (D = 130, and BR 3 x
    D 5), which take one element an access."""
    rng = np.random.default_rng(2)
    r = 2 * w * br                      # room for w distinct blocks
    table, _, src = _case(dtype, s, r, d, w * br, 3, cuda)
    _, _, upd = _case(dtype, s, r, d, w * br, 4, cuda)
    src, upd = src.view(s, w, br, d), upd.view(s, w, br, d)
    ids = np.stack([rng.permutation(r // br)[:w] for _ in range(s)])
    ids[:, ::3] = -1                    # invalid ways
    dirty = rng.random((s, w)) < 0.7    # and clean ones
    ids = torch.as_tensor(ids.astype(np.int32), device=cuda)
    dirty = torch.as_tensor(dirty, device=cuda)
    kinds = ("add", "sat_add", "max", "min") + (
        () if dtype.is_floating_point else ("or",))
    for kind in kinds:
        want = cm.cmerge_plain(table, ids, dirty, src, upd, kind=kind,
                               sat_min=0.0, sat_max=float(1 << 30))
        before = cm.cmerge.launches
        got = merge_buffer(table.clone(), ids, dirty, src, upd, kind=kind,
                           sat_min=0.0, sat_max=float(1 << 30))
        torch.cuda.synchronize()
        assert cm.cmerge.launches == before + 1
        if dtype.is_floating_point:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype] * 8)
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
def test_cmerge_leaves_the_table_alone_without_dirty_valid_ways(cuda, dtype):
    """A W = 8192 drain whose ways are all clean, all invalid, or past the
    table's end: one launch, and the table stays bit-exact."""
    s, w, br, d = 8, 8192, 8, 4
    r = 2 * w * br
    table, _, src = _case(dtype, s, r, d, w * br, 10, cuda)
    _, _, upd = _case(dtype, s, r, d, w * br, 11, cuda)
    src, upd = src.view(s, w, br, d), upd.view(s, w, br, d)
    before = table.clone()
    ids = torch.arange(w, dtype=torch.int32, device=cuda).repeat(s, 1)
    ids[:, w // 2:] = -1
    ids[:, w // 4:w // 2] += r // br           # past the table's end
    dirty = torch.zeros((s, w), dtype=torch.bool, device=cuda)
    dirty[:, w // 4:] = True
    launches = cm.cmerge.launches
    for kind in ("add", "max"):
        cm.cmerge(table, ids, dirty, src, upd, kind=kind)
    torch.cuda.synchronize()
    assert cm.cmerge.launches == launches + 2
    assert torch.equal(table.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       before.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))


@pytest.mark.parametrize("engine", ["kernel", "blocked"])
def test_store_on_the_card_matches_the_oracle(cuda, engine):
    from repro_torch.serve import KVConfig, ShardedKV
    S, R, D, B, T = 8, 4096, 4, 64, 11
    rng = np.random.default_rng(1)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    for partitioned in (False, True):
        kv = ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=partitioned,
                                engine=engine, spill_blocks=512),
                       S, commit_every=4)
        assert kv.device.type == "cuda"
        for t in range(T):
            kv.tick(keys[t], vals[t])
        kv.flush()
        want = np.zeros((R, D), np.int64)
        m = keys >= 0
        np.add.at(want, keys[m], vals[m])
        np.testing.assert_array_equal(kv.table().astype(np.int64), want)


@pytest.mark.parametrize("partitioned,overlap",
                         [(False, False), (True, False), (True, True)])
def test_blocked_reads_on_the_card_match_the_cpu(cuda, partitioned,
                                                 overlap):
    """Read-your-writes reads through the blocked cache (and the spill
    buffer, and the in-flight commit), and the counters, on the card equal
    those of the same store on the CPU after every tick, bitwise."""
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.serve import KVConfig, ShardedKV
    S, R, D, B, T = 8, 4096, 4, 64, 9
    rng = np.random.default_rng(2)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    reads = np.concatenate([keys[:, :, :16].transpose(1, 0, 2).reshape(S, -1),
                            np.full((S, 2), -1, np.int32)], 1)
    cfg = KVConfig(n_keys=R, cols=D, engine="blocked", ways=4, block_rows=8,
                   partitioned=partitioned, spill_blocks=512,
                   consistency="read_your_writes")
    names = ("chip", "host", "pod")
    stores = [ShardedKV(cfg, S, device=dev, **(
        {"schedule": DeferSchedule.fixed(4, names, overlap=True)} if overlap
        else {"commit_every": 4})) for dev in ("cuda", "cpu")]
    for t in range(T):
        for kv in stores:
            kv.tick(keys[t], vals[t])
        card, host = (kv.read(reads).cpu() for kv in stores)
        assert torch.equal(card, host), t
        assert stores[0].counters() == stores[1].counters(), t
    for kv in stores:
        kv.flush()
    np.testing.assert_array_equal(stores[0].table(), stores[1].table())


@pytest.mark.parametrize("merge", ["add", "max", "or"])
def test_uint32_blocked_store_on_the_card_matches_the_cpu(cuda, merge):
    """uint32 tables over the whole 32-bit range (held as int32 bits, MAX
    and MIN biased into signed order): reads, counters and the flushed
    table on the card equal the same store's on the CPU, bitwise."""
    from repro_torch.core import merge_functions as mf
    from repro_torch.serve import KVConfig, ShardedKV
    S, R, D, B, T = 8, 4096, 4, 64, 9
    rng = np.random.default_rng(3)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 32, (T, S, B, D)).astype(np.uint32)
    fn = {"add": mf.ADD, "max": mf.MAX, "or": mf.BITWISE_OR}[merge]
    for partitioned in (False, True):
        cfg = KVConfig(n_keys=R, cols=D, dtype=torch.uint32, merge=fn,
                       engine="blocked", partitioned=partitioned,
                       spill_blocks=512, consistency="read_your_writes")
        stores = [ShardedKV(cfg, S, device=dev, commit_every=4)
                  for dev in ("cuda", "cpu")]
        for t in range(T):
            for kv in stores:
                kv.tick(keys[t], vals[t])
            card, host = (kv.read(keys[t]).cpu() for kv in stores)
            assert torch.equal(card, host), t
            assert stores[0].counters() == stores[1].counters(), t
        for kv in stores:
            kv.flush()
        np.testing.assert_array_equal(stores[0].table(), stores[1].table())


def _attn_inputs(dtype, *shapes, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, device="cuda", generator=g).to(dtype)
            for s in shapes]


# A kernel against its plain version in bf16: both round an f32 result to
# bf16, so they differ by about one bf16 ulp (2**-8 of the value); the worst
# seen on an NVIDIA H100 80GB HBM3 (700 W) is 0.0039. TOL's absolute 4 * 2e-2
# is the size of a typical output element, so bf16 is held to 1e-2 + 1e-2 *
# |want| per element and to 1e-2 of each output row's RMS per row.
ATTN_BF16_TOL, ATTN_BF16_ROW = 1e-2, 1e-2


def _assert_attn_close(got, want, dtype):
    if dtype != torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype] * 4)
        return
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, rtol=ATTN_BF16_TOL, atol=ATTN_BF16_TOL)
    row = ((g - w).square().mean(-1).sqrt()
           / w.square().mean(-1).sqrt().clamp_min(1e-6))
    assert float(row.max()) <= ATTN_BF16_ROW


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,t,d", [(2, 8, 8, 128, 128, 64),
                                          (2, 8, 2, 100, 100, 128),
                                          (1, 4, 1, 37, 130, 72),
                                          (1, 2, 2, 65, 65, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_and_counts_its_launches(
        cuda, dtype, b, h, kv, s, t, d, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_attention
    q, k, v = _attn_inputs(dtype, (b, h, s, d), (b, kv, t, d),
                           (b, kv, t, d))
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    before = fa.flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    _assert_attn_close(got, want, dtype)
    # strided [B, S, H, d] views, as the model passes them
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    _assert_attn_close(flash_attention(qs, ks, vs, causal=causal), want,
                       dtype)


@pytest.mark.parametrize("d", [8, 64, 72, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,s,t", [(1, 8, 4, 100, 37), (1, 8, 1, 37, 100),
                                        (2, 16, 8, 129, 129)])
def test_bf16_flash_attention_runs_on_the_tensor_cores(cuda, d, causal, b, h,
                                                       kv, s, t):
    """bf16 inputs launch the tensor-core variant (and only it), which
    agrees with the plain version (p rounded to bf16 before P.V) to
    ATTN_BF16_TOL at
    every head dim the wrapper takes a tile of, ragged S != T, GQA groups
    of 2 and 8, contiguous and through strided [B, S, H, d] views."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(torch.bfloat16, (b, h, s, d), (b, kv, t, d),
                           (b, kv, t, d), seed=d)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    views = [(q, k, v), tuple(x.transpose(1, 2).contiguous().transpose(1, 2)
                              for x in (q, k, v))]
    for args in views:
        before = dict(fa.flash_attention.launches_by_variant)
        got = fa.flash_attention(*args, causal=causal)
        torch.cuda.synchronize()
        after = fa.flash_attention.launches_by_variant
        assert after["bf16_mma"] == before["bf16_mma"] + 1
        assert after["f32_fma"] == before["f32_fma"]
        _assert_attn_close(got, want, torch.bfloat16)


def test_f32_flash_attention_keeps_the_f32_core_kernel(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(torch.float32, (2, 8, 100, 64), (2, 2, 100, 64),
                           (2, 2, 100, 64), seed=3)
    before = dict(fa.flash_attention.launches_by_variant)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_variant["f32_fma"] == \
        before["f32_fma"] + 1
    assert fa.flash_attention.launches_by_variant["bf16_mma"] == \
        before["bf16_mma"]
    _assert_attn_close(got, fa.flash_attention_plain(q, k, v), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,t,d", [(2, 8, 8, 300, 64),
                                        (2, 16, 8, 257, 128),
                                        (1, 16, 1, 40, 256),
                                        (2, 4, 4, 50, 24),
                                        (8, 16, 8, 4096, 128)])
def test_decode_attention_matches_plain_and_counts_its_launches(
        cuda, dtype, b, h, kv, t, d):
    """At internlm2-1.8b's cache (T = 4096) position 0 fills one slot of
    the plan's several splits: the others are empty partials."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ops import decode_attention
    q, k, v = _attn_inputs(dtype, (b, h, d), (b, t, kv, d), (b, t, kv, d))
    for pos in (0, 1, t // 2, t - 1):
        want = da.decode_attention_plain(q, k, v, pos)
        before = da.decode_attention.launches
        got = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + da.LAUNCHES_PER_CALL
        _assert_attn_close(got, want, dtype)
    # slots past the position are never read
    k[:, t // 2 + 1:] = float("nan")
    got = decode_attention(q, k, v, t // 2)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 7, 45])
def test_decode_attention_passes_on_forced_split_counts(cuda, dtype, splits):
    """Each pass on a forced split count, through ``launch`` as a test may
    call it: the split pass's f32 partials against the plain split pass
    (both f32 sums over the same slots in another order: the f32 TOL), the
    output against the plain version and against the plain combine of the
    kernel's own partials. 45 splits of a 40-slot cache leave empty ones at
    every position."""
    from repro_torch.kernels import decode_attention as da
    b, h, kv, t, d = 2, 16, 8, 40, 128
    q, k, v = _attn_inputs(dtype, (b, h, d), (b, t, kv, d), (b, t, kv, d),
                           seed=splits)
    for pos in (0, 17, t - 1):
        before = da.decode_attention.launches
        out, m, l, acc = da.launch(q, k, v, pos, splits)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + da.LAUNCHES_PER_CALL
        pm, pl, pa = da.decode_attention_partials_plain(q, k, v, pos, splits)
        assert torch.equal(m == da.NEG_INF, pm == da.NEG_INF)
        for got, want in ((m, pm), (l, pl), (acc, pa)):
            torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                                       atol=TOL[torch.float32] * 4)
        _assert_attn_close(out, da.decode_attention_plain(q, k, v, pos),
                           dtype)
        _assert_attn_close(out, da.decode_attention_combine_plain(
            m, l, acc, dtype), dtype)


@pytest.mark.parametrize("arch", ["qwen1-5-0-5b", "internlm2-1-8b"])
def test_lm_serves_through_the_kernels_on_the_card(cuda, arch):
    """The smoke LM on the card launches flash_attention once a layer at
    prefill and calls decode_attention (two launches) once a layer a step,
    and its logits equal
    the same weights' with the plain attention to the bf16 tolerance."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, prompts
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device=cuda, seed=1)
    p = prompts(cfg, 2, 24, 1)
    fa.flash_attention.launches = da.decode_attention.launches = 0
    res = generate(model, p, 5, keep_logits=True)
    assert fa.flash_attention.launches == cfg.n_layers
    assert da.decode_attention.launches == (cfg.n_layers * 4
                                            * da.LAUNCHES_PER_CALL)
    model.impl = "plain"
    logits, caches = model.prefill(torch.as_tensor(p, device=cuda), 29)
    steps = [logits]
    for i in range(4):
        logits, caches = model.decode_step(res.tokens[:, i], caches, 24 + i)
        steps.append(logits)
    assert fa.flash_attention.launches == cfg.n_layers
    for got, want in zip(res.logits, steps):
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


def test_store_on_the_card_equals_the_same_store_on_the_cpu(cuda):
    """The partitioned kernel-engine store (its commits scatter the ring
    through the bucketed cscatter) on Pareto keys: the card's table equals
    the CPU's, bitwise, after every commit and after the flush."""
    from repro_torch.serve import KVConfig, ShardedKV
    S, R, D, B, T = 8, 1 << 16, 4, 256, 9
    keys = _pareto_ids(T * S, B, R, 7).reshape(T, S, B)
    vals = np.random.default_rng(7).integers(1, 9, (T, S, B, D)).astype(
        np.int32)
    stores = [ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=True), S,
                        commit_every=4, device=dev) for dev in ("cuda", "cpu")]
    for t in range(T):
        for kv in stores:
            kv.tick(keys[t], vals[t])
        if (t + 1) % 4 == 0:
            np.testing.assert_array_equal(stores[0].table(),
                                          stores[1].table())
    for kv in stores:
        kv.flush()
    np.testing.assert_array_equal(stores[0].table(), stores[1].table())


def test_recover_on_the_card_onto_another_layout(cuda, tmp_path):
    """An S = 8 privatized store journals from the card, snapshots, ticks
    on and is dropped; a fresh S = 4 partitioned store recovers (the
    snapshot's table installed, the journal re-chunked to 4 shards through
    the ring and cscatter) and its flushed table equals the numpy replay
    of every acknowledged tick, bitwise."""
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan
    S, R, D, B, T = 8, 1 << 12, 4, 64, 10
    rng = np.random.default_rng(3)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    want = np.zeros((R, D), np.int64)
    np.add.at(want, keys[keys >= 0], vals[keys >= 0])
    root = str(tmp_path)
    kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, commit_every=3,
                   device=cuda)
    kv.attach_journal(root)
    for t in range(T):
        kv.tick(torch.as_tensor(keys[t], device=cuda),
                torch.as_tensor(vals[t], device=cuda))
        if t == 4:
            kv.snapshot()
    del kv
    kv4 = ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=True), 4,
                    plan=serving_plan(4, "all"), commit_every=2, device=cuda)
    report = kv4.recover(root)
    kv4.flush()
    assert report["snapshot_step"] is not None
    assert report["replayed_ticks"] == T - 5
    np.testing.assert_array_equal(kv4.table().astype(np.int64), want)


def test_lm_serve_on_the_card_matches_the_cpu(cuda):
    """The same weights (built on the CPU, copied to the card) serve the
    same prompts on both: the card through the kernels (prefill through the
    bf16 tensor-core flash kernel), the CPU through the plain versions;
    every step's logits agree to the bf16 tolerance of the kernel tests of
    the LM (5e-2)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, prompts
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config("qwen1-5-0-5b")
    host = build_model(cfg, device="cpu", seed=2)
    card = build_model(cfg, device="cpu", seed=2).to(cuda)
    p = prompts(cfg, 2, 24, 2)
    before = fa.flash_attention.launches_by_variant["bf16_mma"]
    got = generate(card, p, 4, keep_logits=True)
    assert fa.flash_attention.launches_by_variant["bf16_mma"] == \
        before + cfg.n_layers
    # teacher-forced on the CPU over the card's tokens
    logits, caches = host.prefill(torch.as_tensor(p), 28)
    for i, step in enumerate(got.logits):
        if i:
            logits, caches = host.decode_step(got.tokens[:, i - 1].cpu(),
                                              caches, 24 + i - 1)
        torch.testing.assert_close(step.cpu(), logits, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("app", ["bfs", "pagerank", "kmeans"])
def test_apps_on_the_card_match_the_same_apps_on_the_cpu(cuda, app):
    """``run_app`` on the card, through the CUDA ``cscatter``: the JAX slow
    test's bounds, and the card's errors equal the CPU's for BFS (bitwise)
    and within f32 summation order for the others."""
    from repro_torch.apps.sharded import run_app
    cs.cscatter.launches = 0
    got = run_app(app, 8, n_vertices=96, n_edges=400)
    assert cs.cscatter.launches > 0
    cpu = run_app(app, 8, n_vertices=96, n_edges=400, device="cpu")
    if app == "bfs":
        assert got == cpu
        assert got["eager_max_err"] == got["defer_max_err"] == 0.0
    elif app == "pagerank":
        assert got["eager_max_err"] < 1e-4 and got["defer_max_err"] < 1e-4
    else:
        assert got["defer_max_err"] < 1e-3 and got["overlap_max_err"] < 1e-3


@pytest.mark.parametrize("kind,dtype", [("min", torch.int32),
                                        ("add", torch.float32)])
def test_cscatter_at_a_graph_apps_shape(cuda, kind, dtype):
    """One million ids a shard into [8, 2^18, 1]: every row block is a big
    unit folded with shared-memory atomics and the bucket pass writes its
    positions straight out. MIN bitwise, f32 ADD to TOL."""
    s, r, n = 8, 1 << 18, 1 << 20
    p = cs.plan(s, r, n, 1, torch.cuda.get_device_properties(0)
                .multi_processor_count)
    assert not p.stage and p.n_blocks == r // p.br
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(-1, r, (s, n), device=cuda, generator=g,
                        dtype=torch.int32)
    if dtype == torch.int32:
        vals = torch.randint(0, 1 << 20, (s, n, 1), device=cuda, generator=g,
                             dtype=torch.int32)
        table = torch.full((s, r, 1), torch.iinfo(torch.int32).max,
                           dtype=torch.int32, device=cuda)
    else:
        vals = torch.rand((s, n, 1), device=cuda, generator=g)
        table = torch.zeros((s, r, 1), device=cuda)
    want = cs.cscatter_plain(table, ids, vals, kind=kind)
    got = cs.cscatter(table.clone(), ids, vals, kind=kind)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_backward_on_the_card_matches_its_plain_version(cuda,
                                                                  dtype):
    """The train path's embedding backward is one ``cscatter`` call into an
    f32 ``[V, D]`` gradient: against the plain scatter of the same output
    gradient, each row to 1e-2 of its RMS (the kernel sums in another
    order; bf16 rounds the summed row once either way)."""
    from repro_torch.models.embedding import embed
    rng = np.random.default_rng(0)
    v, d = 5000, 96
    tokens = torch.as_tensor((rng.zipf(1.3, (4, 64)) - 1) % v,
                             device=cuda)
    table = torch.as_tensor(rng.standard_normal((v, d)),
                            dtype=torch.float32).to(cuda, dtype)
    cot = torch.as_tensor(rng.standard_normal((4, 64, d)),
                          dtype=torch.float32).to(cuda, dtype)
    table.requires_grad_(True)
    before = cs.cscatter.launches
    (got,) = torch.autograd.grad((embed(table, tokens) * cot).sum(), table)
    torch.cuda.synchronize()
    assert cs.cscatter.launches - before == cs.LAUNCHES_PER_CALL
    want = torch.zeros((v, d), device=cuda)
    cs.cscatter_plain_(want, tokens.reshape(-1).to(torch.int32),
                       cot.reshape(-1, d).float())
    want = want.to(dtype).float()
    got = got.float()
    assert got.dtype == torch.float32 and not got[
        (want == 0).all(1)].any()
    rms = want.pow(2).mean(1).sqrt()
    err = (got - want).pow(2).mean(1).sqrt()
    assert bool((err <= 1e-2 * rms + 1e-6).all())


def test_a_deferred_cycle_on_the_card_equals_its_eager_reference(cuda):
    """The smoke model in f32 on the card over 4 stacked ranks, K = 2: the
    parameters after the cycle equal one AdamW step on the mean of the two
    steps' eagerly merged gradients (f32, 1e-5 of each leaf's largest
    magnitude); the embedding backward launched ``cscatter`` once a rank a
    step."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.core.grad_merge import merge_gradients
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.core.stacked import StackedAxis
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, constant
    cfg = dataclasses.replace(get_smoke_config("qwen1-5-0-5b"),
                              dtype="float32")
    model = build_model(cfg, device=cuda)
    opt = adamw(constant(1e-3), eps=1e-3)
    step = steps.make_train_step(
        model, cfg, opt, merge_topology=MergePlan.parse("chip:2,pod:2:defer"),
        defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    params = model.params()
    state = {"params": params, "opt": opt.init(params),
             "defer": step.init_defer_state(params)}
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    batches = [batch_at(dcfg, t) for t in range(2)]
    before = cs.cscatter.launches
    for b in batches:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    assert cs.cscatter.launches - before == 2 * 4 * cs.LAUNCHES_PER_CALL
    axis = StackedAxis(4, cuda)
    grads_of = steps.grads_fn(model)
    acc = None
    for b in batches:
        _, stack = steps.rank_grads(grads_of, params,
                                    steps.to_device(b, cuda), 4)
        g = {k: v for k, v in merge_gradients(
            stack, axis, topology=MergePlan.parse("chip:2,pod:2")).items()}
        g = torch.utils._pytree.tree_map(lambda x: x[0] / 2, g)
        acc = g if acc is None else torch.utils._pytree.tree_map(
            torch.add, acc, g)
    want, _, _ = opt.step(params, acc, opt.init(params))
    got_l = torch.utils._pytree.tree_leaves(state["params"])
    for got, w in zip(got_l, torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(got, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()) + 1e-6)


def test_logits_backward_in_bf16_stays_near_the_f32_products(cuda):
    """``_MatmulF32`` (the f32-logits product of a bf16 model on the card)
    rounds the f32 logits gradient to bf16 before both of its products;
    the JAX package takes them in f32. At qwen1.5-0.5b's tied logits, one
    rank's 1024 tokens of d 1024 against the ``[151936, 1024]`` table,
    with the cross entropy's gradient: each row of the input's and of the
    table's gradient within 1e-2 of its RMS of the products of the f32
    gradient with the inputs upcast (f32, no TF32)."""
    from repro_torch.models.transformer import _matmul_f32
    n, d, v = 1024, 1024, 151936
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((n, d), generator=gen, device=cuda).to(torch.bfloat16)
    table = (0.02 * torch.randn((v, d), generator=gen, device=cuda)).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=gen, device=cuda)
    h.requires_grad_(True)
    table.requires_grad_(True)
    logits = _matmul_f32(h, table.t())
    assert logits.dtype == torch.float32
    g = torch.softmax(logits.detach(), -1)
    g[torch.arange(n, device=cuda), labels] -= 1.0
    g /= n
    gh, gt = torch.autograd.grad(logits, (h, table), g)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        want_h = g @ table.detach().float()
        want_t = g.t() @ h.detach().float()
    finally:
        torch.set_float32_matmul_precision(prec)
    for got, want in ((gh, want_h), (gt, want_t)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        rms = want.pow(2).mean(1).sqrt()
        err = (got.float() - want).pow(2).mean(1).sqrt()
        assert bool((err <= 1e-2 * rms + 1e-30).all())


@pytest.mark.parametrize("mode,overlap", [("preempt", False), ("kill", False),
                                          ("kill", True)])
def test_toy_chaos_sweeps_on_the_card_are_bitwise(cuda, tmp_path, mode,
                                                  overlap):
    from repro_torch.runtime import chaos
    fac = chaos.toy_factory("chip:2,host:2:defer,pod:2:defer", (1, 2), 8,
                            width=4096, overlap=overlap, device=cuda)
    baseline, outcomes = chaos.chaos_sweep(fac, 6, str(tmp_path), mode=mode)
    assert baseline["params"]["w"].device.type == "cuda"
    assert baseline["params"]["w"].any()
    assert [o.state_bitwise for o in outcomes] == [True] * 6


@pytest.mark.parametrize("t", [4, 5])
def test_toy_elastic_resolve_on_the_card_equals_the_cpu(cuda, tmp_path, t):
    """An overlapped checkpoint written on the CPU, resolved onto another
    plan on the CPU and on the card: the same params, count and report."""
    from repro_torch.runtime import DriverConfig, TrainDriver, chaos
    step, bf, st0 = chaos.toy_factory("chip:2,host:2:defer,pod:2:defer",
                                      (1, 2), 8, width=4096, overlap=True,
                                      device="cpu")()
    d = str(tmp_path)
    TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=t), step, bf,
                defer_step=step).run(st0, 0, t)
    out = {}
    for device in ("cpu", cuda):
        step, bf, like = chaos.toy_factory("chip:4,pod:2:defer", (3,), 8,
                                           width=4096, device=device)()
        state, start, report = TrainDriver(
            DriverConfig(ckpt_dir=d), step, bf,
            defer_step=step).resume(like)
        assert state["params"]["w"].device.type == torch.device(device).type
        out[str(device)] = (state, report.as_dict())
    (cpu, rep_cpu), (card, rep_card) = out["cpu"], out[str(cuda)]
    assert rep_card == rep_cpu and rep_card["action"] == "resolved"
    assert rep_card["landed_inflight"] == (t == 4)
    assert torch.equal(card["params"]["w"].cpu(), cpu["params"]["w"])
    assert int(card["opt"]["count"]) == int(cpu["opt"]["count"])



# Streams of the determinism test: (table shape, ids a shard, id law). The
# port's shapes: a KV tick with hot Zipf ids (units of more than 32 ids: the
# CTA's exact fold) and with cold uniform ids (warp units), k-means's 5 hot
# rows, a graph app's scatter, and the embedding backward of xlstm-125m (one
# rank's 32 ids) and of qwen1.5-0.5b (1024 ids).
_DET_STREAMS = {
    "tick_hot": ((8, 1 << 16, 4), 1024, "zipf"),
    "tick_cold": ((8, 1 << 16, 4), 1024, "uniform"),
    "kmeans": ((8, 5, 34), 7680, "uniform"),
    "graph": ((8, 1 << 18, 1), 1 << 20, "zipf"),
    "embedding_xlstm": ((50304, 768), 32, "zipf"),
    "embedding_qwen": ((151936, 1024), 1024, "zipf"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["add", "sat_add"])
@pytest.mark.parametrize("stream", sorted(_DET_STREAMS))
def test_float_cscatter_is_bitwise_repeatable(cuda, dtype, kind, stream):
    """Float sums through cscatter are the same bits on every call: five
    calls from the same table, ids and values, hot and cold streams, equal
    bit for bit, and each within TOL of the plain version."""
    shape, n, law = _DET_STREAMS[stream]
    rng = np.random.default_rng(5)
    r = shape[-2]
    lead = shape[:-2]
    if law == "zipf":
        ids = (rng.zipf(1.2, lead + (n,)) - 1) % r
    else:
        ids = rng.integers(0, r, lead + (n,))
    ids = torch.as_tensor(ids.astype(np.int32), device=cuda)
    table = torch.as_tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(cuda, dtype)
    vals = torch.as_tensor(rng.standard_normal(lead + (n, shape[-1])),
                           dtype=torch.float32).to(cuda, dtype)
    sat = (-3.0, 3.0) if kind == "sat_add" else (0.0, 0.0)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    outs = [cs.cscatter(table.clone(), ids, vals, kind=kind, sat_min=sat[0],
                        sat_max=sat[1]) for _ in range(5)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out.view(bits), outs[0].view(bits))
    # against the exact sums (float64), since the plain version's own f32
    # sums of thousands of terms drift by more than TOL
    s3 = table.reshape((-1,) + shape[-2:]).shape[0]
    flat = (ids.reshape(s3, -1).long()
            + r * torch.arange(s3, device=cuda)[:, None]).reshape(-1)
    u = torch.zeros((s3 * r, shape[-1]), dtype=torch.float64, device=cuda)
    u.index_add_(0, flat, vals.reshape(-1, shape[-1]).double())
    want = table.double().reshape(s3 * r, -1) + u
    if kind == "sat_add":       # clips the touched rows only
        touched = torch.zeros(s3 * r, dtype=torch.bool, device=cuda)
        touched[flat] = True
        want = torch.where(touched[:, None], want.clamp(*sat),
                           table.double().reshape(s3 * r, -1))
    torch.testing.assert_close(outs[0].double().reshape(want.shape), want,
                               rtol=TOL[dtype], atol=TOL[dtype] * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,window", [
    (2, 25, 5, 300, 64, 16),      # Hymba's GQA group of 5, window of 16
    (1, 8, 2, 1000, 64, 100),     # a window that ends inside a tile
    (1, 4, 4, 257, 128, 64),      # a window of one tile, ragged S
    (1, 4, 1, 130, 256, 1),       # only the diagonal
    (2, 25, 5, 200, 64, 1024),    # a window past the sequence: causal
])
def test_windowed_flash_attention_matches_plain(cuda, dtype, b, h, kv, s, d,
                                                window):
    """Both CUDA variants with a sliding window against the plain version
    (key j visible to query i iff i - window < j <= i), contiguous and
    through the model's strided [B, S, H, d] views."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(dtype, (b, h, s, d), (b, kv, s, d),
                           (b, kv, s, d), seed=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    variant = fa.VARIANTS[dtype]
    for args in [(q, k, v), tuple(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2) for x in (q, k, v))]:
        before = fa.flash_attention.launches_by_variant[variant]
        got = fa.flash_attention(*args, window=window)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches_by_variant[variant] == before + 1
        _assert_attn_close(got, want, dtype)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, causal=False, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("position", [0, 37, 1022, 1023])
def test_decode_attention_takes_five_heads_a_group_on_a_ring_cache(
        cuda, dtype, position):
    """Hymba's decode geometry: G = H / KV = 5 query heads a kv head (not a
    power of two) over a ring cache of W = 1024 slots, the position
    clamped at W - 1 once the ring is full; against the plain version, and
    both passes against theirs."""
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs(dtype, (8, 25, 64), (8, 1024, 5, 64),
                           (8, 1024, 5, 64), seed=position)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, position)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + da.LAUNCHES_PER_CALL
    _assert_attn_close(got, da.decode_attention_plain(q, k, v, position),
                       dtype)
    out, m, l, acc = da.launch(q, k, v, position, 3)
    wm, wl, wacc = da.decode_attention_partials_plain(q, k, v, position, 3)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(acc, wacc, rtol=1e-4, atol=1e-4)
    _assert_attn_close(out, da.decode_attention_combine_plain(m, l, acc,
                                                              dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t", [(128, 128), (512, 128), (37, 128)])
def test_bidirectional_flash_attention_at_the_encdec_shapes(cuda, dtype, s,
                                                            t):
    """seamless-m4t-medium's bidirectional launches: the encoder's
    self-attention (S = T = 128 frames) and the prefill's cross-attention
    (S = 512 tokens against T = 128 frames; a ragged S too), H = KV = 16,
    d 64, through the model's strided views; each counted as
    bidirectional."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(dtype, (8, 16, s, 64), (8, 16, t, 64),
                           (8, 16, t, 64), seed=s)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    for args in [(q, k, v), tuple(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2) for x in (q, k, v))]:
        before = (fa.flash_attention.launches_bidirectional,
                  fa.flash_attention.launches_by_variant[fa.VARIANTS[dtype]])
        got = fa.flash_attention(*args, causal=False)
        torch.cuda.synchronize()
        assert (fa.flash_attention.launches_bidirectional,
                fa.flash_attention.launches_by_variant[fa.VARIANTS[dtype]]
                ) == (before[0] + 1, before[1] + 1)
        _assert_attn_close(got, want, dtype)
    before = fa.flash_attention.launches_bidirectional
    fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches_bidirectional == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("position", [0, 127])
def test_decode_attention_over_a_cross_cache(cuda, dtype, position):
    """The decode's cross-attention: q [8, 16, 64] over a cache [8, 128,
    16, 64] that no decode step wrote (the encoder's k and v), at position
    T - 1 as the model reads it, and at 0."""
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs(dtype, (8, 16, 64), (8, 128, 16, 64),
                           (8, 128, 16, 64), seed=position + 1)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, position)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + da.LAUNCHES_PER_CALL
    _assert_attn_close(got, da.decode_attention_plain(q, k, v, position),
                       dtype)


def test_encdec_kernel_path_equals_its_plain_path_on_the_card(cuda):
    """The smoke encoder-decoder on the card: a flash launch per encoder
    layer and two per decoder layer at prefill (the encoder's and the
    cross-attention bidirectional), two decode_attention calls a decoder
    layer a step (self and cross); its logits equal the same weights' with
    the plain attention to the bf16 tolerance of the LM's card tests."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config("seamless-m4t-medium")
    model = build_model(cfg, device=cuda, seed=1)
    batch = serve_batch(cfg, 2, 24, 1)
    fa.flash_attention.launches = da.decode_attention.launches = 0
    fa.flash_attention.launches_bidirectional = 0
    res = generate(model, batch["tokens"], 5, frames=batch["frames"],
                   keep_logits=True)
    assert fa.flash_attention.launches == cfg.n_enc_layers + 2 * \
        cfg.n_dec_layers
    assert fa.flash_attention.launches_bidirectional == \
        cfg.n_enc_layers + cfg.n_dec_layers
    assert da.decode_attention.launches == (cfg.n_dec_layers * 2 * 4
                                            * da.LAUNCHES_PER_CALL)
    model.impl = "plain"
    logits, caches = model.prefill(torch.as_tensor(batch["tokens"],
                                                   device=cuda), 29,
                                   batch["frames"])
    steps = [logits]
    for i in range(4):
        logits, caches = model.decode_step(res.tokens[:, i], caches, 24 + i)
        steps.append(logits)
    assert fa.flash_attention.launches == cfg.n_enc_layers + 2 * \
        cfg.n_dec_layers
    for got, want in zip(res.logits, steps):
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,k", [(4096, 4096, 8), (8, 4096, 8)])
def test_moe_combine_at_the_serve_shapes(cuda, dtype, t, d, k):
    """The MoE token combine, ``cscatter`` add into a zero ``[t, d]`` table
    of each token's k weighted expert outputs (ids ``arange(t k) // k``, a
    dropped assignment a zero row), at qwen3-moe-235b's prefill (t = 8 x
    512 tokens, N = 32768) and decode (t = 8, N = 64) shapes: one call, two
    launches, each element within two roundings of the f64 sum (bf16: 2^-7
    of it; f32: 1e-5), and equal to the plain version's to the same bound;
    and through ``models.moe.combine``, whose backward gathers."""
    from repro_torch.models import moe
    rng = np.random.default_rng(t)
    n = t * k
    y = torch.as_tensor(rng.standard_normal((n, d)) * 0.1,
                        dtype=torch.float32)
    y[rng.random(n) < 0.1] = 0                      # dropped assignments
    y = y.to(cuda, dtype)
    ids = (torch.arange(n, device=cuda) // k).to(torch.int32)
    want = torch.zeros((t, d), dtype=torch.float64, device=cuda).index_add_(
        0, ids.long(), y.double())
    before = cs.cscatter.launches
    got = commutative_scatter(torch.zeros((t, d), dtype=dtype, device=cuda),
                              ids, y)
    torch.cuda.synchronize()
    assert cs.cscatter.launches - before == cs.LAUNCHES_PER_CALL
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    plain = cs.cscatter_plain(torch.zeros((t, d), dtype=dtype, device=cuda),
                              ids, y)
    for out in (got, plain):
        assert bool(((out.double() - want).abs()
                     <= rel * want.abs() + 1e-6).all())
    yy = y.clone().requires_grad_(True)
    out = moe.combine(yy, ids, t)
    assert torch.equal(out, got)
    g = torch.randn((t, d), device=cuda).to(dtype)
    (grad,) = torch.autograd.grad(out, yy, g)
    assert torch.equal(grad, g[ids.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,t", [(64, 4, 576), (56, 8, 704)])
def test_decode_attention_at_the_moe_and_vlm_groups(cuda, dtype, h, kv, t):
    """qwen3-moe-235b's decode (G = H / KV = 16, the ``GMAX = 16``
    configuration) and llava-next-34b's (G = 7, ``GMAX = 8``), d 128,
    batch 8, at positions 0, mid and T - 1: against the plain version, and
    both passes against theirs."""
    from repro_torch.kernels import decode_attention as da
    q, k, v = _attn_inputs(dtype, (8, h, 128), (8, t, kv, 128),
                           (8, t, kv, 128), seed=h)
    splits = da.plan_splits(8, kv, t, 128, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    for position in (0, t // 2, t - 1):
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, position)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + da.LAUNCHES_PER_CALL
        _assert_attn_close(got, da.decode_attention_plain(q, k, v, position),
                           dtype)
        out, m, l, acc = da.launch(q, k, v, position, splits)
        wm, wl, wacc = da.decode_attention_partials_plain(q, k, v, position,
                                                          splits)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(acc, wacc, rtol=1e-4, atol=1e-4)
        _assert_attn_close(out, da.decode_attention_combine_plain(
            m, l, acc, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,s", [(64, 4, 512), (56, 8, 640)])
def test_flash_attention_at_the_moe_and_vlm_groups(cuda, dtype, h, kv, s):
    """The prefills' causal flash launches at G = 16 (qwen3-moe-235b) and
    G = 7 (llava-next-34b), d 128, batch 2, through the model's strided
    views."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(dtype, (2, h, s, 128), (2, kv, s, 128),
                           (2, kv, s, 128), seed=s)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    for args in [(q, k, v), tuple(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2) for x in (q, k, v))]:
        before = fa.flash_attention.launches_by_variant[fa.VARIANTS[dtype]]
        got = fa.flash_attention(*args, causal=True)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches_by_variant[
            fa.VARIANTS[dtype]] == before + 1
        _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "kimi-k2-1t"])
def test_moe_kernel_path_equals_its_plain_path_on_the_card(cuda, arch):
    """A smoke MoE LM on the card in f32: one ``cscatter`` call (the
    combine) a MoE layer a forward, one flash launch a layer at prefill
    and a ``decode_attention`` call a layer a step; its logits within 1e-4
    of the same weights with the plain attention, the combine through the
    CUDA kernel in both (the plain path swaps only the attention)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, device=cuda, seed=1)
    tokens = serve_batch(cfg, 2, 24, 1)["tokens"]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    fa.flash_attention.launches = da.decode_attention.launches = 0
    cs.cscatter.launches = 0
    res = generate(model, tokens, 5, keep_logits=True)
    assert fa.flash_attention.launches == cfg.n_layers
    assert da.decode_attention.launches == cfg.n_layers * 4 * \
        da.LAUNCHES_PER_CALL
    assert cs.cscatter.launches == n_moe * 5 * cs.LAUNCHES_PER_CALL
    model.impl = "plain"
    logits, caches = model.prefill(torch.as_tensor(tokens, device=cuda), 29)
    steps = [logits]
    for i in range(4):
        logits, caches = model.decode_step(res.tokens[:, i], caches, 24 + i)
        steps.append(logits)
    assert fa.flash_attention.launches == cfg.n_layers
    for got, want in zip(res.logits, steps):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MoE training: the expert-parallel train step and the donating optimizer
# ---------------------------------------------------------------------------


def _moe_train_cfg(arch, dtype="float32"):
    """``arch``'s smoke config with ``moe_impl="ep"`` and the full config's
    optimizer (the smoke configs are "gshard" with AdamW)."""
    from repro_torch.configs.base import get_config, get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               moe_impl="ep",
                               optimizer=get_config(arch).optimizer)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "kimi-k2-1t"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_optimizer_step_equals_the_functional_one_on_the_card(
        cuda, arch, dtype):
    """AdamW (qwen3-moe) and Adafactor (kimi-k2) over a smoke tree on the
    card, 3 steps on seeded gradients: the donating step's parameters and
    moments equal the functional step's bit for bit, and are the tensors
    it was given."""
    from torch.utils import _pytree as pytree
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant, make_optimizer
    cfg = _moe_train_cfg(arch, dtype)
    opt = make_optimizer(cfg, constant(1e-3))
    params = build_model(cfg, device=cuda, seed=0).params()
    g = torch.Generator(device=cuda).manual_seed(1)

    def clone(tree):
        return pytree.tree_map(lambda x: x.clone() if isinstance(
            x, torch.Tensor) else x, tree)
    func = (params, opt.init(params))
    don = clone(func)
    before = [x for x in pytree.tree_leaves(don)
              if isinstance(x, torch.Tensor) and x.dim()]
    for _ in range(3):
        grads = pytree.tree_map(lambda p: (torch.randn(
            p.shape, device=cuda, generator=g) * 30).to(p.dtype), params)
        p, o, _ = opt.step(func[0], clone(grads), func[1])
        func = (p, o)
        p, o, _ = opt.step(don[0], grads, don[1], donate=True)
        don = (p, o)
    got = [x for x in pytree.tree_leaves(don)
           if isinstance(x, torch.Tensor) and x.dim()]
    want = [x for x in pytree.tree_leaves(func)
            if isinstance(x, torch.Tensor) and x.dim()]
    assert len(got) == len(want) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(a is b for a, b in zip(got, before))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "kimi-k2-1t"])
def test_ep_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """Two eager steps over chip:2 with the MoE layers over 2 stacked model
    ranks, in f32 from the same weights: on the card (the combine and the
    embedding backward through the CUDA ``cscatter``, its launches as the
    path predicts) and on the CPU (their plain versions); the losses to
    1e-5 and the parameters within 1e-5 of 1 + each leaf's largest."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.data.pipeline import batch_at, data_config_for
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant, make_optimizer
    cfg = _moe_train_cfg(arch)
    opt = make_optimizer(cfg, constant(1e-3))
    dcfg = data_config_for(cfg, ShapeConfig("t", 32, 4, "train"), seed=0)
    runs = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device="cpu", seed=0,
                            model_ranks=2).to(device)
        step = steps.make_train_step(model, cfg, opt,
                                     merge_topology=MergePlan.parse("chip:2"))
        params = model.params()
        state = {"params": params, "opt": opt.init(params)}
        cs.cscatter.launches = 0
        losses = []
        for i in range(2):
            state, m = step(state, batch_at(dcfg, i))
            losses.append(float(m["loss"]))
        runs[str(device)] = (losses, state["params"], cs.cscatter.launches)
    (cl, cp, _), (gl, gp, launches) = runs["cpu"], runs[str(cuda)]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert launches == cs.LAUNCHES_PER_CALL * 2 * 2 * (n_moe + 1)
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    for a, b in zip(pytree.tree_leaves(gp), pytree.tree_leaves(cp)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * (1 + float(b.abs().max()))


# ---------------------------------------------------------------------------
# the selective scan (hymba-1.5b's SSM), forward and backward
# ---------------------------------------------------------------------------


def _scan_case(b, t, d, s, u_dtype, device, seed=0, dt_shift=0.0):
    """dt after softplus (of normals + ``dt_shift``), u, b, c, a = -(1..S)
    as the init's, h0 and the cotangents dy, dh, from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=device)
    dt = torch.nn.functional.softplus(f(b, t, d) + dt_shift)
    a = -torch.arange(1, s + 1, dtype=torch.float32,
                      device=device).repeat(d, 1)
    return ([dt, f(b, t, d).to(u_dtype), f(b, t, s), f(b, t, s), a,
             f(b, d, s)], f(b, t, d), f(b, d, s))


def _scan_grads(fn, ins, dy, dh):
    ins = [x.detach().requires_grad_(True) for x in ins]
    y, h = fn(*ins)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    return (y, h), torch.autograd.grad(loss, ins)


def _assert_scan_close(ins, dy, dh):
    """The kernels against the plain version on the same inputs: y and h_T
    within 1e-5 of their largest magnitude, every gradient within 1e-4 of
    its own (two f32 orders of summation); a bf16 u's gradient, rounded
    once in both, also within one bf16 ulp of each element. Counts one
    call's launches."""
    from repro_torch.kernels import selective_scan as sc
    from repro_torch.kernels.ops import selective_scan
    before = (sc.selective_scan.launches_forward,
              sc.selective_scan.launches_backward)
    (y, h), got = _scan_grads(selective_scan, ins, dy, dh)
    torch.cuda.synchronize()
    assert (sc.selective_scan.launches_forward - before[0],
            sc.selective_scan.launches_backward - before[1]) == (
        sc.LAUNCHES_PER_CALL["forward"], sc.LAUNCHES_PER_CALL["backward"])
    (yp, hp), want = _scan_grads(sc.selective_scan_plain, ins, dy, dh)
    u_bf16 = ins[1].dtype == torch.bfloat16
    for name, g, w, tol in (("y", y, yp, 1e-5), ("h_T", h, hp, 1e-5)) + tuple(
            (f"d {n}", g, w, 1e-4) for n, g, w in
            zip(("dt", "u", "b", "c", "a", "h0"), got, want)):
        assert g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max())
        if name == "d u" and u_bf16:
            assert bool((err <= 2 ** -7 * w.float().abs()
                         + tol * scale).all()), name
        else:
            assert float(err.max()) <= tol * scale, (name, float(err.max()),
                                                     scale)


SCAN_L = SEGMENT


@pytest.mark.parametrize("t", [1, SCAN_L - 1, SCAN_L, SCAN_L + 1, 300,
                               2 * SCAN_L + 3])
@pytest.mark.parametrize("s", [4, 8, 16])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain_forward_and_backward(
        cuda, s, u_dtype, t):
    """T around the chunk L (one step, a partial chunk, one, one and a
    step, several and a partial one) and a ragged D (100: a partial
    CTA)."""
    ins, dy, dh = _scan_case(2, t, 100, s, u_dtype, cuda)
    _assert_scan_close(ins, dy, dh)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_from_a_nonzero_state_with_h_t_unused(cuda, u_dtype):
    """A nonzero h0 and a loss of y alone: the backward's carry starts
    from zero (no dh_T), and d h0 is still the carry out of the first
    chunk."""
    ins, dy, _ = _scan_case(2, 2 * SCAN_L + 3, 100, 16, u_dtype, cuda,
                            seed=2)
    _assert_scan_close(ins, dy, None)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_where_the_decays_underflow(cuda, u_dtype):
    """dt = softplus(x + 8) (about 8) against a = -(1..16): exp(dt a)
    underflows to 0 for most states, and so do the chunks' decay
    products; nothing divides by them."""
    ins, dy, dh = _scan_case(2, 300, 100, 16, u_dtype, cuda, seed=3,
                             dt_shift=8.0)
    _assert_scan_close(ins, dy, dh)


@pytest.mark.parametrize("t", [300, 2 * SCAN_L + 3])
@pytest.mark.parametrize("s", [4, 16])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_with_small_steps_carries_the_state_over_chunks(
        cuda, u_dtype, s, t):
    """dt = softplus(x - 5) (about 0.007, as a trained model's): a chunk's
    decay product stays between ~1e-3 and ~0.6, so the start state and the
    adjoint's carry reach several chunks on, forward and backward. At the
    init's dt (about 0.8) they are below f32 rounding after one chunk
    (``tests/test_torch_ssm.py`` shows the difference)."""
    ins, dy, dh = _scan_case(2, t, 100, s, u_dtype, cuda, seed=4,
                             dt_shift=-5.0)
    _assert_scan_close(ins, dy, dh)


def test_selective_scan_backward_is_bitwise_repeatable(cuda):
    """The sums over channels and over (batch, time) are per-CTA and
    per-(row, chunk) partials added in a fixed order: no float atomics."""
    from repro_torch.kernels.ops import selective_scan
    ins, dy, dh = _scan_case(2, 600, 200, 16, torch.bfloat16, cuda, seed=1)
    first = _scan_grads(selective_scan, ins, dy, dh)[1]
    second = _scan_grads(selective_scan, ins, dy, dh)[1]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("s", [2, 5, 32])
def test_selective_scan_refuses_a_d_state_it_has_no_kernel_for(cuda, s):
    from repro_torch.kernels import selective_scan as sc
    ins, _, _ = _scan_case(1, 16, 32, s, torch.float32, cuda)
    before = sc.selective_scan.launches
    with pytest.raises(ValueError, match="d_state"):
        sc.selective_scan(*ins)
    assert sc.selective_scan.launches == before


# -- the pipeline schedule and the static verifier on the card -------------


def test_pipeline_of_decoder_layers_on_the_card_equals_the_serial_run(cuda):
    """4 stacked stages of qwen1.5-0.5b's smoke layers (bf16) through the
    CUDA flash_attention: the last stage's outputs bitwise equal to the
    same layers run serially through the same function, one flash launch
    a stage a tick."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.stacked import StackedAxis
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import pipeline_apply

    stages, n_micro, mb, seq = 4, 5, 2, 64
    cfg = dataclasses.replace(get_smoke_config("qwen1-5-0-5b"),
                              n_layers=stages, dtype="bfloat16")
    model = build_model(cfg, device=cuda, seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n_micro, mb, seq, cfg.d_model), generator=g).to(
        cuda, torch.bfloat16)
    positions = torch.arange(seq, dtype=torch.int32, device=cuda)
    scan = model._caches(stages, mb, seq, x.dtype)
    caches = [attn.KVCache(k=scan.k[i], v=scan.v[i]) for i in range(stages)]
    params = model.params()["blocks"]
    layer = lambda i: pytree.tree_map(lambda a: a[i], params)

    def stage_fn(p, xs):
        return torch.stack([model._block_prefill(layer(i), xs[i], positions,
                                                 caches[i])
                            for i in range(stages)])

    with torch.no_grad():
        before = flash_attention.launches
        got = pipeline_apply(stage_fn, params,
                             x[None].expand((stages,) + tuple(x.shape)),
                             StackedAxis(stages, cuda))
        launches = flash_attention.launches - before
        want = []
        for m in range(n_micro):
            h = x[m]
            for i in range(stages):
                h = model._block_prefill(layer(i), h, positions, caches[i])
            want.append(h)
    assert torch.equal(got[-1], torch.stack(want))
    assert launches == stages * (n_micro + stages - 1)


def test_the_serve_sweep_on_the_card_is_clean_through_the_kernels(cuda):
    from repro_torch.analysis import Report, cli

    report = Report()
    before = (cs.cscatter.launches, cm.cmerge.launches)
    cli.sweep_serve(report, cuda)
    assert report.ok(), report.format()
    # its stores, shapes and seeds are fixed: 20 cscatter calls of the
    # kernel store's ticks, 520 cmerge launches of the blocked stores'
    assert (cs.cscatter.launches - before[0],
            cm.cmerge.launches - before[1]) == (
                20 * cs.LAUNCHES_PER_CALL, 520)
    missed = [r["name"] for r in cli.run_fixtures(cuda) if not r["tripped"]]
    assert not missed


def test_taint_follows_the_cuda_cscatter(cuda):
    """The kernel writes its table past the dispatcher; its wrapper's
    kernel event carries keys and values into the pending, and a tick that
    scatters into the settled table is caught."""
    from repro_torch.analysis import check_kv_tick_taint, out_deps
    from repro_torch.apps.common import scatter
    from repro_torch.serve.kv import KVConfig, ShardedKV, serving_plan

    kv = ShardedKV(KVConfig(n_keys=256, cols=2), 8, device=cuda,
                   plan=serving_plan(8, "all"), commit_every=4)
    settled, pendings, keys, vals = kv.tick_args(32)
    deps = out_deps(kv.raw_tick_fn(0), (settled, pendings, keys, vals))
    n = len(pendings)
    assert deps[0] == {0} and deps[1] == {1, n + 1, n + 2}

    def leaky(settled, pendings, keys, vals):
        return scatter(settled, keys, vals, kind="add"), tuple(pendings)

    assert [d.code for d in check_kv_tick_taint(
        leaky, settled, pendings, keys, vals, "leaky")] == ["CC012"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_the_direct_launches_bitwise(cuda, dtype):
    """Each kernel's dispatcher-visible op (the planner's route,
    ``kernels/custom_ops.py``) on CUDA tensors launches the same kernel as
    the direct call: the same bits, and the same launch counts."""
    from repro_torch.kernels import cscatter as csm
    from repro_torch.kernels import custom_ops  # noqa: F401 (registers)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    op = torch.ops.repro_torch
    q, k, v = _attn_inputs(dtype, (2, 8, 100, 64), (2, 2, 100, 64),
                           (2, 2, 100, 64), seed=5)
    before = fa.flash_attention.launches
    assert torch.equal(op.flash_attention(q, k, v, True, 0),
                       fa.flash_attention(q, k, v, causal=True))
    assert fa.flash_attention.launches == before + 2
    qd, kd, vd = _attn_inputs(dtype, (2, 16, 128), (2, 257, 8, 128),
                              (2, 257, 8, 128), seed=6)
    before = da.decode_attention.launches
    assert torch.equal(op.decode_attention(qd, kd, vd, 200),
                       da.decode_attention(qd, kd, vd, 200))
    assert da.decode_attention.launches == before + 2 * da.LAUNCHES_PER_CALL
    out, lse = op.decode_attention_lse(qd, kd, vd, 200)
    assert torch.equal(out, da.decode_attention(qd, kd, vd, 200))
    assert lse.shape == (2, 16) and torch.isfinite(lse).all()
    if dtype == torch.float32:
        table, ids, vals = _case(dtype, 1, 4096, 64, 3000, 7, cuda)[:3]
        table, ids, vals = table[0], ids[0], vals[0]
        a, b = table.clone(), table.clone()
        before = csm.cscatter.launches
        op.cscatter(a, ids, vals, "add", 0.0, 0.0)
        csm.cscatter(b, ids, vals, kind="add")
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert csm.cscatter.launches == before + 2 * csm.LAUNCHES_PER_CALL
    # the scan (u in ``dtype``): the op's forward, and its backward op
    # through autograd (the forward kernels again, then the backward's),
    # against the direct call's ``_Scan``
    from repro_torch.kernels import selective_scan as sc
    ins, dy, dh = _scan_case(2, 2 * SEGMENT + 5, 48, 16, dtype, cuda, seed=7)
    before = (sc.selective_scan.launches_forward,
              sc.selective_scan.launches_backward)
    (y, h), got = _scan_grads(op.selective_scan, ins, dy, dh)
    torch.cuda.synchronize()
    fwd, bwd = (sc.LAUNCHES_PER_CALL["forward"],
                sc.LAUNCHES_PER_CALL["backward"])
    assert (sc.selective_scan.launches_forward - before[0],
            sc.selective_scan.launches_backward - before[1]) == (2 * fwd, bwd)
    (yd, hd), want = _scan_grads(sc.selective_scan, ins, dy, dh)
    torch.cuda.synchronize()
    assert (sc.selective_scan.launches_forward - before[0],
            sc.selective_scan.launches_backward - before[1]) == (
        3 * fwd, 2 * bwd)
    for g, w in zip((y, h) + got, (yd, hd) + want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_prefill_counts_on_the_card_equal_the_traced_ones(cuda):
    """The count check (``chip_smoke.py`` ``phase_dryrun`` (b)) at a smoke
    size: qwen1.5-0.5b's smoke prefill in bf16 run on the card under the op
    walk and traced on a 1 x 1 fake mesh give equal FLOPs, HBM bytes and
    boundary bytes."""
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import mesh, steps
    from repro_torch.launch.op_cost import OpWalk
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config("qwen1_5_0_5b")
    model = build_model(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                           device="cuda")
    model.prefill(tokens, 64)
    walk = OpWalk(inputs=[*model.parameters(), tokens])
    with walk:
        logits, caches = model.prefill(tokens, 64)
        out = steps.greedy(logits), caches
    walk.add_outputs(out)
    real = walk.result()
    try:
        one = mesh.make_host_mesh(1, 1)
        fake = steps.plan_prefill(cfg, ShapeConfig("p", 64, 2, "prefill"),
                                  one).trace()
    finally:
        mesh.shutdown()
    assert real["flops"] == fake["flops"]
    assert real["hbm_bytes"] == fake["hbm_bytes"]
    assert real["boundary_bytes"] == fake["boundary_bytes"] > 0
    assert real["kernels"]["flash_attention"]["calls"] == cfg.n_layers


# ---------------------------------------------------------------------------
# MeshAxis on the card: 2 processes, gloo (sharing a card, staged through
# the host) and, with 2 cards, NCCL (one card a process)
# ---------------------------------------------------------------------------

MESH_PERMS = {"swap": [(0, 1), (1, 0)], "lone": [(1, 0)], "self": [(0, 0)]}


def _mesh_input() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(4).integers(
        -2**20, 2**20, (2, 33, 5)).astype(np.int32))


def _mesh_axis_worker(backend: str, rank: int, init: str, work: str) -> None:
    """One process of the 2-process group: every collective of its
    ``MeshAxis`` on its row of :func:`_mesh_input` on the card, gathered."""
    from pathlib import Path
    from repro_torch.apps.sharded import mesh_spmd
    from repro_torch.launch import mesh as pmesh
    mesh = pmesh.init_shards(backend, "cuda", init_method=f"file://{init}",
                             rank=rank, world_size=2)
    spmd = mesh_spmd(mesh)
    axis = spmd.axis
    mine = spmd.local(_mesh_input()).cuda()
    out = {"device": np.asarray(mine.device.index),
           "backend": np.asarray(axis.backend)}
    for name, perm in MESH_PERMS.items():
        out[f"ppermute/{name}"] = spmd.gather(axis.ppermute(mine, perm))
    for kind in ("psum", "pmax", "pmin"):
        out[kind] = spmd.gather(getattr(axis, kind)(mine))
    out["gather"] = spmd.gather(mine)
    np.savez(Path(work, f"rank{rank}.npz"),
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
    spmd.barrier()
    pmesh.shutdown()


def _mesh_axis_run(backend: str, work) -> list:
    import os
    import sys
    from pathlib import Path
    from repro_torch.launch.mesh import spawn_shards
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    spawn_shards(lambda r: [sys.executable, __file__, "--mesh-axis-worker",
                            backend, str(r), str(work / "init"), str(work)],
                 2, work, 240, env=env)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]


def _mesh_axis_check(ranks: list, backend: str) -> None:
    from repro_torch.core.stacked import StackedAxis
    axis = StackedAxis(2, "cuda")
    x = _mesh_input().cuda()
    for res in ranks:
        assert str(res["backend"]) == backend
        for name, perm in MESH_PERMS.items():
            np.testing.assert_array_equal(res[f"ppermute/{name}"],
                                          axis.ppermute(x, perm).cpu())
        for kind in ("psum", "pmax", "pmin"):
            np.testing.assert_array_equal(res[kind],
                                          getattr(axis, kind)(x).cpu())
        np.testing.assert_array_equal(res["gather"], x.cpu())


def test_mesh_axis_on_gloo_with_card_tensors_equals_the_stacked_axis(
        cuda, tmp_path):
    """Two processes on a gloo group with their tensors on the card (one
    card shared: the exchanges and the gather staged through pinned host
    buffers): ppermute (a swap, a round in which rank 0 only receives and
    rank 1 only sends, a self pair), psum, pmax, pmin and the gather,
    bitwise the stacked axis's on the card."""
    ranks = _mesh_axis_run("gloo", tmp_path)
    _mesh_axis_check(ranks, "gloo")


def test_mesh_axis_on_nccl_equals_the_stacked_axis(cuda, tmp_path):
    """The same over NCCL, one card a process (every group's first call
    joined by all of its ranks, then rounds that leave a rank idle)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs one card a process: this host has "
                    f"{torch.cuda.device_count()} card(s)")
    ranks = _mesh_axis_run("nccl", tmp_path)
    assert [int(r["device"]) for r in ranks] == [0, 1]
    _mesh_axis_check(ranks, "nccl")


# ---------------------------------------------------------------------------
# the train CLI over processes on the card: gloo sharing it (its gathers
# staged through the host), NCCL one card a process
# ---------------------------------------------------------------------------


def _train_cli(tmp_path, *flags):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1-5-0-5b", "--smoke", "--batch", "8", "--seq", "64", "--steps",
         "3", "--ckpt-every", "3", "--lr", "1e-3", "--warmup", "2", *flags],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("plan", [[], ["--merge-topology", "chip:2"],
                                  ["--merge-topology", "chip:2:defer",
                                   "--merge-defer", "2"]],
                         ids=["implicit", "eager", "deferred"])
def test_train_cli_over_gloo_processes_sharing_the_card(cuda, tmp_path,
                                                         plan):
    """``--procs 2 --backend gloo`` on one card (the FSDP gathers, the
    checkpoint's gathers staged through the host; the gradient
    reductions on the card) against the stacked run of the same flags:
    every parameter within a bf16 rounding plus 2 lr a step."""
    from repro_torch import checkpoint as ckpt
    procs = _train_cli(tmp_path, *plan, "--procs", "2", "--backend", "gloo",
                       "--ckpt-dir", str(tmp_path / "procs"))
    assert procs.returncode == 0, procs.stderr[-3000:]
    assert "steps 0..3: loss" in procs.stdout
    stacked = _train_cli(tmp_path, *plan, "--ckpt-dir",
                         str(tmp_path / "stacked"))
    assert stacked.returncode == 0, stacked.stderr[-3000:]
    got, _ = ckpt.load_raw(str(tmp_path / "procs"))
    want, _ = ckpt.load_raw(str(tmp_path / "stacked"))
    keys = [k for k in want if k.startswith("params/")]
    assert keys and sorted(got) == sorted(want)
    for k in keys:
        g = torch.as_tensor(got[k]).float()
        w = torch.as_tensor(want[k]).float()
        assert bool(((g - w).abs() <= 2 ** -7 * w.abs() + 6e-3).all()), k


def test_train_cli_over_a_model_axis_of_gloo_processes(cuda, tmp_path):
    """``--procs 4 --model-ranks 2 --backend gloo`` on one card, the
    ``(2, 2)`` mesh (heads, ``mlp`` and ``vocab`` split over ``"model"``,
    the FSDP gathers at each use staged through the host) against the
    stacked run over the same two data ranks: every parameter within a
    bf16 rounding plus 2 lr a step."""
    from repro_torch import checkpoint as ckpt
    procs = _train_cli(tmp_path, "--procs", "4", "--model-ranks", "2",
                       "--backend", "gloo", "--ckpt-dir",
                       str(tmp_path / "procs"))
    assert procs.returncode == 0, procs.stderr[-3000:]
    assert "steps 0..3: loss" in procs.stdout
    stacked = _train_cli(tmp_path, "--merge-topology", "chip:2",
                         "--ckpt-dir", str(tmp_path / "stacked"))
    assert stacked.returncode == 0, stacked.stderr[-3000:]
    got, _ = ckpt.load_raw(str(tmp_path / "procs"))
    want, _ = ckpt.load_raw(str(tmp_path / "stacked"))
    keys = [k for k in want if k.startswith("params/")]
    assert keys and sorted(got) == sorted(want)
    for k in keys:
        g = torch.as_tensor(got[k]).float()
        w = torch.as_tensor(want[k]).float()
        assert bool(((g - w).abs() <= 2 ** -7 * w.abs() + 6e-3).all()), k


def _staged_autograd_worker(rank: int, init: str, work: str,
                            device: str = "cuda") -> None:
    """One process of a ``(2, 2)`` gloo mesh on the card: gathers of a
    DTensor through ``core/mesh_axis.redistribute`` inside autograd (over
    both dims, over ``"model"`` alone, and a partial sum made whole), the
    outputs and the input's gradient of each, on the card and again on
    the same ranks' CPU mesh."""
    from pathlib import Path
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.core import mesh_axis
    from repro_torch.launch import mesh as pmesh
    card = pmesh.init_train_mesh("gloo", device,
                                 init_method=f"file://{init}", rank=rank,
                                 world_size=4, model=2)
    host = DeviceMesh("cpu", card.mesh, mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    x0, w0 = torch.randn(8, 6, generator=g), torch.randn(8, 6, generator=g)
    cases = {"whole": ([Shard(0), Shard(1)], [Replicate(), Replicate()]),
             "model": ([Shard(0), Shard(1)], [Shard(0), Replicate()]),
             "partial": ([Partial(), Shard(0)], [Replicate(), Replicate()])}
    out = {"staged": np.asarray(0)}
    calls = []
    on_host = mesh_axis._on_host
    mesh_axis._on_host = lambda *a: calls.append(1) or on_host(*a)
    for name, (src, dst) in cases.items():
        for label, mesh in (("card", card), ("cpu", host)):
            on = device if label == "card" else "cpu"
            whole = DTensor.from_local(x0.to(on), mesh,
                                       [Replicate(), Replicate()])
            x = (whole.redistribute(mesh, src) if name != "partial" else
                 DTensor.from_local(whole.redistribute(
                     mesh, [Replicate(), Shard(0)]).to_local() / 2, mesh,
                     src, run_check=False, shape=whole.shape,
                     stride=whole.stride()))
            x = x.detach().requires_grad_(True)
            y = mesh_axis.redistribute(x, dst)
            w = DTensor.from_local(w0.to(on), mesh,
                                   [Replicate(), Replicate()]
                                   ).redistribute(mesh, dst)
            (y * w).sum().backward()
            out[f"{name}/{label}/y"] = y.to_local().detach().cpu().numpy()
            out[f"{name}/{label}/grad"] = x.grad.to_local().cpu().numpy()
    out["staged"] = np.asarray(len(calls))
    np.savez(Path(work, f"rank{rank}.npz"), **out)
    pmesh.shutdown()


def test_a_staged_gather_inside_autograd_on_gloo_with_card_tensors(
        cuda, tmp_path):
    """A gather of a card tensor over gloo (DTensor's own all-gather of a
    card tensor kills the process there) runs through the host inside
    autograd: forward and backward on four processes sharing the card
    equal the same moves on the CPU, bit for bit, and each gathers of the
    card's went through the host."""
    import os
    import sys
    from pathlib import Path
    from repro_torch.launch.mesh import spawn_shards
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    spawn_shards(lambda r: [sys.executable, __file__, "--staged-worker",
                            str(r), str(tmp_path / "init"), str(tmp_path)],
                 4, tmp_path, 240, env=env)
    for r in range(4):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(got["staged"]) >= 3, got["staged"]
        for name in ("whole", "model", "partial"):
            for part in ("y", "grad"):
                np.testing.assert_array_equal(
                    got[f"{name}/card/{part}"], got[f"{name}/cpu/{part}"],
                    err_msg=f"{r} {name} {part}")


def test_train_mesh_on_nccl_with_more_processes_than_cards_raises(cuda):
    """The train mesh on NCCL with more processes than the host has
    cards raises before it makes a process group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as pmesh
    with pytest.raises(RuntimeError, match="one card a process"):
        pmesh.init_train_mesh("nccl", rank=0,
                              world_size=torch.cuda.device_count() + 1,
                              init_method="file:///nonexistent")
    assert not dist.is_initialized()


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--staged-worker"]:
        _staged_autograd_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--mesh-axis-worker"]:
        _mesh_axis_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4],
                          sys.argv[5])
