"""Tests of the port that need an NVIDIA GPU: the CUDA cscatter, cmerge,
flash_attention and decode_attention kernels against their plain versions,
the stores and the LM on the card.

Marked ``gpu``; each skips with its reason where there is no card. This
file imports only PyTorch and the port, so that it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cmerge as cm
from repro_torch.kernels import cscatter as cs
from repro_torch.kernels.ops import commutative_scatter, merge_buffer

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
        assert cs.cscatter.launches == before + 1
        if dtype.is_floating_point:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype] * 8)
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint32])
@pytest.mark.parametrize("s,w,br,d", [(2, 1, 8, 4), (3, 8, 8, 4),
                                      (2, 300, 4, 130)])
def test_cmerge_matches_plain_and_counts_its_launches(cuda, dtype, s, w, br,
                                                      d):
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


def _assert_attn_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype] * 4)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,t,d", [(2, 8, 8, 300, 64),
                                        (2, 16, 8, 257, 128),
                                        (1, 16, 1, 40, 256),
                                        (2, 4, 4, 50, 24)])
def test_decode_attention_matches_plain_and_counts_its_launches(
        cuda, dtype, b, h, kv, t, d):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ops import decode_attention
    q, k, v = _attn_inputs(dtype, (b, h, d), (b, t, kv, d), (b, t, kv, d))
    for pos in (0, 1, t // 2, t - 1):
        want = da.decode_attention_plain(q, k, v, pos)
        before = da.decode_attention.launches
        got = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        _assert_attn_close(got, want, dtype)
    # slots past the position are never read
    k[:, t // 2 + 1:] = float("nan")
    got = decode_attention(q, k, v, t // 2)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("arch", ["qwen1-5-0-5b", "internlm2-1-8b"])
def test_lm_serves_through_the_kernels_on_the_card(cuda, arch):
    """The smoke LM on the card launches flash_attention once a layer at
    prefill and decode_attention once a layer a step, and its logits equal
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
    assert da.decode_attention.launches == cfg.n_layers * 4
    model.attention = "plain"
    logits, caches = model.prefill(torch.as_tensor(p, device=cuda), 29)
    steps = [logits]
    for i in range(4):
        logits, caches = model.decode_step(res.tokens[:, i], caches, 24 + i)
        steps.append(logits)
    assert fa.flash_attention.launches == cfg.n_layers
    for got, want in zip(res.logits, steps):
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)
