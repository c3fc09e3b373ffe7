"""Tests of the port that need an NVIDIA GPU: the CUDA cscatter and cmerge
kernels against their plain versions, and the stores on the card.

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
