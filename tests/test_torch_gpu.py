"""Tests of the port that need an NVIDIA GPU: the CUDA cscatter kernel
against its plain version, and the store on the card.

Marked ``gpu``; each skips with its reason where there is no card. This
file imports only PyTorch and the port, so that it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cscatter as cs
from repro_torch.kernels.ops import commutative_scatter

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


def test_store_on_the_card_matches_the_oracle(cuda):
    from repro_torch.serve import KVConfig, ShardedKV
    S, R, D, B, T = 8, 4096, 4, 64, 11
    rng = np.random.default_rng(1)
    keys = rng.integers(-1, R, (T, S, B)).astype(np.int32)
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    for partitioned in (False, True):
        kv = ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=partitioned),
                       S, commit_every=4)
        assert kv.device.type == "cuda"
        for t in range(T):
            kv.tick(keys[t], vals[t])
        kv.flush()
        want = np.zeros((R, D), np.int64)
        m = keys >= 0
        np.add.at(want, keys[m], vals[m])
        np.testing.assert_array_equal(kv.table().astype(np.int64), want)
