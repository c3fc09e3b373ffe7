"""The port's attention kernels (plain versions and CPU wrappers) and oracles
against the JAX package's Pallas kernels (``interpret=True``, as
``tests/test_kernels.py`` runs them) and oracles.

The same numpy inputs, made from a seed, go through both, at the JAX kernel
tests' ``TOL`` (1e-5 for f32, 2e-2 for bf16; absolute ``4 * TOL`` as
there). bf16 inputs are rounded once on the numpy side so that both
packages see the same bits. The CUDA kernels themselves run only on the
card: see ``tests/test_torch_gpu.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    MAX_SPLITS, NEG_INF, decode_attention, decode_attention_combine_plain,
    decode_attention_partials_plain, decode_attention_plain, plan_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py TOL


def _arrays(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        out.append(x)
    return out


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype] * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(64, 64), (32, 96)])
def test_flash_plain_matches_pallas_kernel_and_oracles(dtype, h, kv, causal,
                                                       s, t):
    q, k, v = _arrays(0, (2, h, s, 16), (2, kv, t, 16), (2, kv, t, 16),
                      dtype=dtype)
    jargs = [_j(x, dtype) for x in (q, k, v)]
    targs = [_t(x, dtype) for x in (q, k, v)]
    want = jops.flash_attention(*jargs, causal=causal, bq=32, bk=32)
    gold = jref.ref_attention(*jargs, causal=causal)
    got = flash_attention_plain(*targs, causal=causal)
    assert got.dtype == targs[0].dtype and got.shape == (2, h, s, 16)
    _close(got, want, dtype)
    _close(got, gold, dtype)
    _close(ref.ref_attention(*targs, causal=causal), gold, dtype)
    # the CPU wrapper and the ops entry point are the plain version
    assert torch.equal(flash_attention(*targs, causal=causal), got)
    assert torch.equal(ops.flash_attention(*targs, causal=causal), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_shapes_the_pallas_kernel_cannot_tile(dtype, causal):
    """S = T = 100 (and S = 37 against T = 100): no block size divides
    them, so they go against the oracles only."""
    for s, t in ((100, 100), (37, 100)):
        q, k, v = _arrays(1, (1, 4, s, 24), (1, 2, t, 24), (1, 2, t, 24),
                          dtype=dtype)
        got = flash_attention_plain(*(_t(x, dtype) for x in (q, k, v)),
                                    causal=causal)
        _close(got, jref.ref_attention(*(_j(x, dtype) for x in (q, k, v)),
                                       causal=causal), dtype)


@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_rounds_p_as_the_jax_model_does(h, kv, causal):
    """For bf16 inputs the plain version (and the tensor-core kernel it
    stands for) rounds p to bf16 before the P.V product, as the JAX model's
    attention does (``softmax(...).astype(v.dtype)`` in ``_attend`` and
    ``_attend_grouped``) and the Pallas kernel does not (it keeps p in f32).
    It agrees with both at the bf16 TOL."""
    from repro.models import attention as jattn
    s, d = 48, 32
    q, k, v = _arrays(5, (2, h, s, d), (2, kv, s, d), (2, kv, s, d),
                      dtype="bfloat16")
    got = flash_attention_plain(*(_t(x, "bfloat16") for x in (q, k, v)),
                                causal=causal)
    jq, jk, jv = (_j(x.transpose(0, 2, 1, 3), "bfloat16") for x in (q, k, v))
    mask = jnp.asarray(np.tril(np.ones((s, s), bool)) if causal
                       else np.ones((s, s), bool))[None]
    for attend in (jattn._attend, jattn._attend_grouped):
        model = np.asarray(attend(jq, jk, jv, mask), np.float32).reshape(
            2, s, h, d).transpose(0, 2, 1, 3)
        _close(got, model, "bfloat16")
    pallas = jops.flash_attention(*(_j(x, "bfloat16") for x in (q, k, v)),
                                  causal=causal, bq=16, bk=16)
    _close(got, pallas, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1, 37, 127])
def test_decode_plain_matches_pallas_kernel_and_oracles(dtype, pos):
    q, k, v = _arrays(2, (2, 8, 32), (2, 128, 2, 32), (2, 128, 2, 32),
                      dtype=dtype)
    jargs = [_j(x, dtype) for x in (q, k, v)]
    targs = [_t(x, dtype) for x in (q, k, v)]
    want = jops.decode_attention(*jargs, jnp.asarray(pos), bk=32)
    gold = jref.ref_decode_attention(*jargs, pos)
    got = decode_attention_plain(*targs, pos)
    assert got.dtype == targs[0].dtype and got.shape == (2, 8, 32)
    _close(got, want, dtype)
    _close(got, gold, dtype)
    _close(ref.ref_decode_attention(*targs, pos), gold, dtype)
    assert torch.equal(decode_attention(*targs, pos), got)
    assert torch.equal(ops.decode_attention(*targs, pos), got)


@functools.lru_cache(maxsize=None)
def _split_case(dtype, g):
    """A cache of T = 128 slots, H = 8 heads in groups of ``g``, d = 32,
    and the JAX Pallas kernel's output at each position the test takes."""
    q, k, v = _arrays(7 + g, (2, 8, 32), (2, 128, 8 // g, 32),
                      (2, 128, 8 // g, 32), dtype=dtype)
    jargs = [_j(x, dtype) for x in (q, k, v)]
    pallas = {pos: np.asarray(jops.decode_attention(
        *jargs, jnp.asarray(pos), bk=32), np.float32)
        for pos in (0, 1, 64, 127)}
    return (q, k, v), pallas


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("pos", [0, 1, 64, 127])
@pytest.mark.parametrize("splits", [1, 2, 7, 133])
def test_decode_split_and_combine_compose_to_the_pallas_kernel(dtype, g, pos,
                                                               splits):
    """The CUDA kernel's two passes in plain PyTorch: the per-split f32
    partials, merged, equal the JAX Pallas kernel and the one-pass plain
    version, at 1, 2, 7 and more splits (133) than the cache has slots
    (128); a split that starts past ``position`` is empty (m = NEG_INF,
    l = 0, acc = 0)."""
    arrays, pallas = _split_case(dtype, g)
    targs = [_t(x, dtype) for x in arrays]
    m, l, acc = decode_attention_partials_plain(*targs, pos, splits)
    assert m.shape == l.shape == (splits, 2, 8)
    assert acc.shape == (splits, 2, 8, 32) and acc.dtype == torch.float32
    chunk = -(-128 // splits)
    empty = torch.arange(splits) * chunk > pos
    assert bool((m[empty] == NEG_INF).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())
    assert bool((l[~empty] >= 1).all())       # exp(0) at each split's max
    got = decode_attention_combine_plain(m, l, acc, targs[0].dtype)
    assert got.dtype == targs[0].dtype and got.shape == (2, 8, 32)
    _close(got, pallas[pos], dtype)
    _close(got, decode_attention_plain(*targs, pos), dtype)


def test_decode_split_plan_fills_the_card_and_ignores_the_position():
    """``plan_splits`` takes no position, so every decode step over one
    cache launches the same grid: three splits (384 CTAs) at
    qwen1.5-0.5b's cache and eight (512) at internlm2-1.8b's on 132 SMs; a
    short cache gets one split, and no count leaves [1, MAX_SPLITS]."""
    assert plan_splits(8, 16, 576, 64, 132) == 3
    assert plan_splits(8, 8, 4096, 128, 132) == 8
    assert plan_splits(1, 1, 40, 256, 132) == 1
    for b, kv, t, d in ((1, 1, 1, 8), (1, 1, 1 << 20, 8), (64, 64, 8, 256)):
        assert 1 <= plan_splits(b, kv, t, d, 132) <= MAX_SPLITS


def test_decode_never_reads_past_position():
    """Slots past ``position`` may hold anything, NaN included."""
    q, k, v = (_t(x, "float32") for x in _arrays(
        3, (1, 4, 16), (1, 10, 4, 16), (1, 10, 4, 16)))
    want = decode_attention_plain(q, k, v, 5)
    k[:, 6:], v[:, 6:] = float("nan"), float("nan")
    assert torch.equal(decode_attention_plain(q, k, v, 5), want)


def test_decode_is_flash_over_the_cache_prefix():
    """A decode step at ``position`` equals the last query row of causal
    attention over the cache's first ``position + 1`` slots."""
    q, k, v = (_t(x, "float32") for x in _arrays(
        4, (2, 8, 16), (2, 12, 4, 16), (2, 12, 4, 16)))
    pos = 9
    got = decode_attention_plain(q, k, v, pos)
    ks, vs = (x[:, :pos + 1].transpose(1, 2) for x in (k, v))
    full = flash_attention_plain(q[:, :, None], ks, vs, causal=False)
    torch.testing.assert_close(got, full[:, :, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "groups", "kv_d",
                                 "position"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q4, k4 = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    q3, kc = torch.zeros(1, 4, 16), torch.zeros(1, 8, 2, 16)
    pos = 3
    if bad == "dtype":
        q4, k4, q3, kc = (x.double() for x in (q4, k4, q3, kc))
    elif bad == "mixed":
        k4, kc = k4.bfloat16(), kc.bfloat16()
    elif bad == "rank":
        q4, q3 = q4[0], q3[0]
    elif bad == "groups":                 # KV must divide H
        k4, kc = torch.zeros(1, 3, 8, 16), torch.zeros(1, 8, 3, 16)
    elif bad == "kv_d":
        k4, kc = torch.zeros(1, 2, 8, 8), torch.zeros(1, 8, 2, 8)
    else:
        pos = 8
    if bad != "position":
        with pytest.raises((TypeError, ValueError)):
            flash_attention(q4, k4, k4)
    with pytest.raises((TypeError, ValueError)):
        decode_attention(q3, kc, kc, pos)
