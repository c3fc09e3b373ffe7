"""Parity of the port's selective SSM (``repro_torch/models/ssm.py``) with
the JAX package's ``repro/models/ssm.py`` on the same numpy inputs and
weights: the causal conv, the chunk scan, the chunked forward and the
decode step. f32 to 1e-5; bf16 to the dense tests' cache tolerances (the
two packages round bf16 products at other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.module import split_params
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _as_tensor

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
D_MODEL, D_STATE, D_INNER = 32, 4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(dtype: str, seed: int = 0):
    """JAX's init as numpy, with nonzero biases so every term counts."""
    p, _ = split_params(jssm.init(jax.random.key(seed), D_MODEL, D_STATE,
                                  D_INNER, getattr(jnp, dtype)))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for leaf, sub in ((p, "conv_b"), (p["dt_proj"], "b")):
        leaf[sub] = (0.1 * rng.standard_normal(leaf[sub].shape)).astype(
            leaf[sub].dtype)
    return p


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(_as_tensor, tree)


def _x(shape, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


def _close(got, want, dtype, what=""):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_conv1d_causal_matches_jax(dtype, history):
    p = _params(dtype)
    x = _x((2, 9, D_INNER), dtype)
    hist = _x((2, 3, D_INNER), dtype, seed=2) if history else None
    jo, jh = jssm._conv1d_causal(jnp.asarray(p["conv_w"]),
                                 jnp.asarray(p["conv_b"]), jnp.asarray(x),
                                 None if hist is None else jnp.asarray(hist))
    to, th = tssm._conv1d_causal(_as_tensor(p["conv_w"]),
                                 _as_tensor(p["conv_b"]), _as_tensor(x),
                                 None if hist is None else _as_tensor(hist))
    _close(to, jo, dtype, "out")
    _close(th, jh, dtype, "history")


@pytest.mark.parametrize("t", [1, 8, 37, 256])
def test_scan_chunk_matches_jax(t):
    """The log-depth scan against ``associative_scan``, with a carry-in."""
    rng = np.random.default_rng(t)
    da = rng.uniform(0.5, 1.0, (2, t, 6, 3)).astype(np.float32)
    dbx = rng.standard_normal((2, t, 6, 3)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 3)).astype(np.float32)
    jh, jl = jssm._scan_chunk(*map(jnp.asarray, (da, dbx, h0)))
    th, tl = tssm._scan_chunk(*map(torch.from_numpy, (da, dbx, h0)))
    _close(th, jh, "float32", "h")
    _close(tl, jl, "float32", "last")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [16, 512])
def test_apply_seq_matches_jax(dtype, t):
    """One chunk (T < 256) and two (T = 512)."""
    p = _params(dtype)
    x = _x((2, t, D_MODEL), dtype)
    want = jssm.apply_seq(_jax(p), jnp.asarray(x))
    got = tssm.apply_seq(_torch(p), _as_tensor(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """T decode steps chained from the empty state, each step's output
    and the state after it against JAX's."""
    p = _params(dtype)
    jp, tp = _jax(p), _torch(p)
    x = _x((2, 6, D_MODEL), dtype)
    js = jssm.init_state(jp, 2)
    ts = tssm.init_state(tp, 2)
    assert ts.h.dtype == torch.float32 and ts.conv.dtype == getattr(
        torch, dtype)
    for i in range(x.shape[1]):
        jy, js = jssm.decode_step(jp, jnp.asarray(x[:, i:i + 1]), js)
        ty, ts = tssm.decode_step(tp, _as_tensor(x[:, i:i + 1]), ts)
        _close(ty, jy, dtype, f"step {i}")
        _close(ts.h, js.h, dtype, f"h {i}")
        _close(ts.conv, js.conv, dtype, f"conv {i}")


def test_apply_seq_equals_its_decode_steps():
    """The chunked scan and T recurrent steps are the same function (f32),
    and the state the one pass returns is the last step's."""
    tp = _torch(_params("float32"))
    x = torch.from_numpy(_x((2, 12, D_MODEL), "float32"))
    seq, state = tssm.apply_seq_with_state(tp, x)
    st = tssm.init_state(tp, 2)
    outs = []
    for i in range(12):
        y, st = tssm.decode_step(tp, x[:, i:i + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), seq, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(state.h, st.h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.conv, st.conv)


def test_apply_seq_keeps_the_chunk_rule():
    """As JAX: above one chunk, T must be a multiple of it."""
    tp = _torch(_params("float32"))
    with pytest.raises(AssertionError):
        tssm.apply_seq(tp, torch.zeros((1, 300, D_MODEL)))
