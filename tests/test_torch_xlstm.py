"""Parity of the port's xLSTM (``repro_torch/models/xlstm.py``,
``xlstm_lm.py``) with the JAX package's ``repro/models/xlstm.py`` and
``xlstm_lm.py`` on the same numpy inputs and weights: the mLSTM chunk, its
chunked forward and decode step, the sLSTM cell, forward and decode step,
and ``XLSTMModel`` at ``xlstm_125m.smoke_config()`` (prefill logits and
states, decode steps, the loss and every gradient, the eager and deferred
train steps over stacked ranks against the composed JAX reference of
``tests/test_torch_train.py``).

Tolerances: f32 to 1e-5 (the recurrences' gradients, whose sums cancel, to
1e-5 relative plus 1e-5 of each leaf's largest magnitude, as the dense
LM's); bf16 to the dense tests' tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import xlstm as jx
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.core import grad_merge as gm
from repro_torch.models import xlstm as tx
from repro_torch.models.registry import from_jax_params
from repro_torch.models.transformer import _as_tensor
from repro_torch.models.xlstm_lm import XLSTMModel

from test_torch_train import Pair, _assert_trees_close, _flat_jax, _flat_torch

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bf16 mLSTM over two chunks: the exponential input gate turns a one-ulp
# difference of a bf16 projection (the packages round at other places) into
# several ulps of a few outputs; at T = 512 4 of 32768 exceed 5e-2, the
# worst by 0.068, at an RMS difference of 0.005
BF16_TWO_CHUNKS = (2e-2, 1e-1)
ARCH = "xlstm-125m"
D_MODEL, HEADS = 32, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tagged):
    return jax.tree.map(np.asarray, split_params(tagged)[0])


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(_as_tensor, tree)


def _x(shape, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


def _close(got, want, dtype, what="", tol=None):
    rtol, atol = tol or TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _mlstm_params(dtype, seed=0):
    p = _np_tree(jx.init(jax.random.key(seed), D_MODEL, HEADS,
                         getattr(jnp, dtype)))
    rng = np.random.default_rng(seed)
    for leaf, sub in ((p, "conv_b"), (p["w_if"], "b")):
        leaf[sub] = (0.5 * rng.standard_normal(leaf[sub].shape)).astype(
            leaf[sub].dtype)
    return p


def _slstm_params(dtype, seed=0):
    p = _np_tree(jx.slstm_init(jax.random.key(seed), D_MODEL, HEADS,
                               getattr(jnp, dtype)))
    p["w_x"]["b"] = (0.5 * np.random.default_rng(seed).standard_normal(
        p["w_x"]["b"].shape)).astype(p["w_x"]["b"].dtype)
    return p


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carry", ["empty", "full"])
def test_mlstm_chunk_matches_jax(carry):
    rng = np.random.default_rng(3)
    b, h, c, d = 2, 2, 16, 8
    q, k, v = (rng.standard_normal((b, h, c, d)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, h, c)).astype(np.float32)
    lf = np.log(rng.uniform(0.5, 1.0, (b, h, c))).astype(np.float32)
    if carry == "empty":
        state = (np.zeros((b, h, d, d), np.float32),
                 np.zeros((b, h, d), np.float32),
                 np.full((b, h), -1e30, np.float32))
    else:
        state = (rng.standard_normal((b, h, d, d)).astype(np.float32),
                 rng.standard_normal((b, h, d)).astype(np.float32),
                 rng.standard_normal((b, h)).astype(np.float32))
    args = (q, k, v, li, lf)
    jh, jst = jx._mlstm_chunk(*map(jnp.asarray, args),
                              tuple(map(jnp.asarray, state)))
    th, tst = tx._mlstm_chunk(*map(torch.from_numpy, args),
                              tuple(map(torch.from_numpy, state)))
    _close(th, jh, "float32", "h")
    for name, got, want in zip("cnm", tst, jst):
        _close(got, want, "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [16, 512])
def test_mlstm_apply_seq_matches_jax(dtype, t):
    """Shorter than the chunk, and two chunks of 256."""
    p = _mlstm_params(dtype)
    x = _x((2, t, D_MODEL), dtype)
    want = jx.apply_seq(_jax(p), jnp.asarray(x), HEADS)
    got = tx.apply_seq(_torch(p), _as_tensor(x), HEADS)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, tol=BF16_TWO_CHUNKS
           if dtype == "bfloat16" and t > 256 else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_steps_match_jax(dtype):
    p = _mlstm_params(dtype)
    jp, tp = _jax(p), _torch(p)
    x = _x((2, 6, D_MODEL), dtype)
    js, ts = jx.init_state(jp, 2, HEADS), tx.init_state(tp, 2, HEADS)
    for i in range(x.shape[1]):
        jy, js = jx.decode_step(jp, jnp.asarray(x[:, i:i + 1]), js, HEADS)
        ty, ts = tx.decode_step(tp, _as_tensor(x[:, i:i + 1]), ts, HEADS)
        _close(ty, jy, dtype, f"step {i}")
        for name in ("c", "n", "m", "conv"):
            assert getattr(ts, name).dtype == torch.float32
            _close(getattr(ts, name), getattr(js, name), dtype,
                   f"{name} {i}")


def test_mlstm_apply_seq_equals_its_decode_steps():
    """The chunkwise form and T recurrent steps are the same function
    (f32), and the one pass's state is the last step's."""
    tp = _torch(_mlstm_params("float32"))
    x = torch.from_numpy(_x((2, 10, D_MODEL), "float32"))
    seq, state = tx.apply_seq_with_state(tp, x, HEADS)
    st = tx.init_state(tp, 2, HEADS)
    outs = []
    for i in range(10):
        y, st = tx.decode_step(tp, x[:, i:i + 1], st, HEADS)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), seq, rtol=1e-5,
                               atol=1e-5)
    for name in ("c", "n", "m", "conv"):
        torch.testing.assert_close(getattr(state, name), getattr(st, name),
                                   rtol=1e-5, atol=1e-5)


def test_slstm_cell_matches_jax():
    p = _slstm_params("float32")
    rng = np.random.default_rng(4)
    xg = rng.standard_normal((3, 4 * D_MODEL)).astype(np.float32)
    st = [rng.standard_normal((3, D_MODEL)).astype(np.float32)
          for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                   # a normalizer is > 0
    js = jx._slstm_cell(_jax(p), jnp.asarray(xg),
                        jx.SLSTMState(*map(jnp.asarray, st)), HEADS)
    ts = tx._slstm_cell(_torch(p), torch.from_numpy(xg),
                        tx.SLSTMState(*map(torch.from_numpy, st)), HEADS)
    for name in ("c", "n", "h", "m"):
        _close(getattr(ts, name), getattr(js, name), "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_seq_and_decode_steps_match_jax(dtype):
    p = _slstm_params(dtype)
    jp, tp = _jax(p), _torch(p)
    x = _x((2, 7, D_MODEL), dtype)
    _close(tx.slstm_apply_seq(tp, _as_tensor(x), HEADS),
           jx.slstm_apply_seq(jp, jnp.asarray(x), HEADS), dtype, "seq")
    js = jx.slstm_init_state(2, D_MODEL)
    ts = tx.slstm_init_state(2, D_MODEL)
    for i in range(x.shape[1]):
        jy, js = jx.slstm_decode_step(jp, jnp.asarray(x[:, i:i + 1]), js,
                                      HEADS)
        ty, ts = tx.slstm_decode_step(tp, _as_tensor(x[:, i:i + 1]), ts,
                                      HEADS)
        _close(ty, jy, dtype, f"step {i}")
        for name in ("c", "n", "h", "m"):
            _close(getattr(ts, name), getattr(js, name), dtype,
                   f"{name} {i}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _pair(dtype):
    jcfg = dataclasses.replace(jbase.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tbase.get_smoke_config(ARCH), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    params, _ = split_params(jmodel.init(jax.random.key(0)))
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, jmodel, params, tmodel


def _check_states(tstates, jstates, dtype, what, steps):
    """Each layer's state. In f32 a state is a sum over ``steps`` tokens
    whose rounding the two packages take in other orders (a cumulative sum
    of log gates, a sequential recurrence): 1e-5 relative plus 1e-5
    sqrt(steps) of the state's largest magnitude (at 256 steps the worst
    seen is 3.8e-5 on an sLSTM normalizer of magnitude 4)."""
    for i, (ts, js) in enumerate(zip(tstates, jstates)):
        for name in js.__dataclass_fields__:
            got, want = getattr(ts, name), getattr(js, name)
            assert tuple(got.shape) == tuple(want.shape), (what, i, name)
            tol = None
            if dtype == "float32":
                big = max(1.0, float(np.abs(np.asarray(want)).max()))
                tol = (1e-5, 1e-5 * steps ** 0.5 * big)
            _close(got, want, dtype, f"{what} layer {i} {name}", tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 256])
def test_xlstm_model_prefill_and_decode_match_jax(dtype, s):
    """Prefill's last logits and every layer's state (the port's from one
    pass, JAX's from a second), then 8 decode steps teacher-forced on the
    JAX model's greedy tokens. The prompt is shorter than the chunk or one
    chunk long, as JAX requires."""
    jcfg, jmodel, params, tmodel = _pair(dtype)
    assert isinstance(tmodel, XLSTMModel) and tmodel.kinds == [
        "mlstm", "slstm"]
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, s)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnums=2)
    jdecode = jax.jit(jmodel.decode_step)
    jl, js = jprefill(params, {"tokens": jnp.asarray(tokens)}, s + 8)
    tl, ts = tmodel.prefill(torch.from_numpy(tokens), s + 8)
    assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.padded_vocab)
    _close(tl, jl, dtype, "prefill", (LOGIT_TOL[dtype],) * 2)
    _check_states(ts, js, dtype, "prefill", s)
    for i in range(8):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jdecode(params, jnp.asarray(tok), js, s + i)
        tl, ts = tmodel.decode_step(torch.from_numpy(tok), ts, s + i)
        _close(tl, jl, dtype, f"decode {i}", (LOGIT_TOL[dtype],) * 2)
        _check_states(ts, js, dtype, f"decode {i}", s + i + 1)


def _jax_loss_and_grads(pair, batch):
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: pair.jmodel.loss(p, b)[0]))(
            pair.jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = gm.value_and_grad(
        lambda p, b: pair.tmodel.loss(p, b)[0])(
            pair.tparams(), {k: torch.from_numpy(v) for k, v in batch.items()})
    return (float(tloss), _flat_torch(tgrads)), (float(jloss),
                                                 _flat_jax(jgrads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_loss_and_every_gradient_match_jax(dtype):
    """f32 as the dense LM's; bf16 to 2e-2 of the loss and 5e-2 of each
    leaf's largest magnitude, as the dense LM's bf16 test."""
    pair = Pair(dtype, arch=ARCH)
    assert isinstance(pair.tmodel, XLSTMModel)
    tokens = np.random.default_rng(2).integers(0, 512, (4, 17)).astype(
        np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    (tl, tg), (jl, jg) = _jax_loss_and_grads(pair, batch)
    assert len(tg) == len(jg) == len(_flatten_with_paths(pair.tparams()))
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_trees_close(tg, jg, what="xlstm f32")
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        _assert_trees_close(tg, jg, rtol=5e-2, atol_frac=5e-2,
                            what="xlstm bf16")


def test_xlstm_models_run_on_the_card_unless_the_caller_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    cfg = tbase.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XLSTMModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(cfg, {})
    assert XLSTMModel(cfg, device="cpu").device.type == "cpu"


def test_xlstm_value_and_grad_has_the_jax_tree():
    """``params()`` is the JAX tree: ``blocks`` a list of per-block dicts,
    the same leaf paths as JAX's, which the optimizer, the merges and the
    checkpoints key on."""
    _, jmodel, params, tmodel = _pair("float32")
    got = [k for k, _ in _flatten_with_paths(tmodel.params())]
    assert got == list(_flat_jax(jax.tree.map(np.asarray, params)))
    assert isinstance(tmodel.params()["blocks"], list)
    loss, grads = gm.value_and_grad(lambda p, b: tmodel.loss(p, b)[0])(
        tmodel.params(), {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                          "labels": torch.zeros((1, 4), dtype=torch.int64)})
    assert list(_flat_torch(grads)) == got and torch.isfinite(loss)
