"""Parity of the port's sliding-window attention (``attention.ring_prefill``,
``ring_decode_step``, the windowed ``flash_attention`` plain version) and
of ``HymbaModel`` (``repro_torch/models/hymba.py``) with the JAX package's
``repro/models/attention.py`` and ``hymba.py`` on the same numpy inputs and
weights, at ``hymba_1_5b.smoke_config()`` (window 16, a global layer 0 and
a windowed layer 1): prefill with ``cache_len``, decode steps across the
ring's wrap, the loss and every gradient.

Tolerances: f32 to 1e-5 (logits to 1e-4, gradients to 1e-5 relative plus
1e-5 of each leaf's largest magnitude, as the dense LM's); bf16 to the
dense tests' tolerances. The JAX Pallas flash kernel has no window: the
windowed plain version is held against JAX's ``_attend`` under
``make_mask(..., "sliding", W)``, the JAX model's own attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models.hymba import HymbaModel
from repro_torch.models.registry import from_jax_params
from repro_torch.models.transformer import _as_tensor

from test_torch_train import Pair, _assert_trees_close, _flat_jax
from test_torch_xlstm import _jax_loss_and_grads

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "hymba-1-5b"
W = 16                                  # the smoke config's window
D, H, KV, HD = 64, 4, 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype, what="", tol=None):
    rtol, atol = tol or TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _x(shape, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


def _attn_params(dtype):
    p, _ = split_params(jattn.init(jax.random.key(0), D, H, KV, HD,
                                   getattr(jnp, dtype)))
    return jax.tree.map(jnp.asarray, p), jax.tree.map(
        lambda a: _as_tensor(np.asarray(a)), p)


@pytest.mark.parametrize("window", [1, 4, 16])
def test_sliding_mask_matches_jax(window):
    q = np.arange(40, dtype=np.int32)
    np.testing.assert_array_equal(
        tattn.make_mask(torch.from_numpy(q), torch.from_numpy(q), "sliding",
                        window).numpy(),
        np.asarray(jattn.make_mask(jnp.asarray(q), jnp.asarray(q), "sliding",
                                   window)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,s", [(1, 9), (5, 40), (16, 40), (64, 40)])
def test_windowed_flash_plain_matches_jax_sliding_attention(dtype, window,
                                                            s):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, s, H, HD)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, KV, HD)).astype(np.float32)
            for _ in range(2))
    q, k, v = (x.astype(jnp.dtype(dtype)) for x in (q, k, v))
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jattn._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jattn.make_mask(pos, pos, "sliding", window)[None])
    got = flash_attention_plain(*(_as_tensor(x).transpose(1, 2)
                                  for x in (q, k, v)), window=window)
    _close(got.transpose(1, 2).reshape(2, s, H * HD), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 40])
def test_ring_prefill_and_decode_match_jax_across_the_wrap(dtype, s):
    """A prompt shorter than the window (8) and one longer that is not a
    multiple of it (40), then decode steps until the ring has wrapped
    (from 8: positions 8 .. 31 pass slot 15 and wrap at 16)."""
    jp, tp = _attn_params(dtype)
    x = _x((2, s, D), dtype)
    pos = np.arange(s, dtype=np.int32)
    jo, jring = jattn.ring_prefill(jp, jnp.asarray(x), jnp.asarray(pos), H,
                                   KV, W)
    to, tring = tattn.ring_prefill(tp, _as_tensor(x), torch.from_numpy(pos),
                                   H, KV, W)
    _close(to, jo, dtype, "prefill")
    assert tring.k.shape == (2, W, KV, HD)
    _close(tring.k, jring.k, dtype, "ring k")
    _close(tring.v, jring.v, dtype, "ring v")
    steps = 24 if s < W else 5
    xs = _x((2, steps, D), dtype, seed=2)
    for i in range(steps):
        position = s + i
        jo, jring = jattn.ring_decode_step(
            jp, jnp.asarray(xs[:, i:i + 1]), jring,
            jnp.asarray(position, jnp.int32), H, KV, W)
        to, tring = tattn.ring_decode_step(
            tp, _as_tensor(xs[:, i:i + 1]), tring, position, H, KV, W)
        _close(to, jo, dtype, f"decode at {position}")
        _close(tring.k, jring.k, dtype, f"ring k at {position}")


def test_ring_slot_positions_match_jax():
    for position in (0, 5, 15, 16, 40):
        np.testing.assert_array_equal(
            tattn.ring_slot_positions(position, W).numpy(),
            np.asarray(jattn.ring_slot_positions(jnp.int32(position), W)))


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


def _check_caches(tc, jc, dtype, what):
    for i, (t, j) in enumerate(zip(tc, jc)):
        assert type(t["kv"]).__name__ == type(j["kv"]).__name__
        for name in ("k", "v"):
            _close(getattr(t["kv"], name), getattr(j["kv"], name), dtype,
                   f"{what} layer {i} {name}")
        _close(t["ssm"].h, j["ssm"].h, dtype, f"{what} layer {i} ssm h")
        assert t["ssm"].conv.dtype == getattr(torch, dtype)
        _close(t["ssm"].conv, j["ssm"].conv, dtype,
               f"{what} layer {i} ssm conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 40])
def test_hymba_prefill_and_decode_match_jax(dtype, s):
    """Prefill with ``cache_len`` (a global layer's cache of cache_len
    slots, a windowed layer's ring of W), then decode steps past the
    window, teacher-forced on the JAX model's greedy tokens."""
    jcfg, jmodel, params, tmodel = _pair(dtype)
    assert isinstance(tmodel, HymbaModel)
    steps = 20 if s < W else 4
    cache_len = s + steps
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, s)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens)}, cache_len)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), cache_len)
    assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.padded_vocab)
    assert tc[0]["kv"].k.shape[1] == cache_len and tc[1]["kv"].k.shape[1] == W
    _close(tl, jl, dtype, "prefill", (LOGIT_TOL[dtype],) * 2)
    _check_caches(tc, jc, dtype, "prefill")
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jdecode(params, jnp.asarray(tok), jc,
                         jnp.asarray(s + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, s + i)
        _close(tl, jl, dtype, f"decode {i}", (LOGIT_TOL[dtype],) * 2)
    _check_caches(tc, jc, dtype, "decoded")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_loss_and_every_gradient_match_jax(dtype):
    """f32 as the dense LM's; bf16 to 2e-2 of the loss and 5e-2 of each
    leaf's largest magnitude, as the dense LM's bf16 test. The sequence
    (32) is twice the window, so the windows bite."""
    pair = Pair(dtype, arch=ARCH)
    assert isinstance(pair.tmodel, HymbaModel)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 33)).astype(
        np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    (tl, tg), (jl, jg) = _jax_loss_and_grads(pair, batch)
    assert len(tg) == len(jg) == len(_flatten_with_paths(pair.tparams()))
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_trees_close(tg, jg, what="hymba f32")
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        _assert_trees_close(tg, jg, rtol=5e-2, atol_frac=5e-2,
                            what="hymba bf16")


def test_hymba_kernel_path_equals_the_plain_path_on_the_cpu():
    """On the CPU the kernel path runs the kernels' plain versions: the
    switch changes nothing there."""
    cfg = tbase.get_smoke_config(ARCH)
    model = HymbaModel(cfg, device="cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    want, caches = model.prefill(tokens, 44)
    wsteps = [model.decode_step(tokens[:, i], caches, 40 + i)[0]
              for i in range(3)]
    model.impl = "plain"
    got, caches = model.prefill(tokens, 44)
    assert torch.equal(got, want)
    for i in range(3):
        assert torch.equal(model.decode_step(tokens[:, i], caches,
                                             40 + i)[0], wsteps[i])
    with pytest.raises(ValueError, match="impl"):
        model.impl = "sdpa"


def test_hymba_params_are_the_jax_tree_and_run_on_the_card_by_default():
    _, _, params, tmodel = _pair("float32")
    assert [k for k, _ in _flatten_with_paths(tmodel.params())] == list(
        _flat_jax(jax.tree.map(np.asarray, params)))
    assert tmodel.params()["blocks"]["beta"].dtype == torch.float32
    assert tmodel.windows() == [1 << 30, W]
    if torch.cuda.is_available():
        return
    cfg = tbase.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HymbaModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(cfg, {})
