"""Parity of the port's encoder-decoder (``repro_torch/models/encdec.py``),
its cross-attention (``attention.cross_kv``, ``attend_cross``,
``cross_prefill``, ``cross_decode_step``, ``encoder_attend``) and
``module.layernorm`` with the JAX package's ``repro/models/encdec.py``,
``attention.py`` and ``module.py`` on the same numpy inputs and weights,
at ``seamless_m4t_medium.smoke_config()``: encode, prefill and decode
steps with their caches, the loss and every gradient, the serve CLI's
inputs (bitwise against the JAX CLI's draws) and both CLIs.

Tolerances are ``test_torch_lm.py``'s: logits 1e-4 in f32 and 5e-2 in
bf16, caches ``CACHE_TOL``; layers in f32 to 1e-5; the loss and every
gradient leaf as ``test_torch_train.py``'s (f32 to 1e-5, bf16 the loss to
2e-2 and each leaf to 5e-2 of its largest magnitude). In bf16 the decode's
cross-attention keeps the probabilities in f32 inside
``decode_attention``, where JAX's ``_attend`` rounds them to bf16: the
bf16 bound covers it (``test_cross_attention_serving_forms_match_jax``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import module as jmodule
from repro.models.encdec import EncDecModel as JEncDecModel
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import module as tmodule
from repro_torch.models.encdec import EncDecModel, enc_len
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.models.transformer import _as_tensor, load_jax_params

from test_torch_lm import CACHE_TOL, LOGIT_TOL
from test_torch_train import Pair, _assert_trees_close, _flat_jax
from test_torch_xlstm import _jax_loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
D, H, KV, HD = 64, 4, 4, 16           # the smoke config's attention
T_ENC = 128                           # enc_len of any prompt up to 512


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run many small ops: with a pytest-xdist worker per
    core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    rtol, atol = tol
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _x(shape, dtype="float32", seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


def _attn_params(dtype, seed=0):
    p, _ = split_params(jattn.init(jax.random.key(seed), D, H, KV, HD,
                                   getattr(jnp, dtype)))
    return jax.tree.map(jnp.asarray, p), jax.tree.map(
        lambda a: _as_tensor(np.asarray(a)), p)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7, 32), (2, 128, 64)])
def test_layernorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    h = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(shape[-1]).astype(np.float32),
         "bias": rng.standard_normal(shape[-1]).astype(np.float32)}
    got = tmodule.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(h))
    want = jmodule.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(h))
    _close(got, want, (1e-5, 1e-5))
    init = tmodule.layernorm_init(shape[-1], torch.bfloat16)
    jinit, _ = split_params(jmodule.layernorm_init(shape[-1], jnp.bfloat16))
    for k in ("scale", "bias"):
        assert init[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(init[k].float().numpy(),
                                      np.asarray(jinit[k], np.float32))


def test_layernorm_keeps_the_input_dtype_and_computes_in_f32():
    h = torch.from_numpy(_x((2, 5, 64), "float32", 3) * 100).to(
        torch.bfloat16)
    p = tmodule.layernorm_init(64, torch.bfloat16)
    out = tmodule.layernorm(p, h)
    assert out.dtype == torch.bfloat16
    want = jmodule.layernorm({"scale": jnp.ones(64, jnp.bfloat16),
                              "bias": jnp.zeros(64, jnp.bfloat16)},
                             jnp.asarray(h.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def test_cross_kv_and_attend_cross_match_jax():
    """k and v of the encoder output carry no RoPE, nor does the cross q:
    every query sees every key, whatever the positions."""
    jp, tp = _attn_params("float32")
    ctx = _x((2, 40, D), seed=2)
    x = _x((2, 9, D), seed=3)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(ctx), KV)
    tk, tv = tattn.cross_kv(tp, torch.from_numpy(ctx), KV)
    assert tk.shape == (2, 40, KV, HD)
    _close(tk, jk, (1e-5, 1e-5), "k")
    _close(tv, jv, (1e-5, 1e-5), "v")
    want = jattn.attend_cross(jp, jnp.asarray(x), (jk, jv),
                              jnp.arange(9, dtype=jnp.int32), H, KV)
    got = tattn.attend_cross(tp, torch.from_numpy(x), (tk, tv), H)
    _close(got, want, (1e-5, 1e-5), "attend_cross")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_serving_forms_match_jax(dtype):
    """``cross_prefill`` (flash, bidirectional, S != T) and
    ``cross_decode_step`` (decode_attention at T - 1) against JAX's
    ``attend_cross`` on the same cross k and v."""
    jp, tp = _attn_params(dtype)
    ctx = _x((2, T_ENC, D), dtype, seed=2)
    kv = jattn.cross_kv(jp, jnp.asarray(ctx), KV)
    tkv = tattn.cross_kv(tp, _as_tensor(ctx), KV)
    tol = (1e-5, 1e-5) if dtype == "float32" else CACHE_TOL[dtype]
    for s in (1, 37):
        x = _x((2, s, D), dtype, seed=s)
        want = jattn.attend_cross(jp, jnp.asarray(x), kv,
                                  jnp.zeros((s,), jnp.int32), H, KV)
        _close(tattn.cross_prefill(tp, _as_tensor(x), tkv, H), want, tol,
               f"cross_prefill S={s}")
        if s == 1:
            _close(tattn.cross_decode_step(tp, _as_tensor(x), tkv, H),
                   want, tol, "cross_decode_step")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_matches_jax_bidirectional_attend_full(dtype):
    """The serving encoder's self-attention (flash, causal=False, RoPE'd q
    and k) against JAX's ``attend_full(..., "bidirectional")``."""
    jp, tp = _attn_params(dtype)
    x = _x((2, 50, D), dtype, seed=4)
    pos = np.arange(50, dtype=np.int32)
    want = jattn.attend_full(jp, jnp.asarray(x), jnp.asarray(pos), H, KV,
                             "bidirectional")
    tol = (1e-5, 1e-5) if dtype == "float32" else CACHE_TOL[dtype]
    for plain in (False, True):
        _close(tattn.encoder_attend(tp, _as_tensor(x), torch.from_numpy(pos),
                                    H, KV, plain=plain), want, tol)
    _close(tattn.attend_full(tp, _as_tensor(x), torch.from_numpy(pos), H, KV,
                             "bidirectional"), want, tol)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    _, jmodel, params, tmodel = _pair(dtype)
    frames = _x((2, T_ENC, D), seed=5)
    want = jax.jit(jmodel.encode)(params, jnp.asarray(frames))
    tol = (1e-5, 1e-5) if dtype == "float32" else CACHE_TOL[dtype]
    for serve_form in (False, True):
        got = tmodel.encode(tmodel.params(), torch.from_numpy(frames),
                            serve=serve_form)
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, tol, f"encode serve={serve_form}")


def _check_caches(tc, jc, dtype, what):
    tol = CACHE_TOL[dtype]
    for name in ("k", "v"):
        _close(getattr(tc["kv"], name), getattr(jc["kv"], name), tol,
               f"{what} kv.{name}")
    for name in ("cross_k", "cross_v"):
        _close(tc[name], jc[name], tol, f"{what} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill with ``cache_len`` (the self caches, the cross caches of
    T_ENC frames), then 4 decode steps teacher-forced on JAX's greedy
    tokens: logits and every cache."""
    jcfg, jmodel, params, tmodel = _pair(dtype)
    assert isinstance(tmodel, EncDecModel)
    s, steps = 10, 4
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, s)).astype(np.int32)
    frames = _x((2, T_ENC, D), seed=6)
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens),
                 "frames": jnp.asarray(frames)}, s + steps)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), s + steps,
                            torch.from_numpy(frames))
    assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.padded_vocab)
    assert tc["kv"].k.shape == (2, 2, s + steps, KV, HD)
    assert tc["cross_k"].shape == (2, 2, T_ENC, KV, HD)
    tol = (LOGIT_TOL[dtype],) * 2
    _close(tl, jl, tol, "prefill")
    _check_caches(tc, jc, dtype, "prefill")
    cross = tc["cross_k"].clone()
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jdecode(params, jnp.asarray(tok), jc,
                         jnp.asarray(s + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, s + i)
        _close(tl, jl, tol, f"decode {i}")
    _check_caches(tc, jc, dtype, "decoded")
    assert torch.equal(tc["cross_k"], cross)    # read, never rewritten


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax(dtype):
    """f32: the loss and each leaf to 1e-5; bf16: the loss to 2e-2 and
    each leaf to 5e-2 of its largest magnitude, as the dense LM's."""
    pair = Pair(dtype, arch=ARCH)
    assert isinstance(pair.tmodel, EncDecModel)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 17)).astype(
        np.int32)
    batch = {"frames": _x((2, T_ENC, D), seed=7),
             "tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    (tl, tg), (jl, jg) = _jax_loss_and_grads(pair, batch)
    assert len(tg) == len(jg) == len(_flatten_with_paths(pair.tparams())) == 35
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_trees_close(tg, jg, what="encdec f32")
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        _assert_trees_close(tg, jg, rtol=5e-2, atol_frac=5e-2,
                            what="encdec bf16")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_number(remat):
    """The loss and gradients under ``full`` and ``dots`` remat equal
    those without, bit for bit."""
    tokens = np.random.default_rng(3).integers(0, 512, (2, 9)).astype(
        np.int64)
    batch = {"frames": torch.from_numpy(_x((2, T_ENC, D), seed=8)),
             "tokens": torch.from_numpy(tokens[:, :-1].copy()),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    out = {}
    for policy in ("none", remat):
        cfg = dataclasses.replace(tbase.get_smoke_config(ARCH),
                                  dtype="float32", remat=policy)
        model = build_model(cfg, device="cpu", seed=4)
        params = pytree.tree_map(lambda t: t.requires_grad_(True),
                                 model.params())
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, pytree.tree_leaves(params))
        out[policy] = (loss, grads)
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        assert torch.equal(a, b)


def test_kernel_path_equals_the_plain_path_on_the_cpu():
    """On the CPU the kernel path runs the kernels' plain versions: the
    switch changes nothing there."""
    cfg = tbase.get_smoke_config(ARCH)
    model = EncDecModel(cfg, device="cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    frames = torch.randn((2, T_ENC, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    want, caches = model.prefill(tokens, 15, frames)
    wsteps = [model.decode_step(tokens[:, i], caches, 12 + i)[0]
              for i in range(3)]
    model.impl = "plain"
    got, caches = model.prefill(tokens, 15, frames)
    assert torch.equal(got, want)
    for i in range(3):
        assert torch.equal(model.decode_step(tokens[:, i], caches,
                                             12 + i)[0], wsteps[i])
    with pytest.raises(ValueError, match="impl"):
        model.impl = "sdpa"


def test_params_are_the_jax_tree_and_the_model_runs_on_the_card_by_default():
    _, jmodel, params, tmodel = _pair("float32")
    assert isinstance(jmodel, JEncDecModel)
    assert [k for k, _ in _flatten_with_paths(tmodel.params())] == list(
        _flat_jax(jax.tree.map(np.asarray, params)))
    for s in (16, 512, 513, 2048):
        assert tmodel.enc_len(s) == enc_len(s) == jmodel.enc_len(s)
    if torch.cuda.is_available():
        return
    cfg = tbase.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EncDecModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)


def test_from_jax_params_rejects_missing_extra_and_misshaped_leaves():
    _, _, params, _ = _pair("float32")
    tree = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(tbase.get_smoke_config(ARCH), dtype="float32")
    model = build_model(cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_enc"}
    with pytest.raises(ValueError, match="ln_enc.bias"):
        load_jax_params(model, missing)
    extra = dict(tree, unembed={"w": np.zeros((64, 512), np.float32)})
    with pytest.raises(ValueError, match="unembed.w"):
        load_jax_params(model, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["dec"]["cross_attn"]["wq"]["w"] = np.zeros((2, 64, 32), np.float32)
    with pytest.raises(ValueError, match="dec.cross_attn.wq.w"):
        from_jax_params(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# the serve inputs and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke,dtype,b,p", [
    (False, "bfloat16", 8, 512),      # chip_smoke's serve run
    (False, "float32", 2, 700),       # enc_len past its floor of 128
    (True, "bfloat16", 4, 32)])       # the CLI's defaults
def test_serve_inputs_equal_the_jax_cli_draws_bitwise(smoke, dtype, b, p):
    """``serve.serve_batch`` against ``repro/launch/serve.py:49-57``
    replayed: one ``default_rng(seed)``, the prompt ids, then the frames,
    ``jnp.asarray(..., cfg.param_dtype)``."""
    get = "get_smoke_config" if smoke else "get_config"
    jcfg = dataclasses.replace(getattr(jbase, get)(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(getattr(tbase, get)(ARCH), dtype=dtype)
    seed = 11
    rng = np.random.default_rng(seed)
    jtokens = jnp.asarray(rng.integers(0, jcfg.vocab, (b, p)), jnp.int32)
    jframes = jnp.asarray(rng.standard_normal(
        (b, jbuild_model(jcfg).enc_len(p), jcfg.d_model)), jcfg.param_dtype)
    got = serve.serve_batch(tcfg, b, p, seed)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.asarray(jtokens))
    frames = got["frames"]
    assert frames.dtype == tcfg.param_dtype
    assert tuple(frames.shape) == jframes.shape == (b, max(128, p // 4),
                                                    tcfg.d_model)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    want = np.asarray(jframes).view(bits)
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(frames.view(view).numpy().view(bits), want)
    np.testing.assert_array_equal(serve.prompts(tcfg, b, p, seed),
                                  got["tokens"])


def test_serve_inputs_of_the_other_families_carry_no_frames():
    cfg = tbase.get_smoke_config("qwen1-5-0-5b")
    assert sorted(serve.serve_batch(cfg, 2, 8, 0)) == ["tokens"]


def test_generate_passes_the_frames_to_prefill():
    cfg = tbase.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu", seed=5)
    batch = serve.serve_batch(cfg, 2, 8, 5)
    res = serve.generate(model, batch["tokens"], 3, frames=batch["frames"],
                         keep_logits=True)
    logits, caches = model.prefill(torch.from_numpy(batch["tokens"]), 11,
                                   batch["frames"])
    want = [logits.argmax(-1)]
    for i in range(2):
        logits, caches = model.decode_step(want[-1], caches, 8 + i)
        want.append(logits.argmax(-1))
    assert torch.equal(res.tokens, torch.stack(want, 1))
    assert len(res.logits) == 3 and torch.equal(res.logits[-1], logits)
    with pytest.raises(TypeError):
        serve.generate(model, batch["tokens"], 3)


def _cli(module, *args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", ARCH, "--smoke", "--device",
         "cpu", *args], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300, check=True).stdout.splitlines()


def test_serve_cli_serves_the_encoder_decoder_on_the_cpu():
    """The JAX CLI's three lines, then the two traced phases."""
    out = _cli("repro_torch.launch.serve", "--batch", "2", "--prompt-len",
               "24", "--gen", "6", "--profile")
    assert out[0].startswith("prefill: 2x24 tok in ")
    assert out[1].startswith("decode: 5 steps x 2 seqs in ") and \
        out[1].endswith("tok/s)")
    assert len(eval(out[2].removeprefix("generated ids[0]: "))) == 6
    assert [line.split(" (")[0] for line in out
            if line.startswith("profile ")] == ["profile prefill",
                                                "profile decode"]


def test_train_cli_trains_the_encoder_decoder_on_the_cpu(tmp_path):
    """Two steps over two stacked ranks, the batch's frames sliced by rank
    with its tokens."""
    out = _cli("repro_torch.launch.train", "--batch", "4", "--seq", "16",
               "--steps", "2", "--merge-topology", "chip:2", "--ckpt-dir",
               str(tmp_path / "ck"))
    last = out[-1]
    assert last.startswith("steps 0..2: loss ")
    first, final = (float(x) for x in last.split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(final)
