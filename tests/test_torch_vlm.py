"""Parity of the port's VLM backbone (``DecoderLM`` for ``family="vlm"``,
llava-next-34b) and of llama3-405b's dense config with the JAX package's
``repro/models/transformer.py`` on the same numpy inputs and weights, at
their smoke configs: prefill from precomputed patch and text embeddings
(``batch["embeds"]`` in JAX), decode steps with their caches, the loss
from embeds and every gradient, ``from_jax_params``, the serve entry
points and the CLI.

Tolerances are ``test_torch_lm.py``'s (logits 1e-4 in f32 and 5e-2 in
bf16, caches ``CACHE_TOL``) and ``test_torch_train.py``'s for the loss and
gradients (f32 to 1e-5; bf16 the loss to 2e-2 and each leaf to 5e-2 of its
largest magnitude). The embeds are cast to the parameters' dtype, where
JAX casts them to ``cfg.param_dtype``: the same for a model in its
config's dtype, and the card's f32 twin of a bf16 model then runs in f32.
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

from repro.configs import base as jbase
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.core import grad_merge as gm
from repro_torch.launch import serve
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.models.transformer import DecoderLM

from test_torch_lm import CACHE_TOL, LOGIT_TOL
from test_torch_train import _assert_trees_close, _flat_jax

ROOT = Path(__file__).resolve().parents[1]
VLM = "llava-next-34b"
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, dtype):
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    params, _ = split_params(jmodel.init(jax.random.key(0)))
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, jmodel, params, tmodel


def _embeds(b, s, d, dtype="float32", seed=2):
    """Standard normals x 0.02, the embedding table's init scale."""
    return (np.random.default_rng(seed).standard_normal((b, s, d))
            * 0.02).astype(np.float32).astype(jnp.dtype(dtype))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _check(tl, jl, tc, jc, dtype, step):
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol, err_msg=step)
    rtol, atol = CACHE_TOL[dtype]
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tc["scan"], name).float().numpy(),
            np.asarray(getattr(jc["scan"], name), np.float32), rtol=rtol,
            atol=atol, err_msg=f"{step} cache {name}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_prefill_from_embeds_and_decode_match_jax(dtype):
    """Prefill from embeds ``[B, S, D]`` (no token ids), then 4 decode
    steps of the JAX model's greedy tokens through the embedding table."""
    jcfg, jmodel, params, tmodel = _pair(VLM, dtype)
    assert isinstance(tmodel, DecoderLM) and tmodel.embeds_input
    b, s, steps = 2, 12, 4
    emb = _embeds(b, s, jcfg.d_model, dtype)
    jl, jc = jmodel.prefill(params, {"embeds": jnp.asarray(emb)}, s + steps)
    tl, tc = tmodel.prefill(None, s + steps, embeds=_t(emb))
    assert tl.shape == (b, jcfg.padded_vocab) and "dense" not in tc
    _check(tl, jl, tc, jc, dtype, "prefill")
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(s + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, s + i)
        _check(tl, jl, tc, jc, dtype, f"decode {i}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_prefill_from_tokens_matches_jax(dtype):
    """Without embeds the backbone embeds the prompt ids, as JAX's
    ``prefill`` does when the batch has no ``embeds`` (the serve CLI)."""
    jcfg, jmodel, params, tmodel = _pair(VLM, dtype)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10)).astype(
        np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)}, 14)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), 14)
    _check(tl, jl, tc, jc, dtype, "prefill")


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_loss_from_embeds_and_every_gradient_match_jax(dtype):
    """The loss of ``{"embeds", "labels"}`` and every gradient leaf: the
    untied embedding table, which the embeds bypass, has a zero gradient
    in both packages."""
    jcfg, jmodel, params, tmodel = _pair(VLM, dtype)
    emb = _embeds(2, 11, jcfg.d_model, dtype, seed=4)
    labels = np.random.default_rng(5).integers(0, 512, (2, 11)).astype(
        np.int32)
    batch = {"embeds": emb, "labels": labels}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(params,
                                            jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = gm.value_and_grad(lambda p, b: tmodel.loss(p, b)[0])(
        tmodel.params(), {"embeds": _t(emb),
                          "labels": torch.from_numpy(labels)})
    tg = {k: v.float().numpy() for k, v in _flatten_with_paths(tgrads)}
    jg = _flat_jax(jgrads)
    assert not tg["embed/table"].any() and not jg["embed/table"].any()
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        _assert_trees_close(tg, jg, what="vlm f32")
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
        _assert_trees_close(tg, jg, rtol=5e-2, atol_frac=5e-2,
                            what="vlm bf16")


def test_vlm_casts_the_embeds_to_the_parameters_dtype():
    """f64 embeds into an f32 model run in f32; f32 embeds into a bf16
    model equal the same embeds rounded to bf16 first; after ``float()``
    (the card's f32 twin) bf16 embeds run in f32."""
    cfg = tbase.get_smoke_config(VLM)
    model = build_model(cfg, device="cpu", seed=1)
    emb = torch.from_numpy(_embeds(2, 8, cfg.d_model))
    want, caches = model.prefill(None, 10, embeds=emb.to(torch.bfloat16))
    got, _ = model.prefill(None, 10, embeds=emb)
    assert torch.equal(got, want) and caches["scan"].k.dtype == torch.bfloat16
    model.float()
    got32, caches = model.prefill(None, 10, embeds=emb.double())
    assert caches["scan"].k.dtype == torch.float32
    torch.testing.assert_close(
        got32, model.prefill(None, 10, embeds=emb)[0], rtol=0, atol=0)
    dense = build_model(tbase.get_smoke_config("llama3-405b"), device="cpu")
    with pytest.raises(ValueError, match="embeds"):
        dense.prefill(None, 10, embeds=emb)


def test_generate_from_embeds_is_prefill_then_greedy_decode():
    """``serve.generate(..., embeds=)`` prefills the embeds and decodes
    greedily after them, as the model's own calls do."""
    cfg = tbase.get_smoke_config(VLM)
    model = build_model(cfg, device="cpu", seed=5)
    emb = torch.from_numpy(_embeds(2, 9, cfg.d_model, seed=6))
    res = serve.generate(model, None, 3, embeds=emb, keep_logits=True)
    logits, caches = model.prefill(None, 12, embeds=emb)
    want = [logits.argmax(-1)]
    for i in range(2):
        logits, caches = model.decode_step(want[-1], caches, 9 + i)
        want.append(logits.argmax(-1))
    assert torch.equal(res.tokens, torch.stack(want, 1))
    assert len(res.logits) == 3 and torch.equal(res.logits[-1], logits)
    prof = serve.profile(model, None, steps=1, rows=2, embeds=emb)
    assert sorted(prof) == ["decode", "prefill"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_llama3_405b_smoke_matches_jax(dtype):
    """llama3-405b's smoke config (dense, GQA 8 over 2, head dim 8): prefill
    and decode steps, the loss and every gradient."""
    jcfg, jmodel, params, tmodel = _pair("llama3-405b", dtype)
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 13)).astype(
        np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens[:, :12])},
                            16)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens[:, :12]), 16)
    _check(tl, jl, tc, jc, dtype, "prefill")
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(12 + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, 12 + i)
        _check(tl, jl, tc, jc, dtype, f"decode {i}")
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(params,
                                            jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = gm.value_and_grad(lambda p, b: tmodel.loss(p, b)[0])(
        tmodel.params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = {k: v.float().numpy() for k, v in _flatten_with_paths(tgrads)}
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        _assert_trees_close(tg, _flat_jax(jgrads), what="llama3 f32")
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
        _assert_trees_close(tg, _flat_jax(jgrads), rtol=5e-2,
                            atol_frac=5e-2, what="llama3 bf16")


@pytest.mark.parametrize("arch", [VLM, "llama3-405b"])
def test_from_jax_params_loads_the_whole_tree(arch):
    _, _, params, tmodel = _pair(arch, "bfloat16")
    want = dict(_flatten_with_paths(jax.tree.map(np.asarray, params)))
    got = dict(_flatten_with_paths(tmodel.params()))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert torch.equal(got[k], _t(a)), k


@pytest.mark.parametrize("arch", [VLM, "llama3-405b"])
def test_serve_cli_serves_on_the_cpu(arch):
    """The JAX CLI's three lines (the VLM serves the prompt ids the JAX CLI
    draws), then the two traced phases."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--gen", "4", "--profile"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        check=True).stdout.splitlines()
    assert out[0].startswith("prefill: 2x16 tok in ")
    assert out[1].startswith("decode: 3 steps x 2 seqs in ")
    assert len(eval(out[2].removeprefix("generated ids[0]: "))) == 4
    assert [line.split(" (")[0] for line in out
            if line.startswith("profile ")] == ["profile prefill",
                                                "profile decode"]


def test_serve_inputs_equal_the_jax_cli_draws():
    """The JAX CLI draws only prompt ids for the VLM, from
    ``default_rng(seed)``."""
    cfg = tbase.get_smoke_config(VLM)
    batch = serve.serve_batch(cfg, 4, 24, 11)
    assert sorted(batch) == ["tokens"]
    np.testing.assert_array_equal(
        batch["tokens"], np.random.default_rng(11).integers(
            0, cfg.vocab, (4, 24)).astype(np.int32))
