"""The port's LM serving slice against the JAX package: configs, layers, and
``DecoderLM`` prefill plus decode steps on the same weights.

Weights come from the JAX model's own init (``split_params``) and go to the
port through ``from_jax_params``; prompts are numpy ids from a seed. The
JAX model is called directly (``prefill`` / ``decode_step``), not through
its serve CLI, whose mesh setup does not run on this container's jax.

Tolerances. In float32 both packages compute the same function in f32,
differing only in summation order: logits to 1e-4 (absolute and relative),
caches to 1e-5. In bfloat16 they round at different places: the JAX
model's attention rounds the scores and the probabilities to bf16
(``einsum`` in the input dtype), the port's kernels keep both in f32, and
the two frameworks round activations after different fused ops. One bf16
rounding is 2**-8 relative, so a cached K/V value of magnitude 2 to 4 moves
by 0.016 to 0.031 per flipped rounding; the bound on the caches is 5e-2
absolute plus 2e-2 relative (two such roundings), and on the logits, of
magnitude up to about 3, 5e-2 absolute plus 5e-2 relative (the largest
difference seen over three seeds of both smoke models was 0.038).
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
from repro.models import module as jmodule
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.models import mlp, module, rope
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.models.transformer import DecoderLM, load_jax_params

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1-5-0-5b", "internlm2-1-8b"]
CONFIGS = ARCHS + ["xlstm-125m", "hymba-1-5b", "granite-34b"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CACHE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("arch", CONFIGS)
@pytest.mark.parametrize("smoke", [False, True])
def test_ported_configs_equal_the_jax_ones_field_by_field(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    j, t = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.padded_vocab == j.padded_vocab
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert str(t.param_dtype).split(".")[1] == str(j.param_dtype)


def test_config_registry_names_what_is_not_ported():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.ARCH_ALIASES == jbase.ARCH_ALIASES
    with pytest.raises(NotImplementedError, match="seamless_m4t_medium"):
        tbase.get_config("seamless-m4t-medium")
    with pytest.raises(ValueError, match="unknown arch"):
        tbase.get_config("gpt-17")
    cfg = dataclasses.replace(tbase.get_smoke_config("qwen1-5-0-5b"),
                              family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        build_model(cfg, device="cpu")


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        1e6).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rope.rope_freqs(16, 1e6).numpy(),
                               np.asarray(jrope.rope_freqs(16, 1e6)),
                               rtol=1e-6)
    h = rng.standard_normal((3, 7, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        module.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(h)).numpy(),
        np.asarray(jmodule.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    p = {name: {"w": rng.standard_normal(shape).astype(np.float32) * 0.2}
         for name, shape in (("wi_gate", (32, 48)), ("wi_up", (32, 48)),
                             ("wo", (48, 32)))}
    tp = {n: {"w": torch.from_numpy(v["w"])} for n, v in p.items()}
    jp = {n: {"w": jnp.asarray(v["w"])} for n, v in p.items()}
    np.testing.assert_allclose(
        mlp.swiglu(tp, torch.from_numpy(h)).numpy(),
        np.asarray(jmlp.swiglu(jp, jnp.asarray(h))), rtol=1e-5, atol=1e-5)


def test_make_mask_matches_jax():
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    q = np.arange(6, dtype=np.int32)[None] + 3
    k = np.arange(9, dtype=np.int32)[None]
    for mode, window in (("causal", None), ("bidirectional", None),
                         ("sliding", 4)):
        np.testing.assert_array_equal(
            tattn.make_mask(torch.from_numpy(q), torch.from_numpy(k), mode,
                            window).numpy(),
            np.asarray(jattn.make_mask(jnp.asarray(q), jnp.asarray(k), mode,
                                       window)), err_msg=mode)


def _jax_model(arch, dtype):
    cfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype)
    model = jbuild_model(cfg)
    params, _ = split_params(model.init(jax.random.key(0)))
    return cfg, model, params


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_lm_prefill_and_decode_match_jax(arch, dtype):
    jcfg, jmodel, params = _jax_model(arch, dtype)
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype)
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    b, s, steps = 2, 12, 4
    cache_len = s + steps
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)},
                            cache_len)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), cache_len)
    rtol, atol = CACHE_TOL[dtype]

    def check(step):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL[dtype],
                                   atol=LOGIT_TOL[dtype], err_msg=step)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc["scan"], name).float().numpy(),
                np.asarray(getattr(jc["scan"], name), np.float32),
                rtol=rtol, atol=atol, err_msg=f"{step} cache {name}")

    assert tl.dtype == torch.float32 and tl.shape == (b, jcfg.padded_vocab)
    assert tc["scan"].k.shape == (jcfg.n_layers, b, cache_len,
                                  jcfg.n_kv_heads, jcfg.resolved_head_dim)
    check("prefill")
    # teacher-forced: both decode the same tokens, the JAX model's greedy
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(s + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, s + i)
        check(f"decode step {i}")


def test_models_run_on_the_card_unless_the_caller_asks_for_the_cpu():
    """``DecoderLM`` and ``from_jax_params`` default to the card: without
    one, a caller that names no device gets an error, not a model quietly
    built on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    cfg = tbase.get_smoke_config("qwen1-5-0-5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(cfg, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert DecoderLM(cfg, device="cpu").embed.table.device.type == "cpu"


def test_gelu_mlp_is_jax_tanh_gelu():
    """``gelu_mlp`` against JAX's on the same weights (f32 to 1e-5): JAX's
    ``jax.nn.gelu`` is the tanh approximation, which torch's default erf
    GELU misses by up to 4.7e-4 per activation, so this fails with it."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    p = {"wi": {"w": rng.standard_normal((32, 48)).astype(np.float32) * 0.3,
                "b": rng.standard_normal(48).astype(np.float32)},
         "wo": {"w": rng.standard_normal((48, 32)).astype(np.float32) * 0.2,
                "b": rng.standard_normal(32).astype(np.float32)}}
    tp = jax.tree.map(torch.from_numpy, p)
    want = np.asarray(jmlp.gelu_mlp(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(h)))
    np.testing.assert_allclose(mlp.gelu_mlp(tp, torch.from_numpy(h)).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    x = torch.linspace(-4, 4, 801)
    np.testing.assert_allclose(mlp.gelu(x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(x).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
                  ).max() > 1e-4
    init = mlp.gelu_mlp_init(torch.Generator().manual_seed(0), 32, 48,
                             torch.float32)
    assert {k: sorted(v) for k, v in init.items()} == {"wi": ["b", "w"],
                                                       "wo": ["b", "w"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_lm_with_a_gelu_mlp_matches_jax(dtype):
    """``DecoderLM`` at granite-34b's smoke config with ``mlp="gelu"`` (the
    smoke config itself is SwiGLU; the full config is GELU) against JAX's
    ``DecoderLM``: prefill, decode steps and the loss."""
    jcfg = dataclasses.replace(jbase.get_smoke_config("granite-34b"),
                               mlp="gelu", dtype=dtype)
    tcfg = dataclasses.replace(tbase.get_smoke_config("granite-34b"),
                               mlp="gelu", dtype=dtype)
    jmodel = jbuild_model(jcfg)
    params, _ = split_params(jmodel.init(jax.random.key(0)))
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    assert sorted(tmodel.params()["blocks"]["ffn"]) == ["wi", "wo"]
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 10)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)}, 14)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), 14)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(10 + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, 10 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode {i}")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jloss = jmodel.loss(params, jax.tree.map(jnp.asarray, batch))[0]
    tloss = tmodel.loss(tmodel.params(), {k: torch.from_numpy(v.copy())
                                          for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


def test_kernel_and_plain_attention_agree_on_the_cpu():
    """On the CPU the kernel path runs the plain versions: the switch
    changes nothing there, and an unknown choice is refused."""
    cfg = tbase.get_smoke_config("internlm2-1-8b")
    model = build_model(cfg, device="cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    want, _ = model.prefill(tokens, 12)
    model.attention = "plain"
    got, _ = model.prefill(tokens, 12)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="attention"):
        model.attention = "sdpa"


def test_load_jax_params_rejects_missing_extra_and_misshaped_leaves():
    _, _, params = _jax_model("qwen1-5-0-5b", "float32")
    tree = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(tbase.get_smoke_config("qwen1-5-0-5b"),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="ln_f.scale"):
        load_jax_params(model, missing)
    extra = dict(tree, unembed={"w": np.zeros((64, 512), np.float32)})
    with pytest.raises(ValueError, match="unembed.w"):
        load_jax_params(model, extra)
    bad = dict(tree, ln_f={"scale": np.ones(63, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad)


def test_serve_cli_on_the_cpu_end_to_end():
    """The three lines of the JAX CLI, then the two traced phases."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1-5-0-5b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "4", "--profile"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        check=True).stdout.splitlines()
    assert out[0].startswith("prefill: 2x16 tok in ")
    assert out[1].startswith("decode: 3 steps x 2 seqs in ") and \
        out[1].endswith("tok/s)")
    ids = out[2].removeprefix("generated ids[0]: ")
    assert len(eval(ids)) == 4
    traced = [line for line in out if line.startswith("profile ")]
    assert [line.split(" (")[0] for line in traced] == [
        "profile prefill", "profile decode"]


@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1-5b"])
def test_serve_cli_serves_the_new_families_on_the_cpu(arch):
    """The xLSTM and Hymba families through the same CLI and ``generate``
    (a prompt longer than Hymba's smoke window of 16), with the trace."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "24",
         "--gen", "20", "--profile"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        check=True).stdout.splitlines()
    assert out[0].startswith("prefill: 2x24 tok in ")
    assert out[1].startswith("decode: 19 steps x 2 seqs in ")
    assert len(eval(out[2].removeprefix("generated ids[0]: "))) == 20
    assert [line.split(" (")[0] for line in out
            if line.startswith("profile ")] == ["profile prefill",
                                                "profile decode"]


def test_serve_generate_is_prefill_then_greedy_decode():
    """``generate`` returns the prefill's argmax followed by each decode
    step's argmax on the tokens it produced."""
    from repro_torch.launch.serve import generate, prompts
    cfg = tbase.get_smoke_config("qwen1-5-0-5b")
    model = build_model(cfg, device="cpu", seed=5)
    p = prompts(cfg, 2, 8, 5)
    res = generate(model, p, 3, keep_logits=True)
    logits, caches = model.prefill(torch.from_numpy(p), 11)
    want = [logits.argmax(-1)]
    for i in range(2):
        logits, caches = model.decode_step(want[-1], caches, 8 + i)
        want.append(logits.argmax(-1))
    assert torch.equal(res.tokens, torch.stack(want, 1))
    assert len(res.logits) == 3 and torch.equal(res.logits[-1], logits)
