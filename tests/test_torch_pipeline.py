"""The port's GPipe schedule (``repro_torch.sharding.pipeline``) against the
JAX package's ``pipeline_apply`` under ``jax.vmap(axis_name="stage")``, as
``tests/test_pipeline.py`` runs it, on the same numpy inputs: f32 to 1e-5,
with bubbles at both ends (n_micro < S, = S, > S) and a single stage; and
a stage of smoke-config decoder blocks, held to JAX's ``DecoderLM._block``
through the JAX schedule and to the port's serial run of the same blocks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import base as jbase
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro.sharding import pipeline as jpipeline
from repro_torch.configs import base as tbase
from repro_torch.core.stacked import StackedAxis
from repro_torch.models.registry import from_jax_params
from repro_torch.sharding import bubble_fraction, pipeline_apply

TOL = 1e-5
MB, D = 2, 8
CPU = torch.device("cpu")


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _torch_stage(p, x):
    """Every stage's tanh(x W + b) at once: one product a stage."""
    return torch.tanh(torch.bmm(x, p["w"]) + p["b"][:, None])


def _inputs(s, n_micro, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((s, D, D)) * 0.5).astype(np.float32),
              "b": rng.standard_normal((s, D)).astype(np.float32) * 0.1}
    x = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    return params, x


def _jax_pipeline(stage_fn, params, x):
    """Every stage rank gets the stream; only rank 0 reads it."""
    return np.asarray(jax.vmap(
        lambda p, m: jpipeline.pipeline_apply(stage_fn, p, m,
                                              axis_name="stage"),
        axis_name="stage", in_axes=(0, None))(params, x))


def _port_pipeline(stage_fn, params, x, s):
    stream = torch.from_numpy(x)[None].expand((s,) + x.shape)
    return pipeline_apply(stage_fn, params, stream,
                          StackedAxis(s, CPU)).numpy()


@pytest.mark.parametrize("s,n_micro", [(4, 6), (4, 2), (4, 4), (1, 3),
                                       (3, 3)])
def test_pipeline_matches_jax(s, n_micro):
    params, x = _inputs(s, n_micro, seed=s * 10 + n_micro)
    want = _jax_pipeline(_jax_stage, jax.tree.map(jnp.asarray, params),
                         jnp.asarray(x))
    got = _port_pipeline(_torch_stage, pytree.tree_map(torch.from_numpy,
                                                       params), x, s)
    assert got.shape == want.shape == (s, n_micro, MB, D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # only the last stage banks outputs; the others stay zeros, as in JAX
    assert not got[:-1].any()


@pytest.mark.parametrize("s,n_micro", [(4, 6), (4, 2), (1, 3), (3, 3),
                                       (1, 1), (8, 1)])
def test_bubble_fraction_equals_jax(s, n_micro):
    assert bubble_fraction(s, n_micro) == jpipeline.bubble_fraction(s,
                                                                    n_micro)


def test_pipeline_reads_only_stage_zeros_stream():
    s, n_micro = 3, 4
    params, x = _inputs(s, n_micro, seed=5)
    tp = pytree.tree_map(torch.from_numpy, params)
    stream = torch.from_numpy(x)[None].repeat(s, 1, 1, 1)
    want = pipeline_apply(_torch_stage, tp, stream.clone(),
                          StackedAxis(s, CPU))
    stream[1:] = 1e6                       # garbage on the other stages
    got = pipeline_apply(_torch_stage, tp, stream, StackedAxis(s, CPU))
    assert torch.equal(got, want)


def test_pipeline_runs_stage_fn_every_tick_with_one_handoff():
    s, n_micro = 4, 6
    params, x = _inputs(s, n_micro)
    calls = []

    def counted(p, xs):
        calls.append(xs.shape)
        return _torch_stage(p, xs)

    _port_pipeline(counted, pytree.tree_map(torch.from_numpy, params), x, s)
    assert calls == [(s, MB, D)] * (n_micro + s - 1)


def test_pipeline_refuses_a_stream_of_another_stage_count():
    params, x = _inputs(4, 2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_torch_stage, pytree.tree_map(torch.from_numpy,
                                                     params),
                       torch.from_numpy(x)[None].expand(3, 2, MB, D),
                       StackedAxis(4, CPU))


# -- a stage of decoder blocks ---------------------------------------------

ARCH = "qwen1-5-0-5b"
SEQ = 8


@pytest.fixture(scope="module")
def blocks():
    """The smoke config with 4 layers in both packages, the same weights."""
    jcfg = dataclasses.replace(jbase.get_smoke_config(ARCH), n_layers=4,
                               dtype="float32")
    tcfg = dataclasses.replace(tbase.get_smoke_config(ARCH), n_layers=4,
                               dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams, _ = split_params(jmodel.init(jax.random.key(0)))
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, tmodel


def _stream(tmodel, n_micro, seed):
    d = tmodel.cfg.d_model
    return np.random.default_rng(seed).standard_normal(
        (n_micro, MB, SEQ, d)).astype(np.float32)


def _port_block_stage(tmodel):
    positions = torch.arange(SEQ, dtype=torch.int32)

    def stage(p, xs):
        # every stage on its own slice: layer s on stage s's input
        return torch.stack([
            tmodel._block(pytree.tree_map(lambda a: a[i], p), xs[i],
                          positions)[0] for i in range(xs.shape[0])])
    return stage


@pytest.mark.parametrize("n_micro", [2, 5])
def test_decoder_block_stages_match_jax(blocks, n_micro):
    jmodel, jparams, tmodel = blocks
    x = _stream(tmodel, n_micro, seed=n_micro)
    positions = jnp.arange(SEQ, dtype=jnp.int32)
    want = _jax_pipeline(
        lambda p, h: jmodel._block(p, h, positions)[0], jparams["blocks"],
        jnp.asarray(x))
    with torch.no_grad():
        got = _port_pipeline(_port_block_stage(tmodel),
                             tmodel.params()["blocks"], x, 4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=TOL, atol=TOL)


def test_decoder_block_stages_equal_the_serial_run_bitwise(blocks):
    _, _, tmodel = blocks
    n_micro = 3
    x = _stream(tmodel, n_micro, seed=7)
    positions = torch.arange(SEQ, dtype=torch.int32)
    with torch.no_grad():
        got = _port_pipeline(_port_block_stage(tmodel),
                             tmodel.params()["blocks"], x, 4)
        h = torch.from_numpy(x)
        for p in tmodel.layers():
            h = torch.stack([tmodel._block(p, h[m], positions)[0]
                             for m in range(n_micro)])
    np.testing.assert_array_equal(got[-1], h.numpy())
