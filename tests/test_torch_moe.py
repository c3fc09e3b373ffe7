"""Parity of the port's MoE layer (``repro_torch/models/moe.py``), its
stacked expert-parallel form (``models/moe_ep.py``) and the MoE family of
``DecoderLM`` with the JAX package's ``repro/models/moe.py`` and
``transformer.py`` on the same numpy inputs and weights.

Integer outputs (expert ids, positions, keep, slots, capacities) are held
bitwise; floats in f32 to 1e-5 (the logits of whole models to
``test_torch_lm.py``'s ``LOGIT_TOL``, 1e-4). In bf16 the combine is a
decided divergence: the port's ``cscatter`` folds a token's k expert
outputs in f32 and rounds once, where JAX's bf16 ``.at[].add`` rounds at
every add, so bf16 outputs are held to ``tests/test_kernels.py``'s bf16
``TOL`` (2e-2). A bf16 model may route a token near a tie between its
k-th and (k+1)-th expert differently in the two packages (its hidden state
differs by bf16 roundings upstream): the bf16 gradient check holds every
leaf of the layers without such a flip, and asserts that each flip is a
near-tie.

JAX's own ``tests/test_moe_ep.py`` fails on this container's jax (its mesh
API drifted), so ``apply_ep`` over stacked ranks is held, as that test
holds the mesh form, to ``moe.apply``.
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
from repro.models import moe as jmoe
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.core import grad_merge as gm
from repro_torch.launch import serve
from repro_torch.models import moe, moe_ep
from repro_torch.models.registry import build_model, from_jax_params

from test_torch_lm import CACHE_TOL, LOGIT_TOL
from test_torch_train import _assert_trees_close, _flat_jax

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["qwen3-moe-235b", "kimi-k2-1t"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}       # tests/test_kernels.py TOL
CAPACITY_FACTORS = [0.25, 1.25, 8.0]


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: with a pytest-xdist worker per core, torch's
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(d=32, f=48, e=8, shared=0, dtype="float32", seed=0):
    """One MoE layer's weights as numpy, JAX and torch trees."""
    rng = np.random.default_rng(seed)
    p = {"router": {"w": rng.standard_normal((d, e)).astype(np.float32)},
         "wi_gate": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
         "wi_up": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
         "wo": rng.standard_normal((e, f, d)).astype(np.float32) * 0.2}
    if shared:
        p["shared"] = {
            name: {"w": rng.standard_normal(shape).astype(np.float32) * 0.2}
            for name, shape in (("wi_gate", (d, f * shared)),
                                ("wi_up", (d, f * shared)),
                                ("wo", (f * shared, d)))}
    jdt = jnp.dtype(dtype)

    def cast(path, a):      # the router stays f32
        keep = any(getattr(k, "key", None) == "router" for k in path)
        return a if keep else a.astype(jdt)
    p = jax.tree_util.tree_map_with_path(cast, p)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(_t, p)
    return p, jp, tp


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _x(shape, dtype="float32", seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("e,k", [(8, 2), (128, 8), (6, 1)])
def test_route_matches_jax(e, k):
    """Weights and probabilities to 1e-5, expert ids bitwise."""
    _, jp, tp = _layer(e=e)
    x = _x((40, 32))
    jw, ji, jprob = jmoe.route(jp["router"]["w"], jnp.asarray(x), k)
    tw, ti, tprob = moe.route(tp["router"]["w"], torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-5,
                               atol=1e-7)
    assert tw.dtype == tprob.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_breaks_ties_to_the_lower_expert_like_jax(dtype):
    """A zero router: every probability is equal, and JAX's ``top_k``
    takes the lowest expert indices; so does the port, and the dispatch
    that follows (positions, drops) is the same."""
    x = _x((24, 16), dtype)
    w = np.zeros((16, 8), np.float32)
    jw, ji, _ = jmoe.route(jnp.asarray(w), jnp.asarray(x), 3)
    tw, ti, _ = moe.route(torch.from_numpy(w), _t(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(3), (24, 1)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    # a partial tie: equal logits for experts 5, 2 and 7 only
    probs = torch.tensor([[0.1, 0.05, 0.2, 0.05, 0.1, 0.2, 0.1, 0.2]])
    np.testing.assert_array_equal(moe.top_k(probs, 4)[1].numpy(),
                                  np.asarray(jax.lax.top_k(
                                      jnp.asarray(probs.numpy()), 4)[1]))


def test_router_product_is_ieee_f32_whatever_the_matmul_precision():
    """``route``'s logits are the IEEE f32 product even when the caller
    lowered ``torch.set_float32_matmul_precision`` (TF32 on the card, bf16
    passes on some CPUs); the caller's setting is restored."""
    _, _, tp = _layer(d=64, e=16)
    x = torch.from_numpy(_x((50, 64)))
    want = moe.router_logits(tp["router"]["w"], x)
    exact = (x.double() @ tp["router"]["w"].double()).float()
    torch.testing.assert_close(want, exact, rtol=1e-5, atol=1e-5)
    prev = torch.get_float32_matmul_precision()
    try:
        for setting in ("medium", "high"):
            torch.set_float32_matmul_precision(setting)
            assert torch.equal(moe.router_logits(tp["router"]["w"], x), want)
            assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("n,e", [(1, 4), (64, 8), (1000, 128), (300, 7)])
def test_positions_in_expert_match_jax_bitwise(n, e):
    ids = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    want = np.asarray(jmoe.positions_in_expert(jnp.asarray(ids), e))
    got = moe.positions_in_expert(torch.from_numpy(ids), e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # rows of a stack are independent: each equals its own 1-D call
    rows = np.random.default_rng(n + 1).integers(0, e, (3, n)).astype(
        np.int32)
    stacked = moe.positions_in_expert(torch.from_numpy(rows), e).numpy()
    for r in range(3):
        np.testing.assert_array_equal(stacked[r], np.asarray(
            jmoe.positions_in_expert(jnp.asarray(rows[r]), e)))


def test_capacity_for_matches_jax():
    for t in (1, 8, 48, 4096, 32768):
        for k in (1, 2, 8):
            for e in (4, 128, 384):
                for cf in CAPACITY_FACTORS + [1.0, 2.0]:
                    assert moe.capacity_for(t, k, e, cf) == \
                        jmoe.capacity_for(t, k, e, cf), (t, k, e, cf)


def test_init_keeps_the_router_f32_and_matches_jax_shapes():
    gen = torch.Generator().manual_seed(0)
    tp = moe.init(gen, 64, 96, 4, torch.bfloat16, n_shared=1)
    jp = jmoe.init(jax.random.key(0), 64, 96, 4, jnp.bfloat16, n_shared=1)
    jp, _ = split_params(jp)
    jflat = dict(_flatten_with_paths(jax.tree.map(np.asarray, jp)))
    tflat = dict(_flatten_with_paths(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, a in jflat.items():
        assert tuple(tflat[name].shape) == a.shape, name
        assert str(tflat[name].dtype).split(".")[1] == str(a.dtype), name
    assert tp["router"]["w"].dtype == torch.float32


# ------------------------------------------------------------------- apply

def _dispatch_ids(route_fn, pos_fn, cap_fn, w, x, k, e, cf):
    """(ids, pos, keep, slot) of the dispatch, as integers."""
    _, ids, _ = route_fn(w, x, k)
    e_flat = ids.reshape(-1)
    pos = pos_fn(e_flat, e)
    cap = cap_fn(x.shape[0], k, e, cf)
    keep = pos < cap
    return (np.asarray(ids), np.asarray(pos), np.asarray(keep),
            np.where(np.asarray(keep), np.asarray(pos), cap))


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_apply_matches_jax(cf):
    """Outputs and metrics to 1e-5 at capacity factors that drop a third
    of the assignments (0.25), a few (1.25) and none (8.0); ids, positions,
    keep and slots bitwise."""
    _, jp, tp = _layer()
    x = _x((2, 24, 32))
    jo, jm = jmoe.apply(jp, jnp.asarray(x), 2, cf)
    to, tm = moe.apply(tp, torch.from_numpy(x), 2, cf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    assert sorted(tm) == sorted(jm)
    for name in jm:
        np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    xt = x.reshape(48, 32)
    want = _dispatch_ids(jmoe.route, jmoe.positions_in_expert,
                         jmoe.capacity_for, jp["router"]["w"],
                         jnp.asarray(xt), 2, 8, cf)
    got = _dispatch_ids(moe.route, moe.positions_in_expert,
                        moe.capacity_for, tp["router"]["w"],
                        torch.from_numpy(xt), 2, 8, cf)
    for name, g, w in zip(("ids", "pos", "keep", "slot"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    dropped = 1.0 - want[2].mean()
    assert float(tm["drop_frac"]) == pytest.approx(dropped, abs=1e-7)
    if cf == 0.25:
        assert dropped > 0.3
    if cf == 8.0:
        assert dropped == 0


def test_apply_through_the_token_chunk_split_matches_jax():
    """48 tokens in chunks of 16: three sequential dispatches, the metrics
    their mean; at a capacity factor of 0.25 each chunk's positions start
    afresh, so the chunks drop fewer assignments than the whole."""
    _, jp, tp = _layer()
    x = _x((2, 24, 32), seed=3)
    jo, jm = jmoe.apply(jp, jnp.asarray(x), 2, 0.25, token_chunk=16)
    to, tm = moe.apply(tp, torch.from_numpy(x), 2, 0.25, token_chunk=16)
    whole, wm = moe.apply(tp, torch.from_numpy(x), 2, 0.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    for name in jm:
        np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(tm["drop_frac"]) < float(wm["drop_frac"])
    assert not torch.equal(to, whole)


def test_apply_with_a_shared_expert_matches_jax():
    _, jp, tp = _layer(shared=1)
    x = _x((2, 10, 32), seed=4)
    jo, _ = jmoe.apply(jp, jnp.asarray(x), 2, 1.25)
    to, _ = moe.apply(tp, torch.from_numpy(x), 2, 1.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_bf16_apply_is_within_the_bf16_tol_of_jax(cf):
    """The decided divergence: in bf16 the combine sums a token's k expert
    outputs in f32 and rounds once (``cscatter``), JAX rounds at every add;
    the outputs agree to the bf16 ``TOL``."""
    _, jp, tp = _layer(dtype="bfloat16")
    x = _x((2, 24, 32), "bfloat16", seed=5)
    jo, _ = jmoe.apply(jp, jnp.asarray(x), 2, cf)
    to, _ = moe.apply(tp, _t(x), 2, cf)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches_the_jax_scatter_add(dtype):
    """``combine`` alone against ``zeros.at[token_idx].add(y)``: f32 to
    1e-5; bf16, where the port rounds once, to the bf16 ``TOL``; and in
    bf16 it equals the f32 sum rounded once, bit for bit."""
    y = _x((60, 16), dtype, seed=6)
    idx = np.arange(60, dtype=np.int32) // 3
    want = jnp.zeros((20, 16), jnp.dtype(dtype)).at[jnp.asarray(idx)].add(
        jnp.asarray(y))
    got = moe.combine(_t(y), torch.from_numpy(idx), 20)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    once = torch.zeros(20, 16).index_add_(0, torch.from_numpy(idx).long(),
                                          _t(y).float())
    assert torch.equal(got, once.to(got.dtype))


def test_combine_gradient_is_the_gather_of_jax():
    y = _x((30, 8), seed=7)
    idx = np.arange(30, dtype=np.int32) // 2
    r = _x((15, 8), seed=8)
    jg = jax.grad(lambda v: jnp.sum(jnp.zeros((15, 8)).at[
        jnp.asarray(idx)].add(v) * jnp.asarray(r)))(jnp.asarray(y))
    ty = torch.from_numpy(y).requires_grad_(True)
    (moe.combine(ty, torch.from_numpy(idx), 15) * torch.from_numpy(r)
     ).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("cf", [0.25, 8.0])
def test_apply_gradients_match_jax(cf):
    """d/d(weights, x) of the output against a fixed projection plus the
    aux and z terms, f32 to 1e-5 of each leaf's largest magnitude."""
    p, jp, tp = _layer(shared=1)
    x = _x((2, 12, 32), seed=9)
    r = _x((2, 12, 32), seed=10)

    def jloss(params, xx):
        out, m = jmoe.apply(params, xx, 2, cf)
        return jnp.sum(out * jnp.asarray(r)) + m["aux_loss"] + m["router_z"]

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = pytree.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, m = moe.apply(leaves, tx, 2, cf)
    ((out * torch.from_numpy(r)).sum() + m["aux_loss"] + m["router_z"]
     ).backward()
    got = {k: _np(v.grad) for k, v in _flatten_with_paths(leaves)}
    _assert_trees_close(got, _flat_jax(jg[0]), what="moe grads")
    _assert_trees_close({"x": _np(tx.grad)}, {"x": np.asarray(jg[1])},
                        what="moe dx")


# ---------------------------------------------------------------- apply_ep

@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("shared", [0, 1])
def test_apply_ep_over_stacked_ranks_equals_apply(ranks, cf, shared):
    """The expert-parallel form over 2 and 4 stacked model ranks makes
    ``moe.apply``'s dispatch decisions at every capacity factor: outputs
    and metrics to 1e-5, gradients too (and finite)."""
    _, _, tp = _layer(shared=shared)
    x = _x((2, 24, 32), seed=11)
    want, wm = moe.apply(tp, torch.from_numpy(x), 2, cf)
    got, gm_ = moe_ep.apply_ep(tp, torch.from_numpy(x), 2, cf, ranks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for name in wm:
        torch.testing.assert_close(gm_[name], wm[name], rtol=1e-5, atol=1e-6)

    def grads(fn):
        leaves = pytree.tree_map(lambda t: t.clone().requires_grad_(True), tp)
        out, m = fn(leaves, torch.from_numpy(x), 2, cf)
        (out.square().sum() + m["aux_loss"]).backward()
        return {k: v.grad for k, v in _flatten_with_paths(leaves)}
    ge = grads(lambda *a: moe_ep.apply_ep(*a, ranks))
    ga = grads(moe.apply)
    for k in ga:
        assert bool(torch.isfinite(ge[k]).all()), k
        torch.testing.assert_close(ge[k], ga[k], rtol=1e-5, atol=1e-5)


def test_apply_ep_refuses_ranks_that_do_not_split_the_experts():
    _, _, tp = _layer(e=8)
    with pytest.raises(ValueError, match="do not split"):
        moe_ep.apply_ep(tp, torch.zeros(1, 4, 32), 2, 1.25, 3)


# ------------------------------------------------------------ the MoE LMs

def _pair(arch, dtype):
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    params, _ = split_params(jmodel.init(jax.random.key(0)))
    tmodel = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, jmodel, params, tmodel


def _check_caches(tc, jc, dtype, step):
    rtol, atol = CACHE_TOL[dtype]
    for part in ("scan", "dense"):
        assert (part in tc) == (part in jc), part
        if part not in jc:
            continue
        pairs = ([(tc[part], jc[part])] if part == "scan"
                 else list(zip(tc[part], jc[part])))
        for t, j in pairs:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(getattr(t, name)),
                    np.asarray(getattr(j, name), np.float32), rtol=rtol,
                    atol=atol, err_msg=f"{step} {part} cache {name}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_prefill_and_decode_match_jax(arch, dtype):
    """Prefill and 4 teacher-forced decode steps: logits and every cache,
    kimi-k2's ``"dense"`` caches of its first dense block too."""
    jcfg, jmodel, params, tmodel = _pair(arch, dtype)
    b, s, steps = 2, 12, 4
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)},
                            s + steps)
    tl, tc = tmodel.prefill(torch.from_numpy(tokens), s + steps)
    tol = LOGIT_TOL[dtype]
    assert ("dense" in tc) == (jcfg.first_dense_layers > 0)
    assert tc["scan"].k.shape[0] == jcfg.n_layers - jcfg.first_dense_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)
    _check_caches(tc, jc, dtype, "prefill")
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(s + i, jnp.int32))
        tl, tc = tmodel.decode_step(torch.from_numpy(tok), tc, s + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode {i}")
        _check_caches(tc, jc, dtype, f"decode {i}")


def _loss_and_grads(jmodel, params, tmodel, batch):
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(params,
                                            jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = gm.value_and_grad(lambda p, b: tmodel.loss(p, b)[0])(
        tmodel.params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    tflat = {k: _np(v) for k, v in _flatten_with_paths(tgrads)}
    return (float(tloss), tflat), (float(jloss), _flat_jax(jgrads))


def _record_routes(monkeypatch):
    """Both packages' expert ids and probabilities, a list a package, in
    the order their MoE layers run."""
    rec = {"jax": [], "port": []}
    jroute, troute = jmoe.route, moe.route

    def jax_side(*a):
        out = jroute(*a)
        rec["jax"].append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    def port_side(*a):
        out = troute(*a)
        rec["port"].append((out[1].numpy(), out[2].detach().numpy()))
        return out
    monkeypatch.setattr(jmoe, "route", jax_side)
    monkeypatch.setattr(moe, "route", port_side)
    return rec


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_loss_and_every_gradient_match_jax(arch, dtype, monkeypatch):
    """The loss (cross-entropy, z-loss and the router's aux and z terms
    over ``n_layers``) and every gradient leaf — the router, the experts,
    kimi-k2's shared expert and first dense block. f32: the loss to 1e-5
    and each leaf to 1e-5 of its largest magnitude, the same expert ids in
    every layer. bf16: the loss to 2e-2 and the leaves as the dense LM's
    bf16 test (5e-2 of the largest), per MoE layer for the layers where
    both packages route every token alike; a token routed differently must
    be a near-tie (its two experts' probabilities within 1e-2 in both
    packages), and at most one a layer."""
    jcfg, jmodel, params, tmodel = _pair(arch, dtype)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(
        np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    (tl, tg), (jl, jg) = _loss_and_grads(jmodel, params, tmodel, batch)
    assert sorted(tg) == sorted(jg)
    assert any(k.startswith("blocks/moe/router") for k in tg)
    if jcfg.first_dense_layers:
        assert any(k.startswith("dense_blocks/0/ffn") for k in tg)
        assert any(k.startswith("blocks/moe/shared") for k in tg)
    rec = _record_routes(monkeypatch)
    with jax.disable_jit():
        jmodel.loss(params, jax.tree.map(jnp.asarray, batch))
    tmodel.loss(tmodel.params(), {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    n_moe = jcfg.n_layers - jcfg.first_dense_layers
    assert len(rec["jax"]) == len(rec["port"]) == n_moe
    flipped = []
    for (ji, jprob), (ti, tprob) in zip(rec["jax"], rec["port"]):
        rows = np.nonzero((ji != ti).any(-1))[0]
        flipped.append(len(rows))
        for r in rows:
            swapped = np.setxor1d(ji[r], ti[r])
            for probs in (jprob[r], tprob[r]):
                gap = np.ptp(probs[swapped])
                assert gap <= 1e-2, (r, swapped, gap)
    if dtype == "float32":
        assert flipped == [0] * n_moe
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_trees_close(tg, jg, what=f"{arch} f32")
        return
    assert max(flipped) <= 1, flipped
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for k in jg:
        if k.startswith("blocks/moe/"):
            for layer, n in enumerate(flipped):
                if n == 0:
                    _assert_trees_close({k: tg[k][layer]}, {k: jg[k][layer]},
                                        rtol=5e-2, atol_frac=5e-2,
                                        what=f"{arch} bf16 layer {layer}")
        else:
            _assert_trees_close({k: tg[k]}, {k: jg[k]}, rtol=5e-2,
                                atol_frac=5e-2, what=f"{arch} bf16")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_metrics_match_jax(arch):
    """``loss``'s metrics: the MoE layers' aux loss, router z and drop
    share summed over the stacked layers, beside the cross-entropy."""
    jcfg, jmodel, params, tmodel = _pair(arch, "float32")
    tokens = np.random.default_rng(3).integers(0, 512, (2, 9)).astype(
        np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    _, jm = jmodel.loss(params, jax.tree.map(jnp.asarray, batch))
    _, tm = tmodel.loss(tmodel.params(), {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    assert sorted(tm) == sorted(jm) == sorted(
        ["aux_loss", "router_z", "drop_frac", "nll", "z_loss", "loss"])
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_remat_changes_no_number(remat):
    """The MoE loss and gradients under ``full`` and ``dots`` remat (the
    combine recomputed through ``cscatter``) equal those without, bit for
    bit."""
    tokens = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(
        np.int64)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    out = {}
    for policy in ("none", remat):
        cfg = dataclasses.replace(tbase.get_smoke_config("kimi-k2-1t"),
                                  dtype="float32", remat=policy)
        model = build_model(cfg, device="cpu", seed=4)
        params = pytree.tree_map(lambda t: t.requires_grad_(True),
                                 model.params())
        loss, _ = model.loss(params, batch)
        out[policy] = (loss, torch.autograd.grad(loss,
                                                 pytree.tree_leaves(params)))
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_jax_params_keeps_the_router_f32_in_a_bf16_model(arch):
    """Every leaf of the JAX tree lands in the port (``blocks.moe.router.w``,
    ``blocks.moe.shared.*``, ``dense_blocks.<i>.*``), bit for bit, and the
    router stays f32 in a bf16 model."""
    jcfg, _, params, tmodel = _pair(arch, "bfloat16")
    names = dict(tmodel.named_parameters())
    assert names["blocks.moe.router.w"].dtype == torch.float32
    assert names["blocks.moe.wi_gate"].dtype == torch.bfloat16
    if jcfg.first_dense_layers:
        assert "dense_blocks.0.ffn.wi_gate.w" in names
        assert "blocks.moe.shared.wo.w" in names
    want = dict(_flatten_with_paths(jax.tree.map(np.asarray, params)))
    got = dict(_flatten_with_paths(tmodel.params()))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert torch.equal(got[k], _t(a)), k


def test_kernel_path_equals_the_plain_path_on_the_cpu():
    """On the CPU the kernel path runs the kernels' plain versions (the
    combine's ``cscatter`` included): the switch changes nothing."""
    cfg = tbase.get_smoke_config("kimi-k2-1t")
    model = build_model(cfg, device="cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    want, _ = model.prefill(tokens, 12)
    model.impl = "plain"
    got, _ = model.prefill(tokens, 12)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_serves_the_moe_family_on_the_cpu(arch):
    """The JAX CLI's three lines, then the two traced phases."""
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_inputs_equal_the_jax_cli_draws(arch):
    """The JAX CLI draws the prompt ids from ``default_rng(seed)`` and
    nothing else for the MoE family."""
    cfg = tbase.get_smoke_config(arch)
    batch = serve.serve_batch(cfg, 3, 20, 7)
    want = np.random.default_rng(7).integers(0, cfg.vocab, (3, 20))
    assert sorted(batch) == ["tokens"]
    np.testing.assert_array_equal(batch["tokens"], want.astype(np.int32))
