"""The port's training slice against the JAX package: the loss and every
gradient of the model, the embedding backward, microbatch accumulation,
the gradient merge over stacked ranks, and the implicit, eager-explicit,
deferred and overlapped train steps.

Weights come from the JAX model's own init and go to the port through
``from_jax_params``; batches are the data pipeline's (bitwise equal in the
two packages) or numpy ids from a seed. The JAX package's own explicit
train step (``make_train_step(mesh=...)``) does not run on this container's
jax (``AbstractMesh`` and ``shard_map(auto=)`` drift), so the deferred and
overlapped steps are held against a reference composed here from JAX
pieces that do run: per-rank ``jax.value_and_grad`` under ``vmap``,
``ccache.defer_cascade`` / ``overlap_cascade`` / ``settle_inflight`` under
``vmap(axis_name=...)``, and JAX ``adamw``, stepping exactly as the JAX
step does (``repro/launch/steps.py:374-565``).

Tolerances. In float32 both packages compute the same function, differing
in summation order: the loss to ``TOL`` (1e-5, ``tests/test_kernels.py``)
and each gradient leaf to ``TOL`` relative plus ``TOL`` of the leaf's
largest magnitude (small elements of a gradient are sums that cancel).
Parameters after AdamW steps get the same bound plus 1e-5 absolute. The
steps run AdamW with ``eps = 1e-3`` (``EPS``): with the default 1e-8 the
first steps move each element by about ``lr * sign(g)``, and an element
whose true gradient is zero (the key bias: softmax is invariant to it)
then moves by ``±lr`` with the sign of each package's rounding noise.
``tests/test_torch_optim.py`` holds the default ``eps`` against JAX. In bfloat16 the two
packages round at other places, and the port's embedding gradient is
summed in f32 and rounded once where XLA's bf16 scatter-add rounds at each
add: the loss to 2e-2 and each gradient leaf to 5e-2 of its largest
magnitude (a few bf16 roundings of the largest terms of each sum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import defer_state as jdefer_state
from repro.configs import base as jbase
from repro.core import ccache as jccache
from repro.core import grad_merge as jgm
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.core.merge_plan import MergePlan as JMergePlan
from repro.data import pipeline as jpipe
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.core import ccache
from repro_torch.core import grad_merge as gm
from repro_torch.core import merge_functions as mf
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_plan import MergePlan
from repro_torch.core.stacked import StackedAxis
from repro_torch.launch import steps
from repro_torch.models.embedding import embed
from repro_torch.models.registry import from_jax_params
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

ARCH = "qwen1-5-0-5b"
TOL = 1e-5
DP = 8
BATCH, SEQ = 8, 8
LR = 1e-3
EPS = 1e-3


def _adamw(opt, sched):
    return opt.adamw(sched, eps=EPS)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat_torch(tree) -> dict:
    return {k: _np(v) for k, v in _flatten_with_paths(tree)}


def _flat_jax(tree) -> dict:
    return {k: _np(v) for k, v in jckpt.checkpoint._flatten_with_paths(tree)}


def _assert_trees_close(got: dict, want: dict, rtol=TOL, atol_frac=TOL,
                        atol=0.0, what=""):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        bound = atol + atol_frac * float(np.abs(want[k]).max(initial=0.0))
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=bound,
                                   err_msg=f"{what} {k}")


class Pair:
    """One smoke model in both packages on the same weights: the smoke
    config with ``dtype``, ``remat`` and any other ``overrides``; the port's
    MoE layers over ``model_ranks`` stacked model ranks (``DecoderLM``)."""

    def __init__(self, dtype="float32", remat="none", arch=ARCH,
                 model_ranks=None, **overrides):
        self.jcfg = dataclasses.replace(jbase.get_smoke_config(arch),
                                        dtype=dtype, remat=remat, **overrides)
        self.tcfg = dataclasses.replace(tbase.get_smoke_config(arch),
                                        dtype=dtype, remat=remat, **overrides)
        self.jmodel = jbuild_model(self.jcfg)
        self.jparams, _ = split_params(self.jmodel.init(jax.random.key(0)))
        self.tmodel = from_jax_params(
            self.tcfg, jax.tree.map(np.asarray, self.jparams), device="cpu",
            model_ranks=model_ranks)
        self._jgrads = None

    def tparams(self):
        return self.tmodel.params()

    def jax_rank_grads(self, params, batch, dp=DP):
        """JAX's per-rank (loss, grads) over a ``[dp, B/dp, S]`` batch."""
        if self._jgrads is None:
            loss_fn = lambda p, b: self.jmodel.loss(p, b)[0]
            self._jgrads = jax.jit(jax.vmap(jax.value_and_grad(loss_fn),
                                            in_axes=(None, 0)))
        shards = jax.tree.map(
            lambda x: jnp.asarray(x).reshape((dp, -1) + x.shape[1:]), batch)
        loss, grads = self._jgrads(params, shards)
        return loss.mean(), grads


@pytest.fixture(scope="module")
def f32():
    return Pair("float32")


def _batch(seed=0, vocab=512, b=BATCH, s=SEQ):
    tok = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1].copy(), "labels": tok[:, 1:].copy()}


def _stream(n, seed=0):
    cfg = jpipe.DataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH,
                           seed=seed)
    return [jpipe.batch_at(cfg, t) for t in range(n)]


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def _loss_and_grads(pair, batch):
    jloss, jgrads = jax.value_and_grad(
        lambda p: pair.jmodel.loss(p, jax.tree.map(jnp.asarray, batch))[0]
    )(pair.jparams)
    tloss, tgrads = gm.value_and_grad(
        lambda p, b: pair.tmodel.loss(p, b)[0])(pair.tparams(),
                                                _tbatch(batch))
    return (float(tloss), _flat_torch(tgrads)), (float(jloss),
                                                 _flat_jax(jgrads))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_all_gradients_match_jax_in_f32(remat):
    pair = Pair("float32", remat)
    batch = _batch(1)
    batch["labels"][0, :3] = -1                      # ignored positions
    (tl, tg), (jl, jg) = _loss_and_grads(pair, batch)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    _assert_trees_close(tg, jg, what=f"remat={remat}")
    assert {"embed/table", "ln_f/scale", "blocks/attn/wq/b"} <= set(tg)


def test_remat_changes_no_number():
    batch = _tbatch(_batch(2))
    out = {}
    for remat in ("none", "full", "dots"):
        pair = Pair("float32", remat)
        loss, grads = gm.value_and_grad(
            lambda p, b: pair.tmodel.loss(p, b)[0])(pair.tparams(), batch)
        out[remat] = (float(loss), _flat_torch(grads))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for k, v in out["none"][1].items():
            np.testing.assert_array_equal(out[remat][1][k], v, err_msg=k)


def test_loss_and_gradients_match_jax_in_bf16():
    pair = Pair("bfloat16", "dots")
    (tl, tg), (jl, jg) = _loss_and_grads(pair, _batch(3))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    _assert_trees_close(tg, jg, rtol=5e-2, atol_frac=5e-2, what="bf16")


def test_loss_metrics_match_jax(f32):
    batch = _batch(4)
    _, jm = f32.jmodel.loss(f32.jparams, jax.tree.map(jnp.asarray, batch))
    _, tm = f32.tmodel.loss(f32.tparams(), _tbatch(batch))
    assert sorted(tm) == sorted(jm) == ["loss", "nll", "z_loss"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)


# ---------------------------------------------------------------------------
# the embedding backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
def test_embedding_backward_matches_jax_autodiff(tied):
    """The plain ``cscatter`` backward (the tensor is on the CPU) against
    JAX's autodiff of the gather: every id of a heavy-tailed batch repeats,
    one row is hit by a whole column, rows no id touches get zeros (or only
    the tied logits term)."""
    rng = np.random.default_rng(5)
    v, d = 40, 16
    table = rng.standard_normal((v, d)).astype(np.float32)
    tokens = (rng.zipf(1.3, (3, 24)) % v).astype(np.int32)
    tokens[:, 0] = 7
    cot = rng.standard_normal((3, 24, d)).astype(np.float32)
    h = rng.standard_normal((3, 5, d)).astype(np.float32)
    c = rng.standard_normal((3, 5, v)).astype(np.float32)

    def jloss(t):
        out = jnp.sum(t[tokens] * cot)
        return out + jnp.sum((h @ t.T) * c) if tied else out

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = (embed(tt, torch.from_numpy(tokens)) * torch.from_numpy(cot)).sum()
    if tied:
        out = out + ((torch.from_numpy(h) @ tt.t())
                     * torch.from_numpy(c)).sum()
    (got,) = torch.autograd.grad(out, tt)
    untouched = np.setdiff1d(np.arange(v), tokens)
    assert untouched.size > 0
    if not tied:
        assert not got[untouched].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_embedding_backward_ignores_a_negative_id():
    """A decided divergence: the gather wraps -1 to the last row (as JAX's
    does), the ``cscatter`` backward ignores it (JAX's scatter wraps)."""
    table = torch.randn(6, 3, requires_grad=True)
    out = embed(table, torch.tensor([-1, 2, 2]))
    assert torch.equal(out[0], table[5])
    (g,) = torch.autograd.grad(out.sum(), table)
    assert torch.equal(g[2], torch.full((3,), 2.0))
    assert not g[5].any()


def test_embedding_backward_goes_through_embedding_grad_scatter(monkeypatch):
    from repro_torch.models import embedding
    calls = []
    real = embedding.ops.embedding_grad_scatter

    def spy(table_grad, ids, grads):
        calls.append((table_grad.dtype, tuple(table_grad.shape),
                      tuple(ids.shape), ids.dtype, grads.dtype))
        return real(table_grad, ids, grads)

    monkeypatch.setattr(embedding.ops, "embedding_grad_scatter", spy)
    table = torch.randn(30, 8, dtype=torch.bfloat16, requires_grad=True)
    embed(table, torch.randint(0, 30, (2, 5))).float().sum().backward()
    assert calls == [(torch.float32, (30, 8), (10,), torch.int32,
                      torch.float32)]
    assert table.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# microbatches and the gradient merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4])
def test_microbatched_value_and_grad_matches_jax(f32, n):
    batch = _batch(6)
    jloss, jgrads = jgm.microbatched_value_and_grad(
        lambda p, b: f32.jmodel.loss(p, b)[0], n)(
            f32.jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = gm.microbatched_value_and_grad(
        lambda p, b: f32.tmodel.loss(p, b)[0], n)(f32.tparams(),
                                                  _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    _assert_trees_close(_flat_torch(tgrads), _flat_jax(jgrads))


def test_split_microbatches_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="does not split"):
        gm.split_microbatches({"x": torch.zeros(6, 2)}, 4)


def _rank_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((DP, 6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((DP, 7)).astype(np.float32)}}


@pytest.mark.parametrize("topology", [
    "flat", "group2", "chip:2,host:2,pod:2", "lane:chip:2,host:2,pod:2",
    "chip:4,pod:2:software"])
@pytest.mark.parametrize("merge", ["add", "int8"])
@pytest.mark.parametrize("mean", [True, False])
def test_merge_gradients_over_stacked_ranks_matches_jax_vmap(topology, merge,
                                                             mean):
    grads = _rank_tree(7)
    if topology == "flat":
        jt = tt = None
    elif topology == "group2":
        jt, tt = jccache.MergeTopology(2), ccache.MergeTopology(2)
    else:
        lane = topology.startswith("lane:")
        spec = topology.removeprefix("lane:")
        jt = JMergePlan.parse(spec, lane_parallel=lane)
        tt = MergePlan.parse(spec, lane_parallel=lane)
    compress = merge == "int8"
    jfn = jmf.int8_compressed_add() if compress else jmf.ADD
    tfn = mf.int8_compressed_add() if compress else mf.ADD
    want = jax.vmap(lambda g: jgm.merge_gradients(
        g, "r", merge_fn=jfn, compress=compress, mean=mean, topology=jt),
        axis_name="r")(jax.tree.map(jnp.asarray, grads))
    got = gm.merge_gradients(jax.tree.map(torch.from_numpy, grads),
                             StackedAxis(DP, "cpu"), merge_fn=tfn,
                             compress=compress, mean=mean, topology=tt)
    _assert_trees_close(_flat_torch(got), _flat_jax(want))


# ---------------------------------------------------------------------------
# the implicit and the explicit eager step
# ---------------------------------------------------------------------------


def test_implicit_train_step_matches_jax(f32):
    """No mesh, jitted, 2 microbatches, 3 steps of AdamW under a warmup-
    cosine schedule: losses each step, then parameters and moments."""
    n = 3
    jopt_ = _adamw(jopt, jsched.warmup_cosine(LR, 1, n))
    topt_ = _adamw(topt, tsched.warmup_cosine(LR, 1, n))
    jstep = jax.jit(jmake_train_step(f32.jmodel, f32.jcfg, jopt_, 2))
    tstep = steps.make_train_step(f32.tmodel, f32.tcfg, topt_, 2)
    js = {"params": f32.jparams, "opt": jopt_.init(f32.jparams)}
    params = f32.tparams()
    ts = {"params": params, "opt": topt_.init(params)}
    for batch in _stream(n, seed=1):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       err_msg=k)
    _assert_trees_close(_flat_torch(ts), _flat_jax(js), atol=TOL,
                        what="state")


def test_explicit_eager_step_is_the_mean_of_rank_gradients(f32):
    """The eager explicit step over 8 stacked ranks against JAX's per-rank
    grads, their mean, and one JAX AdamW step."""
    plan = MergePlan.parse("chip:2,host:2,pod:2")
    jopt_, topt_ = _adamw(jopt, jsched.constant(LR)), _adamw(topt,
        tsched.constant(LR))
    step = steps.make_train_step(f32.tmodel, f32.tcfg, topt_,
                                 merge_topology=plan)
    batch = _stream(1, seed=2)[0]
    params = f32.tparams()
    ts, tm = step({"params": params, "opt": topt_.init(params)}, batch)
    loss, grads = f32.jax_rank_grads(f32.jparams, batch)
    mean = jax.tree.map(lambda g: g.sum(0) / DP, grads)
    jparams, jstate, _ = jopt_.step(f32.jparams, mean,
                                    jopt_.init(f32.jparams))
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=TOL)
    _assert_trees_close(_flat_torch(ts["params"]), _flat_jax(jparams),
                        atol=TOL, what="params")
    _assert_trees_close(_flat_torch(ts["opt"].mu), _flat_jax(jstate.mu),
                        what="mu")


# ---------------------------------------------------------------------------
# the deferred and the overlapped steps
# ---------------------------------------------------------------------------


def _zeros_stack(params, dp=DP):
    return jax.tree.map(lambda p: jnp.zeros((dp,) + p.shape, p.dtype), params)


_CASCADES = {}


def _cascade(spec, overlap, due, land):
    """The jitted JAX cascade step of ``spec`` under ``vmap``."""
    key = (spec, overlap, due, land)
    if key not in _CASCADES:
        plan = JMergePlan.parse(spec)
        if overlap:
            def fn(g, inf, *p):
                new_p, new_inf, landed = jccache.overlap_cascade(
                    g, list(p), inf, due, land, "r", jmf.ADD, plan)
                return tuple(new_p), new_inf, landed
        else:
            def fn(g, *p):
                new_p, settled = jccache.defer_cascade(
                    g, list(p), due, "r", jmf.ADD, plan)
                return tuple(new_p), settled
        _CASCADES[key] = jax.jit(jax.vmap(fn, axis_name="r"))
    return _CASCADES[key]


def _jax_deferred_run(pair, spec, sched, batches, opt):
    """The JAX train step's deferred logic (``steps.py:439-560``), composed
    from per-rank value_and_grad, the cascades under vmap and ``adamw``,
    over ``spec``'s ranks. Returns the per-step (loss, params, land, due)
    history and the flushed params."""
    plan = JMergePlan.parse(spec)
    dp = plan.num_ranks
    n_def, period, overlap = sched.num_levels, sched.period, sched.overlap
    scale = 1.0 / (dp * period)
    params, opt_state = pair.jparams, opt.init(pair.jparams)
    pends = tuple(_zeros_stack(params, dp) for _ in range(n_def))
    inflight = _zeros_stack(params, dp)

    def opt_step(params, opt_state, settled, s):
        grads = jax.tree.map(lambda g: g[0] * jnp.asarray(s, g.dtype),
                             settled)
        return opt.step(params, grads, opt_state)[:2]

    hist = []
    for t, batch in enumerate(batches, start=1):
        loss, grads = pair.jax_rank_grads(params, batch, dp)
        due = sched.due_count(t)
        land = overlap and t > 1 and sched.due_count(t - 1) == n_def
        fn = _cascade(spec, overlap, due, land)
        if overlap:
            pends, inflight, settled = fn(grads, inflight, *pends)
            commits = land
        else:
            pends, settled = fn(grads, *pends)
            commits = due == n_def
        if commits:
            params, opt_state = opt_step(params, opt_state, settled, scale)
        hist.append((float(loss), _flat_jax(params), land, due))
    T = len(batches)
    if overlap and sched.due_count(T) == n_def:
        landed = jax.vmap(lambda x: jccache.settle_inflight(
            x, "r", jmf.ADD, plan), axis_name="r")(inflight)
        params, opt_state = opt_step(params, opt_state, landed, scale)
    m = T % period
    if m:
        settled = jax.vmap(lambda *p: jccache.defer_cascade(
            jax.tree.map(jnp.zeros_like, p[0]), list(p), n_def, "r", jmf.ADD,
            plan)[1], axis_name="r")(*pends)
        params, opt_state = opt_step(params, opt_state, settled,
                                     1.0 / (dp * m))
    return hist, _flat_jax(params)


SCHEDULES = [
    # (plan, deferred levels' intervals, overlap, steps)
    ("chip:2,host:2,pod:2:defer", (1,), False, 3),
    ("chip:2,host:2:defer,pod:2:defer", (2, 2), False, 5),
    ("chip:2,host:2:defer,pod:2:defer", (1, 3), False, 7),
    ("chip:2,host:2,pod:2:defer", (1,), True, 3),
    ("chip:2,host:2:defer,pod:2:defer", (2, 2), True, 5),
    ("chip:2,host:2:defer,pod:2:defer", (1, 3), True, 7),
]


@pytest.mark.parametrize("spec,intervals,overlap,n", SCHEDULES,
                         ids=[f"{'ovl' if o else 'def'}-{'x'.join(map(str, k))}"
                              f"-{n}steps" for _, k, o, n in SCHEDULES])
def test_deferred_step_matches_the_composed_jax_reference(f32, spec,
                                                          intervals, overlap,
                                                          n):
    """Every step's loss, params, due count and land dispatch, then the
    final flush (a trailing partial cycle where ``n`` is not a multiple of
    the period; the in-flight cycle when overlapped)."""
    names = tuple(lv.name for lv in MergePlan.parse(spec).levels
                  if lv.defer)
    jsched_ = JDeferSchedule(level_names=names, intervals=intervals,
                             overlap=overlap)
    tsched_ = DeferSchedule(level_names=names, intervals=intervals,
                            overlap=overlap)
    jopt_, topt_ = _adamw(jopt, jsched.constant(LR)), _adamw(topt,
        tsched.constant(LR))
    batches = _stream(n, seed=3)
    hist, jfinal = _jax_deferred_run(f32, spec, jsched_, batches, jopt_)

    step = steps.make_train_step(f32.tmodel, f32.tcfg, topt_,
                                 merge_topology=MergePlan.parse(spec),
                                 defer_schedule=tsched_)
    assert isinstance(step, steps.DeferredTrainStep)
    assert step.dp == DP and step.deferred_names == names
    assert len(step.variants) == len(names) + 1
    assert (step.land_variants is not None) == overlap
    assert step.optimizer is topt_
    params = f32.tparams()
    state = {"params": params, "opt": topt_.init(params),
             "defer": step.init_defer_state(params)}
    for t, (batch, (jloss, jparams, land, due)) in enumerate(
            zip(batches, hist), start=1):
        assert step.land_due(state) == land and step.due(state) == due
        state, m = step(state, batch)
        assert int(state["defer"]["t"]) == t
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=TOL)
        _assert_trees_close(_flat_torch(state["params"]), jparams, atol=TOL,
                            what=f"step {t}")
    state, fm = step.flush(state)
    in_flight = overlap and n % tsched_.period == 0
    assert (fm is not None) == (n % tsched_.period != 0 or in_flight)
    if fm is not None:
        assert fm.get("flushed_inflight", False) == in_flight
        assert fm.get("flushed_steps", 0) == n % tsched_.period
    _assert_trees_close(_flat_torch(state["params"]), jfinal, atol=TOL,
                        what="flushed")
    # nothing is outstanding after the flush
    for tree in state["defer"]["pending"] + ((state["defer"]["inflight"],)
                                             if overlap else ()):
        assert all(not x.any() for x in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_durability_manifest_and_defer_state_match_jax(f32):
    spec = "chip:2,host:2:defer,pod:2:defer"
    for overlap in (False, True):
        names = ("host", "pod")
        tsched_ = DeferSchedule(level_names=names, intervals=(2, 4),
                                overlap=overlap)
        jsched_ = JDeferSchedule(level_names=names, intervals=(2, 4),
                                 overlap=overlap)
        step = steps.make_train_step(
            f32.tmodel, f32.tcfg, _adamw(topt, tsched.constant(LR)),
            merge_topology=MergePlan.parse(spec), defer_schedule=tsched_)
        jplan = JMergePlan.parse(spec)
        strides = tuple(s.stride for s in jccache.deferred_stages_of(
            jplan, DP, merge_fn=jmf.ADD))
        want = jdefer_state.defer_manifest(jplan, jsched_, DP, jmf.ADD,
                                           strides, "mean")
        assert step.durability_manifest() == want
        params = f32.tparams()
        state = {"defer": step.init_defer_state(params)}
        jspec = jdefer_state.defer_state_spec(
            jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                         f32.jparams), 2, DP, overlap)
        assert sorted(ckpt.tree_keys(state["defer"])) == \
            sorted(jckpt.tree_keys(jspec))
        assert sorted(ckpt.tree_keys(step.volatile_spec(params))) == \
            sorted(jckpt.tree_keys(jspec))
        for (k, got), (_, meta) in zip(
                _flatten_with_paths(state["defer"]),
                _flatten_with_paths(step.volatile_spec(params))):
            assert got.shape == meta.shape and got.dtype == meta.dtype, k
        extras = step.defer_save_extras(state)
        assert extras == {"defer": want, "defer_land_pending": False,
                          "defer_t": 0}
        manifest = step.scheduled_manifest(0)
        assert [m.name for m in manifest] == ["chip"]
        assert [m.name for m in step.scheduled_manifest()] == \
            ["chip", "host", "pod"]
        assert step.jit() == step.__call__


def test_deferred_k1_equals_the_eager_explicit_step(f32):
    """K = 1 commits every step: the deferred step is the eager one."""
    topt_ = _adamw(topt, tsched.constant(LR))
    eager = steps.make_train_step(
        f32.tmodel, f32.tcfg, topt_,
        merge_topology=MergePlan.parse("chip:2,host:2,pod:2"))
    deferred = steps.make_train_step(
        f32.tmodel, f32.tcfg, topt_,
        merge_topology=MergePlan.parse("chip:2,host:2,pod:2:defer"),
        defer_schedule=DeferSchedule.fixed(1, ("pod",)))
    params = f32.tparams()
    se = {"params": params, "opt": topt_.init(params)}
    sd = dict(se, defer=deferred.init_defer_state(params))
    for batch in _stream(3, seed=4):
        se, me = eager(se, batch)
        sd, md = deferred(sd, batch)
        assert float(md["loss"]) == float(me["loss"])
        _assert_trees_close(_flat_torch(sd["params"]),
                            _flat_torch(se["params"]), rtol=1e-6,
                            atol_frac=1e-6, what="K=1")
    assert deferred.flush(sd)[1] is None


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_make_train_step_refusals(f32):
    opt = _adamw(topt, tsched.constant(LR))
    m, c = f32.tmodel, f32.tcfg
    defer_plan = MergePlan.parse("chip:2,host:2,pod:2:defer")
    with pytest.raises(ValueError, match="needs a merge_topology"):
        steps.make_train_step(m, c, opt,
                              defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="no commit schedule"):
        steps.make_train_step(m, c, opt, merge_topology=defer_plan)
    with pytest.raises(ValueError, match="no :defer levels"):
        steps.make_train_step(m, c, opt,
                              merge_topology=MergePlan.parse("chip:2,pod:4"),
                              defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="do not match"):
        steps.make_train_step(
            m, c, opt, merge_topology=defer_plan,
            defer_schedule=DeferSchedule.fixed(2, ("host", "pod")))
    with pytest.raises(ValueError, match="do not match"):
        steps.make_train_step(m, c, opt, merge_topology=defer_plan,
                              defer_schedule=DeferSchedule.fixed(2, ("dcn",)))
    with pytest.raises(ValueError, match="compile away"):
        steps.make_train_step(
            m, c, opt, merge_topology=MergePlan.parse("chip:8,pod:1:defer"),
            defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="pass dp"):
        steps.make_train_step(m, c, opt,
                              merge_topology=ccache.MergeTopology(2))
    with pytest.raises(ValueError, match="not divisible"):
        steps.make_train_step(m, c, opt, dp=6,
                              merge_topology=ccache.MergeTopology(4))
    with pytest.raises(ValueError, match="ranks but the plan covers"):
        steps.make_train_step(m, c, opt, dp=4, merge_topology=defer_plan,
                              defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    # a merge with no settle mode (neither scalable nor idempotent)
    grads_of = steps.grads_fn(m)
    with pytest.raises(ValueError, match="no deferred settle mode"):
        steps._make_deferred_train_step(
            grads_of, opt, defer_plan, False, DeferSchedule.fixed(2, ("pod",)),
            DP, mf.MUL)
    # overlap needs a stale-tolerant, deferrable merge
    with pytest.raises(ValueError, match="cannot defer"):
        steps._make_deferred_train_step(
            grads_of, opt, defer_plan, False,
            DeferSchedule.fixed(2, ("pod",), overlap=True), DP,
            mf.saturating_add(10.0))
    step = steps.make_train_step(
        m, c, opt, merge_topology=MergePlan.parse("chip:2,pod:2:defer"),
        defer_schedule=DeferSchedule.fixed(1, ("pod",)))
    params = f32.tparams()
    state = {"params": params, "opt": opt.init(params),
             "defer": step.init_defer_state(params)}
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        step(state, _batch(0, b=6))


def test_explicit_step_with_a_two_level_topology_and_dp(f32):
    """A ``MergeTopology`` names no rank count: ``dp`` does."""
    topt_ = _adamw(topt, tsched.constant(LR))
    a = steps.make_train_step(f32.tmodel, f32.tcfg, topt_, dp=DP,
                              merge_topology=ccache.MergeTopology(2))
    b = steps.make_train_step(f32.tmodel, f32.tcfg, topt_,
                              merge_topology=MergePlan.parse("g:2,x:4"))
    params = f32.tparams()
    s0 = {"params": params, "opt": topt_.init(params)}
    batch = _stream(1, seed=5)[0]
    (sa, ma), (sb, mb) = a(s0, batch), b(s0, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_trees_close(_flat_torch(sa["params"]), _flat_torch(sb["params"]),
                        atol=TOL)
