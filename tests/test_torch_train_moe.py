"""The port's MoE train path against the JAX package, at the smoke configs
of qwen3-moe-235b (AdamW) and kimi-k2-1t (Adafactor, a shared expert, a
dense first layer), over the two stacked data ranks of ``chip:2``.

The MoE layer is chosen as JAX's ``DecoderLM._moe`` chooses it: the
expert-parallel ``apply_ep`` over ``model_ranks`` stacked model ranks for
an ``"ep"`` config whose experts they split, ``moe.apply`` otherwise. The
smoke configs are ``"gshard"`` with AdamW (as JAX's), so the tests set
``moe_impl="ep"`` and the full config's optimizer on both packages'
configs. JAX's own ``make_train_step(mesh=...)``
and its ``apply_ep`` do not run on this container's jax (its mesh API
drifted), so the reference is composed from JAX pieces that do run, as
``tests/test_torch_train.py`` composes it: per-rank ``value_and_grad``
under ``vmap``, the mean over ranks, the cascades under
``vmap(axis_name=...)``, and JAX's ``adamw`` / ``adafactor``, with JAX's
``moe.apply`` as the MoE layer (``apply_ep`` makes its dispatch
decisions, ``tests/test_torch_moe.py``).

Tolerances: f32 to ``TOL`` (1e-5) as ``tests/test_torch_train.py``; bf16
as ``tests/test_torch_moe.py``'s bf16 gradient test (the loss to 2e-2,
each gradient leaf to 5e-2 of its largest magnitude), holding the MoE
layers where both packages route every token alike and requiring every
token routed otherwise to be a near-tie. The donating step is held to the
functional one bit for bit.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs import base as tbase
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import steps, train
from repro_torch.models import moe, moe_ep
from repro_torch.models.registry import build_model
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.runtime import DriverConfig, TrainDriver

from test_torch_train import (EPS, LR, TOL, Pair, _assert_trees_close,
                              _flat_jax, _flat_torch, _jax_deferred_run)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-235b", "kimi-k2-1t"]
PLAN, DEFER_PLAN, K, DP = "chip:2", "chip:2:defer", 2, 2
BATCH, SEQ = 4, 16                      # 2 rows a rank
RANKS = [None, 1, 2]


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: with a pytest-xdist worker per core, torch's
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(arch, model_ranks, dtype="float32") -> Pair:
    key = (arch, model_ranks, dtype)
    if key not in _PAIRS:
        _PAIRS[key] = Pair(dtype, arch=arch, model_ranks=model_ranks,
                           moe_impl="ep",
                           optimizer=tbase.get_config(arch).optimizer)
    return _PAIRS[key]


def _optimizers(arch):
    """The full config's optimizer in both packages at a constant lr
    (AdamW with ``EPS``, as ``tests/test_torch_train.py``)."""
    if tbase.get_config(arch).optimizer == "adafactor":
        return (jopt.adafactor(jsched.constant(LR)),
                topt.adafactor(tsched.constant(LR)))
    return (jopt.adamw(jsched.constant(LR), eps=EPS),
            topt.adamw(tsched.constant(LR), eps=EPS))


def _moments(opt_state) -> dict:
    """The optimizer's moments that it keeps (AdamW mu and nu, Adafactor
    nu)."""
    return {k: v for k, v in (("mu", opt_state.mu), ("nu", opt_state.nu))
            if v is not None}


def _stream(n, seed):
    cfg = jpipe.DataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH,
                           seed=seed)
    return [jpipe.batch_at(cfg, t) for t in range(n)]


class _Recording:
    """An optimizer that records the gradients it is given (a copy)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def step(self, params, grads, state, donate=False):
        self.grads.append(pytree.tree_map(torch.clone, grads))
        return self.opt.step(params, grads, state, donate=donate)


def _eager(pair, topt_, donate=False):
    return steps.make_train_step(pair.tmodel, pair.tcfg, topt_,
                                 merge_topology=MergePlan.parse(PLAN),
                                 donate=donate)


def _state(pair, opt):
    params = pair.tparams()
    return {"params": params, "opt": opt.init(params)}


# ---------------------------------------------------------------------------
# the MoE layer's selector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe_impl,ranks,want", [
    ("ep", 2, "apply_ep"), ("ep", 1, "apply_ep"), ("ep", 4, "apply_ep"),
    ("ep", 3, "apply"), ("ep", None, "apply"), ("gshard", 2, "apply")])
def test_the_moe_layer_is_chosen_by_the_jax_condition(moe_impl, ranks, want,
                                                      monkeypatch):
    """``apply_ep`` for an ``"ep"`` config whose 4 experts the ranks split,
    ``moe.apply`` for 3 ranks, no ranks or a ``"gshard"`` config: in
    training and in serving."""
    calls = []
    for mod, name in ((moe_ep, "apply_ep"), (moe, "apply")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    cfg = dataclasses.replace(tbase.get_smoke_config("qwen3-moe-235b"),
                              dtype="float32", moe_impl=moe_impl)
    model = build_model(cfg, device="cpu", seed=0, model_ranks=ranks)
    tokens = torch.randint(0, 512, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    model.loss(model.params(), {"tokens": tokens, "labels": tokens})
    model.prefill(tokens, 10)
    assert calls == [want] * (2 * cfg.n_layers)


# ---------------------------------------------------------------------------
# the eager step, the loss metrics, bf16
# ---------------------------------------------------------------------------


_JAX_EAGER = {}


def _jax_eager(arch, batch_seed):
    """JAX's per-rank loss and gradients over ``chip:2``, their mean and
    one step of the config's optimizer from the init."""
    key = (arch, batch_seed)
    if key not in _JAX_EAGER:
        pair = _pair(arch, None)
        jopt_, _ = _optimizers(arch)
        batch = _stream(1, batch_seed)[0]
        loss, grads = pair.jax_rank_grads(pair.jparams, batch, dp=DP)
        mean = jax.tree.map(lambda g: g.sum(0) / DP, grads)
        jparams, jstate, stats = jopt_.step(pair.jparams, mean,
                                            jopt_.init(pair.jparams))
        _JAX_EAGER[key] = (float(loss), _flat_jax(mean), _flat_jax(jparams),
                           {k: _flat_jax(v) for k, v in
                            _moments(jstate).items()},
                           float(stats["grad_norm"]))
    return _JAX_EAGER[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ranks", RANKS)
def test_moe_eager_step_is_the_mean_of_rank_gradients(arch, ranks):
    """The eager explicit step over chip:2 with the MoE layers over 0, 1
    and 2 stacked model ranks: the loss, the merged gradient the optimizer
    is given (every leaf: the router, the experts, kimi-k2's shared expert
    and dense first block), the grad norm, the parameters and the
    optimizer's moments after one step, against JAX's composed step."""
    jloss, jmean, jparams, jmoments, jgn = _jax_eager(arch, 2)
    pair = _pair(arch, ranks)
    _, topt_ = _optimizers(arch)
    rec = _Recording(topt_)
    ts, tm = _eager(pair, rec)(_state(pair, rec), _stream(1, 2)[0])
    np.testing.assert_allclose(float(tm["loss"]), jloss, rtol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), jgn, rtol=TOL)
    got = _flat_torch(rec.grads[0])
    assert any(k.startswith("blocks/moe/router") for k in got)
    _assert_trees_close(got, jmean, what="merged gradient")
    _assert_trees_close(_flat_torch(ts["params"]), jparams, atol=TOL,
                        what="params")
    for name, want in jmoments.items():
        _assert_trees_close(_flat_torch(getattr(ts["opt"], name)), want,
                            what=name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ranks", [1, 2])
def test_moe_loss_metrics_over_model_ranks_match_jax(arch, ranks):
    """``loss``'s metrics through ``apply_ep``: the aux loss, router z and
    drop share (over the ``[ranks, N]`` keep mask) summed over the MoE
    layers, beside the cross-entropy."""
    pair = _pair(arch, ranks)
    batch = _stream(1, 3)[0]
    _, jm = pair.jmodel.loss(pair.jparams, jax.tree.map(jnp.asarray, batch))
    _, tm = pair.tmodel.loss(pair.tparams(),
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()})
    assert sorted(tm) == sorted(jm) == sorted(
        ["aux_loss", "router_z", "drop_frac", "nll", "z_loss", "loss"])
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def _routes(monkeypatch):
    """Every MoE layer's expert ids and probabilities in both packages, in
    the order their layers run: JAX's ``moe.route``, the port's ``top_k``
    (which ``apply_ep`` routes through)."""
    rec = {"jax": [], "port": []}
    jroute, ttop = jmoe.route, moe.top_k

    def jax_side(*a):
        out = jroute(*a)
        rec["jax"].append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    def port_side(probs, k):
        out = ttop(probs, k)
        rec["port"].append((out[1].numpy(), probs.detach().numpy()))
        return out
    monkeypatch.setattr(jmoe, "route", jax_side)
    monkeypatch.setattr(moe, "top_k", port_side)
    return rec


def _rms_err(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_eager_step_in_bf16(arch, monkeypatch):
    """bf16 over 2 model ranks. Against the port's ``moe.apply`` step on the
    same weights: the loss and every leaf of the merged gradient to the
    bf16 ``TOL`` (2e-2, relative and of the leaf's largest). Against JAX:
    the loss to 2e-2; a token routed otherwise must be a near-tie (its
    swapped experts' probabilities within 1e-2 in both packages), at most
    one a layer and rank; and each leaf's error RMS within 0.1 of its RMS,
    per MoE layer for the layers where both packages route every token of
    both ranks alike. The two packages' bf16 steps part by rounding alone
    (the combine rounds once in the port, at every add in JAX; ``moe.apply``
    and ``apply_ep`` agree): kimi-k2's expert leaves by up to 7 % of their
    RMS at this batch, each expert's gradient a sum over ~16 tokens."""
    pair, ref = _pair(arch, 2, "bfloat16"), _pair(arch, None, "bfloat16")
    batch = _stream(1, 4)[0]
    _, topt_ = _optimizers(arch)
    got = {}
    for name, p in (("ep", pair), ("apply", ref)):
        rec = _Recording(topt_)
        _, tm = _eager(p, rec)(_state(p, rec), batch)
        got[name] = (float(tm["loss"]), _flat_torch(rec.grads[0]))
    (tl, tg), (al, ag) = got["ep"], got["apply"]
    np.testing.assert_allclose(tl, al, rtol=2e-2)
    _assert_trees_close(tg, ag, rtol=2e-2, atol_frac=2e-2, what="ep/apply")

    loss, grads = pair.jax_rank_grads(pair.jparams, batch, dp=DP)
    jmean = _flat_jax(jax.tree.map(lambda g: g.sum(0) / DP, grads))
    assert sorted(tg) == sorted(jmean)
    routes = _routes(monkeypatch)
    n_moe = pair.tcfg.n_layers - pair.tcfg.first_dense_layers
    flipped = np.zeros(n_moe, int)
    for r in range(DP):
        shard = {k: v[r * BATCH // DP:(r + 1) * BATCH // DP]
                 for k, v in batch.items()}
        with jax.disable_jit():
            pair.jmodel.loss(pair.jparams, jax.tree.map(jnp.asarray, shard))
        pair.tmodel.loss(pair.tparams(), {k: torch.from_numpy(v)
                                          for k, v in shard.items()})
    assert len(routes["jax"]) == len(routes["port"]) == DP * n_moe
    for i, ((ji, jprob), (ti, tprob)) in enumerate(zip(routes["jax"],
                                                       routes["port"])):
        rows = np.nonzero((np.sort(ji, -1) != np.sort(ti, -1)).any(-1))[0]
        assert len(rows) <= 1, (i, rows)
        flipped[i % n_moe] += len(rows)
        for row in rows:
            swapped = np.setxor1d(ji[row], ti[row])
            for probs in (jprob[row], tprob[row]):
                assert np.ptp(probs[swapped]) <= 1e-2, (i, row, swapped)

    np.testing.assert_allclose(tl, float(loss), rtol=2e-2)
    held = 0                            # leaves and MoE layers held
    for k in jmean:
        layers = range(n_moe) if k.startswith("blocks/moe/") else [None]
        for layer in layers:
            if layer is not None and flipped[layer]:
                continue
            g, w = ((tg[k], jmean[k]) if layer is None
                    else (tg[k][layer], jmean[k][layer]))
            assert _rms_err(g, w) <= 0.1, (k, layer, _rms_err(g, w))
            held += 1
    assert (flipped == 0).any() and held >= len(jmean)


# ---------------------------------------------------------------------------
# the deferred and the overlapped steps
# ---------------------------------------------------------------------------


def _deferred_step(pair, opt, overlap=False, donate=False):
    return steps.make_train_step(
        pair.tmodel, pair.tcfg, opt,
        merge_topology=MergePlan.parse(DEFER_PLAN, lane_parallel=overlap),
        defer_schedule=DeferSchedule(level_names=("chip",), intervals=(K,),
                                     overlap=overlap), donate=donate)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_deferred_step_matches_the_composed_jax_reference(arch):
    """K = 2 over 3 steps with the MoE layers over 2 model ranks: a commit
    at step 2, then a partial cycle that the flush settles."""
    pair = _pair(arch, 2)
    jopt_, topt_ = _optimizers(arch)
    batches = _stream(3, seed=5)
    hist, jfinal = _jax_deferred_run(
        pair, DEFER_PLAN, JDeferSchedule(level_names=("chip",),
                                         intervals=(K,)), batches, jopt_)
    step = _deferred_step(pair, topt_)
    state = dict(_state(pair, topt_))
    state["defer"] = step.init_defer_state(state["params"])
    for t, (batch, (jloss, jparams, _, due)) in enumerate(
            zip(batches, hist), start=1):
        assert step.due(state) == due
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=TOL)
        _assert_trees_close(_flat_torch(state["params"]), jparams, atol=TOL,
                            what=f"step {t}")
    state, fm = step.flush(state)
    assert fm is not None and fm.get("flushed_steps") == 1
    _assert_trees_close(_flat_torch(state["params"]), jfinal, atol=TOL,
                        what="flushed")


def _assert_bitwise(got, want, what):
    g, w = _flat_torch(got), _flat_torch(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert np.array_equal(g[k], w[k]), f"{what} {k}"


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_overlapped_first_landing_is_the_deferred_commit(arch):
    """The overlapped run lands its first cycle at step K + 1 on the same
    gradients, through the same operations, as the deferred run commits it
    at step K: parameters and moments equal bit for bit."""
    pair = _pair(arch, 2)
    _, topt_ = _optimizers(arch)
    batches = _stream(K + 1, seed=6)
    runs = {}
    for overlap, n in ((False, K), (True, K + 1)):
        step = _deferred_step(pair, topt_, overlap)
        state = dict(_state(pair, topt_))
        state["defer"] = step.init_defer_state(state["params"])
        for batch in batches[:n]:
            state, _ = step(state, batch)
        runs[overlap] = state
    want, got = runs[False], runs[True]
    _assert_bitwise(got["params"], want["params"], "params")
    for name, moment in _moments(want["opt"]).items():
        _assert_bitwise(getattr(got["opt"], name), moment, name)
    assert int(got["opt"].step) == int(want["opt"].step) == 1


# ---------------------------------------------------------------------------
# the donating step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)      # AdamW, Adafactor
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["eager", "deferred"])
def test_donated_step_equals_the_functional_step_bit_for_bit(arch, dtype,
                                                             kind):
    """Three steps of the donating step from a copy of the same state: the
    parameters and the moments equal the functional step's bit for bit;
    the donated state's tensors are the ones it was given, updated in
    place, where the functional step leaves its input as it was."""
    pair = _pair(arch, 2, dtype)
    _, opt = _optimizers(arch)
    runs = {}
    for donate in (False, True):
        step = (_eager(pair, opt, donate) if kind == "eager"
                else _deferred_step(pair, opt, donate=donate))
        assert step.donates is donate
        state = dict(_state(pair, opt))
        if kind == "deferred":
            state["defer"] = step.init_defer_state(state["params"])
        state["params"] = pytree.tree_map(torch.clone, state["params"])
        first = pytree.tree_leaves(state["params"])
        before = [x.clone() for x in first]
        for batch in _stream(3, seed=7):
            state, _ = step(state, batch)
        after = pytree.tree_leaves(state["params"])
        assert all((a is b) is donate for a, b in zip(after, first))
        kept = all(torch.equal(a, b) for a, b in zip(first, before))
        assert kept is not donate
        runs[donate] = state
    _assert_bitwise(runs[True]["params"], runs[False]["params"], "params")
    for name, moment in _moments(runs[False]["opt"]).items():
        _assert_bitwise(getattr(runs[True]["opt"], name), moment, name)
    assert int(runs[True]["opt"].step) == int(runs[False]["opt"].step)


def test_driver_rewinds_a_poisoned_donating_step(tmp_path):
    """A donating step turns ``restore_on_nan`` on. Its poisoned step has
    overwritten the state (here: NaN parameters), so the driver restores
    the last checkpoint and skips the batch; without a checkpoint it
    raises."""
    pair = _pair("qwen3-moe-235b", 2)
    _, opt = _optimizers("qwen3-moe-235b")
    step = _eager(pair, opt, donate=True)
    batches = _stream(4, seed=8)

    def poisoned(state, batch):
        state, m = step(state, batch)
        if batch is batches[3]:
            for p in pytree.tree_leaves(state["params"]):
                p.fill_(float("nan"))
            m = dict(m, loss=torch.tensor(float("nan")))
        return state, m
    poisoned.donates = True

    def fresh():
        s = _state(pair, opt)
        return dict(s, params=pytree.tree_map(torch.clone, s["params"]))

    drv = TrainDriver(DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
                      poisoned, batches.__getitem__)
    assert drv.cfg.restore_on_nan
    state, end = drv.run(fresh(), 0, 4)
    assert end == 4
    assert [e["event"] for e in drv.events if e["event"] in (
        "nan_rollback", "restore")] == ["nan_rollback", "restore"]
    want = fresh()
    for batch in batches[:2]:
        want, _ = step(want, batch)
    _assert_bitwise(state["params"], want["params"], "rewound params")

    drv = TrainDriver(DriverConfig(ckpt_dir=str(tmp_path / "none"),
                                   ckpt_every=100), poisoned,
                      lambda i: batches[3])
    with pytest.raises(RuntimeError, match="no checkpoint to rewind to"):
        drv.run(fresh(), 0, 1)
    functional = TrainDriver(DriverConfig(ckpt_dir=str(tmp_path)),
                             _eager(pair, opt), None)
    assert not functional.cfg.restore_on_nan


# ---------------------------------------------------------------------------
# serving and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_model_ranks_equals_moe_apply(arch):
    """Prefill and 3 greedy decode steps through ``_serve_ffn`` with the
    MoE layers over 2 stacked model ranks: the logits of ``moe.apply``'s
    model (the same weights) to 1e-5."""
    a, b = _pair(arch, 2).tmodel, _pair(arch, None).tmodel
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, 512, (2, 12)).astype(np.int64))
    (la, ca), (lb, cb) = a.prefill(tokens, 16), b.prefill(tokens, 16)
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)
    for i in range(3):
        tok = lb.argmax(-1)
        (la, ca), (lb, cb) = (a.decode_step(tok, ca, 12 + i),
                              b.decode_step(tok, cb, 12 + i))
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)


def test_model_ranks_for_follows_the_jax_meshes():
    """``--model-ranks``: 1 for an ``"ep"`` config when not given (the host
    mesh's model axis), none for a ``"gshard"`` or dense config; refused
    where it does not split the experts or there are none."""
    full = tbase.get_config("qwen3-moe-235b")
    assert full.moe_impl == "ep"
    assert train.model_ranks_for(full, None) == 1
    assert train.model_ranks_for(full, 16) == 16
    assert train.model_ranks_for(tbase.get_smoke_config("kimi-k2-1t"),
                                 None) is None
    assert train.model_ranks_for(tbase.get_config("qwen1-5-0-5b"),
                                 None) is None
    for cfg, ranks in ((full, 3), (full, 0),
                       (tbase.get_config("qwen1-5-0-5b"), 2)):
        with pytest.raises(SystemExit):
            train.model_ranks_for(cfg, ranks)


def _cli(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-moe-235b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "4", "--seq", "16", "--merge-topology", PLAN,
         "--ckpt-dir", str(tmp_path), *flags],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_cli_trains_over_model_ranks_with_a_donating_step(tmp_path):
    out = _cli(tmp_path, "--model-ranks", "2", "--donate")
    assert out.returncode == 0, out.stderr
    m = re.search(r"^steps 0\.\.3: loss (\S+) -> (\S+)$", out.stdout, re.M)
    assert m, out.stdout
    assert all(np.isfinite(float(x)) for x in m.groups())


def test_cli_refuses_model_ranks_that_do_not_split_the_experts(tmp_path):
    out = _cli(tmp_path, "--model-ranks", "3")
    assert out.returncode != 0
    assert "--model-ranks 3 does not split" in out.stderr


def test_cli_layers_cuts_the_depth():
    args = train.parse_args(["--arch", "kimi-k2-1t", "--smoke", "--device",
                             "cpu", "--layers", "2", "--model-ranks", "2"])
    t = train.build(args)
    assert t.cfg.n_layers == 2 and t.model.n_scan == 1
    assert t.model.model_ranks == 2
    args.layers = 1                     # the dense first layer alone
    with pytest.raises(SystemExit, match="--layers 1"):
        train.build(args)
