"""The port's elastic restore, chaos harness and ``restore_resharded``
against the JAX package's.

* ``run_plain`` of the same integer toy in both packages: params and fold
  count bitwise, with and without overlap.
* Overlapped toy checkpoints at t = 4 (a launched cycle not yet landed) and
  t = 5 (mid-cycle), written by either package and resolved by both onto
  another plan: params and count bitwise, the same ``RestoreReport`` and
  the same logged records.
* A small dense LM (the qwen1.5-0.5b smoke config in f32, 8 stacked ranks,
  K = 4 on two deferred levels) checkpointed at t = 6 by the port's
  ``DeferredTrainStep`` and ``TrainDriver``, resolved onto 4 ranks by the
  port and by JAX's ``elastic_restore`` (JAX's ``adamw``, a shim step with
  JAX's manifest and defer spec): params, mu and nu to 1e-5 of each leaf's
  largest plus 1e-5 relative (the two AdamW implementations round their
  norms and square roots apart; the settled gradients are the same f32
  sums in the same order). The port's resolve also equals its own
  verbatim restore plus flush (the cascade sums in another order) to the
  same bound, and a mutant checkpoint whose pendings are zeroed fails both.
* ``restore_resharded`` onto a device; the refusals.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import defer_state as jdefer_state
from repro.core import merge_functions as jmf
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.core.merge_plan import MergePlan as JMergePlan
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.runtime import DriverConfig as JDriverConfig
from repro.runtime import TrainDriver as JTrainDriver
from repro.runtime import chaos as jchaos
from repro.runtime import elastic as jelastic
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.core.ccache import deferred_stages_of
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_functions import ADD
from repro_torch.core.merge_plan import MergePlan
from repro_torch.data.pipeline import batch_at, data_config_for
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.runtime import DriverConfig, TrainDriver, chaos, elastic

DP = 8
PLAN2 = "chip:2,host:2:defer,pod:2:defer"   # strides (2, 4)
PLAN1 = "chip:4,pod:2:defer"                # stride (4)
RESOLVED = {"resume", "elastic_restore", "elastic_settle"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _records(events) -> list:
    """The driver's resume records without their time stamps."""
    return [{k: v for k, v in e.items() if k != "t"} for e in events
            if e["event"] in RESOLVED]


# ---------------------------------------------------------------------------
# the integer toy across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
def test_run_plain_equals_jax(overlap):
    step, bf, st0 = chaos.toy_factory(PLAN2, (1, 2), DP, width=16,
                                      overlap=overlap, device="cpu")()
    got = chaos.run_plain(step, bf, 7, state=st0, flush=True)
    jstep, jbf, jst0 = jchaos.toy_factory(PLAN2, (1, 2), DP, width=16,
                                          overlap=overlap)()
    want = jchaos.run_plain(jstep, jbf, 7, state=jst0, flush=True)
    assert got["params"]["w"].dtype == torch.int32
    np.testing.assert_array_equal(_np(got["params"]["w"]),
                                  _np(want["params"]["w"]))
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) > 0
    # the whole state, the defer tree included, leaf by leaf
    assert chaos.trees_bitwise_equal(
        dict(_flatten_with_paths(got)),
        {k: np.array(v)
         for k, v in jckpt.checkpoint._flatten_with_paths(want)})


def _write_toy(writer: str, d: str, t: int):
    """An overlapped PLAN2 toy run of ``t`` steps checkpointed at ``t`` by
    ``writer``'s own step and driver."""
    if writer == "port":
        step, bf, st0 = chaos.toy_factory(PLAN2, (1, 2), DP, width=4,
                                          overlap=True, device="cpu")()
        TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=t), step, bf,
                    defer_step=step).run(st0, 0, t)
    else:
        step, bf, st0 = jchaos.toy_factory(PLAN2, (1, 2), DP, width=4,
                                           overlap=True)()
        JTrainDriver(JDriverConfig(ckpt_dir=d, ckpt_every=t), step, bf,
                     defer_step=step).run(st0, 0, t)


@pytest.mark.parametrize("t", [4, 5])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_toy_resolve_equals_jax(tmp_path, writer, t):
    d = str(tmp_path)
    _write_toy(writer, d, t)
    step, bf, like = chaos.toy_factory(PLAN1, (3,), DP, width=4,
                                       device="cpu")()
    drv = TrainDriver(DriverConfig(ckpt_dir=d), step, bf, defer_step=step)
    got, start, report = drv.resume(like)
    jstep, jbf, jlike = jchaos.toy_factory(PLAN1, (3,), DP, width=4)()
    jdrv = JTrainDriver(JDriverConfig(ckpt_dir=d), jstep, jbf,
                        defer_step=jstep)
    want, jstart, jreport = jdrv.resume(jlike)
    assert report.action == "resolved" and start == jstart == t
    assert report.landed_inflight == (t == 4)
    assert report.as_dict() == jreport.as_dict()
    assert _records(drv.events) == _records(jdrv.events)
    np.testing.assert_array_equal(_np(got["params"]["w"]),
                                  _np(want["params"]["w"]))
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    assert set(report.seconds) >= {"load", "place", "settle", "fold",
                                   "total"}


# ---------------------------------------------------------------------------
# a small dense LM: the port's deferred run, resolved by both packages
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ, LM_LR, LM_STEPS, EPS = 8, 16, 1e-3, 12, 1e-3


def _lm_optimizers():
    """AdamW under the same schedule in both packages (``eps`` 1e-3: see
    ``tests/test_torch_train.py``)."""
    return (topt.adamw(tsched.warmup_cosine(LM_LR, 2, LM_STEPS), eps=EPS),
            jopt.adamw(jsched.warmup_cosine(LM_LR, 2, LM_STEPS), eps=EPS))


def _lm_step(model, opt, plan: str, k: int):
    plan = MergePlan.parse(plan)
    dp = plan.num_ranks
    names = tuple(s.name for s in deferred_stages_of(plan, dp,
                                                     merge_fn=ADD))
    return steps.make_train_step(model, model.cfg, opt, dp=dp,
                                 merge_topology=plan,
                                 defer_schedule=DeferSchedule.fixed(k, names))


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The port's 8-rank K = 4 run checkpointed at t = 6, its mutant with
    the pendings zeroed, and the 4-rank K = 2 step to resolve onto."""
    root = tmp_path_factory.mktemp("lm")
    cfg = dataclasses.replace(get_smoke_config("qwen1-5-0-5b"),
                              dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    dcfg = data_config_for(cfg, ShapeConfig("t", LM_SEQ, LM_BATCH, "train"),
                           seed=0)
    opt, _ = _lm_optimizers()
    old = _lm_step(model, opt, PLAN2, 4)
    params = model.params()
    state = {"params": params, "opt": opt.init(params),
             "defer": old.init_defer_state(params)}
    d = str(root / "ckpt")
    TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=6), old,
                lambda i: batch_at(dcfg, i), defer_step=old).run(state, 0, 6)
    raw, manifest = ckpt.load_raw(d)
    assert int(raw["defer/t"]) == 6 and manifest["extras"]["defer_t"] == 6
    assert any(np.abs(v).max() > 0 for k, v in raw.items()
               if k.startswith("defer/pending/0/"))
    mutant = str(root / "mutant")
    shutil.copytree(d, mutant)
    zeroed = {k: (np.zeros_like(v) if k.startswith("defer/pending/") else v)
              for k, v in raw.items()}
    np.savez(os.path.join(mutant, "step_00000006", "arrays.npz"), **zeroed)
    new = _lm_step(model, opt, "chip:2,host:2:defer", 2)
    like = {"params": params, "opt": opt.init(params),
            "defer": new.init_defer_state(params)}
    return {"dir": d, "mutant": mutant, "model": model, "old": old,
            "new": new, "like": like}


class _JaxShimStep:
    """The durability surface JAX's ``elastic_restore`` reads of a deferred
    step: the 4-rank plan's manifest and fresh defer state, from JAX's own
    ``defer_manifest`` and ``defer_state_spec``."""

    def __init__(self):
        plan = JMergePlan.parse("chip:2,host:2:defer")
        self.sched = JDeferSchedule(("host",), (2,))
        self.plan, self.dp = plan, 4

    def durability_manifest(self):
        return jdefer_state.defer_manifest(self.plan, self.sched, self.dp,
                                           jmf.ADD, (2,), "mean")

    def init_defer_state(self, params):
        spec = jdefer_state.defer_state_spec(
            jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                         params), 1, self.dp, False)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)


def _jax_resolve(ckpt_dir: str, lm) -> dict:
    _, jadamw = _lm_optimizers()
    jparams = jax.tree.map(lambda p: jnp.asarray(_np(p)), lm["like"]["params"])
    shim = _JaxShimStep()
    jlike = {"params": jparams, "opt": jadamw.init(jparams),
             "defer": shim.init_defer_state(jparams)}
    state, _, report = jelastic.elastic_restore(
        ckpt_dir, jlike, defer_step=shim, optimizer=jadamw)
    assert report.action == "resolved" and report.flushed_steps == 2
    return state


def _port_resolve(ckpt_dir: str, lm):
    new = lm["new"]
    drv = TrainDriver(DriverConfig(ckpt_dir=ckpt_dir), new, None,
                      defer_step=new)
    state, start, report = drv.resume(lm["like"])
    assert start == 6
    return state, report


def _flat(state) -> dict:
    """params, mu and nu by key path, as numpy."""
    opt = state["opt"]
    out = {}
    for name, tree in (("params", state["params"]), ("mu", opt.mu),
                       ("nu", opt.nu)):
        for k, v in _flatten_with_paths(tree):
            out[f"{name}/{k}"] = _np(v).astype(np.float32)
    return out


def _flat_jax(state) -> dict:
    opt = state["opt"]
    out = {}
    for name, tree in (("params", state["params"]), ("mu", opt.mu),
                       ("nu", opt.nu)):
        for k, v in jckpt.checkpoint._flatten_with_paths(tree):
            out[f"{name}/{k}"] = np.asarray(v, np.float32)
    return out


def _close(got: dict, want: dict, tol: float = 1e-5) -> bool:
    """Every leaf within ``tol`` relative plus ``tol`` of its largest."""
    assert sorted(got) == sorted(want)
    return all(np.allclose(got[k], want[k], rtol=tol,
                           atol=tol * float(np.abs(want[k]).max(initial=0)))
               for k in want)


def test_dense_lm_resolve_equals_jax_and_the_flush(lm):
    state, report = _port_resolve(lm["dir"], lm)
    assert report.as_dict() == {
        "action": "resolved", "step": 6, "flushed_steps": 2,
        "landed_inflight": False, "k_old": 4, "k_new": 2, "events": []}
    assert int(state["defer"]["t"]) == 0
    assert len(state["defer"]["pending"]) == 1
    assert all(not p.any() for p in
               torch.utils._pytree.tree_leaves(state["defer"]["pending"]))
    assert all(p.shape[0] == 4 for p in
               torch.utils._pytree.tree_leaves(state["defer"]["pending"]))
    got = _flat(state)
    assert _close(got, _flat_jax(_jax_resolve(lm["dir"], lm)))
    # the oracle: the same checkpoint verbatim on the old plan, flushed
    old = lm["old"]
    like = dict(lm["like"], defer=old.init_defer_state(lm["like"]["params"]))
    verbatim, start, vreport = TrainDriver(
        DriverConfig(ckpt_dir=lm["dir"]), old, None,
        defer_step=old).resume(like)
    assert vreport.action == "verbatim" and start == 6
    oracle, metrics = old.flush(verbatim)
    assert metrics["flushed_steps"] == 2
    assert int(state["opt"].step) == int(oracle["opt"].step) == 2
    assert _close(got, _flat(oracle))


def test_dense_lm_resolve_without_the_pendings_fails_both(lm):
    """The mutant's pendings are zeroed: its resolve must fail against the
    true checkpoint's JAX resolve and against its flush."""
    mutant, _ = _port_resolve(lm["mutant"], lm)
    got = _flat(mutant)
    assert not _close(got, _flat_jax(_jax_resolve(lm["dir"], lm)))
    old = lm["old"]
    like = dict(lm["like"], defer=old.init_defer_state(lm["like"]["params"]))
    verbatim, _, _ = TrainDriver(DriverConfig(ckpt_dir=lm["dir"]), old, None,
                                 defer_step=old).resume(like)
    oracle, _ = old.flush(verbatim)
    assert not _close(got, _flat(oracle))


# ---------------------------------------------------------------------------
# restore_resharded and the refusals
# ---------------------------------------------------------------------------


def _saved_tree(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(0, 1, 5).to(torch.bfloat16),
                  "d": np.float32(2.5)}}
    ckpt.save(str(tmp_path), 3, tree, extras={"next_step": 3})
    return tree


def test_restore_resharded_places_every_leaf_on_the_target(tmp_path):
    tree = _saved_tree(tmp_path)
    # the template has no storage: every leaf comes from the checkpoint
    like = {"a": torch.empty((2, 3), dtype=torch.int32, device="meta"),
            "b": {"c": torch.empty(5, dtype=torch.bfloat16, device="meta"),
                  "d": 0.0}}
    for device in ("cpu", torch.device("cpu"),
                   {"a": "cpu", "b": {"c": "cpu", "d": torch.device("cpu")}}):
        got, extras = ckpt.restore_resharded(str(tmp_path), like, device)
        assert extras == {"next_step": 3}
        for (k, g), (_, w) in zip(_flatten_with_paths(got),
                                  _flatten_with_paths(tree)):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu", k
            w = torch.as_tensor(w)
            assert g.dtype == w.dtype and torch.equal(g, w), k
    with pytest.raises(ValueError, match="target device"):
        ckpt.restore_resharded(str(tmp_path), like, {"a": "cpu"})


def test_restore_resharded_refuses_a_missing_key(tmp_path):
    _saved_tree(tmp_path)
    with pytest.raises(KeyError, match="missing keys"):
        ckpt.restore_resharded(str(tmp_path), {"a": torch.zeros(2, 3),
                                               "z": torch.zeros(1)}, "cpu")


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    step, bf, like = chaos.toy_factory(PLAN1, (3,), DP, width=4,
                                       device="cpu")()
    drv = TrainDriver(DriverConfig(ckpt_dir=str(tmp_path / "none")), step,
                      bf, defer_step=step)
    state, start, report = drv.resume(like)
    assert state is like and start == 0 and report is None
    assert not drv.events


def test_a_legacy_checkpoint_of_another_shape_is_refused(tmp_path):
    """Defer state without a durability manifest restores only into the
    tree it came from; another rank count raises in both packages."""
    step, bf, st0 = chaos.toy_factory(PLAN2, (1, 2), DP, width=4,
                                      device="cpu")()
    st, _ = step(st0, bf(0))
    ckpt.save(str(tmp_path), 1, st, extras={"next_step": 1})
    step4, _, like4 = chaos.toy_factory("chip:2,pod:2:defer", (2,), 4,
                                        width=4, device="cpu")()
    with pytest.raises(ValueError, match="no durability manifest"):
        elastic.elastic_restore(str(tmp_path), like4, defer_step=step4,
                                optimizer=step4.optimizer)
    jstep4, _, jlike4 = jchaos.toy_factory("chip:2,pod:2:defer", (2,), 4,
                                           width=4)()
    with pytest.raises(ValueError, match="no durability manifest"):
        jelastic.elastic_restore(str(tmp_path), jlike4, defer_step=jstep4,
                                 optimizer=jstep4.optimizer)
    # the same tree restores verbatim
    state, _, report = elastic.elastic_restore(str(tmp_path), st0,
                                               defer_step=None)
    assert report.action == "verbatim"
    assert chaos.trees_bitwise_equal(state, st)


def test_outstanding_mass_without_an_optimizer_is_refused(tmp_path):
    _write_toy("port", str(tmp_path), 5)
    step, _, like = chaos.toy_factory(PLAN1, (3,), DP, width=4,
                                      device="cpu")()
    with pytest.raises(ValueError, match="pass optimizer="):
        elastic.elastic_restore(str(tmp_path), like, defer_step=step,
                                optimizer=None)
