"""The port's train steps on ``xlstm-125m``'s smoke config against the
JAX package: the eager explicit step over 8 stacked ranks (the mean of
JAX's per-rank gradients, one AdamW step), and the deferred and overlapped
steps against the reference ``tests/test_torch_train.py`` composes from
JAX pieces (per-rank ``value_and_grad`` under ``vmap``, the cascades under
``vmap(axis_name=...)``, ``adamw``), since JAX's own
``make_train_step(mesh=...)`` does not run on this container's jax. The
tolerances are that file's (f32: 1e-5)."""

import jax
import numpy as np
import pytest
import torch

from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import steps
from repro_torch.models.xlstm_lm import XLSTMModel
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from test_torch_train import (DP, LR, TOL, Pair, _adamw, _assert_trees_close,
                              _flat_jax, _flat_torch, _jax_deferred_run,
                              _stream)


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xlstm():
    pair = Pair("float32", arch="xlstm-125m")
    assert isinstance(pair.tmodel, XLSTMModel)
    return pair


def test_xlstm_eager_step_is_the_mean_of_rank_gradients(xlstm):
    plan = MergePlan.parse("chip:2,host:2,pod:2")
    jopt_, topt_ = (_adamw(jopt, jsched.constant(LR)),
                    _adamw(topt, tsched.constant(LR)))
    step = steps.make_train_step(xlstm.tmodel, xlstm.tcfg, topt_,
                                 merge_topology=plan)
    batch = _stream(1, seed=2)[0]
    params = xlstm.tparams()
    ts, tm = step({"params": params, "opt": topt_.init(params)}, batch)
    loss, grads = xlstm.jax_rank_grads(xlstm.jparams, batch)
    mean = jax.tree.map(lambda g: g.sum(0) / DP, grads)
    jparams, jstate, _ = jopt_.step(xlstm.jparams, mean,
                                    jopt_.init(xlstm.jparams))
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=TOL)
    _assert_trees_close(_flat_torch(ts["params"]), _flat_jax(jparams),
                        atol=TOL, what="params")
    _assert_trees_close(_flat_torch(ts["opt"].mu), _flat_jax(jstate.mu),
                        what="mu")


@pytest.mark.parametrize("spec,intervals,overlap,n", [
    ("chip:2,host:2,pod:2:defer", (2,), True, 5),       # the chaos run's
    ("chip:2,host:2:defer,pod:2:defer", (1, 2), False, 3),
], ids=["ovl-2-5steps", "def-1x2-3steps"])
def test_xlstm_deferred_step_matches_the_composed_jax_reference(
        xlstm, spec, intervals, overlap, n):
    names = tuple(lv.name for lv in MergePlan.parse(spec).levels
                  if lv.defer)
    jopt_, topt_ = (_adamw(jopt, jsched.constant(LR)),
                    _adamw(topt, tsched.constant(LR)))
    batches = _stream(n, seed=3)
    hist, jfinal = _jax_deferred_run(
        xlstm, spec, JDeferSchedule(level_names=names, intervals=intervals,
                                    overlap=overlap), batches, jopt_)
    step = steps.make_train_step(
        xlstm.tmodel, xlstm.tcfg, topt_,
        merge_topology=MergePlan.parse(spec, lane_parallel=overlap),
        defer_schedule=DeferSchedule(level_names=names, intervals=intervals,
                                     overlap=overlap))
    params = xlstm.tparams()
    state = {"params": params, "opt": topt_.init(params),
             "defer": step.init_defer_state(params)}
    for t, (batch, (jloss, jparams, _, _)) in enumerate(zip(batches, hist),
                                                        start=1):
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=TOL)
        _assert_trees_close(_flat_torch(state["params"]), jparams, atol=TOL,
                            what=f"step {t}")
    state, _ = step.flush(state)
    _assert_trees_close(_flat_torch(state["params"]), jfinal, atol=TOL,
                        what="flushed")
