"""The port's train steps on ``hymba-1.5b``'s smoke config against the JAX
package, over the two stacked ranks of ``chip:2`` that the card's run
uses: the eager step (the mean of JAX's per-rank gradients, one AdamW
step) under remat "none" and "dots", the deferred step with K = 2 against
the reference ``tests/test_torch_train.py`` composes from JAX pieces
(per-rank ``value_and_grad`` under ``vmap``, the cascades under
``vmap(axis_name=...)``, ``adamw``), the overlapped run's first landing
against the deferred commit, and the CLI's smoke run. Sequences of 40
tokens run past the smoke config's window of 16. The tolerances are that
file's (f32: 1e-5)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import steps
from repro_torch.models.hymba import HymbaModel
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from test_torch_train import (LR, TOL, Pair, _adamw, _assert_trees_close,
                              _flat_jax, _flat_torch, _jax_deferred_run)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "hymba-1-5b"
PLAN, DEFER_PLAN, K = "chip:2", "chip:2:defer", 2
BATCH, SEQ = 4, 40                      # 2 rows a rank, past the window


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(remat="none") -> Pair:
    if remat not in _PAIRS:
        _PAIRS[remat] = Pair("float32", remat=remat, arch=ARCH)
        assert isinstance(_PAIRS[remat].tmodel, HymbaModel)
    return _PAIRS[remat]


def _stream(n, seed):
    cfg = jpipe.DataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH,
                           seed=seed)
    return [jpipe.batch_at(cfg, t) for t in range(n)]


def _deferred_step(pair, opt, overlap):
    return steps.make_train_step(
        pair.tmodel, pair.tcfg, opt,
        merge_topology=MergePlan.parse(DEFER_PLAN, lane_parallel=overlap),
        defer_schedule=DeferSchedule(level_names=("chip",), intervals=(K,),
                                     overlap=overlap))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_hymba_eager_step_is_the_mean_of_rank_gradients(remat):
    pair = _pair(remat)
    jopt_, topt_ = (_adamw(jopt, jsched.constant(LR)),
                    _adamw(topt, tsched.constant(LR)))
    step = steps.make_train_step(pair.tmodel, pair.tcfg, topt_,
                                 merge_topology=MergePlan.parse(PLAN))
    batch = _stream(1, seed=2)[0]
    params = pair.tparams()
    ts, tm = step({"params": params, "opt": topt_.init(params)}, batch)
    loss, grads = pair.jax_rank_grads(pair.jparams, batch, dp=2)
    mean = jax.tree.map(lambda g: g.sum(0) / 2, grads)
    jparams, jstate, _ = jopt_.step(pair.jparams, mean,
                                    jopt_.init(pair.jparams))
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=TOL)
    _assert_trees_close(_flat_torch(ts["params"]), _flat_jax(jparams),
                        atol=TOL, what="params")
    _assert_trees_close(_flat_torch(ts["opt"].mu), _flat_jax(jstate.mu),
                        what="mu")


def test_hymba_deferred_step_matches_the_composed_jax_reference():
    """K = 2 over 3 steps: a commit at step 2, then a partial cycle that
    the flush settles."""
    pair = _pair()
    jopt_, topt_ = (_adamw(jopt, jsched.constant(LR)),
                    _adamw(topt, tsched.constant(LR)))
    batches = _stream(3, seed=3)
    hist, jfinal = _jax_deferred_run(
        pair, DEFER_PLAN, JDeferSchedule(level_names=("chip",),
                                         intervals=(K,)), batches, jopt_)
    step = _deferred_step(pair, topt_, overlap=False)
    assert step.dp == 2
    params = pair.tparams()
    state = {"params": params, "opt": topt_.init(params),
             "defer": step.init_defer_state(params)}
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


def test_hymba_overlapped_first_landing_is_the_deferred_commit():
    """The overlapped run lands its first cycle at step K + 1 on the same
    gradients, through the same operations, as the deferred run commits it
    at step K: parameters and AdamW's moments equal bit for bit."""
    pair = _pair()
    topt_ = _adamw(topt, tsched.constant(LR))
    batches = _stream(K + 1, seed=4)
    runs = {}
    for overlap, n in ((False, K), (True, K + 1)):
        step = _deferred_step(pair, topt_, overlap)
        params = pair.tparams()
        state = {"params": params, "opt": topt_.init(params),
                 "defer": step.init_defer_state(params)}
        for batch in batches[:n]:
            state, _ = step(state, batch)
        runs[overlap] = state
    want, got = runs[False], runs[True]
    for (k, g), (_, w) in zip(_flat_torch(got["params"]).items(),
                              _flat_torch(want["params"]).items()):
        assert np.array_equal(g, w), k
    for moment in ("mu", "nu"):
        for (k, g), (_, w) in zip(
                _flat_torch(getattr(got["opt"], moment)).items(),
                _flat_torch(getattr(want["opt"], moment)).items()):
            assert np.array_equal(g, w), f"{moment} {k}"
    assert int(got["opt"].step) == int(want["opt"].step) == 1


def test_hymba_cli_smoke_run_ends_with_a_finite_loss(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "64", "--merge-topology", "chip:2:defer", "--merge-defer",
         "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    m = re.search(r"^steps 0\.\.2: loss (\S+) -> (\S+)$", out.stdout, re.M)
    assert m, out.stdout
    assert all(np.isfinite(float(x)) for x in m.groups())
