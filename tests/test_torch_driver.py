"""The port's fault-tolerant train driver and train checkpoints.

Twins of the JAX package's driver tests (``tests/test_substrates.py``):
two-phase checkpoints and their garbage collection, NaN skip-batch (with
and without the rewind to the last checkpoint), retries, stragglers and
preemption; both ``defer_save`` policies on a deferred step; a preempted
deferred run that resumes bitwise; and a train checkpoint written by
either package restored by the other.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import defer_state as jdefer_state
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import checkpoint as ckpt
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_functions import ADD
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import steps
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.runtime import DriverConfig, TrainDriver

DP = 4
PLAN = "chip:2,pod:2:defer"


def _mk_driver(d, step_fn, ckpt_every=2, **kw):
    return TrainDriver(
        DriverConfig(ckpt_dir=d, ckpt_every=ckpt_every, max_retries=2,
                     retry_backoff_s=0.0, **kw),
        step_fn=step_fn, batch_fn=lambda i: {"i": i})


def _x(v=0.0):
    return {"x": torch.tensor(v)}


def test_checkpoint_two_phase_commit_and_gc(tmp_path):
    d = str(tmp_path)
    step = lambda s, b: ({"x": s["x"] + 1}, {"loss": 1.0 / (b["i"] + 1)})
    drv = _mk_driver(d, step, keep_last=2)
    state, end = drv.run(_x(), 0, 6)
    assert end == 6 and float(state["x"]) == 6
    assert ckpt.latest_step(d) == 6
    kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert kept == ["step_00000004", "step_00000006"]
    out, extras = ckpt.restore(d, _x())
    assert float(out["x"]) == 6 and extras == {"next_step": 6}
    out, _ = ckpt.restore(d, _x(), step=4)
    assert float(out["x"]) == 4
    # a stale .tmp dir is never visible
    os.makedirs(os.path.join(d, "step_00000008.tmp"))
    assert ckpt.latest_step(d) == 6
    assert [e["step"] for e in drv.events if e["event"] == "checkpoint"] == \
        [2, 4, 6]


def test_restore_refuses_a_tree_the_checkpoint_lacks(tmp_path):
    ckpt.save(str(tmp_path), 1, _x())
    with pytest.raises(KeyError, match="missing keys"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(()),
                                     "y": torch.zeros(())})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _x())


@pytest.mark.parametrize("restore_on_nan", [False, True])
def test_driver_nan_rollback_skips_batch(tmp_path, restore_on_nan):
    def step(s, b):
        loss = float("nan") if b["i"] == 3 else 0.5
        return {"x": s["x"] + 1}, {"loss": loss}
    drv = _mk_driver(str(tmp_path), step, restore_on_nan=restore_on_nan)
    state, end = drv.run(_x(), 0, 6)
    events = [e["event"] for e in drv.events]
    assert "nan_rollback" in events
    assert ("restore" in events) == restore_on_nan
    assert end == 6
    # the poisoned step did not advance the state: one batch skipped; with
    # the rewind, the state also went back to step 2's checkpoint
    assert float(state["x"]) == (4 if restore_on_nan else 5)


def test_driver_gives_up_after_too_many_poisoned_batches(tmp_path):
    drv = _mk_driver(str(tmp_path), lambda s, b: (s, {"loss": float("inf")}),
                     max_skipped_batches=2)
    with pytest.raises(RuntimeError, match="too many poisoned"):
        drv.run(_x(), 0, 5)


def test_driver_retries_transient_errors(tmp_path):
    calls = {"n": 0}

    def step(s, b):
        calls["n"] += 1
        if b["i"] == 1 and calls["n"] < 3:
            raise RuntimeError("transient")
        return s, {"loss": 1.0}
    drv = _mk_driver(str(tmp_path), step)
    _, end = drv.run(_x(), 0, 3)
    assert end == 3
    assert sum(e["event"] == "step_error" for e in drv.events) == 1


def test_driver_raises_past_its_retries(tmp_path):
    def step(s, b):
        raise RuntimeError("hard")
    drv = _mk_driver(str(tmp_path), step)
    with pytest.raises(RuntimeError, match="hard"):
        drv.run(_x(), 0, 3)
    assert sum(e["event"] == "step_error" for e in drv.events) == 3


def test_driver_straggler_detection(tmp_path):
    import time as _t

    def step(s, b):
        if b["i"] == 12:
            _t.sleep(0.25)
        return s, {"loss": 1.0}
    drv = _mk_driver(str(tmp_path), step, ckpt_every=100)
    drv.run(_x(), 0, 14)
    stragglers = {e["step"]: e for e in drv.events
                  if e["event"] == "straggler"}
    assert 12 in stragglers and stragglers[12]["host"] == 0


def test_driver_preemption_saves_and_exits(tmp_path):
    d = str(tmp_path)
    drv = _mk_driver(d, lambda s, b: (s, {"loss": 1.0}), ckpt_every=100)
    orig = drv.batch_fn

    def batch_fn(i):
        if i == 3:
            drv._preempted = True    # what the SIGTERM handler does
        return orig(i)
    drv.batch_fn = batch_fn
    _, end = drv.run(_x(), 0, 10)
    assert end == 4                  # stopped at the next boundary
    assert ckpt.latest_step(d) == 4  # state saved before exit


def test_driver_config_refuses_an_unknown_defer_save():
    with pytest.raises(ValueError, match="defer_save"):
        DriverConfig(ckpt_dir="x", defer_save="sometimes")


# ---------------------------------------------------------------------------
# deferred state under both durability policies
# ---------------------------------------------------------------------------


def _toy_step(overlap=False, k=3):
    """A deferred step over a quadratic loss: rank r's gradient of batch i
    is ``w - target(i, r)``, so every step adds fresh gradient mass."""
    plan = MergePlan.parse(PLAN)

    def grads_of(params, batch):
        i = int(batch["i"][0])
        target = torch.arange(3, dtype=torch.float32) * (i + 1) + batch[
            "r"].float().sum()
        g = params["w"] - target
        return (g * g).sum(), {"w": g}

    opt = topt.adamw(tsched.constant(1e-2))
    step = steps._make_deferred_train_step(
        grads_of, opt, plan, False, DeferSchedule.fixed(k, ("pod",),
                                                        overlap=overlap),
        DP, ADD)
    params = {"w": torch.zeros(3)}
    state = {"params": params, "opt": opt.init(params),
             "defer": step.init_defer_state(params)}
    batch_fn = lambda i: {"i": np.full((DP,), i), "r": np.arange(DP)}
    return step, state, batch_fn


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v)
            for k, v in ckpt.checkpoint._flatten_with_paths(tree)}


@pytest.mark.parametrize("overlap", [False, True])
def test_defer_save_checkpoint_policy_keeps_the_cascade(tmp_path, overlap):
    """K = 2, a checkpoint every 3 steps: step 3's is mid-cycle (mass in the
    pending), step 6's follows a full commit (overlapped: launched, its
    landing still due)."""
    step, state, batch_fn = _toy_step(overlap, k=2)
    d = str(tmp_path)
    drv = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=3), step, batch_fn,
                      defer_step=step)
    state, end = drv.run(state, 0, 6)
    for at, land in ((3, False), (6, overlap)):
        saved, extras = ckpt.restore(d, state, step=at)
        assert extras["defer"] == step.durability_manifest()
        assert extras["defer_t"] == at and extras["next_step"] == at
        assert extras["defer_land_pending"] == land
        keys = set(ckpt.tree_keys(saved))
        assert {"defer/t", "defer/pending/0/w"} <= keys
        assert ("defer/inflight/w" in keys) == overlap
        assert int(saved["defer"]["t"]) == at
        assert bool(saved["defer"]["pending"][0]["w"].any()) == (at == 3)
        if overlap:
            assert bool(saved["defer"]["inflight"]["w"].any()) == land
    policies = {e["policy"] for e in drv.events if e["event"] == "defer_save"}
    assert policies == {"checkpoint"}


@pytest.mark.parametrize("overlap", [False, True])
def test_a_preempted_deferred_run_resumes_bitwise(tmp_path, overlap):
    """Stop at a boundary mid-cycle, restore through ``checkpoint.restore``
    and run on: the same bits as the uninterrupted run."""
    step, state0, batch_fn = _toy_step(overlap)
    ref, _ = TrainDriver(DriverConfig(ckpt_dir=str(tmp_path / "a"),
                                      ckpt_every=100), step, batch_fn,
                         defer_step=step).run(state0, 0, 8)
    d = str(tmp_path / "b")
    drv = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=100), step,
                      batch_fn, defer_step=step)
    orig = drv.batch_fn

    def preempt_at_4(i):
        if i == 4:
            drv._preempted = True
        return orig(i)
    drv.batch_fn = preempt_at_4
    _, end = drv.run(state0, 0, 8)
    assert end == 5
    state, extras = ckpt.restore(d, state0)
    assert extras["next_step"] == 5
    assert ckpt.manifests_compatible(extras["defer"],
                                     step.durability_manifest())
    state, _ = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=100), step,
                           batch_fn, defer_step=step).run(state, 5, 3)
    want, got = _flat(ref), _flat(state)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("overlap", [False, True])
def test_defer_save_flush_policy_drains_before_saving(tmp_path, overlap):
    step, state, batch_fn = _toy_step(overlap)
    d = str(tmp_path)
    drv = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=2,
                                   defer_save="flush"), step, batch_fn,
                      defer_step=step)
    state, end = drv.run(state, 0, 5)
    saved, extras = ckpt.restore(d, state)
    assert int(saved["defer"]["t"]) == 0
    assert not saved["defer"]["pending"][0]["w"].any()
    if overlap:
        assert not saved["defer"]["inflight"]["w"].any()
    assert extras["defer_t"] == 0 and not extras["defer_land_pending"]
    flushes = [e for e in drv.events if e["event"] == "defer_flush_before_save"]
    assert [e["step"] for e in flushes] == [2, 4]
    assert all(e["flushed"] for e in flushes)
    assert {e["policy"] for e in drv.events
            if e["event"] == "defer_save"} == {"flush"}
    # the saved params carry every step's mass: AdamW on the mean gradient
    # of steps 0-1, then of steps 2-3 (each flush settles its partial cycle)
    opt = topt.adamw(tsched.constant(1e-2))
    w = torch.zeros(3)
    ost = opt.init({"w": w})
    for cycle in ((0, 1), (2, 3)):
        g = sum(w - (torch.arange(3.0) * (i + 1) + r)
                for i in cycle for r in range(DP)) / (len(cycle) * DP)
        upd, ost, _ = opt.step({"w": w}, {"w": g}, ost)
        w = upd["w"]
    torch.testing.assert_close(saved["params"]["w"], w, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# a train checkpoint across the two packages
# ---------------------------------------------------------------------------


def _jax_train_state(rng):
    """A JAX train state (bf16 params, AdamW moments, a defer cascade with
    an in-flight buffer) filled with numpy noise."""
    params = {"embed": {"table": rng.standard_normal((6, 4))},
              "blocks": {"w": rng.standard_normal((2, 4, 4)),
                         "b": rng.standard_normal((2, 4))}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    opt = jopt.adamw(jsched.constant(1e-3))
    st = opt.init(params)
    st = st._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda m: m + 1.5, st.mu),
                     nu=jax.tree.map(lambda m: m + 0.25, st.nu))
    spec = jdefer_state.defer_state_spec(
        jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                     params), 2, DP, True)
    defer = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), spec)
    defer["t"] = jnp.asarray(5, jnp.int32)
    return {"params": params, "opt": st, "defer": defer}


def _torch_like(jstate):
    def leaf(a):
        a = np.asarray(a)
        t = torch.zeros(a.shape, dtype=torch.float32)
        if a.dtype == ml_dtypes.bfloat16:
            return t.to(torch.bfloat16)
        return t.to(getattr(torch, str(a.dtype)))
    st = jstate["opt"]
    return {"params": jax.tree.map(leaf, jstate["params"]),
            "opt": topt.OptState(step=leaf(st.step),
                                 mu=jax.tree.map(leaf, st.mu),
                                 nu=jax.tree.map(leaf, st.nu)),
            "defer": {"t": leaf(jstate["defer"]["t"]),
                      "pending": tuple(jax.tree.map(leaf, p) for p in
                                       jstate["defer"]["pending"]),
                      "inflight": jax.tree.map(leaf,
                                               jstate["defer"]["inflight"])}}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def test_a_train_checkpoint_loads_in_the_other_package(tmp_path):
    jstate = _jax_train_state(np.random.default_rng(0))
    like = _torch_like(jstate)
    assert sorted(ckpt.tree_keys(like)) == sorted(jckpt.tree_keys(jstate))
    extras = {"next_step": 5, "defer_t": 5}
    # JAX writes, the port restores
    jckpt.save(str(tmp_path / "j"), 5, jstate, extras=extras)
    got, got_extras = ckpt.restore(str(tmp_path / "j"), like)
    assert got_extras == extras
    assert isinstance(got["opt"], topt.OptState)
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    want = dict(jckpt.checkpoint._flatten_with_paths(jstate))
    for k, v in ckpt.checkpoint._flatten_with_paths(got):
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)
    # the port writes, JAX restores
    ckpt.save(str(tmp_path / "t"), 5, got, extras=extras)
    back, back_extras = jckpt.restore(str(tmp_path / "t"), jstate)
    assert back_extras == extras
    for k, v in jckpt.checkpoint._flatten_with_paths(back):
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)
