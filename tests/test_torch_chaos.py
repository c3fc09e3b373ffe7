"""The port's chaos harness (repro_torch.runtime.chaos): every case of the
JAX package's ``tests/test_chaos.py`` with the same asserts, on the CPU.

The toy step is an integer (int32 ADD) twin of ``DeferredTrainStep``
running the port's *real* ``defer_cascade``/``overlap_cascade`` over 8
ranks stacked on one device, so every run has one exact answer and "recovered
correctly" is bitwise equality — no tolerances to hide a dropped pending
level behind. The sweeps interrupt at every step boundary (preemption =
boundary save + exit; kill = process death from the batch stream, the
in-flight step's work lost) and require the resumed incarnation to finish
bit-identically to the uninterrupted twin. The elastic tests restore
mid-cycle checkpoints onto a *different* merge topology and require the
outstanding mass to settle exactly as a flush under the old topology
would have. ``rescale_hyperparams`` gets the property treatment:
identity, composition, and preservation of the per-data-step invariants.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline fallback (tests/_hypothesis_stub.py)
    from _hypothesis_stub import given, settings, strategies as st

from repro_torch.runtime import DriverConfig, TrainDriver, chaos
from repro_torch.runtime.elastic import (effective_invariants,
                                         rescale_hyperparams)

DP = 8
PLAN2 = "chip:2,host:2:defer,pod:2:defer"   # strides (2, 4): two levels
PLAN1 = "chip:4,pod:2:defer"                # stride (4): one level


def _fac(plan=PLAN2, intervals=(1, 2), overlap=False):
    return chaos.toy_factory(plan, intervals, DP, width=4, overlap=overlap,
                             device="cpu")


# ---------------------------------------------------------------------------
# preemption / kill sweeps: every boundary, bitwise
# ---------------------------------------------------------------------------


def test_preempt_every_boundary_bitwise(tmp_path):
    _, outcomes = chaos.chaos_sweep(_fac(), 6, str(tmp_path),
                                    mode="preempt")
    assert outcomes, "sweep produced no kill points"
    for o in outcomes:
        assert o.state_bitwise, f"preempt@{o.kill_at}: state diverged"
    assert {o.resume_action for o in outcomes} <= {"verbatim", None}


def test_kill_every_boundary_bitwise(tmp_path):
    _, outcomes = chaos.chaos_sweep(_fac(), 6, str(tmp_path), mode="kill")
    for o in outcomes:
        assert o.state_bitwise, f"kill@{o.kill_at}: state diverged"


def test_overlap_kill_mid_launch_bitwise(tmp_path):
    """Overlapped schedules keep a launched-but-not-landed cycle in
    ``defer/inflight``; kills between launch and land are the interesting
    boundaries and must still recover bitwise."""
    _, outcomes = chaos.chaos_sweep(_fac(intervals=(1, 2), overlap=True),
                                    7, str(tmp_path), mode="kill")
    for o in outcomes:
        assert o.state_bitwise, f"kill@{o.kill_at}: state diverged"


def test_preempt_overlap_sparse_checkpoints(tmp_path):
    """ckpt_every > 1: the resumed run replays the steps after the last
    committed boundary from the (deterministic) stream and must land on
    the same bits."""
    _, outcomes = chaos.chaos_sweep(_fac(overlap=True), 6, str(tmp_path),
                                    mode="preempt", ckpt_every=2,
                                    kill_steps=[1, 3, 5])
    for o in outcomes:
        assert o.state_bitwise, f"preempt@{o.kill_at}: state diverged"


def test_flush_policy_conserves_params(tmp_path):
    """defer_save="flush" settles the cascade before saving: params mass
    is conserved exactly (integer ADD), while the optimizer's fold count
    legitimately differs from the uninterrupted run."""
    _, outcomes = chaos.chaos_sweep(_fac(overlap=True), 6, str(tmp_path),
                                    mode="preempt", defer_save="flush",
                                    kill_steps=[1, 2, 3, 4])
    for o in outcomes:
        assert o.params_bitwise, f"preempt@{o.kill_at}: mass lost"


def test_kill_before_any_checkpoint_restarts_fresh(tmp_path):
    """A crash before the first boundary save resumes from scratch (no
    committed checkpoint) and must still reach the baseline bits."""
    _, outcomes = chaos.chaos_sweep(_fac(), 4, str(tmp_path), mode="kill",
                                    kill_steps=[0])
    assert outcomes[0].resume_action is None
    assert outcomes[0].state_bitwise


# ---------------------------------------------------------------------------
# elastic restore: different topology, zero mass loss
# ---------------------------------------------------------------------------


def _ckpt_midcycle(tmp_path, fac, n_steps, ckpt_every):
    step, bf, st0 = fac()
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every)
    TrainDriver(cfg, step, bf, defer_step=step).run(st0, 0, n_steps)
    return cfg


def _flush_oracle(tmp_path, fac):
    step, bf, like = fac()
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=1)
    s, _, rep = TrainDriver(cfg, step, bf, defer_step=step).resume(like)
    assert rep.action == "verbatim"
    s, _ = step.flush(s)
    return s


@pytest.mark.parametrize("overlap", [False, True])
def test_elastic_resolve_conserves_mass(tmp_path, overlap):
    fac_old = _fac(overlap=overlap)
    _ckpt_midcycle(tmp_path, fac_old, 5, 5)
    oracle = _flush_oracle(tmp_path, fac_old)

    step_n, bf_n, like_n = chaos.toy_factory(PLAN1, (3,), DP, width=4,
                                             device="cpu")()
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=1)
    drv = TrainDriver(cfg, step_n, bf_n, defer_step=step_n)
    state, start, report = drv.resume(like_n)

    assert report.action == "resolved"
    assert report.k_old == 2 and report.k_new == 3
    assert torch.equal(state["params"]["w"], oracle["params"]["w"])
    # fresh cascade for the new topology
    assert int(state["defer"]["t"]) == 0
    assert len(state["defer"]["pending"]) == 1
    assert all(not p.any() for p in state["defer"]["pending"][0].values())
    # and it trains on
    state, end = drv.run(state, start, 2)
    assert end == start + 2


def test_elastic_resolve_lands_outstanding_inflight(tmp_path):
    """Checkpoint taken with a launched-but-not-landed overlap cycle: the
    resolved restore must land it (top-stride representatives combined)
    before settling the partial period."""
    fac_old = _fac(overlap=True)
    _ckpt_midcycle(tmp_path, fac_old, 4, 4)   # t=4: land_due pending
    oracle = _flush_oracle(tmp_path, fac_old)

    step_n, bf_n, like_n = chaos.toy_factory(PLAN1, (3,), DP, width=4,
                                             device="cpu")()
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=1)
    state, _, report = TrainDriver(cfg, step_n, bf_n,
                                   defer_step=step_n).resume(like_n)
    assert report.action == "resolved"
    assert report.landed_inflight
    assert torch.equal(state["params"]["w"], oracle["params"]["w"])


def test_same_topology_resumes_verbatim(tmp_path):
    fac = _fac(overlap=True)
    _ckpt_midcycle(tmp_path, fac, 5, 5)
    step, bf, like = fac()
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=1)
    state, start, report = TrainDriver(cfg, step, bf,
                                       defer_step=step).resume(like)
    assert report.action == "verbatim"
    assert start == 5
    assert int(state["defer"]["t"]) == 5


# ---------------------------------------------------------------------------
# rescale_hyperparams: the property treatment
# ---------------------------------------------------------------------------

ks = st.integers(min_value=1, max_value=64)
lrs = st.floats(min_value=1e-6, max_value=1.0,
                allow_nan=False, allow_infinity=False)
betas = st.floats(min_value=0.01, max_value=0.999,
                  allow_nan=False, allow_infinity=False)


@given(k=ks, lr=lrs, b1=betas, b2=betas)
@settings(max_examples=20, deadline=None)
def test_rescale_identity(k, lr, b1, b2):
    h = rescale_hyperparams(k, k, lr=lr, b1=b1, b2=b2)
    assert h == {"lr": lr, "b1": b1, "b2": b2}


@given(k1=ks, k2=ks, k3=ks, lr=lrs, b1=betas, b2=betas)
@settings(max_examples=20, deadline=None)
def test_rescale_composes(k1, k2, k3, lr, b1, b2):
    via = rescale_hyperparams(k2, k3, **rescale_hyperparams(k1, k2, lr=lr,
                                                            b1=b1, b2=b2))
    direct = rescale_hyperparams(k1, k3, lr=lr, b1=b1, b2=b2)
    assert np.allclose([via["lr"], via["b1"], via["b2"]],
                       [direct["lr"], direct["b1"], direct["b2"]],
                       rtol=1e-12)


@given(k1=ks, k2=ks, lr=lrs, b1=betas, b2=betas)
@settings(max_examples=20, deadline=None)
def test_rescale_preserves_per_step_invariants(k1, k2, lr, b1, b2):
    h = rescale_hyperparams(k1, k2, lr=lr, b1=b1, b2=b2)
    old = effective_invariants(k1, lr=lr, b1=b1, b2=b2)
    new = effective_invariants(k2, **h)
    for key in old:
        assert np.isclose(old[key], new[key], rtol=1e-9), key


def test_rescale_rejects_bad_k():
    with pytest.raises(ValueError):
        rescale_hyperparams(0, 2, lr=0.1)
    with pytest.raises(ValueError):
        rescale_hyperparams(2, -1, lr=0.1)


# ---------------------------------------------------------------------------
# harness self-checks
# ---------------------------------------------------------------------------


def test_crashing_wrapper_raises_at_exactly_one_step():
    bf = chaos.crashing(lambda i: {"i": i}, 3)
    assert bf(2) == {"i": 2}
    with pytest.raises(chaos.SimulatedCrash):
        bf(3)
    assert bf(4) == {"i": 4}


def test_trees_bitwise_equal_detects_dtype_and_value():
    a = {"x": np.arange(4, dtype=np.int32)}
    assert chaos.trees_bitwise_equal(a, {"x": np.arange(4, dtype=np.int32)})
    assert not chaos.trees_bitwise_equal(
        a, {"x": np.arange(4, dtype=np.int64)})
    b = {"x": np.arange(4, dtype=np.int32)}
    b["x"][1] = 7
    assert not chaos.trees_bitwise_equal(a, b)
    assert not chaos.trees_bitwise_equal(a, {"y": a["x"]})


def test_baseline_is_deterministic(tmp_path):
    step, bf, st0 = _fac()()
    a = chaos.run_plain(step, bf, 5, state=st0, flush=True)
    step2, bf2, st02 = _fac()()
    b = chaos.run_plain(step2, bf2, 5, state=st02, flush=True)
    assert chaos.trees_bitwise_equal(a["params"], b["params"])


# ---------------------------------------------------------------------------
# the real-model chaos: xlstm-125m's smoke config, the example's run
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """The real model runs thousands of small ops: with a pytest-xdist
    worker per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xlstm_twin():
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config("xlstm-125m")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cfg, chaos.real_model_twin(cfg, 5, device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("kill", [1, 2, 3, 4])
def test_real_model_kill_resumes_to_the_twin_bitwise(xlstm_twin, tmp_path,
                                                     kill, one_thread):
    """The JAX example's full run (``examples/fault_tolerant_train.py``
    ``chaos_real_model``): killed before step ``kill`` of 5, resumed
    verbatim from the step's checkpoint, finished and flushed, the
    parameters equal the uninterrupted twin's bit for bit."""
    cfg, twin = xlstm_twin
    out = chaos.real_model_run(cfg, 5, str(tmp_path), kill, device="cpu")
    assert out["report"].action == "verbatim"
    assert chaos.trees_bitwise_equal(out["state"]["params"], twin["params"])
    assert len(out["step_s"]) == 5 and out["ckpt_bytes"] > 0


def test_real_model_kill_checkpointing_every_two_steps_resumes_bitwise(
        xlstm_twin, tmp_path, one_thread):
    """``ckpt_every=2`` (``chip_smoke.py``'s, to halve the saves of its
    full-width run) resumes from the same step-2 checkpoint as the
    example's every step, to the same bits; a kill at a step with no
    checkpoint is refused."""
    cfg, twin = xlstm_twin
    out = chaos.real_model_run(cfg, 5, str(tmp_path), 2, device="cpu",
                               ckpt_every=2)
    assert (out["report"].action, out["report"].step) == ("verbatim", 2)
    assert chaos.trees_bitwise_equal(out["state"]["params"], twin["params"])
    assert len(out["save_s"]) == 2          # steps 2 and 4
    with pytest.raises(ValueError, match="no checkpoint's step"):
        chaos.real_model_run(cfg, 5, str(tmp_path), 3, device="cpu",
                             ckpt_every=2)


def test_real_model_resume_without_the_defer_state_differs(xlstm_twin,
                                                           tmp_path,
                                                           one_thread):
    """The control: a resume whose pendings are replaced by fresh zeros
    loses the outstanding gradient mass, and the check sees it."""
    cfg, twin = xlstm_twin
    out = chaos.real_model_run(cfg, 5, str(tmp_path), 3, device="cpu",
                               fresh_defer=True)
    assert not chaos.trees_bitwise_equal(out["state"]["params"],
                                         twin["params"])


def test_real_model_twin_is_bitwise_repeatable(xlstm_twin, one_thread):
    cfg, twin = xlstm_twin
    assert chaos.trees_bitwise_equal(
        chaos.real_model_twin(cfg, 5, device="cpu"), twin)
