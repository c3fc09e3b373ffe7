"""Fault-injection chaos harness for deferred-commit durability.

The port of the JAX package's ``repro/runtime/chaos.py``. The durability
claims — "a preemption at any step boundary resumes bitwise-identically",
"a kill mid-cycle or mid-launch loses zero gradient mass" — are only worth
anything if they are *executed*, not asserted. This module provides:

* :class:`ToyDeferredStep` — an integer twin of the real
  :class:`~repro_torch.launch.steps.DeferredTrainStep`, running the *real*
  ``ccache.defer_cascade`` / ``overlap_cascade`` over ranks stacked on one
  device (``core/stacked.StackedAxis``, the twin of the JAX package's
  ``vmap(axis_name=...)``). Integer params + integer grads +
  ``settle_mode="reapply"`` (settled sums applied unscaled) make every run
  exactly reproducible: addition over int32 is associative, so ANY
  interleaving of checkpoint / restore / flush that conserves mass must
  land on the bitwise-identical params. A float harness could only ever
  assert ``allclose``; the integer twin turns "no mass lost" into
  ``torch.equal``.

* failure injection — :func:`chaos_run` drives a real
  :class:`~repro_torch.runtime.driver.TrainDriver` (real checkpoints on
  disk, real resume path) and injects either a *preemption* (SIGTERM
  analogue: the driver saves at the next step boundary and exits) or a
  *kill* (``SimulatedCrash`` out of ``batch_fn`` — the process dies with no
  goodbye; recovery replays from the last committed checkpoint).

* :func:`chaos_sweep` — inject the failure at EVERY step boundary in turn
  and compare each recovered run against the uninterrupted baseline.

* :func:`real_model_run` — the real-model chaos of the JAX package's
  ``examples/fault_tolerant_train.py`` (``chaos_real_model``): a real LM
  (``xlstm-125m``) trained in its config's dtype over the 8 stacked ranks of
  ``chip:2,host:2,pod:2:defer`` (lane-parallel) with an overlapped K = 2
  commit, killed before a step, resumed and flushed. Its parameters must
  equal the uninterrupted twin's (:func:`real_model_twin`) bit for bit:
  that needs every float sum on the path to be the same bits on every run,
  the embedding backward's ``cscatter`` included (``csrc/cscatter.cu``,
  "Determinism").

Under ``defer_save="checkpoint"`` the comparison is bitwise on the whole
state (params, opt, defer tree). Under ``defer_save="flush"`` the boundary
flush re-times the optimizer folds, so only *mass conservation* holds —
still bitwise on params for the integer ADD toy (sums are order-free), but
the opt step-count legitimately differs.

The toy's tensors live on its device (the card unless the caller asks for
the CPU); its step and fold counters are 0-dim int32 tensors on the host,
as the real step's ``t`` and AdamW's count are.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.checkpoint.defer_state import (defer_manifest,
                                                defer_state_spec)
from repro_torch.core import ccache
from repro_torch.core import merge_functions as mf
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_plan import MergePlan
from repro_torch.core.stacked import StackedAxis
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.serve.kv import resolve_device

PyTree = Any


class SimulatedCrash(RuntimeError):
    """Raised out of ``batch_fn`` to model a hard kill (no boundary save)."""


def trees_bitwise_equal(a: PyTree, b: PyTree) -> bool:
    """Exact structural + bitwise equality of two trees: the same leaf paths
    (dict keys in sorted order, as a JAX tree flattens them) and at each
    path the same dtype and the same bits (tensors, numpy arrays or
    scalars; ``b``'s leaf is compared on ``a``'s leaf's device)."""
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
            return False
    return True


# ---------------------------------------------------------------------------
# deterministic integer data stream
# ---------------------------------------------------------------------------


def toy_grads(step: int, dp: int, width: int,
              device="cuda") -> torch.Tensor:
    """Deterministic per-rank integer 'gradients' — a pure function of the
    step index (the driver's skip/replay policies assume exactly this)."""
    r = np.arange(dp, dtype=np.int64)[:, None]
    c = np.arange(width, dtype=np.int64)[None, :]
    g = (np.int64(step) * 9176 + r * 131 + c * 17) % 23 - 11
    return torch.as_tensor(g.astype(np.int32), device=device)


def crashing(batch_fn: Callable[[int], Any],
             crash_at: int) -> Callable[[int], Any]:
    """Wrap any batch stream with a hard kill *before* ``crash_at`` runs.

    The driver fetches batches outside its retry loop, so the raised
    :class:`SimulatedCrash` propagates out of ``run`` like a real process
    death: the in-flight step's work is lost, never half-applied."""

    def killed(step: int):
        if step == crash_at:
            raise SimulatedCrash(f"injected kill before step {step}")
        return batch_fn(step)

    return killed


def make_toy_batch_fn(dp: int, width: int, crash_at: Optional[int] = None,
                      device="cuda") -> Callable[[int], dict]:
    """Batch stream for the toy step on ``device``; ``crash_at`` injects a
    hard kill *before* that step runs (the step's work is lost, not
    half-applied)."""

    def batch_fn(step: int) -> dict:
        return {"grads": toy_grads(step, dp, width, device)}

    return batch_fn if crash_at is None else crashing(batch_fn, crash_at)


# ---------------------------------------------------------------------------
# the integer twin of DeferredTrainStep
# ---------------------------------------------------------------------------


class ToyOptimizer:
    """params <- merge_fn.apply(params, settled); counts its own steps.

    The count is the observable that distinguishes *bitwise-identical
    sequencing* (checkpoint policy: counts match too) from *mass
    conservation only* (flush policy: params match, counts may differ).
    """

    def __init__(self, merge_fn=None):
        self.merge_fn = merge_fn or mf.ADD

    def step(self, params, grads, opt_state):
        grads = pytree.tree_map(lambda p, g: g.to(p.dtype), params, grads)
        new_params = self.merge_fn.tree_apply(params, grads)
        return new_params, {"count": opt_state["count"] + 1}, {}


class ToyDeferredStep:
    """Integer deferred-commit step over the real cascade programs.

    Implements the full durability surface the driver and elastic restore
    rely on — ``init_defer_state`` / ``due`` / ``land_due`` / ``flush`` /
    ``durability_manifest`` / ``defer_save_extras`` / ``volatile_spec`` —
    so it exercises the same checkpoint/resume code paths as the real
    :class:`~repro_torch.launch.steps.DeferredTrainStep`, over ``dp`` ranks
    stacked on ``device``.

    ``settle_mode`` is ``"reapply"``: a settled cycle is applied to params
    unscaled (integer sum), which keeps every recovery path exact.
    """

    def __init__(self, plan_spec, schedule: DeferSchedule, dp: int,
                 width: int = 8, merge_fn=None, device="cuda"):
        self.plan = (plan_spec if isinstance(plan_spec, MergePlan)
                     else MergePlan.parse(plan_spec))
        self.schedule = schedule
        self.dp = int(dp)
        self.width = int(width)
        self.merge_fn = merge_fn or mf.ADD
        self.axis = StackedAxis(self.dp, resolve_device(device))
        deferred = ccache.deferred_stages_of(self.plan, self.dp,
                                             merge_fn=self.merge_fn)
        if not deferred:
            raise ValueError(f"plan {plan_spec!r} has no deferred stages "
                             f"at dp={dp}")
        self.deferred_names = tuple(s.name for s in deferred)
        self.strides = tuple(s.stride for s in deferred)
        if schedule.level_names != self.deferred_names:
            raise ValueError(
                f"schedule levels {schedule.level_names} do not match the "
                f"plan's deferred stages {self.deferred_names}")
        self._n_def = len(deferred)
        self._settle_mode = "reapply"
        self.optimizer = ToyOptimizer(self.merge_fn)

    # -- state ----------------------------------------------------------

    @property
    def overlap(self) -> bool:
        return self.schedule.overlap

    @property
    def device(self) -> torch.device:
        return self.axis.device

    def init_params(self) -> dict:
        return {"w": self.merge_fn.identity((self.width,), torch.int32,
                                            device=self.device)}

    def init_defer_state(self, params) -> dict:
        def pending_like():
            return pytree.tree_map(
                lambda p: self.merge_fn.identity(
                    (self.dp,) + tuple(p.shape), p.dtype, device=p.device),
                params)
        state = {"t": torch.zeros((), dtype=torch.int32),
                 "pending": tuple(pending_like()
                                  for _ in range(self._n_def))}
        if self.overlap:
            state["inflight"] = pending_like()
        return state

    def init_state(self) -> dict:
        params = self.init_params()
        return {"params": params,
                "opt": {"count": torch.zeros((), dtype=torch.int32)},
                "defer": self.init_defer_state(params)}

    # -- schedule dispatch (mirrors DeferredTrainStep) -------------------

    def due(self, state) -> int:
        return self.schedule.due_count(int(state["defer"]["t"]) + 1)

    def land_due(self, state) -> bool:
        t = int(state["defer"]["t"])
        return (self.overlap and t >= 1
                and self.schedule.due_count(t) == self._n_def)

    def __call__(self, state, batch):
        due = self.due(state)
        land = self.land_due(state)
        d = state["defer"]
        params, opt = state["params"], state["opt"]
        grads = {"w": batch["grads"]}
        if self.overlap:
            new_p, new_if, settled = ccache.overlap_cascade(
                grads, list(d["pending"]), d["inflight"], due, land,
                self.axis, self.merge_fn, self.plan)
            commits = land
        else:
            new_p, settled = ccache.defer_cascade(
                grads, list(d["pending"]), due, self.axis, self.merge_fn,
                self.plan)
            commits = due == self._n_def
        if commits:
            agg = pytree.tree_map(lambda x: x[0], settled)  # replicated
            params, opt, _ = self.optimizer.step(params, agg, opt)
        new_defer = {"t": d["t"] + 1, "pending": tuple(new_p)}
        if self.overlap:
            new_defer["inflight"] = new_if
        new_state = {"params": params, "opt": opt, "defer": new_defer}
        return new_state, {"loss": 0.0}

    # -- durability surface ----------------------------------------------

    def durability_manifest(self) -> dict:
        return defer_manifest(self.plan, self.schedule, self.dp,
                              self.merge_fn, self.strides, self._settle_mode)

    def defer_save_extras(self, state) -> dict:
        return {"defer": self.durability_manifest(),
                "defer_land_pending": bool(self.land_due(state)),
                "defer_t": int(state["defer"]["t"])}

    def volatile_spec(self, params_like) -> dict:
        return defer_state_spec(params_like, self._n_def, self.dp,
                                self.overlap)

    # -- final flush (mirrors DeferredTrainStep.flush) --------------------

    def _flush_land(self, inflight):
        return ccache.settle_inflight(inflight, self.axis, self.merge_fn,
                                      self.plan)

    def _flush_partial(self, pendings):
        zero = self.merge_fn.tree_identity(pendings[0])
        _, settled = ccache.defer_cascade(
            zero, list(pendings), self._n_def, self.axis, self.merge_fn,
            self.plan)
        return settled

    def flush(self, state):
        d = state["defer"]
        t = int(d["t"])
        params, opt = state["params"], state["opt"]
        metrics = None
        new_defer = dict(d)

        def reset(tree):
            return self.merge_fn.tree_identity(tree)

        if (self.overlap and t >= 1
                and self.schedule.due_count(t) == self._n_def):
            landed = self._flush_land(d["inflight"])
            params, opt, _ = self.optimizer.step(
                params, pytree.tree_map(lambda x: x[0], landed), opt)
            new_defer["inflight"] = reset(d["inflight"])
            metrics = {"flushed_inflight": True}
        m = t % self.schedule.period
        if m > 0:
            settled = self._flush_partial(d["pending"])
            params, opt, _ = self.optimizer.step(
                params, pytree.tree_map(lambda x: x[0], settled), opt)
            new_defer["pending"] = tuple(reset(p) for p in d["pending"])
            metrics = {**(metrics or {}), "flushed_steps": m}
        if metrics is None:
            return state, None
        return {"params": params, "opt": opt, "defer": new_defer}, metrics


def toy_factory(plan_spec: str, intervals, dp: int, *, width: int = 8,
                overlap: bool = False, merge_fn=None, device="cuda"):
    """A fresh-process factory: each call builds a new step + batch stream +
    initial state on ``device``, the way a restarted job would.
    ``chaos_run`` calls it once per simulated process incarnation."""
    merge_fn = merge_fn or mf.ADD

    def factory():
        plan = MergePlan.parse(plan_spec)
        names = tuple(s.name for s in
                      ccache.deferred_stages_of(plan, dp, merge_fn=merge_fn))
        sched = DeferSchedule(names, tuple(intervals), overlap=overlap)
        step = ToyDeferredStep(plan, sched, dp, width=width,
                               merge_fn=merge_fn, device=device)
        return (step, make_toy_batch_fn(dp, width, device=step.device),
                step.init_state())

    return factory


# ---------------------------------------------------------------------------
# failure injection
# ---------------------------------------------------------------------------


def run_plain(step_obj, batch_fn, n_steps: int, state=None,
              flush: bool = False):
    """The uninterrupted oracle: a bare loop, no driver, no checkpoints."""
    state = step_obj.init_state() if state is None else state
    for t in range(n_steps):
        state, _ = step_obj(state, batch_fn(t))
    if flush:
        state, _ = step_obj.flush(state)
    return state


@dataclasses.dataclass
class ChaosOutcome:
    kill_at: int
    mode: str                       # "preempt" | "kill"
    state: Any                      # final (flushed) recovered state
    resume_action: Optional[str]    # RestoreReport.action, None = fresh
    params_bitwise: bool            # vs. the baseline's params
    state_bitwise: bool             # vs. the baseline's full state tree


def chaos_run(factory, n_steps: int, ckpt_dir: str, *, kill_at: int,
              mode: str = "preempt", ckpt_every: int = 1,
              defer_save: str = "checkpoint", flush_end: bool = True):
    """One interrupted run: fail at ``kill_at``, recover, finish.

    ``factory() -> (step_obj, batch_fn, state0)`` models one process
    incarnation; it is called twice (before and after the failure) so no
    Python object survives the "crash". Preempt mode sets the driver's
    preemption flag before step ``kill_at`` runs — the driver finishes the
    step, saves at the boundary, and exits cleanly. Kill mode raises
    :class:`SimulatedCrash` from ``batch_fn`` — nothing after the last
    committed checkpoint survives, and recovery recomputes the lost steps
    (sound because the batch stream is a pure function of the step index).

    Returns ``(final_state, report)`` where ``report`` is the resume's
    :class:`~repro_torch.runtime.elastic.RestoreReport` (``None`` when the
    failure hit before the first checkpoint).
    """
    if mode not in ("preempt", "kill"):
        raise ValueError(f"mode must be 'preempt' or 'kill', got {mode!r}")
    cfg = DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                       keep_last=3, defer_save=defer_save)

    # -- incarnation 1: run into the failure -----------------------------
    step_obj, batch_fn, state0 = factory()
    if mode == "preempt":
        holder = {}

        def preempting_batch_fn(s):
            if s == kill_at:
                holder["drv"]._preempted = True
            return batch_fn(s)

        drv = TrainDriver(cfg, step_obj, preempting_batch_fn,
                          defer_step=step_obj)
        holder["drv"] = drv
        drv.run(state0, 0, n_steps)
        if kill_at < n_steps and not drv._preempted:
            raise AssertionError("preemption did not interrupt the run")
    else:
        drv = TrainDriver(cfg, step_obj, crashing(batch_fn, kill_at),
                          defer_step=step_obj)
        try:
            drv.run(state0, 0, n_steps)
            raise AssertionError("injected crash did not fire")
        except SimulatedCrash:
            pass

    # -- incarnation 2: fresh process, resume, finish ---------------------
    step2, batch2, like = factory()
    drv2 = TrainDriver(cfg, step2, batch2, defer_step=step2)
    state, start, report = drv2.resume(like)
    if start < n_steps:
        state, _ = drv2.run(state, start, n_steps - start)
    if flush_end:
        state, _ = step2.flush(state)
    return state, report


def chaos_sweep(factory, n_steps: int, root_dir: str, *,
                mode: str = "preempt", ckpt_every: int = 1,
                defer_save: str = "checkpoint", kill_steps=None,
                flush_end: bool = True):
    """Inject the failure at every step boundary (or ``kill_steps``) and
    compare each recovered run against the uninterrupted oracle.

    Returns ``(baseline_state, [ChaosOutcome, ...])``. For integer merges
    under ``defer_save="checkpoint"``, every outcome should have
    ``state_bitwise=True``; under ``"flush"`` the boundary flushes re-time
    the optimizer folds, so ``params_bitwise`` (mass conservation) is the
    guaranteed bit and the opt count may differ.
    """
    step_b, batch_b, state_b = factory()
    baseline = run_plain(step_b, batch_b, n_steps, state=state_b,
                         flush=flush_end)
    outcomes = []
    for k in (kill_steps if kill_steps is not None else range(n_steps)):
        ckpt_dir = os.path.join(root_dir, f"{mode}_{k}")
        state, report = chaos_run(factory, n_steps, ckpt_dir, kill_at=k,
                                  mode=mode, ckpt_every=ckpt_every,
                                  defer_save=defer_save,
                                  flush_end=flush_end)
        outcomes.append(ChaosOutcome(
            kill_at=k, mode=mode, state=state,
            resume_action=report.action if report else None,
            params_bitwise=trees_bitwise_equal(state["params"],
                                               baseline["params"]),
            state_bitwise=trees_bitwise_equal(state, baseline)))
    return baseline, outcomes


# ---------------------------------------------------------------------------
# the real-model chaos
# ---------------------------------------------------------------------------

REAL_PLAN = "chip:2,host:2,pod:2:defer"
REAL_SHAPE = (32, 8)                # seq, global batch: one row a rank


def _real_model_factory(cfg, *, device="cuda", seed: int = 0):
    """``() -> (step, batch_fn, state0)`` of the example's real-model run:
    ``cfg``'s model with weights from ``seed`` on ``device``, AdamW at a
    constant 1e-3, the deferred train step over ``REAL_PLAN`` (lane
    parallel) on ``DeferSchedule.fixed(2, ("pod",), overlap=True)``, and
    the data stream of ``ShapeConfig("t", 32, 8, "train")`` from seed 0
    (numpy batches, a pure function of the step)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import batch_at, data_config_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import constant

    device = resolve_device(device)
    dcfg = data_config_for(cfg, ShapeConfig("t", *REAL_SHAPE, "train"),
                           seed=0)

    def factory():
        model = build_model(cfg, device=device, seed=seed)
        opt = adamw(constant(1e-3))
        step = make_train_step(
            model, cfg, opt, 1,
            merge_topology=MergePlan.parse(REAL_PLAN, lane_parallel=True),
            defer_schedule=DeferSchedule.fixed(2, ("pod",), overlap=True))
        params = model.params()
        state0 = {"params": params, "opt": opt.init(params),
                  "defer": step.init_defer_state(params)}
        return step, lambda i: batch_at(dcfg, i), state0

    return factory


def real_model_twin(cfg, n_steps: int, *, device="cuda", seed: int = 0):
    """The uninterrupted twin: ``n_steps`` of the real-model step from its
    initial state, then the flush."""
    step, batch_fn, state0 = _real_model_factory(cfg, device=device,
                                                seed=seed)()
    return run_plain(step, batch_fn, n_steps, state=state0, flush=True)


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def real_model_run(cfg, n_steps: int, ckpt_dir: str, kill_at: int, *,
                   device="cuda", seed: int = 0, fresh_defer: bool = False,
                   ckpt_every: int = 1) -> dict:
    """One killed real-model run: a driver checkpointing every
    ``ckpt_every`` steps (the example's every step) runs until
    ``crashing`` kills it before step ``kill_at``, which must be a
    checkpoint's step; a second
    incarnation (new model, step and optimizer objects) resumes from the
    last checkpoint, runs the remaining steps and flushes. With
    ``fresh_defer`` the resumed defer state is replaced by fresh zeros (the
    control: the outstanding gradient mass is lost).

    Returns ``{"state", "report", "seconds": {"killed", "resume", "rest",
    "flush"}, "step_s": [host seconds of each step run], "save_s": [each
    checkpoint's save], "ckpt_bytes"}``."""
    import time

    if not 0 < kill_at < n_steps:
        raise ValueError(f"kill_at {kill_at} outside (0, {n_steps})")
    if kill_at % ckpt_every:
        raise ValueError(f"kill_at {kill_at} is no checkpoint's step "
                         f"(ckpt_every {ckpt_every})")
    factory = _real_model_factory(cfg, device=device, seed=seed)
    dcfg = DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        retry_backoff_s=0.0)
    step, batch_fn, state0 = factory()
    drv = TrainDriver(dcfg, step, crashing(batch_fn, kill_at),
                      defer_step=step)
    t0 = time.perf_counter()
    try:
        drv.run(state0, 0, n_steps)
        raise AssertionError("the injected kill did not fire")
    except SimulatedCrash:
        pass
    killed = time.perf_counter() - t0
    events = drv.events
    del drv, step, state0          # the killed incarnation's buffers go
    step2, batch2, like = factory()
    drv2 = TrainDriver(dcfg, step2, batch2, defer_step=step2)
    t0 = time.perf_counter()
    state, start, report = drv2.resume(like)
    resume = time.perf_counter() - t0
    del like
    if fresh_defer:
        state["defer"] = step2.init_defer_state(state["params"])
    t0 = time.perf_counter()
    state, _ = drv2.run(state, start, n_steps - start)
    rest = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = step2.flush(state)
    flush = time.perf_counter() - t0
    events = events + drv2.events
    saves, last = [], None
    for e in events:
        if e["event"] == "step":
            last = e["t"]
        elif e["event"] == "checkpoint" and last is not None:
            saves.append(e["t"] - last)
    latest = _latest_dir(ckpt_dir)
    return {"state": state, "report": report,
            "seconds": {"killed": killed, "resume": resume, "rest": rest,
                        "flush": flush},
            "step_s": [e["dt"] for e in events if e["event"] == "step"],
            "save_s": saves,
            "ckpt_bytes": _tree_bytes(latest) if latest else 0}


def _latest_dir(ckpt_dir: str) -> Optional[str]:
    """The directory of the latest committed checkpoint under
    ``ckpt_dir``, or None."""
    from repro_torch.checkpoint.checkpoint import latest_step
    step = latest_step(ckpt_dir)
    return None if step is None else os.path.join(ckpt_dir,
                                                  f"step_{step:08d}")
