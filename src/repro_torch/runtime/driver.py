"""Fault-tolerant training driver.

The port of the JAX package's ``repro/runtime/driver.py``. It wraps a step
function with the operational machinery a long run needs:

* periodic checkpoints (two-phase commit, checkpoint/)
* preemption: SIGTERM/SIGINT request a save at the *next step boundary*
  (steps run to completion)
* poisoned steps: non-finite loss triggers restore-from-last-checkpoint and
  a skip-batch policy — sound because the data stream is a pure function of
  the step index, and commutative merges make skip-and-continue order-free
* straggler detection: per-step wall times vs. a rolling median; outliers
  (> k x median) are logged with the host id (the process's rank in its
  group, 0 without one) so a scheduler can reassign — any host can
  recompute any shard (data/pipeline.py)
* retry-with-backoff around transient step failures
* elastic resume (``TrainDriver.resume``, through ``runtime/elastic``): the
  pending cascade verbatim on the same plan and schedule, settled into the
  parameters and the optimizer on another one

Over a process group (gloo or NCCL; every process of a data-parallel run
drives its own driver on its shards of the state) three things differ
from the JAX driver, whose one controller needs none of them:

* preemption is agreed: at each step boundary the processes take the MAX
  of their flags (a one-element all-reduce), so a signal that reached only
  some of them still makes every process save the same step and exit —
  the save gathers each leaf over the group, and a process that left alone
  would hang the others;
* a step that raises is not retried: one process's retry would
  desynchronise the group's collectives, so the error ends the process
  (the spawner stops the group) and the next run resumes from the
  checkpoint;
* rank r > 0 logs its events to ``log_path`` with ``.rank{r}`` appended,
  and only rank 0 removes old checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.runtime import elastic


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep_last: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    max_retries: int = 3
    retry_backoff_s: float = 1.0
    max_skipped_batches: int = 16
    # Rewind to the last checkpoint on a poisoned step. Off by default:
    # the port's steps return new tensors and leave their input state as
    # it was, so discarding the poisoned new_state is sufficient. A step
    # that donates its state (``step_fn.donates``, make_train_step(...,
    # donate=True)) has already overwritten it, so the driver turns this
    # on for such a step.
    restore_on_nan: bool = False
    log_path: Optional[str] = None
    # Durability policy for deferred-commit state (state["defer"], needs a
    # defer_step): "checkpoint" saves the pending cascade as part of the
    # state tree with the durability manifest in extras (restore resumes
    # mid-cycle bitwise); "flush" drains everything outstanding through
    # DeferredTrainStep.flush BEFORE each save, so the checkpoint carries no
    # volatile mass at all (the optimizer sequence then differs from an
    # uninterrupted run — mass-conserving, not bitwise). Either way, no
    # gradient mass is silently dropped, and the chosen path is logged.
    defer_save: str = "checkpoint"

    def __post_init__(self):
        if self.defer_save not in ("checkpoint", "flush"):
            raise ValueError(f"defer_save must be 'checkpoint' or 'flush', "
                             f"got {self.defer_save!r}")


def _group_rank() -> Optional[int]:
    """This process's rank in a real process group of more than one
    process (gloo or NCCL), else None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_backend() not in ("gloo", "nccl") or \
            dist.get_world_size() < 2:
        return None
    return dist.get_rank()


class TrainDriver:
    """step_fn(state, batch) -> (state, metrics); state is a pytree that
    includes everything needed to resume (params, opt state, step count).
    A ``step_fn`` whose ``donates`` attribute is true consumes its input
    state: the driver then rewinds a poisoned step to the last checkpoint
    (``restore_on_nan``), and raises if there is none."""

    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Any],
                 defer_step=None, optimizer=None):
        self.donates = bool(getattr(step_fn, "donates", False))
        if self.donates and not cfg.restore_on_nan:
            cfg = dataclasses.replace(cfg, restore_on_nan=True)
        # this process's rank in a real group (gloo or NCCL) of more than
        # one process, else None
        self.rank = _group_rank()
        if self.rank and cfg.log_path:
            cfg = dataclasses.replace(cfg, log_path=f"{cfg.log_path}"
                                                    f".rank{self.rank}")
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        # defer_step: the DeferredTrainStep (or any object with its
        # durability surface — durability_manifest / defer_save_extras /
        # flush / init_defer_state) whose state["defer"] this driver must
        # keep durable. optimizer: used by the elastic resume path to fold
        # outstanding mass; defaults to defer_step.optimizer.
        self.defer_step = defer_step
        self.optimizer = optimizer or getattr(defer_step, "optimizer", None)
        self._preempted = False
        self._step_times: list[float] = []
        self.events: list[dict] = []
        self._orig_handlers = {}

    # ----------------------------------------------------------- plumbing

    def _install_signals(self):
        def handler(signum, frame):
            self._preempted = True
            self._log({"event": "preemption_requested", "signal": signum})
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _restore_signals(self):
        for sig, h in self._orig_handlers.items():
            signal.signal(sig, h)

    def _log(self, rec: dict):
        rec = {"t": time.time(), **rec}
        self.events.append(rec)
        if self.cfg.log_path:
            with open(self.cfg.log_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")

    def _agreed(self, flag: bool) -> bool:
        """``flag`` made true on every process of the group when it is
        true on any (a one-element MAX all-reduce); as it is without a
        group."""
        if self.rank is None:
            return flag
        import torch.distributed as dist
        device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool(x.item())

    def _gc_checkpoints(self):
        if self.rank:           # rank 0 keeps the directory
            return
        import shutil
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.cfg.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _is_straggler(self, dt: float) -> bool:
        w = self._step_times[-self.cfg.straggler_window:]
        if len(w) < 8:
            return False
        return dt > self.cfg.straggler_factor * statistics.median(w)

    @staticmethod
    def _loss_of(metrics) -> float:
        if isinstance(metrics, dict) and "loss" in metrics:
            return float(metrics["loss"])
        return float("nan")

    # ------------------------------------------------------- durability

    def _save_checkpoint(self, state: Any, step: int,
                         save_extras: Optional[Callable[[int], dict]]) -> Any:
        """Boundary save under the defer durability policy (cfg.defer_save).

        "checkpoint": the pending cascade rides the state tree; extras carry
        the durability manifest so restore can validate it (or settle it
        elastically on a topology change). "flush": everything outstanding
        is drained into params/opt first and the cycle counter reset, so the
        checkpoint holds zero volatile mass. Returns the (possibly flushed)
        state the run must continue from. Both paths log which was taken —
        no silently dropped mass either way."""
        cfg = self.cfg
        extras = {"next_step": step}
        has_defer = isinstance(state, dict) and "defer" in state
        if has_defer and self.defer_step is not None:
            if cfg.defer_save == "flush":
                state, fmetrics = self.defer_step.flush(state)
                if fmetrics is not None:
                    # A flush empties the pendings mid-cycle; restart the
                    # cycle counter so the next commit sees a full window.
                    state = dict(state)
                    state["defer"] = dict(state["defer"],
                                          t=torch.zeros((), dtype=torch.int32))
                self._log({"event": "defer_flush_before_save", "step": step,
                           "flushed": fmetrics is not None})
            extras.update(self.defer_step.defer_save_extras(state))
            self._log({"event": "defer_save", "step": step,
                       "policy": cfg.defer_save})
        elif has_defer:
            # No defer_step: the tree still rides along, but restore cannot
            # validate it — surface that in the log.
            self._log({"event": "defer_save", "step": step,
                       "policy": "checkpoint", "manifest": False})
        if save_extras:
            extras.update(save_extras(step))
        ckpt.save(cfg.ckpt_dir, step, state, extras=extras)
        self._gc_checkpoints()
        self._log({"event": "checkpoint", "step": step})
        return state

    def resume(self, state_like: Any, device=None):
        """Resume from the latest committed checkpoint, elastically.

        Returns ``(state, start_step, report)``; ``(state_like, 0, None)``
        when no checkpoint exists. Restore goes through
        :func:`repro_torch.runtime.elastic.elastic_restore`: matching
        plan/schedule fingerprints restore the pending cascade verbatim
        (onto ``device`` if given: one device, or a tree shaped like
        ``state_like`` of devices and ``(DeviceMesh, placements)``
        layouts; else onto ``state_like``'s own, a DTensor's layout
        included); a changed topology settles the outstanding mass into
        params/opt and re-initializes fresh defer state for the new one.
        Over a process group every process calls it."""
        if ckpt.latest_step(self.cfg.ckpt_dir) is None:
            return state_like, 0, None
        state, extras, report = elastic.elastic_restore(
            self.cfg.ckpt_dir, state_like, defer_step=self.defer_step,
            optimizer=self.optimizer, device=device, log=self._log)
        start = int(extras.get("next_step", report.step or 0))
        self._log({"event": "resume", "action": report.action,
                   "start_step": start,
                   "includes_defer": isinstance(state, dict)
                   and "defer" in state})
        return state, start, report

    # ---------------------------------------------------------------- run

    def run(self, state: Any, start_step: int, num_steps: int,
            save_extras: Optional[Callable[[int], dict]] = None) -> Any:
        cfg = self.cfg
        self._install_signals()
        # the process to signal for a preemption: from here on it saves
        self._log({"event": "run_start", "step": start_step,
                   "pid": os.getpid()})
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        step = start_step
        skipped = 0
        last_good = None  # (ckpt step)
        try:
            while step < start_step + num_steps:
                batch = self.batch_fn(step)
                t0 = time.time()
                attempt = 0
                while True:
                    try:
                        new_state, metrics = self.step_fn(state, batch)
                        break
                    except Exception as e:  # transient failure path
                        attempt += 1
                        self._log({"event": "step_error", "step": step,
                                   "error": repr(e), "attempt": attempt})
                        # over a group a retry would desynchronise the
                        # collectives: the error ends the run
                        if attempt > cfg.max_retries or self.rank is not None:
                            raise
                        time.sleep(cfg.retry_backoff_s * attempt)
                dt = time.time() - t0

                loss = self._loss_of(metrics)
                if math.isnan(loss) or math.isinf(loss):
                    # Poisoned step: discard new_state, skip this batch,
                    # continue (sound: commutative merges are order-free and
                    # the data stream is a pure function of the step index).
                    skipped += 1
                    self._log({"event": "nan_rollback", "step": step,
                               "skipped_total": skipped})
                    if skipped > cfg.max_skipped_batches:
                        raise RuntimeError("too many poisoned batches")
                    if self.donates and last_good is None:
                        raise RuntimeError(
                            f"step {step} poisoned a donated state and this "
                            f"run has saved no checkpoint to rewind to")
                    if cfg.restore_on_nan and last_good is not None:
                        state, _ = ckpt.restore(cfg.ckpt_dir, state,
                                                step=last_good)
                        # The full tree is restored — including any defer
                        # pendings, so no in-flight mass is zeroed.
                        self._log({"event": "restore", "step": last_good,
                                   "includes_defer":
                                   isinstance(state, dict)
                                   and "defer" in state})
                    step += 1  # skip-batch policy
                    continue

                state = new_state
                if self._is_straggler(dt):
                    self._log({"event": "straggler", "step": step,
                               "dt": dt, "host": self.rank or 0})
                self._step_times.append(dt)
                self._log({"event": "step", "step": step, "loss": loss,
                           "dt": dt})
                step += 1

                # the agreed flag, read once: a signal that arrives after
                # the agreement (during the save) waits for the next one,
                # so every process saves and stops at the same step
                stop = self._agreed(self._preempted)
                if step % cfg.ckpt_every == 0 or stop:
                    state = self._save_checkpoint(state, step, save_extras)
                    last_good = step
                if stop:
                    self._log({"event": "preempted_exit", "step": step})
                    break
        finally:
            self._restore_signals()
        return state, step
