"""Elastic restore for deferred-commit train state.

The port of the JAX package's ``repro/runtime/elastic.py``. A checkpoint of
a deferred run carries outstanding gradient mass in ``state["defer"]``:
per-level pendings mid-cycle and (overlapped schedules) a launched but not
landed in-flight cycle. That state is only meaningful under the plan, the
schedule and the rank count that produced it
(``repro_torch.checkpoint.defer_state``). This module restores in both
worlds:

* fingerprints match -> restore verbatim (onto ``device`` if given, or
  onto ``state_like``'s DTensor layouts: the counterpart of JAX's
  ``restore_resharded`` onto a new mesh);
* fingerprints differ (a pod joined or left, K re-solved, the plan's
  geometry changed) -> **settle** the restored pendings into the params and
  the optimizer exactly as ``DeferredTrainStep.flush`` would have, then hand
  back fresh (identity) defer state for the new topology. No gradient mass
  is dropped, and the optimizer sees the same delayed-mean semantics it
  would have seen had the old run flushed before the checkpoint.

The settle respects the cascade's replication geometry: after stage
``i``'s exchange, ``pending[i]`` is replicated within stage ``i``'s stride
unit, so combining the whole ``(dp,)`` leading dim would overcount by the
replication factor. The durability manifest records each level's stride;
the settle combines one representative per stride unit
(``pending[i][::stride_i]``) in rank order, then the levels in order, each
add in the leaf's own dtype: bitwise equal to the JAX package's settle, for
integer merges equal to the flush. It runs in torch on the device each
restored parameter lives on. The parameters and the optimizer state come
from the arrays already read for the settle (the JAX package reads the
file a second time for them).

``rescale_hyperparams`` is the optimizer-continuity half: a full-commit
cycle applies the mean of ``K`` steps' gradients once per ``K`` steps, so
the *per-data-step* effective learning rate is ``lr / K`` and the EMA decay
per data step is ``beta ** (1/K)``. Changing ``K_old -> K_new`` mid-run
without touching hyperparameters would change both; rescaling

    lr'    = lr    * (K_new / K_old)
    beta'  = beta ** (K_new / K_old)        (each of b1, b2)

keeps the per-data-step invariants fixed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, _rebuild
from repro_torch.core import merge_functions

PyTree = Any


# ---------------------------------------------------------------------------
# defer-aware hyperparameter rescaling
# ---------------------------------------------------------------------------


def rescale_hyperparams(k_old: int, k_new: int, *, lr: float,
                        b1: float = 0.9, b2: float = 0.95) -> dict:
    """Rescale (lr, b1, b2) so a K change has no per-data-step discontinuity.

    Returns ``{"lr", "b1", "b2"}``; see module doc for the math. ``k_old ==
    k_new`` returns the inputs unchanged (exact identity)."""
    if k_old < 1 or k_new < 1:
        raise ValueError(f"commit periods must be >= 1, got {k_old}, {k_new}")
    if k_old == k_new:
        return {"lr": lr, "b1": b1, "b2": b2}
    r = k_new / k_old
    return {"lr": lr * r, "b1": b1 ** r, "b2": b2 ** r}


def effective_invariants(k: int, *, lr: float, b1: float = 0.9,
                         b2: float = 0.95) -> dict:
    """The per-data-step quantities ``rescale_hyperparams`` preserves."""
    return {"lr_per_step": lr / k,
            "b1_per_step": b1 ** (1.0 / k),
            "b2_per_step": b2 ** (1.0 / k)}


# ---------------------------------------------------------------------------
# settle of restored pendings
# ---------------------------------------------------------------------------


def _join(*parts: str) -> str:
    return "/".join(p for p in parts if p)


def _combine_representatives(leaf, stride: int, merge_fn,
                             device=None) -> torch.Tensor:
    """Combine one representative per stride unit of a restored ``(dp,
    ...)`` pending leaf (numpy or tensor), in rank order, on ``device`` (the
    leaf's own by default): the exact value the remaining cascade stages
    would have produced (the intra-unit copies are replicas, not
    contributions)."""
    reps = torch.as_tensor(leaf)[::stride]
    if device is not None:
        reps = reps.to(device)
    return functools.reduce(merge_fn.combine,
                            [reps[i] for i in range(reps.shape[0])])


def settle_pending_leaves(level_leaves: Sequence[Sequence[Any]],
                          strides: Sequence[int], merge_fn,
                          device=None) -> list:
    """Combine restored pendings across ranks and levels, per param leaf.

    ``level_leaves[i][j]`` is deferred level ``i``'s pending for param leaf
    ``j`` (shape ``(dp,) + leaf_shape``); ``strides[i]`` is that level's
    replication unit. ``device`` is where the combines run: one device, or
    a sequence of one device per leaf (the leaves' own by default). Returns
    one settled tensor per param leaf."""
    if len(level_leaves) != len(strides):
        raise ValueError(f"{len(level_leaves)} pending levels but "
                         f"{len(strides)} strides")
    n_leaves = len(level_leaves[0])
    devices = (list(device) if isinstance(device, (list, tuple))
               else [device] * n_leaves)
    out = []
    for j in range(n_leaves):
        per_level = [
            _combine_representatives(level_leaves[i][j], int(strides[i]),
                                     merge_fn, devices[j])
            for i in range(len(level_leaves))]
        out.append(functools.reduce(merge_fn.combine, per_level))
    return out


def _merge_by_name(name: str):
    for fn in merge_functions.standard_merges():
        if fn.name == name:
            return fn
    raise ValueError(f"checkpointed defer state used merge {name!r}, "
                     f"which this build does not register — cannot "
                     f"settle it")


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RestoreReport:
    """What the restore did — the driver logs this verbatim."""

    action: str                    # "fresh" | "verbatim" | "resolved"
    step: Optional[int] = None
    flushed_steps: int = 0         # trailing partial-cycle steps settled
    landed_inflight: bool = False  # an in-flight launched cycle was folded
    k_old: Optional[int] = None
    k_new: Optional[int] = None
    events: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # Host-clock seconds of each part of the restore ("load", "place",
        # "settle", "fold", "init") and of the whole ("total"): kept beside
        # the JAX package's fields, not in as_dict().
        self.seconds: dict = {}

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Parts:
    """Times the parts of one restore on the host clock, the card's queued
    work waited for at each part's end, and logs each part as it ends
    (``{"event": "elastic_part", "part", "seconds"}``)."""

    def __init__(self, emit: Callable[[dict], None]):
        self.emit = emit
        self.seconds: dict = {}
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.emit({"event": "elastic_part", "part": name, "seconds": dt})

    def total(self) -> dict:
        return {**self.seconds, "total": time.perf_counter() - self.t0}


def _opt_fold(params, opt_state, settled: dict, scale, optimizer):
    """One optimizer step on the settled leaves (keyed by their path in the
    params tree), each scaled in its own dtype. A DTensor parameter takes
    its slice of the settled leaf on its own layout (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    def grad(key, leaf):
        g = settled[key]
        if scale != 1.0:
            g = g * torch.tensor(scale, dtype=g.dtype)
        if not isinstance(leaf, DTensor):
            return g
        mesh = leaf.device_mesh
        return DTensor.from_local(g, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
                                      mesh, leaf.placements)
    grads = _rebuild(params, grad)
    with implicit_replication():
        return optimizer.step(params, grads, opt_state)


def elastic_restore(ckpt_dir: str, state_like: PyTree, *,
                    defer_step=None, optimizer=None,
                    step: Optional[int] = None, device=None,
                    log: Optional[Callable[[dict], None]] = None
                    ) -> tuple[PyTree, dict, RestoreReport]:
    """Restore train state, elastically when the defer geometry changed.

    ``state_like`` is the CURRENT run's state template (``{"params", "opt"}``
    plus ``"defer"`` when ``defer_step`` is given). ``defer_step`` is any
    object with the deferred-step durability surface —
    ``durability_manifest()`` and ``init_defer_state(params)``
    (:class:`~repro_torch.launch.steps.DeferredTrainStep`, or the chaos
    harness's integer twin). ``optimizer`` is consulted only on the resolved
    path, to fold outstanding mass; folding uses the OLD run's settle
    semantics (manifest-recorded), so pass the optimizer whose
    hyperparameters match the checkpoint — rescale afterwards with
    :func:`rescale_hyperparams`. ``device`` places the restored leaves, as
    :func:`~repro_torch.checkpoint.restore_resharded` does (one device, or
    a tree shaped like ``state_like`` of devices and ``(DeviceMesh,
    placements)`` layouts); without it each leaf goes where its
    ``state_like`` tensor lives, a DTensor onto its layout (the
    counterpart of JAX's ``shardings=``). The settle runs on the device of
    each restored parameter: over a process group every process settles
    the same whole leaves from the same file (deterministic), and the fold
    steps each process's FSDP shards of the parameters and AdamW; the
    fresh defer state is laid out on the new mesh by ``defer_step``.

    Returns ``(state, extras, report)``; raises ``FileNotFoundError`` when
    no committed checkpoint exists (callers start fresh).
    """
    emit = log or (lambda rec: None)
    part = _Parts(emit)
    with part("load"):
        raw, manifest = ckpt.load_raw(ckpt_dir, step=step)
    extras = manifest.get("extras", {})
    found_step = manifest.get("step")
    saved = extras.get("defer")
    current = (defer_step.durability_manifest()
               if defer_step is not None else None)

    def like_matches() -> bool:
        for k, leaf in _flatten_with_paths(state_like):
            shp = tuple(getattr(leaf, "shape", ()) or ())
            if k not in raw or tuple(raw[k].shape) != shp:
                return False
        return True

    # Legacy checkpoints (pre-manifest) restore verbatim iff the stored tree
    # structurally matches the current template — shapes included, so a dp
    # change can never smuggle mis-replicated pendings through this path.
    verbatim = (ckpt.manifests_compatible(saved, current)
                or (saved is None and like_matches()))
    if saved is None and not verbatim and "defer/t" in raw:
        raise ValueError(
            "elastic restore: the checkpoint carries defer state but no "
            "durability manifest (pre-manifest writer?) and its structure "
            "does not match the current run — the outstanding mass cannot "
            "be settled safely; restore it under the original topology and "
            "flush there first")
    if verbatim:
        with part("place"):
            state = ckpt.from_raw(raw, state_like, device)
        report = RestoreReport(action="verbatim", step=found_step,
                               k_old=saved and saved.get("period"),
                               k_new=current and current.get("period"))
        report.seconds = part.total()
        emit({"event": "elastic_restore", "action": "verbatim",
              "step": found_step})
        return state, extras, report

    # -- resolved path: geometry changed (or defer-ness changed) ------------
    outstanding = saved is not None and "defer/t" in raw
    if outstanding and optimizer is None:
        raise ValueError(
            "elastic restore: the checkpoint carries outstanding defer "
            "state under a different plan/schedule; pass optimizer= so "
            "it can be settled (dropping it would lose gradient mass)")
    base_like = {"params": state_like["params"], "opt": state_like["opt"]}
    base_device = device
    if device is not None and not isinstance(device, (str, torch.device)):
        base_device = {"params": device["params"], "opt": device["opt"]}
    with part("place"):
        state = ckpt.from_raw(raw, base_like, base_device)

    report = RestoreReport(action="resolved", step=found_step,
                           k_old=saved and saved.get("period"),
                           k_new=current and current.get("period"))

    if outstanding:
        merge_fn = _merge_by_name(saved["merge"])
        t = int(np.asarray(raw["defer/t"]))
        dp_old = int(saved["dp"])
        period_old = int(saved["period"])
        strides = [int(s) for s in saved["strides"]]
        mean = saved["settle_mode"] == "mean"
        # Leaf paths relative to the params subtree — the same rests the
        # saved defer/pending/<level>/<rest> keys were built from — and the
        # device each restored parameter lives on.
        rests = [k for k, _ in _flatten_with_paths(base_like["params"])]
        devices = [getattr(p, "device", None)
                   for _, p in _flatten_with_paths(state["params"])]

        # Fold order mirrors DeferredTrainStep.flush: the in-flight launched
        # cycle (the OLDER aggregate) first, then the trailing partial cycle.
        if extras.get("defer_land_pending") and saved.get("overlap"):
            with part("settle"):
                landed = {r: _combine_representatives(
                    raw[_join("defer", "inflight", r)], strides[-1],
                    merge_fn, dev) for r, dev in zip(rests, devices)}
            scale = 1.0 / (dp_old * period_old) if mean else 1.0
            with part("fold"):
                state["params"], state["opt"], _ = _opt_fold(
                    state["params"], state["opt"], landed, scale, optimizer)
            del landed
            report.landed_inflight = True
            emit({"event": "elastic_settle", "what": "inflight",
                  "scale_steps": period_old})

        m = t % period_old
        if m > 0:
            with part("settle"):
                level_leaves = [
                    [raw[_join("defer", "pending", str(i), r)] for r in rests]
                    for i in range(len(strides))]
                settled = dict(zip(rests, settle_pending_leaves(
                    level_leaves, strides, merge_fn, device=devices)))
            scale = 1.0 / (dp_old * m) if mean else 1.0
            with part("fold"):
                state["params"], state["opt"], _ = _opt_fold(
                    state["params"], state["opt"], settled, scale, optimizer)
            del settled
            report.flushed_steps = m
            emit({"event": "elastic_settle", "what": "pending",
                  "flushed_steps": m})

    if defer_step is not None:
        with part("init"):
            state["defer"] = defer_step.init_defer_state(state["params"])

    report.seconds = part.total()
    emit({"event": "elastic_restore", "action": "resolved",
          "step": found_step, "flushed_steps": report.flushed_steps,
          "landed_inflight": report.landed_inflight,
          "k_old": report.k_old, "k_new": report.k_new})
    return state, extras, report
