"""The train step family, on ranks stacked on one device.

The train half of the JAX package's ``repro/launch/steps.py``. There the
data-parallel ranks are devices of a mesh, each shard's gradients come out
of ``shard_map`` and the CCache engine merges them with collectives. Here
the ``dp`` ranks are the leading dim of a stack on one device
(``core/stacked.StackedAxis``), the layout the KV store and the apps use:

* rank ``r`` takes batch rows ``[r B/dp, (r+1) B/dp)``; its forward and
  backward run once per rank, in rank order, and its gradients are written
  into slice ``r`` of a preallocated ``[dp, ...]`` stack, so no two ranks'
  activations are alive at once (the order changes no value);
* the stack is merged by the port's ``core/ccache`` engine over that dim:
  ``grad_merge.merge_gradients`` for an eager plan, ``defer_cascade`` /
  ``overlap_cascade`` / ``settle_inflight`` for a deferred one, one leaf
  at a time (the same values; the engine's temporaries are one leaf's, and
  each gradient leaf is freed once merged: at qwen1.5-0.5b's width over 8
  ranks the whole tree's took the card past 80 GB);
* the loss is the mean over ranks (``lax.pmean``), the optimizer consumes
  rank 0's copy of the merged gradient (every rank holds the same);
* with ``donate=True`` the optimizer updates the parameters and its moments
  in place (``Optimizer.step(..., donate=True)``), the counterpart of a jitted
  step that donates its state: the step consumes its input ``state``, and
  the caller must not read it again (``runtime/driver.py`` then rewinds a
  poisoned step to its last checkpoint). The values are the functional
  step's, bit for bit.

:func:`make_train_step` without a topology is the implicit step (one rank,
the whole batch). The mesh rules of the JAX module (``lowering_rules``,
``axes_to_shardings``, ``opt_state_axes``, ``plan_train``,
``LoweredPlan``) have no counterpart on one device and are not ported.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import ccache
from repro_torch.core.ccache import Topology
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.grad_merge import (merge_gradients,
                                         microbatched_value_and_grad,
                                         value_and_grad)
from repro_torch.core.merge_functions import ADD, int8_compressed_add
from repro_torch.core.merge_plan import MergePlan
from repro_torch.core.stacked import StackedAxis

PyTree = Any


def merge_axes_for(topology: Optional[Topology], dp: Optional[int] = None
                   ) -> int:
    """The rank count a gradient-merge topology reduces over: the JAX
    package names mesh axes, the stacked axis has one dim whose size is a
    plan's ``num_ranks`` (a ``MergeTopology`` names no size: pass ``dp``)."""
    if isinstance(topology, MergePlan):
        if dp is not None:
            topology.validate(dp)
        return topology.num_ranks
    if dp is None:
        raise ValueError("a MergeTopology does not name its rank count: "
                         "pass dp")
    if topology is not None:
        topology.validate(dp)
    return dp


def _device_of(params: PyTree) -> torch.device:
    return pytree.tree_leaves(params)[0].device


def to_device(batch: PyTree, device: torch.device) -> PyTree:
    """A numpy (or tensor) batch on ``device``."""
    return pytree.tree_map(lambda x: torch.as_tensor(x, device=device), batch)


def grads_fn(model, num_microbatches: int = 1):
    """``(params, batch) -> (loss, grads)`` of ``model.loss``, accumulated
    over ``num_microbatches`` when more than one."""

    def loss_fn(params, batch):
        return model.loss(params, batch)[0]

    if num_microbatches > 1:
        return microbatched_value_and_grad(loss_fn, num_microbatches)
    return value_and_grad(loss_fn)


@torch.profiler.record_function("train.ranks")
def rank_grads(grads_of, params: PyTree, batch: PyTree, dp: int
               ) -> tuple[torch.Tensor, PyTree]:
    """Every rank's ``(loss, grads)`` on its rows of ``batch``, the grads
    written into slice ``r`` of ``[dp, ...]`` stacks -> (mean loss, stack)."""
    rows = pytree.tree_leaves(batch)[0].shape[0]
    if rows % dp:
        raise ValueError(f"batch of {rows} rows does not split over {dp} "
                         f"ranks")
    per = rows // dp
    leaves, spec = pytree.tree_flatten(params)
    stack = [torch.empty((dp,) + tuple(p.shape), dtype=p.dtype,
                         device=p.device) for p in leaves]
    loss_sum = None
    for r in range(dp):
        shard = pytree.tree_map(lambda x: x[r * per:(r + 1) * per], batch)
        loss, grads = grads_of(params, shard)
        for dst, g in zip(stack, pytree.tree_leaves(grads)):
            dst[r].copy_(g)
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    return loss_sum / dp, pytree.tree_unflatten(stack, spec)


def _leafwise(fn, stack: PyTree, *trees: PyTree, consume: bool = False
              ) -> tuple[list, Any]:
    """``fn(leaf, *leaves_of_trees)`` at each leaf position of ``stack`` in
    turn -> (the results by position, the tree spec). Every merge is
    elementwise within a tensor (int8's scale is a tensor's too), so this
    equals ``fn`` over the whole trees, but the merge engine's temporaries
    are one leaf's at a time, not the tree's. With ``consume`` the dicts of
    ``stack`` are emptied and each leaf is released once merged."""
    leaves, spec = pytree.tree_flatten(stack)
    if consume:
        _empty(stack)
    del stack
    others = [pytree.tree_leaves(t) for t in trees]
    out = []
    for k in range(len(leaves)):
        out.append(fn(leaves[k], *(o[k] for o in others)))
        leaves[k] = None
    return out, spec


def _empty(tree: PyTree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _empty(v)
        tree.clear()


def _rank0(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Rank 0's copy of a merged ``[dp, ...]`` leaf (every rank holds the
    same), without the other ranks' storage."""
    return None if x is None else x[0].clone()


def make_train_step(model, cfg, optimizer, num_microbatches: int = 1, *,
                    dp: Optional[int] = None,
                    merge_topology: Optional[Topology] = None,
                    merge_compress: bool = False,
                    defer_schedule: Optional[DeferSchedule] = None,
                    donate: bool = False):
    """Build the train step ``step(state, batch) -> (state, metrics)`` over
    ``state = {"params", "opt"}`` and a numpy or tensor batch. The step's
    ``donates`` attribute is ``donate``: whether it consumes its input state.

    Default: the implicit step, one rank over the whole batch. With
    ``merge_topology`` (a two-level ``MergeTopology``, with ``dp``, or an
    N-level ``MergePlan`` over its ``num_ranks``) the merge is explicit:
    per-rank gradients over a ``[dp, ...]`` stack, reconciled by the CCache
    hierarchical engine. A plan with ``:defer`` levels also needs a
    ``defer_schedule`` and returns a :class:`DeferredTrainStep`: K deferred
    commits are numerically K-step gradient accumulation over the eagerly
    merged gradients, and an overlapped schedule steps the optimizer one
    step stale. Without a schedule, ``defer`` plans are refused: the
    optimizer would silently train on partially merged gradients.
    """

    grads_of = grads_fn(model, num_microbatches)
    if merge_topology is None and defer_schedule is not None:
        raise ValueError("defer_schedule needs a merge_topology with :defer "
                         "levels")
    if merge_topology is None:
        def train_step(state, batch):
            params = state["params"]
            loss, grads = grads_of(params, to_device(batch,
                                                      _device_of(params)))
            params, opt_state, stats = optimizer.step(
                params, grads, state["opt"], donate=donate)
            return ({"params": params, "opt": opt_state},
                    {"loss": loss, **stats})
        train_step.donates = donate
        return train_step

    has_deferred = getattr(merge_topology, "has_deferred", False)
    if has_deferred and defer_schedule is None:
        raise ValueError(
            "merge plan has :defer levels but no commit schedule: the "
            "optimizer consumes the merged gradient, so deferred levels "
            "need a DeferSchedule (train.py: --merge-defer auto|K; "
            "library: repro_torch.core.defer_schedule.solve_defer_schedule "
            "or DeferSchedule.fixed). Deferred-K training accumulates K "
            "steps' gradients and steps the optimizer once per commit; "
            "alternatively drop the :defer flags.")
    if defer_schedule is not None and not has_deferred:
        raise ValueError("defer_schedule given but the merge plan has "
                         "no :defer levels")
    n_ranks = merge_axes_for(merge_topology, dp)
    grad_merge_fn = int8_compressed_add() if merge_compress else ADD

    if defer_schedule is not None:
        return _make_deferred_train_step(
            grads_of, optimizer, merge_topology, merge_compress,
            defer_schedule, n_ranks, grad_merge_fn, donate)

    def train_step(state, batch):
        params = state["params"]
        axis = StackedAxis(n_ranks, _device_of(params))
        loss, stack = rank_grads(grads_of, params,
                                 to_device(batch, axis.device), n_ranks)
        with torch.profiler.record_function("train.merge"):
            merged, spec = _leafwise(
                lambda g: _rank0(merge_gradients(
                    g, axis, merge_fn=grad_merge_fn, topology=merge_topology,
                    compress=merge_compress)), stack, consume=True)
        with torch.profiler.record_function("train.optimizer"):
            params, opt_state, stats = optimizer.step(
                params, pytree.tree_unflatten(merged, spec), state["opt"],
                donate=donate)
        return {"params": params, "opt": opt_state}, {"loss": loss, **stats}

    train_step.donates = donate
    return train_step


class DeferredTrainStep:
    """Scheduled deferred-commit train step: one step callable per due-count.

    ``variants[due]`` is a plain ``step(state, batch)`` for a step on which
    ``due`` leading deferred stages commit — index 0 only accumulates, the
    last settles every deferred level and steps the optimizer on the
    cycle's mean gradient. ``state`` carries ``{"params", "opt", "defer":
    {"t", "pending"}}``; seed the extra entry with ``init_defer_state``.

    The due-count is a host-side decision: it selects which variant runs,
    so the skipped commits' exchanges never execute. Calling the object
    dispatches off the step counter; ``jit()`` returns that same eager
    dispatcher (PyTorch has no per-variant program to compile).

    With an *overlapped* schedule (``schedule.overlap``), the full-commit
    step launches the top-level exchange instead of running it: the cycle
    aggregate moves into ``state["defer"]["inflight"]`` and the next step
    runs the exchange beside its own compute (``land_variants[due]``),
    stepping the optimizer one step stale. ``flush`` drains whatever is
    outstanding (an in-flight launch and/or a trailing partial cycle) at
    the end of a run so no gradient mass is lost.
    """

    def __init__(self, variants, schedule: DeferSchedule, init_fn, dp: int,
                 deferred_names: tuple, land_variants=None, flush_fn=None,
                 topology=None, merge_fn=None, merge_compress: bool = False,
                 optimizer=None, strides: Optional[tuple] = None,
                 settle_mode: Optional[str] = None, donates: bool = False):
        self.variants = variants
        self.land_variants = land_variants
        self.schedule = schedule
        self._init_fn = init_fn
        self._flush_fn = flush_fn
        self.dp = dp
        self.deferred_names = deferred_names
        self.topology = topology
        self.merge_fn = merge_fn
        self.merge_compress = merge_compress
        self.optimizer = optimizer
        self.strides = strides
        self._settle_mode = settle_mode
        self.donates = donates

    @property
    def overlap(self) -> bool:
        return self.schedule.overlap

    def scheduled_manifest(self, due: Optional[int] = None) -> list:
        """The stages ``variants[due]`` runs (``ccache.program_manifest``:
        the eager stages and the leading ``due`` deferred ones); ``due=None``
        is the full-commit variant."""
        if self.topology is None:
            raise ValueError("step was built without its merge topology")
        if due is None:
            due = len(self.deferred_names)
        return ccache.program_manifest(self.topology, self.dp, due,
                                       merge_fn=self.merge_fn,
                                       compress=self.merge_compress)

    def init_defer_state(self, params) -> dict:
        """Zeroed pendings (merge identity), the step counter, and the
        in-flight buffer when overlapped: ``state["defer"] =
        step.init_defer_state(params)``."""
        return self._init_fn(params)

    def due(self, state) -> int:
        return self.schedule.due_count(int(state["defer"]["t"]) + 1)

    def land_due(self, state) -> bool:
        """Whether this step lands a previously launched commit: true iff
        the *previous* step was a full-commit (launch) step."""
        t = int(state["defer"]["t"])
        return (self.overlap and t >= 1
                and self.schedule.due_count(t) == self.schedule.num_levels)

    def __call__(self, state, batch):
        fns = (self.land_variants if self.land_due(state)
               else self.variants)
        return fns[self.due(state)](state, batch)

    def jit(self):
        return self.__call__

    def durability_manifest(self) -> dict:
        """The checkpoint-recorded identity of this step's defer state
        (``checkpoint.defer_state.defer_manifest``)."""
        if self.topology is None or self.strides is None:
            raise ValueError("step was built without its merge topology")
        from repro_torch.checkpoint.defer_state import defer_manifest
        return defer_manifest(self.topology, self.schedule, self.dp,
                              self.merge_fn, self.strides, self._settle_mode)

    def defer_save_extras(self, state) -> dict:
        """Extras a checkpoint of ``state`` must record so a restore can
        validate the defer state."""
        return {"defer": self.durability_manifest(),
                "defer_land_pending": bool(self.land_due(state)),
                "defer_t": int(state["defer"]["t"])}

    def volatile_spec(self, params_like) -> dict:
        """The shapes and dtypes of ``state["defer"]`` as meta tensors: what
        a durable checkpoint of this step must cover."""
        from repro_torch.checkpoint.defer_state import defer_state_spec
        return defer_state_spec(params_like, len(self.deferred_names),
                                self.dp, self.overlap)

    def flush(self, state) -> tuple[dict, Optional[dict]]:
        """Final flush: land an in-flight launched cycle (overlap), then
        settle any trailing partial cycle through every deferred level and
        step the optimizer on its mean. Returns ``(new_state, metrics)``;
        metrics is ``None`` when there was nothing to flush."""
        return self._flush_fn(state)


def _make_deferred_train_step(grads_of, optimizer, plan, merge_compress: bool,
                              schedule: DeferSchedule, dp: int,
                              grad_merge_fn, donate: bool = False
                              ) -> DeferredTrainStep:
    """The merge-on-evict train step family over ``defer_cascade``.

    Gradients are contributions to an ADD merge, so the pending cascade IS
    gradient accumulation: each rank's pending is its slice of a ``[dp,
    ...]`` stack, eager levels settle every step, and each deferred level's
    exchange runs only in the variants where it is due. The optimizer
    consumes ``settled / (dp * period)`` — the mean over ranks and over the
    cycle's steps — so K deferred commits equal accumulating K eagerly
    merged mean gradients. An overlapped schedule routes through
    ``ccache.overlap_cascade``: the full-commit variant launches (cycle
    aggregate -> ``inflight``), and every variant has a land twin that
    runs the top-level exchange on ``inflight`` and steps the optimizer on
    the landed cycle one step stale.
    """
    deferred = ccache.deferred_stages_of(plan, dp, merge_fn=grad_merge_fn)
    if not deferred:
        raise ValueError("the merge plan's :defer levels all compile away "
                         f"(size 1) on a {dp}-rank merge axis; drop the "
                         ":defer flags")
    names = tuple(s.name for s in deferred)
    if schedule.num_levels != len(deferred) or schedule.level_names != names:
        raise ValueError(
            f"DeferSchedule levels {schedule.level_names} with intervals "
            f"{schedule.intervals} do not match the plan's compiled "
            f"deferred stages {names}")
    n_def = len(deferred)
    period = schedule.period
    overlap = schedule.overlap
    # The merge's algebra decides how a settled cycle reaches the
    # optimizer: scalable merges take the delayed mean over ranks x steps,
    # idempotent merges re-apply the settled join as is, anything else has
    # no sound deferred train path.
    if overlap:
        grad_merge_fn.check_overlap("make_train_step(overlapped schedule)")
    settle_mode = grad_merge_fn.settle_mode()
    if settle_mode is None:
        raise ValueError(
            f"make_train_step: merge '{grad_merge_fn.name}' has no deferred "
            "settle mode — it is neither scalable (delayed mean) nor "
            "idempotent (re-apply); a K-step deferred commit cannot be "
            "reconciled with per-step optimizer semantics. Use an eager "
            "plan (no :defer) for this merge.")
    mean = settle_mode == "mean"
    scale = 1.0 / (dp * period) if mean else 1.0

    @torch.profiler.record_function("train.optimizer")
    def _opt_step(params, opt_state, settled, s):
        """AdamW on rank 0's copy of a settled cycle, scaled by ``s``."""
        grads = pytree.tree_map(
            lambda g: g * torch.tensor(s, dtype=g.dtype), settled)
        return optimizer.step(params, grads, opt_state, donate=donate)

    def _cascade(stack, d, due, land, axis):
        """One step's cascade over the gradient stack (consumed), leaf by
        leaf -> (pendings, inflight or None, rank 0's settled cycle or
        None)."""
        if overlap:
            out, spec = _leafwise(
                lambda g, inf, *p: ccache.overlap_cascade(
                    g, list(p), inf, due, land, axis, grad_merge_fn, plan,
                    compress=merge_compress),
                stack, d["inflight"], *d["pending"], consume=True)
            inflight = pytree.tree_unflatten([o[1] for o in out], spec)
            settled = [_rank0(o[2]) for o in out]
        else:
            out, spec = _leafwise(
                lambda g, *p: ccache.defer_cascade(
                    g, list(p), due, axis, grad_merge_fn, plan,
                    compress=merge_compress),
                stack, *d["pending"], consume=True)
            inflight = None
            settled = [_rank0(o[1]) for o in out]
        pending = tuple(pytree.tree_unflatten([o[0][j] for o in out], spec)
                        for j in range(n_def))
        if settled[0] is None:
            return pending, inflight, None
        return pending, inflight, pytree.tree_unflatten(settled, spec)

    def _zero_metrics(loss):
        return {"loss": loss, "grad_norm": torch.zeros((), dtype=torch.float32),
                "lr": torch.zeros((), dtype=torch.float32)}

    def make_variant(due: int, land: bool = False):
        # One maker for both pipelines: the optimizer consumes a settled
        # cycle on a serialized full-commit step or an overlapped land step.
        commits = land if overlap else due == n_def

        def step(state, batch):
            params = state["params"]
            d = state["defer"]
            axis = StackedAxis(dp, _device_of(params))
            loss, stack = rank_grads(grads_of, params,
                                     to_device(batch, axis.device), dp)
            with torch.profiler.record_function("train.merge"):
                pending, inflight, settled = _cascade(stack, d, due, land,
                                                      axis)
            if commits:
                params, opt_state, stats = _opt_step(
                    params, state["opt"], settled, scale)
                metrics = {"loss": loss, **stats}
            else:
                opt_state = state["opt"]
                metrics = _zero_metrics(loss)
            new_defer = {"t": d["t"] + 1, "pending": pending}
            if overlap:
                new_defer["inflight"] = inflight
            return ({"params": params, "opt": opt_state,
                     "defer": new_defer}, metrics)

        return step

    def init_defer_state(params):
        # the buffers start as the merge's identity; nothing writes them in
        # place, so they share one tree
        zeros = pytree.tree_map(
            lambda p: grad_merge_fn.identity((dp,) + tuple(p.shape), p.dtype,
                                             device=p.device), params)
        state = {"t": torch.zeros((), dtype=torch.int32),
                 "pending": (zeros,) * n_def}
        if overlap:
            state["inflight"] = zeros
        return state

    def flush(state):
        d = state["defer"]
        t = int(d["t"])
        params, opt_state = state["params"], state["opt"]
        axis = StackedAxis(dp, _device_of(params))
        metrics = None
        new_defer = dict(d)
        # A drained buffer is the merge's identity. Every consumer makes new
        # tensors from it and none writes it, so the drained buffers share
        # one tree of zeros.
        zeros = grad_merge_fn.tree_identity(d["pending"][0])
        if overlap and t >= 1 and schedule.due_count(t) == n_def:
            # The last step launched a cycle that never landed.
            landed, spec = _leafwise(
                lambda x: _rank0(ccache.settle_inflight(
                    x, axis, grad_merge_fn, plan, compress=merge_compress)),
                d["inflight"])
            params, opt_state, stats = _opt_step(
                params, opt_state, pytree.tree_unflatten(landed, spec), scale)
            new_defer["inflight"] = zeros
            metrics = {"flushed_inflight": True, **stats}
        m = t % period
        if m > 0:
            # Trailing partial cycle: settle every deferred level on the
            # outstanding pendings (zero delta — no new gradient) and step
            # the optimizer on the mean over the m accumulated steps.
            settled, spec = _leafwise(
                lambda z, *p: _rank0(ccache.defer_cascade(
                    z, list(p), n_def, axis, grad_merge_fn, plan,
                    compress=merge_compress)[1]),
                zeros, *d["pending"])
            pscale = 1.0 / (dp * m) if mean else 1.0
            params, opt_state, stats = _opt_step(
                params, opt_state, pytree.tree_unflatten(settled, spec),
                pscale)
            new_defer["pending"] = (zeros,) * n_def
            metrics = {**(metrics or {}), "flushed_steps": m, **stats}
        if metrics is None:
            return state, None
        return {"params": params, "opt": opt_state,
                "defer": new_defer}, metrics

    variants = [make_variant(due) for due in range(n_def + 1)]
    land_variants = ([make_variant(due, land=True)
                      for due in range(n_def + 1)] if overlap else None)
    return DeferredTrainStep(variants, schedule, init_defer_state, dp, names,
                             land_variants=land_variants, flush_fn=flush,
                             topology=plan, merge_fn=grad_merge_fn,
                             merge_compress=merge_compress,
                             optimizer=optimizer,
                             strides=tuple(s.stride for s in deferred),
                             settle_mode=settle_mode, donates=donate)
