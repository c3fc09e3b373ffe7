"""Gradient accumulation and reduction as CCache merges.

The counterpart of the JAX package's ``repro/core/grad_merge.py``.
Microbatch gradient accumulation *is* privatize-and-merge: each
microbatch's gradient is a contribution on a privatized replica; the merge
function's ``combine`` coalesces them locally (zero cross-rank traffic),
and the one cross-rank merge at the step boundary is the evict-time merge.
Ranks are stacked on one device (``core/stacked.StackedAxis``), so a
gradient tree to merge holds ``[dp, ...]`` tensors and
:func:`merge_gradients` runs the port's ``ccache.reduce_update`` over that
leading dim.

Where JAX differentiates with ``jax.value_and_grad``, :func:`value_and_grad`
runs autograd over a parameter tree: it detaches the leaves (no copy),
marks them as requiring grad, and returns the loss and a gradient tree of
the parameters' structure and dtypes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import ccache
from repro_torch.core.merge_functions import ADD, MergeFn
from repro_torch.core.stacked import StackedAxis

PyTree = Any


def value_and_grad(loss_fn: Callable[[PyTree, PyTree], torch.Tensor]
                   ) -> Callable[[PyTree, PyTree], tuple[torch.Tensor, PyTree]]:
    """``loss_fn(params, batch) -> scalar`` into ``(params, batch) ->
    (loss, grads)``; a parameter the loss does not reach gets zeros."""

    def vg(params: PyTree, batch: PyTree):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    return vg


def split_microbatches(batch: PyTree, num_microbatches: int) -> PyTree:
    """[B, ...] -> [num_microbatches, B/num_microbatches, ...] per leaf."""

    def _split(x):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{num_microbatches} microbatches")
        return x.reshape((num_microbatches, b // num_microbatches)
                         + tuple(x.shape[1:]))

    return pytree.tree_map(_split, batch)


def microbatched_value_and_grad(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    num_microbatches: int,
    merge_fn: MergeFn = ADD,
    mean: bool = True,
) -> Callable[[PyTree, PyTree], tuple[torch.Tensor, PyTree]]:
    """Returns ``step(params, batch) -> (loss, grads)`` with soft-merge
    accumulation: each microbatch's gradient is combined into a privatized
    pending (in the gradients' dtype), and a scalable merge's sum becomes
    the mean over microbatches."""
    grad_fn = value_and_grad(loss_fn)

    def step(params: PyTree, batch: PyTree):
        micro = split_microbatches(batch, num_microbatches)
        pending = merge_fn.tree_identity(params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=pytree.tree_leaves(params)[0].device)
        for i in range(num_microbatches):
            loss, grads = grad_fn(params, pytree.tree_map(lambda x: x[i],
                                                          micro))
            pending = merge_fn.tree_combine(pending, grads)
            loss_sum = loss_sum + loss
        if mean and merge_fn.scalable:
            scale = 1.0 / num_microbatches
            pending = pytree.tree_map(
                lambda g: g * torch.tensor(scale, dtype=g.dtype), pending)
        return loss_sum / num_microbatches, pending

    return step


def merge_gradients(
    grads: PyTree,
    axis: StackedAxis,
    merge_fn: MergeFn = ADD,
    compress: bool = False,
    mean: bool = True,
    topology: Optional[ccache.Topology] = None,
) -> PyTree:
    """Explicit cross-rank gradient merge over the stacked ``axis``: every
    leaf of ``grads`` is ``[dp, ...]``, one gradient a rank, and every rank
    of the result holds the merged value.

    ``compress=True`` with a merge defining encode/decode exchanges the
    int8 wire format. ``topology`` (a two-level ``MergeTopology`` or an
    N-level ``MergePlan``) routes through the hierarchical engine. A
    scalable merge's sum becomes the mean over the ``dp`` ranks.
    """
    merged = ccache.reduce_update(grads, axis, merge_fn, compress=compress,
                                  topology=topology)
    if mean and merge_fn.scalable:
        merged = pytree.tree_map(lambda g: g / axis.size, merged)
    return merged
