"""Pipeline parallelism: a GPipe-style circular schedule over stacked stages.

The counterpart of the JAX package's ``repro/sharding/pipeline.py``. There
each rank of the ``stage`` axis owns one stage under ``shard_map`` or
``vmap(axis_name=...)``; here the ``S`` stages are dim 0 of the parameters
and of every activation, as ``core/stacked.py`` stacks ranks, and the
handoff is a :class:`StackedAxis` ``ppermute``.

At tick t, stage s processes microbatch t - s (a bubble when out of range):
stage 0 reads the input stream, the others take the previous tick's
handoff, and every stage passes its output to stage s + 1 over the full
cycle ``(i, (i + 1) % S)``, so stage 0 receives the last stage's output and
ignores it. Bubbles run ``stage_fn`` too, as the reference's static
schedule does, so both packages do the same work. Total ticks = n_micro +
S - 1; bubble fraction = (S - 1) / (n_micro + S - 1), the standard GPipe
pipeline efficiency.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.stacked import StackedAxis

PyTree = Any


def pipeline_apply(stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                   stage_params: PyTree, microbatches: torch.Tensor,
                   axis: StackedAxis) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over the ``axis.size`` stacked stages.

    ``stage_params``  every stage's parameters, stage-major (dim 0 = S)
    ``microbatches``  ``[S, n_micro, mb, ...]``, the input stream; only
                      stage 0's copy is read (the others may be a
                      broadcast view or zeros)
    ``stage_fn(stage_params, x)`` takes every stage's input ``x [S, mb,
    ...]`` at once and returns every stage's output of the same shape.
    Returns ``[S, n_micro, mb, ...]``; only ``[S - 1]`` holds the outputs.
    """
    n_stages = axis.size
    if microbatches.shape[0] != n_stages:
        raise ValueError(f"microbatches must be [S={n_stages}, n_micro, "
                         f"mb, ...], got {tuple(microbatches.shape)}")
    n_micro = microbatches.shape[1]
    mb_shape = tuple(microbatches.shape[2:])
    first = axis.index() == 0
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    outputs = microbatches.new_zeros((n_stages, n_micro) + mb_shape)
    carry = microbatches.new_zeros((n_stages,) + mb_shape)
    for t in range(n_micro + n_stages - 1):
        # stage 0 reads microbatch t of the stream (clipped, as the
        # reference's dynamic index); the others take the handoff
        stream = microbatches[0, min(t, n_micro - 1)]
        src = axis.where(first, stream.expand_as(carry), carry)
        y = stage_fn(stage_params, src)
        # the last stage banks its result when it ran a real microbatch
        done = t - (n_stages - 1)
        if 0 <= done < n_micro:
            outputs[n_stages - 1, done] = y[n_stages - 1]
        carry = axis.ppermute(y, perm)
    return outputs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
