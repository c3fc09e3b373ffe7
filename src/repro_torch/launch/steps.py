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
the whole batch); with a ``mesh`` and no topology it is the implicit step
on concrete DTensors over a real process group, one process a device of a
``("data", "model")`` mesh (the train CLI's ``--procs N --model-ranks
M``): under JAX's rules, each parameter gathered over the data dims where
the model uses it and kept split over ``"model"`` (tensor-parallel
blocks, the vocab-parallel embedding, the expert-parallel MoE), the loss
and its backward on each process's rows, each gradient reduced onto its
parameter's layout. :func:`lay_out_state` lays a seeded state out on such
a mesh by JAX's rules and :func:`shard_batch` a global batch. A gather of
a card's tensor over gloo goes through the host, inside autograd too
(``core/mesh_axis.redistribute``): gloo's all-gather of card tensors fails
in DTensor's collectives. With a ``mesh`` (a ``DeviceMesh``) and a topology the
step is JAX's explicit branch over DTensors: it runs once a device in a
``local_map`` manual over the merge dims (:func:`merge_axes_on_mesh`), the
parameters gathered whole over them and the batch ``Shard(0)``, the loss's
mean taken there (JAX's ``pmean``); each device's
gradients are merged by the same engine over a
``core/mesh_axis.MeshAxis``, whose collectives are ``torch.distributed``
calls among the mesh's processes, and the deferred and overlapped steps
are the same :class:`DeferredTrainStep` over that axis, their pendings a
global ``[dp, ...]`` stack ``Shard(0)`` over the merge dims. As in JAX, a
mesh whose other dims have size > 1 is refused.

The plan half (the JAX module's ``lowering_rules``, ``axes_to_shardings``,
``opt_state_axes``, ``plan_train``, ``plan_prefill``, ``plan_decode`` and
``plan_for``) plans a cell of the production mesh without devices: a
:class:`StepPlan` holds the step, the specs and logical axes of its inputs
and the rules, and :meth:`StepPlan.trace` runs the step on fake DTensors
over a fake process group (``launch/mesh.py``) under the op-level cost walk
(``launch/op_cost.py``), where JAX lowers and compiles. Every family is
planned: each builds its abstract model through
``models/registry.abstract_model`` and takes its own inputs and caches
(``input_specs`` / ``input_axes``, the caches of a decode of the same
batch and length for a prefill to fill). ``plan_train(merge_plan=,
merge_compress=, defer_schedule=)`` plans the explicit step on the mesh
instead: its walk counts the merge's exchanges by the plan's levels, and
a deferred plan carries every commit variant (``StepPlan.defer_step``).
"""

from __future__ import annotations

import contextlib
import math
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
from repro_torch.core.mesh_axis import MeshAxis, merge_ranks, redistribute
from repro_torch.core.stacked import StackedAxis
from repro_torch.sharding import partition

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


def merge_axes_on_mesh(mesh, topology: Optional[Topology]
                       ) -> tuple[str, ...]:
    """The mesh dims a gradient-merge topology reduces over (the JAX
    package's mesh form of ``merge_axes_for``): a plan pinned to an axis
    (``axis_name``, a dim or a tuple of dims) wins; otherwise the mesh's
    data-parallel dims, ``("pod", "data")`` on the multi-pod mesh (one
    flattened merge axis), ``("data",)`` elsewhere."""
    axis = getattr(topology, "axis_name", None)
    if axis is None:
        names = tuple(mesh.mesh_dim_names)
        return tuple(a for a in ("pod", "data") if a in names) or ("data",)
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _mesh_merge_dims(mesh, topology: Topology) -> tuple[str, ...]:
    """The merge dims of an explicit step on ``mesh``, under JAX's
    restriction: every other mesh dim must have size 1."""
    dims = merge_axes_on_mesh(mesh, topology)
    shape = partition.mesh_shape(mesh)
    missing = [d for d in dims if d not in shape]
    if missing:
        raise ValueError(f"merge axes {dims} are not dims of the mesh "
                         f"{tuple(shape)}")
    auto = sorted(a for a, n in shape.items() if a not in dims and n > 1)
    if auto:
        raise NotImplementedError(
            f"explicit hierarchical gradient merge needs the non-merge mesh "
            f"axes to be trivial, but {auto} have size > 1; the JAX package "
            f"refuses such a mesh (its partitioner cannot split this model "
            f"under a partial-auto shard_map), and so does the port. Use a "
            f"pure data-parallel mesh for the merge plan, or the implicit "
            f"reduction for tensor-parallel cells.")
    return dims


def _device_of(params: PyTree) -> torch.device:
    return pytree.tree_leaves(params)[0].device


def to_device(batch: PyTree, device: torch.device) -> PyTree:
    """A numpy (or tensor) batch on ``device``; a DTensor stays as it is
    (its shards are where its mesh put them)."""
    return pytree.tree_map(lambda x: x if partition.is_dtensor(x)
                           else torch.as_tensor(x, device=device), batch)


def mesh_device(mesh) -> torch.device:
    """The device this process's shards of ``mesh`` live on: its current
    card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicated(mesh) -> list:
    """``Replicate()`` on every dim of ``mesh``."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def shard_batch(batch: PyTree, mesh, dims: tuple = ("data",)) -> PyTree:
    """A global numpy (or tensor) batch as DTensors ``Shard(0)`` over
    ``dims`` of ``mesh``, replicated over the others: every process is
    handed the whole batch (it computes it from the step index, JAX's
    multi-controller discipline) and keeps its own rows. No data moves."""
    from torch.distributed.tensor import DTensor, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Shard(0) if n in dims else p
                  for n, p in zip(names, replicated(mesh))]
    device = mesh_device(mesh)

    def make(x):
        if partition.is_dtensor(x):
            return x
        x = torch.as_tensor(x)
        _, n, first = partition.dim_shards(mesh, placements, 0, x.shape[0])
        rows = x[first:first + n].to(device)
        return DTensor.from_local(rows, mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return pytree.tree_map(make, batch)


def lay_out_state(state: PyTree, cfg, shape_cfg, mesh,
                  merge_dims: tuple = ("data",)) -> PyTree:
    """A concrete train state laid out on ``mesh`` by JAX's rules
    (:func:`lowering_rules` through :func:`axes_to_shardings`), each
    process keeping its slice of the same seeded tensors (no data moves):
    ``"params"`` by ``models/layout.param_axes`` and ``"opt"`` by
    :func:`opt_state_axes` (so the FSDP rule, ``embed`` over ``data``,
    splits the parameters and the moments, and on a mesh whose ``"model"``
    dim is above 1 the heads, ``mlp``, ``vocab`` and the experts split
    over it too), the step count replicated; a concrete ``"defer"`` (a
    stacked ``[dp, ...]`` pending cascade) with each pending ``Shard(0)``
    over ``merge_dims`` and its counter replicated. A leaf already a
    DTensor stays as it is. Each process keeps a copy of its slice, not a
    view of the whole; a meta leaf stands for zeros (the optimizer's
    fresh moments, ``optimizer.init`` of meta parameters) and is made as
    zeros of its slice's shape, so that no process holds the whole."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layout import param_axes
    rules = lowering_rules(cfg, shape_cfg, mesh)
    rules[MERGE_RANKS] = (merge_dims if len(merge_dims) > 1
                          else merge_dims[0])
    device = mesh_device(mesh)
    p_axes = param_axes(cfg)
    axes = {"params": p_axes, "opt": opt_state_axes(state["opt"], p_axes)}
    if "defer" in state:
        stack = pytree.tree_map(lambda a: (MERGE_RANKS,) + (None,) * len(a),
                                p_axes, is_leaf=_is_axes)
        d = state["defer"]
        axes["defer"] = {"t": (), "pending": (stack,) * len(d["pending"])}
        if "inflight" in d:
            axes["defer"]["inflight"] = stack
    parts = axes_to_shardings(axes, state, mesh, rules)
    flat_part, spec = pytree.tree_flatten(parts, is_leaf=_is_axes)
    leaves = spec.flatten_up_to(state)

    def lay(x, part):
        if x is None or partition.is_dtensor(x):
            return x
        placements = partition.placements_for(part, mesh)
        x = torch.as_tensor(x)
        if x.is_meta:
            return partition.zeros(tuple(x.shape), x.dtype, mesh,
                                   placements, device=device)
        whole = DTensor.from_local(x.to(device), mesh, replicated(mesh),
                                   run_check=False)
        # replicated -> split is a local slice: no collective
        out = whole.redistribute(mesh, placements)
        return DTensor.from_local(out.to_local().clone(), mesh, placements,
                                  run_check=False, shape=out.shape,
                                  stride=out.stride())
    return pytree.tree_unflatten([lay(x, pt) for x, pt in
                                  zip(leaves, flat_part)], spec)


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


class _Stacked:
    """The ``dp`` ranks stacked on one device: each rank's gradients into
    slice ``r`` of ``[dp, ...]`` stacks (:func:`rank_grads`), merged over a
    :class:`StackedAxis` one leaf at a time (:func:`_leafwise`)."""

    def __init__(self, grads_of, dp: int):
        self.grads_of = grads_of
        self.dp = dp

    def replicating(self):
        return contextlib.nullcontext()

    def grads_step(self, params, batch, bufs: list, leaf_fn, n_out: int,
                   settles: bool):
        """Every rank's loss and gradients, then ``leaf_fn(axis, grad,
        *bufs' leaves) -> (n_out new buffer leaves, settled leaf or None)``
        at each leaf position -> (mean loss, the ``n_out`` new buffer
        trees, the settled tree or None)."""
        axis = StackedAxis(self.dp, _device_of(params))
        loss, stack = rank_grads(self.grads_of, params,
                                 to_device(batch, axis.device), self.dp)
        with torch.profiler.record_function("train.merge"):
            out, spec = _leafwise(lambda g, *b: leaf_fn(axis, g, *b), stack,
                                  *bufs, consume=True)
        new = [pytree.tree_unflatten([o[0][j] for o in out], spec)
               for j in range(n_out)]
        settled = (pytree.tree_unflatten([o[1] for o in out], spec)
                   if settles else None)
        return loss, new, settled

    def settle(self, params, trees: list, leaf_fn):
        """``leaf_fn(axis, *leaves) -> settled leaf`` at each leaf position
        of ``trees`` -> the settled tree (a flush: no gradients)."""
        axis = StackedAxis(self.dp, _device_of(params))
        out, spec = _leafwise(lambda *x: leaf_fn(axis, *x), *trees)
        return pytree.tree_unflatten(out, spec)

    def identity(self, params, merge_fn) -> PyTree:
        """The merge's identity as a ``[dp, ...]`` stack of each
        parameter."""
        return pytree.tree_map(
            lambda p: merge_fn.identity((self.dp,) + tuple(p.shape), p.dtype,
                                        device=p.device), params)

    def reset(self, tree, merge_fn) -> PyTree:
        return merge_fn.tree_identity(tree)


class _OnMesh:
    """One rank a device of ``mesh``: the step's work runs in a
    ``local_map`` manual over the merge ``dims`` (JAX's ``shard_map``),
    on each device's local tensors: the parameters gathered whole over the
    merge dims at the region's edge (JAX's ``P()`` in_specs: FSDP-sharded
    parameters are all-gathered there), its ``Shard(0)`` rows of the batch
    and its ``[1, ...]`` slice of each ``[dp, ...]`` buffer; the merge
    runs over a :class:`MeshAxis`. The loss leaves replicated, its mean
    taken over the ranks in the region (JAX's ``pmean``); the settled
    gradients leave replicated over the merge dims (JAX's ``P()``
    out_specs) and are laid onto their parameters' placements for the
    optimizer (a local slice of an FSDP parameter's), the buffers
    ``Shard(0)`` over the merge dims."""

    def __init__(self, grads_of, mesh, dims: tuple):
        self.grads_of = grads_of
        self.mesh = mesh
        self.dims = dims
        names = list(mesh.mesh_dim_names)
        self._merge = {names.index(d) for d in dims}
        self.dp = merge_ranks(mesh, dims)

    def replicating(self):
        """DTensor takes a plain tensor the step makes (a scale, the
        optimizer's step count) as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def _placed(self, p, stacked: bool) -> list:
        """A parameter's placements in the region: whole over the merge
        dims; or those of its ``[dp, ...]`` stack (``Shard(0)`` over the
        merge dims, the parameter's dims one further)."""
        from torch.distributed.tensor import Replicate, Shard
        return [(Shard(0) if stacked else Replicate()) if i in self._merge
                else Shard(x.dim + 1) if stacked and isinstance(x, Shard)
                else x for i, x in enumerate(p.placements)]

    def _laid(self, tree, params) -> PyTree:
        """Settled gradients onto their parameters' placements."""
        return pytree.tree_map(lambda g, p: redistribute(g, p.placements),
                               tree, params)

    def _batch_placements(self) -> list:
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(0) if i in self._merge else Replicate()
                for i in range(self.mesh.ndim)]

    def _run(self, region, flat_in: list, in_pl: list, out_pl: list):
        from torch.distributed.tensor.experimental import local_map
        return local_map(region, out_placements=tuple(out_pl),
                         in_placements=tuple(in_pl), device_mesh=self.mesh,
                         redistribute_inputs=True)(*flat_in)

    def grads_step(self, params, batch, bufs: list, leaf_fn, n_out: int,
                   settles: bool):
        """As :meth:`_Stacked.grads_step`, once a device."""
        from torch.distributed.tensor import Replicate
        p_leaves, spec = pytree.tree_flatten(params)
        b_leaves, b_spec = pytree.tree_flatten(batch)
        buf_leaves = [pytree.tree_leaves(b) for b in bufs]
        n_p, n_b = len(p_leaves), len(b_leaves)
        grads_of, dims = self.grads_of, self.dims
        mesh = self.mesh

        def region(*flat):
            local = pytree.tree_unflatten(list(flat[:n_p]), spec)
            rows = pytree.tree_unflatten(list(flat[n_p:n_p + n_b]), b_spec)
            rest = flat[n_p + n_b:]
            held = [list(rest[j * n_p:(j + 1) * n_p])
                    for j in range(len(bufs))]
            with partition.manual_axes(dims):
                loss, grads = grads_of(local, rows)
            axis = MeshAxis(mesh, dims, _device_of(local))
            loss = axis.pmean(loss)
            g = [x[None] for x in pytree.tree_leaves(grads)]
            del grads
            new = [[None] * n_p for _ in range(n_out)]
            settled = []
            with torch.profiler.record_function("train.merge"):
                for k in range(n_p):
                    nb, st = leaf_fn(axis, g[k], *(h[k] for h in held))
                    g[k] = None
                    for j, t in enumerate(nb):
                        new[j][k] = t
                    if settles:
                        settled.append(st)
            return tuple([loss] + [t for row in new for t in row] + settled)

        param_pl = [self._placed(p, False) for p in p_leaves]
        stack_pl = [self._placed(p, True) for p in p_leaves]
        in_pl = (param_pl + [self._batch_placements()] * n_b
                 + stack_pl * len(bufs))
        out_pl = ([[Replicate()] * mesh.ndim] + stack_pl * n_out
                  + (param_pl if settles else []))
        # the parameters gathered whole over the merge dims before the
        # region (staged through the host where the backend needs it)
        whole = [redistribute(p, pl) for p, pl in zip(p_leaves, param_pl)]
        out = self._run(region, whole + b_leaves
                        + [t for row in buf_leaves for t in row], in_pl,
                        out_pl)
        new = [pytree.tree_unflatten(list(out[1 + j * n_p:1 + (j + 1) * n_p]),
                                     spec) for j in range(n_out)]
        settled = (self._laid(pytree.tree_unflatten(
            list(out[1 + n_out * n_p:]), spec), params) if settles else None)
        return out[0], new, settled

    def settle(self, params, trees: list, leaf_fn):
        """As :meth:`_Stacked.settle`, once a device."""
        p_leaves, spec = pytree.tree_flatten(params)
        n_p = len(p_leaves)
        mesh, dims = self.mesh, self.dims

        def region(*flat):
            axis = MeshAxis(mesh, dims, flat[0].device)
            return tuple(leaf_fn(axis, *(flat[j * n_p + k]
                                         for j in range(len(trees))))
                         for k in range(n_p))

        stack_pl = [self._placed(p, True) for p in p_leaves]
        out = self._run(region,
                        [t for tr in trees for t in pytree.tree_leaves(tr)],
                        stack_pl * len(trees),
                        [self._placed(p, False) for p in p_leaves])
        return self._laid(pytree.tree_unflatten(list(out), spec), params)

    def identity(self, params, merge_fn) -> PyTree:
        """The merge's identity as a global ``[dp, ...]`` stack of each
        parameter, ``Shard(0)`` over the merge dims (each device makes its
        ``[1, ...]`` slice: the other dims have size 1)."""
        from torch.distributed.tensor import DTensor

        def make(p):
            shape = (self.dp,) + tuple(p.shape)
            t = merge_fn.identity((1,) + tuple(p.shape), p.dtype,
                                  device=p.to_local().device)
            return DTensor.from_local(
                t, self.mesh, self._placed(p, True), run_check=False,
                shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        return pytree.tree_map(make, params)

    def reset(self, tree, merge_fn) -> PyTree:
        from torch.distributed.tensor import DTensor

        def make(x):
            t = merge_fn.identity(tuple(x.to_local().shape), x.dtype,
                                  device=x.to_local().device)
            return DTensor.from_local(t, x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return pytree.tree_map(make, tree)


def make_train_step(model, cfg, optimizer, num_microbatches: int = 1, *,
                    dp: Optional[int] = None, mesh=None,
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

    With a ``mesh`` too, the step runs over DTensors on it, one rank a
    device (:class:`_OnMesh`; module doc): the parameters gathered whole
    over the merge dims for the region (whatever their layout; the
    optimizer steps them, and its state, in their own), the batch
    ``Shard(0)`` over them, ``dp`` their product; a mesh with another dim
    of size > 1 raises ``NotImplementedError``, as JAX's does. A ``mesh``
    without a topology gives the implicit step over the mesh's DTensors
    (:func:`_implicit_step`): each parameter gathered over the data dims
    alone, leaf by leaf where the model uses it (the tree once a step
    where the ``"model"`` dim is 1).
    """

    grads_of = grads_fn(model, num_microbatches)
    if merge_topology is None and defer_schedule is not None:
        raise ValueError("defer_schedule needs a merge_topology with :defer "
                         "levels")
    if merge_topology is None and mesh is not None:
        return _implicit_step(model, optimizer, num_microbatches,
                              split_cfg=cfg, donate=donate)
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
    if mesh is not None:
        dims = _mesh_merge_dims(mesh, merge_topology)
        dp = merge_ranks(mesh, dims)
    n_ranks = merge_axes_for(merge_topology, dp)
    runner = (_Stacked(grads_of, n_ranks) if mesh is None
              else _OnMesh(grads_of, mesh, dims))
    grad_merge_fn = int8_compressed_add() if merge_compress else ADD

    if defer_schedule is not None:
        return _make_deferred_train_step(
            grads_of, optimizer, merge_topology, merge_compress,
            defer_schedule, n_ranks, grad_merge_fn, donate, runner=runner)

    def merged(axis, g):
        return [], _rank0(merge_gradients(
            g, axis, merge_fn=grad_merge_fn, topology=merge_topology,
            compress=merge_compress))

    def train_step(state, batch):
        with runner.replicating():
            loss, _, grads = runner.grads_step(state["params"], batch, [],
                                               merged, 0, True)
            with torch.profiler.record_function("train.optimizer"):
                params, opt_state, stats = optimizer.step(
                    state["params"], grads, state["opt"], donate=donate)
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
                 settle_mode: Optional[str] = None, donates: bool = False,
                 mesh=None, merge_dims: tuple = ("data",)):
        self.variants = variants
        # the mesh the step runs over (None: stacked ranks) and its
        # merge dims: where the pendings live
        self.mesh = mesh
        self.merge_dims = merge_dims
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
                                self.dp, self.overlap, mesh=self.mesh,
                                merge_dims=self.merge_dims)

    def flush(self, state) -> tuple[dict, Optional[dict]]:
        """Final flush: land an in-flight launched cycle (overlap), then
        settle any trailing partial cycle through every deferred level and
        step the optimizer on its mean. Returns ``(new_state, metrics)``;
        metrics is ``None`` when there was nothing to flush."""
        return self._flush_fn(state)


def _make_deferred_train_step(grads_of, optimizer, plan, merge_compress: bool,
                              schedule: DeferSchedule, dp: int,
                              grad_merge_fn, donate: bool = False,
                              runner=None) -> DeferredTrainStep:
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

    ``runner`` holds the ranks: stacked on one device (the default,
    :class:`_Stacked`) or one a device of a mesh (:class:`_OnMesh`); the
    cascade is the same code over either's axis.
    """
    runner = runner or _Stacked(grads_of, dp)
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

    def _zero_metrics(loss):
        return {"loss": loss, "grad_norm": torch.zeros((), dtype=torch.float32),
                "lr": torch.zeros((), dtype=torch.float32)}

    def make_variant(due: int, land: bool = False):
        # One maker for both pipelines: the optimizer consumes a settled
        # cycle on a serialized full-commit step or an overlapped land step.
        commits = land if overlap else due == n_def

        def cascade(axis, g, *bufs):
            """One leaf's cascade -> (its new buffers, inflight first when
            overlapped; rank 0's settled cycle or None)."""
            if overlap:
                inf, *p = bufs
                new_p, new_inf, landed = ccache.overlap_cascade(
                    g, list(p), inf, due, land, axis, grad_merge_fn, plan,
                    compress=merge_compress)
                return [new_inf] + list(new_p), _rank0(landed)
            new_p, settled = ccache.defer_cascade(
                g, list(bufs), due, axis, grad_merge_fn, plan,
                compress=merge_compress)
            return list(new_p), _rank0(settled)

        def step(state, batch):
            params = state["params"]
            d = state["defer"]
            bufs = ([d["inflight"]] if overlap else []) + list(d["pending"])
            with runner.replicating():
                loss, new, settled = runner.grads_step(
                    params, batch, bufs, cascade, len(bufs), commits)
                if commits:
                    params, opt_state, stats = _opt_step(
                        params, state["opt"], settled, scale)
                    metrics = {"loss": loss, **stats}
                else:
                    opt_state = state["opt"]
                    metrics = _zero_metrics(loss)
            new_defer = {"t": d["t"] + 1}
            if overlap:
                new_defer["inflight"], new = new[0], new[1:]
            new_defer["pending"] = tuple(new)
            return ({"params": params, "opt": opt_state,
                     "defer": new_defer}, metrics)

        return step

    def init_defer_state(params):
        # the buffers start as the merge's identity; nothing writes them in
        # place, so they share one tree
        zeros = runner.identity(params, grad_merge_fn)
        state = {"t": torch.zeros((), dtype=torch.int32),
                 "pending": (zeros,) * n_def}
        if overlap:
            state["inflight"] = zeros
        return state

    def flush(state):
        d = state["defer"]
        t = int(d["t"])
        params, opt_state = state["params"], state["opt"]
        metrics = None
        new_defer = dict(d)
        # A drained buffer is the merge's identity. Every consumer makes new
        # tensors from it and none writes it, so the drained buffers share
        # one tree of zeros.
        zeros = runner.reset(d["pending"][0], grad_merge_fn)
        with runner.replicating():
            if overlap and t >= 1 and schedule.due_count(t) == n_def:
                # The last step launched a cycle that never landed.
                landed = runner.settle(
                    params, [d["inflight"]],
                    lambda axis, x: _rank0(ccache.settle_inflight(
                        x, axis, grad_merge_fn, plan,
                        compress=merge_compress)))
                params, opt_state, stats = _opt_step(params, opt_state,
                                                     landed, scale)
                new_defer["inflight"] = zeros
                metrics = {"flushed_inflight": True, **stats}
            m = t % period
            if m > 0:
                # Trailing partial cycle: settle every deferred level on
                # the outstanding pendings (zero delta — no new gradient)
                # and step the optimizer on the mean over the m accumulated
                # steps.
                settled = runner.settle(
                    params, list(d["pending"]),
                    lambda axis, *p: _rank0(ccache.defer_cascade(
                        grad_merge_fn.tree_identity(p[0]), list(p), n_def,
                        axis, grad_merge_fn, plan,
                        compress=merge_compress)[1]))
                pscale = 1.0 / (dp * m) if mean else 1.0
                params, opt_state, stats = _opt_step(params, opt_state,
                                                     settled, pscale)
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
                             settle_mode=settle_mode, donates=donate,
                             mesh=getattr(runner, "mesh", None),
                             merge_dims=getattr(runner, "dims", ("data",)))


# ---------------------------------------------------------------------------
# The plan half: logical rules, fake DTensor inputs, the traced step.
# ---------------------------------------------------------------------------

def lowering_rules(cfg, shape_cfg, mesh) -> dict:
    """Per (arch x shape x mesh) logical->mesh adjustments, as JAX's."""
    from repro_torch.sharding.partition import mesh_shape
    shape = mesh_shape(mesh)
    rules: dict = {}
    model_size = shape.get("model", 1)
    dp = shape.get("data", 1) * shape.get("pod", 1)
    if shape_cfg.kind == "train":
        # Sequence parallelism for the stored residual stream, only when
        # the saved stack would otherwise pass a few GB a device.
        tokens_per_dev = shape_cfg.global_batch * shape_cfg.seq_len // max(
            dp, 1)
        saved_bytes = cfg.n_layers * tokens_per_dev * cfg.d_model * 2
        if saved_bytes > 4 * 1024**3 and model_size > 1:
            rules["seq_res"] = "model"
    if shape_cfg.kind == "decode":
        if cfg.n_kv_heads % model_size != 0:
            # KV heads don't divide TP: shard the cache on sequence instead.
            rules["kv_heads"] = None
            rules["cache_seq"] = "model"
    if cfg.n_params() > 1e11:
        # Giants: FSDP the embed dim across pods too.
        rules["embed"] = ("pod", "data")
    return rules


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def axes_to_shardings(axes_tree: PyTree, specs_tree: PyTree, mesh,
                      rules: dict) -> PyTree:
    """Tree of logical-axes tuples + tree of specs -> tree of partition
    specs (tuples, as JAX's ``PartitionSpec``)."""
    from repro_torch.sharding.partition import spec_for
    flat_ax, spec = pytree.tree_flatten(axes_tree, is_leaf=_is_axes)
    flat_sp = spec.flatten_up_to(specs_tree)
    return pytree.tree_unflatten(
        [None if s is None else spec_for(tuple(s.shape), a, mesh, rules)
         for a, s in zip(flat_ax, flat_sp)], spec)


def opt_state_axes(opt_specs, param_axes: PyTree):
    """Logical axes for optimizer state, mirroring the parameter axes."""
    from repro_torch.optim.optimizers import OptState, _is_moment

    def nu_axes(ax, nu_leaf):
        if isinstance(nu_leaf, dict) and "row" in nu_leaf:
            return {"row": tuple(ax[:-1]), "col": tuple(ax[:-2]) + (ax[-1],)}
        if isinstance(nu_leaf, dict) and "full" in nu_leaf:
            return {"full": tuple(ax)}
        return tuple(ax)

    flat_ax, spec = pytree.tree_flatten(param_axes, is_leaf=_is_axes)
    mu = (None if opt_specs.mu is None
          else pytree.tree_unflatten(flat_ax, spec))
    flat_nu = pytree.tree_leaves(opt_specs.nu, is_leaf=_is_moment)
    nu = pytree.tree_unflatten([nu_axes(a, n) for a, n in
                                zip(flat_ax, flat_nu)], spec)
    return OptState(step=(), mu=mu, nu=nu)


def opt_state_specs(cfg, param_specs: PyTree):
    """The optimizer state's specs for parameters of ``param_specs``, as
    ``make_optimizer(cfg, ...).init`` lays them out (f32 moments, the
    step a 0-dim int32)."""
    from repro_torch.models.layout import Spec
    from repro_torch.optim.optimizers import OptState
    f32 = torch.float32
    is_spec = lambda x: isinstance(x, Spec)
    if cfg.optimizer == "adafactor":
        def nu_for(p):
            if len(p.shape) >= 2:
                return {"row": Spec(p.shape[:-1], f32),
                        "col": Spec(p.shape[:-2] + p.shape[-1:], f32)}
            return {"full": Spec(p.shape, f32)}
        return OptState(step=Spec((), torch.int32), mu=None,
                        nu=pytree.tree_map(nu_for, param_specs,
                                           is_leaf=is_spec))
    moment = pytree.tree_map(lambda p: Spec(p.shape, f32), param_specs,
                             is_leaf=is_spec)
    return OptState(step=Spec((), torch.int32), mu=moment, nu=moment)


class StepPlan:
    """Everything needed to trace one (arch x shape x mesh) cell: the step,
    its inputs' specs and logical axes (parallel trees), and the rules.

    :meth:`trace` builds each input as a meta DTensor laid out by its axes
    (nothing is allocated), runs the step under the rules and the op-level
    walk, and returns the walk's counts.

    A train plan with an explicit merge (JAX's ``LoweredPlan`` of
    ``plan_train(merge_plan=...)``) also holds the plan's ``levels`` (its
    sizes and names, innermost first: the walk's levels by default), and,
    for a deferred plan, ``defer_step``, the :class:`DeferredTrainStep`
    with every commit variant; ``fn`` is then the superset program (the
    full commit, or its land twin when overlapped), :attr:`noncommit_fn`
    the due-0 variant, and :meth:`trace_variant` traces any variant
    against the plan's specs (JAX's ``lower_variant``)."""

    def __init__(self, fn, in_specs, in_axes, rules: dict, mesh,
                 defer_step: Optional["DeferredTrainStep"] = None,
                 levels: Optional[tuple] = None):
        self.fn = fn
        self.in_specs = in_specs
        self.in_axes = in_axes
        self.rules = rules
        self.mesh = mesh
        self.defer_step = defer_step
        self.levels = levels

    @property
    def noncommit_fn(self):
        """The zero-commit (due = 0) step, what a deferred plan runs between
        commits; None without deferred levels. Its walk moves nothing on
        the deferred levels (CC020)."""
        if self.defer_step is None:
            return None
        return self.defer_step.variants[0]

    def shardings(self) -> PyTree:
        """The inputs' partition specs."""
        return axes_to_shardings(self.in_axes, self.in_specs, self.mesh,
                                 self.rules)

    def inputs(self) -> PyTree:
        """Meta DTensors for the inputs: shapes, dtypes and placements, no
        data."""
        from torch.distributed.tensor import DTensor
        from repro_torch.sharding.partition import local_shape, placements_for
        mesh = self.mesh

        def make(spec, part):
            if spec is None:
                return None
            shape = tuple(spec.shape)
            local = torch.empty(local_shape(shape, part, mesh),
                                dtype=spec.dtype, device="meta")
            stride = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                stride[i] = stride[i + 1] * shape[i + 1]
            return DTensor.from_local(local, mesh,
                                      placements_for(part, mesh),
                                      run_check=False, shape=torch.Size(shape),
                                      stride=tuple(stride))

        from repro_torch.models.layout import Spec
        flat_sp, spec = pytree.tree_flatten(
            self.in_specs, is_leaf=lambda x: isinstance(x, Spec))
        flat_part = spec.flatten_up_to(self.shardings())
        return pytree.tree_unflatten(
            [make(s, p) for s, p in zip(flat_sp, flat_part)], spec)

    def merged(self):
        """(mesh, rules) to trace on: mesh axes that the rules only ever
        name together (``("pod", "data")`` when the giants' FSDP joins the
        batch there) become one mesh dim over the same ranks, when every
        input dim they split divides by the whole group. The local shapes,
        the groups and so the counts are the same; DTensor then plans one
        collective over the group (JAX's one replica group) and searches far
        fewer placements."""
        from repro_torch.sharding.partition import DEFAULT_RULES
        rules = dict(DEFAULT_RULES, **self.rules)
        names = list(self.mesh.mesh_dim_names)
        groups = {v for v in rules.values()
                  if isinstance(v, tuple) and len(v) > 1}
        for grp in groups:
            idx = [names.index(a) for a in grp if a in names]
            alone = any(v in grp for v in rules.values()
                        if not isinstance(v, tuple)) or any(
                v != grp and set(v) & set(grp) for v in rules.values()
                if isinstance(v, tuple))
            if (len(idx) != len(grp) or alone
                    or idx != list(range(idx[0], idx[0] + len(idx)))
                    or not self._divides(grp)):
                continue
            from torch.distributed.device_mesh import DeviceMesh
            shape = list(self.mesh.shape)
            ranks = self.mesh.mesh.reshape(
                shape[:idx[0]] + [math.prod(shape[i] for i in idx)]
                + shape[idx[-1] + 1:])
            name = "_".join(grp)
            new_names = names[:idx[0]] + [name] + names[idx[-1] + 1:]
            mesh = DeviceMesh(self.mesh.device_type, ranks,
                              mesh_dim_names=tuple(new_names))
            return mesh, {k: (name if v == grp else v)
                          for k, v in rules.items()}
        return self.mesh, self.rules

    def _divides(self, grp) -> bool:
        """Whether every input dim the rules give to ``grp`` takes it
        whole."""
        from repro_torch.models.layout import Spec
        from repro_torch.sharding.partition import DEFAULT_RULES, spec_for
        rules = dict(DEFAULT_RULES, **self.rules)
        flat_ax, spec = pytree.tree_flatten(self.in_axes, is_leaf=_is_axes)
        flat_sp = spec.flatten_up_to(self.in_specs)
        for ax, sp in zip(flat_ax, flat_sp):
            if not isinstance(sp, Spec):
                continue
            part = spec_for(tuple(sp.shape), ax, self.mesh, self.rules)
            for e, name in zip(part, ax):
                if rules.get(name) == grp and e != grp:
                    return False
        return True

    def trace(self, level_sizes=None, level_names=None) -> dict:
        """Run the step once on meta DTensors under :class:`OpWalk`; -> the
        walk's result."""
        return self.trace_variant(self.fn, level_sizes, level_names)

    def trace_variant(self, fn, level_sizes=None, level_names=None) -> dict:
        """:meth:`trace` of ``fn``, another step of the same inputs (a
        variant of ``defer_step``). An explicit merge's walk takes the
        plan's levels unless others are given, and its mesh stays as it is
        (the step's ``local_map`` is over its dims)."""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.launch.op_cost import OpWalk
        from repro_torch.sharding.partition import sharding_rules
        if self.levels is not None:
            mesh, rules = self.mesh, self.rules
            if level_sizes is None:
                level_sizes, level_names = self.levels
        else:
            mesh, rules = self.merged()
        plan = StepPlan(fn, self.in_specs, self.in_axes, rules, mesh)
        walk = OpWalk(mesh, level_sizes, level_names, device="meta")
        # a tensor the model makes (positions, RoPE tables, masks) is the
        # same on every device: DTensor takes it as replicated
        with implicit_replication(), sharding_rules(mesh, rules):
            args = plan.inputs()
            walk.add_inputs(args)
            with walk:
                out = fn(*args)
            walk.add_outputs(out)
            del out, args
        return walk.result()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """``argmax(logits, -1)`` as int32; for DTensor logits with the vocab
    split over mesh dims, each device takes its slice's best and the
    slices' bests (one value a row each) meet on every device."""
    if not hasattr(logits, "placements"):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.partition import dim_shards
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab, n, first = dim_shards(mesh, logits.placements, last,
                                 logits.shape[-1])
    if not vocab:      # each device holds whole rows: argmax in place
        keep = [p if isinstance(p, Shard) and p.dim < last else Replicate()
                for p in logits.placements]
        return local_map(lambda lg: torch.argmax(lg, dim=-1).to(torch.int32),
                         out_placements=keep, in_placements=(keep,),
                         device_mesh=mesh, redistribute_inputs=True)(logits)
    lg_in, out = [], []
    for i, p in enumerate(logits.placements):
        batch = isinstance(p, Shard) and p.dim < last
        lg_in.append(Shard(last) if i in vocab else p if batch
                     else Replicate())
        out.append(Shard(0) if i in vocab else Shard(p.dim + 1) if batch
                   else Replicate())

    def local(lg):
        best, idx = lg.max(-1)
        return best[None], (idx + first).to(torch.int32)[None]

    best, idx = local_map(local, out_placements=(out, out),
                          in_placements=(lg_in,), device_mesh=mesh,
                          redistribute_inputs=True)(logits)
    whole = [Replicate() if i in vocab else p for i, p in enumerate(out)]
    best, idx = best.redistribute(mesh, whole), idx.redistribute(mesh, whole)
    return torch.gather(idx, 0, best.argmax(0)[None])[0]


def _sharded_microbatches(vg, params, batch, n: int):
    """``vg(params, batch)`` summed over ``n`` microbatches and averaged,
    each device's rows ``i::n`` of its shard in microbatch ``i`` (so the
    batch stays sharded) -> (loss, grads)."""
    if n == 1:
        return vg(params, batch)
    micro = pytree.tree_map(
        lambda x: x.reshape((x.shape[0] // n, n) + tuple(x.shape[1:])), batch)
    loss, grads = None, None
    for i in range(n):
        l, g = vg(params, pytree.tree_map(lambda x: x[:, i], micro))
        loss = l if loss is None else loss + l
        grads = g if grads is None else pytree.tree_map(torch.add, grads, g)
        del g
    return loss / n, pytree.tree_map(lambda g: g / n, grads)


def _implicit_step(model, optimizer, num_microbatches: int, *,
                   split_cfg=None, donate: bool = False):
    """The implicit step over DTensors (JAX's default step on a mesh): the
    loss and its backward (summed over ``num_microbatches``, each device's
    rows ``i::n`` of its shard, so the batch stays sharded), each gradient
    reduced onto its parameter's layout (the data axes' reduce-scatter, as
    the jitted step's out_shardings ask), the global-norm clip and the
    optimizer on the parameters' layout.

    Two forms. The planner's (no ``split_cfg``), over fake meshes whose
    model axis may split the parameters: DTensor gathers each parameter
    where an op needs it, as GSPMD does, so a tensor-parallel parameter
    stays split (the planner installs its rules). With ``split_cfg`` (the
    config: the step on a real group's train mesh, one process a device)
    the step installs JAX's rules for its batch's shape
    (:func:`lowering_rules`, so that the blocks' constraints and the MoE's
    expert-parallel form see the mesh, as JAX's ``_moe`` sees its mesh)
    and gathers each parameter over the data dims alone, leaf by leaf
    where the model uses it (``partition.gather_at_use``): it stays split
    over ``"model"``, and no step holds the tree whole at once for its own
    sake. Where the ``"model"`` dim is 1 a parameter so gathered is whole,
    so the tree is gathered once at the top of the step instead, outside
    autograd, and the uses' gathers move nothing (nor do remat's
    recomputes). Every gather of a card's tensor
    over gloo goes through the host, its gradient back by the matching
    reduce-scatter (``core/mesh_axis.redistribute``; DTensor's own
    gathers of a card's tensors fail on gloo: module doc), and the loss
    leaves replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    vg = value_and_grad(lambda p, b: model.loss(p, b)[0])

    def rules_for(params, batch):
        if split_cfg is None:
            return contextlib.nullcontext()
        from repro_torch.configs.base import ShapeConfig
        mesh = pytree.tree_leaves(params)[0].device_mesh
        b, s = pytree.tree_leaves(batch)[0].shape[:2]
        rules = lowering_rules(split_cfg, ShapeConfig("step", s, b, "train"),
                               mesh)
        stack = contextlib.ExitStack()
        stack.enter_context(partition.sharding_rules(mesh, rules))
        stack.enter_context(partition.gather_at_use(
            tuple(d for d in mesh.mesh_dim_names if d != "model")))
        return stack

    def whole_at_top(params) -> bool:
        if split_cfg is None:
            return False
        mesh = pytree.tree_leaves(params)[0].device_mesh
        names = mesh.mesh_dim_names
        return "model" not in names or mesh.size(names.index("model")) == 1

    def train_step(state, batch):
        params = state["params"]
        with implicit_replication():
            use = (pytree.tree_map(
                lambda p: redistribute(p, replicated(p.device_mesh)), params)
                if whole_at_top(params) else params)
            with rules_for(params, batch):
                loss, grads = _sharded_microbatches(vg, use, batch,
                                                    num_microbatches)
            del use
            grads = pytree.tree_map(lambda g, p: redistribute(g, p.placements),
                                    grads, params)
            if split_cfg is not None:
                loss = redistribute(loss, replicated(loss.device_mesh))
            with torch.profiler.record_function("train.optimizer"):
                params, opt_state, stats = optimizer.step(
                    params, grads, state["opt"], donate=donate)
        return {"params": params, "opt": opt_state}, {"loss": loss, **stats}

    train_step.donates = donate
    return train_step


def _abstract_model(cfg):
    from repro_torch.models.registry import abstract_model
    return abstract_model(cfg)


# The logical axis of a pending stack's leading dim: the rules map it to
# the merge dims.
MERGE_RANKS = "merge_ranks"


def plan_train(cfg, shape_cfg, mesh, num_microbatches: Optional[int] = None,
               extra_rules: Optional[dict] = None,
               merge_plan: Optional[Topology] = None,
               merge_compress: bool = False,
               defer_schedule: Optional[DeferSchedule] = None) -> StepPlan:
    """The production train plan: the implicit step (each gradient
    reduced onto its parameter's layout by DTensor), or with ``merge_plan``
    the data-parallel gradient reduction routed through the CCache engine
    (:func:`make_train_step` over the mesh) under the same rules: the
    parameters and the optimizer's state keep their layout (FSDP over
    ``data``), and the step gathers the parameters over the merge dims,
    as JAX's ``shard_map`` does. A plan with ``:defer`` levels also takes a
    ``defer_schedule``: the state then carries the pending cascade,
    ``state["defer"]`` (each buffer a ``[dp, ...]`` stack whose leading
    dim, logical axis :data:`MERGE_RANKS`, the rules map to the merge
    dims), and the plan's ``defer_step`` holds every commit variant. As in
    JAX, every non-merge mesh dim must have size 1 (``NotImplementedError``
    otherwise)."""
    from repro_torch.models.layout import Spec, param_axes, param_specs
    from repro_torch.optim import make_optimizer, warmup_cosine
    model = _abstract_model(cfg)
    rules = lowering_rules(cfg, shape_cfg, mesh)
    nmb = (num_microbatches if num_microbatches is not None
           else cfg.microbatches.get(shape_cfg.name, 1))
    p_specs, p_axes = param_specs(cfg), param_axes(cfg)
    o_specs = opt_state_specs(cfg, p_specs)
    optimizer = make_optimizer(cfg, warmup_cosine(3e-4, 100, 10_000))
    specs = ({"params": p_specs, "opt": o_specs}, model.input_specs(shape_cfg))
    axes = ({"params": p_axes, "opt": opt_state_axes(o_specs, p_axes)},
            model.input_axes(shape_cfg))
    if merge_plan is None:
        if defer_schedule is not None:
            raise ValueError("defer_schedule needs a merge_topology with "
                             ":defer levels")
        rules.update(extra_rules or {})
        step = _implicit_step(model, optimizer, nmb)
        return StepPlan(step, specs, axes, rules, mesh)

    dims = _mesh_merge_dims(mesh, merge_plan)
    rules[MERGE_RANKS] = dims if len(dims) > 1 else dims[0]
    rules.update(extra_rules or {})
    step = make_train_step(model, cfg, optimizer, nmb, mesh=mesh,
                           merge_topology=merge_plan,
                           merge_compress=merge_compress,
                           defer_schedule=defer_schedule)
    dp = merge_ranks(mesh, dims)
    plan = (merge_plan if isinstance(merge_plan, MergePlan)
            else merge_plan.to_plan(dp, compress=merge_compress))
    levels = (tuple(lv.size for lv in plan.levels), plan.level_names())
    if not isinstance(step, DeferredTrainStep):
        return StepPlan(step, specs, axes, rules, mesh, levels=levels)
    # The walk's superset program: the full commit, or its land twin when
    # overlapped (the top level's exchange lands there).
    fn = (step.land_variants[-1] if step.land_variants is not None
          else step.variants[-1])
    is_spec = lambda x: isinstance(x, Spec)
    stack = pytree.tree_map(lambda p: Spec((dp,) + tuple(p.shape), p.dtype),
                            p_specs, is_leaf=is_spec)
    # JAX's P(axis): the leading dim over the merge dims, the rest whole
    stack_axes = pytree.tree_map(lambda a: (MERGE_RANKS,) + (None,) * len(a),
                                 p_axes, is_leaf=_is_axes)
    n_def = len(step.deferred_names)
    d_specs = {"t": Spec((), torch.int32), "pending": (stack,) * n_def}
    d_axes = {"t": (), "pending": (stack_axes,) * n_def}
    if step.overlap:
        d_specs["inflight"], d_axes["inflight"] = stack, stack_axes
    specs[0]["defer"], axes[0]["defer"] = d_specs, d_axes
    return StepPlan(fn, specs, axes, rules, mesh, defer_step=step,
                    levels=levels)


def plan_prefill(cfg, shape_cfg, mesh,
                 extra_rules: Optional[dict] = None) -> StepPlan:
    """Prefill of ``shape_cfg``'s batch into caches of its length; the
    attention caches (those a decode of the same batch and length reads,
    laid out by their axes) are an input the step fills, the recurrent
    states (:func:`_written_caches`) its outputs. The batch's other inputs
    (the VLM's ``embeds``, the encoder's ``frames``) go to ``prefill`` by
    name."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.layout import param_axes, param_specs
    model = _abstract_model(cfg)
    rules = lowering_rules(cfg, shape_cfg, mesh)
    rules.update(extra_rules or {})
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    serve = ShapeConfig(shape_cfg.name, s, b, "decode")
    cache_specs = _written_caches(model.input_specs(serve)["caches"])

    def prefill_step(params, batch, caches):
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        if any(t is not None for t in pytree.tree_leaves(caches)):
            extra["caches"] = caches
        logits, caches = model.prefill(batch.get("tokens"), s, **extra,
                                       params=params)
        return greedy(logits), caches

    return StepPlan(prefill_step,
                    (param_specs(cfg), model.input_specs(shape_cfg),
                     cache_specs),
                    (param_axes(cfg), model.input_axes(shape_cfg),
                     _written_caches(model.input_axes(serve)["caches"])),
                    rules, mesh)


def _written_caches(tree):
    """A decode's cache tree with each recurrent state (hymba's SSM, the
    xLSTM's) as None: a prefill makes those and returns them, where it
    writes the attention caches into the ones it is given."""
    from repro_torch.models.ssm import SSMState
    from repro_torch.models.xlstm import MLSTMState, SLSTMState
    if isinstance(tree, (SSMState, MLSTMState, SLSTMState)):
        return None
    if isinstance(tree, list):
        return [_written_caches(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _written_caches(v) for k, v in tree.items()}
    return tree


def plan_decode(cfg, shape_cfg, mesh,
                extra_rules: Optional[dict] = None) -> StepPlan:
    """One decode step of ``shape_cfg``'s batch against caches of its
    length, at the last position (every slot read)."""
    from repro_torch.models.layout import param_axes, param_specs
    model = _abstract_model(cfg)
    rules = lowering_rules(cfg, shape_cfg, mesh)
    rules.update(extra_rules or {})
    inputs = model.input_specs(shape_cfg)
    in_axes = model.input_axes(shape_cfg)
    position = shape_cfg.seq_len - 1

    def serve_step(params, tokens, caches):
        logits, caches = model.decode_step(tokens, caches, position,
                                           params=params)
        return greedy(logits), caches

    return StepPlan(serve_step,
                    (param_specs(cfg), inputs["tokens"], inputs["caches"]),
                    (param_axes(cfg), in_axes["tokens"], in_axes["caches"]),
                    rules, mesh)


def plan_for(cfg, shape_cfg, mesh, **kw) -> StepPlan:
    if shape_cfg.kind == "train":
        return plan_train(cfg, shape_cfg, mesh, **kw)
    if shape_cfg.kind == "prefill":
        return plan_prefill(cfg, shape_cfg, mesh, **kw)
    return plan_decode(cfg, shape_cfg, mesh, **kw)
