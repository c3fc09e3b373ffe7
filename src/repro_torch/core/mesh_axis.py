"""A merge axis over the dims of a device mesh: the engine's collectives
between processes.

The counterpart of :class:`~repro_torch.core.stacked.StackedAxis` for a
program that runs once per device, as the JAX package's merge engine runs
under ``shard_map`` manual over the merge axes. The merge dims of a
``DeviceMesh`` are flattened row-major into one axis of ``size`` ranks
(JAX's engine treats ``("pod", "data")`` the same way), and each device
holds its local slice of a stack that is ``Shard(0)`` over those dims: a
``[1, ...]`` tensor. The contract is ``StackedAxis``'s, on that slice:

* ``stack`` — the ranks a local tensor stacks: 1 (a ``StackedAxis`` has
  ``size``); ``size`` stays the logical rank count that ``compile_plan``
  and ``core/permutes`` build their permutations over;
* ``index()`` — ``[this rank]``, so a per-rank predicate is a ``[1]`` mask
  and :meth:`where` is ``StackedAxis.where``;
* ``ppermute(x, perm)`` — ``(src, dst)`` pairs over the axis's ranks; a
  rank that is no pair's destination receives zeros;
* ``psum`` / ``pmax`` / ``pmin`` over aligned groups of ``group``
  consecutive ranks (the whole axis by default), every member getting the
  group's reduction;
* ``pmean`` — the mean over every rank, for the step's loss: not one of
  the merge's collectives, so no listener hears it (below).

The exchanges are ``torch.distributed`` calls among the processes of the
mesh's group: point-to-point sends and receives for ``ppermute``, the
functional ``all_reduce`` over a group of each ``group`` consecutive ranks
for the reductions, so the axis runs on a real process group (gloo, NCCL)
as on the planner's fake one. On the planner's meta tensors a ``ppermute``
moves no data (there is none): each device's received value is a fresh
tensor of its shape.

Every collective is told to ``repro_torch/hooks.py``'s listeners as
``emit("collective", axis, kind, x, group, perm)`` before it runs, as
``StackedAxis`` tells them, and ``emit("collective_end", axis)`` after, so
that the op-level walk (``launch/op_cost.py``) counts one exchange with its
pairs (or one all-reduce over its groups) and not the ops that carry it.
Process groups are made once for each mesh, merge dims and group size, and
kept until :func:`clear_groups` (``launch/mesh.shutdown`` calls it).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch import hooks
from repro_torch.core.stacked import StackedAxis

PyTree = Any

# (mesh, merge dims, group) -> the process group of this device's group
_GROUPS: dict = {}


def clear_groups() -> None:
    """Forget the process groups made for merge axes (their process group
    is being destroyed)."""
    _GROUPS.clear()


class MeshAxis:
    """The merge axis over ``dims`` of ``mesh``, for tensors on ``device``
    (this device's local slices: meta tensors in the planner). Every other
    dim of the mesh must have size 1 (the explicit train step's
    restriction, JAX's); ``ranks`` are the merge ranks' global ranks."""

    stack = 1

    def __init__(self, mesh, dims: Sequence[str], device):
        names = list(mesh.mesh_dim_names)
        missing = [d for d in dims if d not in names]
        if missing or not dims:
            raise ValueError(f"merge dims {tuple(dims)} are not dims of the "
                             f"mesh {tuple(names)}")
        split = [d for i, d in enumerate(names)
                 if d not in dims and mesh.size(i) > 1]
        if split:
            raise ValueError(f"a merge axis over {tuple(dims)} needs the "
                             f"mesh's other dims to have size 1, but "
                             f"{split} do not")
        if mesh.get_coordinate() is None:
            raise ValueError("this process holds no rank of the mesh")
        self.mesh = mesh
        self.dims = tuple(dims)
        self.device = torch.device(device)
        merge = [names.index(d) for d in self.dims]
        others = [i for i in range(len(names)) if i not in merge]
        # the global rank of each merge rank, the merge dims row-major
        self.ranks = [int(r) for r in
                      mesh.mesh.permute(others + merge).reshape(-1).tolist()]
        self.size = len(self.ranks)
        self.rank = self.ranks.index(int(mesh.get_rank()))

    where = StackedAxis.where

    def index(self) -> torch.Tensor:
        """``axis_index`` of this device: ``[1]`` int64."""
        return torch.tensor([self.rank], device=self.device)

    # -- process groups ------------------------------------------------------

    def _group(self, group: int):
        """The process group of this device's aligned group of ``group``
        consecutive merge ranks (made by every process of the mesh)."""
        key = (self.mesh, self.dims, group)
        if key not in _GROUPS:
            from torch.distributed.device_mesh import DeviceMesh
            sub = DeviceMesh(self.mesh.device_type,
                             torch.tensor(self.ranks).reshape(-1, group),
                             mesh_dim_names=("merge_block", "merge_group"))
            _GROUPS[key] = sub.get_group("merge_group")
        return _GROUPS[key]

    # -- collectives ---------------------------------------------------------

    def ppermute(self, x: PyTree, perm: Sequence[tuple[int, int]]) -> PyTree:
        """Send rank ``src``'s value to rank ``dst`` for every pair; ranks
        that receive nothing get zeros."""
        hooks.emit("collective", self, "ppermute", x, None, perm)
        try:
            dsts = [d for _, d in perm]
            if len(set(dsts)) != len(perm):
                raise ValueError(f"ppermute: duplicate destinations in "
                                 f"{perm}")
            send = [d for s, d in perm if s == self.rank]
            recv = [s for s, d in perm if d == self.rank]
            leaves, spec = pytree.tree_flatten(x)
            return pytree.tree_unflatten(
                self._exchange(leaves, send[0] if send else None,
                               recv[0] if recv else None), spec)
        finally:
            hooks.emit("collective_end", self)

    def _exchange(self, leaves: list, dst, src) -> list:
        """Each leaf sent to merge rank ``dst`` and received from ``src``
        (either may be None or this rank), every send and receive of the
        round posted before any is waited on."""
        import torch.distributed as dist
        me = self.rank
        out = [torch.zeros_like(t) if src is None
               else t.clone() if src == me
               else torch.empty_like(t) for t in leaves]
        if all(t.is_meta for t in leaves):      # the planner's: no data
            return out
        ops = []
        for t, o in zip(leaves, out):
            if dst is not None and dst != me:
                ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                      self.ranks[dst]))
            if src is not None and src != me:
                ops.append(dist.P2POp(dist.irecv, o, self.ranks[src]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def _reduce(self, kind: str, op: str, x: PyTree, group) -> PyTree:
        group = group or self.size
        if group < 1 or self.size % group:
            raise ValueError(f"group {group} must divide the axis size "
                             f"{self.size}")
        hooks.emit("collective", self, kind, x, group, None)
        try:
            if group == 1:
                return pytree.tree_map(torch.clone, x)
            import torch.distributed._functional_collectives as funcol
            pg = self._group(group)

            def reduce(t):
                r = funcol.all_reduce(t, op, pg)
                return (r.wait() if isinstance(r, funcol.AsyncCollectiveTensor)
                        else r)
            return pytree.tree_map(reduce, x)
        finally:
            hooks.emit("collective_end", self)

    def psum(self, x: PyTree, group: int | None = None) -> PyTree:
        """Sum over each group of ranks; integer sums wrap in the dtype."""
        return self._reduce("psum", "sum", x, group)

    def pmax(self, x: PyTree, group: int | None = None) -> PyTree:
        return self._reduce("pmax", "max", x, group)

    def pmin(self, x: PyTree, group: int | None = None) -> PyTree:
        return self._reduce("pmin", "min", x, group)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over every rank (JAX's ``lax.pmean``: a
        step's loss). Not one of the merge's collectives: it is told to no
        listener, so the recorder leaves it out and the op-level walk
        counts the functional all-reduce it is among the step's other
        collectives."""
        if self.size == 1:
            return x.clone()
        import torch.distributed._functional_collectives as funcol
        r = funcol.all_reduce(x / self.size, "sum", self._group(self.size))
        return r.wait() if isinstance(r, funcol.AsyncCollectiveTensor) else r


def merge_ranks(mesh, dims: Sequence[str]) -> int:
    """The rank count of the axis over ``dims`` of ``mesh``."""
    names = list(mesh.mesh_dim_names)
    return math.prod(int(mesh.size(names.index(d))) for d in dims)
