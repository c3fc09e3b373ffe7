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
  the merge's collectives, so no listener hears it (below);
* ``all_gather`` — the whole stack ``[size, ...]`` from every rank's
  slice, for a store's or an app's whole result (JAX's global arrays):
  not one of the merge's collectives either.

The exchanges are ``torch.distributed`` calls among the processes of the
mesh's group: point-to-point sends and receives for ``ppermute``, the
functional ``all_reduce`` over a group of each ``group`` consecutive ranks
for the reductions, so the axis runs on a real process group (gloo, NCCL)
as on the planner's fake one. On the planner's meta tensors a ``ppermute``
moves no data (there is none): each device's received value is a fresh
tensor of its shape.

The group's backend decides how a tensor on the card travels. NCCL takes
it as it is. Gloo's sends and receives take host tensors only (its
all-reduce takes the card's), so on a gloo group ``ppermute`` and
``all_gather`` stage each leaf on the card through a pinned host buffer;
the staging is chosen from the backend, never as a recovery from a failed
call. NCCL asks that a group's first batched send and receive involve
every rank of the group, and the binomial broadcast and the representative
stages have rounds in which a rank neither sends nor receives: so every
group's first call is a one-element all-reduce that all of its ranks join
(``_warm``), made when the group is made and, for the default group that
carries the point-to-point calls, in the first exchange (every rank of the
mesh enters every ``ppermute``). NCCL refuses two ranks on one card: a
mesh with more processes than the host has cards raises on NCCL before
any work.

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
from repro_torch.core.stacked import StackedAxis, run_guarded

PyTree = Any

# (mesh, merge dims, group) -> the process group of this device's group
_GROUPS: dict = {}
# the process groups whose first call has been made (id of the group; the
# default group as None)
_WARMED: set = set()


# a mesh -> the same ranks' mesh of device type "cpu", for gathers staged
# through the host (:func:`redistribute`)
_HOST_MESHES: dict = {}


def clear_groups() -> None:
    """Forget the process groups made for merge axes and which groups
    have made their first call (their process group is being
    destroyed)."""
    _GROUPS.clear()
    _WARMED.clear()
    _HOST_MESHES.clear()


def _gathers(src, dst) -> bool:
    """Whether going from placements ``src`` to ``dst`` gathers a split
    dim (a mesh dim that leaves a ``Shard`` for one that is not: a move
    between two split dims is an all-to-all, which gloo takes on the
    card)."""
    from torch.distributed.tensor import Shard
    return any(isinstance(a, Shard) and not isinstance(b, Shard)
               for a, b in zip(src, dst))


def redistribute(x, placements):
    """``x.redistribute(x.device_mesh, placements)`` for a DTensor ``x``,
    on any backend, inside autograd or outside it. Gloo's all-gather of a
    card's tensor fails in DTensor's functional collectives (the process
    dies), where its all-reduce and reduce-scatter take the card's
    tensors: so a gather of a tensor on the card over gloo runs on a host
    copy over the same ranks' CPU mesh and is copied back, chosen from the
    backend (:func:`_staged_gather`), never as a recovery from a failed
    call. Where such a gather may happen (a card's tensor on gloo) and
    ``x`` takes part in autograd, the move is :class:`_Redistribute`,
    whose backward moves the gradient back by the same rule: a gather's
    gradient is sliced (a replicated one) or reduce-scattered (a partial
    sum) onto ``x``'s placements, and a split's gradient, which DTensor's
    own backward would all-gather, is gathered through the host."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    if not _stages(x):
        return x.redistribute(x.device_mesh, placements)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Redistribute.apply(x, placements)
    return _moved(x, placements)


def _moved(x, placements):
    """:func:`redistribute` of ``x`` without a graph (outside autograd,
    or inside :class:`_Redistribute`)."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    if not _staged_gather(x, placements):
        return x.redistribute(mesh, placements)
    out = _on_host(x, placements).to(x.to_local().device)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _grad_placements(placements) -> tuple:
    """Where the gradient of a DTensor laid out by ``placements`` goes: a
    partial sum's gradient is replicated (DTensor's own rule)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in placements)


class _Redistribute(torch.autograd.Function):
    """:func:`redistribute` as an autograd Function: forward moves ``x`` to
    ``placements`` (a gather through the host, :func:`_moved`), backward
    moves the gradient back onto ``x``'s placements by the same rule."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = _grad_placements(x.placements)
        return _moved(x, placements)

    @staticmethod
    def backward(ctx, g):
        return _moved(g, ctx.placements), None


def whole_on_host(x):
    """The global array of DTensor ``x`` on the host of the group's rank 0,
    None on every other process: a checkpoint's leaf, which rank 0 writes.
    On gloo a tensor split evenly (over one mesh dim or several, none a
    partial sum) is gathered to rank 0 alone: ``dist.gather`` of the host
    copies over the split dims' group (the mesh's whole group when it
    splits over several), rank 0 placing each process's shard at its
    offset; any other is redistributed whole over its mesh (a card's
    tensor over gloo on a host copy, as :func:`redistribute` does)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    mesh, me = x.device_mesh, dist.get_rank()
    split = [i for i, p in enumerate(x.placements) if not p.is_replicate()]
    if backend_of() == "gloo" and split and _even(x, split) and (
            len(split) == 1 or mesh.mesh.numel() == dist.get_world_size()):
        group = mesh.get_group(split[0]) if len(split) == 1 else None
        mine = x.to_local().cpu().contiguous()
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        first = ranks[0]
        parts = ([torch.empty_like(mine) for _ in ranks]
                 if me == first else None)
        dist.gather(mine, parts, dst=first, group=group)
        if me != 0:
            return None
        return _assemble(x, dict(zip(ranks, parts)))
    whole = (Replicate(),) * mesh.ndim
    out = (_on_host(x, whole) if _staged_gather(x, whole)
           else x.redistribute(mesh, whole).to_local().cpu())
    return out if me == 0 else None


def _even(x, split) -> bool:
    """Whether every mesh dim of ``split`` is a ``Shard`` of a tensor dim
    that its shards divide evenly (none a partial sum)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    for i in split:
        p = x.placements[i]
        if type(p) is not Shard:
            return False
    by_dim: dict = {}
    for i in split:
        by_dim[x.placements[i].dim] = by_dim.get(
            x.placements[i].dim, 1) * mesh.size(i)
    return all(x.shape[d] % n == 0 for d, n in by_dim.items())


def _assemble(x, parts: dict) -> torch.Tensor:
    """The global array of ``x`` from its shards by global rank (a
    replicated dim's copies are all there: the first is taken), each at
    its offset under ``x``'s placements."""
    one = next(iter(parts.values()))
    out = torch.empty(tuple(x.shape), dtype=one.dtype)
    grid = x.device_mesh.mesh
    for rank, part in parts.items():
        coord = [int(c) for c in (grid == rank).nonzero()[0]]
        shape, offset = _local_shape_at(x, coord)
        out[tuple(slice(o, o + n) for o, n in zip(offset, shape))] = part
    return out


def _local_shape_at(x, coord) -> tuple:
    """(local shape, global offset) of the shard of ``x`` at mesh
    coordinate ``coord`` (DTensor splits a dim over mesh dims major to
    minor)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    shape, offset = list(x.shape), [0] * len(x.shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
            offset[p.dim] += coord[i] * shape[p.dim]
    return shape, offset


def _stages(x) -> bool:
    """Whether a move of ``x`` that gathers goes through the host: a card's
    tensor over gloo."""
    return x.to_local().is_cuda and backend_of() == "gloo"


def _staged_gather(x, placements) -> bool:
    return _gathers(x.placements, placements) and _stages(x)


def _on_host(x, placements) -> torch.Tensor:
    """This process's local result of redistributing ``x`` to
    ``placements``, computed on a host copy over the same ranks' CPU
    mesh, on the host."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    if mesh not in _HOST_MESHES:
        _HOST_MESHES[mesh] = DeviceMesh("cpu", mesh.mesh,
                                        mesh_dim_names=mesh.mesh_dim_names)
    host = _HOST_MESHES[mesh]
    h = DTensor.from_local(x.to_local().cpu(), host, x.placements,
                           run_check=False, shape=x.shape, stride=x.stride())
    return h.redistribute(host, tuple(placements)).to_local()


def backend_of(group=None) -> str:
    """The backend of ``group`` (the default group when None): ``gloo``,
    ``nccl`` or ``fake``."""
    import torch.distributed as dist
    return str(dist.get_backend(group)).lower()


def check_cards(backend: str, processes: int) -> None:
    """On NCCL, one card a process: raise before any work when this host
    has fewer cards than ``processes``."""
    if backend != "nccl":
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if processes > cards:
        raise RuntimeError(
            f"NCCL needs one card a process: {processes} processes on a "
            f"host with {cards} card(s) (NCCL refuses two ranks on one "
            f"card); use the gloo backend, which stages through the host, "
            f"or fewer processes")


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
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    @property
    def backend(self) -> str:
        """The backend of the mesh's process group."""
        return backend_of()

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` travels through a pinned host buffer: a tensor on
        the card over gloo, whose sends, receives and gathers take host
        tensors."""
        return t.is_cuda and self.backend == "gloo"

    def _warm(self, pg) -> None:
        """Make ``pg``'s first call one that all of its ranks join: an
        all-reduce of one element (NCCL's rule for a group whose first
        batched send and receive leaves ranks out). ``pg`` None is the
        default group."""
        if id(pg) in _WARMED or self.backend == "fake" or \
                self.device.type == "meta":
            return
        import torch.distributed as dist
        dist.all_reduce(torch.zeros(1, device=self.device), group=pg)
        _WARMED.add(id(pg))

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
            self._warm(_GROUPS[key])
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
        self._warm(None)                # the point-to-point calls' group
        ops, landing = [], []
        for t, o in zip(leaves, out):
            staged = self._staged(t)
            if dst is not None and dst != me:
                t = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t) if staged else t.contiguous())
                ops.append(dist.P2POp(dist.isend, t, self.ranks[dst]))
            if src is not None and src != me:
                if staged:
                    h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    landing.append((o, h))
                    o = h
                ops.append(dist.P2POp(dist.irecv, o, self.ranks[src]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for o, h in landing:
            o.copy_(h)
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

    def all_gather(self, x: PyTree) -> PyTree:
        """Every leaf's whole stack ``[size, ...]``, merge rank ``i``'s
        slice at row ``i``, from this rank's ``[1, ...]`` slice, on every
        rank: a store's or an app's whole result, as JAX's global arrays
        give it. Not one of the merge's collectives: it is told to no
        listener, as :meth:`pmean` is not."""
        import torch.distributed as dist
        if self.size == 1:
            return pytree.tree_map(torch.clone, x)
        pg = self._group(self.size)
        # the group's ranks in merge-rank order
        order = [dist.get_group_rank(pg, r) for r in self.ranks]

        def gather(t):
            h = t.cpu() if self._staged(t) else t.contiguous()
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=pg)
            return torch.cat([parts[i] for i in order]).to(t.device)
        return pytree.tree_map(gather, x)

    def barrier(self) -> None:
        """Wait until every rank of the axis gets here (a one-element
        all-reduce on the axis's device, on any backend)."""
        import torch.distributed as dist
        if self.size > 1:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self._group(self.size))


class MeshSPMD:
    """The executor over a 1-D mesh of shards, one process a shard: the
    counterpart of the JAX package's ``apps.sharded.mesh_spmd``
    (``shard_map`` over the ``"shards"`` axis), with
    ``core/stacked.StackedSPMD``'s contract on this process's ``[1, ...]``
    slice of every state tensor.

    * ``spmd(fn, *args, donate=())`` runs ``fn`` on this process's slices
      (``fn``'s collectives go over :attr:`axis`, a :class:`MeshAxis`),
      with ``StackedSPMD``'s guard: an argument not donated that ``fn``
      writes in place raises;
    * host inputs are replicated, as in JAX's multi-controller
      discipline: every process is handed the same ``[S, ...]`` value, and
      :meth:`local` takes this process's row;
    * :meth:`gather` gives every process the whole ``[S, ...]`` value of
      a ``[1, ...]`` slice (``MeshAxis.all_gather``);
    * :meth:`barrier`, and :attr:`rank` (rank 0 alone writes what the
      replicated processes would all write, a journal or a snapshot).
    """

    def __init__(self, mesh, axis_name: str = "shards"):
        if mesh.ndim != 1:
            raise ValueError(f"mesh_spmd takes a 1-D mesh of shards, got "
                             f"dims {mesh.mesh_dim_names}")
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else
                  torch.device(mesh.device_type))
        self.axis = MeshAxis(mesh, (axis_name,), device)
        self.device = self.axis.device

    @property
    def n_shards(self) -> int:
        return self.axis.size

    @property
    def stack(self) -> int:
        return self.axis.stack

    @property
    def rank(self) -> int:
        return self.axis.rank

    @property
    def backend(self) -> str:
        return self.axis.backend

    def __call__(self, fn, *args, donate: Sequence[int] = ()):
        return run_guarded(fn, args, donate, "mesh_spmd")

    def local(self, x):
        """This process's ``[1, ...]`` row of a replicated ``[S, ...]``
        host input (a tensor or a numpy array)."""
        if x.shape[0] != self.n_shards:
            raise ValueError(f"a replicated input needs leading dim "
                             f"{self.n_shards}, got {tuple(x.shape)}")
        return x[self.rank:self.rank + 1]

    def gather(self, x: PyTree) -> PyTree:
        return self.axis.all_gather(x)

    def barrier(self) -> None:
        self.axis.barrier()


def merge_ranks(mesh, dims: Sequence[str]) -> int:
    """The rank count of the axis over ``dims`` of ``mesh``."""
    names = list(mesh.mesh_dim_names)
    return math.prod(int(mesh.size(names.index(d))) for d in dims)
