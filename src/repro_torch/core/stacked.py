"""The stacked executor: every shard on one device, as a leading dim.

The JAX package runs a per-shard program under ``jax.vmap(axis_name=...)``
or ``shard_map`` and names its collectives by axis. Here all ``S`` shards
live on one device as dim 0 of every state tensor, and the collectives are
tensor ops over that dim, provided by a :class:`StackedAxis`:

* ``ppermute(x, perm)`` — ``out[dst] = x[src]`` for each ``(src, dst)``
  pair; a rank that is no pair's destination receives zeros (JAX's
  semantics, which the binomial broadcast and the rep/lane stages rely on);
* ``psum`` / ``pmax`` / ``pmin`` over contiguous groups of ``group`` ranks
  (the whole axis by default): a reduce over a ``[S/group, group, ...]``
  view, broadcast back to every member;
* ``index()`` — ``torch.arange(S)``, the stacked ``axis_index``;
* ``stack`` — the ranks a tensor stacks along dim 0: ``S`` here, 1 on a
  device of a mesh (``core/mesh_axis.MeshAxis``, the same contract on
  each device's ``[1, ...]`` slice).

Functions written against the axis take and return stacked tensors (or
pytrees of them) and see all shards at once; a per-rank predicate is an
``[S]`` mask broadcast over the trailing dims (:meth:`StackedAxis.where`).

Every collective is emitted as a ``"collective"`` event
(``repro_torch/hooks.py``) before it runs, so that
``repro_torch.analysis.trace`` can record a program's collectives.

An *executor* runs a program on the shards: :class:`StackedSPMD` here (all
shards on one device, with a ``StackedAxis``), or
``core/mesh_axis.MeshSPMD`` over a mesh of processes, one a shard (with a
``MeshAxis``, the same contract on each process's ``[1, ...]`` slice). The
KV store and the apps take either; both have ``axis``, ``n_shards``,
``stack`` (the rows a local state tensor holds), ``device``, ``rank``,
``local`` (this executor's rows of a replicated host input), ``gather``
(the whole ``[S, ...]`` value of local rows) and ``barrier``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch import hooks

PyTree = Any


@dataclasses.dataclass(frozen=True)
class StackedAxis:
    """A merge axis of ``size`` ranks stacked along dim 0 on ``device``
    (named by the caller: the axis has no default device)."""

    size: int
    device: torch.device

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"axis size must be >= 1, got {self.size}")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def stack(self) -> int:
        """The ranks a tensor stacks along dim 0: all of them."""
        return self.size

    def index(self) -> torch.Tensor:
        """``axis_index`` for every rank at once: ``[S]`` int64."""
        return torch.arange(self.size, device=self.device)

    def where(self, pred: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
        """Per-rank select: ``pred`` is an ``[S]`` bool mask."""
        def sel(x, y):
            return torch.where(pred.view((-1,) + (1,) * (x.dim() - 1)), x, y)
        return pytree.tree_map(sel, a, b)

    def ppermute(self, x: PyTree,
                 perm: Sequence[tuple[int, int]]) -> PyTree:
        """Send rank ``src``'s value to rank ``dst`` for every pair; ranks
        that receive nothing get zeros."""
        hooks.emit("collective", self, "ppermute", x, None, perm)
        src = torch.tensor([p[0] for p in perm], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([p[1] for p in perm], dtype=torch.long,
                           device=self.device)
        if len(set(dst.tolist())) != len(perm):
            raise ValueError(f"ppermute: duplicate destinations in {perm}")
        full = sorted(dst.tolist()) == list(range(self.size))

        def move(t):
            if full:  # a bijection is one gather, no zero fill
                inv = torch.empty_like(src)
                inv[dst] = src
                return t[inv]
            out = torch.zeros_like(t)
            out[dst] = t[src]
            return out
        return pytree.tree_map(move, x)

    def _told(self, kind: str, x: PyTree, group: int | None) -> int:
        group = group or self.size
        hooks.emit("collective", self, kind, x, group, None)
        return group

    def _grouped(self, x: torch.Tensor, group: int, reduce: Callable
                 ) -> torch.Tensor:
        if group < 1 or self.size % group:
            raise ValueError(f"group {group} must divide the axis size "
                             f"{self.size}")
        g = x.reshape((self.size // group, group) + tuple(x.shape[1:]))
        r = reduce(g)
        # reshaping the stride-0 expand copies: every rank gets its own row
        return r.unsqueeze(1).expand_as(g).reshape(x.shape)

    def psum(self, x: PyTree, group: int | None = None) -> PyTree:
        """Sum over each group of ranks; integer sums wrap in the dtype."""
        group = self._told("psum", x, group)
        return pytree.tree_map(
            lambda t: self._grouped(t, group,
                                    lambda g: g.sum(1, dtype=t.dtype)), x)

    def pmax(self, x: PyTree, group: int | None = None) -> PyTree:
        group = self._told("pmax", x, group)
        return pytree.tree_map(
            lambda t: self._grouped(t, group, lambda g: g.amax(1)), x)

    def pmin(self, x: PyTree, group: int | None = None) -> PyTree:
        group = self._told("pmin", x, group)
        return pytree.tree_map(
            lambda t: self._grouped(t, group, lambda g: g.amin(1)), x)


def run_guarded(fn: Callable, args: Sequence, donate: Sequence[int],
                who: str):
    """``fn(*args)``, raising if ``fn`` wrote in place to an argument whose
    position ``donate`` does not name (``who`` names the executor)."""
    guarded = [(i, t, t._version)
               for i, a in enumerate(args) if i not in donate
               for t in pytree.tree_leaves(a) if isinstance(t, torch.Tensor)]
    out = fn(*args)
    for i, t, version in guarded:
        if t._version != version:
            raise RuntimeError(
                f"{who}: {getattr(fn, '__name__', fn)} wrote argument "
                f"{i} in place but it was not donated")
    return out


class StackedSPMD:
    """The stacked executor, with its :class:`StackedAxis` of ``n_shards``
    ranks on ``device``: the stacked counterpart of the JAX package's
    ``mesh_spmd`` / vmap executor contract (the module doc's). Every shard
    is local: ``local`` and ``gather`` give their argument back, and there
    is one process.

    ``spmd(fn, *args, donate=())`` runs ``fn`` on stacked (shard-major)
    args; ``fn`` sees every shard at once and uses :attr:`axis` for its
    collectives. ``donate`` names the argument positions whose tensors
    ``fn`` may update in place (the state the caller rebinds from the
    result, as the reference donates buffers to XLA); any other argument
    that ``fn`` writes to raises, so an in-place update can never leak into
    a value the caller still holds."""

    rank = 0
    backend = "stacked"

    def __init__(self, n_shards: int, device):
        self.axis = StackedAxis(n_shards, device)
        self.device = self.axis.device

    @property
    def n_shards(self) -> int:
        return self.axis.size

    @property
    def stack(self) -> int:
        return self.axis.stack

    def __call__(self, fn: Callable, *args, donate: Sequence[int] = ()):
        return run_guarded(fn, args, donate, "StackedSPMD")

    def local(self, x):
        return x

    def gather(self, x: PyTree) -> PyTree:
        return x

    def barrier(self) -> None:
        pass
