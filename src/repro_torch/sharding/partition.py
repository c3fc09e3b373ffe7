"""Logical-axis sharding: rules mapping logical axes to mesh axes, and the
DTensor placements they give.

The port of the JAX package's ``repro/sharding/partition.py``. Parameters
and activations carry *logical* axis names (``models/layout.py`` for the
parameters, ``DecoderLM.input_axes`` / ``cache_axes`` for the inputs). A
rule set maps each name to a mesh axis, a tuple of mesh axes or ``None``;
:func:`spec_for` resolves a tensor's axes into a spec (a tuple with one
entry per dim: ``None``, a mesh axis name or a tuple of names, as JAX's
``PartitionSpec``), dropping an assignment when the dim is not divisible by
the mesh axis size (8 KV heads on a 16-way model axis stay replicated) and
never reusing a mesh axis within one spec.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch/mesh.py``) or any object whose ``shape`` maps axis names to
sizes (the tests' shape-only meshes). :func:`placements_for` turns a spec
into DTensor placements over a ``DeviceMesh``: the mesh dim of each named
axis gets ``Shard(dim)``, the rest ``Replicate()``. A composite assignment
such as ``("pod", "data")`` shards one tensor dim over both mesh dims;
DTensor splits a dim over several mesh dims major to minor in mesh-dim
order, which is JAX's order for a tuple whose axes follow the mesh's order
(the production meshes' ``pod, data, model``); another order has no plain
placement and raises.

:func:`logical_constraint` redistributes a DTensor and its gradient to
its spec's placements inside a :func:`sharding_rules` context; outside one, and for a
tensor that is not a DTensor, it is the identity, so the card's paths run
as they always did.

The same model code runs on a real group's mesh, one process a device
(the train step over ``--procs N --model-ranks M``): the step installs the
rules for its mesh, and :func:`gather_at_use` makes :func:`gathered`
gather each parameter over the data dims where the model uses it. Every
explicit move of the models goes through ``core/mesh_axis.redistribute``
(a gather of a card's tensor over gloo runs through the host, inside
autograd too), and a ``local_map``'s inputs are moved by
:func:`local_inputs` before it, not by its own ``redistribute_inputs``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

# Default production rules (the JAX package's DESIGN.md §5).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,   # residual-stream seq dim (sequence-parallel lever)
    "embed": "data",        # FSDP: params/optimizer reduce-scattered over data
    "embed_act": None,      # activation d_model dim stays unsharded
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_mlp": None,
    "capacity": None,
    "layers": None,
    "conv": None,
    "state": None,
}


class _Ctx:
    """The installed rules, process-wide: autograd runs a backward (and a
    checkpoint's recompute) on its own threads, which must see them."""

    def __init__(self):
        self.rules: Optional[dict] = None
        self.mesh = None
        self.manual: frozenset = frozenset()
        self.gather: tuple = ()


_CTX = _Ctx()


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[dict] = None):
    """Install mesh + logical rules for model code (logical_constraint)."""
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def active_mesh():
    """The mesh of the installed rules (:func:`sharding_rules`), or None:
    the planner's fake mesh, or a real group's train mesh (one process a
    device)."""
    return _CTX.mesh


def local_inputs(args, placements) -> list:
    """Each DTensor of ``args`` moved to its ``placements`` by
    ``core/mesh_axis.redistribute``, before a ``local_map`` whose inputs
    must arrive there (its own ``redistribute_inputs`` would move them
    through DTensor's collectives)."""
    from repro_torch.core.mesh_axis import redistribute
    return [redistribute(a, pl) if is_dtensor(a) else a
            for a, pl in zip(args, placements)]


@contextlib.contextmanager
def gather_at_use(dims: tuple):
    """Gather the parameters split over the mesh ``dims`` (FSDP's
    ``data``) where the model uses them (:func:`gathered`), as XLA's
    partitioner gathers each weight at its use: the train step over a
    real mesh whose model axis splits the parameters."""
    prev = _CTX.gather
    _CTX.gather = tuple(dims)
    try:
        yield
    finally:
        _CTX.gather = prev


def gathered(tree: Any) -> Any:
    """Each DTensor of ``tree`` gathered over the mesh dims of
    :func:`gather_at_use` (whole there, split elsewhere as it was), through
    ``core/mesh_axis.redistribute`` (a card's tensor over gloo through the
    host, its gradient reduce-scattered back); the identity outside such a
    context, as in the planner, where DTensor gathers a weight where an op
    needs it."""
    if not _CTX.gather:
        return tree
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.mesh_axis import redistribute

    def one(x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        return redistribute(x, [
            Replicate() if names[i] in _CTX.gather and isinstance(p, Shard)
            else p for i, p in enumerate(x.placements)])
    return pytree.tree_map(one, tree)


def spec_for(shape: tuple[int, ...], axes: tuple, mesh,
             rules: Optional[dict] = None) -> tuple:
    """Logical axes -> spec (one entry per dim).

    Degrades gracefully: assignments are dropped when the dim is not
    divisible by the mesh axis, and a mesh axis already consumed by an
    earlier dim of the same spec is never reused (cross-dim conflict guard).
    """
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name is not None else None
        if mesh_axis is None:
            out.append(None)
            continue
        # Filter a composite assignment down to the divisible, unused prefix.
        if isinstance(mesh_axis, (tuple, list)):
            kept = []
            rem = dim
            for a in mesh_axis:
                if a in sizes and a not in used and rem % sizes[a] == 0:
                    kept.append(a)
                    rem //= sizes[a]
            # one kept axis is that axis, as a PartitionSpec normalizes it
            mesh_axis = (tuple(kept) if len(kept) > 1
                         else kept[0] if kept else None)
        else:
            if (mesh_axis not in sizes or mesh_axis in used
                    or dim % sizes[mesh_axis] != 0):
                mesh_axis = None
        if mesh_axis is not None:
            used.update(mesh_axis if isinstance(mesh_axis, tuple)
                        else (mesh_axis,))
        out.append(mesh_axis)
    return tuple(out)


def placements_for(spec: tuple, mesh) -> list:
    """A spec -> DTensor placements over ``mesh``'s dims: ``Shard(dim)`` on
    every mesh dim the spec names for tensor dim ``dim``, ``Replicate()``
    elsewhere (and on a mesh dim of size 1, which splits nothing). A tuple
    must name its mesh axes in mesh-dim order (major to minor, as JAX reads
    it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of the "
                             f"mesh's order {tuple(names)}: DTensor splits "
                             f"a dim over mesh dims major to minor")
        for i in idx:
            if mesh.size(i) > 1:      # a size-1 axis splits nothing
                out[i] = Shard(dim)
    return out


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    (every named dim divides: :func:`spec_for` guarantees it)."""
    sizes = mesh_shape(mesh)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def dim_shards(mesh, placements, dim: int, size: int
               ) -> tuple[list[int], int, int]:
    """Where this device's slice of tensor dim ``dim`` (``size`` long)
    lies under ``placements``: (the mesh dims that split it, in order, the
    slice's length, its first index)."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]
    coord = mesh.get_coordinate()
    n, first = size, 0
    for i in dims:
        n //= mesh.size(i)
        first = first * mesh.size(i) + coord[i]
    return dims, n, first * n


def params_shardings(param_axes: Any, param_shapes: Any, mesh,
                     rules=None) -> Any:
    """Tree of specs for a params tree (axes tree + shapes tree)."""
    is_axes = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    flat_ax, spec = pytree.tree_flatten(param_axes, is_leaf=is_axes)
    flat_sh = spec.flatten_up_to(param_shapes)
    return pytree.tree_unflatten(
        [spec_for(tuple(s.shape) if hasattr(s, "shape") else tuple(s), a,
                  mesh, rules) for a, s in zip(flat_ax, flat_sh)], spec)


@contextlib.contextmanager
def manual_axes(axes):
    """Mark mesh axes as manual (per-shard code) for the enclosed trace:
    :func:`logical_constraint` then leaves every tensor as it is, as in
    the JAX package's ``shard_map`` regions."""
    prev = _CTX.manual
    _CTX.manual = prev | frozenset(axes)
    try:
        yield
    finally:
        _CTX.manual = prev


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``, and the gradient to
    ``grad_placements``: JAX's ``with_sharding_constraint`` constrains the
    cotangent too (to the same layout)."""

    @staticmethod
    def forward(ctx, x, mesh, placements, grad_placements):
        from repro_torch.core.mesh_axis import redistribute
        ctx.placements = grad_placements
        out = redistribute(x, placements)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.mesh_axis import redistribute
        return redistribute(g, ctx.placements), None, None, None


def logical_constraint(x: torch.Tensor, axes: tuple,
                       grad_axes: Optional[tuple] = None) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements, and its
    gradient to those of ``grad_axes`` (default ``axes``); the identity
    outside a rules context, inside :func:`manual_axes` and for a tensor
    that is not a DTensor. ``grad_axes`` is Megatron's sequence-parallel
    exit: a sublayer's output reduced onto a sequence-split residual, its
    gradient gathered back to whole sequences, which the sublayer's
    products need."""
    if _CTX.mesh is None or _CTX.rules is None or _CTX.manual:
        return x
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules, shape = _CTX.mesh, _CTX.rules, tuple(x.shape)
    want = tuple(placements_for(spec_for(shape, axes, mesh, rules), mesh))
    grad = want if grad_axes is None else tuple(placements_for(
        spec_for(shape, grad_axes, mesh, rules), mesh))
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, mesh, want, grad)


class _PartialGrad(torch.autograd.Function):
    """Identity forward; the backward takes the gradient's ``Replicate``
    placements on ``dims`` as ``Partial`` (each device holds its own share
    of the sum), so DTensor reduces it on the way back."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = [Partial() if i in ctx.dims and isinstance(p, Replicate) else p
              for i, p in enumerate(g.placements)]
        return DTensor.from_local(g.to_local(), g.device_mesh, pl,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride()), None


class _MeanGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``1 / n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def mean_grad(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``, a ``Partial("avg")`` mean of ``n`` devices' values (a
    ``local_map``'s output, JAX's ``pmean``), whose gradient reaches each
    device as its share, ``1 / n`` of the mean's: DTensor hands a partial
    value's gradient to every device whole, which is right for a sum and
    ``n`` times too large for a mean. The identity for ``n`` of 1."""
    return _MeanGrad.apply(x, n) if n > 1 else x


def partial_grad(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` whose gradient is summed over the mesh dims ``dims``: for a
    replicated input of a ``local_map`` whose local gradient is one share of
    the whole (a device that reads only a slice of it)."""
    return _PartialGrad.apply(x, tuple(dims)) if dims else x


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the planner's)."""
    return type(x) is not torch.Tensor and hasattr(x, "placements")


def placements_of(shape: tuple, axes: tuple, mesh) -> list:
    """The placements of a tensor of ``shape`` with logical ``axes`` under
    the installed rules (the default ones outside a rules context)."""
    return placements_for(spec_for(tuple(shape), axes, mesh, _CTX.rules),
                          mesh)


def zeros(shape: tuple, dtype, like, placements, device=None
          ) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` laid out by ``placements``
    over ``like``'s mesh (or the mesh ``like`` itself), each device's shard
    made on ``like``'s local device or ``device`` (the planner's meta
    tensors: nothing allocated)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = like.device_mesh if is_dtensor(like) else like
    device = like.to_local().device if device is None else device
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = torch.zeros(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def count_params(params: Any) -> int:
    return sum(math.prod(x.shape) for x in pytree.tree_leaves(params))
