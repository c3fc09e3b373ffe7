"""Production meshes over a fake process group, for planning without
devices.

The port of the JAX package's ``repro/launch/mesh.py``. JAX plans the
production cells on 512 forced host devices; here a ``DeviceMesh`` of the
same axes and sizes spans the ranks of a *fake* process group
(``torch.testing._internal.distributed.fake_pg``): every collective returns
at once without moving data, so DTensor programs trace on one process, over
fake tensors, and the collectives DTensor inserts are recorded
(``launch/op_cost.py``), never run.

The fake group is global to a process: :func:`fake_world` initialises it
once, with at least the ranks a mesh asks for (512 by default, so both
production meshes and every smaller one share it: a mesh takes ranks ``0 ..
n-1``), and :func:`shutdown` destroys it, with DTensor's cached sharding
decisions, which hold its meshes, and the merge axes' groups
(``core/mesh_axis.py``). A process that has initialised
another backend is refused. ``FakeStore`` is internal to PyTorch: this is
the one module that imports it (``tests/test_torch_partition.py`` fails
clearly if it moves).

Every mesh has the one device type :data:`DEVICE_TYPE`, that of the cards
the plan is for: the planner's tensors are meta tensors and nothing is
allocated on any device, so planning needs no card, and a plan made on a
card's host is the plan made anywhere else. Rank order is row-major over the mesh
axes, model innermost, so consecutive ranks share a model group as they
share an NVLink node.
"""

from __future__ import annotations

import math

import torch

WORLD = 512
DEVICE_TYPE = "cuda"


def fake_store():
    """PyTorch's in-process fake store (internal API)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def fake_world(ranks: int = WORLD) -> int:
    """Initialise the fake process group with at least ``ranks`` ranks (a
    no-op when it already has them) -> its world size."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               f"initialised; planning needs the fake one")
        if dist.get_world_size() >= ranks:
            return dist.get_world_size()
        dist.destroy_process_group()
    world = max(ranks, WORLD)
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=world)
    return world


def shutdown() -> None:
    """Destroy the fake process group (and every mesh's groups), and
    DTensor's caches of sharding decisions: a mesh made later over the
    same ranks equals one of the old meshes, so a cached decision would
    hand it the old mesh, whose groups are gone."""
    import torch.distributed as dist
    from repro_torch.core.mesh_axis import clear_groups
    if dist.is_initialized():
        dist.destroy_process_group()
    clear_groups()
    _clear_dtensor_caches()


def _clear_dtensor_caches() -> None:
    """Clear DTensor's caches that hold meshes (internal names, each
    cleared where this PyTorch has it: the native dispatch cache, the
    sharding propagator's, the redistribution planner's)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()
    prop = getattr(getattr(DTensor, "_op_dispatcher", None),
                   "sharding_propagator", None)
    for cache in (getattr(prop, "propagate_op_sharding", None),
                  getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    clear = getattr(_redistribute, "clear_redistribute_planner_cache", None)
    if clear is not None:
        clear()


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels import custom_ops
    custom_ops.register_shardings()
    n = math.prod(shape)
    fake_world(n)
    return DeviceMesh(DEVICE_TYPE, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False):
    """Single pod: ``(data=16, model=16)`` = 256 ranks. Multi-pod: ``(pod=2,
    data=16, model=16)`` = 512; the ``pod`` axis crosses between pods, and
    only gradient and batch traffic rides it."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ``(data, model)`` mesh over the same fake group (tests, the
    count check's 1 x 1)."""
    return _mesh((data, model), ("data", "model"))


def make_data_parallel_mesh(data: int):
    """A pure data-parallel ``(pod 2, data, model 1)`` mesh over the same
    fake group: the explicit gradient merge's (``steps.plan_train(
    merge_plan=)`` refuses a model axis of size > 1, as JAX's does)."""
    return _mesh((2, data, 1), ("pod", "data", "model"))


def mesh_name(mesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes, else the
    axes and sizes (``data2xmodel2``)."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if shape == {"data": 16, "model": 16}:
        return "pod16x16"
    if shape == {"pod": 2, "data": 16, "model": 16}:
        return "pod2x16x16"
    return "x".join(f"{k}{v}" for k, v in shape.items())
