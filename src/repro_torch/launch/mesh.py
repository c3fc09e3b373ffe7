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

:func:`init_shards` is the other kind of group: a real one (gloo or NCCL),
one process a shard of the KV store or an app, from the environment that
``torchrun`` sets or a file init, with its 1-D ``"shards"`` mesh
(``apps/sharded.build_mesh``); :func:`init_train_mesh` joins one the same
way for training, one process a device of a ``("data", "model")`` mesh
of shape ``(N / M, M)``; :func:`shutdown` destroys either.
:func:`spawn_shards` starts the processes of such a group on one host, and
:func:`spawn_command` a CLI's workers through it (``kv_serve --procs``,
``train --procs``).

Every planning mesh has the one device type :data:`DEVICE_TYPE`, that of
the cards the plan is for: the planner's tensors are meta tensors and
nothing is allocated on any device, so planning needs no card, and a plan
made on a card's host is the plan made anywhere else. Rank order is
row-major over the mesh axes, model innermost, so consecutive ranks share
a model group as they share an NVLink node.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path
from typing import Callable

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


def _join(backend: str, device_type: str, init_method: str | None,
          rank: int | None, world_size: int | None) -> int:
    """Join a real process group (gloo or NCCL) after placing this process
    on its device -> the world size. See :func:`init_shards`."""
    import torch.distributed as dist
    from repro_torch.core.mesh_axis import check_cards
    from repro_torch.serve.kv import resolve_device
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs on the card: "
                         "device_type must be cuda")
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                           f"already initialised in this process")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    check_cards(backend, int(os.environ.get("LOCAL_WORLD_SIZE",
                                            world_size)))
    if resolve_device(device_type).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return world_size


def init_shards(backend: str, device_type: str = "cuda",
                init_method: str | None = None, rank: int | None = None,
                world_size: int | None = None):
    """Join the process group of a mesh of shards, one process a shard,
    and return its 1-D ``"shards"`` mesh.

    ``backend`` is ``gloo`` or ``nccl``, the caller's choice. The rank and
    world size come from the arguments or from the environment that
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``); ``init_method`` defaults to ``env://`` (pass
    ``file://...`` for a file init). The process is placed on its device
    first: ``cuda:{local_rank % device_count}`` (the default; it raises
    when there is no card), or the CPU when ``device_type`` is ``cpu``,
    which only gloo takes. On NCCL a host with fewer cards than its
    processes (``LOCAL_WORLD_SIZE``) is refused before any work."""
    from repro_torch.apps.sharded import build_mesh
    world = _join(backend, device_type, init_method, rank, world_size)
    return build_mesh(world, "shards", device_type)


def init_train_mesh(backend: str, device_type: str = "cuda",
                    init_method: str | None = None, rank: int | None = None,
                    world_size: int | None = None, model: int = 1):
    """Join a real process group as :func:`init_shards` does and return the
    train mesh over it: ``("data", "model")`` of shape ``(world // model,
    model)``, one process a device of JAX's layout, the counterpart of
    :func:`make_host_mesh` ``(data, model)`` (JAX's ``make_host_mesh``;
    ``model=1`` is the JAX CLI's ``--mesh host``, and ``make_production_mesh``
    has ``model=16``). Ranks are laid out as ``jax.make_mesh`` lays out
    ``("data", "model")``: row-major, model minor, so consecutive ranks
    share a model group. ``model`` must divide the world size."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels import custom_ops
    custom_ops.register_shardings()
    world = _join(backend, device_type, init_method, rank, world_size)
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the {world} "
                         f"processes of the group")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(world // model, model),
                      mesh_dim_names=("data", "model"))


def spawn_shards(cmd: Callable[[int], list], n: int, work,
                 timeout: float | None, *, env: dict | None = None,
                 during: Callable | None = None,
                 rank0_to_stdout: bool = False):
    """Run ``cmd(rank)`` as ``n`` processes on this host, one a shard of a
    group with a file init, and wait for them all.

    Each process writes its output to ``work/rank{r}.log`` (a full pipe
    cannot stall it in a collective), rank 0 to this process's output with
    ``rank0_to_stdout``; each has ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    set over ``env`` (this process's environment by default).
    ``during()`` runs in this process while they do, and its value is
    returned. A process that fails, or that still runs ``timeout`` seconds
    after the spawn, stops the others and raises with its log's tail.
    A SIGTERM or SIGINT to this process (from its main thread) is passed
    on to every process still running, which is left to finish (a train
    worker saves and exits)."""
    import signal
    import subprocess
    work = Path(work)
    env = dict(os.environ if env is None else env, LOCAL_WORLD_SIZE=str(n))
    deadline = None if timeout is None else time.monotonic() + timeout
    procs, failed, result = [], None, None

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)
    handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            handlers[sig] = signal.signal(sig, forward)
        except ValueError:          # not the main thread
            pass
    try:
        for r in range(n):
            if r == 0 and rank0_to_stdout:
                procs.append(subprocess.Popen(
                    cmd(r), env=dict(env, LOCAL_RANK=str(r))))
                continue
            with open(work / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    cmd(r), env=dict(env, LOCAL_RANK=str(r)), stdout=log,
                    stderr=subprocess.STDOUT))
        if during is not None:
            result = during()
        while failed is None and any(p.poll() is None for p in procs):
            failed = next(((r, f"exit code {p.returncode}")
                           for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is None and deadline is not None \
                    and time.monotonic() > deadline:
                failed = next((r, f"still running after {timeout} s")
                              for r, p in enumerate(procs)
                              if p.poll() is None)
            time.sleep(0.05)
        if failed is None:
            failed = next(((r, f"exit code {p.returncode}")
                           for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        r, why = failed
        log = work / f"rank{r}.log"
        tail = log.read_text()[-3000:] if log.exists() else ""
        raise RuntimeError(f"process {r} of {n} failed ({why})"
                           + (f":\n{tail}" if tail else ""))
    return result


def spawn_command(module: str, argv: list, procs: int) -> None:
    """Run ``python -m module argv`` as ``procs`` workers, each with
    ``--worker RANK INIT`` appended, on a group with a file init under a
    fresh temporary directory (:func:`spawn_shards`: rank 0 writes to this
    process's output, every other rank to a log file there; a signal to
    this process reaches every worker). A worker that fails stops the
    others and fails the command with its log's tail."""
    import sys
    import tempfile

    with tempfile.TemporaryDirectory(prefix=module.rsplit(".", 1)[-1]
                                     + "_") as work:
        init = os.path.join(work, "init")
        src = str(Path(__file__).resolve().parents[2])
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ,
                   PYTHONPATH=src + (os.pathsep + path if path else ""))
        try:
            spawn_shards(lambda r: [sys.executable, "-m", module, *argv,
                                    "--worker", str(r), f"file://{init}"],
                         procs, work, None, env=env, rank0_to_stdout=True)
        except RuntimeError as e:
            raise SystemExit(str(e)) from None


def shutdown() -> None:
    """Destroy the process group, fake or real (and every mesh's groups), and
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
