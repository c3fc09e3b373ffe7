"""The apps' executors, and ``run_app``: one app end to end against its
reference.

The JAX package runs its apps on a device mesh (``build_mesh`` /
``mesh_spmd``: one device a shard, ``shard_map``). The port runs them on
either executor: the stacked one (``core/stacked.StackedSPMD``, every shard
on one device as dim 0; the default), or the mesh one that
:func:`build_mesh` and :func:`mesh_spmd` make here
(``core/mesh_axis.MeshSPMD``, one process a shard, each with its ``[1,
...]`` slice, the merges ``torch.distributed`` calls over a gloo or NCCL
group that ``launch/mesh.init_shards`` makes). The scatter phase runs the
CUDA ``cscatter`` kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mesh_axis import MeshSPMD
from repro_torch.serve.kv import resolve_device


def build_mesh(n_devices: int, axis_name: str = "shards",
               device_type: str = "cuda"):
    """The 1-D mesh of ``n_devices`` shards over this process group's
    ranks, one process a shard (``launch/mesh.init_shards`` makes the group
    and this mesh): the counterpart of JAX's ``build_mesh``. Its device
    type is the card's unless the caller passes ``cpu`` (gloo only; gloo on
    the card stages through the host). The group must have ``n_devices``
    ranks: every rank of it takes part in the mesh's collectives."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: "
                           "launch/mesh.init_shards makes one")
    world = dist.get_world_size()
    if world != n_devices:
        raise RuntimeError(f"a mesh of {n_devices} shards needs a group of "
                           f"{n_devices} processes, this one has {world}")
    resolve_device(device_type)
    return DeviceMesh(device_type, torch.arange(n_devices),
                      mesh_dim_names=(axis_name,))


def mesh_spmd(mesh, axis_name: str = "shards") -> MeshSPMD:
    """The executor over ``mesh``: ``spmd(fn, *args, donate=())`` on this
    process's ``[1, ...]`` slice of shard-major args, its ``.axis`` the
    ``MeshAxis`` of ``axis_name`` (the counterpart of JAX's ``mesh_spmd``,
    ``shard_map`` over the axis; the executor contract of
    ``core/stacked.py``)."""
    return MeshSPMD(mesh, axis_name)


def _graph(n: int, e: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, n)])
    return src.astype(np.int32), dst.astype(np.int32)


def run_app(app: str, n_shards: int, *, defer_k: int = 4, seed: int = 0,
            n_vertices: int = 48, n_edges: int = 160,
            device="cuda", spmd=None) -> dict:
    """Run one app sharded over ``n_shards`` shards against its reference:
    stacked on ``device`` (the card unless the caller asks for the CPU),
    or on the executor ``spmd`` (a mesh of ``n_shards`` processes, every
    one of which calls this and gets the record).

    Returns a record with ``max_err`` (0.0 expected for the bitwise MIN
    app) for both the all-eager plan and the deferred/overlapped commit
    schedule.
    """
    from repro_torch.apps import (bfs_reference, kmeans_reference,
                                  pagerank_reference, run_bfs, run_kmeans,
                                  run_pagerank)
    from repro_torch.apps.bfs import INF
    from repro_torch.apps.common import default_plan, shard_edges

    if spmd is not None:
        if spmd.n_shards != n_shards:
            raise ValueError(f"the executor has {spmd.n_shards} shards, "
                             f"run_app {n_shards}")
        device = spmd.device
    device = resolve_device(device)
    plan = default_plan(n_shards)
    plan_d = default_plan(n_shards, defer_top=True)
    out: dict = {"app": app, "n_shards": n_shards, "defer_k": defer_k}

    def edges(src, dst):
        return [torch.from_numpy(x).to(device)
                for x in shard_edges(src, dst, n_shards)]

    if app == "bfs":
        src, dst = _graph(n_vertices, n_edges, seed)
        ref = bfs_reference(n_vertices, src, dst, 0)
        src_sh, dst_sh = edges(src, dst)
        dist0 = torch.full((n_shards, n_vertices), INF, dtype=torch.int32,
                           device=device)
        dist0[:, 0] = 0
        eager = run_bfs(dist0, src_sh, dst_sh, plan, supersteps=n_vertices,
                        spmd=spmd)
        defer = run_bfs(dist0, src_sh, dst_sh, plan_d,
                        supersteps=defer_k * n_vertices, defer_k=defer_k,
                        spmd=spmd)
        out["eager_max_err"] = float(
            np.abs(eager[0].cpu().numpy().astype(np.int64) - ref).max())
        out["defer_max_err"] = float(
            np.abs(defer[0].cpu().numpy().astype(np.int64) - ref).max())
        out["bitwise"] = True
    elif app == "pagerank":
        alpha, iters = 0.5, 16 * defer_k
        src, dst = _graph(n_vertices, n_edges, seed)
        ref = pagerank_reference(n_vertices, src, dst, alpha=alpha,
                                 iters=iters)
        src_sh, dst_sh = edges(src, dst)
        eager = run_pagerank(n_vertices, src_sh, dst_sh, plan, alpha=alpha,
                             supersteps=iters, spmd=spmd)
        defer = run_pagerank(n_vertices, src_sh, dst_sh, plan_d, alpha=alpha,
                             supersteps=iters, defer_k=defer_k, spmd=spmd)
        out["eager_max_err"] = float(
            np.abs(eager[0].cpu().numpy().astype(np.float64) - ref).max())
        out["defer_max_err"] = float(
            np.abs(defer[0].cpu().numpy().astype(np.float64) - ref).max())
        out["bitwise"] = False
    elif app == "kmeans":
        k, d, b, t = 5, 3, 16, 2 * defer_k
        rng = np.random.default_rng(seed)
        pts = rng.normal(size=(n_shards, t, b, d)).astype(np.float32)
        c0 = rng.normal(size=(k, d)).astype(np.float32)
        pts_ref = pts.transpose(1, 0, 2, 3).reshape(t, n_shards * b, d)
        errs = {}
        for label, overlap in (("defer", False), ("overlap", True)):
            ref = kmeans_reference(pts_ref, c0, commit_k=defer_k,
                                   overlap=overlap)
            got = run_kmeans(torch.from_numpy(pts).to(device),
                             torch.from_numpy(c0).to(device), plan_d,
                             commit_k=defer_k, overlap=overlap, spmd=spmd)
            errs[f"{label}_max_err"] = float(
                np.abs(got[0].cpu().numpy().astype(np.float64)
                       - ref.astype(np.float64)).max())
        out.update(errs)
        out["eager_max_err"] = errs["defer_max_err"]
        out["bitwise"] = False
    else:
        raise ValueError(f"unknown app {app!r}")
    return out
