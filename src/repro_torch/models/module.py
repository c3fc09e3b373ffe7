"""Layers and initialisers of the port's models.

The counterparts of the JAX package's ``repro/models/module.py``: dense
layers with the weight ``[d_in, d_out]`` as in JAX (``x @ w + b``),
``rmsnorm`` and ``layernorm`` computed in f32 and cast back, the embedding
gather, and the initialisers (truncated-normal fan-in scaling,
normal(0.02) embeddings). Random weights
come from a ``torch.Generator``, not JAX's bits: the tests carry weights
across with ``registry.from_jax_params``. The logical-axis tags (``Px``)
are a tree of their own here, parallel to the parameters:
``models/layout.py``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def dense_init(gen: torch.Generator, shape, dtype, in_dims: int = 1,
               device=None) -> Tensor:
    fan_in = 1
    for d in shape[:in_dims]:
        fan_in *= d
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / fan_in) ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


def dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
          bias: bool = False, device=None) -> dict[str, Tensor]:
    p = {"w": dense_init(gen, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_dense(p, x: Tensor) -> Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = _bias_layout(y, p["b"]) + p["b"]
    return y


def _bias_layout(y, b):
    """The planner's product ``y`` reduce-scattered onto the bias's split
    on every mesh dim where ``y`` is a partial sum and the bias ``b`` is
    split. PyTorch 2.13's sharding propagation picks this layout for the
    add in every planned cell; 2.11's turns the bias into a partial sum
    instead, a redistribution its DTensor cannot make. A plain tensor is
    returned as it is."""
    from repro_torch.core.mesh_axis import redistribute
    from repro_torch.sharding.partition import is_dtensor
    if not (is_dtensor(y) and is_dtensor(b)):
        return y
    from torch.distributed.tensor import Partial, Shard
    pl = [Shard(y.ndim - b.ndim + bp.dim)
          if isinstance(yp, Partial) and isinstance(bp, Shard) else yp
          for yp, bp in zip(y.placements, b.placements)]
    return redistribute(y, pl)


def dense_halves(p, x: Tensor, axes: tuple) -> tuple[Tensor, Tensor]:
    """``apply_dense(p, x)`` cut into its two halves along the last dim (no
    bias). For the planner's DTensors whose halves ``axes`` split by
    channels (``"mlp"`` on the model axis) each device multiplies its rows
    of x by the columns of its own slice of each half, from the gathered
    weight (a ``local_map``): a split of the product itself would leave a
    device's slice of one half on other devices, and gathering the product
    moves far more bytes than the weight. Elsewhere the product is cut."""
    from repro_torch.core.mesh_axis import redistribute
    from repro_torch.sharding.partition import (dim_shards, is_dtensor,
                                                partial_grad, placements_of)
    w = p["w"]
    n = w.shape[-1] // 2
    shape = tuple(x.shape[:-1]) + (n,)
    out_pl = (placements_of(shape, axes, x.device_mesh) if is_dtensor(x)
              else None)
    last = len(shape) - 1
    chan = ([] if out_pl is None else
            dim_shards(x.device_mesh, out_pl, last, n)[0])
    if not chan:
        return apply_dense(p, x).chunk(2, dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    _, n_loc, first = dim_shards(mesh, out_pl, last, n)
    x_pl = [q if isinstance(q, Shard) and q.dim < last else Replicate()
            for q in out_pl]
    split = [i for i, q in enumerate(out_pl) if isinstance(q, Shard)]
    rep = [Replicate()] * mesh.ndim
    xin = partial_grad(redistribute(x, x_pl), chan)
    win = partial_grad(redistribute(w, rep), split)

    def local(xl, wl):
        return (xl @ wl[:, first:first + n_loc],
                xl @ wl[:, n + first:n + first + n_loc])

    return local_map(local, out_placements=(out_pl, out_pl),
                     in_placements=(x_pl, rep), device_mesh=mesh)(xin, win)


def rmsnorm_init(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embed(table: Tensor, tokens: Tensor) -> Tensor:
    if hasattr(table, "placements"):     # the planner's DTensor
        from repro_torch.models.embedding import sharded_lookup
        return sharded_lookup(table, tokens)
    return table[tokens]
