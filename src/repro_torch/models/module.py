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
        y = y + p["b"]
    return y


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
