"""Layers and initialisers of the port's models.

The counterparts of the JAX package's ``repro/models/module.py``: dense
layers with the weight ``[d_in, d_out]`` as in JAX (``x @ w + b``), an
f32-compute ``rmsnorm``, the embedding gather, and the initialisers
(truncated-normal fan-in scaling, normal(0.02) embeddings). Random weights
come from a ``torch.Generator``, not JAX's bits: the tests carry weights
across with ``registry.from_jax_params``. One card has no mesh, so the
logical-axis tags (``Px``) have no counterpart.
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


def embed(table: Tensor, tokens: Tensor) -> Tensor:
    return table[tokens]
