"""Feed-forward blocks, as ``repro/models/mlp.py``: SwiGLU (the llama
family, Hymba) and the two-matrix GELU MLP (``cfg.mlp == "gelu"``, e.g.
granite-34b; xLSTM's sLSTM block uses the same GELU). The GELU is JAX's
default, the tanh approximation (``jax.nn.gelu(approximate=True)``), not
torch's exact erf form: :func:`gelu`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import module as nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` as JAX calls it by default: the tanh approximation
    (the erf form differs by up to 4.7e-4)."""
    return F.gelu(x, approximate="tanh")


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device=None) -> dict:
    return {
        "wi_gate": nn.dense(gen, d_model, d_ff, dtype, device=device),
        "wi_up": nn.dense(gen, d_model, d_ff, dtype, device=device),
        "wo": nn.dense(gen, d_ff, d_model, dtype, device=device),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(nn.apply_dense(p["wi_gate"], x))
    u = nn.apply_dense(p["wi_up"], x)
    return nn.apply_dense(p["wo"], g * u)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  bias: bool = True, device=None) -> dict:
    return {
        "wi": nn.dense(gen, d_model, d_ff, dtype, bias=bias, device=device),
        "wo": nn.dense(gen, d_ff, d_model, dtype, bias=bias, device=device),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return nn.apply_dense(p["wo"], gelu(nn.apply_dense(p["wi"], x)))
