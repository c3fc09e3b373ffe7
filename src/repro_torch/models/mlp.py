"""Feed-forward blocks, as ``repro/models/mlp.py``: SwiGLU. (``gelu_mlp``
comes with the encoder-decoder family.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import module as nn


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
