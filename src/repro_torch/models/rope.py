"""Rotary position embeddings (RoPE), as ``repro/models/rope.py``: f32
angles, the head dim split in halves."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor,
               theta: float = 10000.0) -> Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs       # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
