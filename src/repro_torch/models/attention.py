"""GQA attention for serving: prefill (returns the KV cache) and decode.

The counterparts of ``prefill`` and ``decode_step`` of the JAX package's
``repro/models/attention.py``. There the attention itself is a jnp
stand-in; here it goes through the port's kernels: prefill's causal
self-attention through ``ops.flash_attention`` (at any sequence length),
and decode through ``ops.decode_attention`` after the token's K/V is written
at slot ``position``. ``plain=True`` takes the kernels' plain PyTorch
versions instead, on any device: the caller asks for it (``chip_smoke.py``
holds the whole model against it on the card); nothing falls back to it.

The cache keeps the JAX layout, ``k, v [B, T, KV, hd]``, and decode writes
it in place (the JAX serve loop donates it). Sliding-window and ring
caches, cross-attention and the training path (``attend_full``) are not on
this path and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import module as nn
from repro_torch.models.rope import apply_rope

Tensor = torch.Tensor


@dataclasses.dataclass
class KVCache:
    """Decode-time KV cache for one attention layer (or stacked layers)."""

    k: Tensor  # [B, T, KV, hd]
    v: Tensor  # [B, T, KV, hd]


def init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
         head_dim: int, dtype, qkv_bias: bool = False, device=None) -> dict:
    return {
        "wq": nn.dense(gen, d_model, n_heads * head_dim, dtype,
                       bias=qkv_bias, device=device),
        "wk": nn.dense(gen, d_model, n_kv * head_dim, dtype, bias=qkv_bias,
                       device=device),
        "wv": nn.dense(gen, d_model, n_kv * head_dim, dtype, bias=qkv_bias,
                       device=device),
        "wo": nn.dense(gen, n_heads * head_dim, d_model, dtype,
                       device=device),
    }


def _split_heads(x: Tensor, n: int) -> Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _qkv(p, x: Tensor, n_heads: int, n_kv: int, positions: Tensor,
         rope_theta: float):
    """``x [B, S, D]`` -> q ``[B, S, H, hd]``, k and v ``[B, S, KV, hd]``."""
    q = _split_heads(nn.apply_dense(p["wq"], x), n_heads)
    k = _split_heads(nn.apply_dense(p["wk"], x), n_kv)
    v = _split_heads(nn.apply_dense(p["wv"], x), n_kv)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def make_mask(q_pos: Tensor, k_pos: Tensor, mode: str,
              window: Optional[int] = None) -> Tensor:
    """[B?, S] x [B?, T] -> [B?, S, T] boolean visibility mask."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    if mode == "causal":
        return d >= 0
    if mode == "bidirectional":
        return torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if mode == "sliding":
        assert window is not None
        return (d >= 0) & (d < window)
    raise ValueError(mode)


def prefill(p, x: Tensor, positions: Tensor, n_heads: int, n_kv: int,
            cache_len: int, rope_theta: float = 10000.0, plain: bool = False,
            cache: Optional[KVCache] = None) -> tuple[Tensor, KVCache]:
    """Causal full-sequence forward over ``x [B, S, D]`` at ``positions =
    arange(S)`` (the kernel's mask counts positions from 0) that also
    materializes the KV cache (``cache_len`` slots, the first S filled, the
    rest zero), in ``cache`` when one is given."""
    q, k, v = _qkv(p, x, n_heads, n_kv, positions, rope_theta)
    b, s = x.shape[:2]
    attend = flash_attention_plain if plain else ops.flash_attention
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True)                                # [B, H, S, hd]
    out = out.transpose(1, 2).reshape(b, s, -1)
    if cache is None:
        shape = (b, cache_len, n_kv, k.shape[-1])
        cache = KVCache(k=k.new_empty(shape), v=v.new_empty(shape))
    for dst, src in ((cache.k, k), (cache.v, v)):
        dst[:, :s] = src
        dst[:, s:] = 0
    return nn.apply_dense(p["wo"], out), cache


def decode_step(p, x: Tensor, cache: KVCache, position: int, n_heads: int,
                n_kv: int, rope_theta: float = 10000.0, plain: bool = False
                ) -> tuple[Tensor, KVCache]:
    """One-token decode: ``x [B, 1, D]`` at int ``position``. Writes the
    token's K/V into ``cache`` at slot ``position`` (in place) and attends
    to slots ``[0, position]``."""
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv, pos, rope_theta)
    cache.k[:, position] = k[:, 0]
    cache.v[:, position] = v[:, 0]
    attend = decode_attention_plain if plain else ops.decode_attention
    out = attend(q[:, 0], cache.k, cache.v, position)        # [B, H, hd]
    return nn.apply_dense(p["wo"], out.reshape(b, 1, -1)), cache
