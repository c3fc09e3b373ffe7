"""GQA attention: training over a full sequence, prefill (returns the KV
cache) and decode.

The counterparts of ``attend_full``, ``prefill`` and ``decode_step`` of the
JAX package's ``repro/models/attention.py``. Training (``attend_full``,
with ``_attend``, ``_attend_grouped`` and the online-softmax
``_attend_blockwise`` above ``BLOCKWISE_THRESHOLD``) is plain PyTorch, as
the JAX package computes it in jnp outside any Pallas kernel: neither
attention kernel has a backward in either package, so the train path never
calls ``flash_attention``. For serving the attention itself is a jnp
stand-in in the JAX package; here it goes through the port's kernels:
prefill's causal
self-attention through ``ops.flash_attention`` (at any sequence length),
and decode through ``ops.decode_attention`` after the token's K/V is written
at slot ``position``. ``plain=True`` takes the kernels' plain PyTorch
versions instead, on any device: the caller asks for it (``chip_smoke.py``
holds the whole model against it on the card); nothing falls back to it.

The cache keeps the JAX layout, ``k, v [B, T, KV, hd]``, and decode writes
it in place (the JAX serve loop donates it). Ring caches and
cross-attention are not ported yet.
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

# Above this sequence length, full-seq attention switches to the online-
# softmax blockwise path (memory O(chunk * T) instead of O(S * T)).
BLOCKWISE_THRESHOLD = 4096


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


def _repeat_kv(k: Tensor, g: int) -> Tensor:
    """[B,T,KV,hd] -> [B,T,KV*g,hd] (head h reads kv group h//g)."""
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=2)


def _masked_softmax(scores: Tensor, mask: Tensor, dtype) -> Tensor:
    """f32 ``scores`` with masked entries at -1e30, softmaxed, in ``dtype``
    (as the JAX package's ``jnp.where`` + ``jax.nn.softmax``)."""
    scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=scores.dtype,
                                                    device=scores.device))
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd]; mask: [B or 1, S, T] bool."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kf, vf = _repeat_kv(k, g), _repeat_kv(v, g)
    scores = torch.einsum("bshd,bthd->bhst", q, kf).float()
    scores = scores * (1.0 / hd ** 0.5)
    probs = _masked_softmax(scores, mask[:, None, :, :], v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.reshape(b, s, h * hd)


def _attend_grouped(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """The grouped form of :func:`_attend`: (kv, g) einsums with the same
    h // g mapping, mathematically identical."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * (1.0 / hd ** 0.5)
    probs = _masked_softmax(scores, mask[:, None, None, :, :], v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * hd)


def _attend_blockwise(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                      k_pos: Tensor, mode: str, window: Optional[int],
                      q_chunk: int = 512) -> Tensor:
    """Attention one chunk of ``q_chunk`` queries at a time: memory
    O(chunk * T). With a static sliding window, each chunk attends only its
    ``[chunk_start - window, chunk_end)`` key slice."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    t = k.shape[1]
    scale = 1.0 / hd ** 0.5
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                         f"{q_chunk}")
    kf, vf = _repeat_kv(k, g), _repeat_kv(v, g)
    qpc = torch.broadcast_to(q_pos, (b, s))
    kp_full = torch.broadcast_to(k_pos, (b, t))
    windowed = (mode == "sliding" and isinstance(window, int)
                and 0 < window and window + q_chunk < t)
    if windowed:
        # left-pad keys by `window` so chunk i reads [i*qc, i*qc + qc + W)
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, window, 0))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, window, 0))
        kp_full = torch.nn.functional.pad(kp_full, (window, 0),
                                          value=-(1 << 30))
    outs = []
    for i in range(s // q_chunk):
        lo = i * q_chunk
        qi, qpi = q[:, lo:lo + q_chunk], qpc[:, lo:lo + q_chunk]
        if windowed:
            ki = kf[:, lo:lo + q_chunk + window]
            vi = vf[:, lo:lo + q_chunk + window]
            kpi = kp_full[:, lo:lo + q_chunk + window]
        else:
            ki, vi, kpi = kf, vf, kp_full
        scores = torch.einsum("bshd,bthd->bhst", qi, ki).float() * scale
        probs = _masked_softmax(scores, make_mask(qpi, kpi, mode,
                                                  window)[:, None], v.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, vi)
        outs.append(out.reshape(b, q_chunk, h * hd))
    return torch.cat(outs, dim=1)


def attend_full(p, x: Tensor, positions: Tensor, n_heads: int, n_kv: int,
                mode: str = "causal", window: Optional[int] = None,
                rope_theta: float = 10000.0) -> Tensor:
    """Training / encoder path over a full sequence ``x [B, S, D]``."""
    q, k, v = _qkv(p, x, n_heads, n_kv, positions, rope_theta)
    if x.shape[1] > BLOCKWISE_THRESHOLD:
        out = _attend_blockwise(q, k, v, positions, positions, mode, window)
    else:
        mask = make_mask(positions, positions, mode, window)
        if mask.dim() == 2:
            mask = mask[None]
        out = _attend(q, k, v, mask)
    return nn.apply_dense(p["wo"], out)


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
