"""GQA attention: training over a full sequence, prefill (returns the KV
cache) and decode, self-attention and cross-attention.

The counterparts of ``attend_full``, ``attend_cross``, ``cross_kv``,
``prefill`` and ``decode_step`` of the JAX package's
``repro/models/attention.py``. Training (``attend_full``,
with ``_attend``, ``_attend_grouped`` and the online-softmax
``_attend_blockwise`` above ``BLOCKWISE_THRESHOLD``, and ``attend_cross``)
is plain PyTorch, as
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

On DTensors (the planner's, ``launch/steps.py``) ``attend_full`` constrains
q and k to their logical axes, as JAX's does, and the attention itself
runs on each device's batch and heads (:func:`_on_head_shards`, slicing the
KV heads a device's heads read when the mesh cannot split them); a decode
cache split by sequence is attended slice by slice and combined by each
head's log-sum-exp (:func:`_sharded_decode`). On a plain tensor, and
outside a rules context, none of it runs.

The cache keeps the JAX layout, ``k, v [B, T, KV, hd]``, and decode writes
it in place (the JAX serve loop donates it). Sliding-window layers keep a
ring of W slots (:class:`RingKVCache`): ``ring_prefill`` attends through
``flash_attention(..., window=W)`` and writes the last ``min(W, S)`` keys
and values into slots ``pos % W``; ``ring_decode_step`` writes the token at
slot ``position % W`` and attends through ``decode_attention`` over slots
``[0, min(position, W - 1)]`` (why that is exact: its docstring).

An encoder's self-attention (:func:`encoder_attend`) sees every position:
``flash_attention(causal=False)`` over RoPE'd q and k, as JAX's
``attend_full(..., "bidirectional")``. Cross-attention reads k and v of
the encoder output (:func:`cross_kv`, ``[B, T_enc, KV, hd]``, no RoPE) and
takes q from ``wq`` with no RoPE either: :func:`attend_cross` is the plain
form (every key visible), :func:`cross_prefill` goes through
``flash_attention(causal=False)`` with S queries against T_enc keys, and
:func:`cross_decode_step` through ``decode_attention`` at position
``T_enc - 1`` over that cross cache, which no decode step writes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import module as nn
from repro_torch.models.rope import apply_rope
from repro_torch.core.mesh_axis import redistribute
from repro_torch.sharding.partition import (dim_shards, is_dtensor,
                                            local_inputs, partial_grad)
from repro_torch.sharding.partition import logical_constraint as lc

Tensor = torch.Tensor

# Above this sequence length, full-seq attention switches to the online-
# softmax blockwise path (memory O(chunk * T) instead of O(S * T)).
BLOCKWISE_THRESHOLD = 4096


@dataclasses.dataclass
class KVCache:
    """Decode-time KV cache for one attention layer (or stacked layers); a
    pytree node, as JAX's."""

    k: Tensor  # [B, T, KV, hd]
    v: Tensor  # [B, T, KV, hd]


torch.utils._pytree.register_pytree_node(
    KVCache, lambda c: ([c.k, c.v], None),
    lambda leaves, _: KVCache(*leaves))


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
    if is_dtensor(x):      # heads the mesh cannot split evenly: gather them
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        split = [i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == last]
        if n % math.prod(x.device_mesh.size(i) for i in split):
            x = redistribute(x, [Replicate() if i in split else p
                                 for i, p in enumerate(x.placements)])
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


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_head_shards(fn, q, k, v):
    """``fn(q, k, v) -> [B, S, H*hd]`` on each device's shard of DTensors
    q ``[B, S, H, hd]``, k, v ``[B, T, KV, hd]`` (the planner's): batch
    and heads stay where q has them, as JAX's ``_repeat_kv`` keeps the
    score tensor head-sharded. Where the mesh splits the heads but not the
    KV heads, each device slices the KV heads its own heads read (h // G),
    so G = H / KV holds locally."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    q_in, kv_in, out = [], [], []
    head_dims = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            q_in.append(Shard(0)), kv_in.append(Shard(0)), out.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:
            q_in.append(Shard(2)), out.append(Shard(2))
            head_dims.append(i)
            kv_in.append(Shard(2) if kv % mesh.size(i) == 0 else Replicate())
        else:
            q_in.append(Replicate()), kv_in.append(Replicate())
            out.append(Replicate())
    sliced = [i for i in head_dims if not isinstance(kv_in[i], Shard)]
    _, h_loc, first = dim_shards(mesh, q_in, 2, h)
    g = h // kv
    lo = first // g
    hi = (first + h_loc - 1) // g + 1
    if sliced and h_loc % (hi - lo):
        raise ValueError(f"{h} heads, {h_loc} a device, do not map onto "
                         f"whole groups of {kv} KV heads")

    def local(ql, kl, vl):
        # the gradients leave in the layout DTensor assumes (contiguous)
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if sliced:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl).contiguous()

    # a device reads only its slice of replicated k, v: its gradient is a
    # share of theirs
    k, v = partial_grad(k, sliced), partial_grad(v, sliced)
    return local_map(local, out_placements=out,
                     in_placements=(q_in, kv_in, kv_in),
                     device_mesh=mesh)(*local_inputs(
                         (q, k, v), (q_in, kv_in, kv_in)))


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
    q = lc(q, ("batch", "seq", "heads", "head_dim"))
    k = lc(k, ("batch", "seq", "kv_heads", "head_dim"))

    def core(q, k, v):
        if q.shape[1] > BLOCKWISE_THRESHOLD:
            return _attend_blockwise(q, k, v, positions, positions, mode,
                                     window)
        mask = make_mask(positions, positions, mode, window)
        return _attend(q, k, v, mask[None] if mask.dim() == 2 else mask)

    out = _on_head_shards(core, q, k, v) if is_dtensor(q) else core(q, k, v)
    return nn.apply_dense(p["wo"], out)


def _flash(q: Tensor, k: Tensor, v: Tensor, plain: bool, causal: bool,
           window: int = 0) -> Tensor:
    """q ``[B, S, H, hd]``, k, v ``[B, T, KV, hd]`` through the flash
    kernel (or its plain version), as transposed views with no copy -> the
    heads' output ``[B, S, H*hd]``."""
    b, s = q.shape[:2]
    attend = flash_attention_plain if plain else ops.flash_attention
    if is_dtensor(q):
        return _on_head_shards(
            lambda q, k, v: _flash(q, k, v, plain, causal, window), q, k, v)
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window)               # [B, H, S, hd]
    return out.transpose(1, 2).reshape(b, s, -1)


def _prefill_attend(p, x: Tensor, positions: Tensor, n_heads: int,
                    n_kv: int, rope_theta: float, plain: bool, window: int
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """Causal (``window`` > 0: sliding) self-attention of ``x [B, S, D]``
    through the flash kernel -> (the heads' output ``[B, S, H*hd]``, k, v
    ``[B, S, KV, hd]``)."""
    q, k, v = _qkv(p, x, n_heads, n_kv, positions, rope_theta)
    return _flash(q, k, v, plain, True, window), k, v


def encoder_attend(p, x: Tensor, positions: Tensor, n_heads: int, n_kv: int,
                   rope_theta: float = 10000.0, plain: bool = False
                   ) -> Tensor:
    """Bidirectional self-attention of ``x [B, S, D]`` at ``positions``
    (RoPE'd q and k) through ``flash_attention(causal=False)``: the serving
    form of ``attend_full(..., "bidirectional")``."""
    q, k, v = _qkv(p, x, n_heads, n_kv, positions, rope_theta)
    return nn.apply_dense(p["wo"], _flash(q, k, v, plain, False))


def cross_kv(p, ctx: Tensor, n_kv: int) -> tuple[Tensor, Tensor]:
    """k and v of the encoder output ``ctx [B, T, D]``, each ``[B, T, KV,
    hd]``, with no RoPE."""
    return (_split_heads(nn.apply_dense(p["wk"], ctx), n_kv),
            _split_heads(nn.apply_dense(p["wv"], ctx), n_kv))


def _cross_q(p, x: Tensor, n_heads: int) -> Tensor:
    return _split_heads(nn.apply_dense(p["wq"], x), n_heads)   # no RoPE


def attend_cross(p, x: Tensor, ctx_kv: tuple[Tensor, Tensor], n_heads: int
                 ) -> Tensor:
    """Cross-attention of ``x [B, S, D]`` over every key of ``ctx_kv``
    (:func:`cross_kv`), in plain PyTorch: the train path's form."""
    k, v = ctx_kv
    q = _cross_q(p, x, n_heads)
    if is_dtensor(q):
        q = lc(q, ("batch", "seq", "heads", "head_dim"))
        k = lc(k, ("batch", "seq", "kv_heads", "head_dim"))

    def core(q, k, v):
        mask = torch.ones((1, q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
        return _attend(q, k, v, mask)

    out = _on_head_shards(core, q, k, v) if is_dtensor(q) else core(q, k, v)
    return nn.apply_dense(p["wo"], out)


def cross_prefill(p, x: Tensor, ctx_kv: tuple[Tensor, Tensor], n_heads: int,
                  plain: bool = False) -> Tensor:
    """:func:`attend_cross` through ``flash_attention(causal=False)``: S
    queries against the T_enc keys of ``ctx_kv``."""
    out = _flash(_cross_q(p, x, n_heads), *ctx_kv, plain, False)
    return nn.apply_dense(p["wo"], out)


def cross_decode_step(p, x: Tensor, ctx_kv: tuple[Tensor, Tensor],
                      n_heads: int, plain: bool = False) -> Tensor:
    """One token ``x [B, 1, D]`` attending over the whole cross cache
    ``ctx_kv`` (``[B, T_enc, KV, hd]`` each, not written) through
    ``decode_attention`` at position ``T_enc - 1``."""
    k, v = ctx_kv
    q = _cross_q(p, x, n_heads)[:, 0]
    if is_dtensor(k):
        out = _sharded_decode(q, k, v, k.shape[1] - 1)
    else:
        attend = decode_attention_plain if plain else ops.decode_attention
        out = attend(q, k, v, k.shape[1] - 1)
    return nn.apply_dense(p["wo"], out.reshape(x.shape[0], 1, -1))


def prefill(p, x: Tensor, positions: Tensor, n_heads: int, n_kv: int,
            cache_len: int, rope_theta: float = 10000.0, plain: bool = False,
            cache: Optional[KVCache] = None) -> tuple[Tensor, KVCache]:
    """Causal full-sequence forward over ``x [B, S, D]`` at ``positions =
    arange(S)`` (the kernel's mask counts positions from 0) that also
    materializes the KV cache (``cache_len`` slots, the first S filled, the
    rest zero), in ``cache`` when one is given. A sliding-window layer
    prefills through :func:`ring_prefill`."""
    out, k, v = _prefill_attend(p, x, positions, n_heads, n_kv, rope_theta,
                                plain, 0)
    b, s = x.shape[:2]
    if cache is None:
        shape = (b, cache_len, n_kv, k.shape[-1])
        cache = KVCache(k=k.new_empty(shape), v=v.new_empty(shape))
    for dst, src in ((cache.k, k), (cache.v, v)):
        dst[:, :s] = src
        if s < cache_len:
            dst[:, s:].zero_()
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
    if is_dtensor(cache.k):
        _write_slot(cache.k, k[:, 0], position)
        _write_slot(cache.v, v[:, 0], position)
        out = _sharded_decode(q[:, 0], cache.k, cache.v, position)
        return nn.apply_dense(p["wo"], out.reshape(b, 1, -1)), cache
    cache.k[:, position] = k[:, 0]
    cache.v[:, position] = v[:, 0]
    attend = decode_attention_plain if plain else ops.decode_attention
    out = attend(q[:, 0], cache.k, cache.v, position)        # [B, H, hd]
    return nn.apply_dense(p["wo"], out.reshape(b, 1, -1)), cache


def _seq_shards(cache):
    """(mesh dims that split a DTensor cache's slots, slots a shard, this
    device's first slot)."""
    return dim_shards(cache.device_mesh, cache.placements, 1, cache.shape[1])


def _write_slot(cache, x, position: int) -> None:
    """``cache[:, position] = x`` for a DTensor cache ``[B, T, KV, hd]``
    (the planner's): the device holding the slot writes it, in place."""
    from torch.distributed.tensor import Replicate, Shard
    dims, n, first = _seq_shards(cache)
    want = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else
            Shard(1) if isinstance(p, Shard) and p.dim == 2 else Replicate()
            for p in cache.placements]
    local = cache.to_local()
    if first <= position < first + n:
        local[:, position - first] = x.redistribute(
            cache.device_mesh, want).to_local()


def _sharded_decode(q, k, v, position: int):
    """``decode_attention`` of DTensors q ``[B, H, d]``, k, v ``[B, T, KV,
    d]`` (the planner's). Over KV heads or the batch the kernel's op splits
    by its own rule; over the slots (a cache split by sequence, JAX's
    decode rule when KV does not divide the model axis) each device attends
    to its slots with every head and the slices combine by the softmax of
    their log-sum-exps, as the kernel's own split pass does within one
    device."""
    import torch.distributed.tensor as dt
    from torch.distributed.tensor.experimental import local_map
    dims, n, first = _seq_shards(k)
    if not dims:
        return ops.decode_attention(q, k, v, position)
    mesh = k.device_mesh
    q_in = [dt.Shard(0) if isinstance(p, dt.Shard) and p.dim == 0
            else dt.Replicate() for p in k.placements]
    out = [dt.Shard(0) if i in dims else dt.Shard(1) if p == dt.Shard(0)
           else dt.Replicate() for i, p in enumerate(q_in)]

    def local(ql, kl, vl):
        last = position - first
        if last < 0:        # none of this device's slots is visible yet
            return (ql.new_zeros((1,) + tuple(ql.shape)),
                    ql.new_full((1,) + tuple(ql.shape[:2]), -1e30,
                                dtype=torch.float32))
        o, lse = torch.ops.repro_torch.decode_attention_lse(
            ql, kl, vl, min(last, n - 1))
        return o[None], lse[None]

    o, lse = local_map(local, out_placements=(out, out),
                       in_placements=(q_in, k.placements, v.placements),
                       device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    w = torch.softmax(lse, dim=0)
    out = (o.float() * w[..., None]).sum(0).to(q.dtype)
    return lc(out, ("batch", "heads", "head_dim"))


# ---------------------------------------------------------------------------
# Ring-buffer cache for sliding-window layers: O(window) memory whatever the
# context length.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RingKVCache:
    """Sliding-window cache: slot i holds the most recent position = i (mod
    W); a pytree node, as JAX's."""

    k: Tensor  # [B, W, KV, hd]
    v: Tensor  # [B, W, KV, hd]


torch.utils._pytree.register_pytree_node(
    RingKVCache, lambda c: ([c.k, c.v], None),
    lambda leaves, _: RingKVCache(*leaves))


def ring_slot_positions(position: int, window: int, device=None) -> Tensor:
    """The absolute position held in each ring slot at ``position``: slot
    i holds ``position - ((position - i) mod W)``; a negative one is
    empty."""
    i = torch.arange(window, dtype=torch.int64, device=device)
    return position - torch.remainder(position - i, window)


def ring_prefill(p, x: Tensor, positions: Tensor, n_heads: int, n_kv: int,
                 window: int, rope_theta: float = 10000.0,
                 plain: bool = False, cache: Optional[RingKVCache] = None
                 ) -> tuple[Tensor, RingKVCache]:
    """Sliding-window forward over ``x [B, S, D]`` at ``positions =
    arange(S)`` through ``flash_attention(..., window=W)``; the ring keeps
    the last ``min(W, S)`` keys and values, at slots ``pos % W`` (the rest
    zero), in ``cache`` when one is given. Those slots are at most two
    runs of consecutive ones, each written as a slice."""
    out, k, v = _prefill_attend(p, x, positions, n_heads, n_kv, rope_theta,
                                plain, window)
    b, s = x.shape[:2]
    take = min(window, s)
    if cache is None:
        shape = (b, window, n_kv, k.shape[-1])
        cache = RingKVCache(k=k.new_empty(shape), v=v.new_empty(shape))
    first = (s - take) % window          # the slot of position s - take
    run = min(take, window - first)
    for dst, src in ((cache.k, k), (cache.v, v)):
        dst[:, first:first + run] = src[:, s - take:s - take + run]
        if run < take:
            dst[:, :take - run] = src[:, s - take + run:]
        if take < window:
            dst[:, take:].zero_()
    return nn.apply_dense(p["wo"], out), cache


def ring_decode_step(p, x: Tensor, cache: RingKVCache, position: int,
                     n_heads: int, n_kv: int, window: int,
                     rope_theta: float = 10000.0, plain: bool = False
                     ) -> tuple[Tensor, RingKVCache]:
    """One-token decode in a sliding-window layer: ``x [B, 1, D]`` at int
    ``position``. Writes the token's K/V at slot ``position % W`` (in place)
    and attends through ``decode_attention`` over slots ``[0, min(position,
    W - 1)]``. That equals JAX's ``ring_decode_step``, which masks the ring
    by ``ring_slot_positions``: RoPE is applied before the write and the
    softmax does not depend on the order of the slots; once ``position >=
    W - 1`` all W slots hold the positions ``position - W + 1 ..
    position``, every one visible; before that, slots ``[0, position]``
    hold positions ``0 .. position`` and the rest are empty."""
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv, pos, rope_theta)
    slot = position % window
    last = min(position, window - 1)
    if is_dtensor(cache.k):
        _write_slot(cache.k, k[:, 0], slot)
        _write_slot(cache.v, v[:, 0], slot)
        out = _sharded_decode(q[:, 0], cache.k, cache.v, last)
        return nn.apply_dense(p["wo"], out.reshape(b, 1, -1)), cache
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    attend = decode_attention_plain if plain else ops.decode_attention
    out = attend(q[:, 0], cache.k, cache.v, last)
    return nn.apply_dense(p["wo"], out.reshape(b, 1, -1)), cache
