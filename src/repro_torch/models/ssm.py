"""Mamba-style selective SSM (the hybrid family's parallel-head branch).

The port of the JAX package's ``repro/models/ssm.py``. Training and prefill
(:func:`apply_seq_with_state`) compute the scan's inputs over the whole
sequence (``dt``, ``b``, ``c`` and ``a = -exp(a_log)``) and run the
recurrence in one call of ``kernels/ops.selective_scan``: on the card the
hand-written CUDA kernel, forward and backward, which keeps each channel's
states in registers and never writes the ``[T, d_inner, d_state]`` states;
on the CPU its plain version, JAX's chunk loop (chunk 256, parallel within
a chunk, sequential across chunks), whose ``associative_scan`` becomes a
log-depth Hillis-Steele scan over the chunk's time axis (8 rounds at chunk
256), each round out of place, so that autograd keeps every round.
``plain=True`` takes the plain version on the card too. Decode is the O(1)
recurrent step, elementwise, as in JAX. ``a_log`` and ``d_skip`` stay f32
in a bf16 model, and the state ``h`` is f32; the conv history has the
model's dtype.

On the planner's DTensors the channels ``d_inner`` (JAX's ``"mlp"``) stay
split over the model axis from the input projection to the output one:
``in_proj``'s two halves each by channels (``module.dense_halves``), the
depthwise conv on each device's channels and batch rows (a ``local_map``:
DTensor has no strategy for it), the scan by its custom op's channel rule;
only ``x_bc`` and ``x_dt``, which contract the channels, leave partial
sums.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.models import module as nn
from repro_torch.sharding.partition import is_dtensor, partial_grad, zeros

Tensor = torch.Tensor
_CHANNELS = ("batch", "seq", "mlp")      # u and z, the scan's channels


@dataclasses.dataclass
class SSMState:
    """Decode-time recurrent state; a pytree node, as JAX's."""

    h: Tensor       # [B, d_inner, d_state] f32
    conv: Tensor    # [B, k-1, d_inner] trailing conv inputs


torch.utils._pytree.register_dataclass(SSMState)


def init(gen: torch.Generator, d_model: int, d_state: int, d_inner: int,
         dtype, conv_k: int = 4, dt_rank: int | None = None,
         device=None) -> dict:
    dt_rank = dt_rank or max(1, d_model // 16)
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device).repeat(d_inner, 1)
    return {
        "in_proj": nn.dense(gen, d_model, 2 * d_inner, dtype, device=device),
        "conv_w": nn.dense_init(gen, (conv_k, d_inner), dtype, device=device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_bc": nn.dense(gen, d_inner, 2 * d_state, dtype, device=device),
        "x_dt": nn.dense(gen, d_inner, dt_rank, dtype, device=device),
        "dt_proj": nn.dense(gen, dt_rank, d_inner, dtype, bias=True,
                            device=device),
        "a_log": torch.log(a),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": nn.dense(gen, d_inner, d_model, dtype, device=device),
    }


def _conv_on_shards(w: Tensor, b: Tensor, x: Tensor,
                    history: Tensor | None) -> tuple[Tensor, Tensor]:
    """:func:`_conv1d_causal` of DTensors, on each device's batch rows and
    channels (a ``local_map``; the weights' gradients are partial sums
    over the batch's mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    x_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in x.placements]
    chan = [i for i, p in enumerate(x_pl) if p == Shard(2)]
    batch = [i for i, p in enumerate(x_pl) if p == Shard(0)]
    w_pl = [Shard(1) if i in chan else Replicate() for i in range(mesh.ndim)]
    b_pl = [Shard(0) if i in chan else Replicate() for i in range(mesh.ndim)]
    args = [x, partial_grad(w.redistribute(mesh, w_pl), batch),
            partial_grad(b.redistribute(mesh, b_pl), batch)]
    in_pl = [x_pl, w_pl, b_pl]
    if history is not None:
        args.append(history)
        in_pl.append(x_pl)
    return local_map(
        lambda xl, wl, bl, *hl: _conv1d_causal(wl, bl, xl, *hl),
        out_placements=(x_pl, x_pl), in_placements=tuple(in_pl),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def _conv1d_causal(w: Tensor, b: Tensor, x: Tensor,
                   history: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv. x: [B,T,C]; w: [k,C]; history: [B,k-1,C] ->
    (out [B,T,C], the last k-1 inputs)."""
    if is_dtensor(x):
        return _conv_on_shards(w, b, x, history)
    k = w.shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    new_hist = xp[:, xp.shape[1] - (k - 1):] if k > 1 else history
    return out + b, new_hist


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_inputs(p, u: Tensor):
    """u: [..., T, d_inner] -> the scan's inputs in f32: (dt [..., T,
    d_inner] after softplus, b, c [..., T, d_state], a = -exp(a_log)
    [d_inner, d_state])."""
    dt = _softplus(nn.apply_dense(p["dt_proj"],
                                  nn.apply_dense(p["x_dt"], u)).float())
    bc = nn.apply_dense(p["x_bc"], u).float()
    b, c = bc.chunk(2, dim=-1)
    return dt, b, c, -torch.exp(p["a_log"])


def _ssm_params(p, u: Tensor):
    """u: [..., T, d_inner] -> (da, dbx [..., T, d_inner, d_state], c
    [..., T, d_state]) for one recurrent step, in f32."""
    dt, b, c, a = _ssm_inputs(p, u)
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * u.float())[..., None] * b[..., None, :]
    return da, dbx, c


def apply_seq_with_state(p, x: Tensor, chunk: int = 256, plain: bool = False
                         ) -> tuple[Tensor, SSMState]:
    """Training/prefill forward ``x [B, T, d_model] -> [B, T, d_model]``
    and the state after the sequence (the final ``h`` and the last k-1
    pre-conv inputs), from the one pass. T is at most ``chunk`` or a
    multiple of it, as JAX asserts. The scan is ``ops.selective_scan``
    (the CUDA kernel on the card), or its plain version with ``plain``."""
    b, t, _ = x.shape
    u, z = nn.dense_halves(p["in_proj"], x, _CHANNELS)
    u, hist = _conv1d_causal(p["conv_w"], p["conv_b"], u)
    u = F.silu(u)
    d_inner, d_state = p["a_log"].shape
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    dt, bm, cm, a = _ssm_inputs(p, u)
    h0 = _zero_state(u, (b, d_inner, d_state))
    if plain:
        y, h = selective_scan_plain(dt, u, bm, cm, a, h0, chunk)
    else:
        y, h = ops.selective_scan(dt, u, bm, cm, a, h0)
    y = y + u.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    # the conv history in its own storage: as a view it would keep the
    # whole padded sequence [B, T + 3, d_inner] alive with the state
    return nn.apply_dense(p["out_proj"], y), SSMState(h=h, conv=hist.clone())


def _zero_state(u: Tensor, shape: tuple) -> Tensor:
    """f32 zeros ``[B, d_inner, d_state]`` on u's device; for a DTensor u
    ``[B, T, d_inner]``, split as u splits its batch and channels."""
    if not is_dtensor(u):
        return torch.zeros(shape, dtype=torch.float32, device=u.device)
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
          else Replicate() for p in u.placements]
    return zeros(shape, torch.float32, u, pl)


def apply_seq(p, x: Tensor, chunk: int = 256, plain: bool = False
              ) -> Tensor:
    """Training/prefill forward. x: [B, T, d_model] -> [B, T, d_model]."""
    return apply_seq_with_state(p, x, chunk, plain)[0]


def init_state(p, batch: int) -> SSMState:
    d_inner, d_state = p["a_log"].shape
    conv_k = p["conv_w"].shape[0]
    dev = p["a_log"].device
    return SSMState(
        h=torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros((batch, conv_k - 1, d_inner),
                         dtype=p["conv_w"].dtype, device=dev))


def decode_step(p, x: Tensor, state: SSMState) -> tuple[Tensor, SSMState]:
    """x: [B, 1, d_model] -> ([B, 1, d_model], state')."""
    u, z = nn.dense_halves(p["in_proj"], x, _CHANNELS)
    u, conv_hist = _conv1d_causal(p["conv_w"], p["conv_b"], u, state.conv)
    u = F.silu(u)
    da, dbx, c = _ssm_params(p, u)
    h = da[:, 0] * state.h + dbx[:, 0]
    y = torch.einsum("bds,bs->bd", h, c[:, 0])[:, None]
    y = y + u.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return nn.apply_dense(p["out_proj"], y), SSMState(h=h, conv=conv_hist)
