"""Mamba-style selective SSM (the hybrid family's parallel-head branch).

The port of the JAX package's ``repro/models/ssm.py``. Training and prefill
run the chunked scan (chunk 256): parallel within a chunk, sequential across
chunks, so the ``[T, d_inner, d_state]`` intermediate exists for one chunk
at a time. JAX's ``associative_scan`` becomes a log-depth Hillis-Steele
scan over the chunk's time axis (8 rounds at chunk 256), not a loop over
time. Decode is the O(1) recurrent step. ``a_log`` and ``d_skip`` stay f32
in a bf16 model, and the state ``h`` is f32; the conv history has the
model's dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import module as nn

Tensor = torch.Tensor


@dataclasses.dataclass
class SSMState:
    """Decode-time recurrent state."""

    h: Tensor       # [B, d_inner, d_state] f32
    conv: Tensor    # [B, k-1, d_inner] trailing conv inputs


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


def _conv1d_causal(w: Tensor, b: Tensor, x: Tensor,
                   history: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv. x: [B,T,C]; w: [k,C]; history: [B,k-1,C] ->
    (out [B,T,C], the last k-1 inputs)."""
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


def _ssm_params(p, u: Tensor):
    """u: [..., T, d_inner] -> (da, dbx [..., T, d_inner, d_state], c
    [..., T, d_state]) for the scan, in f32."""
    dt = _softplus(nn.apply_dense(p["dt_proj"],
                                  nn.apply_dense(p["x_dt"], u)).float())
    bc = nn.apply_dense(p["x_bc"], u).float()
    b, c = bc.chunk(2, dim=-1)
    a = -torch.exp(p["a_log"])                     # [d_inner, d_state]
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * u.float())[..., None] * b[..., None, :]
    return da, dbx, c


def _scan_chunk(da: Tensor, dbx: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """The first-order recurrence ``h_t = da_t * h_{t-1} + dbx_t`` over a
    chunk's axis 1, from ``h0``: a Hillis-Steele scan of the pairs ``(a,
    b)`` under ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``, log2(chunk)
    rounds, out of place (autograd keeps each round). -> (h [B, c, ...],
    h at the chunk's end)."""
    t = da.shape[1]
    b = torch.cat([dbx[:, :1] + da[:, :1] * h0[:, None], dbx[:, 1:]], dim=1)
    a = da
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < t:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]


def apply_seq_with_state(p, x: Tensor, chunk: int = 256
                         ) -> tuple[Tensor, SSMState]:
    """Training/prefill forward ``x [B, T, d_model] -> [B, T, d_model]``
    and the state after the sequence (the final ``h`` and the last k-1
    pre-conv inputs), from the one pass."""
    b, t, _ = x.shape
    u, z = nn.apply_dense(p["in_proj"], x).chunk(2, dim=-1)
    u, hist = _conv1d_causal(p["conv_w"], p["conv_b"], u)
    u = F.silu(u)
    d_inner, d_state = p["a_log"].shape
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    h = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(t // chunk):
        da, dbx, c = _ssm_params(p, u[:, i * chunk:(i + 1) * chunk])
        h_seq, h = _scan_chunk(da, dbx, h)
        del da, dbx
        ys.append(torch.einsum("btds,bts->btd", h_seq, c))
        del h_seq
    y = torch.cat(ys, dim=1)
    y = y + u.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return nn.apply_dense(p["out_proj"], y), SSMState(h=h, conv=hist)


def apply_seq(p, x: Tensor, chunk: int = 256) -> Tensor:
    """Training/prefill forward. x: [B, T, d_model] -> [B, T, d_model]."""
    return apply_seq_with_state(p, x, chunk)[0]


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
    u, z = nn.apply_dense(p["in_proj"], x).chunk(2, dim=-1)
    u, conv_hist = _conv1d_causal(p["conv_w"], p["conv_b"], u, state.conv)
    u = F.silu(u)
    da, dbx, c = _ssm_params(p, u)
    h = da[:, 0] * state.h + dbx[:, 0]
    y = torch.einsum("bds,bs->bd", h, c[:, 0])[:, None]
    y = y + u.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return nn.apply_dense(p["out_proj"], y), SSMState(h=h, conv=conv_hist)
