"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM
(scalar memory, sequential).

The port of the JAX package's ``repro/models/xlstm.py``. mLSTM is a
linear-attention-like recurrence with exponential input gates and
stabilized log-space accumulation:

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t              (normalizer)
    h_t = o_t * (C_t q_t) / max(|n_t q_t|, 1)

Training and prefill run the chunkwise form (quadratic within a chunk of
256, the state ``(C, n, m)`` carried across chunks by a loop), so the
``[T, d, d]`` state sequence never exists; decode is the O(1) recurrent
step. sLSTM mixes its memory through recurrent weights and runs as a loop
over time. The recurrences and gates are f32 whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import module as nn
from repro_torch.models.mlp import gelu
from repro_torch.models.ssm import _conv1d_causal

Tensor = torch.Tensor
NEG = -1e30        # the log-scale stabilizer of an empty state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MLSTMState:
    """Decode-time state for one mLSTM layer."""

    c: Tensor      # [B, H, d, d]   matrix memory (stored at scale exp(m))
    n: Tensor      # [B, H, d]      normalizer (same scale)
    m: Tensor      # [B, H]         log-scale stabilizer
    conv: Tensor   # [B, k-1, d_inner] trailing causal-conv inputs, f32


def init(gen: torch.Generator, d_model: int, n_heads: int, dtype,
         proj_factor: float = 2.0, conv_k: int = 4, device=None) -> dict:
    d_inner = int(d_model * proj_factor)

    def dense(d_in, d_out, bias=False):
        return nn.dense(gen, d_in, d_out, dtype, bias=bias, device=device)

    return {
        "in_proj": dense(d_model, 2 * d_inner),
        "conv_w": nn.dense_init(gen, (conv_k, d_inner), dtype, device=device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        # gates: input/forget from x (per head), output per channel
        "w_if": dense(d_inner, 2 * n_heads, bias=True),
        "w_o": dense(d_inner, d_inner),
        "ln_h": nn.rmsnorm_init(d_inner, dtype, device),
        "out_proj": dense(d_inner, d_model),
    }


def _heads(x: Tensor, h: int) -> Tensor:
    """[..., T, H*d] -> [..., H, T, d]"""
    y = x.reshape(x.shape[:-1] + (h, x.shape[-1] // h))
    return y.movedim(-2, -3)


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk of the stabilized chunkwise mLSTM.

    q, k, v: [B,H,c,d]; li, lf: [B,H,c] log input/forget gates; state:
    (C [B,H,d,d], n [B,H,d], m [B,H]) at scale exp(m). Returns (h
    [B,H,c,d], new state)."""
    c_in, n_in, m_in = state
    eps = 1e-6
    cum = torch.cumsum(lf, dim=-1)                    # L_t (inclusive)
    # D[t,s] = L_t - L_s + li_s for s <= t (contribution of step s at t)
    d_mat = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    c = d_mat.shape[-1]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    d_mat = torch.where(tri, d_mat, float("-inf"))
    m_intra = d_mat.amax(dim=-1)                      # [B,H,c]
    m_carry = cum + m_in[..., None]                   # carry-in at scale m_in
    m_t = torch.maximum(m_intra, m_carry)
    m_t = m_t.clamp_min(NEG)                          # guard all -inf rows

    w = torch.exp(d_mat - m_t[..., None])             # [B,H,c,c]
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * w
    intra = torch.einsum("bhts,bhsd->bhtd", scores, v)
    carry_scale = torch.exp(m_carry - m_t)            # [B,H,c]
    # c_in is [v-dim, k-dim]: contract q with the k-dim (as decode does)
    inter = torch.einsum("bhtd,bhed->bhte", q, c_in) * carry_scale[..., None]
    num = intra + inter

    n_intra = torch.einsum("bhts,bhsd->bhtd", w, k)
    n_t = n_intra + n_in[..., None, :] * carry_scale[..., None]
    qn = torch.einsum("bhtd,bhtd->bht", q, n_t).abs()
    denom = torch.maximum(qn, torch.exp(-m_t)) + eps
    h = num / denom[..., None]

    # the chunk-end carry at scale m_out
    l_end = cum[..., -1:]                             # [B,H,1]
    d_end = l_end - cum + li                          # decay of step s to end
    m_end_intra = d_end.amax(dim=-1)
    m_end_carry = l_end[..., 0] + m_in
    m_out = torch.maximum(m_end_intra, m_end_carry)
    w_end = torch.exp(d_end - m_out[..., None])       # [B,H,c]
    keep = torch.exp(m_end_carry - m_out)
    c_out = (torch.einsum("bhs,bhsd,bhse->bhde", w_end, v, k)
             + c_in * keep[..., None, None])
    n_out = torch.einsum("bhs,bhsd->bhd", w_end, k) + n_in * keep[..., None]
    return h, (c_out, n_out, m_out)


def _gates_qkv(p, u: Tensor, n_heads: int):
    """u: [B,T,d_inner] -> q, k, v [B,H,T,d], li, lf [B,H,T], in f32."""
    d_head = u.shape[-1] // n_heads
    q = _heads(nn.apply_dense(p["wq"], u), n_heads)
    k = _heads(nn.apply_dense(p["wk"], u), n_heads) / (d_head ** 0.5)
    v = _heads(nn.apply_dense(p["wv"], u), n_heads)
    gif = nn.apply_dense(p["w_if"], u).float()        # [B,T,2H]
    li = gif[..., :n_heads].movedim(-1, -2)           # exp input gate
    lf = F.logsigmoid(gif[..., n_heads:].movedim(-1, -2))
    return q.float(), k.float(), v.float(), li, lf


def _empty_carry(b: int, n_heads: int, d_head: int, device):
    return (torch.zeros((b, n_heads, d_head, d_head), dtype=torch.float32,
                        device=device),
            torch.zeros((b, n_heads, d_head), dtype=torch.float32,
                        device=device),
            torch.full((b, n_heads), NEG, dtype=torch.float32, device=device))


def apply_seq_with_state(p, x: Tensor, n_heads: int, chunk: int = 256
                         ) -> tuple[Tensor, MLSTMState]:
    """mLSTM layer over a full sequence ``x [B,T,D] -> [B,T,D]``, and the
    decode state after it, from the one pass: the carry ``(C, n, m)`` the
    chunk loop ends with and the last k-1 pre-conv inputs in f32."""
    b, t, _ = x.shape
    u, z = nn.apply_dense(p["in_proj"], x).chunk(2, dim=-1)
    u_conv, hist = _conv1d_causal(p["conv_w"], p["conv_b"], u)
    u_conv = F.silu(u_conv)

    q, k, v, li, lf = _gates_qkv(p, u_conv, n_heads)
    d_inner = u.shape[-1]
    d_head = d_inner // n_heads
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    state = _empty_carry(b, n_heads, d_head, x.device)
    hs = []
    for i in range(t // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                li[:, :, sl], lf[:, :, sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=2)                          # [B,H,T,d]
    h = h.movedim(1, 2).reshape(b, t, d_inner).to(x.dtype)

    h = nn.rmsnorm(p["ln_h"], h)
    # learnable skip (xLSTM block): gated by the z branch
    h = (h + nn.apply_dense(p["w_o"], u_conv)) * F.silu(z)
    c, n, m = state
    return (nn.apply_dense(p["out_proj"], h),
            MLSTMState(c=c, n=n, m=m, conv=hist.float()))


def apply_seq(p, x: Tensor, n_heads: int, chunk: int = 256) -> Tensor:
    """mLSTM layer over a full sequence. x: [B,T,D] -> [B,T,D]."""
    return apply_seq_with_state(p, x, n_heads, chunk)[0]


def init_state(p, batch: int, n_heads: int) -> MLSTMState:
    d_inner = p["out_proj"]["w"].shape[0]
    conv_k = p["conv_w"].shape[0]
    dev = p["conv_w"].device
    c, n, m = _empty_carry(batch, n_heads, d_inner // n_heads, dev)
    return MLSTMState(c=c, n=n, m=m, conv=torch.zeros(
        (batch, conv_k - 1, d_inner), dtype=torch.float32, device=dev))


def decode_step(p, x: Tensor, state: MLSTMState, n_heads: int
                ) -> tuple[Tensor, MLSTMState]:
    """One-token mLSTM step. x: [B,1,D]."""
    u, z = nn.apply_dense(p["in_proj"], x).chunk(2, dim=-1)
    u_conv, conv_hist = _conv1d_causal(p["conv_w"], p["conv_b"], u,
                                       state.conv.to(u.dtype))
    u_conv = F.silu(u_conv)
    q, k, v, li, lf = _gates_qkv(p, u_conv, n_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]      # [B,H,d]
    li, lf = li[:, :, 0], lf[:, :, 0]                 # [B,H]

    m_new = torch.maximum(lf + state.m, li)
    decay = torch.exp(lf + state.m - m_new)
    inject = torch.exp(li - m_new)
    c = (state.c * decay[..., None, None]
         + torch.einsum("bhd,bhe->bhde", v, k) * inject[..., None, None])
    n = state.n * decay[..., None] + k * inject[..., None]
    num = torch.einsum("bhd,bhed->bhe", q, c)         # C q
    qn = torch.einsum("bhd,bhd->bh", q, n).abs()
    h = num / (torch.maximum(qn, torch.exp(-m_new)) + 1e-6)[..., None]

    b = x.shape[0]
    d_inner = u.shape[-1]
    h = h.reshape(b, 1, d_inner).to(x.dtype)
    h = nn.rmsnorm(p["ln_h"], h)
    h = (h + nn.apply_dense(p["w_o"], u_conv)) * F.silu(z)
    out = nn.apply_dense(p["out_proj"], h)
    return out, MLSTMState(c=c, n=n, m=m_new, conv=conv_hist.float())


# ---------------------------------------------------------------------------
# sLSTM: scalar memory + memory mixing (block-diagonal recurrence). Sequential.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SLSTMState:
    c: Tensor  # [B, d]
    n: Tensor  # [B, d]
    h: Tensor  # [B, d]
    m: Tensor  # [B, d]


def slstm_init(gen: torch.Generator, d_model: int, n_heads: int, dtype,
               ffn_factor: float = 4.0 / 3.0, device=None) -> dict:
    d_head = d_model // n_heads
    d_ff = int(d_model * ffn_factor)
    return {
        # 4 gates (z, i, f, o) from the input; recurrent mixing is
        # block-diagonal over the heads
        "w_x": nn.dense(gen, d_model, 4 * d_model, dtype, bias=True,
                        device=device),
        "r": nn.dense_init(gen, (n_heads, d_head, 4 * d_head), dtype,
                           in_dims=2, device=device),
        "ln_h": nn.rmsnorm_init(d_model, dtype, device),
        "up": nn.dense(gen, d_model, d_ff, dtype, device=device),
        "down": nn.dense(gen, d_ff, d_model, dtype, device=device),
    }


def _slstm_cell(p, x_gates: Tensor, state: SLSTMState, n_heads: int
                ) -> SLSTMState:
    """x_gates: [B, 4*d] precomputed input contributions."""
    b, d4 = x_gates.shape
    d = d4 // 4
    d_head = d // n_heads
    hh = state.h.reshape(b, n_heads, d_head)
    # JAX promotes the f32 state against bf16 weights to f32
    rec = torch.einsum("bhd,hde->bhe", hh, p["r"].float())
    # per-head interleave: the recurrent output [B,H,4*dh] regrouped to gates
    rec = rec.reshape(b, n_heads, 4, d_head)
    xg = x_gates.reshape(b, 4, n_heads, d_head)
    pre = (xg + rec.movedim(2, 1)).float()
    zt = torch.tanh(pre[:, 0]).reshape(b, d)
    it = pre[:, 1].reshape(b, d)                      # log-space input gate
    ft = F.logsigmoid(pre[:, 2]).reshape(b, d)        # log forget
    ot = torch.sigmoid(pre[:, 3]).reshape(b, d)
    m_new = torch.maximum(ft + state.m, it)
    decay = torch.exp(ft + state.m - m_new)
    inject = torch.exp(it - m_new)
    c = decay * state.c + inject * zt
    n = decay * state.n + inject
    h = ot * (c / n.clamp_min(1e-6))
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_init_state(batch: int, d: int, device=None) -> SLSTMState:
    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, d), NEG, dtype=torch.float32,
                                   device=device))


def _slstm_out(p, h: Tensor) -> Tensor:
    h = nn.rmsnorm(p["ln_h"], h)
    return nn.apply_dense(p["down"], gelu(nn.apply_dense(p["up"], h)))


def slstm_apply_seq_with_state(p, x: Tensor, n_heads: int
                               ) -> tuple[Tensor, SLSTMState]:
    """Sequential sLSTM over T, ``x [B,T,D] -> [B,T,D]``, and the state
    after the sequence, from the one pass."""
    b, t, d = x.shape
    x_gates = nn.apply_dense(p["w_x"], x)             # [B,T,4D]
    state = slstm_init_state(b, d, x.device)
    hs = []
    for i in range(t):
        state = _slstm_cell(p, x_gates[:, i], state, n_heads)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).to(x.dtype)            # [B,T,D]
    return _slstm_out(p, h), state


def slstm_apply_seq(p, x: Tensor, n_heads: int) -> Tensor:
    """Sequential sLSTM over T. x: [B,T,D]."""
    return slstm_apply_seq_with_state(p, x, n_heads)[0]


def slstm_decode_step(p, x: Tensor, state: SLSTMState, n_heads: int
                      ) -> tuple[Tensor, SLSTMState]:
    """x: [B,1,D]."""
    xg = nn.apply_dense(p["w_x"], x[:, 0])
    state = _slstm_cell(p, xg, state, n_heads)
    return _slstm_out(p, state.h[:, None].to(x.dtype)), state
