"""Public entry points of the port's kernels, named as in the JAX package's
``repro/kernels/ops.py``.

Each runs the hand-written CUDA kernel on a CUDA tensor and the kernel's
plain PyTorch version on a CPU tensor; ``flash_attention``,
``decode_attention`` and ``commutative_scatter`` take their custom op on a
planner's tensor (a DTensor, a fake tensor), which has no data to launch a
kernel on (``kernels/custom_ops.kernel_call``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import selective_scan as _scan
from repro_torch.kernels.cmerge import cmerge
from repro_torch.kernels.cscatter import cscatter


def commutative_scatter(table: torch.Tensor, ids: torch.Tensor,
                        vals: torch.Tensor, *, kind: str = "add",
                        sat_min: float = 0.0,
                        sat_max: float = 0.0) -> torch.Tensor:
    """CCache scatter: ``table[ids] ⊕= vals`` through a privatized copy,
    in place (see :func:`repro_torch.kernels.cscatter.cscatter`)."""
    return cscatter(table, ids, vals, kind=kind, sat_min=sat_min,
                    sat_max=sat_max)


def merge_buffer(table: torch.Tensor, block_ids: torch.Tensor,
                 dirty: torch.Tensor, src: torch.Tensor, upd: torch.Tensor, *,
                 kind: str = "add", sat_min: float = 0.0,
                 sat_max: float = 0.0) -> torch.Tensor:
    """The explicit merge instruction over a W-way source buffer, in place
    (see :func:`repro_torch.kernels.cmerge.cmerge`)."""
    return cmerge(table, block_ids, dirty, src, upd, kind=kind,
                  sat_min=sat_min, sat_max=sat_max)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,S,d]; k,v [B,KV,T,d] -> [B,H,S,d], sliding when ``window``
    > 0 (see :func:`repro_torch.kernels.flash_attention.flash_attention`)."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     position: int) -> torch.Tensor:
    """q [B,H,d]; k,v [B,T,KV,d]; attends to slots [0, position] -> [B,H,d]
    (see :func:`repro_torch.kernels.decode_attention.decode_attention`)."""
    return _decode.decode_attention(q, k, v, position)


def selective_scan(dt: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective SSM recurrence ``h_t = exp(dt_t a) h_{t-1} + (dt_t
    u_t) b_t``, ``y_t = sum_s h_t c_t`` -> (y [B,T,D] f32, h_T [B,D,S]),
    differentiable (see
    :func:`repro_torch.kernels.selective_scan.selective_scan`)."""
    return _scan.selective_scan(dt, u, b, c, a, h0)


def embedding_grad_scatter(table_grad: torch.Tensor, token_ids: torch.Tensor,
                           out_grads: torch.Tensor) -> torch.Tensor:
    """Embedding-table gradient accumulation as a CCache scatter, in place:
    ``dL/dE[v] += Σ_{n: id_n=v} g_n`` for token_ids ``[N]`` (flattened
    batch*seq) and out_grads ``[N, D]``."""
    return commutative_scatter(table_grad, token_ids, out_grads, kind="add")
