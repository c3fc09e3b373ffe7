"""Mixture-of-Experts FFN of the port: top-k routing, the capacity dispatch,
grouped expert products and the token combine through the CUDA
``cscatter``.

The counterpart of the JAX package's ``repro/models/moe.py``. Tokens are
routed to their top-k experts by an f32 router, placed into an ``[E, C,
D]`` buffer at their stable position within the expert (an assignment past
the capacity ``C`` is dropped: the residual carries its token, GShard's
discipline), run through the experts' SwiGLU as batched products, and
gathered back. The combine — each token's sum of its k weighted expert
outputs, ``zeros[t, d].at[token_idx].add(y)`` in JAX — is CData in the
paper's sense, an order-free additive merge, so it goes through
``kernels.ops.commutative_scatter``: the CUDA ``cscatter`` on a CUDA
tensor (which launches the kernel or raises), its plain version on a CPU
tensor. Its backward is the gather ``grad_out[token_idx]`` (:class:`_Combine`).

Where the port decides (each pinned by ``tests/test_torch_moe.py``):

* **Ties.** ``jax.lax.top_k`` breaks ties toward the lower expert index;
  ``torch.topk`` promises no order among ties on the card, so the top k
  come from a stable descending sort (:func:`top_k`).
* **Router precision.** ``route`` takes ``x @ router_w`` in IEEE f32,
  whatever ``torch.set_float32_matmul_precision`` says (no TF32 on the
  card, no bf16 passes on the CPU).
* **On DTensors** (the planner's, for a config that does not take the
  expert-parallel form) the layer runs whole on every device
  (:func:`_replicated`): x and the weights gathered, the global dispatch
  computed alike everywhere, as a ``local_map`` whose results are
  replicated. GSPMD partitions the global sort instead; either way it is
  the slow path the expert-parallel form replaces.
* **The combine accumulates in f32 and rounds once** (``cscatter`` folds
  a bf16 table in f32), where JAX's bf16 ``.at[].add`` rounds at every
  add. In f32 the two agree to 1e-5.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import module as nn
from repro_torch.models.mlp import swiglu, swiglu_init
from repro_torch.sharding.partition import is_dtensor

Tensor = torch.Tensor


def init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
         dtype, n_shared: int = 0, device=None) -> dict:
    """The router ``w [D, E]`` in f32 whatever ``dtype`` is, the experts'
    ``wi_gate``, ``wi_up`` ``[E, D, F]`` and ``wo`` ``[E, F, D]`` (fan-in
    over the first two dims, as JAX's ``in_dims=2``), and a shared SwiGLU
    of width ``d_ff * n_shared`` when ``n_shared``."""
    p = {
        "router": {"w": nn.dense_init(gen, (d_model, n_experts),
                                      torch.float32, device=device)},
        "wi_gate": nn.dense_init(gen, (n_experts, d_model, d_ff), dtype,
                                 in_dims=2, device=device),
        "wi_up": nn.dense_init(gen, (n_experts, d_model, d_ff), dtype,
                               in_dims=2, device=device),
        "wo": nn.dense_init(gen, (n_experts, d_ff, d_model), dtype,
                            in_dims=2, device=device),
    }
    if n_shared:
        p["shared"] = swiglu_init(gen, d_model, d_ff * n_shared, dtype,
                                  device=device)
    return p


@contextlib.contextmanager
def ieee_f32():
    """f32 products in full IEEE f32 inside the block (no TF32, no bf16
    passes), the caller's setting restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(router_w: Tensor, x: Tensor) -> Tensor:
    """``x.astype(f32) @ router_w`` in IEEE f32."""
    with ieee_f32():
        return x.float() @ router_w.float()


def route(router_w: Tensor, x: Tensor, k: int
          ) -> tuple[Tensor, Tensor, Tensor]:
    """x: [T, D] -> (weights [T, k] renormalised, ids [T, k] int64, probs
    [T, E]), all f32."""
    probs = torch.softmax(router_logits(router_w, x), dim=-1)
    w, ids = top_k(probs, k)
    return w / (w.sum(-1, keepdim=True) + 1e-9), ids, probs


def positions_in_expert(e_flat: Tensor, n_experts: int) -> Tensor:
    """The slot of each assignment within its expert, in the stable order
    of the assignments: int32 of ``e_flat``'s shape (``[N]``, or ``[S, N]``
    for S independent rows)."""
    n = e_flat.shape[-1]
    e_sorted, order = torch.sort(e_flat.long(), dim=-1, stable=True)
    experts = torch.arange(n_experts, device=e_flat.device).expand(
        e_flat.shape[:-1] + (n_experts,)).contiguous()
    seg_start = torch.searchsorted(e_sorted.contiguous(), experts)
    pos_sorted = torch.arange(n, device=e_flat.device) - torch.gather(
        seg_start, -1, e_sorted)
    return torch.zeros(e_flat.shape, dtype=torch.int32,
                       device=e_flat.device).scatter_(
        -1, order, pos_sorted.to(torch.int32))


def capacity_for(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


class _Combine(torch.autograd.Function):
    """``zeros[..., t, d]`` with ``y [..., n, d]`` added at rows ``ids [...,
    n]`` through ``cscatter`` (a leading dim: that many independent
    tables); the backward gathers ``grad_out`` at ``ids``."""

    @staticmethod
    def forward(ctx, y: Tensor, ids: Tensor, t: int) -> Tensor:
        ctx.save_for_backward(ids)
        out = torch.zeros(y.shape[:-2] + (t, y.shape[-1]), dtype=y.dtype,
                          device=y.device)
        return ops.commutative_scatter(out, ids, y.contiguous())

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        (ids,) = ctx.saved_tensors
        idx = ids.long().unsqueeze(-1).expand(
            ids.shape + (grad_out.shape[-1],))
        return torch.gather(grad_out, -2, idx), None, None


def combine(y: Tensor, token_idx: Tensor, t: int) -> Tensor:
    """The commutative token combine: ``[t, d]`` (or ``[S, t, d]``) zeros
    plus each row of ``y`` at its token; differentiable in ``y``."""
    return _Combine.apply(y, token_idx.to(torch.int32).contiguous(), t)


def expert_ffn(p, buf: Tensor) -> Tensor:
    """The grouped SwiGLU: ``buf [E, C, D]`` through each expert's own
    weights -> ``[E, C, D]``."""
    g = F.silu(torch.bmm(buf, p["wi_gate"]))
    u = torch.bmm(buf, p["wi_up"])
    return torch.bmm(g * u, p["wo"])


def metrics_of(ids: Tensor, probs: Tensor, keep: Tensor, n: int,
               n_experts: int) -> dict[str, Tensor]:
    """The router's commutative counters: the load-balancing aux loss, the
    z term, the dropped share and each expert's first-choice load."""
    # one_hot by comparison: F.one_hot takes other ops on a meta tensor
    # than on data (a range check), which the planner's count would miss
    e_one = (ids[:, :1] == torch.arange(n_experts, device=ids.device)
             ).float()
    dispatched = keep.float().sum()
    return {
        "aux_loss": n_experts * (e_one.mean(0) * probs.mean(0)).sum(),
        "router_z": (torch.logsumexp(torch.log(probs + 1e-9), -1) ** 2
                     ).mean(),
        "drop_frac": 1.0 - dispatched / n,
        "expert_load": e_one.sum(0),
    }


def apply(p, x: Tensor, top_k: int, capacity_factor: float = 1.25,
          token_chunk: int = 131072) -> tuple[Tensor, dict[str, Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], metrics). Dropped assignments
    contribute 0. Token streams longer than ``token_chunk`` that it divides
    run in chunks of that many tokens, one after another, and their
    metrics are the chunks' mean."""
    if is_dtensor(x):
        return _replicated(p, x, top_k, capacity_factor, token_chunk)
    b, s, d = x.shape
    t = b * s
    if t > token_chunk and t % token_chunk == 0:
        parts = [_apply_tokens(p, xi, top_k, capacity_factor)
                 for xi in x.reshape(t // token_chunk, 1, token_chunk, d)]
        out = torch.cat([o for o, _ in parts]).reshape(b, s, d)
        ms = [m for _, m in parts]
        return out, {k: torch.stack([m[k] for m in ms]).mean(0)
                     for k in ms[0]}
    return _apply_tokens(p, x, top_k, capacity_factor)


def _replicated(p, x, top_k: int, capacity_factor: float, token_chunk: int):
    """:func:`apply` of DTensors, whole on every device (a ``local_map``
    whose inputs are gathered and whose results are replicated)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree
    from repro_torch.sharding.partition import local_inputs
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    leaves, spec = pytree.tree_flatten(p)
    keys = ("aux_loss", "router_z", "drop_frac", "expert_load")

    def local(xl, *ws):
        out, metrics = apply(pytree.tree_unflatten(list(ws), spec), xl,
                             top_k, capacity_factor, token_chunk)
        return (out,) + tuple(metrics[k] for k in keys)

    args = local_inputs((x, *leaves), (rep,) * (1 + len(leaves)))
    out, *metrics = local_map(
        local, out_placements=(rep,) * (1 + len(keys)),
        in_placements=(rep,) * (1 + len(leaves)), device_mesh=mesh)(*args)
    return out, dict(zip(keys, metrics))


def _apply_tokens(p, x: Tensor, top_k: int, capacity_factor: float
                  ) -> tuple[Tensor, dict]:
    b, s, d = x.shape
    n_experts = p["wi_gate"].shape[0]
    xt = x.reshape(b * s, d)
    t = b * s

    w, ids, probs = route(p["router"]["w"], xt, top_k)

    n = t * top_k
    e_flat = ids.reshape(n)
    w_flat = w.reshape(n)
    token_idx = torch.arange(n, device=x.device) // top_k

    cap = capacity_for(t, top_k, n_experts, capacity_factor)
    pos = positions_in_expert(e_flat, n_experts)
    keep = pos < cap
    slot = torch.where(keep, pos, cap).long()   # cap: the dropped column

    buf = torch.zeros((n_experts, cap + 1, d), dtype=x.dtype,
                      device=x.device).index_put((e_flat, slot),
                                                 xt[token_idx])
    out_buf = expert_ffn(p, buf[:, :cap])

    y = torch.where(keep[:, None], out_buf[e_flat, slot.clamp(max=cap - 1)],
                    0)
    y = y * (w_flat * keep)[:, None].to(y.dtype)
    out = combine(y, token_idx, t)

    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(b, s, d), metrics_of(ids, probs, keep, n, n_experts)
