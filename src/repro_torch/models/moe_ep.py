"""Expert-parallel MoE on one card: the model ranks stacked as a leading
dim, a local dispatch each, and one commutative merge.

The counterpart of the JAX package's ``repro/models/moe_ep.py``
(``apply_ep`` and ``_local_apply``), whose ``shard_map`` gives each of the
mesh's model ranks ``E / ranks`` experts and all of its data shard's
tokens. Here the ``ranks`` model ranks live on one device as dim 0, as in
``core/stacked``: the router's ``all_gather`` of each rank's logit slice is
a concatenation over that dim, each rank dispatches only the assignments
routed to its own experts (the rest go to a dropped row), the ranks'
partial token outputs come from one ``cscatter`` call over the ``[ranks,
t, D]`` stack (a table a rank), and the ``psum`` over the model axis is a
sum over dim 0. One card has no data axis, so the metrics' ``pmean`` is
the identity.

Its dispatch decisions are ``moe.apply``'s: the same capacity, and a rank's
positions within an expert are the stable order of that expert's
assignments, as in the global sort. So it equals ``moe.apply`` at any
capacity factor (``tests/test_torch_moe.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import moe as moe_base
from repro_torch.models.mlp import swiglu

Tensor = torch.Tensor


def _local_apply(p, x: Tensor, top_k: int, capacity_factor: float,
                 ranks: int) -> tuple[Tensor, dict]:
    """Every rank's local dispatch at once: x [B, S, D] (all tokens, on
    every rank); the expert weights' dim 0 splits into ``ranks`` slices of
    ``E / ranks``."""
    b, s, d = x.shape
    n_experts = p["wi_gate"].shape[0]
    e_loc = n_experts // ranks
    xt = x.reshape(b * s, d)
    t = b * s

    # each rank's logit slice [ranks, T, E_loc], gathered along the experts
    router = p["router"]["w"].reshape(d, ranks, e_loc).permute(1, 0, 2)
    with moe_base.ieee_f32():
        logits_loc = torch.matmul(xt.float(), router.float())
    logits = logits_loc.permute(1, 0, 2).reshape(t, n_experts)
    probs = torch.softmax(logits, dim=-1)
    w, ids = moe_base.top_k(probs, top_k)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)

    # keep only the assignments routed to a rank's experts; dispatch locally
    n = t * top_k
    e_flat = ids.reshape(n)
    w_flat = w.reshape(n)
    token_idx = torch.arange(n, device=x.device) // top_k
    rank = torch.arange(ranks, device=x.device)[:, None]
    rel = e_flat[None] - rank * e_loc                         # [ranks, N]
    mine = (rel >= 0) & (rel < e_loc)
    rel_safe = torch.where(mine, rel, e_loc)                 # e_loc: dropped

    cap = moe_base.capacity_for(t, top_k, n_experts, capacity_factor)
    pos = moe_base.positions_in_expert(rel_safe, e_loc + 1)
    keep = mine & (pos < cap)
    slot = torch.where(keep, pos, cap).long()

    buf = torch.zeros((ranks, e_loc + 1, cap + 1, d), dtype=x.dtype,
                      device=x.device).index_put(
        (rank.expand_as(rel_safe), rel_safe, slot),
        xt[token_idx].expand(ranks, n, d))
    out_buf = moe_base.expert_ffn(
        p, buf[:, :e_loc, :cap].reshape(n_experts, cap, d)).reshape(
        ranks, e_loc, cap, d)

    y = torch.where(keep[..., None],
                    out_buf[rank, rel_safe.clamp(max=e_loc - 1),
                            slot.clamp(max=cap - 1)], 0)
    y = y * (w_flat[None] * keep)[..., None].to(y.dtype)
    partial = moe_base.combine(y, token_idx.expand(ranks, n), t)

    # the commutative merge: every rank contributed its experts' updates
    out = partial.sum(0)

    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(b, s, d), moe_base.metrics_of(ids, probs, keep, n,
                                                     n_experts)


def apply_ep(p, x: Tensor, top_k: int, capacity_factor: float, ranks: int
             ) -> tuple[Tensor, dict]:
    """x [B, S, D] over ``ranks`` stacked model ranks, each holding ``E /
    ranks`` experts -> (out [B, S, D], metrics)."""
    n_experts = p["wi_gate"].shape[0]
    if ranks < 1 or n_experts % ranks:
        raise ValueError(f"apply_ep: {n_experts} experts do not split over "
                         f"{ranks} model ranks")
    return _local_apply(p, x, top_k, capacity_factor, ranks)
