"""Expert-parallel MoE: on one card the model ranks stacked as a leading
dim, on the planner's mesh each device's own body; a local dispatch each,
and one commutative merge.

The counterpart of the JAX package's ``repro/models/moe_ep.py``
(``apply_ep`` and ``_local_apply``), whose ``shard_map`` gives each of the
mesh's model ranks ``E / ranks`` experts and all of its data shard's
tokens. Both forms here run one body, :func:`rank_body`, over the model
ranks that its caller holds: all ``ranks`` of them on one device as a
leading dim (``apply_ep``, as in ``core/stacked``), or a device's one rank
on the planner's mesh (``apply_ep_mesh``). Each rank dispatches only the
assignments routed to its own experts (the rest go to a dropped row), and
every held rank's token outputs go through one ``cscatter`` call into one
table, so that the ``psum`` over the model axis is the combine's own
merge. On one card the router's ``all_gather`` of the ranks' logit slices
is the whole router's product, and with no data axis the metrics'
``pmean`` is the identity.

Its dispatch decisions are ``moe.apply``'s: the same capacity, and a rank's
positions within an expert are the stable order of that expert's
assignments, as in the global sort. So it equals ``moe.apply`` at any
capacity factor (``tests/test_torch_moe.py``).

:func:`apply_ep_mesh` is JAX's ``shard_map`` form on the planner's
DTensors (``launch/steps.py``): x split over the batch's mesh dims, the
router and the experts' weights over ``"model"``. The router product runs
per device on its logit slice (a ``local_map``), the slices meet by a
DTensor redistribution over ``"model"`` (JAX's ``all_gather``, so the op
walk counts it as a collective), and each device runs :func:`rank_body`
(:func:`route_local`'s logits, the dispatch to its ``E / model`` experts
from ``e_start``, the capacity from its local token count, the combine
through ``cscatter``) in a second ``local_map``. Its output leaves as a
``Partial`` sum over ``"model"`` (JAX's ``psum``) and its metrics as a
``Partial`` mean over every mesh dim (JAX's ``pmean``), for DTensor to
reduce. Gradients: a device's body reads all of x and all of the logits
but contributes only its experts' share, and reads replicated weights
with only its batch shard, so those gradients leave as partial sums
(``partition.partial_grad``). With one model rank the two forms run
the same aten ops, so the card's prefill at ``model_ranks=1`` and the
planner's 1 x 1 trace count the same work.
"""

from __future__ import annotations

import torch

from repro_torch.models import moe as moe_base
from repro_torch.models.mlp import swiglu
from repro_torch.core.mesh_axis import redistribute
from repro_torch.sharding.partition import mean_grad, partial_grad

Tensor = torch.Tensor


def route_local(router_w: Tensor, xt: Tensor) -> Tensor:
    """One device's router product: ``xt [T, D]`` against its slice of the
    router ``[D, E_loc]`` -> logits ``[T, E_loc]`` in IEEE f32."""
    with moe_base.ieee_f32():
        return xt.float() @ router_w.float()


def rank_body(p, xt: Tensor, logits: Tensor, top_k: int,
              capacity_factor: float, e_start: int, n_experts: int,
              model_ranks: int) -> tuple[Tensor, dict]:
    """The local dispatch of the model ranks whose experts ``p`` holds,
    ``E / model_ranks`` each from expert ``e_start`` on: ``xt [T, D]``
    (all of the data shard's tokens, on every rank) and the gathered
    ``logits [T, E]`` -> (their token outputs summed, ``[T, D]``; their
    metrics). A device of the mesh holds one rank, the stacked form all of
    them. Every rank's outputs go through one combine into one table, so
    the merge over the ranks (JAX's ``psum``) is the combine's own. The
    metrics' ``drop_frac`` counts the held ranks' assignments against
    their share of ``T k``, so that its mean over the devices is JAX's
    (one minus the dispatched count summed over the model axis, over ``T
    k``)."""
    t, d = xt.shape
    e_loc = n_experts // model_ranks
    ranks = p["wi_gate"].shape[0] // e_loc
    probs = torch.softmax(logits, dim=-1)
    w, ids = moe_base.top_k(probs, top_k)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)

    # keep only the assignments routed to a rank's experts; dispatch locally
    n = t * top_k
    e_flat = ids.reshape(n)
    w_flat = w.reshape(n)
    token_idx = torch.arange(n, device=xt.device) // top_k
    rank = torch.arange(ranks, device=xt.device)[:, None]
    rel = e_flat[None] - (rank * e_loc + e_start)            # [ranks, N]
    mine = (rel >= 0) & (rel < e_loc)
    rel_safe = torch.where(mine, rel, e_loc)                 # e_loc: dropped

    cap = moe_base.capacity_for(t, top_k, n_experts, capacity_factor)
    pos = moe_base.positions_in_expert(rel_safe, e_loc + 1)
    keep = mine & (pos < cap)
    slot = torch.where(keep, pos, cap).long()

    buf = torch.zeros((ranks, e_loc + 1, cap + 1, d), dtype=xt.dtype,
                      device=xt.device).index_put(
        (rank.expand_as(rel_safe), rel_safe, slot),
        xt[token_idx][None].expand(ranks, n, d))
    out_buf = moe_base.expert_ffn(
        p, buf[:, :e_loc, :cap].reshape(ranks * e_loc, cap, d)).reshape(
        ranks, e_loc, cap, d)
    y = torch.where(keep[..., None],
                    out_buf[rank, rel_safe.clamp(max=e_loc - 1),
                            slot.clamp(max=cap - 1)], 0)
    y = y * (w_flat[None] * keep)[..., None].to(y.dtype)
    out = moe_base.combine(y.reshape(ranks * n, d),
                           token_idx.expand(ranks, n).reshape(ranks * n), t)
    return out, moe_base.metrics_of(ids, probs, keep,
                                    n * ranks / model_ranks, n_experts)


def apply_ep(p, x: Tensor, top_k: int, capacity_factor: float, ranks: int
             ) -> tuple[Tensor, dict]:
    """x [B, S, D] over ``ranks`` stacked model ranks, each holding ``E /
    ranks`` experts -> (out [B, S, D], metrics)."""
    n_experts = p["wi_gate"].shape[0]
    if ranks < 1 or n_experts % ranks:
        raise ValueError(f"apply_ep: {n_experts} experts do not split over "
                         f"{ranks} model ranks")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    out, metrics = rank_body(p, xt, route_local(p["router"]["w"], xt), top_k,
                             capacity_factor, 0, n_experts, ranks)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out, metrics


def apply_ep_mesh(p, x: Tensor, top_k: int, capacity_factor: float, mesh
                  ) -> tuple[Tensor, dict]:
    """JAX's ``apply_ep`` on DTensors: x ``[B, S, D]`` over ``mesh``, whose
    ``"model"`` dim splits the experts -> (out ``[B, S, D]``, ``Partial``
    over ``"model"``; metrics, ``Partial`` means over every mesh dim)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = list(mesh.mesh_dim_names)
    m = names.index("model")
    ranks = mesh.size(m)
    n_experts = p["wi_gate"].shape[0]
    if n_experts % ranks:
        raise ValueError(f"apply_ep_mesh: {n_experts} experts do not split "
                         f"over {ranks} model ranks")
    e_loc = n_experts // ranks
    b, s, d = x.shape
    dp = [i for i, pl in enumerate(x.placements)
          if i != m and isinstance(pl, Shard) and pl.dim == 0]
    R = Replicate()

    def layout(model_pl, batch_split: bool):
        return [model_pl if i == m else Shard(0) if batch_split and i in dp
                else R for i in range(mesh.ndim)]

    batch = layout(R, True)                 # x: batch split, whole on model
    xin = partial_grad(redistribute(x, batch), [m])

    def weights(w, model_pl):
        return partial_grad(redistribute(w, layout(model_pl, False)), dp)

    router = weights(p["router"]["w"], Shard(1))
    logits = local_map(
        lambda xl, wl: route_local(wl, xl.reshape(-1, d)),
        out_placements=layout(Shard(1), True),
        in_placements=(batch, layout(Shard(1), False)),
        device_mesh=mesh)(xin, router)
    # JAX's all_gather of the logit slices over the model axis
    logits = partial_grad(redistribute(logits, batch), [m])
    e_start = mesh.get_coordinate()[m] * e_loc
    experts = [weights(p[k], Shard(0)) for k in ("wi_gate", "wi_up", "wo")]
    keys = ("aux_loss", "router_z", "drop_frac", "expert_load")

    def body(xl, lg, wg, wu, wo):
        out, metrics = rank_body({"wi_gate": wg, "wi_up": wu, "wo": wo},
                                 xl.reshape(-1, d), lg, top_k,
                                 capacity_factor, e_start, n_experts, ranks)
        return (out.reshape(xl.shape),) + tuple(metrics[k] for k in keys)

    mean = [Partial("avg")] * mesh.ndim
    out, *metrics = local_map(
        body, out_placements=(layout(Partial(), True),) + (mean,) * len(keys),
        in_placements=(batch, batch) + (layout(Shard(0), False),) * 3,
        device_mesh=mesh)(xin, logits, *experts)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    # pmean's gradient: each device's share of the mean
    n = mesh.size()
    return out, {k: mean_grad(v, n) for k, v in zip(keys, metrics)}
