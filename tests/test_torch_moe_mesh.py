"""The expert-parallel MoE's mesh form (``models/moe_ep.apply_ep_mesh``):
each device's body against the JAX package's ``moe.apply``, the stacked
form's ops on a 1 x 1 mesh, and the layout and collectives on the
production mesh.

JAX's own ``apply_ep`` on a mesh fails on this container's jax (its mesh
API drifted), so the per-device body, run on plain CPU tensors for each
model rank in turn with that rank's slice of the experts and summed, is
held to ``moe.apply`` in f32 to 1e-5: the output, and each metric as the
mean of the ranks' (JAX's ``pmean``). The planner's meshes are fake
(``launch/mesh.py``): nothing is allocated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.models import moe as jmoe
from repro_torch.launch import op_cost
from repro_torch.models import moe_ep
from repro_torch.models.mlp import swiglu

from test_torch_moe import CAPACITY_FACTORS, _layer, _x

E, TOP_K = 8, 2


def _bodies(tp, x: torch.Tensor, cf: float, ranks: int):
    """Every rank's body on plain tensors, summed: (out, the ranks' mean
    metrics)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = moe_ep.route_local(tp["router"]["w"], xt)
    e_loc = E // ranks
    out, metrics = 0, []
    for r in range(ranks):
        sl = slice(r * e_loc, (r + 1) * e_loc)
        part, m = moe_ep.rank_body({k: tp[k][sl] for k in
                                    ("wi_gate", "wi_up", "wo")}, xt, logits,
                                   TOP_K, cf, r * e_loc, E, ranks)
        out = out + part
        metrics.append(m)
    if "shared" in tp:
        out = out + swiglu(tp["shared"], xt)
    mean = {k: torch.stack([m[k] for m in metrics]).mean(0)
            for k in metrics[0]}
    return out.reshape(b, s, d), mean


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("shared", [0, 1])
def test_rank_bodies_summed_equal_jax_apply(ranks, cf, shared):
    _, jp, tp = _layer(e=E, shared=shared)
    x = _x((2, 24, 32), seed=7)
    want, wm = jmoe.apply(jp, jnp.asarray(x), TOP_K, cf)
    got, gm = _bodies(tp, torch.from_numpy(x), cf, ranks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("aux_loss", "router_z", "drop_frac", "expert_load"):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(wm[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_rank_bodies_summed_equal_the_stacked_form(ranks, cf):
    _, _, tp = _layer(e=E, shared=1)
    x = torch.from_numpy(_x((2, 24, 32), seed=8))
    got, gm = _bodies(tp, x, cf, ranks)
    want, wm = moe_ep.apply_ep(tp, x, TOP_K, cf, ranks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in wm:
        torch.testing.assert_close(gm[k], wm[k], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.launch import mesh
    yield {"1x1": mesh.make_host_mesh(1, 1),
           "pod": mesh.make_production_mesh()}
    mesh.shutdown()


def _dtensors(tree, mesh, placements):
    """Meta DTensors of ``tree``'s shapes and dtypes, each laid out by
    ``placements(path)``."""
    from torch.distributed.tensor import DTensor, Shard

    def make(path, t):
        pl = placements(path, t)
        local = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype,
                                              device="meta"), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return pytree.tree_map_with_path(make, tree)


def test_mesh_form_on_1x1_runs_the_stacked_forms_ops(meshes):
    """One model rank: the mesh form's trace and the stacked form at
    ``ranks=1`` on meta tensors count the same FLOPs, HBM bytes, ops and
    kernel calls, so the card's prefill and its 1 x 1 trace agree."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.partition import sharding_rules
    m = meshes["1x1"]
    _, _, tp = _layer(e=E, shared=1)
    x = torch.from_numpy(_x((2, 24, 32), seed=9))
    meta = pytree.tree_map(lambda t: t.to("meta"), (tp, x))
    plain = op_cost.OpWalk(device="meta")
    with plain:
        moe_ep.apply_ep(*meta, TOP_K, 1.25, 1)
    dtp, dx = _dtensors(meta, m, lambda path, t: [Replicate(), Replicate()])
    mesh_walk = op_cost.OpWalk(m, device="meta")
    with implicit_replication(), sharding_rules(m), mesh_walk:
        moe_ep.apply_ep_mesh(dtp, dx, TOP_K, 1.25, m)
    a, b = plain.result(), mesh_walk.result()
    for key in ("flops", "hbm_bytes", "kernels"):
        assert a[key] == b[key], key
    assert a["kernels"]["cscatter"]["calls"] == 1
    assert {k: v["calls"] for k, v in a["by_op"].items()} == \
        {k: v["calls"] for k, v in b["by_op"].items()}


def test_mesh_form_on_the_production_mesh(meshes):
    """16 x 16: each device dispatches to its 128 / 16 experts with its
    batch shard's tokens; the logits meet by an all-gather over the model
    axis, the output leaves as a partial sum over it and the metrics as
    means over every mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.partition import sharding_rules
    m = meshes["pod"]
    d, f, e = 64, 32, 128
    g = torch.Generator().manual_seed(0)
    tp = {"router": {"w": torch.randn(d, e, generator=g)},
          "wi_gate": torch.randn(e, d, f, generator=g),
          "wi_up": torch.randn(e, d, f, generator=g),
          "wo": torch.randn(e, f, d, generator=g)}
    meta = pytree.tree_map(lambda t: t.to("meta"),
                           (tp, torch.zeros(32, 64, d)))

    def placements(path, t):
        if t.dim() == 3 and t.shape[0] == 32:          # x: batch on data
            return [Shard(0), Replicate()]
        if t.dim() == 2:                              # router: experts
            return [Shard(0), Shard(1)]
        return [Shard(1), Shard(0)]                   # experts, FSDP embed
    dtp, dx = _dtensors(meta, m, placements)
    walk = op_cost.OpWalk(m, (8, 32), ("nvlink", "ib"), device="meta")
    with implicit_replication(), sharding_rules(m), walk:
        out, metrics = moe_ep.apply_ep_mesh(dtp, dx, 8, 1.25, m)
    assert tuple(out.placements) == (Shard(0), Partial())
    assert out.to_local().shape == (2, 64, d)
    assert all(tuple(v.placements) == (Partial("avg"), Partial("avg"))
               for v in metrics.values())
    res = walk.result()
    assert res["kernels"]["cscatter"]["calls"] == 1
    # the combine's table: the device's 2 x 64 tokens, every column
    assert res["kernels"]["cscatter"]["flops"] == 2 * 64 * 8 * d
    assert res["per_collective"]["all-gather"]["count"] >= 1
    # the expert products: 8 local experts' three matrices
    bmm = res["by_op"]["bmm"]
    cap = (2 * 64 * 8 * 5 // 4) // e + 1
    cap = max(8, -(-cap // 8) * 8)
    assert bmm["flops"] == 3 * 2 * (e // 16) * cap * d * f
