"""``plan_train``'s explicit gradient merge (``merge_plan=``,
``merge_compress=``, ``defer_schedule=``) on the fake process group.

The JAX package's own tests of these plans fail on this container's jax
(``AbstractMesh`` and ``shard_map(auto=)`` drift:
``test_merge_plan.py::test_three_level_plan_through_both_train_paths``,
``test_defer_schedule.py::test_plan_train_threads_defer_state``,
``test_overlap_commit.py::test_plan_train_threads_inflight_shardings``),
so the plan is held here to JAX's refusals and messages, to the ports of
the last two tests, and to the cost model the engine's exchanges are
solved from: every plan's merge (``StepPlan.trace``: the step on meta
DTensors; the walk's ``"merge"``, its exchanges counted from the
``MeshAxis`` events) must move, level by level, exactly
``launch/wire_cost.wire_bytes_by_level`` summed over the gradient leaves
(CC021, ``placement.check_walk_bytes``), with the scheduled collectives
(``check_commit_walk``); the due-0 variant's merge must move nothing on
its deferred level and its eager levels' bytes on the others (CC020).
The plan keeps JAX's rules: the parameters stay FSDP over ``data`` and
the step gathers them, so the walk's totals add that gather and the
loss's mean to the merge's bytes. Held at the smoke config on a ``(pod 2, data 4, model
1)`` mesh and at full width (qwen1.5-0.5b, ``train_4k``, 256 ranks of
``(pod 2, data 128, model 1)``, one row of 4096 tokens a device). The
values of the same step on a real process group are
``tests/test_torch_plan_merge_gloo.py``'s.
"""

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.analysis import placement
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, \
    get_smoke_config
from repro_torch.core import ccache
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.core.merge_functions import ADD, int8_compressed_add
from repro_torch.core.merge_plan import MergePlan
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps, wire_cost
from repro_torch.models.layout import Spec, param_specs

SMOKE_SHAPE = ShapeConfig("t", 32, 8, "train")
# (plan, its schedule or None): eager, deferred K = 4, overlapped
SMOKE_PLANS = {"eager": ("chip:2,host:2,pod:2", None),
               "deferred": ("chip:2,host:2,pod:2:defer",
                            DeferSchedule.fixed(4, ("pod",))),
               "overlapped": ("chip:2,host:2,pod:2:defer",
                              DeferSchedule.fixed(4, ("pod",),
                                                  overlap=True))}
FULL_PLANS = {k: (v[0].replace("chip:2,host:2", "chip:16,host:8"), v[1])
              for k, v in SMOKE_PLANS.items()}
CELLS = {"smoke": (SMOKE_PLANS, 4), "full": (FULL_PLANS, 128)}


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    yield
    pmesh.shutdown()


def _cfg(cell):
    return (get_smoke_config("qwen1-5-0-5b") if cell == "smoke"
            else get_config("qwen1-5-0-5b"))


def _shape(cell):
    return SMOKE_SHAPE if cell == "smoke" else SHAPES["train_4k"]


def _leaves(cfg):
    return pytree.tree_leaves(param_specs(cfg),
                              is_leaf=lambda x: isinstance(x, Spec))


def _plan(cell, name, compress=False):
    plans, data = CELLS[cell]
    spec, sched = plans[name]
    mesh = pmesh.make_data_parallel_mesh(data)
    return (steps.plan_train(_cfg(cell), _shape(cell), mesh,
                             merge_plan=MergePlan.parse(spec),
                             merge_compress=compress, defer_schedule=sched),
            MergePlan.parse(spec), 2 * data)


def _want(cell, plan, dp, levels=None, compress=False):
    """The cost model's bytes by level, summed over the gradient leaves."""
    return wire_cost.tree_wire_bytes_by_level(
        ccache.resolve_plan(plan, dp, compress),
        dp, _leaves(_cfg(cell)),
        merge_fn=int8_compressed_add() if compress else ADD, levels=levels)


# ---------------------------------------------------------------------------
# merge axes, refusals
# ---------------------------------------------------------------------------


def test_merge_axes_on_mesh_follow_jax():
    """The data-parallel dims, ``("pod", "data")`` on the multi-pod mesh
    (one flattened axis), else ``("data",)``; a plan's ``axis_name``
    wins."""
    single = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    plan = MergePlan.parse("chip:2,pod:2")
    assert steps.merge_axes_on_mesh(single, plan) == ("data",)
    assert steps.merge_axes_on_mesh(multi, plan) == ("pod", "data")
    assert steps.merge_axes_on_mesh(multi, None) == ("pod", "data")
    pinned = MergePlan.parse("chip:2,pod:2", axis_name="data")
    assert steps.merge_axes_on_mesh(multi, pinned) == ("data",)
    assert steps.merge_axes_on_mesh(
        multi, MergePlan.parse("a:2", axis_name=("pod", "data"))) == (
        "pod", "data")


def test_refusals_carry_jax_messages():
    from repro_torch.optim import make_optimizer, warmup_cosine
    cfg = _cfg("smoke")
    mesh = pmesh.make_data_parallel_mesh(4)
    model = steps._abstract_model(cfg)
    opt = make_optimizer(cfg, warmup_cosine(3e-4, 100, 10_000))
    defer_plan = MergePlan.parse("chip:2,host:2,pod:2:defer")
    with pytest.raises(ValueError, match="needs a merge_topology"):
        steps.make_train_step(model, cfg, opt, mesh=mesh,
                              defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="needs a merge_topology"):
        steps.plan_train(cfg, SMOKE_SHAPE, mesh,
                         defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="no commit schedule"):
        steps.plan_train(cfg, SMOKE_SHAPE, mesh, merge_plan=defer_plan)
    with pytest.raises(ValueError, match="no :defer levels"):
        steps.plan_train(cfg, SMOKE_SHAPE, mesh,
                         merge_plan=MergePlan.parse("chip:2,host:2,pod:2"),
                         defer_schedule=DeferSchedule.fixed(2, ("pod",)))
    with pytest.raises(ValueError, match="do not match"):
        steps.plan_train(cfg, SMOKE_SHAPE, mesh, merge_plan=defer_plan,
                         defer_schedule=DeferSchedule.fixed(2, ("host",)))
    with pytest.raises(ValueError, match="ranks but the plan covers"):
        steps.plan_train(cfg, SMOKE_SHAPE, mesh,
                         merge_plan=MergePlan.parse("chip:2,pod:2"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_keeps_the_implicit_plan_as_in_jax(multi_pod):
    """A model axis of 16: JAX's ``NotImplementedError``, its message's
    opening words."""
    mesh = pmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(NotImplementedError,
                       match="explicit hierarchical gradient merge needs the "
                             r"non-merge mesh axes to be trivial, but "
                             r"\['model'\] have size > 1"):
        steps.plan_train(get_config("qwen1-5-0-5b"), SHAPES["train_4k"],
                         mesh,
                         merge_plan=MergePlan.parse("chip:16,host:16"
                                                    + (",pod:2" if multi_pod
                                                       else "")))


def test_fsdp_parameters_are_gathered_over_the_merge_dims():
    """The plan keeps JAX's rules (the FSDP rule ``embed -> data``): the
    parameters and the optimizer's moments stay split over ``data``, the
    step gathers the parameters at its region's edge (JAX's ``shard_map``
    with ``P()`` in_specs), and its outputs keep the inputs' layout: the
    parameters and moments FSDP, the loss replicated (JAX's ``pmean``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.partition import DEFAULT_RULES, sharding_rules
    cfg = _cfg("smoke")
    mesh = pmesh.make_data_parallel_mesh(4)
    p = steps.plan_train(cfg, SMOKE_SHAPE, mesh,
                         merge_plan=MergePlan.parse("chip:2,host:2,pod:2"))
    assert dict(DEFAULT_RULES, **p.rules)["embed"] == "data"
    with implicit_replication(), sharding_rules(mesh, p.rules):
        state, batch = p.inputs()
        split = [x for x in pytree.tree_leaves(state["params"])
                 if Shard(0) in x.placements or Shard(1) in x.placements]
        assert split and all(x.placements[1] != Replicate() for x in split)
        new, m = p.fn(state, batch)
    for part in ("params", "opt"):
        for a, b in zip(pytree.tree_leaves(state[part]),
                        pytree.tree_leaves(new[part])):
            assert b.placements == a.placements and b.shape == a.shape
    assert list(m["loss"].placements) == [Replicate()] * 3
    walk = p.trace()
    assert walk["per_collective"]["all-gather"]["count"] >= len(split)
    assert "all-gather" not in walk["merge"]["per_collective"]
    assert all(t >= g for t, g in zip(walk["wire_bytes_by_level_total"],
                                      walk["merge"]["wire_bytes_by_level_total"]))


# ---------------------------------------------------------------------------
# the plan's defer state (ports of JAX's two plan tests)
# ---------------------------------------------------------------------------


def test_plan_train_threads_defer_state():
    """JAX's ``test_plan_train_threads_defer_state``, on ``(data 8, model
    1)``: the plan holds the schedule, and ``state["defer"]`` is in its
    specs and its shardings, each pending split by rank over ``data``."""
    mesh = pmesh.make_host_mesh(8, 1)
    lp = steps.plan_train(
        _cfg("smoke"), SMOKE_SHAPE, mesh,
        merge_plan=MergePlan.parse("chip:2,host:2,pod:2:defer"),
        defer_schedule=DeferSchedule.fixed(4, ("pod",)))
    assert lp.defer_step is not None
    assert lp.defer_step.schedule.period == 4
    assert "defer" in lp.in_specs[0]
    sh = lp.shardings()[0]
    assert "defer" in sh and "inflight" not in sh["defer"]
    assert lp.fn is lp.defer_step.variants[-1]
    assert lp.noncommit_fn is lp.defer_step.variants[0]
    (specs,), (shapes,) = sh["defer"]["pending"], \
        lp.in_specs[0]["defer"]["pending"]
    for spec, leaf in zip(
            pytree.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple)),
            pytree.tree_leaves(shapes, is_leaf=lambda x: isinstance(x, Spec))):
        assert spec[0] == "data" and leaf.shape[0] == 8
        assert "data" not in spec[1:]


def test_plan_train_threads_inflight_shardings():
    """JAX's ``test_plan_train_threads_inflight_shardings``: the overlapped
    plan carries ``inflight``, and its superset program is the land twin of
    the full commit."""
    mesh = pmesh.make_host_mesh(8, 1)
    lp = steps.plan_train(
        _cfg("smoke"), SMOKE_SHAPE, mesh,
        merge_plan=MergePlan.parse("chip:2,host:2,pod:2:defer"),
        defer_schedule=DeferSchedule.fixed(4, ("pod",), overlap=True))
    assert lp.defer_step is not None and lp.defer_step.overlap
    assert "inflight" in lp.in_specs[0]["defer"]
    assert "inflight" in lp.shardings()[0]["defer"]
    assert lp.fn is lp.defer_step.land_variants[-1]
    assert lp.noncommit_fn is lp.defer_step.variants[0]


def test_placements_of_the_defer_state_on_the_multipod_dims():
    """On ``(pod 2, data 4, model 1)`` a pending's leading dim splits over
    both merge dims (row-major: merge rank r is pod r // 4, data r % 4) and
    the parameters keep their plan's layout (the FSDP rule's)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.partition import sharding_rules
    lp, _, dp = _plan("smoke", "overlapped")
    with implicit_replication(), sharding_rules(lp.mesh, lp.rules):
        state, batch = lp.inputs()
    for x in pytree.tree_leaves(state["defer"]["inflight"]):
        assert list(x.placements) == [Shard(0), Shard(0), Replicate()]
        assert x.shape[0] == dp and x.to_local().shape[0] == 1
    want = pytree.tree_leaves(lp.shardings()[0]["params"],
                              is_leaf=lambda x: isinstance(x, tuple))
    for x, spec in zip(pytree.tree_leaves(state["params"]), want):
        assert list(x.placements) == [
            Replicate(), Shard(spec.index("data")) if "data" in spec
            else Replicate(), Replicate()]
    assert list(batch["tokens"].placements) == [Shard(0), Shard(0),
                                                Replicate()]


# ---------------------------------------------------------------------------
# the walks against the cost model
# ---------------------------------------------------------------------------


def _n_leaves(cell):
    return len(_leaves(_cfg(cell)))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("name", sorted(SMOKE_PLANS))
def test_full_commit_moves_the_cost_model_s_bytes(cell, name):
    """The plan's program (the full commit, or its land twin) moves
    exactly ``wire_cost``'s bytes on every level and the scheduled
    collectives (CC021 clean); each device runs one embedding backward
    through ``cscatter`` and no other kernel."""
    lp, plan, dp = _plan(cell, name)
    walk = lp.trace()
    merge = walk["merge"]
    assert merge["level_names"] == list(plan.level_names())
    assert placement.check_walk_bytes(merge, _want(cell, plan, dp),
                                      f"{cell}:{name}") == []
    manifest = ccache.program_manifest(plan, dp, plan.num_deferred,
                                       merge_fn=ADD)
    assert placement.check_commit_walk(merge, manifest, f"{cell}:{name}",
                                       n_leaves=_n_leaves(cell)) == []
    assert {k: v["calls"] for k, v in walk["kernels"].items()} == {
        "cscatter": 1}
    assert walk["peak_live_bytes"] < 80e9


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("name", ["deferred", "overlapped"])
def test_noncommit_variant_moves_nothing_on_the_deferred_level(cell, name):
    """The due-0 variant (``noncommit_fn``) moves 0 bytes on ``pod``
    (CC020) and the eager levels' bytes on the others."""
    lp, plan, dp = _plan(cell, name)
    walk = lp.trace_variant(lp.noncommit_fn)["merge"]
    assert placement.check_deferred_levels_idle(walk, ("pod",),
                                                f"{cell}:{name}") == []
    assert walk["wire_bytes_by_level_total"][-1] == 0.0
    eager = {m.index for m in ccache.program_manifest(plan, dp, 0,
                                                      merge_fn=ADD)}
    assert eager == {0, 1}
    assert placement.check_walk_bytes(
        walk, _want(cell, plan, dp, levels=eager), f"{cell}:{name}") == []
    # and CC020 sees the eager levels' exchange: the check is not vacuous
    assert placement.check_deferred_levels_idle(walk, ("host",), "x")


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("name", sorted(SMOKE_PLANS))
def test_int8_compressed_merge_moves_the_codec_s_bytes(cell, name):
    """``merge_compress=True`` puts the int8 wire on the top level: its
    exchange moves the int8 values and their f32 scale, its broadcast the
    decoded f32 payload, as the cost model sizes them."""
    lp, plan, dp = _plan(cell, name, compress=True)
    walk = lp.trace()["merge"]
    want = _want(cell, plan, dp, compress=True)
    assert placement.check_walk_bytes(walk, want, f"{cell}:{name}") == []
    assert want != _want(cell, plan, dp)
    manifest = ccache.program_manifest(
        ccache.resolve_plan(plan, dp, True), dp, plan.num_deferred,
        merge_fn=int8_compressed_add())
    assert placement.check_commit_walk(walk, manifest, f"{cell}:{name}",
                                       n_leaves=_n_leaves(cell),
                                       exact_counts=False) == []


def test_overlapped_plan_traces_every_variant():
    """Every variant of the overlapped plan traces against the plan's
    specs; the launch (full commit, no land) moves nothing on ``pod`` and
    the land twin of the due-0 step moves only the top exchange there."""
    lp, plan, dp = _plan("smoke", "overlapped")
    step = lp.defer_step
    launch = lp.trace_variant(step.variants[-1])["merge"]
    assert launch["wire_bytes_by_level_total"][-1] == 0.0
    land0 = lp.trace_variant(step.land_variants[0])["merge"]
    full = lp.trace()["merge"]
    assert land0["wire_bytes_by_level_total"][-1] == \
        full["wire_bytes_by_level_total"][-1] > 0


def test_flat_merge_over_a_non_power_of_two_mesh_axis_raises():
    """The flat non-power-of-two merge gathers every rank's value and folds
    it in rank order: it runs on a stacked axis only."""
    from repro_torch.core.mesh_axis import MeshAxis
    axis = MeshAxis(pmesh.make_host_mesh(6, 1), ("data",), "meta")
    assert (axis.size, axis.stack, axis.rank) == (6, 1, 0)
    assert axis.index().shape == (1,)
    with pytest.raises(NotImplementedError, match="not on a mesh axis"):
        ccache.tree_merge(torch.empty((1, 3), device="meta"), axis, ADD)


def test_a_mesh_axis_needs_the_other_dims_trivial():
    """The axis flattens the merge dims; a mesh whose other dims split it
    (a model axis of 2) is refused, as the explicit step refuses it."""
    from repro_torch.core.mesh_axis import MeshAxis
    with pytest.raises(ValueError, match=r"\['model'\] do not"):
        MeshAxis(pmesh.make_host_mesh(4, 2), ("data",), "meta")
    axis = MeshAxis(pmesh.make_data_parallel_mesh(4), ("pod", "data"),
                    "meta")
    assert axis.ranks == list(range(8)) and axis.rank == 0
