"""The explicit-merge train step over a real process group: 8 CPU processes
on a gloo group, one rank each of a ``(pod 2, data 4, model 1)`` mesh.

Each process runs ``steps.make_train_step(mesh=...)`` (the step that
``plan_train(merge_plan=...)`` plans) on DTensors of the dense smoke
config, batch 8 x 32 (the shape of JAX's three-level test), its gradients
merged by the engine over ``core/mesh_axis.MeshAxis``: point-to-point
sends and receives and gloo all-reduces between the processes. The loss
and the parameters after every step (and after the final flush) are held
to the stacked step (``make_train_step(merge_topology=...)``, the 8 ranks
stacked on one device) and to the JAX reference of
``tests/test_torch_train.py`` (per-rank ``jax.value_and_grad``, JAX's
cascades under ``vmap``, JAX's AdamW), within that file's ``TOL``: f32
sums in another order (gloo's all-reduce against the stacked ``sum``, the
per-process backward against the stacked one), not bitwise. Every
process's parameters must be bitwise equal to every other's (the replicas
of a data-parallel step stay one). Two runs lay the parameters and the
optimizer's moments out by the plan's FSDP rule (``embed`` over ``data``):
the step gathers the parameters at its region's edge and hands them back
in their own layout, as JAX's ``shard_map`` with ``P()`` in_specs does; the
loss leaves every run replicated (JAX's ``pmean``).

The processes are this file run as a script (``--worker``), each writing
its output to its own log file, with one time limit for the spawn; a
process that fails, or outlives the limit, fails the test with its log's
tail.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 4, 1)
BATCH, SEQ = 8, 32
WORKER_TIMEOUT = 300          # seconds, every process of a spawn
# (name, plan, lane-parallel, deferred levels' intervals or None, overlap,
# steps, FSDP): the eager plan of JAX's three-level test, lane-parallel
# too, and a deferred and an overlapped row of test_torch_train.SCHEDULES,
# the parameters replicated; and the eager and the overlapped plan with the
# parameters and the optimizer's moments laid out by the plan's FSDP rule
# (``embed`` over ``data``), which the step gathers at its region's edge
RUNS = [("eager", "chip:2,host:2,pod:2", False, None, False, 1, False),
        ("eager_lane", "chip:2,host:2,pod:2", True, None, False, 1, False),
        ("deferred", "chip:2,host:2:defer,pod:2:defer", False, (2, 2),
         False, 5, False),
        ("overlapped", "chip:2,host:2:defer,pod:2:defer", False, (1, 3),
         True, 7, False),
        ("eager_fsdp", "chip:2,host:2,pod:2", False, None, False, 1, True),
        ("overlapped_fsdp", "chip:2,host:2:defer,pod:2:defer", False,
         (1, 3), True, 4, True)]


# the engine alone, over the mesh axis against the stacked one: (plan,
# lane-parallel, merge, dtype, compress); float sums only over pairs (two
# addends sum alike in any order), so every case is bitwise
ENGINE = [("chip:2,host:2,pod:2", False, "add", "float32", False),
          ("chip:2,host:2,pod:2", True, "add", "float32", False),
          ("chip:8", False, "add", "int32", False),
          ("chip:2,host:4", False, "max", "float32", False),
          ("chip:4,pod:2", True, "min", "float32", False),
          ("chip:2,host:2,pod:2", True, "int8_add", "float32", True),
          ("chip:4,pod:2", False, "int8_add", "float32", True)]


def _merge(name):
    from repro_torch.core import merge_functions as mf
    return {"add": mf.ADD, "max": mf.MAX, "min": mf.MIN,
            "int8_add": mf.int8_compressed_add()}[name]


def _engine_input(i: int, dtype: str) -> torch.Tensor:
    g = np.random.default_rng(100 + i)
    if dtype == "int32":
        return torch.from_numpy(g.integers(-2**30, 2**30, (WORLD, 6, 3),
                                           dtype=np.int32))
    return torch.from_numpy(g.standard_normal((WORLD, 6, 3),
                                              dtype=np.float32))


def _names(spec):
    from repro_torch.core.merge_plan import MergePlan
    return tuple(lv.name for lv in MergePlan.parse(spec).levels if lv.defer)


# ---------------------------------------------------------------------------
# the worker: one process, one rank of the mesh
# ---------------------------------------------------------------------------


def _worker(rank: int, init: str, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs import base as tbase
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.launch import steps
    from repro_torch.models.registry import abstract_model
    from repro_torch.optim import optimizers as topt
    from repro_torch.optim import schedules as tsched

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD)
    meta = json.loads(Path(work, "meta.json").read_text())
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(MESH),
                      mesh_dim_names=("pod", "data", "model"))
    cfg = dataclasses.replace(tbase.get_smoke_config(meta["arch"]),
                              dtype="float32", remat="none")
    model = abstract_model(cfg)
    local = torch.load(Path(work, "params.pt"))
    rep = [Replicate()] * 3

    def replicated(x):
        return DTensor.from_local(x, mesh, rep, run_check=False)

    from repro_torch.models.layout import param_axes
    from repro_torch.sharding.partition import placements_for, spec_for
    axes = pytree.tree_leaves(param_axes(cfg), is_leaf=steps._is_axes)

    def fsdp(tree):
        """A tree of the parameters' structure laid out by the FSDP rule
        (a local slice of each replicated tensor: no data moves)."""
        leaves, spec = pytree.tree_flatten(tree)
        return pytree.tree_unflatten(
            [replicated(x).redistribute(mesh, placements_for(
                spec_for(tuple(x.shape), a, mesh), mesh))
             for x, a in zip(leaves, axes)], spec)

    batches = np.load(Path(work, "batches.npz"))
    per = BATCH // WORLD
    rows = [Shard(0), Shard(0), Replicate()]

    def batch_at(t):
        return {k: DTensor.from_local(
            torch.from_numpy(batches[k][t, rank * per:(rank + 1) * per]),
            mesh, rows, run_check=False, shape=(BATCH, SEQ),
            stride=(SEQ, 1)) for k in ("tokens", "labels")}

    from repro_torch.analysis import placement, trace
    from repro_torch.core import ccache
    from repro_torch.core.mesh_axis import MeshAxis
    axis = MeshAxis(mesh, ("pod", "data"), "cpu")
    out = {"axis": [axis.size, axis.rank, axis.stack]}
    for i, (spec, lane, merge, dtype, comp) in enumerate(ENGINE):
        x = _engine_input(i, dtype)[rank:rank + 1]
        got, calls = trace.record(
            lambda u: ccache.hierarchical_merge(
                u, axis, _merge(merge), MergePlan.parse(
                    spec, lane_parallel=lane), compress=comp), x)
        out[f"engine{i}"] = got[0]
        sizes = [lv.size for lv in MergePlan.parse(spec).levels]
        out[f"engine{i}/walk"] = placement.walk_of(
            calls, sizes)["wire_bytes_by_level_total"]
    for name, spec, lane, intervals, overlap, n, sharded in RUNS:
        opt = topt.adamw(tsched.constant(meta["lr"]), eps=meta["eps"])
        o = opt.init(local)
        if sharded:
            params = fsdp(local)
            o = type(o)(step=replicated(o.step), mu=fsdp(o.mu),
                        nu=fsdp(o.nu))
        else:
            params = pytree.tree_map(replicated, local)
            o = pytree.tree_map(replicated, o)
        state = {"params": params, "opt": o}
        layout = [x.placements for x in pytree.tree_leaves(state)]
        sched = (None if intervals is None else DeferSchedule(
            level_names=_names(spec), intervals=tuple(intervals),
            overlap=overlap))
        step = steps.make_train_step(
            model, cfg, opt, mesh=mesh,
            merge_topology=MergePlan.parse(spec, lane_parallel=lane),
            defer_schedule=sched)
        if sched is not None:
            state["defer"] = step.init_defer_state(state["params"])
        hist = []
        for t in range(n):
            state, m = step(state, batch_at(t))
            assert list(m["loss"].placements) == rep
            hist.append(float(m["loss"].to_local()))
            out[f"{name}/params/{t}"] = state["params"]
        out[f"{name}/layout_kept"] = float(layout == [
            x.placements for x in pytree.tree_leaves(
                {"params": state["params"], "opt": state["opt"]})])
        out[f"{name}/split"] = float(sum(
            x.placements != tuple(rep)
            for x in pytree.tree_leaves(state["params"])))
        if sched is not None:
            state, _ = step.flush(state)
            out[f"{name}/params/flushed"] = state["params"]
            left = [x for tr in state["defer"]["pending"]
                    + ((state["defer"]["inflight"],) if overlap else ())
                    for x in pytree.tree_leaves(tr)]
            out[f"{name}/outstanding"] = float(sum(
                x.to_local().abs().sum() for x in left))
        out[f"{name}/loss"] = hist
    flat = {}
    for k, v in out.items():
        if isinstance(v, (float, list)):
            flat[k] = np.asarray(v, np.float64)
            continue
        if isinstance(v, torch.Tensor):
            flat[k] = v.numpy()
            continue
        for path, x in _flatten_with_paths(v):
            flat[f"{k}/{path}"] = x.full_tensor().numpy()
    np.savez(Path(work, f"rank{rank}.npz"), **flat)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test
# ---------------------------------------------------------------------------


def _spawn(work: Path) -> None:
    """Run the :data:`WORLD` workers, each writing its output to its own
    log file (a full pipe cannot stall a worker in a collective); a worker
    that fails or outlives :data:`WORKER_TIMEOUT` fails the spawn with its
    log's tail."""
    from repro_torch.launch.mesh import spawn_shards
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init = work / "init"
    spawn_shards(lambda r: [sys.executable, __file__, "--worker", str(r),
                            str(init), str(work)],
                 WORLD, work, WORKER_TIMEOUT, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of :data:`RUNS` on the 8 processes -> (each rank's
    results, the batches, the smoke pair of test_torch_train)."""
    from test_torch_train import ARCH, EPS, LR, Pair, _batch
    pair = Pair("float32")
    work = tmp_path_factory.mktemp("gloo")
    n = max(r[5] for r in RUNS)
    raw = [_batch(seed=10 + t, s=SEQ) for t in range(n)]
    np.savez(work / "batches.npz",
             **{k: np.stack([b[k] for b in raw]) for k in raw[0]})
    torch.save(pair.tparams(), work / "params.pt")
    (work / "meta.json").write_text(json.dumps(
        {"arch": ARCH, "lr": LR, "eps": EPS}))
    _spawn(work)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, raw, pair


def _tree(rank: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def test_every_process_holds_the_same_parameters(runs):
    """The replicas stay one: every rank's parameters, after every step
    and after each flush, are bitwise equal to rank 0's."""
    ranks, _, _ = runs
    keys = [k for k in ranks[0] if "/params/" in k]
    assert keys
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_the_mesh_axis_is_this_process_s_rank_of_the_flattened_dims(runs):
    """``pod`` x ``data`` flattened row-major: rank r of the gloo group is
    merge rank r (the model dim has size 1), one rank a device."""
    ranks, _, _ = runs
    for r, got in enumerate(ranks):
        assert got["axis"].tolist() == [WORLD, r, 1]


@pytest.mark.parametrize("i", range(len(ENGINE)),
                         ids=[f"{c[0]}{'-lane' if c[1] else ''}-{c[2]}-"
                              f"{c[3]}" for c in ENGINE])
def test_engine_over_the_mesh_axis_equals_the_stacked_engine(runs, i):
    """``hierarchical_merge`` over the processes (p2p sends and receives,
    gloo all-reduces over each aligned group) gives every rank the stacked
    engine's row, bitwise; its recorded walk (the ``MeshAxis`` collectives
    heard by ``analysis.trace``) equals the stacked one's."""
    from repro_torch.analysis import placement, trace
    from repro_torch.core import ccache
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.core.stacked import StackedAxis
    ranks, _, _ = runs
    spec, lane, merge, dtype, comp = ENGINE[i]
    plan = MergePlan.parse(spec, lane_parallel=lane)
    want, calls = trace.record(
        lambda u: ccache.hierarchical_merge(u, StackedAxis(WORLD, "cpu"),
                                            _merge(merge), plan,
                                            compress=comp),
        _engine_input(i, dtype))
    walk = placement.walk_of(calls, [lv.size for lv in plan.levels])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"engine{i}"], want[r].numpy(),
                                      err_msg=f"rank {r}")
        assert got[f"engine{i}/walk"].tolist() == \
            walk["wire_bytes_by_level_total"]


def _stacked_run(pair, spec, lane, intervals, overlap, batches):
    """The stacked step's losses and flat parameters after each step (and
    after the flush)."""
    from test_torch_train import _adamw, _flat_torch
    from repro_torch.core.defer_schedule import DeferSchedule
    from repro_torch.core.merge_plan import MergePlan
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    from repro_torch.optim import schedules as tsched
    from test_torch_train import LR
    opt = _adamw(topt, tsched.constant(LR))
    sched = (None if intervals is None else DeferSchedule(
        level_names=_names(spec), intervals=intervals, overlap=overlap))
    step = steps.make_train_step(
        pair.tmodel, pair.tcfg, opt,
        merge_topology=MergePlan.parse(spec, lane_parallel=lane),
        defer_schedule=sched)
    params = pair.tparams()
    state = {"params": params, "opt": opt.init(params)}
    if sched is not None:
        state["defer"] = step.init_defer_state(params)
    losses, trees = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        trees.append(_flat_torch(state["params"]))
    if sched is not None:
        state, _ = step.flush(state)
        trees.append(_flat_torch(state["params"]))
    return losses, trees


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_planned_step_on_gloo_equals_the_stacked_step_and_jax(runs, run):
    """Every step's loss and parameters, and the flushed parameters of a
    deferred or overlapped schedule, against the stacked step and the
    composed JAX reference (``TOL``)."""
    import jax
    from test_torch_train import (LR, TOL, _adamw, _assert_trees_close,
                                  _flat_jax, _jax_deferred_run)
    from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    ranks, raw, pair = runs
    name, spec, lane, intervals, overlap, n, sharded = run
    batches = raw[:n]
    got = ranks[0]
    assert float(got[f"{name}/layout_kept"]) == 1.0
    assert (float(got[f"{name}/split"]) > 0) == sharded
    losses, trees = _stacked_run(pair, spec, lane, intervals, overlap,
                                 batches)
    jopt_ = _adamw(jopt, jsched.constant(LR))
    if intervals is None:
        loss, grads = pair.jax_rank_grads(pair.jparams, batches[0])
        mean = jax.tree.map(lambda g: g.sum(0) / WORLD, grads)
        jparams, _, _ = jopt_.step(pair.jparams, mean,
                                   jopt_.init(pair.jparams))
        jlosses, jtrees = [float(loss)], [_flat_jax(jparams)]
    else:
        sched = JDeferSchedule(level_names=_names(spec), intervals=intervals,
                               overlap=overlap)
        hist, jfinal = _jax_deferred_run(pair, spec, sched, batches, jopt_)
        jlosses = [h[0] for h in hist]
        jtrees = [h[1] for h in hist] + [jfinal]
        assert float(got[f"{name}/outstanding"]) == 0.0
    np.testing.assert_allclose(got[f"{name}/loss"], losses, rtol=TOL)
    np.testing.assert_allclose(got[f"{name}/loss"], jlosses, rtol=TOL)
    keys = [str(t) for t in range(n)] + (["flushed"] if intervals else [])
    for t, key in enumerate(keys):
        mine = _tree(got, f"{name}/params/{key}/")
        _assert_trees_close(mine, trees[t], atol=TOL,
                            what=f"{name} {key} vs stacked")
        _assert_trees_close(mine, jtrees[t], atol=TOL,
                            what=f"{name} {key} vs jax")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
