"""The train CLI over a real ``(data, model)`` mesh of processes
(``launch/train.py --procs N --model-ranks M``), one gloo CPU process a
device of JAX's layout, at the f32 smoke configs.

Each run is the CLI's own worker path: this file run as a script
(``--cli RECORD MODE ...``) sets the smoke config to f32 with no remat,
``moe_impl="ep"`` (the smoke configs are ``"gshard"``, so a plain smoke
run would take ``moe.apply``) and the full config's optimizer (kimi-k2 is
Adafactor), AdamW's ``eps`` to 1e-3 (``tests/test_torch_train.py`` says
why), and hands the rest of its arguments to the CLI. It records what the
tests read: each process's slices of the laid-out state and of the first
batch, the digest of each of its slices of the final state
(``checkpoint.shard_digests``), the calls of ``moe_ep.apply_ep_mesh``, of the ``cscatter`` wrapper
(``kernels.ops.commutative_scatter``: the vocab-parallel embedding's
gradient and the expert-parallel combine), and every all-gather that
DTensor's functional collectives ran outside ``core/mesh_axis``'s staging
(mode ``staged``: every gather over gloo is staged through the host, as
on the card, where DTensor's own all-gather of a card tensor kills the
process). Mode ``plain`` runs DTensor's own collectives, as gloo on the
CPU may.

Every run is held to the stacked CLI run of the same flags (the data ranks
stacked as ``--merge-topology chip:D``, the model ranks as
``--model-ranks M``, in this process) and to the reference composed from
JAX's pieces (``tests/test_torch_train_procs.py``: per-rank
``jax.value_and_grad`` under ``vmap``, the mean over the data ranks, JAX's
AdamW or Adafactor; JAX's own ``make_train_step(mesh=)`` and ``apply_ep``
on a mesh fail on this container's jax): the losses, the parameters and
the optimizer's moments (every gradient leaf through the optimizer) after
2 steps, within ``TOL`` (1e-5). Each process's slices are held to JAX's
``NamedSharding`` of the same leaf by JAX's rules, on a forced
4-device host mesh in a subprocess.
"""

import atexit
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 240
EPS = 1e-3
LR, WARMUP, STEPS = 1e-3, 2, 2
BATCH, SEQ = 8, 16
EP_ARCHS = ("qwen3-moe-235b", "kimi-k2-1t")
# name -> (arch, data, model, mode)
RUNS = {
    "dense_2x2": ("qwen1-5-0-5b", 2, 2, "staged"),
    "dense_1x2": ("qwen1-5-0-5b", 1, 2, "plain"),
    "qwen3_2x2": ("qwen3-moe-235b", 2, 2, "staged"),
    "qwen3_1x2": ("qwen3-moe-235b", 1, 2, "plain"),
    "kimi_2x2": ("kimi-k2-1t", 2, 2, "staged"),
}


def cli_config(get_smoke_config, get_config, arch: str):
    """The smoke config the tests run: f32, no remat, the full config's
    optimizer, and the expert-parallel MoE for the MoE archs."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              remat="none",
                              optimizer=get_config(arch).optimizer)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    return cfg


def patch_cli(train) -> None:
    """The CLI at :func:`cli_config`, AdamW ``eps`` 1e-3."""
    from repro_torch.optim import optimizers as topt
    smoke, full = train.get_smoke_config, train.get_config
    train.get_smoke_config = lambda arch: cli_config(smoke, full, arch)
    train.make_optimizer = lambda cfg, sched: (
        topt.adafactor(sched) if cfg.optimizer == "adafactor"
        else topt.adamw(sched, eps=EPS))


def argv_for(arch: str, ckpt_dir: Path, steps: int = STEPS) -> list:
    return ["--arch", arch, "--smoke", "--device", "cpu", "--batch",
            str(BATCH), "--seq", str(SEQ), "--lr", str(LR), "--warmup",
            str(WARMUP), "--steps", str(steps), "--ckpt-every", str(steps),
            "--ckpt-dir", str(ckpt_dir)]


def run_procs(argv: list, procs: int, model: int, work: Path,
              mode: str = "staged", during=None) -> str:
    """The CLI's workers of ``argv`` over ``procs`` gloo processes as a
    ``(procs / model, model)`` mesh (this file as ``--cli``), each
    recording into ``work/record.rank{r}.json``, the driver's log in
    ``work/log.jsonl`` -> rank 0's output."""
    from repro_torch.launch.mesh import spawn_shards
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    extra = [] if "--log" in argv else ["--log", str(work / "log.jsonl")]
    extra += ["--model-ranks", str(model)] if model > 1 else []
    init = work / "init"
    if init.exists():
        init.unlink()
    spawn_shards(lambda r: [sys.executable, __file__, "--cli",
                            str(work / "record"), mode, *argv, *extra,
                            "--procs", str(procs), "--worker", str(r),
                            f"file://{init}"],
                 procs, work, WORKER_TIMEOUT, env=env, during=during)
    return (work / "rank0.log").read_text()


def records(work: Path, procs: int) -> list:
    return [json.loads((work / f"record.rank{r}.json").read_text())
            for r in range(procs)]


def run_stacked(argv: list, data: int, model: int):
    """The stacked CLI run of ``argv`` in this process: ``data`` ranks as
    ``--merge-topology chip:data``, ``model`` as ``--model-ranks`` (a MoE
    config's) -> its ``TrainResult``."""
    import contextlib
    import io
    from repro_torch.launch import train
    extra = ["--merge-topology", f"chip:{data}"] if data > 1 else []
    cfg = train.get_smoke_config(argv[argv.index("--arch") + 1])
    if cfg.family == "moe":
        extra += ["--model-ranks", str(model)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "get_smoke_config", train.get_smoke_config)
        mp.setattr(train, "make_optimizer", train.make_optimizer)
        patch_cli(train)
        with contextlib.redirect_stdout(io.StringIO()):
            return train.main(argv + extra)


def events(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def step_losses(path: Path) -> list:
    return [e["loss"] for e in events(path) if e["event"] == "step"]


def flat_ckpt(d: Path) -> dict:
    from test_torch_train_procs import flat_ckpt as flat
    return flat(d)


def close(got: dict, want: dict, what: str, keys=None):
    from test_torch_train import TOL, _assert_trees_close
    keys = sorted(want) if keys is None else keys
    _assert_trees_close({k: got[k] for k in keys}, {k: want[k] for k in keys},
                        atol=TOL, what=what)


# ---------------------------------------------------------------------------
# JAX's side: the composed reference and the NamedSharding slices
# ---------------------------------------------------------------------------


def jax_reference(arch: str, data: int, tmp: Path):
    """The composed JAX run of the CLI's flags from the port's seeded
    weights: per-rank ``value_and_grad`` over ``data`` ranks, their mean,
    JAX's optimizer -> (losses, flat state ``params/...``, ``opt/...``)."""
    import jax
    from repro import checkpoint as jckpt
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import batch_at, data_config_for
    from repro_torch.models.registry import build_model
    from test_torch_train import Pair
    cfg = cli_config(get_smoke_config, get_config, arch)
    params = build_model(cfg, device="cpu", seed=0).params()
    dcfg = data_config_for(cfg, ShapeConfig("cli", SEQ, BATCH, "train"),
                           seed=0)
    over = {"optimizer": cfg.optimizer}
    if cfg.family == "moe":
        over["moe_impl"] = "ep"
    pair = Pair("float32", arch=arch, **over)
    ckpt.save(str(tmp), 0, params)
    pair.jparams, _ = jckpt.restore(str(tmp), pair.jparams)
    sched = jsched.warmup_cosine(LR, WARMUP, STEPS)
    opt = (jopt.adafactor(sched) if cfg.optimizer == "adafactor"
           else jopt.adamw(sched, eps=EPS))
    p, state = pair.jparams, opt.init(pair.jparams)
    losses = []
    for t in range(STEPS):
        loss, grads = pair.jax_rank_grads(p, batch_at(dcfg, t), data)
        p, state, _ = opt.step(p, jax.tree.map(lambda g: g.sum(0) / data,
                                               grads), state)
        losses.append(float(loss))
    from repro.checkpoint.checkpoint import _flatten_with_paths
    flat = dict(_flatten_with_paths({"params": p, "opt": state}))
    return losses, {k: np.asarray(v, dtype=np.float32) for k, v in
                    flat.items() if np.ndim(v) > 0}


def jax_slices(runs: dict) -> dict:
    """For each run, JAX's ``NamedSharding`` slice of every state leaf and
    of the batch by JAX's rules at each ``(data, model)`` coordinate, from
    a subprocess on a forced 4-device host mesh."""
    spec = {name: [arch, d, m] for name, (arch, d, m, _) in runs.items()}
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, __file__, "--jax-slices",
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jax_slices_main(spec: dict) -> None:
    import jax
    from jax.sharding import NamedSharding
    from repro.checkpoint.checkpoint import _flatten_with_paths
    from repro.configs.base import ShapeConfig, get_config, get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import (axes_to_shardings, lowering_rules,
                                    opt_state_axes)
    from repro.models.module import split_params
    from repro.models.registry import build_model
    from repro.optim import make_optimizer, warmup_cosine
    from repro.optim.optimizers import OptState
    from repro.sharding.partition import spec_for
    out = {}
    for name, (arch, data, model) in spec.items():
        cfg = cli_config(get_smoke_config, get_config, arch)
        mesh = make_host_mesh(data, model)
        rules = lowering_rules(cfg, ShapeConfig("cli", SEQ, BATCH, "train"),
                               mesh)
        jmodel = build_model(cfg)
        p_specs, p_axes = split_params(jax.eval_shape(jmodel.init,
                                                      jax.random.key(0)))
        o_specs = jax.eval_shape(make_optimizer(
            cfg, warmup_cosine(LR, WARMUP, STEPS)).init, p_specs)
        o_axes = opt_state_axes(o_specs, p_axes)
        shard = {"params": axes_to_shardings(p_axes, p_specs, mesh, rules),
                 "opt": OptState(step=None, mu=None if o_specs.mu is None
                                 else axes_to_shardings(o_axes.mu,
                                                        o_specs.mu, mesh,
                                                        rules),
                                 nu=axes_to_shardings(o_axes.nu, o_specs.nu,
                                                      mesh, rules))}
        shapes = dict(_flatten_with_paths({"params": p_specs,
                                           "opt": o_specs}))
        leaves = dict(_flatten_with_paths(shard))
        leaves["batch/tokens"] = NamedSharding(
            mesh, spec_for((BATCH, SEQ), ("batch", "seq"), mesh, rules))
        shapes["batch/tokens"] = jax.ShapeDtypeStruct((BATCH, SEQ), "int32")
        got = {}
        for key, sh in leaves.items():
            if sh is None:
                continue
            where = {}
            for dev, idx in sh.devices_indices_map(
                    tuple(shapes[key].shape)).items():
                i, j = (int(c) for c in np.argwhere(mesh.devices == dev)[0])
                where[f"{i},{j}"] = [
                    [s.start or 0, n if s.stop is None else s.stop]
                    for s, n in zip(idx, shapes[key].shape)]
            got[key] = where
        out[name] = got
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_procs")
    out = {}
    for name, (arch, data, model, mode) in RUNS.items():
        work = root / name
        procs = data * model
        text = run_procs(argv_for(arch, work / "ck"), procs, model, work,
                         mode)
        res = run_stacked(argv_for(arch, root / f"{name}_stacked"), data,
                          model)
        out[name] = {"text": text, "work": work, "procs": procs,
                     "records": records(work, procs), "stacked": res,
                     "stacked_dir": root / f"{name}_stacked",
                     "jax": jax_reference(arch, data, root / f"{name}_jax")}
    out["jax_slices"] = jax_slices(RUNS)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_run_equals_the_stacked_run(runs, name):
    """Losses, parameters and moments after 2 steps within ``TOL`` of the
    stacked run of the same flags."""
    from test_torch_train import TOL
    run = runs[name]
    got = step_losses(run["work"] / "log.jsonl")
    want = [e["loss"] for e in run["stacked"].events if e["event"] == "step"]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=TOL, err_msg=name)
    mine, theirs = flat_ckpt(run["work"] / "ck"), flat_ckpt(
        run["stacked_dir"])
    assert sorted(mine) == sorted(theirs)
    close(mine, theirs, f"{name} vs stacked")


@pytest.mark.parametrize("name", list(RUNS))
def test_run_equals_the_composed_jax_reference(runs, name):
    from test_torch_train import TOL
    run = runs[name]
    losses, want = run["jax"]
    np.testing.assert_allclose(step_losses(run["work"] / "log.jsonl"),
                               losses, rtol=TOL, err_msg=name)
    mine = flat_ckpt(run["work"] / "ck")
    assert {k for k in mine if k.startswith(("params/", "opt/mu",
                                             "opt/nu"))} == set(want)
    close(mine, want, f"{name} vs jax")


@pytest.mark.parametrize("name", list(RUNS))
def test_every_slice_is_jax_s(runs, name):
    """Each process's local slice of every laid-out state leaf (the
    parameters split over ``"model"`` where the rules say, FSDP over
    ``"data"``, the moments by ``opt_state_axes``) and of the batch (split
    over ``"data"`` only, whole over ``"model"``) is JAX's
    ``NamedSharding`` slice at the process's mesh coordinate."""
    want = runs["jax_slices"][name]
    recs = runs[name]["records"]
    data, model = RUNS[name][1:3]
    split_over_model = 0
    for r, rec in enumerate(recs):
        i, j = rec["coordinate"]
        assert (i, j) == divmod(r, model)        # model minor, as JAX's
        assert set(rec["slices"]) == set(want), name
        for key, where in rec["slices"].items():
            assert where == want[key][f"{i},{j}"], (name, r, key)
            whole = [[0, n] for _, n in want[key]["0,0"]]
            split_over_model += (model > 1 and where != whole
                                 and key.startswith("params/"))
    if model > 1:
        assert split_over_model > 0


def test_expert_parallel_form_ran_on_every_process(runs):
    """The MoE runs take ``apply_ep_mesh`` (JAX's ``_moe`` condition on
    the process's real mesh): once a MoE layer a step on every process;
    the dense runs never."""
    from repro_torch.configs.base import get_smoke_config
    for name, (arch, data, model, _) in RUNS.items():
        cfg = get_smoke_config(arch)
        moe_layers = (cfg.n_layers - cfg.first_dense_layers
                      if cfg.family == "moe" else 0)
        for rec in runs[name]["records"]:
            assert rec["apply_ep_mesh"] == moe_layers * STEPS, (name, rec)


def test_cscatter_runs_in_each_process_s_embedding_and_combine(runs):
    """The ``cscatter`` wrapper on each process's local tensors: the
    vocab-parallel embedding's gradient once a step, and each MoE layer's
    combine once a step (no remat here): the card's prediction, two
    launches a call."""
    from repro_torch.configs.base import get_smoke_config
    for name, (arch, *_rest) in RUNS.items():
        cfg = get_smoke_config(arch)
        moe_layers = (cfg.n_layers - cfg.first_dense_layers
                      if cfg.family == "moe" else 0)
        for rec in runs[name]["records"]:
            assert rec["cscatter_calls"] == (1 + moe_layers) * STEPS, name
            assert rec["cscatter_on_dtensors"] == 0, name


@pytest.mark.parametrize("name", [n for n, r in RUNS.items()
                                  if r[3] == "staged"])
def test_no_gather_runs_through_dtensor_s_collectives(runs, name):
    """With every gather over gloo staged through the host (as on the
    card), no all-gather runs through DTensor's functional collectives
    outside ``core/mesh_axis``'s staging: not in the FSDP gathers, the
    logits' gather over ``"model"``, the constraints, nor in any op's
    forward or backward. (A move between two split dims is an all-to-all
    on the card; on the CPU DTensor runs it as a gather, which the record
    leaves out.)"""
    for rec in runs[name]["records"]:
        assert rec["staged_gathers"] > 0
        assert rec["unstaged_gathers"] == [], rec["unstaged_gathers"][:3]


def test_model_ranks_print_jax_s_lines_once(runs):
    import re
    for name in RUNS:
        text = runs[name]["text"]
        assert len(re.findall(r"^steps 0\.\.2: loss \S+ -> \S+$", text,
                              re.M)) == 1, name


# ---------------------------------------------------------------------------
# the worker: the CLI with its records
# ---------------------------------------------------------------------------


def _worker(record: str, mode: str, argv: list) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                                   shard_digests)
    from repro_torch.core import mesh_axis
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import moe_ep
    patch_cli(train)
    rec = {"apply_ep_mesh": 0, "cscatter_calls": 0,
           "cscatter_on_dtensors": 0, "staged_gathers": 0,
           "unstaged_gathers": [], "slices": {}, "coordinate": None}
    rank = argv[argv.index("--worker") + 1]

    def slices(key, x):
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, x.placements)
        rec["slices"][key] = [[o, o + n] for o, n in zip(offset, shape)]

    lay = steps.lay_out_state

    def lay_out_state(state, *a, **k):
        out = lay(state, *a, **k)
        for key, x in _flatten_with_paths(out):
            if x.dim() > 0:
                slices(key, x)
        rec["coordinate"] = list(out["params"]["ln_f"]["scale"]
                                 .device_mesh.get_coordinate())
        return out
    steps.lay_out_state = lay_out_state
    shard = steps.shard_batch

    def shard_batch(batch, mesh, *a, **k):
        out = shard(batch, mesh, *a, **k)
        if "batch/tokens" not in rec["slices"]:
            slices("batch/tokens", out["tokens"])
        return out
    steps.shard_batch = shard_batch
    ep = moe_ep.apply_ep_mesh

    def apply_ep_mesh(*a, **k):
        rec["apply_ep_mesh"] += 1
        return ep(*a, **k)
    moe_ep.apply_ep_mesh = apply_ep_mesh
    scatter = ops.commutative_scatter

    def commutative_scatter(table, *a, **k):
        rec["cscatter_calls"] += 1
        rec["cscatter_on_dtensors"] += hasattr(table, "placements")
        return scatter(table, *a, **k)
    ops.commutative_scatter = commutative_scatter
    if mode == "staged":
        # the card's choice: every gather over gloo through the host
        mesh_axis._stages = lambda x: mesh_axis.backend_of() == "gloo"
    staging = [0]
    on_host = mesh_axis._on_host

    def staged(*a):
        staging[0] += 1
        rec["staged_gathers"] += 1
        try:
            return on_host(*a)
        finally:
            staging[0] -= 1
    mesh_axis._on_host = staged
    for name in ("all_gather_tensor", "all_gather_single",
                 "all_gather_tensor_autograd"):
        fn = getattr(funcol, name, None)
        if fn is None:
            continue

        def gather(*a, _fn=fn, **k):
            stack = traceback.extract_stack()
            if mode == "staged" and not staging[0] and not any(
                    f.name == "shard_dim_alltoall" for f in stack):
                at = [f for f in stack if "repro_torch" in f.filename]
                rec["unstaged_gathers"].append(
                    f"{at[-1].filename}:{at[-1].lineno}" if at else "?")
            return _fn(*a, **k)
        setattr(funcol, name, gather)

    run = train._train

    def _train(args, mesh):
        # the digest of each of this process's slices of the final state,
        # taken before the group goes: what the checkpoint must hold there
        res = run(args, mesh)
        rec["state_digests"] = shard_digests(res.state)
        return res
    train._train = _train

    def write():
        Path(f"{record}.rank{rank}.json").write_text(json.dumps(rec))
    atexit.register(write)
    train.main(argv)


if __name__ == "__main__" and sys.argv[1:2] == ["--cli"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4:])
elif __name__ == "__main__" and sys.argv[1:2] == ["--jax-slices"]:
    _jax_slices_main(json.loads(sys.argv[2]))
