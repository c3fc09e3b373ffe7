"""The pieces under the train CLI over a process group, on gloo CPU
processes: checkpoints of DTensor leaves, the driver's agreement and its
straggler host, ``TrainDriver.resume`` of a deferred checkpoint written
over 4 processes (verbatim onto 4, resolved onto 2 against JAX's
``elastic_restore``), the CLI's refusals, its output lines, and a signal
to the command reaching every worker.

The group's work is this file run as a script (``--api-worker`` over 4
processes, ``--resolve-worker`` over 2), each process writing what it
found to ``rank{r}.npz`` / ``rank{r}.json`` in the spawn's directory; the
f32 smoke config and AdamW ``eps`` 1e-3 are ``tests/test_torch_train_procs.py``'s.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train_procs import BASE as BASE_ARGS

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 240
DEFER = ["--merge-topology", "chip:2,host:2:defer", "--merge-defer", "2",
         "--steps", "3", "--ckpt-every", "3"]
ONTO = ["--merge-topology", "chip:2:defer", "--merge-defer", "2", "--steps",
        "3"]


def _args(argv: list, procs: int):
    from repro_torch.launch import train
    return train.parse_args(BASE_ARGS + argv + ["--procs", str(procs)])


def _offset(x) -> tuple:
    """Where DTensor ``x``'s local shard starts in its global array."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, list(x.placements))[1]


def _flat_whole(tree) -> dict:
    """Every leaf's global array as numpy, gathered over the group."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    return {k: (v.full_tensor() if isinstance(v, DTensor) else
                torch.as_tensor(v)).detach().float().numpy()
            for k, v in _flatten_with_paths(tree)}


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def _api_worker(rank: int, init: str, work: str) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import train
    from repro_torch.runtime import DriverConfig, TrainDriver
    from test_torch_train_procs import patch_cli
    torch.set_num_threads(1)
    mesh = pmesh.init_train_mesh("gloo", "cpu", init_method=init, rank=rank,
                                 world_size=4)
    work = Path(work)
    out, found = {}, {}
    g = np.random.default_rng(7)
    w = torch.from_numpy(g.standard_normal((6, 8), dtype=np.float32))
    pend = torch.from_numpy(g.standard_normal((4, 6, 8), dtype=np.float32))

    def dt(x, placements):
        return DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                                  run_check=False).redistribute(mesh,
                                                                placements)
    fsdp, stack, rep = ([Shard(1), Replicate()], [Shard(0), Replicate()],
                        [Replicate(), Replicate()])
    tree = {"w": dt(w, fsdp), "pending": dt(pend, stack),
            "count": dt(torch.tensor(5, dtype=torch.int32), rep)}
    d = str(work / "dt")
    ckpt.save(d, 1, tree, extras={"rank_saved": rank})
    found["saved_before_return"] = ckpt.latest_step(d) == 1
    like = {k: dt(torch.zeros(v.shape, dtype=v.dtype), v.placements)
            for k, v in tree.items()}
    got, _ = ckpt.restore(d, like)
    for k, v in got.items():
        out[f"restored/{k}"] = v.to_local().numpy()
        found[f"placements/{k}"] = v.placements == like[k].placements
    targets = {k: (mesh, tuple(v.placements)) for k, v in tree.items()}
    # the targets as layouts, the like's leaves only shapes
    got2, _ = ckpt.restore_resharded(d, {k: torch.empty(v.shape,
                                                        device="meta")
                                         for k, v in like.items()}, targets)
    found["resharded_equal"] = all(
        torch.equal(got2[k].to_local(), got[k].to_local()) for k in got)
    bad = dict(like, pending=dt(torch.zeros(8, 6, 8), stack))
    try:
        ckpt.restore(d, bad)
        found["shape_error"] = ""
    except ValueError as e:
        found["shape_error"] = str(e)
    # the driver: an agreed flag, and a straggler's host
    drv = TrainDriver(DriverConfig(ckpt_dir=str(work / "none"),
                                   ckpt_every=1000), lambda s, b: (s, {}),
                      lambda i: None)
    found["agreed_one"] = drv._agreed(rank == 2)
    found["agreed_none"] = drv._agreed(False)

    def slow(s, b):
        time.sleep(0.2 if b == 9 else 0.005)
        return s, {"loss": torch.tensor(1.0)}
    drv = TrainDriver(DriverConfig(ckpt_dir=str(work / "none"),
                                   ckpt_every=1000), slow, lambda i: i)
    drv.run({}, 0, 10)
    found["straggler_hosts"] = [e["host"] for e in drv.events
                                if e["event"] == "straggler"]

    # a poisoned step rewinds the DTensor state to the last checkpoint
    def poisoned(s, b):
        w = s["w"] + 1.0
        loss = torch.tensor(float("nan") if b == 2 else 1.0)
        return {"w": w}, {"loss": loss}
    drv = TrainDriver(DriverConfig(ckpt_dir=str(work / "nan"), ckpt_every=1,
                                   restore_on_nan=True), poisoned,
                      lambda i: i)
    after, _ = drv.run({"w": tree["w"]}, 0, 4)
    found["nan_restore"] = [e["event"] for e in drv.events
                            if e["event"] in ("nan_rollback", "restore")]
    found["nan_final"] = torch.equal(after["w"].to_local(),
                                     tree["w"].to_local() + 1.0 + 1.0 + 1.0)
    found["nan_layout"] = after["w"].placements == tree["w"].placements

    def fails(s, b):
        raise RuntimeError("a transient fault")
    drv = TrainDriver(DriverConfig(ckpt_dir=str(work / "none"),
                                   ckpt_every=1000, retry_backoff_s=0.0),
                      fails, lambda i: i)
    try:
        drv.run({}, 0, 3)
        found["raised"] = False
    except RuntimeError:
        found["raised"] = True
    found["step_errors"] = sum(e["event"] == "step_error"
                               for e in drv.events)

    # a signal to rank 1 alone while the step-2 save runs (after that
    # boundary's agreement): every process saves step 3 and stops there;
    # the steps' all-reduces hang if one process stops alone
    import torch.distributed as dist

    def reduced(s, b):
        dist.all_reduce(torch.ones(1))
        return {"w": s["w"] + 1.0}, {"loss": torch.tensor(1.0)}

    def mid_save(step):
        if rank == 1 and step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return {}
    drv = TrainDriver(DriverConfig(ckpt_dir=str(work / "late"),
                                   ckpt_every=2), reduced, lambda i: i)
    _, end = drv.run({"w": tree["w"]}, 0, 6, save_extras=mid_save)
    found["late_signal"] = [end, [e["step"] for e in drv.events
                                  if e["event"] == "preempted_exit"],
                            ckpt.latest_step(str(work / "late"))]
    # a deferred CLI state over the mesh: 3 steps, the checkpoint at 3
    patch_cli(train)
    t = train.build(_args(DEFER, 4), mesh)
    state, t.state = t.state, None
    root = str(work / "ck")
    TrainDriver(DriverConfig(ckpt_dir=root, ckpt_every=3),
                lambda s, b: t.step_fn(s, train.steps.shard_batch(b, mesh)),
                lambda i: train.batch_at(t.dcfg, i),
                defer_step=t.deferred).run(state, 0, 3)
    # a concrete stacked state (a [4, ...] cascade of seeded values) laid
    # out by the rules: each process keeps its slices
    from repro_torch.configs.base import ShapeConfig
    t0 = train.build(train.parse_args(BASE_ARGS + DEFER), None)
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    gen = torch.Generator().manual_seed(3)
    stacked = dict(t0.state)
    stacked["defer"] = {"t": torch.tensor(1, dtype=torch.int32),
                        "pending": tuple(pytree.tree_map(
                            lambda x: torch.randn(x.shape, generator=gen), p)
                            for p in t0.state["defer"]["pending"])}
    laid = train.steps.lay_out_state(stacked, t0.cfg,
                                     ShapeConfig("cli", 16, 8, "train"), mesh)
    want = [x for _, x in _flatten_with_paths(stacked)]
    got = [x for _, x in _flatten_with_paths(laid)]
    assert [k for k, _ in _flatten_with_paths(laid)] == \
        [k for k, _ in _flatten_with_paths(stacked)]
    found["laid_out"] = [[str(list(g.placements)),
                          list(g.to_local().shape), list(w.shape)]
                         for g, w in zip(got, want)]
    found["laid_slices_equal"] = all(
        torch.equal(g.to_local(), torch.as_tensor(w)[tuple(
            slice(o, o + n) for o, n in zip(
                _offset(g), g.to_local().shape))])
        for g, w in zip(got, want))
    # resumed verbatim onto the same 4 processes
    t2 = train.build(_args(DEFER, 4), mesh)
    # what a durable checkpoint of the mesh's deferred step must cover
    spec = t2.deferred.volatile_spec(t2.state["params"])
    found["volatile"] = [[list(x.shape), str(list(x.placements)),
                          list(x.to_local().shape), x.to_local().is_meta]
                         for x in pytree.tree_leaves(spec["pending"])]
    back, start, report = TrainDriver(
        DriverConfig(ckpt_dir=root), t2.step_fn, None,
        defer_step=t2.deferred).resume(t2.state)
    found["verbatim"] = [report.action, start]
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    for k, v in _flatten_with_paths(back):
        out[f"verbatim/{k}"] = (v.to_local() if isinstance(v, DTensor)
                                else v).numpy()
        if isinstance(v, DTensor) and isinstance(v.placements[0], Shard):
            found[f"verbatim_split/{k}"] = v.placements[0].dim
    np.savez(work / f"rank{rank}.npz", **out)
    (work / f"rank{rank}.json").write_text(json.dumps(found))
    pmesh.shutdown()


def _resolve_worker(rank: int, init: str, work: str, ckpt_dir: str) -> None:
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import train
    from repro_torch.runtime import DriverConfig, TrainDriver
    from test_torch_train_procs import patch_cli
    torch.set_num_threads(1)
    mesh = pmesh.init_train_mesh("gloo", "cpu", init_method=init, rank=rank,
                                 world_size=2)
    patch_cli(train)
    t = train.build(_args(ONTO, 2), mesh)
    state, start, report = TrainDriver(
        DriverConfig(ckpt_dir=ckpt_dir), t.step_fn, None,
        defer_step=t.deferred).resume(t.state)
    found = {"report": report.as_dict(), "start": start,
             "defer_t": int(state["defer"]["t"]),
             "pending_shape": list(state["defer"]["pending"][0][
                 "embed"]["table"].shape)}
    opt = state["opt"]
    flat = {f"{name}/{k}": v for name, tree in
            (("params", state["params"]), ("mu", opt.mu), ("nu", opt.nu))
            for k, v in _flat_whole(tree).items()}
    flat["count"] = np.asarray(int(getattr(opt.step, "full_tensor",
                                           lambda: opt.step)()))
    if rank == 0:
        np.savez(Path(work) / "resolved.npz", **flat)
        (Path(work) / "resolved.json").write_text(json.dumps(found))
    pmesh.shutdown()


def _spawn(flag: str, n: int, work: Path, *extra) -> list:
    from repro_torch.launch.mesh import spawn_shards
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    work.mkdir(parents=True, exist_ok=True)
    spawn_shards(lambda r: [sys.executable, __file__, flag, str(r),
                            f"file://{work / 'init'}", str(work), *extra],
                 n, work, WORKER_TIMEOUT, env=env)


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    work = tmp_path_factory.mktemp("api")
    _spawn("--api-worker", 4, work)
    ranks = [(dict(np.load(work / f"rank{r}.npz")),
              json.loads((work / f"rank{r}.json").read_text()))
             for r in range(4)]
    return work, ranks


# ---------------------------------------------------------------------------
# checkpoints of DTensor leaves
# ---------------------------------------------------------------------------


def test_save_of_dtensor_leaves_writes_the_global_arrays(api):
    from repro_torch import checkpoint as ckpt
    work, ranks = api
    raw, manifest = ckpt.load_raw(str(work / "dt"))
    g = np.random.default_rng(7)
    w = g.standard_normal((6, 8), dtype=np.float32)
    pend = g.standard_normal((4, 6, 8), dtype=np.float32)
    np.testing.assert_array_equal(raw["w"], w)
    np.testing.assert_array_equal(raw["pending"], pend)
    assert raw["count"].dtype == np.int32 and int(raw["count"]) == 5
    assert manifest["extras"] == {"rank_saved": 0}      # rank 0 wrote
    assert all(found["saved_before_return"] for _, found in ranks)


@pytest.mark.parametrize("leaf", ["w", "pending", "count"])
def test_restore_gives_each_process_its_slice_bit_for_bit(api, leaf):
    from repro_torch import checkpoint as ckpt
    work, ranks = api
    raw, _ = ckpt.load_raw(str(work / "dt"))
    for r, (out, found) in enumerate(ranks):
        want = {"w": raw["w"][:, 2 * r:2 * r + 2],
                "pending": raw["pending"][r:r + 1],
                "count": raw["count"]}[leaf]
        np.testing.assert_array_equal(out[f"restored/{leaf}"], want)
        assert found[f"placements/{leaf}"]
        assert found["resharded_equal"]


def test_a_global_shape_unlike_the_target_raises_naming_the_leaf(api):
    _, ranks = api
    for _, found in ranks:
        msg = found["shape_error"]
        assert "'pending'" in msg and "(4, 6, 8)" in msg and "(8, 6, 8)" \
            in msg and "TrainDriver.resume" in msg


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_a_damaged_member_fails_its_crc(tmp_path, damage):
    """A member's bytes are held to its CRC on every read: one flipped bit,
    or a file cut short, raises instead of restoring."""
    from repro_torch import checkpoint as ckpt
    g = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(g.standard_normal((64, 32),
                                                    dtype=np.float32)),
            "b": torch.arange(10, dtype=torch.int32)}
    path = Path(ckpt.save(str(tmp_path), 1, tree)) / "arrays.npz"
    raw, _ = ckpt.load_raw(str(tmp_path))
    np.testing.assert_array_equal(raw["a"], tree["a"].numpy())
    data = bytearray(path.read_bytes())
    at = data.find(tree["a"].numpy().tobytes()[:64]) + 1000
    if damage == "flip":
        data[at] ^= 0x10
    else:
        data = data[:at]
    path.write_bytes(bytes(data))
    with pytest.raises((ValueError, zipfile.BadZipFile)):
        ckpt.load_raw(str(tmp_path))


# ---------------------------------------------------------------------------
# the driver over a group
# ---------------------------------------------------------------------------


def test_a_flag_of_one_process_is_every_process_s(api):
    _, ranks = api
    assert all(f["agreed_one"] and not f["agreed_none"] for _, f in ranks)


def test_a_signal_during_a_save_stops_every_process_at_the_next_step(api):
    """SIGTERM to rank 1 alone inside the step-2 save (``ckpt_every`` 2),
    after that boundary's agreement: no process stops at 2; every one
    saves step 3 and stops there."""
    _, ranks = api
    for _, found in ranks:
        assert found["late_signal"] == [3, [3], 3]


def test_a_straggler_is_logged_with_its_process_s_rank(api):
    _, ranks = api
    for r, (_, found) in enumerate(ranks):
        assert found["straggler_hosts"] == [r]


def test_a_poisoned_step_restores_the_dtensor_state(api):
    """``restore_on_nan`` over a group: the step-2 checkpoint restored onto
    the DTensor state's own layout, the batch skipped, one more step."""
    _, ranks = api
    for _, found in ranks:
        assert found["nan_restore"] == ["nan_rollback", "restore"]
        assert found["nan_final"] and found["nan_layout"]


def test_a_step_that_raises_is_not_retried_over_a_group(api):
    """One process's retry would desynchronise the group's collectives:
    the first error ends the run (``max_retries`` 3 retries it alone)."""
    _, ranks = api
    for _, found in ranks:
        assert found["raised"] and found["step_errors"] == 1


def test_a_concrete_state_is_laid_out_by_jax_s_rules(api):
    """``steps.lay_out_state`` of a stacked state: parameters and moments
    split by the FSDP rule (some leaves over ``data``), each pending
    ``Shard(0)`` a row a process, the counters replicated; every shard is
    its slice of the stacked value bit for bit."""
    _, ranks = api
    for r, (_, found) in enumerate(ranks):
        assert found["laid_slices_equal"]
        laid = found["laid_out"]
        pend = [x for x in laid if x[2][:1] == [4] and len(x[2]) > 1
                and x[1][0] == 1]
        assert pend and all(x[0].startswith("[Shard(dim=0)") for x in pend)
        assert any("Shard(dim=1)" in x[0] for x in laid)       # FSDP
        assert all(x[0] == "[Replicate(), Replicate()]" for x in laid
                   if x[2] == [])                              # counters


def test_volatile_spec_of_the_mesh_step_is_its_pendings_layout(api):
    """``defer_state_spec`` on a mesh: each pending a meta DTensor of the
    global ``[4, ...]`` shape, ``Shard(0)`` over ``data``, a ``[1, ...]``
    slice a process."""
    _, ranks = api
    for _, found in ranks:
        assert found["volatile"]
        for shape, placements, local, meta in found["volatile"]:
            assert shape[0] == 4 and local == [1] + shape[1:] and meta
            assert placements == "[Shard(dim=0), Replicate()]"


def test_verbatim_resume_over_four_processes_is_the_file_bit_for_bit(api):
    from repro_torch import checkpoint as ckpt
    work, ranks = api
    raw, manifest = ckpt.load_raw(str(work / "ck"))
    assert manifest["extras"]["defer_t"] == 3 and \
        manifest["extras"]["defer"]["dp"] == 4
    for r, (out, found) in enumerate(ranks):
        assert found["verbatim"] == ["verbatim", 3]
        keys = [k[len("verbatim/"):] for k in out if k.startswith("verbatim/")]
        assert sorted(keys) == sorted(raw)
        split = {k[len("verbatim_split/"):]: d for k, d in found.items()
                 if k.startswith("verbatim_split/")}
        assert {k for k in split if k.startswith("defer/pending")} == \
            {k for k in keys if k.startswith("defer/pending")}
        assert any(k.startswith("params/") for k in split)     # FSDP
        for k in keys:
            got, want = out[f"verbatim/{k}"], np.asarray(raw[k])
            if k in split:
                want = np.split(want, 4, axis=split[k])[r]
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_resolved_resume_onto_two_processes_equals_jax(api, tmp_path):
    """The step-3 checkpoint (a pending a rank of 4, K = 2 mid-cycle) onto
    chip:2:defer over 2 processes: the outstanding step settled from the
    old stacks on each process, folded into the FSDP-split parameters and
    AdamW, fresh defer state of 2 ranks; against JAX's ``elastic_restore``
    of the same file (the step count bit for bit, f32 to 1e-5)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import defer_state as jdefer_state
    from repro.core import merge_functions as jmf
    from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
    from repro.core.merge_plan import MergePlan as JMergePlan
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro.runtime import elastic as jelastic
    from test_torch_elastic import _close, _flat_jax
    from test_torch_train_procs import EPS, LR, WARMUP, jax_pair, port_init
    work, _ = api
    out = tmp_path / "resolve"
    _spawn("--resolve-worker", 2, out, str(work / "ck"))
    got = dict(np.load(out / "resolved.npz"))
    found = json.loads((out / "resolved.json").read_text())
    assert found["report"]["action"] == "resolved"
    assert found["report"]["flushed_steps"] == 1 and found["start"] == 3
    assert found["defer_t"] == 0 and found["pending_shape"][0] == 2

    class Shim:
        plan, dp = JMergePlan.parse("chip:2:defer"), 2
        sched = JDeferSchedule(("chip",), (2,))

        def durability_manifest(self):
            return jdefer_state.defer_manifest(self.plan, self.sched,
                                               self.dp, jmf.ADD, (1,), "mean")

        def init_defer_state(self, params):
            spec = jdefer_state.defer_state_spec(
                jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape,
                                                            p.dtype),
                             params), 1, self.dp, False)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    params, _ = port_init()
    jparams = jax_pair(tmp_path / "w", params).jparams
    jadamw = jopt.adamw(jsched.warmup_cosine(LR, WARMUP, 3), eps=EPS)
    shim = Shim()
    jlike = {"params": jparams, "opt": jadamw.init(jparams),
             "defer": shim.init_defer_state(jparams)}
    want, _, jreport = jelastic.elastic_restore(
        str(work / "ck"), jlike, defer_step=shim, optimizer=jadamw)
    assert jreport.action == "resolved" and jreport.flushed_steps == 1
    assert int(got["count"]) == int(want["opt"].step)
    mine = {k: v for k, v in got.items() if k != "count"}
    assert _close(mine, _flat_jax(want))


# ---------------------------------------------------------------------------
# the CLI: refusals, its lines, a signal to the command
# ---------------------------------------------------------------------------


BAD = [
    (["--procs", "1"], "--procs needs at least 2 processes"),
    (["--backend", "gloo"], "--backend is the process group's: add --procs"),
    (["--procs", "2", "--backend", "nccl"], "--backend nccl runs on the card"),
]


@pytest.mark.parametrize("extra,msg", BAD, ids=["one", "no-procs", "nccl"])
def test_parse_refusals(extra, msg, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.parse_args(BASE_ARGS + extra)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("extra,msg", [
    (["--model-ranks", "3", "--procs", "4"],
     "--model-ranks 3 does not divide --procs 4"),
    (["--model-ranks", "2", "--procs", "4", "--merge-topology", "chip:2"],
     "explicit hierarchical gradient merge needs the non-merge mesh axes "
     "to be trivial, but ['model'] have size > 1"),
    (["--arch", "qwen3-moe-235b", "--model-ranks", "3", "--procs", "6"],
     "--model-ranks 3 does not split qwen3-moe-235b-smoke's 4 experts"),
    (["--model-ranks", "2"], "has no MoE layers"),
    (["--arch", "xlstm-125m", "--model-ranks", "2", "--procs", "4"],
     "the model axis over processes runs the decoder families"),
    (["--merge-group-size", "3", "--procs", "4"],
     "--merge-group-size 3 does not divide the data axis (4 devices)"),
    (["--batch", "6", "--procs", "4"],
     "--batch 6 must be divisible by --procs 4"),
    (["--merge-topology", "chip:2,host:2", "--procs", "2"],
     "--merge-topology: "),
    (["--procs", "4", "--microbatches", "4"],
     "which --microbatches 4 does not divide"),
    (["--merge-group-size", "2"],
     "--merge-group-size 2 does not divide the data axis (1 devices)"),
], ids=["model-ranks", "model-ranks-merge", "model-ranks-experts",
        "model-ranks-dense", "model-ranks-family", "group-size", "batch", "topology",
        "microbatches", "group-size-stacked"])
def test_flag_refusals(extra, msg):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.check_flags(train.parse_args(BASE_ARGS + extra))
    assert msg in str(e.value)


def _cli(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *flags], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


CLI = ["--arch", "qwen1-5-0-5b", "--smoke", "--device", "cpu", "--procs", "4",
       "--batch", "8", "--seq", "16", "--steps", "5", "--merge-topology",
       "chip:2,host:2:defer", "--merge-defer", "2", "--ckpt-every", "2"]


def test_cli_over_processes_prints_jax_s_lines_once_and_resumes(tmp_path):
    first = _cli(*CLI, "--ckpt-dir", str(tmp_path))
    assert first.returncode == 0, first.stderr[-3000:]
    out = first.stdout
    assert out.count("merge-defer schedule: host: K=2 (period 2)") == 1
    assert out.count("final flush: settled a 1-step partial cycle") == 1
    assert len(re.findall(r"^steps 0\.\.5: loss \S+ -> \S+$", out,
                          re.M)) == 1
    second = _cli(*CLI, "--ckpt-dir", str(tmp_path))
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count(
        "resumed from checkpoint step 4 -> start 4") == 1


def test_cli_over_processes_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    flags = [f for f in CLI if f not in ("--device", "cpu")]
    out = _cli(*flags, "--ckpt-dir", str(tmp_path), timeout=60)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_a_signal_to_the_command_reaches_every_worker(tmp_path):
    """SIGTERM to the command (the spawner) is passed on to each worker:
    all of them save the same step and exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    log = tmp_path / "log.jsonl"
    flags = ["--arch", "qwen1-5-0-5b", "--smoke", "--device", "cpu",
             "--procs", "2", "--batch", "8", "--seq", "16", "--steps", "50",
             "--merge-topology", "chip:2", "--ckpt-every", "100",
             "--ckpt-dir", str(tmp_path / "ck"), "--log", str(log)]
    p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                          *flags], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    logs = [log, Path(f"{log}.rank1")]
    deadline = time.monotonic() + 200
    while not all(x.exists() and '"run_start"' in x.read_text()
                  for x in logs):
        assert time.monotonic() < deadline and p.poll() is None
        time.sleep(0.01)
    p.send_signal(signal.SIGTERM)
    _, err = p.communicate(timeout=200)
    assert p.returncode == 0, err[-3000:]
    exits = []
    for x in logs:
        ev = [json.loads(ln) for ln in x.read_text().splitlines()]
        exits.append([e["step"] for e in ev if e["event"] == "preempted_exit"])
    assert len(exits[0]) == 1 and exits[0] == exits[1]
    from repro_torch import checkpoint as ckpt
    assert ckpt.latest_step(str(tmp_path / "ck")) == exits[0][0] < 50


def test_nccl_train_mesh_with_more_processes_than_cards_raises_first():
    from repro_torch.launch import mesh as pmesh
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="one card a process"):
        pmesh.init_train_mesh("nccl", rank=0, world_size=cards + 1,
                              init_method="file:///nonexistent")
    assert not dist.is_initialized()


if __name__ == "__main__" and sys.argv[1] in ("--api-worker",
                                              "--resolve-worker"):
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    fn = _api_worker if sys.argv[1] == "--api-worker" else _resolve_worker
    fn(int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:])
