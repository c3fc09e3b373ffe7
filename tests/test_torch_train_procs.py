"""The train CLI over a real process group (``launch/train.py --procs N``),
one CPU process a data rank on a gloo group, at the smoke config in f32.

Each run is the CLI's own worker path (``train.main(... --worker r
init)``): this file run as a script (``--cli``) sets the smoke config to
f32 with no remat and AdamW's ``eps`` to 1e-3 (``tests/test_torch_train.py``
says why the default 1e-8 cannot be held across packages) and hands the
rest of its arguments to the CLI. The processes start through
``launch/mesh.spawn_shards`` with one time limit, rank 0's output and every
process's ``--log`` kept in the run's directory. Every run is held to the
stacked CLI run of the same flags (the same ranks stacked on one device,
in this process) and, where JAX's pieces run here, to the reference of
``tests/test_torch_train.py``: per-rank ``jax.value_and_grad``, JAX's
cascades under ``vmap`` and JAX's AdamW, from the port's seeded weights.
Tolerance ``TOL`` (1e-5) on the losses and relative per leaf, as there: the
processes sum in another order (gloo's all-reduce, each process's backward,
the FSDP shards' norm), never bitwise; ``--donate`` is bitwise against the
functional run over the same processes.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 240        # seconds, every process of a spawn
EPS = 1e-3
LR, WARMUP = 1e-3, 2
BASE = ["--arch", "qwen1-5-0-5b", "--smoke", "--device", "cpu", "--batch",
        "8", "--seq", "16", "--lr", str(LR), "--warmup", str(WARMUP)]
LOSS_LINE = re.compile(r"^steps (\d+)\.\.(\d+): loss (\S+) -> (\S+)$", re.M)
EAGER = ["--merge-topology", "chip:2,host:2", "--steps", "3",
         "--ckpt-every", "3"]
DEFERRED = ["--merge-topology", "chip:2,host:2:defer", "--merge-defer", "2",
            "--merge-overlap", "--steps", "5", "--ckpt-every", "5"]
IMPLICIT = ["--steps", "3", "--ckpt-every", "3"]
XLSTM = ["--merge-topology", "chip:2", "--steps", "2", "--ckpt-every", "2"]
AUTO = ["--merge-topology", "chip:2,host:2:defer", "--merge-defer", "auto",
        "--steps", "2", "--ckpt-every", "100"]


def patch_cli(train) -> None:
    """The CLI at the f32 smoke config without remat, AdamW ``eps`` 1e-3."""
    from repro_torch.optim import optimizers as topt
    smoke = train.get_smoke_config
    train.get_smoke_config = lambda arch: dataclasses.replace(
        smoke(arch), dtype="float32", remat="none")
    train.make_optimizer = lambda cfg, sched: topt.adamw(sched, eps=EPS)


@contextlib.contextmanager
def patched_cli():
    from repro_torch.launch import train
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "get_smoke_config", train.get_smoke_config)
        mp.setattr(train, "make_optimizer", train.make_optimizer)
        patch_cli(train)
        yield train


def run_procs(argv: list, procs: int, work: Path, during=None) -> str:
    """The CLI's workers of ``argv`` over ``procs`` gloo processes (this
    file as ``--cli``), its checkpoints in ``work/ck`` unless ``argv``
    names a directory, the driver's log ``work/log.jsonl`` (rank r's with
    ``.rank{r}``) -> rank 0's output."""
    from repro_torch.launch.mesh import spawn_shards
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    extra = [] if "--ckpt-dir" in argv else ["--ckpt-dir", str(work / "ck")]
    extra += [] if "--log" in argv else ["--log", str(work / "log.jsonl")]
    init = work / "init"
    if init.exists():
        init.unlink()
    spawn_shards(lambda r: [sys.executable, __file__, "--cli", *argv, *extra,
                            "--procs", str(procs), "--worker", str(r),
                            f"file://{init}"],
                 procs, work, WORKER_TIMEOUT, env=env, during=during)
    return (work / "rank0.log").read_text()


def run_stacked(argv: list, ckpt_dir: Path) -> tuple[str, object]:
    """The stacked CLI run of ``argv`` in this process -> (its output,
    its ``TrainResult``)."""
    out = io.StringIO()
    with patched_cli() as train, contextlib.redirect_stdout(out):
        res = train.main(argv + ["--ckpt-dir", str(ckpt_dir)])
    return out.getvalue(), res


def events(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def step_losses(path: Path) -> list:
    return [e["loss"] for e in events(path) if e["event"] == "step"]


def flat_ckpt(d: Path) -> dict:
    """The last committed checkpoint's leaves as f32 numpy (bf16 and
    integers too)."""
    from repro_torch import checkpoint as ckpt
    raw, _ = ckpt.load_raw(str(d))
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in raw.items()}


def port_init(arch: str = "qwen1-5-0-5b"):
    """The CLI's seeded f32 weights, its data config and its batches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import data_config_for
    from repro_torch.models.registry import build_model
    with patched_cli() as train:
        cfg = train.get_smoke_config(arch)
    model = build_model(cfg, device="cpu", seed=0)
    dcfg = data_config_for(cfg, ShapeConfig("cli", 16, 8, "train"), seed=0)
    return model.params(), dcfg


def jax_pair(tmp: Path, params):
    """``test_torch_train.Pair`` at f32 with JAX's weights replaced by the
    port's seeded ones (through a checkpoint, JAX's own restore)."""
    from repro import checkpoint as jckpt
    from repro_torch import checkpoint as ckpt
    from test_torch_train import Pair
    pair = Pair("float32")
    ckpt.save(str(tmp), 0, params)
    pair.jparams, _ = jckpt.restore(str(tmp), pair.jparams)
    return pair


def jax_eager_run(pair, batches, steps_: int, dp: int):
    """JAX's eager data-parallel steps: the mean of the ranks' gradients
    through JAX's AdamW -> (losses, flat params)."""
    import jax
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from test_torch_train import _flat_jax
    opt = jopt.adamw(jsched.warmup_cosine(LR, WARMUP, steps_), eps=EPS)
    params, state = pair.jparams, opt.init(pair.jparams)
    losses = []
    for b in batches:
        loss, grads = pair.jax_rank_grads(params, b, dp)
        mean = jax.tree.map(lambda g: g.sum(0) / dp, grads)
        params, state, _ = opt.step(params, mean, state)
        losses.append(float(loss))
    return losses, _flat_jax(params)


def close(got: dict, want: dict, what: str, keys=None):
    from test_torch_train import TOL, _assert_trees_close
    keys = sorted(want) if keys is None else keys
    _assert_trees_close({k: got[k] for k in keys}, {k: want[k] for k in keys},
                        atol=TOL, what=what)


def _params(flat: dict) -> dict:
    return {k[len("params/"):]: v for k, v in flat.items()
            if k.startswith("params/")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file: each over processes, and stacked."""
    root = tmp_path_factory.mktemp("procs")
    out = {}
    for name, argv, procs in (("eager", EAGER, 4), ("deferred", DEFERRED, 4),
                              ("implicit", IMPLICIT, 2),
                              ("donate", EAGER + ["--donate"], 4),
                              ("xlstm", XLSTM, 2), ("auto", AUTO, 4)):
        full = (["--arch", "xlstm-125m"] + BASE[2:] + argv if name == "xlstm"
                else BASE + argv)
        text = run_procs(full, procs, root / name)
        out[name] = {"text": text, "dir": root / name}
        if name not in ("donate", "auto"):
            stext, sres = run_stacked(full, root / f"{name}_stacked")
            out[name].update(stacked_text=stext, stacked=sres,
                             stacked_dir=root / f"{name}_stacked")
    return out


def _held_to_stacked(run: dict, what: str):
    from test_torch_train import TOL
    got = step_losses(run["dir"] / "log.jsonl")
    want = [e["loss"] for e in run["stacked"].events if e["event"] == "step"]
    np.testing.assert_allclose(got, want, rtol=TOL, err_msg=what)
    mine, theirs = flat_ckpt(run["dir"] / "ck"), flat_ckpt(run["stacked_dir"])
    assert sorted(mine) == sorted(theirs)
    close(mine, theirs, f"{what} vs stacked")
    return got, mine


def test_eager_over_four_processes_equals_stacked_and_jax(runs, tmp_path):
    losses, mine = _held_to_stacked(runs["eager"], "eager")
    m = LOSS_LINE.search(runs["eager"]["text"])
    assert m and m.group(1, 2) == ("0", "3")
    params, dcfg = port_init()
    from repro_torch.data.pipeline import batch_at
    from test_torch_train import TOL
    jl, jp = jax_eager_run(jax_pair(tmp_path, params),
                           [batch_at(dcfg, t) for t in range(3)], 3, 4)
    np.testing.assert_allclose(losses, jl, rtol=TOL)
    close(_params(mine), jp, "eager vs jax")


def test_deferred_overlapped_over_four_processes_equals_stacked_and_jax(
        runs, tmp_path):
    run = runs["deferred"]
    text = run["text"]
    assert text.count("merge-defer schedule: host: K=2 (period 2)") == 1
    assert "final flush: settled a 1-step partial cycle" in text
    losses, mine = _held_to_stacked(run, "deferred")
    assert any(np.abs(v).max() > 0 for k, v in mine.items()
               if k.startswith("defer/pending/0/"))   # live mass saved
    from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro_torch.data.pipeline import batch_at
    from test_torch_train import TOL, _jax_deferred_run
    params, dcfg = port_init()
    pair = jax_pair(tmp_path, params)
    opt = jopt.adamw(jsched.warmup_cosine(LR, WARMUP, 5), eps=EPS)
    hist, _ = _jax_deferred_run(
        pair, "chip:2,host:2:defer",
        JDeferSchedule(("host",), (2,), overlap=True),
        [batch_at(dcfg, t) for t in range(5)], opt)
    np.testing.assert_allclose(losses, [h[0] for h in hist], rtol=TOL)
    close(_params(mine), hist[-1][1], "deferred step 5 vs jax")


def test_implicit_step_over_two_processes_equals_stacked_and_jax(
        runs, tmp_path):
    losses, mine = _held_to_stacked(runs["implicit"], "implicit")
    from repro_torch.data.pipeline import batch_at
    from test_torch_train import TOL
    params, dcfg = port_init()
    jl, jp = jax_eager_run(jax_pair(tmp_path, params),
                           [batch_at(dcfg, t) for t in range(3)], 3, 1)
    np.testing.assert_allclose(losses, jl, rtol=TOL)
    close(_params(mine), jp, "implicit vs jax")
    # the moments were split by the FSDP rule and saved whole
    assert mine["opt/mu/embed/table"].shape == \
        mine["params/embed/table"].shape


def test_xlstm_over_two_processes_equals_stacked(runs):
    _held_to_stacked(runs["xlstm"], "xlstm")


def test_donating_run_is_the_functional_run_bit_for_bit(runs):
    a, b = flat_ckpt(runs["eager"]["dir"] / "ck"), \
        flat_ckpt(runs["donate"]["dir"] / "ck")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert step_losses(runs["eager"]["dir"] / "log.jsonl") == \
        step_losses(runs["donate"]["dir"] / "log.jsonl")


def test_solved_schedule_is_every_process_s(runs):
    """``--merge-defer auto`` times each level over the step's own mesh
    axis and takes each time's largest over the processes: every process
    logs the schedule rank 0 prints, and the rates name the backend."""
    run = runs["auto"]
    text = run["text"]
    assert "over gloo (4 processes)" in text
    m = re.search(r"^merge-defer schedule: (.*)$", text, re.M)
    assert m
    for r in range(4):
        log = run["dir"] / ("log.jsonl" + (f".rank{r}" if r else ""))
        got = [e["schedule"] for e in events(log)
               if e["event"] == "defer_schedule"]
        assert got == [m.group(1)], (r, got)


def test_every_process_logs_its_own_events(runs):
    """Rank 0 logs to ``--log``, rank r to ``--log`` + ``.rank{r}``; the
    replicated loss is every process's."""
    d = runs["eager"]["dir"]
    want = step_losses(d / "log.jsonl")
    assert len(want) == 3
    for r in range(1, 4):
        assert step_losses(d / f"log.jsonl.rank{r}") == want
        starts = [e for e in events(d / f"log.jsonl.rank{r}")
                  if e["event"] == "run_start"]
        assert len(starts) == 1 and starts[0]["pid"] > 0


if __name__ == "__main__" and sys.argv[1:2] == ["--cli"]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as _train
    patch_cli(_train)
    _train.main(sys.argv[2:])
