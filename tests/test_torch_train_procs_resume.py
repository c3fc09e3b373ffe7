"""Preemption and resume of the train CLI over a process group, and its
checkpoints across layouts and packages (gloo CPU processes, the f32 smoke
config of ``tests/test_torch_train_procs.py``, whose helpers run the CLI).

* A SIGTERM that reaches rank 1's worker alone, before its first step
  ends: every process agrees on it at the step boundary, saves step 1 (mid
  cycle: live pending mass in the checkpoint), logs ``preempted_exit`` and
  exits 0; the same command again resumes from step 1, and its final
  checkpoint is bit for bit that of an uninterrupted run over the same
  processes.
* A checkpoint written over 4 processes loads in the JAX package
  (``load_raw``, ``restore``), every leaf bit for bit the port's.
* A stacked checkpoint resumes over 4 processes, and a 4-process one in
  the stacked CLI; each resumed run is within ``TOL`` of the
  uninterrupted run of the other layout.
"""

import os
import shutil
import signal
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch import checkpoint as ckpt
from test_torch_train_procs import (BASE, events, flat_ckpt, run_procs,
                                    run_stacked)

FLAGS = BASE + ["--merge-topology", "chip:2,host:2:defer", "--merge-defer",
                "2", "--steps", "4", "--ckpt-every", "4"]


def _signal_rank1_at_start(work: Path):
    """Beside the spawn: SIGTERM rank 1's worker once its driver has
    started (its ``run_start`` record names the process) -> its pid."""
    def during():
        log = work / "log.jsonl.rank1"
        deadline = time.monotonic() + 200
        while time.monotonic() < deadline:
            if log.exists():
                starts = [e for e in events(log) if e["event"] == "run_start"]
                if starts:
                    os.kill(starts[0]["pid"], signal.SIGTERM)
                    return starts[0]["pid"]
            time.sleep(0.005)
        raise AssertionError("rank 1 never started its run")
    return during


def _keep_step(src: Path, dst: Path, step: int) -> None:
    """A copy of checkpoint directory ``src`` holding only ``step``, as a
    run that stopped there left it."""
    name = f"step_{step:08d}"
    dst.mkdir(parents=True)
    shutil.copytree(src / name, dst / name)
    (dst / "LATEST").write_text(name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    out = {"root": root}
    # uninterrupted over 4 processes, and stacked (checkpoints at 2 and 4)
    run_procs(FLAGS, 4, root / "whole")
    run_stacked(FLAGS[:-1] + ["2"], root / "stacked")
    # preempted at rank 1, then the same command again
    pre = root / "pre"
    out["preempted_text"] = run_procs(FLAGS, 4, pre,
                                      during=_signal_rank1_at_start(pre))
    out["pre_logs"] = {r: events(pre / ("log.jsonl" + (f".rank{r}" if r
                                                        else "")))
                       for r in range(4)}
    _keep_step(pre / "ck", root / "pre_step1", 1)
    out["resumed_text"] = run_procs(FLAGS, 4, pre)
    # the stacked step-2 checkpoint resumed over 4 processes
    _keep_step(root / "stacked", root / "from_stacked", 2)
    out["from_stacked_text"] = run_procs(
        FLAGS + ["--ckpt-dir", str(root / "from_stacked")], 4,
        root / "from_stacked_run")
    # the 4-process step-1 checkpoint resumed stacked
    _keep_step(pre / "ck", root / "to_stacked", 1)
    out["to_stacked_text"], _ = run_stacked(FLAGS, root / "to_stacked")
    return out


def test_preemption_at_one_process_saves_the_same_step_everywhere(runs):
    logs = runs["pre_logs"]
    assert any(e["event"] == "preemption_requested" for e in logs[1])
    for r, log in logs.items():
        kinds = [(e["event"], e.get("step")) for e in log]
        assert ("checkpoint", 1) in kinds, (r, kinds)
        assert ("preempted_exit", 1) in kinds, (r, kinds)
        assert [e["step"] for e in log if e["event"] == "step"] == [0]
    _, manifest = ckpt.load_raw(str(runs["root"] / "pre_step1"))
    assert manifest["extras"]["defer_t"] == 1      # mid-cycle (K = 2)
    raw = flat_ckpt(runs["root"] / "pre_step1")
    assert any(np.abs(v).max() > 0 for k, v in raw.items()
               if k.startswith("defer/pending/0/"))


def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(runs):
    assert "resumed from checkpoint step 1 -> start 1" in runs["resumed_text"]
    a = flat_ckpt(runs["root"] / "whole" / "ck")
    b = flat_ckpt(runs["root"] / "pre" / "ck")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_a_checkpoint_of_processes_loads_in_jax_bit_for_bit(runs):
    from repro import checkpoint as jckpt
    d = str(runs["root"] / "whole" / "ck")
    mine, manifest = ckpt.load_raw(d)
    theirs, jmanifest = jckpt.load_raw(d)
    assert manifest == jmanifest and sorted(mine) == sorted(theirs)
    assert manifest["extras"]["defer"]["dp"] == 4
    for k, v in mine.items():
        want = np.asarray(theirs[k])
        got = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # JAX's restore into a tree of the same keys
    flat = {k: np.zeros(np.shape(v), np.asarray(theirs[k]).dtype)
            for k, v in theirs.items()}
    tree, extras = jckpt.restore(d, flat)
    assert extras["next_step"] == 4
    for k in flat:
        np.testing.assert_array_equal(np.asarray(tree[k]),
                                      np.asarray(theirs[k]), err_msg=k)


def test_stacked_checkpoint_resumes_over_processes(runs):
    from test_torch_train_procs import close
    assert "resumed from checkpoint step 2 -> start 2" in \
        runs["from_stacked_text"]
    got = flat_ckpt(runs["root"] / "from_stacked")
    close(got, flat_ckpt(runs["root"] / "stacked"), "stacked -> procs")


def test_process_checkpoint_resumes_stacked(runs):
    from test_torch_train_procs import close
    assert "resumed from checkpoint step 1 -> start 1" in \
        runs["to_stacked_text"]
    got = flat_ckpt(runs["root"] / "to_stacked")
    close(got, flat_ckpt(runs["root"] / "whole" / "ck"), "procs -> stacked")
