"""Checkpoints of model-split training state: the train CLI over a
``(data, model)`` mesh of gloo CPU processes (``--procs N --model-ranks
M``) at the f32 smoke configs of ``tests/test_torch_train_model_procs.py``,
whose helpers run it.

* The expert-parallel qwen3-moe-235b smoke run over ``(2, 2)``: rank 0
  writes JAX's on-disk layout from leaves split over both mesh dims, and
  JAX's ``load_raw`` reads every leaf bit for bit; a SIGTERM that reaches
  rank 1 alone makes every process save the same step, and the same
  command resumes to the uninterrupted run's checkpoint bit for bit; its
  step-2 checkpoint resumes stacked, and the stacked step-2 checkpoint
  resumes over ``(2, 2)``, each within ``TOL`` of the other layout's
  uninterrupted run.
* The dense qwen1.5-0.5b smoke run (whose values do not depend on the
  layout): a ``(2, 2)`` checkpoint resumes onto ``(4, 1)`` and onto ``(1,
  2)``, and each of theirs onto ``(2, 2)``, every resumed run within
  ``TOL`` of the stacked run of the same flags.
"""

import os
import shutil
import signal
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch import checkpoint as ckpt
from test_torch_train_model_procs import (argv_for, close, events, flat_ckpt,
                                          records, run_procs, run_stacked,
                                          step_losses)

STEPS = 4
EP, DENSE = "qwen3-moe-235b", "qwen1-5-0-5b"


def _flags(arch: str, ckpt_dir: Path, every: int) -> list:
    argv = argv_for(arch, ckpt_dir, STEPS)
    argv[argv.index("--ckpt-every") + 1] = str(every)
    return argv


def _signal_rank1_at_start(work: Path):
    """Beside the spawn: SIGTERM rank 1's worker once its driver has
    started (its ``run_start`` record names the process)."""
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


def _keep_step(src: Path, dst: Path, step: int) -> Path:
    """A copy of checkpoint directory ``src`` holding only ``step``, as a
    run that stopped there left it."""
    name = f"step_{step:08d}"
    dst.mkdir(parents=True)
    shutil.copytree(src / name, dst / name)
    (dst / "LATEST").write_text(name)
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_ckpt")
    out = {"root": root}
    # the expert-parallel run: uninterrupted over (2, 2) and stacked
    run_procs(_flags(EP, root / "ep", 2), 4, 2, root / "ep_run")
    run_stacked(_flags(EP, root / "ep_stacked", 2), 2, 2)
    # preempted at rank 1 during step 0, then the same command again
    pre = root / "ep_pre"
    run_procs(_flags(EP, pre / "ck", 2), 4, 2, pre,
              during=_signal_rank1_at_start(pre))
    out["pre_logs"] = {r: events(pre / ("log.jsonl" + (f".rank{r}" if r
                                                        else "")))
                       for r in range(4)}
    _keep_step(pre / "ck", root / "ep_pre_step1", 1)
    out["resumed_text"] = run_procs(_flags(EP, pre / "ck", 2), 4, 2, pre)
    # (2, 2) -> stacked, stacked -> (2, 2), from step 2
    d = _keep_step(root / "ep", root / "ep_to_stacked", 2)
    out["to_stacked"] = run_stacked(_flags(EP, d, 2), 2, 2)
    d = _keep_step(root / "ep_stacked", root / "ep_from_stacked", 2)
    out["from_stacked_text"] = run_procs(_flags(EP, d, 2), 4, 2,
                                         root / "ep_from_stacked_run")
    # the dense run across layouts: (2, 2) -> (4, 1) -> (2, 2) and
    # (2, 2) -> (1, 2) -> (2, 2), a checkpoint every step
    run_stacked(_flags(DENSE, root / "dense_stacked", 1), 1, 1)
    run_procs(_flags(DENSE, root / "d22", 1), 4, 2, root / "d22_run")
    legs = {"d41": ("d22", 2, 4, 1), "d12": ("d22", 2, 2, 2),
            "d41_22": ("d41", 3, 4, 2), "d12_22": ("d12", 3, 4, 2)}
    out["legs"] = {}
    for name, (src, step, procs, model) in legs.items():
        d = _keep_step(root / src, root / name, step)
        out["legs"][name] = run_procs(_flags(DENSE, d, 1), procs, model,
                                      root / f"{name}_run")
    return out


def test_a_model_split_checkpoint_loads_in_jax_bit_for_bit(runs):
    from repro import checkpoint as jckpt
    d = str(runs["root"] / "ep")
    mine, manifest = ckpt.load_raw(d)
    theirs, jmanifest = jckpt.load_raw(d)
    assert manifest == jmanifest and sorted(mine) == sorted(theirs)
    assert manifest["extras"]["next_step"] == STEPS
    for k, v in mine.items():
        want = np.asarray(theirs[k])
        got = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # split over both dims in the run: the experts over "model", the
    # embedding dim over "data"
    assert mine["params/blocks/moe/wi_gate"].shape == (2, 4, 64, 96)


def test_the_checkpoint_holds_every_process_s_final_slices_bit_for_bit(
        runs):
    """Each process records the digest of each of its slices of the final
    state (the worker's ``state_digests``); the checkpoint rank 0 wrote,
    read whole, holds the same bits at every process's slice of every
    leaf."""
    import torch
    from repro_torch.checkpoint.checkpoint import digest
    raw, _ = ckpt.load_raw(str(runs["root"] / "ep"))
    for r, rec in enumerate(records(runs["root"] / "ep_run", 4)):
        log = runs["root"] / "ep_run" / ("log.jsonl" + (f".rank{r}" if r
                                                          else ""))
        ends = [e for e in events(log) if e["event"] == "run_end"]
        assert len(ends) == 1 and ends[0]["step"] == STEPS
        digests = rec["state_digests"]
        assert set(digests) == set(raw)
        for key, d in digests.items():
            whole = torch.as_tensor(raw[key])
            part = whole[tuple(slice(o, o + n) for o, n in
                               zip(d["offset"], d["shape"]))]
            assert digest(part) == d["digest"], (r, key)


def test_preemption_at_one_process_saves_the_same_step_everywhere(runs):
    logs = runs["pre_logs"]
    assert any(e["event"] == "preemption_requested" for e in logs[1])
    for r, log in logs.items():
        kinds = [(e["event"], e.get("step")) for e in log]
        assert ("checkpoint", 1) in kinds, (r, kinds)
        assert ("preempted_exit", 1) in kinds, (r, kinds)
        assert [e["step"] for e in log if e["event"] == "step"] == [0]
    _, manifest = ckpt.load_raw(str(runs["root"] / "ep_pre_step1"))
    assert manifest["extras"]["next_step"] == 1


def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(runs):
    assert "resumed from checkpoint step 1 -> start 1" in runs["resumed_text"]
    a = flat_ckpt(runs["root"] / "ep")
    b = flat_ckpt(runs["root"] / "ep_pre" / "ck")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_model_split_checkpoint_resumes_stacked(runs):
    res = runs["to_stacked"]
    assert res.start == 2 and res.end == STEPS
    close(flat_ckpt(runs["root"] / "ep_to_stacked"),
          flat_ckpt(runs["root"] / "ep"), "(2, 2) -> stacked")


def test_stacked_checkpoint_resumes_over_the_model_axis(runs):
    assert "resumed from checkpoint step 2 -> start 2" in \
        runs["from_stacked_text"]
    close(flat_ckpt(runs["root"] / "ep_from_stacked"),
          flat_ckpt(runs["root"] / "ep_stacked"), "stacked -> (2, 2)")


@pytest.mark.parametrize("leg,step", [("d41", 2), ("d12", 2),
                                      ("d41_22", 3), ("d12_22", 3)])
def test_checkpoint_resumes_onto_another_layout(runs, leg, step):
    """(2, 2) -> (4, 1), (2, 2) -> (1, 2), and back onto (2, 2): each
    resumed run's state within ``TOL`` of the stacked run's, its losses of
    the uninterrupted (2, 2) run's."""
    from test_torch_train import TOL
    root = runs["root"]
    assert f"resumed from checkpoint step {step} -> start {step}" in \
        runs["legs"][leg]
    want = step_losses(root / "d22_run" / "log.jsonl")
    got = step_losses(root / f"{leg}_run" / "log.jsonl")
    np.testing.assert_allclose(got, want[step:], rtol=TOL, err_msg=leg)
    close(flat_ckpt(root / leg), flat_ckpt(root / "dense_stacked"),
          f"{leg} vs stacked")
