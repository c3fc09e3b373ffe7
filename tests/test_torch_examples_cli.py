"""The examples' twins and ``scripts/ci_torch.sh`` as a user runs them.

* Every twin runs on the card unless asked for the CPU: without ``--device
  cpu`` on a host with no card it raises before any work (the first
  function of its work is replaced here by one that fails the test if
  called).
* Every twin runs once as a script, ``python examples/<twin>.py --device
  cpu`` (``train_e2e_torch.py`` cut to 2 steps, its checkpoints in a
  temporary directory), with the port's source on the path and no JAX.
* ``train_e2e_torch`` run twice on one checkpoint directory resumes.
* ``scripts/ci_torch.sh`` parses (``bash -n``) and, with no card and no
  ``--cpu``, exits non-zero before stage 1, naming ``--cpu``.
"""

import math
import os
import subprocess

import pytest
import torch

from _examples_common import ROOT, load_example, one_thread, run_port_script

CI = ROOT / "scripts" / "ci_torch.sh"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the twins run on it")


def _never(*args, **kwargs):
    raise AssertionError("the twin started its work without a device")


# twin -> the attributes that would start its work
REFUSALS = {
    "kv_store_ccache_torch": ["draw_inputs", "StackedSPMD"],
    "quickstart_torch": ["build_model", "from_jax_params"],
    "serve_batched_torch": ["build_model", "from_jax_params",
                            "serve_batch"],
    "fault_tolerant_train_torch": ["demo", "chaos_toy_sweeps"],
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_twin_without_a_card_raises_before_any_work(name, monkeypatch):
    _no_card()
    twin = load_example(name)
    for attr in REFUSALS[name]:
        monkeypatch.setattr(twin, attr, _never)
    for argv in ([], ["--chaos"]) if "fault" in name else ([],):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            twin.main(argv)


def test_train_e2e_without_a_card_raises_before_any_work(monkeypatch,
                                                         tmp_path):
    _no_card()
    twin = load_example("train_e2e_torch")
    monkeypatch.setattr(twin.train_cli, "build_model", _never)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.main(["--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


SCRIPTS = {
    "kv_store_ccache_torch": ([], "[cscatter kernel] max err"),
    "quickstart_torch": ([], "greedy continuation ids:"),
    "serve_batched_torch": ([], "sample ids:"),
    "fault_tolerant_train_torch": ([], "final loss"),
    "train_e2e_torch": (["--steps", "2"], "steps 0..2: loss"),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_twin_runs_as_a_script_on_the_cpu(name, tmp_path):
    extra, want = SCRIPTS[name]
    if name == "train_e2e_torch":
        extra = extra + ["--ckpt-dir", str(tmp_path / "ck")]
    out = run_port_script(name, "--device", "cpu", *extra, cwd=tmp_path)
    assert want in out.splitlines()[-1]


def test_train_e2e_resumes_from_its_last_checkpoint(tmp_path, capsys):
    twin = load_example("train_e2e_torch")
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2"]
    with one_thread():
        first = twin.main(argv + ["--steps", "4"])
        second = twin.main(argv + ["--steps", "6"])
    assert (first["start"], first["end"]) == (0, 4)
    assert (second["start"], second["end"]) == (4, 6)
    assert "resumed from checkpoint step 4 -> start 4" in \
        capsys.readouterr().out
    assert all(math.isfinite(x) for x in first["loss"] + second["loss"])


def test_train_e2e_keeps_its_own_checkpoint_directory():
    """Not the JAX example's ``repro_train_e2e``: each package loads the
    other's checkpoints, so a shared directory would resume across them."""
    twin = load_example("train_e2e_torch")
    assert os.path.basename(twin.CKPT_DIR) == "repro_torch_train_e2e"


def test_ci_script_parses():
    subprocess.run(["bash", "-n", str(CI)], check=True, timeout=30)


def test_ci_script_without_a_card_stops_naming_cpu(tmp_path):
    _no_card()
    res = subprocess.run(["bash", str(CI)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "--cpu" in res.stderr
    assert "stage 1" not in res.stdout


def test_ci_script_refuses_an_unknown_flag():
    res = subprocess.run(["bash", str(CI), "--gpu"], capture_output=True,
                         text=True, timeout=30)
    assert res.returncode == 2 and "usage" in res.stderr
