"""What the ``test_torch_examples*.py`` files share: the examples loaded as
modules, the JAX examples run as subprocesses (``fault_tolerant_train.py``
parses ``sys.argv`` and sets ``XLA_FLAGS`` at import, so none of them is
imported here), the JAX weights each JAX example draws, and torch on one
intra-op thread (the smoke models run thousands of small ops: with a
pytest-xdist worker per core, more threads only contend)."""

from __future__ import annotations

import contextlib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # tests/test_kernels.py TOL
JAX_TIMEOUT = 300                             # seconds, a JAX example


def load_chip_smoke():
    """``chip_smoke.py`` as a module of its own (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ``examples/<name>.py`` as a module (its ``main`` not run), loaded as
# ``chip_smoke.py`` loads it
load_example = load_chip_smoke().load_example


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def start_jax_example(name: str, *args: str, cwd) -> subprocess.Popen:
    """Start ``examples/<name>.py args`` (the JAX example) in ``cwd``."""
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py"), *args], cwd=cwd,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    """``(returncode, stdout, stderr)`` of a started example."""
    try:
        out, err = proc.communicate(timeout=JAX_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{proc.args} ran past {JAX_TIMEOUT} s: "
                             f"{err[-2000:]}")
    return proc.returncode, out, err


def run_jax_example(name: str, *args: str, cwd) -> str:
    """The stdout of a JAX example that must succeed."""
    rc, out, err = finish(start_jax_example(name, *args, cwd=cwd))
    assert rc == 0, f"{name} {args} exited {rc}: {err[-3000:]}"
    return out


def run_port_script(name: str, *args: str, cwd) -> str:
    """The stdout of ``python examples/<name>.py args``, which must
    succeed, with the port's source on the path and no JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                          *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=JAX_TIMEOUT)
    assert res.returncode == 0, f"{name} {args}: {res.stderr[-3000:]}"
    return res.stdout


def ints(text: str) -> list[int]:
    return [int(x) for x in re.findall(r"-?\d+", text)]


def jax_params(arch: str):
    """The JAX model of ``arch``'s smoke config and its ``split_params``
    tree from ``model.init(jax.random.key(0))``, as every JAX example
    draws it, with numpy leaves."""
    import jax

    from repro.configs.base import get_smoke_config
    from repro.models.module import split_params
    from repro.models.registry import build_model
    model = build_model(get_smoke_config(arch))
    params, _ = split_params(model.init(jax.random.key(0)))
    return model, jax.tree.map(np.asarray, params)


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
