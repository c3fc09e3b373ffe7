"""Import hygiene of the PyTorch port: nothing under ``src/repro_torch/``,
nor ``chip_smoke.py``, imports ``jax``, the JAX package ``repro`` or
``ml_dtypes`` (absent where the card is)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_the_port_has_files_to_scan():
    names = {p.name for p in PORT_FILES}
    assert {"cscatter.py", "cmerge.py", "ccache.py", "blocked.py", "kv.py",
            "bfs.py", "pagerank.py", "kmeans.py", "sharded.py", "common.py",
            "flash_attention.py", "decode_attention.py", "attention.py",
            "transformer.py", "registry.py", "serve.py", "base.py",
            "qwen1_5_0_5b.py", "internlm2_1_8b.py", "chip_smoke.py",
            "defer_schedule.py", "wire_cost.py", "kv_serve.py", "journal.py",
            "checkpoint.py", "defer_state.py", "pipeline.py",
            "optimizers.py", "schedules.py", "driver.py", "grad_merge.py",
            "steps.py", "train.py", "embedding.py", "elastic.py",
            "chaos.py", "mlp.py", "ssm.py", "xlstm.py", "xlstm_lm.py",
            "hymba.py", "xlstm_125m.py", "hymba_1_5b.py",
            "granite_34b.py", "encdec.py", "seamless_m4t_medium.py",
            "selective_scan.py", "mesh_axis.py", "stacked.py",
            "mesh.py"} <= names
    dirs = {p.parent.name for p in PORT_FILES}
    assert {"data", "optim", "runtime", "launch", "checkpoint"} <= dirs
    for kernel in ("cscatter.cu", "cmerge.cu", "flash_attention.cu",
                   "decode_attention.cu", "selective_scan.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / kernel).is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


# test files whose processes run the port alone (``--worker``): the module
# those processes import must load no JAX
WORKER_FILES = ["test_torch_kv_mesh.py", "test_torch_plan_merge_gloo.py"]


@pytest.mark.parametrize("name", WORKER_FILES)
def test_mesh_worker_modules_load_no_jax(name):
    code = ("import sys\n"
            f"sys.path[:0] = [{str(ROOT / 'tests')!r}]\n"
            f"import {name.removesuffix('.py')}\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
