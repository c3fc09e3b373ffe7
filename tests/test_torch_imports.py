"""Import hygiene of the PyTorch port: nothing under ``src/repro_torch/``,
nor ``chip_smoke.py``, the examples' twins (``examples/*_torch.py``) or
the port's scripts (``scripts/*_torch.py``), imports ``jax``, the JAX
package ``repro`` or ``ml_dtypes`` (absent where the card is)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
# files run by path, outside the package
SCRIPT_FILES = (sorted((ROOT / "examples").glob("*_torch.py"))
                + sorted((ROOT / "scripts").glob("*_torch.py")))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py"] + SCRIPT_FILES
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
    assert {"kv_store_ccache_torch.py", "quickstart_torch.py",
            "serve_batched_torch.py", "train_e2e_torch.py",
            "fault_tolerant_train_torch.py", "lint_plans_torch.py"} <= names
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
        for p in PACKAGE_FILES)
    paths = [str(p) for p in SCRIPT_FILES]
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"for i, p in enumerate({paths!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f's{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
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


def test_ci_script_runs_only_the_port_s_entry_points():
    """``scripts/ci_torch.sh`` runs the port's lint and examples, never the
    JAX package's (its stage 1 runs the parity tests, which import JAX)."""
    import re
    text = (ROOT / "scripts" / "ci_torch.sh").read_text()
    code = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))
    run = re.findall(r"(?:scripts|examples)/\w+\.py", code)
    assert run and all(p.endswith("_torch.py") for p in run), run
    assert not re.search(r"-m\s+(repro|benchmarks)\b", code)
