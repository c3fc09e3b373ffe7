"""``kv_serve --procs N``: the KV store's CLI over a process group, one
process a shard, on the CPU (gloo). Each command spawns its own processes;
rank 0 prints, and the settled-mass check must hold. The flags that the
mesh cannot take, or that would quietly change the backend, are refused
before any process starts; NCCL on a host with fewer cards than processes
raises before any work."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--procs", "2", "--shards", "2", "--device", "cpu", "--keys", "4096",
        "--ticks", "9", "--batch", "64"]


def _cli(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kv_serve", *flags],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("flags", [
    ["--defer", "4"], ["--defer", "4", "--partitioned", "--overlap"],
    ["--defer", "4", "--engine", "blocked", "--backend", "gloo"]])
def test_cli_serves_over_two_gloo_processes(flags):
    out = _cli(*BASE, *flags)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    text = out.stdout
    assert "2 processes over gloo" in text
    assert f"settled mass col0: {9 * 2 * 64} (= {9 * 2 * 64} updates" \
        in text
    # rank 0 alone prints
    assert text.count("settled mass col0") == 1
    if "blocked" in flags:
        assert "evict_merges" in text


def test_cli_solves_its_schedule_over_the_processes_wire():
    """``--defer auto`` over the mesh times each level over the gloo
    group and prints it beside the rates."""
    out = _cli(*BASE, "--defer", "auto")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "over gloo (2 processes)" in out.stdout
    assert "solved schedule:" in out.stdout
    assert f"settled mass col0: {9 * 2 * 64}" in out.stdout


@pytest.mark.parametrize("flags,why", [
    (["--backend", "nccl"], "runs on the card"),
    (["--shards", "8"], "must equal"),
    (["--procs", "1", "--shards", "1"], "at least 2"),
])
def test_cli_refuses_what_the_mesh_cannot_take(flags, why):
    out = _cli(*BASE, "--defer", "4", *flags, timeout=60)
    assert out.returncode != 0
    assert why in out.stderr


def test_cli_backend_needs_procs():
    out = _cli("--device", "cpu", "--backend", "gloo", timeout=60)
    assert out.returncode != 0 and "--procs" in out.stderr


def test_nccl_with_more_processes_than_cards_raises_before_any_work():
    """``init_shards("nccl")`` on a host with fewer cards than processes
    raises before it makes a process group."""
    import torch.distributed as dist
    from repro_torch.core.mesh_axis import check_cards
    from repro_torch.launch import mesh as pmesh
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one card a process"):
        check_cards("nccl", cards + 1)
    check_cards("gloo", cards + 8)          # gloo shares cards
    with pytest.raises(RuntimeError, match="one card a process"):
        pmesh.init_shards("nccl", rank=0, world_size=cards + 1,
                          init_method="file:///nonexistent/init")
    assert not dist.is_initialized()


def test_init_shards_takes_the_card_unless_asked_for_the_cpu(tmp_path):
    """With no device type, ``init_shards`` places the process on the
    card, and raises before it makes a group where there is none."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as pmesh
    init = f"file://{tmp_path / 'init'}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.init_shards("gloo", rank=0, world_size=1,
                              init_method=init)
        assert not dist.is_initialized()
        return
    try:
        mesh = pmesh.init_shards("gloo", rank=0, world_size=1,
                                 init_method=init)
        assert mesh.device_type == "cuda"
    finally:
        pmesh.shutdown()


def test_build_mesh_needs_a_group_of_its_shards(tmp_path):
    """Every rank of the group joins the mesh's first collective, so a
    mesh of fewer shards than the group has processes is refused; and a
    mesh takes the card unless the caller passes ``cpu``."""
    from repro_torch.apps.sharded import build_mesh
    from repro_torch.launch import mesh as pmesh
    mesh = pmesh.init_shards("gloo", "cpu", rank=0, world_size=1,
                             init_method=f"file://{tmp_path / 'init'}")
    try:
        assert mesh.device_type == "cpu" and mesh.size() == 1
        with pytest.raises(RuntimeError, match="needs a group of 2"):
            build_mesh(2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_mesh(1)
    finally:
        pmesh.shutdown()


def test_spawn_shards_returns_what_runs_beside_the_processes(tmp_path):
    from repro_torch.launch.mesh import spawn_shards
    got = spawn_shards(
        lambda r: [sys.executable, "-c",
                   "import os; print(os.environ['LOCAL_RANK'], "
                   "os.environ['LOCAL_WORLD_SIZE'])"],
        2, tmp_path, 60, during=lambda: "beside")
    assert got == "beside"
    assert (tmp_path / "rank1.log").read_text().split() == ["1", "2"]


@pytest.mark.parametrize("code,timeout,why", [
    ("import sys; print('boom'); sys.exit(3)", 60, r"\(exit code 3\)"),
    ("import time; print('boom', flush=True); time.sleep(60)", 2,
     "still running after 2 s"),
])
def test_spawn_shards_stops_the_others_and_raises_with_the_log_tail(
        tmp_path, code, timeout, why):
    """A process that fails, or outlives the limit, fails the spawn with
    its log's tail, and the others are stopped at once."""
    import time
    from repro_torch.launch.mesh import spawn_shards
    cmd = {0: [sys.executable, "-c", code],
           1: [sys.executable, "-c", "import time; time.sleep(60)"]}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=why) as err:
        spawn_shards(cmd.__getitem__, 2, tmp_path, timeout)
    assert "process 0 of 2" in str(err.value) and "boom" in str(err.value)
    assert time.monotonic() - t0 < 30
