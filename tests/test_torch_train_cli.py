"""The port's train CLI (``python -m repro_torch.launch.train``) on the CPU:
a deferred run that checkpoints, flushes its partial cycle and resumes;
the eager, overlapped and solved (``--merge-defer auto``) runs; and the
refusals of bad flag combinations, with the JAX CLI's messages
(``repro/launch/train.py:196-256``)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import checkpoint as ckpt
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "qwen1-5-0-5b", "--smoke", "--device", "cpu",
         "--batch", "8", "--seq", "16"]
LOSS_LINE = re.compile(r"^steps (\d+)\.\.(\d+): loss (\S+) -> (\S+)$", re.M)


def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_deferred_cli_trains_checkpoints_flushes_and_resumes(tmp_path):
    args = SMOKE + ["--merge-topology", "chip:2,host:2:defer",
                    "--merge-defer", "2", "--steps", "5", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path), "--log",
                    str(tmp_path / "log.jsonl")]
    first = _cli(args)
    assert "merge-defer schedule: host: K=2 (period 2)" in first
    assert "final flush: settled a 1-step partial cycle" in first
    m = LOSS_LINE.search(first)
    assert m and m.group(1, 2) == ("0", "5")
    assert all(float(x) == float(x) for x in m.group(3, 4))     # finite
    assert ckpt.latest_step(str(tmp_path)) == 4
    _, manifest = ckpt.load_raw(str(tmp_path))
    assert manifest["extras"]["defer"]["dp"] == 4
    assert "defer/pending/0/embed/table" in {
        e["key"] for e in manifest["keys"]}
    second = _cli(args)
    assert "resumed from checkpoint step 4 -> start 4" in second
    assert "final flush: settled a 1-step partial cycle" in second
    m = LOSS_LINE.search(second)
    assert m and m.group(1, 2) == ("4", "5")
    assert (tmp_path / "log.jsonl").read_text().count('"event": "step"') == 6


@pytest.mark.parametrize("extra,flush", [
    (["--merge-topology", "chip:2,host:2,pod:2", "--microbatches", "1"], None),
    (["--merge-topology", "chip:2,pod:2", "--microbatches", "2",
      "--merge-compress", "--batch", "16"], None),
    (["--merge-topology", "chip:2,host:2:defer,pod:2:defer", "--merge-defer",
      "3", "--merge-overlap", "--merge-lane-parallel"],
     "final flush: landed the in-flight commit"),
    ([], None),
], ids=["eager", "compress-microbatches", "overlap", "implicit"])
def test_cli_runs(tmp_path, capsys, extra, flush):
    res = train.main(SMOKE + extra + ["--steps", "3", "--ckpt-dir",
                                      str(tmp_path), "--ckpt-every", "100"])
    out = capsys.readouterr().out
    assert res.end == 3 and LOSS_LINE.search(out)
    assert (flush in out) if flush else "final flush" not in out
    losses = [e["loss"] for e in res.events if e["event"] == "step"]
    assert len(losses) == 3 and all(x == x for x in losses)


def test_merge_defer_auto_solves_from_measured_rates(tmp_path, capsys):
    train.main(SMOKE + ["--merge-topology", "chip:2,host:2:defer,pod:2:defer",
                        "--merge-defer", "auto", "--steps", "2",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "100"])
    out = capsys.readouterr().out
    assert "wire vector (bytes a synchronized tick, machine-wide): chip " \
        in out
    assert "level merges on cpu (median of 5): chip " in out
    assert "per-rank step on cpu: " in out
    assert re.search(r"merge-defer schedule: host: K=\d+, pod: K=\d+", out)
    assert LOSS_LINE.search(out)


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1-5-0-5b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("extra,msg", [
    (["--merge-group-size", "2", "--merge-topology", "chip:2"],
     "--merge-group-size and --merge-topology are mutually exclusive"),
    (["--merge-compress"],
     "--merge-compress requires --merge-group-size or --merge-topology"),
    (["--merge-lane-parallel"],
     "--merge-lane-parallel requires --merge-topology"),
    (["--merge-group-size", "2"],
     "--merge-group-size 2 does not divide the data axis (1 devices)"),
    (["--merge-topology", "chip:3"],
     "--batch 8 must be divisible by the merge topology's 3 ranks"),
    (["--merge-topology", "chip:2:bogus"], "--merge-topology: "),
    (["--merge-defer", "2"],
     "--merge-defer requires a --merge-topology with :defer levels"),
    (["--merge-topology", "chip:2,pod:2", "--merge-overlap"],
     "--merge-overlap requires --merge-defer"),
    (["--merge-topology", "chip:2,pod:2:defer"],
     "--merge-topology has :defer levels; pass --merge-defer auto|K"),
    (["--merge-topology", "chip:2,pod:2:defer", "--merge-defer", "0"],
     "--merge-defer: K must be >= 1"),
    (["--merge-topology", "chip:2,pod:2:defer", "--merge-defer", "often"],
     "--merge-defer must be 'auto' or an integer, got 'often'"),
    (["--merge-topology", "chip:8,pod:1:defer", "--merge-defer", "2"],
     "--merge-defer: the :defer levels all have size 1"),
    (["--merge-topology", "chip:8", "--microbatches", "3"],
     "which --microbatches 3 does not divide"),
])
def test_cli_refusals(tmp_path, extra, msg):
    with pytest.raises(SystemExit) as e:
        train.build(train.parse_args(SMOKE + extra + [
            "--ckpt-dir", str(tmp_path)]))
    assert msg in str(e.value)
