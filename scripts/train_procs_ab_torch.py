"""The train CLI over gloo processes sharing one card, timed step by step,
from this tree or another checkout of the repository, so that two versions
of the steps over a real process group can be compared on one card.

    python scripts/train_procs_ab_torch.py [--root DIR] [--label NAME]
        [--layers 2] [--steps 6] [--forms implicit,deferred]

Needs a CUDA card. Imports ``chip_smoke`` from ``--root`` (default: this
script's repository, so an older checkout needs no copy of the script),
runs ``phase_card`` (prints the card's name and power limit), then runs
each form of ``chip_smoke``'s ``phase_train_procs`` command from that
checkout: its ``_procs_argv`` (qwen1.5-0.5b at full width, PROCS_BATCH x
TRAIN_SEQ, bf16) at ``--layers`` and ``--steps``, no checkpoint before
the end, as ``python -m repro_torch.launch.train ... --procs PROCS
--backend gloo``:

* ``implicit``: no merge topology, the implicit step over a ``(PROCS, 1)``
  mesh (``launch/steps._implicit_step``);
* ``deferred``: ``phase_train_procs``' own PROCS_PLAN deferred with
  PROCS_K (the explicit branch, ``_OnMesh``).

Prints one JSON line a form: rank 0's step times in ms from its driver log,
their median after the first step (which builds the kernels and warms
up), the losses, and each process's peak device bytes. Run each tree in its
own process and alternate them (A B B A), so that both see the same host
and card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def form_argv(cs, form: str, layers: int, steps: int, ckpt_dir: str,
              log: str) -> list:
    argv = cs._procs_argv(ckpt_dir, log)
    for flag, value in (("--layers", layers), ("--steps", steps),
                        ("--ckpt-every", 1 << 30)):
        argv[argv.index(flag) + 1] = str(value)
    if form == "implicit":
        for flag in ("--merge-topology", "--merge-defer"):
            i = argv.index(flag)
            del argv[i:i + 2]
    return argv + ["--procs", str(cs.PROCS), "--backend", "gloo"]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--forms", default="implicit,deferred")
    p.add_argument("--timeout", type=float, default=600)
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    _, smi = cs.phase_card()
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for form in args.forms.split(","):
        work = tempfile.mkdtemp(prefix="train_procs_ab_")
        try:
            log = os.path.join(work, "log.jsonl")
            argv = form_argv(cs, form, args.layers, args.steps,
                             os.path.join(work, "ck"), log)
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", *argv],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=args.timeout)
            if run.returncode:
                raise SystemExit(f"{form}: the command returned "
                                 f"{run.returncode}: {run.stderr[-3000:]}")
            logs = cs._rank_logs(log)
            steps = [e for e in logs[0] if e["event"] == "step"]
            ends = [[e for e in ev if e["event"] == "run_end"] for ev in logs]
            ms = [1e3 * e["dt"] for e in steps]
            print(json.dumps({
                "label": args.label, "form": form, "layers": args.layers,
                "card": smi, "step_ms": ms,
                "median_ms_after_first": statistics.median(ms[1:]),
                "losses": [e["loss"] for e in steps],
                "peak_device_bytes": [en[-1]["peak_device_bytes"]
                                      if en else None for en in ends]}),
                flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
