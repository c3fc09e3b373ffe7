#!/usr/bin/env python3
"""Seconds for a process of the train CLI to start: Python, PyTorch, the
CLI's modules, DTensor and the card's context, with and without a bytecode
cache, one process alone and four at once (as ``launch/train.py --procs 4``
starts them).

    python scripts/start_cost.py        # from the checkout's root, one card

A host that writes no bytecode (``PYTHONDONTWRITEBYTECODE``) compiles
PyTorch's sources again in every process it starts; ``chip_smoke.py``
therefore gives every process it starts one cache, ``build/pycache``. The
cache this script measures is its own, ``build/start_cost_pycache``, made
anew. Prints the card's name and power limit, then one JSON object.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CODE = ("import repro_torch.launch.train, torch, torch.distributed.tensor; "
        "torch.zeros(1, device='cuda')")


def starts(env: dict, n: int) -> float:
    """Seconds until ``n`` processes started together have all ended."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", CODE], env=env)
             for _ in range(n)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"a process exited {p.returncode}")
    return time.perf_counter() - t0


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    cache = ROOT / "build" / "start_cost_pycache"
    shutil.rmtree(cache, ignore_errors=True)
    plain = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cached = dict(plain, PYTHONPYCACHEPREFIX=str(cache))
    cached.pop("PYTHONDONTWRITEBYTECODE", None)
    out = {"card": smi, "host_writes_no_bytecode":
           bool(os.environ.get("PYTHONDONTWRITEBYTECODE"))}
    for label, env, n in [("no_cache_x1", plain, 1), ("cache_cold_x1", cached, 1),
                          ("cache_warm_x1", cached, 1), ("no_cache_x4", plain, 4),
                          ("cache_warm_x4", cached, 4)]:
        out[label] = starts(env, n)
    shutil.rmtree(cache, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
