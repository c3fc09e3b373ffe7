"""The selective-scan kernels on the card: each launch's time, and the chunk
length L swept.

    PYTHONPATH=src python scripts/scan_sweep.py [--chunks 32,64,128]

Needs a CUDA card and ``nvcc``. Builds ``csrc/selective_scan.cu`` once for
each chunk length (a copy with ``kChunk`` changed, under
``build/scan_sweep/``) and times, with CUDA graphs as ``chip_smoke.py``'s
``phase_scan`` does, the forward and the backward at hymba-1.5b's shapes
(S 16, u bf16): one training rank's ``[2, 2048, 3200]`` (forward with
checkpoints, backward) and the prefill's ``[8, 2048, 3200]`` (forward
only), every build in turn, then again in reverse order. Then profiles five
calls of the repository's own build (``torch.profiler``) for each launch's
device time. Prints each build's ``ptxas`` registers and spills at S 16,
then one JSON line: ms by shape, direction and chunk (both turns), and
µs a launch by kernel and shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as sc  # noqa: E402

SHAPES = [("train", 2, 2048, 3200, 16, "bfloat16", True),
          ("prefill", 8, 2048, 3200, 16, "bfloat16", False)]


def build(chunk: int) -> ctypes.CDLL:
    """The kernels with ``kChunk = chunk``, built and loaded."""
    src = (_build.CSRC / "selective_scan.cu").read_text()
    old = f"constexpr int kChunk = {sc.SEGMENT};"
    assert old in src, "the source's chunk constant moved"
    out = ROOT / "build" / "scan_sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"selective_scan_{chunk}.cu"
    cu.write_text(src.replace(old, f"constexpr int kChunk = {chunk};"))
    lib = out / f"libselective_scan_{chunk}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed at chunk {chunk}:\n{r.stdout}"
                           f"{r.stderr}")
    for line in cs.ptxas_report(r.stdout + r.stderr):
        if "ILi16E" in line:
            print(f"chunk {chunk} ptxas: {line}")
    return ctypes.CDLL(str(lib))


def use(chunk: int, lib: ctypes.CDLL) -> None:
    """Route the wrapper's launches to ``lib``, its buffers sized for
    ``chunk``."""
    sc.SEGMENT = chunk
    _build._loaded["selective_scan"] = lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="32,64,128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_sweep: no CUDA card")
    home = sc.SEGMENT
    chunks = [int(x) for x in args.chunks.split(",")]
    libs = {n: build(n) for n in chunks}
    ms: dict[str, list[float]] = {}
    per_launch: dict[str, float] = {}
    for what, b, t, d, s, u, bwd in SHAPES:
        ins = cs._scan_inputs(what, b, t, d, s, u, cs.SEED)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
        dy = torch.randn((b, t, d), generator=g, device="cuda")
        dh = torch.randn((b, d, s), generator=g, device="cuda")
        for order in (chunks, chunks[::-1]):
            for n in order:
                use(n, libs[n])
                ms.setdefault(f"{what} forward L{n}", []).append(cs.graph_ms(
                    lambda: sc.launch_forward(*ins, checkpoints=bwd),
                    launches=20, samples=5))
                if bwd:
                    ckpt = sc.launch_forward(*ins)[2]
                    ms.setdefault(f"{what} backward L{n}", []).append(
                        cs.graph_ms(lambda: sc.launch_backward(
                            *ins[:5], ckpt, dy, dh), launches=20, samples=5))
        sc.SEGMENT = home
        _build._loaded.pop("selective_scan", None)
        ckpt = sc.launch_forward(*ins)[2]
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                sc.launch_forward(*ins, checkpoints=bwd)
                if bwd:
                    sc.launch_backward(*ins[:5], ckpt, dy, dh)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "scan_" in ev.key and ev.count:
                name = ev.key.split("::")[-1].split("(")[0]
                per_launch[f"{what} {name}"] = (ev.device_time_total
                                                / ev.count)
        del ins, dy, dh, ckpt
        torch.cuda.empty_cache()
    for k, v in ms.items():
        print(f"{k}: {v}")
    for k, v in per_launch.items():
        print(f"{k}: {v:.3f} us a launch")
    print(json.dumps({"card": torch.cuda.get_device_name(0), "ms": ms,
                      "us_a_launch": per_launch}))


if __name__ == "__main__":
    main()
