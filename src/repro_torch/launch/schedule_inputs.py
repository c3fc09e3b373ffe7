"""What a solved commit schedule is solved from, measured on the device.

``--defer auto|adaptive`` of the KV store's CLI and ``--merge-defer auto``
of the train CLI both solve their commit intervals from the wire vector of
``launch/wire_cost.py``, each plan level's merge timed alone on the device
(its "rate" is its wire bytes over that time) and the time of the work a
commit is amortized over (a deferred tick, a per-rank step). This module
holds the timing and the printed description they share.
"""

from __future__ import annotations

import statistics
import time

import torch

from repro_torch.serve.kv import sync_device


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def median_seconds(fn, device: torch.device, runs: int) -> float:
    """The median over ``runs`` calls of ``fn``'s time, after a warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    sync_device(device)
    out = []
    for _ in range(runs):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return statistics.median(out)


def time_level_merges(plan, payload: torch.Tensor, merge,
                      runs: int = 5, axis=None) -> list[float]:
    """Seconds of each level's merge alone (``ccache.merge_stage``) over
    ``payload``, median of ``runs``, by plan level (0 for a level that
    compiles away). The merge runs over ``axis``, the wire the caller
    really uses (a KV store's ``MeshAxis`` over a process group, the
    payload this process's ``[1, ...]`` slice); by default a
    ``StackedAxis`` over the payload's ``[S, ...]`` dim 0."""
    from repro_torch.core import ccache
    from repro_torch.core.merge_plan import compile_plan
    from repro_torch.core.stacked import StackedAxis

    if axis is None:
        axis = StackedAxis(payload.shape[0], payload.device)
    level_s = [0.0] * len(plan.levels)
    for st in compile_plan(plan, axis.size, merge_fn=merge):
        level_s[st.index] = median_seconds(
            lambda: ccache.merge_stage(payload, axis, merge, st),
            payload.device, runs)
    return level_s


def describe_inputs(inputs: dict, label: str = "deferred tick",
                    key: str = "tick_s") -> list[str]:
    """The measured inputs of a solved schedule, as printed lines;
    ``inputs[key]`` is the time of the work a commit is amortized over,
    printed as ``label``."""
    names = inputs["names"]
    over = f" over {inputs['backend']}" if "backend" in inputs else ""
    return [
        "wire vector (bytes a synchronized tick, machine-wide): "
        + ", ".join(f"{n} {b:.0f}" for n, b in zip(names, inputs["wire"])),
        f"level merges on {inputs['device']} (median of 5): "
        + ", ".join(f"{n} {1e3 * t:.6f} ms ({r:.6g} B/s)" for n, t, r in
                    zip(names, inputs["level_s"], inputs["rates"])) + over,
        f"{label} on {inputs['device']}: {1e3 * inputs[key]:.6f} ms"]
