"""Host microseconds a ``cscatter`` call takes through its decorated
wrapper (``kernels/custom_ops.kernel_call``: the planner's test and the
listeners' test) and through the function beneath it (``__wrapped__``),
alternated, at the KV tick's shape ([8, 2^22, 4] int32, N = 1024 a
shard): what the decorator adds to the main path.

    python scripts/kernel_call_us.py [--samples 10] [--calls 200]

Needs a CUDA card; prints one JSON line (the samples, their medians and
the difference).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--calls", type=int, default=200)
    args = p.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    from repro_torch.kernels import cscatter as cm
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.zeros((8, 1 << 22, 4), dtype=torch.int32, device="cuda")
    ids = torch.randint(0, 1 << 22, (8, 1024), device="cuda", generator=g,
                        dtype=torch.int32)
    vals = torch.ones((8, 1024, 4), dtype=torch.int32, device="cuda")
    runs = {"decorated": cm.cscatter, "undecorated": cm.cscatter.__wrapped__}
    for fn in runs.values():
        fn(table, ids, vals, kind="add")
    torch.cuda.synchronize()
    samples = {k: [] for k in runs}
    for _ in range(args.samples):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn(table, ids, vals, kind="add")
            samples[name].append(1e6 * (time.perf_counter() - t0)
                                 / args.calls)
            torch.cuda.synchronize()
    med = {k: statistics.median(v) for k, v in samples.items()}
    print(json.dumps({"samples_us": samples, "median_us": med,
                      "added_us": med["decorated"] - med["undecorated"]}))


if __name__ == "__main__":
    main()
