"""The KV stores of ``chip_smoke.py``'s main path run on their own, from this
tree or another checkout of the repository, so that two versions can be
compared end to end on one card.

    python scripts/stores_ab.py [--root DIR] [--label NAME] [--repeat N]

Needs a CUDA card. Imports ``chip_smoke`` and the port from ``--root``
(default: this script's repository, so an older checkout needs no copy of
the script), runs ``phase_card`` (the card's name and power limit), then
``phase_stores`` (the privatized, sync, partitioned and overlapped stores)
and ``phase_blocked_stores`` (the blocked engine's) on the main path's
stream, with their own checks against the numpy oracle, ``--repeat``
times. Each store prints its updates/s and its tick times; one JSON line
ends each repeat with the label. Run each tree in its own process and
alternate them (A B B A), so that both see the same host and card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="")
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    cs.phase_card()
    stream, vals = cs.main_stream()
    keys = stream.reshape(cs.TICKS, cs.S, cs.B)
    for i in range(args.repeat):
        t0 = time.perf_counter()
        cs.phase_stores(keys, vals)
        cs.phase_blocked_stores(keys, vals)
        print(json.dumps({"label": args.label, "repeat": i,
                          "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
