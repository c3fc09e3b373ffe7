"""Paths of ``chip_smoke.py``'s model families run on their own, from this
tree or another checkout of the repository, so that two versions can be
compared end to end on one card.

    python scripts/families_ab.py [--root DIR] [--label NAME] [--out FILE]
        _hymba_serve _hymba_train

Needs a CUDA card. Imports ``chip_smoke`` and the port from ``--root``
(default: this script's repository, so an older checkout needs no copy of
the script), runs ``phase_card`` (the card's name and power limit, the f32
matmul flags), then each named path function of ``chip_smoke`` with its own
checks and launch counts, as ``phase_families`` does. Prints one JSON line
a path: its scalar results flattened (``runs.eager.ms_by_kind.eager``,
``profile_eager_step.idle_share``, ...); ``--out`` also keeps the whole
results. Run each tree in its own process and alternate them (A B B A), so
that both see the same host and card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def flat(row, prefix: str = "") -> dict:
    """Every number, string and bool of a nested dict, keyed by its dotted
    path; lists are left out."""
    out = {}
    for k, v in row.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[key] = v
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+", help="chip_smoke functions, e.g. "
                                            "_hymba_serve _hymba_train")
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    _, smi = cs.phase_card()
    results = {}
    for name in args.paths:
        t0 = time.perf_counter()
        row = getattr(cs, name)(smi)
        row["phase_s"] = time.perf_counter() - t0
        results[name] = row
        print(json.dumps({"label": args.label, "path": name, **flat(row)}))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"label": args.label, "root": str(root), "card": smi,
             "results": results}, default=str))


if __name__ == "__main__":
    main()
