"""Paths of ``chip_smoke.py``'s model families run on their own, from this
tree or another checkout of the repository, so that two versions can be
compared end to end on one card.

    python scripts/families_ab.py [--root DIR] [--label NAME] [--out FILE]
        _hymba_serve _hymba_train
    python scripts/families_ab.py [--root DIR] [--label NAME] --repeat N
        _encdec_serve _xlstm_serve

Needs a CUDA card. Imports ``chip_smoke`` and the port from ``--root``
(default: this script's repository, so an older checkout needs no copy of
the script), runs ``phase_card`` (the card's name and power limit, the f32
matmul flags), then each named path function of ``chip_smoke`` with its own
checks and launch counts, as ``phase_families`` does. Prints one JSON line
a path: its scalar results flattened (``runs.eager.ms_by_kind.eager``,
``profile_eager_step.idle_share``, ...); ``--out`` also keeps the whole
results. With ``--repeat N`` a serving path (:data:`SERVE`) runs none of
its checks: its model (full width, bf16, random weights from the seed) and
its batch are built once, a short generate warms up, and N generate calls
of the path's prompt and length are timed, one JSON line each (prefill ms,
decode ms a step); the last line gives each one's median and quartiles.
Run each tree in its own process and alternate them (A B B A), so that
both see the same host and card.
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


# a serving path of chip_smoke -> its arch, and the names of its prompt
# length and generated tokens there (read from the imported chip_smoke)
SERVE = {"_encdec_serve": ("seamless-m4t-medium", "ENCDEC_PROMPT",
                           "ENCDEC_GEN"),
         "_xlstm_serve": ("xlstm-125m", "XLSTM_PROMPT", "XLSTM_GEN")}


def quartiles(xs: list) -> dict:
    import statistics
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return {"q1": q1, "median": statistics.median(xs), "q3": q3,
            "min": min(xs), "max": max(xs)}


def time_serve(cs, name: str, n: int, label: str) -> dict:
    """``n`` timed generate calls of the serving path ``name``'s model and
    batch -> each timing's quartiles."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models.registry import build_model
    arch, prompt, gen = SERVE[name]
    prompt, gen = getattr(cs, prompt), getattr(cs, gen)
    cfg = get_config(arch)
    model = build_model(cfg, device="cuda", seed=cs.SEED)
    batch = serve_batch(cfg, cs.FAMILY_BATCH, prompt, cs.SEED)
    ids, frames = batch["tokens"], batch.get("frames")
    generate(model, ids[:, :16], 2, frames=frames)      # warm-up
    rows = []
    for i in range(n):
        res = generate(model, ids, gen, frames=frames)
        rows.append({"prefill_ms": 1e3 * res.prefill_s,
                     "decode_ms_per_step": 1e3 * res.decode_s / (gen - 1)})
        print(json.dumps({"label": label, "path": name, "repeat": i,
                          **rows[-1]}))
    del model
    torch.cuda.empty_cache()
    return {k: quartiles([r[k] for r in rows]) for k in rows[0]}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+", help="chip_smoke functions, e.g. "
                                            "_hymba_serve _hymba_train")
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--repeat", type=int, default=0,
                   help="time N generate calls of each serving path, "
                        "without its checks")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    _, smi = cs.phase_card()
    results = {}
    if args.repeat:
        for name in args.paths:
            results[name] = time_serve(cs, name, args.repeat, args.label)
        print(json.dumps({"label": args.label, "repeats": args.repeat,
                          "card": smi, **results}))
        return
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
