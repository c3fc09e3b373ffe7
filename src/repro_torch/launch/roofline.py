"""Roofline report: the dry-run's cell records as a markdown table.

The port of the JAX package's ``repro/launch/roofline.py``; "fits" is
measured against the H100's 80 GB (``launch/hw_analysis.HBM_BYTES``).
:func:`floor_table` follows it: a row an (arch, shape), the two meshes
side by side, with the walk's counts, both rooflines' terms and the live
bytes (``PERF.md``'s table of the cells).

    python -m repro_torch.launch.roofline [--dir results/dryrun_torch] [--mesh pod16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(dir_: str) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        rec["_file"] = os.path.basename(path)
        cells.append(rec)
    return cells


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def fmt_b(x) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if x < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


def table(cells: list[dict], mesh: str | None = None,
          base_only: bool = True) -> str:
    rows = ["| arch | shape | mesh | compute | memory | collective | "
            "dominant | useful 6ND/walk | HBM/dev | fits |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("status") != "ok":
            if mesh and c.get("mesh") != mesh:
                continue
            rows.append(f"| {c.get('arch')} | {c.get('shape')} | "
                        f"{c.get('mesh')} | {c.get('status').upper()} "
                        f"| - | - | - | - | - | - |")
            continue
        if mesh and c["mesh"] != mesh:
            continue
        if base_only and "__" in c["_file"].replace(
                f"{c['arch']}__{c['shape']}__{c['mesh']}", ""):
            continue
        r = c["roofline"]
        u = c.get("useful_flops_ratio")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {u:.3f} | {fmt_b(c['memory']['live_bytes_per_device'])} "
            f"| {'yes' if c['memory']['fits_80gb_hbm'] else 'NO'} |")
    return "\n".join(rows)


MESHES = ("pod16x16", "pod2x16x16")


def _both(values: list, fmt: str) -> str:
    """One mesh's value, or both's joined by "; " where they differ."""
    out = [format(v, fmt) if isinstance(v, (int, float)) else str(v)
           for v in values]
    return out[0] if len(set(out)) == 1 else "; ".join(out)


def floor_table(cells: list[dict]) -> str:
    """A row an (arch, shape) of ``ok`` cells, the meshes of
    :data:`MESHES` side by side: FLOPs, the eager HBM bytes, the boundary
    bytes, the wire bytes by level, the three terms with the eager
    traffic, the floor's memory term, the dominant term of each roofline,
    the live GB a device (NO past 80 GB) and the useful-FLOPs ratio."""
    terms = ("compute_s", "memory_s", "collective_s")

    def gb(c):
        g = c["memory"]["live_bytes_per_device"] / 1e9
        return format(g, ".3g") + ("" if g < 80 else " NO")

    columns = [
        (lambda c: c["op_walk"]["flops"], ".4g"),
        (lambda c: c["op_walk"]["hbm_bytes"], ".4g"),
        (lambda c: c["memory"]["boundary_bytes_per_device"], ".4g"),
        (lambda c: "/".join(format(b, ".3g") for b in
                            c["op_walk"]["wire_bytes_by_level"]), ""),
        (lambda c: " / ".join(format(c["roofline"][k], ".4g")
                              for k in terms), ""),
        (lambda c: c["roofline_floor"]["memory_s"], ".4g"),
        (lambda c: f"{c['roofline']['dominant']}, "
                   f"{c['roofline_floor']['dominant']}", ""),
        (gb, ""),
        (lambda c: c.get("useful_flops_ratio") or 0.0, ".3g")]
    rows = ["| Cell (16×16; 2×16×16) | FLOPs | Eager HBM bytes | Boundary "
            "bytes | Wire bytes by level | Compute / eager memory / "
            "collective s | Floor memory s | Dominant: eager, floor | Live "
            "GB (fits 80) | Useful |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    by_cell: dict = {}
    for c in cells:
        if c.get("status") == "ok" and c.get("mesh") in MESHES:
            by_cell.setdefault((c["arch"], c["shape"]), {})[c["mesh"]] = c
    for (arch, shape), meshes in by_cell.items():
        cs = [meshes[m] for m in MESHES if m in meshes]
        cols = [_both([get(c) for c in cs], fmt) for get, fmt in columns]
        rows.append(f"| {arch} {shape} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="results/dryrun_torch")
    p.add_argument("--mesh", default=None)
    args = p.parse_args(argv)
    cells = load_cells(args.dir)
    ok = [c for c in cells if c.get("status") == "ok"]
    print(f"# Roofline ({len(ok)}/{len(cells)} cells ok)\n")
    print(table(cells, mesh=args.mesh))
    if ok:
        worst = min(ok, key=lambda c: (c.get("useful_flops_ratio") or 1))
        coll = max(ok, key=lambda c: c["roofline"]["collective_s"]
                   / max(c["roofline"]["bound_s"], 1e-30))
        print(f"\nworst useful-FLOPs cell: {worst['arch']} x {worst['shape']}"
              f" ({worst.get('useful_flops_ratio'):.3f})")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']}")
    print("\n# Counts and floors, a row an (arch, shape)\n")
    print(floor_table(cells))


if __name__ == "__main__":
    main()
