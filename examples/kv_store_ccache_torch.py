"""The paper's key-value store on the port's CCache engine and kernels (§3.3).

    PYTHONPATH=src python examples/kv_store_ccache_torch.py            # card
    PYTHONPATH=src python examples/kv_store_ccache_torch.py --device cpu

The PyTorch twin of ``examples/kv_store_ccache.py``. Eight "cores" (the
stacked executor's 8 ranks, ``core/stacked.StackedSPMD``, where the JAX
example vmaps a named axis) increment random keys of a shared table.
Three layers of the port cooperate:

  1. blocked engine  — per-core on-demand privatization with W ways,
     evict-merge + dirty-merge counters (the paper's Fig. 9 machinery);
     on the card every eviction and the flush are ``cmerge`` launches
  2. flexible merge  — cross-core reconciliation with software-defined
     merge functions: plain add, saturating add, complex multiply, and an
     approximate (update-dropping) merge — the §6.3 diversity demo
  3. cscatter kernel — the same computation as one call of the CUDA
     ``cscatter`` (its plain PyTorch version on the CPU)

The inputs are drawn from ``torch.Generator`` seeds (``jax.random`` bits
need JAX); ``main(rows=, vals=)`` takes the JAX example's draws instead.
The dropping merge draws its mask from a ``torch.Generator``, so its kept
share differs from the JAX example's draw; ``kept_sigma`` is the share's
binomial standard deviation for this table's masses.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import blocked, ccache
from repro_torch.core import merge_functions as mf
from repro_torch.core.stacked import StackedSPMD
from repro_torch.kernels import ops
from repro_torch.serve.kv import resolve_device

N_CORES, KEYS, COLS, UPDATES = 8, 256, 4, 512
WAYS, BLOCK_ROWS = 8, 4
DROP = 0.5


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def draw_inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """``rows`` int64 ``[N_CORES, UPDATES]`` in ``[0, KEYS)`` and ``vals``
    ``|normal|`` f32 ``[N_CORES, UPDATES, COLS]``, from seeds 1 and 2 (the
    JAX example's key numbers) on the CPU."""
    rows = torch.randint(0, KEYS, (N_CORES, UPDATES),
                         generator=torch.Generator().manual_seed(1))
    vals = torch.randn((N_CORES, UPDATES, COLS),
                       generator=torch.Generator().manual_seed(2)).abs()
    return rows, vals


def main(argv=None, *, rows=None, vals=None) -> dict:
    """Run the demo and return what it printed: ``lines`` and each
    number. ``rows`` / ``vals`` (arrays of :func:`draw_inputs`' shapes)
    replace the seeded draws."""
    args = _parse_args(argv)
    device = resolve_device(args.device)
    if rows is None or vals is None:
        rows, vals = draw_inputs()
    rows = torch.as_tensor(np.array(rows), device=device).long()
    vals = torch.as_tensor(np.array(vals), dtype=torch.float32,
                           device=device)
    table = torch.zeros(KEYS, COLS, device=device)
    spmd = StackedSPMD(N_CORES, device)
    axis = spmd.axis
    shared = table.expand(N_CORES, KEYS, COLS).clone()   # every core's copy
    out, lines = {}, []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    # --- 1. per-core privatization through the blocked source buffer -----
    def cores(rows_c, vals_c, src):
        cache = blocked.init_cache(N_CORES, ways=WAYS, block_rows=BLOCK_ROWS,
                                   cols=COLS, dtype=src.dtype, device=device)
        local = src.clone()
        cache, local = blocked.cop_scatter(cache, local, rows_c, vals_c,
                                           mf.ADD)
        cache, local = blocked.flush(cache, local, mf.ADD)
        # delta vs. the shared source copy, then the flexible tree merge
        merged = ccache.merge(ccache.CView(src=src, upd=local), src, axis,
                              mf.ADD)
        return merged, cache.n_evict_merges, cache.n_flush_merges

    merged, evicts, flushes = spmd(cores, rows, vals, shared)
    gold = table.index_add(0, rows.reshape(-1), vals.reshape(-1, COLS))
    out["blocked_err"] = float((merged[0] - gold).abs().max())
    out["evict_merges"] = evicts.tolist()
    out["flush_merges"] = flushes.tolist()
    say(f"[blocked+tree-merge] max err vs serialization: "
        f"{out['blocked_err']:.2e}")
    say(f"  evict-merges/core: {out['evict_merges']}")
    say(f"  flush-merges/core: {out['flush_merges']}")

    # --- 2. merge-function diversity (paper §6.3) ------------------------
    core_rows = torch.arange(N_CORES, device=device)[:, None] * KEYS + rows
    upds = torch.zeros(N_CORES * KEYS, COLS, device=device).index_add_(
        0, core_rows.reshape(-1), vals.reshape(-1, COLS)).view(
        N_CORES, KEYS, COLS)
    sat_add = mf.saturating_add(3.0)
    sat = ccache.reduce_update(upds, axis, sat_add, force_tree=True)
    out["sat_max"] = float(sat_add.apply(table, sat[0]).max())
    say(f"[saturating merge] table max = {out['sat_max']:.2f} (cap 3.0)")

    drop = mf.dropping_add(DROP)
    total = ccache.reduce_update(upds, axis, drop)
    key = torch.Generator(device=device).manual_seed(7)
    approx = drop.apply(table, total[0], key=key)
    out["kept"] = float(approx.sum() / gold.sum())
    # each element's whole mass is kept or dropped: a Bernoulli(1 - DROP)
    # weighted by its share of the mass
    mass = total[0].double()
    out["kept_sigma"] = float((DROP * (1 - DROP) * (mass ** 2).sum()).sqrt()
                              / mass.sum())
    say(f"[approximate merge] kept {out['kept']:.0%} of update mass "
        f"({DROP:.0%} drop target)")

    z = torch.tensor([[1.0, 0.2]], device=device).repeat(KEYS, 1)   # 1+0.2i
    factors = torch.tensor([[[1.0, 0.1]]], device=device).repeat(
        N_CORES, KEYS, 1)
    prod = ccache.reduce_update(factors, axis, mf.COMPLEX_MUL)
    zm = mf.COMPLEX_MUL.apply(z, prod[0])
    out["z0"] = (float(zm[0, 0]), float(zm[0, 1]))
    say(f"[complex-mul merge] z[0] = {out['z0'][0]:.3f}{out['z0'][1]:+.3f}i"
        f"  (= (1+0.2i)*(1+0.1i)^8)")

    # --- 3. the same scatter as one kernel call --------------------------
    # JAX's block_rows=32, chunk=128 have no counterpart: the CUDA kernel
    # plans its own tiling from the ids it is given
    scattered = ops.commutative_scatter(
        table.clone(), rows.reshape(-1).to(torch.int32),
        vals.reshape(-1, COLS), kind="add")
    out["cscatter_err"] = float((scattered - gold).abs().max())
    say(f"[cscatter kernel] max err vs serialization: "
        f"{out['cscatter_err']:.2e}")
    out["lines"] = lines
    return out


if __name__ == "__main__":
    main()
