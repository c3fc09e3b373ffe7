"""How far each package's bf16 logits drift from its own f32 logits for
xlstm-125m at full width and depth, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_bf16_drift.py \\
        [--layers 12] [--prompt 32] [--steps 4] [--seed 0]

Both packages hold the same random weights: the port's bf16 init from
``--seed`` (``--layers`` of the config's 12, every width as published; at
the default depth the 9 mLSTM and 3 sLSTM blocks), carried to JAX leaf by
leaf; each package's f32 twin is the same weights upcast. Batch 1,
``--prompt`` ids drawn as the serve CLIs draw them, a prefill (the mLSTM's
chunkwise form, the sLSTM's loop over time) and ``--steps`` recurrent
decode steps, teacher-forced in all four runs on the port's bf16 greedy
tokens. No kernel of the port is on this path.

Prints, per package, each step's largest and RMS difference between its
bf16 and its f32 logits, then one JSON line with the worst drift of each
package and their ratio (port over JAX: above 1.5 is a fault of the port).
About 2 GB of host memory and a minute or two.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import jax
import numpy as np
import torch

from moe_bf16_drift import _drift, _jax_params, _jax_run, _torch_run
from repro.configs import base as jbase
from repro_torch.configs import base as tbase
from repro_torch.launch.serve import prompts
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import load_jax_params

ARCH = "xlstm-125m"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(8)
    jcfg16 = dataclasses.replace(jbase.get_config(ARCH),
                                 n_layers=args.layers)
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    tcfg16 = dataclasses.replace(tbase.get_config(ARCH),
                                 n_layers=args.layers)
    tokens = prompts(tcfg16, 1, args.prompt, args.seed)

    model = build_model(tcfg16, device="cpu", seed=args.seed)
    kinds = list(model.kinds)
    with torch.no_grad():
        logits, caches = model.prefill(torch.from_numpy(tokens),
                                       args.prompt + args.steps)
        greedy = [logits.argmax(-1)]
        for i in range(args.steps - 1):
            logits, caches = model.decode_step(greedy[-1], caches,
                                               args.prompt + i)
            greedy.append(logits.argmax(-1))
    del caches
    forced = torch.stack(greedy, 1).numpy().astype(np.int32)
    t16 = _torch_run(model, tokens, args.steps, forced)
    params = _jax_params(model, take=True)
    del model
    gc.collect()
    with jax.disable_jit():
        j16 = _jax_run(jcfg16, params, tokens, args.steps, forced,
                       eager=True)
    model = load_jax_params(build_model(tcfg16, device="cpu"), params)
    del params
    gc.collect()
    model.float()                  # the f32 twin, a leaf at a time
    t32 = _torch_run(model, tokens, args.steps, forced)
    model.float()        # drops the per-layer views: an emptied leaf frees
    params = _jax_params(model, take=True)
    del model
    gc.collect()
    j32 = _jax_run(jcfg32, params, tokens, args.steps, forced)
    del params

    out = {"arch": ARCH, "layers": args.layers,
           "kinds": kinds,
           "batch": 1, "prompt": args.prompt, "steps": args.steps,
           "jax": _drift(j16, j32), "port": _drift(t16, t32),
           "port_f32_vs_jax_f32_max": max(float(np.abs(a - b).max())
                                          for a, b in zip(t32, j32))}
    for name in ("jax", "port"):
        for i, d in enumerate(out[name]):
            print(f"{name} step {i}: bf16 vs its f32 max {d['max']:.6f} "
                  f"RMS {d['rms']:.6f}")
        out[f"{name}_max"] = max(d["max"] for d in out[name])
        out[f"{name}_rms"] = max(d["rms"] for d in out[name])
    out["ratio_max"] = out["port_max"] / out["jax_max"]
    out["ratio_rms"] = out["port_rms"] / out["jax_rms"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
