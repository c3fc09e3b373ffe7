"""How far each package's bf16 logits drift from its own f32 logits for
seamless-m4t-medium at full width, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/encdec_bf16_drift.py \\
        [--prompt 32] [--steps 4] [--seed 0]

Both packages hold the same random weights: the JAX model's bf16 init,
carried to the port by ``registry.from_jax_params``; each package's f32
twin is the same weights upcast. Batch 1, ``--prompt`` ids and
``enc_len(prompt)`` frames drawn as the serve CLIs draw them, a prefill
and ``--steps`` decode steps, teacher-forced in all four runs on the JAX
f32 run's greedy tokens. Prints, per package, each step's largest and RMS
difference between its bf16 and its f32 logits, then one JSON line with
the worst of each and their ratio (port over JAX). The port runs its
kernels' plain versions here (the tensors are on the CPU). About 6 GB of
host memory at its peak (the two packages' weights are not held at once).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models.module import split_params
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.launch.serve import serve_batch
from repro_torch.models.registry import from_jax_params

ARCH = "seamless-m4t-medium"


def _jax_run(cfg, params, tokens, frames, steps, forced=None):
    """The JAX model's logits at prefill and ``steps`` decode steps (f32
    numpy), teacher-forced on ``forced`` (or its own greedy tokens)."""
    model = jbuild_model(cfg)
    s = tokens.shape[1]
    logits, caches = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens),
                 "frames": jnp.asarray(frames, cfg.param_dtype)}, s + steps)
    out = [np.asarray(logits, np.float32)]
    decode = jax.jit(model.decode_step)
    for i in range(steps):
        tok = (forced[:, i] if forced is not None
               else np.argmax(out[-1], -1).astype(np.int32))
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.asarray(s + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out


def _torch_run(cfg, tree, tokens, frames, steps, forced):
    model = from_jax_params(cfg, tree, device="cpu")
    s = tokens.shape[1]
    with torch.no_grad():
        logits, caches = model.prefill(torch.from_numpy(tokens), s + steps,
                                       torch.from_numpy(frames))
        out = [logits.numpy()]
        for i in range(steps):
            logits, caches = model.decode_step(
                torch.from_numpy(forced[:, i]), caches, s + i)
            out.append(logits.numpy())
    return out


def _drift(bf16, f32):
    return [{"max": float(np.abs(a - b).max()),
             "rms": float(np.sqrt(np.mean((a - b) ** 2)))}
            for a, b in zip(bf16, f32)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(8)
    jcfg16 = jbase.get_config(ARCH)
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    tcfg16 = tbase.get_config(ARCH)
    tcfg32 = dataclasses.replace(tcfg16, dtype="float32")
    batch = serve_batch(tcfg16, 1, args.prompt, args.seed)
    tokens = batch["tokens"]
    frames = batch["frames"].float().numpy()     # bf16 values, exact in f32
    params, _ = split_params(jbuild_model(jcfg16).init(
        jax.random.key(args.seed)))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    j32 = _jax_run(jcfg32, params32, tokens, frames, args.steps)
    del params32
    forced = np.stack([np.argmax(x, -1) for x in j32[:-1]], 1).astype(
        np.int32)
    j16 = _jax_run(jcfg16, params, tokens, frames, args.steps, forced)
    tree = jax.tree.map(np.asarray, params)
    del params
    t16 = _torch_run(tcfg16, tree, tokens, frames, args.steps, forced)
    t32 = _torch_run(tcfg32, tree, tokens, frames, args.steps, forced)
    out = {"arch": ARCH, "batch": 1, "prompt": args.prompt,
           "frames": frames.shape[1], "steps": args.steps,
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
