"""Whether the port's full-width training steps follow the JAX package's:
the losses and every parameter's update over a few AdamW steps, in f32, on
the CPU, from the same random weights.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_drift.py \\
        [--arch hymba-1-5b|qwen3-moe-235b|both] [--steps 3] [--batch 2] \\
        [--seq 64] [--experts 32] [--seed 0]

Each model runs at the widths its config publishes, its depth cut:
hymba-1.5b to layers 0-1 (layer 0 attends globally, layer 1 through its
window); qwen3-moe-235b to 1 of 94 layers with its experts cut from 128 to
``--experts`` (the width, top-8, the expert width and the router kept),
because with 128 experts a package's f32 weights, gradients and two
moments come to ~60 GB. The port holds the card runs' paths: qwen3-moe's MoE layer
through ``apply_ep`` over 4 stacked model ranks and a donating AdamW step
(``chip_smoke.py``'s ``--model-ranks 4 --donate``); JAX's runs
``moe.apply`` (no mesh), which the CPU tests hold ``apply_ep`` to. The
optimizer is the config's at the card runs' schedule, ``warmup_cosine(3e-4,
2, steps)``; the batches are the JAX data pipeline's Zipf stream.

The packages run one after the other, to keep one model's training state
in memory at a time: the port first (its weights from ``--seed``; its
final weights then wait in a temporary directory), then JAX from the same
initial weights, leaf by leaf. Prints each step's loss in
both packages, then each leaf's update (final minus initial weights): the
port's difference from JAX's as an RMS over JAX's update's RMS and as a
largest over JAX's largest, and the share of entries off by more than
1e-3 of that largest; one JSON line last: the losses, the worst leaf, and
``agree`` (losses to 1e-4 relative and every leaf's update to 1e-3 in RMS).
The largest difference is no criterion: AdamW's first steps are near
``lr * sign(g)``, so an entry whose gradient is at f32 rounding noise can
take a whole lr-sized step the other way in the other package.
About 3 GB of host memory and 2 min for hymba; for qwen3-moe about four
times its f32 weights (7.7 GB at 32 experts), and as much again on disk.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models.registry import build_model as jbuild_model
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs import base as tbase
from repro_torch.core import grad_merge as gm
from repro_torch.models.registry import build_model
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

LR, WARMUP = 3e-4, 2          # chip_smoke.py's TRAIN_LR, TRAIN_WARMUP
LOSS_RTOL, UPDATE_TOL = 1e-4, 1e-3
MOE_RANKS = 4


def _configs(arch: str, experts: int):
    over = {"dtype": "float32"}
    if arch == "qwen3-moe-235b":
        over.update(n_layers=1, n_experts=experts)
    else:
        over.update(n_layers=2)
    return (dataclasses.replace(jbase.get_config(arch), **over),
            dataclasses.replace(tbase.get_config(arch), **over))


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy_tree(tree):
    """A writable numpy copy of a torch or JAX tree."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy().copy()
        return np.array(x, copy=True)
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return leaf(tree)


def _batches(cfg, args):
    dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                            global_batch=args.batch, seed=args.seed)
    return [jpipe.batch_at(dcfg, t) for t in range(args.steps)]


def _port_model(tcfg, arch: str, seed: int):
    ranks = MOE_RANKS if arch == "qwen3-moe-235b" else None
    return build_model(tcfg, device="cpu", seed=seed, model_ranks=ranks)


def _port_run(tcfg, arch, args, batches):
    """The port's losses and final weights (numpy), its donating AdamW
    step as on the card."""
    model = _port_model(tcfg, arch, args.seed)
    opt = topt.make_optimizer(tcfg, tsched.warmup_cosine(LR, WARMUP,
                                                         args.steps))
    vg = gm.value_and_grad(lambda p, b: model.loss(p, b)[0])
    params = model.params()
    state = opt.init(params)
    losses = []
    for batch in batches:
        loss, grads = vg(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        params, state, _ = opt.step(params, grads, state, donate=True)
        del grads
        losses.append(float(loss))
        print(f"port step {len(losses)}: loss {losses[-1]:.6f}", flush=True)
    del state, vg
    final = _numpy_tree(params)
    del params, model
    gc.collect()
    return losses, final


def _jax_run(jcfg, tcfg, arch, args, batches):
    """JAX's losses and final weights from the port's initial weights."""
    model = _port_model(tcfg, arch, args.seed)
    params = jax.tree.map(jnp.asarray, _numpy_tree(model.params()))
    del model
    gc.collect()
    jmodel = jbuild_model(jcfg)
    opt = jopt.make_optimizer(jcfg, jsched.warmup_cosine(LR, WARMUP,
                                                         args.steps))

    def step(p, s, b):
        loss, g = jax.value_and_grad(lambda q: jmodel.loss(q, b)[0])(p)
        p, s, _ = opt.step(p, g, s)
        return p, s, loss

    jstep = jax.jit(step, donate_argnums=(0, 1))
    state = opt.init(params)
    losses = []
    for batch in batches:
        params, state, loss = jstep(params, state,
                                    jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
        print(f"jax  step {len(losses)}: loss {losses[-1]:.6f}", flush=True)
    del state
    final = _numpy_tree(params)
    del params
    gc.collect()
    return losses, final


def drift(arch: str, args) -> dict:
    jcfg, tcfg = _configs(arch, args.experts)
    batches = _batches(tcfg, args)
    tl, tfinal = _port_run(tcfg, arch, args, batches)
    # the port's weights wait on disk while JAX trains
    spill = tempfile.TemporaryDirectory()
    names = sorted(_flat(tfinal))
    for i, (k, v) in enumerate(sorted(_flat(tfinal).items())):
        np.save(os.path.join(spill.name, f"{i}.npy"), v)
    del tfinal, v
    gc.collect()
    jl, jfinal = _jax_run(jcfg, tcfg, arch, args, batches)
    tfinal = {k: np.load(os.path.join(spill.name, f"{i}.npy"),
                         mmap_mode="r") for i, k in enumerate(names)}
    jfinal = _flat(jfinal)
    init = _flat(_numpy_tree(_port_model(tcfg, arch, args.seed).params()))
    assert sorted(init) == sorted(tfinal) == sorted(jfinal)
    leaves = {}
    for k in sorted(tfinal):
        # dport - dJAX is the final weights' difference; f32 throughout
        # (the embedding's arrays are GBs each at qwen3-moe's vocab)
        err = np.abs(tfinal.pop(k) - jfinal[k])
        dj = np.subtract(jfinal.pop(k), init.pop(k))
        scale = float(np.abs(dj).max())
        leaves[k] = {
            "update_max": scale,
            "max_ratio": float(err.max()) / max(scale, 1e-30),
            "rms_ratio": float(np.sqrt(np.mean(err ** 2))
                               / max(np.sqrt(np.mean(dj ** 2)), 1e-30)),
            "share_off": float(np.mean(err > UPDATE_TOL * scale))}
        print(f"  {k}: |dJAX| {scale:.3e}  max {leaves[k]['max_ratio']:.3e}"
              f"  rms {leaves[k]['rms_ratio']:.3e}  share off "
              f"{leaves[k]['share_off']:.3e}")
    worst = max(leaves, key=lambda k: leaves[k]["rms_ratio"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tl, jl))
    del tfinal
    spill.cleanup()
    out = {"arch": arch, "layers": tcfg.n_layers, "steps": args.steps,
           "batch": args.batch, "seq": args.seq,
           "experts": tcfg.n_experts or None,
           "losses_port": tl, "losses_jax": jl, "loss_max_rel": loss_rel,
           "worst_leaf": worst, "worst": leaves[worst],
           "max_share_off": max(v["share_off"] for v in leaves.values()),
           "agree": bool(loss_rel <= LOSS_RTOL and all(
               v["rms_ratio"] <= UPDATE_TOL for v in leaves.values()))}
    if arch == "qwen3-moe-235b":
        out["cut"] = (f"experts 128 -> {args.experts}; d_model, top_k, "
                      f"d_ff_expert and the router as published")
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="both",
                   choices=["hymba-1-5b", "qwen3-moe-235b", "both"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--experts", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(8)
    archs = (["hymba-1-5b", "qwen3-moe-235b"] if args.arch == "both"
             else [args.arch])
    out = [drift(a, args) for a in archs]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
