"""How far each package's bf16 logits drift from its own f32 logits for
qwen3-moe-235b at full width, on the CPU, and how often the two packages
route a token to the same experts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/moe_bf16_drift.py \\
        [--layers 2] [--prompt 32] [--steps 4] [--seed 0]

Both packages hold the same random weights: the port's bf16 init from
``--seed`` (``--layers`` of the config's 94, every width as published,
the router in f32), carried to JAX leaf by leaf; each package's f32 twin
is the same weights upcast. Batch 1, ``--prompt`` ids drawn as the serve
CLIs draw them, a prefill and ``--steps`` decode steps, teacher-forced in
all four runs on the port's bf16 greedy tokens. Each MoE layer's expert
ids are recorded in both packages (in JAX's jitted f32 run by a debug
callback; its bf16 run goes op by op); the port runs its kernels' plain
versions here (the tensors are on the CPU).

Prints, per package, each step's largest and RMS difference between its
bf16 and its f32 logits, and per dtype the share of router assignments
(a token's k experts, compared as sets) on which the two packages agree;
then one JSON line with the worst drift of each package, their ratio
(port over JAX: above 1.5 is a fault of the port) and the agreements
(expected 1.0 in f32). The weights are handed from one package to the
other and upcast leaf by leaf: about 37 GB of host memory at the peak
for 2 layers (12.5 GB of bf16 weights, 24.9 GB in f32), about 25 min.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.launch.serve import prompts
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import load_jax_params

ARCH = "qwen3-moe-235b"


class _Routes:
    """Each MoE layer's expert ids, in the order the layers run, from both
    packages' ``route`` wrapped in place."""

    def __init__(self):
        self.ids: list[np.ndarray] = []
        self._j, self._t = jmoe.route, tmoe.route

        def jax_side(*a):
            out = self._j(*a)
            jax.debug.callback(lambda ids: self.ids.append(np.asarray(ids)),
                               out[1], ordered=True)
            return out

        def port_side(*a):
            out = self._t(*a)
            self.ids.append(out[1].numpy())
            return out
        jmoe.route, tmoe.route = jax_side, port_side

    def take(self) -> list[np.ndarray]:
        out, self.ids = self.ids, []
        return out


def _to_jax(tensor: torch.Tensor):
    """A copy of a CPU tensor as a JAX array (bf16 through its bits)."""
    if tensor.dtype == torch.bfloat16:
        a = tensor.view(torch.int16).numpy().view(jnp.bfloat16)
    else:
        a = tensor.numpy()
    return jnp.array(a, copy=True)


def _nest(flat: dict):
    """Dotted names -> the nested tree (a level of indices: a list)."""
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _jax_params(model, take: bool = False):
    """The port model's parameters as the JAX tree, leaf by leaf; with
    ``take`` each of the model's parameters is emptied once copied, so
    that the two trees are not held at once."""
    flat = {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            flat[name] = _to_jax(param)
            if take:
                param.data = torch.empty(0, dtype=param.dtype)
    return _nest(flat)


def _jax_run(cfg, params, tokens, steps, forced, eager: bool = False):
    """The JAX model's logits at prefill and ``steps`` decode steps (f32
    numpy), teacher-forced on ``forced``. ``eager`` runs op by op: XLA's
    CPU products upcast bf16 weights to f32, which a jitted scan does for
    every layer's experts at once."""
    model = jbuild_model(cfg)
    s = tokens.shape[1]
    jit = (lambda f, **_: f) if eager else jax.jit
    logits, caches = jit(model.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens)}, s + steps)
    out = [np.asarray(logits, np.float32)]
    decode = jit(model.decode_step)
    for i in range(steps):
        logits, caches = decode(params, jnp.asarray(forced[:, i]), caches,
                                jnp.asarray(s + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    jax.effects_barrier()
    return out


def _torch_run(model, tokens, steps, forced):
    s = tokens.shape[1]
    with torch.no_grad():
        logits, caches = model.prefill(torch.from_numpy(tokens), s + steps)
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


def _agreement(a: list, b: list) -> float:
    """The share of (token, layer) expert sets shared, slot by slot."""
    same = total = 0
    for x, y in zip(a, b):
        for r, s in zip(x.reshape(-1, x.shape[-1]), y.reshape(-1,
                                                             y.shape[-1])):
            same += len(np.intersect1d(r, s))
            total += len(r)
    return same / total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=2)
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
    routes = _Routes()
    ids = {}

    model = build_model(tcfg16, device="cpu", seed=args.seed)
    with torch.no_grad():
        logits, caches = model.prefill(torch.from_numpy(tokens),
                                       args.prompt + args.steps)
        greedy = [logits.argmax(-1)]
        for i in range(args.steps - 1):
            logits, caches = model.decode_step(greedy[-1], caches,
                                               args.prompt + i)
            greedy.append(logits.argmax(-1))
    del caches
    routes.take()
    forced = torch.stack(greedy, 1).numpy().astype(np.int32)
    t16 = _torch_run(model, tokens, args.steps, forced)
    ids["port_bf16"] = routes.take()
    params = _jax_params(model, take=True)
    del model
    gc.collect()
    with jax.disable_jit():
        j16 = _jax_run(jcfg16, params, tokens, args.steps, forced,
                       eager=True)
    ids["jax_bf16"] = routes.take()
    model = load_jax_params(build_model(tcfg16, device="cpu"), params)
    del params
    gc.collect()
    model.float()                  # the f32 twin, a leaf at a time
    gc.collect()
    t32 = _torch_run(model, tokens, args.steps, forced)
    ids["port_f32"] = routes.take()
    model.float()        # drops the per-layer views: an emptied leaf frees
    params = _jax_params(model, take=True)
    del model
    gc.collect()
    j32 = _jax_run(jcfg32, params, tokens, args.steps, forced)
    ids["jax_f32"] = routes.take()
    del params

    out = {"arch": ARCH, "layers": args.layers, "batch": 1,
           "prompt": args.prompt, "steps": args.steps,
           "jax": _drift(j16, j32), "port": _drift(t16, t32),
           "port_f32_vs_jax_f32_max": max(float(np.abs(a - b).max())
                                          for a, b in zip(t32, j32)),
           "router_agreement_f32": _agreement(ids["jax_f32"],
                                              ids["port_f32"]),
           "router_agreement_bf16": _agreement(ids["jax_bf16"],
                                               ids["port_bf16"]),
           "router_agreement_jax_bf16_vs_f32": _agreement(ids["jax_bf16"],
                                                          ids["jax_f32"]),
           "router_agreement_port_bf16_vs_f32": _agreement(ids["port_bf16"],
                                                           ids["port_f32"])}
    for name in ("jax", "port"):
        for i, d in enumerate(out[name]):
            print(f"{name} step {i}: bf16 vs its f32 max {d['max']:.6f} "
                  f"RMS {d['rms']:.6f}")
        out[f"{name}_max"] = max(d["max"] for d in out[name])
        out[f"{name}_rms"] = max(d["rms"] for d in out[name])
    print(f"router assignments the packages share: f32 "
          f"{out['router_agreement_f32']:.6f}, bf16 "
          f"{out['router_agreement_bf16']:.6f}")
    out["ratio_max"] = out["port_max"] / out["jax_max"]
    out["ratio_rms"] = out["port_rms"] / out["jax_rms"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
