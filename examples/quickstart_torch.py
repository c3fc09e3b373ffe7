"""Quickstart: train a tiny LM with the port's CCache gradient pipeline.

    PYTHONPATH=src python examples/quickstart_torch.py                # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The PyTorch twin of ``examples/quickstart.py``: the public API end to end,
config -> model -> optimizer -> soft-merge gradient accumulation -> train
steps -> checkpoint -> serve a few greedy tokens from the restored
weights (prefill through ``flash_attention``, decode through
``decode_attention`` on the card). The weights are random from seed 0, or
``main(params=)``'s JAX ``split_params`` tree.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch
from torch.utils import _pytree as pytree

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.data.pipeline import batch_at, data_config_for
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.chaos import trees_bitwise_equal
from repro_torch.serve.kv import resolve_device

ARCH = "qwen1_5_0_5b"
SHAPE = ShapeConfig("quickstart", seq_len=64, global_batch=8, kind="train")
STEPS, MICROBATCHES = 40, 2
PROMPT, GEN = 16, 8


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None, *, params=None, dtype=None) -> dict:
    """Train, checkpoint, restore and serve; return what it printed
    (``lines``, the parameter count, ``losses`` and ``gnorms`` by printed
    step, ``greedy`` ids, ``restore_bitwise``) and the served ``model``,
    ``prompt`` and ``served`` (its ``generate`` result, logits kept).
    ``dtype`` replaces the config's (``"float32"``: the loop the tests hold
    to JAX's in f32)."""
    args = _parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = (build_model(cfg, device=device, seed=0) if params is None
             else from_jax_params(cfg, params, device=device))
    opt = adamw(warmup_cosine(3e-3, 10, 100))

    # microbatches=2: gradient accumulation runs as CCache soft-merge —
    # per-microbatch grads coalesce privately, one merge per step.
    step = make_train_step(model, cfg, opt, num_microbatches=MICROBATCHES)

    params = model.params()
    state = {"params": params, "opt": opt.init(params)}
    dcfg = data_config_for(cfg, SHAPE, seed=0)
    out = {"losses": {}, "gnorms": {}, "lines": []}

    def say(line: str) -> None:
        print(line)
        out["lines"].append(line)

    out["params"] = sum(x.numel() for x in pytree.tree_leaves(params))
    say(f"model: {cfg.name}, params = {out['params']:,}")
    for i in range(STEPS):
        state, metrics = step(state, batch_at(dcfg, i))
        if i % 10 == 0 or i == STEPS - 1:
            out["losses"][i] = float(metrics["loss"])
            out["gnorms"][i] = float(metrics["grad_norm"])
            say(f"step {i:3d}  loss {out['losses'][i]:.4f}  "
                f"gnorm {out['gnorms'][i]:.3f}")

    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save(d, STEPS, state, extras={"next_step": STEPS})
        say(f"checkpointed to {path}")
        restored, _ = ckpt.restore(d, state)
    out["restore_bitwise"] = trees_bitwise_equal(restored, state)

    # Serve a few tokens greedily from the restored weights, which the
    # model takes as its own.
    with torch.no_grad():
        for mine, got in zip(pytree.tree_leaves(model.params()),
                             pytree.tree_leaves(restored["params"])):
            mine.copy_(got)
    prompt = batch_at(dcfg, 99)["tokens"][:2, :PROMPT]
    served = generate(model, prompt, GEN, keep_logits=True)
    out["greedy"] = served.tokens[0].tolist()
    say(f"greedy continuation ids: {out['greedy']}")
    out.update(model=model, prompt=prompt, served=served)
    return out


if __name__ == "__main__":
    main()
