"""Batched serving with a KV cache on the port: prefill once, decode greedily.

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch hymba-1-5b]
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The PyTorch twin of ``examples/serve_batched.py``, at the smoke config of
any architecture: the hybrid default exercises the ring caches and the
recurrent SSM state (prefill through the windowed ``flash_attention`` and
the ``selective_scan`` kernels, decode through ``decode_attention`` over
the rings). The decode step writes its caches in place, the counterpart of
the JAX example's ``donate_argnums=(2,)``. The prompt ids (and, for the
encoder-decoder, the frames after them) come from ``default_rng(0)`` as the
JAX example draws them; the weights are random from seed 0, or
``main(params=)``'s JAX ``split_params`` tree. See
``repro_torch.launch.serve`` for the CLI.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.serve import generate, serve_batch
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.serve.kv import resolve_device

BATCH, PROMPT_LEN, GEN = 4, 32, 24        # the JAX example's defaults


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="hymba-1-5b")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--prompt-len", type=int, default=PROMPT_LEN)
    p.add_argument("--gen", type=int, default=GEN)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None, *, params=None) -> dict:
    """Serve one batch and return what it printed: ``lines``, the
    prefill's ms, the decode's tok/s and ms a step, the sample ids; with
    ``ids``, every sequence's ``[batch, gen]`` generated ids, and
    ``served``, the ``launch.serve.generate`` result (each step's logits
    kept), with the ``model`` and the ``batch`` it served."""
    args = _parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = (build_model(cfg, device=device, seed=0) if params is None
             else from_jax_params(cfg, params, device=device))
    batch = serve_batch(cfg, args.batch, args.prompt_len, seed=0)
    res = generate(model, batch["tokens"], args.gen,
                   frames=batch.get("frames"), keep_logits=True)
    steps = args.gen - 1
    out = {"prefill_ms": res.prefill_s * 1e3,
           "tok_s": steps * args.batch / res.decode_s,
           "ms_per_step": res.decode_s / steps * 1e3,
           "ids": res.tokens.tolist(), "served": res, "model": model,
           "batch": batch}
    out["sample_ids"] = out["ids"][0][:12]
    out["lines"] = [
        f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
        f"{out['prefill_ms']:.0f}ms",
        f"decode: {steps} steps, {out['tok_s']:.1f} tok/s "
        f"({out['ms_per_step']:.1f} ms/step)",
        f"sample ids: {out['sample_ids']}"]
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    main()
