"""Batched LM serving driver: prefill a batch of prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1-5-0-5b \\
        --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1-5-0-5b \\
        --smoke --device cpu

The port of the JAX package's ``repro/launch/serve.py``: random weights
from ``--seed`` (no checkpoint is read), random prompt ids from the same
seed, a prefill and a fixed-shape greedy decode step for the whole batch.
Every ported family serves through :func:`generate`, whose model carries
its own decode state: the dense LMs and Hymba (``--arch hymba-1-5b``)
prefill through ``flash_attention`` (Hymba's windowed layers with their
window) and decode through ``decode_attention`` (Hymba's windowed layers
over a ring of W slots), with the caches updated in place; xLSTM
(``--arch xlstm-125m``) has no attention and carries recurrent states
(its prompt, like Hymba's, is a multiple of 256 tokens or shorter); the
encoder-decoder (``--arch seamless-m4t-medium``) also takes the frame
embeddings the JAX CLI draws after the prompts (:func:`serve_batch`),
encodes them at prefill and reads its cross cache at every decode step.
The MoE family (``--arch qwen3-moe-235b``, ``kimi-k2-1t``) routes each
token through its experts and combines their outputs through ``cscatter``;
the VLM backbone (``--arch llava-next-34b``) serves the prompt ids the JAX
CLI draws, and :func:`generate` also prefills it from precomputed patch
and text embeddings (``embeds=``, the JAX prefill's ``batch["embeds"]``).
It runs on the card (``--device cuda``, the default) and
raises when there is none, unless ``--device cpu`` asks for the CPU, where
the kernels' plain versions run. One card has no mesh: the JAX CLI's mesh
and lowering rules have no counterpart here. It prints the JAX CLI's three
lines. ``--profile`` then traces one more prefill and three decode steps
with ``torch.profiler`` and prints, for each, the kernel launches, host
and device time, and the operators that take the most device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models.encdec import enc_len
from repro_torch.models.registry import build_model
from repro_torch.serve.kv import resolve_device


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # [B, gen] int64, the generated ids
    prefill_s: float
    decode_s: float
    logits: list                # [B, V] f32 per step when kept, else empty


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The batch the JAX CLI draws for the same arguments, from one
    ``default_rng(seed)``: ``tokens`` (int32 prompt ids) and, for the
    encoder-decoder, then ``frames``, standard normals ``[batch,
    enc_len(prompt_len), d_model]`` cast from float64 to the parameters'
    dtype (a CPU tensor)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, enc_len(prompt_len), cfg.d_model))).to(cfg.param_dtype)
    return out


def prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The prompt ids the JAX CLI draws for the same arguments."""
    return serve_batch(cfg, batch, prompt_len, seed)["tokens"]


def _prefill(model, tokens, cache_len: int, frames, embeds=None):
    if embeds is not None:
        return model.prefill(tokens, cache_len, embeds=embeds)
    if frames is None:
        return model.prefill(tokens, cache_len)
    return model.prefill(tokens, cache_len, frames)


def _prompt_len(tokens, embeds) -> int:
    return (embeds if embeds is not None else tokens).shape[1]


def generate(model, tokens, gen: int, *, frames=None, embeds=None,
             keep_logits: bool = False) -> ServeResult:
    """Prefill ``tokens [B, P]`` (an encoder-decoder with its ``frames``;
    the VLM from ``embeds [B, P, D]`` instead, cast to the parameters'
    dtype, with ``tokens`` then unused) and decode ``gen - 1`` greedy steps
    after the prefill's token (``gen`` tokens in all), timing each phase
    between two synchronisations of the card."""
    device = model.device
    if embeds is None:
        tokens = torch.as_tensor(tokens, device=device)
    prompt = _prompt_len(tokens, embeds)
    cache_len = prompt + gen
    kept = []
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = _prefill(model, tokens, cache_len, frames, embeds)
    tok = logits.argmax(-1)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    if keep_logits:
        kept.append(logits)
    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = model.decode_step(tok, caches, prompt + i)
        tok = logits.argmax(-1)
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t1
    return ServeResult(torch.stack(out, 1), prefill_s, decode_s, kept)


def profile(model, tokens, steps: int = 3, rows: int = 12, *,
            frames=None, embeds=None) -> dict:
    """Trace one prefill of ``tokens`` (with ``frames`` for an
    encoder-decoder; of ``embeds`` for the VLM) and ``steps`` greedy
    decode steps
    after it with ``torch.profiler`` (CPU and CUDA activities); print the
    operators with the most device time and return, per phase, the kernel
    launches, host time and device time (ms, per decode step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    device = model.device
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if embeds is None:
        tokens = torch.as_tensor(tokens, device=device)
    prompt = _prompt_len(tokens, embeds)
    cache_len = prompt + steps + 1
    out = {}
    for phase in ("prefill", "decode"):
        if phase == "decode":
            logits, caches = _prefill(model, tokens, cache_len, frames,
                                      embeds)
            tok = logits.argmax(-1)
        _sync(device)
        t0 = time.perf_counter()
        with trace(activities=acts) as prof:
            if phase == "prefill":
                _prefill(model, tokens, cache_len, frames, embeds)
            else:
                for i in range(steps):
                    logits, caches = model.decode_step(tok, caches,
                                                       prompt + i)
                    tok = logits.argmax(-1)
            _sync(device)
        host_s = time.perf_counter() - t0
        n = 1 if phase == "prefill" else steps
        events = prof.key_averages()
        launches = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cuLaunchKernelEx"))
        # the kernels' own rows (an operator's row repeats its kernels')
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        out[phase] = {"launches": launches / n, "host_ms": 1e3 * host_s / n,
                      "device_ms": device_us / 1e3 / n}
        print(f"profile {phase} (per {'step' if n > 1 else 'call'}): "
              f"{out[phase]['launches']:.0f} kernel launches, host "
              f"{out[phase]['host_ms']:.3f} ms (traced), device "
              f"{out[phase]['device_ms']:.3f} ms")
        print(events.table(sort_by="self_device_time_total" if acts[1:]
                           else "self_cpu_time_total", row_limit=rows,
                           max_name_column_width=60))
    return out


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="then trace a prefill and 3 decode steps")
    return p.parse_args(argv)


def main(argv=None) -> ServeResult:
    args = _parse_args(argv)
    if args.gen < 1:
        raise SystemExit("--gen must be >= 1")
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = build_model(cfg, device=device, seed=args.seed)
    batch = serve_batch(cfg, args.batch, args.prompt_len, args.seed)
    res = generate(model, batch["tokens"], args.gen,
                   frames=batch.get("frames"))
    steps = args.gen - 1
    print(f"prefill: {args.batch}x{args.prompt_len} tok "
          f"in {res.prefill_s * 1e3:.1f}ms")
    print(f"decode: {steps} steps x {args.batch} seqs in "
          f"{res.decode_s * 1e3:.1f}ms "
          f"({steps * args.batch / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("generated ids[0]:", res.tokens[0].tolist())
    if args.profile:
        profile(model, batch["tokens"], frames=batch.get("frames"))
    return res


if __name__ == "__main__":
    main()
