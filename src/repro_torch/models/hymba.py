"""The Hymba-style hybrid LM of the port (family ``hybrid``): parallel
attention and Mamba (SSM) heads in every block, served and trained.

The counterpart of the JAX package's ``repro/models/hymba.py``
``HymbaModel``. Each block feeds the same normalised input to GQA attention
and to a selective SSM (``models/ssm.py``), normalises both outputs and
averages them with learnable per-branch scales (``beta``, f32), then
applies a SwiGLU FFN. Layers in ``cfg.full_attn_layers`` attend globally
(causal); the others through a sliding window of ``cfg.sliding_window``.
Blocks are stacked ``[L, ...]`` as the JAX tree, so ``from_jax_params``
fills them leaf by leaf. The logits are tied and f32; the interface is
``DecoderLM``'s.

Serving runs the attention kernels in every layer: prefill through
``flash_attention`` (windowed layers with ``window=W``, global ones
causal), decode through ``decode_attention`` (windowed layers over their
ring of W slots, ``attention.ring_decode_step``; global ones over a cache
of ``cache_len`` slots). ``attention="plain"`` takes the kernels' plain
versions. Training attends through the plain ``attention.attend_full``
("sliding", with a window of ``_BIG_WINDOW`` for the global layers, which
equals causal), as JAX does. Prefill takes each layer's SSM output and its
decode state from one pass (``ssm.apply_seq_with_state``); JAX runs the
SSM a second time for the state (``_ssm_prefill``), with the same values.
The SSM's conv history has the model's dtype.
"""

from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from repro_torch.models import attention as attn
from repro_torch.models import module as nn
from repro_torch.models import ssm
from repro_torch.models.embedding import embed
from repro_torch.models.mlp import swiglu, swiglu_init
from repro_torch.models.transformer import (ATTENTION, _index, _matmul_f32,
                                           _plain, _stack, _tree,
                                           _unbind_layers, cross_entropy,
                                           remat)
from repro_torch.serve.kv import resolve_device

Tensor = torch.Tensor
_BIG_WINDOW = 1 << 30      # a sliding window so large it equals causal


class HymbaModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 attention: str = "kernel"):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HymbaModel: family {cfg.family!r} is not "
                             f"'hybrid'")
        device = resolve_device(device)
        self.cfg = cfg
        self.attention = attention
        full = set(cfg.full_attn_layers)
        self.is_global = [i in full for i in range(cfg.n_layers)]
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = cfg.param_dtype
        d_inner = int(cfg.d_model * cfg.ssm_expand)

        def block() -> dict:
            return {
                "ln1": nn.rmsnorm_init(cfg.d_model, dt, device),
                "attn": attn.init(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.resolved_head_dim, dt,
                                  device=device),
                "ssm": ssm.init(gen, cfg.d_model, cfg.ssm_state, d_inner, dt,
                                device=device),
                "ln_attn": nn.rmsnorm_init(cfg.d_model, dt, device),
                "ln_ssm": nn.rmsnorm_init(cfg.d_model, dt, device),
                "beta": torch.ones((2,), dtype=torch.float32, device=device),
                "ln2": nn.rmsnorm_init(cfg.d_model, dt, device),
                "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device),
            }

        self.embed = _tree({"table": nn.embed_init(
            gen, (cfg.padded_vocab, cfg.d_model), dt, device)})
        self.blocks = _tree(_stack([block() for _ in range(cfg.n_layers)]))
        self.ln_f = _tree(nn.rmsnorm_init(cfg.d_model, dt, device))
        self._layers = None

    @property
    def attention(self) -> str:
        return self._attention

    @attention.setter
    def attention(self, value: str) -> None:
        if value not in ATTENTION:
            raise ValueError(f"attention must be one of {ATTENTION}, got "
                             f"{value!r}")
        self._attention = value

    def _apply(self, fn, *args, **kwargs):
        self._layers = None       # .to() and friends make new tensors
        return super()._apply(fn, *args, **kwargs)

    def layers(self) -> list[dict]:
        """Per-layer views of the stacked block parameters."""
        if self._layers is None:
            tree = _plain(self.blocks)
            self._layers = [_index(tree, i)
                            for i in range(self.cfg.n_layers)]
        return self._layers

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def windows(self) -> list[int]:
        """Each layer's sliding window (``_BIG_WINDOW``: global)."""
        w = self.cfg.sliding_window or _BIG_WINDOW
        return [_BIG_WINDOW if g else w for g in self.is_global]

    def params(self) -> dict:
        """The parameters as the JAX package's tree, detached tensors that
        share the module's storage."""
        tree = {"embed": _plain(self.embed), "blocks": _plain(self.blocks),
                "ln_f": _plain(self.ln_f)}
        return torch.utils._pytree.tree_map(lambda t: t.detach(), tree)

    # --------------------------------------------------------------- blocks

    def _mix(self, p, h: Tensor, a: Tensor, s: Tensor) -> Tensor:
        beta = p["beta"].float()
        mixed = 0.5 * (beta[0] * nn.rmsnorm(p["ln_attn"], a).float()
                       + beta[1] * nn.rmsnorm(p["ln_ssm"], s).float())
        h = h + mixed.to(h.dtype)
        return h + swiglu(p["ffn"], nn.rmsnorm(p["ln2"], h))

    def _block(self, p, h: Tensor, positions: Tensor, window: int) -> Tensor:
        cfg = self.cfg
        x = nn.rmsnorm(p["ln1"], h)
        a = attn.attend_full(p["attn"], x, positions, cfg.n_heads,
                             cfg.n_kv_heads, "sliding", window=window,
                             rope_theta=cfg.rope_theta)
        return self._mix(p, h, a, ssm.apply_seq(p["ssm"], x))

    def forward(self, params, h: Tensor, positions: Tensor):
        """The blocks and the final norm over ``h [B, S, D]``, each block
        under ``cfg.remat`` -> (``h``, metrics); the family has none."""
        block = remat(functools.partial(self._block, positions=positions),
                      self.cfg.remat)
        for p, w in zip(_unbind_layers(params["blocks"]), self.windows()):
            h = block(p, h, window=w)
        return nn.rmsnorm(params["ln_f"], h), {}

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens``, ``labels`` ``[B, S]`` on the model's device) under
        ``params`` -> (loss, metrics)."""
        table = params["embed"]["table"]
        h = embed(table, batch["tokens"])
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, _ = self.forward(params, h, positions)
        loss, metrics = cross_entropy(_matmul_f32(h, table.t()),
                                      batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    def _logits(self, h: Tensor) -> Tensor:
        return _matmul_f32(h, self.embed["table"].t())

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int):
        """``tokens [B, S]`` int -> (last-position logits ``[B, V]`` f32,
        per-layer caches ``{"kv": KVCache [B, cache_len, KV, hd] (global)
        or RingKVCache [B, W, KV, hd] (windowed), "ssm": SSMState}``). S is
        a multiple of 256 or shorter (the SSM chunk)."""
        cfg = self.cfg
        plain = self.attention == "plain"
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        h = nn.embed(self.embed["table"], tokens)
        positions = torch.arange(s, dtype=torch.int32, device=self.device)
        caches = []
        for p, g in zip(self.layers(), self.is_global):
            x = nn.rmsnorm(p["ln1"], h)
            if g:
                a, kv = attn.prefill(p["attn"], x, positions, cfg.n_heads,
                                     cfg.n_kv_heads, cache_len,
                                     rope_theta=cfg.rope_theta, plain=plain)
            else:
                a, kv = attn.ring_prefill(p["attn"], x, positions,
                                          cfg.n_heads, cfg.n_kv_heads,
                                          cfg.sliding_window,
                                          rope_theta=cfg.rope_theta,
                                          plain=plain)
            s_out, sst = ssm.apply_seq_with_state(p["ssm"], x)
            h = self._mix(p, h, a, s_out)
            caches.append({"kv": kv, "ssm": sst})
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: list, position: int):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32, the
        caches, the attention caches updated in place)."""
        cfg = self.cfg
        plain = self.attention == "plain"
        position = int(position)
        tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(self.embed["table"], tokens)[:, None, :]
        new = []
        for p, g, c in zip(self.layers(), self.is_global, caches):
            x = nn.rmsnorm(p["ln1"], h)
            if g:
                a, kv = attn.decode_step(p["attn"], x, c["kv"], position,
                                         cfg.n_heads, cfg.n_kv_heads,
                                         rope_theta=cfg.rope_theta,
                                         plain=plain)
            else:
                a, kv = attn.ring_decode_step(p["attn"], x, c["kv"],
                                              position, cfg.n_heads,
                                              cfg.n_kv_heads,
                                              cfg.sliding_window,
                                              rope_theta=cfg.rope_theta,
                                              plain=plain)
            s_out, sst = ssm.decode_step(p["ssm"], x, c["ssm"])
            h = self._mix(p, h, a, s_out)
            new.append({"kv": kv, "ssm": sst})
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, 0]), new
