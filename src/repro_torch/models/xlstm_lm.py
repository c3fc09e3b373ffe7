"""The xLSTM language model of the port (family ``ssm``): alternating mLSTM
and sLSTM residual blocks, served and trained.

The counterpart of the JAX package's ``repro/models/xlstm_lm.py``
``XLSTMModel``. ``cfg.slstm_every = k`` makes every k-th block an sLSTM (0:
all mLSTM). Blocks are unrolled (heterogeneous): ``blocks`` is a list of
per-block trees, as the JAX tree, so ``from_jax_params`` fills it leaf by
leaf. The logits are tied and f32. The interface is ``DecoderLM``'s:
:meth:`params`, :meth:`forward`, :meth:`loss` (the embedding backward
through the CUDA ``cscatter``), :meth:`prefill` and :meth:`decode_step`;
the model's own parameters are frozen and training is functional.

This family has no attention and so no attention kernel: the recurrences
run in PyTorch, as the JAX package runs them in jnp. Prefill takes each
layer's output and its decode state from one pass over the sequence
(``xlstm.apply_seq_with_state``); JAX's prefill runs every layer a second
time for the state (``_mlstm_prefill_state``, ``_slstm_prefill_state``),
which gives the same values. The recurrent state is O(1) in the context
length.
"""

from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from repro_torch.models import module as nn
from repro_torch.models import xlstm
from repro_torch.models.embedding import embed
from repro_torch.models.transformer import (ATTENTION, _matmul_f32, _plain,
                                           _tree, cross_entropy, remat)
from repro_torch.serve.kv import resolve_device

Tensor = torch.Tensor


class XLSTMModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 attention: str = "kernel"):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"XLSTMModel: family {cfg.family!r} is not "
                             f"'ssm'")
        if attention not in ATTENTION:
            raise ValueError(f"attention must be one of {ATTENTION}, got "
                             f"{attention!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.attention = attention      # no attention layer: nothing reads it
        k = cfg.slstm_every
        self.kinds = ["slstm" if (k and (i % k == k - 1)) else "mlstm"
                      for i in range(cfg.n_layers)]
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = cfg.param_dtype
        blocks = []
        for kind in self.kinds:
            p = {"ln": nn.rmsnorm_init(cfg.d_model, dt, device)}
            if kind == "mlstm":
                p["mlstm"] = xlstm.init(gen, cfg.d_model, cfg.n_heads, dt,
                                        proj_factor=cfg.ssm_expand,
                                        device=device)
            else:
                p["slstm"] = xlstm.slstm_init(gen, cfg.d_model, cfg.n_heads,
                                              dt, device=device)
            blocks.append(p)
        self.embed = _tree({"table": nn.embed_init(
            gen, (cfg.padded_vocab, cfg.d_model), dt, device)})
        self.blocks = _tree(blocks)
        self.ln_f = _tree(nn.rmsnorm_init(cfg.d_model, dt, device))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def params(self) -> dict:
        """The parameters as the JAX package's tree (``blocks`` a list),
        detached tensors that share the module's storage."""
        tree = {"embed": _plain(self.embed), "blocks": _plain(self.blocks),
                "ln_f": _plain(self.ln_f)}
        return torch.utils._pytree.tree_map(lambda t: t.detach(), tree)

    # --------------------------------------------------------------- blocks

    def _block(self, p, h: Tensor, kind: str, with_state: bool = False):
        x = nn.rmsnorm(p["ln"], h)
        if kind == "mlstm":
            y, st = xlstm.apply_seq_with_state(p["mlstm"], x,
                                               self.cfg.n_heads)
        else:
            y, st = xlstm.slstm_apply_seq_with_state(p["slstm"], x,
                                                     self.cfg.n_heads)
        return (h + y, st) if with_state else h + y

    def forward(self, params, h: Tensor, positions: Tensor | None = None):
        """The blocks and the final norm over ``h [B, T, D]``, each block
        under ``cfg.remat`` -> (``h``, metrics); the family has none. The
        recurrences need no positions."""
        for p, kind in zip(params["blocks"], self.kinds):
            block = remat(functools.partial(self._block, kind=kind),
                          self.cfg.remat)
            h = block(p, h)
        return nn.rmsnorm(params["ln_f"], h), {}

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens``, ``labels`` ``[B, T]`` on the model's device) under
        ``params`` -> (loss, metrics)."""
        table = params["embed"]["table"]
        h, _ = self.forward(params, embed(table, batch["tokens"]))
        loss, metrics = cross_entropy(_matmul_f32(h, table.t()),
                                      batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    def _layers(self):
        return zip(_plain(self.blocks), self.kinds)

    def _logits(self, h: Tensor) -> Tensor:
        return _matmul_f32(h, self.embed["table"].t())

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int | None = None):
        """``tokens [B, T]`` int -> (last-position logits ``[B, V]`` f32,
        per-layer recurrent states). ``cache_len`` is taken for the serve
        loop's sake: the states do not grow. T is a multiple of 256 or
        shorter (the mLSTM chunk)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(self.embed["table"], tokens)
        states = []
        for p, kind in self._layers():
            h, st = self._block(p, h, kind, with_state=True)
            states.append(st)
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, -1]), states

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, states: list, position: int):
        """``tokens [B]`` int -> (logits ``[B, V]`` f32, new states).
        ``position`` is taken for the serve loop's sake."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(self.embed["table"], tokens)[:, None, :]
        new = []
        for (p, kind), st in zip(self._layers(), states):
            x = nn.rmsnorm(p["ln"], h)
            if kind == "mlstm":
                y, st = xlstm.decode_step(p["mlstm"], x, st, cfg.n_heads)
            else:
                y, st = xlstm.slstm_decode_step(p["slstm"], x, st,
                                                cfg.n_heads)
            h = h + y
            new.append(st)
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, 0]), new
