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

The production-mesh planner (``launch/steps.py``) runs the same code on
DTensors: ``XLSTMModel(cfg, abstract=True)`` holds no parameters, and
``loss``, ``prefill(..., params=)`` and ``decode_step(...,
params=)`` take its trees; ``state_specs`` / ``state_axes`` and
``input_specs`` / ``input_axes`` are JAX's (the recurrent states are a
decode's ``caches``). The blocks constrain the residual stream as JAX's
do; outside a rules context that is the identity.
"""

from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from repro_torch.models import module as nn
from repro_torch.models import xlstm
from repro_torch.models.embedding import embed
from repro_torch.models.layout import Spec
from repro_torch.models.transformer import (_ACT, _RESID, IMPLS, _matmul_f32,
                                           _plain, _tree, cross_entropy,
                                           remat)
from repro_torch.serve.kv import resolve_device
from repro_torch.sharding.partition import logical_constraint as lc

Tensor = torch.Tensor


class XLSTMModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 impl: str = "kernel", abstract: bool = False):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"XLSTMModel: family {cfg.family!r} is not "
                             f"'ssm'")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{impl!r}")
        self.cfg = cfg
        self.impl = impl      # no kernel of its own: nothing reads it
        k = cfg.slstm_every
        self.kinds = ["slstm" if (k and (i % k == k - 1)) else "mlstm"
                      for i in range(cfg.n_layers)]
        if abstract:        # no parameters: the planner passes its trees
            return
        device = resolve_device(device)
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
        h = lc(h, _RESID)
        x = lc(nn.rmsnorm(p["ln"], h), _ACT)
        if kind == "mlstm":
            y, st = xlstm.apply_seq_with_state(p["mlstm"], x,
                                               self.cfg.n_heads)
        else:
            y, st = xlstm.slstm_apply_seq_with_state(p["slstm"], x,
                                                     self.cfg.n_heads)
        h = h + lc(y, _RESID, _ACT)
        return (h, st) if with_state else h

    def forward(self, params, h: Tensor, positions: Tensor | None = None):
        """The blocks and the final norm over ``h [B, T, D]``, each block
        under ``cfg.remat`` -> (``h``, metrics); the family has none. The
        recurrences need no positions."""
        for p, kind in zip(params["blocks"], self.kinds):
            block = remat(functools.partial(self._block, kind=kind),
                          self.cfg.remat)
            h = block(p, h)
        return nn.rmsnorm(params["ln_f"], lc(h, _RESID)), {}

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens``, ``labels`` ``[B, T]`` on the model's device) under
        ``params`` -> (loss, metrics)."""
        table = params["embed"]["table"]
        h, _ = self.forward(params, embed(table, batch["tokens"]))
        h = lc(h, ("batch", "seq", "embed_act"))
        loss, metrics = cross_entropy(_matmul_f32(h, table.t()),
                                      batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    def _serving(self, params) -> tuple[list[dict], Tensor, dict]:
        """(per-layer trees, embedding table, final norm) of the module's
        own parameters, or of the tree ``params`` (the planner's)."""
        if params is None:
            return _plain(self.blocks), self.embed["table"], self.ln_f
        return params["blocks"], params["embed"]["table"], params["ln_f"]

    def _logits(self, h: Tensor, table: Tensor | None = None) -> Tensor:
        table = self.embed["table"] if table is None else table
        return _matmul_f32(h, table.t())

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int | None = None, *,
                params=None):
        """``tokens [B, T]`` int -> (last-position logits ``[B, V]`` f32,
        per-layer recurrent states). ``cache_len`` is taken for the serve
        loop's sake: the states do not grow. T is a multiple of 256 or
        shorter (the mLSTM chunk). ``params`` (a parameter tree,
        :meth:`params`' layout) is the planner's."""
        blocks, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(table, tokens)
        states = []
        for p, kind in zip(blocks, self.kinds):
            h, st = self._block(p, h, kind, with_state=True)
            states.append(st)
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        return self._logits(h[:, -1], table), states

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, states: list, position: int, *,
                    params=None):
        """``tokens [B]`` int -> (logits ``[B, V]`` f32, new states).
        ``position`` is taken for the serve loop's sake; ``params`` as in
        :meth:`prefill`."""
        cfg = self.cfg
        blocks, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(table, tokens)[:, None, :]
        new = []
        for p, kind, st in zip(blocks, self.kinds, states):
            h = lc(h, _RESID)
            x = nn.rmsnorm(p["ln"], h)
            if kind == "mlstm":
                y, st = xlstm.decode_step(p["mlstm"], x, st, cfg.n_heads)
            else:
                y, st = xlstm.slstm_decode_step(p["slstm"], x, st,
                                                cfg.n_heads)
            h = h + lc(y, _RESID, _ACT)
            new.append(st)
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        return self._logits(h[:, 0], table), new

    # ---------------------------------------------------------- input specs

    def state_specs(self, batch: int) -> list:
        """The recurrent states' :class:`~repro_torch.models.layout.Spec`
        tree, as JAX's ``state_specs``."""
        cfg = self.cfg
        d_inner = int(cfg.d_model * cfg.ssm_expand)
        d_head = d_inner // cfg.n_heads
        f32 = torch.float32
        out = []
        for kind in self.kinds:
            if kind == "mlstm":
                out.append(xlstm.MLSTMState(
                    c=Spec((batch, cfg.n_heads, d_head, d_head), f32),
                    n=Spec((batch, cfg.n_heads, d_head), f32),
                    m=Spec((batch, cfg.n_heads), f32),
                    conv=Spec((batch, 3, d_inner), f32)))
            else:
                s = Spec((batch, cfg.d_model), f32)
                out.append(xlstm.SLSTMState(c=s, n=s, h=s, m=s))
        return out

    def state_axes(self) -> list:
        out = []
        for kind in self.kinds:
            if kind == "mlstm":
                out.append(xlstm.MLSTMState(
                    c=("batch", "heads", None, None),
                    n=("batch", "heads", None), m=("batch", "heads"),
                    conv=("batch", None, "mlp")))
            else:
                ax = ("batch", "embed_act")
                out.append(xlstm.SLSTMState(c=ax, n=ax, h=ax, m=ax))
        return out

    def input_specs(self, shape_cfg) -> dict:
        """Each input's :class:`~repro_torch.models.layout.Spec`, as JAX's
        ``input_specs``."""
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        i32 = torch.int32
        if shape_cfg.kind == "train":
            return {"tokens": Spec((b, s), i32), "labels": Spec((b, s), i32)}
        if shape_cfg.kind == "prefill":
            return {"tokens": Spec((b, s), i32)}
        return {"tokens": Spec((b,), i32), "caches": self.state_specs(b),
                "position": Spec((), i32)}

    def input_axes(self, shape_cfg) -> dict:
        """Logical axes for each input (for shardings)."""
        if shape_cfg.kind == "train":
            return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape_cfg.kind == "prefill":
            return {"tokens": ("batch", "seq")}
        return {"tokens": ("batch",), "caches": self.state_axes(),
                "position": ()}

