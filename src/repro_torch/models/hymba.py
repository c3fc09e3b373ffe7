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
of ``cache_len`` slots). Training attends through the plain
``attention.attend_full`` ("sliding", with a window of ``_BIG_WINDOW`` for
the global layers, which equals causal), as JAX does. Prefill and training
run every layer's SSM (``ssm.apply_seq``) through ``ops.selective_scan``,
the CUDA scan kernel on the card, forward and backward.
``impl="plain"`` takes the kernels' plain versions: the plain attention
and ``selective_scan_plain``. Prefill takes each layer's SSM output and its
decode state from one pass (``ssm.apply_seq_with_state``); JAX runs the
SSM a second time for the state (``_ssm_prefill``), with the same values.
The SSM's conv history has the model's dtype.

The production-mesh planner (``launch/steps.py``) runs the same code on
DTensors: ``HymbaModel(cfg, abstract=True)`` holds no parameters, and
``loss``, ``prefill(..., params=, caches=)`` and ``decode_step(...,
params=)`` take its trees; ``cache_specs`` / ``cache_axes`` and
``input_specs`` / ``input_axes`` are JAX's (a ``RingKVCache`` of ``min(W,
len)`` slots for a windowed layer, ``SSMState(h f32 [B, d_inner, S], conv
[B, 3, d_inner])``). The blocks constrain the residual stream as JAX's do
and each branch's output back onto it (``_RESID``, ``_ACT``); outside a
rules context that is the identity.
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
from repro_torch.models.layout import Spec
from repro_torch.models.transformer import (_ACT, _RESID, IMPLS, _index,
                                           _matmul_f32, _plain, _stacked_init,
                                           _tree, _unbind_layers,
                                           cross_entropy, remat)
from repro_torch.serve.kv import resolve_device
from repro_torch.sharding.partition import logical_constraint as lc

Tensor = torch.Tensor
_BIG_WINDOW = 1 << 30      # a sliding window so large it equals causal


class HymbaModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 impl: str = "kernel", abstract: bool = False):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HymbaModel: family {cfg.family!r} is not "
                             f"'hybrid'")
        self.cfg = cfg
        self.impl = impl
        full = set(cfg.full_attn_layers)
        self.is_global = [i in full for i in range(cfg.n_layers)]
        self._layers = None
        if abstract:        # no parameters: the planner passes its trees
            return
        device = resolve_device(device)
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
        self.blocks = _tree(_stacked_init(block, cfg.n_layers))
        self.ln_f = _tree(nn.rmsnorm_init(cfg.d_model, dt, device))

    @property
    def impl(self) -> str:
        return self._impl

    @impl.setter
    def impl(self, value: str) -> None:
        if value not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{value!r}")
        self._impl = value

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
        a, s = lc(a, _RESID, _ACT), lc(s, _RESID, _ACT)
        beta = p["beta"].float()
        mixed = 0.5 * (beta[0] * nn.rmsnorm(p["ln_attn"], a).float()
                       + beta[1] * nn.rmsnorm(p["ln_ssm"], s).float())
        h = lc(h + mixed.to(h.dtype), _RESID)
        f = swiglu(p["ffn"], lc(nn.rmsnorm(p["ln2"], h), _ACT))
        return h + lc(f, _RESID, _ACT)

    def _block(self, p, h: Tensor, positions: Tensor, window: int) -> Tensor:
        cfg = self.cfg
        h = lc(h, _RESID)
        x = lc(nn.rmsnorm(p["ln1"], h), _ACT)
        a = attn.attend_full(p["attn"], x, positions, cfg.n_heads,
                             cfg.n_kv_heads, "sliding", window=window,
                             rope_theta=cfg.rope_theta)
        return self._mix(p, h, a, ssm.apply_seq(
            p["ssm"], x, plain=self.impl == "plain"))

    def forward(self, params, h: Tensor, positions: Tensor):
        """The blocks and the final norm over ``h [B, S, D]``, each block
        under ``cfg.remat`` -> (``h``, metrics); the family has none."""
        block = remat(functools.partial(self._block, positions=positions),
                      self.cfg.remat)
        for p, w in zip(_unbind_layers(params["blocks"]), self.windows()):
            h = block(p, h, window=w)
        return nn.rmsnorm(params["ln_f"], lc(h, _RESID)), {}

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens``, ``labels`` ``[B, S]`` on the model's device) under
        ``params`` -> (loss, metrics)."""
        table = params["embed"]["table"]
        h = embed(table, batch["tokens"])
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, _ = self.forward(params, h, positions)
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
            return self.layers(), self.embed["table"], self.ln_f
        return ([_index(params["blocks"], i)
                 for i in range(self.cfg.n_layers)],
                params["embed"]["table"], params["ln_f"])

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int, *, params=None,
                caches=None):
        """``tokens [B, S]`` int -> (last-position logits ``[B, V]`` f32,
        per-layer caches ``{"kv": KVCache [B, cache_len, KV, hd] (global)
        or RingKVCache [B, W, KV, hd] (windowed), "ssm": SSMState}``). S is
        a multiple of 256 or shorter (the SSM chunk). ``params`` (a
        parameter tree, :meth:`params`' layout) and ``caches`` (laid out as
        the result, its attention caches filled in place; the SSM states
        are made anew, whatever it holds) are the planner's."""
        cfg = self.cfg
        plain = self.impl == "plain"
        layers, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        h = nn.embed(table, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=h.device)
        out = []
        for i, (p, g) in enumerate(zip(layers, self.is_global)):
            c = caches[i] if caches is not None else None
            h = lc(h, _RESID)
            x = nn.rmsnorm(p["ln1"], h)
            if g:
                a, kv = attn.prefill(p["attn"], x, positions, cfg.n_heads,
                                     cfg.n_kv_heads, cache_len,
                                     rope_theta=cfg.rope_theta, plain=plain,
                                     cache=c and c["kv"])
            else:
                a, kv = attn.ring_prefill(p["attn"], x, positions,
                                          cfg.n_heads, cfg.n_kv_heads,
                                          cfg.sliding_window,
                                          rope_theta=cfg.rope_theta,
                                          plain=plain, cache=c and c["kv"])
            s_out, sst = ssm.apply_seq_with_state(p["ssm"], x, plain=plain)
            h = self._mix(p, h, a, s_out)
            out.append({"kv": kv, "ssm": sst})
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        return _matmul_f32(h[:, -1], table.t()), out

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: list, position: int, *,
                    params=None):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32, the
        caches, the attention caches updated in place); ``params`` as in
        :meth:`prefill`."""
        cfg = self.cfg
        plain = self.impl == "plain"
        position = int(position)
        layers, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(table, tokens)[:, None, :]
        new = []
        for p, g, c in zip(layers, self.is_global, caches):
            h = lc(h, _RESID)
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
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        return _matmul_f32(h[:, 0], table.t()), new

    # ---------------------------------------------------------- input specs

    def cache_specs(self, batch: int, cache_len: int) -> list:
        """The caches' :class:`~repro_torch.models.layout.Spec` tree, as
        JAX's ``cache_specs``."""
        cfg = self.cfg
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        d_inner = int(cfg.d_model * cfg.ssm_expand)
        dt = cfg.param_dtype
        out = []
        for g in self.is_global:
            t = cache_len if g else min(cfg.sliding_window, cache_len)
            kv_cls = attn.KVCache if g else attn.RingKVCache
            out.append({
                "kv": kv_cls(k=Spec((batch, t, kv, hd), dt),
                             v=Spec((batch, t, kv, hd), dt)),
                "ssm": ssm.SSMState(
                    h=Spec((batch, d_inner, cfg.ssm_state), torch.float32),
                    conv=Spec((batch, 3, d_inner), dt))})
        return out

    def cache_axes(self) -> list:
        ax = ("batch", "cache_seq", "kv_heads", "head_dim")
        return [{"kv": (attn.KVCache if g else attn.RingKVCache)(k=ax, v=ax),
                 "ssm": ssm.SSMState(h=("batch", "mlp", "state"),
                                     conv=("batch", None, "mlp"))}
                for g in self.is_global]

    def input_specs(self, shape_cfg) -> dict:
        """Each input's :class:`~repro_torch.models.layout.Spec`, as JAX's
        ``input_specs``."""
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        i32 = torch.int32
        if shape_cfg.kind == "train":
            return {"tokens": Spec((b, s), i32), "labels": Spec((b, s), i32)}
        if shape_cfg.kind == "prefill":
            return {"tokens": Spec((b, s), i32)}
        return {"tokens": Spec((b,), i32), "caches": self.cache_specs(b, s),
                "position": Spec((), i32)}

    def input_axes(self, shape_cfg) -> dict:
        """Logical axes for each input (for shardings)."""
        if shape_cfg.kind == "train":
            return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape_cfg.kind == "prefill":
            return {"tokens": ("batch", "seq")}
        return {"tokens": ("batch",), "caches": self.cache_axes(),
                "position": ()}
