"""The encoder-decoder transformer of the port (family ``encdec``,
seamless-m4t-medium's backbone): served and trained.

The counterpart of the JAX package's ``repro/models/encdec.py``
``EncDecModel``. The speech frontend is a stub, as there: the encoder takes
precomputed frame embeddings ``[B, S_enc, D]`` (:func:`enc_len` frames for
a sequence of S tokens), cast to the parameters' dtype. Encoder blocks are
pre-layernorm bidirectional self-attention (RoPE at ``arange(S_enc)``) and
a GELU MLP, ending in ``ln_enc``; decoder blocks are causal
self-attention, cross-attention over the encoder output (k and v from
``attention.cross_kv``, no RoPE) and a GELU MLP, ending in ``ln_f``; the
logits are f32 against the tied embedding. Parameters are named and
stacked as the JAX tree (``embed.table``, ``enc.{ln1, attn, ln2, ffn}``
and ``dec.{ln1, self_attn, ln_x, cross_attn, ln2, ffn}`` with a leading
layers axis, ``ln_enc``, ``ln_f``), so ``registry.from_jax_params`` fills
them leaf by leaf.

Serving runs the attention kernels in every attention: :meth:`prefill`
encodes through ``flash_attention(causal=False)``, prefills each decoder
layer's causal self-attention through ``flash_attention`` and its
cross-attention through ``flash_attention(causal=False)`` with S queries
against S_enc keys, and fills the self-attention caches and, once, the
cross caches; :meth:`decode_step` writes the self cache in place and reads
the cross cache through ``decode_attention`` at position ``S_enc - 1``,
never recomputing it. ``impl="plain"`` takes the kernels' plain
versions. Training (:meth:`loss`) embeds through ``models/embedding.embed``
(its backward is the CUDA ``cscatter``), attends through the plain
``attention.attend_full`` and ``attend_cross`` (neither kernel has a
backward) and follows ``cfg.remat`` in every block, as JAX does.

The production-mesh planner (``launch/steps.py``) runs the same code on
DTensors: ``EncDecModel(cfg, abstract=True)`` holds no parameters, and
``loss``, ``prefill(..., params=, caches=)`` and ``decode_step(...,
params=)`` take its trees; ``cache_specs(batch, cache_len, enc_len)``,
``input_specs`` and ``input_axes`` are JAX's (``frames [B, enc_len, D]``;
``kv``, ``cross_k`` and ``cross_v`` stacked over the decoder layers). The
blocks constrain the residual stream as JAX's do and each sublayer's
output back onto it; outside a rules context that is the identity.
"""

from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from repro_torch.models import attention as attn
from repro_torch.models import module as nn
from repro_torch.models.embedding import embed
from repro_torch.models.mlp import gelu_mlp, gelu_mlp_init
from repro_torch.models.layout import Spec
from repro_torch.models.transformer import (_ACT, _RESID, IMPLS, _index,
                                           _matmul_f32, _plain, _stacked_init,
                                           _tree, _unbind_layers,
                                           cross_entropy, remat)
from repro_torch.serve.kv import resolve_device
from repro_torch.sharding.partition import is_dtensor
from repro_torch.sharding.partition import logical_constraint as lc

Tensor = torch.Tensor
FRAME_RATIO = 4  # seq_len -> encoder frame count divisor (frontend stub)


def enc_len(seq_len: int) -> int:
    """The encoder's frame count for a sequence of ``seq_len`` tokens."""
    return max(128, seq_len // FRAME_RATIO)


class EncDecModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 impl: str = "kernel", abstract: bool = False):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel: family {cfg.family!r} is not "
                             f"'encdec'")
        self.cfg = cfg
        self.impl = impl
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_dec_layers or cfg.n_layers
        self._layers = None
        if abstract:        # no parameters: the planner passes its trees
            return
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dt, d = cfg.param_dtype, cfg.d_model

        def attention_init() -> dict:
            return attn.init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dt, device=device)

        def enc_block() -> dict:
            return {"ln1": nn.layernorm_init(d, dt, device),
                    "attn": attention_init(),
                    "ln2": nn.layernorm_init(d, dt, device),
                    "ffn": gelu_mlp_init(gen, d, cfg.d_ff, dt,
                                         device=device)}

        def dec_block() -> dict:
            return {"ln1": nn.layernorm_init(d, dt, device),
                    "self_attn": attention_init(),
                    "ln_x": nn.layernorm_init(d, dt, device),
                    "cross_attn": attention_init(),
                    "ln2": nn.layernorm_init(d, dt, device),
                    "ffn": gelu_mlp_init(gen, d, cfg.d_ff, dt,
                                         device=device)}

        self.embed = _tree({"table": nn.embed_init(
            gen, (cfg.padded_vocab, d), dt, device)})
        self.enc = _tree(_stacked_init(enc_block, self.n_enc))
        self.dec = _tree(_stacked_init(dec_block, self.n_dec))
        self.ln_enc = _tree(nn.layernorm_init(d, dt, device))
        self.ln_f = _tree(nn.layernorm_init(d, dt, device))

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
        """Per-layer views of the stacked decoder blocks."""
        if self._layers is None:
            tree = _plain(self.dec)
            self._layers = [_index(tree, i) for i in range(self.n_dec)]
        return self._layers

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def enc_len(self, seq_len: int) -> int:
        return enc_len(seq_len)

    def params(self) -> dict:
        """The parameters as the JAX package's tree, detached tensors that
        share the module's storage."""
        tree = {k: _plain(getattr(self, k))
                for k in ("embed", "enc", "dec", "ln_enc", "ln_f")}
        return torch.utils._pytree.tree_map(lambda t: t.detach(), tree)

    # -------------------------------------------------------------- encoder

    def _enc_block(self, p, h: Tensor, positions: Tensor,
                   serve: bool) -> Tensor:
        cfg = self.cfg
        h = lc(h, _RESID)
        x = lc(nn.layernorm(p["ln1"], h), _ACT)
        if serve:
            a = attn.encoder_attend(p["attn"], x, positions, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.rope_theta,
                                    plain=self.impl == "plain")
        else:
            a = attn.attend_full(p["attn"], x, positions, cfg.n_heads,
                                 cfg.n_kv_heads, "bidirectional",
                                 rope_theta=cfg.rope_theta)
        h = lc(h + lc(a, _RESID, _ACT), _RESID)
        f = gelu_mlp(p["ffn"], lc(nn.layernorm(p["ln2"], h), _ACT))
        return h + lc(f, _RESID, _ACT)

    def encode(self, params, frames: Tensor, *, serve: bool = False
               ) -> Tensor:
        """``frames [B, S_enc, D]`` -> the encoder output ``[B, S_enc,
        D]`` under the parameter tree ``params``. The train path's form
        (plain attention, each block under ``cfg.remat``); ``serve=True``
        attends through ``flash_attention(causal=False)`` (or its plain
        version, ``impl="plain"``)."""
        dt = params["ln_enc"]["scale"].dtype
        h = (frames if is_dtensor(frames)
             else torch.as_tensor(frames, device=self.device)).to(dt)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        block = functools.partial(self._enc_block, positions=positions,
                                  serve=serve)
        if not serve:
            block = remat(block, self.cfg.remat)
        for p in _unbind_layers(params["enc"]):
            h = block(p, h)
        return nn.layernorm(params["ln_enc"], lc(h, _RESID))

    # -------------------------------------------------------------- decoder

    def _dec_block(self, p, h: Tensor, ctx_kv, positions: Tensor) -> Tensor:
        cfg = self.cfg
        h = lc(h, _RESID)
        a = attn.attend_full(p["self_attn"],
                             lc(nn.layernorm(p["ln1"], h), _ACT), positions,
                             cfg.n_heads, cfg.n_kv_heads, "causal",
                             rope_theta=cfg.rope_theta)
        h = lc(h + lc(a, _RESID, _ACT), _RESID)
        c = attn.attend_cross(p["cross_attn"],
                              lc(nn.layernorm(p["ln_x"], h), _ACT), ctx_kv,
                              cfg.n_heads)
        h = lc(h + lc(c, _RESID, _ACT), _RESID)
        f = gelu_mlp(p["ffn"], lc(nn.layernorm(p["ln2"], h), _ACT))
        return h + lc(f, _RESID, _ACT)

    def decode_seq(self, params, tokens: Tensor, enc_out: Tensor) -> Tensor:
        """The decoder over ``tokens [B, S]`` against ``enc_out``, the
        train path's form -> the final-normed hidden ``[B, S, D]``."""
        h = embed(params["embed"]["table"], tokens)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        block = remat(functools.partial(self._dec_block, positions=positions),
                      self.cfg.remat)
        for p in _unbind_layers(params["dec"]):
            ctx_kv = attn.cross_kv(p["cross_attn"], enc_out,
                                   self.cfg.n_kv_heads)
            h = block(p, h, ctx_kv)
        return nn.layernorm(params["ln_f"], lc(h, _RESID))

    def _logits(self, h: Tensor, table: Tensor) -> Tensor:
        return _matmul_f32(h, table.t())

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``frames [B, S_enc, D]``, ``tokens``, ``labels`` ``[B, S]`` on the
        model's device) under ``params`` -> (loss, metrics)."""
        enc_out = self.encode(params, batch["frames"])
        h = self.decode_seq(params, batch["tokens"], enc_out)
        h = lc(h, ("batch", "seq", "embed_act"))
        loss, metrics = cross_entropy(
            self._logits(h, params["embed"]["table"]), batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    def _serving(self, params) -> tuple[list[dict], Tensor, dict, dict]:
        """(the parameter tree, per-layer decoder trees, embedding table,
        final norm) of the module's own parameters or of the tree
        ``params`` (the planner's)."""
        if params is None:
            return self.params(), self.layers(), self.embed["table"], \
                self.ln_f
        return (params, [_index(params["dec"], i) for i in range(self.n_dec)],
                params["embed"]["table"], params["ln_f"])

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int, frames: Tensor, *,
                params=None, caches=None):
        """Encode ``frames [B, S_enc, D]`` once, then prefill the decoder
        over ``tokens [B, S]`` -> (last-position logits ``[B, V]`` f32,
        caches ``{"kv": KVCache(k=[L, B, cache_len, KV, hd], ...),
        "cross_k", "cross_v": [L, B, S_enc, KV, hd]}``). ``params`` (a
        parameter tree, :meth:`params`' layout) and ``caches`` (laid out as
        the result, filled in place) are the planner's."""
        cfg = self.cfg
        plain = self.impl == "plain"
        tree, layers, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        enc_out = self.encode(tree, frames, serve=True)
        h = nn.embed(table, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=h.device)
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if caches is None:
            ck = h.new_empty((self.n_dec, b, cache_len, kv, hd))
            caches = {"kv": attn.KVCache(k=ck, v=torch.empty_like(ck)),
                      "cross_k": h.new_empty((self.n_dec, b,
                                              enc_out.shape[1], kv, hd))}
            caches["cross_v"] = torch.empty_like(caches["cross_k"])
        ck, cv = caches["kv"].k, caches["kv"].v
        xk, xv = caches["cross_k"], caches["cross_v"]
        for i, p in enumerate(layers):
            h = lc(h, _RESID)
            a, _ = attn.prefill(p["self_attn"], nn.layernorm(p["ln1"], h),
                                positions, cfg.n_heads, kv, cache_len,
                                rope_theta=cfg.rope_theta, plain=plain,
                                cache=attn.KVCache(k=ck[i], v=cv[i]))
            h = lc(h + lc(a, _RESID, _ACT), _RESID)
            k, v = attn.cross_kv(p["cross_attn"], enc_out, kv)
            xk[i], xv[i] = k, v
            c = attn.cross_prefill(p["cross_attn"], nn.layernorm(p["ln_x"], h),
                                   (xk[i], xv[i]), cfg.n_heads, plain)
            h = lc(h + lc(c, _RESID, _ACT), _RESID)
            h = h + lc(gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h)), _RESID,
                       _ACT)
        h = nn.layernorm(ln_f, lc(h, _RESID))
        return self._logits(h[:, -1], table), caches

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: dict, position: int, *,
                    params=None):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32,
        caches, the self-attention cache updated in place); ``params`` as
        in :meth:`prefill`."""
        cfg = self.cfg
        plain = self.impl == "plain"
        _, layers, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(table, tokens)[:, None, :]
        kv = caches["kv"]
        for i, p in enumerate(layers):
            h = lc(h, _RESID)
            a, _ = attn.decode_step(
                p["self_attn"], nn.layernorm(p["ln1"], h),
                attn.KVCache(k=kv.k[i], v=kv.v[i]), int(position),
                cfg.n_heads, cfg.n_kv_heads, rope_theta=cfg.rope_theta,
                plain=plain)
            h = lc(h + lc(a, _RESID, _ACT), _RESID)
            c = attn.cross_decode_step(
                p["cross_attn"], nn.layernorm(p["ln_x"], h),
                (caches["cross_k"][i], caches["cross_v"][i]), cfg.n_heads,
                plain)
            h = lc(h + lc(c, _RESID, _ACT), _RESID)
            h = h + lc(gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h)), _RESID,
                       _ACT)
        h = nn.layernorm(ln_f, lc(h, _RESID))
        return self._logits(h[:, 0], table), caches

    # ---------------------------------------------------------- input specs

    def cache_specs(self, batch: int, cache_len: int, enc_len: int) -> dict:
        """The caches' :class:`~repro_torch.models.layout.Spec` tree, as
        JAX's ``cache_specs``."""
        cfg = self.cfg
        dt = cfg.param_dtype
        kv, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, self.n_dec
        self_kv = Spec((n, batch, cache_len, kv, hd), dt)
        cross = Spec((n, batch, enc_len, kv, hd), dt)
        return {"kv": attn.KVCache(k=self_kv, v=self_kv), "cross_k": cross,
                "cross_v": cross}

    def input_specs(self, shape_cfg) -> dict:
        """Each input's :class:`~repro_torch.models.layout.Spec`, as JAX's
        ``input_specs``."""
        cfg = self.cfg
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        se = self.enc_len(s)
        i32, dt = torch.int32, cfg.param_dtype
        if shape_cfg.kind == "train":
            return {"frames": Spec((b, se, cfg.d_model), dt),
                    "tokens": Spec((b, s), i32), "labels": Spec((b, s), i32)}
        if shape_cfg.kind == "prefill":
            return {"frames": Spec((b, se, cfg.d_model), dt),
                    "tokens": Spec((b, s), i32)}
        return {"tokens": Spec((b,), i32),
                "caches": self.cache_specs(b, s, se),
                "position": Spec((), i32)}

    def input_axes(self, shape_cfg) -> dict:
        """Logical axes for each input (for shardings)."""
        ax_kv = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        if shape_cfg.kind == "train":
            return {"frames": ("batch", "seq", "embed_act"),
                    "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape_cfg.kind == "prefill":
            return {"frames": ("batch", "seq", "embed_act"),
                    "tokens": ("batch", "seq")}
        return {"tokens": ("batch",),
                "caches": {"kv": attn.KVCache(k=ax_kv, v=ax_kv),
                           "cross_k": ax_kv, "cross_v": ax_kv},
                "position": ()}
