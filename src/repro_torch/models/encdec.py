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
backward) and follows ``cfg.remat`` in every block, as JAX does. The
dryrun's ``cache_specs``, ``input_specs`` and ``input_axes`` have no
counterpart here.
"""

from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from repro_torch.models import attention as attn
from repro_torch.models import module as nn
from repro_torch.models.embedding import embed
from repro_torch.models.mlp import gelu_mlp, gelu_mlp_init
from repro_torch.models.transformer import (IMPLS, _index, _matmul_f32,
                                           _plain, _stacked_init, _tree,
                                           _unbind_layers, cross_entropy,
                                           remat)
from repro_torch.serve.kv import resolve_device

Tensor = torch.Tensor
FRAME_RATIO = 4  # seq_len -> encoder frame count divisor (frontend stub)


def enc_len(seq_len: int) -> int:
    """The encoder's frame count for a sequence of ``seq_len`` tokens."""
    return max(128, seq_len // FRAME_RATIO)


class EncDecModel(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 impl: str = "kernel"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel: family {cfg.family!r} is not "
                             f"'encdec'")
        device = resolve_device(device)
        self.cfg = cfg
        self.impl = impl
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_dec_layers or cfg.n_layers
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
        self._layers = None

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
        x = nn.layernorm(p["ln1"], h)
        if serve:
            a = attn.encoder_attend(p["attn"], x, positions, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.rope_theta,
                                    plain=self.impl == "plain")
        else:
            a = attn.attend_full(p["attn"], x, positions, cfg.n_heads,
                                 cfg.n_kv_heads, "bidirectional",
                                 rope_theta=cfg.rope_theta)
        h = h + a
        return h + gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h))

    def encode(self, params, frames: Tensor, *, serve: bool = False
               ) -> Tensor:
        """``frames [B, S_enc, D]`` -> the encoder output ``[B, S_enc,
        D]`` under the parameter tree ``params``. The train path's form
        (plain attention, each block under ``cfg.remat``); ``serve=True``
        attends through ``flash_attention(causal=False)`` (or its plain
        version, ``impl="plain"``)."""
        dt = params["ln_enc"]["scale"].dtype
        h = torch.as_tensor(frames, device=self.device).to(dt)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        block = functools.partial(self._enc_block, positions=positions,
                                  serve=serve)
        if not serve:
            block = remat(block, self.cfg.remat)
        for p in _unbind_layers(params["enc"]):
            h = block(p, h)
        return nn.layernorm(params["ln_enc"], h)

    # -------------------------------------------------------------- decoder

    def _dec_block(self, p, h: Tensor, ctx_kv, positions: Tensor) -> Tensor:
        cfg = self.cfg
        h = h + attn.attend_full(p["self_attn"], nn.layernorm(p["ln1"], h),
                                 positions, cfg.n_heads, cfg.n_kv_heads,
                                 "causal", rope_theta=cfg.rope_theta)
        h = h + attn.attend_cross(p["cross_attn"], nn.layernorm(p["ln_x"], h),
                                  ctx_kv, cfg.n_heads)
        return h + gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h))

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
        return nn.layernorm(params["ln_f"], h)

    def _logits(self, h: Tensor, table: Tensor) -> Tensor:
        return _matmul_f32(h, table.t())

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``frames [B, S_enc, D]``, ``tokens``, ``labels`` ``[B, S]`` on the
        model's device) under ``params`` -> (loss, metrics)."""
        enc_out = self.encode(params, batch["frames"])
        h = self.decode_seq(params, batch["tokens"], enc_out)
        loss, metrics = cross_entropy(
            self._logits(h, params["embed"]["table"]), batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int, frames: Tensor):
        """Encode ``frames [B, S_enc, D]`` once, then prefill the decoder
        over ``tokens [B, S]`` -> (last-position logits ``[B, V]`` f32,
        caches ``{"kv": KVCache(k=[L, B, cache_len, KV, hd], ...),
        "cross_k", "cross_v": [L, B, S_enc, KV, hd]}``)."""
        cfg = self.cfg
        plain = self.impl == "plain"
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        enc_out = self.encode(self.params(), frames, serve=True)
        h = nn.embed(self.embed["table"], tokens)
        positions = torch.arange(s, dtype=torch.int32, device=self.device)
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        ck = h.new_empty((self.n_dec, b, cache_len, kv, hd))
        cv = torch.empty_like(ck)
        xk = h.new_empty((self.n_dec, b, enc_out.shape[1], kv, hd))
        xv = torch.empty_like(xk)
        for i, p in enumerate(self.layers()):
            a, _ = attn.prefill(p["self_attn"], nn.layernorm(p["ln1"], h),
                                positions, cfg.n_heads, kv, cache_len,
                                rope_theta=cfg.rope_theta, plain=plain,
                                cache=attn.KVCache(k=ck[i], v=cv[i]))
            h = h + a
            k, v = attn.cross_kv(p["cross_attn"], enc_out, kv)
            xk[i], xv[i] = k, v
            h = h + attn.cross_prefill(p["cross_attn"],
                                       nn.layernorm(p["ln_x"], h),
                                       (xk[i], xv[i]), cfg.n_heads, plain)
            h = h + gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h))
        h = nn.layernorm(self.ln_f, h)
        caches = {"kv": attn.KVCache(k=ck, v=cv), "cross_k": xk,
                  "cross_v": xv}
        return self._logits(h[:, -1], self.embed["table"]), caches

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: dict, position: int):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32,
        caches, the self-attention cache updated in place)."""
        cfg = self.cfg
        plain = self.impl == "plain"
        tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(self.embed["table"], tokens)[:, None, :]
        kv = caches["kv"]
        for i, p in enumerate(self.layers()):
            a, _ = attn.decode_step(
                p["self_attn"], nn.layernorm(p["ln1"], h),
                attn.KVCache(k=kv.k[i], v=kv.v[i]), int(position),
                cfg.n_heads, cfg.n_kv_heads, rope_theta=cfg.rope_theta,
                plain=plain)
            h = h + a
            h = h + attn.cross_decode_step(
                p["cross_attn"], nn.layernorm(p["ln_x"], h),
                (caches["cross_k"][i], caches["cross_v"][i]), cfg.n_heads,
                plain)
            h = h + gelu_mlp(p["ffn"], nn.layernorm(p["ln2"], h))
        h = nn.layernorm(self.ln_f, h)
        return self._logits(h[:, 0], self.embed["table"]), caches
