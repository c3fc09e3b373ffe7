"""The decoder-only transformer LM of the port (dense family): serving and
training.

The counterpart of ``DecoderLM.prefill`` / ``decode_step`` and of
``forward`` / ``loss`` of the JAX package's ``repro/models/transformer.py``
for ``family="dense"``
(qwen1.5-0.5b, internlm2-1.8b): embed, L blocks of pre-norm attention and
SwiGLU with residuals, a final rmsnorm, and logits in f32 against the tied
embedding or the unembedding. Attention goes through the port's kernels
(``models/attention.py``); ``attention="plain"`` takes their plain
versions.

Parameters are named and stacked as the JAX tree (``embed.table``,
``blocks.attn.wq.w`` with a leading layers axis, ``ln_f.scale``,
``unembed.w`` when untied), so :func:`from_jax_params` fills them leaf by
leaf; caches are stacked as the JAX scan stacks them, ``{"scan":
KVCache(k=[L, B, T, KV, hd], v=...)}``, and decode updates them in place.

The module's own parameters are frozen: serving never builds a graph.
Training is functional, as in the JAX package: :meth:`DecoderLM.params`
hands out the parameter tree (nested dicts of tensors sharing the module's
storage), and :meth:`DecoderLM.loss` takes a tree, so a train step
differentiates whatever tree it passes (``core/grad_merge.value_and_grad``)
and the optimizer returns new ones. The train path embeds through
``models/embedding.embed`` (its backward is the CUDA ``cscatter``),
attends through the plain ``attention.attend_full``, and follows
``cfg.remat``: ``"none"``, ``"full"`` (``torch.utils.checkpoint`` of each
block) or ``"dots"`` (selective checkpointing that saves the outputs of
the products without batch dims, ``aten.mm``, and recomputes the rest, as
JAX's ``dots_with_no_batch_dims_saveable``). Remat changes memory, never
the numbers. MoE and ``dense_blocks`` (MoE only) are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn as tnn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import module as nn
from repro_torch.models.embedding import embed
from repro_torch.models.mlp import swiglu, swiglu_init
from repro_torch.serve.kv import resolve_device

Tensor = torch.Tensor
ATTENTION = ("kernel", "plain")


def _tree(d: Mapping) -> tnn.Module:
    """A nested dict of tensors as modules whose parameter names are the
    dotted paths of the dict (frozen: serving only)."""
    leaves = {k: v for k, v in d.items() if isinstance(v, Tensor)}
    subs = {k: v for k, v in d.items() if not isinstance(v, Tensor)}
    if subs and leaves:
        raise ValueError(f"mixed tree level: {sorted(d)}")
    if leaves:
        return tnn.ParameterDict({k: tnn.Parameter(v, requires_grad=False)
                                  for k, v in leaves.items()})
    return tnn.ModuleDict({k: _tree(v) for k, v in subs.items()})


def _stack(trees: list) -> dict:
    if isinstance(trees[0], Tensor):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


def _index(tree, i: int):
    """Layer ``i``'s views of a stacked parameter tree."""
    if isinstance(tree, Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


class _MatmulF32(torch.autograd.Function):
    """bf16 ``x @ w`` with f32 output on the card. Its backward rounds the
    f32 output gradient to bf16 and takes both products on the tensor cores
    (bf16 results, f32 accumulation); XLA takes them in f32."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Tensor) -> Tensor:
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[1],))

    @staticmethod
    def backward(ctx, g: Tensor):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        gx = torch.mm(g2, w.t()).reshape(x.shape)
        gw = torch.mm(x.reshape(-1, x.shape[-1]).t(), g2)
        return gx, gw


def _matmul_f32(x: Tensor, w: Tensor) -> Tensor:
    """``x [..., D] @ w [D, V]`` with f32 output, as JAX's
    ``preferred_element_type=float32``: on the card one bf16 product that
    accumulates and returns f32 (no f32 copy of the weight); elsewhere in
    f32. Differentiable in both."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return _MatmulF32.apply(x, w)
    return x.float() @ w.float()


def cross_entropy(logits_f32: Tensor, labels: Tensor, z_coeff: float = 1e-4):
    """logits: [..., V] f32; labels int (< 0 = ignore)."""
    lse = torch.logsumexp(logits_f32, dim=-1)
    gold = torch.gather(logits_f32, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    z_loss = z_coeff * ((lse * mask) ** 2).sum() / denom
    return loss + z_loss, {"nll": loss, "z_loss": z_loss}


_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the products without batch dims, recompute everything else."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy: str):
    """``fn`` under the remat policy of ``cfg.remat``."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none|full|dots, got {policy!r}")


def _unbind_layers(blocks) -> list[dict]:
    """Per-layer views of the stacked block parameters whose backward is
    one stack per leaf (``unbind``), not one full-size scatter per layer."""
    leaves, spec = torch.utils._pytree.tree_flatten(blocks)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [torch.utils._pytree.tree_unflatten([u[i] for u in per_leaf], spec)
            for i in range(len(per_leaf[0]))]


class DecoderLM(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 attention: str = "kernel"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"DecoderLM: family {cfg.family!r} is not ported yet")
        if cfg.mlp != "swiglu":
            raise NotImplementedError(
                f"DecoderLM: mlp {cfg.mlp!r} is not ported yet (only "
                f"'swiglu' is)")
        device = resolve_device(device)
        self.cfg = cfg
        self.attention = attention
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = cfg.param_dtype
        hd = cfg.resolved_head_dim

        def block() -> dict:
            return {
                "ln1": nn.rmsnorm_init(cfg.d_model, dt, device),
                "attn": attn.init(gen, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, hd, dt,
                                       qkv_bias=cfg.qkv_bias, device=device),
                "ln2": nn.rmsnorm_init(cfg.d_model, dt, device),
                "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device),
            }

        self.embed = _tree({"table": nn.embed_init(
            gen, (cfg.padded_vocab, cfg.d_model), dt, device)})
        self.blocks = _tree(_stack([block() for _ in range(cfg.n_layers)]))
        self.ln_f = _tree(nn.rmsnorm_init(cfg.d_model, dt, device))
        if not cfg.tie_embeddings:
            self.unembed = _tree({"w": nn.dense_init(
                gen, (cfg.d_model, cfg.padded_vocab), dt, device=device)})
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

    # --------------------------------------------------------------- blocks

    def _block_prefill(self, p, h, positions, cache):
        cfg = self.cfg
        a, _ = attn.prefill(
            p["attn"], nn.rmsnorm(p["ln1"], h), positions, cfg.n_heads,
            cfg.n_kv_heads, cache.k.shape[1], rope_theta=cfg.rope_theta,
            plain=self.attention == "plain",
            cache=cache)
        h = h + a
        return h + swiglu(p["ffn"], nn.rmsnorm(p["ln2"], h))

    def _block_decode(self, p, h, cache, position):
        cfg = self.cfg
        a, cache = attn.decode_step(
            p["attn"], nn.rmsnorm(p["ln1"], h), cache, position, cfg.n_heads,
            cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            plain=self.attention == "plain")
        h = h + a
        return h + swiglu(p["ffn"], nn.rmsnorm(p["ln2"], h)), cache

    def _logits(self, h: Tensor) -> Tensor:
        if self.cfg.tie_embeddings:
            w = self.embed["table"].t()
        else:
            w = self.unembed["w"]
        return _matmul_f32(h, w)

    # ------------------------------------------------------------- training

    def params(self) -> dict:
        """The parameters as the JAX package's tree, detached tensors that
        share the module's storage: what a train step differentiates and
        the optimizer replaces."""
        tree = {"embed": self.embed, "blocks": self.blocks, "ln_f": self.ln_f}
        if not self.cfg.tie_embeddings:
            tree["unembed"] = self.unembed
        return torch.utils._pytree.tree_map(
            lambda t: t.detach(), {k: _plain(v) for k, v in tree.items()})

    def _block(self, p, h: Tensor, positions: Tensor) -> Tensor:
        cfg = self.cfg
        a = attn.attend_full(p["attn"], nn.rmsnorm(p["ln1"], h), positions,
                             cfg.n_heads, cfg.n_kv_heads, "causal",
                             rope_theta=cfg.rope_theta)
        h = h + a
        return h + swiglu(p["ffn"], nn.rmsnorm(p["ln2"], h))

    def forward(self, params, h: Tensor, positions: Tensor):
        """The blocks and the final norm over ``h [B, S, D]``, each block
        under ``cfg.remat`` -> (``h``, metrics); the dense family has no
        metrics."""
        block = remat(functools.partial(self._block, positions=positions),
                      self.cfg.remat)
        for p in _unbind_layers(params["blocks"]):
            h = block(p, h)
        return nn.rmsnorm(params["ln_f"], h), {}

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens``, ``labels`` ``[B, S]`` on the model's device) under the
        parameter tree ``params`` -> (loss, metrics)."""
        h = embed(params["embed"]["table"], batch["tokens"])
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, _ = self.forward(params, h, positions)
        w = (params["embed"]["table"].t() if self.cfg.tie_embeddings
             else params["unembed"]["w"])
        loss, metrics = cross_entropy(_matmul_f32(h, w), batch["labels"])
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int):
        """``tokens [B, S]`` int -> (last-position logits ``[B, V]`` f32,
        caches ``{"scan": KVCache(k=[L, B, cache_len, KV, hd], ...)}``)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        h = nn.embed(self.embed["table"], tokens)
        positions = torch.arange(s, dtype=torch.int32, device=self.device)
        hd = cfg.resolved_head_dim
        shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, hd)
        ck = torch.empty(shape, dtype=h.dtype, device=self.device)
        cv = torch.empty_like(ck)
        for i, p in enumerate(self.layers()):
            h = self._block_prefill(p, h, positions,
                                    attn.KVCache(k=ck[i], v=cv[i]))
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, -1]), {"scan": attn.KVCache(k=ck, v=cv)}

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: dict, position: int):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32,
        caches, updated in place)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(self.embed["table"], tokens)[:, None, :]
        stacked = caches["scan"]
        for i, p in enumerate(self.layers()):
            h, _ = self._block_decode(
                p, h, attn.KVCache(k=stacked.k[i], v=stacked.v[i]),
                int(position))
        h = nn.rmsnorm(self.ln_f, h)
        return self._logits(h[:, 0]), caches


def _plain(module: tnn.Module):
    """A ModuleDict / ParameterDict tree as nested dicts of tensors."""
    if isinstance(module, tnn.ParameterDict):
        return {k: v for k, v in module.items()}
    return {k: _plain(v) for k, v in module.items()}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _as_tensor(a) -> Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16, as JAX hands it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_jax_params(model: DecoderLM, tree: Mapping) -> DecoderLM:
    """Copy the JAX ``split_params`` tree (numpy arrays, bf16 or any float
    dtype) into ``model``'s parameters, leaf by leaf, converting to their
    dtype. Raises on a missing or extra leaf and on any shape mismatch."""
    want = dict(model.named_parameters())
    got = _flatten(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing leaves {missing}, extra "
                         f"leaves {extra}")
    for name, param in want.items():
        t = _as_tensor(got[name])
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"load_jax_params: {name} has shape "
                             f"{tuple(t.shape)}, the model needs "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(param.dtype))
    return model


def from_jax_params(cfg, tree: Mapping, *, device="cuda",
                    attention: str = "kernel") -> DecoderLM:
    """A :class:`DecoderLM` of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU) holding the JAX parameter tree's weights, so
    that both packages compute the same function."""
    model = DecoderLM(cfg, device=device, attention=attention)
    return load_jax_params(model, tree)
