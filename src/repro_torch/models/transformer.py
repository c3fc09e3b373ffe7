"""The decoder-only transformer LM of the port (dense, MoE and VLM
families): serving and training.

The counterpart of ``DecoderLM.prefill`` / ``decode_step`` and of
``forward`` / ``loss`` of the JAX package's ``repro/models/transformer.py``
for ``family`` ``"dense"`` (qwen1.5-0.5b, internlm2-1.8b, granite-34b,
llama3-405b), ``"moe"`` (qwen3-moe-235b, kimi-k2-1t) and ``"vlm"``
(llava-next-34b): embed, L blocks of pre-norm attention and a
feed-forward layer with residuals, a final rmsnorm, and logits in f32
against the tied embedding or the unembedding. The feed-forward layer is
an MLP (SwiGLU, or the two-matrix GELU MLP for ``cfg.mlp == "gelu"``) or,
in the MoE family, ``models/moe.apply`` (routing, the capacity dispatch,
the grouped experts and the token combine through the CUDA ``cscatter``),
after ``cfg.first_dense_layers`` unrolled dense blocks of width ``cfg.d_ff
or 4 * cfg.d_ff_expert`` (kimi-k2). One card has no mesh: ``model_ranks``
stands for the size of the mesh's ``"model"`` axis, and the MoE layer is
chosen as JAX's ``_moe`` chooses it (:meth:`DecoderLM._moe`):
``models/moe_ep.apply_ep`` over that many stacked model ranks for a
``moe_impl="ep"`` config whose experts they split, ``moe.apply`` otherwise
and without ranks (``None``, JAX without a mesh). The VLM is the dense
backbone fed precomputed patch and text embeddings (``embeds``) in
``loss`` and ``prefill``, cast to the parameters' dtype. Attention goes
through the port's kernels (``models/attention.py``); ``impl="plain"``
takes their plain versions.

Parameters are named and stacked as the JAX tree (``embed.table``,
``blocks.attn.wq.w`` and ``blocks.moe.router.w`` with a leading layers
axis, ``dense_blocks.<i>.*``, ``ln_f.scale``, ``unembed.w`` when untied),
so ``registry.from_jax_params`` fills them leaf by leaf; the router stays
f32 in a bf16 model. Caches are stacked as the JAX scan stacks them,
``{"scan": KVCache(k=[L, B, T, KV, hd], v=...)}`` plus ``"dense"``, a
``KVCache`` a dense block, and decode updates them in place.

The module's own parameters are frozen: serving never builds a graph.
Training is functional, as in the JAX package: :meth:`DecoderLM.params`
hands out the parameter tree (nested dicts of tensors sharing the module's
storage), and :meth:`DecoderLM.loss` takes a tree, so a train step
differentiates whatever tree it passes (``core/grad_merge.value_and_grad``)
and the optimizer returns new ones; a donating step
(``make_train_step(..., donate=True)``) writes the tree in place, and with
it the module's own parameters, which share its storage. The train path
embeds through ``models/embedding.embed`` (its backward is the CUDA
``cscatter``), attends through the plain ``attention.attend_full``, adds
the router's aux and z losses of the MoE blocks, and follows
``cfg.remat``: ``"none"``,
``"full"`` (``torch.utils.checkpoint`` of each block) or ``"dots"``
(selective checkpointing that saves the outputs of the products without
batch dims, ``aten.mm``, and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable``). Remat changes memory, never the
numbers.

The production-mesh planner (``launch/steps.py``) runs the same code on
DTensors: ``DecoderLM(cfg, abstract=True)`` holds no parameters, and
``loss``, ``prefill(..., params=, caches=)`` and ``decode_step(...,
params=)`` take its trees; ``input_specs`` / ``input_axes`` and
``cache_specs`` / ``cache_axes`` give its inputs, as JAX's. Under its
rules context the blocks constrain the residual stream and each
sublayer's input and output (``_RESID``, ``_ACT``), and the lookup, the
cross-entropy and the attention run per device; outside one those
constraints are the identity and nothing else changes.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn as tnn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe, moe_ep
from repro_torch.models import module as nn
from repro_torch.models.embedding import embed
from repro_torch.models.layout import Spec
from repro_torch.models.mlp import (gelu_mlp, gelu_mlp_init, swiglu,
                                   swiglu_init)
from repro_torch.serve.kv import resolve_device
from repro_torch.sharding.partition import (active_mesh, dim_shards,
                                            gathered, is_dtensor,
                                            local_inputs)
from repro_torch.sharding.partition import logical_constraint as lc

Tensor = torch.Tensor
IMPLS = ("kernel", "plain")


class _Node(tnn.Module):
    """A dict level that holds both tensors and sub-trees (the SSM and
    xLSTM layers' ``conv_w`` beside their dense layers), indexed by key."""

    def __init__(self, d: Mapping):
        super().__init__()
        for k, v in d.items():
            if isinstance(v, Tensor):
                self.register_parameter(k, tnn.Parameter(v,
                                                         requires_grad=False))
            else:
                self.add_module(k, _tree(v))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _tree(d) -> tnn.Module:
    """A nested dict (or list) of tensors as modules whose parameter names
    are the dotted paths of the tree, list items by index (frozen: serving
    only)."""
    if isinstance(d, (list, tuple)):
        return tnn.ModuleList([_tree(x) for x in d])
    leaves = {k: v for k, v in d.items() if isinstance(v, Tensor)}
    subs = {k: v for k, v in d.items() if not isinstance(v, Tensor)}
    if subs and leaves:
        return _Node(d)
    if leaves:
        return tnn.ParameterDict({k: tnn.Parameter(v, requires_grad=False)
                                  for k, v in leaves.items()})
    return tnn.ModuleDict({k: _tree(v) for k, v in subs.items()})


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
    accumulates and returns f32 (no f32 copy of the weight); on the CPU in
    f32. The planner's meta tensors plan the card's program and take the
    card's form. Differentiable in both."""
    if x.device.type in ("cuda", "meta") and x.dtype == torch.bfloat16:
        return _MatmulF32.apply(x, w)
    return x.float() @ w.float()


def _sharded_lse_gold(logits: Tensor, labels: Tensor):
    """(logsumexp, the label's logit) of DTensor logits ``[..., V]`` (the
    planner's) with the vocab split over mesh dims: each device reduces its
    slice of V (a ``local_map`` whose results gain a leading dim, one entry
    a vocab shard), then the slices combine."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab, n, first = dim_shards(mesh, logits.placements, last,
                                 logits.shape[-1])
    lg_in, lab_in, out = [], [], []
    for i, p in enumerate(logits.placements):
        batch = isinstance(p, Shard) and p.dim < last
        lg_in.append(Shard(last) if i in vocab else p if batch
                     else Replicate())
        lab_in.append(p if batch else Replicate())
        out.append(Shard(0) if i in vocab else Shard(p.dim + 1) if batch
                   else Replicate())

    def local(lg, lab):
        m = lg.amax(-1)
        se = torch.exp(lg - m[..., None]).sum(-1)
        ids = lab.long() - first
        hit = (ids >= 0) & (ids < n)
        gold = torch.gather(lg, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        return m[None], se[None], (gold * hit)[None]

    m, se, gold = local_map(local, out_placements=(out, out, out),
                            in_placements=(lg_in, lab_in),
                            device_mesh=mesh)(*local_inputs(
                                (logits, labels), (lg_in, lab_in)))
    # the max only steadies the sum (its gradient cancels), as
    # ``jax.nn.logsumexp`` stops it
    top = m.amax(0).detach()
    lse = top + torch.log((se * torch.exp(m - top)).sum(0))
    return lse, gold.sum(0)


def cross_entropy(logits_f32: Tensor, labels: Tensor, z_coeff: float = 1e-4):
    """logits: [..., V] f32; labels int (< 0 = ignore)."""
    if hasattr(logits_f32, "placements"):
        lse, gold = _sharded_lse_gold(logits_f32, labels)
    else:
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


def _stacked_init(make, n: int) -> dict:
    """``n`` trees of ``make()`` stacked leaf by leaf into one tree with a
    leading layers dim, filled a layer at a time (one layer's tree lives
    beside the stack, not all ``n``)."""
    first = make()
    out = torch.utils._pytree.tree_map(
        lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make()
        torch.utils._pytree.tree_map(lambda o, t: o[i].copy_(t), out, layer)
    return out


FAMILIES = ("dense", "moe", "vlm")

# The residual stream's logical axes. Under a rules context the train
# blocks constrain it where JAX's do (a block's input), after the attention
# residual, each sublayer's input to _ACT and its output onto _RESID (its
# gradient back to _ACT): DTensor's propagation is greedy and would otherwise carry the
# attention output's partial sum into the MLP, gathering its weights where
# GSPMD reduces the activation. Outside one it is the identity.
_RESID = ("batch", "seq_res", "embed_act")
# a sublayer's input: the whole sequence on each device (with the residual
# split by sequence, Megatron's gather before the column-parallel products)
_ACT = ("batch", "seq", "embed_act")


class DecoderLM(tnn.Module):
    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 impl: str = "kernel", model_ranks: int | None = None,
                 abstract: bool = False):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"DecoderLM: family {cfg.family!r} is not one of {FAMILIES} "
                f"(registry.build_model builds each ported family's model)")
        if cfg.mlp not in ("swiglu", "gelu"):
            raise ValueError(f"DecoderLM: unknown mlp {cfg.mlp!r}")
        self.cfg = cfg
        self.is_moe = cfg.family == "moe"
        self.embeds_input = cfg.family == "vlm"
        self.impl = impl
        self.model_ranks = model_ranks
        self.n_scan = cfg.n_layers - cfg.first_dense_layers
        self._layers = None
        if abstract:        # no parameters: the planner passes its trees
            return
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = cfg.param_dtype
        hd = cfg.resolved_head_dim
        ffn_init = gelu_mlp_init if cfg.mlp == "gelu" else swiglu_init

        def block(moe_ffn: bool, d_ff: int) -> dict:
            p = {
                "ln1": nn.rmsnorm_init(cfg.d_model, dt, device),
                "attn": attn.init(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, hd, dt,
                                  qkv_bias=cfg.qkv_bias, device=device),
                "ln2": nn.rmsnorm_init(cfg.d_model, dt, device),
            }
            if moe_ffn:
                p["moe"] = moe.init(gen, cfg.d_model, cfg.d_ff_expert,
                                    cfg.n_experts, dt,
                                    n_shared=cfg.n_shared_experts,
                                    device=device)
            else:
                p["ffn"] = ffn_init(gen, cfg.d_model, d_ff, dt,
                                    device=device)
            return p

        self.embed = _tree({"table": nn.embed_init(
            gen, (cfg.padded_vocab, cfg.d_model), dt, device)})
        self.blocks = _tree(_stacked_init(
            functools.partial(block, self.is_moe, cfg.d_ff), self.n_scan))
        self.ln_f = _tree(nn.rmsnorm_init(cfg.d_model, dt, device))
        if cfg.first_dense_layers:
            self.dense_blocks = _tree([
                block(False, cfg.d_ff or 4 * cfg.d_ff_expert)
                for _ in range(cfg.first_dense_layers)])
        if not cfg.tie_embeddings:
            self.unembed = _tree({"w": nn.dense_init(
                gen, (cfg.d_model, cfg.padded_vocab), dt, device=device)})

    def _ffn(self, p, x: Tensor) -> Tensor:
        return (gelu_mlp if self.cfg.mlp == "gelu" else swiglu)(p, x)

    def _moe(self, p, x: Tensor) -> tuple[Tensor, dict]:
        """The MoE layer -> (out, metrics), chosen by JAX's condition: the
        expert-parallel form for an ``"ep"`` config whose experts the model
        axis splits, else ``moe.apply``. The model axis is ``model_ranks``
        stacked ranks on one card, or for DTensors the ``"model"`` dim of
        the installed rules' mesh (``partition.active_mesh``): the
        planner's, or the real mesh of the process's group."""
        cfg = self.cfg
        if is_dtensor(x):
            mesh = active_mesh()
            names = list(getattr(mesh, "mesh_dim_names", None) or ())
            if (cfg.moe_impl == "ep" and "model" in names and cfg.n_experts
                    % mesh.size(names.index("model")) == 0):
                return moe_ep.apply_ep_mesh(p, x, cfg.top_k,
                                            cfg.capacity_factor, mesh)
            return moe.apply(p, x, cfg.top_k, cfg.capacity_factor)
        ranks = self.model_ranks
        if (ranks is not None and cfg.moe_impl == "ep"
                and cfg.n_experts % ranks == 0):
            return moe_ep.apply_ep(p, x, cfg.top_k, cfg.capacity_factor,
                                   ranks)
        return moe.apply(p, x, cfg.top_k, cfg.capacity_factor)

    def _serve_ffn(self, p, x: Tensor) -> Tensor:
        """A block's feed-forward layer at serving: the MoE layer (its
        metrics dropped, as JAX drops them), or the MLP."""
        if "moe" in p:
            return self._moe(p["moe"], x)[0]
        return self._ffn(p["ffn"], x)

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
        """Per-layer views of the stacked block parameters, after the
        dense blocks' own trees (MoE only)."""
        if self._layers is None:
            tree = _plain(self.blocks)
            dense = (_plain(self.dense_blocks)
                     if self.cfg.first_dense_layers else [])
            self._layers = dense + [_index(tree, i)
                                    for i in range(self.n_scan)]
        return self._layers

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # --------------------------------------------------------------- blocks

    def _block_prefill(self, p, h, positions, cache):
        cfg = self.cfg
        h = lc(h, _RESID)
        a, _ = attn.prefill(
            p["attn"], nn.rmsnorm(p["ln1"], h), positions, cfg.n_heads,
            cfg.n_kv_heads, cache.k.shape[1], rope_theta=cfg.rope_theta,
            plain=self.impl == "plain",
            cache=cache)
        h = lc(h + a, _RESID)
        return h + self._serve_ffn(p, nn.rmsnorm(p["ln2"], h))

    def _block_decode(self, p, h, cache, position):
        cfg = self.cfg
        h = lc(h, _RESID)
        a, cache = attn.decode_step(
            p["attn"], nn.rmsnorm(p["ln1"], h), cache, position, cfg.n_heads,
            cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            plain=self.impl == "plain")
        h = lc(h + a, _RESID)
        return h + self._serve_ffn(p, nn.rmsnorm(p["ln2"], h)), cache

    def _logits(self, h: Tensor, params=None) -> Tensor:
        embed_, unembed = ((self.embed, getattr(self, "unembed", None))
                           if params is None
                           else (params["embed"], params.get("unembed")))
        if self.cfg.tie_embeddings:
            w = embed_["table"].t()
        else:
            w = unembed["w"]
        return _matmul_f32(h, w)

    def _serving(self, params) -> tuple[list[dict], Tensor, dict]:
        """(per-layer trees, embedding table, final norm) of the module's
        own parameters, or of the tree ``params`` (the planner's)."""
        if params is None:
            return self.layers(), self.embed["table"], self.ln_f
        layers = list(params.get("dense_blocks", [])) + [
            _index(params["blocks"], i) for i in range(self.n_scan)]
        return layers, params["embed"]["table"], params["ln_f"]

    # ------------------------------------------------------------- training

    def params(self) -> dict:
        """The parameters as the JAX package's tree, detached tensors that
        share the module's storage: what a train step differentiates and
        the optimizer replaces."""
        tree = {"embed": self.embed, "blocks": self.blocks, "ln_f": self.ln_f}
        if self.cfg.first_dense_layers:
            tree["dense_blocks"] = self.dense_blocks
        if not self.cfg.tie_embeddings:
            tree["unembed"] = self.unembed
        return torch.utils._pytree.tree_map(
            lambda t: t.detach(), {k: _plain(v) for k, v in tree.items()})

    def _block(self, p, h: Tensor, positions: Tensor):
        """One block of the train path -> (h, the MoE layer's metrics or
        ``{}``)."""
        cfg = self.cfg
        p = gathered(p)
        h = lc(h, _RESID)
        a = attn.attend_full(p["attn"], lc(nn.rmsnorm(p["ln1"], h), _ACT),
                             positions, cfg.n_heads, cfg.n_kv_heads,
                             "causal", rope_theta=cfg.rope_theta)
        h = lc(h + lc(a, _RESID, _ACT), _RESID)
        x = lc(nn.rmsnorm(p["ln2"], h), _ACT)
        if "moe" in p:
            f, metrics = self._moe(p["moe"], x)
        else:
            f, metrics = self._ffn(p["ffn"], x), {}
        return h + lc(f, _RESID, _ACT), metrics

    def forward(self, params, h: Tensor, positions: Tensor):
        """The dense blocks, the stacked blocks and the final norm over
        ``h [B, S, D]``, each block under ``cfg.remat`` -> (``h``,
        metrics): the MoE blocks' metrics, each summed over its elements
        and the stacked layers (JAX's ``tree.map(jnp.sum)`` of the scan's
        stack); ``{}`` without MoE blocks."""
        block = remat(functools.partial(self._block, positions=positions),
                      self.cfg.remat)
        for p in params.get("dense_blocks", []):
            h, _ = block(p, h)
        totals = {}
        for p in _unbind_layers(params["blocks"]):
            h, metrics = block(p, h)
            for k, v in metrics.items():
                totals[k] = totals[k] + v.sum() if k in totals else v.sum()
        return nn.rmsnorm(gathered(params["ln_f"]), lc(h, _RESID)), totals

    def _input(self, table: Tensor, tokens, embeds) -> Tensor:
        """The first hidden state: ``embeds`` (VLM) cast to the parameters'
        dtype, else the table at ``tokens``."""
        if self.embeds_input and embeds is not None:
            return torch.as_tensor(embeds, device=table.device).to(
                table.dtype)
        return embed(table, tokens)

    def loss(self, params, batch: dict):
        """Mean next-token cross-entropy plus the z-loss of ``batch``
        (``tokens`` or, for the VLM, ``embeds [B, S, D]``, and ``labels``
        ``[B, S]``, on the model's device) under the parameter tree
        ``params``, plus the MoE router's aux and z losses over
        ``cfg.n_layers`` -> (loss, metrics)."""
        cfg = self.cfg
        table = gathered(params["embed"]["table"])
        h = self._input(table, batch.get("tokens"), batch.get("embeds"))
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, moe_metrics = self.forward(params, h, positions)
        h = lc(h, ("batch", "seq", "embed_act"))
        w = (table.t() if cfg.tie_embeddings
             else gathered(params["unembed"]["w"]))
        loss, metrics = cross_entropy(_matmul_f32(h, w), batch["labels"])
        if moe_metrics:
            loss = loss + 0.01 * moe_metrics["aux_loss"] / cfg.n_layers \
                + 1e-3 * moe_metrics["router_z"] / cfg.n_layers
            metrics.update({k: v for k, v in moe_metrics.items()
                            if k != "expert_load"})
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serving

    def _caches(self, n: int, b: int, cache_len: int, dtype) -> attn.KVCache:
        cfg = self.cfg
        shape = (n, b, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        ck = torch.empty(shape, dtype=dtype, device=self.device)
        return attn.KVCache(k=ck, v=torch.empty_like(ck))

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, embeds=None, *, params=None,
                caches=None):
        """``tokens [B, S]`` int, or for the VLM ``embeds [B, S, D]`` (cast
        to the parameters' dtype; ``tokens`` is then unused) -> (last-
        position logits ``[B, V]`` f32, caches ``{"scan": KVCache(k=[L, B,
        cache_len, KV, hd], ...)}``, with ``"dense"``, a ``KVCache`` a
        dense block, when the model has dense blocks). ``params`` (a
        parameter tree, :meth:`params`' layout) and ``caches`` (laid out as
        the result, filled in place) are the planner's: its DTensors stand
        for the module's own parameters and fresh caches."""
        cfg = self.cfg
        layers, table, ln_f = self._serving(params)
        if embeds is not None and not self.embeds_input:
            raise ValueError(f"{cfg.name}: embeds are the VLM's input")
        if embeds is None and params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = self._input(table, tokens, embeds)
        b, s = h.shape[:2]
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                             f"{cache_len}")
        positions = torch.arange(s, dtype=torch.int32, device=h.device)
        n_dense = cfg.first_dense_layers
        if caches is None:
            dense = self._caches(n_dense, b, cache_len, h.dtype)
            scan = self._caches(self.n_scan, b, cache_len, h.dtype)
            dense_caches = [attn.KVCache(k=dense.k[i], v=dense.v[i])
                            for i in range(n_dense)]
        else:
            scan = caches["scan"]
            dense_caches = list(caches.get("dense", []))
        layer_caches = dense_caches + [
            attn.KVCache(k=scan.k[i], v=scan.v[i])
            for i in range(self.n_scan)]
        for p, cache in zip(layers, layer_caches):
            h = self._block_prefill(p, h, positions, cache)
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        out = {"scan": scan}
        if n_dense:
            out["dense"] = layer_caches[:n_dense]
        return self._logits(h[:, -1], params), out

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: dict, position: int, *,
                    params=None):
        """``tokens [B]`` int at ``position`` -> (logits ``[B, V]`` f32,
        caches, updated in place); ``params`` as in :meth:`prefill`."""
        layers, table, ln_f = self._serving(params)
        if params is None:
            tokens = torch.as_tensor(tokens, device=self.device)
        h = nn.embed(table, tokens)[:, None, :]
        stacked = caches["scan"]
        layer_caches = list(caches.get("dense", [])) + [
            attn.KVCache(k=stacked.k[i], v=stacked.v[i])
            for i in range(self.n_scan)]
        for p, cache in zip(layers, layer_caches):
            h, _ = self._block_decode(p, h, cache, int(position))
        h = nn.rmsnorm(ln_f, lc(h, _RESID))
        return self._logits(h[:, 0], params), caches

    # ---------------------------------------------------------- input specs

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        """The caches' :class:`~repro_torch.models.layout.Spec` tree, as
        JAX's ``cache_specs``."""
        cfg = self.cfg
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        one = lambda pre: attn.KVCache(k=Spec(pre + shape, cfg.param_dtype),
                                       v=Spec(pre + shape, cfg.param_dtype))
        specs = {"scan": one((self.n_scan,))}
        if cfg.first_dense_layers:
            specs["dense"] = [one(()) for _ in range(cfg.first_dense_layers)]
        return specs

    def cache_axes(self, batch: int, cache_len: int) -> dict:
        ax = ("batch", "cache_seq", "kv_heads", "head_dim")
        specs = {"scan": attn.KVCache(k=("layers",) + ax,
                                      v=("layers",) + ax)}
        if self.cfg.first_dense_layers:
            specs["dense"] = [attn.KVCache(k=ax, v=ax)
                              for _ in range(self.cfg.first_dense_layers)]
        return specs

    def input_specs(self, shape_cfg) -> dict:
        """Each input's :class:`~repro_torch.models.layout.Spec`, as JAX's
        ``input_specs``: a decode step's ``position`` is a 0-dim int32."""
        cfg = self.cfg
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        i32 = torch.int32
        if shape_cfg.kind == "train":
            if self.embeds_input:
                return {"embeds": Spec((b, s, cfg.d_model), cfg.param_dtype),
                        "labels": Spec((b, s), i32)}
            return {"tokens": Spec((b, s), i32), "labels": Spec((b, s), i32)}
        if shape_cfg.kind == "prefill":
            if self.embeds_input:
                return {"embeds": Spec((b, s, cfg.d_model), cfg.param_dtype)}
            return {"tokens": Spec((b, s), i32)}
        return {"tokens": Spec((b,), i32),
                "caches": self.cache_specs(b, s),
                "position": Spec((), i32)}

    def input_axes(self, shape_cfg) -> dict:
        """Logical axes for each input (for shardings)."""
        if shape_cfg.kind == "train":
            if self.embeds_input:
                return {"embeds": ("batch", "seq", "embed_act"),
                        "labels": ("batch", "seq")}
            return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape_cfg.kind == "prefill":
            if self.embeds_input:
                return {"embeds": ("batch", "seq", "embed_act")}
            return {"tokens": ("batch", "seq")}
        return {"tokens": ("batch",),
                "caches": self.cache_axes(shape_cfg.global_batch,
                                          shape_cfg.seq_len),
                "position": ()}


def _plain(module: tnn.Module):
    """A tree of :func:`_tree`'s modules as nested dicts (and lists) of
    tensors."""
    if isinstance(module, tnn.ParameterDict):
        return {k: v for k, v in module.items()}
    if isinstance(module, tnn.ModuleList):
        return [_plain(m) for m in module]
    if isinstance(module, _Node):
        return {**dict(module._parameters),
                **{k: _plain(m) for k, m in module._modules.items()}}
    return {k: _plain(v) for k, v in module.items()}


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    out = {}
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _as_tensor(a) -> Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16, as JAX hands it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_jax_params(model: tnn.Module, tree: Mapping) -> tnn.Module:
    """Copy the JAX ``split_params`` tree (numpy arrays, bf16 or any float
    dtype) into ``model``'s parameters (any model of the port), leaf by
    leaf, converting to their dtype. Raises on a missing or extra leaf and
    on any shape mismatch."""
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
