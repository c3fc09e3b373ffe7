"""The parameter layout of every model family: each leaf's shape, dtype and
logical axes, built from the config alone (nothing is allocated).

The counterpart of the JAX package's logical-axis tags
(``repro/models/module.py`` ``px`` and ``split_params``): there every
parameter is created through ``px(value, axes)`` and ``split_params``
separates the tagged tree into values and an axes tree. Here the axes are a
tree of their own, parallel to ``model.params()``: :func:`param_layout`
mirrors each family's ``init`` (the same names, nesting, shapes, dtypes and
axes, stacked layers with a leading ``"layers"`` axis), :func:`param_axes`
keeps the axes and :func:`param_specs` the ``(shape, dtype)`` of each
leaf. ``sharding/partition.py`` maps the logical axes to a mesh.

The planner (``launch/steps.py``) builds its fake parameters from
:func:`param_specs` at full width, where a model built for real would not
fit (llama3-405b, kimi-k2-1t).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree


class Leaf(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    axes: tuple


class Spec(NamedTuple):
    """A tensor's shape and dtype: the counterpart of JAX's
    ``ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype


def _is_leaf(x) -> bool:
    return isinstance(x, Leaf)


def _dense(d_in: int, d_out: int, axes: tuple, dtype, bias: bool = False,
           bias_axes: tuple | None = None) -> dict:
    p = {"w": Leaf((d_in, d_out), dtype, tuple(axes))}
    if bias:
        p["b"] = Leaf((d_out,), dtype, tuple(bias_axes or (axes[-1],)))
    return p


def _rmsnorm(d: int, dtype) -> dict:
    return {"scale": Leaf((d,), dtype, ("embed",))}


def _layernorm(d: int, dtype) -> dict:
    return {"scale": Leaf((d,), dtype, ("embed",)),
            "bias": Leaf((d,), dtype, ("embed",))}


def _attention(d: int, h: int, kv: int, hd: int, dtype,
               qkv_bias: bool = False) -> dict:
    return {"wq": _dense(d, h * hd, ("embed", "heads"), dtype, qkv_bias),
            "wk": _dense(d, kv * hd, ("embed", "kv_heads"), dtype, qkv_bias),
            "wv": _dense(d, kv * hd, ("embed", "kv_heads"), dtype, qkv_bias),
            "wo": _dense(h * hd, d, ("heads", "embed"), dtype)}


def _swiglu(d: int, d_ff: int, dtype) -> dict:
    return {"wi_gate": _dense(d, d_ff, ("embed", "mlp"), dtype),
            "wi_up": _dense(d, d_ff, ("embed", "mlp"), dtype),
            "wo": _dense(d_ff, d, ("mlp", "embed"), dtype)}


def _gelu_mlp(d: int, d_ff: int, dtype, bias: bool = True) -> dict:
    return {"wi": _dense(d, d_ff, ("embed", "mlp"), dtype, bias),
            "wo": _dense(d_ff, d, ("mlp", "embed"), dtype, bias)}


def _moe(d: int, d_ff: int, n_experts: int, dtype, n_shared: int) -> dict:
    p = {"router": {"w": Leaf((d, n_experts), torch.float32,
                              ("embed", "expert"))},
         "wi_gate": Leaf((n_experts, d, d_ff), dtype,
                         ("expert", "embed", "expert_mlp")),
         "wi_up": Leaf((n_experts, d, d_ff), dtype,
                       ("expert", "embed", "expert_mlp")),
         "wo": Leaf((n_experts, d_ff, d), dtype,
                    ("expert", "expert_mlp", "embed"))}
    if n_shared:
        p["shared"] = _swiglu(d, d_ff * n_shared, dtype)
    return p


def _ssm(d: int, d_state: int, d_inner: int, dtype, conv_k: int = 4) -> dict:
    dt_rank = max(1, d // 16)
    return {"in_proj": _dense(d, 2 * d_inner, ("embed", "mlp"), dtype),
            "conv_w": Leaf((conv_k, d_inner), dtype, ("conv", "mlp")),
            "conv_b": Leaf((d_inner,), dtype, ("mlp",)),
            "x_bc": _dense(d_inner, 2 * d_state, ("mlp", "state"), dtype),
            "x_dt": _dense(d_inner, dt_rank, ("mlp", "state"), dtype),
            "dt_proj": _dense(dt_rank, d_inner, ("state", "mlp"), dtype,
                              bias=True),
            "a_log": Leaf((d_inner, d_state), torch.float32,
                          ("mlp", "state")),
            "d_skip": Leaf((d_inner,), torch.float32, ("mlp",)),
            "out_proj": _dense(d_inner, d, ("mlp", "embed"), dtype)}


def _mlstm(d: int, n_heads: int, dtype, proj_factor: float,
           conv_k: int = 4) -> dict:
    di = int(d * proj_factor)
    return {"in_proj": _dense(d, 2 * di, ("embed", "mlp"), dtype),
            "conv_w": Leaf((conv_k, di), dtype, ("conv", "mlp")),
            "conv_b": Leaf((di,), dtype, ("mlp",)),
            "wq": _dense(di, di, ("mlp", "heads"), dtype),
            "wk": _dense(di, di, ("mlp", "heads"), dtype),
            "wv": _dense(di, di, ("mlp", "heads"), dtype),
            "w_if": _dense(di, 2 * n_heads, ("mlp", "heads"), dtype,
                           bias=True),
            "w_o": _dense(di, di, ("mlp", "mlp"), dtype),
            "ln_h": _rmsnorm(di, dtype),
            "out_proj": _dense(di, d, ("mlp", "embed"), dtype)}


def _slstm(d: int, n_heads: int, dtype, ffn_factor: float = 4.0 / 3.0
           ) -> dict:
    dh = d // n_heads
    d_ff = int(d * ffn_factor)
    return {"w_x": _dense(d, 4 * d, ("embed", "mlp"), dtype, bias=True),
            "r": Leaf((n_heads, dh, 4 * dh), dtype,
                      ("heads", "head_dim", "mlp")),
            "ln_h": _rmsnorm(d, dtype),
            "up": _dense(d, d_ff, ("embed", "mlp"), dtype),
            "down": _dense(d_ff, d, ("mlp", "embed"), dtype)}


def _stacked(tree: Any, n: int) -> Any:
    """``n`` layers of ``tree`` stacked: each leaf gains a leading
    ``"layers"`` dim (JAX's ``stack_layer_init``)."""
    return pytree.tree_map(
        lambda l: Leaf((n,) + l.shape, l.dtype, ("layers",) + l.axes), tree,
        is_leaf=_is_leaf)


def _embed(cfg, dt) -> dict:
    return {"table": Leaf((cfg.padded_vocab, cfg.d_model), dt,
                          ("vocab", "embed"))}


def _decoder_lm(cfg, dt) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ffn = _gelu_mlp if cfg.mlp == "gelu" else _swiglu

    def block(moe_ffn: bool, d_ff: int) -> dict:
        p = {"ln1": _rmsnorm(d, dt),
             "attn": _attention(d, cfg.n_heads, cfg.n_kv_heads, hd, dt,
                                cfg.qkv_bias),
             "ln2": _rmsnorm(d, dt)}
        if moe_ffn:
            p["moe"] = _moe(d, cfg.d_ff_expert, cfg.n_experts, dt,
                            cfg.n_shared_experts)
        else:
            p["ffn"] = ffn(d, d_ff, dt)
        return p

    out = {"embed": _embed(cfg, dt),
           "blocks": _stacked(block(cfg.family == "moe", cfg.d_ff),
                              cfg.n_layers - cfg.first_dense_layers),
           "ln_f": _rmsnorm(d, dt)}
    if cfg.first_dense_layers:
        out["dense_blocks"] = [block(False, cfg.d_ff or 4 * cfg.d_ff_expert)
                               for _ in range(cfg.first_dense_layers)]
    if not cfg.tie_embeddings:
        out["unembed"] = {"w": Leaf((d, cfg.padded_vocab), dt,
                                    ("embed", "vocab"))}
    return out


def _hymba(cfg, dt) -> dict:
    d = cfg.d_model
    block = {"ln1": _rmsnorm(d, dt),
             "attn": _attention(d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, dt),
             "ssm": _ssm(d, cfg.ssm_state, int(d * cfg.ssm_expand), dt),
             "ln_attn": _rmsnorm(d, dt),
             "ln_ssm": _rmsnorm(d, dt),
             "beta": Leaf((2,), torch.float32, (None,)),
             "ln2": _rmsnorm(d, dt),
             "ffn": _swiglu(d, cfg.d_ff, dt)}
    return {"embed": _embed(cfg, dt),
            "blocks": _stacked(block, cfg.n_layers),
            "ln_f": _rmsnorm(d, dt)}


def _xlstm(cfg, dt) -> dict:
    k = cfg.slstm_every
    blocks = []
    for i in range(cfg.n_layers):
        p = {"ln": _rmsnorm(cfg.d_model, dt)}
        if k and i % k == k - 1:
            p["slstm"] = _slstm(cfg.d_model, cfg.n_heads, dt)
        else:
            p["mlstm"] = _mlstm(cfg.d_model, cfg.n_heads, dt,
                                cfg.ssm_expand)
        blocks.append(p)
    return {"embed": _embed(cfg, dt), "blocks": blocks,
            "ln_f": _rmsnorm(cfg.d_model, dt)}


def _encdec(cfg, dt) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = lambda: _attention(d, cfg.n_heads, cfg.n_kv_heads, hd, dt)
    enc = {"ln1": _layernorm(d, dt), "attn": attn(),
           "ln2": _layernorm(d, dt), "ffn": _gelu_mlp(d, cfg.d_ff, dt)}
    dec = {"ln1": _layernorm(d, dt), "self_attn": attn(),
           "ln_x": _layernorm(d, dt), "cross_attn": attn(),
           "ln2": _layernorm(d, dt), "ffn": _gelu_mlp(d, cfg.d_ff, dt)}
    return {"embed": _embed(cfg, dt),
            "enc": _stacked(enc, cfg.n_enc_layers or cfg.n_layers),
            "dec": _stacked(dec, cfg.n_dec_layers or cfg.n_layers),
            "ln_enc": _layernorm(d, dt),
            "ln_f": _layernorm(d, dt)}


_FAMILIES = {"dense": _decoder_lm, "moe": _decoder_lm, "vlm": _decoder_lm,
             "hybrid": _hymba, "ssm": _xlstm, "encdec": _encdec}


def param_layout(cfg) -> Any:
    """The tree of :class:`Leaf` (shape, dtype, logical axes) of ``cfg``'s
    model, parallel to its ``params()``."""
    try:
        build = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family!r}") from None
    return build(cfg, cfg.param_dtype)


def param_axes(cfg) -> Any:
    """The logical-axes tree of ``cfg``'s parameters: JAX's
    ``split_params(...)[1]``."""
    return pytree.tree_map(lambda l: l.axes, param_layout(cfg),
                           is_leaf=_is_leaf)


def param_specs(cfg) -> Any:
    """The :class:`Spec` (shape, dtype) tree of ``cfg``'s parameters."""
    return pytree.tree_map(lambda l: Spec(l.shape, l.dtype),
                           param_layout(cfg), is_leaf=_is_leaf)
