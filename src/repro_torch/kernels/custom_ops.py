"""The kernels on the planner's paths as dispatcher-visible operators
(the planner's route), and the decorator every kernel's wrapper wears.

A kernel launched through ``ctypes`` is invisible to PyTorch's dispatcher,
so neither a fake tensor nor a DTensor can pass through it. This module
registers ``flash_attention``, ``decode_attention``, ``cscatter`` and
``selective_scan`` (with its backward, ``selective_scan_backward``) as
``torch.library.custom_op`` operators (``torch.ops.repro_torch.*``), each
with

* an implementation that calls the kernel's wrapper: the CUDA launch on a
  CUDA tensor, the plain version on a CPU tensor, as a direct call;
* a fake (shape) function, so that the op traces on fake tensors with
  nothing allocated;
* a DTensor sharding rule (:func:`register_shardings`), so that it runs on
  DTensors with each device's shard: flash over the batch or over the
  heads (H and KV split together, so that G = H / KV holds), decode over
  the batch or the KV heads, ``cscatter`` over the columns D (columns are
  independent) or replicated, the scan over the batch or the channels D
  (JAX's ``"mlp"``: each channel's states are independent; its backward
  leaves the sums over channels, ``d b`` and ``d c``, and the sum over the
  batch, ``d a``, as partial sums). DTensor keeps only strategies that
  split their dims evenly; anything else is replicated.

``selective_scan`` has ``register_autograd``: its backward is the op
``selective_scan_backward``, so that a train step traces its backward on
DTensors. On CUDA tensors that op runs the forward kernels again for
their checkpoints and then the backward kernels; on CPU tensors the
autograd formula takes the plain version's own backward instead, and the
op refuses them. The train path on a concrete tensor never takes the op
(``kernels/selective_scan._Scan`` keeps the checkpoints).

``decode_attention_lse`` is decode with each head's log-sum-exp, which a
cache split over devices by sequence combines by; it runs on each
device's slice (``models/attention._sharded_decode``), so it has no
sharding rule.

:func:`kernel_call` decorates each kernel's wrapper (``flash_attention``,
``decode_attention``, ``cscatter``, ``cmerge``). A planner's tensor (a
DTensor, a meta or a fake tensor, :func:`planned`) takes the wrapper's
custom op; a concrete tensor launches the kernel directly, as before: a
call through a Python custom op costs tens of microseconds of dispatch,
which the KV tick cannot pay. While anyone listens (``repro_torch.hooks``),
a concrete call is bracketed by ``emit("kernel_begin", name, args,
kwargs)`` and ``emit("kernel_end", name, result)``, whichever route runs
it (the CUDA launch or the plain version): a wrapper's result is what the
kernel wrote (an in-place kernel returns the table it updated), so the
taint tracker (``analysis/trace.py``) follows the data from the arguments
into it, and the op-level walk (``launch/op_cost.py``) counts the call
once, by the kernel's formula.

``cscatter`` updates ``table`` in place (``mutates_args``). This module
imports no kernel module at import time: each imports it for the
decorator.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch import hooks

Tensor = torch.Tensor


def planned(x: Tensor) -> bool:
    """Whether ``x`` is a planner's tensor (a DTensor, a meta or a fake
    tensor), which takes the custom op."""
    if type(x) is torch.Tensor:
        return x.is_meta
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return isinstance(x, (FakeTensor, DTensor))


def _flash_route(q, k, v, *, causal=True, window=0):
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, int(window))


def _decode_route(q, k, v, position):
    return torch.ops.repro_torch.decode_attention(q, k, v, int(position))


def _cscatter_route(table, ids, vals, *, kind="add", sat_min=0.0,
                    sat_max=0.0):
    torch.ops.repro_torch.cscatter(table, ids, vals, kind, float(sat_min),
                                   float(sat_max))
    return table


def _scan_route(dt, u, b, c, a, h0):
    return torch.ops.repro_torch.selective_scan(dt, u, b, c, a, h0)


# the wrapper's arguments -> its custom op's call
_ROUTES = {"flash_attention": _flash_route, "decode_attention": _decode_route,
           "cscatter": _cscatter_route, "selective_scan": _scan_route}


def kernel_call(name: str) -> Callable:
    """Decorate the wrapper of kernel ``name``: a planner's first argument
    takes the kernel's custom op (where it has one); a concrete call runs
    the wrapper, bracketed by ``kernel_begin`` / ``kernel_end`` while
    anyone listens. With no listener a concrete call costs two tests more
    than the wrapper's own."""
    route = _ROUTES.get(name)

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if route is not None and planned(args[0]):
                return route(*args, **kwargs)
            if not hooks.LISTENERS:
                return fn(*args, **kwargs)
            hooks.emit("kernel_begin", name, args, kwargs)
            out = None
            try:
                out = fn(*args, **kwargs)
            finally:
                hooks.emit("kernel_end", name, out)
            return out
        return call

    return wrap


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int) -> Tensor:
    from repro_torch.kernels.flash_attention import flash_attention as fn
    return fn(q, k, v, causal=causal, window=window)


@flash_attention.register_fake
def _(q, k, v, causal, window):
    b, h, s, d = q.shape
    if q.device.type == "cpu":      # the plain version's layout
        return q.new_empty((b, h, s, d))
    return q.new_empty((b, s, h, d)).transpose(1, 2)   # the kernel's


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: Tensor, k: Tensor, v: Tensor,
                     position: int) -> Tensor:
    from repro_torch.kernels.decode_attention import decode_attention as fn
    return fn(q, k, v, position)


@decode_attention.register_fake
def _(q, k, v, position):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::decode_attention_lse",
                         mutates_args=())
def decode_attention_lse(q: Tensor, k: Tensor, v: Tensor,
                         position: int) -> tuple[Tensor, Tensor]:
    """``decode_attention`` and the log-sum-exp of each head's scores
    ``[B, H]`` f32: what a cache split over devices combines by (each
    device attends to its slots; the softmax of the slices' lse weighs
    their outputs)."""
    from repro_torch.kernels import decode_attention as _decode
    from repro_torch.kernels.cscatter import _sm_count
    if q.device.type == "cuda":
        b, h, d = q.shape
        out, m, l, _ = _decode.launch(
            q, k, v, position,
            _decode.plan_splits(b, k.shape[2], k.shape[1], d,
                                _sm_count(q.device)))
    else:
        m, l, acc = _decode.decode_attention_partials_plain(q, k, v,
                                                           position, 1)
        out = _decode.decode_attention_combine_plain(m, l, acc, q.dtype)
    top = m.amax(0)
    lse = top + torch.log((l * torch.exp(m - top)).sum(0).clamp_min(1e-30))
    return out, lse


@decode_attention_lse.register_fake
def _(q, k, v, position):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.custom_op("repro_torch::cscatter", mutates_args=("table",))
def cscatter(table: Tensor, ids: Tensor, vals: Tensor, kind: str,
             sat_min: float, sat_max: float) -> None:
    from repro_torch.kernels.cscatter import cscatter as fn
    fn(table, ids, vals, kind=kind, sat_min=sat_min, sat_max=sat_max)


@cscatter.register_fake
def _(table, ids, vals, kind, sat_min, sat_max):
    return None


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan(dt: Tensor, u: Tensor, b: Tensor, c: Tensor, a: Tensor,
                   h0: Tensor) -> tuple[Tensor, Tensor]:
    from repro_torch.kernels.selective_scan import selective_scan as fn
    y, h = fn(dt, u, b, c, a, h0)
    return y, h


@selective_scan.register_fake
def _(dt, u, b, c, a, h0):
    return dt.new_empty(dt.shape), h0.new_empty(h0.shape)


@torch.library.custom_op("repro_torch::selective_scan_backward",
                         mutates_args=())
def selective_scan_backward(dt: Tensor, u: Tensor, b: Tensor, c: Tensor,
                            a: Tensor, h0: Tensor, dy: Tensor, dh: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                       Tensor, Tensor]:
    """The six gradients of ``sum(y dy) + sum(h_T dh)``: (d dt, d u, d b,
    d c, d a, d h0)."""
    from repro_torch.kernels import selective_scan as sc
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan_backward: no kernel for device "
                         f"{dt.device} (a CPU tensor's backward is the plain "
                         f"version's autograd)")
    ins = [x.contiguous() for x in (dt, u, b, c, a, h0)]
    _, _, ckpt = sc.launch_forward(*ins)
    return sc.launch_backward(*ins[:5], ckpt, dy.float().contiguous(),
                              dh.float().contiguous())


@selective_scan_backward.register_fake
def _(dt, u, b, c, a, h0, dy, dh):
    return tuple(x.new_empty(x.shape) for x in (dt, u, b, c, a, h0))


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_backward(ctx, dy, dh):
    ins = ctx.saved_tensors
    if ins[0].device.type == "cpu":
        # the plain version's own backward, built here above the dispatcher
        from repro_torch.kernels.selective_scan import selective_scan_plain
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ins]
            y, h = selective_scan_plain(*leaves)
            return torch.autograd.grad((y, h), leaves, (dy, dh))
    return torch.ops.repro_torch.selective_scan_backward(*ins, dy, dh)


selective_scan.register_autograd(_scan_backward, setup_context=_scan_setup)


_REGISTERED = False


def register_shardings() -> None:
    """Register the ops' DTensor sharding rules (once a process)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash_rule(q, k, v, causal, window):
        # q [B, H, S, d], k, v [B, KV, T, d]: batch, or heads with KV.
        return [([R], [R, R, R, None, None]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None]),
                ([Shard(1)], [Shard(1), Shard(1), Shard(1), None, None])]

    @register_sharding(torch.ops.repro_torch.decode_attention.default)
    def _decode_rule(q, k, v, position):
        # q [B, H, d], k, v [B, T, KV, d]: batch, or the KV heads.
        return [([R], [R, R, R, None]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0), None]),
                ([Shard(1)], [Shard(1), Shard(2), Shard(2), None])]

    @register_sharding(torch.ops.repro_torch.cscatter.default)
    def _cscatter_rule(table, ids, vals, kind, sat_min, sat_max):
        # table [R, D] (or [S, R, D]), vals [N, D]: the columns D.
        col = len(table.shape) - 1
        return [([], [R, R, R, None, None, None]),
                ([], [Shard(col), R, Shard(len(vals.shape) - 1), None, None,
                      None])]

    @register_sharding(torch.ops.repro_torch.selective_scan.default)
    def _scan_rule(dt, u, b, c, a, h0):
        # dt, u [B, T, D], b, c [B, T, S], a [D, S], h0 [B, D, S] -> y
        # [B, T, D], h [B, D, S]: the batch, or the channels D.
        S0 = Shard(0)
        return [([R, R], [R] * 6),
                ([S0, S0], [S0, S0, S0, S0, R, S0]),
                ([Shard(2), Shard(1)],
                 [Shard(2), Shard(2), R, R, S0, Shard(1)])]

    @register_sharding(torch.ops.repro_torch.selective_scan_backward.default)
    def _scan_backward_rule(dt, u, b, c, a, h0, dy, dh):
        # -> d dt, d u, d b, d c, d a, d h0: over the batch d a is a
        # partial sum, over the channels d b and d c are.
        from torch.distributed.tensor import Partial
        S0, P = Shard(0), Partial()
        return [([R] * 6, [R] * 8),
                ([S0, S0, S0, S0, P, S0], [S0, S0, S0, S0, R, S0, S0, S0]),
                ([Shard(2), Shard(2), P, P, S0, Shard(1)],
                 [Shard(2), Shard(2), R, R, S0, Shard(1), Shard(2),
                  Shard(1)])]

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype_rule(a, b, out_dtype):
        # the f32-output product of the logits: aten.mm's strategies
        from torch.distributed.tensor import Partial
        return [([R], [R, R, None]),
                ([Shard(0)], [Shard(0), R, None]),
                ([Shard(1)], [R, Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]

    _REGISTERED = True
