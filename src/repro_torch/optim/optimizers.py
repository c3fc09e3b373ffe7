"""Optimizers: AdamW and Adafactor (factored second moment).

The counterparts of the JAX package's ``repro/optim/optimizers.py``, with
its functional API over dicts of tensors::

    opt = make_optimizer(cfg, schedule)
    state = opt.init(params)
    params, state, stats = opt.step(params, grads, state)

Moments are f32. A bf16 parameter is updated in f32 and cast back. ``step``
returns new tensors and leaves its arguments as they were, so a caller may
drop a poisoned result (the train driver's NaN skip) and keep the old
state. ``step(..., donate=True)`` is the counterpart of a jitted step with
donated buffers: it updates the parameters and the moments in place, leaf
by leaf, and scales the gradients in place for the clip, so that no second
copy of the state is alive. It runs the same operations in the same order
as the functional form (the same bits); the caller must not read its
arguments again, as with a donated argument. The step counter is a 0-dim
int32 tensor on the CPU, as the schedule's learning rate is.

The same code steps DTensors: the shards of a state split over a process
group (FSDP parameters and moments, a replicated step count), each process
updating its own; the global norm's sum of squares is reduced over the
group, and the donating form writes each process's shards in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: PyTree          # first moment (AdamW) or None
    nu: PyTree          # second moment / factored rows+cols


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    # step(params, grads, state, donate=False) -> (params, state, stats)
    step: Callable[..., tuple[PyTree, OptState, dict]]


def _into(x: torch.Tensor, donate: bool) -> Optional[torch.Tensor]:
    """The ``out=`` of an update of ``x``: ``x`` itself when donated, else
    a new tensor."""
    return x if donate else None


def _write(p: torch.Tensor, new: torch.Tensor, donate: bool) -> torch.Tensor:
    """The updated parameter in ``p``'s dtype: written into ``p`` when
    donated (the same rounding as ``.to``), else a new tensor."""
    return p.copy_(new) if donate else new.to(p.dtype)


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float, donate: bool = False
                        ) -> tuple[PyTree, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm`` (in place
    when ``donate``) -> (grads, the norm before the clip)."""
    leaves = pytree.tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    if donate:
        for g in leaves:
            torch.mul(g, scale, out=g)
        return grads, gn
    return pytree.tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm=1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=pytree.tree_map(zeros, params),
                        nu=pytree.tree_map(zeros, params))

    @torch.no_grad()
    def step(params, grads, state, donate=False):
        grads, gn = clip_by_global_norm(grads, max_grad_norm, donate)
        t = state.step + 1
        lr = schedule(t)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def upd(p, g, mu, nu):
            # mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g g;
            # p - lr ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p)
            g = g.float()
            mu = torch.mul(mu, b1, out=_into(mu, donate)).add_(
                torch.mul(g, 1 - b1))
            nu = torch.mul(nu, b2, out=_into(nu, donate)).add_(
                torch.mul(g, 1 - b2).mul_(g))
            u = torch.div(mu, bc1).div_(torch.div(nu, bc2).sqrt_().add_(eps))
            u.add_(torch.mul(p.float(), weight_decay))
            return (_write(p, torch.sub(p.float(), u.mul_(lr), out=u),
                           donate), mu, nu)

        leaves_p, spec = pytree.tree_flatten(params)
        out = [upd(*args) for args in zip(
            leaves_p, pytree.tree_leaves(grads), pytree.tree_leaves(state.mu),
            pytree.tree_leaves(state.nu))]
        unflat = lambda i: pytree.tree_unflatten([o[i] for o in out], spec)
        return (unflat(0), OptState(step=t, mu=unflat(1), nu=unflat(2)),
                {"grad_norm": gn, "lr": lr})

    return Optimizer(init=init, step=step)


def adafactor(schedule, decay=0.8, eps=1e-30, weight_decay=0.0,
              max_grad_norm=1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern): O(n+m) state for
    an [n, m] matrix instead of O(nm)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def nu_for(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"row": torch.zeros(p.shape[:-1], **f32),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           **f32)}
            return {"full": torch.zeros(p.shape, **f32)}
        leaves, spec = pytree.tree_flatten(params)
        return OptState(step=torch.zeros((), dtype=torch.int32), mu=None,
                        nu=pytree.tree_unflatten([nu_for(p) for p in leaves],
                                                 spec))

    @torch.no_grad()
    def step(params, grads, state, donate=False):
        grads, gn = clip_by_global_norm(grads, max_grad_norm, donate)
        t = state.step + 1
        lr = schedule(t)
        beta = 1.0 - t.to(torch.float32) ** (-decay)

        def ema(x, new):
            """beta x + (1 - beta) new, into ``x`` when donated."""
            return torch.mul(x, beta, out=_into(x, donate)).add_(
                torch.mul(new, 1 - beta))

        def upd(p, g, nu):
            g = g.float()
            g2 = torch.mul(g, g).add_(eps)
            if "full" in nu:
                nu_new = {"full": ema(nu["full"], g2)}
                u = torch.div(g, torch.sqrt(nu_new["full"]).add_(1e-12))
            else:
                row = ema(nu["row"], g2.mean(-1))
                col = ema(nu["col"], g2.mean(-2))
                nu_new = {"row": row, "col": col}
                v = _factored_moment(row, torch.clamp(row.mean(-1, keepdim=True),
                                               min=eps), col, g)
                u = torch.div(g, v.sqrt_().add_(1e-12))
            # update clipping (RMS <= 1), as Adafactor
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u.div_(torch.clamp(rms, min=1.0))
            if weight_decay:
                u.add_(torch.mul(p.float(), weight_decay))
            return (_write(p, torch.sub(p.float(), u.mul_(lr), out=u),
                           donate), nu_new)

        leaves_p, spec = pytree.tree_flatten(params)
        leaves_nu = pytree.tree_leaves(state.nu, is_leaf=_is_moment)
        out = [upd(p, g, nu) for p, g, nu in zip(
            leaves_p, pytree.tree_leaves(grads), leaves_nu)]
        return (pytree.tree_unflatten([o[0] for o in out], spec),
                OptState(step=t, mu=None,
                         nu=pytree.tree_unflatten([o[1] for o in out], spec)),
                {"grad_norm": gn, "lr": lr})

    return Optimizer(init=init, step=step)


def _factored_moment(row: torch.Tensor, den: torch.Tensor,
                     col: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(row / den)[..., None] * col[..., None, :]``, the factored
    moment, laid out as ``like`` (the gradient). For DTensors each process
    divides its rows of ``row`` and multiplies them by its columns of
    ``col``, each first moved where ``like``'s slice needs it (through
    ``core/mesh_axis.redistribute``): DTensor's own broadcasting ops would
    gather them through its collectives."""
    if not hasattr(like, "placements"):
        return (row / den)[..., None] * col[..., None, :]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.mesh_axis import redistribute
    last = like.dim() - 1
    rows = [Shard(p.dim) if isinstance(p, Shard) and p.dim < last
            else Replicate() for p in like.placements]
    cols = [Shard(p.dim - 1 if p.dim == last else p.dim)
            if isinstance(p, Shard) and p.dim != last - 1 else Replicate()
            for p in like.placements]
    # den keeps one entry where row has its last dim
    dens = [Replicate() if isinstance(p, Shard) and p.dim == last - 1
            else p for p in rows]
    r = (redistribute(row, rows).to_local()
         / redistribute(den, dens).to_local())
    out = r[..., None] * redistribute(col, cols).to_local()[..., None, :]
    return DTensor.from_local(out, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _is_moment(x) -> bool:
    """Adafactor's per-parameter second moment: ``{"row", "col"}`` or
    ``{"full"}``."""
    return isinstance(x, dict) and set(x) in ({"row", "col"}, {"full"})


def make_optimizer(arch_cfg, schedule) -> Optimizer:
    if arch_cfg.optimizer == "adafactor":
        return adafactor(schedule)
    return adamw(schedule)
