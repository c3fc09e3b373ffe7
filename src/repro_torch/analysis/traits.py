"""Trait certification: do a merge fn's declared algebra traits hold?

The port of the JAX package's ``repro/analysis/traits.py``. The engine
trusts ``MergeFn`` trait declarations at plan-compile time
(``check_deferrable`` / ``check_overlap``) — a mislabeled merge silently
buys scheduling freedom its algebra cannot pay for (a ``sat_add`` declared
scalable would be granted the delayed-mean settle path and clip different
sums than the per-step program). This module probes the declarations:

* **randomized algebraic probes** — the reference's identities on the
  same deterministic random inputs (numpy's ``default_rng(seed)``, the
  x1/x10/x100 magnitude sweep, 3 trials, the scalars 2, 0.5, 3):

    idempotent   combine(a, a) == a
    scalable     combine(c*a, c*b) == c*combine(a, b)  AND the delayed-mean
                 installation apply(apply(m, c*a), c*b) ==
                 apply(m, c*combine(a, b))
    invertible   combine(a, delta(a, b)) == b
    deferrable   apply(apply(m, u1), u2) == apply(m, combine(u1, u2))

* **op classification** — where the reference walks ``apply``'s jaxpr next
  to ``combine``'s, the port runs both under a ``TorchDispatchMode`` that
  collects the aten ops each calls. A deferrable-declared merge whose
  apply uses comparison/clamp/select ops (:data:`MEMORY_OBSERVING`) that
  combine does not is flagged even when the random probes missed the
  threshold.

Probes are refutation-only: a passing probe certifies nothing beyond "not
provably mislabeled" (the probes are sound, not complete).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.merge_functions import MergeFn

_SCALES = (1.0, 10.0, 100.0)
_PROBE_SCALARS = (2.0, 0.5, 3.0)
_N_TRIALS = 3

# apply-side aten ops that read memory through a value-dependent branch:
# the counterparts of the reference's min, max, clamp, select_n, lt, gt,
# le and ge primitives
MEMORY_OBSERVING = {"minimum", "maximum", "min", "max", "clamp",
                    "clamp_min", "clamp_max", "where", "lt", "gt", "le",
                    "ge"}


def _sample(fn: MergeFn, rng: np.random.Generator, shape: tuple,
            scale: float) -> torch.Tensor:
    """A random update drawn from the merge's value domain (the
    reference's draws): int32 bit patterns for the bitwise merges, else
    floats bounded away from zero with random signs, times ``scale``."""
    if fn.xla_reduce in ("or", "and"):
        return torch.as_tensor(rng.integers(0, 1 << 20, size=shape),
                               dtype=torch.int32)
    mag = rng.uniform(0.5, 1.5, size=shape) * scale
    sign = rng.choice([-1.0, 1.0], size=shape)
    return torch.as_tensor(mag * sign, dtype=torch.float32)


def _probe_shape(fn: MergeFn) -> tuple:
    # structured combines (COMPLEX_MUL) need a whole trailing atom
    return (4, 3) if fn.wire_atom == 1 else (4, fn.wire_atom)


def _close(a: torch.Tensor, b: torch.Tensor) -> bool:
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    scale = float(a.abs().max() + b.abs().max() + 1.0)
    return bool(torch.allclose(a, b, rtol=1e-3, atol=1e-4 * scale))


def _scale_update(u: torch.Tensor, c: float) -> torch.Tensor:
    if not u.dtype.is_floating_point:
        return (u * int(c)) if float(c) == int(c) else u
    return u * c


class _OpNames(TorchDispatchMode):
    """The aten op names (overload packets) a region runs."""

    def __init__(self):
        super().__init__()
        self.names: set[str] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def op_names(fn, *args) -> set[str]:
    """The aten ops ``fn(*args)`` runs."""
    with _OpNames() as mode:
        fn(*args)
    return mode.names


def certify_merge_fn(fn: MergeFn, site: Optional[str] = None,
                     seed: int = 0) -> list[Diagnostic]:
    """Probe ``fn``'s declared traits; returns the refutations found."""
    site = site or f"merge:{fn.name}"
    shape = _probe_shape(fn)
    rng = np.random.default_rng(seed)
    diags: list[Diagnostic] = []

    def refute(code: str, what: str, lhs, rhs, detail: str) -> None:
        diags.append(Diagnostic(
            code=code, site=site,
            message=f"merge {fn.name!r} is declared {what} but {detail}: "
                    f"probe lhs={lhs.numpy().ravel()[:4]} != "
                    f"rhs={rhs.numpy().ravel()[:4]}"))

    samples = [(scale, _sample(fn, rng, shape, scale),
                _sample(fn, rng, shape, scale),
                _sample(fn, rng, shape, scale))
               for scale in _SCALES for _ in range(_N_TRIALS)]

    if fn.idempotent:
        for _, a, _b, _m in samples:
            got = fn.combine(a, a)
            if not _close(got, a):
                refute("CC001", "idempotent", got, a,
                       "combine(a, a) != a")
                break

    if fn.scalable:
        done = False
        for _, a, b, m in samples:
            for c in _PROBE_SCALARS:
                ca, cb = _scale_update(a, c), _scale_update(b, c)
                lhs = fn.combine(ca, cb)
                rhs = _scale_update(fn.combine(a, b), c)
                if not _close(lhs, rhs):
                    refute("CC002", "scalable", lhs, rhs,
                           "combine(c*a, c*b) != c*combine(a, b)")
                    done = True
                    break
                # the delayed-mean settle installs ONE scaled aggregate in
                # place of the per-step applies: the identity must survive
                # apply (sat_add's clipped sums do not)
                if fn.needs_key:
                    continue
                lhs = fn.apply(fn.apply(m, ca), cb)
                rhs = fn.apply(m, fn.combine(ca, cb))
                if not _close(lhs, rhs):
                    refute("CC002", "scalable", lhs, rhs,
                           "installing the scaled aggregate diverges from "
                           "the per-step applies "
                           "(apply(apply(m, c*a), c*b) != "
                           "apply(m, c*combine(a, b)))")
                    done = True
                    break
            if done:
                break

    if fn.invertible:
        for _, a, b, _m in samples:
            got = fn.combine(a, fn.delta(a, b))
            if not _close(got, b):
                refute("CC003", "invertible", got, b,
                       "combine(a, delta(a, b)) != b")
                break

    if fn.needs_key and fn.deferrable:
        diags.append(Diagnostic(
            code="CC006", site=site,
            message=f"merge {fn.name!r} draws a PRNG key per apply but is "
                    f"declared deferrable; collapsing K applies into one "
                    f"changes the sampling distribution"))
    elif fn.deferrable:
        for _, u1, u2, m in samples:
            lhs = fn.apply(fn.apply(m, u1), u2)
            rhs = fn.apply(m, fn.combine(u1, u2))
            if not _close(lhs, rhs):
                refute("CC004", "deferrable", lhs, rhs,
                       "apply(apply(m, u1), u2) != "
                       "apply(m, combine(u1, u2))")
                break
        # structural corroboration: a memory-observing apply contradicts
        # the homomorphism even when the probes missed the threshold
        _, u1, u2, m = samples[0]
        apply_ops = op_names(fn.apply, m, u1)
        combine_ops = op_names(fn.combine, u1, u2)
        observing = (apply_ops - combine_ops) & MEMORY_OBSERVING
        if observing and not any(d.code == "CC004" for d in diags):
            diags.append(Diagnostic(
                code="CC005", site=site,
                message=f"merge {fn.name!r} is declared deferrable but its "
                        f"apply uses memory-observing ops "
                        f"{sorted(observing)} that combine does not — a "
                        f"value-dependent threshold observed against "
                        f"memory at every commit"))

    return diags
