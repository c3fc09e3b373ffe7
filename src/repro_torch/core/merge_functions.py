"""Merge functions: the software-defined commutative merges, in PyTorch.

Every merge factors into four algebraic pieces so the engine can both run
it as a cross-rank reduction with an arbitrary commutative combine and
defer / locally coalesce updates:

    delta(src, upd)               -> u      what one rank contributes
    combine(u1, u2)               -> u      associative + commutative coalescing
    apply(mem, u)                 -> mem'   installs the combined update into memory
    identity(shape, dtype, device) -> u     neutral element of ``combine``

``apply`` sees the *memory* copy — value-dependent conditionals (e.g.
saturation thresholds) observe memory, not the update copy.

``xla_reduce`` names the fixed reduce op (add/mul/min/max/or/and) when
``combine`` is one; the engine then takes a fused grouped reduction for
add/max/min (the name is kept from the JAX reference, where XLA fuses it).
Anything else runs the ppermute exchange.

Algebra traits
--------------

Deferral and overlap reorder *when* combined updates reach memory, and that
is only sound for some algebras:

    idempotent   combine(a, a) == a — lattice joins (max/min/or/and).
    scalable     combine(c*a, c*b) == c*combine(a, b) — ADD; makes delayed
                 *mean* semantics exist.
    invertible   every update has an inverse under combine (ADD/MUL/
                 COMPLEX_MUL).
    deferrable   apply(apply(m, u1), u2) == apply(m, combine(u1, u2)).
                 False when apply observes memory between commits
                 (saturating_add's threshold).

``deferrable`` gates ``:defer`` levels outright; overlapped (one-step-stale)
commits additionally need ``scalable or idempotent``.

``encode``/``decode`` optionally compress one rank's update for the wire
(``int8_compressed_add``); the engine applies them rank by rank. A merge
with ``needs_key`` (``dropping_add``) draws from a ``torch.Generator`` in
``apply``, where the JAX package takes a PRNG key: the two give different
bits from the same seed, so such merges are held to their laws, not to
JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class MergeFn:
    """A software-defined commutative merge (one MFRF entry)."""

    name: str
    delta: Callable[[Tensor, Tensor], Tensor]
    combine: Callable[[Tensor, Tensor], Tensor]
    apply: Callable[..., Tensor]  # (mem, u, *, key=None) -> mem'
    identity: Callable[..., Tensor]  # (shape, dtype, device=None) -> u
    xla_reduce: Optional[str] = None  # {"add","mul","min","max","or","and"}
    encode: Optional[Callable[[Tensor], PyTree]] = None
    decode: Optional[Callable[[PyTree], Tensor]] = None
    needs_key: bool = False  # apply wants a torch.Generator (approximate merges)
    # Contiguous trailing elements ``combine`` treats as one value (2 for
    # complex real/imag pairs). The lane-parallel exchange splits payloads
    # on atom boundaries so structured combines see whole elements.
    wire_atom: int = 1
    idempotent: bool = False   # combine(a, a) == a
    scalable: bool = False     # combine(c*a, c*b) == c*combine(a, b)
    invertible: bool = False   # updates have inverses under combine
    deferrable: bool = True    # apply distributes over combine

    def tree_delta(self, src: PyTree, upd: PyTree) -> PyTree:
        return pytree.tree_map(self.delta, src, upd)

    def tree_combine(self, u1: PyTree, u2: PyTree) -> PyTree:
        return pytree.tree_map(self.combine, u1, u2)

    def tree_apply(self, mem: PyTree, u: PyTree,
                   key: Optional[torch.Generator] = None) -> PyTree:
        """``apply`` leaf by leaf. A keyed merge draws every leaf's noise
        from ``key`` in turn (JAX splits one key per leaf instead)."""
        if self.needs_key:
            if key is None:
                raise ValueError(f"merge {self.name!r} needs a key: pass a "
                                 f"torch.Generator")
            return pytree.tree_map(lambda m, uu: self.apply(m, uu, key=key),
                                   mem, u)
        return pytree.tree_map(self.apply, mem, u)

    def tree_identity(self, like: PyTree) -> PyTree:
        return pytree.tree_map(
            lambda x: self.identity(x.shape, x.dtype, device=x.device), like)

    # ---------------------------------------------------- derived validity

    @property
    def stale_tolerant(self) -> bool:
        """May a one-step-stale (overlapped) commit land against this merge?
        Scalable merges absorb the delay into delayed-mean bookkeeping;
        idempotent merges cannot be corrupted by duplicated or late joins."""
        return self.scalable or self.idempotent

    def settle_mode(self) -> Optional[str]:
        """How a K-step deferred commit reconciles with per-step semantics:
        ``"mean"`` (scalable), ``"reapply"`` (idempotent), or ``None``
        (neither; a deferred loop has no sound way to install the
        aggregate and callers must raise)."""
        if self.scalable:
            return "mean"
        if self.idempotent:
            return "reapply"
        return None

    def check_deferrable(self, context: str) -> None:
        """Raise unless ``:defer`` is algebra-sound for this merge."""
        if not self.deferrable:
            raise ValueError(
                f"{context}: merge '{self.name}' cannot defer commits — its "
                "apply is not a homomorphism over combine (it observes "
                "memory or randomizes per commit), so applying K coalesced "
                "steps at once diverges from applying each step. Drop the "
                ":defer flags or pick a deferrable merge.")
        if self.needs_key:
            raise ValueError(
                f"{context}: merge '{self.name}' draws a random key per "
                "apply; deferred commits collapse K applies into one and "
                "would change the sampling distribution. Drop the :defer "
                "flags.")

    def check_overlap(self, context: str) -> None:
        """Raise unless one-step-stale commit landings are algebra-sound."""
        self.check_deferrable(context)
        if not self.stale_tolerant:
            raise ValueError(
                f"{context}: merge '{self.name}' cannot land one-step-stale "
                "overlapped commits — it is neither scalable (no delayed-"
                "mean reconciliation) nor idempotent (a late landing is not "
                "a harmless re-join). Defer without overlap.")


def _full(shape, dtype, value, device=None) -> Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def _zeros(shape, dtype, device=None):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _ones(shape, dtype, device=None):
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def _neg_inf(shape, dtype, device=None):
    if dtype.is_floating_point:
        return _full(shape, dtype, float("-inf"), device)
    return _full(shape, dtype, torch.iinfo(dtype).min, device)


def _pos_inf(shape, dtype, device=None):
    if dtype.is_floating_point:
        return _full(shape, dtype, float("inf"), device)
    return _full(shape, dtype, torch.iinfo(dtype).max, device)


def _all_ones(shape, dtype, device=None):
    if dtype.is_floating_point:
        raise TypeError(f"bitwise AND has no identity for {dtype}")
    # -1 for signed types; the dtype's max (every bit set) for unsigned ones
    return _full(shape, dtype, torch.iinfo(dtype).max if
                 torch.iinfo(dtype).min == 0 else -1, device)


def _scalar_as(value: float, dtype: torch.dtype):
    """``value`` cast the way ``jnp.asarray(value, dtype)`` casts it."""
    return float(value) if dtype.is_floating_point else int(value)


# ---------------------------------------------------------------------------
# Standard merges (paper §3.2 / §6.3 menu).
# ---------------------------------------------------------------------------

ADD = MergeFn(
    name="add",
    delta=lambda src, upd: upd - src,
    combine=lambda a, b: a + b,
    apply=lambda mem, u: mem + u,
    identity=_zeros,
    xla_reduce="add",
    scalable=True,
    invertible=True,
)

MUL = MergeFn(  # multiplicative updates: contribution is the factor upd/src
    name="mul",
    delta=lambda src, upd: upd / src,
    combine=lambda a, b: a * b,
    apply=lambda mem, u: mem * u,
    identity=_ones,
    xla_reduce="mul",
    invertible=True,
)


# Complex multiply: represented as (..., 2) real/imag channels, as in the
# JAX package, so the same merge runs on real dtypes.
def _cmul(a: Tensor, b: Tensor) -> Tensor:
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def _cdiv(a: Tensor, b: Tensor) -> Tensor:
    br, bi = b[..., 0], b[..., 1]
    d = br * br + bi * bi
    conj = torch.stack([br, -bi], dim=-1)
    return _cmul(a, conj) / d[..., None]


def _cones(shape, dtype, device=None):
    one = torch.zeros(tuple(shape), dtype=dtype, device=device)
    one[..., 0] = 1
    return one


COMPLEX_MUL = MergeFn(
    name="complex_mul",
    delta=lambda src, upd: _cdiv(upd, src),
    combine=_cmul,
    apply=lambda mem, u: _cmul(mem, u),
    identity=_cones,
    wire_atom=2,
    invertible=True,
)

MAX = MergeFn(
    name="max",
    delta=lambda src, upd: upd,
    combine=torch.maximum,
    apply=torch.maximum,
    identity=_neg_inf,
    xla_reduce="max",
    idempotent=True,
)

MIN = MergeFn(
    name="min",
    delta=lambda src, upd: upd,
    combine=torch.minimum,
    apply=torch.minimum,
    identity=_pos_inf,
    xla_reduce="min",
    idempotent=True,
)

BITWISE_OR = MergeFn(  # the paper's BFS bitmap merge
    name="or",
    delta=lambda src, upd: upd | src,
    combine=lambda a, b: a | b,
    apply=lambda mem, u: mem | u,
    identity=_zeros,
    xla_reduce="or",
    idempotent=True,
)

BITWISE_AND = MergeFn(
    name="and",
    delta=lambda src, upd: upd & src,
    combine=lambda a, b: a & b,
    apply=lambda mem, u: mem & u,
    identity=_all_ones,
    xla_reduce="and",
    idempotent=True,
)


def saturating_add(max_value: float, min_value: float | None = None) -> MergeFn:
    """Additive merge with a memory-observed threshold (paper §4.5)."""

    def _apply(mem, u):
        out = mem + u
        out = torch.clamp(out, max=_scalar_as(max_value, out.dtype))
        if min_value is not None:
            out = torch.clamp(out, min=_scalar_as(min_value, out.dtype))
        return out

    return MergeFn(
        name=f"sat_add[{max_value}]",
        delta=ADD.delta,
        combine=ADD.combine,
        apply=_apply,
        identity=_zeros,
        xla_reduce="add",  # combine is plain add; only apply saturates
        # The threshold is observed against memory at every commit: folding
        # K commits into one changes which sums get clipped.
        deferrable=False,
    )


def dropping_add(drop_prob: float) -> MergeFn:
    """Approximate merge (paper §3.2/§6.3): binomially drop updates.

    Per-element Bernoulli(drop_prob) masking of the combined update at apply
    time — the loop-perforation-style quality/performance trade-off. The
    draw comes from the ``torch.Generator`` passed as ``key`` (on the
    update's device): element e is kept where ``uniform[e] < 1 - drop_prob``,
    as ``jax.random.bernoulli`` decides, so drop_prob 0 keeps and 1 drops
    every element exactly.
    """

    def _apply(mem, u, *, key):
        keep = torch.rand(u.shape, generator=key, device=u.device) \
            < 1.0 - drop_prob
        return mem + torch.where(keep, u, torch.zeros_like(u))

    return MergeFn(
        name=f"drop_add[{drop_prob}]",
        delta=ADD.delta,
        combine=ADD.combine,
        apply=_apply,
        identity=_zeros,
        xla_reduce=None,  # flexible path only: COUP cannot express this
        needs_key=True,
        deferrable=False,  # one Bernoulli draw per commit, not per step
    )


def int8_compressed_add() -> MergeFn:
    """Delta merge with an int8-quantized wire format (beyond the paper).

    ``encode`` quantizes one rank's update with a per-tensor scale
    (``amax / 127``, ties rounded to even as ``jnp.round``); exchange rounds
    move ~4x fewer bytes than f32 (int8 plus a scalar). Decode/requantize at
    each combine keeps the reduction commutative up to quantization noise.
    """

    def _encode(u: Tensor):
        amax = u.abs().max() + 1e-12
        scale = amax / 127.0
        q = torch.clamp(torch.round(u / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.to(torch.float32)}

    def _decode(c) -> Tensor:
        return c["q"].to(torch.float32) * c["scale"]

    return MergeFn(
        name="int8_add",
        delta=ADD.delta,
        combine=ADD.combine,
        apply=lambda mem, u: mem + u.to(mem.dtype),
        identity=_zeros,
        xla_reduce=None,
        encode=_encode,
        decode=_decode,
        scalable=True,
        invertible=True,
    )


class MergeFunctionRegistry:
    """The MFRF: maps small integer ids -> merge functions.

    The paper provisions a 4-entry register file (2 merge-type bits / line);
    this one is software, so the size is a knob, but ids stay dense so the
    blocked engine / kernels can carry per-block merge-type tags.
    """

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._by_name: dict[str, MergeFn] = {}
        self._by_id: list[MergeFn] = []

    def merge_init(self, fn: MergeFn) -> int:
        """Register ``fn``; returns its MFRF id (paper: merge_init(&fn, i))."""
        if fn.name in self._by_name:
            return self._by_id.index(self._by_name[fn.name])
        if len(self._by_id) >= self.capacity:
            raise ValueError(f"MFRF full (capacity={self.capacity})")
        self._by_name[fn.name] = fn
        self._by_id.append(fn)
        return len(self._by_id) - 1

    def __getitem__(self, key) -> MergeFn:
        if isinstance(key, str):
            return self._by_name[key]
        return self._by_id[key]

    def id_of(self, name: str) -> int:
        return self._by_id.index(self._by_name[name])

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_id)

    def __iter__(self):
        """Registered merges in id order."""
        return iter(self._by_id)


def default_registry() -> MergeFunctionRegistry:
    reg = MergeFunctionRegistry()
    for fn in (ADD, MAX, MIN, BITWISE_OR, MUL, COMPLEX_MUL):
        reg.merge_init(fn)
    return reg


def standard_merges() -> tuple[MergeFn, ...]:
    """Every merge the package ships, including the parameterized families
    at representative parameters — the trait-certification sweep surface."""
    return tuple(default_registry()) + (
        saturating_add(8.0, min_value=-8.0),
        dropping_add(0.25),
        int8_compressed_add(),
    )
