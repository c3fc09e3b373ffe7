"""Permutation builders shared by the flat and hierarchical merge paths.

Every cross-rank exchange in the merge engine is a ``ppermute`` (on the
stacked layout, ``repro_torch.core.stacked.StackedAxis.ppermute``) whose
permutation is built here. All builders return *full* permutations (every
rank appears exactly once as a source): ranks that do not participate in a
round get an identity self-pair, which keeps every rank's value defined
(a rank that is no pair's destination would receive zeros).

Rank geometry: a ``stride``-sized *unit* is a contiguous, aligned run of
ranks ``[u*stride, (u+1)*stride)``; a *block* groups ``fanout`` sibling
units. ``stride == 1`` degenerates to the flat case (every rank is its own
unit), which is how ``tree_merge`` and the plan's innermost level share
these builders.
"""

from __future__ import annotations


def is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _require_divides(builder: str, what: str, block: int, size: int) -> None:
    if block < 1 or size % block != 0:
        raise ValueError(
            f"{builder}: {what} {block} must divide the axis size {size}; a "
            f"partial trailing block would send ranks outside the axis")


def butterfly_perms(size: int, step: int) -> list[tuple[int, int]]:
    """One recursive-doubling round over the whole axis: ``i <-> i ^ step``.

    For aligned power-of-two blocks, steps below the block size stay inside
    the block (``i ^ step`` preserves the high bits), so this single builder
    serves both the flat butterfly and block-confined intra rounds. The
    pairing is only a permutation when ``2 * step`` tiles the axis — loudly
    rejected otherwise (``i ^ step`` would leave the axis).
    """
    if not is_pow2(step):
        raise ValueError(f"butterfly_perms: step must be a power of two, "
                         f"got {step}")
    _require_divides("butterfly_perms", "pair block 2*step", 2 * step, size)
    return [(i, i ^ step) for i in range(size)]


def ring_perm(size: int, group: int) -> list[tuple[int, int]]:
    """Each rank -> next lane in its aligned ``group``-sized ring."""
    _require_divides("ring_perm", "group", group, size)
    return [(i, (i // group) * group + ((i % group) + 1) % group)
            for i in range(size)]


def rep_exchange_perms(size: int, stride: int,
                       fanout: int) -> list[list[tuple[int, int]]]:
    """Exchange among unit representatives across ``fanout`` sibling units.

    Only ranks at multiples of ``stride`` (unit leaders) participate; within
    each ``stride * fanout`` block they run a recursive-doubling butterfly
    (power-of-two ``fanout``) or a single ring perm circulated ``fanout - 1``
    times (otherwise). ``stride == size // fanout`` with one block recovers
    the two-level inter-group exchange; ``stride == 1`` the flat butterfly.
    """
    block = stride * fanout
    _require_divides("rep_exchange_perms", "block stride*fanout", block, size)
    perms: list[list[tuple[int, int]]] = []

    def partner_of(step_or_inc: int, ring: bool) -> list[tuple[int, int]]:
        out = []
        for i in range(size):
            if i % stride != 0:
                out.append((i, i))
                continue
            base = (i // block) * block
            g = (i % block) // stride
            ng = (g + step_or_inc) % fanout if ring else g ^ step_or_inc
            out.append((i, base + ng * stride))
        return out

    if is_pow2(fanout):
        step = 1
        while step < fanout:
            perms.append(partner_of(step, ring=False))
            step <<= 1
    else:
        perms.append(partner_of(1, ring=True))
    return perms


def lane_exchange_perms(size: int, stride: int,
                        fanout: int) -> list[list[tuple[int, int]]]:
    """Lane-parallel variant of ``rep_exchange_perms``: EVERY rank
    participates, paired with the same lane of the partner unit, so the
    cross-unit exchange bandwidth-parallelizes over the unit's ``stride``
    lanes instead of serializing on lane 0. Butterfly for power-of-two
    ``fanout``, ring perm otherwise."""
    block = stride * fanout
    _require_divides("lane_exchange_perms", "block stride*fanout", block, size)

    def perm_for(step_or_inc: int, ring: bool) -> list[tuple[int, int]]:
        out = []
        for i in range(size):
            base = (i // block) * block
            g = (i % block) // stride
            lane = i % stride
            ng = (g + step_or_inc) % fanout if ring else g ^ step_or_inc
            out.append((i, base + ng * stride + lane))
        return out

    perms: list[list[tuple[int, int]]] = []
    if is_pow2(fanout):
        step = 1
        while step < fanout:
            perms.append(perm_for(step, ring=False))
            step <<= 1
    else:
        perms.append(perm_for(1, ring=True))
    return perms


def binomial_broadcast_perms(size: int,
                             group: int) -> list[tuple[int, list[tuple[int, int]]]]:
    """Binomial swap-tree broadcast from lane 0 of each aligned ``group``:
    returns ``[(k, perm), ...]`` rounds; at round ``k`` lanes ``[k, 2k)``
    receive from lanes ``[0, k)`` (the caller selects with ``lane < k``)."""
    _require_divides("binomial_broadcast_perms", "group", group, size)
    rounds = []
    k = 1
    while k < group:
        perm = []
        for i in range(size):
            lane = i % group
            partner = lane ^ k
            if lane < 2 * k and partner < group:
                perm.append((i, (i // group) * group + partner))
            else:
                perm.append((i, i))
        rounds.append((k, perm))
        k <<= 1
    return rounds


def lane_gather_doubling_perms(size: int,
                               stride: int) -> list[list[tuple[int, int]]]:
    """Recursive-doubling all-gather pairing within each aligned unit:
    round ``k`` pairs lane ``l`` with lane ``l ^ 2^k``. Power-of-two
    ``stride`` only (callers fall back to ``ring_perm`` otherwise)."""
    if not is_pow2(stride):
        raise ValueError(
            f"lane_gather_doubling_perms: stride must be a power of two "
            f"(recursive doubling pairs lanes by XOR), got {stride}; use "
            f"ring_perm for other unit sizes")
    _require_divides("lane_gather_doubling_perms", "stride", stride, size)
    perms = []
    k = 1
    while k < stride:
        perms.append([(i, (i // stride) * stride + ((i % stride) ^ k))
                      for i in range(size)])
        k <<= 1
    return perms
