"""Placement lint: the collectives a tick makes vs the scheduled manifest.

The port's twin of the JAX package's ``repro/analysis/placement.py``.
There layer 2 walks compiled HLO (``launch/hlo_cost.py``); the port has no
HLO, so its walk is built from the collectives a tick actually made
(:func:`walk_of`, over ``trace.CollectiveRecorder``'s calls), with the same
keys the reference's checks read — ``wire_bytes_by_level_total``,
``level_names`` and ``per_collective`` — a ``ppermute`` leaf counted as a
``collective-permute`` and a ``psum/pmax/pmin`` leaf as an ``all-reduce``,
and the bytes put on levels by the port's link mapping
(``launch/wire_cost.py``, which equals the reference's HLO walk level by
level). The checks over a walk dict are the reference's, unchanged:

* :func:`check_noncommit_walk` — CC020: a non-commit tick must move ZERO
  cross-rank collective bytes; :func:`check_noncommit_record` is the same
  check over a record carrying the walk's fields.
* :func:`check_commit_walk` — CC021: a commit program's collectives must
  match the manifest (no bytes above the topmost scheduled level, every
  scheduled exchange moves bytes on its own level, only the scheduled
  kinds, the scheduled round counts).

Two checks run on the device instead of on compiled text:

* :func:`check_rank_isolation` — CC020 again: a non-commit tick run with
  one rank's keys and values perturbed must leave every other rank's
  outputs bitwise equal. It runs the real kernels, so it catches
  cross-rank movement that bypasses ``StackedAxis`` (a ``roll`` over the
  shard dim), which no recorded walk sees.
* :func:`check_donation` — CC022: no state tensor a tick is given as
  donated may be copied whole inside the tick, seen at the aten level by
  the taint tracker of ``analysis/trace.py``: a ``clone``, ``copy``,
  ``copy_`` or same-dtype ``_to_copy`` that reads all of a donated buffer
  (a duplicate of the state), or a ``copy_`` over all of it of a value
  computed from it out of place (``s.copy_(s + d)``). Either is what the
  reference's "donation compiled to a copy" costs, a pass over the whole
  state that the update did not need. A merge's fresh result is not one
  (the caching allocator hands it the blocks the caller's old state
  frees), nor is a reset that writes constants over a donated buffer, so
  the check does not ask for the result in the donated storage. The
  reference's HLO-text parsers (``aliased_param_numbers``, its alias-map
  regex) have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import hooks
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.trace import CollectiveCall, _Taint, clone_tree
from repro_torch.core.stacked import stacked_spmd
from repro_torch.launch import wire_cost

_KIND = {"ppermute": "collective-permute", "psum": "all-reduce",
         "pmax": "all-reduce", "pmin": "all-reduce"}


def walk_of(calls: Iterable[CollectiveCall], level_sizes: Sequence[int],
            level_names: Optional[Sequence[str]] = None) -> dict:
    """The walk dict of the recorded ``calls`` on a hierarchy of
    ``level_sizes`` (innermost first; their product is the axis size)."""
    level_sizes = [int(s) for s in level_sizes]
    level_names = list(level_names or [f"level{i}"
                                       for i in range(len(level_sizes))])
    if len(level_names) != len(level_sizes):
        raise ValueError(f"{len(level_names)} level names for "
                         f"{len(level_sizes)} level sizes")
    size = int(np.prod(level_sizes))
    bounds = list(np.cumprod(level_sizes[:-1]).astype(int))
    vec = [0.0] * len(level_sizes)
    per: dict[str, dict] = {}
    for c in calls:
        if c.size != size:
            raise ValueError(f"level sizes {level_sizes} multiply to {size}, "
                             f"the axis has {c.size} ranks")
        entry = per.setdefault(_KIND[c.kind], {"count": 0, "bytes": 0.0})
        for nbytes in c.rank_bytes:
            before = sum(vec)
            if c.kind == "ppermute":
                wire_cost._permute(vec, c.perm, nbytes, bounds)
            else:
                wire_cost._all_reduce(vec, c.size, c.group, nbytes, bounds)
            entry["count"] += 1
            entry["bytes"] += sum(vec) - before
    return {"wire_bytes_by_level_total": vec, "level_names": level_names,
            "per_collective": per}


def _nonzero_levels(walk: dict) -> list[tuple[int, float]]:
    totals = walk.get("wire_bytes_by_level_total") or []
    return [(i, b) for i, b in enumerate(totals) if b > 0]


def _level_name(walk: dict, i: int) -> str:
    names = walk.get("level_names") or []
    return names[i] if i < len(names) else f"level{i}"


def check_noncommit_record(rec: dict, site: str) -> Optional[Diagnostic]:
    """CC020 over a wire record (a walk dict or a record carrying its
    fields): any collective byte or op disqualifies a non-commit tick.
    Returns ``None`` when clean."""
    hot = _nonzero_levels(rec)
    per = rec.get("per_collective") or {}
    ops = {k: v.get("count", 0) for k, v in per.items()
           if isinstance(v, dict) and v.get("count", 0) > 0}
    # benchmark records flatten the per-kind counts into "collectives"
    counts = rec.get("collectives")
    if isinstance(counts, dict):
        ops.update({k: v for k, v in counts.items() if v})
    if not hot and not ops:
        return None
    detail = []
    if hot:
        detail.append("bytes " + ", ".join(
            f"{_level_name(rec, i)}={b:.0f}" for i, b in hot))
    if ops:
        detail.append(f"ops {ops}")
    return Diagnostic(
        code="CC020", site=site,
        level=_level_name(rec, hot[0][0]) if hot else None,
        message=f"non-commit tick moves collective traffic "
                f"({'; '.join(detail)}); the privatized hot path must run "
                f"ZERO collectives")


def check_noncommit_walk(walk: dict, site: str) -> list[Diagnostic]:
    d = check_noncommit_record(walk, site)
    return [d] if d else []


def check_commit_walk(walk: dict, manifest: Sequence, site: str,
                      n_leaves: int = 1,
                      exact_counts: bool = True) -> list[Diagnostic]:
    """CC021: the walk's collective multiset vs the scheduled ``manifest``
    (a ``ccache.program_manifest`` stage list). ``n_leaves`` is the number
    of payload tensors riding each exchange; ``exact_counts=False`` relaxes
    the round-count equality to >= (compressed wire formats carry extra
    leaves per round)."""
    if not manifest:
        return check_noncommit_walk(walk, site)
    diags: list[Diagnostic] = []
    totals = walk.get("wire_bytes_by_level_total") or []
    per = walk.get("per_collective") or {}

    top = max(m.index for m in manifest)
    for i, b in _nonzero_levels(walk):
        if i > top:
            diags.append(Diagnostic(
                code="CC021", site=site, level=_level_name(walk, i),
                message=f"{b:.0f} collective bytes on level "
                        f"{_level_name(walk, i)} above the topmost "
                        f"scheduled level {manifest[-1].name!r}; the "
                        f"commit reached links the plan never scheduled"))
    for m in manifest:
        if m.fanout > 1 and m.index < len(totals) and totals[m.index] <= 0:
            diags.append(Diagnostic(
                code="CC021", site=site, level=m.name,
                message=f"scheduled stage {m.name!r} ({m.kind}, fanout "
                        f"{m.fanout}) moved no bytes on its own level; "
                        f"the exchange was elided or misplaced"))

    allowed = {"collective-permute"}
    if any(m.fused_ops for m in manifest):
        allowed.add("all-reduce")
    if any(m.kind == "gather" for m in manifest):
        allowed.add("all-gather")
    observed = {k for k, v in per.items()
                if isinstance(v, dict) and v.get("count", 0) > 0}
    for kind in sorted(observed - allowed):
        diags.append(Diagnostic(
            code="CC021", site=site,
            message=f"program emits {kind} (count "
                    f"{per[kind].get('count')}), which no scheduled stage "
                    f"produces; an exchange the plan did not ask for"))

    want_permutes = sum(m.permute_rounds for m in manifest) * n_leaves
    got_permutes = (per.get("collective-permute") or {}).get("count", 0)
    bad = (got_permutes != want_permutes if exact_counts
           else got_permutes < want_permutes)
    if bad:
        diags.append(Diagnostic(
            code="CC021", site=site,
            message=f"collective-permute count {got_permutes:.0f} != "
                    f"scheduled {want_permutes} ("
                    + " + ".join(f"{m.name}:{m.permute_rounds}"
                                 for m in manifest)
                    + f" rounds x {n_leaves} leaves)"))
    want_fused = sum(m.fused_ops for m in manifest) * n_leaves
    got_fused = (per.get("all-reduce") or {}).get("count", 0)
    if exact_counts and got_fused != want_fused:
        diags.append(Diagnostic(
            code="CC021", site=site,
            message=f"fused all-reduce count {got_fused:.0f} != scheduled "
                    f"{want_fused}"))
    return diags


def check_walk_bytes(walk: dict, want: Sequence[float],
                     site: str) -> list[Diagnostic]:
    """CC021: a commit's recorded bytes on each level must equal the cost
    model's (``wire_cost.wire_bytes_by_level`` over the scheduled stages),
    the vector the commit schedule is solved from."""
    got = walk.get("wire_bytes_by_level_total") or []
    if list(got) == list(want):       # the same sums, in the same order
        return []
    return [Diagnostic(
        code="CC021", site=site,
        message=f"recorded wire bytes by level {list(got)} != the cost "
                f"model's {list(want)} ({walk.get('level_names')}); the "
                f"schedule is solved from bytes the commit does not move")]


# -- device-level checks -----------------------------------------------------


def _leaves(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def check_rank_isolation(fn: Callable, args: Sequence,
                         perturbed: Sequence[int], n_ranks: int, site: str,
                         ranks: Optional[Sequence[int]] = None
                         ) -> list[Diagnostic]:
    """CC020 on the device: run the non-commit tick ``fn`` on a copy of
    ``args``, then again with rank ``r``'s rows of the arguments at
    ``perturbed`` (keys and values, leading dim ``n_ranks``) replaced by
    rank ``r + 1``'s, shifted by one along the batch; every output tensor
    with a leading rank dim must keep every other rank's rows bitwise."""
    base = _leaves(fn(*clone_tree(tuple(args))))
    diags = []
    for r in (ranks if ranks is not None else (0, n_ranks // 2)):
        run = list(clone_tree(tuple(args)))
        for i in perturbed:
            t = run[i]
            t[r] = torch.roll(t[(r + 1) % n_ranks], 1, 0)
        got = _leaves(fn(*run))
        moved = []
        for j, (a, b) in enumerate(zip(base, got)):
            if a.dim() == 0 or a.shape[0] != n_ranks:
                continue
            others = [k for k in range(n_ranks) if k != r
                      and not torch.equal(a[k], b[k])]
            if others:
                moved.append((j, others))
        if moved:
            diags.append(Diagnostic(
                code="CC020", site=site,
                message=f"perturbing rank {r}'s inputs changed other "
                        f"ranks' outputs (output leaf, ranks): {moved}; "
                        f"the non-commit tick moves data across ranks "
                        f"outside the scheduled exchange"))
    return diags


class _CopyWatch(_Taint):
    """The taint tracker, labelling each donated leaf with its flat number,
    that also records the whole copies of donated buffers (module doc) as
    (leaf number, aten op)."""

    def __init__(self, donated: Sequence[tuple[int, torch.Tensor]]):
        super().__init__()
        self.donated: dict[int, tuple[int, int]] = {}
        for n, t in donated:
            if self.key(t) is not None:     # an empty buffer copies nothing
                self.label(t, n)
                self.donated[self.key(t)] = (n, t.untyped_storage().nbytes())
        self.copies: list[tuple[int, str]] = []

    def _whole(self, t) -> Optional[int]:
        """The leaf number of the donated buffer ``t`` covers, if all."""
        if not isinstance(t, torch.Tensor):
            return None
        hit = self.donated.get(self.key(t))
        if hit and t.numel() * t.element_size() >= hit[1]:
            return hit[0]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket.__name__
        if op in ("clone", "lift_fresh_copy") or (
                op == "_to_copy" and kwargs.get("dtype") in (
                    None, args[0].dtype)):
            n = self._whole(args[0])
            if n is not None:
                self.copies.append((n, op))
        elif op in ("copy", "copy_"):
            n = self._whole(args[1])
            if n is not None:
                self.copies.append((n, op))
            n = self._whole(args[0]) if op == "copy_" else None
            if n is not None and n in self.of(args[1]):
                self.copies.append((n, op))
        return super().__torch_dispatch__(func, types, args, kwargs)


def check_donation(fn: Callable, args: Sequence, donate: Sequence[int],
                   site: str) -> list[Diagnostic]:
    """CC022: run ``fn`` on a copy of ``args`` through ``stacked_spmd``
    with ``donate``; no donated tensor may be copied whole on the way.
    Reports the flat argument leaf numbers that were, with the copying
    op."""
    args = clone_tree(tuple(args))
    donated: list[tuple[int, torch.Tensor]] = []
    n = 0
    for i, a in enumerate(args):
        for leaf in pytree.tree_leaves(a):
            if i in donate and isinstance(leaf, torch.Tensor):
                donated.append((n, leaf))
            n += 1
    watch = _CopyWatch(donated)
    with hooks.listening(watch.on), watch:
        stacked_spmd(fn, *args, donate=tuple(donate))
    if not watch.copies:
        return []
    return [Diagnostic(
        code="CC022", site=site,
        message=f"donated argument leaves were copied whole inside the "
                f"tick (leaf, op): {sorted(set(watch.copies))}; a donated "
                f"buffer is to be updated, not duplicated — the in-place "
                f"update silently regressed to a copy of the state")]
