"""Schedule-aware deferred commits: pick per-level commit intervals K from
the per-level roofline.

A :class:`DeferSchedule` says how often each deferred level of a
:class:`~repro_torch.core.merge_plan.MergePlan` commits. Intervals are
*nested* (each outer deferred level's K is a multiple of the level below),
so the levels due at any step are always a prefix of the deferred suffix —
which is what lets ``ccache.defer_cascade`` settle a pending upward through
the hierarchy without ever double-counting a contribution.

:func:`solve_defer_schedule` picks the intervals. A deferred level's commit
moves (to first order) the same bytes as its eager per-step exchange would,
so committing every ``K`` steps amortizes its wire time ``t_lvl`` to
``t_lvl / K`` per step. It picks the smallest ``K`` at which the amortized
time no longer dominates the per-step bound (compute, memory, or the eager
levels' exchange time):

    t_lvl / K  <=  target_fraction * max(compute_s, memory_s, eager_wire_s)

Its inputs are the per-level wire vector of the plan's eager twin
(``repro_torch.launch.wire_cost``) and a rate for every level, given as
``bandwidths`` or by a ``fabric`` object. There is no default rate: on one
card every level's exchange is a pass over device memory, so the rates are
measured there (``repro_torch.launch.kv_serve.measure_schedule_inputs``).
:class:`AdaptiveDeferSchedule` re-solves a uniform K online from the
measured ingest rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DeferSchedule:
    """Commit intervals for a plan's deferred levels, innermost first.

    ``level_names[i]`` commits every ``intervals[i]`` steps; intervals are
    nested (``intervals[i+1] % intervals[i] == 0``). ``period`` — the top
    interval — is the full-commit cycle: one optimizer-visible commit per
    ``period`` accumulated steps.

    ``overlap`` selects the overlapped commit pipeline: the top deferred
    level's exchange is *launched* on the full-commit step and *landed* one
    step later (``ccache.launch_inflight`` / ``settle_inflight``), beside
    the next step's work. The settled state then runs one step stale.
    """

    level_names: tuple[str, ...]
    intervals: tuple[int, ...]
    predicted: Optional[dict] = dataclasses.field(default=None, compare=False)
    overlap: bool = False

    def __post_init__(self):
        object.__setattr__(self, "level_names", tuple(self.level_names))
        object.__setattr__(self, "intervals", tuple(self.intervals))
        if len(self.level_names) != len(self.intervals):
            raise ValueError(
                f"{len(self.level_names)} deferred levels but "
                f"{len(self.intervals)} intervals")
        if not self.intervals:
            raise ValueError("DeferSchedule needs at least one deferred level")
        for name, k in zip(self.level_names, self.intervals):
            if int(k) != k or k < 1:
                raise ValueError(f"level {name!r}: commit interval must be a "
                                 f"positive integer, got {k!r}")
        for (ni, ki), (no, ko) in zip(
                zip(self.level_names, self.intervals),
                list(zip(self.level_names, self.intervals))[1:]):
            if ko % ki != 0:
                raise ValueError(
                    f"commit intervals must be nested (each outer level's K "
                    f"a multiple of the level below): {no}:{ko} is not a "
                    f"multiple of {ni}:{ki}")

    @property
    def num_levels(self) -> int:
        return len(self.intervals)

    @property
    def period(self) -> int:
        """Steps per full (optimizer-visible) commit cycle."""
        return self.intervals[-1]

    @property
    def max_period(self) -> int:
        """Upper bound on ``period`` over the schedule's lifetime. A fixed
        schedule never changes, so this IS the period; adaptive schedules
        report their ``k_max`` so capacity sized against ``max_period``
        (e.g. the partitioned store's pending ring) stays sufficient
        through re-solves."""
        return self.period

    def due_count(self, step: int) -> int:
        """How many leading deferred levels commit after completing the
        ``step``-th accumulation step (1-based). Nesting makes the due set
        a prefix, so a count is a complete description."""
        n = 0
        for k in self.intervals:
            if step % k == 0:
                n += 1
            else:
                break
        return n

    @staticmethod
    def fixed(k: int, level_names: Sequence[str],
              overlap: bool = False) -> "DeferSchedule":
        """Every deferred level commits every ``k`` steps (the manual
        ``--merge-defer K`` path)."""
        names = tuple(level_names)
        return DeferSchedule(level_names=names,
                             intervals=(int(k),) * len(names),
                             overlap=overlap)

    def as_dict(self) -> dict:
        out = {"level_names": list(self.level_names),
               "intervals": list(self.intervals),
               "period": self.period,
               "overlap": self.overlap}
        if self.predicted is not None:
            out["predicted"] = self.predicted
        return out

    def describe(self) -> str:
        parts = [f"{n}: K={k}" for n, k in zip(self.level_names,
                                               self.intervals)]
        s = ", ".join(parts) + f" (period {self.period})"
        if self.overlap:
            s += ", overlapped top-level commit (lands one step stale)"
        p = self.predicted
        if p:
            eager = p.get("wire_bytes_per_step_eager")
            amort = p.get("wire_bytes_per_step_deferred")
            if eager and amort:
                s += (f"; predicted wire {eager / 1e6:.2f} MB/step -> "
                      f"{amort / 1e6:.2f} MB/step")
            top = p.get("per_level", [])
            if top:
                t = top[-1]
                s += (f"; {t['name']} level {t['bytes_per_step'] / 1e6:.3f} "
                      f"MB/step -> {t['amortized_bytes_per_step'] / 1e6:.3f} "
                      f"MB/step ({t['interval']}x)")
        return s


class AdaptiveDeferSchedule:
    """A uniform commit interval re-solved from the measured ingest rate.

    Keeps an EMA of updates/tick (fed by :meth:`observe`), and at every
    full-commit boundary re-runs :func:`solve_defer_schedule` with

        compute_s = base_compute_s + per_update_s * ema

    Heavier ingest -> larger per-tick bound -> the commit amortizes more
    easily -> SMALLER K; idle traffic drifts K up toward ``k_max``.

    All deferred levels share one K (``DeferSchedule.fixed`` geometry) —
    the partitioned store requires all-or-nothing commits, and the uniform
    interval is what makes the mid-flight re-solve sound: the cycle phase
    is tracked internally, so changing K at a boundary never skips or
    doubles a level's commit. Offers the ``DeferSchedule`` surface the
    store uses (``level_names`` / ``due_count`` / ``period`` /
    ``max_period`` / ``overlap`` / ``as_dict``). ``due_count`` advances
    the internal phase — call it exactly once per tick, as
    ``ShardedKV.tick`` does.
    """

    def __init__(self, plan, wire_bytes_by_level: Sequence[float],
                 level_names: Optional[Sequence[str]] = None, *,
                 base_compute_s: float = 0.0, per_update_s: float = 0.0,
                 ema_alpha: float = 0.25, overlap: bool = False,
                 k_min: int = 1, k_max: int = 64, **solve_kwargs):
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        if per_update_s < 0.0 or base_compute_s < 0.0:
            raise ValueError("base_compute_s and per_update_s must be >= 0")
        self._plan = plan
        self._vec = tuple(float(b) for b in wire_bytes_by_level)
        self._measured_names = (tuple(level_names)
                                if level_names is not None else None)
        self._base = float(base_compute_s)
        self._per_update = float(per_update_s)
        self._alpha = float(ema_alpha)
        self._k_min, self._k_max = int(k_min), int(k_max)
        self._overlap = bool(overlap)
        self._solve_kwargs = dict(solve_kwargs)
        self._ema: Optional[float] = None
        self._phase = 0
        self._n_resolves = 0
        self._current = self._solve()

    def _solve(self) -> DeferSchedule:
        load = self._ema if self._ema is not None else 0.0
        solved = solve_defer_schedule(
            self._plan, self._vec, self._measured_names,
            compute_s=self._base + self._per_update * load,
            k_min=self._k_min, k_max=self._k_max,
            overlap=self._overlap, **self._solve_kwargs)
        # Collapse to one uniform K (the solved full-commit period): the
        # partitioned store commits all-or-nothing.
        uniform = DeferSchedule(
            level_names=solved.level_names,
            intervals=(solved.period,) * len(solved.level_names),
            predicted=solved.predicted, overlap=self._overlap)
        self._n_resolves += 1
        return uniform

    def observe(self, n_updates: int) -> None:
        """Feed one tick's real (non-padding) update count into the EMA."""
        n = float(n_updates)
        self._ema = n if self._ema is None else (
            self._alpha * n + (1.0 - self._alpha) * self._ema)

    def due_count(self, step: int) -> int:
        """Advance one tick; all levels are due at the cycle boundary,
        none otherwise. Re-solves K from the current EMA at each boundary
        (the passed absolute ``step`` is ignored — the phase is internal,
        so a K change realigns cleanly)."""
        self._phase += 1
        if self._phase >= self._current.period:
            self._phase = 0
            due = len(self._current.level_names)
            self._current = self._solve()
            return due
        return 0

    def reset(self) -> None:
        """Forget phase and load history (after an out-of-band flush)."""
        self._phase = 0
        self._ema = None
        self._current = self._solve()

    @property
    def level_names(self) -> tuple:
        return self._current.level_names

    @property
    def intervals(self) -> tuple:
        return self._current.intervals

    @property
    def period(self) -> int:
        """The CURRENT cycle length; changes as the EMA moves."""
        return self._current.period

    @property
    def max_period(self) -> int:
        """K never exceeds the solver's ``k_max`` — size ring capacity
        against this, not the drifting ``period``."""
        return self._k_max

    @property
    def k_min(self) -> int:
        return self._k_min

    @property
    def k_max(self) -> int:
        return self._k_max

    @property
    def overlap(self) -> bool:
        return self._overlap

    @property
    def predicted(self) -> Optional[dict]:
        return self._current.predicted

    def as_dict(self) -> dict:
        out = self._current.as_dict()
        out["adaptive"] = {
            "ema_updates_per_tick": self._ema,
            "ema_alpha": self._alpha,
            "base_compute_s": self._base,
            "per_update_s": self._per_update,
            "k_min": self._k_min, "k_max": self._k_max,
            "n_resolves": self._n_resolves,
        }
        return out

    def describe(self) -> str:
        load = "unobserved" if self._ema is None else f"{self._ema:.1f}"
        return (self._current.describe()
                + f"; adaptive (ema {load} updates/tick, "
                  f"K in [{self._k_min}, {self._k_max}])")


def _resolve_bandwidths(n: int, names: Sequence[str],
                        bandwidths: Optional[Sequence[float]],
                        fabric) -> list[float]:
    """One rate (bytes/s) per measured level: ``bandwidths`` as given, or
    each level's ``link_bw`` in ``fabric.levels`` (by name, else by
    position). There is no default: rates are measured on the card."""
    if bandwidths is not None:
        if len(bandwidths) != n:
            raise ValueError(f"{n} levels but {len(bandwidths)} bandwidths")
        return [float(b) for b in bandwidths]
    if fabric is not None:
        by_name = {lv.name: float(lv.link_bw) for lv in fabric.levels}
        out = []
        for i, name in enumerate(names):
            if name in by_name:
                out.append(by_name[name])
            elif i < len(fabric.levels):
                out.append(float(fabric.levels[i].link_bw))
            else:
                raise ValueError(
                    f"fabric has no level named {name!r} and no level at "
                    f"index {i}")
        return out
    raise ValueError(
        "solve_defer_schedule needs a rate for every level: pass "
        "bandwidths= (bytes/s, one per level) measured on the card — "
        "repro_torch.launch.kv_serve.measure_schedule_inputs times each "
        "level's merge — or a fabric= with per-level link_bw")


def solve_defer_schedule(plan, wire_bytes_by_level: Sequence[float],
                         level_names: Optional[Sequence[str]] = None, *,
                         bandwidths: Optional[Sequence[float]] = None,
                         fabric=None,
                         compute_s: float = 0.0, memory_s: float = 0.0,
                         target_fraction: float = 0.5,
                         k_min: int = 1, k_max: int = 64,
                         overlap: bool = False,
                         merge_fn=None) -> DeferSchedule:
    """Solve per-level commit intervals for ``plan``'s deferred levels.

    ``wire_bytes_by_level`` is the per-level wire vector of the plan's
    EAGER twin (every level exchanged each step) — per-device or
    machine-wide, as long as the ``bandwidths``/``fabric`` rates use the
    same basis. ``compute_s``/``memory_s`` are the other two roofline terms
    of one step. A deferred level's K is the smallest interval at which its
    amortized wire time stays under ``target_fraction`` of the per-step
    bound; intervals are then rounded up to nest.

    With ``overlap``, the TOP deferred level's commit is launch/landed
    (``ccache.launch_inflight`` / ``settle_inflight``): its exchange runs
    beside the next step's work, so up to ``max(compute_s, memory_s)`` of
    its time hides. Only the *exposed* remainder needs amortizing, so
    overlap usually moves the optimal K *down*.

    With ``merge_fn``, the merge's algebra traits gate the schedule before
    any K is solved: non-deferrable merges (saturating/dropping adds) raise
    outright, and ``overlap=True`` additionally requires a stale-tolerant
    merge (scalable or idempotent) so the one-step-late landing is sound.
    """
    if merge_fn is not None:
        if overlap:
            merge_fn.check_overlap("solve_defer_schedule(overlap=True)")
        else:
            merge_fn.check_deferrable("solve_defer_schedule")
    if k_min < 1:
        raise ValueError(f"k_min must be >= 1, got {k_min}")
    if k_max < k_min:
        raise ValueError(f"k_max={k_max} < k_min={k_min}: the interval "
                         f"window is empty — no commit schedule exists")
    exec_levels = [lv for lv in plan.levels if lv.size > 1]
    names = (tuple(level_names) if level_names is not None
             else tuple(lv.name for lv in exec_levels))
    vec = [float(b) for b in wire_bytes_by_level]
    if len(vec) != len(names):
        raise ValueError(f"wire vector has {len(vec)} levels but names are "
                         f"{names}")
    deferred = [lv for lv in exec_levels if lv.defer]
    if not deferred:
        raise ValueError("plan has no deferred levels to schedule "
                         "(no :defer flags, or they all have size 1)")
    idx = {}
    for lv in exec_levels:
        if lv.name not in names:
            raise ValueError(f"plan level {lv.name!r} missing from the "
                             f"measured level names {names}")
        idx[lv.name] = names.index(lv.name)
    bws = _resolve_bandwidths(len(names), names, bandwidths, fabric)

    deferred_ix = {idx[lv.name] for lv in deferred}
    eager_wire_s = sum(b / bw for i, (b, bw) in enumerate(zip(vec, bws))
                       if i not in deferred_ix)
    step_bound_s = max(compute_s, memory_s, eager_wire_s)

    hide_budget_s = max(compute_s, memory_s) if overlap else 0.0
    intervals: list[int] = []
    per_level = []
    prev_k = 1
    for li, lv in enumerate(deferred):
        b = vec[idx[lv.name]]
        t = b / bws[idx[lv.name]]
        # Only the top deferred level's exchange is launch/landed; inner
        # deferred commits still run inline at their due steps.
        hidden = (min(t, hide_budget_s) if li == len(deferred) - 1 else 0.0)
        exposed = t - hidden
        if exposed <= 0.0:
            k = 1  # fully hidden (or no traffic): committing is free
        elif step_bound_s <= 0.0:
            # Nothing to hide the commit behind: defer as far as allowed.
            k = k_max
        else:
            k = math.ceil(exposed / (target_fraction * step_bound_s))
        k = max(k, k_min, prev_k)
        k = ((k + prev_k - 1) // prev_k) * prev_k   # nest on the level below
        if k > k_max:
            # Clamp to the largest multiple of the inner interval that
            # still fits; when k_max < prev_k no nested interval exists at
            # all, so raise instead of silently exceeding k_max.
            k = (k_max // prev_k) * prev_k
            if k < prev_k:
                raise ValueError(
                    f"level {lv.name!r}: no nested commit interval fits — "
                    f"the level below commits every {prev_k} steps but "
                    f"k_max={k_max} < {prev_k}; raise k_max or loosen the "
                    f"inner levels' intervals")
        intervals.append(k)
        entry = {"name": lv.name, "interval": k,
                 "bytes_per_step": b,
                 "amortized_bytes_per_step": b / k,
                 "time_s": t, "amortized_s": (t - hidden) / k}
        if overlap and li == len(deferred) - 1:
            entry["hidden_s"] = hidden
            entry["exposed_s"] = exposed
        per_level.append(entry)
        prev_k = k

    eager_total = sum(vec)
    amortized_total = (sum(b for i, b in enumerate(vec)
                           if i not in deferred_ix)
                       + sum(p["amortized_bytes_per_step"]
                             for p in per_level))
    predicted = {
        "target_fraction": target_fraction,
        "compute_s": compute_s, "memory_s": memory_s,
        "eager_wire_s": eager_wire_s, "step_bound_s": step_bound_s,
        "per_level": per_level,
        "wire_bytes_per_step_eager": eager_total,
        "wire_bytes_per_step_deferred": amortized_total,
        "top_amortization_x": intervals[-1],
    }
    if overlap:
        predicted["overlap"] = True
        predicted["hide_budget_s"] = hide_budget_s
    return DeferSchedule(level_names=tuple(lv.name for lv in deferred),
                         intervals=tuple(intervals), predicted=predicted,
                         overlap=overlap)
