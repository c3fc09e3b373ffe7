"""Schedule-aware deferred commits: per-level commit intervals.

A :class:`DeferSchedule` says how often each deferred level of a
:class:`~repro_torch.core.merge_plan.MergePlan` commits. Intervals are
*nested* (each outer deferred level's K is a multiple of the level below),
so the levels due at any step are always a prefix of the deferred suffix —
which is what lets ``ccache.defer_cascade`` settle a pending upward through
the hierarchy without ever double-counting a contribution.

The JAX package also solves K from a per-level wire vector measured on
compiled HLO (``solve_defer_schedule``) and re-solves it online
(``AdaptiveDeferSchedule``); neither is ported yet.
"""

from __future__ import annotations

import dataclasses
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
