"""MergePlan IR: an explicit N-level description of a hierarchical merge.

The paper's CCache merges privatized copies up a *physical hierarchy*
(private cache -> shared cache -> memory), deferring expensive upper-level
merges with a "mergeable" bit. The IR describes a hierarchy of any
depth: a topology is a list of ``MergeLevel``
entries, innermost (cheapest links) first, compiled into a sequence of
level-local stages executed by ``repro_torch.core.ccache``:

    MergePlan.parse("chip:4,host:16,pod:2:defer")

describes a 128-rank axis where blocks of 4 ranks share chip-local links,
16 chips share a host fabric, and the 2 pods meet over the DCI — with the
pod level *deferred*: its traffic is accumulated into ``soft_merge``'s
``PendingUpdate`` and committed once every K steps (merge-on-evict at pod
scope; the paper's mergeable bit, level 2).

Each level carries its own policy:

* ``combine_mode`` — "xla" rides the fused grouped reduction when the merge
  has a fixed reduce op (innermost level only; COUP's in-protocol ops; the
  name is kept from the JAX reference, where XLA fuses it), "software"
  forces the ppermute exchange, "auto" picks.
* ``compress``     — apply the merge's encode/decode wire format on this
  level's rounds only (compress where bytes are scarce).
* ``defer``        — exclude the level from the eager merge; deferred levels
  must form a suffix of the plan (you can only defer *upward*).

``lane_parallel`` selects the execution strategy for upper levels: the
representative role is sharded over a unit's lanes (each lane carries a
1/stride chunk of the payload through the cross-unit butterfly, then the
unit all-gathers the combined chunks), so the upper-level exchange
bandwidth-parallelizes instead of serializing on lane 0. Total wire bytes
match the representative-only exchange; per-link bytes drop by the unit
size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

AxisName = Union[str, tuple]

_TRANSPORTS = ("auto", "ici", "dci")
_COMBINE_MODES = ("auto", "xla", "software")


@dataclasses.dataclass(frozen=True)
class MergeLevel:
    """One level of the merge hierarchy (innermost levels list first)."""

    name: str
    size: int                     # fanout: units merged at this level
    transport: str = "auto"       # informational: link class for cost models
    combine_mode: str = "auto"    # "auto" | "xla" | "software"
    compress: bool = False        # encode/decode wire format on this level
    defer: bool = False           # merge-on-evict: commit via PendingUpdate

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"level {self.name!r}: size must be >= 1, "
                             f"got {self.size}")
        if self.transport not in _TRANSPORTS:
            raise ValueError(f"level {self.name!r}: transport must be one of "
                             f"{_TRANSPORTS}, got {self.transport!r}")
        if self.combine_mode not in _COMBINE_MODES:
            raise ValueError(f"level {self.name!r}: combine_mode must be one "
                             f"of {_COMBINE_MODES}, got {self.combine_mode!r}")


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """An N-level merge topology over one named device axis.

    ``levels`` are innermost-first; the product of their sizes must equal
    the merge axis size (validated at trace time — a mismatch raises instead
    of silently producing wrong groups). ``axis_name`` optionally pins the
    plan to a named axis (a string, or a tuple of mesh axes that the engine
    treats as one flattened axis). ``lane_parallel`` turns on the chunked
    upper-level exchange.
    """

    levels: tuple[MergeLevel, ...]
    axis_name: Optional[AxisName] = None
    lane_parallel: bool = False

    def __post_init__(self):
        if not self.levels:
            raise ValueError("MergePlan needs at least one level")
        object.__setattr__(self, "levels", tuple(self.levels))
        seen = set()
        for lv in self.levels:
            if lv.name in seen:
                raise ValueError(f"duplicate level name {lv.name!r}")
            seen.add(lv.name)
        # defer must be a suffix: once a level defers, everything above does.
        deferring = False
        for lv in self.levels:
            if deferring and not lv.defer:
                raise ValueError(
                    "deferred levels must form a suffix of the plan "
                    f"(level {lv.name!r} is eager but a lower level defers); "
                    "you can only defer upward")
            deferring = deferring or lv.defer

    # -- geometry ----------------------------------------------------------

    @property
    def num_ranks(self) -> int:
        n = 1
        for lv in self.levels:
            n *= lv.size
        return n

    def strides(self) -> list[int]:
        """``strides()[i]`` = ranks per unit entering level i (prefix
        product of lower-level sizes; ``strides()[0] == 1``)."""
        out, acc = [], 1
        for lv in self.levels:
            out.append(acc)
            acc *= lv.size
        return out

    def level_sizes(self) -> tuple[int, ...]:
        return tuple(lv.size for lv in self.levels)

    def level_names(self) -> tuple[str, ...]:
        return tuple(lv.name for lv in self.levels)

    @property
    def num_deferred(self) -> int:
        return sum(1 for lv in self.levels if lv.defer)

    @property
    def has_deferred(self) -> bool:
        return self.num_deferred > 0

    def resolve_axis(self, axis_name: Optional[AxisName]) -> AxisName:
        return self.axis_name if self.axis_name is not None else axis_name

    def validate(self, axis_size: int) -> None:
        if self.num_ranks != axis_size:
            detail = " x ".join(f"{lv.name}:{lv.size}" for lv in self.levels)
            raise ValueError(
                f"merge axis has {axis_size} ranks but the plan covers "
                f"{self.num_ranks} ({detail}); the product of level sizes "
                f"must equal the axis size")

    # -- construction ------------------------------------------------------

    @staticmethod
    def parse(spec: str, axis_name: Optional[AxisName] = None,
              lane_parallel: bool = False) -> "MergePlan":
        """Parse the CLI syntax ``name:size[:flag...],...`` innermost first.

        Flags per level: ``defer`` (merge-on-evict via PendingUpdate),
        ``compress`` (encode/decode wire format), ``software`` / ``xla``
        (combine mode), ``ici`` / ``dci`` (transport hint). Example:

            chip:4,host:16,pod:2:defer:compress
        """
        levels = []
        for part in spec.split(","):
            fields = [f.strip() for f in part.strip().split(":") if f.strip()]
            if len(fields) < 2:
                raise ValueError(
                    f"bad level spec {part!r}: expected name:size[:flag...]")
            name = fields[0]
            try:
                size = int(fields[1])
            except ValueError:
                raise ValueError(f"bad level size in {part!r}: {fields[1]!r}")
            kw: dict = {}
            for flag in fields[2:]:
                if flag == "defer":
                    kw["defer"] = True
                elif flag == "compress":
                    kw["compress"] = True
                elif flag in ("xla", "software"):
                    kw["combine_mode"] = flag
                elif flag in ("ici", "dci"):
                    kw["transport"] = flag
                else:
                    raise ValueError(f"unknown level flag {flag!r} in "
                                     f"{part!r} (defer/compress/xla/"
                                     f"software/ici/dci)")
            levels.append(MergeLevel(name=name, size=size, **kw))
        return MergePlan(levels=tuple(levels), axis_name=axis_name,
                         lane_parallel=lane_parallel)

    @staticmethod
    def two_level(group_size: int, axis_size: int,
                  axis_name: Optional[AxisName] = None,
                  use_xla_intra: bool = True,
                  compress_inter: bool = False,
                  lane_parallel: bool = False) -> "MergePlan":
        """The two-level shape: intra groups of ``group_size``
        on cheap links, one inter level across groups."""
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1: {group_size}")
        if axis_size % group_size != 0:
            raise ValueError(f"axis size {axis_size} not divisible by "
                             f"group_size {group_size}")
        intra_mode = "auto" if use_xla_intra else "software"
        return MergePlan(
            levels=(MergeLevel("intra", group_size, transport="ici",
                               combine_mode=intra_mode),
                    MergeLevel("inter", axis_size // group_size,
                               transport="dci", compress=compress_inter)),
            axis_name=axis_name, lane_parallel=lane_parallel)


# ---------------------------------------------------------------------------
# Compilation: plan -> executable level stages.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelStage:
    """One compiled stage: merge ``fanout`` sibling units of ``stride``
    ranks inside each aligned ``block = stride * fanout``. On entry every
    rank holds its unit's combination (replicated within the unit); on exit
    every rank holds its block's combination."""

    index: int
    name: str
    stride: int
    fanout: int
    block: int
    combine_mode: str         # resolved: "xla" | "software"
    compress: bool
    defer: bool
    lane_parallel: bool
    transport: str


def validate_plan_merge(plan: MergePlan, axis_size: int,
                        merge_fn=None) -> list[tuple]:
    """Collect ``compile_plan``'s validity problems without raising.

    Returns ``(kind, level_name, message)`` tuples, ``kind`` one of
    ``"geometry"`` (plan does not cover the axis), ``"codec"`` (a compress
    level with no wire codec), or ``"defer-trait"`` (a ``:defer`` level
    reached by a non-deferrable merge). ``compile_plan`` raises on the
    first problem; a linter can report all of them.
    """
    problems: list[tuple] = []
    try:
        plan.validate(axis_size)
    except ValueError as e:
        problems.append(("geometry", None, str(e)))
    if merge_fn is not None and (merge_fn.encode is None
                                 or merge_fn.decode is None):
        bad = [lv.name for lv in plan.levels if lv.compress and lv.size > 1]
        if bad:
            problems.append((
                "codec", bad[0],
                f"levels {bad} set compress but merge {merge_fn.name!r} "
                f"defines no encode/decode wire format — the exchange would "
                f"silently stay uncompressed; use a codec merge (e.g. "
                f"int8_compressed_add) or drop the compress flags"))
    if merge_fn is not None:
        deferred = [lv.name for lv in plan.levels if lv.defer and lv.size > 1]
        if deferred:
            try:
                merge_fn.check_deferrable(
                    f"compile_plan: levels {deferred} set :defer")
            except ValueError as e:
                problems.append(("defer-trait", deferred[0], str(e)))
    return problems


def compile_plan(plan: MergePlan, axis_size: int,
                 merge_fn=None) -> list[LevelStage]:
    """Validate ``plan`` against the axis and emit its stage sequence.

    Size-1 levels are no-ops and are dropped. The innermost *emitted* stage
    has ``stride == 1`` (all ranks participate directly); ``combine_mode``
    "auto" resolves to "xla" there and "software" above (the fused
    reduction only exists for whole aligned rank groups — upper levels are
    representative- or lane-sharded exchanges by construction).

    With ``merge_fn``, per-level ``compress`` flags are checked against the
    merge's wire codec: a level asking for compression from a merge with no
    ``encode``/``decode`` raises instead of silently exchanging full-width
    bytes the caller believes are compressed. ``:defer`` levels are likewise
    checked against the merge's algebra traits: a non-deferrable merge
    (apply observes memory or randomizes per commit — saturating/dropping
    adds) raises here, at plan-compile time, instead of silently committing
    K coalesced steps with different semantics. The same checks are
    available non-raising as :func:`validate_plan_merge`.
    """
    problems = validate_plan_merge(plan, axis_size, merge_fn)
    if problems:
        raise ValueError(problems[0][2])
    stages: list[LevelStage] = []
    strides = plan.strides()
    for i, lv in enumerate(plan.levels):
        if lv.size == 1:
            continue
        stride = strides[i]
        mode = lv.combine_mode
        if mode == "auto":
            mode = "xla" if stride == 1 else "software"
        if mode == "xla" and stride > 1:
            # The fused collective reduces whole rank groups; a stride>1
            # exchange is representative-/lane-sharded by construction.
            mode = "software"
        stages.append(LevelStage(
            index=i, name=lv.name, stride=stride, fanout=lv.size,
            block=stride * lv.size, combine_mode=mode,
            compress=lv.compress, defer=lv.defer,
            lane_parallel=plan.lane_parallel and stride > 1,
            transport=lv.transport))
    return stages


def split_eager_deferred(
        stages: Sequence[LevelStage]
) -> tuple[list[LevelStage], list[LevelStage]]:
    eager = [s for s in stages if not s.defer]
    deferred = [s for s in stages if s.defer]
    return eager, deferred
