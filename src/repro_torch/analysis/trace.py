"""Privatization lint of programs run on stacked example tensors.

The port's twin of the JAX package's ``repro/analysis/jaxpr.py``. There the
per-shard update bodies are traced to jaxprs with the merge axis bound and
abstract-interpreted; the port has no jaxpr, so each check runs the
stacked program (``core/stacked.py``) on example tensors and watches what
it does:

* :class:`CollectiveRecorder` / :func:`check_noncommit_region` — every
  ``StackedAxis.ppermute/psum/pmax/pmin`` call, with its kind, group,
  permutation and bytes a rank, heard as ``"collective"`` events
  (``repro_torch/hooks.py``); any call
  inside a non-commit region is CC010 (the recorded walk of
  ``analysis/placement.py`` is built from the same calls);
* :func:`out_deps` / :func:`check_kv_tick_taint` — input -> output
  dependency sets, tracked by a ``TorchDispatchMode`` over storages through
  every aten op, in-place ones included (the counterpart of the
  reference's ``_out_deps``). Hand-written kernels are launched through
  ``ctypes`` past the dispatcher, so their wrappers emit what they read
  and write (a ``"kernel"`` event) and the tracker folds that in: on the
  card the check follows the real hot path. On a due=0 tick the settled
  output may depend only on the settled input (CC012 otherwise) and no
  pending output may depend on the settled input (CC011);
* :func:`audit_plan` / :func:`audit_stages` — the plan/trait audit
  (CC013/CC014) over the port's ``validate_plan_merge``.

A dependency that leaves the tensors through a Python number (``.item()``,
a ring cursor kept as an int) is not followed; a tick has none on its
settled or pending path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hooks
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.merge_functions import MergeFn
from repro_torch.core.merge_plan import MergePlan, validate_plan_merge

PyTree = Any


def clone_tree(tree: PyTree) -> PyTree:
    """A copy of every tensor leaf (a program may update its donated
    arguments in place)."""
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


# -- collectives ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One ``StackedAxis`` collective: each leaf of its payload is one
    collective op of the reference (a ``ppermute`` leaf is one
    collective-permute, a ``psum/pmax/pmin`` leaf one all-reduce)."""

    kind: str                       # "ppermute" | "psum" | "pmax" | "pmin"
    size: int                       # the axis's rank count
    group: Optional[int]            # reduction group (None for ppermute)
    perm: Optional[tuple]           # (src, dst) pairs (ppermute only)
    rank_bytes: tuple               # each leaf's bytes on one rank


class CollectiveRecorder:
    """Records every collective made through any ``StackedAxis`` while
    :meth:`on` listens (:func:`record`)."""

    def __init__(self):
        self.calls: list[CollectiveCall] = []

    def on(self, event: str, *args) -> None:
        if event != "collective":
            return
        axis, kind, x, group, perm = args
        leaves = [t for t in pytree.tree_leaves(x)
                  if isinstance(t, torch.Tensor)]
        self.calls.append(CollectiveCall(
            kind=kind, size=axis.size, group=group,
            perm=None if perm is None else tuple(map(tuple, perm)),
            rank_bytes=tuple(t.numel() // axis.size * t.element_size()
                             for t in leaves)))


def record(fn: Callable, *args) -> tuple[Any, list[CollectiveCall]]:
    """``fn(*args)`` and the collectives it made."""
    rec = CollectiveRecorder()
    with hooks.listening(rec.on):
        out = fn(*args)
    return out, rec.calls


def check_noncommit_region(fn: Callable, args: Sequence,
                           site: str) -> list[Diagnostic]:
    """CC010: a non-commit region must make zero collective calls (run on
    a copy of ``args``)."""
    _, calls = record(fn, *clone_tree(tuple(args)))
    if calls:
        kinds = sorted({c.kind for c in calls})
        return [Diagnostic(
            code="CC010", site=site,
            message=f"non-commit region makes {len(calls)} collective "
                    f"call(s) {kinds}; the privatized window must have "
                    f"zero coherence traffic")]
    return []


# -- taint: which inputs does each output depend on? ------------------------


# ops whose tensor arguments give only a shape, dtype and device: their
# outputs depend on nothing (a jaxpr's zeros_like has no input either)
_SHAPE_ONLY = frozenset({
    "empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
    "randn_like", "randint_like", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full"})


class _Taint(TorchDispatchMode):
    """Dependency sets of storages: each storage maps to the input labels
    its contents derive from. A functional op's fresh output takes the
    union of its tensor inputs' sets; an op that writes an argument in
    place (the schema's mutable arguments, a kernel's reported writes)
    adds that union to the written storage's set; views share their
    base's storage and so its set."""

    def __init__(self):
        super().__init__()
        self.deps: dict[int, frozenset] = {}
        # every storage seen stays alive, so no address is reused
        self._held: dict[int, Any] = {}

    def key(self, t: torch.Tensor) -> Optional[int]:
        st = t.untyped_storage()
        if st.nbytes() == 0:
            return None
        k = st.data_ptr()
        self._held.setdefault(k, st)
        return k

    def of(self, t: torch.Tensor) -> frozenset:
        k = self.key(t)
        return self.deps.get(k, frozenset()) if k is not None else frozenset()

    def label(self, t: torch.Tensor, i: int) -> None:
        k = self.key(t)
        if k is not None:
            self.deps[k] = self.deps.get(k, frozenset()) | {i}

    def flow(self, reads, writes, fresh=()) -> None:
        src = frozenset().union(*(self.of(t) for t in reads))
        read_keys = {self.key(t) for t in reads}
        for t in writes:
            k = self.key(t)
            if k is not None:
                self.deps[k] = self.deps.get(k, frozenset()) | src
        for t in fresh:
            k = self.key(t)
            if k is not None and k not in read_keys:
                self.deps[k] = src

    def on(self, event: str, *args) -> None:
        if event == "kernel":
            _, reads, writes = args
            self.flow(reads, writes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tensors = lambda x: [t for t in pytree.tree_leaves(x)
                             if isinstance(t, torch.Tensor)]
        written = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(a.name)
                written += tensors(value)
        ins = ([] if func.overloadpacket.__name__ in _SHAPE_ONLY
               else tensors((args, kwargs)))
        self.flow(ins, written, () if written else tensors(out))
        return out


def out_deps(fn: Callable, args: Sequence) -> list[frozenset]:
    """For each tensor leaf of ``fn(*args)`` (run on a copy of ``args``),
    the flat indices of the argument leaves its contents depend on."""
    args = clone_tree(tuple(args))
    taint = _Taint()
    with hooks.listening(taint.on), taint:
        for i, leaf in enumerate(pytree.tree_leaves(args)):
            if isinstance(leaf, torch.Tensor):
                taint.label(leaf, i)
        out = fn(*args)
        return [taint.of(t) for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]


def check_kv_tick_taint(tick_fn: Callable, settled: torch.Tensor,
                        pendings: Sequence[torch.Tensor], keys: torch.Tensor,
                        vals: torch.Tensor, site: str) -> list[Diagnostic]:
    """Taint lint of a due=0 KV tick ``(settled, pendings, keys, vals) ->
    (settled', pendings')`` on stacked example tensors.

    Flat input/output index 0 is the settled table; 1..n_pending the
    cascade. CC011: a pending output tainted by the settled input (the
    update path read shared state). CC012: the settled output tainted by
    pendings/keys/vals (pending mass reached shared state without a
    commit).
    """
    deps = out_deps(tick_fn, (settled, tuple(pendings), keys, vals))
    n_pend = len(pendings)
    diags: list[Diagnostic] = []
    if len(deps) != 1 + n_pend:
        return [Diagnostic(
            code="CC012", site=site,
            message=f"due=0 tick returns {len(deps)} tensors, expected "
                    f"settled + {n_pend} pendings; cannot prove the "
                    f"settled table stayed untouched")]
    settled_deps, pending_deps = deps[0], deps[1:]
    if settled_deps - {0}:
        diags.append(Diagnostic(
            code="CC012", site=site,
            message=f"settled output depends on non-settled inputs "
                    f"{sorted(settled_deps - {0})} (0=settled, "
                    f"1..{n_pend}=pendings, {n_pend + 1}=keys, "
                    f"{n_pend + 2}=vals) on a due=0 tick; pending mass "
                    f"escaped the cascade"))
    tainted = [i for i, d in enumerate(pending_deps) if 0 in d]
    if tainted:
        diags.append(Diagnostic(
            code="CC011", site=site,
            message=f"pending output(s) {tainted} depend on the settled "
                    f"table inside a non-commit tick; the privatized "
                    f"update path read shared state"))
    return diags


# -- plan/trait audits -------------------------------------------------------


def audit_plan(plan: MergePlan, axis_size: int,
               merge_fn: Optional[MergeFn] = None,
               site: Optional[str] = None) -> list[Diagnostic]:
    """Non-raising twin of ``compile_plan``'s validity gate (CC013/CC014)."""
    site = site or f"plan:{','.join(plan.level_names())}"
    diags = []
    for kind, level, msg in validate_plan_merge(plan, axis_size, merge_fn):
        diags.append(Diagnostic(
            code="CC013" if kind == "defer-trait" else "CC014",
            site=site, level=level, message=msg))
    return diags


def audit_stages(stages, merge_fn: MergeFn,
                 site: str) -> list[Diagnostic]:
    """CC013 for compiled stage lists that bypassed ``compile_plan``: a
    ``:defer`` stage reached by a merge whose apply is not a homomorphism
    (or draws a key per apply) was never validated."""
    diags = []
    for st in stages:
        if st.defer and st.fanout > 1 and (not merge_fn.deferrable
                                           or merge_fn.needs_key):
            why = ("draws a PRNG key per apply" if merge_fn.needs_key
                   else "apply is not a homomorphism over combine")
            diags.append(Diagnostic(
                code="CC013", site=site, level=st.name,
                message=f"deferred stage {st.name!r} is reached by merge "
                        f"{merge_fn.name!r}, which {why}; this stage list "
                        f"bypassed compile_plan's trait gate"))
    return diags
