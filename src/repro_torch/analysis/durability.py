"""CC040: volatile defer state must be covered by the checkpoint tree.

The port's twin of the JAX package's ``repro/analysis/durability.py``. A
deferred-commit step carries gradient mass OUTSIDE params/opt — the
pending cascade, the step-phase counter, an overlapped in-flight launch.
A checkpoint that saves only ``{"params", "opt"}`` for such a run is a
silent-mass-loss bug: restore looks healthy, but up to ``period - 1``
steps of gradient (plus a whole launched cycle) evaporated. This check is
the static half of the durability contract: given what a step declares
volatile (``volatile_spec``, meta tensors: ``launch/steps.py``'s
``DeferredTrainStep`` or ``runtime/chaos.py``'s ``ToyDeferredStep``) and
what a driver's checkpoint actually saves (its state-tree template), every
volatile leaf key must appear in the saved key space with the same shape.
The dynamic half — chaos injection proving the restored bits are *right* —
lives in ``repro_torch.runtime.chaos``.

Key spaces compare via the checkpoint's own flattening
(``checkpoint.tree_keys``: the ``"/"`` paths the npz is keyed by), so this
check certifies exactly what restore will be able to fetch.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.checkpoint.checkpoint import _flatten_with_paths

PyTree = Any


def _shapes(tree: PyTree) -> dict:
    return {k: tuple(getattr(leaf, "shape", ()) or ())
            for k, leaf in _flatten_with_paths(tree)}


def check_checkpoint_coverage(site: str, volatile_spec: PyTree,
                              checkpoint_tree: PyTree,
                              prefix: str = "defer") -> list[Diagnostic]:
    """Every leaf of ``volatile_spec`` must appear under ``prefix/`` in
    ``checkpoint_tree``'s key space with a matching shape.

    ``volatile_spec`` is the step's declared volatile tree;
    ``checkpoint_tree`` is the state template the driver passes to
    ``checkpoint.save`` (leaves may be tensors, meta tensors or arrays).
    Returns CC040 diagnostics for every missing or mis-shaped leaf — an
    empty list is the certificate that a restore can reconstruct all
    outstanding mass."""
    need = _shapes(volatile_spec)
    have = _shapes(checkpoint_tree)
    out = []
    for key, shape in sorted(need.items()):
        full = f"{prefix}/{key}" if prefix else key
        if full not in have:
            out.append(Diagnostic(
                code="CC040", site=site,
                message=f"volatile leaf '{full}' {shape} is not in the "
                        f"checkpoint tree — its pending mass is dropped "
                        f"on restore"))
        elif have[full] != shape:
            out.append(Diagnostic(
                code="CC040", site=site,
                message=f"volatile leaf '{full}' has shape {shape} but the "
                        f"checkpoint tree saves {have[full]} — restore "
                        f"would misinterpret the pending geometry"))
    return out


def check_step_durability(site: str, defer_step, params_like: PyTree,
                          checkpoint_tree: Optional[PyTree] = None
                          ) -> list[Diagnostic]:
    """CC040 for a deferred train step: its ``volatile_spec(params)`` must
    be covered by ``checkpoint_tree`` (defaults to the canonical driver
    state ``{"params", "opt", "defer": init_defer_state(params)}`` — i.e.
    a self-check that the spec and the real state agree)."""
    spec = defer_step.volatile_spec(params_like)
    if checkpoint_tree is None:
        checkpoint_tree = {"params": params_like, "opt": {},
                           "defer": defer_step.init_defer_state(params_like)}
    return check_checkpoint_coverage(site, spec, checkpoint_tree)
