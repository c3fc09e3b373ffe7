"""Events the port tells its listeners, for the verifier
(``repro_torch.analysis``).

These kinds are emitted, each before or where the work happens:

* ``emit("collective", axis, kind, x, group, perm)`` — every
  ``StackedAxis.ppermute/psum/pmax/pmin`` call (``core/stacked.py``) and
  every ``MeshAxis`` one (``core/mesh_axis.py``), which
  ``analysis.trace.CollectiveRecorder`` records; a ``MeshAxis`` ends each
  with ``emit("collective_end", axis)``, so that the op-level walk counts
  the exchange once and not the ``torch.distributed`` calls that carry it
  (its ``pmean``, ``all_gather`` and ``barrier`` are not the merge's and
  are told to no listener);
* ``emit("kernel_begin", name, args, kwargs)`` and ``emit("kernel_end",
  name, result)`` — around every concrete call of a hand-written kernel's
  wrapper (``kernels/custom_ops.kernel_call``), whichever route runs it:
  the CUDA launch or the plain version. A kernel launched through
  ``ctypes`` (``kernels/_build.py``) is invisible to PyTorch's dispatcher,
  so the taint tracker (``analysis.trace.out_deps``) follows the data from
  the arguments into the result (an in-place kernel returns the table it
  wrote), and the op-level cost walk (``launch/op_cost.py``) counts the
  call once, by the kernel's own formula, and not the plain version's
  operations inside.

A listener is added only for the span of a :func:`listening` block, so none
is left behind on an error; with none, :func:`emit` is an empty loop.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

# each called as fn(event, *args)
LISTENERS: list[Callable] = []


def emit(event: str, *args) -> None:
    for fn in LISTENERS:
        fn(event, *args)


@contextlib.contextmanager
def listening(fn: Callable) -> Iterator[None]:
    """``fn`` hears every event emitted inside the block."""
    LISTENERS.append(fn)
    try:
        yield
    finally:
        LISTENERS.remove(fn)

