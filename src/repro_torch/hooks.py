"""Events the port tells its listeners, for the verifier
(``repro_torch.analysis``).

Two kinds are emitted, each before or where the work happens:

* ``emit("collective", axis, kind, x, group, perm)`` — every
  ``StackedAxis.ppermute/psum/pmax/pmin`` call (``core/stacked.py``),
  which ``analysis.trace.CollectiveRecorder`` records;
* ``emit("kernel", name, reads, writes)`` — every launch of a hand-written
  kernel. A kernel launched through ``ctypes`` (``kernels/_build.py``) is
  invisible to PyTorch's dispatcher, so its wrapper tells the tensors it
  reads and those it writes in place, and the taint tracker
  (``analysis.trace.out_deps``) follows the data through it.

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
