"""Write-ahead update journal for the sharded KV serving tier.

The JAX package's ``repro/serve/journal.py``, with the same framing: a
journal written by either package replays through the other.

The store's device state between snapshots is volatile: the settled table,
the pending ring/cache/spill, and an overlapped in-flight launch all die
with the process. The durability contract ``ShardedKV.snapshot()`` /
``recover()`` makes is *zero acknowledged mass lost*: an update batch is
acknowledged when ``tick()`` returns, and ``tick()`` journals the raw
``(keys, vals)`` batch **before** any device work (write-ahead). Recovery
then never needs the dead process's device state at all — it reloads the
last flush-consistent snapshot and replays every journaled tick since.
Commutativity is what makes the replay sound: re-applying the same update
multiset in different tick groupings (or onto a different shard count)
settles to the same table.

Framing: one segment file per snapshot epoch (``segments/seg_<n>.log``),
each record ``b"KVJ1" + uint32(le) payload_len + payload`` where the
payload is an ``.npz`` of the batch. A crash mid-append leaves a torn
trailing record; replay detects it (bad magic / short read) and stops
there — correct, because a torn record was never acknowledged. Appends are
flushed to the OS per record; pass ``sync=True`` to also ``fsync`` (pay
the latency only if the failure model includes whole-machine power loss
rather than process death).
"""

from __future__ import annotations

import io
import os
import re
import struct
from typing import Iterator, Optional

import numpy as np

_MAGIC = b"KVJ1"
_SEG_RE = re.compile(r"^seg_(\d{8})\.log$")


def _seg_dir(root: str) -> str:
    return os.path.join(root, "segments")


def _seg_path(root: str, n: int) -> str:
    return os.path.join(_seg_dir(root), f"seg_{n:08d}.log")


def list_segments(root: str) -> list[int]:
    d = _seg_dir(root)
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        m = _SEG_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


class UpdateJournal:
    """Append-only segmented journal of raw ``(keys, vals)`` tick batches.

    Opening a journal always starts a *new* segment (one past the highest
    on disk): a recovered process must never append into a segment an
    earlier incarnation may have torn. ``rotate()`` closes the current
    segment and starts the next — the snapshot path calls it at the
    flush-consistent point and records the returned index as where replay
    must begin. ``gc(before)`` deletes segments the latest snapshot made
    redundant.
    """

    def __init__(self, root: str, sync: bool = False):
        self.root = root
        self.sync = bool(sync)
        os.makedirs(_seg_dir(root), exist_ok=True)
        existing = list_segments(root)
        self._segment = (existing[-1] + 1) if existing else 0
        self._f = open(_seg_path(root, self._segment), "ab")

    @property
    def segment(self) -> int:
        return self._segment

    def append(self, keys, vals) -> None:
        buf = io.BytesIO()
        np.savez(buf, keys=np.asarray(keys), vals=np.asarray(vals))
        payload = buf.getvalue()
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def rotate(self) -> int:
        """Close the current segment, start the next; returns the NEW
        segment index (the first one a post-snapshot replay must read)."""
        self._f.close()
        self._segment += 1
        self._f = open(_seg_path(self.root, self._segment), "ab")
        return self._segment

    def gc(self, before_segment: int) -> int:
        """Delete segments with index < ``before_segment`` (covered by a
        committed snapshot). Returns how many were removed."""
        n = 0
        for s in list_segments(self.root):
            if s < before_segment and s != self._segment:
                os.remove(_seg_path(self.root, s))
                n += 1
        return n

    def close(self) -> None:
        self._f.close()

    # -- replay ----------------------------------------------------------

    @staticmethod
    def replay(root: str, start_segment: int = 0
               ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield every intact ``(keys, vals)`` record from segments >=
        ``start_segment``, in append order. Stops a segment at the first
        torn record (crash mid-append — never acknowledged, so dropping it
        is the *correct* recovery, not a best-effort one)."""
        for s in list_segments(root):
            if s < start_segment:
                continue
            with open(_seg_path(root, s), "rb") as f:
                while True:
                    head = f.read(len(_MAGIC) + 4)
                    if len(head) < len(_MAGIC) + 4:
                        break  # clean EOF or torn header
                    if head[:len(_MAGIC)] != _MAGIC:
                        break  # corrupt tail; nothing beyond is trustworthy
                    (length,) = struct.unpack("<I", head[len(_MAGIC):])
                    payload = f.read(length)
                    if len(payload) < length:
                        break  # torn payload
                    try:
                        with np.load(io.BytesIO(payload)) as z:
                            yield z["keys"], z["vals"]
                    except Exception:
                        break  # undecodable tail
