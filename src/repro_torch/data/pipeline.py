"""Deterministic synthetic data pipeline with host prefetch.

The JAX package's ``repro/data/pipeline.py``, kept as the port's own copy
(numpy only, so the port imports nothing of that package): the same Philox
key and counter and the same Zipf draw, so both packages yield the same
batches bit for bit. The stream is a pure function of (seed, step): any
host can recompute any batch, which is what makes straggler reassignment
and restarts lossless; the whole pipeline state is one integer. Batches are
Zipf-distributed token ids (heavy-tailed like natural text, so the
embedding-gradient scatter sees realistic row reuse: the access pattern of
the paper's KV store). Batches are numpy; the train step moves them to the
device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    # multi-host slice: this process produces rows [host_id::num_hosts]
    host_id: int = 0
    num_hosts: int = 1
    with_frames: bool = False     # enc-dec: also emit frame embeddings
    frame_len: int = 0
    d_model: int = 0
    with_embeds: bool = False     # vlm: emit precomputed patch/text embeds


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # Philox keyed by (seed, step, host): order-independent reconstruction.
    return np.random.Generator(
        np.random.Philox(key=cfg.seed, counter=[step, cfg.host_id, 0, 0]))


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The batch for ``step`` (this host's rows). Pure and stateless."""
    rng = _rng_for(cfg, step)
    rows = cfg.global_batch // cfg.num_hosts
    # Zipf with rejection to vocab range (heavy-tailed token ids).
    tokens = rng.zipf(cfg.zipf_a, size=(rows, cfg.seq_len + 1))
    tokens = (tokens - 1) % cfg.vocab
    tokens = tokens.astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.with_frames:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.frame_len, cfg.d_model)).astype(np.float32)
    if cfg.with_embeds:
        batch["embeds"] = rng.standard_normal(
            (rows, cfg.seq_len, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    return batch


class Prefetcher:
    """Background-thread prefetch of ``batch_at`` (bounded queue).

    ``state()``/``restore()`` expose the single-integer pipeline state.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._next = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        self._next = step + 1
        return step, batch

    def state(self) -> int:
        return self._next

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    """Simple synchronous iterator (no thread) — used by tests."""
    step = start_step
    while True:
        yield step, batch_at(cfg, step)
        step += 1


def data_config_for(arch_cfg, shape_cfg, seed: int = 0,
                    num_hosts: int = 1, host_id: int = 0) -> DataConfig:
    """DataConfig matching a model's input_specs for a train shape."""
    with_frames = arch_cfg.family == "encdec"
    frame_len = max(128, shape_cfg.seq_len // 4) if with_frames else 0
    return DataConfig(
        vocab=arch_cfg.vocab, seq_len=shape_cfg.seq_len,
        global_batch=shape_cfg.global_batch, seed=seed,
        host_id=host_id, num_hosts=num_hosts,
        with_frames=with_frames, frame_len=frame_len,
        d_model=arch_cfg.d_model,
        with_embeds=arch_cfg.family == "vlm")
