"""The port's synthetic data stream against the JAX package's: the same
batches, bit for bit, for several steps, seeds and hosts, through
``batch_at``, ``iterate`` and the ``Prefetcher``, for the dense family and
both families ``data_config_for`` branches on (enc-dec frames, VLM
embeddings)."""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe


def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _configs(seed, num_hosts, host_id, **kw):
    fields = dict(vocab=1000, seq_len=24, global_batch=8, seed=seed,
                  num_hosts=num_hosts, host_id=host_id, **kw)
    return tpipe.DataConfig(**fields), jpipe.DataConfig(**fields)


@pytest.mark.parametrize("seed,num_hosts,host_id",
                         [(0, 1, 0), (7, 2, 1), (123, 4, 3)])
def test_batch_at_is_bitwise_the_jax_stream(seed, num_hosts, host_id):
    tcfg, jcfg = _configs(seed, num_hosts, host_id)
    for step in (0, 1, 5, 1000):
        _assert_batches_equal(tpipe.batch_at(tcfg, step),
                              jpipe.batch_at(jcfg, step))


@pytest.mark.parametrize("extra", [
    dict(with_frames=True, frame_len=16, d_model=8),
    dict(with_embeds=True, d_model=8)], ids=["frames", "embeds"])
def test_frames_and_embeds_are_bitwise_the_jax_stream(extra):
    tcfg, jcfg = _configs(3, 1, 0, **extra)
    for step in (0, 2):
        _assert_batches_equal(tpipe.batch_at(tcfg, step),
                              jpipe.batch_at(jcfg, step))


@pytest.mark.parametrize("start", [0, 4])
def test_iterate_and_prefetcher_yield_the_jax_stream(start):
    tcfg, jcfg = _configs(11, 1, 0)
    want = list(itertools.islice(jpipe.iterate(jcfg, start), 5))
    got = list(itertools.islice(tpipe.iterate(tcfg, start), 5))
    for (ts, tb), (js, jb) in zip(got, want):
        assert ts == js
        _assert_batches_equal(tb, jb)
    pf = tpipe.Prefetcher(tcfg, start_step=start, depth=2)
    try:
        for js, jb in want:
            step, batch = pf.get()
            assert step == js
            _assert_batches_equal(batch, jb)
        assert pf.state() == start + 5
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("family", ["dense", "encdec", "vlm"])
def test_data_config_for_matches_jax(family):
    jarch = dataclasses.replace(jbase.get_smoke_config("qwen1-5-0-5b"),
                                family=family)
    tarch = dataclasses.replace(tbase.get_smoke_config("qwen1-5-0-5b"),
                                family=family)
    jshape = jbase.ShapeConfig("t", 600, 4, "train")
    tshape = tbase.ShapeConfig("t", 600, 4, "train")
    want = jpipe.data_config_for(jarch, jshape, seed=5, num_hosts=2,
                                 host_id=1)
    got = tpipe.data_config_for(tarch, tshape, seed=5, num_hosts=2,
                                host_id=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _assert_batches_equal(tpipe.batch_at(got, 3), jpipe.batch_at(want, 3))
