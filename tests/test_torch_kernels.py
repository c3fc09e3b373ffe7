"""The port's cscatter and cmerge (plain versions and CPU wrappers) and
their oracles against the JAX package's Pallas kernels (``interpret=True``)
and oracles.

The same numpy inputs, made from a seed, go through both. Integer tables
must agree bitwise; float tables to the JAX kernel tests' ``TOL``
(``tests/test_kernels.py``). The CUDA kernel itself runs only on the card:
see ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cmerge import cmerge as jax_cmerge
from repro.kernels.cscatter import cscatter as jax_cscatter
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cmerge import cmerge, cmerge_plain, cmerge_plain_
from repro_torch.kernels import cscatter as cs
from repro_torch.kernels.cscatter import (cscatter, cscatter_plain,
                                          cscatter_plain_)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py TOL
DTYPES = ("float32", "bfloat16", "int32", "uint32")
R, D, N, BR, CH = 64, 8, 96, 16, 32
SAT = {"float": (-2.0, 2.0), "int": (0.0, float(1 << 30))}


def _kinds(dtype):
    base = ("add", "sat_add", "max", "min")
    return base + (("or",) if dtype in ("int32", "uint32") else ())


def _inputs(dtype, seed=0, r=R, n=N, d=D, shards=None):
    """numpy table/ids/vals; float ones are exact in bf16 when asked."""
    rng = np.random.default_rng(seed)
    lead = () if shards is None else (shards,)
    ids = rng.integers(-3, r + 3, lead + (n,)).astype(np.int32)
    if dtype in ("float32", "bfloat16"):
        table = rng.standard_normal(lead + (r, d)).astype(np.float32)
        vals = rng.standard_normal(lead + (n, d)).astype(np.float32)
        if dtype == "bfloat16":  # round once, then both sides hold the bits
            table = np.asarray(jnp.asarray(table, jnp.bfloat16), np.float32)
            vals = np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float32)
        return table, ids, vals
    # below 2**24 in sum, so the JAX oracle's f32 sat_add is exact too
    table = rng.integers(0, 1 << 20, lead + (r, d)).astype(dtype)
    vals = rng.integers(0, 1 << 16, lead + (n, d)).astype(dtype)
    return table, ids, vals


def _torch(x, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x)).clone()


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)


def _np(x):
    """A torch or JAX result as numpy (bf16 widened exactly to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _assert_match(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype in TOL:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype] * 8)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _sat(dtype):
    return SAT["float" if dtype in TOL else "int"]


@pytest.mark.parametrize("dtype,kind", [(dt, k) for dt in DTYPES
                                        for k in _kinds(dt)])
def test_plain_matches_pallas_kernel_and_serial_oracle(dtype, kind):
    table, ids, vals = _inputs(dtype)
    lo, hi = _sat(dtype)
    want = jax_cscatter(_jax(table, dtype), jnp.asarray(ids),
                        _jax(vals, dtype), kind=kind, block_rows=BR,
                        chunk=CH, sat_min=lo, sat_max=hi, interpret=True)
    gold = jref.ref_cscatter_serial(_jax(table, dtype), jnp.asarray(ids),
                                    _jax(vals, dtype), kind, lo, hi)
    got = cscatter_plain(_torch(table, dtype), torch.from_numpy(ids),
                         _torch(vals, dtype), kind=kind, sat_min=lo,
                         sat_max=hi)
    _assert_match(got, want, dtype)
    _assert_match(got, gold, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_untouched_rows_stay_bit_exact(dtype):
    table, ids, vals = _inputs(dtype, seed=1)
    ids[ids % 3 == 0] = -1          # leave a third of the rows untouched
    t = _torch(table, dtype)
    for kind in _kinds(dtype):
        got = cscatter_plain(t, torch.from_numpy(ids), _torch(vals, dtype),
                             kind=kind, sat_min=_sat(dtype)[0],
                             sat_max=_sat(dtype)[1])
        untouched = np.setdiff1d(np.arange(R), ids)
        assert len(untouched) > 0
        assert torch.equal(got[untouched], t[untouched]), kind


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_min_at_the_dtype_maximum(dtype):
    """MIN's identity is the dtype's maximum: a table holding it everywhere
    (uint32 0xFFFFFFFF) takes each row's smallest update, bitwise."""
    _, ids, vals = _inputs(dtype, seed=2)
    table = np.full((R, D), np.iinfo(dtype).max, dtype)
    vals[::5] = np.iinfo(dtype).max
    want = jax_cscatter(jnp.asarray(table), jnp.asarray(ids),
                        jnp.asarray(vals), kind="min", block_rows=BR,
                        chunk=CH, interpret=True)
    got = cscatter_plain(_torch(table, dtype), torch.from_numpy(ids),
                         _torch(vals, dtype), kind="min")
    _assert_match(got, want, dtype)
    t = _torch(table, dtype)
    ref_got = ref.ref_cscatter(t, torch.from_numpy(ids), _torch(vals, dtype),
                               "min")
    _assert_match(ref_got, want, dtype)


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_integer_sat_add_follows_the_kernel_not_the_oracle(dtype):
    """The Pallas kernel adds integers in the table's dtype, then clips; the
    JAX oracle adds and clips in f32. Above 2**24 they differ: the port
    matches the kernel."""
    rng = np.random.default_rng(3)
    table = rng.integers(1 << 26, 1 << 28, (R, D)).astype(dtype)
    table |= 1                      # odd: not representable in f32
    ids = rng.integers(0, R, N).astype(np.int32)
    vals = rng.integers(1, 1 << 20, (N, D)).astype(dtype)
    vals |= 1
    lo, hi = 0.0, float(1 << 30)
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals))
    kern = np.asarray(jax_cscatter(*args, kind="sat_add", block_rows=BR,
                                   chunk=CH, sat_min=lo, sat_max=hi,
                                   interpret=True))
    oracle = np.asarray(jref.ref_cscatter(*args, "sat_add", lo, hi))
    got = cscatter_plain(_torch(table, dtype), torch.from_numpy(ids),
                         _torch(vals, dtype), kind="sat_add", sat_min=lo,
                         sat_max=hi).numpy()
    np.testing.assert_array_equal(got, kern)
    assert not np.array_equal(got, oracle)
    # the port's oracles keep the JAX oracle's definition
    port_oracle = ref.ref_cscatter(_torch(table, dtype),
                                   torch.from_numpy(ids),
                                   _torch(vals, dtype), "sat_add", lo, hi)
    np.testing.assert_array_equal(port_oracle.numpy(), oracle)


@pytest.mark.parametrize("dtype", DTYPES)
def test_leading_shard_form_is_one_scatter_per_shard(dtype):
    S = 3
    table, ids, vals = _inputs(dtype, seed=4, shards=S)
    lo, hi = _sat(dtype)
    for kind in _kinds(dtype):
        got = cscatter_plain(_torch(table, dtype), torch.from_numpy(ids),
                             _torch(vals, dtype), kind=kind, sat_min=lo,
                             sat_max=hi)
        for s in range(S):
            want = jax_cscatter(_jax(table[s], dtype), jnp.asarray(ids[s]),
                                _jax(vals[s], dtype), kind=kind,
                                block_rows=BR, chunk=CH, sat_min=lo,
                                sat_max=hi, interpret=True)
            _assert_match(got[s], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrapper_updates_in_place_as_the_plain_version(dtype):
    table, ids, vals = _inputs(dtype, seed=5, shards=2)
    for kind in _kinds(dtype):
        t = _torch(table, dtype)
        want = cscatter_plain(t, torch.from_numpy(ids), _torch(vals, dtype),
                              kind=kind, sat_min=-1.0, sat_max=1.0)
        out = cscatter(t, torch.from_numpy(ids), _torch(vals, dtype),
                       kind=kind, sat_min=-1.0, sat_max=1.0)
        assert out is t
        assert torch.equal(t, want), kind


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_oracles_match_jax_oracles(dtype):
    table, ids, vals = _inputs(dtype, seed=6)
    lo, hi = _sat(dtype)
    for kind in _kinds(dtype):
        args = (_jax(table, dtype), jnp.asarray(ids), _jax(vals, dtype))
        targs = (_torch(table, dtype), torch.from_numpy(ids),
                 _torch(vals, dtype))
        want = jref.ref_cscatter_serial(*args, kind, lo, hi)
        _assert_match(ref.ref_cscatter_serial(*targs, kind, lo, hi), want,
                      dtype)
        _assert_match(ref.ref_cscatter(*targs, kind, lo, hi), want, dtype)
        if (dtype, kind) == ("uint32", "min"):
            # the JAX vectorized oracle cannot pad with 2**32 - 1: jnp.where
            # overflows on the Python int (ref.py:69-71)
            with pytest.raises(OverflowError):
                jref.ref_cscatter(*args, kind, lo, hi)
            continue
        _assert_match(ref.ref_cscatter(*targs, kind, lo, hi),
                      jref.ref_cscatter(*args, kind, lo, hi), dtype)


def test_all_padding_batch_leaves_the_table_alone():
    table, _, vals = _inputs("int32", seed=7)
    t = _torch(table, "int32")
    ids = torch.full((N,), -1, dtype=torch.int32)
    assert torch.equal(cscatter_plain(t, ids, _torch(vals, "int32")), t)
    empty = cscatter_plain(t, ids[:0], _torch(vals, "int32")[:0])
    assert torch.equal(empty, t)


def test_ops_entry_points_match_jax_ops():
    from repro.kernels import ops as jops
    table, ids, vals = _inputs("float32", seed=8)
    want = jops.commutative_scatter(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(vals), kind="max",
                                    block_rows=BR, chunk=CH)
    got = ops.commutative_scatter(_torch(table, "float32"),
                                  torch.from_numpy(ids),
                                  _torch(vals, "float32"), kind="max")
    _assert_match(got, want, "float32")
    grad = np.zeros((R, D), np.float32)
    want = jops.embedding_grad_scatter(jnp.asarray(grad), jnp.asarray(ids),
                                       jnp.asarray(vals), block_rows=BR,
                                       chunk=CH)
    got = ops.embedding_grad_scatter(_torch(grad, "float32"),
                                     torch.from_numpy(ids),
                                     _torch(vals, "float32"))
    _assert_match(got, want, "float32")


@pytest.mark.parametrize("bad", ["kind", "or_float", "ids_dtype", "vals_dtype",
                                 "table_dtype", "shape", "contiguous",
                                 "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    table = torch.zeros((2, 8, 4), dtype=torch.float32)
    ids = torch.zeros((2, 5), dtype=torch.int32)
    vals = torch.ones((2, 5, 4), dtype=torch.float32)
    kind = "add"
    if bad == "kind":
        kind = "xor"
    elif bad == "or_float":
        kind = "or"
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "vals_dtype":
        vals = vals.double()
    elif bad == "table_dtype":
        table, vals = table.double(), vals.double()
    elif bad == "shape":
        vals = vals[:, :4]
    elif bad == "contiguous":
        table = torch.zeros((2, 4, 8)).transpose(1, 2)
    else:
        ids = ids[None]
    with pytest.raises((TypeError, ValueError)):
        cscatter(table, ids, vals, kind=kind)


@pytest.mark.parametrize("r", [1, 1000, 1 << 22, 1 << 30])
@pytest.mark.parametrize("n", [1, 8192, 1 << 20])
def test_bucketed_cscatter_host_sizing(r, n):
    """The two launches' geometry, computed on the host for every D up to
    256: tiles cover the table, the shared memory fits a block, the
    histogram rounds cover every block, the scratch holds perm, rowid,
    unit starts, big units and counts, and the fold grid is bounded by the
    card and by the shard's units."""
    s, n_sm = 8, 132
    for d in range(1, 257):
        p = cs.plan(s, r, n, d, n_sm)
        assert p.dc == min(d, cs.MAX_COLS)
        assert (p.col_tiles - 1) * p.dc < d <= p.col_tiles * p.dc
        assert p.br % 32 == 0 and 32 <= p.br <= max(32, -(-r // 32) * 32)
        assert (p.n_blocks - 1) * p.br < r <= p.n_blocks * p.br
        assert p.br * p.dc * 4 + p.br // 8 <= 227 * 1024  # the fold's tile
        assert p.br * p.dc * 4 <= cs.MAX_ACC_BYTES
        counters = -(-p.hist_cap // 4) * 4
        assert 4 * counters <= cs.BUCKET_SMEM
        assert p.stage == (p.chunks == 1 and 4 * (counters + 2 * n)
                           <= cs.BUCKET_SMEM)
        assert (p.chunks - 1) * p.hist_cap < p.n_blocks <= \
            p.chunks * p.hist_cap
        assert p.list_cap == max(1, min(p.n_blocks, n))
        assert p.scratch == s * (2 * n + 2 * p.list_cap + 3) < 2**31
        assert 1 <= p.fold_ctas <= -(-cs.FOLD_CTAS_PER_SM * n_sm // s)
        assert p.fold_ctas <= max(1, -(-p.list_cap // cs.FOLD_WARPS))
        if r <= 1 << 22:    # one histogram: the ids are read twice a call
            assert p.chunks == 1


def test_bucketed_cscatter_sizing_at_the_main_path():
    """[8, 2^22, 4] int32: 1024-row blocks, one histogram of 4096, a fold
    grid of 132 CTAs per shard; a tick's 1024 ids per shard make at most
    1024 units, a ring flush's 8192 at most 4096."""
    tick, flush = (cs.plan(8, 1 << 22, n, 4, 132) for n in (1024, 8192))
    for p in (tick, flush):
        assert (p.br, p.dc, p.col_tiles, p.n_blocks, p.hist_cap, p.chunks,
                p.fold_ctas) == (1024, 4, 1, 4096, 4096, 1, 132)
        assert p.stage
    assert (tick.list_cap, flush.list_cap) == (1024, 4096)
    assert (tick.scratch, flush.scratch) == (8 * (2048 + 2048 + 3),
                                             8 * (16384 + 8192 + 3))
    with pytest.raises(ValueError):
        cs.plan(8, 0, 1, 4, 132)


# ---------------------------------------------------------------- cmerge

W, BRM = 4, 8                          # ways, rows per block (R = 64)
BLOCK_IDS = np.asarray([5, -1, 0, 2], np.int32)
DIRTY = np.asarray([1, 1, 0, 1], np.int32)


def _cmerge_inputs(dtype, seed=0, shards=None):
    """numpy table/src/upd for the merge instruction; upd is what a way's
    update copy holds after COps on top of src (an or-superset for
    integers, so every kind's delta rule holds)."""
    rng = np.random.default_rng(seed)
    lead = () if shards is None else (shards,)
    shape = lead + (W, BRM, D)
    if dtype in TOL:
        table, _, _ = _inputs(dtype, seed, r=R, n=1, d=D, shards=shards)
        src = rng.standard_normal(shape).astype(np.float32)
        upd = src + rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            src = np.asarray(jnp.asarray(src, jnp.bfloat16), np.float32)
            upd = np.asarray(jnp.asarray(upd, jnp.bfloat16), np.float32)
        return table, src, upd
    table = rng.integers(0, 1 << 20, lead + (R, D)).astype(dtype)
    src = rng.integers(0, 1 << 20, shape).astype(dtype)
    upd = src | rng.integers(0, 1 << 16, shape).astype(dtype)
    return table, src, upd


def _ids(shards=None):
    if shards is None:
        return BLOCK_IDS, DIRTY
    return np.tile(BLOCK_IDS, (shards, 1)), np.tile(DIRTY, (shards, 1))


@pytest.mark.parametrize("dtype,kind", [(dt, k) for dt in DTYPES
                                        for k in _kinds(dt)])
def test_cmerge_plain_matches_pallas_kernel_and_oracle(dtype, kind):
    from repro.kernels import ops as jops
    table, src, upd = _cmerge_inputs(dtype)
    lo, hi = _sat(dtype)
    jargs = (_jax(table, dtype), jnp.asarray(BLOCK_IDS), jnp.asarray(DIRTY),
             _jax(src, dtype), _jax(upd, dtype))
    targs = (_torch(table, dtype), torch.from_numpy(BLOCK_IDS),
             torch.from_numpy(DIRTY), _torch(src, dtype), _torch(upd, dtype))
    want = jops.merge_buffer(*jargs, kind=kind, sat_min=lo, sat_max=hi)
    gold = jref.ref_cmerge(*jargs, kind, lo, hi)
    _assert_match(cmerge_plain(*targs, kind=kind, sat_min=lo, sat_max=hi),
                  want, dtype)
    _assert_match(ops.merge_buffer(*(x.clone() for x in targs), kind=kind,
                                   sat_min=lo, sat_max=hi), want, dtype)
    _assert_match(ref.ref_cmerge(*targs, kind, lo, hi), gold, dtype)
    _assert_match(ref.ref_cmerge(*targs, kind, lo, hi), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cmerge_clean_and_invalid_ways_leave_memory_alone(dtype):
    """Only valid dirty ways merge: every other row stays bit-exact, and a
    buffer of clean ways (whose update copies would corrupt memory if
    merged) changes nothing."""
    table, src, upd = _cmerge_inputs(dtype, seed=1)
    t = _torch(table, dtype)
    ids = torch.from_numpy(BLOCK_IDS)
    for kind in _kinds(dtype):
        got = cmerge_plain(t, ids, torch.from_numpy(DIRTY),
                           _torch(src, dtype), _torch(upd, dtype), kind=kind,
                           sat_min=_sat(dtype)[0], sat_max=_sat(dtype)[1])
        merged = {5, 2}               # valid and dirty
        rest = [r for r in range(R) if r // BRM not in merged]
        assert torch.equal(got[rest], t[rest]), kind
        clean = cmerge_plain(t, ids, torch.zeros(W, dtype=torch.int32),
                             _torch(src, dtype), _torch(upd, dtype),
                             kind=kind)
        assert torch.equal(clean, t), kind


@pytest.mark.parametrize("kind", ["add", "max", "or"])
def test_cmerge_block_id_past_the_table_follows_the_kernel_not_the_oracle(
        kind):
    """A dirty way whose block id lies past the table's end: the Pallas
    kernel (``ops.merge_buffer``, interpret mode) leaves every row alone,
    and so do the port's plain version and oracle; the JAX oracle
    ``ref_cmerge`` clamps the id and writes the last block instead."""
    rng = np.random.default_rng(11)
    table = rng.integers(0, 1 << 20, (32, 4)).astype(np.int32)
    src = rng.integers(0, 1 << 20, (1, 8, 4)).astype(np.int32)
    upd = src | rng.integers(1, 1 << 16, (1, 8, 4)).astype(np.int32)
    ids, dirty = np.asarray([5], np.int32), np.asarray([1], np.int32)
    jargs = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(dirty),
             jnp.asarray(src), jnp.asarray(upd))
    targs = (torch.from_numpy(table), torch.from_numpy(ids),
             torch.from_numpy(dirty), torch.from_numpy(src),
             torch.from_numpy(upd))
    kernel = np.asarray(jops.merge_buffer(*jargs, kind=kind))
    np.testing.assert_array_equal(kernel, table)
    np.testing.assert_array_equal(cmerge_plain(*targs, kind=kind).numpy(),
                                  kernel)
    np.testing.assert_array_equal(ref.ref_cmerge(*targs, kind=kind).numpy(),
                                  kernel)
    oracle = np.asarray(jref.ref_cmerge(*jargs, kind=kind))
    np.testing.assert_array_equal(oracle[:24], table[:24])
    assert not np.array_equal(oracle[24:], table[24:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cmerge_leading_shard_form_is_one_merge_per_shard(dtype):
    S = 3
    table, src, upd = _cmerge_inputs(dtype, seed=2, shards=S)
    ids, dirty = _ids(S)
    dirty = dirty.copy()
    dirty[1, 0] = 0                   # shards differ in what they merge
    lo, hi = _sat(dtype)
    for kind in _kinds(dtype):
        got = cmerge_plain(_torch(table, dtype), torch.from_numpy(ids),
                           torch.from_numpy(dirty), _torch(src, dtype),
                           _torch(upd, dtype), kind=kind, sat_min=lo,
                           sat_max=hi)
        for s in range(S):
            want = jax_cmerge(_jax(table[s], dtype), jnp.asarray(ids[s]),
                              jnp.asarray(dirty[s]), _jax(src[s], dtype),
                              _jax(upd[s], dtype), kind=kind, sat_min=lo,
                              sat_max=hi, interpret=True)
            _assert_match(got[s], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cmerge_cpu_wrapper_updates_in_place_as_the_plain_version(dtype):
    table, src, upd = _cmerge_inputs(dtype, seed=3, shards=2)
    ids, dirty = _ids(2)
    for kind in _kinds(dtype):
        t = _torch(table, dtype)
        args = (torch.from_numpy(ids), torch.from_numpy(dirty) != 0,
                _torch(src, dtype), _torch(upd, dtype))
        want = cmerge_plain(t, *args, kind=kind, sat_min=-1.0, sat_max=1.0)
        out = cmerge(t, *args, kind=kind, sat_min=-1.0, sat_max=1.0)
        assert out is t
        assert torch.equal(t, want), kind


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["cscatter", "cmerge"])
@pytest.mark.parametrize("shards", [None, 2])
def test_in_place_plain_versions_match_the_copying_ones(kernel, dtype,
                                                        shards):
    """``*_plain_`` writes into its argument what ``*_plain`` returns on a
    copy, with and without the leading shard dim."""
    if kernel == "cscatter":
        table, ids, vals = _inputs(dtype, seed=9, shards=shards)
        args = (torch.from_numpy(ids), _torch(vals, dtype))
        copying, in_place = cscatter_plain, cscatter_plain_
    else:
        table, src, upd = _cmerge_inputs(dtype, seed=9, shards=shards)
        ids, dirty = _ids(shards)
        args = (torch.from_numpy(ids), torch.from_numpy(dirty) != 0,
                _torch(src, dtype), _torch(upd, dtype))
        copying, in_place = cmerge_plain, cmerge_plain_
    for kind in _kinds(dtype):
        t = _torch(table, dtype)
        before = t.clone()
        want = copying(t, *args, kind=kind, sat_min=-1.0, sat_max=1.0)
        assert torch.equal(t, before), kind
        assert in_place(t, *args, kind=kind, sat_min=-1.0,
                        sat_max=1.0) is t
        assert torch.equal(t, want), kind


@pytest.mark.parametrize("bad", ["kind", "or_float", "ids_dtype",
                                 "dirty_dtype", "upd_dtype", "rows", "shape",
                                 "contiguous", "rank"])
def test_cmerge_wrapper_refuses_what_the_kernel_does_not_take(bad):
    table = torch.zeros((2, 16, 4), dtype=torch.float32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    dirty = torch.ones((2, 3), dtype=torch.bool)
    src = torch.zeros((2, 3, 4, 4), dtype=torch.float32)
    upd = torch.ones((2, 3, 4, 4), dtype=torch.float32)
    kind = "add"
    if bad == "kind":
        kind = "xor"
    elif bad == "or_float":
        kind = "or"
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "dirty_dtype":
        dirty = dirty.float()
    elif bad == "upd_dtype":
        upd = upd.double()
    elif bad == "rows":               # 18 rows are no whole number of blocks
        table = torch.zeros((2, 18, 4))
    elif bad == "shape":
        upd = upd[:, :2]
    elif bad == "contiguous":
        src = torch.zeros((2, 3, 4, 4)).transpose(2, 3)
    else:
        ids = ids[None]
    with pytest.raises((TypeError, ValueError)):
        cmerge(table, ids, dirty, src, upd, kind=kind)
