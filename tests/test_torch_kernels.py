"""The port's cscatter (plain version and CPU wrapper) and its oracles
against the JAX package's Pallas kernel (``interpret=True``) and oracles.

The same numpy inputs, made from a seed, go through both. Integer tables
must agree bitwise; float tables to the JAX kernel tests' ``TOL``
(``tests/test_kernels.py``). The CUDA kernel itself runs only on the card:
see ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cscatter import cscatter as jax_cscatter
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cscatter import cscatter, cscatter_plain

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
