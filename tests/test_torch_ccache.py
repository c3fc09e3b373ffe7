"""The port's merge engine on the stacked axis against the JAX engine under
``jax.vmap(axis_name=...)``.

Random MergePlans over S ranks, int32 payloads made from a seed with numpy,
ADD/MAX/MIN/OR: ``hierarchical_merge``, every due of ``defer_cascade``, and
``launch_inflight`` then ``settle_inflight`` must agree bitwise. (Under vmap
the JAX engine's fused innermost stage falls back to the butterfly; the
port's grouped reduction over dim 0 is bitwise equal for these integer
merges.)
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ccache as jcc
from repro.core import merge_functions as jmf
from repro.core import merge_plan as jmp
from repro_torch.core import ccache
from repro_torch.core import merge_functions as mf
from repro_torch.core import merge_plan as mp
from repro_torch.core.stacked import StackedAxis, stacked_spmd

AX = "ranks"
MERGES = {"add": (mf.ADD, jmf.ADD), "max": (mf.MAX, jmf.MAX),
          "min": (mf.MIN, jmf.MIN), "or": (mf.BITWISE_OR, jmf.BITWISE_OR)}
FACTORS = {4: [(2, 2), (4,), (2, 1, 2)],
           6: [(3, 2), (2, 3)],
           8: [(2, 2, 2), (2, 4), (4, 2), (8,)],
           12: [(2, 3, 2), (4, 3)]}


def _random_plan(rng, size):
    """A plan over ``size`` ranks: a random factorization, lane-parallel or
    not, the outer ``n_defer`` executing levels deferred (at least one)."""
    sizes = FACTORS[size][rng.integers(len(FACTORS[size]))]
    names = ("chip", "host", "pod")[:len(sizes)]
    executing = [i for i, s in enumerate(sizes) if s > 1]
    first_deferred = executing[rng.integers(len(executing))]
    spec = ",".join(f"{n}:{s}" + (":defer" if i >= first_deferred else "")
                    for i, (n, s) in enumerate(zip(names, sizes)))
    lane = bool(rng.integers(2))
    return (mp.MergePlan.parse(spec, lane_parallel=lane),
            jmp.MergePlan.parse(spec, lane_parallel=lane))


def _payload(rng, size, kind, shape=(5, 3)):
    if kind == "or":
        return rng.integers(0, 1 << 30, (size,) + shape).astype(np.int32)
    return rng.integers(-1000, 1000, (size,) + shape).astype(np.int32)


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name=AX)(*args)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = [(size, seed, kind) for size in (4, 8) for seed in range(3)
         for kind in MERGES] + [(size, seed, "add") for size in (6, 12)
                                for seed in range(2)]


@pytest.mark.parametrize("size,seed,kind", CASES)
def test_hierarchical_merge_matches_vmap(size, seed, kind):
    rng = np.random.default_rng(seed * 100 + size)
    plan, jplan = _random_plan(rng, size)
    port, ref = MERGES[kind]
    x = _payload(rng, size, kind)
    axis = StackedAxis(size, "cpu")
    for force_tree in (False, True):
        got = ccache.hierarchical_merge(torch.from_numpy(x), axis, port, plan,
                                        force_tree=force_tree)
        want = _vmap(lambda v: jcc.hierarchical_merge(
            v, AX, ref, jplan, force_tree=force_tree), x)
        _eq(got, want)
    # every rank ends with the full combination
    full = {"add": x.sum(0), "max": x.max(0), "min": x.min(0),
            "or": np.bitwise_or.reduce(x, 0)}[kind]
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(full, x.shape))


@pytest.mark.parametrize("size,seed,kind", CASES)
def test_defer_cascade_every_due_matches_vmap(size, seed, kind):
    rng = np.random.default_rng(seed * 100 + size + 7)
    plan, jplan = _random_plan(rng, size)
    port, ref = MERGES[kind]
    n_def = plan.num_deferred
    delta = _payload(rng, size, kind)
    pend = [_payload(rng, size, kind) for _ in range(n_def)]
    axis = StackedAxis(size, "cpu")
    for due in range(n_def + 1):
        got_p, got_s = ccache.defer_cascade(
            torch.from_numpy(delta), [torch.from_numpy(p) for p in pend],
            due, axis, port, plan)
        want_p, want_s = _vmap(
            lambda d, *p: jcc.defer_cascade(d, list(p), due, AX, ref, jplan),
            delta, *pend)
        assert len(got_p) == len(want_p) == n_def
        for g, w in zip(got_p, want_p):
            _eq(g, w)
        assert (got_s is None) == (want_s is None) == (due < n_def)
        if got_s is not None:
            _eq(got_s, want_s)


@pytest.mark.parametrize("size,seed,kind", CASES)
def test_launch_then_settle_inflight_matches_vmap(size, seed, kind):
    rng = np.random.default_rng(seed * 100 + size + 13)
    plan, jplan = _random_plan(rng, size)
    port, ref = MERGES[kind]
    x = _payload(rng, size, kind)
    axis = StackedAxis(size, "cpu")
    launched = ccache.launch_inflight(torch.from_numpy(x), axis, port, plan)
    jlaunched = _vmap(lambda v: jcc.launch_inflight(v, AX, ref, jplan), x)
    _eq(launched, jlaunched)
    landed = ccache.settle_inflight(launched, axis, port, plan)
    _eq(landed, _vmap(lambda v: jcc.settle_inflight(v, AX, ref, jplan),
                      np.asarray(jlaunched)))
    _eq(landed, _vmap(lambda v: jcc.settle_deferred(v, AX, ref, jplan), x))
    _eq(ccache.settle_deferred(torch.from_numpy(x), axis, port, plan),
        np.asarray(landed))


def _manifests(fn, plan, size, merge, *args):
    return [dataclasses.asdict(m) for m in fn(plan, size, *args,
                                              merge_fn=merge)]


@pytest.mark.parametrize("size", [4, 6, 8, 12])
def test_manifests_match_jax(size):
    rng = np.random.default_rng(size)
    for _ in range(4):
        plan, jplan = _random_plan(rng, size)
        for kind in ("add", "or"):
            port, ref = MERGES[kind]
            assert _manifests(ccache.collective_manifest, plan, size, port) \
                == _manifests(jcc.collective_manifest, jplan, size, ref)
            for due in range(plan.num_deferred + 1):
                assert _manifests(ccache.program_manifest, plan, size, port,
                                  due) == \
                    _manifests(jcc.program_manifest, jplan, size, ref, due)
            for half in ("launch", "land"):
                assert _manifests(ccache.overlap_program_manifest, plan,
                                  size, port, half) == \
                    _manifests(jcc.overlap_program_manifest, jplan, size,
                               ref, half)


def test_ppermute_zero_fills_ranks_that_receive_nothing():
    """JAX's documented ``lax.ppermute`` semantics (vmap itself only takes
    full permutations): a rank that is no pair's destination gets zeros."""
    x = np.arange(1, 13, dtype=np.int32).reshape(4, 3)
    axis = StackedAxis(4, "cpu")
    got = axis.ppermute(torch.from_numpy(x), [(0, 1), (2, 3)])
    assert got.tolist() == [[0, 0, 0], x[0].tolist(), [0, 0, 0],
                            x[2].tolist()]
    # a full bijection moves every row and fills nothing
    cyc = [(i, (i + 1) % 4) for i in range(4)]
    _eq(axis.ppermute(torch.from_numpy(x), cyc),
        _vmap(lambda v: jax.lax.ppermute(v, AX, cyc), x))
    with pytest.raises(ValueError):
        axis.ppermute(torch.from_numpy(x), [(0, 1), (2, 1)])


def test_grouped_reductions_and_axis_index():
    x = np.random.default_rng(0).integers(-9, 9, (8, 3)).astype(np.int32)
    axis = StackedAxis(8, "cpu")
    t = torch.from_numpy(x)
    for group in (2, 4, 8):
        g = x.reshape(8 // group, group, 3)
        for name, red in (("psum", g.sum(1)), ("pmax", g.max(1)),
                          ("pmin", g.min(1))):
            got = getattr(axis, name)(t, group)
            want = np.repeat(red, group, axis=0).astype(np.int32)
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.dtype == t.dtype
    np.testing.assert_array_equal(
        axis.psum(t).numpy(), _vmap(lambda v: jax.lax.psum(v, AX), x))
    np.testing.assert_array_equal(
        axis.index().numpy(), _vmap(lambda v: jax.lax.axis_index(AX), x))
    with pytest.raises(ValueError):
        axis.psum(t, 3)


def test_stacked_spmd_refuses_writes_to_arguments_not_donated():
    def bump(a, b):
        a.add_(1)
        return a + b

    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    assert torch.equal(stacked_spmd(bump, a, b, donate=(0,)),
                       torch.full((2, 3), 2.0))
    with pytest.raises(RuntimeError, match="not donated"):
        stacked_spmd(bump, a, b)
