"""The port's merge functions, permutation builders, MergePlan compiler and
DeferSchedule against the JAX package's, on the same inputs.

Merges run on random tensors made from a seed with numpy (integers bitwise,
floats to f32 rounding); the pure-Python modules must give identical
output.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import common as jcommon
from repro.core import merge_functions as jmf
from repro.core import merge_plan as jmp
from repro.core import permutes as jperm
from repro.core.defer_schedule import DeferSchedule as JDeferSchedule
from repro.serve import kv as jkv
from repro_torch.apps import common
from repro_torch.core import merge_functions as mf
from repro_torch.core import merge_plan as mp
from repro_torch.core import permutes as perm
from repro_torch.core.defer_schedule import DeferSchedule
from repro_torch.serve import kv

MERGES = {
    "add": (mf.ADD, jmf.ADD),
    "mul": (mf.MUL, jmf.MUL),
    "complex_mul": (mf.COMPLEX_MUL, jmf.COMPLEX_MUL),
    "max": (mf.MAX, jmf.MAX),
    "min": (mf.MIN, jmf.MIN),
    "or": (mf.BITWISE_OR, jmf.BITWISE_OR),
    "and": (mf.BITWISE_AND, jmf.BITWISE_AND),
    "sat_add": (mf.saturating_add(8.0, min_value=-8.0),
                jmf.saturating_add(8.0, min_value=-8.0)),
    "sat_add_hi": (mf.saturating_add(100.0), jmf.saturating_add(100.0)),
    "int8_add": (mf.int8_compressed_add(), jmf.int8_compressed_add()),
    "drop_add": (mf.dropping_add(0.25), jmf.dropping_add(0.25)),
}
# the dtypes each merge is defined on
MERGE_DTYPES = {
    "add": ("float32", "int32"), "mul": ("float32",),
    "complex_mul": ("float32",), "max": ("float32", "int32"),
    "min": ("float32", "int32"), "or": ("int32",), "and": ("int32",),
    "sat_add": ("float32", "int32"), "sat_add_hi": ("float32", "int32"),
    "int8_add": ("float32",),
}
TRAITS = ("name", "xla_reduce", "needs_key", "wire_atom", "idempotent",
          "scalable", "invertible", "deferrable", "stale_tolerant")


def _rand(rng, dtype, shape):
    if dtype == "int32":
        return rng.integers(-20, 20, shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(np.abs(x) < 0.1, np.float32(0.5), x)  # no near-0 divisor


def _same(got: torch.Tensor, want, dtype):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,dtype", [(n, d) for n, ds in
                                        MERGE_DTYPES.items() for d in ds])
def test_merge_pieces_match_jax(name, dtype):
    port, ref = MERGES[name]
    rng = np.random.default_rng(0)
    shape = (6, 5, 2)
    a, b, m = (_rand(rng, dtype, shape) for _ in range(3))
    ta, tb, tm = (torch.from_numpy(x) for x in (a, b, m))
    ja, jb, jm = (jnp.asarray(x) for x in (a, b, m))
    _same(port.delta(ta, tb), ref.delta(ja, jb), dtype)
    _same(port.combine(ta, tb), ref.combine(ja, jb), dtype)
    _same(port.apply(tm, ta), ref.apply(jm, ja), dtype)
    _same(port.tree_combine({"x": ta}, {"x": tb})["x"],
          ref.tree_combine({"x": ja}, {"x": jb})["x"], dtype)
    _same(port.tree_apply([tm], [ta])[0], ref.tree_apply([jm], [ja])[0],
          dtype)
    tdt = getattr(torch, dtype)
    ident = port.identity(shape, tdt)
    assert ident.dtype == tdt
    _same(ident, ref.identity(shape, getattr(jnp, dtype)), dtype)
    _same(port.tree_identity((ta,))[0], ref.tree_identity((ja,))[0], dtype)
    # the identity is neutral under combine
    _same(port.combine(ident, ta), a, dtype)


@pytest.mark.parametrize("name", sorted(MERGES))
def test_merge_traits_and_checks_match_jax(name):
    port, ref = MERGES[name]
    for trait in TRAITS:
        assert getattr(port, trait) == getattr(ref, trait), trait
    assert port.settle_mode() == ref.settle_mode()
    for check in ("check_deferrable", "check_overlap"):
        outcomes = []
        for fn in (port, ref):
            try:
                getattr(fn, check)("ctx")
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(type(e))
        assert outcomes[0] == outcomes[1], check


def test_and_identity_on_unsigned_sets_every_bit():
    ident = mf.BITWISE_AND.identity((3,), torch.uint32)
    assert ident.view(torch.int32).tolist() == [-1, -1, -1]
    with pytest.raises(TypeError):
        mf.BITWISE_AND.identity((3,), torch.float32)


SIZES = (2, 4, 8, 16)


def _divisor_pairs(n):
    return [(s, f) for s in SIZES for f in SIZES if s * f <= n and n % (s * f)
            == 0]


@pytest.mark.parametrize("n", SIZES)
def test_permutes_match_jax(n):
    assert perm.is_pow2(n) == jperm.is_pow2(n)
    for step in (1, 2, 4, 8):
        if step < n:
            assert perm.butterfly_perms(n, step) == \
                jperm.butterfly_perms(n, step)
    for g in SIZES:
        if n % g == 0:
            assert perm.ring_perm(n, g) == jperm.ring_perm(n, g)
            assert perm.binomial_broadcast_perms(n, g) == \
                jperm.binomial_broadcast_perms(n, g)
            assert perm.lane_gather_doubling_perms(n, g) == \
                jperm.lane_gather_doubling_perms(n, g)
    for stride, fanout in _divisor_pairs(n):
        assert perm.rep_exchange_perms(n, stride, fanout) == \
            jperm.rep_exchange_perms(n, stride, fanout)
        assert perm.lane_exchange_perms(n, stride, fanout) == \
            jperm.lane_exchange_perms(n, stride, fanout)


def _as_dicts(stages):
    return [dataclasses.asdict(s) for s in stages]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lane_parallel", [False, True])
def test_default_plan_compiles_identically(n, lane_parallel):
    plan = common.default_plan(n, lane_parallel=lane_parallel)
    jplan = jcommon.default_plan(n, lane_parallel=lane_parallel)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    for port_merge, ref_merge in (MERGES["add"], MERGES["or"], (None, None)):
        assert _as_dicts(mp.compile_plan(plan, n, merge_fn=port_merge)) == \
            _as_dicts(jmp.compile_plan(jplan, n, merge_fn=ref_merge))
    for defer in ("all", "top", "none"):
        sp = kv.serving_plan(n, defer, lane_parallel=lane_parallel)
        jsp = jkv.serving_plan(n, defer, lane_parallel=lane_parallel)
        assert dataclasses.asdict(sp) == dataclasses.asdict(jsp)
        assert _as_dicts(mp.compile_plan(sp, n, merge_fn=mf.ADD)) == \
            _as_dicts(jmp.compile_plan(jsp, n, merge_fn=jmf.ADD))


@pytest.mark.parametrize("spec,size", [
    ("chip:2,host:3,pod:2", 12), ("chip:4,host:2,pod:2:defer", 16),
    ("a:2,b:2,c:2,d:2", 16), ("chip:2,host:1,pod:4", 8),
    ("chip:3:defer,pod:2:defer", 6), ("chip:2,pod:2:compress", 4)])
def test_parsed_plans_compile_identically(spec, size):
    for lane in (False, True):
        plan = mp.MergePlan.parse(spec, lane_parallel=lane)
        jplan = jmp.MergePlan.parse(spec, lane_parallel=lane)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
        assert plan.strides() == jplan.strides()
        assert plan.level_sizes() == jplan.level_sizes()
        assert plan.num_deferred == jplan.num_deferred
        assert _as_dicts(mp.compile_plan(plan, size)) == \
            _as_dicts(jmp.compile_plan(jplan, size))
        assert mp.validate_plan_merge(plan, size, mf.ADD) == \
            jmp.validate_plan_merge(jplan, size, jmf.ADD)


def test_compile_plan_checks_the_ports_merge_traits():
    """``compile_plan`` -> ``validate_plan_merge`` -> the port's
    ``MergeFn.check_deferrable``: a non-deferrable merge on a :defer level
    raises in both packages, with the same problem list."""
    spec = "chip:2,host:2,pod:2:defer"
    plan, jplan = mp.MergePlan.parse(spec), jmp.MergePlan.parse(spec)
    port, ref = MERGES["sat_add"]
    assert [p[:2] for p in mp.validate_plan_merge(plan, 8, port)] == \
        [p[:2] for p in jmp.validate_plan_merge(jplan, 8, ref)] == \
        [("defer-trait", "pod")]
    with pytest.raises(ValueError, match="cannot defer"):
        mp.compile_plan(plan, 8, merge_fn=port)
    with pytest.raises(ValueError, match="geometry|cover|ranks"):
        mp.compile_plan(plan, 16, merge_fn=mf.ADD)
    with pytest.raises(ValueError):
        jmp.compile_plan(jplan, 16, merge_fn=jmf.ADD)


@pytest.mark.parametrize("intervals,overlap", [
    ((1,), False), ((3, 6), False), ((2, 4, 8), False), ((8, 8, 8), True)])
def test_defer_schedule_matches_jax(intervals, overlap):
    names = ("chip", "host", "pod")[:len(intervals)]
    s = DeferSchedule(names, intervals, overlap=overlap)
    j = JDeferSchedule(names, intervals, overlap=overlap)
    assert (s.period, s.max_period, s.num_levels) == \
        (j.period, j.max_period, j.num_levels)
    assert [s.due_count(t) for t in range(1, 30)] == \
        [j.due_count(t) for t in range(1, 30)]
    assert s.as_dict() == j.as_dict()
    assert s.describe() == j.describe()
    f, jf = (DeferSchedule.fixed(intervals[-1], names, overlap=overlap),
             JDeferSchedule.fixed(intervals[-1], names, overlap=overlap))
    assert f == DeferSchedule(f.level_names, f.intervals, overlap=overlap)
    assert (f.level_names, f.intervals) == (jf.level_names, jf.intervals)


def test_defer_schedule_rejects_what_jax_rejects():
    for names, intervals in ((("a", "b"), (3, 4)), (("a",), (0,)),
                             ((), ()), (("a", "b"), (2,))):
        with pytest.raises(ValueError):
            JDeferSchedule(names, intervals)
        with pytest.raises(ValueError):
            DeferSchedule(names, intervals)


def _codec_inputs():
    rng = np.random.default_rng(11)
    out = [rng.standard_normal((6, 5)).astype(np.float32) * 3,
           rng.standard_normal((128,)).astype(np.float32) * 1e-3,
           rng.integers(-300, 300, (4, 4, 2)).astype(np.float32),
           np.zeros((3, 2), np.float32),
           np.asarray(2.5, np.float32)]
    # amax 127 makes the scale exactly 1, so these sit on rounding ties
    # (half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
    out.append(np.asarray([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                          np.float32))
    return out


@pytest.mark.parametrize("i", range(6))
def test_int8_codec_encode_decode_bitwise_against_jax(i):
    u = _codec_inputs()[i]
    port, ref = mf.int8_compressed_add(), jmf.int8_compressed_add()
    wire = port.encode(torch.from_numpy(u))
    jwire = ref.encode(jnp.asarray(u))
    assert wire["q"].dtype == torch.int8 and wire["scale"].dtype == \
        torch.float32 and wire["scale"].dim() == 0
    np.testing.assert_array_equal(wire["q"].numpy(), np.asarray(jwire["q"]))
    assert wire["scale"].numpy().tobytes() == \
        np.asarray(jwire["scale"]).tobytes()
    got = port.decode(wire)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.decode(jwire)))
    # the round trip is within half a quantization step
    assert np.all(np.abs(got.numpy() - u) <= wire["scale"].item() / 2 + 1e-6)
    if i == 5:
        assert wire["q"].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_registry_names_ids_and_standard_merges_equal_jax():
    reg, jreg = mf.default_registry(), jmf.default_registry()
    assert [fn.name for fn in reg] == [fn.name for fn in jreg]
    assert len(reg) == len(jreg) == 6
    for fn in jreg:
        assert reg.id_of(fn.name) == jreg.id_of(fn.name)
        assert reg[fn.name].name == fn.name and fn.name in reg
        assert reg[reg.id_of(fn.name)] is reg[fn.name]
    assert reg.merge_init(mf.MAX) == jreg.merge_init(jmf.MAX) == 1
    assert reg.merge_init(mf.saturating_add(8.0)) == \
        jreg.merge_init(jmf.saturating_add(8.0)) == 6
    std, jstd = mf.standard_merges(), jmf.standard_merges()
    assert [fn.name for fn in std] == [fn.name for fn in jstd]
    for fn, jfn in zip(std, jstd):
        for trait in TRAITS:
            assert getattr(fn, trait) == getattr(jfn, trait), (fn.name, trait)
    small = mf.MergeFunctionRegistry(capacity=2)
    small.merge_init(mf.ADD)
    small.merge_init(mf.MAX)
    with pytest.raises(ValueError, match="full"):
        small.merge_init(mf.MIN)


def _drop(p, u, mem, seed):
    g = torch.Generator().manual_seed(seed)
    return mf.dropping_add(p).tree_apply({"m": mem}, {"m": u}, key=g)["m"]


def test_dropping_add_by_its_laws():
    """The Bernoulli draw cannot match JAX's bits, so the merge is held to
    its laws: drop_prob 0 and 1 are exact, the kept fraction lies within a
    binomial bound, and one generator seed gives one result."""
    rng = np.random.default_rng(0)
    n = 20000
    u = torch.from_numpy(rng.integers(1, 9, n).astype(np.float32))
    mem = torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32))
    assert torch.equal(_drop(0.0, u, mem, 1), mem + u)
    assert torch.equal(_drop(1.0, u, mem, 1), mem)
    for p in (0.1, 0.5, 0.9):
        out = _drop(p, u, mem, 7)
        kept = out != mem
        # every element is either dropped or kept whole
        assert torch.equal(out[kept], (mem + u)[kept])
        frac = kept.double().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        assert abs(frac - (1 - p)) < 5 * sigma, (p, frac)
        assert torch.equal(_drop(p, u, mem, 7), out)
        assert not torch.equal(_drop(p, u, mem, 8), out)
    with pytest.raises(ValueError, match="key"):
        mf.dropping_add(0.5).tree_apply(mem, u)
    with pytest.raises(ValueError, match="cannot defer"):
        mf.dropping_add(0.5).check_deferrable("ctx")


def test_tree_apply_draws_each_leaf_from_the_generator_in_turn():
    u = torch.ones(4096)
    g = torch.Generator().manual_seed(3)
    out = mf.dropping_add(0.5).tree_apply([torch.zeros(4096)] * 2, [u, u],
                                          key=g)
    assert not torch.equal(out[0], out[1])      # not one mask for both
    g2 = torch.Generator().manual_seed(3)
    first = mf.dropping_add(0.5).apply(torch.zeros(4096), u, key=g2)
    assert torch.equal(out[0], first)
