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
from repro_torch.core.stacked import StackedAxis, StackedSPMD

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
    stacked_spmd = StackedSPMD(2, "cpu")
    assert torch.equal(stacked_spmd(bump, a, b, donate=(0,)),
                       torch.full((2, 3), 2.0))
    with pytest.raises(RuntimeError, match="not donated"):
        stacked_spmd(bump, a, b)


def test_the_port_has_every_public_name_of_the_jax_engine():
    import inspect
    public = [n for n, v in vars(jcc).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == jcc.__name__]
    assert len(public) >= 25
    missing = [n for n in public if not hasattr(ccache, n)]
    assert not missing, missing


def _floats(rng, size, shape=(5, 3)):
    return (rng.standard_normal((size,) + shape) * 4).astype(np.float32)


def _step_of(x):
    """One quantization step of the last round of a compressed all-reduce:
    ``max |sum| / 127``."""
    return float(np.abs(x.sum(0)).max()) / 127.0


@pytest.mark.parametrize("size,spec,lane", [
    (4, "chip:2,pod:2", False), (8, "chip:2,host:2,pod:2", True),
    (8, "chip:2,host:2,pod:2", False), (6, "chip:2,pod:3", False),
    (6, "chip:3,pod:2", True), (12, "chip:2,host:3,pod:2", True),
    (6, "chip:2,pod:3", True), (8, "chip:4:compress,pod:2", False),
    (6, "chip:3:compress,pod:2", True)])
def test_compressed_hierarchical_merge_matches_jax(size, spec, lane):
    """The int8 wire on the outermost level (the function-level flag) or
    on a level that asks for it, against the JAX engine: within one
    quantization step (the codec is bitwise equal; only the f32 order of a
    round's sums may differ)."""
    rng = np.random.default_rng(size)
    x = _floats(rng, size)
    plan = mp.MergePlan.parse(spec, lane_parallel=lane)
    jplan = jmp.MergePlan.parse(spec, lane_parallel=lane)
    port, ref = mf.int8_compressed_add(), jmf.int8_compressed_add()
    axis = StackedAxis(size, "cpu")
    got = ccache.hierarchical_merge(torch.from_numpy(x), axis, port, plan,
                                    compress=True)
    want = _vmap(lambda v: jcc.hierarchical_merge(v, AX, ref, jplan,
                                                  compress=True), x)
    step = _step_of(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=step)
    # and close to the exact sum: a few steps over the rounds
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(x.sum(0),
                                                            x.shape),
                               rtol=0, atol=4 * step)


@pytest.mark.parametrize("size", [2, 4, 8, 6, 12])
def test_compressed_tree_merge_and_reduce_update_match_jax(size):
    rng = np.random.default_rng(size + 1)
    x = _floats(rng, size)
    port, ref = mf.int8_compressed_add(), jmf.int8_compressed_add()
    axis = StackedAxis(size, "cpu")
    step = _step_of(x)
    got = ccache.tree_merge(torch.from_numpy(x), axis, port, compress=True)
    want = _vmap(lambda v: jcc.tree_merge(v, AX, ref, compress=True), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=step)
    got = ccache.reduce_update(torch.from_numpy(x), axis, port,
                               compress=True)
    want = _vmap(lambda v: jcc.reduce_update(v, AX, ref, compress=True), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=step)
    with pytest.raises(ValueError, match="encode/decode"):
        ccache.tree_merge(torch.from_numpy(x), axis, mf.ADD, compress=True)


@pytest.mark.parametrize("size,kind", [(s, k) for s in (3, 4, 6, 8, 12)
                                       for k in ("add", "max", "or")])
def test_tree_merge_and_reduce_update_match_jax(size, kind):
    """Recursive doubling on a power-of-two axis, the gather-and-fold
    fallback otherwise; integer merges bitwise."""
    rng = np.random.default_rng(size * 3)
    x = _payload(rng, size, kind)
    port, ref = MERGES[kind]
    axis = StackedAxis(size, "cpu")
    _eq(ccache.tree_merge(torch.from_numpy(x), axis, port),
        _vmap(lambda v: jcc.tree_merge(v, AX, ref), x))
    for force_tree in (False, True):
        _eq(ccache.reduce_update(torch.from_numpy(x), axis, port,
                                 force_tree=force_tree),
            _vmap(lambda v: jcc.reduce_update(v, AX, ref,
                                              force_tree=force_tree), x))


@pytest.mark.parametrize("size,group,lane", [
    (8, 2, False), (8, 4, True), (6, 3, False), (6, 2, True), (12, 4, False),
    (8, 1, False), (8, 8, True)])
def test_merge_topology_matches_jax(size, group, lane):
    topo = ccache.MergeTopology(group_size=group, lane_parallel=lane)
    jtopo = jcc.MergeTopology(group_size=group, lane_parallel=lane)
    for compress in (False, True):
        assert dataclasses.asdict(topo.to_plan(size, compress=compress)) == \
            dataclasses.asdict(jtopo.to_plan(size, compress=compress))
    assert topo.groups(size) == jtopo.groups(size)
    rng = np.random.default_rng(size + group)
    axis = StackedAxis(size, "cpu")
    for kind in ("add", "min"):
        x = _payload(rng, size, kind)
        port, ref = MERGES[kind]
        _eq(ccache.hierarchical_merge(torch.from_numpy(x), axis, port, topo),
            _vmap(lambda v: jcc.hierarchical_merge(v, AX, ref, jtopo), x))
        _eq(ccache.reduce_update(torch.from_numpy(x), axis, port,
                                 topology=topo),
            _vmap(lambda v: jcc.reduce_update(v, AX, ref, topology=jtopo), x))
        assert _manifests(ccache.collective_manifest, topo, size, port) == \
            _manifests(jcc.collective_manifest, jtopo, size, ref)
    with pytest.raises(ValueError):
        ccache.MergeTopology(group_size=0).validate(size)
    with pytest.raises(ValueError):
        ccache.MergeTopology(group_size=5).validate(size)


def _defer_plans(size):
    spec = {4: "chip:2,pod:2:defer", 8: "chip:2,host:2,pod:2:defer",
            6: "chip:3,pod:2:defer", 12: "chip:2,host:3:defer,pod:2:defer"}
    return [(mp.MergePlan.parse(spec[size], lane_parallel=lane),
             jmp.MergePlan.parse(spec[size], lane_parallel=lane))
            for lane in (False, True)]


@pytest.mark.parametrize("size,kind", [(s, k) for s in (4, 6, 8, 12)
                                       for k in ("add", "max", "min", "or")])
def test_partial_merge_and_deferred_commits_match_jax(size, kind):
    """``partial_merge`` (eager levels only), ``soft_merge`` with a plan,
    then ``commit_launch`` / ``commit_land`` / ``commit_deferred``, and the
    plan-less ``soft_merge`` + ``commit``: bitwise against the JAX engine,
    and the deferred commit equal to one eager merge of the same deltas."""
    port, ref = MERGES[kind]
    rng = np.random.default_rng(size * 7 + len(kind))
    axis = StackedAxis(size, "cpu")
    mem = _payload(rng, size, kind)[:1].repeat(size, 0)  # replicated memory
    deltas = [_payload(rng, size, kind) for _ in range(3)]
    for plan, jplan in _defer_plans(size):
        _eq(ccache.partial_merge(torch.from_numpy(deltas[0]), axis, port,
                                 plan),
            _vmap(lambda v: jcc.partial_merge(v, AX, ref, jplan), deltas[0]))
        # soft_merge over three steps: views whose upd moves by each delta
        pend, jpend = None, None
        upd = torch.from_numpy(mem)
        view = ccache.privatize(upd)
        for d in deltas:
            view = ccache.c_update(
                view, lambda u, d=d: port.combine(u, torch.from_numpy(d)))
            view, pend = ccache.soft_merge(view, pend, port, axis, plan=plan)
            assert torch.equal(view.src, view.upd)

        def jsoft(m, *ds):
            v, p = jcc.privatize(m), None
            for d in ds:
                v = jcc.c_update(v, lambda u, d=d: ref.combine(u, d))
                v, p = jcc.soft_merge(v, p, ref, AX, plan=jplan)
            return p.update
        _eq(pend.update, _vmap(jsoft, mem, *deltas))

        inflight = ccache.commit_launch(pend, axis, port, plan)
        landed = ccache.commit_land(inflight, torch.from_numpy(mem), port)
        full = ccache.commit_deferred(pend, torch.from_numpy(mem), axis, port,
                                      plan)
        _eq(landed, full.numpy())

        def jcommit(m, *ds):
            p = jcc.PendingUpdate(update=jsoft(m, *ds))
            return jcc.commit_deferred(p, m, AX, ref, jplan)
        _eq(full, _vmap(jcommit, mem, *deltas))

    # plan-less: soft_merge coalesces locally, commit runs the full merge
    pend = None
    view = ccache.privatize(torch.from_numpy(mem))
    for d in deltas:
        view = ccache.c_write(view, port.combine(ccache.c_read(view),
                                                 torch.from_numpy(d)))
        view, pend = ccache.soft_merge(view, pend, port)
    got = ccache.commit(pend, torch.from_numpy(mem), axis, port)

    def jplain(m, *ds):
        v, p = jcc.privatize(m), None
        for d in ds:
            v = jcc.c_write(v, ref.combine(jcc.c_read(v), d))
            v, p = jcc.soft_merge(v, p, ref)
        return jcc.commit(p, m, AX, ref)
    _eq(got, _vmap(jplain, mem, *deltas))


@pytest.mark.parametrize("size,kind", [(s, k) for s in (4, 6, 8)
                                       for k in ("add", "max", "or")])
def test_merge_of_a_view_matches_jax(size, kind):
    port, ref = MERGES[kind]
    rng = np.random.default_rng(size + 40)
    axis = StackedAxis(size, "cpu")
    mem = _payload(rng, size, kind)[:1].repeat(size, 0)
    new = _payload(rng, size, kind)
    plan, jplan = _defer_plans(size)[1]
    for topo, jtopo in ((None, None), (plan, jplan)):
        view = ccache.c_write(ccache.privatize(torch.from_numpy(mem)),
                              torch.from_numpy(new))
        got = ccache.merge(view, torch.from_numpy(mem), axis, port,
                           topology=topo)
        want = _vmap(lambda m, n: jcc.merge(
            jcc.c_write(jcc.privatize(m), n), m, AX, ref, topology=jtopo),
            mem, new)
        _eq(got, want)


def test_keyed_merge_applies_one_draw_on_every_rank():
    """``dropping_add`` through ``merge``/``commit``: every rank applies the
    same mask (as the reference's ranks do with one replicated key), so
    replicated memory stays replicated; drop_prob 0 is the ADD merge."""
    size = 8
    rng = np.random.default_rng(5)
    axis = StackedAxis(size, "cpu")
    mem = torch.from_numpy(rng.integers(-9, 9, (1, 64, 4)).astype(
        np.float32)).repeat(size, 1, 1)
    new = mem + torch.from_numpy(rng.integers(1, 9, (size, 64, 4)).astype(
        np.float32))
    view = ccache.c_write(ccache.privatize(mem), new)
    out = ccache.merge(view, mem, axis, mf.dropping_add(0.5),
                       key=torch.Generator().manual_seed(1))
    assert torch.equal(out, out[:1].expand_as(out))
    kept = (out != mem)[0]
    assert 0.3 < kept.float().mean().item() < 0.7
    again = ccache.merge(view, mem, axis, mf.dropping_add(0.5),
                         key=torch.Generator().manual_seed(1))
    assert torch.equal(again, out)
    exact = ccache.merge(view, mem, axis, mf.dropping_add(0.0),
                         key=torch.Generator().manual_seed(1))
    assert torch.equal(exact, ccache.merge(view, mem, axis, mf.ADD))
    _, pend = ccache.soft_merge(view, None, mf.dropping_add(0.5))
    landed = ccache.commit(pend, mem, axis, mf.dropping_add(0.5),
                           key=torch.Generator().manual_seed(1))
    assert torch.equal(landed, out)
    with pytest.raises(ValueError, match="key"):
        ccache.merge(view, mem, axis, mf.dropping_add(0.5))
    with pytest.raises(ValueError, match="cannot defer"):
        mp.compile_plan(mp.MergePlan.parse("chip:4,pod:2:defer"), size,
                        merge_fn=mf.dropping_add(0.5))


def test_views_and_pending_updates_are_pytrees():
    """``StackedSPMD`` guards every tensor inside a CView or a
    PendingUpdate it was not given to write."""
    view = ccache.privatize(torch.zeros(2, 3))
    pend = ccache.PendingUpdate(update={"x": torch.zeros(2, 3)})

    def bump(v, p):
        p.update["x"].add_(1)
        return v

    stacked_spmd = StackedSPMD(2, "cpu")
    with pytest.raises(RuntimeError, match="not donated"):
        stacked_spmd(bump, view, pend)
    stacked_spmd(bump, view, pend, donate=(1,))
    assert pend.update["x"].sum().item() == 12
