"""The port's apps (BFS / PageRank / k-means) on the stacked layout against
the JAX package's apps under ``jax.vmap(axis_name=...)``, on the same numpy
inputs and at ``tests/test_apps_sharded.py``'s sizes.

The JAX apps scatter through the jnp oracle ``ref_cscatter`` under vmap, as
their own tests do; the port's run the plain ``cscatter`` on the CPU.

* BFS (integer MIN): bitwise against JAX ``run_bfs`` and ``bfs_reference``,
  every shard's view, with and without the trailing flush;
* PageRank (f32 ADD): against JAX ``run_pagerank`` to rtol 1e-5 (f32
  summation order: the port sums a row's contributions in another order
  than ``ref_cscatter``), and against the float64 reference to the JAX
  test's bounds;
* k-means (f32 ADD through ``defer_cascade`` / ``overlap_cascade``):
  against JAX ``run_kmeans`` and the schedule mirror to the JAX test's
  2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import bfs as jbfs
from repro.apps import common as jcommon
from repro.apps import kmeans as jkmeans
from repro.apps import pagerank as jpagerank
from repro_torch import apps
from repro_torch.apps import bfs, common, kmeans, pagerank
from repro_torch.apps.sharded import run_app
from repro_torch.kernels.cscatter import cscatter

AXIS = "shards"
S = 8


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name=AXIS)(*args)


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    # self-sources keep every vertex out-connected (degree >= 1)
    src = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, n)])
    return src.astype(np.int32), dst.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_apps_export_what_the_jax_package_exports():
    import repro.apps as japps
    public = {n for n in dir(japps) if not n.startswith("_")
              and callable(getattr(japps, n))}
    assert public <= {n for n in dir(apps) if callable(getattr(apps, n))}


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("defer_top", [False, True])
def test_default_plan_equals_jax(n_shards, defer_top):
    got = common.default_plan(n_shards, defer_top=defer_top)
    want = jcommon.default_plan(n_shards, defer_top=defer_top)
    assert [(lv.name, lv.size, lv.defer) for lv in got.levels] == \
        [(lv.name, lv.size, lv.defer) for lv in want.levels]
    assert got.lane_parallel == want.lane_parallel


@pytest.mark.parametrize("e,n_shards", [(64, 8), (67, 8), (5, 8), (96, 3),
                                        (0, 4)])
def test_shard_edges_equals_jax(e, n_shards):
    src, dst = _graph(12, e, e)
    got = common.shard_edges(src, dst, n_shards)
    want = jcommon.shard_edges(src, dst, n_shards)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        assert g.shape[0] == n_shards
        np.testing.assert_array_equal(g, w)
    # padding is -1 at the tail and nothing else is lost
    flat = got[0].reshape(-1)
    assert (flat[len(src):] == -1).all()
    np.testing.assert_array_equal(flat[:len(src)], src)


def test_bfs_superstep_matches_jax():
    n, e = 24, 64
    src, dst = _graph(n, e, 4)
    src_sh, dst_sh = common.shard_edges(src, dst, S)
    rng = np.random.default_rng(4)
    dist = np.where(rng.random((S, n)) < 0.3, rng.integers(0, 5, (S, n)),
                    bfs.INF).astype(np.int32)
    got = bfs.bfs_superstep(_t(dist), _t(src_sh), _t(dst_sh))
    want = _vmap(jbfs.bfs_superstep, dist, src_sh, dst_sh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bfs_inputs(n, e, seed):
    src, dst = _graph(n, e, seed)
    src_sh, dst_sh = common.shard_edges(src, dst, S)
    dist0 = np.full((S, n), bfs.INF, np.int32)
    dist0[:, 0] = 0
    return src, dst, src_sh, dst_sh, dist0


def test_bfs_eager_bitwise_against_jax_and_the_reference():
    n, e = 24, 64
    src, dst, src_sh, dst_sh, dist0 = _bfs_inputs(n, e, 0)
    ref = bfs.bfs_reference(n, src, dst, 0)
    np.testing.assert_array_equal(ref, jbfs.bfs_reference(n, src, dst, 0))
    plan = common.default_plan(S)
    d0 = _t(dist0)
    got = bfs.run_bfs(d0, _t(src_sh), _t(dst_sh), plan, supersteps=n)
    want = jbfs.run_bfs(jnp.asarray(dist0), jnp.asarray(src_sh),
                        jnp.asarray(dst_sh), _vmap,
                        jcommon.default_plan(S), AXIS, supersteps=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(ref, got.shape))
    np.testing.assert_array_equal(d0.numpy(), dist0)  # the caller's input


@pytest.mark.parametrize("supersteps", [5 * 24, 5 * 24 + 3])
def test_bfs_deferred_bitwise_against_jax_and_the_reference(supersteps):
    """defer_k = 5; 123 supersteps end on a partial cycle, so the trailing
    flush runs."""
    n, e = 24, 64
    src, dst, src_sh, dst_sh, dist0 = _bfs_inputs(n, e, 0)
    ref = bfs.bfs_reference(n, src, dst, 0)
    got = bfs.run_bfs(_t(dist0), _t(src_sh), _t(dst_sh),
                      common.default_plan(S, defer_top=True),
                      supersteps=supersteps, defer_k=5)
    want = jbfs.run_bfs(jnp.asarray(dist0), jnp.asarray(src_sh),
                        jnp.asarray(dst_sh), _vmap,
                        jcommon.default_plan(S, defer_top=True), AXIS,
                        supersteps=supersteps, defer_k=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every shard holds the fully merged view
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(ref, got.shape))


def test_bfs_deferred_partial_cycle_matches_jax_before_it_converges():
    """Few supersteps: the distances are still moving, so the flush and the
    per-pod views are what the comparison sees."""
    n, e = 24, 40
    src, dst, src_sh, dst_sh, dist0 = _bfs_inputs(n, e, 7)
    for supersteps in (1, 2, 3, 6, 7):
        got = bfs.run_bfs(_t(dist0), _t(src_sh), _t(dst_sh),
                          common.default_plan(S, defer_top=True),
                          supersteps=supersteps, defer_k=4)
        want = jbfs.run_bfs(jnp.asarray(dist0), jnp.asarray(src_sh),
                            jnp.asarray(dst_sh), _vmap,
                            jcommon.default_plan(S, defer_top=True), AXIS,
                            supersteps=supersteps, defer_k=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{supersteps} supersteps")


def test_pagerank_superstep_and_degree_match_jax():
    n, e = 24, 96
    src, dst = _graph(n, e, 1)
    src_sh, dst_sh = common.shard_edges(src, dst, S)
    rng = np.random.default_rng(1)
    r = rng.random((S, n)).astype(np.float32)
    deg = rng.integers(0, 6, (S, n)).astype(np.float32)
    got = pagerank.pagerank_superstep(_t(r), _t(src_sh), _t(dst_sh), _t(deg),
                                      alpha=0.85)
    want = _vmap(lambda a, b, c, d: jpagerank.pagerank_superstep(
        a, b, c, d, alpha=0.85), r, src_sh, dst_sh, deg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    from repro_torch.core.stacked import StackedAxis
    got_deg = pagerank._out_degree(n, _t(src_sh), StackedAxis(S, "cpu"),
                                   common.default_plan(S))
    want_deg = _vmap(lambda x: jpagerank._out_degree(
        n, x, AXIS, jcommon.default_plan(S), False), src_sh)
    np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))


def test_pagerank_eager_and_deferred_against_jax_and_the_reference():
    n, e = 24, 96
    alpha, k = 0.5, 4
    src, dst = _graph(n, e, 1)
    src_sh, dst_sh = common.shard_edges(src, dst, S)
    ts, td = _t(src_sh), _t(dst_sh)
    js, jd = jnp.asarray(src_sh), jnp.asarray(dst_sh)

    iters = 32
    ref = pagerank.pagerank_reference(n, src, dst, alpha=alpha, iters=iters)
    np.testing.assert_array_equal(ref, jpagerank.pagerank_reference(
        n, src, dst, alpha=alpha, iters=iters))
    eager = pagerank.run_pagerank(n, ts, td, common.default_plan(S),
                                  alpha=alpha, supersteps=iters)
    jeager = jpagerank.run_pagerank(n, js, jd, _vmap,
                                    jcommon.default_plan(S), AXIS,
                                    alpha=alpha, supersteps=iters)
    np.testing.assert_allclose(eager.numpy(), np.asarray(jeager), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(eager[0].numpy().astype(np.float64), ref,
                               rtol=1e-4, atol=1e-6)

    # deferred: the stale remote term converges to the same fixpoint
    iters_d = 16 * k
    ref_d = pagerank.pagerank_reference(n, src, dst, alpha=alpha,
                                        iters=iters_d)
    plan_d = common.default_plan(S, defer_top=True)
    defer = pagerank.run_pagerank(n, ts, td, plan_d, alpha=alpha,
                                  supersteps=iters_d, defer_k=k)
    jdefer = jpagerank.run_pagerank(n, js, jd, _vmap,
                                    jcommon.default_plan(S, defer_top=True),
                                    AXIS, alpha=alpha, supersteps=iters_d,
                                    defer_k=k)
    np.testing.assert_allclose(defer.numpy(), np.asarray(jdefer), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(defer[0].numpy().astype(np.float64), ref_d,
                               rtol=2e-3, atol=1e-6)


def test_pagerank_deferred_rounds_up_to_a_commit_step_as_jax():
    """6 supersteps at K = 4 run 8, ending on a commit: every shard holds
    the merged view, equal to JAX's."""
    n, e = 24, 96
    src, dst = _graph(n, e, 5)
    src_sh, dst_sh = common.shard_edges(src, dst, S)
    got = pagerank.run_pagerank(n, _t(src_sh), _t(dst_sh),
                                common.default_plan(S, defer_top=True),
                                alpha=0.85, supersteps=6, defer_k=4)
    want = jpagerank.run_pagerank(n, jnp.asarray(src_sh), jnp.asarray(dst_sh),
                                  _vmap,
                                  jcommon.default_plan(S, defer_top=True),
                                  AXIS, alpha=0.85, supersteps=6, defer_k=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(got[0], got.shape),
                               rtol=1e-6, atol=1e-9)


def test_kmeans_step_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(S, 16, 3)).astype(np.float32)
    c = rng.normal(size=(S, 5, 3)).astype(np.float32)
    got = kmeans.kmeans_step(_t(pts), _t(c))
    want = _vmap(jkmeans.kmeans_step, pts, c)
    np.testing.assert_array_equal(
        kmeans._assign(_t(pts), _t(c)).numpy(),
        np.asarray(_vmap(jkmeans._assign, pts, c)))
    for name in ("sum", "count"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("commit_k,overlap", [(4, False), (4, True),
                                              (2, True)])
def test_kmeans_against_jax_and_the_schedule_mirror(commit_k, overlap):
    n_shards, k, d, b, t = 8, 4, 3, 8, 8
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(n_shards, t, b, d)).astype(np.float32)
    c0 = rng.normal(size=(k, d)).astype(np.float32)
    pts_ref = pts.transpose(1, 0, 2, 3).reshape(t, n_shards * b, d)

    ref = kmeans.kmeans_reference(pts_ref, c0, commit_k=commit_k,
                                  overlap=overlap)
    np.testing.assert_array_equal(ref, jkmeans.kmeans_reference(
        pts_ref, c0, commit_k=commit_k, overlap=overlap))
    got = kmeans.run_kmeans(_t(pts), _t(c0),
                            common.default_plan(n_shards, defer_top=True),
                            commit_k=commit_k, overlap=overlap)
    want = jkmeans.run_kmeans(jnp.asarray(pts), jnp.asarray(c0), _vmap,
                              jcommon.default_plan(n_shards, defer_top=True),
                              AXIS, commit_k=commit_k, overlap=overlap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # centroids replicated across shards, equal to the mirror
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(ref, got.shape),
                               rtol=2e-5, atol=2e-5)


def test_app_drivers_validate_plans():
    plan = common.default_plan(S)  # no :defer levels
    dist0 = torch.full((S, 4), bfs.INF, dtype=torch.int32)
    edges = torch.zeros((S, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="deferred"):
        bfs.run_bfs(dist0, edges, edges, plan, supersteps=1, defer_k=2)
    with pytest.raises(ValueError, match="deferred"):
        pagerank.run_pagerank(4, edges, edges, plan, supersteps=1, defer_k=2)
    pts = torch.zeros((S, 4, 2, 3))
    c0 = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="defer"):
        kmeans.run_kmeans(pts, c0, plan, commit_k=2)
    with pytest.raises(ValueError, match="multiple"):
        kmeans.run_kmeans(pts, c0, common.default_plan(S, defer_top=True),
                          commit_k=3)


def _count_scatters(monkeypatch, module):
    calls = [0]
    real = module.scatter

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    monkeypatch.setattr(module, "scatter", counted)
    return calls


def test_scatter_calls_follow_the_schedule(monkeypatch):
    """One scatter call (two ``cscatter`` launches on the card) a BFS
    superstep for all shards; one for the degrees plus one a superstep for
    PageRank; two a k-means step. ``chip_smoke.py`` holds the card's
    launch counts to the same schedule."""
    n, e = 24, 64
    src, dst, src_sh, dst_sh, dist0 = _bfs_inputs(n, e, 0)
    ts, td = _t(src_sh), _t(dst_sh)
    plan_d = common.default_plan(S, defer_top=True)
    calls = _count_scatters(monkeypatch, bfs)
    bfs.run_bfs(_t(dist0), ts, td, plan_d, supersteps=11, defer_k=4)
    assert calls[0] == 11
    calls = _count_scatters(monkeypatch, pagerank)
    pagerank.run_pagerank(n, ts, td, plan_d, supersteps=10, defer_k=4)
    assert calls[0] == 1 + 12                    # rounded up to a commit
    calls = _count_scatters(monkeypatch, kmeans)
    pts = torch.zeros((S, 4, 2, 3))
    kmeans.run_kmeans(pts, torch.ones((2, 3)), plan_d, commit_k=2,
                      overlap=True)
    assert calls[0] == 2 * 4
    assert cscatter.launches == 0            # the CPU runs the plain version


def test_run_app_on_the_cpu_within_the_jax_acceptance_bounds():
    """``run_app`` at its own defaults, the JAX slow test's bounds:
    bitwise BFS, PageRank within 1e-4, k-means within 1e-3."""
    out = {app: run_app(app, S, device="cpu")
           for app in ("bfs", "pagerank", "kmeans")}
    assert out["bfs"] == {"app": "bfs", "n_shards": S, "defer_k": 4,
                          "eager_max_err": 0.0, "defer_max_err": 0.0,
                          "bitwise": True}
    assert out["pagerank"]["eager_max_err"] < 1e-4
    assert out["pagerank"]["defer_max_err"] < 1e-4
    assert not out["pagerank"]["bitwise"]
    assert out["kmeans"]["defer_max_err"] < 1e-3
    assert out["kmeans"]["overlap_max_err"] < 1e-3
    assert out["kmeans"]["eager_max_err"] == out["kmeans"]["defer_max_err"]
    with pytest.raises(ValueError, match="unknown app"):
        run_app("sssp", S, device="cpu")


def test_run_app_runs_on_the_card_unless_the_caller_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_app("bfs", S)
