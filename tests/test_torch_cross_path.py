"""The four-path differential suite of ``tests/test_cross_path.py`` on the
port, held against the same paths of the JAX engine under
``jax.vmap(axis_name=...)``, on the same numpy inputs.

The engine has four ways to produce "the combination of all ranks'
updates": the flat ``tree_merge``, the compiled-plan
``hierarchical_merge``, the scheduled ``defer_cascade`` and the overlapped
``overlap_cascade`` launch/land pipeline. On every case each port path must
agree

* with the port's flat merge, to the reference suite's tolerances: exact
  for ADD/MAX/MIN on integer-valued floats and for BITWISE_OR on int32
  bitmaps; rtol 1e-4 / atol 1e-5 for COMPLEX_MUL (multiplication
  reordering); rtol 0.05 / atol 6 for the int8-compressed wire (per-round
  quantization);
* with the same path of the JAX engine: exact for the integer-valued and
  bitmap merges, rtol 1e-5 / atol 1e-6 for COMPLEX_MUL (f32 rounding of
  the same products, which XLA may contract), and within one quantization
  step of the last round (``max |sum| / 127``) for the compressed wire.

The cases are drawn once from a fixed seed (the reference draws them with
hypothesis), so every run checks the same ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccache as jcc
from repro.core import merge_functions as jmf
from repro.core.merge_plan import MergePlan as JMergePlan
from repro_torch.core import ccache
from repro_torch.core import merge_functions as mf
from repro_torch.core.merge_plan import MergePlan
from repro_torch.core.stacked import StackedAxis

AX = "cores"

TOPOLOGIES = [
    (2, 2), (2, 4), (4, 2), (2, 3), (3, 2), (4, 4),
    (2, 2, 2), (2, 2, 3), (2, 3, 2), (4, 2, 2), (2, 2, 4),
]
MERGE_NAMES = ["add", "max", "min", "or", "complex_mul"]


def _cases(n=30):
    rng = np.random.default_rng(20240611)
    out = []
    for i in range(n):
        sizes = TOPOLOGIES[rng.integers(len(TOPOLOGIES))]
        name = MERGE_NAMES[i % len(MERGE_NAMES)]
        compressed = name == "add" and bool(rng.integers(2))
        n_defer = min(int(rng.integers(0, 3)), len(sizes) - 1)
        out.append((int(rng.integers(10**6)), sizes, name,
                    bool(rng.integers(2)), compressed, n_defer))
    return out


def _plan_spec(sizes, n_defer):
    parts = []
    for i, s in enumerate(sizes):
        flags = ":defer" if i >= len(sizes) - n_defer else ""
        parts.append(f"l{i}:{s}{flags}")
    return ",".join(parts)


def _updates(merge_name, seed, size):
    rng = np.random.default_rng(seed)
    if merge_name == "complex_mul":
        # Near-identity complex factors keep products well-conditioned.
        base = (rng.normal(size=(size, 3, 2)) * 0.1).astype(np.float32)
        one = np.asarray([1.0, 0.0], np.float32)
        return {"a": base + one, "b": base[:, :2] * np.float32(0.5) + one}
    if merge_name == "or":
        bits = rng.integers(0, 1 << 15, (size, 2, 5)).astype(np.int32)
        return {"a": bits, "b": (bits[:, 0, :3] << 3).astype(np.int32)}
    # Integer-valued floats: ADD/MAX/MIN reassociate exactly.
    ints = rng.integers(-8, 9, (size, 2, 5))
    return {"a": ints.astype(np.float32),
            "b": (ints[:, 0, :3] * 2).astype(np.float32)}


MERGES = {"add": (mf.ADD, jmf.ADD), "max": (mf.MAX, jmf.MAX),
          "min": (mf.MIN, jmf.MIN), "or": (mf.BITWISE_OR, jmf.BITWISE_OR),
          "complex_mul": (mf.COMPLEX_MUL, jmf.COMPLEX_MUL)}


def _merges_and_tols(name, compressed):
    if compressed:
        return (mf.int8_compressed_add(), jmf.int8_compressed_add(),
                dict(rtol=0.05, atol=6.0))
    port, ref = MERGES[name]
    tols = (dict(rtol=1e-4, atol=1e-5) if name == "complex_mul"
            else dict(rtol=0, atol=0))
    return port, ref, tols


def _close(got, want, tols, what):
    for key in sorted(want):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if tols["rtol"] == 0 and tols["atol"] == 0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} [{key}]")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{what} [{key}]",
                                       **tols)


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name=AX)(*args)


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("seed,sizes,merge_name,lane,compressed,n_defer",
                         _cases())
def test_all_merge_paths_agree_with_each_other_and_with_jax(
        seed, sizes, merge_name, lane, compressed, n_defer):
    port, ref, tols = _merges_and_tols(merge_name, compressed)
    size = int(np.prod(sizes))
    spec = _plan_spec(sizes, n_defer)
    plan = MergePlan.parse(spec, lane_parallel=lane)
    jplan = JMergePlan.parse(spec, lane_parallel=lane)
    upds = _updates(merge_name, seed, size)
    axis = StackedAxis(size, "cpu")

    # Path 1: flat recursive doubling (uncompressed: the exact combination)
    flat = _np(ccache.tree_merge(_t(upds), axis, port))
    jflat = _vmap(lambda u: jcc.tree_merge(u, AX, ref), upds)
    vs_jax = (dict(rtol=1e-5, atol=1e-6) if merge_name == "complex_mul"
              else dict(rtol=0, atol=0))
    _close(flat, jflat, vs_jax, "tree_merge vs JAX")
    if compressed:
        # one quantization step of the last round: amax / 127
        step = max(np.abs(v).max() for v in flat.values()) / 127.0
        vs_jax = dict(rtol=0, atol=step)

    # Path 2: compiled-plan hierarchical merge (all levels eager)
    hier = _np(ccache.hierarchical_merge(_t(upds), axis, port, plan,
                                         compress=compressed))
    _close(hier, flat, tols, "hierarchical_merge vs tree_merge")
    _close(hier, _vmap(lambda u: jcc.hierarchical_merge(
        u, AX, ref, jplan, compress=compressed), upds), vs_jax,
        "hierarchical_merge vs JAX")

    n_def = len(ccache.deferred_stages_of(plan, size))
    assert n_def == len(jcc.deferred_stages_of(jplan, size))
    if n_def == 0:
        return

    # Path 3: the scheduled cascade, one full-commit cycle (due = all)
    ident = port.tree_identity(_t(upds))
    jident = _vmap(lambda u: ref.tree_identity(u), upds)
    _, settled = ccache.defer_cascade(_t(upds), [ident] * n_def, n_def, axis,
                                      port, plan, compress=compressed)
    _, jsettled = _vmap(lambda u, *p: jcc.defer_cascade(
        u, list(p), n_def, AX, ref, jplan, compress=compressed),
        upds, *[jident] * n_def)
    _close(_np(settled), flat, tols, "defer_cascade vs tree_merge")
    _close(_np(settled), jsettled, vs_jax, "defer_cascade vs JAX")

    # Path 4: overlapped launch (full-commit step), land via settle_inflight
    new_p, launched, landed = ccache.overlap_cascade(
        _t(upds), [ident] * n_def, ident, n_def, False, axis, port, plan,
        compress=compressed)
    assert landed is None
    _, jlaunched = _vmap(lambda u, inf, *p: jcc.overlap_cascade(
        u, list(p), inf, n_def, False, AX, ref, jplan,
        compress=compressed)[:2], upds, jident, *[jident] * n_def)
    _close(_np(launched), jlaunched, vs_jax, "overlap launch vs JAX")
    landed = ccache.settle_inflight(launched, axis, port, plan,
                                    compress=compressed)
    _close(_np(landed), flat, tols, "overlap launch/land vs tree_merge")

    # The land half through overlap_cascade's land flag, with a zero delta
    # so only the landing is seen, agrees with the standalone settle.
    _, new_inf, landed2 = ccache.overlap_cascade(
        port.tree_identity(_t(upds)), new_p, launched, 0, True, axis, port,
        plan, compress=compressed)
    _close(_np(landed2), flat, tols, "overlap_cascade land vs tree_merge")
    _close(_np(landed2), _np(landed), dict(rtol=0, atol=0),
           "overlap_cascade land vs settle_inflight")
    _close(_np(new_inf), _np(ident), dict(rtol=0, atol=0),
           "inflight reset after landing")


def test_cross_path_two_cycle_add_exact():
    """Two full cycles through the cascade and overlap paths both equal two
    eager cycle sums, bitwise, on integer-valued floats — and JAX's."""
    size, K = 8, 2
    T = 2 * K
    plan = MergePlan.parse("l0:2,l1:2,l2:2:defer", lane_parallel=True)
    jplan = JMergePlan.parse("l0:2,l1:2,l2:2:defer", lane_parallel=True)
    upds = np.random.default_rng(3).integers(
        -8, 9, (T, size, 4)).astype(np.float32)
    axis = StackedAxis(size, "cpu")

    def eager_cycle(lo, hi):
        return sum(ccache.tree_merge(torch.from_numpy(upds[t]), axis, mf.ADD)
                   for t in range(lo, hi))

    pend = torch.zeros((size, 4))
    jpend = np.zeros((size, 4), np.float32)
    cascade, jcascade = [], []
    for t in range(1, T + 1):
        due = 1 if t % K == 0 else 0
        (pend,), settled = ccache.defer_cascade(
            torch.from_numpy(upds[t - 1]), [pend], due, axis, mf.ADD, plan)
        jpend, jsettled = _vmap(lambda g, p: (lambda o: (o[0][0], o[1]))(
            jcc.defer_cascade(g, [p], due, AX, jmf.ADD, jplan)),
            upds[t - 1], jpend)
        if due:
            cascade.append(settled)
            jcascade.append(np.asarray(jsettled))

    pend, inflight = torch.zeros((size, 4)), torch.zeros((size, 4))
    overlap = []
    for t in range(1, T + 1):
        due = 1 if t % K == 0 else 0
        land = t > 1 and (t - 1) % K == 0
        (pend,), inflight, landed = ccache.overlap_cascade(
            torch.from_numpy(upds[t - 1]), [pend], inflight, due, land, axis,
            mf.ADD, plan)
        if land:
            overlap.append(landed)
    # the final launched cycle lands after the loop (the flush)
    overlap.append(ccache.settle_inflight(inflight, axis, mf.ADD, plan))

    for c, (lo, hi) in enumerate([(0, K), (K, T)]):
        want = eager_cycle(lo, hi).numpy()
        np.testing.assert_array_equal(cascade[c].numpy(), want,
                                      err_msg=f"cascade cycle {c}")
        np.testing.assert_array_equal(jcascade[c], want,
                                      err_msg=f"JAX cascade cycle {c}")
        np.testing.assert_array_equal(overlap[c].numpy(), want,
                                      err_msg=f"overlap cycle {c}")


def test_overlap_cascade_validates_inputs():
    """The same refusals as the JAX engine's
    (``tests/test_cross_path.py::test_overlap_cascade_validates_inputs``)."""
    plan = MergePlan.parse("l0:2,l1:2:defer")
    flat = MergePlan.parse("l0:2,l1:2")
    axis = StackedAxis(4, "cpu")
    z = torch.zeros((4, 3))
    jplan = JMergePlan.parse("l0:2,l1:2:defer")
    jz = jnp.zeros((4, 3))
    for port_call, jax_call, match in (
            (lambda: ccache.overlap_cascade(z, [z, z], z, 0, False, axis,
                                            mf.ADD, plan),
             lambda g: jcc.overlap_cascade(g, [g, g], g, 0, False, AX,
                                           jmf.ADD, jplan), "pendings"),
            (lambda: ccache.overlap_cascade(z, [z], z, 2, False, axis,
                                            mf.ADD, plan),
             lambda g: jcc.overlap_cascade(g, [g], g, 2, False, AX,
                                           jmf.ADD, jplan), "due"),
            (lambda: ccache.overlap_cascade(z, [], z, 0, False, axis,
                                            mf.ADD, flat),
             lambda g: jcc.overlap_cascade(g, [], g, 0, False, AX, jmf.ADD,
                                           JMergePlan.parse("l0:2,l1:2")),
             "no deferred"),
            (lambda: ccache.settle_inflight(z, axis, mf.ADD, flat),
             lambda g: jcc.settle_inflight(g, AX, jmf.ADD,
                                           JMergePlan.parse("l0:2,l1:2")),
             "no deferred")):
        with pytest.raises(ValueError, match=match):
            port_call()
        with pytest.raises(ValueError, match=match):
            _vmap(jax_call, jz)
    # a degenerate (flat) topology has nothing to defer, in either engine
    with pytest.raises(ValueError, match="degenerate"):
        ccache.overlap_cascade(z, [z], z, 0, False, axis, mf.ADD,
                               ccache.MergeTopology(group_size=1))
    with pytest.raises(ValueError, match="degenerate"):
        _vmap(lambda g: jcc.overlap_cascade(
            g, [g], g, 0, False, AX, jmf.ADD,
            jcc.MergeTopology(group_size=1)), jz)
