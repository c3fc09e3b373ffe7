"""Parity of the port's selective SSM (``repro_torch/models/ssm.py``) with
the JAX package's ``repro/models/ssm.py`` on the same numpy inputs and
weights: the causal conv, the chunk scan, the chunked forward and the
decode step. f32 to 1e-5; bf16 to the dense tests' cache tolerances (the
two packages round bf16 products at other places). The scan's plain version
(``kernels/selective_scan.selective_scan_plain``) and its gradients are
held to JAX's chunk loop at 1e-5 (a bf16 ``u``'s own gradient to one bf16
ulp: both round the same f32 sum once); the autograd Function of the
kernels is driven on the CPU with its launches replaced by plain mirrors,
under each remat policy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.module import split_params
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as tscan
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _as_tensor, remat

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
D_MODEL, D_STATE, D_INNER = 32, 4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """These models run thousands of small ops: with a pytest-xdist worker
    per core, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(dtype: str, seed: int = 0):
    """JAX's init as numpy, with nonzero biases so every term counts."""
    p, _ = split_params(jssm.init(jax.random.key(seed), D_MODEL, D_STATE,
                                  D_INNER, getattr(jnp, dtype)))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for leaf, sub in ((p, "conv_b"), (p["dt_proj"], "b")):
        leaf[sub] = (0.1 * rng.standard_normal(leaf[sub].shape)).astype(
            leaf[sub].dtype)
    return p


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(_as_tensor, tree)


def _x(shape, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(jnp.dtype(dtype))


def _close(got, want, dtype, what=""):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_conv1d_causal_matches_jax(dtype, history):
    p = _params(dtype)
    x = _x((2, 9, D_INNER), dtype)
    hist = _x((2, 3, D_INNER), dtype, seed=2) if history else None
    jo, jh = jssm._conv1d_causal(jnp.asarray(p["conv_w"]),
                                 jnp.asarray(p["conv_b"]), jnp.asarray(x),
                                 None if hist is None else jnp.asarray(hist))
    to, th = tssm._conv1d_causal(_as_tensor(p["conv_w"]),
                                 _as_tensor(p["conv_b"]), _as_tensor(x),
                                 None if hist is None else _as_tensor(hist))
    _close(to, jo, dtype, "out")
    _close(th, jh, dtype, "history")


@pytest.mark.parametrize("t", [1, 8, 37, 256])
def test_scan_chunk_matches_jax(t):
    """The log-depth scan against ``associative_scan``, with a carry-in."""
    rng = np.random.default_rng(t)
    da = rng.uniform(0.5, 1.0, (2, t, 6, 3)).astype(np.float32)
    dbx = rng.standard_normal((2, t, 6, 3)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 3)).astype(np.float32)
    jh, jl = jssm._scan_chunk(*map(jnp.asarray, (da, dbx, h0)))
    th, tl = tscan._scan_chunk(*map(torch.from_numpy, (da, dbx, h0)))
    _close(th, jh, "float32", "h")
    _close(tl, jl, "float32", "last")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [16, 512])
def test_apply_seq_matches_jax(dtype, t):
    """One chunk (T < 256) and two (T = 512)."""
    p = _params(dtype)
    x = _x((2, t, D_MODEL), dtype)
    want = jssm.apply_seq(_jax(p), jnp.asarray(x))
    got = tssm.apply_seq(_torch(p), _as_tensor(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """T decode steps chained from the empty state, each step's output
    and the state after it against JAX's."""
    p = _params(dtype)
    jp, tp = _jax(p), _torch(p)
    x = _x((2, 6, D_MODEL), dtype)
    js = jssm.init_state(jp, 2)
    ts = tssm.init_state(tp, 2)
    assert ts.h.dtype == torch.float32 and ts.conv.dtype == getattr(
        torch, dtype)
    for i in range(x.shape[1]):
        jy, js = jssm.decode_step(jp, jnp.asarray(x[:, i:i + 1]), js)
        ty, ts = tssm.decode_step(tp, _as_tensor(x[:, i:i + 1]), ts)
        _close(ty, jy, dtype, f"step {i}")
        _close(ts.h, js.h, dtype, f"h {i}")
        _close(ts.conv, js.conv, dtype, f"conv {i}")


def test_apply_seq_equals_its_decode_steps():
    """The chunked scan and T recurrent steps are the same function (f32),
    and the state the one pass returns is the last step's."""
    tp = _torch(_params("float32"))
    x = torch.from_numpy(_x((2, 12, D_MODEL), "float32"))
    seq, state = tssm.apply_seq_with_state(tp, x)
    st = tssm.init_state(tp, 2)
    outs = []
    for i in range(12):
        y, st = tssm.decode_step(tp, x[:, i:i + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), seq, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(state.h, st.h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.conv, st.conv)


def test_apply_seq_keeps_the_chunk_rule():
    """As JAX: above one chunk, T must be a multiple of it."""
    tp = _torch(_params("float32"))
    with pytest.raises(AssertionError):
        tssm.apply_seq(tp, torch.zeros((1, 300, D_MODEL)))


# ---------------------------------------------------------------------------
# the selective scan's plain version and its autograd Function
# ---------------------------------------------------------------------------

SCAN_B, SCAN_D = 2, 24


def _scan_inputs(t, s, u_dtype, seed=0, dt_shift=0.0):
    """dt (after softplus, of normals + ``dt_shift``), u, b, c, a_log, h0
    and the cotangents dy, dh as numpy: dt in (0, ~3) unshifted, a_log
    near log(1..S) as the init's, so that exp(dt a) spans 1 down to
    ~1e-20."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(SCAN_B, t, SCAN_D) + np.float32(dt_shift)))
    u = f(SCAN_B, t, SCAN_D).astype(jnp.dtype(u_dtype))
    a_log = (np.log(np.arange(1, s + 1, dtype=np.float32))[None]
             + 0.1 * f(SCAN_D, s))
    return (dt, u, f(SCAN_B, t, s), f(SCAN_B, t, s), a_log,
            f(SCAN_B, SCAN_D, s), f(SCAN_B, t, SCAN_D), f(SCAN_B, SCAN_D, s))


def _jax_chunk_loop(dt, u, b, c, a_log, h0, chunk=256):
    """JAX's ``apply_seq`` scan from the scan's inputs: ``_ssm_params``'
    da and dbx, ``_scan_chunk`` chained over chunks, the einsum."""
    a = -jnp.exp(a_log)
    t = dt.shape[1]
    chunk = min(chunk, t)
    h, ys = h0, []
    for i in range(0, t, chunk):
        d_t = dt[:, i:i + chunk]
        da = jnp.exp(d_t[..., None] * a)
        dbx = ((d_t * u[:, i:i + chunk].astype(jnp.float32))[..., None]
               * b[:, i:i + chunk, None, :])
        h_seq, h = jssm._scan_chunk(da, dbx, h)
        ys.append(jnp.einsum("btds,bts->btd", h_seq, c[:, i:i + chunk]))
    return jnp.concatenate(ys, axis=1), h


def _torch_scan(dt, u, b, c, a_log, h0):
    return tscan.selective_scan_plain(dt, u, b, c, -torch.exp(a_log), h0)


SCAN_CASES = [(t, s, u) for t in (64, 256, 512) for s in (4, 16)
              for u in ("float32", "bfloat16")]
SCAN_IDS = [f"T{t}-S{s}-u{'f32' if u == 'float32' else 'bf16'}"
            for t, s, u in SCAN_CASES]


@pytest.mark.parametrize("t,s,u_dtype", SCAN_CASES, ids=SCAN_IDS)
def test_selective_scan_plain_matches_the_jax_chunk_loop(t, s, u_dtype):
    ins = _scan_inputs(t, s, u_dtype)[:6]
    jy, jh = _jax_chunk_loop(*map(jnp.asarray, ins))
    ty, th = _torch_scan(*map(_as_tensor, ins))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy, "float32", "y")
    _close(th, jh, "float32", "h_T")


@pytest.mark.parametrize("t,s,u_dtype", SCAN_CASES, ids=SCAN_IDS)
def test_selective_scan_plain_gradients_match_jax(t, s, u_dtype):
    """d dt, d u, d b, d c and d a_log of ``sum(y dy) + sum(h_T dh)``
    against ``jax.grad``: 1e-5 relative plus 1e-5 of the leaf's largest
    magnitude; a bf16 ``u``'s gradient is bf16 in both, rounded once from
    f32 sums taken in other orders, so it is held to one bf16 ulp (2^-7
    of the value) instead."""
    *ins, dy, dh = _scan_inputs(t, s, u_dtype)
    argnums = (0, 1, 2, 3, 4)

    def jloss(*args):
        y, h = _jax_chunk_loop(*args)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    want = jax.grad(jloss, argnums=argnums)(*map(jnp.asarray, ins))
    targs = [_as_tensor(x).requires_grad_(i in argnums)
             for i, x in enumerate(ins)]
    y, h = _torch_scan(*targs)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (h * torch.from_numpy(dh)).sum(),
                              [targs[i] for i in argnums])
    for name, g, w, x in zip(("dt", "u", "b", "c", "a_log"), got, want,
                             targs):
        w = np.asarray(w, np.float32)
        assert g.dtype == x.dtype
        rtol = 2 ** -7 if (name == "u" and u_dtype == "bfloat16") else 1e-5
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"d {name}")


# The kernels' chunked decomposition, in float64 numpy: per chunk of L steps
# the local scan from zero and the decay product, the carry over chunks,
# each chunk again from its true start (the forward); the adjoint's local
# carries, its reverse carry over chunks and each chunk's reverse walk (the
# backward). The algorithm of csrc/selective_scan.cu, held where no kernel
# runs.


def _chunks(t, length):
    return [range(k, min(t, k + length)) for k in range(0, t, length)]


def _chunked_forward(dt, u, b, c, a, h0, length, with_carry=True):
    """-> (y [B, T, D], h_T, the chunks' start states [B, nc + 1, D, S]).
    A chunk's decay product is exp(a sum_t dt_t), as the kernel takes it.
    ``with_carry=False`` drops the decayed start state from each chunk's end
    (a wrong carry, to show which inputs can see it)."""
    da = np.exp(dt[..., None] * a)
    dbx = (dt * u)[..., None] * b[:, :, None, :]
    steps = _chunks(dt.shape[1], length)
    local = np.zeros((len(steps),) + h0.shape)
    decay = np.empty_like(local)
    for k, ts in enumerate(steps):
        for t in ts:
            local[k] = da[:, t] * local[k] + dbx[:, t]
        decay[k] = np.exp(dt[:, ts].sum(1)[..., None] * a)
    start = [h0]
    for k in range(len(steps)):
        start.append(decay[k] * start[k] * with_carry + local[k])
    y = np.empty(dt.shape)
    for k, ts in enumerate(steps):
        h = start[k]
        for t in ts:
            h = da[:, t] * h + dbx[:, t]
            y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y, start[-1], np.stack(start, axis=1)


def _chunked_backward(dt, u, b, c, a, start, dy, dh, length,
                      with_carry=True):
    """The gradients of ``sum(y dy) + sum(h_T dh)`` -> (d dt, d u, d b,
    d c, d a, d h0). ``with_carry=False`` drops the decayed carry from each
    chunk's start, as in ``_chunked_forward``."""
    da = np.exp(dt[..., None] * a)
    dbx = (dt * u)[..., None] * b[:, :, None, :]
    steps = _chunks(dt.shape[1], length)
    dyc = dy[..., None] * c[:, :, None, :]
    local = np.zeros((len(steps),) + dh.shape)
    decay = np.ones_like(local)
    for k, ts in enumerate(steps):       # a forward walk from a zero carry
        for t in ts:
            decay[k] *= da[:, t]
            local[k] += decay[k] * dyc[:, t]
    carry, g = [None] * len(steps), dh
    for k in reversed(range(len(steps))):
        carry[k] = g
        g = local[k] + decay[k] * g * with_carry
    ddt, du = np.empty(dt.shape), np.empty(dt.shape)
    db, dc = np.empty(b.shape), np.empty(c.shape)
    d_a = np.zeros(a.shape)
    for k, ts in enumerate(steps):
        hs = [start[:, k]]
        for t in ts:
            hs.append(da[:, t] * hs[-1] + dbx[:, t])
        cr = carry[k]
        for i in reversed(range(len(ts))):
            t = ts[i]
            gt = dyc[:, t] + cr
            gb = (gt * b[:, t, None, :]).sum(-1)
            gha = gt * hs[i] * da[:, t]
            ddt[:, t] = (gha * a).sum(-1) + u[:, t] * gb
            du[:, t] = dt[:, t] * gb
            db[:, t] = (gt * (dt[:, t] * u[:, t])[..., None]).sum(1)
            dc[:, t] = (dy[:, t, :, None] * hs[i + 1]).sum(1)
            d_a += (gha * dt[:, t, :, None]).sum(0)
            cr = da[:, t] * gt
    return ddt, du, db, dc, d_a, g


# dt_shift -5: dt about 0.007, as a trained Mamba-style model's, where a
# chunk's decay product keeps the start state for several chunks; at 0 (the
# init's dt, about 0.8) it is below f32 rounding within one chunk
DECOMP_CASES = [(t, length, s, shift) for t in (300, 512)
                for length in (64, 128) for s in (4, 16)
                for shift in (0.0, -5.0)]
DECOMP_IDS = [f"T{t}-L{n}-S{s}" + ("-small_dt" if shift else "")
              for t, n, s, shift in DECOMP_CASES]


@pytest.mark.parametrize("t,length,s,dt_shift", DECOMP_CASES, ids=DECOMP_IDS)
def test_chunked_forward_matches_the_jax_chunk_loop(t, length, s, dt_shift):
    """y and h_T against JAX's chunk loop (its 256-step chunks'
    associative scans) in f32, to 1e-5; every chunk's start state against
    the plain version's state after the steps before it."""
    dt, u, b, c, a_log, h0 = _scan_inputs(t, s, "float32",
                                          dt_shift=dt_shift)[:6]
    a = -np.exp(a_log.astype(np.float64))
    y, h_t, start = _chunked_forward(
        *(x.astype(np.float64) for x in (dt, u, b, c)), a,
        h0.astype(np.float64), length)
    jy, jh = _jax_chunk_loop(*map(jnp.asarray, (dt, u, b, c, a_log, h0)))
    _close(torch.from_numpy(y), jy, "float32", "y")
    _close(torch.from_numpy(h_t), jh, "float32", "h_T")
    for k in range(1, start.shape[1] - 1):
        cut = [torch.from_numpy(x[:, :k * length]) for x in (dt, u, b, c)]
        _, hk = _torch_scan(*cut, torch.from_numpy(a_log),
                            torch.from_numpy(h0))
        _close(torch.from_numpy(start[:, k]), hk, "float32", f"start {k}")


@pytest.mark.parametrize("t,length,s,dt_shift", DECOMP_CASES, ids=DECOMP_IDS)
def test_chunked_backward_matches_the_plain_gradients(t, length, s,
                                                      dt_shift):
    """The adjoint carried over chunks in reverse, then each chunk walked
    back with its true carry: all six gradients against autograd through
    ``selective_scan_plain`` in f32, 1e-5 relative plus 1e-5 of the leaf's
    largest magnitude."""
    *ins, dy, dh = _scan_inputs(t, s, "float32", dt_shift=dt_shift)
    ins[4] = -np.exp(ins[4])
    f64 = [x.astype(np.float64) for x in ins]
    start = _chunked_forward(*f64, length)[2]
    got = _chunked_backward(*f64[:5], start, dy.astype(np.float64),
                            dh.astype(np.float64), length)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y, h = tscan.selective_scan_plain(*xs)
    want = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                               + (h * torch.from_numpy(dh)).sum(), xs)
    for name, g, w in zip(("dt", "u", "b", "c", "a", "h0"), got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"d {name}")


@pytest.mark.parametrize("t", [300, 512])
@pytest.mark.parametrize("s", [4, 16])
def test_small_steps_make_the_carry_over_chunks_visible(t, s):
    """At dt = softplus(x - 5) a decomposition that drops the carry over
    L = 64 chunks misses y, h_T and every gradient by far more than the
    kernels' tolerances (1e-5 of the largest forward, 1e-4 backward), so
    the small-dt cases of the card tests and ``chip_smoke.py`` would catch
    a wrong decay product or carry."""
    *ins, dy, dh = _scan_inputs(t, s, "float32", dt_shift=-5.0)
    ins[4] = -np.exp(ins[4])
    f64 = [x.astype(np.float64) for x in ins] + [dy.astype(np.float64),
                                                 dh.astype(np.float64)]

    def run(with_carry):
        y, h_t, start = _chunked_forward(*f64[:6], 64, with_carry)
        return (y, h_t) + _chunked_backward(*f64[:5], start, *f64[6:], 64,
                                            with_carry)
    names = ("y", "h_T", "d dt", "d u", "d b", "d c", "d a", "d h0")
    for name, right, wrong in zip(names, run(True), run(False)):
        off = np.abs(wrong - right).max() / np.abs(right).max()
        assert off > 100 * (1e-5 if name in ("y", "h_T") else 1e-4), (
            name, off)


def test_selective_scan_on_a_cpu_tensor_launches_nothing():
    ins = [_as_tensor(x) for x in _scan_inputs(64, 4, "float32")[:6]]
    ins[4] = -torch.exp(ins[4])
    before = (tscan.selective_scan.launches,
              tscan.selective_scan.launches_forward,
              tscan.selective_scan.launches_backward)
    y, h = ops.selective_scan(*ins)
    want = tscan.selective_scan_plain(*ins)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert (tscan.selective_scan.launches,
            tscan.selective_scan.launches_forward,
            tscan.selective_scan.launches_backward) == before
    assert tscan.LAUNCHES_PER_CALL == {"forward": 3, "backward": 4}


def test_selective_scan_refuses_what_the_kernels_do_not_take():
    dt, u, b, c, a_log, h0 = (_as_tensor(x) for x in
                              _scan_inputs(16, 4, "float32")[:6])
    a = -torch.exp(a_log)
    with pytest.raises(ValueError, match="shapes"):
        tscan.selective_scan_plain(dt, u, b[:, :8], c, a, h0)
    with pytest.raises(TypeError, match="u dtype"):
        tscan.selective_scan_plain(dt, u.half(), b, c, a, h0)
    with pytest.raises(TypeError, match="b must be f32"):
        tscan.selective_scan_plain(dt, u, b.double(), c, a, h0)


def _apply_seq_grads(tp, x, policy):
    """``apply_seq``'s gradients over every parameter and the input, the
    layer under ``remat(policy)`` as a model's block is."""
    params = {k: (v if isinstance(v, torch.Tensor) else dict(v))
              for k, v in tp.items()}
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    x = x.clone().requires_grad_(True)
    fn = remat(lambda ps, xx: tssm.apply_seq(
        torch.utils._pytree.tree_unflatten(ps, spec), xx), policy)
    y = fn(leaves, x)
    w = torch.from_numpy(_x(tuple(y.shape), "float32", seed=5))
    return torch.autograd.grad((y * w).sum(), leaves + [x])


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_apply_seq_gradient_under_remat_is_its_gradient_without(policy):
    """Remat changes memory, never the numbers: the scan recomputed in the
    backward (T = 512, two chunks) gives the gradient of ``"none"``."""
    tp = _torch(_params("float32"))
    x = torch.from_numpy(_x((2, 512, D_MODEL), "float32"))
    for g, w in zip(_apply_seq_grads(tp, x, policy),
                    _apply_seq_grads(tp, x, "none")):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


class _Mirror:
    """The kernels' launches in plain PyTorch on the CPU, for driving
    ``selective_scan``'s autograd Function there: the forward is the plain
    version under ``no_grad`` and hands out a numbered token for its
    checkpoints; the backward records the token it got and returns
    autograd's gradients of the plain version."""

    def __init__(self):
        self.forward_tokens, self.backward_tokens = [], []

    def forward(self, dt, u, b, c, a, h0, checkpoints=True):
        with torch.no_grad():
            y, h = tscan.selective_scan_plain(dt, u, b, c, a, h0)
        self.forward_tokens.append(len(self.forward_tokens))
        return y, h, torch.tensor([float(self.forward_tokens[-1])])

    def backward(self, dt, u, b, c, a, ckpt, dy, dh_last):
        self.backward_tokens.append(int(ckpt.item()))
        ins = [x.detach().requires_grad_(True) for x in (dt, u, b, c, a)]
        h0 = torch.zeros((dt.shape[0], a.shape[0], a.shape[1]),
                         requires_grad=True)
        with torch.enable_grad():
            y, h = tscan.selective_scan_plain(*ins, h0)
            out = (y * dy).sum() + (0 if dh_last is None
                                    else (h * dh_last).sum())
            return torch.autograd.grad(out, ins + [h0])


@pytest.mark.parametrize("policy,forwards", [("none", 1), ("dots", 2),
                                             ("full", 2)])
def test_the_scan_function_under_remat(monkeypatch, policy, forwards):
    """The Function the card runs, its launches mirrored: under ``"dots"``
    (hymba-1.5b's) and ``"full"`` the forward runs again in the backward's
    recompute and the backward reads the recompute's own checkpoints; the
    gradient is the plain version's under every policy."""
    mirror = _Mirror()
    monkeypatch.setattr(tscan, "launch_forward", mirror.forward)
    monkeypatch.setattr(tscan, "launch_backward", mirror.backward)
    monkeypatch.setattr(ops, "selective_scan",
                        lambda *xs: tscan._Scan.apply(*xs))
    tp = _torch(_params("float32"))
    x = torch.from_numpy(_x((2, 256, D_MODEL), "float32"))
    got = _apply_seq_grads(tp, x, policy)
    assert mirror.forward_tokens == list(range(forwards))
    assert mirror.backward_tokens == [forwards - 1]
    monkeypatch.undo()
    for g, w in zip(got, _apply_seq_grads(tp, x, "none")):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
