"""The port's optimizers and schedules against the JAX package's:
``adamw``, ``adafactor`` (factored and full second moments),
``clip_by_global_norm``, ``constant`` and ``warmup_cosine``, over several
steps on the same f32 trees made with numpy. Both compute the same f32
arithmetic in another order, so the tolerance is 1e-6 relative (and 1e-7
absolute, for values that pass through zero). A bf16 tree is held to one
bf16 rounding (2**-8 relative) of its parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (6, 5), "b": (5,), "stack": (3, 4, 6)}


def _tree(rng, scale=1.0, dtype=np.float32):
    return {"layer": {k: (scale * rng.standard_normal(s)).astype(dtype)
                      for k, s in SHAPES.items()},
            "scale": (scale * rng.standard_normal((4,))).astype(dtype)}


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_torch(tree):
    return jax.tree.map(_tensor, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    g = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), got,
                                     is_leaf=lambda x: isinstance(
                                         x, torch.Tensor)))
    w = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,make", [
    ("constant", lambda m: m.constant(3e-4)),
    ("warmup_cosine", lambda m: m.warmup_cosine(1e-3, 5, 40)),
    ("warmup_cosine_no_warmup", lambda m: m.warmup_cosine(2e-3, 0, 10, 0.2)),
])
def test_schedules_match_jax(name, make):
    tf, jf = make(tsched), make(jsched)
    for step in list(range(0, 45)) + [100]:
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got),
                                   float(jf(jnp.asarray(step, jnp.int32))),
                                   rtol=RTOL, atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(0))
    tg, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    jg, jn = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tg, jg)


def _run(make, steps, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype=dtype)
    grads = [_tree(rng, scale=0.1 * (t + 1), dtype=dtype)
             for t in range(steps)]
    topt_, jopt_ = make(topt, tsched), make(jopt, jsched)
    tp, jp = _to_torch(params), _to_jax(params)
    ts, js = topt_.init(tp), jopt_.init(jp)
    for t, g in enumerate(grads):
        tp, ts, tstats = topt_.step(tp, _to_torch(g), ts)
        jp, js, jstats = jopt_.step(jp, _to_jax(g), js)
        assert int(ts.step) == int(js.step) == t + 1
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=RTOL)
    return tp, ts, jp, js


@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_matches_jax_over_steps(seed):
    make = lambda o, s: o.adamw(s.warmup_cosine(1e-2, 2, 6))
    tp, ts, jp, js = _run(make, 6, seed)
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adafactor_matches_jax_over_steps(weight_decay):
    """Matrices take the factored second moment (row and col), vectors the
    full one; both kinds are in the tree."""
    make = lambda o, s: o.adafactor(s.constant(1e-2),
                                    weight_decay=weight_decay)
    tp, ts, jp, js = _run(make, 5, 3)
    assert ts.mu is None and js.mu is None
    assert set(ts.nu["layer"]["w"]) == {"row", "col"}
    assert set(ts.nu["layer"]["b"]) == {"full"}
    assert tuple(ts.nu["layer"]["stack"]["col"].shape) == (3, 6)
    _close(tp, jp)
    _close(ts.nu, js.nu)


def test_make_optimizer_picks_by_config():
    class Cfg:
        optimizer = "adafactor"
    assert topt.make_optimizer(Cfg, tsched.constant(1.0)).init(
        {"w": torch.zeros(2, 2)}).mu is None
    Cfg.optimizer = "adamw"
    assert topt.make_optimizer(Cfg, tsched.constant(1.0)).init(
        {"w": torch.zeros(2, 2)}).mu is not None


def test_adamw_on_bf16_params_updates_in_f32_and_casts_back():
    import ml_dtypes
    make = lambda o, s: o.adamw(s.constant(1e-2))
    tp, ts, jp, js = _run(make, 3, 5, dtype=ml_dtypes.bfloat16)
    for leaf in jax.tree.leaves(tp, is_leaf=lambda x: isinstance(
            x, torch.Tensor)):
        assert leaf.dtype == torch.bfloat16
    assert ts.mu["scale"].dtype == torch.float32
    _close(tp, jp, rtol=2 ** -8, atol=1e-6)


def test_step_leaves_its_arguments_alone():
    """A poisoned step's result can be dropped: the old state is intact."""
    opt = topt.adamw(tsched.constant(1e-2))
    params = _to_torch(_tree(np.random.default_rng(0)))
    state = opt.init(params)
    before = jax.tree.map(lambda t: t.clone(), (params, state.mu, state.nu),
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    opt.step(params, _to_torch(_tree(np.random.default_rng(1))), state)
    after = (params, state.mu, state.nu)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        assert torch.equal(a, b)
    assert int(state.step) == 0
