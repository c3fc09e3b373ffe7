"""``examples/serve_batched_torch.py`` held to ``examples/serve_batched.py``
for one family: what ``test_torch_examples_serve*.py`` share.

The JAX example runs as a subprocess (its printed sample ids parsed), and
its loop is composed here from the example's own calls on the same weights
(``model.init(jax.random.key(0))``) and prompts (``default_rng(0)``), to
keep each step's logits; the composed ids must be the printed ones. The
twin gets the same weights (``main(params=)``). Each row's ids are equal
to JAX's up to its first difference, if any; there both packages' logits
for the two candidate tokens must lie within ``NEAR_TIE`` of each other
(the bf16 ``TOL``): a near-tie that the two packages' bf16 roundings break
either way (ROADMAP §3 item 11's rule). After it the row's inputs differ,
so the rest of the row is not compared.
"""

from __future__ import annotations

import numpy as np

from _examples_common import (TOL, finish, ints, jax_params, load_example,
                              one_thread, start_jax_example)

NEAR_TIE = TOL["bfloat16"]
BATCH, PROMPT, GEN = 4, 32, 24


def start(arch: str, cwd):
    return start_jax_example("serve_batched", "--arch", arch, cwd=cwd)


def _jax_loop(model, params) -> tuple[np.ndarray, list]:
    """The JAX example's prefill and decode, its ids ``[B, GEN]`` and each
    step's logits."""
    import jax
    import jax.numpy as jnp
    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT)), jnp.int32)}
    if cfg.family == "encdec":
        batch["frames"] = jnp.asarray(
            rng.standard_normal((BATCH, model.enc_len(PROMPT), cfg.d_model)),
            cfg.param_dtype)
    logits, caches = jax.jit(
        lambda p, b: model.prefill(p, b, PROMPT + GEN))(params, batch)
    decode = jax.jit(model.decode_step, donate_argnums=(2,))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    ids, kept = [tok], [np.asarray(logits, np.float32)]
    for i in range(GEN - 1):
        logits, caches = decode(params, tok, caches,
                                jnp.asarray(PROMPT + i, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        ids.append(tok)
        kept.append(np.asarray(logits, np.float32))
    return np.stack([np.asarray(t) for t in ids], 1), kept


def check(arch: str, proc) -> dict:
    """Run both sides for ``arch`` (``proc``: its started JAX example) and
    assert the rule above; returns the rows' first differences."""
    model, params = jax_params(arch.replace("-", "_"))
    jids, jlogits = _jax_loop(model, params)
    rc, out, err = finish(proc)
    assert rc == 0, err[-3000:]
    printed = ints(out.strip().splitlines()[-1].split(":", 1)[1])
    assert printed == jids[0, :12].tolist()

    twin = load_example("serve_batched_torch")
    with one_thread():
        got = twin.main(["--arch", arch, "--device", "cpu"], params=params)
    ids = np.asarray(got["ids"])
    assert ids.shape == jids.shape
    assert got["sample_ids"] == ids[0, :12].tolist()
    plogits = [l.float().numpy() for l in got["served"].logits]
    ties = {}
    for r in range(BATCH):
        diff = np.flatnonzero(ids[r] != jids[r])
        if not len(diff):
            continue
        t = int(diff[0])
        pj, pp = int(jids[r, t]), int(ids[r, t])
        gap_jax = jlogits[t][r, pj] - jlogits[t][r, pp]
        gap_port = plogits[t][r, pp] - plogits[t][r, pj]
        assert 0 <= gap_jax <= NEAR_TIE and 0 <= gap_port <= NEAR_TIE, (
            f"{arch} row {r} step {t}: JAX picks {pj}, the port {pp}; "
            f"logit gaps {gap_jax} (JAX), {gap_port} (port) > {NEAR_TIE}")
        ties[r] = (t, float(gap_jax), float(gap_port))
    return ties
