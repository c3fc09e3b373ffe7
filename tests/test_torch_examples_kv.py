"""``examples/kv_store_ccache_torch.py`` held to its JAX example,
``examples/kv_store_ccache.py``.

The JAX example runs as a subprocess and its printed lines are parsed; its
``rows`` / ``vals`` (``jax.random`` keys 1 and 2) are drawn here with the
same calls and handed to the twin (``main(rows=, vals=)``). On them the
blocked engine's per-core evict- and flush-merge counters are equal bit for
bit: they depend only on the access order. The merged table and the
``cscatter`` table are within the f32 ``TOL`` of serialization (relative
to the table's largest value). The saturating maximum and ``z[0]`` equal
JAX's to the printed precision. The dropping merge draws its mask from a
``torch.Generator`` (a decided divergence): its kept share is held to a
binomial band around 1/2, five standard deviations wide, the deviation
derived here from the table's masses.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _examples_common import TOL, ints, load_example, one_thread, \
    run_jax_example

kv = load_example("kv_store_ccache_torch")
BAND_SIGMAS = 5


@pytest.fixture(scope="module")
def jax_lines(tmp_path_factory):
    return run_jax_example("kv_store_ccache",
                           cwd=tmp_path_factory.mktemp("jax")).splitlines()


def _line(lines: list, tag: str) -> str:
    (line,) = [x for x in lines if tag in x]
    return line.split(tag, 1)[1]


@pytest.fixture(scope="module")
def inputs():
    rows = jax.random.randint(jax.random.key(1), (kv.N_CORES, kv.UPDATES),
                              0, kv.KEYS)
    vals = jnp.abs(jax.random.normal(jax.random.key(2),
                                     (kv.N_CORES, kv.UPDATES, kv.COLS)))
    return np.asarray(rows), np.asarray(vals)


@pytest.fixture(scope="module")
def port(inputs):
    with one_thread():
        return kv.main(["--device", "cpu"], rows=inputs[0], vals=inputs[1])


def _gold(inputs) -> np.ndarray:
    rows, vals = inputs
    gold = np.zeros((kv.KEYS, kv.COLS), np.float64)
    np.add.at(gold, rows.reshape(-1), vals.reshape(-1, kv.COLS))
    return gold


def test_blocked_counters_equal_jax_bit_for_bit(port, jax_lines):
    for what in ("evict", "flush"):
        assert port[f"{what}_merges"] == ints(
            _line(jax_lines, f"{what}-merges/core:"))
    assert port["flush_merges"] == [kv.WAYS] * kv.N_CORES


@pytest.mark.parametrize("what", ["blocked_err", "cscatter_err"])
def test_tables_are_within_tol_of_serialization(port, inputs, what):
    assert port[what] <= TOL["float32"] * np.abs(_gold(inputs)).max()


def test_saturating_and_complex_merges_equal_jax(port, jax_lines):
    assert port["sat_max"] <= 3.0
    assert _line(jax_lines, "table max = ").startswith(
        f"{port['sat_max']:.2f} ")
    z = complex(*port["z0"])
    assert abs(z - (1 + 0.2j) * (1 + 0.1j) ** 8) <= 1e-5
    assert _line(jax_lines, "z[0] = ").startswith(
        f"{z.real:.3f}{z.imag:+.3f}i ")


def test_kept_share_lies_in_the_binomial_band(port, inputs, jax_lines):
    mass = _gold(inputs)
    sigma = np.sqrt(0.25 * (mass ** 2).sum()) / mass.sum()
    assert port["kept_sigma"] == pytest.approx(sigma, rel=1e-5)
    assert abs(port["kept"] - 0.5) <= BAND_SIGMAS * sigma
    # JAX's own draw lies in the same band
    jkept = ints(_line(jax_lines, "kept "))[0] / 100   # printed as a %
    assert abs(jkept - 0.5) <= BAND_SIGMAS * sigma + 0.005


def test_printed_lines_are_jax_s(port, jax_lines):
    """The same lines in the same order, each with JAX's words: the
    numbers aside (the evict counts, errors and kept share are checked
    above), one line for one."""
    def words(line):
        return re.sub(r"[-+]?[\d.]+(e[-+]?\d+)?", "#", line)
    assert [words(x) for x in port["lines"]] == [words(x) for x in jax_lines]
