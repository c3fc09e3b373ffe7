"""``examples/fault_tolerant_train_torch.py`` held to
``examples/fault_tolerant_train.py``.

The JAX example runs as two subprocesses (it parses ``sys.argv`` and sets
``XLA_FLAGS`` at import), the demo and ``--chaos --quick``, and their
printed lines are parsed.

* The demo, on the JAX example's weights (``main(params=)``): the same
  step numbers (step 8 reached with 1 poisoned batch skipped, a checkpoint
  at step 11, resumed 11 -> 16) and the final loss within ``LOSS_TOL`` of
  JAX's: bf16 rounding over 15 steps, measured 1.0e-3 (4.1843 against
  4.1833); the bound is five times that.
* ``--chaos --quick``: the four parts JAX completes on this container
  print JAX's results (the sweeps' counts and actions, the spec's leaf
  count, the elastic settle, K, lr' and b1', the serving recovery's
  snapshot and replay). JAX's fifth part, the real model, fails on jax 0.9
  (``shard_map(auto=)``, ROADMAP §3 item 4): the test pins that failure
  and holds the port's real-model part to its own uninterrupted twin,
  bitwise, which is the example's own check; the run ends with
  ``CHAOS_SUITE_OK``.
"""

import pytest

from _examples_common import finish, jax_params, load_example, one_thread, \
    start_jax_example

LOSS_TOL = 5e-3
PARTS = ("[toy]", "  preempt:", "  kill:", "  flush policy:", "[spec]",
         "[elastic]", "  settled", "[serve]", "  snapshot@")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    procs = {"demo": start_jax_example("fault_tolerant_train",
                                       cwd=tmp_path_factory.mktemp("d")),
             "chaos": start_jax_example("fault_tolerant_train", "--chaos",
                                        "--quick",
                                        cwd=tmp_path_factory.mktemp("c"))}
    return {k: finish(p) for k, p in procs.items()}


@pytest.fixture(scope="module")
def twin():
    return load_example("fault_tolerant_train_torch")


def test_demo_matches_jax(twin, jax_runs):
    rc, out, err = jax_runs["demo"]
    assert rc == 0, err[-3000:]
    _, params = jax_params("internlm2_1_8b")
    with one_thread():
        got = twin.main(["--device", "cpu"], params=params)
    demo = got["demo"]
    assert (demo["reached"], demo["skipped"], demo["preempted_at"],
            demo["resumed"]) == (8, 1, 11, (11, 16))
    jlines = out.splitlines()
    # the printed lines carry the same step numbers
    for want, have in zip([x for x in jlines if x.startswith("  ")],
                          [x for x in got["lines"] if x.startswith("  ")]):
        assert want.split(";")[0] == have.split(";")[0]
    jloss = float(jlines[-1].rsplit(" ", 1)[1])
    assert abs(demo["final_loss"] - jloss) <= LOSS_TOL


@pytest.fixture(scope="module")
def port_chaos(twin):
    with one_thread():
        return twin.main(["--device", "cpu", "--chaos", "--quick"])


def test_chaos_parts_jax_completes_print_jax_s_results(port_chaos,
                                                       jax_runs):
    _, out, _ = jax_runs["chaos"]
    jlines = out.splitlines()
    for tag in PARTS:
        (want,) = [x for x in jlines if x.startswith(tag)]
        (have,) = [x for x in port_chaos["lines"] if x.startswith(tag)]
        assert have == want, tag
    assert port_chaos["spec"]["leaves"] == 4
    assert port_chaos["elastic"]["k_new"] == 3
    assert port_chaos["serve"] == {"snapshot_step": 0, "replayed_ticks": 6}


def test_jax_real_model_part_fails_on_this_jax_as_recorded(jax_runs):
    rc, out, err = jax_runs["chaos"]
    if rc == 0:          # a JAX that runs it: then it prints the suite's end
        assert out.splitlines()[-1] == "CHAOS_SUITE_OK"
        return
    assert "[real]" in out and "CHAOS_SUITE_OK" not in out
    assert "shard_map() got an unexpected keyword argument 'auto'" in err


def test_real_model_part_is_bitwise_and_the_suite_ends_ok(port_chaos):
    assert port_chaos["real"] == {2: "verbatim"}
    assert "  kill@2: resumed (verbatim at step 2) -> params BITWISE equal" \
        in port_chaos["lines"]
    assert port_chaos["lines"][-1] == "CHAOS_SUITE_OK"
