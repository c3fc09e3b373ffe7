"""``chip_smoke.py`` ``phase_examples``' checks catch a wrong kernel, held on
the CPU through ``scripts/examples_mutations_torch.py``.

The script serves the quickstart's and serve_batched's twins, then serves
the same weights and prompts again with one kernel wrapper made subtly
wrong (the newest slot left out of a decode, a softmax scale off by 5 %,
the scan's output 2 % too large, the embedding backward's scatter without
its last id). On the CPU each wrapper runs its kernel's plain version, so
the wrong version differs from the model's plain path exactly as a wrong
kernel would on the card. Every sound run must pass the phase's checks and
every wrong one must fail them; the wrong serves that the phase's former
fixed rule (logits within 0.1, greedy tokens past a margin of 0.2) let
through are named, since they are why the limit is now the logits' spread
times the bf16 TOL.

One wrong serve is not held: the quickstart's prefill with its queries 5 %
too large moves the trained model's logits by 1.8-6.0 % of their spread,
by the PyTorch it trained on (2.11's CPU, the card, 2.13's CPU), against a
limit of 2 %: at the limit, caught on some and not on others. The script
reports it; serve_batched's copy of the same fault is held.
"""

import importlib.util

import pytest

from _examples_common import ROOT, one_thread


@pytest.fixture(scope="module")
def verdicts():
    spec = importlib.util.spec_from_file_location(
        "examples_mutations", ROOT / "scripts" / "examples_mutations_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with one_thread():
        return mod.main(["--device", "cpu"])


@pytest.mark.parametrize("name", ["quickstart", "serve_batched",
                                  "quickstart_embedding_backward"])
def test_a_sound_run_passes_the_phase_s_checks(verdicts, name):
    got = verdicts["sound"][name]
    assert not got["caught"], got
    # on the CPU the kernel path is the plain one: no error at all
    assert got["max_abs_err" if "embedding" in name else "max_logit_err"] \
        == 0.0


def test_the_serve_checks_require_most_tokens(verdicts):
    """The margin scales with the limit: the phase's former margin of 0.2
    required 1 of serve_batched's 96 tokens on the card."""
    for name in ("quickstart", "serve_batched"):
        got = verdicts["sound"][name]
        assert got["sure_tokens"] >= got["tokens"] // 2, got


@pytest.mark.parametrize("case", [
    "decode_drops_newest/quickstart", "decode_drops_newest/serve_batched",
    "flash_q_times_1.05/serve_batched",
    "scan_y_times_1.02/serve_batched",
    "scatter_drops_last/quickstart_embedding_backward"])
def test_a_wrong_kernel_fails_the_phase_s_checks(verdicts, case):
    assert verdicts["wrong"][case]["new_rule"]["caught"], verdicts["wrong"][
        case]


def test_the_former_fixed_rule_let_wrong_serves_through(verdicts):
    passed = sorted(k for k, v in verdicts["wrong"].items()
                    if v.get("old_rule", {}).get("passes"))
    assert passed == ["decode_drops_newest/quickstart",
                      "flash_q_times_1.05/quickstart",
                      "flash_q_times_1.05/serve_batched",
                      "scan_y_times_1.02/serve_batched"], passed
