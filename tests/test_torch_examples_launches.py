"""``chip_smoke.py`` ``phase_examples``' launch predictions, held on the CPU.

On the card the phase requires each twin's kernel launches to equal
``examples_predicted()``, worked out from the code. Here the same twins run
on the CPU with the phase's arguments (``train_e2e_torch``'s two runs cut
to ``E2E_STEPS = (2, 3)``, a checkpoint every 2), and every kernel
wrapper's calls are heard
through ``repro_torch.hooks`` (a wrapper announces each concrete call, on
the CPU too, where it runs the plain version); the calls times each
kernel's launches a call must be the prediction. A kernel whose launch
count depends on the card alone (a ``cscatter`` of no ids launches
nothing) does not arise at these shapes.
"""

import collections

import pytest

from _examples_common import load_chip_smoke, load_example, one_thread
from repro_torch import hooks
from repro_torch.kernels.cscatter import LAUNCHES_PER_CALL as CS
from repro_torch.kernels.decode_attention import LAUNCHES_PER_CALL as DA
from repro_torch.kernels.selective_scan import LAUNCHES_PER_CALL as SC

PER_CALL = {"cscatter": CS, "cmerge": 1, "flash_attention": 1,
            "decode_attention": DA, "selective_scan": SC["forward"]}


@pytest.fixture(scope="module")
def smoke():
    mod = load_chip_smoke()
    mod.E2E_STEPS, mod.E2E_CKPT_EVERY = (2, 3), 2
    return mod


def _heard(fn) -> dict:
    calls = collections.Counter()

    def hear(event, *args):
        if event == "kernel_begin":
            calls[args[0]] += 1
    with one_thread(), hooks.listening(hear):
        fn()
    return {k: calls[k] * n for k, n in PER_CALL.items()}


def _runs(smoke, tmp_path) -> dict:
    ft = load_example("fault_tolerant_train_torch")
    e2e = load_example("train_e2e_torch")

    def twice():
        for n in smoke.E2E_STEPS:
            e2e.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                      "--steps", str(n),
                      "--ckpt-every", str(smoke.E2E_CKPT_EVERY)])
    return {
        "kv_store_ccache": lambda: load_example(
            "kv_store_ccache_torch").main(["--device", "cpu"]),
        "quickstart": lambda: load_example("quickstart_torch").main(
            ["--device", "cpu"]),
        "serve_batched": lambda: load_example("serve_batched_torch").main(
            ["--device", "cpu"]),
        "train_e2e": twice,
        "fault_tolerant_demo": lambda: ft.main(["--device", "cpu"]),
        "fault_tolerant_chaos": lambda: ft.main(["--device", "cpu",
                                                 "--chaos", "--quick"]),
    }


NAMES = ["kv_store_ccache", "quickstart", "serve_batched", "train_e2e",
         "fault_tolerant_demo", "fault_tolerant_chaos"]


@pytest.mark.parametrize("name", NAMES)
def test_launches_heard_on_the_cpu_are_the_phase_s_prediction(
        smoke, name, tmp_path):
    assert sorted(smoke.examples_predicted()) == sorted(NAMES)
    assert _heard(_runs(smoke, tmp_path)[name]) == \
        smoke.examples_predicted()[name]
