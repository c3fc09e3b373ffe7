"""``examples/serve_batched_torch.py`` against the JAX example, for the five
``ARCH_IDS`` smoke configs that ``test_torch_examples_serve.py`` leaves out
(``tests/_examples_serve.py`` states the rule): the VLM backbone from its
prompt ids, the dense giants' smoke configs and kimi-k2-1t's MoE with its
shared expert and dense first layer."""

import pytest

from _examples_serve import check, start

ARCHS = ["llava-next-34b", "granite-34b", "llama3-405b", "internlm2-1-8b",
         "kimi-k2-1t"]


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    started = {a: start(a, tmp_path_factory.mktemp(a)) for a in ARCHS}
    yield started
    for p in started.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_ids_equal_jax_up_to_a_near_tie(arch, procs):
    check(arch, procs[arch])
