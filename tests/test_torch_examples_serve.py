"""``examples/serve_batched_torch.py`` against the JAX example, for the
default hymba-1.5b and four more of the ``ARCH_IDS`` smoke configs
(``tests/_examples_serve.py`` states the rule; the other five configs are
in ``test_torch_examples_serve_more.py``). The JAX examples start together
in a module fixture and are read one by one."""

import pytest

from _examples_serve import check, start

ARCHS = ["hymba-1-5b", "qwen1-5-0-5b", "xlstm-125m", "seamless-m4t-medium",
         "qwen3-moe-235b"]


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
