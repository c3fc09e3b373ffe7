"""The port's logical axes and partition rules against the JAX package's.

The parameter layout (``models/layout.py``) of every ``ARCH_IDS`` config at
full width against JAX's ``split_params(jax.eval_shape(init))``, leaf by
leaf (axes, shapes, dtypes), and at smoke size against the port's own
models; ``spec_for`` against JAX's on ``tests/test_sharding.py``'s cases and
on every parameter of every config at full width on both production
meshes; ``lowering_rules`` for every (arch, applicable shape, mesh);
``opt_state_axes``; every family's input, cache and state specs and axes,
and the partition specs they give; DTensor's order of a composite shard
pinned to JAX's; ``logical_constraint`` outside and inside a rules
context.
"""

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import (ARCH_IDS, SHAPES, applicable_shapes,
                                      get_config, get_smoke_config)
from repro_torch.launch import steps
from repro_torch.models import layout
from repro_torch.sharding import partition

# every config and each of its applicable shapes: the dry-run's cells
CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]


class FakeMesh:
    """Shape-only mesh (axis name -> size), as ``tests/test_sharding.py``."""

    def __init__(self, **shape):
        self.shape = shape


M = FakeMesh(data=16, model=16)
MP = FakeMesh(pod=2, data=16, model=16)
MESHES = {"pod16x16": M, "pod2x16x16": MP}


def _flat(tree, is_leaf):
    """Dotted path -> leaf of a nested dict/list/tuple tree."""
    out = {}

    def rec(t, pre):
        if is_leaf(t):
            out[pre] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{pre}.{k}" if pre else str(k))
        elif isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
            for i, v in enumerate(t):
                rec(v, f"{pre}.{i}")
        elif hasattr(t, "_fields") or hasattr(t, "__dataclass_fields__"):
            names = getattr(t, "_fields", None) or list(
                t.__dataclass_fields__)
            for k in names:
                rec(getattr(t, k), f"{pre}.{k}" if pre else k)
        else:
            out[pre] = t
    rec(tree, "")
    return out


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _jax_split(arch):
    import jax
    from repro.configs.base import get_config as jget
    from repro.models.module import split_params
    from repro.models.registry import build_model
    model = build_model(jget(arch))
    return split_params(jax.eval_shape(model.init, jax.random.key(0)))


def test_fake_store_is_importable():
    """The fake process group's store is internal to PyTorch: if it moves,
    the planner fails here, by name."""
    from repro_torch.launch import mesh
    try:
        mesh.fake_store()
    except ImportError as e:          # pragma: no cover - a PyTorch change
        pytest.fail(f"torch.testing._internal.distributed.fake_pg.FakeStore "
                    f"moved: {e}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_layout_matches_jax_at_full_width(arch):
    specs, axes = _jax_split(arch)
    want_ax = _flat(axes, _is_axes)
    want_sp = _flat(specs, lambda x: hasattr(x, "shape"))
    got = _flat(layout.param_layout(get_config(arch)),
                lambda x: isinstance(x, layout.Leaf))
    assert set(got) == set(want_ax)
    for k, leaf in got.items():
        assert leaf.axes == want_ax[k], k
        assert leaf.shape == tuple(want_sp[k].shape), k
        assert str(leaf.dtype).split(".")[-1] == str(want_sp[k].dtype), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_layout_matches_the_port_model(arch):
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config(arch)
    params = build_model(cfg, device="cpu").params()
    got = _flat(params, lambda x: isinstance(x, torch.Tensor))
    specs = _flat(layout.param_specs(cfg),
                  lambda x: isinstance(x, layout.Spec))
    assert set(got) == set(specs)
    for k, t in got.items():
        assert (tuple(t.shape), t.dtype) == (specs[k].shape,
                                              specs[k].dtype), k
    assert _flat(layout.param_axes(cfg), _is_axes).keys() == got.keys()


SPEC_CASES = [
    ((151936, 1024), ("vocab", "embed"), "pod16x16", None),
    ((1024, 2816), ("embed", "mlp"), "pod16x16", None),
    ((151937, 1024), ("vocab", "embed"), "pod16x16", None),
    ((2, 128, 8, 128), ("batch", "cache_seq", "kv_heads", "head_dim"),
     "pod16x16", None),
    ((2, 128, 16, 128), ("batch", "cache_seq", "kv_heads", "head_dim"),
     "pod16x16", None),
    ((256, 4096), ("batch", "seq"), "pod2x16x16", None),
    ((2, 4096), ("batch", "seq"), "pod2x16x16", None),
    ((1, 4096), ("batch", "seq"), "pod2x16x16", None),
    ((2, 4096, 16, 128), ("batch", "cache_seq", "kv_heads", "head_dim"),
     "pod16x16", {"cache_seq": "model"}),
    ((16384, 53248), ("embed", "mlp"), "pod2x16x16",
     {"embed": ("pod", "data")}),
    ((32, 16), ("batch", "embed"), "pod2x16x16",
     {"batch": ("data", "pod")}),
]


@pytest.mark.parametrize("shape,axes,mesh,rules", SPEC_CASES)
def test_spec_for_matches_jax(shape, axes, mesh, rules):
    from repro.sharding.partition import spec_for as jax_spec_for
    want = jax_spec_for(shape, axes, MESHES[mesh], rules)
    assert partition.spec_for(shape, axes, MESHES[mesh], rules) == \
        tuple(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_every_dense_param_matches_jax(arch, mesh):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget
    from repro.launch.steps import lowering_rules as jax_rules
    from repro.sharding.partition import spec_for as jax_spec_for
    m = MESHES[mesh]
    rules = jax_rules(jget(arch), JSHAPES["train_4k"], m)
    assert rules == steps.lowering_rules(get_config(arch),
                                         SHAPES["train_4k"], m)
    for path, leaf in _flat(layout.param_layout(get_config(arch)),
                            lambda x: isinstance(x, layout.Leaf)).items():
        want = jax_spec_for(leaf.shape, leaf.axes, m, rules)
        assert partition.spec_for(leaf.shape, leaf.axes, m, rules) == \
            tuple(want), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_lowering_rules_match_jax(arch, shape, mesh):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget
    from repro.launch.steps import lowering_rules as jax_rules
    want = jax_rules(jget(arch), JSHAPES[shape], MESHES[mesh])
    assert steps.lowering_rules(get_config(arch), SHAPES[shape],
                                MESHES[mesh]) == want


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "llama3_405b"])
def test_opt_state_axes_and_specs_match_jax(arch):
    """AdamW (qwen1.5) and Adafactor (llama3) state: the axes tree and the
    specs, leaf by leaf."""
    import jax
    from repro.configs.base import get_config as jget
    from repro.launch.steps import opt_state_axes as jax_opt_axes
    from repro.optim import make_optimizer, warmup_cosine
    specs, axes = _jax_split(arch)
    opt = make_optimizer(jget(arch), warmup_cosine(3e-4, 100, 10_000))
    opt_specs = jax.eval_shape(opt.init, specs)
    want_ax = _flat(jax_opt_axes(opt_specs, axes), _is_axes)
    want_sp = _flat(opt_specs, lambda x: hasattr(x, "shape"))
    cfg = get_config(arch)
    got_specs = steps.opt_state_specs(cfg, layout.param_specs(cfg))
    got_ax = _flat(steps.opt_state_axes(got_specs, layout.param_axes(cfg)),
                   _is_axes)
    got_sp = _flat(got_specs, lambda x: isinstance(x, layout.Spec))
    assert got_ax == want_ax
    assert set(got_sp) == set(want_sp)
    for k, s in got_sp.items():
        if s is None:                  # Adafactor keeps no first moment
            assert want_sp[k] is None, k
            continue
        assert s.shape == tuple(want_sp[k].shape), k
        assert str(s.dtype).split(".")[-1] == str(want_sp[k].dtype), k


def _models(arch):
    from repro.configs.base import get_config as jget
    from repro.models.registry import build_model as jbuild
    from repro_torch.models.registry import abstract_model
    return jbuild(jget(arch)), abstract_model(get_config(arch))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_match_jax(arch, shape):
    """Every family's inputs (a decode's caches or recurrent states among
    them): specs and logical axes, leaf by leaf."""
    from repro.configs.base import SHAPES as JSHAPES
    jm, pm = _models(arch)
    want_sp = _flat(jm.input_specs(JSHAPES[shape]),
                    lambda x: hasattr(x, "shape"))
    got_sp = _flat(pm.input_specs(SHAPES[shape]),
                   lambda x: isinstance(x, layout.Spec))
    assert set(got_sp) == set(want_sp)
    for k, s in got_sp.items():
        assert s.shape == tuple(want_sp[k].shape), k
        assert str(s.dtype).split(".")[-1] == str(want_sp[k].dtype), k
    assert _flat(pm.input_axes(SHAPES[shape]), _is_axes) == \
        _flat(jm.input_axes(JSHAPES[shape]), _is_axes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_partition_specs_match_jax(arch, shape, mesh):
    """The partition spec of every input leaf under the cell's rules, and
    for a prefill the caches it fills (a decode's of the same batch and
    length), against JAX's ``spec_for`` on its own axes and specs."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as jget
    from repro.launch.steps import lowering_rules as jax_rules
    from repro.sharding.partition import spec_for as jax_spec_for
    jm, pm = _models(arch)
    m = MESHES[mesh]
    rules = jax_rules(jget(arch), JSHAPES[shape], m)
    base = SHAPES[shape]
    trees = [(pm.input_axes(base), pm.input_specs(base),
              jm.input_axes(JSHAPES[shape]), jm.input_specs(JSHAPES[shape]))]
    if base.kind == "prefill":
        serve = base.__class__(base.name, base.seq_len, base.global_batch,
                               "decode")
        jserve = JShape(base.name, base.seq_len, base.global_batch, "decode")
        trees.append((pm.input_axes(serve)["caches"],
                      pm.input_specs(serve)["caches"],
                      jm.input_axes(jserve)["caches"],
                      jm.input_specs(jserve)["caches"]))
    for p_ax, p_sp, j_ax, j_sp in trees:
        got = _flat(steps.axes_to_shardings(p_ax, p_sp, m, rules),
                    lambda x: isinstance(x, tuple))
        axes, specs = _flat(j_ax, _is_axes), _flat(j_sp,
                                                   lambda x: hasattr(x,
                                                                     "shape"))
        assert set(got) == set(specs)
        for k, spec in got.items():
            assert spec == tuple(jax_spec_for(tuple(specs[k].shape), axes[k],
                                              m, rules)), k


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.launch import mesh
    yield {"mp": mesh.make_production_mesh(multi_pod=True),
           "host": mesh.make_host_mesh(2, 2)}
    mesh.shutdown()


def test_placements_split_a_composite_dim_pod_major(meshes):
    """``("pod", "data")`` on one dim: DTensor's chunk of coordinate (p, d)
    starts at ``(p * 16 + d) * rows``, JAX's major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    m = meshes["mp"]
    pl = partition.placements_for((("pod", "data"), None), m)
    assert pl == [Shard(0), Shard(0), Replicate()]
    for p in range(2):
        for d in range(16):
            shape, off = _compute_local_shape_and_global_offset(
                (256, 8), (2, 16, 16), [p, d, 3], pl)
            assert shape == (8, 8) and off == ((p * 16 + d) * 8, 0)
    with pytest.raises(ValueError, match="order"):
        partition.placements_for((("data", "pod"),), m)


def test_logical_constraint_outside_and_inside_a_rules_context(meshes):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.ones(4, 4)
    assert partition.logical_constraint(x, ("batch", "embed")) is x
    m = meshes["host"]
    d = DTensor.from_local(torch.empty(4, 4, device="meta"), m,
                           [Replicate(), Replicate()], run_check=False)
    assert partition.logical_constraint(d, ("batch", "mlp")) is d
    with partition.sharding_rules(m):
        y = partition.logical_constraint(d, ("batch", "mlp"))
        with partition.manual_axes(("data",)):
            assert partition.logical_constraint(d, ("batch", "mlp")) is d
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert y.to_local().shape == (2, 2)
    assert partition.active_mesh() is None


def test_params_shardings_and_count_params():
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen1_5_0_5b")
    tree = partition.params_shardings(layout.param_axes(cfg),
                                      layout.param_specs(cfg), M)
    assert tree["embed"]["table"] == ("model", "data")
    assert tree["blocks"]["attn"]["wq"]["w"] == (None, "data", "model")
    smoke = get_smoke_config("qwen1_5_0_5b")
    meta = pytree.tree_map(lambda s: torch.empty(s.shape, device="meta"),
                           layout.param_specs(smoke),
                           is_leaf=lambda x: isinstance(x, layout.Spec))
    assert partition.count_params(meta) == partition.count_params(
        build_model(smoke, device="cpu").params())
