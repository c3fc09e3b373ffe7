"""The production-mesh dry-run of the MoE, VLM, hybrid, encoder-decoder and
xLSTM families: the selective scan as a custom op, the count check of
each family's prefill, and the xLSTM's extrapolation over time.

* The scan's custom op (``kernels/custom_ops.py``): its fake shapes are
  the plain outputs'; on the CPU its forward and its backward equal
  ``selective_scan_plain`` and its autograd bit for bit; on the 16 x 16
  mesh its DTensor rule splits the channels over the model axis (and the
  batch over the data axis), and its backward leaves the sums over the
  split dims as partial sums.
* The count check on the CPU: each new family's smoke prefill in f32 run
  for real under the op walk (each kernel's plain version counted once,
  by its formula) and traced on a 1 x 1 mesh count the same FLOPs, the
  same kernel calls and the same boundary bytes.
* The xLSTM traced at 2 and 3 of its 256-token chunks and extrapolated
  over time equals its exact trace at 4 chunks.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.launch import op_cost, steps


def _scan_inputs(b=2, t=40, d=32, s=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.functional.softplus(torch.randn(b, t, d, generator=g)),
            torch.randn(b, t, d, generator=g),
            torch.randn(b, t, s, generator=g),
            torch.randn(b, t, s, generator=g),
            -torch.arange(1, s + 1, dtype=torch.float32).repeat(d, 1),
            torch.randn(b, d, s, generator=g)]


def test_scan_custom_op_fake_shapes_match_the_plain_outputs():
    from repro_torch.kernels import custom_ops  # noqa: F401 (registers)
    from repro_torch.kernels.selective_scan import selective_scan_plain
    ins = _scan_inputs()
    want = selective_scan_plain(*ins)
    ops = torch.ops.repro_torch
    got = ops.selective_scan(*[x.to("meta") for x in ins])
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    meta = [x.to("meta") for x in ins]
    grads = ops.selective_scan_backward(*meta, meta[0], meta[5])
    assert [(t.shape, t.dtype) for t in grads] == \
        [(t.shape, t.dtype) for t in ins]


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_scan_custom_op_equals_the_plain_version_bit_for_bit(u_dtype):
    """Forward and backward through the op equal the plain version and its
    autograd on the CPU, bit for bit."""
    from repro_torch.kernels.selective_scan import selective_scan_plain
    ins = _scan_inputs()
    ins[1] = ins[1].to(u_dtype)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in ins]
        y, h = fn(*leaves)
        g = torch.Generator().manual_seed(1)
        dy = torch.randn(y.shape, generator=g)
        dh = torch.randn(h.shape, generator=g)
        return (y, h) + torch.autograd.grad((y, h), leaves, (dy, dh))

    got = run(torch.ops.repro_torch.selective_scan)
    want = run(selective_scan_plain)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.launch import mesh
    yield {"1x1": mesh.make_host_mesh(1, 1),
           "pod": mesh.make_production_mesh()}
    mesh.shutdown()


def test_scan_rule_splits_the_channels_on_16x16(meshes):
    """On the 16 x 16 mesh with the batch over data and the channels over
    model, the scan runs on each device's batch rows and channels; its
    backward leaves d b and d c as partial sums over the model axis and d
    a over the data axis. The walk counts each call once, by the scan's
    formula on the device's shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.kernels import ops
    m = meshes["pod"]
    b, t, d, s = 32, 64, 256, 16

    def dt(shape, *pl, dtype=torch.float32):
        local = list(shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= m.size(i)
        return DTensor.from_local(
            torch.empty(local, dtype=dtype, device="meta"), m, list(pl),
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()
        ).requires_grad_(True)

    R = Replicate()
    ins = [dt((b, t, d), Shard(0), Shard(2)),
           dt((b, t, d), Shard(0), Shard(2), dtype=torch.bfloat16),
           dt((b, t, s), Shard(0), R), dt((b, t, s), Shard(0), R),
           dt((d, s), R, Shard(0)), dt((b, d, s), Shard(0), Shard(1))]
    walk = op_cost.OpWalk(m, device="meta")
    with walk:
        y, h = ops.selective_scan(*ins)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(h.placements) == (Shard(0), Shard(1))
        assert y.to_local().shape == (2, t, 16)
        grads = torch.autograd.grad((y.sum(), h.sum()), ins)
    assert tuple(grads[2].placements)[1] == Partial()       # d b
    assert tuple(grads[3].placements)[1] == Partial()       # d c
    assert tuple(grads[4].placements)[0] == Partial()       # d a
    assert tuple(grads[0].placements) == (Shard(0), Shard(2))
    k = walk.result()["kernels"]
    assert k["selective_scan"]["calls"] == 1
    assert k["selective_scan"]["flops"] == 2 * t * 16 * s
    assert k["selective_scan_backward"]["calls"] == 1


def _real_and_traced(cfg, b, s, meshes, **kw):
    """(the real prefill's walk, the 1 x 1 trace's) of ``cfg``'s f32 smoke
    model on ``b x s`` random ids (and the family's other inputs)."""
    from repro_torch.models.registry import build_model
    from repro_torch.models.encdec import enc_len
    model = build_model(cfg, device="cpu", seed=0, **kw)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32,
                           generator=g)
    extra = {}
    if cfg.family == "vlm":
        extra["embeds"] = torch.randn(b, s, cfg.d_model, generator=g)
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(b, enc_len(s), cfg.d_model,
                                      generator=g)
    walk = op_cost.OpWalk(inputs=[*model.parameters(), *extra.values()]
                          + ([] if "embeds" in extra else [tokens]))
    with walk:
        logits, caches = model.prefill(None if "embeds" in extra
                                       else tokens, s, **extra)
        out = steps.greedy(logits), caches
    walk.add_outputs(out)
    fake = steps.plan_prefill(cfg, ShapeConfig("p", s, b, "prefill"),
                              meshes["1x1"]).trace()
    return walk.result(), fake


COUNT_CELLS = [("qwen3_moe_235b", {"moe_impl": "ep"}, {"model_ranks": 1},
                {"cscatter"}),
               ("kimi_k2_1t", {"moe_impl": "ep"}, {"model_ranks": 1},
                {"cscatter"}),
               ("llava_next_34b", {}, {}, set()),
               ("hymba_1_5b", {}, {}, {"selective_scan"}),
               ("seamless_m4t_medium", {}, {}, set()),
               ("xlstm_125m", {}, {}, None)]


@pytest.mark.parametrize("arch,over,kw,also", COUNT_CELLS,
                         ids=[c[0] for c in COUNT_CELLS])
def test_real_prefill_counts_equal_the_traced_ones(meshes, arch, over, kw,
                                                   also):
    """Each new family's count check on the CPU: FLOPs, kernel records
    and boundary bytes equal, the real prefill and its 1 x 1 trace. The
    MoE configs take the expert-parallel form at one model rank on both
    sides (the card's prefill at ``model_ranks=1``, the planner's 1 x 1
    mesh), the combine through ``cscatter``; hymba's SSM through the
    selective scan."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **over)
    real, fake = _real_and_traced(cfg, 2, 64, meshes, **kw)
    assert real["flops"] == fake["flops"] > 0
    assert real["kernels"] == fake["kernels"]
    assert real["boundary_bytes"] == fake["boundary_bytes"] > 0
    names = set(real["kernels"])
    if also is None:          # no attention: no kernel at all
        assert names == set()
    else:
        assert names == {"flash_attention"} | also
    if "cscatter" in names:
        assert real["kernels"]["cscatter"]["calls"] == \
            cfg.n_layers - cfg.first_dense_layers
    if "selective_scan" in names:
        assert real["kernels"]["selective_scan"]["calls"] == cfg.n_layers


def test_xlstm_extrapolated_over_time_equals_the_exact_trace(meshes):
    """A prefill and a train step of 1024 tokens, traced at 512 and 768
    and extrapolated, equal the exact trace: every count is affine in the
    length."""
    from repro_torch.launch import dryrun, hw_analysis as hw
    from repro_torch.launch import mesh as pmesh
    cfg = get_smoke_config("xlstm_125m")
    m = pmesh.make_host_mesh(2, 2)
    sizes, names = (2, 2), ("nvlink", "ib")
    for kind, b in (("prefill", 4), ("train", 4)):
        shape = ShapeConfig("t", 1024, b, kind)
        exact = dryrun.trace_cell(cfg, shape, m, sizes, names, exact=True)
        scaled = dryrun.trace_cell(cfg, shape, m, sizes, names)
        assert scaled["trip_counts"] == [4]
        assert scaled["traced_lengths"] == [512, 768]
        for key in ("flops", "hbm_bytes", "wire_bytes", "input_bytes",
                    "boundary_bytes", "peak_live_bytes"):
            assert scaled[key] == pytest.approx(exact[key], rel=1e-9), \
                (kind, key)
        assert scaled["wire_bytes_by_level"] == pytest.approx(
            exact["wire_bytes_by_level"])
        assert hw.roofline_terms(scaled["flops"], scaled["hbm_bytes"],
                                 scaled["wire_bytes"]) == pytest.approx(
            hw.roofline_terms(exact["flops"], exact["hbm_bytes"],
                              exact["wire_bytes"]))
