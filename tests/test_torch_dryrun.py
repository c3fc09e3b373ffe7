"""The production-mesh dry-run of the port: the roofline formulas and the
ring model against the JAX package's, the op-level walk against counts
computed independently, the kernels' custom ops, and the CLI's smoke cell.

Held to JAX: ``roofline_terms``, ``level_bandwidths``,
``collective_time_by_level`` and ``dci_bytes`` given JAX's rates (read from
its module here); ``roofline.table`` on the same records; each collective
kind's level vector against ``hlo_cost.analyze_hlo`` on HLO text with the
same replica groups. Held to the port's own numbers: the walk's FLOPs on a
1 x 1 mesh against an analytic count from the config; per-device product
FLOPs on 16 x 16 against the 1-device count / 256 where every dim divides;
the layer-scaled walk against the whole one; each kernel's fake shape
against its plain output.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, get_smoke_config
from repro_torch.launch import hw_analysis as hw
from repro_torch.launch import op_cost, steps

ROOT = Path(__file__).resolve().parents[1]


def _jax_rates():
    from repro.launch import hlo_analysis as h
    return hw.Rates(peak_flops=h.PEAK_FLOPS, hbm_bw=h.HBM_BW,
                    link_bw=h.ICI_BW, top_bw=h.DCI_BW,
                    level_bw=tuple(h.LEVEL_BW.items()))


NAMES = [None, ("chip",), ("chip", "host"), ("chip", "host", "pod"),
         ("chip", "x", "y", "dci"), ("a", "b", "c")]


@pytest.mark.parametrize("names", NAMES)
def test_level_bandwidths_and_dci_bytes_match_jax(names):
    from repro.launch import hlo_analysis as h
    rates = _jax_rates()
    for n in (1, 2, 3, 4):
        nm = names[:n] if names else None
        assert hw.level_bandwidths(n, nm, rates) == h.level_bandwidths(n, nm)
        vec = [1e9 * (i + 1) for i in range(n)]
        assert hw.dci_bytes(vec, nm, rates) == h.dci_bytes(vec, nm)
        assert hw.collective_time_by_level(vec, names=nm, rates=rates) == \
            h.collective_time_by_level(vec, names=nm)


@pytest.mark.parametrize("case", [
    (1e15, 1e12, 1e10, 0.0, None, None),
    (1e12, 1e13, 1e9, 2e8, None, None),
    (1e14, 1e11, 5e10, 0.0, [3e10, 1.5e10, 5e9], ("chip", "host", "pod")),
    (1e9, 1e9, 1e12, 0.0, [1e12, 0.0], None),
])
def test_roofline_terms_match_jax(case):
    from repro.launch import hlo_analysis as h
    f, m, w, inter, vec, names = case
    assert hw.roofline_terms(f, m, w, inter, vec, names, _jax_rates()) == \
        h.roofline_terms(f, m, w, inter, vec, names)


def test_h100_levels_of_the_production_meshes():
    assert hw.mesh_levels({"data": 16, "model": 16}) == ((8, 32),
                                                         ("nvlink", "ib"))
    assert hw.mesh_levels({"pod": 2, "data": 16, "model": 16}) == (
        (8, 32, 2), ("nvlink", "ib", "pod"))
    assert hw.level_bandwidths(3, ("nvlink", "ib", "pod")) == [
        450e9, 50e9, 50e9]


def _record(arch, shape, mesh, status="ok", dominant="compute", fits=True):
    r = {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
         "_file": f"{arch}__{shape}__{mesh}.json"}
    if status == "ok":
        r["roofline"] = {"compute_s": 1.5, "memory_s": 2e-3,
                         "collective_s": 3e-6, "dominant": dominant,
                         "bound_s": 1.5}
        r["useful_flops_ratio"] = 0.75
        r["memory"] = {"live_bytes_per_device": 5 * 1024**3,
                       "fits_16gb_hbm": fits, "fits_80gb_hbm": fits}
    return r


def test_roofline_table_rows_match_jax():
    from repro.launch import roofline as jax_roofline
    from repro_torch.launch import roofline
    cells = [_record("a", "train_4k", "pod16x16"),
             _record("b", "decode_32k", "pod2x16x16", dominant="memory",
                     fits=False),
             _record("c", "prefill_32k", "pod16x16", status="error")]
    got = roofline.table(cells).splitlines()
    want = jax_roofline.table(cells).splitlines()
    assert got[1:] == want[1:]
    assert roofline.table(cells, mesh="pod16x16").splitlines()[1:] == \
        jax_roofline.table(cells, mesh="pod16x16").splitlines()[1:]


def test_floor_table_pairs_the_meshes_of_a_cell():
    """``roofline.floor_table``: one row an (arch, shape), each figure
    once where the two meshes agree and both, single-pod first, where they
    differ; a cell past 80 GB says NO."""
    from repro_torch.launch import roofline

    def rec(mesh, flops, live):
        r = _record("a", "train_4k", mesh)
        r["memory"].update(live_bytes_per_device=live,
                           boundary_bytes_per_device=1e6)
        r["op_walk"] = {"flops": flops, "hbm_bytes": 2e9,
                        "wire_bytes_by_level": [1e9, 0.0]}
        r["roofline_floor"] = dict(r["roofline"], memory_s=3e-7)
        return r
    rows = roofline.floor_table([rec("pod2x16x16", 5e14, 90e9),
                                 rec("pod16x16", 1e15, 90e9),
                                 _record("b", "decode_32k", "pod16x16",
                                         status="error")]).splitlines()
    assert len(rows) == 3
    cols = [c.strip() for c in rows[2].split("|")[1:-1]]
    assert cols[0] == "a train_4k"
    assert cols[1] == "1e+15; 5e+14"
    assert cols[2] == "2e+09" and cols[4] == "1e+09/0"
    assert cols[7] == "compute, compute" and cols[8] == "90 NO"
    assert cols[9] == "0.75"


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.launch import mesh
    yield {"pod": mesh.make_production_mesh(),
           "multipod": mesh.make_production_mesh(multi_pod=True),
           "1x1": mesh.make_host_mesh(1, 1),
           "2x2": mesh.make_host_mesh(2, 2)}
    mesh.shutdown()


_HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all"}


@pytest.mark.parametrize("kind", list(_HLO_OPS))
@pytest.mark.parametrize("axis", ["model", "data", "pod"])
def test_collective_level_vector_matches_the_hlo_walk(meshes, kind, axis):
    """A collective over one mesh axis of the two-pod mesh: the walk's
    machine-wide level vector equals the HLO walk's on a module whose
    replica groups are that axis's groups."""
    from repro.launch import hlo_cost
    m = meshes["multipod"]
    dim = m.mesh_dim_names.index(axis)
    sizes, names = hw.mesh_levels(dict(zip(m.mesh_dim_names, m.shape)))
    walk = op_cost.OpWalk(m, sizes, names)
    out = torch.empty(64, 32, device="meta")
    walk._count_collective(kind, (None, m.get_group(dim).group_name), out)
    groups = walk._mesh_groups(m)[m.get_group(dim).group_name]
    rg = ",".join("{" + ",".join(map(str, g)) + "}" for g in groups)
    hlo = (f"HloModule t, num_partitions=512\n"
           f"ENTRY %main (p0: f32[64,32]) -> f32[64,32] {{\n"
           f"  %p0 = f32[64,32]{{1,0}} parameter(0)\n"
           f"  ROOT %c = f32[64,32]{{1,0}} {_HLO_OPS[kind]}(%p0), "
           f"replica_groups={{{rg}}}\n}}\n")
    want = hlo_cost.analyze_hlo(hlo, level_sizes=sizes, level_names=names)
    assert walk.by_level_total == pytest.approx(
        want["wire_bytes_by_level_total"])
    assert walk.wire_bytes == pytest.approx(want["wire_bytes"])
    res = walk.result()
    assert res["wire_bytes_by_level"] == pytest.approx(
        want["wire_bytes_by_level"])
    if axis == "model":        # 16 ranks span two 8-GPU nodes
        assert res["wire_bytes_by_level"][1] > 0


def _analytic_prefill_flops(cfg, b, s):
    """Products and flash of a causal prefill of ``b x s`` tokens on one
    device, from the config alone."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    t = b * s
    proj = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
    mlp = (2 if cfg.mlp == "gelu" else 3) * 2 * t * d * f
    flash = 4 * b * h * hd * s * (s + 1) // 2
    logits = 2 * b * d * cfg.padded_vocab
    return cfg.n_layers * (proj + mlp + flash) + logits, flash * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "internlm2_1_8b",
                                  "granite_34b", "llama3_405b"])
def test_walk_flops_on_one_device_match_the_analytic_count(meshes, arch):
    cfg = get_smoke_config(arch)
    b, s = 2, 64
    walk = steps.plan_prefill(cfg, ShapeConfig("p", s, b, "prefill"),
                              meshes["1x1"]).trace((1,), ("nvlink",))
    want, flash = _analytic_prefill_flops(cfg, b, s)
    assert walk["flops"] == want
    assert walk["kernels"]["flash_attention"] == {
        "calls": cfg.n_layers, "flops": float(flash),
        "hbm_bytes": pytest.approx(walk["kernels"]["flash_attention"]
                                   ["hbm_bytes"])}
    assert walk["wire_bytes"] == 0


def test_products_split_evenly_over_16x16(meshes):
    """Where every dim divides the mesh, a device does 1/256 of the
    products."""
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"), d_model=256,
                              n_heads=16, n_kv_heads=16, d_ff=512,
                              vocab=4096)
    shape = ShapeConfig("p", 64, 16, "prefill")

    def products(walk):
        return sum(v["flops"] for k, v in walk["by_op"].items()
                   if k in ("mm", "bmm", "addmm"))

    one = steps.plan_prefill(cfg, shape, meshes["1x1"]).trace()
    many = steps.plan_prefill(cfg, shape, meshes["pod"]).trace((8, 32),
                                                               ("nvlink",
                                                                "ib"))
    assert products(one) > 0
    assert products(many) == products(one) / 256
    assert many["kernels"]["flash_attention"]["flops"] == \
        one["kernels"]["flash_attention"]["flops"] / 256


def test_layer_scaled_walk_equals_the_whole_one(meshes, monkeypatch):
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), n_layers=5)
    shape = ShapeConfig("t", 32, 8, "train")
    sizes, names = (2, 2), ("nvlink", "ib")
    whole = dryrun.trace_cell(cfg, shape, meshes["2x2"], sizes, names,
                              exact=True)
    monkeypatch.setattr(dryrun, "SCALE_ABOVE", 3)
    scaled = dryrun.trace_cell(cfg, shape, meshes["2x2"], sizes, names)
    assert scaled["trip_counts"] == [5] and scaled["traced_layers"] == [2, 3]
    for key in ("flops", "hbm_bytes", "wire_bytes", "input_bytes"):
        assert scaled[key] == pytest.approx(whole[key], rel=1e-9), key
    assert scaled["wire_bytes_by_level"] == pytest.approx(
        whole["wire_bytes_by_level"])


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_custom_ops_fake_shapes_match_the_plain_outputs():
    from repro_torch.kernels import custom_ops  # noqa: F401 (registers)
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, 16, generator=g)
    k = torch.randn(2, 2, 8, 16, generator=g)
    ops = torch.ops.repro_torch
    want = flash_attention_plain(q, k, k, causal=True)
    got = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                              True, 0)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert torch.equal(ops.flash_attention(q, k, k, True, 0), want)
    qd, kd = torch.randn(2, 4, 16, generator=g), torch.randn(2, 8, 2, 16,
                                                             generator=g)
    want = decode_attention_plain(qd, kd, kd, 5)
    got = ops.decode_attention(qd.to("meta"), kd.to("meta"), kd.to("meta"),
                               5)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    out, lse = ops.decode_attention_lse(qd, kd, kd, 5)
    assert torch.allclose(out, want, atol=1e-6)
    fo, fl = ops.decode_attention_lse(qd.to("meta"), kd.to("meta"),
                                      kd.to("meta"), 5)
    assert (fo.shape, fl.shape, fl.dtype) == (out.shape, lse.shape,
                                              torch.float32)
    scores = torch.einsum("bkgd,btkd->bkgt", qd.reshape(2, 2, 2, 16),
                          kd[:, :6]) / 4.0
    assert torch.allclose(lse, torch.logsumexp(scores, -1).reshape(2, 4),
                          atol=1e-5)
    table = torch.zeros(16, 4)
    ids = torch.tensor([1, 3, 1, -1], dtype=torch.int32)
    vals = torch.ones(4, 4)
    ops.cscatter(table, ids, vals, "add", 0.0, 0.0)
    assert table[1].tolist() == [2.0] * 4 and table.sum() == 12
    ops.cscatter(_meta(16, 4, dtype=torch.float32), ids.to("meta"),
                 vals.to("meta"), "add", 0.0, 0.0)


def test_custom_ops_shard_by_their_dtensor_rules(meshes):
    """On DTensors each op keeps the batch or head split it is given (its
    registered rule), and ``cscatter`` the column split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    m = meshes["2x2"]

    def dt(local, *pl):
        return DTensor.from_local(local, m, list(pl), run_check=False)

    q = dt(_meta(2, 4, 8, 16), Shard(0), Shard(1))
    k = dt(_meta(2, 2, 8, 16), Shard(0), Shard(1))
    out = ops.flash_attention(q, k, k)
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert out.to_local().shape == (2, 4, 8, 16)
    qd = dt(_meta(2, 4, 16), Shard(0), Shard(1))
    kd = dt(_meta(2, 8, 2, 16), Shard(0), Shard(2))
    o = ops.decode_attention(qd, kd, kd, 7)
    assert tuple(o.placements) == (Shard(0), Shard(1))
    table = dt(_meta(16, 4, dtype=torch.float32), Replicate(), Shard(1))
    ids = dt(torch.empty(4, dtype=torch.int32, device="meta"), Replicate(),
             Replicate())
    vals = dt(_meta(4, 4, dtype=torch.float32), Replicate(), Shard(1))
    assert ops.commutative_scatter(table, ids, vals) is table
    walk = op_cost.OpWalk(m, device="meta")
    with walk:
        ops.flash_attention(q, k, k)
    assert walk.kernels["flash_attention"]["calls"] == 1
    assert walk.kernels["flash_attention"]["flops"] == \
        4.0 * 2 * 4 * 16 * (8 * 9 // 2)


def test_the_plain_kernels_count_once_by_their_formula():
    """On the CPU a wrapper runs its plain version: the walk counts the
    call by the kernel's formula and none of the plain version's ops."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 2, 16, 8)
    walk = op_cost.OpWalk()
    with walk:
        ops.flash_attention(q, q, q)
    assert walk.kernels["flash_attention"]["calls"] == 1
    assert walk.flops == 4.0 * 2 * 8 * (16 * 17 // 2)
    assert walk.hbm_bytes == 4 * q.numel() * 4
    assert "bmm" not in walk.by_op and "exp" not in walk.by_op


def test_boundary_bytes_count_inputs_and_fresh_outputs_once():
    """The floor's bytes: every input storage once, every output storage
    that is not an input's once (an in-place result adds nothing, nor does
    a view of an output counted already), whatever the program moves in
    between."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    walk = op_cost.OpWalk(inputs=[a, b])
    with walk:
        c = (a @ b).relu()
        a.add_(1.0)
    walk.add_outputs({"c": c, "c_view": c[:4], "a": a})
    res = walk.result()
    assert res["input_bytes"] == a.nbytes + b.nbytes
    assert res["output_bytes"] == c.nbytes
    assert res["boundary_bytes"] == a.nbytes + b.nbytes + c.nbytes
    assert res["hbm_bytes"] > res["boundary_bytes"]     # the eager traffic


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
def test_floor_bytes_of_a_plan_are_its_inputs_and_outputs(meshes, kind):
    """On a 1 x 1 mesh a plan's boundary bytes are its input specs' bytes
    (parameters, batch, caches, optimizer state), plus for training the
    updated parameters and state written anew."""
    from repro_torch.models.layout import Spec
    cfg = get_smoke_config("qwen1_5_0_5b")
    base = SHAPES[kind]
    shape = ShapeConfig(base.name, 64, 4, base.kind)
    plan = steps.plan_for(cfg, shape, meshes["1x1"])
    specs = [x for x in torch.utils._pytree.tree_leaves(
        plan.in_specs, is_leaf=lambda x: isinstance(x, Spec))
        if isinstance(x, Spec)]
    want = sum(math.prod(x.shape) * x.dtype.itemsize for x in specs)
    walk = plan.trace()
    assert walk["input_bytes"] == want
    assert walk["boundary_bytes"] == want + walk["output_bytes"]
    if base.kind == "train":
        params = sum(math.prod(x.shape) * x.dtype.itemsize for x in
                     torch.utils._pytree.tree_leaves(
                         plan.in_specs[0],
                         is_leaf=lambda x: isinstance(x, Spec)))
        assert walk["output_bytes"] >= params
    else:     # the tokens the step picks; the caches are filled in place
        assert walk["output_bytes"] == shape.global_batch * 4


def test_dryrun_smoke_cell_on_production_mesh(tmp_path):
    """The JAX package's CLI test, ported: one smoke cell on the two-pod
    mesh, in a subprocess (the fake process group is per process)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1-8b", "--shape", "train_4k", "--smoke", "--multipod",
         "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dominant=" in r.stdout and "floor=" in r.stdout
    import json
    rec = json.loads((tmp_path / "internlm2_1_8b__train_4k__pod2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["op_walk"]["level_names"] == ["nvlink", "ib", "pod"]
    assert rec["memory"]["fits_80gb_hbm"] is True
    floor = rec["roofline_floor"]
    assert floor["compute_s"] == rec["roofline"]["compute_s"]
    assert 0 < floor["memory_s"] < rec["roofline"]["memory_s"]
    assert floor["bound_s"] <= rec["roofline"]["bound_s"]
    assert rec["op_walk"]["kernels"]["cscatter"]["calls"] == 1
    assert "defer_schedule" in rec and "defer_schedule_overlap" in rec
    assert math.isclose(sum(rec["op_walk"]["wire_bytes_by_level"]),
                        sum(v["wire_bytes_by_level_total"][i]
                            for v in rec["per_collective"].values()
                            for i in range(3)) / 512)


def test_real_prefill_flops_equal_the_traced_ones(meshes):
    """The count check on the CPU: qwen1.5-0.5b's smoke prefill in f32 run
    for real under the walk (flash's plain version counted once, by its
    formula) and traced on a 1 x 1 mesh give the same FLOPs. (The HBM bytes
    are held equal on the card: the plain version returns another layout
    than the kernel, which the heads' merge then copies.)"""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"),
                              dtype="float32")
    b, s = 2, 64
    model = build_model(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32)
    before = fa.flash_attention.launches
    walk = op_cost.OpWalk(inputs=[*model.parameters(), tokens])
    with walk:
        logits, caches = model.prefill(tokens, s)
        out = steps.greedy(logits), caches
    walk.add_outputs(out)
    real = walk.result()
    fake = steps.plan_prefill(cfg, ShapeConfig("p", s, b, "prefill"),
                              meshes["1x1"]).trace()
    assert real["flops"] == fake["flops"] > 0
    # the caches are the plan's input and the real prefill's output
    assert real["boundary_bytes"] == fake["boundary_bytes"] > 0
    assert real["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert real["kernels"] == fake["kernels"]
    assert fa.flash_attention.launches == before      # the plain version


def test_no_dtensor_result_is_a_strided_shard(meshes, monkeypatch):
    """A train step with the residual split by sequence (``seq_res`` on the
    model axis) and a composite batch never makes DTensor flatten a split
    inner dim (a ``_StridedShard``), which the card's PyTorch refuses and
    whose redistributions cost minutes to plan."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.launch import mesh
    strided = []
    inner = op_cost.OpWalk.__torch_dispatch__

    def watch(self, func, types, args=(), kwargs=None):
        out = inner(self, func, types, args, kwargs)
        if out is NotImplemented:
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, DTensor) and any(
                        isinstance(p, _StridedShard) for p in o.placements):
                    strided.append(str(func))
        return out

    monkeypatch.setattr(op_cost.OpWalk, "__torch_dispatch__", watch)
    m = mesh._mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                              microbatches={"t": 2})
    steps.plan_train(cfg, ShapeConfig("t", 32, 8, "train"), m,
                     extra_rules={"seq_res": "model"}).trace((2, 2, 2))
    assert not strided
