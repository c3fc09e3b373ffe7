"""Smoke cells of the MoE, VLM, hybrid, encoder-decoder and xLSTM families
on the 16 x 16 production mesh: each (arch, applicable shape) planned
``ok`` through ``launch/dryrun.run_cell`` with its smoke config (sequence
cut to 512, batch to 32), nothing allocated, with the kernels of its path
counted.

The MoE smoke configs take the expert-parallel form here (``moe_impl
"ep"``, 16 experts: the model axis must split them), as the full configs
do on the production meshes.
"""

import pytest

from repro_torch.configs.base import ARCH_IDS, applicable_shapes, get_config

NEW = [a for a in ARCH_IDS if get_config(a).family != "dense"]
CELLS = [(a, s) for a in NEW for s in applicable_shapes(get_config(a))]
OVERRIDES = {"moe": {"moe_impl": "ep", "n_experts": 16}}

# the kernels each family's step calls, by the step's kind
ATTENTION = {"train": set(), "prefill": {"flash_attention"},
             "decode": {"decode_attention"}}
ALSO = {"moe": {"train": {"cscatter"}, "prefill": {"cscatter"},
                "decode": {"cscatter"}},
        "vlm": {},
        "hybrid": {"train": {"selective_scan", "selective_scan_backward",
                             "cscatter"},
                   "prefill": {"selective_scan"}},
        "encdec": {"train": {"cscatter"}},
        "ssm": {"train": {"cscatter"}}}


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    from repro_torch.launch import mesh
    yield
    mesh.shutdown()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_plans_ok_on_the_production_mesh(arch, shape, tmp_path):
    from repro_torch.launch import dryrun
    family = get_config(arch).family
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path), smoke=True,
                          overrides=OVERRIDES.get(family))
    assert rec["status"] == "ok", rec.get("traceback")
    walk = rec["op_walk"]
    assert walk["flops"] > 0 and walk["wire_bytes"] > 0
    kind = rec["kind"]
    want = (set() if family == "ssm" else ATTENTION[kind]) | \
        ALSO[family].get(kind, set())
    assert set(walk["kernels"]) == want
    assert rec["memory"]["fits_80gb_hbm"]
    assert rec["roofline_floor"]["bound_s"] <= rec["roofline"]["bound_s"]
