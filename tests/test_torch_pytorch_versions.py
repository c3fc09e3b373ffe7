"""Two places where the port would take a path that some PyTorch lacks.

* ``kernels/ref._select``: the plain scatter's final ``where`` on a uint32
  table goes through the signed view of its bits (PyTorch 2.11's CPU
  ``where`` has no uint32), and equals ``where`` on the values.
* ``models/module._bias_layout``: before a planned ``y + b`` whose product
  is a partial sum where the bias is split, the product is reduce-scattered
  onto the bias's split. That is the layout DTensor itself picks for the
  add on PyTorch 2.13 (so the planner's bytes do not move); 2.11 would make
  the bias a partial sum instead, which it cannot. Held on a smoke cell of
  the production mesh, where hymba's SSM projections meet it (on a PyTorch
  that cannot make the add without it, the cell still plans).
"""

import tempfile

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.int64,
                                   torch.float32])
def test_select_equals_where_for_every_dtype(dtype):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 2 ** 31 - 1, (16, 4), generator=g)
    b = torch.randint(0, 2 ** 31 - 1, (16, 4), generator=g)
    mask = torch.rand((16, 1), generator=g) < 0.5
    got = ref._select(mask, a.to(dtype), b.to(dtype))
    want = torch.where(mask, a, b)
    assert got.dtype == dtype
    if dtype.is_floating_point:
        assert torch.equal(got, want.to(dtype))
    else:
        assert torch.equal(got.to(torch.int64), want)


def test_uint32_scatter_reference_at_the_dtype_top():
    table = torch.from_numpy(np.full((4, 2), 2 ** 32 - 1, np.uint32))
    ids = torch.tensor([1, 1, 3], dtype=torch.int32)
    vals = torch.from_numpy(np.array([[5, 6], [7, 8], [1, 2]], np.uint32))
    got = ref.ref_cscatter(table, ids, vals, "min")
    want = table.to(torch.int64)
    want[1] = torch.tensor([5, 6])
    want[3] = torch.tensor([1, 2])
    assert torch.equal(got.to(torch.int64), want)


def test_bias_layout_is_the_layout_dtensor_picks():
    from torch.distributed.tensor import Partial, Shard

    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import module
    seen = []
    relay = module._bias_layout

    def recording(y, b):
        out = relay(y, b)
        if any(isinstance(yp, Partial) and isinstance(bp, Shard)
               for yp, bp in zip(y.placements, b.placements)):
            try:
                picked = (y + b).placements
            except RuntimeError:        # a PyTorch that cannot make it
                picked = None
            seen.append((picked, (out + b).placements, out.placements,
                         b.placements))
        return out
    module._bias_layout = recording
    try:
        with tempfile.TemporaryDirectory() as d:
            rec = dryrun.run_cell("hymba_1_5b", "prefill_32k", False, d,
                                  smoke=True)
    finally:
        module._bias_layout = relay
        mesh.shutdown()
    assert rec["status"] == "ok", rec.get("traceback")
    assert seen, "no partial product met a split bias"
    for picked, ours, laid, split in seen:
        assert picked in (None, ours)
        # the product no longer a partial sum where the bias is split
        assert not any(isinstance(yp, Partial) and isinstance(bp, Shard)
                       for yp, bp in zip(laid, split))
