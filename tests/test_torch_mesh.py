"""The planner's fake process group across lifetimes (``launch/mesh.py``).

A mesh made after ``mesh.shutdown()`` over the same ranks and axis names
equals one made before it, so DTensor's cached sharding decisions would
hand the new one's ops the old mesh, whose groups are gone or now name
other ranks: ``shutdown`` clears those caches. This trace runs in two
lifetimes whose groups are created in different orders.
"""

from repro_torch.configs.base import ShapeConfig, get_smoke_config


def _trace_twice():
    from repro_torch.launch import mesh, steps
    cfg = get_smoke_config("xlstm_125m")
    flops = []
    try:
        for lifetime in range(2):
            if lifetime:      # other groups first: other group names
                mesh.make_production_mesh()
            m = mesh.make_host_mesh(2, 2)
            flops.append(steps.plan_prefill(
                cfg, ShapeConfig("p", 256, 4, "prefill"), m).trace()["flops"])
            mesh.shutdown()
    finally:
        mesh.shutdown()
    return flops


def test_shutdown_clears_dtensor_caches():
    a, b = _trace_twice()
    assert a == b > 0

