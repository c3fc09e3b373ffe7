"""Which gloo collectives take tensors on the card, on this PyTorch.

Card only. Each collective runs in a fresh pair of processes on a gloo
group with their tensors on the card (one card shared), so that one that
kills its process (a crash in the backend, not an exception) is reported
and the next still runs:

    python scripts/gloo_card_collectives.py

One line a collective: its name, the two processes' exit codes and rank
0's result or error. ``core/mesh_axis.redistribute`` stages through the
host exactly the gathers this reports as failing.
"""

import json
import subprocess
import sys
import tempfile

OPS = ["all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "funcol_all_gather", "funcol_reduce_scatter",
       "funcol_all_reduce", "dtensor_shard_to_replicate",
       "dtensor_partial_to_shard", "dtensor_partial_to_replicate",
       "all_to_all_single", "funcol_all_to_all_single",
       "dtensor_shard_to_shard", "gather"]


def _worker(op: str, rank: int, init: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2)
    mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
    x = torch.arange(4.0, device="cuda") + rank
    wait = torch.ops._c10d_functional.wait_tensor

    def run():
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return y
        if op == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return y
        if op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            return torch.cat(parts)
        if op == "all_gather_into_tensor":
            y = torch.empty(8, device="cuda")
            dist.all_gather_into_tensor(y, x)
            return y
        if op == "reduce_scatter_tensor":
            y = torch.empty(2, device="cuda")
            dist.reduce_scatter_tensor(y, x)
            return y
        if op == "funcol_all_gather":
            return wait(funcol.all_gather_tensor(x, 0, mesh))
        if op == "funcol_reduce_scatter":
            return wait(funcol.reduce_scatter_tensor(x, "sum", 0, mesh))
        if op == "funcol_all_reduce":
            return wait(funcol.all_reduce(x, "sum", mesh))
        if op == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return y
        if op == "funcol_all_to_all_single":
            return wait(funcol.all_to_all_single(x, None, None, mesh))
        if op == "dtensor_shard_to_shard":
            return DTensor.from_local(x.reshape(2, 2), mesh, [Shard(0)]
                                      ).redistribute(mesh, [Shard(1)]
                                                     ).to_local()
        if op == "gather":
            parts = ([torch.empty_like(x) for _ in range(2)] if rank == 0
                     else None)
            dist.gather(x, parts, dst=0)
            return torch.cat(parts) if rank == 0 else x
        if op == "dtensor_shard_to_replicate":
            return DTensor.from_local(x, mesh, [Shard(0)]).redistribute(
                mesh, [Replicate()]).to_local()
        placement = Shard(0) if op == "dtensor_partial_to_shard" \
            else Replicate()
        return DTensor.from_local(x, mesh, [Partial()]).redistribute(
            mesh, [placement]).to_local()

    try:
        got = run()
        torch.cuda.synchronize()
        result = "ok " + str(got.tolist())
    except Exception as e:                  # noqa: BLE001 - reported
        result = "raised " + repr(e)[:200]
    with open(out, "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card")
    print(torch.__version__, torch.cuda.get_device_name(0))
    for op in OPS:
        work = tempfile.mkdtemp()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", op, str(r),
             f"{work}/init", f"{work}/r{r}.json"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for r in range(2)]
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append("timeout")
        try:
            with open(f"{work}/r0.json") as f:
                result = json.load(f)
        except OSError:
            result = "no result: the process died"
        print(op, codes, result, flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
