"""The embedding lookup of the train path, with its backward through the
CUDA ``cscatter``.

The JAX package's ``DecoderLM._embed`` is the gather ``table[tokens]`` and
leaves its gradient to autodiff: ``dL/dE[v] = Σ_{n: id_n = v} g_n``, a
scatter-add of the output gradients into the table's rows. That is the
paper's commutative KV-store update at LM scale (``repro/kernels/ops.py``
``embedding_grad_scatter``), and the training data is Zipf-distributed, so
a few hot rows take most of the ids: the pattern ``cscatter`` privatizes
and merges.

:func:`embed`'s forward is the gather. Its backward allocates an f32
``[V, D]`` gradient, scatters the flattened output gradients into it with
``kernels.ops.embedding_grad_scatter`` — the CUDA ``cscatter`` on a CUDA
tensor (which launches the kernel or raises, never a silent plain path),
its plain version on a CPU tensor — and returns it cast to the table's
dtype. The accumulator is f32 because ``cscatter`` takes ``vals`` in the
table's dtype and accumulates a bf16 table in f32 inside the kernel
anyway: every row is summed in f32 and rounded once, where XLA's bf16
scatter-add may round at every add. With tied embeddings, autograd adds
the logits product's gradient to it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.core.mesh_axis import redistribute
from repro_torch.sharding.partition import dim_shards, local_inputs

Tensor = torch.Tensor


def _batch_and_rows(mesh, placements, tokens, vocab: int):
    """For a DTensor table of ``vocab`` rows laid out by ``placements``:
    (the ids' placements that keep each device's batch rows, whole
    sequences, and replicate them over the mesh dims that split the table's
    rows; those mesh dims; rows a device; its first row)."""
    from torch.distributed.tensor import Replicate, Shard
    dims, n_rows, first = dim_shards(mesh, placements, 0, vocab)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0
            and i not in dims else Replicate()
            for i, p in enumerate(tokens.placements)]
    return rows, dims, n_rows, first


def _sharded_grad(grad_out, tokens, placements, vocab: int, dtype):
    """The gradient of a DTensor table of ``vocab`` rows laid out by
    ``placements``: ``cscatter`` of each device's batch shard into its
    shard of rows, as a ``local_map``; a partial sum over the batch's mesh
    dims, which DTensor reduces onto ``placements``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = grad_out.device_mesh
    rows, dims, n_rows, first = _batch_and_rows(mesh, placements, tokens,
                                                vocab)
    # flattening [B, S] needs each device's whole sequences
    ids = redistribute(tokens, rows).reshape(-1)
    g = redistribute(grad_out, rows).reshape(-1, grad_out.shape[-1])
    out = [Shard(0) if i in dims else Partial() if p == Shard(0)
           else Replicate() for i, p in enumerate(rows)]

    def local(g_loc, ids_loc):
        grad = torch.zeros((n_rows, g_loc.shape[-1]), dtype=torch.float32,
                           device=g_loc.device)
        ops.embedding_grad_scatter(grad, (ids_loc - first).to(torch.int32),
                                   g_loc.float())
        return grad

    grad = local_map(local, out_placements=out, in_placements=(rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(g, ids)
    return redistribute(grad, placements).to(dtype)


def sharded_lookup(table, tokens):
    """``table[tokens]`` of a DTensor table (the planner's), as a
    ``local_map``: each device looks up the ids of its rows (the table's
    columns gathered), zeros elsewhere, and the result is a partial sum
    over the mesh dims that split the rows (vocab parallelism)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    ids_in, dims, n_rows, first = _batch_and_rows(
        mesh, table.placements, tokens, table.shape[0])
    t_in = [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)]
    out = [Partial() if i in dims else p for i, p in enumerate(ids_in)]

    def local(t, ids):
        if not dims:                  # every device holds every row
            return t[ids]
        ids = ids.long() - first
        hit = (ids >= 0) & (ids < n_rows)
        rows = t[ids.clamp(0, n_rows - 1)]
        return rows * hit[..., None].to(rows.dtype)

    return local_map(local, out_placements=out, in_placements=(t_in, ids_in),
                     device_mesh=mesh)(*local_inputs((table, tokens),
                                                     (t_in, ids_in)))


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: Tensor, tokens: Tensor) -> Tensor:
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        ctx.placements = getattr(table, "placements", None)
        if ctx.placements is not None:
            return sharded_lookup(table, tokens)
        return table[tokens]

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        (tokens,) = ctx.saved_tensors
        if ctx.placements is not None:
            return _sharded_grad(grad_out, tokens, ctx.placements,
                                 ctx.table_shape[0], ctx.table_dtype), None
        v, d = ctx.table_shape
        grad = torch.zeros((v, d), dtype=torch.float32,
                           device=grad_out.device)
        ops.embedding_grad_scatter(
            grad, tokens.reshape(-1).to(torch.int32).contiguous(),
            grad_out.reshape(-1, d).float().contiguous())
        return grad.to(ctx.table_dtype), None


def embed(table: Tensor, tokens: Tensor) -> Tensor:
    """``table [V, D]`` at ``tokens`` (any shape) -> ``[*tokens.shape, D]``;
    differentiable in ``table`` through the ``cscatter`` backward."""
    return _Embed.apply(table, tokens)
