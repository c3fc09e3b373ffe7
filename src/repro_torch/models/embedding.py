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

Tensor = torch.Tensor


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: Tensor, tokens: Tensor) -> Tensor:
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        (tokens,) = ctx.saved_tensors
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
