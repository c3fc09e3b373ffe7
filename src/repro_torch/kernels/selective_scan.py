"""selective_scan: the selective SSM recurrence, forward and backward.

No Pallas original: the JAX package runs this recurrence as
``repro/models/ssm.py``'s chunked ``jax.lax.associative_scan``
(``_ssm_params``, ``_scan_chunk`` and the ``einsum("btds,bts->btd")`` of
``apply_seq``), which that module calls the TPU adaptation of the CUDA
selective-scan kernel. For ``dt, u [B, T, D]`` (dt after softplus, f32; u
f32 or bf16), ``b, c [B, T, S]`` f32, ``a [D, S]`` f32 (``-exp(a_log)``)
and ``h0 [B, D, S]`` f32 it computes

    h_t = exp(dt_t a) * h_{t-1} + (dt_t u_t) b_t,    y_t = sum_s h_t c_t

and returns ``(y [B, T, D] f32, h_T [B, D, S] f32)``.

* On a CUDA tensor, :func:`selective_scan` is a ``torch.autograd.Function``
  over the hand-written kernels of ``csrc/selective_scan.cu`` (its header
  says what bounds them): time is cut into chunks of :data:`SEGMENT`
  steps, each channel's states spread over several lanes. The forward
  (three launches) takes each chunk's local end state and decay product,
  walks the chunks for their true start states (the backward's
  checkpoints, h_T last) and runs each chunk again from its start for y;
  the backward (four launches) chains the adjoint over the chunks the same
  way, walks each chunk in reverse with its true carry, then adds the
  per-CTA partials of the sums over channels in a fixed order (two calls
  give the same bits). It takes ``S`` in :data:`DSTATES` and raises on
  anything else; it never falls back. ``selective_scan.launches`` counts
  every launch, ``launches_forward`` and ``launches_backward`` each
  direction's (:data:`LAUNCHES_PER_CALL` a call).
* On a CPU tensor it runs :func:`selective_scan_plain`, the JAX module's
  chunk loop in plain PyTorch (its gradient from autograd), which the tests
  hold against JAX and ``chip_smoke.py`` holds the kernels against.
* On a planner's tensor (a DTensor, a meta or a fake tensor) it takes the
  custom op ``repro_torch::selective_scan`` (``kernels/custom_ops.py``:
  its shape function, its sharding rule and its backward op); a concrete
  tensor launches directly, as before.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.custom_ops import kernel_call

Tensor = torch.Tensor
DSTATES = (4, 8, 16)
U_DTYPES = (torch.float32, torch.bfloat16)
SEGMENT = 64                # the chunk, the checkpoint spacing (csrc kChunk)
LAUNCHES_PER_CALL = {"forward": 3, "backward": 4}


def _check(dt: Tensor, u: Tensor, b: Tensor, c: Tensor, a: Tensor,
           h0: Tensor) -> None:
    if dt.dim() != 3 or u.shape != dt.shape:
        raise ValueError(f"selective_scan: want dt = u [B,T,D]; got "
                         f"{tuple(dt.shape)}, {tuple(u.shape)}")
    bsz, t, d = dt.shape
    s = a.shape[-1]
    if (a.shape != (d, s) or b.shape != (bsz, t, s) or c.shape != b.shape
            or h0.shape != (bsz, d, s)):
        raise ValueError(f"selective_scan: shapes disagree: dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    if u.dtype not in U_DTYPES:
        raise TypeError(f"selective_scan: u dtype {u.dtype} not in "
                        f"{U_DTYPES}")
    for name, x in (("dt", dt), ("b", b), ("c", c), ("a", a), ("h0", h0)):
        if x.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} must be f32, got "
                            f"{x.dtype}")
    if len({x.device for x in (dt, u, b, c, a, h0)}) != 1:
        raise ValueError("selective_scan: tensors on different devices")


def _scan_chunk(da: Tensor, dbx: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """The first-order recurrence ``h_t = da_t * h_{t-1} + dbx_t`` over a
    chunk's axis 1, from ``h0``: a Hillis-Steele scan of the pairs ``(a,
    b)`` under ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``, log2(chunk)
    rounds, each built out of place, so that autograd, where it runs (the
    CPU, and the plain reference on the card), keeps every round. ->
    (h [B, c, ...], h at the chunk's end)."""
    t = da.shape[1]
    b = torch.cat([dbx[:, :1] + da[:, :1] * h0[:, None], dbx[:, 1:]], dim=1)
    a = da
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < t:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]


def selective_scan_plain(dt: Tensor, u: Tensor, b: Tensor, c: Tensor,
                         a: Tensor, h0: Tensor, chunk: int = 256
                         ) -> tuple[Tensor, Tensor]:
    """The JAX module's chunk loop in plain PyTorch, on any device: per
    chunk of ``chunk`` steps ``da = exp(dt * a)`` and ``dbx = (dt * u) *
    b`` (``[B, chunk, D, S]`` f32), the Hillis-Steele :func:`_scan_chunk`
    from the previous chunk's last state, and ``y = einsum("btds,bts->btd",
    h, c)``. Differentiable by autograd. -> (y [B, T, D] f32, h_T)."""
    _check(dt, u, b, c, a, h0)
    t = dt.shape[1]
    chunk = min(chunk, t)
    h, ys = h0, []
    for i in range(0, t, chunk):
        sl = slice(i, i + chunk)
        d_t = dt[:, sl]
        da = torch.exp(d_t[..., None] * a)
        dbx = (d_t * u[:, sl].float())[..., None] * b[:, sl, None, :]
        h_seq, h = _scan_chunk(da, dbx, h)
        del da, dbx
        ys.append(torch.einsum("btds,bts->btd", h_seq, c[:, sl]))
        del h_seq
    # h_T in its own storage, as the kernel's (not a view of the last
    # chunk's states)
    return torch.cat(ys, dim=1), h.clone()


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("selective_scan")
    if lib.selective_scan_fwd_launch.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.selective_scan_chunk.restype = i32
        lib.selective_scan_chunk.argtypes = []
        if lib.selective_scan_chunk() != SEGMENT:
            raise RuntimeError(f"selective_scan: the library's chunk is "
                               f"{lib.selective_scan_chunk()}, SEGMENT "
                               f"{SEGMENT}")
        lib.selective_scan_fwd_launch.restype = i32
        lib.selective_scan_fwd_launch.argtypes = (
            [p, p, i32] + [p] * 8 + [i64] * 3 + [i32, p])
        lib.selective_scan_bwd_launch.restype = i32
        lib.selective_scan_bwd_launch.argtypes = (
            [p, p, i32] + [p] * 15 + [i64] * 3 + [i32, p])
        lib.selective_scan_bwd_partials.restype = i32
        lib.selective_scan_bwd_partials.argtypes = [i64]
    return lib


def _ptr(x: Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def launch_forward(dt: Tensor, u: Tensor, b: Tensor, c: Tensor, a: Tensor,
                   h0: Tensor, checkpoints: bool = True
                   ) -> tuple[Tensor, Tensor, Tensor | None]:
    """The forward kernels (three launches) on contiguous CUDA inputs ->
    (y, h_T, the chunks' start states ``[B, ceil(T / SEGMENT) + 1, D, S]``
    with h_T last, or None). The start states are made either way: the
    last launch runs each chunk from its own."""
    bsz, t, d = dt.shape
    s = a.shape[1]
    nc = -(-t // SEGMENT)
    f32 = dict(dtype=torch.float32, device=dt.device)
    y = torch.empty_like(dt)
    h_last = torch.empty_like(h0)
    ckpt = torch.empty((bsz, nc + 1, d, s), **f32)
    scratch = torch.empty((2, bsz, nc, d, s), **f32)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = _lib().selective_scan_fwd_launch(
            dt.data_ptr(), u.data_ptr(), int(u.dtype == torch.bfloat16),
            b.data_ptr(), c.data_ptr(), a.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), ckpt.data_ptr(),
            scratch.data_ptr(), bsz, t, d, s, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan forward kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += LAUNCHES_PER_CALL["forward"]
    selective_scan.launches_forward += LAUNCHES_PER_CALL["forward"]
    return y, h_last, (ckpt if checkpoints else None)


def launch_backward(dt: Tensor, u: Tensor, b: Tensor, c: Tensor, a: Tensor,
                    ckpt: Tensor, dy: Tensor, dh_last: Tensor | None
                    ) -> tuple[Tensor, ...]:
    """The backward kernels (four launches) on contiguous CUDA inputs ->
    (d dt, d u in u's dtype, d b, d c, d a, d h0)."""
    bsz, t, d = dt.shape
    s = a.shape[1]
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt, du = torch.empty_like(dt), torch.empty_like(u)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty_like(a)
    dh0 = torch.empty((bsz, d, s), **f32)
    part_bc = torch.empty((lib.selective_scan_bwd_partials(d), bsz, t,
                           2 * s), **f32)
    nc = -(-t // SEGMENT)
    part_a = torch.empty((bsz, nc, d, s), **f32)
    scratch = torch.empty((3, bsz, nc, d, s), **f32)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan_bwd_launch(
            dt.data_ptr(), u.data_ptr(), int(u.dtype == torch.bfloat16),
            b.data_ptr(), c.data_ptr(), a.data_ptr(), ckpt.data_ptr(),
            dy.data_ptr(), _ptr(dh_last), ddt.data_ptr(), du.data_ptr(),
            db.data_ptr(), dc.data_ptr(), da.data_ptr(), dh0.data_ptr(),
            part_bc.data_ptr(), part_a.data_ptr(), scratch.data_ptr(), bsz, t,
            d, s, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan backward kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += LAUNCHES_PER_CALL["backward"]
    selective_scan.launches_backward += LAUNCHES_PER_CALL["backward"]
    return ddt, du, db, dc, da, dh0


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, u, b, c, a, h0):
        y, h_last, ckpt = launch_forward(dt, u, b, c, a, h0,
                                         checkpoints=any(
                                             ctx.needs_input_grad))
        ctx.save_for_backward(dt, u, b, c, a, ckpt)
        ctx.set_materialize_grads(False)    # an unused h_T: no zeros read
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, u, b, c, a, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.float().contiguous()
        if dh_last is not None:
            dh_last = dh_last.float().contiguous()
        return launch_backward(dt, u, b, c, a, ckpt, dy, dh_last)


@kernel_call("selective_scan")
def selective_scan(dt: Tensor, u: Tensor, b: Tensor, c: Tensor, a: Tensor,
                   h0: Tensor) -> tuple[Tensor, Tensor]:
    """``(y [B,T,D] f32, h_T [B,D,S] f32)`` of the selective scan: the CUDA
    kernels (differentiable through the backward kernel) on CUDA tensors,
    :func:`selective_scan_plain` on CPU tensors, the custom op
    ``torch.ops.repro_torch.selective_scan`` on a planner's tensors."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, u, b, c, a, h0)
    _check(dt, u, b, c, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {dt.device}")
    if a.shape[1] not in DSTATES:
        raise ValueError(f"selective_scan: d_state {a.shape[1]} not in "
                         f"{DSTATES}")
    return _Scan.apply(dt.contiguous(), u.contiguous(), b.contiguous(),
                       c.contiguous(), a.contiguous(), h0.contiguous())


selective_scan.launches = 0
selective_scan.launches_forward = 0
selective_scan.launches_backward = 0
