"""decode_attention: one query token against a KV cache.

The port of the JAX package's TPU kernel ``repro/kernels/decode_attention.py``
``decode_attention`` (Pallas). For ``q [B, H, d]``, the cache ``k, v [B, T,
KV, d]`` and an int ``position``, every head attends to cache slots
``[0, position]`` of its kv head (the G = H / KV query heads of a kv head
share it), with an f32 softmax and the normaliser clamped at ``1e-30``; the
output ``[B, H, d]`` has q's dtype. The slot at ``position`` holds the
current token's K/V, written by the caller.

* On a CUDA tensor, :func:`decode_attention` launches the hand-written
  Hopper kernel of ``csrc/decode_attention.cu`` or raises; it never falls
  back. ``decode_attention.launches`` counts its launches. ``position`` is a
  kernel argument: nothing is read back to the host.
* On a CPU tensor it runs :func:`decode_attention_plain`, the plain PyTorch
  version of the same arithmetic.

Slots past ``position`` are never read, by either version.
"""

from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # query heads per kv head the kernel takes


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           position) -> int:
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not in {DTYPES}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q, k, v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: want q [B,H,d], k = v "
                         f"[B,T,KV,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (KV must divide H)")
    position = int(position)
    if not 0 <= position < k.shape[1]:
        raise ValueError(f"decode_attention: position {position} outside "
                         f"the cache's {k.shape[1]} slots")
    if not (q.device == k.device == v.device):
        raise ValueError(f"decode_attention: tensors on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    return position


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           position: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: f32 scores
    over slots ``[0, position]`` only, ``exp(s - max)`` normalised by the
    sum clamped at ``1e-30``."""
    position = _check(q, k, v, position)
    b, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    kf = k[:, :position + 1].transpose(1, 2).float()      # [B,KV,n,d]
    vf = v[:, :position + 1].transpose(1, 2).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, kf) * (1.0 / d ** 0.5)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,bktd->bkgd", p, vf) / l
    return out.reshape(b, h, d).to(q.dtype)


def _kernel_fn():
    from repro_torch.kernels import _build
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
    return fn


def _strides(x: torch.Tensor, name: str) -> list[int]:
    """The outer element strides of a tensor the kernel reads with 16-byte
    loads; raises if it cannot."""
    st = x.stride()
    if st[-1] != 1 or any(s % 8 for s in st[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"decode_attention: {name} needs unit stride in d, "
                         f"outer strides that are multiples of 8 and 16-byte "
                         f"aligned data (got strides {st}); pass "
                         f"{name}.contiguous()")
    return list(st[:-1])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     position: int) -> torch.Tensor:
    """``q [B,H,d]``, ``k, v [B,T,KV,d]``, ``position`` -> ``[B,H,d]``: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, position)
    position = _check(q, k, v, position)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if d % 8 or d > 256 or h // n_kv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} must be a multiple "
                         f"of 8 up to 256 and H / KV = {h // n_kv} at most "
                         f"{MAX_GROUP}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(out, "out"))
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, n_kv, t, d, position, (ctypes.c_int64 * 10)(*strides),
                 DTYPES.index(q.dtype), 1.0 / d ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
