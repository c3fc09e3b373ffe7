"""flash_attention: forward GQA attention with an f32 online softmax.

The port of the JAX package's TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (Pallas). For ``q [B, H, S, d]`` and ``k, v [B, KV, T,
d]`` (KV divides H; head ``h`` reads kv head ``h // (H / KV)``) it computes
``softmax(q k^T / sqrt(d)) v`` per head, causal (key ``j`` visible to query
``i`` iff ``j <= i``, both counted from 0) or bidirectional; a sliding
``window`` W > 0 (causal only) keeps key ``j`` iff ``i - W < j <= i``, the
JAX package's ``make_mask(..., "sliding", W)`` (the TPU kernel has no
window; its reference here is the JAX model's masked attention). Scores
and the softmax are f32, masked scores are ``-1e30``, and the normaliser
is clamped at ``1e-30``; the output has q's dtype.

* On a CUDA tensor, :func:`flash_attention` launches one of the two
  hand-written Hopper kernels of ``csrc/flash_attention.cu`` (its header
  says what bounds them), chosen by dtype (:data:`VARIANTS`): bf16 inputs
  go to ``bf16_mma``, products on the tensor cores (``mma.sync``, K/V
  copies in flight with ``cp.async``); f32 inputs to ``f32_fma``, products
  on the f32 cores. It raises on what they do not take; it never falls
  back. ``flash_attention.launches`` counts every launch,
  ``flash_attention.launches_by_variant`` each variant's,
  ``flash_attention.launches_windowed`` those with a window and
  ``flash_attention.launches_bidirectional`` those with ``causal=False``.
* On a CPU tensor it runs :func:`flash_attention_plain`, the plain PyTorch
  version of the same arithmetic, which the tests hold against the JAX
  kernel and ``chip_smoke.py`` holds the CUDA kernels against.

For bf16 inputs the probabilities are rounded to bf16 before the P.V
product, as the tensor-core kernel feeds them to it and as the JAX model
does (``softmax(...).astype(v.dtype)``); the TPU kernel keeps them in f32.
f32 inputs keep everything in f32.

The kernels read q, k and v through their strides (unit stride in ``d``),
so ``[B, S, H, d]`` activations transposed to ``[B, H, S, d]`` need no copy.
The result has the shape ``[B, H, S, d]`` and the memory layout ``[B, S, H,
d]``, so that merging the heads back is a view. Any S, T >= 1 and any d that
is a multiple of 8 up to 256 are taken.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.custom_ops import kernel_call

DTYPES = (torch.float32, torch.bfloat16)
# the kernel each input dtype launches, and its C entry point
VARIANTS = {torch.float32: "f32_fma", torch.bfloat16: "bf16_mma"}
_ENTRY = {"f32_fma": "flash_attention_f32_launch",
          "bf16_mma": "flash_attention_bf16_launch"}
NEG_INF = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window {window} needs causal "
                         f"attention and must be >= 0")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q [B,H,S,d], k = v "
                         f"[B,KV,T,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (KV must divide H)")
    if min(s, k.shape[2]) < 1:
        raise ValueError("flash_attention: empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: tensors on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, on any device: f32 scores,
    the ``-1e30`` mask, ``p = exp(s - max)``, for bf16 inputs rounded to
    bf16 before the P.V product, normalised by the f32 sum of the unrounded
    ``p`` clamped at ``1e-30``. Returns a contiguous ``[B, H, S, d]`` in
    q's dtype."""
    _check(q, k, v, causal, window)
    b, h, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / d ** 0.5)
    if causal:
        diff = (torch.arange(s, device=q.device)[:, None]
                - torch.arange(t, device=q.device)[None, :])
        mask = (diff >= 0) & (diff < window) if window else diff >= 0
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l
    return out.reshape(b, h, s, d).to(q.dtype)


def _kernel_fn(variant: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("flash_attention"), _ENTRY[variant])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    return fn


def _strides(x: torch.Tensor, name: str) -> list[int]:
    """The three outer element strides of a 4-d tensor the kernel reads
    with 16-byte loads; raises if it cannot."""
    st = x.stride()
    if st[3] != 1 or any(s % 8 for s in st[:3]) or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs unit stride in d, "
                         f"outer strides that are multiples of 8 and 16-byte "
                         f"aligned data (got strides {st}); pass "
                         f"{name}.contiguous()")
    return list(st[:3])


@kernel_call("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q [B,H,S,d]``, ``k, v [B,KV,T,d]`` -> ``[B,H,S,d]``, with a
    sliding ``window`` when it is > 0: the CUDA kernel of q's dtype on a
    CUDA tensor, the plain version on a CPU tensor."""
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    if d % 8 or d > 256:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 8 up to 256")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(out, "out"))
    variant = VARIANTS[q.dtype]
    fn = _kernel_fn(variant)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, n_kv, s, t, d, (ctypes.c_int64 * 12)(*strides),
                 int(causal), min(window, 1 << 30), 1.0 / d ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    flash_attention.launches_windowed += window > 0
    flash_attention.launches_bidirectional += not causal
    return out


flash_attention.launches = 0
flash_attention.launches_windowed = 0
flash_attention.launches_bidirectional = 0
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
