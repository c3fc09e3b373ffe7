"""decode_attention: one query token against a KV cache.

The port of the JAX package's TPU kernel ``repro/kernels/decode_attention.py``
``decode_attention`` (Pallas). For ``q [B, H, d]``, the cache ``k, v [B, T,
KV, d]`` and an int ``position``, every head attends to cache slots
``[0, position]`` of its kv head (the G = H / KV query heads of a kv head
share it), with an f32 softmax and the normaliser clamped at ``1e-30``; the
output ``[B, H, d]`` has q's dtype. The slot at ``position`` holds the
current token's K/V, written by the caller.

* On a CUDA tensor, :func:`decode_attention` launches the hand-written
  Hopper kernels of ``csrc/decode_attention.cu`` or raises; it never falls
  back. A call is two launches (``LAUNCHES_PER_CALL``): a split pass over
  ``splits`` chunks of the cache writes f32 partials ``(m, l, acc)``, and a
  combine pass merges them. ``decode_attention.launches`` counts both.
  :func:`plan_splits` picks ``splits`` from the cache's shape and the SM
  count, never from ``position``, so every decode step launches the same
  grid. ``position`` is a kernel argument: nothing is read back to the host.
* On a CPU tensor it runs :func:`decode_attention_plain`, the plain PyTorch
  version of the same arithmetic.

:func:`decode_attention_partials_plain` and
:func:`decode_attention_combine_plain` are the two passes in plain PyTorch;
the tests and ``chip_smoke.py`` hold each pass of the kernel against them.
Slots past ``position`` are never read, by any version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.custom_ops import kernel_call

from repro_torch.kernels.cscatter import _sm_count

DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # query heads per kv head the kernel takes
NEG_INF = -1e30         # the kernel's finite -inf: m of an empty split
LAUNCHES_PER_CALL = 2   # the split pass, then the combine pass
# split-pass sizing (csrc/decode_attention.cu): threads a CTA, CTAs an SM
# holds (its shared-memory ring), the fewest slots a lane group should get
# (three full tiles of 4), the most splits
THREADS, CTAS_PER_SM, MIN_SLOTS_PER_GROUP, MAX_SPLITS = 128, 4, 12, 1024


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


def decode_attention_partials_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, position: int,
                                    splits: int):
    """The split pass in plain PyTorch: for each of ``splits`` chunks of
    the cache, the f32 softmax statistics of every head over the chunk's
    slots up to ``position`` — ``m [splits, B, H]`` (the largest score),
    ``l [splits, B, H]`` (the sum of ``exp(s - m)``) and ``acc [splits, B,
    H, d]`` (the sum of ``exp(s - m) v``). A split that starts past
    ``position`` gives ``m = NEG_INF``, ``l = 0``, ``acc = 0``."""
    position = _check(q, k, v, position)
    if splits < 1:
        raise ValueError(f"decode_attention: splits {splits} < 1")
    b, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    m = torch.full((splits, b, h), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((splits, b, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((splits, b, h, d), dtype=torch.float32,
                      device=q.device)
    chunk = -(-t // splits)        # split i reads [i chunk, (i + 1) chunk)
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, position + 1)
        if lo >= hi:
            continue
        kf = k[:, lo:hi].transpose(1, 2).float()          # [B,KV,n,d]
        vf = v[:, lo:hi].transpose(1, 2).float()
        scores = torch.einsum("bkgd,bktd->bkgt", qg, kf) * (1.0 / d ** 0.5)
        mi = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - mi)
        m[i] = mi.reshape(b, h)
        l[i] = p.sum(-1).reshape(b, h)
        acc[i] = torch.einsum("bkgt,bktd->bkgd", p, vf).reshape(b, h, d)
    return m, l, acc


def decode_attention_combine_plain(m: torch.Tensor, l: torch.Tensor,
                                   acc: torch.Tensor,
                                   dtype: torch.dtype) -> torch.Tensor:
    """The combine pass in plain PyTorch: merges the partials of
    :func:`decode_attention_partials_plain` in f32 — ``m* = max m_i``, ``l
    = sum l_i exp(m_i - m*)``, ``acc = sum acc_i exp(m_i - m*)`` — and
    returns ``acc / max(l, 1e-30)`` ``[B, H, d]`` in ``dtype``."""
    w = torch.exp(m - m.amax(0, keepdim=True))
    total = (l * w).sum(0).clamp_min(1e-30)
    return ((acc * w[..., None]).sum(0) / total[..., None]).to(dtype)


@functools.lru_cache(maxsize=64)
def plan_splits(b: int, n_kv: int, t: int, d: int, n_sm: int) -> int:
    """The split count of a cache ``[B, T, KV, d]`` on a card of ``n_sm``
    SMs: enough CTAs for ``CTAS_PER_SM`` a SM, but no split shorter than
    ``MIN_SLOTS_PER_GROUP`` slots for each lane group of a CTA, and at
    most ``MAX_SPLITS``. It never depends on ``position``: every decode
    step over one cache launches the same grid."""
    lanes = 1              # lanes a cache row: 8 elements a lane, rounded
    while lanes * 8 < d:   # up to a power of two
        lanes *= 2
    groups = THREADS // lanes
    fill = max(1, CTAS_PER_SM * n_sm // (b * n_kv))
    longest = max(1, t // (MIN_SLOTS_PER_GROUP * groups))
    return min(fill, longest, MAX_SPLITS)


def _kernel_fn():
    from repro_torch.kernels import _build
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7
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


@kernel_call("decode_attention")
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     position: int) -> torch.Tensor:
    """``q [B,H,d]``, ``k, v [B,T,KV,d]``, ``position`` -> ``[B,H,d]``: the
    CUDA kernels on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, position)
    b, _, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    return _launch(q, k, v, position,
                   plan_splits(b, n_kv, t, d, _sm_count(q.device)))[0]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, position: int,
           splits: int):
    """The two launches of one call on CUDA tensors, over ``splits``
    chunks of the cache. Returns the output and the f32 partials ``(out,
    m, l, acc)`` that the split pass wrote, laid out as
    :func:`decode_attention_partials_plain`'s. :func:`decode_attention`
    passes :func:`plan_splits`'s choice; a test may pass any count from 1
    to ``MAX_SPLITS``."""
    out, scratch = _launch(q, k, v, position, splits)
    b, h, d = q.shape
    n = splits * b * h
    return (out, scratch[:n].view(splits, b, h),
            scratch[n:2 * n].view(splits, b, h),
            scratch[2 * n:].view(splits, b, h, d))


def _launch(q, k, v, position, splits):
    position = _check(q, k, v, position)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if d % 8 or d > 256 or h // n_kv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} must be a multiple "
                         f"of 8 up to 256 and H / KV = {h // n_kv} at most "
                         f"{MAX_GROUP}")
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"decode_attention: splits {splits} outside "
                         f"[1, {MAX_SPLITS}]")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # the split pass's f32 partials: m, then l, then acc
    scratch = torch.empty(splits * b * h * (d + 2), dtype=torch.float32,
                          device=q.device)
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(out, "out"))
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, h, n_kv, t, d, position, splits,
                 (ctypes.c_int64 * 10)(*strides), DTYPES.index(q.dtype),
                 1.0 / d ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += LAUNCHES_PER_CALL
    return out, scratch


decode_attention.launches = 0
