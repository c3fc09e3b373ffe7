"""cmerge: the merge instruction over a W-way source buffer.

The port of the JAX package's TPU kernel ``repro/kernels/cmerge.py``
``cmerge`` (Pallas). For a table ``T[S, R, D]`` (or ``[R, D]``) and, per
shard, W ways of ``block_rows`` (BR) rows each — ``block_ids [S, W]`` (-1 =
invalid), ``dirty [S, W]``, source copies ``src [S, W, BR, D]`` and update
copies ``upd [S, W, BR, D]`` — it computes, for every valid dirty way,

    T[block] = apply(T[block], delta(src[w], upd[w]))

with the kinds add ``mem + (upd - src)``, sat_add (clipped in f32), max and
min against ``upd``, and or ``mem | upd``. Clean and invalid ways leave
memory untouched; block ids past the table's end are ignored too (the JAX
kernel's index maps would clamp them). Block ids must be unique among the
dirty ways of a shard — the source buffer's invariant.

* On a CUDA tensor, :func:`cmerge` launches the hand-written Hopper kernel of
  ``csrc/cmerge.cu`` or raises; it never falls back. ``cmerge.launches``
  counts its launches.
* On a CPU tensor it runs :func:`cmerge_plain_`, the plain PyTorch version
  (in place; :func:`cmerge_plain` on a copy) that the tests hold against
  the JAX kernel and that ``chip_smoke.py`` holds the CUDA kernel against.

:func:`cmerge` updates ``table`` **in place** (the reference aliases the
output onto the table) and returns it. Nothing on the launch path reads a
value back to the host, so the blocked engine can launch it once per access
without synchronizing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import hooks
from repro_torch.kernels.cscatter import DTYPES, _domain, _f32, _wrap

MERGE_KINDS = ("add", "sat_add", "max", "min", "or")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
               torch.uint32: 3}


def _check(table, block_ids, dirty, src, upd, kind):
    """Validate and bring the arguments to the stacked ``[S, ...]`` form
    (``dirty`` as bool)."""
    if kind not in MERGE_KINDS:
        raise ValueError(f"kind must be one of {MERGE_KINDS}, got {kind!r}")
    if table.dtype not in DTYPES:
        raise TypeError(f"cmerge: table dtype {table.dtype} not in {DTYPES}")
    if kind == "or" and table.dtype.is_floating_point:
        raise TypeError("cmerge: kind 'or' needs an integer table")
    if src.dtype != table.dtype or upd.dtype != table.dtype:
        raise TypeError(f"cmerge: src/upd dtypes {src.dtype}, {upd.dtype} != "
                        f"table dtype {table.dtype}")
    if block_ids.dtype != torch.int32:
        raise TypeError(f"cmerge: block_ids must be int32, got "
                        f"{block_ids.dtype}")
    if dirty.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"cmerge: dirty must be bool or int32, got "
                        f"{dirty.dtype}")
    if table.dim() == 2:
        table, block_ids, dirty, src, upd = (
            x[None] for x in (table, block_ids, dirty, src, upd))
    if (table.dim(), block_ids.dim(), dirty.dim(), src.dim()) != (3, 2, 2, 4):
        raise ValueError(
            f"cmerge: want table [S,R,D], block_ids/dirty [S,W], src/upd "
            f"[S,W,BR,D] (or without S); got {tuple(table.shape)}, "
            f"{tuple(block_ids.shape)}, {tuple(dirty.shape)}, "
            f"{tuple(src.shape)}")
    s, r, d = table.shape
    _, w, br, d2 = src.shape
    if (block_ids.shape != (s, w) or dirty.shape != (s, w)
            or src.shape != (s, w, br, d) or upd.shape != src.shape):
        raise ValueError(f"cmerge: shapes disagree: table {tuple(table.shape)}"
                         f", block_ids {tuple(block_ids.shape)}, dirty "
                         f"{tuple(dirty.shape)}, src {tuple(src.shape)}, upd "
                         f"{tuple(upd.shape)}")
    if br < 1 or r % br:
        raise ValueError(f"cmerge: {r} rows are not a multiple of the block's "
                         f"{br}")
    devices = {x.device for x in (table, block_ids, dirty, src, upd)}
    if len(devices) != 1:
        raise ValueError(f"cmerge: tensors on different devices: {devices}")
    if not all(x.is_contiguous() for x in (table, block_ids, dirty, src, upd)):
        raise ValueError("cmerge: every argument must be contiguous")
    if dirty.dtype != torch.bool:
        dirty = dirty != 0
    return table, block_ids, dirty, src, upd


def _merged_blocks(table, block_ids, dirty, src, upd, kind, sat_min,
                   sat_max):
    """The plain version's arithmetic on stacked arguments: the flat row
    index ``s * R + r`` of every row a merging way covers ``[n, BR]`` and
    its merged value ``[n, BR, D]``. Integer tables compute in int64 and
    wrap, which equals the kernel's wrapping arithmetic in the dtype; merged
    integer rows come back as int32 bit patterns (torch's uint32 has no
    index_put)."""
    s, r, d = table.shape
    br = src.shape[2]
    ok = (block_ids >= 0) & (block_ids < r // br) & dirty
    shard, way = ok.nonzero(as_tuple=True)
    rows = ((shard * r + block_ids[shard, way].long() * br)[:, None]
            + torch.arange(br, device=table.device))
    lo, hi = _f32(sat_min), _f32(sat_max)
    if table.dtype.is_floating_point:
        su, uu = src[shard, way], upd[shard, way]
        mem = table.reshape(s * r, d)[rows]
        if kind == "add":
            return rows, mem + (uu - su)
        if kind == "sat_add":
            x = mem.float() + (uu.float() - su.float())
            return rows, torch.clamp(x, lo, hi).to(mem.dtype)
        if kind == "max":
            return rows, torch.maximum(mem, uu)
        return rows, torch.minimum(mem, uu)
    # index through int32 bit views: CUDA has no uint32 indexing
    m = _domain(table.view(torch.int32).reshape(s * r, d)[rows], table.dtype)
    sv = _domain(src.view(torch.int32)[shard, way], table.dtype)
    uv = _domain(upd.view(torch.int32)[shard, way], table.dtype)
    if kind == "add":
        new = m + (uv - sv)
    elif kind == "sat_add":
        x = m.to(torch.float32) + (uv.to(torch.float32)
                                   - sv.to(torch.float32))
        new = torch.clamp(x, lo, hi).to(torch.int64)
    elif kind == "max":
        new = torch.maximum(m, uv)
    elif kind == "min":
        new = torch.minimum(m, uv)
    else:
        new = m | uv
    return rows, _wrap(new, torch.int32).to(torch.int32)


def _write_blocks(table: torch.Tensor, rows: torch.Tensor,
                  new: torch.Tensor) -> None:
    s, r, d = table.shape
    dst = table if table.dtype.is_floating_point else table.view(torch.int32)
    dst.view(s * r, d)[rows] = new


def cmerge_plain_(table: torch.Tensor, block_ids: torch.Tensor,
                  dirty: torch.Tensor, src: torch.Tensor, upd: torch.Tensor,
                  *, kind: str = "add", sat_min: float = 0.0,
                  sat_max: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in place on any device:
    updates ``table`` and returns it, as the kernel does."""
    args = _check(table, block_ids, dirty, src, upd, kind)
    _write_blocks(args[0], *_merged_blocks(*args, kind, sat_min, sat_max))
    return table


def cmerge_plain(table: torch.Tensor, block_ids: torch.Tensor,
                 dirty: torch.Tensor, src: torch.Tensor, upd: torch.Tensor, *,
                 kind: str = "add", sat_min: float = 0.0,
                 sat_max: float = 0.0) -> torch.Tensor:
    """:func:`cmerge_plain_` on a copy: returns a new table and leaves the
    argument untouched."""
    return cmerge_plain_(table.clone(), block_ids, dirty, src, upd,
                         kind=kind, sat_min=sat_min, sat_max=sat_max)


def _kernel_fn():
    from repro_torch.kernels import _build
    fn = _build.load("cmerge").cmerge_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
    return fn


def cmerge(table: torch.Tensor, block_ids: torch.Tensor, dirty: torch.Tensor,
           src: torch.Tensor, upd: torch.Tensor, *, kind: str = "add",
           sat_min: float = 0.0, sat_max: float = 0.0) -> torch.Tensor:
    """``table [S,R,D] | [R,D]``; ``block_ids`` int32 and ``dirty`` bool or
    int32 ``[S,W] | [W]``; ``src, upd [S,W,BR,D] | [W,BR,D]`` in the
    table's dtype. Updates ``table`` in place and returns it: the CUDA
    kernel on a CUDA tensor, the plain version's arithmetic on a CPU
    tensor."""
    if table.device.type == "cpu":
        return cmerge_plain_(table, block_ids, dirty, src, upd, kind=kind,
                             sat_min=sat_min, sat_max=sat_max)
    t, ids, dirty, s_, u_ = _check(table, block_ids, dirty, src, upd, kind)
    if t.device.type != "cuda":
        raise ValueError(f"cmerge: no kernel for device {t.device}")
    s, r, d = t.shape
    _, w, br, _ = s_.shape
    if w == 0:
        return table
    fn = _kernel_fn()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t.data_ptr(), ids.data_ptr(), dirty.data_ptr(),
                 s_.data_ptr(), u_.data_ptr(), s, r, w, br, d,
                 _DTYPE_CODE[t.dtype], MERGE_KINDS.index(kind), sat_min,
                 sat_max, stream)
    if err != 0:
        raise RuntimeError(f"cmerge kernel launch failed: cudaError {err}")
    hooks.emit("kernel", "cmerge", (t, ids, dirty, s_, u_), (t,))
    cmerge.launches += 1
    return table


cmerge.launches = 0
