"""cscatter: commutative scatter-update with a privatized copy.

The port of the JAX package's TPU kernel ``repro/kernels/cscatter.py``
``cscatter`` (Pallas). For a table ``T[S, R, D]`` (or ``[R, D]``) and a
stream of COps ``(ids[S, N], vals[S, N, D])`` it computes, per shard,

    T[ids[n]] = apply(T[ids[n]], fold(combine, identity, vals where id matches))

— the paper's privatize-and-merge semantics: all contributions to a row are
combined into a private delta first and merged into memory once, so
``apply`` observes memory (what makes saturating merges correct). Rows no
id touches stay bit-exact; ids ``< 0`` or ``>= R`` are ignored (padding).

* On a CUDA tensor, :func:`cscatter` launches the hand-written Hopper kernels
  of ``csrc/cscatter.cu`` (its header says what bounds them and why) or
  raises; it never falls back. A call is two launches, a bucket pass that
  sorts each shard's ids by row block and a fold pass that merges each
  touched row once; :func:`plan` sizes both on the host. Every result is
  the same bits on every call with the same inputs, float sums included
  (the header's "Determinism"); they need not be the plain version's.
  ``cscatter.launches`` counts the kernel launches, ``LAUNCHES_PER_CALL``
  a call.
* On a CPU tensor it runs :func:`cscatter_plain_`, the plain PyTorch
  version (in place; :func:`cscatter_plain` on a copy) that the tests hold
  against the JAX kernel and that ``chip_smoke.py`` holds the CUDA kernel
  against.

:func:`cscatter` updates ``table`` **in place** (where the reference returns
a new table and lets XLA alias the donated buffer) and returns it.

Accumulators are f32 for float tables and the table's own dtype, with
wrapping adds, for integer tables. ``apply`` casts the delta to the table's
dtype first for add/max/min/or; ``sat_add`` adds in the accumulator dtype,
then clips in f32 and casts back — for integer tables that is the integer
add first, as the TPU kernel does (``cscatter.py:117``), and not the JAX
oracle's add-in-f32 (``ref.py:43``); the two differ above 2**24.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.custom_ops import kernel_call

MERGE_KINDS = ("add", "sat_add", "max", "min", "or")
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.uint32)
_U32 = 1 << 32


def _check(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
           kind: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate and bring the arguments to the stacked ``[S, ...]`` form."""
    if kind not in MERGE_KINDS:
        raise ValueError(f"kind must be one of {MERGE_KINDS}, got {kind!r}")
    if table.dtype not in DTYPES:
        raise TypeError(f"cscatter: table dtype {table.dtype} not in {DTYPES}")
    if kind == "or" and table.dtype.is_floating_point:
        raise TypeError("cscatter: kind 'or' needs an integer table")
    if vals.dtype != table.dtype:
        raise TypeError(f"cscatter: vals dtype {vals.dtype} != table dtype "
                        f"{table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"cscatter: ids must be int32, got {ids.dtype}")
    if table.dim() == 2:
        table, ids, vals = table[None], ids[None], vals[None]
    if table.dim() != 3 or ids.dim() != 2 or vals.dim() != 3:
        raise ValueError(f"cscatter: want table [S,R,D], ids [S,N], vals "
                         f"[S,N,D] (or without S); got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(vals.shape)}")
    s, r, d = table.shape
    if ids.shape[0] != s or vals.shape != (s, ids.shape[1], d):
        raise ValueError(f"cscatter: shapes disagree: table {tuple(table.shape)}"
                         f", ids {tuple(ids.shape)}, vals {tuple(vals.shape)}")
    if r >= 2**31:
        raise ValueError(f"cscatter: {r} rows do not fit int32 ids")
    if not (table.device == ids.device == vals.device):
        raise ValueError(f"cscatter: tensors on different devices: "
                         f"{table.device}, {ids.device}, {vals.device}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("cscatter: table, ids and vals must be contiguous")
    return table, ids, vals


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 tensor reduced mod 2**32 into ``dtype``'s value range."""
    x = x & (_U32 - 1)
    if dtype == torch.uint32:
        return x
    return torch.where(x >= _U32 // 2, x - _U32, x)


def _domain(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 bit patterns as int64 values of ``dtype`` (int32 or uint32)."""
    x = bits.to(torch.int64)
    return x & (_U32 - 1) if dtype == torch.uint32 else x


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _merged_rows(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                 kind: str, sat_min: float, sat_max: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's arithmetic on stacked arguments: the flat row
    index ``s * R + r`` of every touched row and its merged value. Integer
    tables fold exactly in int64 and wrap once, which equals the kernel's
    wrapping fold in the table's dtype; merged integer rows come back as
    int32 bit patterns (torch's uint32 has no index_put)."""
    s, r, d = table.shape
    ok = (ids >= 0) & (ids < r)
    gid = (ids.long() + r * torch.arange(s, device=ids.device)[:, None])[ok]
    rows, inv = torch.unique(gid, return_inverse=True)
    lo, hi = _f32(sat_min), _f32(sat_max)

    if table.dtype.is_floating_point:
        mem = table.reshape(s * r, d)[rows]
        v = vals[ok].float()
        if kind in ("add", "sat_add"):
            # on the card an f32 index_add_ adds in the order of its atomics,
            # which changes from call to call: there the sums are taken in
            # f64 and rounded once to f32, as the kernel's exact sums are
            acc = torch.float64 if v.is_cuda else torch.float32
            u = torch.zeros(len(rows), d, dtype=acc, device=v.device
                            ).index_add_(0, inv, v.to(acc)).float()
        else:
            info = torch.finfo(torch.float32)
            u = torch.full((len(rows), d), info.min if kind == "max"
                           else info.max, device=v.device)
            u.scatter_reduce_(0, inv[:, None].expand_as(v), v,
                              "amax" if kind == "max" else "amin")
        if kind == "add":
            return rows, mem + u.to(mem.dtype)
        if kind == "sat_add":
            return rows, torch.clamp(mem.float() + u, lo, hi).to(mem.dtype)
        if kind == "max":
            return rows, torch.maximum(mem, u.to(mem.dtype))
        return rows, torch.minimum(mem, u.to(mem.dtype))

    # index through int32 bit views: CUDA has no uint32 indexing
    v = _domain(vals.view(torch.int32)[ok], table.dtype)
    m = _domain(table.view(torch.int32).reshape(s * r, d)[rows], table.dtype)
    if kind in ("add", "sat_add"):
        u = torch.zeros(len(rows), d, dtype=torch.int64,
                        device=v.device).index_add_(0, inv, v)
    elif kind in ("max", "min"):
        info = torch.iinfo(table.dtype)
        u = torch.full((len(rows), d), info.min if kind == "max" else info.max,
                       dtype=torch.int64, device=v.device)
        u.scatter_reduce_(0, inv[:, None].expand_as(v), v,
                          "amax" if kind == "max" else "amin")
    else:  # or, one bit at a time: no scatter_reduce takes bitwise or
        u = torch.zeros(len(rows), d, dtype=torch.int64, device=v.device)
        for b in range(32):
            bit = torch.zeros_like(u).scatter_reduce_(
                0, inv[:, None].expand_as(v), (v >> b) & 1, "amax")
            u |= bit << b
    if kind == "add":
        new = m + u
    elif kind == "sat_add":
        s_ = _wrap(m + u, table.dtype).to(torch.float32)
        new = torch.clamp(s_, lo, hi).to(torch.int64)
    elif kind == "max":
        new = torch.maximum(m, u)
    elif kind == "min":
        new = torch.minimum(m, u)
    else:
        new = m | u
    return rows, _wrap(new, torch.int32).to(torch.int32)


def _write_rows(table: torch.Tensor, rows: torch.Tensor,
                new: torch.Tensor) -> None:
    s, r, d = table.shape
    dst = table if table.dtype.is_floating_point else table.view(torch.int32)
    dst.view(s * r, d)[rows] = new


def cscatter_plain_(table: torch.Tensor, ids: torch.Tensor,
                    vals: torch.Tensor, *, kind: str = "add",
                    sat_min: float = 0.0, sat_max: float = 0.0
                    ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in place on any device:
    updates ``table`` and returns it, as the kernel does."""
    t, i, v = _check(table, ids, vals, kind)
    _write_rows(t, *_merged_rows(t, i, v, kind, sat_min, sat_max))
    return table


def cscatter_plain(table: torch.Tensor, ids: torch.Tensor,
                   vals: torch.Tensor, *, kind: str = "add",
                   sat_min: float = 0.0, sat_max: float = 0.0
                   ) -> torch.Tensor:
    """:func:`cscatter_plain_` on a copy: returns a new table and leaves
    the argument untouched."""
    return cscatter_plain_(table.clone(), ids, vals, kind=kind,
                           sat_min=sat_min, sat_max=sat_max)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
               torch.uint32: 3}

# The kernels' geometry (csrc/cscatter.cu): 4-byte accumulators (12 bytes,
# an int64 sum and a magnitude, for the exact float sums of add and sat_add:
# EXACT_ACC_ITEM), column tiles of at most 32, a fold CTA of 4 warps with
# one [br, dc] accumulator tile (for buckets of more than 32 ids; a warp
# folds smaller ones in registers), and one bucket-pass histogram of at
# most HIST_CAP blocks in shared memory.
ACC_ITEM = 4
EXACT_ACC_ITEM = 12
MAX_COLS = 32
FOLD_WARPS = 4
ACC_BYTES = 16 * 1024              # a fold CTA's tile when the blocks fit
MAX_ACC_BYTES = 128 * 1024         # grown up to this when they do not
HIST_CAP = 32 * 1024               # 128 KiB of counters
FOLD_CTAS_PER_SM = 8
BUCKET_SMEM = 226 * 1024           # the bucket pass's dynamic shared memory
LAUNCHES_PER_CALL = 2              # the bucket pass, then the fold pass


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the two launches of one call need, computed on the host.

    ``br`` rows x ``dc`` columns per accumulator tile; ``n_blocks`` row
    blocks of ``br`` rows (the buckets); the bucket pass counts ``hist_cap``
    blocks at a time in ``chunks`` rounds (each round reads the ids twice);
    ``list_cap`` bounds a shard's work units (a unit is consecutive
    buckets of at most 32 ids, or one larger bucket); the fold grid is
    ``fold_ctas`` x ``col_tiles`` x S; with ``stage`` (one round, and
    room for ``2N`` ints) the bucket pass sorts in shared memory and writes
    perm and rowid out coalesced; ``scratch`` is the int32 element
    count of perm, rowid ``[S, N]``, ustart ``[S, L + 1]``, big ``[S, L]``
    and counts ``[S, 2]``."""

    br: int
    dc: int
    col_tiles: int
    n_blocks: int
    hist_cap: int
    chunks: int
    list_cap: int
    fold_ctas: int
    stage: bool
    scratch: int


def acc_item(dtype: torch.dtype, kind: str) -> int:
    """Bytes of one cell of the fold's accumulator tile: float tables
    under add and sat_add sum exactly in int64 beside each cell's largest
    magnitude (``csrc/cscatter.cu``, "Determinism")."""
    return (EXACT_ACC_ITEM if dtype.is_floating_point
            and kind in ("add", "sat_add") else ACC_ITEM)


@functools.lru_cache(maxsize=1024)
def plan(s: int, r: int, n: int, d: int, n_sm: int,
         item: int = ACC_ITEM) -> Plan:
    """The sizing of one call on a card with ``n_sm`` SMs, for a table
    ``[s, r, d]`` and ``n`` ids per shard, with accumulator cells of
    ``item`` bytes (:func:`acc_item`). The tile starts at ``ACC_BYTES``
    and doubles, up to ``MAX_ACC_BYTES``, while the row blocks outnumber
    one histogram; past that the bucket pass runs in chunks. The fold runs
    about ``FOLD_CTAS_PER_SM`` CTAs per SM in all, split over the shards,
    and no more than a shard's buckets can keep busy."""
    if min(s, r, d, n_sm) < 1 or n < 0:
        raise ValueError(f"cscatter.plan: bad sizes s={s} r={r} n={n} d={d} "
                         f"n_sm={n_sm}")
    dc = min(d, MAX_COLS)
    r32 = -(-r // 32) * 32
    acc = ACC_BYTES
    while True:
        br = min(max(32, acc // (dc * item) // 32 * 32), r32)
        n_blocks = -(-r // br)
        if n_blocks <= HIST_CAP or acc >= MAX_ACC_BYTES:
            break
        acc = min(2 * acc, MAX_ACC_BYTES)
    hist_cap = min(n_blocks, HIST_CAP)
    counters = -(-hist_cap // 4) * 4       # read 4 at a time
    stage = n_blocks <= hist_cap and 4 * (counters + 2 * n) <= BUCKET_SMEM
    list_cap = max(1, min(n_blocks, n))
    per_shard = -(-FOLD_CTAS_PER_SM * n_sm // s)
    return Plan(br=br, dc=dc, col_tiles=-(-d // dc), n_blocks=n_blocks,
                hist_cap=hist_cap, chunks=-(-n_blocks // hist_cap),
                list_cap=list_cap,
                fold_ctas=max(1, min(per_shard, -(-list_cap // FOLD_WARPS))),
                stage=stage, scratch=s * (2 * n + 2 * list_cap + 3))


_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _kernel_fn():
    from repro_torch.kernels import _build
    fn = _build.load("cscatter").cscatter_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float] + [ctypes.c_int64] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
    return fn


@kernel_call("cscatter")
def cscatter(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor, *,
             kind: str = "add", sat_min: float = 0.0,
             sat_max: float = 0.0) -> torch.Tensor:
    """``table [S,R,D] | [R,D]``; ``ids`` int32 ``[S,N] | [N]``; ``vals``
    ``[S,N,D] | [N,D]`` in the table's dtype. Updates ``table`` in place
    and returns it: the CUDA kernels on a CUDA tensor, the plain version's
    arithmetic on a CPU tensor."""
    if table.device.type == "cpu":
        return cscatter_plain_(table, ids, vals, kind=kind, sat_min=sat_min,
                               sat_max=sat_max)
    t, i, v = _check(table, ids, vals, kind)
    if t.device.type != "cuda":
        raise ValueError(f"cscatter: no kernel for device {t.device}")
    s, r, d = t.shape
    n = i.shape[1]
    if n > 0:
        launch(t, i, v, kind, sat_min, sat_max,
               plan(s, r, n, d, _sm_count(t.device), acc_item(t.dtype, kind)))
    return table


def launch(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor, kind: str,
           sat_min: float, sat_max: float, p: Plan) -> None:
    """The two launches of one call, on checked stacked CUDA arguments
    with ``N >= 1``, sized by ``p``. :func:`cscatter` passes ``plan``'s
    choice; a test may pass another valid plan (``stage`` off, a smaller
    ``hist_cap``) to reach each branch of the bucket pass."""
    s, r, d = t.shape
    n = i.shape[1]
    scratch = torch.empty(p.scratch, dtype=torch.int32, device=t.device)
    fn = _kernel_fn()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), v.data_ptr(), scratch.data_ptr(),
                 s, r, n, d, _DTYPE_CODE[t.dtype], MERGE_KINDS.index(kind),
                 sat_min, sat_max, p.br, p.dc, p.n_blocks, p.hist_cap,
                 p.list_cap, p.fold_ctas, int(p.stage), stream)
    if err != 0:
        raise RuntimeError(f"cscatter kernel launch failed: cudaError {err}")
    cscatter.launches += LAUNCHES_PER_CALL


cscatter.launches = 0
