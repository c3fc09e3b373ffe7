"""PyTorch oracles for the cscatter and cmerge kernels.

The counterparts of the JAX package's ``repro/kernels/ref.py``
``ref_cscatter``, ``ref_cscatter_serial`` and ``ref_cmerge``, with the same
definitions — including integer ``sat_add``, which the cscatter oracles add
and clip in float32 (the kernel adds in the integer dtype first; see
``kernels/cscatter.py``). ``ref_cscatter_serial`` is the gold standard: a
literal serialization of the COp stream.

torch's ``uint32`` supports few ops, so integer tables are computed in int64
and wrapped back to the table's dtype (exact for add, max, min and or).

``ref_attention`` and ``ref_decode_attention`` are the attention oracles
of ``ref.py``: an f32 softmax over scores masked with ``-inf``.
"""

from __future__ import annotations

import torch

_U32 = 1 << 32


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where the oracle computes: float32 for float tables, int64 (then
    wrapped) for integer ones."""
    return torch.float32 if dtype.is_floating_point else torch.int64


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 tensor reduced mod 2**32 into ``dtype``'s value range."""
    x = x & (_U32 - 1)
    if dtype == torch.uint32:
        return x
    return torch.where(x >= _U32 // 2, x - _U32, x)


def _identity(kind: str, dtype: torch.dtype) -> float | int:
    if kind in ("add", "sat_add", "or"):
        return 0
    info = torch.finfo(torch.float32) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _combine(kind: str, a, b):
    if kind in ("add", "sat_add"):
        return a + b
    if kind == "max":
        return torch.maximum(a, b)
    if kind == "min":
        return torch.minimum(a, b)
    if kind == "or":
        return a | b
    raise ValueError(kind)


def _apply(kind: str, mem: torch.Tensor, u: torch.Tensor, sat_min: float,
           sat_max: float) -> torch.Tensor:
    """``mem`` in the table's dtype, ``u`` in the accumulator's."""
    dtype = mem.dtype
    if not dtype.is_floating_point:
        m = mem.to(torch.int64)
        u = _wrap(u, dtype)  # the reference accumulates in the table dtype
        if kind == "add":
            out = m + u
        elif kind == "sat_add":
            s = m.to(torch.float32) + u.to(torch.float32)
            out = torch.clamp(s, sat_min, sat_max).to(torch.int64)
        elif kind == "max":
            out = torch.maximum(m, u)
        elif kind == "min":
            out = torch.minimum(m, u)
        else:
            out = m | u
        return _wrap(out, dtype).to(dtype)
    if kind == "add":
        return mem + u.to(dtype)
    if kind == "sat_add":
        s = mem.to(torch.float32) + u
        return torch.clamp(s, sat_min, sat_max).to(dtype)
    if kind == "max":
        return torch.maximum(mem, u.to(dtype))
    if kind == "min":
        return torch.minimum(mem, u.to(dtype))
    raise ValueError(f"kind {kind!r} needs an integer table")


def _select(mask: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """``torch.where(mask, a, b)`` for every dtype: an unsigned one through
    the signed view of its bits (PyTorch 2.11's CPU ``where`` has no
    uint32)."""
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}.get(a.dtype)
    if signed is None:
        return torch.where(mask, a, b)
    return torch.where(mask, a.view(signed), b.view(signed)).view(a.dtype)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def ref_cscatter(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                 kind: str = "add", sat_min: float = 0.0,
                 sat_max: float = 0.0) -> torch.Tensor:
    """Vectorized privatize-and-merge oracle: fold deltas per row, apply
    once. ``table [R, D]``, ``ids [N]``, ``vals [N, D]``."""
    r, d = table.shape
    acc = _acc_dtype(table.dtype)
    ident = _identity(kind, table.dtype)
    u = torch.full((r, d), ident, dtype=acc, device=table.device)
    valid = (ids >= 0) & (ids < r)
    safe = torch.where(valid, ids, 0).long()
    v = vals.to(acc)
    if kind in ("add", "sat_add"):
        u.index_add_(0, safe, torch.where(valid[:, None], v, 0))
    elif kind in ("max", "min"):
        v = torch.where(valid[:, None], v, torch.full_like(v, ident))
        u.scatter_reduce_(0, safe[:, None].expand_as(v), v,
                          "amax" if kind == "max" else "amin")
    else:  # or — no scatter_reduce for or: serial fold over the stream
        for i, val, ok in zip(safe.tolist(), v, valid.tolist()):
            if ok:
                u[i] |= val
    touched = torch.zeros(r, dtype=torch.bool, device=table.device)
    touched[safe[valid]] = True
    merged = _apply(kind, table, u, _f32(sat_min), _f32(sat_max))
    return _select(touched[:, None], merged, table)


def ref_cscatter_serial(table: torch.Tensor, ids: torch.Tensor,
                        vals: torch.Tensor, kind: str = "add",
                        sat_min: float = 0.0,
                        sat_max: float = 0.0) -> torch.Tensor:
    """Gold standard: literal serialization of delta-fold + single apply."""
    r, d = table.shape
    acc = _acc_dtype(table.dtype)
    u = torch.full((r, d), _identity(kind, table.dtype), dtype=acc,
                   device=table.device)
    touched = torch.zeros(r, dtype=torch.bool, device=table.device)
    for i, val in zip(ids.tolist(), vals.to(acc)):
        if 0 <= i < r:
            u[i] = _combine(kind, u[i], val)
            touched[i] = True
    merged = _apply(kind, table, u, _f32(sat_min), _f32(sat_max))
    return _select(touched[:, None], merged, table)


# ------------------------------------------------------------------ cmerge


def _cmerge_block(kind: str, mem: torch.Tensor, src: torch.Tensor,
                  upd: torch.Tensor, sat_min: float,
                  sat_max: float) -> torch.Tensor:
    """One way's merged block, in the table's dtype: ``apply(mem,
    delta(src, upd))`` for the cmerge kinds."""
    dtype = mem.dtype
    if kind == "sat_add":
        s = mem.to(torch.float32) + (upd.to(torch.float32)
                                     - src.to(torch.float32))
        s = torch.clamp(s, sat_min, sat_max)
        if dtype.is_floating_point:
            return s.to(dtype)
        return _wrap(s.to(torch.int64), dtype).to(dtype)
    if dtype.is_floating_point:
        if kind == "add":
            return mem + (upd - src)
        if kind == "max":
            return torch.maximum(mem, upd)
        if kind == "min":
            return torch.minimum(mem, upd)
        raise ValueError(f"kind {kind!r} needs an integer table")
    m, s, u = (x.to(torch.int64) for x in (mem, src, upd))
    if kind == "add":
        out = m + (u - s)
    elif kind == "max":
        out = torch.maximum(m, u)
    elif kind == "min":
        out = torch.minimum(m, u)
    elif kind == "or":
        out = m | u
    else:
        raise ValueError(kind)
    return _wrap(out, dtype).to(dtype)


def ref_cmerge(table: torch.Tensor, block_ids: torch.Tensor,
               dirty: torch.Tensor, src: torch.Tensor, upd: torch.Tensor,
               kind: str = "add", sat_min: float = 0.0,
               sat_max: float = 0.0) -> torch.Tensor:
    """Serial oracle of the merge instruction: for each valid dirty way
    ``w`` in order, ``table[block_ids[w]] = apply(mem, delta(src[w],
    upd[w]))``. ``table [R, D]``, ``block_ids [W]``, ``dirty [W]``,
    ``src, upd [W, BR, D]``; returns a new table. A block id past the
    table's end is skipped, as the Pallas kernel leaves it (the JAX oracle
    clamps it onto the last block instead)."""
    w, br, _ = src.shape
    out = table.clone()
    lo, hi = _f32(sat_min), _f32(sat_max)
    for i, (b, ok) in enumerate(zip(block_ids.tolist(), dirty.tolist())):
        if b < 0 or not ok or (b + 1) * br > table.shape[0]:
            continue
        mem = out[b * br:(b + 1) * br]
        out[b * br:(b + 1) * br] = _cmerge_block(kind, mem, src[i], upd[i],
                                                 lo, hi)
    return out


# --------------------------------------------------------------- attention


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q [B,H,S,d]; k,v [B,KV,T,d] -> [B,H,S,d] (f32 softmax)."""
    b, h, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, n_kv, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / d ** 0.5
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        scores = torch.where(mask, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         position: int) -> torch.Tensor:
    """q [B,H,d]; k,v [B,T,KV,d]; attends to slots [0, position]."""
    b, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, n_kv, g, d).float()
    kf = k.transpose(1, 2).float()                   # [B,KV,T,d]
    vf = v.transpose(1, 2).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, kf) / d ** 0.5
    mask = torch.arange(t, device=q.device) <= position
    scores = torch.where(mask, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)
