"""Op-level cost walk: FLOPs, HBM bytes, wire bytes and peak live bytes of
one device's program, seen at PyTorch's dispatcher.

The counterpart of the JAX package's ``repro/launch/hlo_cost.py``, which
walks the compiled HLO of one device. Here the program is run (on fake
tensors in the planner, for real in a count check) under :class:`OpWalk`,
a ``TorchDispatchMode`` that sees every aten op one device runs: under
DTensor it declines the global op and sees the local ops DTensor issues on
the device's shard, and the collectives DTensor inserts.

* **FLOPs**: ``mm``, ``mm(out_dtype=)``, ``addmm``, ``bmm`` and
  ``baddbmm`` count ``2 x |out| x |contracted|`` (``_dot_flops``).
* **HBM bytes**: every op counts its tensor operands and results at its
  boundary, the eager counterpart of a fusion's operands and result
  (``_fusion_memory_bytes``); a view, a metadata query, an allocation and
  a ``wait_tensor`` are free, and a gather (``embedding``, ``index``,
  ``index_select``, ``gather``) counts its indices and twice its result, as
  the HLO walk counts a gather.
* **Wire bytes**: each ``_c10d_functional`` collective by the ring model of
  ``_wire_bytes`` on its result, over its group's size, and classified into
  a per-level vector by the hierarchy levels each of its ring's links
  crosses (``_link_level``, ``_ring_level_fractions``): the bytes of every
  group of the mesh dim the collective runs over, machine-wide, divided by
  the device count, as the HLO walk divides its replica groups' bytes.
  The merge engine's exchanges over a ``core/mesh_axis.MeshAxis`` are
  counted from the axis's ``"collective"`` event, one collective a leaf
  (a ``ppermute`` a collective-permute, a ``psum/pmax/pmin`` an
  all-reduce), as ``launch/wire_cost.py`` and the recorded walk of
  ``analysis/placement.py`` count them: a permutation's payload once on
  every pair whose ranks differ, on the level where the two first share a
  block; a reduction's by the ring model over each aligned group; pairs
  and groups are merge ranks, which the levels block. The ops that carry
  the exchange, up to the axis's ``"collective_end"``, are not counted
  (their results are kept alive in the live bytes). These exchanges are
  also kept apart, as the result's ``"merge"``, a dict of the same
  collective keys: the merge's own traffic, which the plan checks against
  the cost model, where the totals add the step's other collectives (the
  gather of FSDP parameters, the loss's mean).
* **Peak live bytes**: the storages alive at once on the device (the
  inputs' from the start), the counterpart of ``memory_analysis()``.
* **Boundary bytes**: the inputs' storages (:meth:`OpWalk.add_inputs`)
  and the outputs' that are not an input's (:meth:`OpWalk.add_outputs`),
  each once: the bytes any implementation of the step must move (read its
  inputs once, write its outputs once). The HBM bytes above are the eager
  program's traffic, an upper bound on a fused one's; the boundary bytes
  are the floor a roofline share is taken against.
* **Kernels**: each call of ``flash_attention``, ``decode_attention``,
  ``cscatter``, ``cmerge`` or ``selective_scan`` (and the scan's backward
  op, ``selective_scan_backward``) is counted once, by its own formula here,
  whichever route ran it: the custom op on a planner's tensor, the
  wrapper's ``kernel_begin`` event on a concrete one (the CUDA launch, or
  the plain version, whose own aten ops are then not counted).

A planner's walk (``device="meta"``) counts only the ops on its meta
tensors, the device's data: DTensor's own bookkeeping (index arithmetic on
host tensors, and the runs on fake global tensors that derive an op's
result shape) is not the device's work.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hooks
from repro_torch.launch import wire_cost

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_GATHERS = {"embedding", "index", "index_select", "gather"}
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "detach", "alias", "lift_fresh", "wait_tensor",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_to_copy_noop", "device",
         "dim", "size", "stride", "record_stream", "set_"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}
# custom ops -> the kernel whose formula counts them
_OPS = {"flash_attention": "flash_attention",
        "decode_attention": "decode_attention",
        "decode_attention_lse": "decode_attention", "cscatter": "cscatter",
        "selective_scan": "selective_scan",
        "selective_scan_backward": "selective_scan_backward"}


def _wire_bytes(op: str, rbytes: int, g: int) -> float:
    """Ring-model bytes a device sends for one collective (``_wire_bytes``
    of the HLO walk, keyed by its op names)."""
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * rbytes
    if op == "all-gather":
        return (g - 1) / g * rbytes
    if op == "reduce-scatter":
        return float((g - 1) * rbytes)
    if op == "all-to-all":
        return (g - 1) / g * rbytes
    return float(rbytes)


def _link_level(s: int, t: int, bounds: list[int]) -> int:
    """Hierarchy level of a directed link: 0 if both ends share the
    innermost block, i if they first meet at the level-i block, top
    otherwise. ``bounds`` are the block sizes B_1..B_{N-1}."""
    for i, b in enumerate(bounds):
        if s // b == t // b:
            return i
    return len(bounds)


def _ring_level_fractions(group: list[int], bounds: list[int]) -> list[float]:
    """Per-level fraction of a group's ring links."""
    n_levels = len(bounds) + 1
    if len(group) < 2:
        return [0.0] * n_levels
    ring = sorted(group)
    counts = [0] * n_levels
    for a, b in zip(ring, ring[1:] + ring[:1]):
        counts[_link_level(a, b, bounds)] += 1
    return [c / len(ring) for c in counts]


def level_bounds(level_sizes: Sequence[int]) -> list[int]:
    """Block sizes B_1..B_{N-1} of per-level fanouts, innermost first."""
    out, acc = [], 1
    for s in list(level_sizes)[:-1]:
        acc *= s
        out.append(acc)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results: tensors, and tensors
    in lists, tuples and dicts one or two levels down (an aten op's
    arguments are no deeper)."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def dot_flops(name: str, args: Sequence, out: torch.Tensor) -> float:
    """``2 x |out| x |contracted|`` of a product op."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _visible_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """Query-key pairs the flash kernel computes: query ``i`` sees keys
    ``j <= i`` (``i - W < j`` with a window), both counted from 0."""
    if not causal:
        return s * t
    i1 = np.arange(1, s + 1, dtype=np.int64)        # i + 1
    hi = np.minimum(i1, t)
    lo = np.maximum(0, i1 - window) if window else 0
    return int(np.maximum(0, hi - lo).sum())


def kernel_cost(name: str, args: Sequence, kwargs: dict) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one kernel call, from its arguments: each
    input read once and each output written once.

    * ``flash_attention(q [B,H,S,d], k, v [B,KV,T,d], causal, window)``:
      ``4 B H d`` per visible query-key pair; q, k, v and the output.
    * ``decode_attention(q [B,H,d], k, v [B,T,KV,d], position)``: ``4 B H
      d (position + 1)``; q, the output and the ``position + 1`` slots of
      k and v it reads.
    * ``cscatter(table [S,R,D] | [R,D], ids, vals, ...)``: one combine per
      value element; ids, vals and the rows it may touch, read and written
      (``min(N, R)`` a shard: the bound without the ids' values).
    * ``cmerge(table, block_ids, dirty, src, upd)``: one combine per update
      element; ids, dirty, src, upd and the ways' rows of the table, read
      and written (every way dirty: the bound without the flags' values).
    * ``selective_scan(dt, u [B,T,D], b, c [B,T,S], a [D,S], h0 [B,D,S])``:
      ``B T D S`` exponentials (its operations, at whatever rate); the six
      inputs, y (f32, dt's shape) and h_T (h0's). Its backward
      ``selective_scan_backward(dt, u, b, c, a, h0, dy, dh)``: the same
      exponentials; the eight inputs and the six gradients (each its
      input's shape and dtype). Neither counts the kernels' own checkpoints
      (``chip_smoke.py``'s ``scan_bound_ms``: a choice of their design).
    """
    if name == "flash_attention":
        q, k, v = args[:3]
        causal = kwargs.get("causal", args[3] if len(args) > 3 else True)
        window = int(kwargs.get("window", args[4] if len(args) > 4 else 0))
        b, h, s, d = q.shape
        pairs = _visible_pairs(s, k.shape[2], causal, window)
        return (4.0 * b * h * d * pairs,
                float(2 * _nbytes(q) + _nbytes(k) + _nbytes(v)))
    if name == "decode_attention":
        q, k, v = args[:3]
        position = int(kwargs.get("position", args[3]))
        b, h, d = q.shape
        slots = min(position + 1, k.shape[1])
        kv_read = 2 * b * slots * k.shape[2] * d * k.element_size()
        return 4.0 * b * h * d * slots, float(2 * _nbytes(q) + kv_read)
    if name == "cscatter":
        table, ids, vals = args[:3]
        t = table if table.dim() == 3 else table.unsqueeze(0)
        s, r, d = t.shape
        n = ids.shape[-1]
        rows = s * min(n, r) * d * table.element_size()
        return (float(vals.numel()),
                float(_nbytes(ids) + _nbytes(vals) + 2 * rows))
    if name == "cmerge":
        table, block_ids, dirty, src, upd = args[:5]
        rows = upd.numel() * table.element_size()     # S W BR rows of D
        return (float(upd.numel()),
                float(_nbytes(block_ids) + _nbytes(dirty) + _nbytes(src)
                      + _nbytes(upd) + 2 * rows))
    if name in ("selective_scan", "selective_scan_backward"):
        dt, u, b, c, a, h0 = args[:6]
        ins = sum(_nbytes(t) for t in args[:8] if isinstance(t, torch.Tensor))
        outs = (_nbytes(dt) + _nbytes(h0) if name == "selective_scan"
                else sum(_nbytes(t) for t in args[:6]))
        return float(dt.numel() * a.shape[-1]), float(ins + outs)
    raise ValueError(f"no cost formula for kernel {name!r}")


class OpWalk(TorchDispatchMode):
    """Count one device's work while a program runs under it.

    ``mesh`` (a ``DeviceMesh``) names the groups a collective can run over;
    ``level_sizes`` / ``level_names`` (innermost first, covering the
    mesh's ranks) classify its wire bytes. With ``device`` (the planner's
    ``"meta"``) only ops on plain tensors of that device type count. Use as
    a context manager around
    the program; :meth:`result` gives the counts. ``inputs`` (or
    :meth:`add_inputs`) are the tensors alive from the start (parameters,
    state, batch). Build it outside any ``FakeTensorMode``."""

    def __init__(self, mesh=None, level_sizes: Optional[Sequence[int]] = None,
                 level_names: Optional[Sequence[str]] = None, inputs=(),
                 device: Optional[str] = None):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.wire_bytes = 0.0
        self.per_collective: dict[str, dict] = {}
        self.kernels: dict[str, dict] = {}
        self.by_op: dict[str, list] = {}     # name -> [calls, flops, bytes]
        self.level_sizes = list(level_sizes) if level_sizes else None
        self.level_names = (list(level_names) if level_names else
                            [f"level{i}" for i in range(len(level_sizes))]
                            if level_sizes else None)
        self.bounds = (level_bounds(level_sizes) if level_sizes else None)
        self.by_level_total = ([0.0] * len(level_sizes) if level_sizes
                               else None)
        # the merge axes' own collectives (a subset of the totals)
        self.merge_per_collective: dict = {}
        self.merge_by_level = list(self.by_level_total or [])
        self.n_devices = mesh.size() if mesh is not None else 1
        self._groups = self._mesh_groups(mesh) if mesh is not None else {}
        self._suppress = 0
        self._carrying = 0      # inside a merge axis's collective
        self._live: dict[int, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.input_bytes = 0
        self.output_bytes = 0
        self._boundary: set[int] = set()     # storages counted at the edge
        self.add_inputs(inputs)
        self._stack = contextlib.ExitStack()

    # ------------------------------------------------------------ groups

    @staticmethod
    def _mesh_groups(mesh) -> dict:
        """Each mesh dim's process-group name, and each of its groups' rank
        tuples -> every group of that dim (ranks), as an HLO replica-group
        list (built outside any fake mode: the mesh's rank tensor is
        real)."""
        out = {}
        ranks = np.asarray(mesh.mesh.tolist())
        for i in range(ranks.ndim):
            rows = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            groups = rows.tolist()
            out[mesh.get_group(i).group_name] = groups
            for g in groups:
                out[tuple(sorted(g))] = groups
        return out

    def _groups_of(self, group_name: str) -> list[list[int]]:
        """Every group of the mesh dim a collective's group belongs to (a
        group DTensor made for an equal mesh is known by its ranks); a
        group of no mesh dim stands alone."""
        if group_name in self._groups:
            return self._groups[group_name]
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        ranks = dist.get_process_group_ranks(
            _resolve_process_group(group_name))
        return self._groups.get(tuple(sorted(ranks)), [ranks])

    # ------------------------------------------------------------ memory

    def add_inputs(self, inputs) -> None:
        """Count ``inputs`` (a pytree) as alive from the start."""
        from torch.utils import _pytree as pytree
        for t in pytree.tree_leaves(inputs):
            if not isinstance(t, torch.Tensor):
                continue
            self._track(_local(t))
            self._boundary.add(_storage_key(_local(t)))
        self.input_bytes = self.live_bytes

    def add_outputs(self, outputs) -> None:
        """Count the storages of ``outputs`` (a pytree) that are neither an
        input's nor counted already as written once (an in-place result,
        such as a cache updated in its input's storage, adds nothing)."""
        from torch.utils import _pytree as pytree
        for t in pytree.tree_leaves(outputs):
            if not isinstance(t, torch.Tensor):
                continue
            t = _local(t)
            key = _storage_key(t)
            if key is not None and key not in self._boundary:
                self._boundary.add(key)
                self.output_bytes += t.untyped_storage().nbytes()

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None:
            return
        st = t.untyped_storage()
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [0, st.nbytes()]
            self.live_bytes += entry[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live_bytes -= entry[1]
            del self._live[key]

    # ------------------------------------------------------------ counts

    def _count_kernel(self, name: str, args, kwargs) -> None:
        flops, nbytes = kernel_cost(name, args, kwargs)
        self.flops += flops
        self.hbm_bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "hbm_bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["hbm_bytes"] += nbytes

    def _count_collective(self, base: str, args, out) -> None:
        rbytes = sum(_nbytes(t) for t in _tensors(out))
        group_name = args[-1]
        groups = self._groups_of(group_name)
        g = len(groups[0])
        wire = _wire_bytes(base, rbytes, g)
        d = self.per_collective.setdefault(
            base, {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += rbytes
        d["wire_bytes"] += wire
        self.wire_bytes += wire
        if self.bounds is None:
            return
        vec = [0.0] * len(self.level_sizes)
        for grp in groups:
            total = len(grp) * _wire_bytes(base, rbytes, len(grp))
            for lvl, frac in enumerate(_ring_level_fractions(grp,
                                                             self.bounds)):
                vec[lvl] += total * frac
        dl = d.setdefault("wire_bytes_by_level_total", [0.0] * len(vec))
        for lvl, b in enumerate(vec):
            dl[lvl] += b
            self.by_level_total[lvl] += b

    def _count_merge(self, axis, kind: str, x, group, perm) -> None:
        """One ``MeshAxis`` collective, a collective a leaf of ``x`` (each
        device's ``[1, ...]`` slice), machine-wide, into the totals and
        into the merge's own counts (:meth:`result`'s ``"merge"``). Its
        pairs and groups are merge ranks, which the levels block."""
        from torch.utils import _pytree as pytree
        leaves = [t for t in pytree.tree_leaves(x)
                  if isinstance(t, torch.Tensor)]
        base = "collective-permute" if kind == "ppermute" else "all-reduce"
        g = group or axis.size
        sends = kind == "ppermute" and any(
            a == axis.rank and b != axis.rank for a, b in perm)
        for per, vec in ((self.per_collective, self.by_level_total),
                         (self.merge_per_collective, self.merge_by_level)):
            d = per.setdefault(base, {"count": 0.0, "result_bytes": 0.0,
                                      "wire_bytes": 0.0})
            if self.bounds is not None:
                dl = d.setdefault("wire_bytes_by_level_total",
                                  [0.0] * len(self.level_sizes))
            for t in leaves:
                nbytes = _nbytes(t) // axis.stack
                mine = ((float(nbytes) if sends else 0.0) if perm is not None
                        else (_wire_bytes("all-reduce", nbytes, g)
                              if g > 1 else 0.0))
                d["count"] += 1
                d["result_bytes"] += nbytes
                d["wire_bytes"] += mine
                if per is self.per_collective:
                    self.wire_bytes += mine
                if self.bounds is None:
                    continue
                # machine-wide, as wire_cost and the recorded walk add them
                for v in (dl, vec):
                    if perm is not None:
                        wire_cost._permute(v, perm, nbytes, self.bounds)
                    else:
                        wire_cost._all_reduce(v, axis.size, g, nbytes,
                                              self.bounds)

    def _on_device(self, tree) -> bool:
        """Whether an op works on the device's data: with a device type,
        a plain tensor of that type among its arguments or results."""
        if self.device is None:
            return True
        return any(type(t) is torch.Tensor and t.device.type == self.device
                   for t in _tensors(tree))

    def _on_event(self, event: str, *args) -> None:
        if event == "kernel_begin":
            if self._suppress == 0:
                self._count_kernel(args[0], args[1], args[2])
            self._suppress += 1
        elif event == "kernel_end":
            self._suppress -= 1
        elif event == "collective" and _on_mesh(args[0]):
            if self._suppress == 0:
                self._count_merge(*args)
            self._suppress += 1
            self._carrying += 1
        elif event == "collective_end" and _on_mesh(args[0]):
            self._suppress -= 1
            self._carrying -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented
        if self._suppress:
            out = func(*args, **kwargs)
            if self._carrying and not func.is_view:
                for t in _tensors(out):
                    self._track(t)
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "repro_torch" and name in _OPS:
            if self._on_device((args, kwargs)):
                self._count_kernel(_OPS[name], args, kwargs)
            self._suppress += 1
            try:
                return func(*args, **kwargs)
            finally:
                self._suppress -= 1
        out = func(*args, **kwargs)
        if not self._on_device((args, kwargs, out)):
            return out
        if ns in ("_c10d_functional", "_c10d_functional_autograd") \
                and name in _COLLECTIVES:
            self._count_collective(_COLLECTIVES[name], args, out)
        elif not (func.is_view or name in _FREE or ns == "prim"):
            outs = _tensors(out)
            flops = dot_flops(name, args, outs[0]) if name in _DOTS else 0.0
            if name in _GATHERS:
                idx = [t for t in _tensors((args, kwargs))
                       if not t.is_floating_point()]
                nbytes = (2 * sum(_nbytes(t) for t in outs)
                          + sum(_nbytes(t) for t in idx))
            else:
                nbytes = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                          + sum(_nbytes(t) for t in outs))
            self.flops += flops
            self.hbm_bytes += nbytes
            rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += flops
            rec[2] += nbytes
        if not func.is_view:
            for t in _tensors(out):
                self._track(t)
        return out

    # ------------------------------------------------------------ context

    def __enter__(self):
        self._stack.enter_context(hooks.listening(self._on_event))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def result(self) -> dict:
        out = {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
               "wire_bytes": self.wire_bytes,
               "per_collective": self.per_collective,
               "kernels": self.kernels,
               "by_op": {k: {"calls": v[0], "flops": v[1], "hbm_bytes": v[2]}
                         for k, v in sorted(self.by_op.items(),
                                            key=lambda kv: -kv[1][2])},
               "peak_live_bytes": self.peak_bytes,
               "input_bytes": self.input_bytes,
               "output_bytes": self.output_bytes,
               "boundary_bytes": self.input_bytes + self.output_bytes,
               "num_partitions": self.n_devices}
        if self.level_sizes:
            out["level_sizes"] = list(self.level_sizes)
            out["level_names"] = list(self.level_names)
            out["wire_bytes_by_level_total"] = list(self.by_level_total)
            out["wire_bytes_by_level"] = [b / self.n_devices
                                          for b in self.by_level_total]
        if self.merge_per_collective:
            out["merge"] = {
                "per_collective": self.merge_per_collective,
                "level_sizes": out.get("level_sizes"),
                "level_names": out.get("level_names"),
                "wire_bytes_by_level_total": list(self.merge_by_level),
                "wire_bytes_by_level": [b / self.n_devices
                                        for b in self.merge_by_level]}
        return out


def _on_mesh(axis) -> bool:
    """Whether a collective's axis is a merge axis over a mesh's dims."""
    from repro_torch.core.mesh_axis import MeshAxis
    return isinstance(axis, MeshAxis)


def _storage_key(t: torch.Tensor) -> Optional[int]:
    """The identity of ``t``'s storage, or None where it has none."""
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, else the tensor."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t
