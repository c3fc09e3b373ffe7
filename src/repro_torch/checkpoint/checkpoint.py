"""Checkpoints with an atomic two-phase commit.

Layout (the JAX package's ``repro/checkpoint/checkpoint.py``, so a
checkpoint written by either package loads in the other):

    ckpt_dir/
      step_00000100.tmp/       (phase 1: written here)
      step_00000100/           (phase 2: atomic rename)
        manifest.json          leaf keys, shapes, true dtypes, extras
        arrays.npz             leaf data, keyed by flattened tree path
      LATEST                   text file, written last (commit point)

A partially written checkpoint is never visible: ``LATEST`` only ever
names a fully renamed directory.

A tree whose leaves are DTensors (state split over the processes of a
group: FSDP parameters and moments, ``Shard(0)`` pendings) is saved by
every process of the group together: each leaf's global array is gathered
to rank 0 in turn and written there while the next one is gathered (no
more than two leaves are alive at once), rank 0 alone writes the files,
and a barrier follows, so that no
process returns, or reads ``LATEST``, before the commit. The file is the
one a single process writes, so a checkpoint written over processes loads
anywhere, and the reverse. :func:`restore`, :func:`restore_resharded` and
:func:`from_raw` place a leaf onto a DTensor layout, given by a ``like``
DTensor or by a ``(DeviceMesh, placements)`` target: each process reads
the file and keeps its own shard, so no collective runs.

A tree is a dict, list, tuple or
NamedTuple nesting of leaves (``torch.Tensor``, numpy arrays and scalars);
dict keys flatten in sorted order, NamedTuple fields by name (JAX's
``GetAttrKey``: an ``OptState``'s ``step``, ``mu``, ``nu``), other
sequence items by index, joined by ``"/"``; ``None`` holds no leaf.
``.npz`` holds no bfloat16 or float8, so those leaves are stored as raw
bits beside their true dtype, and :func:`load_raw` and :func:`restore`
return them as torch tensors.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any
SEP = "/"

# dtypes numpy cannot hold, stored as unsigned raw bits of their width
_RAW_BITS = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
_SIGNED = {1: torch.int8, 2: torch.int16}


def _flatten_with_paths(tree: PyTree, prefix: tuple = (), is_leaf=None
                        ) -> list[tuple[str, Any]]:
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(SEP.join(prefix), tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(SEP.join(prefix), tree)]
    out = []
    for k, sub in items:
        out += _flatten_with_paths(sub, prefix + (k,), is_leaf)
    return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def digest(t: torch.Tensor) -> int:
    """A digest of ``t``'s bits, on its device: each element's bit pattern
    as an integer of its width, times its flat index mod 65521 plus one,
    summed mod 2^64 (in any order: integer addition wraps alike). Equal
    tensors give equal digests; a changed bit, or an element moved, changes
    it."""
    bits = t.detach().contiguous().reshape(-1)
    bits = bits.view(_BITS[bits.element_size()])
    total, step = 0, 1 << 24
    for start in range(0, bits.numel(), step):
        chunk = bits[start:start + step].to(torch.int64)
        weight = torch.arange(start, start + chunk.numel(),
                              device=chunk.device) % 65521 + 1
        total = (total + int((chunk * weight).sum())) % (1 << 64)
    return total


def shard_digests(tree: PyTree) -> dict:
    """Each leaf key of ``tree`` -> this process's slice of it (its global
    ``offset`` and ``shape``: a DTensor's local shard, else the whole) and
    its :func:`digest`: what a checkpoint of ``tree`` must hold there, bit
    for bit."""
    out = {}
    for key, x in _flatten_with_paths(tree):
        if not isinstance(x, torch.Tensor):
            continue
        if _is_dtensor(x):
            from torch.distributed.tensor._utils import (
                compute_local_shape_and_global_offset)
            shape, offset = compute_local_shape_and_global_offset(
                x.shape, x.device_mesh, list(x.placements))
            x = x.to_local()
        else:
            shape, offset = tuple(x.shape), (0,) * x.dim()
        out[key] = {"offset": list(offset), "shape": list(shape),
                    "digest": digest(x)}
    return out


def tree_keys(tree: PyTree) -> list[str]:
    """The flattened ``"/"``-joined leaf paths of ``tree`` — the key space
    a checkpoint of it stores under."""
    return [k for k, _ in _flatten_with_paths(tree)]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _group_rank(tree: PyTree) -> Optional[int]:
    """This process's rank in the group when ``tree`` holds DTensors
    (every process saves it together), else None."""
    if not any(_is_dtensor(x) for _, x in _flatten_with_paths(tree)):
        return None
    import torch.distributed as dist
    return dist.get_rank()


def _whole(leaf):
    """A leaf's global array for the process that writes (rank 0): a
    DTensor gathered over its mesh onto rank 0's host (on host copies
    where the group's backend needs it); None on the other processes."""
    if not _is_dtensor(leaf):
        return leaf
    from repro_torch.core.mesh_axis import whole_on_host
    return whole_on_host(leaf.detach())


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array ``arrays.npz`` stores, and its true dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _RAW_BITS:
            width = t.element_size()
            return (t.view(_SIGNED[width]).numpy().view(f"uint{8 * width}"),
                    name)
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class _Stored:
    """The arrays of an ``arrays.npz`` by key (``np.load``'s interface:
    ``files``, ``[key]``, a context manager), each member read straight
    from the file into a new array (``np.fromfile`` past the member's
    headers, where ``np.load`` copies it through Python buffers) and its
    bytes held to the member's CRC, as ``zipfile`` holds them. Both
    packages write ``np.savez``'s layout, uncompressed ``.npy`` members of
    version 1 or 2; any other member raises."""

    def __init__(self, path: str):
        import zipfile
        self._path = path
        self._zip = zipfile.ZipFile(path)
        self._file = open(path, "rb")
        self._info = {i.filename[:-4]: i for i in self._zip.infolist()
                      if i.filename.endswith(".npy")}
        self.files = list(self._info)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        import struct
        import zipfile
        import zlib
        fmt = np.lib.format
        info, f = self._info[key], self._file
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = fmt.read_magic(f)
        read = {(1, 0): fmt.read_array_header_1_0,
                (2, 0): fmt.read_array_header_2_0}.get(version)
        if info.compress_type != zipfile.ZIP_STORED or read is None:
            raise ValueError(f"{self._path}: member {key!r} is not an "
                             f"uncompressed .npy of version 1 or 2")
        shape, fortran, dtype = read(f)
        if dtype.hasobject:
            raise ValueError(f"{self._path}: member {key!r} holds objects")
        header = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(header))
        arr = np.fromfile(f, dtype=dtype, count=math.prod(shape))
        if zlib.crc32(arr, crc) != info.CRC or \
                header + arr.nbytes != info.file_size:
            raise ValueError(f"{self._path}: member {key!r} fails its "
                             f"CRC: the file is damaged")
        return arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)


def load_raw(ckpt_dir: str, step: Optional[int] = None
             ) -> tuple[dict, dict]:
    """Load a checkpoint without a structure to load it into.

    Returns ``(leaves, manifest)``: ``leaves`` maps each flattened key path
    to its numpy array, or, for bfloat16 and float8 leaves, to a torch
    tensor of that dtype (restored from the stored bits).
    """
    path, manifest = _manifest_path(ckpt_dir, step)
    dtypes = {e["key"]: e["dtype"] for e in manifest["keys"]}
    with _Stored(os.path.join(path, "arrays.npz")) as data:
        leaves = {k: _true_dtype(data[k], dtypes.get(k)) for k in data.files}
    return leaves, manifest


def _true_dtype(arr: np.ndarray, want: Optional[str]):
    """A stored array in its true dtype: bfloat16 and float8 (stored as raw
    bits) as torch tensors, anything else as numpy."""
    want = want or str(arr.dtype)
    if want in _RAW_BITS:
        bits = arr.view(f"int{8 * arr.itemsize}")
        return torch.from_numpy(bits).view(_RAW_BITS[want])
    if want != str(arr.dtype):
        return arr.view(np.dtype(want))
    return arr


def _manifest_path(ckpt_dir: str, step: Optional[int]) -> tuple[str, dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def save(ckpt_dir: str, step: int, tree: PyTree,
         extras: Optional[dict] = None) -> str:
    """Two-phase-commit save. Returns the final checkpoint path.

    A tree of DTensors is saved by every process of its group together
    (module doc): each leaf gathered in turn, rank 0 writing, a barrier
    after the commit."""
    import zipfile
    rank = _group_rank(tree)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    writes = not rank
    if writes:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    manifest = {"step": step, "keys": [], "extras": extras or {}}

    def write(key, whole) -> dict:
        arr, true_dtype = _to_numpy(whole)
        del whole
        with zf.open(key + ".npy", "w", force_zip64=True) as f:
            _write_array(f, np.asanyarray(arr))
        return {"key": key, "shape": list(arr.shape), "dtype": true_dtype}

    # np.savez's layout (an uncompressed zip of .npy members), written a
    # leaf at a time by one thread while the next leaf is gathered: at
    # most two leaves are alive at once
    with contextlib.ExitStack() as stack:
        if writes:
            zf = stack.enter_context(zipfile.ZipFile(
                os.path.join(tmp, "arrays.npz"), "w", zipfile.ZIP_STORED,
                allowZip64=True))
            pool = stack.enter_context(ThreadPoolExecutor(1))
        written = None
        for key, leaf in _flatten_with_paths(tree):
            whole = _whole(leaf)
            if not writes:
                continue
            if written is not None:
                manifest["keys"].append(written.result())
            written = pool.submit(write, key, whole)
            del whole
        if written is not None:
            manifest["keys"].append(written.result())
    if writes:
        _commit(ckpt_dir, name, tmp, final, manifest)
    if rank is not None:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write_array(f, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``'s bytes: a C-ordered array's data is
    handed to the member straight from the array's memory, a chunk at a
    time (``write_array`` copies each chunk out first); any other array
    takes ``write_array``."""
    fmt = np.lib.format
    if arr.flags.c_contiguous and not arr.dtype.hasobject:
        try:
            fmt.write_array_header_1_0(f, fmt.header_data_from_array_1_0(arr))
        except ValueError:      # a header past version 1.0's
            pass
        else:
            data = memoryview(arr.reshape(-1)).cast("B")
            for i in range(0, len(data), 1 << 26):
                f.write(data[i:i + (1 << 26)])
            return
    fmt.write_array(f, arr, allow_pickle=False)


def _commit(ckpt_dir: str, name: str, tmp: str, final: str,
            manifest: dict) -> None:
    """Phase 2: the manifest, the atomic rename and ``LATEST``."""
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic on one filesystem
    latest = os.path.join(ckpt_dir, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(name)
    os.replace(latest + ".tmp", latest)        # commit point


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _rebuild(like: PyTree, load, prefix: tuple = ()) -> PyTree:
    """``like``'s structure with each leaf replaced by ``load(key, leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, load, prefix + (str(k),))
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), load, prefix + (f,))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, load, prefix + (str(i),))
                          for i, x in enumerate(like))
    return load(SEP.join(prefix), like)


def _is_layout(x) -> bool:
    """A DTensor target: ``(DeviceMesh, placements)``."""
    from torch.distributed.device_mesh import DeviceMesh
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def _targets(like: PyTree, device) -> dict:
    """Each leaf key of ``like`` -> its target: a device, or a
    ``(DeviceMesh, placements)`` layout. ``device`` is one device (or its
    name) for every leaf, or a tree of devices or layouts shaped like
    ``like``; without ``device`` a DTensor leaf of ``like`` names its own
    layout and any other leaf None (its own device, as :func:`restore`)."""
    keys = tree_keys(like)
    if device is None:
        return {k: ((x.device_mesh, tuple(x.placements)) if _is_dtensor(x)
                    else None) for k, x in _flatten_with_paths(like)}
    if isinstance(device, (str, torch.device)):
        return {k: torch.device(device) for k in keys}
    by_key = dict(_flatten_with_paths(device, is_leaf=_is_layout))
    missing = [k for k in keys if k not in by_key]
    if missing:
        raise ValueError(f"no target device for leaves {missing[:5]}...")
    return {k: by_key[k] if _is_layout(by_key[k]) else torch.device(by_key[k])
            for k in keys}


def _on_layout(key: str, arr, like, layout):
    """This process's shard of the stored global array ``arr`` under
    ``layout`` ``(mesh, placements)``, as a DTensor: a slice taken on the
    host, then copied to the mesh's device (no collective)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, placements = layout
    arr = torch.as_tensor(arr)
    want = tuple(getattr(like, "shape", arr.shape))
    if tuple(arr.shape) != want:
        raise ValueError(
            f"checkpoint leaf {key!r} has global shape {tuple(arr.shape)}, "
            f"its target {want}: the checkpoint was written under another "
            f"layout (a pending cascade of another rank count?); restore it "
            f"through runtime.TrainDriver.resume, which settles a changed "
            f"plan's pendings")
    shape, offset = compute_local_shape_and_global_offset(
        arr.shape, mesh, list(placements))
    local = arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return DTensor.from_local(local.contiguous().to(device), mesh,
                              list(placements), run_check=False,
                              shape=arr.shape, stride=arr.stride())


def _place(like: PyTree, get, have, device=None) -> PyTree:
    """``like``'s structure with each leaf ``get(key)`` (an array in its
    true dtype). Without ``device`` a leaf whose ``like`` is a DTensor
    comes back on that DTensor's layout, a tensor as a tensor on that
    tensor's device, any other as it was loaded; with ``device`` every
    leaf comes back as a tensor on its target, a device or a layout.
    Raises ``KeyError`` if ``have`` lacks a leaf of ``like``, and
    ``ValueError`` if a layout's global shape is not the stored one."""
    missing = [k for k in tree_keys(like) if k not in have]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    targets = _targets(like, device)

    def load(key, leaf):
        target = targets[key]
        if target is None:
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(get(key)).to(leaf.device)
            return get(key)
        if _is_layout(target):
            return _on_layout(key, get(key), leaf, target)
        return torch.as_tensor(get(key)).to(target)
    return _rebuild(like, load)


def _restore(ckpt_dir: str, like: PyTree, step: Optional[int], device
             ) -> tuple[PyTree, dict]:
    path, manifest = _manifest_path(ckpt_dir, step)
    dtypes = {e["key"]: e["dtype"] for e in manifest["keys"]}
    with _Stored(os.path.join(path, "arrays.npz")) as data:
        tree = _place(like, lambda k: _true_dtype(data[k], dtypes.get(k)),
                      set(data.files), device)
    return tree, manifest["extras"]


def restore(ckpt_dir: str, like: PyTree, step: Optional[int] = None
            ) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like``; returns (tree, extras).

    Each leaf keeps the dtype it was saved with; a leaf whose ``like`` is a
    DTensor comes back as this process's shard on its layout (its global
    shape must be the stored one, else ``ValueError``), a tensor as a
    tensor on that tensor's device, any other as numpy (bf16 and float8
    always as tensors). Raises ``KeyError`` if the checkpoint lacks a leaf
    of ``like``.
    """
    return _restore(ckpt_dir, like, step, None)


def restore_resharded(ckpt_dir: str, like: PyTree, device,
                      step: Optional[int] = None) -> tuple[PyTree, dict]:
    """Restore with each leaf placed on a target: ``device`` is one
    ``torch.device`` (or its name), or a tree shaped like ``like`` of
    devices and ``(DeviceMesh, placements)`` layouts.

    The counterpart of the JAX package's ``restore_resharded``, which places
    each leaf with a target sharding on any mesh: a checkpoint that a CPU
    run wrote restores onto the card, and one written by a single process
    onto the shards of a process group (each process keeping its slice of
    the global array). Every leaf comes back as a tensor in the dtype it
    was saved with. For a layout, ``like``'s leaf gives the global shape
    (a DTensor's, or a meta tensor's as JAX's ``ShapeDtypeStruct``), and a
    stored array of another shape raises ``ValueError``.
    """
    return _restore(ckpt_dir, like, step, device)


def from_raw(leaves: dict, like: PyTree, device=None) -> PyTree:
    """Leaves that :func:`load_raw` returned, in the structure of ``like``
    and placed as :func:`restore` (``device=None``) or
    :func:`restore_resharded` places them: a restore from arrays already
    read, without reading the file again."""
    return _place(like, leaves.__getitem__, leaves, device)
