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
names a fully renamed directory. A tree is a dict, list, tuple or
NamedTuple nesting of leaves (``torch.Tensor``, numpy arrays and scalars);
dict keys flatten in sorted order, NamedTuple fields by name (JAX's
``GetAttrKey``: an ``OptState``'s ``step``, ``mu``, ``nu``), other
sequence items by index, joined by ``"/"``; ``None`` holds no leaf.
``.npz`` holds no bfloat16 or float8, so those leaves are stored as raw
bits beside their true dtype, and :func:`load_raw` and :func:`restore`
return them as torch tensors.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any
SEP = "/"

# dtypes numpy cannot hold, stored as unsigned raw bits of their width
_RAW_BITS = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
_SIGNED = {1: torch.int8, 2: torch.int16}


def _flatten_with_paths(tree: PyTree, prefix: tuple = ()
                        ) -> list[tuple[str, Any]]:
    if tree is None:
        return []
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
        out += _flatten_with_paths(sub, prefix + (k,))
    return out


def tree_keys(tree: PyTree) -> list[str]:
    """The flattened ``"/"``-joined leaf paths of ``tree`` — the key space
    a checkpoint of it stores under."""
    return [k for k, _ in _flatten_with_paths(tree)]


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


def load_raw(ckpt_dir: str, step: Optional[int] = None
             ) -> tuple[dict, dict]:
    """Load a checkpoint without a structure to load it into.

    Returns ``(leaves, manifest)``: ``leaves`` maps each flattened key path
    to its numpy array, or, for bfloat16 and float8 leaves, to a torch
    tensor of that dtype (restored from the stored bits).
    """
    path, manifest = _manifest_path(ckpt_dir, step)
    dtypes = {e["key"]: e["dtype"] for e in manifest["keys"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
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
    """Two-phase-commit save. Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": step, "keys": [], "extras": extras or {}}
    for key, leaf in _flatten_with_paths(tree):
        arr, true_dtype = _to_numpy(leaf)
        arrays[key] = arr
        manifest["keys"].append(
            {"key": key, "shape": list(arr.shape), "dtype": true_dtype})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic on one filesystem
    latest = os.path.join(ckpt_dir, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(name)
    os.replace(latest + ".tmp", latest)        # commit point
    return final


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


def _targets(like: PyTree, device) -> dict:
    """Each leaf key of ``like`` -> its target device: ``device`` is one
    device (or its name) for every leaf, or a tree of them shaped like
    ``like``."""
    if isinstance(device, (str, torch.device)):
        return {k: torch.device(device) for k in tree_keys(like)}
    by_key = dict(_flatten_with_paths(device))
    missing = [k for k in tree_keys(like) if k not in by_key]
    if missing:
        raise ValueError(f"no target device for leaves {missing[:5]}...")
    return {k: torch.device(by_key[k]) for k in tree_keys(like)}


def _place(like: PyTree, get, have, device=None) -> PyTree:
    """``like``'s structure with each leaf ``get(key)`` (an array in its
    true dtype). Without ``device`` a leaf whose ``like`` is a tensor comes
    back as a tensor on that tensor's device, any other as it was loaded;
    with ``device`` every leaf comes back as a tensor on its target. Raises
    ``KeyError`` if ``have`` lacks a leaf of ``like``."""
    missing = [k for k in tree_keys(like) if k not in have]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    if device is None:
        def load(key, leaf):
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(get(key)).to(leaf.device)
            return get(key)
    else:
        targets = _targets(like, device)

        def load(key, leaf):
            return torch.as_tensor(get(key)).to(targets[key])
    return _rebuild(like, load)


def _restore(ckpt_dir: str, like: PyTree, step: Optional[int], device
             ) -> tuple[PyTree, dict]:
    path, manifest = _manifest_path(ckpt_dir, step)
    dtypes = {e["key"]: e["dtype"] for e in manifest["keys"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = _place(like, lambda k: _true_dtype(data[k], dtypes.get(k)),
                      set(data.files), device)
    return tree, manifest["extras"]


def restore(ckpt_dir: str, like: PyTree, step: Optional[int] = None
            ) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like``; returns (tree, extras).

    Each leaf keeps the dtype it was saved with; a leaf whose ``like`` is a
    tensor comes back as a tensor on that tensor's device, any other as
    numpy (bf16 and float8 always as tensors). Raises ``KeyError`` if the
    checkpoint lacks a leaf of ``like``.
    """
    return _restore(ckpt_dir, like, step, None)


def restore_resharded(ckpt_dir: str, like: PyTree, device,
                      step: Optional[int] = None) -> tuple[PyTree, dict]:
    """Restore with each leaf placed on a target device: ``device`` is one
    ``torch.device`` (or its name) or a tree of them shaped like ``like``.

    The counterpart of the JAX package's ``restore_resharded``, which places
    each leaf with a target sharding on any mesh: on one card the target is
    a device, so a checkpoint that a CPU run wrote restores onto the card.
    Every leaf comes back as a tensor in the dtype it was saved with.
    """
    return _restore(ckpt_dir, like, step, device)


def from_raw(leaves: dict, like: PyTree, device=None) -> PyTree:
    """Leaves that :func:`load_raw` returned, in the structure of ``like``
    and placed as :func:`restore` (``device=None``) or
    :func:`restore_resharded` places them: a restore from arrays already
    read, without reading the file again."""
    return _place(like, leaves.__getitem__, leaves, device)
