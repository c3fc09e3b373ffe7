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
names a fully renamed directory. A tree is a dict, list or tuple nesting of
leaves (``torch.Tensor``, numpy arrays and scalars); dict keys flatten in
sorted order, sequence items by index, joined by ``"/"``. ``.npz`` holds no
bfloat16 or float8, so those leaves are stored as raw bits beside their
true dtype, and :func:`load_raw` returns them as torch tensors.
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
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {e["key"]: e["dtype"] for e in manifest["keys"]}
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in data.files:
            arr = data[k]
            want = dtypes.get(k, str(arr.dtype))
            if want in _RAW_BITS:
                bits = arr.view(f"int{8 * arr.itemsize}")
                leaves[k] = torch.from_numpy(bits).view(_RAW_BITS[want])
            elif want != str(arr.dtype):
                leaves[k] = arr.view(np.dtype(want))
            else:
                leaves[k] = arr
    return leaves, manifest


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
