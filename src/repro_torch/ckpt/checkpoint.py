"""Checkpointing: atomic, content-verified, in the reference's layout.

Port of ``repro/ckpt/checkpoint.py``, with the same files, so a checkpoint
written by either package restores in the other:

    <dir>/step_<N>/
        manifest.json      {step, leaves: [{key, file, shape, dtype, sha256}], meta}
        leaf_<i>.npy       one file per pytree leaf, in jax's flattening order

* keys are ``jax.tree.flatten_with_path``'s strings for the same pytree, e.g.
  ``[0]/['blocks']/[0]/['attn']/['wq']`` and ``[1]/.m/['embed']`` for
  ``(params, OptState)``; a :class:`~repro_torch.models.DecoderLM` in the tree
  stands for its :meth:`~repro_torch.models.DecoderLM.param_tree`, whose
  block leaves are written stacked ``[R, ...]`` as the reference stores them;
* bfloat16 leaves are stored as raw ``uint8`` bytes (read back through
  ``uint16``, without ``ml_dtypes``), every other dtype as itself;
* leaves are written one at a time (the host holds one leaf, never two
  copies of the model), into ``step_N.tmp``, then ``os.replace``;
* restore checks each leaf's sha256, shape and dtype and writes it into the
  target's tensors in place, on their device.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil

import numpy as np
import torch

from .. import tree as pytree
from ..models.model import DecoderLM
from ..tree import Stacked


def _resolve(tree):
    """``tree`` with every DecoderLM replaced by its parameter pytree."""
    if isinstance(tree, DecoderLM):
        return tree.param_tree()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_resolve(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_resolve(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _resolve(v) for k, v in tree.items()}
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _leaf_array(leaf) -> np.ndarray:
    """The leaf on the host (bfloat16 as its uint16 bits); a Stacked leaf is
    filled layer by layer into one array."""
    if not isinstance(leaf, Stacked):
        return _host(leaf)
    first = _host(leaf.layers[0])
    out = np.empty((len(leaf.layers), *first.shape), first.dtype)
    out[0] = first
    for r, t in enumerate(leaf.layers[1:], 1):
        out[r] = _host(t)
    return out


def save_checkpoint(directory: str, step: int, tree, meta: dict | None = None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for i, (key, leaf) in enumerate(pytree.flatten_with_path(_resolve(tree))):
        arr = _leaf_array(leaf)
        fn = f"leaf_{i:05d}.npy"
        if leaf.dtype == torch.bfloat16:
            # as the reference stores exotic dtypes: raw bytes; the manifest's
            # dtype and shape rebuild them on load
            np.save(os.path.join(tmp, fn), np.frombuffer(arr.tobytes(), dtype=np.uint8))
        else:
            np.save(os.path.join(tmp, fn), arr)
        with open(os.path.join(tmp, fn), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"].append(
            {"key": key, "file": fn, "shape": list(arr.shape),
             "dtype": _dtype_name(leaf.dtype), "sha256": digest}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _read_leaf(path: str, entry: dict, verify: bool) -> torch.Tensor:
    with open(path, "rb") as f:
        data = f.read()
    if verify and hashlib.sha256(data).hexdigest() != entry["sha256"]:
        raise IOError(f"checkpoint corruption at {entry['key']}")
    arr = np.load(io.BytesIO(data))
    shape, dtype = entry["shape"], entry["dtype"]
    if dtype == "bfloat16":
        bits = np.frombuffer(arr.tobytes(), dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype == np.uint8 and dtype != "uint8":
        arr = np.frombuffer(arr.tobytes(), dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(directory: str, step: int, target_tree, verify: bool = True):
    """Write step ``step`` into ``target_tree``'s tensors in place; returns
    ``(target_tree, manifest)``.  Raises on a missing key, a digest, shape
    or dtype mismatch."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    with torch.no_grad():
        for key, leaf in pytree.flatten_with_path(_resolve(target_tree)):
            if key not in by_key:
                raise KeyError(f"checkpoint {path} has no leaf {key}")
            entry = by_key[key]
            src = _read_leaf(os.path.join(path, entry["file"]), entry, verify)
            if list(src.shape) != list(leaf.shape) or entry["dtype"] != _dtype_name(leaf.dtype):
                raise ValueError(f"{key}: checkpoint {entry['dtype']} {entry['shape']}, "
                                 f"target {_dtype_name(leaf.dtype)} {list(leaf.shape)}")
            if isinstance(leaf, Stacked):
                for r, t in enumerate(leaf.layers):
                    t.copy_(src[r])
            else:
                leaf.copy_(src)
    return target_tree, manifest


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
