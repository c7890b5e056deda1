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

On a mesh (a tree holding a rank's shard, ``runtime.sharding.shard_model``,
and its optimizer pieces, ``shard_opt_state``) a checkpoint holds whole
leaves, as the reference's holds global arrays: the ranks gather each leaf
(``TrainLayout.whole_params`` / ``whole_moments``) and the mesh's first
rank writes it in the one-rank format; restore cuts each rank's pieces out
of the whole leaves by the same rules, so a checkpoint of any mesh restores
on any other, or on one rank.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as pytree
from ..models.model import DecoderLM
from ..optim.optimizers import OptState
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


def _parts(tree):
    """(key prefix, part) of a tree: the parts of a top-level tuple or list
    (not a named tuple), or the tree itself."""
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return [(f"[{i}]/", x) for i, x in enumerate(tree)]
    return [("", tree)]


def _mesh_shard(tree):
    """The rank's shard in ``tree`` when it holds one of a mesh of several
    ranks (its model and optimizer pieces then save and restore whole)."""
    for _, x in _parts(tree):
        if isinstance(x, DecoderLM) and x.shard is not None and x.shard.mesh.size > 1:
            return x
    return None


def _mesh_leaves(tree, model):
    """(key, whole leaf) of a mesh rank's tree in jax's flattening order,
    gathered one at a time (collectives: every rank walks every leaf): the
    shard's parameters and an ``OptState``'s moments made whole by its
    ``TrainLayout``, any other leaf as it is."""
    from ..runtime.sharding import train_layout

    layout = train_layout(model)
    for pre, x in _parts(tree):
        if x is model:
            for lf, whole in layout.whole_params(model):
                yield pre + lf.key, whole
        elif isinstance(x, OptState):
            yield pre + ".step", x.step.detach()
            for field in ("m", "v"):
                for lf, whole in layout.whole_moments(getattr(x, field)):
                    yield f"{pre}.{field}/{lf.key}", whole
        else:
            yield from ((pre + key, leaf) for key, leaf in pytree.flatten_with_path(_resolve(x)))


def _save_mesh(directory, step, tree, meta, model) -> str:
    """Every leaf gathered whole, one at a time; the mesh's first rank
    writes them (the one-rank format); the others wait for it."""
    writer = model.shard.mesh.rank == 0
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for i, (key, whole) in enumerate(_mesh_leaves(tree, model)):
        if writer:
            manifest["leaves"].append(_write_leaf(tmp, i, key, whole))
    if writer:
        _finish(tmp, final, manifest)
    dist.barrier()
    return final


def _write_leaf(tmp: str, i: int, key: str, leaf) -> dict:
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
    return {"key": key, "file": fn, "shape": list(arr.shape),
            "dtype": _dtype_name(leaf.dtype), "sha256": digest}


def _finish(tmp: str, final: str, manifest: dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_checkpoint(directory: str, step: int, tree, meta: dict | None = None) -> str:
    model = _mesh_shard(tree)
    if model is not None:
        return _save_mesh(directory, step, tree, meta, model)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for i, (key, leaf) in enumerate(pytree.flatten_with_path(_resolve(tree))):
        manifest["leaves"].append(_write_leaf(tmp, i, key, leaf))
    _finish(tmp, final, manifest)
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
    model = _mesh_shard(target_tree)
    if model is not None:
        _restore_mesh(path, by_key, target_tree, model, verify)
        return target_tree, manifest
    for key, leaf in pytree.flatten_with_path(_resolve(target_tree)):
        _restore_leaf(path, by_key, key, leaf, verify)
    return target_tree, manifest


def _read(path: str, by_key: dict, key: str, verify: bool) -> torch.Tensor:
    if key not in by_key:
        raise KeyError(f"checkpoint {path} has no leaf {key}")
    entry = by_key[key]
    return _read_leaf(os.path.join(path, entry["file"]), entry, verify)


@torch.no_grad()
def _restore_leaf(path: str, by_key: dict, key: str, leaf, verify: bool) -> None:
    """Leaf ``key`` of the checkpoint written into ``leaf`` (a tensor or a
    Stacked one) in place, its shape and dtype checked."""
    src = _read(path, by_key, key, verify)
    entry = by_key[key]
    if list(src.shape) != list(leaf.shape) or entry["dtype"] != _dtype_name(leaf.dtype):
        raise ValueError(f"{key}: checkpoint {entry['dtype']} {entry['shape']}, "
                         f"target {_dtype_name(leaf.dtype)} {list(leaf.shape)}")
    if isinstance(leaf, Stacked):
        for r, t in enumerate(leaf.layers):
            t.copy_(src[r])
    else:
        leaf.copy_(src)


def _restore_mesh(path, by_key, tree, model, verify) -> None:
    """A mesh rank's pieces cut out of the checkpoint's whole leaves by its
    ``TrainLayout``, one leaf at a time."""
    from ..runtime.sharding import train_layout

    layout = train_layout(model)
    for pre, x in _parts(tree):
        if x is model:
            layout.load_params(model, lambda lf: _read(path, by_key, pre + lf.key, verify))
        elif isinstance(x, OptState):
            _restore_leaf(path, by_key, pre + ".step", x.step, verify)
            for field in ("m", "v"):
                layout.load_moments(getattr(x, field), lambda lf: _read(
                    path, by_key, f"{pre}.{field}/{lf.key}", verify))
        else:
            for key, leaf in pytree.flatten_with_path(_resolve(x)):
                _restore_leaf(path, by_key, pre + key, leaf, verify)


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
