"""Pytrees in the reference's layout over torch tensors.

Flattening follows ``jax.tree.flatten_with_path``: dict keys in sorted order,
tuples and lists in order, NamedTuple fields in order; anything else is a
leaf (a tensor, a :class:`Stacked`).  Key strings are
jax's (``['name']``, ``[i]``, ``.field``, joined by ``/``), so a checkpoint's
keys read the same in both packages.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Iterator

if TYPE_CHECKING:
    import torch


class Stacked:
    """One leaf of the reference's parameter pytree that the port keeps as
    per-layer tensors: pattern slot ``pi``'s R layers, the reference's
    ``[R, ...]`` array."""

    def __init__(self, layers: list[torch.Tensor]):
        self.layers = layers

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.layers), *self.layers[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0].dtype

    @property
    def device(self) -> torch.device:
        return self.layers[0].device


def leaf_layers(leaf) -> list[torch.Tensor]:
    """The per-layer tensors of a leaf (the leaf itself when it is not
    :class:`Stacked`)."""
    return leaf.layers if isinstance(leaf, Stacked) else [leaf]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, path: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    """(key string, leaf) pairs in jax's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_path(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from flatten_with_path(x, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map(fn: Callable, tree):   # noqa: A001 -- jax.tree.map's name
    """``tree`` with every leaf replaced by ``fn(leaf)``, called in the
    flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, x) for x in tree)
    return fn(tree)
