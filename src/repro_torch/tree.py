"""Trees of tensors: nested dicts, tuples and lists with tensor leaves (a
model's params and gradients, an optimizer's moments), walked in
``jax.tree_util``'s leaf order (dict keys sorted)."""
from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, tuples and lists (None
    passes through), with ``rest`` of the same structure; dicts keep
    ``tree``'s key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Tensor leaves in ``jax.tree_util`` order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [l for v in tree for l in tree_leaves(v)]


def tree_flatten(tree) -> dict:
    """A nested tree as the flat ``{name: leaf}`` dict that ``ota_psum``
    and the schemes take, its names ``"00000"``, ``"00001"``, ... in leaf
    order, so the flat dict's sorted order is the reference's leaf order."""
    return {f"{i:05d}": l for i, l in enumerate(tree_leaves(tree))}


def tree_unflatten(like, flat: dict):
    """The inverse of ``tree_flatten``: ``flat``'s leaves in the structure
    of ``like``."""
    it = iter(flat[k] for k in sorted(flat))

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return type(t)(build(v) for v in t)
    return build(like)
