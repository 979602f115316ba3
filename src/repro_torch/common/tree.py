"""Nested-dict parameter trees in JAX's leaf order.

Counterpart of ``repro/common/tree.py``. Parameters, deltas and hidden
states are nested dicts of tensors, as in the reference. JAX flattens a
dict in sorted key order, so every flat vector of the port lists its leaves
that way (``conv0/b, conv0/gn_bias, conv0/gn_scale, conv0/w, ...,
head/b, head/w`` for the CNN); without it the two packages' flat vectors
could not be compared.

A ``treedef`` is a hashable nested tuple: a leaf is ``None``, a dict is
``(("key", sub), ...)`` in sorted key order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in JAX order and the tree's structure."""
    if isinstance(tree, dict):
        leaves: List[Any] = []
        spec = []
        for k in sorted(tree):
            sub_leaves, sub_def = tree_flatten(tree[k])
            leaves.extend(sub_leaves)
            spec.append((k, sub_def))
        return leaves, tuple(spec)
    return [tree], None


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves) -> Any:
    """Rebuild a tree of ``treedef``'s structure from leaves in JAX order."""
    it = iter(leaves)

    def build(spec):
        if spec is None:
            return next(it)
        return {k: build(sub) for k, sub in spec}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
