"""Nested-dict parameter trees in JAX's leaf order.

Counterpart of ``repro/common/tree.py``. Parameters, deltas and hidden
states are nested dicts of tensors, as in the reference. JAX flattens a
dict in sorted key order, so every flat vector of the port lists its leaves
that way (``conv0/b, conv0/gn_bias, conv0/gn_scale, conv0/w, ...,
head/b, head/w`` for the CNN); without it the two packages' flat vectors
could not be compared.

A ``treedef`` is a hashable nested tuple: a leaf is ``None``, a dict is
``(("key", sub), ...)`` in sorted key order.

The reference's tree arithmetic follows (``tree_add`` ... ``split_key_tree``),
each rounding as the reference's does on XLA:CPU, except ``tree_dot`` and
``tree_norm``, which hold to a stated bound (``tree_dot``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


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


# ---------------------------------------------------------------------------
# Tree arithmetic (the reference's ``repro/common/tree.py``)
# ---------------------------------------------------------------------------


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def weak_scalar(value: float, t: torch.Tensor) -> float:
    """A Python float as jax's weakly typed scalar meets the tensor ``t``:
    rounded to ``t``'s dtype (through f32), returned as a float that the
    op then takes exactly."""
    v = torch.tensor(float(value), dtype=torch.float32)
    return float(v.to(t.dtype)) if t.is_floating_point() else float(v)


def tree_scale(a, s):
    """Each leaf times ``s`` in the leaf's dtype (``weak_scalar``)."""
    return tree_map(lambda x: (x * weak_scalar(s, x)).to(x.dtype), a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, cast back to y's dtype leaf-wise."""
    return tree_map(lambda xi, yi: (weak_scalar(alpha, xi) * xi + yi).to(
        yi.dtype), x, y)


_DOT_CHUNK = 1 << 24  # elements per float64 partial dot of a leaf


def _leaf_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``vdot(x, y)`` of one leaf pair as f32, on the leaves' device: the
    products (exact: two f32 significands fit in a double) and their sum
    in float64, ``_DOT_CHUNK`` elements at a time, rounded once to f32."""
    xs, ys = x.reshape(-1), y.reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, xs.numel(), _DOT_CHUNK):
        acc = acc + torch.dot(xs[i:i + _DOT_CHUNK].to(torch.float64),
                              ys[i:i + _DOT_CHUNK].to(torch.float64))
    return acc.to(torch.float32)


def tree_dot(a, b) -> torch.Tensor:
    """sum_leaves vdot(a_i, b_i) in f32, a 0-dim tensor on the leaves'
    device. Each leaf's dot is taken in float64 and rounded once
    (``_leaf_dot``); the leaves' dots are summed in XLA:CPU's order for
    ``jnp.sum`` of their stack (``ref.xla_sum``). The reference's own
    f32 dots round at every step, in an order XLA picks per leaf shape
    and per jit, so the two agree within the f32 summation bound
    ``(n + 2L + 2) * 2^-24 * sum|a_i b_i|`` (n the longest leaf, L the
    leaves; tests/test_torch_tree.py), not bit for bit."""
    from repro_torch.kernels.ref import xla_sum

    return xla_sum(torch.stack([_leaf_dot(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b))]))


def tree_norm(a) -> torch.Tensor:
    """sqrt(tree_dot(a, a)), correctly rounded (``ref.sqrt_f32``)."""
    from repro_torch.kernels.ref import sqrt_f32

    return sqrt_f32(tree_dot(a, a))


def tree_size(tree) -> int:
    """Total number of scalar elements in the tree (a host int)."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the tree at its stored dtypes (a host int)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def split_key_tree(key, tree):
    """One independent key per leaf of ``tree`` (``prng.split(key, n)``,
    in leaf order), as a tree of keys."""
    from repro_torch.common import prng

    leaves, treedef = tree_flatten(tree)
    keys = prng.split(key, len(leaves))
    return tree_unflatten(treedef, [keys[i] for i in range(len(leaves))])
