"""Shared helpers: jax-compatible PRNG, parameter trees, device choice."""
from repro_torch.common.tree import (split_key_tree, tree_add, tree_axpy,
                                     tree_bytes, tree_dot, tree_norm,
                                     tree_scale, tree_size, tree_sub,
                                     tree_zeros_like)

__all__ = ["split_key_tree", "tree_add", "tree_axpy", "tree_bytes",
           "tree_dot", "tree_norm", "tree_scale", "tree_size", "tree_sub",
           "tree_zeros_like"]
