"""Parameters from the JAX package into the port.

The JAX package keeps parameters as nested dicts of arrays with HWIO conv
kernels; the port keeps the same leaf shapes (``models.cnn``), so the
conversion is a copy of every leaf onto the port's device. With it both
packages compute the same function from the same weights, which is what the
cross-package tests need. Only numpy arrays cross: the port never imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map


def params_from_jax(tree_of_numpy, device=None):
    """A nested dict of arrays (e.g. ``jax.tree.map(np.asarray, params)``)
    -> the same tree of f32 tensors on ``device`` (None: the CUDA device,
    as every entry point of the port). Feed the result to
    ``models.cnn.CNN`` for the ``nn.Module`` view."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev),
        tree_of_numpy)
