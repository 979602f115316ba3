"""Parameters and round state from the JAX package into the port.

The JAX package keeps parameters as nested dicts of arrays (HWIO conv
kernels for the CNN, ``(in, out)`` matrices stacked over super-blocks for
the decoders, ``(E, in, out)`` expert banks, MLA's latent projections,
deepseek's ``prefix_layers``, ``mtp_block`` and ``mtp_norm``); the port
keeps the same leaves, so the conversion is a copy
of every leaf onto the port's device in its own dtype. With it both
packages compute the same function from the same weights, which is what
the cross-package tests need. Only numpy arrays cross: the port imports
neither JAX nor ``ml_dtypes``; a bf16 array (ml_dtypes' ``bfloat16``)
crosses as its ``uint16`` bits reinterpreted as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map


def _tensor(a, device=None) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a tensor of
    the same dtype on ``device`` (None: the card); float64 (a Python
    list, say) becomes float32, the dtype JAX holds it in."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(
            a, dtype=np.float32 if a.dtype == np.float64 else a.dtype))
    return t.to(dev)


def params_from_jax(tree_of_numpy, device=None):
    """A nested dict of arrays (e.g. ``jax.tree.map(np.asarray, params)``)
    -> the same tree of tensors, each leaf in its own dtype (f32 stays
    f32, bf16 stays bf16), on ``device`` (None: the CUDA device, as every
    entry point of the port). Feed the CNN's to ``models.cnn.CNN`` for the
    ``nn.Module`` view."""
    return tree_map(lambda a: _tensor(a, device), tree_of_numpy)


def round_state_from_jax(state, device=None):
    """The reference's ``distributed.steps.RoundState`` (its trees as
    numpy, e.g. ``jax.device_get(state)``) -> the port's
    ``distributed.steps.RoundState`` on ``device``, each leaf in its own
    dtype: x, x-hat and m in one flat buffer each in the tree's main
    dtype with the trees as views, the leaves of another dtype (mamba2's
    f32 ``A_log``, ``D``, ``dt_bias``) beside them
    (``RoundState.from_trees``)."""
    from repro_torch.distributed.steps import RoundState

    return RoundState.from_trees(params_from_jax(state.x, device),
                                 params_from_jax(state.hidden, device),
                                 params_from_jax(state.momentum, device),
                                 t=int(np.asarray(state.t)))


def cache_from_jax(cache, device=None):
    """The reference's serving cache (``transformer.prefill`` /
    ``init_cache``: ``{"layers": {pos: {"k", "v", "slot_pos"}}}``, k and v
    in the activation dtype, ``slot_pos`` int32; an MLA position's
    ``{"ckv", "k_rope", "slot_pos"}``, the latents in the activation
    dtype; a mamba position's ``{"ssm", "conv"}``, ``ssm`` f32 (B, H, P,
    N) and ``conv`` (B, W - 1, C) in the activation dtype; each leaf
    stacked over the super-blocks; deepseek's ``"prefix"`` entry the same,
    stacked over its dense prefix layers;
    as numpy, e.g. ``jax.device_get(cache)``) -> the port's, each leaf in
    its own dtype on ``device`` (None: the card), so the port's
    ``decode_step`` continues from the reference's own prefill."""
    return params_from_jax(cache, device)
