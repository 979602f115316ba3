"""Primitive layers of the paper's CNN.

Counterpart of the parts of ``repro/models/layers.py`` the CNN uses. Images
are channel-last (B, H, W, C) as in the reference.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """Truncated-normal fan-in init (cut at +-2 std), like the reference's;
    the draws come from ``gen`` and are not the reference's numbers."""
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w / math.sqrt(fan_in)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-last images (B, H, W, C): population variance
    per (image, group) and ``rsqrt``, as the reference computes it."""
    b, h, w, c = x.shape
    xf = x.to(torch.float32).reshape(b, h, w, groups, c // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)
