"""Wrapper of the silu kernel pair (``csrc/silu.cu``).

silu has no Pallas counterpart: the reference's is ``jax.nn.silu`` in its
jitted models, which XLA:CPU compiles to ``x * s``, ``s = 1 / (1 +
exp(-x))`` with its own ``exp`` and the flush of subnormals, and its vjp
to ``fma(g, s, (g * x) * (s * (1 - s)))``. ``silu_forward`` and
``silu_backward`` run that law on f32 tensors of any shape: a CPU tensor
through the plain version (``xla_math.silu_fwd`` / ``silu_bwd``), a CUDA
tensor as one launch of the kernel, adding one to
``LAUNCHES["silu_forward"]`` or ``LAUNCHES["silu_backward"]``; a failed
build or launch raises, and any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import xla_math
from repro_torch.kernels.qsgd import on_card

# launches since the last reset (``kernels.reset_launches``)
LAUNCHES = {"silu_forward": 0, "silu_backward": 0}


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"silu: {name} is {t.dtype}, expected float32")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"silu: {name} {tuple(t.shape)} on {t.device}, "
                         f"expected {tuple(like.shape)} on {like.device}")


def silu_forward(x: torch.Tensor) -> torch.Tensor:
    """silu of f32 ``x``."""
    _check("x", x, x)
    if not on_card(x):
        return xla_math.silu_fwd(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        _build.check("silu", _build.entry("silu")(
            x.data_ptr(), None, y.data_ptr(), x.numel(), 0,
            torch.cuda.current_stream(x.device).cuda_stream))
        LAUNCHES["silu_forward"] += 1
    return y


def silu_backward(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient of silu at ``x`` for cotangent ``g``, both f32 of one
    shape; the logistic is recomputed from ``x``."""
    _check("x", x, x)
    _check("g", g, x)
    if not on_card(x):
        return xla_math.silu_bwd(g, x)
    g, x = g.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _build.check("silu", _build.entry("silu")(
            g.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(), 1,
            torch.cuda.current_stream(x.device).cuda_stream))
        LAUNCHES["silu_backward"] += 1
    return out
