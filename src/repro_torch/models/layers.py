"""Primitive layers: norms, rotary embeddings, MLPs, initializers.

Counterpart of ``repro/models/layers.py``. Images are channel-last
(B, H, W, C) as in the reference. Math in f32, outputs cast back to the
activation dtype, as the reference does; a matrix product runs in its
operands' dtype (``torch.einsum``: f32 in, or bf16 in with f32
accumulation on the card).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import silu as _ksilu


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, fan_in: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (cut at +-2 std), like the reference's;
    the draws come from ``gen`` (on its device) and are not the
    reference's numbers; on the ``meta`` device nothing is drawn. The
    scaling is in place, so a leaf costs one f32 draw beside its result
    (a 40-layer granite-34b's stacked MLP matrices: 24 GB each in f32)."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not w.is_meta:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.div_(math.sqrt(max(fan_in, 1))).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) embeddings, drawn from ``gen`` on its device
    (nothing drawn on ``meta``)."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not w.is_meta:
        w.normal_(0.0, 1.0, generator=gen)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             scale_plus_one: bool = False) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale over the last axis, in f32;
    gemma's convention multiplies by (1 + scale)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    if scale_plus_one:
        s = 1.0 + s
    return (y * s).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None,
                     folded: bool = False) -> torch.Tensor:
    """1 / theta^(2i / head_dim) for i < head_dim / 2, f32: ``1 / theta **
    e`` in f32 ops (``e = 2i / head_dim``), or with ``folded`` as the
    jitted reference's decode step has it, where XLA rewrites that as
    ``theta ** -e`` and folds it into a constant correctly rounded to f32
    (taken here in float64 and rounded once). The two differ in the last
    bit on up to a tenth of the frequencies, which moves a rotation angle
    by up to 0.025 rad at position 524,287; decode at such positions takes
    the folded law (``attention.attention_decode``, ``mla.mla_decode``),
    and the full-sequence paths keep the first (ROADMAP queue C)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    if folded:
        return torch.pow(float(np.float32(theta)),
                         -exps.to(torch.float64)).to(torch.float32)
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, folded: bool = False) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions broadcastable to (..., S).
    Rotates the two halves of the head dim (the reference's layout);
    ``folded`` as in ``rope_frequencies``."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device, folded)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _batch_first(info, in_dims, *tensors):
    """``tensors`` with their vmap batch dimension first, an unbatched one
    expanded to the batch (an elementwise op's vmap rule)."""
    return tuple(t.movedim(d, 0) if d is not None
                 else t.expand(info.batch_size, *t.shape)
                 for t, d in zip(tensors, in_dims))


class _SiLU(torch.autograd.Function):
    """silu by the reference's law on f32 (``kernels.silu``): ``x * s``
    with ``s = 1 / (1 + exp(-x))`` by XLA:CPU's ``exp`` and its flush of
    subnormals, and as gradient ``fma(g, s, (g * x) * (s * (1 - s)))``,
    the transpose jax takes of ``x * logistic(x)`` with XLA's fused add
    (``_SiLUGrad``, ``s`` recomputed from ``x``, the only tensor saved);
    bit-equal to the jitted ``jax.nn.silu`` and its vjp. A CUDA tensor
    runs the kernel (one launch each way), a CPU tensor its plain
    version. One backward for ``torch.autograd.grad`` and the
    ``torch.func`` transforms, so the round's gradient paths with and
    without remat agree bit for bit (``F.silu``'s two backward formulas do
    not); the op is elementwise, so its vmap rule runs it on the batched
    tensor whole."""

    @staticmethod
    def forward(x):
        return _ksilu.silu_forward(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _SiLUGrad.apply(g, x)

    @staticmethod
    def vmap(info, in_dims, x):
        (x,) = _batch_first(info, in_dims, x)
        return _SiLU.apply(x), 0


class _SiLUGrad(torch.autograd.Function):
    """silu's gradient (``kernels.silu.silu_backward``) as an op with a
    vmap rule, so a vmapped ``torch.func.grad`` reaches the kernel too;
    it has no derivative of its own."""

    @staticmethod
    def forward(g, x):
        return _ksilu.silu_backward(g, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _):
        raise NotImplementedError("silu's second derivative is not ported")

    @staticmethod
    def vmap(info, in_dims, g, x):
        return _SiLUGrad.apply(*_batch_first(info, in_dims, g, x)), 0


def silu(x: torch.Tensor) -> torch.Tensor:
    """silu of an f32 tensor by the reference's law (``_SiLU``)."""
    return _SiLU.apply(x)


class _SiLUAten(torch.autograd.Function):
    """silu by torch's own law: ``F.silu`` forward and ATen's fused
    ``silu_backward`` (``g * s * (1 + x * (1 - s))``), which is what
    ``torch.autograd.grad`` of ``F.silu`` runs; ``torch.func.grad`` of
    ``F.silu`` composes that formula op by op instead, so here too one
    backward serves both gradient paths."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.nn.functional.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.silu_backward(g, x)


def silu_aten(x: torch.Tensor) -> torch.Tensor:
    """silu by torch's law (``_SiLUAten``), one backward for both gradient
    paths: the MoE experts' activation (``moe._expert_ffn``)."""
    return _SiLUAten.apply(x)


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": silu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "relu": torch.relu}[name]


def gated_mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU-style gated MLP: down(act(gate(x)) * up(x)), the activation
    in f32."""
    g = torch.einsum("...d,df->...f", x, params["w_gate"])
    u = torch.einsum("...d,df->...f", x, params["w_up"])
    h = _act(act)(g.to(torch.float32)).to(x.dtype) * u
    return torch.einsum("...f,fd->...d", h, params["w_down"])


def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype: torch.dtype = torch.float32, lead=()) -> dict:
    """The MLP's three matrices; ``lead`` prepends stacked dims (one set
    per super-block), each slice drawn at the single layer's fan-in."""
    lead = tuple(lead)
    return {
        "w_gate": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w_up": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w_down": dense_init(gen, lead + (d_ff, d_model), d_ff, dtype),
    }


def logsumexp(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.logsumexp`` of ``a`` over ``dim``, by its law: ``log(sum(
    exp(a - m))) + m`` with ``m`` the detached maximum (0 where it is not
    finite), so its gradient is ``(g / sum) * exp(a - m)``, the exp
    saved from the forward. ``torch.logsumexp``'s backward takes ``g *
    exp(a - out)`` instead, whose last bits the chained QAFeL rounds
    amplify (ROADMAP queue C)."""
    m = a.detach().amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    total = torch.exp(a - m).sum(dim=dim, keepdim=True)
    return (torch.log(total) + m).squeeze(dim)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(x / cap) in f32 (identity for None)."""
    if cap is None:
        return x
    xf = x.to(torch.float32)
    return (torch.tanh(xf / cap) * cap).to(x.dtype)
