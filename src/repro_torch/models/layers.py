"""Primitive layers: norms, rotary embeddings, MLPs, initializers.

Counterpart of ``repro/models/layers.py``. Images are channel-last
(B, H, W, C) as in the reference. Math in f32, outputs cast back to the
activation dtype, as the reference does; a matrix product runs in its
operands' dtype (``torch.einsum``: f32 in, or bf16 in with f32
accumulation on the card).

On a mesh's "model" axis (``tp``, a ``launch.mesh.TensorParallel`` of
more than one rank) the products take this rank's shards by
``sharding.rules.param_pspecs`` (``column_parallel``, ``row_parallel``,
``gated_mlp``) and the loss's ``logsumexp`` runs over the vocabulary
shards (``sharded_logsumexp``); with one rank they are the meshless ops.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import logsumexp as _klse
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
                     folded: bool = True) -> torch.Tensor:
    """1 / theta^(2i / head_dim) for i < head_dim / 2, f32, by the jitted
    reference's law (``folded``): XLA rewrites the reference's ``1 / theta
    ** e`` (``e = 2i / head_dim``) as ``theta ** -e`` and folds it into a
    constant correctly rounded to f32 (taken here in float64 and rounded
    once). Read from XLA:CPU's optimised HLO: the jitted prefill step, the
    decode step and the round without remat hold that constant; the round
    with remat recomputes it in the backward as ``power(theta, -e)``,
    whose values on the published head dims are the same. ``folded=False``
    is the eager reference's ``1 / theta ** e`` in f32 ops (the bf16 op
    tests compare against it): the two differ in the last bit on up to a
    third of the frequencies, which moves a rotation angle by up to 0.03
    rad at position 524,287."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    if folded:
        return torch.pow(float(np.float32(theta)),
                         -exps.to(torch.float64)).to(torch.float32)
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, folded: bool = True) -> torch.Tensor:
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


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": silu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "relu": torch.relu}[name]


def tp_active(tp) -> bool:
    """Whether ``tp`` (a ``launch.mesh.TensorParallel`` or None) splits
    the model over more than one "model" rank."""
    return tp is not None and tp.size > 1


def column_parallel(x: torch.Tensor, w: torch.Tensor, n_out: int, tp,
                    xc: Optional[torch.Tensor] = None):
    """``x @ w`` for a column-parallel weight of global shape (d, n_out)
    and this rank's shard ``w`` of it, ``x`` (..., d) replicated over
    "model": ``(y, sharded)``. Sharded on its output dim (``w`` (d, n_out
    / m)), y is this rank's slice of the output (``sharded``), from
    ``xc``, ``x`` through ``launch.mesh.copy_to_model``; on its input dim
    (the rule's fallback, ``w`` (d / m, n_out)), the product of this
    rank's slice of x, summed over "model"; whole, the meshless product.
    Without ``tp`` the meshless product."""
    from repro_torch.launch import mesh as M

    if not tp_active(tp) or (w.shape[-1] == n_out
                          and w.shape[0] == x.shape[-1]):
        return torch.einsum("...d,de->...e", x, w), False
    if w.shape[-1] != n_out:
        xc = M.copy_to_model(x, tp) if xc is None else xc
        return torch.einsum("...d,de->...e", xc, w), True
    return M.reduce_from_model(torch.einsum(
        "...d,de->...e", M.split_to_model(x, -1, tp), w), tp), False


def row_parallel(h: torch.Tensor, w: torch.Tensor, sharded: bool,
                 tp) -> torch.Tensor:
    """``h @ w`` for a row-parallel weight and this rank's shard ``w``:
    ``h`` this rank's slice of the input (``sharded``, ``w`` its rows)
    or replicated; a product of row shards is summed over "model"."""
    from repro_torch.launch import mesh as M

    if not tp_active(tp) or (not sharded and w.shape[0] == h.shape[-1]):
        return torch.einsum("...f,fd->...d", h, w)
    if not sharded:
        h = M.split_to_model(h, -1, tp)
    return M.reduce_from_model(torch.einsum("...f,fd->...d", h, w), tp)


def gated_mlp(params, x: torch.Tensor, act: str = "silu", *, tp=None,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU-style gated MLP: down(act(gate(x)) * up(x)), the activation
    in f32. With ``tp`` (more than one "model" rank) the weights are this
    rank's shards of a ``d_ff``-wide MLP (``column_parallel``,
    ``row_parallel``)."""
    if not tp_active(tp):
        g = torch.einsum("...d,df->...f", x, params["w_gate"])
        u = torch.einsum("...d,df->...f", x, params["w_up"])
        h = _act(act)(g.to(torch.float32)).to(x.dtype) * u
        return torch.einsum("...f,fd->...d", h, params["w_down"])
    from repro_torch.launch import mesh as M

    xc = M.copy_to_model(x, tp)
    g, sharded = column_parallel(x, params["w_gate"], d_ff, tp, xc)
    u, _ = column_parallel(x, params["w_up"], d_ff, tp, xc)
    h = _act(act)(g.to(torch.float32)).to(x.dtype) * u
    return row_parallel(h, params["w_down"], sharded, tp)


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


class _LogSumExp(torch.autograd.Function):
    """``jax.nn.logsumexp`` over the last axis as XLA:CPU compiles it
    (``kernels.logsumexp``): ``log(sum(exp(a - m))) + m`` with ``m`` the
    maximum (0 where it is not finite), XLA's ``exp`` with its flush, the
    sum in law 7's order and XLA's ``log``, on the card two launches (the
    row max, then one pass); the gradient ``(g / sum) * exp(a - m)``, which is what
    jax's transpose gives, one launch (``_LogSumExpGrad``), its ``exp``
    recomputed from ``a`` (the same bits), so no logits-sized tensor is
    kept between the passes (the loss keeps ``a`` for its gather anyway).
    ``m`` and the sum ride out as outputs that carry no gradient (how a
    ``torch.func``-ready Function keeps an intermediate); the op is
    row-wise, so its vmap rule runs it on the batched tensor whole."""

    @staticmethod
    def forward(a):
        return _klse.forward(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, m, total = output
        ctx.mark_non_differentiable(m, total)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(inputs[0], m, total)

    @staticmethod
    def backward(ctx, g, _gm, _gt):
        a, m, total = ctx.saved_tensors
        return _LogSumExpGrad.apply(g, a, m, total)

    @staticmethod
    def vmap(info, in_dims, a):
        (a,) = _batch_first(info, in_dims, a)
        return _LogSumExp.apply(a), (0, 0, 0)


class _LogSumExpGrad(torch.autograd.Function):
    """``kernels.logsumexp.backward`` as an op with a vmap rule, so the
    backward of a vmapped ``torch.func.grad`` reaches the kernel too; it
    has no derivative of its own."""

    @staticmethod
    def forward(g, a, m, total):
        return _klse.backward(g, a, m, total)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _):
        raise NotImplementedError("logsumexp's second derivative is not "
                                  "ported")

    @staticmethod
    def vmap(info, in_dims, g, a, m, total):
        return _LogSumExpGrad.apply(
            *_batch_first(info, in_dims, g, a, m, total)), 0


def logsumexp(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.logsumexp`` of f32 ``a`` over ``dim`` by XLA:CPU's law
    (``_LogSumExp``), bit-equal to the jitted reference's with its vjp;
    ``torch.logsumexp`` takes torch's ``exp``, its own sum order and the
    backward ``g * exp(a - out)``, whose last bits the QAFeL rounds
    amplify (ROADMAP queue C)."""
    return _LogSumExp.apply(a.movedim(dim, -1))[0]


class _ShardedLogSumExp(torch.autograd.Function):
    """``_LogSumExp`` over the last axis split across a group (the
    vocabulary shards of "model"): the row maximum is the group's max, the
    ``exp`` sum each rank's law-7 sum of its shard (``kernels.logsumexp
    .sum_exp``) summed over the group, then the log (``log_plus``); the
    gradient ``(g / sum) * exp(a - m)`` of this rank's shard."""

    @staticmethod
    def forward(a, group):
        import torch.distributed as dist

        m = a.amax(dim=-1, keepdim=True).contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m, total = _klse.sum_exp(a, m)
        dist.all_reduce(total, group=group)
        return _klse.log_plus(total, m), m, total

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, m, total = output
        ctx.mark_non_differentiable(m, total)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(inputs[0], m, total)

    @staticmethod
    def backward(ctx, g, _gm, _gt):
        a, m, total = ctx.saved_tensors
        return _LogSumExpGrad.apply(g, a, m, total), None


def sharded_logsumexp(a: torch.Tensor, tp) -> torch.Tensor:
    """``logsumexp`` over the last axis of f32 ``a``, this rank's shard of
    the axis over "model" (``tp``; the meshless ``logsumexp`` with one
    rank)."""
    if not tp_active(tp):
        return logsumexp(a, -1)
    return _ShardedLogSumExp.apply(a, tp.group)[0]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(x / cap) in f32 (identity for None)."""
    if cap is None:
        return x
    xf = x.to(torch.float32)
    return (torch.tanh(xf / cap) * cap).to(x.dtype)
