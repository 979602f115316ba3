"""Wrapper of the loss's logsumexp kernel (``csrc/logsumexp.cu``).

The reference's cross-entropy takes ``jax.nn.logsumexp`` over the
vocabulary in its jitted model, which XLA:CPU compiles as ``lse =
log(sum(exp(a - m))) + m``: ``m`` the row maximum (0 where it is not
finite), XLA's ``exp`` with its flush (``xla_math.exp``), the sum in law
7's order (``ref.xla_sum``: windows of 32, recursively) and XLA's ``log``
(``xla_math.log``; torch's at 0, the infinities and nan); its vjp is ``(g /
sum) * exp(a - m)``, each operation flushing a subnormal operand and
result as XLA:CPU's does. No Pallas kernel computes it.

``forward`` is two launches: the row maxima (``LAUNCHES["logsumexp_max"]``),
then the exps, the law's sum, the log and ``+ m`` in one pass over ``a``
(``["logsumexp_forward"]``), no ``a - m`` or ``exp`` tensor written.
``backward`` is one launch (``["logsumexp_backward"]``). For logits split over a group's vocabulary
shards, ``sum_exp`` gives this rank's sum (``["logsumexp_sum"]``) and
``log_plus`` the log of the group's (``["logsumexp_log"]``). A CPU tensor
runs the plain version (``plain_*``: the law in elementwise torch ops), a
CUDA tensor the kernel; a failed build or launch raises, and any other
device raises.

Launches that share the per-row completion counters (``taps.row_counters``)
run on one stream.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import xla_math
from repro_torch.kernels.qsgd import on_card
from repro_torch.kernels.ref import xla_sum
from repro_torch.kernels.taps import row_counters, scratch_slots

# launches since the last reset (``kernels.reset_launches``)
LAUNCHES = {"logsumexp_max": 0, "logsumexp_forward": 0, "logsumexp_sum": 0,
            "logsumexp_log": 0, "logsumexp_backward": 0}

_FORWARD, _SUM, _LOG, _BACKWARD, _MAX = 0, 1, 2, 3, 4  # csrc's modes
MAX_PARTS = 64  # partial maxima a row (``kMaxParts``)
_TINY = float(np.finfo(np.float32).tiny)


def plain_log(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` of positive normal values (``xla_math.log``),
    torch's at 0, infinities and nan (-inf, inf, nan as XLA gives them)."""
    normal = torch.isfinite(v) & (v >= _TINY)
    safe = torch.where(normal, v, torch.ones_like(v))
    return torch.where(normal, xla_math.log(safe), torch.log(v))


def plain_sum(a: torch.Tensor, m: torch.Tensor):
    """``(m, total)``: ``m`` (..., 1) set to 0 where not finite, and the
    law-7 sum of ``exp(a - m)`` over the last axis, (..., 1)."""
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m, xla_sum(xla_math.exp(a - m), -1)[..., None]


def plain_forward(a: torch.Tensor):
    """``(lse, m, total)`` of f32 ``a`` over its last axis by the law."""
    m, total = plain_sum(a, a.amax(dim=-1, keepdim=True))
    return plain_log_plus(total, m), m, total


def plain_log_plus(total: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``log(total) + m`` of (..., 1) tensors, (...,), flushed."""
    return xla_math.ftz(plain_log(total) + m)[..., 0]


def plain_backward(g, a, m, total) -> torch.Tensor:
    """``(g / total) * exp(a - m)``: two roundings, no FMA, each flushed
    as XLA:CPU flushes a subnormal operand and result."""
    q = xla_math.ftz(xla_math.ftz(g)[..., None] / total)
    return xla_math.ftz(q * xla_math.exp(a - m))


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"logsumexp: {name} is {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"logsumexp: {name} {tuple(t.shape)} on {t.device},"
                         f" expected {tuple(shape)} on {device}")


def _rows(a: torch.Tensor) -> int:
    """Rows of f32 logits ``a`` (..., n), n >= 1."""
    _check("a", a, a.shape, a.device)
    if a.dim() == 0 or a.shape[-1] < 1:
        raise ValueError(f"logsumexp: a {tuple(a.shape)} needs a last axis "
                         "of at least one value")
    return a.numel() // a.shape[-1]


def _scratch(a: torch.Tensor, rows: int) -> torch.Tensor:
    """The forward's scratch: ``MAX_PARTS`` partial maxima a row, then the
    law's sums of a row (``taps.scratch_slots``)."""
    return torch.empty(rows * (MAX_PARTS + scratch_slots(a.shape[-1])),
                       dtype=torch.float32, device=a.device)


def _launch(mode: int, *, a=None, g=None, g_stride=0, m=None, total=None,
            lse=None, out=None, scratch=None, rows: int, n: int = 0) -> None:
    dev = next(t for t in (a, m, total) if t is not None).device
    counters = None
    if mode in (_FORWARD, _SUM):
        counters = row_counters(dev, rows)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check("logsumexp", _build.entry("logsumexp")(
        mode, ptr(a), ptr(g), g_stride, ptr(m), ptr(total), ptr(lse),
        ptr(out), rows, n, ptr(scratch), ptr(counters),
        torch.cuda.current_stream(dev).cuda_stream))


def forward(a: torch.Tensor):
    """``(lse, m, total)`` of f32 ``a`` (..., n) over its last axis: lse
    (...,), ``m`` and ``total`` (..., 1). On the card two launches."""
    rows = _rows(a)
    if not on_card(a):
        return plain_forward(a)
    a = a.contiguous()
    m = torch.empty(a.shape[:-1] + (1,), dtype=torch.float32,
                    device=a.device)
    total = torch.empty_like(m)
    lse = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    if rows:
        scratch = _scratch(a, rows)
        _launch(_MAX, a=a, scratch=scratch, rows=rows, n=a.shape[-1])
        LAUNCHES["logsumexp_max"] += 1
        _launch(_FORWARD, a=a, m=m, total=total, lse=lse, scratch=scratch,
                rows=rows, n=a.shape[-1])
        LAUNCHES["logsumexp_forward"] += 1
    return lse, m, total


def sum_exp(a: torch.Tensor, m: torch.Tensor):
    """``(m, total)`` for this rank's shard ``a`` (..., n) of logits split
    over a group, ``m`` (..., 1) the group's row maxima: ``m`` set to 0
    where it is not finite (in place on the card) and this shard's law-7
    sum of ``exp(a - m)``, (..., 1). One launch on the card."""
    rows = _rows(a)
    _check("m", m, a.shape[:-1] + (1,), a.device)
    if not on_card(a):
        return plain_sum(a, m)
    a, m = a.contiguous(), m.contiguous()
    total = torch.empty_like(m)
    if rows:
        _launch(_SUM, a=a, m=m, total=total, scratch=_scratch(a, rows),
                rows=rows, n=a.shape[-1])
        LAUNCHES["logsumexp_sum"] += 1
    return m, total


def log_plus(total: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``log(total) + m`` with XLA's ``log``, (..., 1) -> (...,); one
    launch on the card."""
    _check("total", total, total.shape, total.device)
    _check("m", m, total.shape, total.device)
    if total.dim() == 0 or total.shape[-1] != 1:
        raise ValueError(f"logsumexp: total {tuple(total.shape)} needs a "
                         "last axis of 1")
    if not on_card(total):
        return plain_log_plus(total, m)
    total, m = total.contiguous(), m.contiguous()
    lse = torch.empty(total.shape[:-1], dtype=torch.float32,
                      device=total.device)
    if total.numel():
        _launch(_LOG, m=m, total=total, lse=lse, rows=total.numel())
        LAUNCHES["logsumexp_log"] += 1
    return lse


def backward(g: torch.Tensor, a: torch.Tensor, m: torch.Tensor,
             total: torch.Tensor) -> torch.Tensor:
    """The gradient ``(g / total) * exp(a - m)`` of ``a`` (..., n) for the
    cotangent ``g`` (...,) of lse, ``m`` and ``total`` (..., 1) as
    ``forward`` gives them; one launch on the card, ``exp`` recomputed
    from ``a``."""
    rows = _rows(a)
    for name, t in (("m", m), ("total", total)):
        _check(name, t, a.shape[:-1] + (1,), a.device)
    _check("g", g, a.shape[:-1], a.device)
    if not on_card(a):
        return plain_backward(g, a, m, total)
    a, m, total = a.contiguous(), m.contiguous(), total.contiguous()
    gf = g.reshape(-1)  # a view where one stride reaches every row
    out = torch.empty_like(a)
    if rows:
        _launch(_BACKWARD, a=a, g=gf, g_stride=gf.stride(0), m=m,
                total=total, out=out, rows=rows, n=a.shape[-1])
        LAUNCHES["logsumexp_backward"] += 1
    return out
