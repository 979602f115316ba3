"""Server-side update buffer (the "Buff" in FedBuff/QAFeL, Algorithm 1).

Counterpart of ``repro/core/buffer.py``, packed mode. The K uploads of a
window are stored as they arrived on the wire — uint8 qsgd codes + bucket
norms, stacked at flush time — or, for identity uploads (f32 on the wire),
folded into one flat weighted sum. Uploads the server decoded on arrival
(a bit-width tier's, ``add_decoded_flat``) fold into a second flat sum.
``drain()`` hands the window's raw ingredients to the server flush, which
dequantizes inside its fused aggregate launch, and resets the buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.core.quantizers import Quantizer, TreeLayout


@dataclasses.dataclass
class FlushBatch:
    """The raw contents of one full window: the consumer computes exactly
    ``sum_k weights[k] * dequant(stack[k], norms[k]) + extra`` (``weights``
    and ``extra`` are already divided by the normalization denominator)."""

    n: int
    layout: TreeLayout
    bits: Optional[int] = None  # qsgd stack bit-width (None when no stack)
    stack: Any = None  # (K, rows, 16*bits) uint8 codes, or None
    norms: Any = None  # (K, rows) f32 bucket norms, or None
    weights: Any = None  # (K,) f32, normalized, or None
    extra: Any = None  # (n,) flat f32 pre-scaled identity sum, or None


def _f32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to f32, as a 0-dim tensor on ``like``'s device."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)


def _true_div(t: torch.Tensor, denom: float) -> torch.Tensor:
    """``t / denom`` as an IEEE f32 division on every device. (On the card
    torch multiplies by the reciprocal of a Python-number divisor, which
    rounds twice; a 0-dim tensor divisor on the same device divides.)"""
    return t / torch.full((), denom, dtype=t.dtype, device=t.device)


@dataclasses.dataclass
class UpdateBuffer:
    capacity: int  # K
    quantizer: Quantizer
    count: int = 0
    _packed: List[Any] = dataclasses.field(default_factory=list)
    _weights: List[float] = dataclasses.field(default_factory=list)
    _layout: Optional[TreeLayout] = None
    _bits: Optional[int] = None
    _n: Optional[int] = None
    _flat_acc: Any = None  # identity uploads: flat f32 weighted sum
    _acc: Any = None  # uploads decoded on arrival: flat f32 weighted sum
    _weightsum: float = 0.0
    flushes: int = 0

    def add_decoded_flat(self, flat: torch.Tensor, weight: float = 1.0, *,
                         layout: Optional[TreeLayout] = None) -> None:
        """Accumulate an already-decoded flat f32 delta, as
        ``weight * flat + acc`` (each product and sum rounded once)."""
        n = int(flat.numel())
        if self._layout is None:
            if layout is None:
                raise ValueError("add_decoded_flat into an empty buffer "
                                 "needs a layout")
            self._layout, self._n = layout, n
        elif layout is not None and layout != self._layout:
            raise ValueError("delta layout mismatch: all buffered uploads "
                             "must share the same tree structure")
        elif n != self._n:
            raise ValueError(f"flat delta size {n} != n={self._n}")
        term = flat * _f32_scalar(weight, flat)
        self._acc = term if self._acc is None else term + self._acc
        self._weightsum += float(weight)
        self.count += 1

    def add_encoded(self, enc: dict, weight: float = 1.0) -> None:
        """Store one packed upload; no dequantization. Validates everything
        before mutating, so a rejected message leaves the buffer as it was."""
        if enc.get("format") != "packed":
            raise ValueError("add_encoded expects a packed message")
        kind = enc["kind"]
        if kind != self.quantizer.spec.kind:
            raise ValueError(f"message kind {kind!r} does not match buffer "
                             f"quantizer {self.quantizer.spec.kind!r}")
        if self._layout is not None:
            if enc["layout"] != self._layout:
                raise ValueError("message layout mismatch: all buffered "
                                 "uploads must encode the same tree")
            if self._bits is not None and enc.get("bits") != self._bits:
                raise ValueError(f"message bits mismatch: {enc.get('bits')} "
                                 f"!= {self._bits}")
        if kind == "qsgd":
            from repro_torch.kernels import ops as kops
            if enc["norms"].shape[0] != kops.rows_for(enc["n"]):
                raise ValueError("corrupt qsgd message: norms/rows mismatch")
        if self._layout is None:
            self._layout, self._n = enc["layout"], enc["n"]
        if self._bits is None:
            self._bits = enc.get("bits")
        if kind == "qsgd":
            self._packed.append((enc["packed"], enc["norms"]))
        else:  # identity: f32 on the wire, folded into one weighted sum
            term = enc["payload"] * weight
            self._flat_acc = (term if self._flat_acc is None
                              else self._flat_acc + term)
        self._weightsum += float(weight)
        self._weights.append(float(weight))
        self.count += 1

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    @property
    def layout(self) -> Optional[TreeLayout]:
        """Layout of the current window (None when empty), so the server
        can validate before ``drain()`` resets the window."""
        return self._layout

    def _reset(self) -> None:
        self._packed, self._weights = [], []
        self._layout = self._bits = self._n = None
        self._flat_acc = self._acc = None
        self._weightsum = 0.0
        self.count = 0
        self.flushes += 1

    def drain(self) -> FlushBatch:
        """Hand the window's raw ingredients to the flush, and reset. The
        weights are divided by K (Algorithm 1 line 11, the reference's
        ``normalize="capacity"``) as ``f32(w) / f32(K)``; the identity sum
        is divided by K, and the decoded sum is scaled by ``fl32(1/K)``
        and added in front, ``scaled + extra``, as the reference does."""
        if not self.full:
            raise RuntimeError(f"flush before full: {self.count}/"
                               f"{self.capacity}")
        denom = float(self.capacity)
        stack = norms = weights = extra = None
        if self._packed:
            stack = torch.stack([p for p, _ in self._packed])
            norms = torch.stack([nm for _, nm in self._packed])
            w = (np.asarray(self._weights, np.float32)
                 / np.float32(denom)).astype(np.float32)
            weights = to_device(torch.from_numpy(w), stack.device)
        if self._flat_acc is not None:
            extra = _true_div(self._flat_acc, denom)
        if self._acc is not None:
            scaled = _f32_scalar(1.0 / denom, self._acc) * self._acc
            extra = scaled if extra is None else scaled + extra
        batch = FlushBatch(n=self._n, layout=self._layout, bits=self._bits,
                           stack=stack, norms=norms, weights=weights,
                           extra=extra)
        self._reset()
        return batch
