"""Wrapper of the fused dequantize + weighted-accumulate kernel of the
QAFeL server buffer (CUDA C++ in ``csrc/buffer_aggregate.cu``).

Counterpart of ``repro/kernels/buffer_agg.py``. Algorithm 1 lines 11-12
dequantize the K buffered uploads and fold them into the model update;
the kernel does it in one pass, ``out = sum_k w_k * dequant(packed_k,
norms_k)``, reading the K code blocks once and writing the f32 result once
(w_k carries the 1/K mean and the 1/sqrt(1+tau_k) staleness weight).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.qsgd import (check_aligned, check_bits,
                                     check_tensor, on_card)
from repro_torch.kernels.ref import LANES

# launches since the last reset (``kernels.reset_launches``)
LAUNCHES = {"buffer_aggregate": 0}


def buffer_aggregate(packed_stack: torch.Tensor, norms: torch.Tensor,
                     weights: torch.Tensor, bits: int) -> torch.Tensor:
    """packed_stack uint8 (K, rows, 16*bits), norms f32 (K, rows), weights
    f32 (K,) -> f32 (rows, 128) == sum_k weights[k] * dequant(msg_k)."""
    check_bits(bits)
    k, rows = packed_stack.shape[0], packed_stack.shape[1]
    dev = packed_stack.device
    check_tensor("packed_stack", packed_stack, torch.uint8,
                 (None, None, LANES * bits // 8), dev)
    check_tensor("norms", norms, torch.float32, (k, rows), dev)
    check_tensor("weights", weights, torch.float32, (k,), dev)
    if k == 0:
        raise ValueError("buffer_aggregate needs at least one message")
    if not on_card(packed_stack):
        return _ref.buffer_aggregate(packed_stack, norms, weights, bits)
    check_aligned("packed_stack", packed_stack)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    if rows:
        fn = _build.entry("buffer_aggregate")
        _build.check("buffer_aggregate", fn(
            packed_stack.data_ptr(), norms.data_ptr(), weights.data_ptr(),
            out.data_ptr(), k, rows, bits,
            torch.cuda.current_stream(dev).cuda_stream))
        LAUNCHES["buffer_aggregate"] += 1
    return out
