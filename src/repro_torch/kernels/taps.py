"""Wrappers of the metric-tap kernels (CUDA C++ in ``csrc/flush_taps.cu``,
``csrc/upload_taps.cu`` and ``csrc/round_taps.cu``, on
``csrc/tap_reduce.cuh``).

Counterpart of the tap math of ``repro/obs/taps.py`` (``flush_tap_vector``,
``cohort_tap_rows``, ``decode_qsgd_stack``), which the reference computes in
XLA inside its fused dispatches. No Pallas kernel computes it; the port
takes it in two kernels of its own whose sums of squares run in XLA:CPU's
order for ``jnp.sum`` (``ref.tap_sum``, which depends on the vector's
length alone): the card equals the CPU and the reference bit for bit, and
a member's upload tap does not depend on the cohort it was batched with. Taps on cost one launch per
flush (``flush_taps``) and one per client-step encode (``upload_taps``).
The QAFeL round's taps (``round_taps``) are the flush's seven, finished in
one launch from the level-1 window sums that the server-update kernel and
K3's x-hat apply write as they go (the round updates its state in place,
so no pass over the materialized vectors is possible).

As the other wrappers: a CPU tensor runs the plain version
(``ref.flush_taps``, ``ref.upload_taps``), a CUDA tensor launches the
kernel and adds one to ``LAUNCHES[name]``; there is no fallback.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.qsgd import check_bits, check_tensor, on_card
from repro_torch.kernels.ref import LANES

# launches per kernel since the last reset (``kernels.reset_launches``)
LAUNCHES = {"flush_taps": 0, "upload_taps": 0, "round_taps": 0}

FLUSH_SUMS, UPLOAD_SUMS = 5, 2  # partial sums a block writes
_counters: Dict[torch.device, torch.Tensor] = {}

THREADS = 128  # a block (``tap_reduce.cuh`` kThreads: 4 warps)


def _smem_bytes(vectors: int, sums: int, bits: int = 0) -> int:
    """Dynamic shared bytes of a tap kernel's block (``tap_reduce.cuh``
    ``smem_bytes``): two stages a warp of ``vectors`` staged spans (32
    rows of 36 floats) and, for codes of ``bits``, the span's code words
    (32 * bits + 1, one pad a 32) and 9 norms, to 16 bytes; each warp's
    window sums; two units' level-1 sums."""
    words = 32 * bits + 1 if bits else 0
    extra = words + words // 32 + 1 + 9 if bits else 0
    stage = -(-(vectors * 32 * 36 + extra) // 4) * 4
    return 4 * (4 * 2 * stage + 4 * sums * 36 + 2 * 32 * sums)


# dynamic shared bytes of each kernel's block (the upload's at qsgd4)
SMEM_BYTES = {"flush_taps": _smem_bytes(5, FLUSH_SUMS),
              "upload_taps": _smem_bytes(1, UPLOAD_SUMS, 4),
              "round_taps": _smem_bytes(5, _ref.ROUND_TAP_SUMS)}


def row_counters(device: torch.device, rows: int) -> torch.Tensor:
    """At least ``rows`` per-row completion counters on ``device``: int32
    zeros, made at first use (one fill launch) and grown by doubling. Each
    launch's last blocks set them back to 0, so launches on one stream
    share them."""
    c = _counters.get(device)
    if c is None or c.numel() < rows:
        size = max(rows, 1024 if c is None else 2 * c.numel())
        c = torch.zeros(size, dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def scratch_slots(n: int) -> int:
    """Scratch floats per sum of a row of n values (``tap_reduce.cuh``'s
    ``scratch_slots``): its level-1 sums of 1,024 values and the levels
    above them."""
    return 2 * -(-n // 1024) + 32


def flush_taps(x_old: torch.Tensor, x_new: torch.Tensor, delta: torch.Tensor,
               diff: torch.Tensor, q: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The flush tap vector, f32 (7,) in ``obs.taps.FLUSH_TAP_NAMES``
    order, from the flush's true-n f32 vectors (``q`` is ``diff`` itself
    for an identity server quantizer) and its (K,) normalized weights or
    None."""
    n, dev = x_old.shape[0], x_old.device
    for name, t in (("x_old", x_old), ("x_new", x_new), ("delta", delta),
                    ("diff", diff), ("q", q)):
        check_tensor(name, t, torch.float32, (n,), dev)
    if weights is not None:
        check_tensor("weights", weights, torch.float32, (None,), dev)
    if n == 0:
        raise ValueError("flush_taps needs a non-empty vector")
    if not on_card(x_old):
        return _ref.flush_taps(x_old, x_new, delta, diff, q, weights)
    k = 0 if weights is None else weights.shape[0]
    partials = torch.empty(scratch_slots(n) * FLUSH_SUMS, dtype=torch.float32,
                           device=dev)
    out = torch.empty(7, dtype=torch.float32, device=dev)
    fn = _build.entry("flush_taps")
    _build.check("flush_taps", fn(
        x_old.data_ptr(), x_new.data_ptr(), delta.data_ptr(),
        diff.data_ptr(), q.data_ptr(), weights.data_ptr() if k else None, k,
        n, partials.data_ptr(), row_counters(dev, 1).data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["flush_taps"] += 1
    return out


def round_taps(partials: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The QAFeL round's tap vector, f32 (7,) in
    ``obs.taps.FLUSH_TAP_NAMES`` order, from the f32 (5, W) level-1 window
    sums of its five squares (rows delta_bar, x_new - x, diff:
    ``server_update_(taps=)``; err, q: ``qsgd_unpack_dequantize(taps=)``)
    and its (K,) staleness weights or None: XLA's sum law finished on each
    row (``ref.round_taps_finish``), one launch."""
    check_tensor("partials", partials, torch.float32,
                 (_ref.ROUND_TAP_SUMS, None), partials.device)
    windows, dev = partials.shape[1], partials.device
    if weights is not None:
        check_tensor("weights", weights, torch.float32, (None,), dev)
    if windows == 0:
        raise ValueError("round_taps needs a non-empty vector")
    if not on_card(partials):
        return _ref.round_taps_finish(partials, weights)
    k = 0 if weights is None else weights.shape[0]
    scratch = torch.empty(scratch_slots(windows) * _ref.ROUND_TAP_SUMS,
                          dtype=torch.float32, device=dev)
    out = torch.empty(7, dtype=torch.float32, device=dev)
    fn = _build.entry("round_taps")
    _build.check("round_taps", fn(
        partials.data_ptr(), windows, weights.data_ptr() if k else None, k,
        scratch.data_ptr(), row_counters(dev, 1).data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["round_taps"] += 1
    return out


def upload_taps(flat2d: torch.Tensor, packed: Optional[torch.Tensor] = None,
                norms: Optional[torch.Tensor] = None,
                bits: Optional[int] = None) -> torch.Tensor:
    """Per-message upload taps of an f32 (b, d) delta stack, f32 (b, 2) in
    ``obs.taps.COHORT_TAP_NAMES`` order. ``packed`` uint8 (b, rows, 16*bits)
    and ``norms`` f32 (b, rows) are the stack's wire codes; without them
    (identity uploads, ``bits`` None) the error column is 0."""
    check_tensor("flat2d", flat2d, torch.float32, (None, None), flat2d.device)
    b, d = flat2d.shape
    dev = flat2d.device
    if b == 0 or d == 0:
        raise ValueError(f"upload_taps needs a non-empty stack, got "
                         f"{tuple(flat2d.shape)}")
    if (packed is None) != (bits is None) or (packed is None) != (
            norms is None):
        raise ValueError("upload_taps takes packed, norms and bits together")
    if packed is not None:
        check_bits(bits)
        rows = _ref.rows_for(d)
        check_tensor("packed", packed, torch.uint8,
                     (b, rows, LANES * bits // 8), dev)
        check_tensor("norms", norms, torch.float32, (b, rows), dev)
        if packed.data_ptr() % 4:
            raise ValueError("upload_taps reads the codes as 32-bit words: "
                             "packed must be 4-byte aligned")
    if not on_card(flat2d):
        return _ref.upload_taps(flat2d, packed, norms, bits)
    partials = torch.empty(b * scratch_slots(d) * UPLOAD_SUMS, dtype=torch.float32,
                           device=dev)
    out = torch.empty((b, 2), dtype=torch.float32, device=dev)
    fn = _build.entry("upload_taps")
    _build.check("upload_taps", fn(
        flat2d.data_ptr(), None if packed is None else packed.data_ptr(),
        None if norms is None else norms.data_ptr(), b, d,
        0 if bits is None else bits, partials.data_ptr(),
        row_counters(dev, b).data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["upload_taps"] += 1
    return out


def lowrank_upload_taps(c2d: torch.Tensor, e2d: torch.Tensor,
                        y2d: torch.Tensor, packed: torch.Tensor,
                        norms: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-member lowrank upload taps, f32 (b, 3) in
    ``obs.taps.COHORT_TAP_NAMES_LOWRANK`` order: ``||c||``, ``||e|| /
    max(||c||, 1e-30)`` and the subspace error ``||y - qdq(y)|| /
    max(||y||, 1e-30)``, from the error-compensated stack ``c2d``, the new
    residual ``e2d`` (both (b, d)), the (b, rank) subspace stack ``y2d``
    and its wire codes. Two ``upload_taps`` launches: one over ``(y,
    codes)``, one over the rows of ``c`` and ``e`` together, so every sum
    runs in ``ref.tap_sum``'s order."""
    b = c2d.shape[0]
    sub = upload_taps(y2d, packed, norms, bits)
    ce = upload_taps(torch.cat([c2d, e2d]))[:, 0]
    cn = ce[:b]
    return torch.stack([cn, _ref._relative(ce[b:], cn), sub[:, 1]], dim=1)
