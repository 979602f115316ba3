"""Plain PyTorch versions of the qsgd / buffer kernels.

Each function computes exactly what its CUDA kernel computes, bit for bit,
and exactly what the JAX reference computes on XLA:CPU. The wrappers in
``kernels.qsgd`` and ``kernels.buffer_agg`` run these on CPU tensors; the
tests compare them with ``repro.kernels.ops`` and ``chip_smoke.py`` compares
them with the kernels on the card. The rounding follows the reference's
laws on purpose, and a reduction or product written the "natural" torch way
would differ in about a third of the rows or elements:

* bucket norm: four partial sums, partial w adding ``x[32w+j]**2`` for
  j = 0..31 in order (multiply and add rounded separately), then
  ``((p0+p1)+p2)+p3`` and ``sqrt``; ``torch.sum`` takes another order;
* codes: ``inv = s / max(norm, 1e-30)`` as a true division (torch's
  ``scalar / tensor`` would take a reciprocal first), ``level = |x|*inv``,
  stochastic round against the dither, sign bit as the MSB, codes packed
  little-endian into bytes;
* dequantize: ``(sign*mag) * (norm * fl32(1/s))`` — XLA rewrites the
  division by s as a product with the f32 reciprocal;
* buffer aggregate: ``scale_k = (w_k*n_k) * fl32(1/s)`` and
  ``acc = fma(sign*mag, scale_k, acc)`` over ascending k from zero;
* square root: correctly rounded, which torch's CPU ``sqrt`` is not;
* metric taps (``flush_taps``, ``upload_taps``): sums of squares in
  XLA:CPU's own order for ``jnp.sum`` (``xla_sum``: windows of 32 with
  the padding split, recursively), which depends on the length alone.

Counter-hash words are uint32 values held in int64 tensors (torch has no
uint32 shifts or adds on the CPU), masked after every add and multiply.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import prng

LANES = 128  # bucket size: one norm per 128-element row
MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def levels(bits: int) -> int:
    """Magnitude levels s of a ``bits``-bit code (one bit is the sign)."""
    return (1 << (bits - 1)) - 1


def reciprocal_levels(bits: int) -> float:
    """fl32(1/s): the f32 reciprocal XLA multiplies by in place of ``/ s``."""
    return float(np.float32(1.0) / np.float32(levels(bits)))


def sqrt_f32(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root of a non-negative f32 tensor.

    torch's CPU ``sqrt`` is off by one ulp on about 0.7% of inputs, so the
    root is taken in float64 and then corrected against the two midpoints
    around it: a midpoint of adjacent f32 values has 25 significant bits,
    so its square is exact in float64 and the comparison decides the
    rounding exactly. On the card ``sqrt`` is already exact and the
    correction changes nothing."""
    t64 = t.to(torch.float64)
    r = torch.sqrt(t64).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    mid = (r.to(torch.float64) + up.to(torch.float64)) * 0.5
    r = torch.where(mid * mid < t64, up, r)
    down = torch.nextafter(r, torch.zeros_like(r))
    mid = (r.to(torch.float64) + down.to(torch.float64)) * 0.5
    return torch.where(mid * mid > t64, down, r)


def bucket_norms(x2d: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norm of an f32 (rows, 128) array in the reference's sum
    order (four in-order partials of 32 squares, combined left to right)."""
    sq = (x2d * x2d).reshape(-1, 4, 32)
    acc = sq[:, :, 0]
    for j in range(1, 32):
        acc = acc + sq[:, :, j]
    total = ((acc[:, 0] + acc[:, 1]) + acc[:, 2]) + acc[:, 3]
    return sqrt_f32(total)


def rows_for(n: int) -> int:
    """Number of 128-lane rows (= bucket norms) of a length-n message."""
    return (n + LANES - 1) // LANES


def rows2d(flat: torch.Tensor) -> torch.Tensor:
    """(..., n) f32 -> (..., rows_for(n), 128), zero-padding the last row."""
    n = flat.shape[-1]
    pad = rows_for(n) * LANES - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(*flat.shape[:-1], rows_for(n), LANES).contiguous()


def _pack(code: torch.Tensor, bits: int) -> torch.Tensor:
    per_byte = 8 // bits
    grouped = code.reshape(code.shape[0], LANES // per_byte, per_byte)
    shifts = torch.arange(per_byte, device=code.device) * bits
    return (grouped << shifts).sum(dim=-1).to(torch.uint8)


def quantize_pack(x2d: torch.Tensor, u2d: torch.Tensor, bits: int):
    """f32 (rows, 128) message + f32 (rows, 128) uniforms -> (packed uint8
    (rows, 128*bits//8), norms f32 (rows,))."""
    s = levels(bits)
    norm = bucket_norms(x2d)
    inv = torch.where(norm > 0.0,
                      torch.full_like(norm, float(s))
                      / torch.clamp(norm, min=1e-30),
                      torch.zeros_like(norm))
    level = x2d.abs() * inv[:, None]
    low = torch.floor(level)
    xi = low + (u2d < (level - low)).to(torch.float32)
    xi = torch.clamp(xi, max=float(s)).to(torch.int64)
    code = ((x2d < 0.0).to(torch.int64) << (bits - 1)) | xi
    return _pack(code, bits), norm


def quantize_pack_threefry(flat: torch.Tensor, key, bits: int, *,
                           row0: int = 0):
    """f32 (n,) message quantized with the threefry dither ``uniform(key,
    (rows, 128))`` over its zero-padded rows -> (packed uint8
    (rows, 128*bits//8), norms f32 (rows,)): the b=1 upload. With ``row0``
    the message is rows ``[row0, row0 + rows)`` of a longer one, and
    element i takes the dither of its element ``row0*128 + i``."""
    x2d = rows2d(flat)
    u = prng.uniform_range(key, row0 * LANES, x2d.numel(), device=flat.device)
    return quantize_pack(x2d, u.reshape(x2d.shape), bits)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 without overflowing int64: split c into 16-bit
    halves so every partial product stays below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_uniform(seed0, seed1, idx: torch.Tensor) -> torch.Tensor:
    """The counter hash's f32 uniforms in [0, 1): two fmix32 rounds of
    ``idx * golden + seed0`` keyed by ``seed1``, top 24 bits scaled.
    ``idx`` is an int64 tensor of uint32 counters; the seeds are uint32
    words as Python ints or int64 tensors that broadcast against it."""
    x = _fmix32((_mul32(idx, _GOLDEN) + seed0) & MASK32)
    x = _fmix32(x ^ seed1)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform(seeds: torch.Tensor, rows: int, row0: int = 0):
    """The counter-hash dither of the batched kernel: for message b and
    element index ``(row0 + row)*128 + lane`` mod 2**32, ``counter_uniform``
    keyed by ``seeds[b]``. ``seeds`` is (B, 2) int64 holding uint32 words;
    returns f32 (B, rows, 128) on the seeds' device."""
    dev = seeds.device
    row = torch.arange(row0, row0 + rows, dtype=torch.int64, device=dev)
    lane = torch.arange(LANES, dtype=torch.int64, device=dev)[None, :]
    idx = ((row[:, None] * LANES + lane) & MASK32)[None]
    s0 = (seeds[:, 0] & MASK32).reshape(-1, 1, 1)
    s1 = (seeds[:, 1] & MASK32).reshape(-1, 1, 1)
    return counter_uniform(s0, s1, idx)


def quantize_pack_batch(x3d: torch.Tensor, seeds: torch.Tensor, bits: int,
                        *, row0: int = 0):
    """f32 (B, rows, 128) stack + (B, 2) int64 seed words -> (packed uint8
    (B, rows, 128*bits//8), norms f32 (B, rows)); the dither is
    ``hash_uniform`` from row ``row0`` on, so a message's codes depend
    neither on the batch nor on how its rows are cut into chunks."""
    b, rows, _ = x3d.shape
    u = hash_uniform(seeds.to(x3d.device), rows, int(row0))
    packed, norms = quantize_pack(x3d.reshape(b * rows, LANES),
                                  u.reshape(b * rows, LANES), bits)
    return packed.reshape(b, rows, -1), norms.reshape(b, rows)


def signed_magnitudes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Unpack uint8 (..., rows, 128*bits//8) codes to f32 ``sign*mag``
    (..., rows, 128)."""
    per_byte = 8 // bits
    shifts = torch.arange(per_byte, device=packed.device) * bits
    codes = (packed.to(torch.int64)[..., None] >> shifts) & ((1 << bits) - 1)
    codes = codes.reshape(*packed.shape[:-1], LANES)
    mag = (codes & levels(bits)).to(torch.float32)
    sign = 1.0 - 2.0 * ((codes >> (bits - 1)) & 1).to(torch.float32)
    return sign * mag


_ACC_CHUNK_ROWS = 1 << 18  # rows per float64 chunk of the accumulating decode


def unpack_dequantize(packed: torch.Tensor, norms: torch.Tensor, bits: int,
                      *, eager: bool = False, acc=None, weight=None):
    """Packed uint8 (rows, 128*bits//8) + norms f32 (rows,) -> f32
    (rows, 128) = (sign*mag) * (norm * fl32(1/s)), or with ``eager``
    (sign*mag) * (norm / s), a true division. With an f32 accumulator
    ``acc`` of n <= rows*128 values: fma(sign*mag, norm * fl32(1/s),
    acc) (0 past n), or with a one-element f32 ``weight`` too,
    fma((sign*mag) * (norm * fl32(1/s)), weight, acc);
    ``_ACC_CHUNK_ROWS`` rows at a time so the float64 temporaries stay
    small."""
    if acc is not None:
        rows = packed.shape[0]
        flat = torch.nn.functional.pad(acc, (0, rows * LANES - acc.numel()))
        out = flat.reshape(rows, LANES).clone()
        scale = norms * reciprocal_levels(bits)
        for r in range(0, rows, _ACC_CHUNK_ROWS):
            sl = slice(r, r + _ACC_CHUNK_ROWS)
            sm = signed_magnitudes(packed[sl], bits)
            if weight is None:
                out[sl] = fma_f32(sm, scale[sl, None], out[sl])
            else:
                out[sl] = fma_f32(sm * scale[sl, None], weight, out[sl])
        return out
    if eager:
        scale = norms / torch.full_like(norms, float(levels(bits)))
    else:
        scale = norms * reciprocal_levels(bits)
    return signed_magnitudes(packed, bits) * scale[:, None]


def fma_f32(a: torch.Tensor, b, c: torch.Tensor):
    """Single-rounded f32 ``a*b + c`` of f32 operands (``b`` a tensor or an
    f32-representable Python number) whose product is exact in float64
    (two f32 significands give at most 48 bits).

    The sum is taken in float64, ``s = p + c``, with its exact TwoSum error
    ``err``. Rounding ``s`` to f32 is already the correctly rounded result
    unless ``s`` lies exactly on the midpoint of two f32 neighbours (a
    midpoint has 25 significant bits, so it is a double, and no double lies
    closer to the exact sum than ``s``): then the exact sum lies on the
    side of ``err``, and that neighbour is the answer (``err == 0`` is a
    true tie, which the f32 conversion breaks to even). Written without
    bit views of the tensors, so it runs under ``torch.func.vmap``."""
    p = a.to(torch.float64) * (b.to(torch.float64)
                               if isinstance(b, torch.Tensor) else float(b))
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    tie = ((s != r64) & ((r64 + other.to(torch.float64)) * 0.5 == s)
           & (err != 0))
    side = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, side, r)


def server_update_(buf: torch.Tensor, m: torch.Tensor, x: torch.Tensor,
                   xhat: torch.Tensor, *, inv_k: float, beta, lr: float,
                   taps=None, chunk: int = 1 << 25):
    """The round's server update over the first n = ``x.numel()`` values,
    in place, about ``chunk`` elements at a time: ``delta_bar = buf *
    inv_k``, ``m_new = fma(m, beta, delta_bar)`` (``beta`` None:
    ``delta_bar``), ``x_new = m_new + x`` for ``lr == 1`` else
    ``fma(m_new, lr, x)``, ``diff = x_new - xhat``; then ``buf <- diff``
    (f32), ``m <- m_new`` and ``x <- x_new`` rounded to their dtype (f32 or
    bf16, nearest even). ``inv_k``, ``beta`` and ``lr`` are f32 values; m,
    x and xhat share one dtype and buf is f32. With ``taps``, an f32 (3,
    ``tap_windows(n)``) tensor, its rows get the level-1 window sums
    (``window_chunks``) of ``delta_bar**2``, ``(x_new - x)**2`` (x_new the
    f32 value before rounding) and ``diff**2``, each square rounded, as
    XLA:CPU computes the reference round's taps. Returns ``buf``."""
    n = x.numel()
    for w0, w1, a, b, lo, hi in window_chunks(n, max(1, chunk // 32)):
        sl = slice(a, b)
        delta_bar, m_new, x_new, diff = server_update_values(
            buf[sl], m[sl], x[sl], xhat[sl], inv_k=inv_k, beta=beta, lr=lr)
        if taps is not None:
            upd = x_new - x[sl].to(torch.float32)
            for row, v in enumerate((delta_bar, upd, diff)):
                taps[row, w0:w1] = window_sums(v * v, lo, hi)
        buf[sl] = diff
        m[sl] = m_new.to(m.dtype)
        x[sl] = x_new.to(x.dtype)
    return buf


def server_update_values(buf, m, x, xhat, *, inv_k: float, beta,
                         lr: float):
    """``server_update_``'s values on one range, in f32 and not written
    anywhere: ``(delta_bar, m_new, x_new, diff)``; m, x and xhat of any
    float dtype (each coordinate rounded as ``server_update_`` rounds
    it)."""
    delta_bar = buf * inv_k
    m_new = (delta_bar if beta is None else
             fma_f32(m.to(torch.float32), beta, delta_bar))
    x32 = x.to(torch.float32)
    x_new = m_new + x32 if lr == 1.0 else fma_f32(m_new, lr, x32)
    return delta_bar, m_new, x_new, x_new - xhat.to(torch.float32)


def buffer_aggregate(stack: torch.Tensor, norms: torch.Tensor,
                     weights: torch.Tensor, bits: int) -> torch.Tensor:
    """sum_k w_k * dequant(stack[k], norms[k]) over ascending k, each step
    one fused multiply-add; stack uint8 (K, rows, 128*bits//8), norms f32
    (K, rows), weights f32 (K,) -> f32 (rows, 128)."""
    rcp = reciprocal_levels(bits)
    scales = [((weights[k] * norms[k]) * rcp)[:, None]
              for k in range(stack.shape[0])]
    if len(scales) == 1:
        # XLA folds the one-step loop's ``0 + p`` to ``p``, which keeps the
        # sign of a zero product; the kernel does the same
        return signed_magnitudes(stack[0], bits) * scales[0]
    acc = torch.zeros((stack.shape[1], LANES), dtype=torch.float32,
                      device=stack.device)
    for k, scale in enumerate(scales):
        acc = fma_f32(signed_magnitudes(stack[k], bits), scale, acc)
    return acc


XLA_WINDOW = 32  # XLA:CPU's reduce window (``xla_sum``)


def _in_order(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right from +0."""
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def xla_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in XLA:CPU's order for an f32 ``jnp.sum`` (jax 0.9;
    read from its optimised HLO, ``reduce-window(size=32, stride=32)``
    with the padding split evenly, then a ``reduce``): cut the n values
    into windows of 32, ``floor(pad/2)`` zeros in front and the rest
    behind; sum each window in order from +0; reduce the window sums by
    the same law until 32 or fewer are left, and sum those in order. Up to
    32 values it is the in-order sum. Every add is an f32 add, so the
    result is the same on every device."""
    v = v.movedim(dim, -1)
    while v.shape[-1] > XLA_WINDOW:
        v = _window_sums(v)
    return _in_order(v)


def _window_sums(v: torch.Tensor) -> torch.Tensor:
    """One level of ``xla_sum``: the in-order sums of the windows of 32
    over the last axis, ``tap_front`` zeros in front, with no padded copy
    of ``v``: the whole windows are a view, and a window cut by the
    padding sums its values alone (an add of +0 to a sum begun at +0
    changes no bit: such a sum is never -0)."""
    n, w = v.shape[-1], XLA_WINDOW
    windows, f = tap_windows(n), tap_front(n)
    back = windows * w - n - f
    w0, w1 = (1 if f else 0), windows - (1 if back else 0)
    parts = []
    if f:
        parts.append(_in_order(v[..., :w - f])[..., None])
    if w1 > w0:
        parts.append(_in_order(v[..., w0 * w - f:w1 * w - f].reshape(
            *v.shape[:-1], w1 - w0, w)))
    if back:
        parts.append(_in_order(v[..., (windows - 1) * w - f:])[..., None])
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def tap_front(n: int) -> int:
    """Zeros in front of a level of n values in ``xla_sum``'s law: half the
    padding to whole windows of 32, rounded down (none at 32 or fewer,
    where the level is summed in order)."""
    if n <= XLA_WINDOW:
        return 0
    return (-(-n // XLA_WINDOW) * XLA_WINDOW - n) // 2


def tap_windows(n: int) -> int:
    """Level-1 windows of a vector of n values, ``ceil(n / 32)``."""
    return -(-n // XLA_WINDOW)


def window_chunks(n: int, windows: int):
    """The level-1 windows of a vector of n values, ``windows`` at a time:
    yields ``(w0, w1, a, b, lo, hi)``, windows [w0, w1) covering the
    elements [a, b) with ``lo`` zeros in front and ``hi`` behind (window w
    holds elements [32 w - f, 32 w - f + 32), f = ``tap_front(n)``)."""
    f, total = tap_front(n), tap_windows(n)
    for w0 in range(0, total, windows):
        w1 = min(total, w0 + windows)
        s, e = XLA_WINDOW * w0 - f, XLA_WINDOW * w1 - f
        a, b = max(s, 0), min(e, n)
        yield w0, w1, a, b, a - s, e - b


def window_sums(sq: torch.Tensor, lo: int = 0, hi: int = 0) -> torch.Tensor:
    """Level-1 window sums of ``xla_sum``'s law: ``sq`` (the squares of a
    run of whole windows, ``lo`` zeros in front and ``hi`` behind) summed
    32 at a time in order from +0."""
    sq = torch.nn.functional.pad(sq, (lo, hi))
    return _in_order(sq.reshape(-1, XLA_WINDOW))


def tap_sum(sq: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of f32 squares in the reference's order:
    the taps' ``jnp.sum`` of materialized squares, which is ``xla_sum``
    (the tap kernels' ``csrc/tap_reduce.cuh`` runs the same order)."""
    return xla_sum(sq)


def _relative(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / max(den, 1e-30) as an IEEE f32 division."""
    return num / torch.clamp(den, min=1e-30)


def flush_taps(x_old: torch.Tensor, x_new: torch.Tensor, delta: torch.Tensor,
               diff: torch.Tensor, q: torch.Tensor, weights=None):
    """The flush's tap vector, f32 (7,): the norms of delta, x_new - x_old,
    diff and q, the relative broadcast error ||diff - q|| / ||diff||, and
    the weights' in-order sum and their minimum (zeros without weights)."""
    upd = x_new - x_old
    err = diff - q
    roots = sqrt_f32(torch.stack([tap_sum(v * v)
                                  for v in (delta, upd, diff, err, q)]))
    return _tap_vector(roots, weights, x_old.device)


def upload_taps(flat2d: torch.Tensor, packed=None, norms=None, bits=None):
    """Per-message upload taps of a (b, d) delta stack, f32 (b, 2):
    ``[||delta_i||, ||delta_i - qdq(delta_i)|| / max(||delta_i||, 1e-30)]``
    with qdq the decode of the message's packed codes (``unpack_dequantize``
    law, its last product fused into the subtraction as XLA:CPU compiles
    the reference's tap); the error is 0 without codes (identity
    uploads)."""
    b, d = flat2d.shape
    dn = sqrt_f32(tap_sum(flat2d * flat2d))
    if packed is None:
        s_err = torch.zeros_like(dn)
    else:
        rows = packed.shape[1]
        # XLA:CPU fuses the decode's last product into the subtraction:
        # delta - (sign*mag) * scale rounds once
        sm = signed_magnitudes(packed, bits).reshape(b, rows * LANES)[:, :d]
        scale = (norms * reciprocal_levels(bits))[:, :, None].expand(
            b, rows, LANES).reshape(b, rows * LANES)[:, :d]
        err = fma_f32(-sm, scale, flat2d)
        s_err = tap_sum(err * err)
    return torch.stack([dn, _relative(sqrt_f32(s_err), dn)], dim=1)


def _decode_slice(packed: torch.Tensor, norms: torch.Tensor, bits: int,
                  a: int, b: int):
    """``sign*mag`` and ``norm * fl32(1/s)`` of the elements [a, b) of a
    message's codes, each f32 (b - a,)."""
    r0, r1 = a // LANES, rows_for(b)
    sm = signed_magnitudes(packed[r0:r1], bits).reshape(-1)
    scale = (norms[r0:r1] * reciprocal_levels(bits)).repeat_interleave(LANES)
    return (sm[a - r0 * LANES:b - r0 * LANES],
            scale[a - r0 * LANES:b - r0 * LANES])


def dequantize_taps(packed: torch.Tensor, norms: torch.Tensor, bits: int,
                    diff: torch.Tensor, *, chunk: int = 1 << 25):
    """The broadcast's two taps as level-1 window sums, f32 (2,
    ``tap_windows(n)``) for the n values of ``diff``: of ``err**2``, err
    ``fma(-(sign*mag), norm * fl32(1/s), diff)``, and of ``q**2``, q the
    materialized decode ``(sign*mag) * (norm * fl32(1/s))``: XLA:CPU
    fuses the decode's last product into the reference round's ``diff - q``
    (read from its object code, one ``vfnmadd``), as in the upload taps."""
    n = diff.numel()
    out = torch.empty((2, tap_windows(n)), dtype=torch.float32,
                      device=diff.device)
    for w0, w1, a, b, lo, hi in window_chunks(n, max(1, chunk // 32)):
        sm, scale = _decode_slice(packed, norms, bits, a, b)
        q = sm * scale
        err = fma_f32(-sm, scale, diff[a:b])
        out[0, w0:w1] = window_sums(err * err, lo, hi)
        out[1, w0:w1] = window_sums(q * q, lo, hi)
    return out


ROUND_TAP_SUMS = 5  # delta_bar, x_new - x, diff, diff - q, q


def round_taps_finish(partials: torch.Tensor, weights=None) -> torch.Tensor:
    """The round's tap vector, f32 (7,) in ``obs.taps.FLUSH_TAP_NAMES``
    order, from its level-1 window sums: the f32 (5, W) rows of
    ``delta_bar**2``, ``(x_new - x)**2``, ``diff**2`` (``server_update_``),
    ``err**2`` and ``q**2`` (``dequantize_taps``). Each row's total is ``xla_sum`` of its window sums (the rest of
    XLA's law), then ``flush_taps``' roots, ratio and weights."""
    roots = sqrt_f32(xla_sum(partials))
    return _tap_vector(roots, weights, partials.device)


def _tap_vector(roots: torch.Tensor, weights, device) -> torch.Tensor:
    """[r0, r1, r2, r3 / max(r2, 1e-30), r4, sum w, min w] from the five
    roots; the weights summed in order from the first (zeros without)."""
    if weights is None or weights.numel() == 0:
        wsum = wmin = torch.zeros((), dtype=torch.float32, device=device)
    else:
        wsum = weights[0]
        for k in range(1, weights.shape[0]):
            wsum = wsum + weights[k]
        wmin = torch.min(weights)
    return torch.stack([roots[0], roots[1], roots[2],
                        _relative(roots[3], roots[2]), roots[4], wsum, wmin])


def round_taps(x_old: torch.Tensor, x_new: torch.Tensor,
               delta: torch.Tensor, diff: torch.Tensor, packed: torch.Tensor,
               norms: torch.Tensor, bits: int, weights=None, *,
               chunk: int = 1 << 25) -> torch.Tensor:
    """The QAFeL round's tap vector, f32 (7,), from its materialized f32
    vectors (x before and after the server update, ``delta_bar``, the
    broadcast diff) and the broadcast's codes: ``xla_sum`` of each rounded
    square (``delta``, ``x_new - x_old``, ``diff``, the error ``fma(-(sign
    *mag), scale, diff)`` and the decode q), correctly rounded roots, the
    ratio and the weights' sum and minimum. The sums run over windows of
    ``chunk`` values at a time (``xla_sum`` is ``xla_sum`` of its level-1
    window sums), so a long vector needs no whole-length temporaries. The
    plain version of the kernel path (the server update's and K3's tap
    outputs, then ``kernels.taps.round_taps``), for the tests."""
    n = diff.numel()
    parts = torch.empty((ROUND_TAP_SUMS, tap_windows(n)),
                        dtype=torch.float32, device=diff.device)
    for w0, w1, a, b, lo, hi in window_chunks(n, max(1, chunk // 32)):
        sm, scale = _decode_slice(packed, norms, bits, a, b)
        q = sm * scale
        err = fma_f32(-sm, scale, diff[a:b])
        upd = x_new[a:b] - x_old[a:b]
        for row, v in enumerate((delta[a:b], upd, diff[a:b], err, q)):
            parts[row, w0:w1] = window_sums(v * v, lo, hi)
    return round_taps_finish(parts, weights)
