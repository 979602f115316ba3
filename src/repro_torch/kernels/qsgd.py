"""Wrappers of the qsgd wire kernels (CUDA C++ in ``csrc/``).

Counterpart of ``repro/kernels/qsgd.py``. Wire format per message of n
elements: ``rows = ceil(n/128)`` rows of 128 lanes, one f32 L2 norm per row
(bucket) and one ``bits``-bit code per element — a sign bit (MSB) over the
stochastically rounded level in [0, s], s = 2**(bits-1) - 1 — packed
little-endian, ``8 // bits`` codes per byte. bits is 2, 4 or 8.

Each wrapper checks its inputs, allocates its outputs and then either runs
the kernel's plain PyTorch version (``kernels.ref``) for a CPU tensor or
launches the kernel on the current CUDA stream for a CUDA tensor, adding
one to ``LAUNCHES[name]`` per launch. Any other device raises; there is no
fallback from the card to the plain version.

The TPU kernels' 256-row tile padding has no counterpart: the CUDA kernels
mask the ragged edge themselves and take wire-layout rows as they come.
Kernels that load 16 bytes at a time need 16-byte aligned inputs on the
card; the wrappers raise for any other.

The batched encode has two entries on one kernel:
``qsgd_quantize_pack_batch`` takes the TPU kernel's (B, rows, 128) layout
and ``qsgd_quantize_pack_batch_flat`` a flat (B, n) stack, whose ragged
rows the kernel pads itself (the flush's broadcast encode, one launch).

The b=1 upload has two entries: ``qsgd_quantize_pack`` takes the uniforms
from the caller (the TPU kernel's own signature) and
``qsgd_quantize_pack_threefry`` draws the threefry uniforms inside the
kernel, so the upload is one launch and the uniforms never reach memory.

The low-rank uplink's sketch basis (``basis_seeds``, ``sketch_signs``,
``sketch_project``, ``sketch_expand``) is here too, in plain PyTorch, as
the reference has it in XLA beside its kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import to_device
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import LANES

# launches per kernel since the last reset (``kernels.reset_launches``)
LAUNCHES = {"qsgd_quantize_pack": 0, "qsgd_quantize_pack_threefry": 0,
            "qsgd_quantize_pack_batch": 0, "qsgd_unpack_dequantize": 0}


def check_bits(bits: int) -> None:
    if bits not in (2, 4, 8):
        raise ValueError(f"packed qsgd needs bits in (2, 4, 8), got {bits}")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` has the dtype, shape (None = any extent) and
    device given and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary (the kernels'
    vector loads need it; a fresh allocation always does)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raise for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def qsgd_quantize_pack(x2d: torch.Tensor, u2d: torch.Tensor, bits: int):
    """Quantize + pack an f32 (rows, 128) message with caller-given f32
    (rows, 128) uniforms. Returns (packed uint8 (rows, 16*bits), norms f32
    (rows,))."""
    check_bits(bits)
    rows = x2d.shape[0]
    check_tensor("x2d", x2d, torch.float32, (None, LANES), x2d.device)
    check_tensor("u2d", u2d, torch.float32, (rows, LANES), x2d.device)
    if not on_card(x2d):
        return _ref.quantize_pack(x2d, u2d, bits)
    check_aligned("x2d", x2d)
    packed = torch.empty((rows, LANES * bits // 8), dtype=torch.uint8,
                         device=x2d.device)
    norms = torch.empty((rows,), dtype=torch.float32, device=x2d.device)
    if rows:
        fn = _build.entry("quantize_pack")
        _build.check("qsgd_quantize_pack", fn(
            x2d.data_ptr(), u2d.data_ptr(), packed.data_ptr(),
            norms.data_ptr(), rows, bits,
            torch.cuda.current_stream(x2d.device).cuda_stream))
        LAUNCHES["qsgd_quantize_pack"] += 1
    return packed, norms


def qsgd_quantize_pack_threefry(flat: torch.Tensor, key, bits: int, *,
                                row0: int = 0,
                                total_rows: Optional[int] = None):
    """Quantize + pack one flat f32 (n,) message over its zero-padded
    ``rows = ceil(n/128)`` rows with the dither ``prng.uniform(key,
    (rows, 128))``, which the kernel draws itself (a key is two uint32
    words, see ``common.prng``). Returns (packed uint8 (rows, 16*bits),
    norms f32 (rows,)).

    ``row0`` makes ``flat`` the rows ``[row0, row0 + rows)`` of a message
    of ``total_rows`` rows (default ``row0 + rows``): the dither of its
    element i is that of element ``row0*128 + i`` of the whole message, so
    the chunk's codes and norms are exactly those rows of the whole
    message's. The counter law is pinned for ``total_rows*128 < 2**32``
    only, so larger messages raise."""
    check_bits(bits)
    check_tensor("flat", flat, torch.float32, (None,), flat.device)
    n = flat.shape[0]
    rows = _ref.rows_for(n)
    row0 = int(row0)
    total = row0 + rows if total_rows is None else int(total_rows)
    if row0 < 0 or row0 + rows > total:
        raise ValueError(f"rows [{row0}, {row0 + rows}) lie outside a "
                         f"message of {total} rows")
    if total * LANES >= 2 ** 32:
        raise ValueError(f"a message of {total} rows; the threefry dither "
                         "needs rows*128 < 2**32")
    if not on_card(flat):
        return _ref.quantize_pack_threefry(flat, key, bits, row0=row0)
    check_aligned("flat", flat)
    k0, k1 = prng.key_words(key)
    packed = torch.empty((rows, LANES * bits // 8), dtype=torch.uint8,
                         device=flat.device)
    norms = torch.empty((rows,), dtype=torch.float32, device=flat.device)
    if rows:
        fn = _build.entry("quantize_pack_threefry")
        _build.check("qsgd_quantize_pack_threefry", fn(
            flat.data_ptr(), n, packed.data_ptr(), norms.data_ptr(), bits,
            k0, k1, row0, torch.cuda.current_stream(flat.device).cuda_stream))
        LAUNCHES["qsgd_quantize_pack_threefry"] += 1
    return packed, norms


def seed_words(seeds: torch.Tensor):
    """The (B, 2) seed words (int64 holding uint32 values) as the batched
    kernel's by-value parameter: a ``SeedWords`` whose words 2b, 2b+1 are
    ``seeds[b]`` for B <= ``SEEDS_BY_VALUE``, else None (the kernel then
    reads them from a device buffer)."""
    b = seeds.shape[0]
    if b > _build.SEEDS_BY_VALUE:
        return None
    words = _build.SeedWords()
    words.w[:2 * b] = [int(w) & 0xFFFFFFFF for w in seeds.reshape(-1).tolist()]
    return words


def _check_seeds(seeds, b: int) -> torch.Tensor:
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1, 2)
    if seeds.shape[0] != b:
        raise ValueError(f"seeds: {seeds.shape[0]} pairs for {b} messages")
    return seeds


def _launch_batch(x: torch.Tensor, n: int, stride: int, b: int,
                  seeds: torch.Tensor, bits: int, row0: int):
    """The batched kernel on B messages of n elements, message b at
    ``x.data_ptr() + 4*b*stride``, whose first row is row ``row0`` of the
    whole message; the kernel zero-pads each ragged last row. Seed words go
    by value, or for B above the cap through a device buffer."""
    check_aligned("x", x)
    rows = _ref.rows_for(n)
    packed = torch.empty((b, rows, LANES * bits // 8), dtype=torch.uint8,
                         device=x.device)
    norms = torch.empty((b, rows), dtype=torch.float32, device=x.device)
    if b * rows:
        words, on_dev = seed_words(seeds), None
        if words is None:
            on_dev = to_device(prng.key_words_i32(seeds.cpu()).contiguous(),
                               x.device)
            words = _build.SeedWords()
        fn = _build.entry("quantize_pack_batch")
        _build.check("qsgd_quantize_pack_batch", fn(
            x.data_ptr(), n, stride, row0, b, bits, words,
            None if on_dev is None else on_dev.data_ptr(), packed.data_ptr(),
            norms.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream))
        LAUNCHES["qsgd_quantize_pack_batch"] += 1
    return packed, norms


def qsgd_quantize_pack_batch(x3d: torch.Tensor, seeds: torch.Tensor,
                             bits: int, *, row0: int = 0):
    """Quantize + pack an f32 (B, rows, 128) stack; the dither is the
    in-kernel counter hash keyed by each message's seed words ``seeds[b]``
    ((B, 2) int64 holding uint32 values, best on the CPU: up to
    ``SEEDS_BY_VALUE`` messages they ride in the launch itself) and the
    element index ``(row0 + row)*128 + lane`` (mod 2**32, the reference's
    ``row_offset``: the stack is rows ``[row0, row0 + rows)`` of longer
    messages). Returns (packed uint8 (B, rows, 16*bits), norms f32
    (B, rows))."""
    check_bits(bits)
    b, rows = x3d.shape[0], x3d.shape[1]
    check_tensor("x3d", x3d, torch.float32, (None, None, LANES), x3d.device)
    seeds = _check_seeds(seeds, b)
    if not on_card(x3d):
        return _ref.quantize_pack_batch(x3d, seeds, bits, row0=row0)
    return _launch_batch(x3d, rows * LANES, rows * LANES, b, seeds, bits,
                         int(row0))


def qsgd_quantize_pack_batch_flat(flat2d: torch.Tensor, seeds: torch.Tensor,
                                  bits: int, *, row0: int = 0):
    """``qsgd_quantize_pack_batch`` of a flat f32 (B, n) stack over each
    message's zero-padded ``rows = ceil(n/128)`` rows: the same kernel,
    which pads the ragged last rows itself, so the call is one launch."""
    check_bits(bits)
    check_tensor("flat2d", flat2d, torch.float32, (None, None),
                 flat2d.device)
    b, n = flat2d.shape
    seeds = _check_seeds(seeds, b)
    if not on_card(flat2d):
        return _ref.quantize_pack_batch(_ref.rows2d(flat2d), seeds, bits,
                                        row0=row0)
    return _launch_batch(flat2d, n, n, b, seeds, bits, int(row0))


def qsgd_unpack_dequantize(packed: torch.Tensor, norms: torch.Tensor,
                           bits: int, *, eager: bool = False,
                           acc: Optional[torch.Tensor] = None,
                           weight: Optional[torch.Tensor] = None,
                           tap_diff: Optional[torch.Tensor] = None,
                           taps: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Inverse of ``qsgd_quantize_pack``: packed uint8 (rows, 16*bits) +
    norms f32 (rows,) -> f32 (rows, 128). ``eager=True`` scales by
    ``norm / s`` (a true division, the reference's op-by-op decode) in
    place of ``norm * fl32(1/s)`` (its jitted decode).

    With an accumulator ``acc`` of n <= rows*128 values the decode is
    added into it in place, in the same launch, and ``acc`` is returned
    (nothing past its n values is written): ``fma(sign*mag, norm *
    fl32(1/s), acc)``, the decode fused into the add that consumes it, as
    XLA:CPU compiles the round's x-hat + q (``acc`` f32, or bf16 with the
    result rounded to nearest even); with a one-element f32 ``weight`` w
    on the same device, ``fma((sign*mag) * (norm * fl32(1/s)), w, acc)``,
    the decoded value rounded and its weighted add fused, as XLA:CPU
    compiles the round's ``buf + w_k * dec`` (``acc`` f32).

    ``taps`` (with ``acc`` and no weight: the round's x-hat + q), an f32
    (2, ``ref.tap_windows(n)``) tensor, gets in the same launch the level-1
    window sums of the round's two broadcast taps over ``tap_diff`` (the n
    f32 values the codes encode): ``err**2``, err ``fma(-(sign*mag),
    scale, diff)``, and ``q**2``, q the materialized decode
    (``ref.dequantize_taps``)."""
    check_bits(bits)
    rows = packed.shape[0]
    check_tensor("packed", packed, torch.uint8, (None, LANES * bits // 8),
                 packed.device)
    check_tensor("norms", norms, torch.float32, (rows,), packed.device)
    if acc is not None:
        bf16 = weight is None and acc.dtype == torch.bfloat16
        check_tensor("acc", acc, torch.bfloat16 if bf16 else torch.float32,
                     (None,), packed.device)
        if eager or acc.numel() > rows * LANES:
            raise ValueError(f"an accumulator of {acc.numel()} values takes "
                             f"the jitted scale and at most {rows * LANES}")
    if weight is not None:
        if acc is None:
            raise ValueError("a weight needs an accumulator")
        weight = weight.reshape(1)
        check_tensor("weight", weight, torch.float32, (1,), packed.device)
    if (taps is None) != (tap_diff is None):
        raise ValueError("taps and tap_diff go together")
    if taps is not None:
        if acc is None or weight is not None:
            raise ValueError("taps come with the unweighted accumulating "
                             "decode (the round's x-hat + q)")
        n = acc.numel()
        check_tensor("tap_diff", tap_diff, torch.float32, (n,),
                     packed.device)
        check_tensor("taps", taps, torch.float32, (2, _ref.tap_windows(n)),
                     packed.device)
    if not on_card(packed):
        if acc is None:
            return _ref.unpack_dequantize(packed, norms, bits, eager=eager)
        if taps is not None:
            taps.copy_(_ref.dequantize_taps(packed, norms, bits, tap_diff))
        return acc.copy_(_ref.unpack_dequantize(
            packed, norms, bits, acc=acc.to(torch.float32),
            weight=weight).reshape(-1)[:acc.numel()])
    check_aligned("packed", packed)
    if acc is None:
        out = torch.empty((rows, LANES), dtype=torch.float32,
                          device=packed.device)
        mode = 0
    else:
        check_aligned("acc", acc)
        out = acc
        mode = 2 if acc.dtype == torch.bfloat16 else 1
    if taps is not None:
        check_aligned("tap_diff", tap_diff)
    if rows:
        fn = _build.entry("unpack_dequantize")
        _build.check("qsgd_unpack_dequantize", fn(
            packed.data_ptr(), norms.data_ptr(), out.data_ptr(), rows, bits,
            int(eager), 0 if acc is None else acc.numel(),
            None if weight is None else weight.data_ptr(), mode,
            None if taps is None else tap_diff.data_ptr(),
            None if taps is None else taps.data_ptr(),
            0 if taps is None else _ref.tap_windows(acc.numel()),
            0 if taps is None else _ref.tap_front(acc.numel()),
            torch.cuda.current_stream(packed.device).cuda_stream))
        LAUNCHES["qsgd_unpack_dequantize"] += 1
    return out


# ---------------------------------------------------------------------------
# Low-rank sketch basis (counter-hash Rademacher signs)
# ---------------------------------------------------------------------------
#
# Plain PyTorch, as the reference computes these in XLA outside any Pallas
# kernel: uint32 words held in int64 tensors and masked after every add and
# multiply (``ref._mul32``, ``ref._fmix32``). The projection's group sums
# follow XLA:CPU's order (jax 0.9), probed per group size; ``fused=True`` is
# the order inside the reference's jitted client step, ``fused=False`` the
# order of an eager call (the reference's standalone ``encode_flat`` and
# ``qdq_flat``):
#
# * fused, group <= 8, and eager, group <= 32: left to right from +0;
# * fused, group 16 or 32: eight accumulators, accumulator j adding the
#   elements j, j + 8, j + 16, ... in order from +0, then a halving tree
#   (``a[:4] + a[4:]``, ``[:2] + [2:]``, ``[0] + [1]``);
# * group 64 or 128, both: in-order sums of 32 elements from +0, added
#   left to right.
#
# Then one separately rounded product with ``fl32(1/sqrt(group))``. The
# sign flips are exact, so where XLA fuses them into the sums changes no
# bit. ``sketch_expand`` is elementwise, ``(repeat(y) * sign) * scale``.

_SIGN_SALT = 0xB5297A4D  # the signs' salt: never correlated with the dither
_BASIS_SALT = 0x7F4A7C15


def basis_seeds(basis_seed: int, version: int) -> torch.Tensor:
    """The sketch basis seed pair of one round, keyed by the run's basis
    seed and the model version (both as uint32): ``s0 = fmix32(version *
    0x9E3779B9 + basis_seed)``, ``s1 = fmix32(s0 ^ 0x7F4A7C15)``, as an
    int64 (2,) tensor of uint32 words on the CPU."""
    v = torch.tensor(int(version) & _ref.MASK32, dtype=torch.int64)
    s0 = _ref._fmix32((_ref._mul32(v, _ref._GOLDEN)
                       + (int(basis_seed) & _ref.MASK32)) & _ref.MASK32)
    s1 = _ref._fmix32(s0 ^ _BASIS_SALT)
    return torch.stack([s0, s1])


def sketch_signs(seeds, idx: torch.Tensor) -> torch.Tensor:
    """Rademacher +-1 f32 signs of the global element indices ``idx``
    (int64) under ``seeds`` ((2,) or (K, 2) int64 uint32 words; a stack
    gives a (K, len(idx)) result): ``x = fmix32(idx * 0x9E3779B9 + (s0 ^
    0xB5297A4D))``, ``x = fmix32(x ^ s1)``, sign ``1 - 2 * (x & 1)``."""
    seeds = to_device(torch.as_tensor(seeds, dtype=torch.int64), idx.device)
    s0 = (seeds[..., 0:1] & _ref.MASK32) ^ _SIGN_SALT
    s1 = seeds[..., 1:2] & _ref.MASK32
    x = _ref._fmix32((_ref._mul32(idx, _ref._GOLDEN) + s0) & _ref.MASK32)
    x = _ref._fmix32(x ^ s1)
    return 1.0 - 2.0 * (x & 1).to(torch.float32)


def sketch_scale(group: int) -> float:
    """fl32(1/sqrt(group)), the sketch's orthonormal scale."""
    return float(np.float32(1.0 / float(group) ** 0.5))


def _halving_tree(t: torch.Tensor) -> torch.Tensor:
    """(..., w) with w a power of two -> (...,): at width w, lane j < w/2
    adds lane j + w/2, down to one lane."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _group_sums(p: torch.Tensor, fused: bool) -> torch.Tensor:
    """(..., group) -> (...,) in XLA:CPU's order (section comment)."""
    g = p.shape[-1]
    if g > 32:
        return _ref._in_order(torch.stack(
            [_ref._in_order(p[..., w:w + 32]) for w in range(0, g, 32)], -1))
    if not fused or g <= 8:
        return _ref._in_order(p)
    acc = torch.zeros((*p.shape[:-1], 8), dtype=p.dtype, device=p.device)
    for j in range(0, g, 8):
        acc = acc + p[..., j:j + 8]
    return _halving_tree(acc)


def sketch_project(c2d: torch.Tensor, seeds, group: int, *,
                   fused: bool = True) -> torch.Tensor:
    """Project an f32 (B, d_pad) stack onto the sketch subspace, d_pad a
    multiple of ``group``: ``y[b, r] = fl32(1/sqrt(group)) * sum_j
    sign_j * c[b, j]`` over the r-th group of elements, in the order
    ``fused`` names (section comment). Rows of the implied S are
    orthonormal, so ``sketch_expand`` is S^T."""
    b, dpad = c2d.shape
    if dpad % group:
        raise ValueError(f"sketch_project: {dpad} elements are not whole "
                         f"groups of {group}")
    idx = torch.arange(dpad, dtype=torch.int64, device=c2d.device)
    p = (c2d * sketch_signs(seeds, idx)).reshape(b, dpad // group, group)
    return _group_sums(p, fused) * sketch_scale(group)


def sketch_expand(y2d: torch.Tensor, seeds, group: int, offset: int = 0,
                  *, scaled: bool = True) -> torch.Tensor:
    """S^T of an f32 (B, r) subspace stack: (B, r * group) flat elements
    starting at global element ``offset``. ``seeds`` is one (2,) pair or a
    (B, 2) stack, one pair per row. ``scaled=False`` stops before the
    product with ``sketch_scale(group)``."""
    b, r = y2d.shape
    idx = offset + torch.arange(r * group, dtype=torch.int64,
                                device=y2d.device)
    x = torch.repeat_interleave(y2d, group, dim=-1) * sketch_signs(seeds,
                                                                   idx)
    return x * sketch_scale(group) if scaled else x
