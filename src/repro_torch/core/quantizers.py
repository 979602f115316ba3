"""Quantizers and the packed wire format (Definition 2.1 of the paper).

Counterpart of ``repro/core/quantizers.py``, every kind of it:

* ``qsgd`` with bits in 2..8 — stochastic n-bit quantization (Alistarh et
  al., 2017): one sign bit and bits-1 magnitude bits per coordinate,
  s = 2**(bits-1) - 1 levels, one f32 norm per bucket. Unbiased. The wire
  kernels take bits in {2, 4, 8} (8 % bits == 0) and 128-coordinate
  buckets; the in-math ``qdq`` takes any bits and ``bucket_size``.
* ``top_k`` — the k = ceil(fraction * d) largest magnitudes, ties broken
  by index. Biased.
* ``rand_k`` — k uniformly random coordinates (``prng.choice``), scaled by
  d/k when ``scaled`` (unbiased).
* ``lowrank`` — the message sketched onto rank = d_pad / group subspace
  coordinates (a counter-hash Rademacher basis keyed by a seed pair,
  ``kernels.qsgd.sketch_project``), which travel as a bucketed qsgd
  message; the receiver expands them back (S^T). Clients carry the
  sketch's loss forward as an error-feedback residual (``core.qafel``).
* ``identity`` — no compression; QAFeL with identity quantizers is FedBuff.

A message is the whole parameter tree flattened into one f32 vector
(``TreeLayout`` records how to undo it) and encoded in one pass: for qsgd
exactly one quantize-pack launch per message, for lowrank one over its
rank coordinates. Sparse messages are ``{"idx" int32, "vals" f32}`` pairs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.ref import (LANES, fma_f32, rows2d, rows_for,
                                     sqrt_f32, xla_sum)

_KINDS = ("qsgd", "top_k", "rand_k", "identity", "lowrank")


def sparse_k(fraction: float, d: int) -> int:
    """top_k / rand_k: coordinates kept of a d-element message."""
    return max(1, math.ceil(fraction * d))


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Declarative description of a quantizer; hashable."""

    kind: str  # "qsgd" | "top_k" | "rand_k" | "identity" | "lowrank"
    bits: int = 4  # qsgd / lowrank: total bits per coordinate, sign included
    fraction: float = 0.1  # top_k / rand_k: k = ceil(fraction * d)
    scaled: bool = True  # rand_k: the unbiased d/k scaling
    bucket_size: int = 128  # qsgd: one f32 norm per bucket
    # lowrank: elements sketched into one subspace coordinate; divides the
    # bucket row, so each wire row maps to whole subspace coordinates
    group: int = 32

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown quantizer kind: {self.kind}")
        if self.kind in ("qsgd", "lowrank") and not 2 <= self.bits <= 8:
            raise ValueError(f"{self.kind} bits must be in [2, 8]")
        if self.kind in ("top_k", "rand_k") and not 0.0 < self.fraction <= 1.0:
            raise ValueError("fraction must be in (0, 1]")
        if self.kind == "lowrank" and (
                self.group < 2 or self.bucket_size % self.group != 0):
            raise ValueError("lowrank group must be >= 2 and divide the "
                             f"{self.bucket_size}-lane bucket row")

    @property
    def unbiased(self) -> bool:
        if self.kind in ("qsgd", "identity"):
            return True
        if self.kind == "rand_k":
            return self.scaled
        return False  # top_k, lowrank

    @property
    def levels(self) -> int:
        """qsgd: magnitude levels s (one sign bit, bits - 1 magnitude)."""
        return (1 << (self.bits - 1)) - 1

    def rank(self, d: int) -> int:
        """lowrank: subspace dimension of a d-element message, over the
        bucket-row-padded length."""
        if self.kind != "lowrank":
            raise ValueError(f"rank() is lowrank-only (kind={self.kind})")
        d_pad = math.ceil(d / self.bucket_size) * self.bucket_size
        return d_pad // self.group

    def delta(self, d: int) -> float:
        """Compression parameter delta for dimension d (clipped to (0, 1]):
        k/d for the sparse kinds; qsgd's per-bucket worst case (Alistarh et
        al. 2017, Lemma 3.1), divided by the group for lowrank."""
        if self.kind == "identity":
            return 1.0
        if self.kind in ("top_k", "rand_k"):
            return sparse_k(self.fraction, d) / d
        s = self.levels
        b = min(d, self.bucket_size)
        one_minus_delta = min(2 * b / s**2, math.sqrt(2 * b) / s)
        if self.kind == "lowrank":
            return max(1e-6, (1.0 - one_minus_delta) / self.group)
        return max(1e-6, 1.0 - one_minus_delta)

    def wire_bits(self, d: int) -> int:
        """Exact bits on the wire for a d-dimensional message."""
        if self.kind == "identity":
            return 32 * d
        if self.kind == "qsgd":
            return self.bits * d + 32 * math.ceil(d / self.bucket_size)
        if self.kind == "lowrank":
            # a bucketed qsgd message over the rank coordinates; the basis
            # never ships (both sides derive it from the seed)
            r = self.rank(d)
            return self.bits * r + 32 * math.ceil(r / self.bucket_size)
        return 64 * sparse_k(self.fraction, d)  # a 32-bit index and a 32-bit value per kept

    def label(self) -> str:
        if self.kind == "identity":
            return "identity"
        if self.kind == "qsgd":
            return f"qsgd{self.bits}b"
        if self.kind == "lowrank":
            return f"lowrank{self.bits}g{self.group}"
        return f"{self.kind}{self.fraction:g}"


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """A parameter tree flattened into one vector: the structure and, in
    JAX leaf order, each leaf's shape, dtype name and size."""

    treedef: Any
    shapes: tuple
    dtypes: tuple  # dtype names, e.g. "float32"
    sizes: tuple

    @property
    def total_size(self) -> int:
        return sum(self.sizes)

    @staticmethod
    def of(tree) -> "TreeLayout":
        leaves, treedef = tree_flatten(tree)
        return TreeLayout(
            treedef=treedef,
            shapes=tuple(tuple(x.shape) for x in leaves),
            dtypes=tuple(str(x.dtype).replace("torch.", "") for x in leaves),
            sizes=tuple(int(x.numel()) for x in leaves))

    def unflatten(self, flat: torch.Tensor):
        """Split a flat vector (a tensor or a ``SplitFlat``) back into the
        tree (views where the dtype already matches)."""
        leaves, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(flat[off:off + size].reshape(shape).to(
                getattr(torch, dtype)))
            off += size
        return tree_unflatten(self.treedef, leaves)


class SplitFlat:
    """A flat vector in a ``TreeLayout``'s coordinates held in two parts:
    ``base``, every coordinate in the tree's main dtype, and each leaf of
    another dtype as a flat tensor of its own (``sides``: {offset:
    tensor}), whose slots in ``base`` only shadow it. A slice lies in one
    leaf and reads it in that leaf's dtype, which is all that
    ``TreeLayout.unflatten`` and ``core.qafel.DeltaRows`` take of it: the
    x-hat a mixed-dtype round state hands its clients
    (``distributed.steps``)."""

    def __init__(self, base: torch.Tensor, sides: dict):
        self.base = base
        self.sides = sorted((off, off + t.numel(), t)
                            for off, t in sides.items())

    @property
    def device(self) -> torch.device:
        return self.base.device

    def numel(self) -> int:
        return self.base.numel()

    def __getitem__(self, sl: slice) -> torch.Tensor:
        a = 0 if sl.start is None else sl.start
        b = self.base.numel() if sl.stop is None else sl.stop
        for off, end, t in self.sides:
            if off <= a < end and b <= end:
                return t[a - off:b - off]
            if a < end and off < b:
                raise ValueError(f"elements [{a}, {b}) cross the side leaf "
                                 f"[{off}, {end})")
        return self.base[a:b]


def flatten_tree(tree, device=None):
    """Concatenate the leaves (JAX order) into one flat f32 vector on
    ``device`` (None: the leaves'), each leaf converted as it is copied in
    (no f32 copy of the whole tree besides the result); returns (flat,
    layout)."""
    layout = TreeLayout.of(tree)
    leaves = tree_flatten(tree)[0]
    flat = torch.empty(layout.total_size, dtype=torch.float32,
                       device=leaves[0].device if device is None else device)
    off = 0
    for x, size in zip(leaves, layout.sizes):
        flat[off:off + size].copy_(x.reshape(-1))
        off += size
    return flat, layout


def packed_qsgd_payload(packed, norms, bits: int, n: int,
                        layout: TreeLayout) -> dict:
    """The packed qsgd wire-payload schema (uploads and broadcasts)."""
    return {"format": "packed", "kind": "qsgd", "packed": packed,
            "norms": norms, "bits": bits, "n": n, "layout": layout}


def packed_identity_payload(flat, n: int, layout: TreeLayout) -> dict:
    """The packed identity (full-precision) wire-payload schema."""
    return {"format": "packed", "kind": "identity", "payload": flat,
            "n": n, "layout": layout}


def packed_lowrank_payload(packed, norms, bits: int, n: int,
                           layout: TreeLayout, rank: int, group: int,
                           seed) -> dict:
    """The lowrank wire-payload schema: a qsgd message over the ``rank``
    subspace coordinates, with the sketch ``group`` and the (2,) basis
    ``seed`` (int64 uint32 words) it was projected with, so a receiver
    decodes it with no other state."""
    return {"format": "packed", "kind": "lowrank", "packed": packed,
            "norms": norms, "bits": bits, "n": n, "layout": layout,
            "rank": rank, "group": group, "seed": seed}


def sparse_payload(kind: str, idx, vals, n: int, layout: TreeLayout) -> dict:
    """The top_k / rand_k wire-payload schema: int32 indices, f32 values."""
    return {"format": "packed", "kind": kind, "idx": idx.to(torch.int32),
            "vals": vals, "n": n, "layout": layout}


def seed_pair(seed) -> torch.Tensor:
    """A basis seed (or key) as an int64 (2,) CPU tensor of uint32 words."""
    return torch.as_tensor(np.asarray(prng.key_words(seed), np.int64))


def lowrank_project_flat2d(flat2d: torch.Tensor, seeds, group: int, *,
                           fused: bool = True) -> torch.Tensor:
    """Sketch-project a (B, n) stack to its (B, rank) subspace
    coordinates: zero-pad n to whole 128-lane rows, then
    ``kernels.qsgd.sketch_project`` in the order ``fused`` names."""
    from repro_torch.kernels import qsgd as _kq

    return _kq.sketch_project(rows2d(flat2d).reshape(flat2d.shape[0], -1),
                              seeds, group, fused=fused)


def lowrank_expand_flat2d(y2d: torch.Tensor, seeds, group: int, n,
                          offset: int = 0, *,
                          scaled: bool = True) -> torch.Tensor:
    """Expand a (B, r) subspace stack back to flat coordinates, sliced to
    ``n`` (None keeps the padded width); ``seeds`` one pair or one per
    row. ``scaled=False`` leaves out the last product with
    fl32(1/sqrt(group)), for a caller that fuses it into its own sum."""
    from repro_torch.kernels import qsgd as _kq

    x = _kq.sketch_expand(y2d, seeds, group, offset, scaled=scaled)
    return x if n is None else x[:, :n]


def _f32_tensor(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to f32, as a 0-dim tensor on ``like``'s device
    (an f32 multiply on every device, as XLA has a Python float)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)


def _bucket_sq_sums(xp: torch.Tensor) -> torch.Tensor:
    """Per-row sums of squares of an f32 (rows, b) array in XLA:CPU's
    order for ``jnp.linalg.norm(axis=1)`` (jax 0.9): for b <= 32 in order
    from +0, each square fused into its add (an FMA) except for
    5 <= b <= 8, where product and add round apart; above 32 the squares
    round apart and are summed by ``ref.xla_sum`` (windows of 32 with the
    padding split evenly, recursively; at b = 128 the wire kernels' four
    partials)."""
    b = xp.shape[1]
    if b > 32 or 5 <= b <= 8:
        return xla_sum(xp * xp)
    acc = torch.zeros(xp.shape[0], dtype=torch.float32, device=xp.device)
    for j in range(b):
        acc = fma_f32(xp[:, j], xp[:, j], acc)
    return acc


def _qsgd_qdq_flat(x: torch.Tensor, key, bits: int,
                   bucket: int = LANES, *,
                   reciprocal: bool = False) -> torch.Tensor:
    """The reference's in-math qsgd quantize-dequantize of a flat vector
    (``repro.core.quantizers._qsgd_qdq_flat``) with its rounding on
    XLA:CPU: buckets of ``bucket`` elements (the last zero-padded), their
    norms in ``_bucket_sq_sums``' order, ``level = |x| * (s / safe)`` and
    ``recon = (sign * xi) * (safe / s)`` with both quotients true
    divisions, the dither ``uniform(key, (rows, bucket))``.
    ``reciprocal`` takes ``safe * fl32(1/s)`` for ``safe / s``, as XLA
    rewrites the division by the constant s where it compiles the
    function into a larger program (the distributed round's x-hat
    apply)."""
    n = x.numel()
    xf = x.to(torch.float32)
    pad = (-n) % bucket
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xp = xf.reshape(-1, bucket)
    norm = sqrt_f32(_bucket_sq_sums(xp))[:, None]
    safe = torch.clamp(norm, min=1e-30)
    s = torch.full_like(safe, float((1 << (bits - 1)) - 1))
    level = xp.abs() * (s / safe)
    low = torch.floor(level)
    u = prng.uniform(key, tuple(xp.shape), device=xp.device)
    xi = torch.clamp(low + (u < level - low).to(torch.float32), max=s)
    recon = torch.sign(xp) * xi * (
        safe * float(np.float32(1.0 / float(s[0, 0]))) if reciprocal
        else safe / s)
    recon = torch.where(norm > 0, recon, torch.zeros_like(xp))
    return recon.reshape(-1)[:n].to(x.dtype)


def _top_k_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest magnitudes' indices, ties broken by index (the
    reference's stable ``argsort(-|x|)``); works along the last axis."""
    return torch.argsort(-flat.abs(), dim=-1, stable=True)[..., :k]


def _top_k_qdq_flat(x: torch.Tensor, k: int) -> torch.Tensor:
    xf = x.to(torch.float32)
    mask = torch.zeros_like(xf, dtype=torch.bool)
    mask[_top_k_indices(xf, k)] = True
    return torch.where(mask, xf, torch.zeros_like(xf)).to(x.dtype)


def _rand_k_qdq_flat(x: torch.Tensor, key, k: int,
                     scaled: bool) -> torch.Tensor:
    xf = x.to(torch.float32)
    d = xf.numel()
    mask = torch.zeros_like(xf, dtype=torch.bool)
    mask[prng.choice(key, d, k, device=xf.device)] = True
    out = torch.where(mask, xf, torch.zeros_like(xf))
    if scaled:
        out = out * _f32_tensor(d / k, out)
    return out.to(x.dtype)


def qsgd_encode_rows(x3d: torch.Tensor, seeds, bits: int, row_off: int, *,
                     chunk_rows=None):
    """Counter-hash quantize-pack of an f32 (B, R, 128) row block whose
    first row is wire row ``row_off`` of its messages: K2 with that row
    offset, so any tiling of the rows emits the whole message's wire bits.
    ``chunk_rows`` encodes ``chunk_rows`` rows at a time
    (``kernels.ops.qsgd_encode_chunks``; the tail chunk as it is: the
    reference pads it with zero rows, which encode to zero codes and are
    sliced off). ``seeds`` is the (B, 2) word stack.
    Returns ``(packed (B, R, 16*bits), norms (B, R))``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import qsgd as _kq

    b, rows = x3d.shape[0], x3d.shape[1]
    if chunk_rows is None or chunk_rows >= rows:
        return _kq.qsgd_quantize_pack_batch(x3d.contiguous(), seeds, bits,
                                            row0=row_off)
    return kops.qsgd_quantize_rows(
        lambda a, e: x3d[:, a // LANES:e // LANES].reshape(b, -1),
        rows * LANES, seeds, bits, chunk_rows, device=x3d.device, b=b,
        threefry=False, row0=row_off)


def qsgd_encode_flat2d(flat2d: torch.Tensor, keys, bits: int, *,
                       threefry: bool = False, chunk_rows=None):
    """Quantize-pack a (B, n) stack in wire layout.

    ``threefry=True`` (B == 1, ``keys`` one key) is the single-message
    convention: the dither is ``uniform(key, (rows, 128))``, the sequential
    engine's upload. ``threefry=False`` (``keys`` a (B, 2) stack) is the
    batched counter-hash convention of the broadcast encode.

    ``chunk_rows`` encodes ``chunk_rows`` wire rows at a time, each chunk
    keyed by its global row offset (K1 or K2 with a row offset): the codes
    are the unchunked encode's bit for bit at any chunk size.

    Returns ``(packed uint8 (B, rows, 16*bits), norms f32 (B, rows))``.
    """
    from repro_torch.kernels import ops as kops

    b, n = flat2d.shape
    if threefry and b != 1:
        raise ValueError("threefry dither is the single-message path; "
                         f"got B={b}")
    if chunk_rows is not None and chunk_rows < rows_for(n):
        return kops.qsgd_quantize_rows(lambda a, e: flat2d[:, a:e], n, keys,
                                       bits, chunk_rows, device=flat2d.device,
                                       b=b, threefry=threefry)
    if threefry:
        packed, norms = kops.qsgd_quantize(flat2d[0], keys, bits)
        return packed[None], norms[None]
    return kops.qsgd_quantize_batch(flat2d, keys, bits)


@dataclasses.dataclass(frozen=True)
class Quantizer:
    spec: QuantizerSpec

    # ---- in-math quantize-dequantize -----------------------------------
    def qdq_leaf(self, x: torch.Tensor, key) -> torch.Tensor:
        """Quantize-dequantize one array (any shape). lowrank has no
        per-leaf form (its basis spans the whole message): ``qdq_flat``."""
        spec = self.spec
        if spec.kind == "identity":
            return x
        if spec.kind == "lowrank":
            raise ValueError("lowrank quantizes whole flat messages: use "
                             "qdq_flat")
        flat = x.reshape(-1)
        if spec.kind == "qsgd":
            out = _qsgd_qdq_flat(flat, key, spec.bits, spec.bucket_size)
        elif spec.kind == "top_k":
            out = _top_k_qdq_flat(flat, sparse_k(spec.fraction, flat.numel()))
        else:
            out = _rand_k_qdq_flat(flat, key,
                                   sparse_k(spec.fraction, flat.numel()),
                                   spec.scaled)
        return out.reshape(x.shape)

    def qdq(self, tree, key):
        """Quantize-dequantize a tree leaf by leaf, leaf i with key i of
        ``split(key, leaves)`` in JAX leaf order, as the reference's
        ``qdq`` draws them (its in-math path, not the wire's one message
        per tree)."""
        if self.spec.kind == "identity":
            return tree
        leaves, treedef = tree_flatten(tree)
        keys = prng.split(key, len(leaves))
        return tree_unflatten(treedef, [self.qdq_leaf(x, k)
                                        for x, k in zip(leaves, keys)])

    def qdq_flat(self, flat: torch.Tensor, key) -> torch.Tensor:
        """Quantize-dequantize one flat vector. qsgd honours
        ``bucket_size``; lowrank projects under the basis seed of the
        key's words, quantize-dequantizes the subspace vector with the
        same key and expands it (the reference's eager order)."""
        spec = self.spec
        if spec.kind == "identity":
            return flat
        if spec.kind == "qsgd":
            return _qsgd_qdq_flat(flat, key, spec.bits, spec.bucket_size)
        if spec.kind == "lowrank":
            seeds = seed_pair(key)
            n = int(flat.numel())
            y = lowrank_project_flat2d(flat[None], seeds, spec.group,
                                       fused=False)
            yq = _qsgd_qdq_flat(y[0], key, spec.bits, spec.bucket_size)
            return lowrank_expand_flat2d(yq[None], seeds, spec.group, n)[0]
        k = sparse_k(spec.fraction, flat.numel())
        if spec.kind == "top_k":
            return _top_k_qdq_flat(flat, k)
        return _rand_k_qdq_flat(flat, key, k, spec.scaled)

    # ---- wire format ----------------------------------------------------
    def encode(self, tree, key) -> dict:
        """Encode a whole tree as one packed message (``encode_flat`` of
        its flat vector)."""
        flat, layout = flatten_tree(tree)
        return self.encode_flat(flat, layout, key)

    def encode_flat(self, flat: torch.Tensor, layout: TreeLayout,
                    key) -> dict:
        """Encode one flat f32 vector as a packed wire message: qsgd with
        the threefry dither (K1); lowrank under the basis seed of the
        key's words (``encode_lowrank_flat``); top_k / rand_k as index /
        value pairs, rand_k's indices ``prng.choice(key, n, k)`` and its
        values times fl32(n/k) when ``scaled``."""
        spec = self.spec
        n = int(flat.numel())
        if spec.kind == "identity":
            return packed_identity_payload(flat, n, layout)
        if spec.kind == "qsgd":
            packed, norms = qsgd_encode_flat2d(flat[None], key, spec.bits,
                                               threefry=True)
            return packed_qsgd_payload(packed[0], norms[0], spec.bits, n,
                                       layout)
        if spec.kind == "lowrank":
            return self.encode_lowrank_flat(flat, layout, key,
                                            seed_pair(key))
        k = sparse_k(spec.fraction, n)
        if spec.kind == "top_k":
            idx = _top_k_indices(flat, k)
            vals = flat[idx]
        else:
            idx = prng.choice(key, n, k, device=flat.device)
            vals = flat[idx]
            if spec.scaled:
                vals = vals * _f32_tensor(n / k, vals)
        return sparse_payload(spec.kind, idx, vals, n, layout)

    def encode_lowrank_flat(self, flat: torch.Tensor, layout: TreeLayout,
                            key, basis_seed) -> dict:
        """Lowrank wire encode of one flat vector under the basis seed
        pair ``basis_seed``: project (in the order of the reference's
        eager call), then K1 over the rank coordinates with the threefry
        dither of ``key``."""
        spec = self.spec
        n = int(flat.numel())
        seeds = seed_pair(basis_seed)
        y = lowrank_project_flat2d(flat[None], seeds, spec.group,
                                   fused=False)
        packed, norms = qsgd_encode_flat2d(y, key, spec.bits, threefry=True)
        return packed_lowrank_payload(packed[0], norms[0], spec.bits, n,
                                      layout, int(y.shape[1]), spec.group,
                                      seeds)

    def encode_batch(self, stacked_tree, keys) -> list:
        """Encode B stacked deltas (leaves with a leading B axis) as B
        packed messages: qsgd in one K2 launch (the counter-hash dither
        keyed by each message's key; B == 1 is ``encode``, the threefry
        one), top_k by one row-wise sort, rand_k with each message's own
        ``prng.choice``. lowrank encodes ride the client step, which holds
        the round's basis seed."""
        leaves, treedef = tree_flatten(stacked_tree)
        if not leaves:
            raise ValueError("encode_batch needs a non-empty tree")
        b = int(leaves[0].shape[0])
        keys = torch.as_tensor(keys)
        first = tree_unflatten(treedef, [x[0] for x in leaves])
        if b == 1:
            return [self.encode(first, keys[0])]
        spec = self.spec
        layout = TreeLayout.of(first)
        flat2d = torch.cat([x.reshape(b, -1).to(torch.float32)
                            for x in leaves], dim=1)
        n = int(flat2d.shape[1])
        if spec.kind == "identity":
            return [packed_identity_payload(flat2d[i], n, layout)
                    for i in range(b)]
        if spec.kind == "qsgd":
            packed, norms = qsgd_encode_flat2d(
                flat2d, keys.reshape(b, -1)[:, :2], spec.bits)
            return [packed_qsgd_payload(packed[i], norms[i], spec.bits, n,
                                        layout) for i in range(b)]
        if spec.kind == "lowrank":
            raise ValueError(
                "lowrank cohort encodes ride the client step "
                "(kernels.ops.cohort_train_encode_step): the basis seed is "
                "round state that encode_batch does not carry")
        k = sparse_k(spec.fraction, n)
        if spec.kind == "top_k":
            idx = _top_k_indices(flat2d, k)
            vals = torch.gather(flat2d, 1, idx)
        else:
            idx = torch.stack([prng.choice(kk, n, k, device=flat2d.device)
                               for kk in keys])
            vals = torch.gather(flat2d, 1, idx)
            if spec.scaled:
                vals = vals * _f32_tensor(n / k, vals)
        return [sparse_payload(spec.kind, idx[i], vals[i], n, layout)
                for i in range(b)]

    def decode_flat(self, enc) -> torch.Tensor:
        """Decode a packed message to its flat f32 vector: K3 for qsgd and
        for lowrank's rank coordinates (then the sketch's expand), a
        scatter of the kept values for top_k / rand_k."""
        from repro_torch.kernels import ops as kops

        kind = enc["kind"]
        if kind == "identity":
            return enc["payload"]
        if kind == "qsgd":
            return kops.qsgd_dequantize(enc["packed"], enc["norms"],
                                        enc["bits"], enc["n"])
        if kind == "lowrank":
            y = kops.qsgd_dequantize(enc["packed"], enc["norms"],
                                     enc["bits"], enc["rank"])
            return lowrank_expand_flat2d(y[None], enc["seed"], enc["group"],
                                         enc["n"])[0]
        vals = enc["vals"]
        out = torch.zeros(enc["n"], dtype=torch.float32, device=vals.device)
        out[enc["idx"].to(torch.int64)] = vals
        return out

    def decode(self, enc):
        """Decode a packed message to its tree."""
        return enc["layout"].unflatten(self.decode_flat(enc))

    def wire_bytes_packed(self, layout: TreeLayout) -> float:
        """Exact bytes on the wire: the whole tree is one d-element
        message (bucket norms shared across leaf boundaries)."""
        return self.spec.wire_bits(layout.total_size) / 8.0


def make_quantizer(spec_or_name) -> Quantizer:
    """A Quantizer from a spec or a name: "qsgd4", "qsgd8", "top_k0.1",
    "rand_k0.05", "lowrank", "lowrank4g32" (``lowrank<bits>[g<group>]``),
    "identity"."""
    if isinstance(spec_or_name, Quantizer):
        return spec_or_name
    if isinstance(spec_or_name, QuantizerSpec):
        return Quantizer(spec_or_name)
    name = spec_or_name
    if name is None or name == "identity":
        return Quantizer(QuantizerSpec("identity"))
    if name.startswith("lowrank"):
        bits_s, _, group_s = name[len("lowrank"):].partition("g")
        return Quantizer(QuantizerSpec("lowrank", bits=int(bits_s or 4),
                                       group=int(group_s or 32)))
    if name.startswith("qsgd"):
        return Quantizer(QuantizerSpec("qsgd",
                                       bits=int(name[len("qsgd"):] or 4)))
    for kind in ("top_k", "rand_k"):
        if name.startswith(kind):
            return Quantizer(QuantizerSpec(
                kind, fraction=float(name[len(kind):] or 0.1)))
    raise ValueError(f"unknown quantizer: {name!r}")
