"""Quantizers and the packed wire format (Definition 2.1 of the paper).

Counterpart of ``repro/core/quantizers.py`` for the two kinds on the main
path:

* ``qsgd`` with bits in {2, 4, 8} — stochastic n-bit quantization
  (Alistarh et al., 2017): one sign bit and bits-1 magnitude bits per
  coordinate, s = 2**(bits-1) - 1 levels, one f32 norm per 128-coordinate
  bucket. Unbiased.
* ``identity`` — no compression; QAFeL with identity quantizers is FedBuff.

A message is the whole parameter tree flattened into one f32 vector
(``TreeLayout`` records how to undo it) and encoded in one pass: for qsgd
exactly one quantize-pack launch per message.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.common import prng
from repro_torch.common.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.ref import bucket_norms, levels, rows2d

_KINDS = ("qsgd", "identity")


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Declarative description of a quantizer; hashable."""

    kind: str  # "qsgd" | "identity"
    bits: int = 4  # qsgd: total bits per coordinate, sign included
    bucket_size: int = 128  # one f32 norm per 128 coordinates

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"quantizer kind {self.kind!r} is not in the "
                             f"port (it has {_KINDS})")
        if self.kind == "qsgd" and self.bits not in (2, 4, 8):
            raise ValueError(f"packed qsgd needs bits in (2, 4, 8), "
                             f"got {self.bits}")

    def wire_bits(self, d: int) -> int:
        """Exact bits on the wire for a d-dimensional message."""
        if self.kind == "identity":
            return 32 * d
        return self.bits * d + 32 * math.ceil(d / self.bucket_size)

    def label(self) -> str:
        return "identity" if self.kind == "identity" else f"qsgd{self.bits}b"


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
        """Split a flat vector back into the tree (views where the dtype
        already matches)."""
        leaves, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(flat[off:off + size].reshape(shape).to(
                getattr(torch, dtype)))
            off += size
        return tree_unflatten(self.treedef, leaves)


def flatten_tree(tree, device=None):
    """Concatenate the leaves (JAX order) into one flat f32 vector;
    returns (flat, layout)."""
    layout = TreeLayout.of(tree)
    leaves = tree_flatten(tree)[0]
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    return (flat if device is None else flat.to(device)), layout


def packed_qsgd_payload(packed, norms, bits: int, n: int,
                        layout: TreeLayout) -> dict:
    """The packed qsgd wire-payload schema (uploads and broadcasts)."""
    return {"format": "packed", "kind": "qsgd", "packed": packed,
            "norms": norms, "bits": bits, "n": n, "layout": layout}


def packed_identity_payload(flat, n: int, layout: TreeLayout) -> dict:
    """The packed identity (full-precision) wire-payload schema."""
    return {"format": "packed", "kind": "identity", "payload": flat,
            "n": n, "layout": layout}


def _qsgd_qdq_flat(x: torch.Tensor, key, bits: int) -> torch.Tensor:
    """The reference's in-math qsgd quantize-dequantize of a flat vector
    (``repro.core.quantizers._qsgd_qdq_flat``) with its rounding on
    XLA:CPU: the bucket norms of the wire kernels (``ref.bucket_norms``),
    ``level = |x| * (s / safe)`` and ``recon = (sign * xi) * (safe / s)``
    with both quotients true divisions, the dither ``uniform(key,
    (rows, 128))``."""
    n = x.numel()
    xp = rows2d(x.to(torch.float32))
    norm = bucket_norms(xp)[:, None]
    safe = torch.clamp(norm, min=1e-30)
    s = torch.full_like(safe, float(levels(bits)))
    level = xp.abs() * (s / safe)
    low = torch.floor(level)
    u = prng.uniform(key, tuple(xp.shape), device=xp.device)
    xi = torch.clamp(low + (u < level - low).to(torch.float32), max=s)
    recon = torch.sign(xp) * xi * (safe / s)
    recon = torch.where(norm > 0, recon, torch.zeros_like(xp))
    return recon.reshape(-1)[:n].to(x.dtype)


def qsgd_encode_flat2d(flat2d: torch.Tensor, keys, bits: int, *,
                       threefry: bool = False):
    """Quantize-pack a (B, n) stack in wire layout.

    ``threefry=True`` (B == 1, ``keys`` one key) is the single-message
    convention: the dither is ``uniform(key, (rows, 128))``, the sequential
    engine's upload. ``threefry=False`` (``keys`` a (B, 2) stack) is the
    batched counter-hash convention of the broadcast encode.

    Returns ``(packed uint8 (B, rows, 16*bits), norms f32 (B, rows))``.
    """
    from repro_torch.kernels import ops as kops

    if threefry:
        if flat2d.shape[0] != 1:
            raise ValueError("threefry dither is the single-message path; "
                             f"got B={flat2d.shape[0]}")
        packed, norms = kops.qsgd_quantize(flat2d[0], keys, bits)
        return packed[None], norms[None]
    return kops.qsgd_quantize_batch(flat2d, keys, bits)


@dataclasses.dataclass(frozen=True)
class Quantizer:
    spec: QuantizerSpec

    def encode_flat(self, flat: torch.Tensor, layout: TreeLayout,
                    key) -> dict:
        """Encode one flat f32 vector as a packed wire message (threefry
        dither for qsgd)."""
        n = int(flat.numel())
        if self.spec.kind == "identity":
            return packed_identity_payload(flat, n, layout)
        packed, norms = qsgd_encode_flat2d(flat[None], key, self.spec.bits,
                                           threefry=True)
        return packed_qsgd_payload(packed[0], norms[0], self.spec.bits, n,
                                   layout)

    def decode_flat(self, enc) -> torch.Tensor:
        """Dequantize a packed message to its flat f32 vector."""
        from repro_torch.kernels import ops as kops

        if enc["kind"] == "identity":
            return enc["payload"]
        return kops.qsgd_dequantize(enc["packed"], enc["norms"], enc["bits"],
                                    enc["n"])

    def qdq_leaf(self, x: torch.Tensor, key) -> torch.Tensor:
        """Quantize-dequantize one array (any shape)."""
        if self.spec.kind == "identity":
            return x
        return _qsgd_qdq_flat(x.reshape(-1), key, self.spec.bits).reshape(
            x.shape)

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

    def wire_bytes_packed(self, layout: TreeLayout) -> float:
        """Exact bytes on the wire: the whole tree is one d-element
        message (bucket norms shared across leaf boundaries)."""
        return self.spec.wire_bits(layout.total_size) / 8.0


def make_quantizer(spec_or_name) -> Quantizer:
    """A Quantizer from a spec or a name: "qsgd4", "qsgd8", "identity"."""
    if isinstance(spec_or_name, Quantizer):
        return spec_or_name
    if isinstance(spec_or_name, QuantizerSpec):
        return Quantizer(spec_or_name)
    name = spec_or_name
    if name is None or name == "identity":
        return Quantizer(QuantizerSpec("identity"))
    if name.startswith("qsgd"):
        return Quantizer(QuantizerSpec("qsgd",
                                       bits=int(name[len("qsgd"):] or 4)))
    raise ValueError(f"quantizer {name!r} is not in the port "
                     "(qsgd<bits> and identity are)")
