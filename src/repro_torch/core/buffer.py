"""Server-side update buffer (the "Buff" in FedBuff/QAFeL, Algorithm 1).

Counterpart of ``repro/core/buffer.py``, packed mode. The K uploads of a
window are stored as they arrived on the wire — uint8 qsgd codes + bucket
norms, stacked at flush time; lowrank's codes over the rank coordinates
with each upload's basis seed pair; top_k / rand_k index / value pairs —
or, for identity uploads (f32 on the wire), folded into one flat weighted
sum. A qsgd upload streamed in row chunks is validated and reassembled
(``assemble_chunks``) and stored like any other. Uploads the server
decoded on arrival (a bit-width tier's, ``add_decoded_flat``) fold into a
second flat sum. ``drain()`` hands the window's raw ingredients to the
server flush, which dequantizes inside its fused aggregate launch (qsgd)
or expands each upload (lowrank), and resets the buffer; the sparse pairs
are scatter-added into the flat ``extra``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.core.quantizers import (Quantizer, TreeLayout,
                                         packed_qsgd_payload)


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
    # lowrank windows: the stack holds rank-length subspace pairs, and each
    # upload has its own basis seed pair (a window spans model versions)
    kind: Optional[str] = None  # upload kind of the stacked pairs
    seeds: Any = None  # (K, 2) int64 uint32 words per upload, or None
    rank: Optional[int] = None  # subspace dimension of the stacked pairs
    group: Optional[int] = None  # sketch group (rank = padded n / group)

    def reduce(self) -> torch.Tensor:
        """The window's flat Delta-bar outside the fused flush (the
        non-fused flush chain): K4 for a qsgd stack, the expanded lowrank
        window in the reference's op-by-op order, plus ``extra`` in
        front."""
        from repro_torch.kernels import ops as kops

        if self.stack is None:
            return self.extra
        if self.kind == "lowrank":
            flat = kops.lowrank_window_delta(
                self.stack, self.norms, self.weights, self.seeds,
                bits=self.bits, group=self.group, n=self.n, eager=True)
        else:
            flat = kops.buffer_aggregate(self.stack, self.norms,
                                         self.weights, self.bits, self.n)
        return flat if self.extra is None else self.extra + flat


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
    # lowrank: each upload's (2,) basis seed pair and the window's shape
    _seeds: List[Any] = dataclasses.field(default_factory=list)
    _rank: Optional[int] = None
    _group: Optional[int] = None

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
        from repro_torch.kernels import ops as kops
        if kind == "qsgd":
            if enc["norms"].shape[0] != kops.rows_for(enc["n"]):
                raise ValueError("corrupt qsgd message: norms/rows mismatch")
        if kind == "lowrank":
            spec = self.quantizer.spec
            if enc.get("group") != spec.group:
                raise ValueError(f"lowrank sketch group mismatch: "
                                 f"{enc.get('group')} != {spec.group}")
            if enc.get("rank") != spec.rank(enc["n"]):
                raise ValueError(f"corrupt lowrank message: rank "
                                 f"{enc.get('rank')} != {spec.rank(enc['n'])}")
            if enc["norms"].shape[0] != kops.rows_for(enc["rank"]):
                raise ValueError("corrupt lowrank message: norms/rows "
                                 "mismatch over the rank-length payload")
            seed = torch.as_tensor(enc["seed"]).reshape(-1)
            if seed.shape[0] != 2:
                raise ValueError("corrupt lowrank message: basis seed must "
                                 "be a (2,) pair")
            if self._rank is not None and enc["rank"] != self._rank:
                raise ValueError(f"lowrank rank mismatch: {enc['rank']} != "
                                 f"{self._rank}")
        if self._layout is None:
            self._layout, self._n = enc["layout"], enc["n"]
        if self._bits is None:
            self._bits = enc.get("bits")
        if kind in ("qsgd", "lowrank"):
            self._packed.append((enc["packed"], enc["norms"]))
            if kind == "lowrank":
                self._seeds.append(seed.to(torch.int64).cpu())
                self._rank, self._group = enc["rank"], enc["group"]
        elif kind == "identity":  # f32 on the wire: one weighted sum
            term = enc["payload"] * weight
            self._flat_acc = (term if self._flat_acc is None
                              else self._flat_acc + term)
        else:  # top_k / rand_k: the pairs as they arrived
            self._packed.append((enc["idx"], enc["vals"]))
        self._weightsum += float(weight)
        self._weights.append(float(weight))
        self.count += 1

    def assemble_chunks(self, chunks: List[dict]) -> dict:
        """The packed qsgd payload (``quantizers.packed_qsgd_payload``) of
        one upload that arrived as streamed row chunks
        (``protocol.packed_qsgd_chunk_payload``), in any order, after
        validating the whole set; the buffer is not changed. The chunks
        must be packed_chunk payloads into a qsgd buffer, of one layout, n
        and bits (the window's, if it has uploads), whose rows cover
        ``[0, rows_for(n))`` without gap or overlap."""
        if not chunks:
            raise ValueError("empty chunk stream")
        from repro_torch.kernels import ops as kops
        first = chunks[0]
        if any(ch.get("format") != "packed_chunk" for ch in chunks):
            raise ValueError("add_encoded_chunks expects packed_chunk "
                             "payloads (protocol.packed_qsgd_chunk_payload)")
        if first["kind"] != "qsgd" or self.quantizer.spec.kind != "qsgd":
            raise ValueError("chunk streaming is defined for qsgd uploads "
                             f"(got {first['kind']!r} into a "
                             f"{self.quantizer.spec.kind!r} buffer)")
        for ch in chunks[1:]:
            if (ch["layout"] != first["layout"] or ch["n"] != first["n"]
                    or ch["bits"] != first["bits"]):
                raise ValueError("inconsistent chunk stream: all chunks "
                                 "must share one layout, n and bits")
        if self._layout is not None:
            if first["layout"] != self._layout:
                raise ValueError("message layout mismatch: all buffered "
                                 "uploads must encode the same tree")
            if self._bits is not None and first["bits"] != self._bits:
                raise ValueError(f"message bits mismatch: {first['bits']} "
                                 f"!= {self._bits}")
        rows = kops.rows_for(first["n"])
        ordered = sorted(chunks, key=lambda ch: ch["row0"])
        cover = 0
        for ch in ordered:
            if ch["row0"] != cover:
                raise ValueError(f"chunk stream has a gap or overlap at row "
                                 f"{cover} (next chunk starts at "
                                 f"{ch['row0']})")
            if ch["norms"].shape[0] != ch["rows"] or ch["rows"] <= 0:
                raise ValueError("corrupt chunk: rows/norms mismatch")
            cover += ch["rows"]
        if cover != rows:
            raise ValueError(f"chunk stream covers {cover} rows, the "
                             f"message needs {rows}")
        return packed_qsgd_payload(
            torch.cat([ch["packed"] for ch in ordered]),
            torch.cat([ch["norms"] for ch in ordered]), first["bits"],
            first["n"], first["layout"])

    def add_encoded_chunks(self, chunks: List[dict],
                           weight: float = 1.0) -> None:
        """Store one qsgd upload that arrived as streamed row chunks, in
        any order: validated and assembled (``assemble_chunks``) before any
        state changes, then stored as ``add_encoded`` stores an upload, so
        the flush cannot tell them apart."""
        self.add_encoded(self.assemble_chunks(chunks), weight=weight)

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
        self._seeds, self._rank, self._group = [], None, None
        self._weightsum = 0.0
        self.count = 0
        self.flushes += 1

    def drain(self) -> FlushBatch:
        """Hand the window's raw ingredients to the flush, and reset. The
        weights are divided by K (Algorithm 1 line 11, the reference's
        ``normalize="capacity"``) as ``f32(w) / f32(K)``. Sparse pairs are
        scatter-added from zeros in arrival order, each as ``vals *
        fl32(w / K)`` (indices are unique within a message, so one
        ``index_add_`` per message is the reference's ``.at[idx].add``);
        the identity sum divided by K is added behind them; the decoded
        sum is scaled by ``fl32(1/K)`` and added in front, ``scaled +
        extra``, as the reference does."""
        if not self.full:
            raise RuntimeError(f"flush before full: {self.count}/"
                               f"{self.capacity}")
        denom = float(self.capacity)
        kind = self.quantizer.spec.kind
        stack = norms = weights = extra = None
        seeds = rank = group = win_kind = None
        if self._packed and kind in ("qsgd", "lowrank"):
            stack = torch.stack([p for p, _ in self._packed])
            norms = torch.stack([nm for _, nm in self._packed])
            w = (np.asarray(self._weights, np.float32)
                 / np.float32(denom)).astype(np.float32)
            weights = to_device(torch.from_numpy(w), stack.device)
            win_kind = kind
            if kind == "lowrank":
                seeds = torch.stack(self._seeds)
                rank, group = self._rank, self._group
        elif self._packed:
            vals0 = self._packed[0][1]
            extra = torch.zeros(self._n, dtype=torch.float32,
                                device=vals0.device)
            for (idx, vals), w in zip(self._packed, self._weights):
                extra.index_add_(0, idx.to(torch.int64),
                                 vals * _f32_scalar(w / denom, vals))
        if self._flat_acc is not None:
            flat = _true_div(self._flat_acc, denom)
            extra = flat if extra is None else extra + flat
        if self._acc is not None:
            scaled = _f32_scalar(1.0 / denom, self._acc) * self._acc
            extra = scaled if extra is None else scaled + extra
        batch = FlushBatch(n=self._n, layout=self._layout, bits=self._bits,
                           stack=stack, norms=norms, weights=weights,
                           extra=extra, kind=win_kind, seeds=seeds,
                           rank=rank, group=group)
        self._reset()
        return batch
