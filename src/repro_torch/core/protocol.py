"""Wire protocol: message framing and exact byte accounting.

Counterpart of ``repro/core/protocol.py``. Every upload and broadcast is a
``Message`` carrying a real packed payload (uint8 qsgd codes + bucket norms,
lowrank's codes over its rank coordinates, top_k / rand_k index / value
pairs, or the f32 vector for identity). Bytes follow the paper's Appendix E
model on the whole flattened model: ``bits`` per coordinate plus one f32
norm per 128-coordinate bucket for qsgd (over the rank coordinates for
lowrank), 64 bits per kept coordinate for the sparse kinds, 32 bits per
coordinate for identity.
Broadcasts fan out: one server message reaches every client still training,
so ``TrafficMeter.record`` takes the receiver count. A streamed upload
(``packed_qsgd_chunk_payload``, ``frame_chunk_messages``) meters as one
upload of exactly the unstreamed message's bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from repro_torch.core.quantizers import (Quantizer, TreeLayout,
                                         flatten_tree,
                                         packed_identity_payload,
                                         packed_lowrank_payload,
                                         packed_qsgd_payload, seed_pair)

CLIENT_UPDATE = "client_update"
HIDDEN_BROADCAST = "hidden_broadcast"


@dataclasses.dataclass
class Message:
    kind: str
    payload: Any  # packed payload dict (quantizers.packed_*_payload)
    wire_bytes: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def encode_message(kind: str, quantizer: Quantizer, tree, key, *,
                   fast: bool = False, **meta) -> Message:
    """Encode a parameter tree as one packed message and frame it
    (``Quantizer.encode``: the tree's flat f32 vector, one wire message).
    ``fast=True`` encodes a qsgd message with the batched kernel's
    counter-hash dither (K2, keyed by the key's two words), the
    reference's ``encode_fast``: the same wire format, other codes; the
    other kinds ignore it."""
    if fast and quantizer.spec.kind == "qsgd":
        from repro_torch.kernels import ops as kops

        flat, layout = flatten_tree(tree)
        seeds = seed_pair(key).reshape(1, 2).to(flat.device)
        packed, norms = kops.qsgd_quantize_batch(flat[None], seeds,
                                                 quantizer.spec.bits)
        enc = packed_qsgd_payload(packed[0], norms[0], quantizer.spec.bits,
                                  int(flat.numel()), layout)
    else:
        enc = quantizer.encode(tree, key)
    return Message(kind=kind, payload=enc,
                   wire_bytes=quantizer.wire_bytes_packed(enc["layout"]),
                   meta=dict(meta))


def decode_message(quantizer: Quantizer, msg: Message):
    """Decode a packed message to its parameter tree."""
    return quantizer.decode(msg.payload)


def frame_packed_message(kind: str, quantizer: Quantizer, enc: dict,
                         **meta) -> Message:
    """Frame an already-encoded packed payload (e.g. the broadcast bits of
    the server flush) as a wire Message."""
    return Message(kind=kind, payload=enc,
                   wire_bytes=quantizer.wire_bytes_packed(enc["layout"]),
                   meta=dict(meta))


def payloads_from_fused(quantizer: Quantizer, out: dict, layout: TreeLayout,
                        enc_keys=None, *, count: Optional[int] = None,
                        basis_seed=None) -> List[dict]:
    """Per-member wire payloads of one client step's output
    (``kernels.ops.cohort_train_encode_step``): ``{"packed", "norms"}``
    stacks for qsgd and lowrank (lowrank over the rank coordinates, with
    the round's ``basis_seed``), a ``{"flat"}`` stack for identity and the
    sparse kinds, which are encoded here, row i with ``enc_keys[i]``
    (``Quantizer.encode_flat``).

    ``count`` keeps the first N rows only: a tier group is padded to the
    full cohort size, and the padding rows never reach the wire. Each
    payload is a view of the step's output on its own device, so the
    flush's stack reads it there, with no copy to the host and back."""
    n = layout.total_size
    spec = quantizer.spec
    if spec.kind in ("qsgd", "lowrank"):
        packed, norms = out["packed"], out["norms"]
        count = packed.shape[0] if count is None else count
        if spec.kind == "qsgd":
            return [packed_qsgd_payload(packed[i], norms[i], spec.bits, n,
                                        layout) for i in range(count)]
        if basis_seed is None:
            raise ValueError("lowrank payloads need the round's basis_seed")
        seed = seed_pair(basis_seed)
        return [packed_lowrank_payload(packed[i], norms[i], spec.bits, n,
                                       layout, spec.rank(n), spec.group,
                                       seed) for i in range(count)]
    flat = out["flat"]
    count = flat.shape[0] if count is None else count
    if spec.kind == "identity":
        return [packed_identity_payload(flat[i], n, layout)
                for i in range(count)]
    return [quantizer.encode_flat(flat[i], layout, enc_keys[i])
            for i in range(count)]


def frame_cohort_messages(kind: str, quantizer: Quantizer, out: dict,
                          layout: TreeLayout, enc_keys=None, *,
                          version: int = 0, count: Optional[int] = None,
                          basis_seed=None) -> List[Message]:
    """Frame a client step's output as one Message per member (the first
    ``count``), all of model ``version``. Bytes follow from the shapes,
    wherever the payload lies. ``enc_keys`` (sparse kinds) and
    ``basis_seed`` (lowrank) go to ``payloads_from_fused``."""
    wire = quantizer.wire_bytes_packed(layout)
    return [Message(kind=kind, payload=enc, wire_bytes=wire,
                    meta={"version": version})
            for enc in payloads_from_fused(quantizer, out, layout, enc_keys,
                                           count=count,
                                           basis_seed=basis_seed)]


def packed_qsgd_chunk_payload(packed_c, norms_c, bits: int, n: int,
                              layout: TreeLayout, *, row0: int, seq: int,
                              last: bool) -> dict:
    """One streamed segment of a packed qsgd upload: ``packed_c`` /
    ``norms_c`` are the wire rows ``[row0, row0 + len(norms_c))`` of the
    whole ``(rows_for(n), ...)`` message. Each chunk carries bits, n and
    the layout, so a receiver validates it before any state changes."""
    return {"format": "packed_chunk", "kind": "qsgd", "packed": packed_c,
            "norms": norms_c, "bits": bits, "n": n, "layout": layout,
            "row0": int(row0), "rows": int(norms_c.shape[0]),
            "seq": int(seq), "last": bool(last)}


def frame_chunk_messages(kind: str, quantizer: Quantizer, chunks: List[dict],
                         layout: TreeLayout, *, version: int = 0,
                         stream: int = 0, client=None) -> List[Message]:
    """Frame the streamed chunks of one upload as Messages, each meta
    with the ``version``, the ``stream`` id and, when given, the
    ``client`` id: the receiver holds a stream's chunks by these three. A
    chunk's bytes are its codes plus one f32 norm per row; the last chunk
    absorbs the metering remainder, so the stream totals exactly
    ``wire_bytes_packed(layout)``, the unstreamed message's bytes."""
    total = quantizer.wire_bytes_packed(layout)
    meta = {"version": version, "stream": stream}
    if client is not None:
        meta["client"] = client
    msgs, spent = [], 0.0
    for ch in chunks:
        wire = (total - spent if ch["last"]
                else float(ch["packed"].numel() + 4 * ch["rows"]))
        spent += wire
        msgs.append(Message(kind=kind, payload=ch, wire_bytes=wire,
                            meta=dict(meta)))
    return msgs


def encode_message_flat(kind: str, quantizer: Quantizer, flat, layout, key,
                        **meta) -> Message:
    """Encode a flat f32 vector (``Quantizer.encode_flat``) and frame it:
    the non-fused flush's broadcast."""
    return Message(kind=kind, payload=quantizer.encode_flat(flat, layout, key),
                   wire_bytes=quantizer.wire_bytes_packed(layout),
                   meta=dict(meta))


def payload_wire_bytes(enc) -> Optional[float]:
    """Exact framed bytes of one packed payload, from the payload itself:
    a lowrank upload is a rank-length qsgd message, a sparse one 64 bits
    per kept coordinate, a tier upload priced at its own bits."""
    if not isinstance(enc, dict) or enc.get("format") != "packed":
        return None
    kind = enc.get("kind")
    if kind == "lowrank":
        r = int(enc["rank"])
        return (enc["bits"] * r + 32 * math.ceil(r / 128)) / 8.0
    if kind == "qsgd":
        n = int(enc["n"])
        return (enc["bits"] * n + 32 * math.ceil(n / 128)) / 8.0
    if kind == "identity":
        return 32 * int(enc["n"]) / 8.0
    if "idx" in enc:
        return 64 * int(enc["idx"].shape[-1]) / 8.0
    return None


def payload_kind_label(enc) -> str:
    """Per-kind bucket label for traffic accounting ("qsgd4",
    "lowrank4g32", "top_k", "identity")."""
    if not isinstance(enc, dict):
        return "tree"
    kind = enc.get("kind")
    if kind == "lowrank":
        return f"lowrank{enc['bits']}g{enc['group']}"
    if kind == "qsgd":
        return f"qsgd{enc['bits']}"
    if kind is not None:
        return str(kind)
    return "sparse" if "idx" in enc else "other"


def decode_message_flat(quantizer: Quantizer, msg: Message):
    """Decode a packed message to its flat f32 vector (no unflatten)."""
    return quantizer.decode_flat(msg.payload)


@dataclasses.dataclass
class TrafficMeter:
    """Accumulates the paper's communication metrics.

    ``broadcast_bytes`` counts downlink fan-out (``n_receivers`` times the
    message); ``broadcast_wire_bytes`` keeps the single-copy total so
    kB-per-broadcast stays comparable to the paper's tables.
    """

    uploads: int = 0
    broadcasts: int = 0
    upload_bytes: float = 0.0
    broadcast_bytes: float = 0.0
    broadcast_wire_bytes: float = 0.0
    broadcast_receivers: int = 0
    # uploads rejected by the staleness drop policy: the uplink bytes were
    # spent, but the update never entered the buffer
    uploads_dropped: int = 0
    dropped_bytes: float = 0.0
    uploads_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    upload_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def _upload_size(self, msg: Message) -> float:
        actual = payload_wire_bytes(msg.payload)
        return msg.wire_bytes if actual is None else actual

    def record(self, msg: Message, n_receivers: int = 1):
        if msg.kind == CLIENT_UPDATE:
            wire = self._upload_size(msg)
            self.uploads += 1
            self.upload_bytes += wire
            label = payload_kind_label(msg.payload)
            self.uploads_by_kind[label] = self.uploads_by_kind.get(label, 0) + 1
            self.upload_bytes_by_kind[label] = (
                self.upload_bytes_by_kind.get(label, 0.0) + wire)
        else:
            self.broadcasts += 1
            self.broadcast_bytes += msg.wire_bytes * n_receivers
            self.broadcast_wire_bytes += msg.wire_bytes
            self.broadcast_receivers += n_receivers

    def record_stream(self, enc, stream_bytes: float):
        """One complete streamed upload: its chunks' summed bytes count as
        one upload, of the kind its chunks describe."""
        self.uploads += 1
        self.upload_bytes += stream_bytes
        label = payload_kind_label(enc)
        self.uploads_by_kind[label] = self.uploads_by_kind.get(label, 0) + 1
        self.upload_bytes_by_kind[label] = (
            self.upload_bytes_by_kind.get(label, 0.0) + stream_bytes)

    def record_dropped(self, msg: Message):
        """An upload rejected at the server (staleness bound exceeded)."""
        self.uploads_dropped += 1
        self.dropped_bytes += self._upload_size(msg)

    def summary(self) -> Dict[str, float]:
        by_kind = {f"kB_per_upload/{k}": self.upload_bytes_by_kind[k] / c / 1e3
                   for k, c in self.uploads_by_kind.items() if c}
        return {
            "uploads": self.uploads,
            "broadcasts": self.broadcasts,
            "upload_MB": self.upload_bytes / 1e6,
            "broadcast_MB": self.broadcast_bytes / 1e6,
            "kB_per_upload": (self.upload_bytes / self.uploads / 1e3
                              if self.uploads else 0.0),
            **by_kind,
            "kB_per_broadcast": (self.broadcast_wire_bytes / self.broadcasts
                                 / 1e3 if self.broadcasts else 0.0),
            "mean_broadcast_fanout": (self.broadcast_receivers
                                      / self.broadcasts
                                      if self.broadcasts else 0.0),
            "uploads_dropped": self.uploads_dropped,
            "dropped_MB": self.dropped_bytes / 1e6,
        }
