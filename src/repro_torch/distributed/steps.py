"""The QAFeL round on a decoder architecture, on one device.

Counterpart of the baseline round of ``repro/distributed/steps.py``
(``make_qafel_round``): the compute of one buffer flush (Algorithm 1 lines
5-16) for a model of ``models.transformer``.

* The K buffered clients run in turn, each P local SGD steps from the
  shared hidden state with its own batch slice: ``core.qafel
  .client_update_flat`` at b = 1 (flat x-hat in, real packed qsgd wire
  codes out: K1, the threefry upload encode), then the server decodes the
  client's own wire bits and adds them, weighted, into the f32 sum ``buf``
  in place (K3, ``accumulate``).
* The server half (``server_half``): the server-update kernel
  (``kernels.server_update``: ``delta_bar = buf * fl32(1/K)``, the FedBuff
  momentum and update, the broadcast diff ``x_new - x-hat`` left in
  ``buf``), the diff encoded with the threefry dither (K1) and its decode
  added into x-hat in place (K3).
* ``chunk_rows`` encodes every message ``chunk_rows`` wire rows at a time,
  each chunk keyed by its global row offset, so the round's bits are the
  same at any chunking; a client then forms its delta chunk by chunk too,
  and only the codes and the norms of its upload exist whole.
* ``remat`` (the default, as in the reference) recomputes each
  super-block in local SGD's backward pass: the gradient is taken with
  ``torch.autograd.grad`` (``core.qafel.local_sgd``), under which the
  model's ``torch.utils.checkpoint`` runs; the values are those of
  ``remat=False``, which takes ``torch.func.grad``, bit for bit (each
  silu is one ``autograd.Function`` with one backward for both,
  ``models.layers.silu``, and so is the loss's ``layers.logsumexp``).

**The state is updated in place**, unlike the reference's functional
round: ``RoundState`` holds x, x-hat and m as one flat buffer each in the
tree's main dtype (``RoundState.flat``), its trees are views of them, and
``round_fn`` updates the buffers and returns the same state with ``t +
1``. A caller that keeps the state from before a round clones it
(``RoundState.clone``). The memory it saves is what lets gemma2-2b and
mamba2-1.3b run at their published depth on one card. x, x-hat and m are
rounded to the leaves' dtype, nearest even, as the reference's
``layout.unflatten`` rounds them every round. A mixed-dtype tree (mamba2's
f32 ``A_log``, ``D`` and ``dt_bias`` in a bf16 model: 9,216 of 1.34e9
coordinates in mamba2-1.3b) keeps its other leaves as tensors of their own
beside the bf16 buffers, whose slots only shadow them: the kernels run
over the whole buffers as for one dtype, and those few coordinates are
recomputed in their own dtype in plain PyTorch where the round reads or
writes them (the clients read them through ``core.quantizers.SplitFlat``;
``server_half``), bit for bit the reference's, with no launch added.

Per round, with R = ceil(d/128) wire rows in ``ceil(R / chunk_rows)``
chunks (1 without ``chunk_rows``): K1 (K + 1) x chunks launches, K3 K + 1
and the server update 1. The phases run under
``torch.profiler.record_function`` ranges named ``"client"`` (local SGD and
the K1 upload encode), ``"accumulate"`` (K3 into ``buf``), ``"server"``
(the server update) and ``"broadcast"`` (K1, K3), so a profiled round
reads its time by phase. Every product and sum of the server half rounds
where the reference's jitted round rounds on XLA:CPU, so the wire bits, x,
x-hat and m are the reference's bit for bit for the same client messages;
the model math (forward, gradients) agrees within a tolerance (tests/
test_torch_llm_round.py).

``taps=True`` adds the reference's flush tap vector (``metrics["taps"]``,
f32 (7,) in ``obs.taps.FLUSH_TAP_NAMES`` order: the norms of delta_bar,
x_new - x, the diff and the broadcast q, the relative error ||diff - q|| /
||diff||, the weights' sum and minimum). Its five whole-vector sums cannot
be read after the round has overwritten buf, x and x-hat, so the kernels
that overwrite them take the squares as they go: the server-update kernel
writes the level-1 window sums (XLA:CPU's sum law) of delta_bar^2,
(x_new - x)^2 and diff^2, K3's x-hat apply those of err^2 and q^2, into
one f32 (5, ceil(d/32)) buffer that lives for the round, and one more
launch (``kernels.taps.round_taps``) finishes the law. Taps on change no
bit of the round and add that one launch.

**The other quantizers** follow the reference's ``round_fn``
(``repro/distributed/steps.py:114-132,147-191``), each sum rounded where
its jitted round rounds on XLA:CPU (read from its optimised HLO; XLA
folds a constant factor into the weight and contracts the last product
into the add):

* clients: identity sends its raw rows and top_k its kept values,
  ``buf = fma(v, w_k, buf)``; rand_k's server takes the raw kept values,
  ``buf = fma(v, fl32(w_k * fl32(d/k)), buf)`` (scaled); lowrank
  quantize-packs its rank coordinates (K1) under ``basis_seeds(0, t)``
  with a zero residual, and the server decodes them (K3) and expands,
  ``buf = fma(repeat(y) * sign, fl32(w_k * fl32(1/sqrt(g))), buf)`` (at
  a d that the expand fills exactly; ``accumulate_upload``);
* the server: the same update kernel, then q = diff (identity), the kept
  values (top_k, rand_k) or the lowrank in-math quantize-dequantize
  (``Quantizer.qdq_flat``), and x-hat + q with a scaled q's last product
  fused into the add (``fma(v, fl32(d/k), x-hat)``, ``fma(repeat(yq) *
  sign, fl32(1/sqrt(g)), x-hat)``); its taps' err^2 and q^2 window sums
  come from a plain pass over diff and q (``_apply_broadcast``), err
  ``diff - q`` with the same contraction.

The sums are plain PyTorch (``ref.fma_f32``, float64-exact, in chunks of
``_CHUNK`` elements); only qsgd messages go through K1 and K3.

The round runs over any tree of the pool: the MoE configs' expert banks
and routers, deepseek's MLA, ``prefix_layers``, ``mtp_block`` and
``mtp_norm`` are leaves like any other, flattened in JAX's sorted-key
order (``embed``, ``final_norm``, ``head``, ``layers``, ``mtp_block``,
``mtp_norm``, ``prefix_layers``), so the server half stays bit for bit
with the reference's on equal messages; the loss carries the routers'
aux term and the MTP term (``transformer.loss_fn``).

``make_prefill_step`` and ``make_decode_step`` wrap ``transformer.prefill``
and ``transformer.decode_step`` (the serving side, ``launch.serve``).

**On a ("data", "model") mesh** (``make_qafel_round(mesh=)``, the dense
attention decoders: gemma2-2b, codeqwen1.5-7b, qwen3-14b, granite-34b and
their reduced configs) the round is tensor-parallel (``_mesh_round``):

* x, x-hat and m are the flat substrate's segments over the mesh's flat
  axes (``RoundState.on_mesh``: data-major, rows padded,
  ``sharding.rules``); ``state.flat`` holds this rank's three segments.
* Once a round the clients' x-hat shards (``sharding.rules
  .param_pspecs``; whole leaves where the model extent is 1) are cut from
  the segments leaf by leaf, each leaf's range broadcast by the ranks
  that hold it (none with one segment: the shards are views of it).
* Each client runs local SGD on its shards (``models.transformer
  .loss_fn(tp=)``), its batch split over "data" where ``batch_pspecs``
  splits it (the gradients summed over "data"), else replicated. Its
  delta is brought to this rank's segment of the global flat rows, leaf
  by leaf over "model", and K1 encodes the segment at its global row
  offset (the threefry dither is keyed by the global row, so the codes do
  not depend on the mesh); K3 adds it, weighted, into ``buf``'s segment.
* The server half runs on each segment (``server_half`` at the segment's
  rows): the update kernel, K1's broadcast and K3's x-hat + q.
* With ``taps`` each segment's window partials are gathered over the flat
  group in segment order before ``round_taps``; ``on_message`` sees the
  whole messages, the segments' codes gathered.

A rank holds its segments, its shards (their gradients and the client's
working copy) and, beyond them, at most one leaf's range or one segment
in flight. On a (n, 1) mesh the model runs the meshless ops, and the
round is the meshless round bit for bit.

Not ported here: the pod-quantized round (ROADMAP queue A item 14d); on
a mesh, the other families (MoE, MLA, Mamba2, the hybrid, the VLM prefix,
audio codebooks) and the other quantizers (13b.2); each raises
``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.common import prng
from repro_torch.common.device import to_device
from repro_torch.common.tree import (tree_flatten, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.core.qafel import QAFeLConfig, client_update_flat
from repro_torch.core.protocol import payload_wire_bytes
from repro_torch.core.quantizers import (QuantizerSpec, SplitFlat,
                                         TreeLayout, _qsgd_qdq_flat,
                                         _top_k_indices,
                                         lowrank_expand_flat2d,
                                         lowrank_project_flat2d,
                                         make_quantizer,
                                         packed_identity_payload,
                                         packed_lowrank_payload,
                                         packed_qsgd_payload, seed_pair,
                                         sparse_k, sparse_payload)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import qsgd as _kq
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.server_update import server_update_
from repro_torch.kernels.taps import round_taps
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class RoundState:
    """The round's state: the full-precision server model ``x``, the
    shared hidden state x-hat (``hidden``), the server momentum (trees in
    the leaves' dtypes) and the server step ``t``. ``flat`` is the
    ``(x, hidden, momentum)`` triple of flat buffers in the tree's main
    dtype (``from_trees``): its leaves of that dtype view them, a leaf of
    another dtype (mamba2's f32 ``A_log``, ``D`` and ``dt_bias`` in a
    bf16 model) is a tensor of its own, which its slots in the buffers
    shadow. None until the first round or ``from_trees``."""

    x: Any
    hidden: Any
    momentum: Any
    t: int = 0
    flat: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    mesh: Any = None

    @staticmethod
    def on_mesh(x, hidden, momentum, mesh, t: int = 0) -> "RoundState":
        """A state on ``mesh``'s flat segments (``sharding.rules``): this
        rank's segment of each tree's flat vector, zero-padded past d, in
        the trees' one dtype, as ``flat``; ``x``, ``hidden`` and
        ``momentum`` are trees of views of the segments where the mesh has
        one segment, else None (``gather_tree`` assembles them)."""
        from repro_torch.sharding.rules import (flat_padded_len,
                                                flat_segment_index,
                                                mesh_flat_extent)

        layout = TreeLayout.of(x)
        if len(set(layout.dtypes)) != 1:
            raise NotImplementedError(
                "a mixed-dtype state on a mesh (Mamba2, the hybrid) is "
                "ROADMAP queue A item 13b.2")
        nseg = mesh_flat_extent(mesh)
        n_l = flat_padded_len(layout.total_size, nseg) // nseg
        a = flat_segment_index(mesh) * n_l
        flats = []
        for tree in (x, hidden, momentum):
            leaves = tree_leaves(tree)
            seg = torch.zeros(n_l, dtype=leaves[0].dtype,
                              device=leaves[0].device)
            off = 0
            for leaf, size in zip(leaves, layout.sizes):
                lo, hi = max(off, a), min(off + size, a + n_l)
                if lo < hi:
                    seg[lo - a:hi - a] = leaf.reshape(-1)[lo - off:hi - off]
                off += size
            flats.append(seg)
        return RoundState(*_segment_trees(layout, flats, nseg), t=t,
                          flat=tuple(flats), mesh=mesh)

    @staticmethod
    def from_trees(x, hidden, momentum, t: int = 0) -> "RoundState":
        """A state of copies of the three trees: one flat buffer each in
        the dtype that holds most coordinates, the other leaves cloned
        (their buffer slots hold them rounded to the buffer's dtype)."""
        layout = TreeLayout.of(x)
        base = _base_dtype(layout)
        flats, trees = [], []
        for tree in (x, hidden, momentum):
            leaves = tree_leaves(tree)
            buf = torch.empty(layout.total_size, dtype=getattr(torch, base),
                              device=leaves[0].device)
            off = 0
            for leaf, size in zip(leaves, layout.sizes):
                buf[off:off + size].copy_(leaf.reshape(-1))
                off += size
            flats.append(buf)
            trees.append(_trees_over(layout, base, buf, leaves))
        return RoundState(*trees, t=t, flat=tuple(flats))

    def clone(self) -> "RoundState":
        """A copy that later rounds on this state leave untouched."""
        if self.mesh is not None:
            from repro_torch.sharding.rules import mesh_flat_extent
            flats = tuple(f.clone() for f in self.flat)
            layout = (None if self.x is None else TreeLayout.of(self.x))
            trees = (_segment_trees(layout, flats, 1) if layout is not None
                     and mesh_flat_extent(self.mesh) == 1
                     else (None, None, None))
            return RoundState(*trees, t=self.t, flat=flats, mesh=self.mesh)
        if self.flat is None:
            return RoundState(*(tree_map(torch.clone, tr) for tr in
                                (self.x, self.hidden, self.momentum)),
                              t=self.t)
        layout = TreeLayout.of(self.x)
        base = str(self.flat[0].dtype).replace("torch.", "")
        flats = tuple(f.clone() for f in self.flat)
        trees = [_trees_over(layout, base, f, tree_leaves(tr))
                 for f, tr in zip(flats, (self.x, self.hidden,
                                          self.momentum))]
        return RoundState(*trees, t=self.t, flat=flats)


def _segment_trees(layout: TreeLayout, flats, nseg: int) -> tuple:
    """The three trees of views of one-segment flats (None each where the
    mesh has more segments)."""
    if nseg != 1:
        return None, None, None
    return tuple(layout.unflatten(f[:layout.total_size]) for f in flats)


def _base_dtype(layout: TreeLayout) -> str:
    """The dtype name that holds most of a layout's coordinates."""
    size: Dict[str, int] = {}
    for dt, n in zip(layout.dtypes, layout.sizes):
        size[dt] = size.get(dt, 0) + n
    return max(size, key=size.get)


def _trees_over(layout: TreeLayout, base: str, buf: torch.Tensor, leaves):
    """The tree whose ``base``-dtype leaves view ``buf`` and whose other
    leaves are clones of ``leaves``' (contiguous, so their flat views
    write them)."""
    out, off = [], 0
    for leaf, shape, dt, size in zip(leaves, layout.shapes, layout.dtypes,
                                     layout.sizes):
        out.append(buf[off:off + size].view(shape) if dt == base
                   else leaf.detach().clone(
                       memory_format=torch.contiguous_format))
        off += size
    return tree_unflatten(layout.treedef, out)


@dataclasses.dataclass
class _Side:
    """A leaf of a mixed state outside its buffers: its offset in the
    flat coordinates and flat views of its x, x-hat and m tensors."""
    off: int
    x: torch.Tensor
    hidden: torch.Tensor
    m: torch.Tensor

    @property
    def end(self) -> int:
        return self.off + self.x.numel()


def _sides(state: RoundState, layout: TreeLayout) -> list:
    """The state's leaves of another dtype than its buffers' (none for a
    tree of one dtype)."""
    base = str(state.flat[0].dtype).replace("torch.", "")
    out, off = [], 0
    for i, (dt, size) in enumerate(zip(layout.dtypes, layout.sizes)):
        if dt != base:
            out.append(_Side(off, *(tree_leaves(tr)[i].view(-1) for tr in (
                state.x, state.hidden, state.momentum))))
        off += size
    return out


def init_round_state(cfg: ModelConfig, seed: int = 0, device=None,
                     mesh=None) -> RoundState:
    """Random parameters (``transformer.init_params``) as x and x-hat,
    zero momentum, t = 0, on ``device`` (None: the card); with a ``mesh``
    this rank's segments of them (``RoundState.on_mesh``; every rank draws
    the same parameters from the seed)."""
    params = T.init_params(cfg, seed, device)
    zeros = tree_map(torch.zeros_like, params)
    if mesh is not None:
        return RoundState.on_mesh(params, params, zeros, mesh)
    return RoundState.from_trees(params, params, zeros)


def abstract_round_state(cfg: ModelConfig) -> RoundState:
    """``init_round_state``'s shapes and dtypes without memory (``meta``
    tensors): x, x-hat and m as ``transformer.abstract_params``."""
    params = T.abstract_params(cfg)
    return RoundState(x=params, hidden=tree_map(torch.empty_like, params),
                      momentum=tree_map(torch.empty_like, params))


_CHUNK = 1 << 24  # elements per float64 chunk of the plain sums


def _fma_into(out, v, scale, c) -> None:
    """``out = fma(v, scale, c)`` single rounded (``ref.fma_f32``), or
    ``c + v`` where ``scale`` is None, in f32 and then rounded to
    ``out``'s dtype, ``_CHUNK`` elements at a time; ``out`` may be ``c``.
    ``scale`` is a Python float of f32 value or a one-element f32
    tensor."""
    for a in range(0, out.numel(), _CHUNK):
        e = min(out.numel(), a + _CHUNK)
        cf = c[a:e].to(torch.float32)
        out[a:e] = (cf + v[a:e] if scale is None
                    else _ref.fma_f32(v[a:e], scale, cf))


def _f32_product(a, b: float) -> torch.Tensor:
    """fl32(a * b) of a one-element f32 tensor and an f32 value."""
    return a.to(torch.float32) * float(torch.tensor(b, dtype=torch.float32))


def _kept(flat, idx) -> torch.Tensor:
    """The sparse kinds' kept vector: ``flat`` at ``idx``, zero elsewhere
    (the reference's ``where(mask, x, 0)``)."""
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out


def accumulate(buf, packed, norms, weight, *, bits: int, d: int):
    """One client's message into the weighted sum, in place: ``buf + w_k *
    dec`` with ``dec`` the decode of the packed qsgd codes, rounded, and
    the weight's product fused into the add, ``fma(dec, w_k, buf)``, as
    XLA:CPU compiles the reference round's scan
    (``repro/distributed/steps.py:170``); one K3 launch. ``weight`` is a
    one-element f32 tensor on ``buf``'s device; ``buf`` holds d f32
    values. Returns ``buf``."""
    if buf.numel() != d:
        raise ValueError(f"buf: {buf.numel()} values, expected {d}")
    return _kq.qsgd_unpack_dequantize(packed, norms, bits, acc=buf,
                                      weight=weight.reshape(1))


def upload(spec: QuantizerSpec, out: dict, k_enc, layout: TreeLayout,
           seeds=None) -> dict:
    """A client step's output (``core.qafel.client_update_flat`` at
    b = 1) as its wire payload: the packed qsgd or lowrank codes (lowrank
    under the round's basis ``seeds``), identity's raw rows, top_k's and
    rand_k's index / value pairs (``Quantizer.encode_flat`` with
    ``k_enc``; the flat delta rides along as ``"flat"``, which the
    reference's server reads)."""
    d = layout.total_size
    if spec.kind == "qsgd":
        return packed_qsgd_payload(out["packed"][0], out["norms"][0],
                                   spec.bits, d, layout)
    if spec.kind == "lowrank":
        return packed_lowrank_payload(out["packed"][0], out["norms"][0],
                                      spec.bits, d, layout, spec.rank(d),
                                      spec.group, seed_pair(seeds))
    flat = out["flat"][0]
    if spec.kind == "identity":
        return packed_identity_payload(flat, d, layout)
    return dict(make_quantizer(spec).encode_flat(flat, layout, k_enc),
                flat=flat)


def accumulate_upload(buf, payload: dict, weight, spec: QuantizerSpec):
    """``buf + w_k * decode(payload)`` in place, as the reference's jitted
    round rounds it for the payload's kind (module docstring): K3 for
    qsgd (``accumulate``); identity and top_k ``fma(v, w_k, buf)``;
    rand_k ``fma(v, fl32(w_k * fl32(d/k)), buf)`` on the raw kept values
    when ``spec`` (the client quantizer) is scaled; lowrank the K3 decode
    of the rank coordinates, expanded, ``fma(repeat(y) * sign,
    fl32(w_k * fl32(1/sqrt(g))), buf)`` where the expand fills d exactly
    (d = rank * g, every config of ``configs``), else ``fma(fl32(repeat(y)
    * sign * fl32(1/sqrt(g))), w_k, buf)``. ``weight`` is a one-element
    f32 tensor on ``buf``'s device. Returns ``buf``."""
    kind, d = payload["kind"], payload["n"]
    if kind == "qsgd":
        return accumulate(buf, payload["packed"], payload["norms"], weight,
                          bits=payload["bits"], d=d)
    if buf.numel() != d:
        raise ValueError(f"buf: {buf.numel()} values, expected {d}")
    if kind == "lowrank":
        y = kops.qsgd_dequantize(payload["packed"], payload["norms"],
                                 payload["bits"], payload["rank"])
        # XLA folds the expand's scale into the weight only where the
        # expand fills d exactly; a sliced expand keeps its rounded product
        whole = payload["rank"] * payload["group"] == d
        v = lowrank_expand_flat2d(y[None], payload["seed"], payload["group"],
                                  d, scaled=not whole)[0]
        scale = (_f32_product(weight, _kq.sketch_scale(payload["group"]))
                 if whole else weight)
    elif kind == "identity":
        v, scale = payload["payload"], weight
    else:
        v, scale = _kept(payload["flat"], payload["idx"].long()), weight
        if kind == "rand_k" and spec.scaled:
            scale = _f32_product(weight, d / payload["idx"].numel())
    _fma_into(buf, v, scale.reshape(()), buf)
    return buf


def _broadcast_qdq(spec: QuantizerSpec, diff, key, taps: bool):
    """A non-qsgd server quantizer's q = Q_s(diff), as the reference's
    jitted round computes it on XLA:CPU (read from its optimised HLO), in
    the terms ``_apply_broadcast`` takes: ``(apply, tap, msg)``.

    ``apply = (v, scale, fused)`` adds q to x-hat: q = v * scale
    (``scale`` None: q = v), the product fused into the add where
    ``fused``. ``tap = (v, scale)`` is the q of the taps (None without
    ``taps``), whose err ``diff - q`` always fuses the product. ``msg``
    is the pair of tensors the broadcast stands for: identity ``(diff,
    None)``; top_k and rand_k their wire index / value pair; lowrank the
    quantize-dequantized subspace vector ``(yq, None)``.

    rand_k keeps its kept values' product rounded before the add. A
    lowrank server is the reference's in-math ``qdq_flat`` (the sketch
    projection, the bucketed qsgd with ``key``'s dither, the expand),
    and XLA computes it twice: the x-hat apply projects in the fused
    group order and multiplies by fl32(1/s) where the eager ``qdq_flat``
    divides by s, and fuses the expand's scale into the add; the taps
    take the eager order and the division."""
    d = diff.numel()
    if spec.kind == "identity":
        return (diff, None, False), ((diff, None) if taps else None), (
            diff, None)
    if spec.kind == "lowrank":
        seeds, scale = seed_pair(key), _kq.sketch_scale(spec.group)

        def q(fused: bool):
            y = lowrank_project_flat2d(diff[None], seeds, spec.group,
                                       fused=fused)
            yq = _qsgd_qdq_flat(y[0], key, spec.bits, spec.bucket_size,
                                reciprocal=fused)
            return yq, lowrank_expand_flat2d(yq[None], seeds, spec.group, d,
                                             scaled=False)[0]

        yq, v = q(True)
        tap = (q(False)[1], scale) if taps else None
        return (v, scale, True), tap, (yq, None)
    k = sparse_k(spec.fraction, d)
    if spec.kind == "top_k":
        idx = _top_k_indices(diff, k)
    else:
        idx = prng.choice(key, d, k, device=diff.device)
    v = _kept(diff, idx)
    scale = (float(torch.tensor(d / k, dtype=torch.float32))
             if spec.kind == "rand_k" and spec.scaled else None)
    vals = v[idx] if scale is None else v[idx] * scale
    return (v, scale, False), ((v, scale) if taps else None), (idx, vals)


def _apply_broadcast(hidden_flat, diff, apply, tap=None, taps=None,
                     sides=()) -> None:
    """x-hat + q over x-hat in place, rounded to x-hat's dtype, with q
    and the taps' q as ``_broadcast_qdq`` gives them (a mixed state's
    ``sides`` each in its own dtype); with ``taps``, an
    f32 (2, ``ref.tap_windows(d)``) view, the level-1 window sums of
    err^2 and q^2, err = ``diff - q`` with q's product fused into the
    subtraction and q the rounded product (the reference's
    ``flush_tap_vector`` on XLA:CPU)."""
    v, scale, fused = apply
    if scale is not None and not fused:
        v, scale = v * scale, None
    _fma_into(hidden_flat, v, scale, hidden_flat)
    for sd in sides:
        _fma_into(sd.hidden, v[sd.off:sd.end], scale, sd.hidden)
    if taps is None:
        return
    v, scale = tap
    d = diff.numel()
    for w0, w1, a, b, lo, hi in _ref.window_chunks(d, _CHUNK // 32):
        q = v[a:b] if scale is None else v[a:b] * scale
        err = (diff[a:b] - v[a:b] if scale is None
               else _ref.fma_f32(-v[a:b], scale, diff[a:b]))
        taps[0, w0:w1] = _ref.window_sums(err * err, lo, hi)
        taps[1, w0:w1] = _ref.window_sums(q * q, lo, hi)


def message_tensors(payload: dict) -> Tuple[torch.Tensor, Any]:
    """The pair of tensors ``on_message`` sees for a wire payload: the
    codes and norms (qsgd, lowrank), the raw rows and None (identity),
    the indices and values (top_k, rand_k)."""
    if payload["kind"] in ("qsgd", "lowrank"):
        return payload["packed"], payload["norms"]
    if payload["kind"] == "identity":
        return payload["payload"], None
    return payload["idx"], payload["vals"]


def broadcast_payload(spec: QuantizerSpec, msg, layout: TreeLayout) -> dict:
    """The broadcast of ``server_half`` as the wire payload it meters:
    qsgd's codes, identity's rows, top_k's and rand_k's pairs; a lowrank
    server's in-math quantize-dequantize has no codes, so it stands for
    the rank-length qsgd message of its subspace vector."""
    d = layout.total_size
    a, b = msg
    if spec.kind == "qsgd":
        return packed_qsgd_payload(a, b, spec.bits, d, layout)
    if spec.kind == "identity":
        return packed_identity_payload(a, d, layout)
    if spec.kind == "lowrank":
        return {"format": "packed", "kind": "lowrank", "bits": spec.bits,
                "n": d, "layout": layout, "rank": spec.rank(d),
                "group": spec.group}
    return sparse_payload(spec.kind, a, b, d, layout)


def _side_regions(sides, d: int, taps: bool) -> list:
    """The element ranges ``[a, b, sides]`` a mixed state's server update
    recomputes: each side leaf's range, widened to whole level-1 tap
    windows (``ref.window_chunks``) with ``taps``, overlapping ones
    merged."""
    f, w = _ref.tap_front(d), _ref.XLA_WINDOW
    out = []
    for sd in sides:
        a, b = sd.off, sd.end
        if taps:
            a = max(w * ((a + f) // w) - f, 0)
            b = min(w * -(-(b + f) // w) - f, d)
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
            out[-1][2].append(sd)
        else:
            out.append([a, b, [sd]])
    return out


def _region_values(region, buf, x_flat, hidden_flat, m_flat) -> tuple:
    """A region's buf, x, x-hat and m before the server update, f32
    copies, each side leaf's coordinates from its own tensor."""
    a, b, sides = region
    out = [buf[a:b].clone()]
    for flat, name in ((x_flat, "x"), (hidden_flat, "hidden"),
                       (m_flat, "m")):
        v = flat[a:b].to(torch.float32, copy=True)
        for sd in sides:
            v[sd.off - a:sd.end - a] = getattr(sd, name)
        out.append(v)
    return tuple(out)


def _fix_server_update(regions, saved, buf, taps, d: int, **law) -> None:
    """After the server-update kernel: each side leaf's m and x and its
    diff in ``buf`` from its own values (the kernel read their shadows),
    and with ``taps`` the regions' window sums of the three squares
    (``ref.server_update_values``, the kernel's law)."""
    f, w = _ref.tap_front(d), _ref.XLA_WINDOW
    for (a, b, sides), (bv, xv, hv, mv) in zip(regions, saved):
        delta_bar, m_new, x_new, diff = _ref.server_update_values(
            bv, mv, xv, hv, **law)
        for sd in sides:
            i, j = sd.off - a, sd.end - a
            sd.m.copy_(m_new[i:j])
            sd.x.copy_(x_new[i:j])
            buf[sd.off:sd.end] = diff[i:j]
        if taps is not None:
            w0, w1 = (a + f) // w, -(-(b + f) // w)
            lo, hi = a - (w * w0 - f), (w * w1 - f) - b
            for row, v in enumerate((delta_bar, x_new - xv, diff)):
                taps[row, w0:w1] = _ref.window_sums(v * v, lo, hi)


def _fix_apply(sides, packed, norms, bits: int) -> None:
    """After K3's x-hat apply: each side leaf's x-hat + q from its own
    values, ``fma(sign*mag, norm * fl32(1/s), x-hat)`` on the wire rows
    that hold it (the kernel's law, ``ref.unpack_dequantize``)."""
    lanes = _ref.LANES
    for sd in sides:
        r0, r1 = sd.off // lanes, -(-sd.end // lanes)
        acc = torch.zeros((r1 - r0) * lanes, dtype=torch.float32,
                          device=sd.hidden.device)
        i, j = sd.off - r0 * lanes, sd.end - r0 * lanes
        acc[i:j] = sd.hidden
        out = _ref.unpack_dequantize(packed[r0:r1], norms[r0:r1], bits,
                                     acc=acc)
        sd.hidden.copy_(out.reshape(-1)[i:j])


def server_half(x_flat, hidden_flat, momentum_flat, buf, k_server, *,
                qcfg: QAFeLConfig, d: int,
                chunk_rows: Optional[int] = None,
                taps: Optional[torch.Tensor] = None, sides=(),
                row0: int = 0, total_rows: Optional[int] = None):
    """The server half of the round on the flat state (x, x-hat and m:
    d values each in one dtype, f32 or bf16), in place, from the clients'
    weighted sum ``buf`` (``accumulate``), rounded where the reference's
    jitted round rounds on XLA:CPU (``repro/distributed/steps.py:172-194``,
    read from its optimised program and pinned by tests):

    1. the server-update kernel (``kernels.server_update``): ``delta_bar =
       buf * fl32(1/K)``; the momentum's product fused into its add,
       ``m_new = fma(m, beta, delta_bar)``; ``x_new = m_new + x`` (XLA
       drops the product by a server lr of 1, else ``fma(m_new, lr, x)``);
       ``diff = x_new - x-hat`` into ``buf``; m and x rounded to the
       state's dtype;
    2. a qsgd server (``qcfg.server_quantizer``): the broadcast K1 of the
       diff (threefry dither keyed by ``k_server``), ``chunk_rows`` rows
       at a time when given;
    3. ``x-hat + q`` with the decode's last product fused into the add,
       ``fma(sign*mag, norm * fl32(1/s), x-hat)``, written over x-hat and
       rounded to its dtype: one K3 launch.

    Any other server quantizer takes q = Q_s(diff) in plain PyTorch
    instead of steps 2-3 (``_broadcast_qdq``, ``_apply_broadcast``;
    module docstring).

    With ``taps``, an f32 (5, ``ref.tap_windows(d)``) buffer, step 1
    writes rows 0-2 and step 3 rows 3-4 of the taps' level-1 window sums
    (``kernels.taps.round_taps`` finishes them); the launches and every
    other output are the same.

    ``sides`` (``_Side``: a mixed state's leaves of another dtype, whose
    slots in the buffers only shadow them) are recomputed from their own
    values by the same laws in plain PyTorch, each on its own range: the
    update after the kernel (from the sums saved before it; with taps,
    whole windows), so the broadcast encodes their true diff, and the
    x-hat apply after K3; then the shadows are rewritten. No launch is
    added, and every bit is the reference's, which rounds each leaf to
    its own dtype only when it splits its f32 vector into the tree.

    ``row0`` and ``total_rows`` make the state one segment of a flat
    vector on a mesh (``_mesh_round``): its d values are the wire rows
    ``[row0, row0 + ceil(d/128))`` of a message of ``total_rows`` rows,
    and the broadcast's dither is keyed by those global rows.

    Returns the broadcast as a pair of tensors: ``(packed, norms)`` for
    qsgd, else ``_broadcast_qdq``'s ``msg``; ``buf`` ends holding the
    diff."""
    spec = make_quantizer(qcfg.server_quantizer).spec
    beta = qcfg.server_momentum if qcfg.server_momentum else None
    with record_function("server"):
        regions = _side_regions(sides, d, taps is not None)
        saved = [_region_values(r, buf, x_flat, hidden_flat, momentum_flat)
                 for r in regions]
        server_update_(buf, momentum_flat, x_flat, hidden_flat,
                       k=qcfg.buffer_size, beta=beta, lr=qcfg.server_lr,
                       taps=None if taps is None else taps[:3])
        f32 = lambda v: None if v is None else float(np.float32(v))
        _fix_server_update(regions, saved, buf,
                           None if taps is None else taps[:3], d,
                           inv_k=f32(1.0 / qcfg.buffer_size), beta=f32(beta),
                           lr=f32(qcfg.server_lr))
        del saved
    with record_function("broadcast"):
        if spec.kind != "qsgd":
            apply, tap, msg = _broadcast_qdq(spec, buf[:d], k_server,
                                             taps is not None)
            _apply_broadcast(hidden_flat, buf[:d], apply, tap,
                             None if taps is None else taps[3:], sides)
            _shadow(sides, x_flat, hidden_flat, momentum_flat)
            return msg
        sbits = spec.bits
        if chunk_rows is None and total_rows is None:
            packed, norms = kops.qsgd_quantize(buf, k_server, sbits)
        else:
            rows = _ref.rows_for(d) if chunk_rows is None else chunk_rows
            packed, norms = (t[0] for t in kops.qsgd_quantize_rows(
                lambda a, e: buf[None, a:e], d, k_server, sbits, rows,
                device=buf.device, row0=row0, total_rows=total_rows))
        _kq.qsgd_unpack_dequantize(
            packed, norms, sbits, acc=hidden_flat,
            tap_diff=None if taps is None else buf[:d],
            taps=None if taps is None else taps[3:])
        _fix_apply(sides, packed, norms, sbits)
        _shadow(sides, x_flat, hidden_flat, momentum_flat)
    return packed, norms


def _shadow(sides, x_flat, hidden_flat, m_flat) -> None:
    """Each side leaf's x, x-hat and m rounded into its buffer slots."""
    for sd in sides:
        for flat, t in ((x_flat, sd.x), (hidden_flat, sd.hidden),
                        (m_flat, sd.m)):
            flat[sd.off:sd.end] = t


def make_qafel_round(cfg: ModelConfig, qcfg: QAFeLConfig, *,
                     remat: bool = True,
                     window_override: Optional[int] = None,
                     pod_quantized: bool = False, mesh=None,
                     podq_bits: int = 4, taps: bool = False,
                     chunk_rows: Optional[int] = None,
                     on_message: Optional[Callable] = None) -> Callable:
    """The round function for a decoder architecture:
    ``round_fn(state, batch, weights, key) -> (state, metrics)``.

    ``batch`` leaves are (K, P, local_batch, ...) tensors on the state's
    device; ``weights`` the (K,) staleness weights; ``key`` a threefry
    key (``common.prng``). ``metrics["loss"]`` is the mean over the
    clients of their mean step loss (a 0-dim f32 tensor);
    ``"upload_bytes"`` and ``"broadcast_bytes"`` the metered bytes of one
    upload and of the broadcast (``protocol.payload_wire_bytes`` of the
    real payload: ``upload``, ``broadcast_payload``); with ``taps``,
    ``"taps"`` the f32 (7,) tap vector on the state's device (module
    docstring), equal to the reference's bit for bit on equal messages.
    Every quantizer kind runs, on either side (module docstring).
    ``chunk_rows`` and ``remat`` as in the module docstring: neither
    changes a bit of the round (``remat``: on gelu models). The state is updated in place (module
    docstring). ``on_message(kind, index, a, b)``, when given, sees each
    message of the round as it is made: ``("upload", k, ...)`` for client
    k's upload and ``("broadcast", K, ...)``, ``(a, b)`` the message's
    tensors (``message_tensors``; a non-qsgd broadcast as
    ``_broadcast_qdq`` makes it); the tensors are the round's own and are
    freed or overwritten after the call, so a caller that keeps them
    clones them.

    ``mesh`` (a ("data", "model") mesh of ``launch.mesh``) runs the round
    tensor-parallel on this rank's segments and shards (``_mesh_round``,
    module docstring; ``check_mesh_round`` says what it refuses); the
    returned function's ``plan`` is its ``MeshPlan``."""
    if pod_quantized:
        raise NotImplementedError("the pod-quantized round is ROADMAP queue "
                                  "A item 14d")
    if chunk_rows is not None and int(chunk_rows) <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    del podq_bits
    if mesh is not None:
        return _mesh_round(cfg, qcfg, mesh, remat=remat,
                           window_override=window_override, taps=taps,
                           chunk_rows=chunk_rows, on_message=on_message)
    cq = make_quantizer(qcfg.client_quantizer).spec
    sq = make_quantizer(qcfg.server_quantizer).spec

    def loss(params, batch, key):
        del key
        return T.loss_fn(cfg, params, batch, remat=remat,
                         window_override=window_override)[0]

    def round_fn(state: RoundState, batch: Dict[str, torch.Tensor],
                 weights, key):
        k_clients, k_server = prng.split(key)
        if state.flat is None:
            state = RoundState.from_trees(state.x, state.hidden,
                                          state.momentum, state.t)
        layout = TreeLayout.of(state.x)
        d = layout.total_size
        x_flat, hidden_flat, m_flat = state.flat
        sides = _sides(state, layout)
        # the clients read each side leaf of x-hat in its own dtype
        client_hidden = (SplitFlat(hidden_flat,
                                   {sd.off: sd.hidden for sd in sides})
                         if sides else hidden_flat)
        dev = hidden_flat.device
        w = to_device(torch.as_tensor(weights, dtype=torch.float32), dev)
        ckeys = prng.split(k_clients, qcfg.buffer_size)
        # lowrank: fresh clients each round (zero residual, the new one
        # never formed, as the reference's compiled round drops it), the
        # basis rotating with the server step, as in the reference's round
        seeds = _kq.basis_seeds(0, state.t) if cq.kind == "lowrank" else None
        buf = torch.zeros(d, dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(qcfg.buffer_size):
            k_train, k_enc = prng.split(ckeys[k])
            batches_k = {name: v[k] for name, v in batch.items()}
            with record_function("client"):
                out, losses = client_update_flat(
                    loss, qcfg, cq, layout, client_hidden, batches_k,
                    k_train, k_enc, b=1, with_loss=True,
                    chunk_rows=chunk_rows, remat=remat, basis_seed=seeds,
                    new_residual=False)
                payload = upload(cq, out, k_enc, layout, seeds)
            del out
            if k == 0:
                upload_bytes = payload_wire_bytes(payload)
            if on_message is not None:
                on_message("upload", k, *message_tensors(payload))
            with record_function("accumulate"):
                accumulate_upload(buf, payload, w[k:k + 1], cq)
            del payload
            loss_sum = loss_sum + losses.mean()
        partials = (torch.empty((_ref.ROUND_TAP_SUMS, _ref.tap_windows(d)),
                                dtype=torch.float32, device=dev)
                    if taps else None)
        msg = server_half(x_flat, hidden_flat, m_flat, buf, k_server,
                          qcfg=qcfg, d=d, chunk_rows=chunk_rows,
                          taps=partials, sides=sides)
        del buf
        if on_message is not None:
            on_message("broadcast", qcfg.buffer_size, *msg)
        metrics = {"loss": loss_sum / qcfg.buffer_size,
                   "upload_bytes": upload_bytes,
                   "broadcast_bytes": payload_wire_bytes(
                       broadcast_payload(sq, msg, layout))}
        del msg
        if partials is not None:
            with record_function("server"):
                metrics["taps"] = round_taps(partials, w)
            del partials
        state.t += 1
        return state, metrics

    return round_fn


# ---------------------------------------------------------------------------
# The round on a ("data", "model") mesh
# ---------------------------------------------------------------------------


def check_mesh_round(cfg: ModelConfig, qcfg: QAFeLConfig, mesh) -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, for what the
    round on a mesh does not port: every family but the dense attention
    decoders, the quantizers but qsgd, and a "pod" axis."""
    what = None
    if cfg.use_mla:
        what = f"MLA ({cfg.arch_id})"
    elif cfg.n_experts:
        what = f"the MoE layers of {cfg.arch_id} (moe_impl={cfg.moe_impl})"
    elif any(k not in ("attn", "local", "global") for k in cfg.layer_pattern):
        what = f"Mamba2 and the hybrid ({cfg.arch_id})"
    elif cfg.modality == "vlm":
        what = f"the VLM prefix ({cfg.arch_id})"
    elif cfg.modality == "audio":
        what = f"audio codebooks ({cfg.arch_id})"
    elif (make_quantizer(qcfg.client_quantizer).spec.kind != "qsgd"
          or make_quantizer(qcfg.server_quantizer).spec.kind != "qsgd"):
        what = (f"the quantizers {qcfg.client_quantizer} / "
                f"{qcfg.server_quantizer} (qsgd only)")
    if what is not None:
        raise NotImplementedError(f"the round on a model-parallel mesh: "
                                  f"{what} is ROADMAP queue A item 13b.2")
    if "pod" in tuple(mesh.mesh_dim_names):
        raise NotImplementedError("a mesh with a \"pod\" axis is the "
                                  "pod-quantized round, ROADMAP queue A "
                                  "item 14d")


class MeshPlan:
    """The round's layout on ``mesh`` (``_mesh_round``): the parameters'
    global ``layout`` (d coordinates), each leaf's spec
    (``sharding.rules.param_pspecs``) and its shard on this rank, the
    client's ``local_layout`` of the shards, and this rank's segment: the
    flat coordinates ``[a, a + n_l)``, of which ``n_real`` lie below d,
    the wire rows from ``row0`` of ``rows`` in all."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.launch.mesh import flat_group, tensor_parallel
        from repro_torch.sharding import rules as R

        abstract = T.abstract_params(cfg)
        leaves, self.treedef = tree_flatten(abstract)
        self.layout = TreeLayout.of(abstract)
        self.d = d = self.layout.total_size
        self.specs = R.spec_leaves(R.param_pspecs(R.ShardingRules(mesh),
                                                  cfg, abstract))
        self.tp = tensor_parallel(mesh)
        self.shard_dim = []
        local = []
        for leaf, spec in zip(leaves, self.specs):
            axes = [i for i, e in enumerate(spec) if R.spec_axes(e)]
            if any(R.spec_axes(spec[i]) != ("model",) for i in axes):
                raise NotImplementedError(
                    f"a spec {spec} on a mesh: FSDP and expert parallelism "
                    "are ROADMAP queue A item 13b.2")
            dim = axes[0] if axes and self.tp.size > 1 else None
            self.shard_dim.append(dim)
            shape = list(leaf.shape)
            if dim is not None:
                shape[dim] //= self.tp.size
            local.append(torch.empty(shape, dtype=leaf.dtype,
                                     device="meta"))
        self.local_layout = TreeLayout.of(tree_unflatten(self.treedef,
                                                         local))
        self.offsets = np.concatenate([[0], np.cumsum(self.layout.sizes)])
        self.local_offsets = np.concatenate(
            [[0], np.cumsum(self.local_layout.sizes)])
        self.nseg = R.mesh_flat_extent(mesh)
        self.seg = R.flat_segment_index(mesh)
        self.n_l = R.flat_padded_len(d, self.nseg) // self.nseg
        self.a = self.seg * self.n_l
        self.n_real = max(0, min(self.n_l, d - self.a))
        self.rows = _ref.rows_for(d)
        self.row0 = self.a // _ref.LANES
        self.group = flat_group(mesh) if self.nseg > 1 else None

    def leaf(self, seg: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's flat values from the segments ``seg`` (this rank's):
        a view of it with one segment, else the leaf's range broadcast
        piece by piece by the ranks that hold it (a collective of the
        flat group)."""
        off, size = int(self.offsets[i]), self.layout.sizes[i]
        if self.nseg == 1:
            return seg[off:off + size]
        import torch.distributed as dist

        out = torch.empty(size, dtype=seg.dtype, device=seg.device)
        for s in range(off // self.n_l, -(-(off + size) // self.n_l)):
            lo, hi = max(off, s * self.n_l), min(off + size,
                                                 (s + 1) * self.n_l)
            piece = out[lo - off:hi - off]
            if s == self.seg:
                piece.copy_(seg[lo - self.a:hi - self.a])
            dist.broadcast(piece, src=dist.get_global_rank(self.group, s),
                           group=self.group)
        return out

    def shard(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's shard of leaf i from its flat values."""
        t = full.view(self.layout.shapes[i])
        dim = self.shard_dim[i]
        if dim is None:
            return t
        n = t.shape[dim] // self.tp.size
        return t.narrow(dim, self.tp.rank * n, n)

    def client_flat(self, seg: torch.Tensor) -> torch.Tensor:
        """The clients' x-hat shards as one flat vector in
        ``local_layout``: with one segment, a view of it; else cut leaf by
        leaf (one leaf in flight)."""
        if self.nseg == 1:
            return seg[:self.d]
        out = torch.empty(self.local_layout.total_size, dtype=seg.dtype,
                          device=seg.device)
        for i in range(len(self.layout.sizes)):
            lo, hi = self.local_offsets[i], self.local_offsets[i + 1]
            out[lo:hi] = self.shard(self.leaf(seg, i), i).reshape(-1)
        return out

    def segment_rows(self, delta) -> Callable:
        """``rows_fn(a, e)`` of the client's delta (``core.qafel
        .DeltaRows`` in ``local_layout``) on this rank's segment: the
        (1, e - a) f32 values of the segment's elements ``[a, e)``.
        With one "model" rank the shards are the leaves and the rows are
        formed on request; else each leaf's delta is gathered over
        "model" (one leaf in flight) into the segment's f32 values."""
        if self.tp.size == 1:
            return lambda a, e: delta.rows(self.a + a, self.a + e)[None]
        from repro_torch.launch.mesh import all_gather_cat

        seg = torch.zeros(self.n_real, dtype=torch.float32,
                          device=delta.x_hat_flat.device)
        for i in range(len(self.layout.shapes)):
            lo, hi = self.local_offsets[i], self.local_offsets[i + 1]
            part = delta.rows(int(lo), int(hi)).view(
                self.local_layout.shapes[i])
            dim = self.shard_dim[i]
            full = (part if dim is None
                    else all_gather_cat(part, dim, self.tp.group)).reshape(-1)
            off = int(self.offsets[i])
            a, b = max(off, self.a), min(off + full.numel(),
                                         self.a + self.n_real)
            if a < b:
                seg[a - self.a:b - self.a] = full[a - off:b - off]
            del part, full
        return lambda a, e: seg[None, a:e]

    def full_message(self, packed: torch.Tensor, norms: torch.Tensor):
        """The whole message's codes and norms from each segment's (its
        rows below ``rows``; a segment's padding rows zero)."""
        pad = self.n_l // _ref.LANES - packed.shape[0]
        if pad:
            packed = torch.cat([packed, packed.new_zeros(
                (pad,) + tuple(packed.shape[1:]))])
            norms = torch.cat([norms, norms.new_zeros(pad)])
        return self.gather(packed)[:self.rows], self.gather(norms)[:self.rows]

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every segment's ``t`` concatenated along ``dim`` in segment
        order (``t`` itself with one segment)."""
        if self.nseg == 1:
            return t
        from repro_torch.launch.mesh import all_gather_cat
        return all_gather_cat(t, dim, self.group)

    def batch_split(self, batch: Dict[str, torch.Tensor]) -> bool:
        """Whether ``batch_pspecs(batch_dim=2)`` splits the local batch
        over "data"."""
        from types import SimpleNamespace

        from repro_torch.sharding.rules import ShardingRules, batch_pspecs
        if self.tp.data_size == 1:
            return False
        rules = ShardingRules(SimpleNamespace(
            mesh_dim_names=("data", "model"),
            shape=(self.tp.data_size, self.tp.size)))
        specs = batch_pspecs(rules, batch, batch_dim=2)
        return any(len(sp) > 2 and sp[2] is not None
                   for sp in tree_leaves(specs) if isinstance(sp, tuple))


def gather_tree(state: RoundState, name: str, plan: "MeshPlan"):
    """One of a mesh state's trees (``"x"``, ``"hidden"``,
    ``"momentum"``) assembled leaf by leaf on every rank of the flat group
    (a collective; one leaf in flight beside the result)."""
    i = ("x", "hidden", "momentum").index(name)
    seg = state.flat[i]
    leaves = [plan.leaf(seg, j).clone().view(shape)
              for j, shape in enumerate(plan.layout.shapes)]
    return tree_unflatten(plan.treedef, leaves)


def _segment_server(plan: MeshPlan, state: RoundState, buf, w, k_server,
                    *, qcfg: QAFeLConfig, chunk_rows: Optional[int],
                    taps: bool) -> tuple:
    """``server_half`` on this rank's segment from its weighted sum
    ``buf``, at the segment's global rows; with ``taps`` the segments'
    window partials gathered in segment order and finished
    (``round_taps``). Returns the segment's broadcast codes and norms
    and the (7,) taps or None."""
    x_seg, h_seg, m_seg = state.flat
    n, dev = plan.n_real, buf.device
    tw = _ref.tap_windows(n)
    partials = (torch.zeros((_ref.ROUND_TAP_SUMS, tw), dtype=torch.float32,
                            device=dev) if taps else None)
    if n:
        packed, norms = server_half(
            x_seg[:n], h_seg[:n], m_seg[:n], buf, k_server, qcfg=qcfg, d=n,
            chunk_rows=chunk_rows, taps=partials, row0=plan.row0,
            total_rows=plan.rows)
    else:
        bits = make_quantizer(qcfg.server_quantizer).spec.bits
        packed = torch.zeros((0, 16 * bits), dtype=torch.uint8, device=dev)
        norms = torch.zeros(0, dtype=torch.float32, device=dev)
    if partials is None:
        return packed, norms, None
    seg_windows = plan.n_l // _ref.XLA_WINDOW
    if seg_windows != tw:
        partials = torch.cat([partials, partials.new_zeros(
            (_ref.ROUND_TAP_SUMS, seg_windows - tw))], dim=1)
    partials = plan.gather(partials, dim=1)[
        :, :_ref.tap_windows(plan.d)].contiguous()
    with record_function("server"):
        return packed, norms, round_taps(partials, w)


def mesh_server_half(plan: MeshPlan, state: RoundState, uploads, weights,
                     k_server, *, qcfg: QAFeLConfig,
                     chunk_rows: Optional[int] = None,
                     taps: bool = False) -> tuple:
    """The mesh round's server half fed whole upload messages (``uploads``:
    (packed, norms) pairs of d values each, as ``on_message`` shows them):
    each message's rows of this rank's segment added, weighted, into its
    ``buf`` segment (K3), then ``_segment_server``; ``state`` (on the
    mesh) updated in place. Returns the whole broadcast (codes, norms) and
    the taps or None."""
    dev = state.flat[0].device
    w = to_device(torch.as_tensor(weights, dtype=torch.float32), dev)
    bits = make_quantizer(qcfg.client_quantizer).spec.bits
    n = plan.n_real
    r0, r1 = plan.row0, plan.row0 + _ref.rows_for(n)
    buf = torch.zeros(plan.n_l, dtype=torch.float32, device=dev)
    for k, (packed, norms) in enumerate(uploads):
        if n:
            accumulate(buf[:n], packed[r0:r1].contiguous(),
                       norms[r0:r1].contiguous(), w[k:k + 1], bits=bits,
                       d=n)
    packed, norms, tap = _segment_server(plan, state, buf, w, k_server,
                                         qcfg=qcfg, chunk_rows=chunk_rows,
                                         taps=taps)
    return plan.full_message(packed, norms), tap


def _mesh_round(cfg: ModelConfig, qcfg: QAFeLConfig, mesh, *, remat: bool,
                window_override: Optional[int], taps: bool,
                chunk_rows: Optional[int],
                on_message: Optional[Callable]) -> Callable:
    """``make_qafel_round(mesh=)``'s round function (module docstring);
    its ``plan`` attribute is the ``MeshPlan``."""
    from repro_torch.core.qafel import client_update
    from repro_torch.launch.mesh import copy_to_data

    check_mesh_round(cfg, qcfg, mesh)
    plan = MeshPlan(cfg, mesh)
    if taps and plan.nseg > 1 and plan.d % _ref.XLA_WINDOW:
        raise NotImplementedError(
            "the round's taps on a mesh need d a multiple of 32 (no tap "
            "window across two segments); ROADMAP queue A item 13b.2")
    bits = make_quantizer(qcfg.client_quantizer).spec.bits
    sbits = make_quantizer(qcfg.server_quantizer).spec.bits
    n = plan.n_real
    upload_bytes, broadcast_bytes = (payload_wire_bytes(packed_qsgd_payload(
        None, None, b, plan.d, plan.layout)) for b in (bits, sbits))
    # wire rows an upload encode takes at a time (the segment's whole)
    upload_rows = (max(1, _ref.rows_for(n)) if chunk_rows is None
                   else chunk_rows)

    def round_fn(state: RoundState, batch: Dict[str, torch.Tensor],
                 weights, key):
        k_clients, k_server = prng.split(key)
        if state.mesh is None:  # a meshless state, placed once
            state = RoundState.on_mesh(state.x, state.hidden,
                                       state.momentum, mesh, state.t)
        dev = state.flat[0].device
        w = to_device(torch.as_tensor(weights, dtype=torch.float32), dev)
        ckeys = prng.split(k_clients, qcfg.buffer_size)
        split = plan.batch_split(batch)
        tp = plan.tp if split else dataclasses.replace(
            plan.tp, data_size=1, data_rank=0, data_group=None)

        def loss(params, b, key):
            del key
            if split:
                params = tree_map(lambda p: copy_to_data(p, tp), params)
            return T.loss_fn(cfg, params, b, remat=remat,
                             window_override=window_override, tp=tp)[0]

        def rows_of(v):
            if not split:
                return v
            m = v.shape[1] // tp.data_size
            return v[:, tp.data_rank * m:(tp.data_rank + 1) * m]

        client_hidden = plan.client_flat(state.flat[1])
        buf = torch.zeros(plan.n_l, dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(qcfg.buffer_size):
            k_train, k_enc = prng.split(ckeys[k])
            batches_k = {name: rows_of(v[k]) for name, v in batch.items()}
            with record_function("client"):
                delta, losses = client_update(
                    loss, qcfg, plan.local_layout, client_hidden, batches_k,
                    k_train, with_loss=True, remat=remat, streamed=True)
                rows_fn = plan.segment_rows(delta)
                packed, norms = (t[0] for t in kops.qsgd_quantize_rows(
                    rows_fn, n, k_enc, bits, upload_rows, device=dev,
                    row0=plan.row0, total_rows=plan.rows))
                del delta, rows_fn
            if on_message is not None:
                on_message("upload", k, *plan.full_message(packed, norms))
            with record_function("accumulate"):
                if n:
                    accumulate(buf[:n], packed, norms, w[k:k + 1],
                               bits=bits, d=n)
            del packed, norms
            loss_sum = loss_sum + losses.mean()
        del client_hidden
        packed, norms, tap = _segment_server(
            plan, state, buf, w, k_server, qcfg=qcfg, chunk_rows=chunk_rows,
            taps=taps)
        del buf
        if on_message is not None:
            on_message("broadcast", qcfg.buffer_size,
                       *plan.full_message(packed, norms))
        del packed, norms
        metrics = {"loss": loss_sum / qcfg.buffer_size,
                   "upload_bytes": upload_bytes,
                   "broadcast_bytes": broadcast_bytes}
        if tap is not None:
            metrics["taps"] = tap
        state.t += 1
        return state, metrics

    round_fn.plan = plan
    return round_fn


def make_prefill_step(cfg: ModelConfig, *, max_len: Optional[int] = None,
                      window_override: Optional[int] = None,
                      q_block: int = 512, kv_block: int = 512) -> Callable:
    """``prefill_step(params, inputs) -> (logits, cache)``:
    ``transformer.prefill`` with the caches sized for ``max_len`` (the
    attention blocks must divide the prompt's length)."""
    def prefill_step(params, inputs):
        return T.prefill(cfg, params, inputs, max_len=max_len,
                         window_override=window_override, q_block=q_block,
                         kv_block=kv_block)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *,
                     window_override: Optional[int] = None) -> Callable:
    """``decode_step(params, cache, inputs, pos) -> (logits, cache)``:
    ``transformer.decode_step``, the cache written in place."""
    def decode_step(params, cache, inputs, pos):
        return T.decode_step(cfg, params, cache, inputs, pos,
                             window_override=window_override)
    return decode_step
