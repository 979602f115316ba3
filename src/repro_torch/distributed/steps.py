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
  ``remat=False``, which takes ``torch.func.grad``.

**The state is updated in place**, unlike the reference's functional
round: where every leaf has one dtype (every config of ``configs``),
``RoundState`` holds x, x-hat and m as one flat buffer each in that dtype
(``RoundState.flat``), its trees are views of them, and ``round_fn``
updates the buffers and returns the same state with ``t + 1``. A caller
that keeps the state from before a round clones it
(``RoundState.clone``). The memory it saves is what lets gemma2-2b run
at its published depth on one card. A mixed-dtype tree goes through f32
copies of the three vectors and leaves as a new state. x, x-hat and m are
rounded to the leaves' dtype, nearest even, as the reference's
``layout.unflatten`` rounds them every round.

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

``make_prefill_step`` and ``make_decode_step`` wrap ``transformer.prefill``
and ``transformer.decode_step`` (the serving side, ``launch.serve``).

Not ported here: quantizers other than qsgd and the pod-quantized round
(ROADMAP queue A item 14d); each raises ``NotImplementedError`` naming its
item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.common import prng
from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.qafel import QAFeLConfig, client_update_flat
from repro_torch.core.protocol import payload_wire_bytes
from repro_torch.core.quantizers import (TreeLayout, flatten_tree,
                                         make_quantizer, packed_qsgd_payload)
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
    ``(x, hidden, momentum)`` triple of flat buffers whose views the trees
    are (a tree of one dtype; ``from_trees``), or None."""

    x: Any
    hidden: Any
    momentum: Any
    t: int = 0
    flat: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    @staticmethod
    def from_trees(x, hidden, momentum, t: int = 0) -> "RoundState":
        """A state of the three trees: copied into one flat buffer each
        where every leaf has one dtype (the trees then view them), else
        kept as they are."""
        layout = TreeLayout.of(x)
        if len(set(layout.dtypes)) != 1:
            return RoundState(x=x, hidden=hidden, momentum=momentum, t=t)
        dtype = getattr(torch, layout.dtypes[0])
        flats = []
        for tree in (x, hidden, momentum):
            leaves = tree_leaves(tree)
            buf = torch.empty(layout.total_size, dtype=dtype,
                              device=leaves[0].device)
            off = 0
            for leaf, size in zip(leaves, layout.sizes):
                buf[off:off + size].copy_(leaf.reshape(-1))
                off += size
            flats.append(buf)
        trees = [layout.unflatten(f) for f in flats]
        return RoundState(*trees, t=t, flat=tuple(flats))

    def clone(self) -> "RoundState":
        """A copy that later rounds on this state leave untouched."""
        if self.flat is None:
            return RoundState(*(tree_map(torch.clone, tr) for tr in
                                (self.x, self.hidden, self.momentum)),
                              t=self.t)
        flats = tuple(f.clone() for f in self.flat)
        layout = TreeLayout.of(self.x)
        return RoundState(*(layout.unflatten(f) for f in flats), t=self.t,
                          flat=flats)


def init_round_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> RoundState:
    """Random parameters (``transformer.init_params``) as x and x-hat,
    zero momentum, t = 0, on ``device`` (None: the card)."""
    params = T.init_params(cfg, seed, device)
    return RoundState.from_trees(params, params,
                                 tree_map(torch.zeros_like, params))


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


def server_half(x_flat, hidden_flat, momentum_flat, buf, k_server, *,
                qcfg: QAFeLConfig, sbits: int, d: int,
                chunk_rows: Optional[int] = None,
                taps: Optional[torch.Tensor] = None):
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
    2. the broadcast K1 of the diff (threefry dither keyed by
       ``k_server``, ``sbits``-bit qsgd), ``chunk_rows`` rows at a time
       when given;
    3. ``x-hat + q`` with the decode's last product fused into the add,
       ``fma(sign*mag, norm * fl32(1/s), x-hat)``, written over x-hat and
       rounded to its dtype: one K3 launch.

    With ``taps``, an f32 (5, ``ref.tap_windows(d)``) buffer, step 1
    writes rows 0-2 and step 3 rows 3-4 of the taps' level-1 window sums
    (``kernels.taps.round_taps`` finishes them); the launches and every
    other output are the same.

    Returns the broadcast ``(packed, norms)``; ``buf`` ends holding the
    diff."""
    with record_function("server"):
        server_update_(buf, momentum_flat, x_flat, hidden_flat,
                       k=qcfg.buffer_size,
                       beta=(qcfg.server_momentum if qcfg.server_momentum
                             else None), lr=qcfg.server_lr,
                       taps=None if taps is None else taps[:3])
    with record_function("broadcast"):
        if chunk_rows is None:
            packed, norms = kops.qsgd_quantize(buf, k_server, sbits)
        else:
            packed, norms = (t[0] for t in kops.qsgd_quantize_rows(
                lambda a, e: buf[None, a:e], d, k_server, sbits, chunk_rows,
                device=buf.device))
        _kq.qsgd_unpack_dequantize(
            packed, norms, sbits, acc=hidden_flat,
            tap_diff=None if taps is None else buf[:d],
            taps=None if taps is None else taps[3:])
    return packed, norms


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
    upload and of the broadcast (``protocol.payload_wire_bytes``); with
    ``taps``, ``"taps"`` the f32 (7,) tap vector on the state's device
    (module docstring), equal to the reference's bit for bit on equal
    messages. Both
    quantizers are qsgd. ``chunk_rows`` and ``remat`` as in the module
    docstring: neither changes a bit of the round. The state is updated in
    place (module docstring). ``on_message(kind, index, packed, norms)``,
    when given, sees each message of the round as it is made:
    ``("upload", k, ...)`` for client k's upload and ``("broadcast", K,
    ...)``; the tensors are the round's own and are freed or overwritten
    after the call, so a caller that keeps them clones them."""
    if pod_quantized or mesh is not None:
        raise NotImplementedError("the pod-quantized round is ROADMAP queue "
                                  "A item 14d")
    if chunk_rows is not None and int(chunk_rows) <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    del podq_bits
    cq = make_quantizer(qcfg.client_quantizer).spec
    sq = make_quantizer(qcfg.server_quantizer).spec
    for name, spec in (("client", cq), ("server", sq)):
        if spec.kind != "qsgd":
            raise NotImplementedError(
                f"a {spec.kind} {name} quantizer in the round is ROADMAP "
                "queue A item 14d")

    def loss(params, batch, key):
        del key
        return T.loss_fn(cfg, params, batch, remat=remat,
                         window_override=window_override)[0]

    def round_fn(state: RoundState, batch: Dict[str, torch.Tensor],
                 weights, key):
        k_clients, k_server = prng.split(key)
        layout = TreeLayout.of(state.x)
        d = layout.total_size
        if state.flat is not None:
            x_flat, hidden_flat, m_flat = state.flat
        else:  # a mixed-dtype tree: f32 copies, a new state at the end
            x_flat, hidden_flat, m_flat = (
                flatten_tree(tr)[0]
                for tr in (state.x, state.hidden, state.momentum))
        dev = hidden_flat.device
        w = to_device(torch.as_tensor(weights, dtype=torch.float32), dev)
        ckeys = prng.split(k_clients, qcfg.buffer_size)
        buf = torch.zeros(d, dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(qcfg.buffer_size):
            k_train, k_enc = prng.split(ckeys[k])
            batches_k = {name: v[k] for name, v in batch.items()}
            with record_function("client"):
                out, losses = client_update_flat(
                    loss, qcfg, cq, layout, hidden_flat, batches_k, k_train,
                    k_enc, b=1, with_loss=True, chunk_rows=chunk_rows,
                    remat=remat)
            if k == 0:
                upload_bytes = _wire_bytes(out["packed"][0],
                                           out["norms"][0], cq.bits, layout)
            if on_message is not None:
                on_message("upload", k, out["packed"][0], out["norms"][0])
            with record_function("accumulate"):
                accumulate(buf, out["packed"][0], out["norms"][0],
                           w[k:k + 1], bits=cq.bits, d=d)
            del out
            loss_sum = loss_sum + losses.mean()
        partials = (torch.empty((_ref.ROUND_TAP_SUMS, _ref.tap_windows(d)),
                                dtype=torch.float32, device=dev)
                    if taps else None)
        packed, norms = server_half(x_flat, hidden_flat, m_flat, buf,
                                    k_server, qcfg=qcfg, sbits=sq.bits, d=d,
                                    chunk_rows=chunk_rows, taps=partials)
        del buf
        if on_message is not None:
            on_message("broadcast", qcfg.buffer_size, packed, norms)
        metrics = {"loss": loss_sum / qcfg.buffer_size,
                   "upload_bytes": upload_bytes,
                   "broadcast_bytes": _wire_bytes(packed, norms, sq.bits,
                                                  layout)}
        if partials is not None:
            with record_function("server"):
                metrics["taps"] = round_taps(partials, w)
            del partials
        if state.flat is None:
            return RoundState(x=layout.unflatten(x_flat),
                              hidden=layout.unflatten(hidden_flat),
                              momentum=layout.unflatten(m_flat),
                              t=state.t + 1), metrics
        state.t += 1
        return state, metrics

    return round_fn


def _wire_bytes(packed, norms, bits: int, layout) -> float:
    """Metered bytes of one qsgd message of the round (``protocol
    .payload_wire_bytes`` of its payload)."""
    return payload_wire_bytes(packed_qsgd_payload(
        packed, norms, bits, layout.total_size, layout))


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
