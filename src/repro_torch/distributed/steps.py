"""The QAFeL round on a decoder architecture, on one device.

Counterpart of the baseline round of ``repro/distributed/steps.py``
(``make_qafel_round``): the compute of one buffer flush (Algorithm 1 lines
5-16) for a model of ``models.transformer``.

* The K buffered clients run in turn, each P local SGD steps from the
  shared hidden state with its own batch slice: ``core.qafel
  .client_update_flat`` at b = 1 (flat x-hat in, real packed qsgd wire
  codes out: K1, the threefry upload encode), then the server decodes the
  client's own wire bits (K3) and accumulates ``buf + w_k * dec``.
* The server half (``server_half``): ``delta_bar = buf * (1/K)``, the
  FedBuff momentum and update, the broadcast diff ``x_new - x-hat``
  encoded with the threefry dither (K1) and decoded (K3), ``x-hat + q``.
* The state enters and leaves as trees in the leaves' dtypes (bf16 for
  gemma2-2b): ``layout.unflatten`` rounds x, x-hat and m to nearest even
  every round, as the reference's does.

Per round: K + 1 launches of K1 and K + 1 of K3 on the card (each client's
decode and weighted add is one K3 launch, ``accumulate``). The phases run
under ``torch.profiler.record_function`` ranges named ``"client"`` (local
SGD and the K1 upload encode), ``"accumulate"`` (K3 into ``buf``),
``"server"`` (the momentum and the update) and ``"broadcast"`` (K1, K3 and
the hidden-state apply), so a profiled round reads its time by phase. Every product
and sum of the server half rounds where the reference's jitted round
rounds on XLA:CPU (``server_half``), so the wire bits, x, x-hat and m are
the reference's bit for bit for the same client messages; the model math
(forward, gradients) agrees within a tolerance (tests/
test_torch_llm_round.py).

Not ported here: quantizers other than qsgd and the pod-quantized round
(ROADMAP queue A item 14d), ``chunk_rows`` streaming, ``remat`` and the
round's taps (item 13), prefill / decode (item 14b); each raises
``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.common import prng
from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_map
from repro_torch.core.qafel import QAFeLConfig, client_update_flat
from repro_torch.core.protocol import payload_wire_bytes
from repro_torch.core.quantizers import (flatten_tree, make_quantizer,
                                         packed_qsgd_payload)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import fma_f32_
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class RoundState:
    """The round's state: the full-precision server model ``x``, the
    shared hidden state x-hat (``hidden``), the server momentum (trees in
    the leaves' dtypes) and the server step ``t``."""

    x: Any
    hidden: Any
    momentum: Any
    t: int = 0


def init_round_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> RoundState:
    """Random parameters (``transformer.init_params``) as x and x-hat,
    zero momentum, t = 0, on ``device`` (None: the card)."""
    params = T.init_params(cfg, seed, device)
    return RoundState(x=params, hidden=tree_map(torch.clone, params),
                      momentum=tree_map(torch.zeros_like, params), t=0)


def _f32(value: float) -> float:
    return float(np.float32(value))


def accumulate(buf, packed, norms, weight, *, bits: int, d: int):
    """One client's message into the weighted sum: ``buf + w_k * dec``
    with ``dec`` the decode of the packed qsgd codes, rounded, and the
    weight's product fused into the add, ``fma(dec, w_k, buf)``, as
    XLA:CPU compiles the reference round's scan
    (``repro/distributed/steps.py:170``); one K3 launch. ``weight`` is a
    one-element f32 tensor on ``buf``'s device. Returns the new sum (a new
    tensor; ``buf`` is left as it was)."""
    return kops.qsgd_dequantize(packed, norms, bits, d, acc=buf,
                                weight=weight)


def server_half(x_flat, hidden_flat, momentum_flat, buf, k_server, *,
                qcfg: QAFeLConfig, sbits: int, d: int):
    """The server half of the round on flat f32 vectors: from the
    clients' weighted sum ``buf`` (``accumulate``) to ``(x_new,
    hidden_new, m_new, (packed, norms))``, rounded where the reference's
    jitted round rounds on XLA:CPU (``repro/distributed/steps.py:172-194``,
    read from its optimised program and pinned by tests): ``delta_bar =
    buf * fl32(1/K)``; the momentum's product fused into its add, ``m_new
    = fma(m, beta, delta_bar)``; ``x_new = m_new + x`` (XLA drops the
    product by a server lr of 1, else ``fma(m_new, lr, x)``); ``diff =
    x_new - x-hat``; the broadcast K1 of the diff (threefry dither keyed
    by ``k_server``, ``sbits``-bit qsgd); ``x-hat + q`` with the decode's
    last product fused into the add, ``fma(sign*mag, norm * fl32(1/s),
    x-hat)``, one K3 launch.

    ``buf`` is overwritten (it becomes ``m_new``); the momentum's and the
    server lr's multiply-adds are the plain single-rounded ``ref.fma_f32_``
    in chunks (no float64 vector of length d), the one pass over d of the
    round not in a kernel (ROADMAP queue A item 13)."""
    with record_function("server"):
        m_new = buf.mul_(_f32(1.0 / qcfg.buffer_size))
        if qcfg.server_momentum:
            fma_f32_(momentum_flat, _f32(qcfg.server_momentum), m_new)
        if qcfg.server_lr == 1.0:
            x_new = m_new + x_flat
        else:
            x_new = fma_f32_(m_new, _f32(qcfg.server_lr), x_flat.clone())
        diff = x_new - hidden_flat
    with record_function("broadcast"):
        packed, norms = kops.qsgd_quantize(diff, k_server, sbits)
        del diff
        hidden_new = kops.qsgd_dequantize(packed, norms, sbits, d,
                                          acc=hidden_flat)
    return x_new, hidden_new, m_new, (packed, norms)


def make_qafel_round(cfg: ModelConfig, qcfg: QAFeLConfig, *,
                     remat: bool = False,
                     window_override: Optional[int] = None,
                     pod_quantized: bool = False, mesh=None,
                     podq_bits: int = 4, taps: bool = False,
                     chunk_rows: Optional[int] = None) -> Callable:
    """The round function for a decoder architecture:
    ``round_fn(state, batch, weights, key) -> (state, metrics)``.

    ``batch`` leaves are (K, P, local_batch, ...) tensors on the state's
    device; ``weights`` the (K,) staleness weights; ``key`` a threefry
    key (``common.prng``). ``metrics["loss"]`` is the mean over the
    clients of their mean step loss (a 0-dim f32 tensor);
    ``"upload_bytes"`` and ``"broadcast_bytes"`` the metered bytes of one
    upload and of the broadcast (``protocol.payload_wire_bytes``). Both
    quantizers are qsgd.

    ``remat`` (the reference's default is True) raises: the round's
    activations at the example's sequence length are small, and
    ``torch.func.grad`` cannot run ``torch.utils.checkpoint``."""
    if remat:
        raise NotImplementedError(
            "remat inside the round: local SGD takes torch.func.grad, which "
            "does not run torch.utils.checkpoint; a recomputing "
            "autograd.Function is ROADMAP queue A item 13 (the full-depth "
            "round's memory levers)")
    if pod_quantized or mesh is not None:
        raise NotImplementedError("the pod-quantized round is ROADMAP queue "
                                  "A item 14d")
    if chunk_rows is not None:
        raise NotImplementedError("chunk_rows streaming is ROADMAP queue A "
                                  "item 13")
    if taps:
        raise NotImplementedError("the round's taps are ROADMAP queue A "
                                  "item 13")
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
        hidden_flat, layout = flatten_tree(state.hidden)
        d = layout.total_size
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
                    k_enc, b=1, with_loss=True)
            if k == 0:
                upload_bytes = _wire_bytes(out["packed"][0],
                                           out["norms"][0], cq.bits, layout)
            with record_function("accumulate"):
                buf = accumulate(buf, out["packed"][0], out["norms"][0],
                                 w[k:k + 1], bits=cq.bits, d=d)
            del out
            loss_sum = loss_sum + losses.mean()
        x_flat = flatten_tree(state.x)[0]
        m_flat = flatten_tree(state.momentum)[0]
        x_new, hidden_new, m_new, (packed, norms) = server_half(
            x_flat, hidden_flat, m_flat, buf, k_server, qcfg=qcfg,
            sbits=sq.bits, d=d)
        del x_flat, m_flat, buf, hidden_flat
        new_state = RoundState(x=layout.unflatten(x_new),
                               hidden=layout.unflatten(hidden_new),
                               momentum=layout.unflatten(m_new),
                               t=state.t + 1)
        return new_state, {"loss": loss_sum / qcfg.buffer_size,
                           "upload_bytes": upload_bytes,
                           "broadcast_bytes": _wire_bytes(packed, norms,
                                                          sq.bits, layout)}

    return round_fn


def _wire_bytes(packed, norms, bits: int, layout) -> float:
    """Metered bytes of one qsgd message of the round (``protocol
    .payload_wire_bytes`` of its payload)."""
    return payload_wire_bytes(packed_qsgd_payload(
        packed, norms, bits, layout.total_size, layout))


def make_prefill_step(*args, **kwargs):
    raise NotImplementedError("prefill is ROADMAP queue A item 14b")


def make_decode_step(*args, **kwargs):
    raise NotImplementedError("decode_step is ROADMAP queue A item 14b")
