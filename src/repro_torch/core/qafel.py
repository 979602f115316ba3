"""QAFeL: Quantized Asynchronous Federated Learning (Algorithms 1-3).

Counterpart of ``repro/core/qafel.py`` on one device. The algorithm is
generic over the task: a ``loss_fn(params, batch, key) -> scalar tensor``
over a nested-dict parameter tree.

The client side is one entry for one client and for a cohort:
``client_update_flat`` binds ``client_update`` to the task and hands it to
``kernels.ops.cohort_train_encode_step``, which trains b clients from the
flat x-hat (under ``torch.func.vmap`` for b > 1) and encodes their (b, d)
delta stack in one launch. The server state is flat: ``x``, ``x-hat`` and
the momentum are f32 vectors in the coordinate space of one
``TreeLayout``, on the run's device. A flush is
``kernels.ops.server_flush_step``: the fused dequantize-accumulate of the
K packed uploads, momentum and server update, the broadcast quantize-pack
and the hidden-state apply of the decoded broadcast bits. A top_k, rand_k
or lowrank server quantizer takes a short non-fused chain instead (the
window's reduce, the update, ``Quantizer.encode_flat`` of the diff and the
apply of its decode).

Lowrank uploads project each client's delta onto a basis that rotates
every server step (``round_basis_seed``: the run's ``basis_seed`` and the
model version; both sides derive it, no bytes ship), and each client
carries what its quantized subspace message failed to carry as an
error-feedback residual. The server holds the residuals here, as the
reference's simulator does, keyed by client id.

FedBuff is QAFeL with identity quantizers (``core.fedbuff``).

``QAFeL(chunk_rows=)`` encodes each upload that many wire rows at a time,
bit for bit the unchunked codes, forming a b = 1 qsgd delta chunk by
chunk; ``run_client_stream`` sends the upload as row-chunk messages,
which ``receive`` reassembles (``UpdateBuffer.add_encoded_chunks``) and
meters as one upload of the unstreamed message's bytes.

``QAFeL(..., mesh=)`` (a ``launch.mesh`` mesh over an initialised
``torch.distributed`` group) lays the server state over the mesh's flat
segments: each rank holds its contiguous segment of x, x-hat and the
momentum (``ServerState``, ``place_flat_on_mesh``) and runs the flush on
it (``kernels.ops.server_flush_step_sharded``); every rank runs the same
host protocol from the same seeds, so the buffer, the meters and the
messages are the same on each. The segments meet in all-gathers only: the
broadcast's payload rows, the full x-hat a client trains from, the tree
views, the sparse server chain and ``hidden_drift``, the cohort step's
member slices. Every bit is the meshless run's.

``QAFeL(..., telemetry=tracer)`` attaches an ``obs.RunTracer``: one typed
event per upload, drop, flush and broadcast and, when the tracer has
``taps=True``, the client step's and the flush's metric taps on them (one
more launch each). Without a tracer every launch and bit is as before.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import (tree_flatten, tree_leaves, weak_scalar,
                                     tree_unflatten)
from repro_torch.core.buffer import UpdateBuffer
from repro_torch.core.hidden_state import HiddenState
from repro_torch.core.protocol import (CLIENT_UPDATE, HIDDEN_BROADCAST,
                                       Message, TrafficMeter,
                                       encode_message_flat,
                                       frame_chunk_messages,
                                       frame_cohort_messages,
                                       frame_packed_message,
                                       packed_qsgd_chunk_payload)
from repro_torch.core.quantizers import (Quantizer, TreeLayout, flatten_tree,
                                         make_quantizer,
                                         packed_identity_payload,
                                         packed_qsgd_payload)
from repro_torch.core.staleness import StalenessMonitor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import fma_f32
from repro_torch.obs.taps import named_cohort_taps, named_flush_taps


@dataclasses.dataclass(frozen=True)
class QAFeLConfig:
    client_lr: float = 0.01
    server_lr: float = 1.0
    server_momentum: float = 0.0  # FedBuff's beta (0.3 in the paper's runs)
    buffer_size: int = 10  # K
    local_steps: int = 1  # P
    client_quantizer: Any = "qsgd4"  # "identity" -> FedBuff upload
    server_quantizer: Any = "qsgd4"
    staleness_scaling: bool = True  # 1/sqrt(1+tau) down-weighting
    # 0 = unbounded; > 0 rejects uploads with tau > max_staleness before
    # they reach the buffer (counted in the TrafficMeter / StalenessMonitor)
    max_staleness: int = 0

    def cq(self) -> Quantizer:
        return make_quantizer(self.client_quantizer)

    def sq(self) -> Quantizer:
        return make_quantizer(self.server_quantizer)


# ---------------------------------------------------------------------------
# Round math
# ---------------------------------------------------------------------------


def _sgd_leaf_(y: torch.Tensor, g: torch.Tensor, lr: float,
               inplace: bool) -> torch.Tensor:
    """One step ``y - lr*g`` of one leaf in its dtype, as the reference's
    jitted scan body compiles it on XLA:CPU (read from its optimised HLO):
    an f32 leaf is one fused multiply-add, ``fma(-lr, g, y)``; a bf16 leaf
    keeps both of the reference's bf16 roundings, the Python float ``lr``
    being weakly typed: ``p = bf16(g * bf16(lr))``, then ``bf16(y - p)``,
    each op in f32. ``inplace`` writes the step over ``y`` (and a bf16
    leaf's ``g``)."""
    lr32 = float(np.float32(lr))  # the f32 learning rate, as XLA has it
    if y.dtype == torch.float32:
        new = fma_f32(g.to(torch.float32), -lr32, y)
        return y.copy_(new) if inplace else new
    if y.dtype != torch.bfloat16:
        raise ValueError(f"local SGD on a {y.dtype} leaf")
    prod = g.to(torch.bfloat16).mul_(
        float(torch.tensor(lr32).to(torch.bfloat16)))
    return y.sub_(prod) if inplace else y - prod


def _local_sgd(loss_fn: Callable, lr: float, layout: TreeLayout, y0_flat,
               batches, keys, *, with_loss: bool, remat: bool):
    """``local_sgd``'s loop. Returns ``(y_flat, leaves, losses)``:
    ``y_flat`` the final flat f32 parameters of an all-f32 layout (None
    otherwise) and ``leaves`` the final leaves, views of it where it
    exists."""
    if remat:
        def step_fn(tree, batch, key):
            leaves, treedef = tree_flatten(tree)
            leaves = [t.detach().requires_grad_() for t in leaves]
            loss = loss_fn(tree_unflatten(treedef, leaves), batch, key)
            grads = torch.autograd.grad(loss, leaves)
            g = tree_unflatten(treedef, list(grads))
            return (g, loss.detach()) if with_loss else g
    else:
        step_fn = (torch.func.grad_and_value(loss_fn) if with_loss
                   else torch.func.grad(loss_fn))
    f32 = all(dt == "float32" for dt in layout.dtypes)
    y_flat = y0_flat.to(torch.float32) if f32 else None
    leaves = tree_leaves(layout.unflatten(y0_flat))
    losses = []
    for p in range(len(keys)):
        batch = {k: v[p] for k, v in batches.items()}
        out = step_fn(tree_unflatten(layout.treedef, leaves), batch, keys[p])
        g = out[0] if with_loss else out
        if with_loss:
            losses.append(out[1].detach().to(torch.float32))
        if f32:
            g_flat = torch.cat([gi.reshape(-1) for gi in tree_leaves(g)])
            y_flat = fma_f32(g_flat, -float(np.float32(lr)), y_flat)
            leaves = tree_leaves(layout.unflatten(y_flat))
            del g_flat
        else:
            leaves = [_sgd_leaf_(yi, gi, lr, inplace=p > 0)
                      for yi, gi in zip(leaves, tree_leaves(g))]
        del g, out
    return (y_flat if f32 else None), leaves, (
        torch.stack(losses) if with_loss else None)


def local_sgd(loss_fn: Callable, lr: float, layout: TreeLayout, y0_flat,
              batches, keys, *, with_loss: bool = False,
              remat: bool = False):
    """Algorithm 2 lines 2-4: P plain SGD steps from the flat ``y0_flat``
    (``layout``'s coordinates, f32 or the leaves' one dtype), step p on
    ``batches[..][p]`` with ``keys[p]``; the loss sees the parameter
    tree, in each leaf's dtype. Returns the final parameter tree, and
    with ``with_loss`` also the (P,) losses of the steps (the distributed
    round's metric).

    Each step rounds as the reference's jitted scan body on XLA:CPU (read
    from its optimised HLO): an all-f32 tree steps its flat vector with
    one fused multiply-add, ``fma(-lr, g, y)`` (with a separately rounded
    product the two packages drift apart by an ulp per step even where
    their gradients agree bit for bit); a bf16 leaf keeps both of the
    reference's bf16 roundings, and any other tree steps leaf by leaf
    (``_sgd_leaf_``). y stays in the leaves' dtypes: the first step writes
    new leaves, the later ones step them in place, so no f32 vector of
    length d is built for a bf16 model.

    ``remat=True`` takes the gradient with ``torch.autograd.grad``, under
    which a loss that wraps its blocks in ``torch.utils.checkpoint``
    recomputes them in the backward pass (``torch.func.grad``, the
    default, does not run the checkpoint); the values are the same. It
    does not run under ``torch.func.vmap``."""
    _, leaves, losses = _local_sgd(loss_fn, lr, layout, y0_flat, batches,
                                   keys, with_loss=with_loss, remat=remat)
    tree = tree_unflatten(layout.treedef, leaves)
    return (tree, losses) if with_loss else tree


def local_sgd_scan(loss_fn: Callable, lr: float, y0, batches, keys, *,
                   with_loss: bool = False):
    """The reference's ``local_sgd_scan`` on a parameter tree ``y0``:
    ``local_sgd`` in the tree's own coordinates. Returns ``(y_final,
    losses-or-None)``, the (P,) step losses with ``with_loss``."""
    y0_flat, layout = flatten_tree(y0)
    out = local_sgd(loss_fn, lr, layout, y0_flat, batches, keys,
                    with_loss=with_loss)
    return out if with_loss else (out, None)


def server_apply(qcfg: "QAFeLConfig", x, momentum, delta_bar):
    """The FedBuff server update on trees (the reference's
    ``server_apply``, called eagerly): ``m = beta * m + delta_bar`` and
    ``x = lr * m + x`` leaf by leaf, each product and sum rounded on its
    own in the leaves' dtypes (a Python float meets a leaf in its dtype,
    ``common.tree.weak_scalar``). Returns ``(x_new, momentum_new)``."""
    beta = qcfg.server_momentum if qcfg.server_momentum else None
    lr = qcfg.server_lr

    def step(xi, mi, di):
        m = di if beta is None else (weak_scalar(beta, mi) * mi + di).to(
            di.dtype)
        return (weak_scalar(lr, m) * m + xi).to(xi.dtype), m

    out = [step(xi, mi, di) for xi, mi, di in zip(
        tree_leaves(x), tree_leaves(momentum), tree_leaves(delta_bar))]
    treedef = tree_flatten(x)[1]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))


class DeltaRows:
    """A client's delta ``y_P - y_0`` in the flat wire coordinates, formed
    on request one element range at a time (``rows(a, b)``): each leaf's
    segment ``y - x_hat`` in f32, rounded to the leaf's dtype as the
    reference subtracts its trees, as f32. The row-chunked upload encodes
    it chunk by chunk, so no f32 vector of length d is built."""

    def __init__(self, layout: TreeLayout, y_flat, leaves, x_hat_flat):
        self.layout, self.y_flat, self.leaves = layout, y_flat, leaves
        self.x_hat_flat = x_hat_flat
        self.n = layout.total_size

    def rows(self, a: int, b: int) -> torch.Tensor:
        """The f32 delta of flat elements ``[a, b)``."""
        if self.y_flat is not None:
            return (self.y_flat[a:b]
                    - self.x_hat_flat[a:b].to(torch.float32))
        pieces, off = [], 0
        for leaf, size in zip(self.leaves, self.layout.sizes):
            lo, hi = max(a, off), min(b, off + size)
            if lo < hi:
                d = (leaf.reshape(-1)[lo - off:hi - off].to(torch.float32)
                     - self.x_hat_flat[lo:hi].to(torch.float32))
                pieces.append(d if leaf.dtype == torch.float32 else
                              d.to(leaf.dtype).to(torch.float32))
            off += size
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def client_update(loss_fn: Callable, qcfg: QAFeLConfig, layout: TreeLayout,
                  x_hat_flat, batches, key, *, with_loss: bool = False,
                  remat: bool = False, streamed: bool = False):
    """Algorithm 2: y_0 <- x-hat; P local SGD steps; delta = y_P - y_0
    (the text's sign convention, as in the reference), in ``layout``'s
    flat coordinates; a bf16 leaf's delta is rounded to bf16, as the
    reference subtracts its trees. ``batches`` leaves have leading dim P.
    Returns the unquantized flat f32 delta, or with ``streamed`` a
    ``DeltaRows`` that forms it one range at a time; with ``with_loss``
    also the (P,) losses. ``remat`` as in ``local_sgd``."""
    keys = prng.split(key, qcfg.local_steps)
    y_flat, leaves, losses = _local_sgd(
        loss_fn, qcfg.client_lr, layout, x_hat_flat, batches, keys,
        with_loss=with_loss, remat=remat)
    delta = DeltaRows(layout, y_flat, leaves, x_hat_flat)
    if not streamed:
        delta = delta.rows(0, delta.n)
    return (delta, losses) if with_loss else delta


def client_update_flat(loss_fn: Callable, qcfg: QAFeLConfig, spec, layout,
                       hidden_flat, batches, k_train, k_enc, *, b: int = 1,
                       member_chunk: Optional[int] = None,
                       taps: bool = False, residual=None,
                       basis_seed=None, with_loss: bool = False,
                       chunk_rows: Optional[int] = None,
                       remat: bool = False, new_residual: bool = True,
                       mesh=None):
    """Flat x-hat in, wire payloads out, for one client (b = 1) or a
    cohort tier group of b members: ``client_update`` on this task, run by
    ``kernels.ops.cohort_train_encode_step`` (vmapped over the members for
    b > 1, then one encode launch over the (b, d) delta stack: K1 at
    b = 1, K2 above). A lowrank ``spec`` takes the members' (b, d)
    ``residual`` stack and the round's ``basis_seed`` pair.

    Returns ``{"packed", "norms"}`` stacks for qsgd (lowrank: over the
    rank coordinates, and the new ``"residual"`` stack), ``{"flat"}`` for
    identity and the sparse kinds, and with ``taps`` the ``"taps"`` rows;
    ``with_loss`` returns ``(out, losses)``, the members' (b, P) (at b = 1
    (P,)) step losses, the distributed round's metric.

    ``chunk_rows`` encodes the upload ``chunk_rows`` wire rows at a time,
    bit for bit the unchunked codes; a qsgd upload at b = 1 forms its
    delta chunk by chunk too (``kernels.ops.cohort_train_encode_step``).
    ``remat`` takes local SGD's gradient through ``torch.autograd``
    (``local_sgd``), at b = 1 only. ``new_residual=False``: a lowrank
    caller that never reads the new residual, which is then not formed.
    ``mesh``: b > 1 members over its data ranks, each from the full x-hat
    (``kernels.ops.cohort_train_encode_step``).
    """
    lowrank = spec.kind == "lowrank"
    if lowrank and basis_seed is None:
        raise ValueError("a lowrank client step needs the round's basis "
                         "seed pair")
    if remat and b > 1:
        raise NotImplementedError(
            "remat under the vmapped cohort step (b > 1): torch.func.vmap "
            "does not run torch.autograd.grad; ROADMAP queue A item 13b.2")
    return kops.cohort_train_encode_step(
        functools.partial(client_update, loss_fn, qcfg, layout,
                          with_loss=with_loss, remat=remat), hidden_flat,
        batches, k_train, k_enc, b=b, with_loss=with_loss,
        bits=spec.bits if spec.kind in ("qsgd", "lowrank") else None,
        member_chunk=member_chunk, taps=taps,
        group=spec.group if lowrank else None, basis_seed=basis_seed,
        residual=residual, chunk_rows=chunk_rows, new_residual=new_residual,
        mesh=mesh)


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def segment_rows(v: torch.Tensor, r0: int, count: int) -> torch.Tensor:
    """Rows ``[r0, r0 + count)`` along dim 1 of ``v``, zero past its end
    (a fresh contiguous tensor)."""
    out = torch.zeros((v.shape[0], count) + tuple(v.shape[2:]),
                      dtype=v.dtype, device=v.device)
    r1 = min(v.shape[1], r0 + count)
    if r1 > r0:
        out[:, :r1 - r0] = v[:, r0:r1]
    return out


def _check_upload(payload) -> None:
    """Raise unless ``payload`` is a well-formed packed upload, before the
    server counts it."""
    kind = payload.get("kind") if isinstance(payload, dict) else None
    if kind is None or payload.get("format") != "packed":
        raise ValueError("the port decodes packed uploads only")
    if kind in ("qsgd", "lowrank"):
        if (payload["packed"].shape[-1] != 16 * payload["bits"]
                or payload["norms"].shape[-1] != payload["packed"].shape[0]):
            raise ValueError(f"corrupt {kind}{payload['bits']} upload: codes "
                             f"{tuple(payload['packed'].shape)}, norms "
                             f"{tuple(payload['norms'].shape)}")
    elif kind in ("top_k", "rand_k"):
        idx, vals = payload.get("idx"), payload.get("vals")
        if (idx is None or vals is None or idx.dim() != 1
                or vals.shape != idx.shape or idx.numel() > payload["n"]):
            raise ValueError(f"corrupt {kind} upload: it needs 1-D idx and "
                             f"vals of one length, at most n={payload['n']}")
    elif kind != "identity":
        raise ValueError(f"unknown upload kind {kind!r}")


def place_flat_on_mesh(flat: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """This rank's segment of a flat f32 vector of true length n (any
    padding past n is ignored): the vector zero-padded to the mesh's
    segment-aligned length (``sharding.rules.flat_padded_len``) and cut
    into ``mesh_flat_extent`` equal segments, ``flat_segment_index``'s.
    Always a fresh tensor on ``flat``'s device."""
    from repro_torch.sharding.rules import (flat_padded_len,
                                            flat_segment_index,
                                            mesh_flat_extent)

    nseg = mesh_flat_extent(mesh)
    n_l = flat_padded_len(n, nseg) // nseg
    a = flat_segment_index(mesh) * n_l
    out = torch.zeros(n_l, dtype=torch.float32, device=flat.device)
    b = min(n, a + n_l)
    if b > a:
        out[:b - a] = flat.reshape(-1)[a:b]
    return out


@dataclasses.dataclass
class ServerState:
    """Flat server state: the full-precision model ``x``, the shared
    hidden state ``x-hat`` and the momentum, in one layout's coordinates;
    ``t`` is the server step (model version). With a ``mesh`` the three
    are this rank's segments (``place_flat_on_mesh``) and ``full``
    gathers one to the true length n, once a step (the gathers are
    collectives: every rank of the mesh takes them in the same order,
    which the replicated host protocol gives)."""

    x_flat: torch.Tensor
    hidden_flat: torch.Tensor
    momentum_flat: torch.Tensor
    layout: TreeLayout
    t: int = 0
    mesh: Any = dataclasses.field(default=None, repr=False, compare=False)
    _full: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @staticmethod
    def init(params0, device, mesh=None) -> "ServerState":
        flat, layout = flatten_tree(params0, device)
        if mesh is not None:
            n = layout.total_size
            return ServerState(
                x_flat=place_flat_on_mesh(flat, mesh, n),
                hidden_flat=place_flat_on_mesh(flat, mesh, n),
                momentum_flat=place_flat_on_mesh(torch.zeros_like(flat),
                                                 mesh, n),
                layout=layout, t=0, mesh=mesh)
        return ServerState(x_flat=flat, hidden_flat=flat.clone(),
                           momentum_flat=torch.zeros_like(flat),
                           layout=layout, t=0)

    @property
    def n(self) -> int:
        return self.layout.total_size

    def full(self, name: str) -> torch.Tensor:
        """The flat vector ``name`` ("x_flat", "hidden_flat" or
        "momentum_flat") at its true length n: the tensor itself without a
        mesh, else its segments gathered (cached for this step)."""
        v = getattr(self, name)
        if self.mesh is None:
            return v
        if name not in self._full:
            from repro_torch.launch.mesh import gather_segments
            self._full[name] = gather_segments(v, self.mesh)[:self.n]
        return self._full[name]

    @property
    def x(self):
        """Tree view of the full-precision server model."""
        return self.layout.unflatten(self.full("x_flat"))

    @property
    def hidden_tree(self):
        """Tree view of the shared hidden state x-hat."""
        return self.layout.unflatten(self.full("hidden_flat"))

    @property
    def hidden(self) -> HiddenState:
        """x-hat as a ``HiddenState``: ``state.hidden.value`` is its tree."""
        return HiddenState(value=self.hidden_tree)


class QAFeL:
    """Server and client logic of Algorithms 1-3, driven by an event loop
    (``sim.events``). ``device=None`` means CUDA; the tests pass "cpu".
    ``telemetry`` is an ``obs.RunTracer`` or None (module docstring).
    ``basis_seed`` keys the lowrank sketch bases of the run. ``mesh``
    lays the server state over a mesh's flat segments (module
    docstring); ``device`` is then this rank's."""

    def __init__(self, qcfg: QAFeLConfig, loss_fn: Callable, params0,
                 device=None, telemetry=None, basis_seed: int = 0,
                 chunk_rows: Optional[int] = None, mesh=None):
        self.qcfg = qcfg
        # encode the client uploads this many wire rows at a time (bit for
        # bit the unchunked codes); the streamed uplink's default chunk
        if chunk_rows is not None and int(chunk_rows) <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.chunk_rows = None if chunk_rows is None else int(chunk_rows)
        # streamed uploads in flight, by (client, stream, version), and
        # the ids of the streams this instance frames
        self._pending_chunks: Dict[Any, list] = {}
        self._stream_ids = itertools.count()
        self.basis_seed = int(basis_seed)
        # lowrank error-feedback residuals, one (d,) row per client id
        self._residuals: Dict[Any, torch.Tensor] = {}
        self.telemetry = telemetry
        self._taps = bool(telemetry is not None and telemetry.taps)
        self.loss_fn = loss_fn
        self.cq = qcfg.cq()
        self.sq = qcfg.sq()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.state = ServerState.init(params0, self.device, mesh)
        self.buffer = UpdateBuffer(capacity=qcfg.buffer_size,
                                   quantizer=self.cq)
        self.meter = TrafficMeter()
        self.staleness = StalenessMonitor(max_allowed=qcfg.max_staleness)

    # -- client side ------------------------------------------------------
    def round_basis_seed(self) -> torch.Tensor:
        """The (2,) sketch basis seed pair of the current round, keyed by
        the run's ``basis_seed`` and the server step: the basis rotates
        every step, so error feedback reaches the whole space."""
        from repro_torch.kernels import qsgd as _kq
        return _kq.basis_seeds(self.basis_seed, self.state.t)

    def client_residuals(self, clients) -> torch.Tensor:
        """The (b, d) error-feedback residual stack of ``clients`` (one id
        per member; an id not seen yet starts at zero), on the state's
        device."""
        zero = None
        rows = []
        for cid in clients:
            r = self._residuals.get(cid)
            if r is None:
                if zero is None:
                    zero = torch.zeros(self.state.n, dtype=torch.float32,
                                       device=self.state.x_flat.device)
                r = zero
            rows.append(r)
        return torch.stack(rows)

    def store_residuals(self, clients, residual2d) -> None:
        """Keep row i of a client step's new residual stack for
        ``clients[i]`` (padding rows already dropped)."""
        for i, cid in enumerate(clients):
            self._residuals[cid] = residual2d[i]

    def run_client(self, batches, key, client=None) -> Tuple[Message, int]:
        """Algorithm 2 on the CURRENT hidden state; returns (message,
        version). ``k_train, k_enc = split(key)`` as in the reference. The
        client step is ``client_update_flat`` at b = 1, the entry the
        cohort engine takes at b = cohort_size, so both engines share one
        client path. ``client`` keys a lowrank upload's residual (None is
        one shared slot). With taps on, the upload's taps ride in
        ``msg.meta["taps"]``."""
        k_train, k_enc = prng.split(key)
        st = self.state
        kw = {}
        if self.cq.spec.kind == "lowrank":
            kw = {"residual": self.client_residuals([client]),
                  "basis_seed": self.round_basis_seed()}
        out = client_update_flat(self.loss_fn, self.qcfg, self.cq.spec,
                                 st.layout, st.full("hidden_flat"), batches,
                                 k_train, k_enc, taps=self._taps,
                                 chunk_rows=self.chunk_rows, **kw)
        if kw:
            self.store_residuals([client], out["residual"])
        msg = frame_cohort_messages(CLIENT_UPDATE, self.cq, out, st.layout,
                                    [k_enc], version=st.t,
                                    basis_seed=kw.get("basis_seed"))[0]
        if self._taps:
            msg.meta["taps"] = named_cohort_taps(out["taps"][0])
        return msg, st.t

    def run_client_stream(self, batches, key, *,
                          chunk_rows: Optional[int] = None,
                          client=None) -> Tuple[list, int]:
        """Algorithm 2 with a streamed uplink: local SGD as in
        ``run_client`` (``k_train, k_enc = split(key)``), then the delta
        formed and encoded ``chunk_rows`` wire rows at a time (the
        argument, else ``QAFeL(chunk_rows=)``), each chunk one K1 launch
        at its global row offset (``kernels.ops.qsgd_encode_chunks``): the
        chunks reassemble to ``run_client``'s message bit for bit, and
        neither the f32 delta nor the whole message is built. Returns
        ``(chunk messages, version)``; each message's meta carries the
        ``version``, a ``stream`` id no other stream of this instance has
        and, when given, the ``client`` id. ``receive`` takes the messages
        in any order, interleaved with other streams, and buffers the
        upload when its chunks hold all its rows. qsgd client quantizers
        only."""
        if self.cq.spec.kind != "qsgd":
            raise ValueError("streamed uploads are defined for qsgd client "
                             f"quantizers (got {self.cq.spec.kind!r})")
        c = self.chunk_rows if chunk_rows is None else int(chunk_rows)
        if c is None or c <= 0:
            raise ValueError("run_client_stream needs a positive chunk_rows "
                             "(argument or QAFeL(chunk_rows=...))")
        k_train, k_enc = prng.split(key)
        st = self.state
        delta = client_update(self.loss_fn, self.qcfg, st.layout,
                              st.full("hidden_flat"), batches, k_train,
                              streamed=True)
        n, bits = st.n, self.cq.spec.bits
        rows = kops.rows_for(n)
        chunks = [packed_qsgd_chunk_payload(p_c, n_c, bits, n, st.layout,
                                            row0=r0, seq=i, last=r1 == rows)
                  for i, (r0, r1, p_c, n_c) in enumerate(
                      kops.qsgd_encode_chunks(delta.rows, n, k_enc, bits, c))]
        msgs = frame_chunk_messages(CLIENT_UPDATE, self.cq, chunks,
                                    st.layout, version=st.t,
                                    stream=next(self._stream_ids),
                                    client=client)
        return msgs, st.t

    # -- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, path) -> None:
        """Write the server state, the buffer's window and the meters
        (``core.checkpoint``)."""
        from repro_torch.core.checkpoint import save_checkpoint
        save_checkpoint(path, self)

    def load_checkpoint(self, path) -> "QAFeL":
        """Restore a ``save_checkpoint`` archive into this instance (the
        layout is verified against this model). Returns self."""
        from repro_torch.core.checkpoint import load_checkpoint
        return load_checkpoint(path, self)

    # -- server side ------------------------------------------------------
    def receive(self, msg: Message, key,
                n_receivers: int = 1) -> Optional[Message]:
        """Algorithm 1 lines 5-16: buffer the upload; at K uploads flush
        and return the broadcast message. An upload of the client
        quantizer is buffered packed (undecoded); one of another bit width,
        kind or sketch group — a tier's — is decoded on arrival (K3 at its
        own bits for qsgd and lowrank) into the buffer's flat sum.
        ``n_receivers`` is the broadcast's fan-out for byte accounting.
        A chunk of a streamed upload (``run_client_stream``) is held until
        its stream's last chunk (``_receive_chunk``)."""
        if (isinstance(msg.payload, dict)
                and msg.payload.get("format") == "packed_chunk"):
            return self._receive_chunk(msg, key, n_receivers)
        version = msg.meta["version"]
        if version > self.state.t:
            raise ValueError(
                f"message version {version} is ahead of the server clock "
                f"t={self.state.t} (clock skew or replay)")
        _check_upload(msg.payload)
        payload = msg.payload
        tau = self.state.t - version
        if self.staleness.would_drop(tau):
            self.meter.record_dropped(msg)
            self.staleness.record_dropped(tau)
            if self.telemetry is not None:
                self.telemetry.emit("drop", step=self.state.t,
                                    client=msg.meta.get("client", -1),
                                    tau=tau, reason="stale")
            return None
        self.meter.record(msg)
        self.staleness.observe(tau)
        w = (1.0 / math.sqrt(1.0 + tau)) if self.qcfg.staleness_scaling else 1.0
        if self.telemetry is not None:
            extra = {"taps": msg.meta["taps"]} if "taps" in msg.meta else {}
            self.telemetry.emit("upload", step=self.state.t,
                                client=msg.meta.get("client", -1), tau=tau,
                                weight=w, **extra)
        native = (payload["kind"] == self.cq.spec.kind
                  and payload.get("bits") in (None, self.cq.spec.bits))
        if native and payload["kind"] == "lowrank":
            # another sketch group is another subspace: decode it
            native = payload.get("group") == self.cq.spec.group
        if native:
            self.buffer.add_encoded(payload, weight=w)
        else:
            self.buffer.add_decoded_flat(self.cq.decode_flat(payload),
                                         weight=w, layout=payload["layout"])
        if not self.buffer.full:
            return None
        return self._flush(key, n_receivers)

    def _receive_chunk(self, msg: Message, key,
                       n_receivers: int) -> Optional[Message]:
        """One chunk of a streamed upload, held by its (client, stream,
        version) key. The stream completes when its chunks hold as many
        rows as the message has, in whatever order they came (the
        reference waits for the chunk flagged last, and refuses a stream
        whose last chunk came first). Its chunks are then validated and
        assembled (``UpdateBuffer.assemble_chunks``) before anything else
        changes: a malformed stream raises and is discarded, and the
        meters, the staleness monitor, the telemetry and the buffer are
        left as they were. A valid stream meters as one upload, with its
        summed chunk bytes (the unstreamed message's exactly,
        ``protocol.frame_chunk_messages``); the staleness decision and the
        buffer insert also happen once, then, against the server clock at
        that time."""
        version = msg.meta["version"]
        if version > self.state.t:
            raise ValueError(
                f"message version {version} is ahead of the server clock "
                f"t={self.state.t} (clock skew or replay)")
        sid = (msg.meta.get("client", -1), msg.meta.get("stream", 0), version)
        pend = self._pending_chunks.setdefault(sid, [[], 0.0])
        pend[0].append(msg.payload)
        pend[1] += msg.wire_bytes
        if (sum(ch["rows"] for ch in pend[0])
                < kops.rows_for(msg.payload["n"])):
            return None
        chunks, stream_bytes = self._pending_chunks.pop(sid)
        enc = self.buffer.assemble_chunks(chunks)
        tau = self.state.t - version
        if self.staleness.would_drop(tau):
            self.meter.uploads_dropped += 1
            self.meter.dropped_bytes += stream_bytes
            self.staleness.record_dropped(tau)
            if self.telemetry is not None:
                self.telemetry.emit("drop", step=self.state.t,
                                    client=msg.meta.get("client", -1),
                                    tau=tau, reason="stale")
            return None
        self.meter.record_stream(enc, stream_bytes)
        self.staleness.observe(tau)
        w = (1.0 / math.sqrt(1.0 + tau)) if self.qcfg.staleness_scaling else 1.0
        if self.telemetry is not None:
            self.telemetry.emit("upload", step=self.state.t,
                                client=msg.meta.get("client", -1),
                                tau=tau, weight=w)
        self.buffer.add_encoded(enc, weight=w)
        if not self.buffer.full:
            return None
        return self._flush(key, n_receivers)

    def _flush(self, key, n_receivers: int) -> Message:
        """Algorithm 1 lines 11-16. The broadcast carries
        q^t = Q_s(x^{t+1} - x-hat^t), and the server applies the decoded
        wire bits themselves — the increment every client decodes — which
        keeps all x-hat replicas bit-identical. A qsgd or identity server
        quantizer takes ``server_flush_step``; top_k, rand_k and lowrank
        take the non-fused chain (``FlushBatch.reduce``, the server update,
        ``encode_flat`` of the diff with ``key``, the apply of its decode),
        whose flush event has no taps, as in the reference."""
        st = self.state
        if self.buffer.layout != st.layout:  # before drain() resets it
            raise ValueError("buffered uploads do not match the server's "
                             "parameter layout")
        batch = self.buffer.drain()
        kind = self.sq.spec.kind
        beta = self.qcfg.server_momentum if self.qcfg.server_momentum else None
        tap_vec = None
        if kind in ("qsgd", "identity"):
            sbits = self.sq.spec.bits if kind == "qsgd" else None
            lowrank_win = batch.kind == "lowrank"
            key2d = key.reshape(1, -1) if kind == "qsgd" else None
            lkw = dict(group=batch.group if lowrank_win else None,
                       lseeds=batch.seeds if lowrank_win else None)
            if self.mesh is None:
                out = kops.server_flush_step(
                    st.x_flat, st.hidden_flat, st.momentum_flat, batch.stack,
                    batch.norms, batch.weights, batch.extra, key2d,
                    bits=batch.bits, sbits=sbits, n=batch.n,
                    lr=self.qcfg.server_lr, beta=beta, taps=self._taps,
                    **lkw)
            else:
                out = self._flush_on_mesh(batch, key2d, sbits, beta, lkw)
            x_new, h_new, m_new, payload = out[:4]
            if self._taps:
                tap_vec = out[4]
            if kind == "qsgd":
                enc = packed_qsgd_payload(payload[0], payload[1], sbits,
                                          batch.n, st.layout)
            else:
                enc = packed_identity_payload(payload[0], batch.n, st.layout)
            bmsg = frame_packed_message(HIDDEN_BROADCAST, self.sq, enc,
                                        t=st.t)
        else:
            # under a mesh on the gathered true-n vectors, re-segmented
            x_new, m_new = kops.server_apply_flat(
                st.full("x_flat"), st.full("momentum_flat"), batch.reduce(),
                lr=self.qcfg.server_lr, beta=beta)
            diff = x_new - st.full("hidden_flat")
            bmsg = encode_message_flat(HIDDEN_BROADCAST, self.sq, diff,
                                       st.layout, key, t=st.t)
            h_new = st.full("hidden_flat") + self.sq.decode_flat(
                bmsg.payload)
            if self.mesh is not None:
                x_new, h_new, m_new = (place_flat_on_mesh(v, self.mesh,
                                                          batch.n)
                                       for v in (x_new, h_new, m_new))
        self.meter.record(bmsg, n_receivers=n_receivers)
        if self.telemetry is not None:
            extra = ({"taps": named_flush_taps(tap_vec)}
                     if tap_vec is not None else {})
            self.telemetry.emit(
                "flush", step=st.t, window=self.qcfg.buffer_size,
                packed_k=0 if batch.stack is None else int(batch.stack.shape[0]),
                has_residual=batch.extra is not None, **extra)
            self.telemetry.emit("broadcast", step=st.t + 1,
                                n_receivers=n_receivers,
                                wire_kB=bmsg.wire_bytes / 1e3)
        self.state = ServerState(x_flat=x_new, hidden_flat=h_new,
                                 momentum_flat=m_new, layout=st.layout,
                                 t=st.t + 1, mesh=self.mesh)
        return bmsg

    def _flush_on_mesh(self, batch, key2d, sbits, beta, lkw) -> tuple:
        """The qsgd / identity flush on this rank's segment: the window's
        stack rows, norms and ``extra`` elements of the segment (zero past
        the true rows; a lowrank window's rank-length stack whole), the
        sharded flush, and the payload's segments gathered and cut to the
        true rows (n for identity), so the broadcast is the meshless
        one's."""
        from repro_torch.launch.mesh import gather_segments
        from repro_torch.sharding.rules import flat_segment_index

        st, n = self.state, batch.n
        rows, rows_l = kops.rows_for(n), st.x_flat.shape[0] // kops.LANES
        r0 = flat_segment_index(self.mesh) * rows_l
        stack, norms, extra = batch.stack, batch.norms, batch.extra
        if stack is not None and lkw["group"] is None:
            stack, norms = (segment_rows(v, r0, rows_l)
                            for v in (stack, norms))
        if extra is not None:
            extra = segment_rows(extra.reshape(1, -1), r0 * kops.LANES,
                             rows_l * kops.LANES)[0]
        out = kops.server_flush_step_sharded(
            st.x_flat, st.hidden_flat, st.momentum_flat, stack, norms,
            batch.weights, extra, key2d, bits=batch.bits, sbits=sbits,
            lr=self.qcfg.server_lr, beta=beta, mesh=self.mesh, n=n,
            taps=self._taps, chunk_rows=self.chunk_rows, **lkw)
        cut = (rows, rows) if sbits is not None else (n,)
        payload = tuple(gather_segments(p, self.mesh)[:c]
                        for p, c in zip(out[3], cut))
        return out[:3] + (payload,) + out[4:]

    # -- invariant checks / metrics ----------------------------------------
    def hidden_drift(self) -> float:
        """|| x - x-hat || / || x || — the quantization term of Lemma F.9,
        on the true-n vectors (under a mesh gathered first, so the sums
        are the meshless run's)."""
        x, h = self.state.full("x_flat"), self.state.full("hidden_flat")
        d = x - h
        num = torch.sqrt(torch.sum(d * d))
        den = torch.clamp(torch.sqrt(torch.sum(x * x)), min=1e-30)
        return float(num / den)

    def metrics(self, drift: bool = False) -> Dict[str, Any]:
        """The metrics surface (``obs.metrics.collect``): traffic,
        staleness, server steps, on request the hidden drift, and the
        tracer's tap series when telemetry is attached."""
        from repro_torch.obs.metrics import collect
        return collect(self.meter, self.staleness, self.state.t,
                       tracer=self.telemetry,
                       drift=self.hidden_drift() if drift else None)
