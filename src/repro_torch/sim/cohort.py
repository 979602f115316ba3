"""Cohort engine: the async FL timeline, batched over cohorts of clients.

Counterpart of ``repro/sim/cohort.py``. The sequential ``AsyncFLSimulator``
trains one client per Python iteration, so its host time grows with every
client. This engine admits arrivals in **cohorts** of ``cohort_size`` and
runs each cohort tier group's client pipeline as one
``core.qafel.client_update_flat``: local SGD of all the group's members
under one ``torch.func.vmap`` from the server's flat x-hat, and one K2
encode launch over their (b, d) delta stack. The packed messages feed
``QAFeL.receive`` as they are, so the server stays decode-free between
flushes as on the sequential path, which takes the same entry at b = 1.

**Admission model.** Whenever the arrival process reaches the next pending
completion, the next ``cohort_size`` arrivals are admitted together and all
train from the hidden state as of admission. A member whose nominal arrival
falls after a broadcast thus trains on a slightly older state than the
sequential engine would give it; at ``cohort_size=1`` there is no such
member, and the engine consumes the key and numpy streams in the
sequential order and reproduces the sequential trajectory bit for bit.

Timing, dropouts, stragglers and per-client quantizer tiers come from a
``ScenarioConfig`` (``sim.scenarios``). Tier groups are padded to the full
cohort size (padding repeats the group's first member; its rows are
computed and dropped), so K2 always runs at B = ``cohort_size``. A tier
client's upload through a narrower quantizer is decoded on arrival; the
default tier stays packed. A lowrank group carries each member's
error-feedback residual through its client step (padding rows carry the
first member's, and are dropped with the rest of the padding). With telemetry taps on (``QAFeL(...,
telemetry=)``) each member's upload taps ride its message, and a member
lost to dropout is a ``drop`` event.
"""
from __future__ import annotations

import heapq
import math
import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.core.protocol import (CLIENT_UPDATE, Message,
                                       frame_cohort_messages)
from repro_torch.core.qafel import QAFeL, client_update_flat
from repro_torch.core.quantizers import make_quantizer
from repro_torch.obs.taps import named_cohort_taps
from repro_torch.sim.events import BaseAsyncSimulator, SimConfig, SimResult
from repro_torch.sim.scenarios import (ScenarioConfig, ScenarioSampler,
                                       get_scenario)

# Bytes one member's vmapped client step holds per model parameter at its
# peak: the parameters, gradient and delta, the float64 temporaries of the
# single-rounded SGD step (``ref.fma_f32``) and the activations of its
# batch. ``chip_smoke.py`` measures 180.5 on the card for the paper's CNN
# at batch 8 (32 members) and fails if a run exceeds this bound (PERF.md).
# The activations grow with the batch, not with d: a task with larger
# batches per parameter needs its own bound.
_BYTES_PER_MEMBER_PARAM = 256


def _free_bytes(device: torch.device) -> int:
    """Memory a cohort step may still take on ``device``: the card's free
    memory plus what torch's allocator holds unused, or the host's free
    physical memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def auto_member_chunk(b: int, d: int, device=None, *,
                      free_bytes: Optional[int] = None) -> Optional[int]:
    """Members per vmap for a cohort of ``b`` members of ``d`` parameters:
    ``None`` (the whole cohort in one vmap) or a chunk size. One rule on
    every device: the whole cohort unless its working set, b members of
    ``_BYTES_PER_MEMBER_PARAM * d`` bytes, exceeds half of ``free_bytes``
    (by default what ``device`` has free; ``None`` is the card, as for
    every entry point), else as many members as fit.
    The reference's rule, a cache optimum measured on XLA:CPU, is not
    carried over. The encode's bits do not depend on the chunking; the
    CNN's deltas may move (up to 1.2e-7 on the CPU;
    ``ops.cohort_train_encode_step``)."""
    if b <= 1:
        return None
    if free_bytes is None:
        free_bytes = _free_bytes(resolve_device(device))
    per_member = max(d, 1) * _BYTES_PER_MEMBER_PARAM
    budget = free_bytes // 2
    if b * per_member <= budget:
        return None
    return max(1, min(b, budget // per_member))


def _stack_trees(trees):
    """Stack per-member batch trees along a new leading member dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class CohortAsyncFLSimulator(BaseAsyncSimulator):
    """Drives a QAFeL instance through the async timeline, cohort-batched."""

    def __init__(self, algo: QAFeL, sim_cfg: SimConfig,
                 client_batches_fn: Callable[[int, Any], Any],
                 eval_fn: Callable[[Any], float],
                 scenario: Union[str, ScenarioConfig] = "identity",
                 cohort_size: int = 32):
        super().__init__(algo, sim_cfg, client_batches_fn, eval_fn)
        self.scenario = get_scenario(scenario)
        self.cohort_size = max(1, int(cohort_size))
        self.sampler = ScenarioSampler(self.scenario, sim_cfg.concurrency,
                                       self.rng)
        self.tier_quantizers = [make_quantizer(name)
                                for _, name in self.scenario.tiers]
        self.dropped = 0
        self.cohorts = 0
        self.groups = 0  # client steps run: one per tier group per cohort
        self._receive_keys: List[Any] = []

    def _next_receive_key(self):
        """The key ``QAFeL.receive`` gets for one delivery (a flush uses
        it). At ``cohort_size=1`` the sequential draw; above it one
        ``split(key, 65)`` refills 64 keys, popped from the end."""
        if self.cohort_size == 1:
            return self._next_key()
        if not self._receive_keys:
            subs = prng.split(self.key, 65)
            self.key = subs[0]
            self._receive_keys = list(subs[1:])
        return self._receive_keys.pop()

    # -- cohort admission -------------------------------------------------
    def _train_encode_cohort(self, batches: Any, train_keys, enc_keys,
                             tiers: np.ndarray, *, stacked: bool = False,
                             client0: Optional[int] = None) -> List[Message]:
        """Train and encode one admitted cohort, one
        ``client_update_flat`` per tier group. Each group is padded to the
        full cohort size with repeats of its first member, whose rows are
        dropped when the messages are framed. ``client0`` is the first
        member's client id (member i is ``client0 + i``), which keys the
        lowrank residuals."""
        b = int(tiers.size) if stacked else len(batches)
        st = self.algo.state
        msgs: List[Any] = [None] * b
        chunk = auto_member_chunk(b, st.layout.total_size,
                                  st.hidden_flat.device)
        for tier in sorted(set(tiers.tolist())):
            q = self.algo.cq if tier < 0 else self.tier_quantizers[tier]
            members = np.nonzero(tiers == tier)[0]
            if b == 1:
                grp_batches, gt, ge = batches[0], train_keys[0], enc_keys[0]
            else:
                pad_idx = np.concatenate(
                    [members, np.repeat(members[:1], b - members.size)])
                if stacked and members.size == b:
                    grp_batches = batches
                elif stacked:
                    grp_batches = tree_map(
                        lambda x: x[torch.as_tensor(pad_idx, device=x.device)],
                        batches)
                else:
                    grp_batches = _stack_trees([batches[i] for i in pad_idx])
                if members.size == b:
                    gt, ge = train_keys, enc_keys
                else:
                    idx = torch.as_tensor(pad_idx)
                    gt, ge = train_keys[idx], enc_keys[idx]
            kw, cids = {}, None
            if q.spec.kind == "lowrank":
                cids = ([client0] if b == 1 else
                        [None if client0 is None else client0 + int(i)
                         for i in pad_idx])
                kw = {"residual": self.algo.client_residuals(cids),
                      "basis_seed": self.algo.round_basis_seed()}
            out = client_update_flat(
                self.algo.loss_fn, self.algo.qcfg, q.spec, st.layout,
                st.full("hidden_flat"), grp_batches, gt, ge, b=b,
                member_chunk=chunk, taps=self.algo._taps,
                chunk_rows=self.algo.chunk_rows, mesh=self.algo.mesh, **kw)
            self.groups += 1
            if cids is not None:
                self.algo.store_residuals(cids[:members.size],
                                          out["residual"][:members.size])
            mlist = frame_cohort_messages(
                CLIENT_UPDATE, q, out, st.layout,
                [ge] if b == 1 else ge, version=st.t, count=members.size,
                basis_seed=kw.get("basis_seed"))
            # row j of the step's outputs is member members[j]
            tap_rows = out["taps"].cpu() if self.algo._taps else None
            for j, i in enumerate(members.tolist()):
                msgs[i] = mlist[j]
                if tap_rows is not None:
                    msgs[i].meta["taps"] = named_cohort_taps(tap_rows[j])
        return msgs

    def _train_cohort(self, first: int, tiers: np.ndarray) -> List[Message]:
        """Draw the keys of the cohort of clients ``first, first + 1, ...``
        (one per tier in ``tiers``), fetch their batches and train and
        encode them. The keys follow the reference: at b = 1 the sequential
        engine's batches key and client key; above it one ``split(key,
        2b+1)`` and a split of each of the last b."""
        b = self.cohort_size
        if b == 1:
            batch_keys = [self._next_key()]
            k_train, k_enc = prng.split(self._next_key())
            train_keys, enc_keys = [k_train], [k_enc]
        else:
            subs = prng.split(self.key, 2 * b + 1)
            self.key = subs[0]
            batch_keys = subs[1:b + 1]
            te = prng.split_each(subs[b + 1:])
            train_keys, enc_keys = te[:, 0], te[:, 1]
        # a batches fn marked ``batched = True`` is called once with the
        # cohort's client ids and keys and returns the stacked tree
        stacked = b > 1 and getattr(self.client_batches_fn, "batched", False)
        if stacked:
            batches = self.client_batches_fn(np.arange(first, first + b),
                                             batch_keys)
        else:
            batches = [self.client_batches_fn(first + i, batch_keys[i])
                       for i in range(b)]
        return self._train_encode_cohort(batches, train_keys, enc_keys, tiers,
                                         stacked=stacked, client0=first)

    def _admit_cohort(self, next_arrival: float, next_client: int):
        """Train and encode one cohort starting at ``next_arrival``.

        Returns (messages, arrival_times, durations, drop_mask,
        new_next_arrival). The streams are consumed in the reference's
        order: interarrivals and tiers, then the keys, the batches and
        training (``_train_cohort``), and then the durations and
        dropouts."""
        b = self.cohort_size
        self.cohorts += 1
        inter = self.sampler.interarrivals(b)
        arrivals = next_arrival + np.concatenate(
            [[0.0], np.cumsum(inter[:-1])])
        new_next_arrival = float(arrivals[-1] + inter[-1])
        tiers = self.sampler.tier_indices(b)
        msgs = self._train_cohort(next_client, tiers)
        durations = self.sampler.durations(b)
        drops = self.sampler.dropouts(b)
        return msgs, arrivals, durations, drops, new_next_arrival

    # -- main loop ---------------------------------------------------------
    def run(self) -> SimResult:
        cfg, algo = self.cfg, self.algo
        heap: List[tuple] = []  # (finish_time, seq, client_id)
        pending: Dict[int, Message] = {}
        # admitted members may arrive in the future: a broadcast fans out
        # only to clients already training (arrival <= now, not delivered)
        arrival_heap: List[float] = []
        started = 0
        delivered = 0
        accuracy_trace: List[tuple] = []
        uploads = 0
        next_client = 0
        next_arrival = 0.0
        now = 0.0
        self._last_eval_step = -1
        reached = False
        seq = 0

        while uploads < cfg.max_uploads and not reached:
            # admit cohorts until the arrivals pass the next completion (a
            # cohort lost to dropout may leave the heap empty)
            next_finish = heap[0][0] if heap else math.inf
            while next_arrival <= next_finish:
                msgs, arrivals, durations, drops, next_arrival = \
                    self._admit_cohort(next_arrival, next_client)
                for i in range(self.cohort_size):
                    if drops[i]:
                        self.dropped += 1
                        if self.tracer is not None:
                            # at the tracer's current clock, not the
                            # member's future arrival, so t_sim stays
                            # non-decreasing
                            self.tracer.emit("drop", step=algo.state.t,
                                             client=next_client + i, tau=0,
                                             reason="dropout")
                        continue
                    msgs[i].meta["client"] = next_client + i
                    heapq.heappush(heap, (float(arrivals[i] + durations[i]),
                                          seq, next_client + i))
                    heapq.heappush(arrival_heap, float(arrivals[i]))
                    pending[seq] = msgs[i]
                    seq += 1
                next_client += self.cohort_size
                next_finish = heap[0][0] if heap else math.inf

            now, s, _cid = heapq.heappop(heap)
            msg = pending.pop(s)
            while arrival_heap and arrival_heap[0] <= now:
                heapq.heappop(arrival_heap)
                started += 1
            delivered += 1
            if self.tracer is not None:
                self.tracer.set_sim_time(now)
            bmsg = algo.receive(msg, self._next_receive_key(),
                                n_receivers=max(1, started - delivered))
            uploads += 1
            if bmsg is not None:
                reached = self._apply_broadcast(bmsg, now, uploads,
                                                accuracy_trace)

        return self._finalize(reached=reached, uploads=uploads, now=now,
                              accuracy_trace=accuracy_trace,
                              dropped_uploads=self.dropped)
