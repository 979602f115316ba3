"""Event-driven asynchronous FL simulator (paper Appendix D methodology).

Counterpart of ``repro/sim/events.py`` (the sequential engine). Timing
model, as in the paper and FedBuff's FLSim setup:

* clients arrive at a constant rate r (client n starts at time n / r),
* each client's training duration is half-normal |N(0, 1)|; a concurrency
  of C means r = C / E|N(0,1)| = C / sqrt(2/pi),
* the server consumes uploads in completion-time order, and every K-th
  upload triggers a server step and a hidden-state broadcast,
* a client starting at time T trains from the hidden state as of T; its
  staleness is the number of server steps between its start and delivery.

The simulator keeps independent flat hidden-state replicas (Algorithm 3)
for a few clients and checks that they stay bit-identical to the server's:
each broadcast is decoded once and added to every replica.

Randomness: durations come from ``numpy.random.default_rng(seed)`` and the
key stream from the port's threefry ``PRNGKey(seed)``, both as in the
reference, so the event timeline is the reference's exactly.

With an ``obs.RunTracer`` attached to the algorithm (``QAFeL(...,
telemetry=)``), the simulator stamps its clock before every delivery,
emits an eval event per evaluation and polls the kernel-library loads once
at the end (compile events).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.core.protocol import decode_message_flat
from repro_torch.core.qafel import QAFeL
from repro_torch.obs.records import AccuracyPoint

HALF_NORMAL_MEAN = math.sqrt(2.0 / math.pi)  # E|N(0, 1)|


@dataclasses.dataclass(frozen=True)
class SimConfig:
    concurrency: int = 100  # average # clients training in parallel
    eval_every_steps: int = 10  # server steps between evals
    max_uploads: int = 10_000
    target_accuracy: Optional[float] = None  # stop early when reached
    track_hidden_replicas: int = 2  # clients whose x-hat replica we verify
    seed: int = 0

    @property
    def arrival_rate(self) -> float:
        return self.concurrency / HALF_NORMAL_MEAN


@dataclasses.dataclass
class SimResult:
    reached_target: bool
    uploads: int
    server_steps: int
    sim_time: float
    metrics: Dict[str, Any]
    accuracy_trace: List[AccuracyPoint]
    final_accuracy: float


class BaseAsyncSimulator:
    """Seeded RNG streams, tracked hidden-state replicas, the decode-once
    broadcast application with its eval cadence, and result assembly."""

    def __init__(self, algo: QAFeL, sim_cfg: SimConfig,
                 client_batches_fn: Callable[[int, Any], Any],
                 eval_fn: Callable[[Any], float]):
        """client_batches_fn(client_id, key) -> dict of (P, ...) tensors on
        the run's device; eval_fn(params tree) -> accuracy in [0, 1]."""
        self.algo = algo
        self.cfg = sim_cfg
        self.client_batches_fn = client_batches_fn
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(sim_cfg.seed)
        self.key = prng.PRNGKey(sim_cfg.seed)
        # the algorithm's RunTracer, if one is attached
        self.tracer = getattr(algo, "telemetry", None)
        # replicas hold x-hat at its true length n (under a mesh gathered)
        self.replicas = [algo.state.full("hidden_flat").clone()
                         for _ in range(sim_cfg.track_hidden_replicas)]
        self._last_eval_step = -1

    def _next_key(self):
        self.key, sub = prng.split(self.key)
        return sub

    def _eval_extra(self) -> Dict[str, Any]:
        """Fields merged into every eval event this engine emits: the
        population engine's per-state client counts; nothing here."""
        return {}

    def verify_replicas(self) -> bool:
        h = self.algo.state.full("hidden_flat")
        return all(torch.equal(rep, h) for rep in self.replicas)

    def _apply_broadcast(self, bmsg, now: float, uploads: int,
                         accuracy_trace: List[AccuracyPoint]) -> bool:
        """Decode the broadcast once and add it to every tracked replica
        (Algorithm 3). Evaluates on the server-step cadence; returns True
        when the target accuracy is reached."""
        q = decode_message_flat(self.algo.sq, bmsg)
        self.replicas = [rep + q for rep in self.replicas]
        step = self.algo.state.t
        if step - self._last_eval_step >= self.cfg.eval_every_steps:
            acc = float(self.eval_fn(self.algo.state.x))
            accuracy_trace.append(AccuracyPoint(now, uploads, step, acc))
            if self.tracer is not None:
                self.tracer.emit("eval", step=step, accuracy=acc,
                                 uploads=uploads, **self._eval_extra())
            self._last_eval_step = step
            if (self.cfg.target_accuracy is not None
                    and acc >= self.cfg.target_accuracy):
                return True
        return False

    def _finalize(self, *, reached: bool, uploads: int, now: float,
                  accuracy_trace: List[AccuracyPoint],
                  **extra_metrics) -> SimResult:
        """Always evaluate the final server model, so a run ending between
        flushes does not report a stale accuracy. ``extra_metrics`` (the
        cohort engine's ``dropped_uploads``) join the metrics dict."""
        final_acc = float(self.eval_fn(self.algo.state.x))
        if not accuracy_trace or accuracy_trace[-1][1] != uploads:
            accuracy_trace.append(
                AccuracyPoint(now, uploads, self.algo.state.t, final_acc))
            if self.tracer is not None:
                self.tracer.set_sim_time(now)
                self.tracer.emit("eval", step=self.algo.state.t,
                                 accuracy=final_acc, uploads=uploads,
                                 **self._eval_extra())
        if self.tracer is not None:
            self.tracer.poll_compiles(step=self.algo.state.t)
        metrics = self.algo.metrics(drift=True)
        metrics["replicas_in_sync"] = self.verify_replicas()
        metrics.update(extra_metrics)
        return SimResult(reached_target=reached, uploads=uploads,
                         server_steps=self.algo.state.t, sim_time=now,
                         metrics=metrics, accuracy_trace=accuracy_trace,
                         final_accuracy=final_acc)


class AsyncFLSimulator(BaseAsyncSimulator):
    """Drives a QAFeL (or FedBuff) instance through the async event
    timeline, one client per iteration."""

    def run(self) -> SimResult:
        cfg, algo = self.cfg, self.algo
        rate = cfg.arrival_rate
        heap: List[tuple] = []  # (finish_time, seq, client_id)
        accuracy_trace: List[AccuracyPoint] = []
        uploads = 0
        next_client = 0
        next_arrival = 0.0
        now = 0.0
        self._last_eval_step = -1
        reached = False
        # a client trains on the hidden state AS OF its start: its update
        # is computed at start (run_client records the version) and
        # delivered at finish
        pending: Dict[int, Any] = {}
        seq = 0

        while uploads < cfg.max_uploads and not reached:
            # admit arrivals up to the next completion
            next_finish = heap[0][0] if heap else math.inf
            while next_arrival <= next_finish:
                cid = next_client
                batches = self.client_batches_fn(cid, self._next_key())
                msg, _version = algo.run_client(batches, self._next_key(),
                                                client=cid)
                msg.meta["client"] = cid
                duration = abs(self.rng.normal(0.0, 1.0))
                heapq.heappush(heap, (next_arrival + duration, seq, cid))
                pending[seq] = msg
                seq += 1
                next_client += 1
                next_arrival += 1.0 / rate
                next_finish = heap[0][0] if heap else math.inf

            # deliver the earliest completion; a flush's broadcast fans out
            # to every client still training at that instant
            now, s, cid = heapq.heappop(heap)
            msg = pending.pop(s)
            if self.tracer is not None:
                self.tracer.set_sim_time(now)
            bmsg = algo.receive(msg, self._next_key(),
                                n_receivers=max(1, len(heap)))
            uploads += 1
            if bmsg is not None:
                reached = self._apply_broadcast(bmsg, now, uploads,
                                                accuracy_trace)

        return self._finalize(reached=reached, uploads=uploads, now=now,
                              accuracy_trace=accuracy_trace)
