"""The device-resident population engine, up to a million clients.

Counterpart of ``repro/sim/population.py``. The cohort engine
(``sim.cohort``) batches training, but its client lifecycle — arrivals,
latency draws, dropout, in-flight heaps, broadcast fan-out counting — is
per-client Python. Here the population lives in device tensors
(``kernels.population``) and the event loop is one
``kernels.ops.population_advance`` per macro step (admit a cohort, or
deliver a batch of completions) with one device-to-host copy per step.

* ``PopulationAsyncFLSimulator`` — a sibling of ``CohortAsyncFLSimulator``
  with the same constructor and a ``draws`` mode: the step runs the
  timeline, the host trains the admitted cohorts and delivers the
  completions through the same client and server entries. With
  ``draws="host"`` the per-client randomness comes from the scenario's
  ``ScenarioSampler`` in the cohort engine's order, so the trajectory
  is the cohort engine's event for event (the equivalence pin); with
  ``draws="device"`` (default) every draw is made in the step under the
  counter-hash law keyed by the global client id.
* ``PopulationEngine`` — the lifecycle alone, with no model, to measure
  and scale the machinery: ``advance_to(horizon)`` runs admissions and
  deliveries to a sim-time horizon.

Event times are f32 on the device and float64 in the cohort engine, so the
pins compare the event and accuracy sequence exactly and times within
f32's rounding; model state (parameters, accuracies, staleness, fan-out
counts) is integer- and key-driven and matches bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.common.device import resolve_device
from repro_torch.core.qafel import QAFeL
from repro_torch.core.staleness import StalenessMonitor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.population import (CompiledScenario, PopStepOut,
                                            init_population, run_seeds,
                                            wheel_shape)
from repro_torch.obs.taps import (POPULATION_STATE_NAMES,
                                  named_population_counts)
from repro_torch.sim.cohort import CohortAsyncFLSimulator
from repro_torch.sim.events import SimConfig, SimResult
from repro_torch.sim.scenarios import ScenarioConfig, get_scenario


def compile_scenario(cfg: ScenarioConfig,
                     concurrency: int) -> CompiledScenario:
    """The frozen image of ``cfg`` at ``concurrency``. Tiers become their
    fractions; the host maps tier indices back to quantizers as the cohort
    engine does."""
    return CompiledScenario(
        latency=cfg.latency, latency_scale=cfg.latency_scale,
        lognormal_sigma=cfg.lognormal_sigma, trace=cfg.trace,
        arrival=cfg.arrival, rate=cfg.arrival_rate(concurrency),
        dropout=cfg.dropout, straggler_frac=cfg.straggler_frac,
        straggler_mult=cfg.straggler_mult,
        tier_fracs=tuple(f for f, _ in cfg.tiers))


def _sizing(concurrency: int, admit: int) -> int:
    """Slot capacity: the in-flight population fluctuates around the
    calibrated concurrency; headroom covers the fluctuation and the
    speculative admission batch (exhaustion raises, it never drops)."""
    return int(1.5 * concurrency) + 8 * admit + 64


def _round_queue(n: int, quantum: int = 4096) -> int:
    """Arrival-queue capacities round up to a quantum (the reference's
    compile-cache rule, kept so both engines size their queues alike)."""
    return -(-int(n) // quantum) * quantum


def _capacity_error(capacity: int, queue_cap: int) -> RuntimeError:
    return RuntimeError(f"population capacity exhausted (capacity="
                        f"{capacity}, queue_cap={queue_cap}); pass a larger "
                        f"capacity= for this scenario")


def _check_branch(o: PopStepOut, admitting: bool) -> None:
    """The branch the host took must be the device's own ``do_admit``."""
    if bool(o["admitted"]) != admitting:
        raise AssertionError("the host's macro-step branch (admit="
                             f"{admitting}) differs from the device's")


class PopulationAsyncFLSimulator(CohortAsyncFLSimulator):
    """The async FL timeline with a device-resident client population.

    The protocol of ``CohortAsyncFLSimulator`` — cohorts of
    ``cohort_size`` train through the client entry, uploads feed
    ``QAFeL.receive`` in completion order with the exact fan-out counts —
    with arrivals, latencies, dropouts, deadline order, fan-out counting
    and per-state accounting in the population step, on the device of the
    algorithm's state. ``deliver_batch`` completions are popped per step
    (default ``cohort_size``); ``capacity`` overrides the slot count.
    ``macro_steps`` counts the steps of each kind.
    """

    def __init__(self, algo: QAFeL, sim_cfg: SimConfig,
                 client_batches_fn: Callable[[int, Any], Any],
                 eval_fn: Callable[[Any], float],
                 scenario: Union[str, ScenarioConfig] = "identity",
                 cohort_size: int = 32, *, draws: str = "device",
                 deliver_batch: Optional[int] = None,
                 capacity: Optional[int] = None):
        if getattr(algo, "mesh", None) is not None:
            raise NotImplementedError(
                "the population engine on a mesh is not ported: ROADMAP "
                "queue A item 13b.2")
        super().__init__(algo, sim_cfg, client_batches_fn, eval_fn,
                         scenario=scenario, cohort_size=cohort_size)
        if draws not in ("device", "host"):
            raise ValueError(f"draws must be 'device' or 'host': {draws!r}")
        self.draw_mode = draws
        b = self.cohort_size
        self.capacity = int(capacity) if capacity is not None else _sizing(
            sim_cfg.concurrency, b)
        self.buckets, self.bucket_width = wheel_shape(self.capacity)
        self.deliver_batch = (int(deliver_batch) if deliver_batch is not None
                              else b)
        # non-dropped arrivals are append-only for the fan-out count:
        # bounded by the delivered uploads plus everything in flight
        self.queue_cap = _round_queue(sim_cfg.max_uploads + 2 * self.capacity
                                      + 8 * b + 64)
        self.compiled = compile_scenario(self.scenario, sim_cfg.concurrency)
        self._seeds = run_seeds(sim_cfg.seed)
        self._statics = dict(
            scenario=self.compiled, capacity=self.capacity,
            buckets=self.buckets, bucket_width=self.bucket_width,
            admit=b, deliver=self.deliver_batch, queue_cap=self.queue_cap)
        self._state_counts = dict.fromkeys(POPULATION_STATE_NAMES, 0)
        self._state_counts["idle"] = self.capacity
        self.macro_steps = {"admit": 0, "deliver": 0}

    def _eval_extra(self) -> Dict[str, Any]:
        return {"population": dict(self._state_counts)}

    def _host_draws(self) -> Dict[str, np.ndarray]:
        """One admission's sampler draws in the cohort engine's numpy
        order (interarrivals, tiers, durations, dropouts; the key draws in
        between use another stream)."""
        b = self.cohort_size
        inter = self.sampler.interarrivals(b)
        tiers = self.sampler.tier_indices(b)
        dur = self.sampler.durations(b)
        drops = self.sampler.dropouts(b)
        return {"inter": inter.astype(np.float32),
                "dur": dur.astype(np.float32),
                "drop": np.asarray(drops, dtype=bool),
                "tier": tiers.astype(np.int32)}

    def _admit_from_kernel(self, o: PopStepOut,
                           pending: Dict[int, Any]) -> None:
        """Train and encode the cohort the step just admitted, keyed by
        the step's slots; the keys are drawn as ``_admit_cohort`` draws
        them."""
        first = int(o["admit_cids"][0])
        drops = o["admit_drops"]
        slots = o["admit_slots"]
        msgs = self._train_cohort(first, np.asarray(o["admit_tiers"],
                                                    dtype=np.int64))
        for i in range(self.cohort_size):
            if drops[i]:
                self.dropped += 1
                if self.tracer is not None:
                    self.tracer.emit("drop", step=self.algo.state.t,
                                     client=first + i, tau=0,
                                     reason="dropout")
                continue
            msgs[i].meta["client"] = first + i
            pending[int(slots[i])] = msgs[i]

    def run(self) -> SimResult:
        cfg, algo = self.cfg, self.algo
        pop = init_population(self.capacity, self.buckets, self.bucket_width,
                              self.queue_cap,
                              device=algo.state.hidden_flat.device)
        pending: Dict[int, Any] = {}  # slot -> in-flight Message
        accuracy_trace: List[tuple] = []
        uploads = 0
        now = 0.0
        self._last_eval_step = -1
        reached = False
        host = self.draw_mode == "host"
        admitting = True  # a fresh population admits first
        while uploads < cfg.max_uploads and not reached:
            draws = self._host_draws() if host and admitting else None
            packed = kops.population_advance(
                pop, self._seeds, algo.state.t, draws, admitting=admitting,
                **self._statics)
            o = PopStepOut(packed, self.cohort_size, self.deliver_batch)
            if o["error"]:
                raise _capacity_error(self.capacity, self.queue_cap)
            _check_branch(o, admitting)
            self.macro_steps["admit" if admitting else "deliver"] += 1
            self._state_counts = named_population_counts(o["state_counts"])
            admitted, admitting = admitting, bool(o["will_admit"])
            if admitted:
                self._admit_from_kernel(o, pending)
                continue
            for j in range(self.deliver_batch):
                # reaped dropouts pop with deliver_valid False: no host work
                if not o["deliver_valid"][j]:
                    continue
                now = float(o["deliver_t"][j])
                msg = pending.pop(int(o["deliver_slots"][j]))
                if self.tracer is not None:
                    self.tracer.set_sim_time(now)
                bmsg = algo.receive(msg, self._next_receive_key(),
                                    n_receivers=int(o["deliver_nrec"][j]))
                uploads += 1
                if bmsg is not None:
                    reached = self._apply_broadcast(bmsg, now, uploads,
                                                    accuracy_trace)
                if uploads >= cfg.max_uploads or reached:
                    break
        return self._finalize(reached=reached, uploads=uploads, now=now,
                              accuracy_trace=accuracy_trace,
                              dropped_uploads=self.dropped,
                              population_states=dict(self._state_counts))


class PopulationEngine:
    """The lifecycle alone: admissions, completions, dropout reaping and
    staleness accounting over the device-resident population, with no
    model attached, to size and measure the machinery at 100k-1M clients.

    ``version`` advances every ``buffer_size`` deliveries (the buffered
    server's flush cadence), so per-delivery staleness flows through
    ``StalenessMonitor.observe_batch`` as a full run would feed it.
    Runs on ``device`` (default: the card).
    """

    def __init__(self, scenario: Union[str, ScenarioConfig] = "identity",
                 concurrency: int = 1000, *, horizon: float = 10.0,
                 seed: int = 0, buffer_size: int = 32,
                 admit_batch: Optional[int] = None,
                 deliver_batch: Optional[int] = None,
                 capacity: Optional[int] = None, max_staleness: int = 0,
                 device=None):
        self.scenario = get_scenario(scenario)
        self.concurrency = int(concurrency)
        self.compiled = compile_scenario(self.scenario, self.concurrency)
        # large admission batches keep 1M-client runs at O(1000) steps:
        # admitting B clients advances the arrival clock by B/rate, which
        # lets the next deliver step drain ~B completions
        b = int(admit_batch) if admit_batch is not None else max(
            1, min(1024, self.concurrency // 2))
        self.admit_batch = b
        self.deliver_batch = (int(deliver_batch) if deliver_batch is not None
                              else b)
        self.capacity = int(capacity) if capacity is not None else _sizing(
            self.concurrency, b)
        self.buckets, self.bucket_width = wheel_shape(self.capacity)
        self.horizon = float(horizon)
        # every arrival admitted before the horizon fits: rate * horizon
        # arrivals plus one speculative batch, plus slack
        self.queue_cap = _round_queue(
            int(self.compiled.rate * self.horizon) + 2 * b
            + self.capacity + 64)
        self.buffer_size = int(buffer_size)
        self.monitor = StalenessMonitor(max_allowed=max_staleness)
        self.device = resolve_device(device)
        self.pop = init_population(self.capacity, self.buckets,
                                   self.bucket_width, self.queue_cap,
                                   device=self.device)
        self._seeds = run_seeds(seed)
        self._statics = dict(
            scenario=self.compiled, capacity=self.capacity,
            buckets=self.buckets, bucket_width=self.bucket_width,
            admit=b, deliver=self.deliver_batch, queue_cap=self.queue_cap)
        self.version = 0
        self.macro_steps = 0
        self.steps_by_kind = {"admit": 0, "deliver": 0}
        self._admitting = True
        self._na = 0.0
        self._nf = math.inf
        self._o: Optional[PopStepOut] = None

    def step(self) -> PopStepOut:
        """One macro step; returns its host view."""
        admitting = self._admitting
        packed = kops.population_advance(self.pop, self._seeds, self.version,
                                         None, admitting=admitting,
                                         **self._statics)
        o = PopStepOut(packed, self.admit_batch, self.deliver_batch)
        if o["error"]:
            raise _capacity_error(self.capacity, self.queue_cap)
        _check_branch(o, admitting)
        self.macro_steps += 1
        self.steps_by_kind["admit" if admitting else "deliver"] += 1
        if not admitting:
            taus = o["deliver_tau"][o["deliver_valid"]]
            if taus.size:
                self.monitor.observe_batch(taus)
        self._admitting = bool(o["will_admit"])
        self.version = int(o["delivered_total"]) // self.buffer_size
        self._na = float(o["next_arrival"])
        self._nf = float(o["next_finish"])
        self._o = o
        return o

    def advance_to(self, t: float) -> Dict[str, Any]:
        """Run the lifecycle until every pending event is past sim-time
        ``t`` (at most the constructed horizon, for which the arrival
        queue is sized). Returns ``metrics()``."""
        if t > self.horizon + 1e-9:
            raise ValueError(f"advance_to({t}) beyond sized horizon "
                             f"{self.horizon}")
        while min(self._na, self._nf) <= t:
            self.step()
        return self.metrics()

    def metrics(self) -> Dict[str, Any]:
        o = self._o
        if o is None:
            counts = dict.fromkeys(POPULATION_STATE_NAMES, 0)
            counts["idle"] = self.capacity
            return {"population_states": counts, "sim_time": 0.0,
                    "admitted": 0, "delivered": 0, "dropped": 0,
                    "discarded": 0, "macro_steps": 0,
                    "staleness": self.monitor.summary()}
        return {"population_states": named_population_counts(
                    o["state_counts"]),
                "sim_time": float(o["t"]),
                "admitted": int(o["admitted_total"]),
                "delivered": int(o["delivered_total"]),
                "dropped": int(o["dropped_total"]),
                "discarded": int(o["discarded_total"]),
                "macro_steps": self.macro_steps,
                "staleness": self.monitor.summary()}
