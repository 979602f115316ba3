"""Structured run tracing: typed events, bounded ring, compile counters.

Counterpart of ``repro/obs/events.py``. ``RunTracer`` is the host-side half
of the telemetry layer: the simulators stamp it with the simulated clock
(``set_sim_time``) and the protocol layer (``QAFeL.receive`` / ``_flush``)
emits one typed event per upload, drop, flush and broadcast; the
simulators add eval and compile events. Events land in a bounded in-memory
ring (overflow counted, never raised) and export as JSONL, one JSON object
per line, validated by ``obs.schema``.

``CompileWatch`` counts what the port compiles: it has no jit, so the only
compile is the build and load of a kernel library at first use
(``kernels._build.entry``, which counts loads per library). A run that
loaded libraries records one compile event per library, ``entry`` its
name and ``retraces`` its loads. Compile events depend on what the process
loaded before (a second run in one process loads nothing), so they stay out
of stream comparisons and out of ``metrics()``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.kernels import _build

EVENT_KINDS = ("upload", "drop", "flush", "broadcast", "eval", "compile")

# wall-clock fields: excluded when comparing event streams across runs
WALL_CLOCK_FIELDS = ("t_wall",)


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed telemetry event."""

    kind: str  # one of EVENT_KINDS
    seq: int  # emission index, strictly increasing per tracer
    step: int  # server step (model version) at emission
    t_sim: float  # simulated clock (engine-stamped)
    t_wall: float  # host wall clock (time.time())
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        out = {"kind": self.kind, "seq": self.seq, "step": self.step,
               "t_sim": self.t_sim, "t_wall": self.t_wall}
        out.update(self.data)
        return out

    def comparable(self) -> Dict[str, Any]:
        """The event minus its wall-clock fields: what same-seed runs are
        compared on."""
        out = self.as_dict()
        for f in WALL_CLOCK_FIELDS:
            out.pop(f, None)
        return out


class CompileWatch:
    """Polling view of the kernel libraries' load counters
    (``kernels._build.LOADS``)."""

    def __init__(self):
        self._last = self.totals()

    def totals(self) -> Dict[str, int]:
        """Loads per kernel library in this process so far."""
        return dict(_build.LOADS)

    def poll(self) -> Dict[str, int]:
        """Loads per library since the previous poll (zeros omitted)."""
        now = self.totals()
        delta = {g: now[g] - self._last.get(g, 0) for g in now
                 if now[g] != self._last.get(g, 0)}
        self._last = now
        return delta


class RunTracer:
    """Typed event ring and time-series registry for one run.

    ``taps`` switches the metric taps on for any algorithm this tracer is
    attached to (``QAFeL(..., telemetry=tracer)``): the flush and every
    client step then take one more launch each, and their values ride the
    flush and upload events. With ``taps=False`` the tracer still records
    the host-side event stream and the launches stay as without a tracer.
    """

    def __init__(self, capacity: int = 65536, *, taps: bool = True,
                 wall_clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.taps = taps
        self.dropped_events = 0  # ring overflow (oldest evicted)
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._sim_time = 0.0
        self._wall = wall_clock
        self._compiles = CompileWatch()

    # -- clock + emission --------------------------------------------------
    @property
    def sim_time(self) -> float:
        return self._sim_time

    def set_sim_time(self, t: float) -> None:
        self._sim_time = float(t)

    def emit(self, kind: str, *, step: int = 0, **data) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"known: {EVENT_KINDS}")
        if len(self._events) == self.capacity:
            self.dropped_events += 1
        ev = Event(kind=kind, seq=self._seq, step=int(step),
                   t_sim=self._sim_time, t_wall=float(self._wall()),
                   data=data)
        self._seq += 1
        self._events.append(ev)
        return ev

    def poll_compiles(self, *, step: int = 0) -> int:
        """Record a compile event per kernel library loaded since the last
        poll; returns the number of events emitted."""
        emitted = 0
        for library, loads in sorted(self._compiles.poll().items()):
            self.emit("compile", step=step, entry=library, retraces=loads)
            emitted += 1
        return emitted

    # -- read side ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self, kind: Optional[str] = None) -> List[Event]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e.kind == kind]

    def series(self, kind: str, field: str, *,
               subfield: Optional[str] = None) -> List[Any]:
        """One value per event of ``kind``, from ``data[field]`` (or
        ``data[field][subfield]`` for tap dicts); events missing the field
        are skipped."""
        out = []
        for e in self._events:
            if e.kind != kind or field not in e.data:
                continue
            v = e.data[field]
            if subfield is not None:
                if not isinstance(v, dict) or subfield not in v:
                    continue
                v = v[subfield]
            out.append(v)
        return out

    def counters(self) -> Dict[str, int]:
        """Event counts per kind and the absolute load count per kernel
        library (``loads_<library>``)."""
        out = {f"events_{k}": 0 for k in EVENT_KINDS}
        for e in self._events:
            out[f"events_{e.kind}"] += 1
        out["events_evicted"] = self.dropped_events
        for library, total in self._compiles.totals().items():
            out[f"loads_{library}"] = total
        return out

    def metrics(self) -> Dict[str, Any]:
        """The deterministic telemetry keys merged into ``metrics()``:
        per-flush and per-upload tap series (tuples, so two runs' metrics
        dicts compare with ``==``). The load counters stay out: they depend
        on what the process loaded before."""
        from repro_torch.obs.taps import (COHORT_TAP_NAMES, FLUSH_TAP_NAMES,
                                          POPULATION_STATE_NAMES)
        out: Dict[str, Any] = {}
        for kind, names in (("flush", FLUSH_TAP_NAMES),
                            ("upload", COHORT_TAP_NAMES)):
            series = self.series(kind, "taps")
            if series:
                for name in names:
                    out[f"{kind}/{name}"] = tuple(t[name] for t in series
                                                  if name in t)
        pops = self.series("eval", "population")
        if pops:
            for name in POPULATION_STATE_NAMES:
                out[f"population/{name}"] = tuple(p[name] for p in pops
                                                  if name in p)
        return out

    # -- export ------------------------------------------------------------
    def to_jsonl(self, path) -> int:
        """Write the ring as JSONL (one event per line); returns the number
        of events written."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e.as_dict()) + "\n")
        return len(events)

    def iter_dicts(self) -> Iterable[Dict[str, Any]]:
        for e in self._events:
            yield e.as_dict()
