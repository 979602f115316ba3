"""Reporters: JSONL artifact, terminal summary table, report rows.

Counterpart of ``repro/obs/report.py``. Three read-side sinks for one
``RunTracer``:

* ``write_jsonl``: the archival artifact, one event per line, validated by
  ``obs.schema``;
* ``summary_table``: a fixed-width terminal table of event counts and
  tap-series statistics (``examples/cohort_scenarios.py --trace``);
* ``report_rows``: ``obs/*`` rows through a ``report(name, us, derived)``
  callback, the reference's benchmark-row signature.
"""
from __future__ import annotations

import math
from typing import List, Sequence


def write_jsonl(tracer, path) -> int:
    """Write the tracer's event ring to ``path`` as JSONL; returns the
    number of events written."""
    return tracer.to_jsonl(path)


def _stats(values: Sequence[float]):
    vals = [float(v) for v in values if not math.isnan(float(v))]
    if not vals:
        return None
    return (len(vals), min(vals), sum(vals) / len(vals), max(vals))


def summary_table(tracer, *, title: str = "telemetry") -> str:
    """Fixed-width terminal summary of one run's telemetry."""
    rows: List[tuple] = []
    counters = tracer.counters()
    for key in sorted(counters):
        if counters[key]:
            rows.append((key, "", f"{counters[key]}", ""))
    for key, series in sorted(tracer.metrics().items()):
        st = _stats(series)
        if st is None:
            continue
        n, lo, mean, hi = st
        rows.append((key, f"{lo:.4g}", f"{mean:.4g}", f"{hi:.4g}"))
    header = (f"{'series':<28} {'min':>12} {'mean/count':>12} {'max':>12}")
    bar = "-" * len(header)
    lines = [f"== {title} ==", header, bar]
    for name, lo, mid, hi in rows:
        lines.append(f"{name:<28} {lo:>12} {mid:>12} {hi:>12}")
    if not rows:
        lines.append("(no events recorded)")
    return "\n".join(lines)


def report_rows(tracer, report, *, prefix: str = "obs") -> int:
    """Emit tracer aggregates as ``{prefix}/*`` rows through a
    ``benchmarks.run.report``-style callback; returns the row count."""
    emitted = 0
    counters = tracer.counters()
    counts = ";".join(f"{k}={v}" for k, v in sorted(counters.items()) if v)
    report(f"{prefix}/events", 0.0, counts or "empty=1")
    emitted += 1
    for key, series in sorted(tracer.metrics().items()):
        st = _stats(series)
        if st is None:
            continue
        n, lo, mean, hi = st
        report(f"{prefix}/{key}", 0.0,
               f"n={n};min={lo:.6g};mean={mean:.6g};max={hi:.6g}")
        emitted += 1
    return emitted
