"""The one metrics surface.

Counterpart of ``repro/obs/metrics.py``: the ``TrafficMeter`` and
``StalenessMonitor`` summaries in the reference's key order, the server
step count, optionally the hidden drift, and, with a tracer attached, its
deterministic tap series after them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def collect(meter, staleness, server_steps: int, *,
            tracer=None, drift: Optional[float] = None) -> Dict[str, Any]:
    """Build the metrics dict: ``meter.summary()`` keys first, then
    ``staleness.summary()``, ``server_steps``, ``hidden_drift`` and the
    tracer's ``flush/*`` and ``upload/*`` series (its load counters stay
    out: same-seed runs are compared on whole-dict equality)."""
    out: Dict[str, Any] = dict(meter.summary())
    out.update(staleness.summary())
    out["server_steps"] = server_steps
    if drift is not None:
        out["hidden_drift"] = drift
    if tracer is not None:
        out.update(tracer.metrics())
    return out
