"""The one metrics surface.

Counterpart of ``repro/obs/metrics.py`` without the tracer: the
``TrafficMeter`` and ``StalenessMonitor`` summaries in the reference's key
order, the server step count and, optionally, the hidden drift.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def collect(meter, staleness, server_steps: int, *,
            drift: Optional[float] = None) -> Dict[str, Any]:
    """Build the metrics dict: ``meter.summary()`` keys first, then
    ``staleness.summary()``, ``server_steps`` and ``hidden_drift``."""
    out: Dict[str, Any] = dict(meter.summary())
    out.update(staleness.summary())
    out["server_steps"] = server_steps
    if drift is not None:
        out["hidden_drift"] = drift
    return out
