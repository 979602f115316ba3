"""Named record types for host-side time series.

Counterpart of ``repro/obs/records.py``: ``AccuracyPoint`` is a NamedTuple,
so it compares and indexes like the plain ``(t_sim, uploads, step,
accuracy)`` tuple while new code can say ``point.accuracy``.
"""
from __future__ import annotations

from typing import NamedTuple


class AccuracyPoint(NamedTuple):
    """One entry of a simulator's accuracy trace."""

    t_sim: float  # simulated wall-clock at the eval
    uploads: int  # uploads delivered so far
    step: int  # server step (model version) evaluated
    accuracy: float  # eval_fn on the full-precision server model x

    def as_dict(self) -> dict:
        return {"t_sim": self.t_sim, "uploads": self.uploads,
                "step": self.step, "accuracy": self.accuracy}
