"""Staleness tracking (Assumption 3.4) and the drop policy.

Counterpart of ``repro/core/staleness.py``. The staleness tau of an upload
is the number of server steps between the model version its client started
from and the version it is applied to; FedBuff and QAFeL down-weight stale
updates by 1/sqrt(1+tau) (``QAFeL.receive``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import sqrt_f32


def staleness_weight(tau, enabled: bool = True) -> torch.Tensor:
    """1/sqrt(1+tau) in f32 (ones when disabled), on scalars or tensors:
    ``1 + tau`` in f32, a correctly rounded root (``ref.sqrt_f32``) and
    one division, as the reference computes it called eagerly (the
    launcher's call); bit for bit with it for every tau in 0..10^6. (XLA
    rewrites the quotient into a reciprocal square root when the call is
    jitted, which differs in the last bit.) A tensor ``tau`` keeps its
    device."""
    t = torch.as_tensor(tau).to(torch.float32)
    if not enabled:
        return torch.ones_like(t)
    return 1.0 / sqrt_f32(1.0 + t)


@dataclasses.dataclass
class StalenessMonitor:
    """Accepted staleness values and drop-policy rejections.

    ``max_allowed > 0`` makes ``observe`` raise on a violation (for callers
    that should have filtered already); ``QAFeL.receive`` enforces the bound
    as a drop policy through ``would_drop`` / ``record_dropped``.
    """

    max_allowed: int = 0  # 0 = unbounded
    history: List[int] = dataclasses.field(default_factory=list)
    dropped: List[int] = dataclasses.field(default_factory=list)

    def observe(self, tau: int) -> None:
        if tau < 0:
            raise ValueError(
                f"negative staleness {tau}: the update claims a model version "
                "newer than the server's (clock skew or replay)")
        if self.max_allowed and tau > self.max_allowed:
            raise RuntimeError(
                f"staleness {tau} exceeds tau_max={self.max_allowed} "
                "(Assumption 3.4 violated)")
        self.history.append(int(tau))

    def observe_batch(self, taus) -> None:
        """``observe`` of each value of ``taus`` in order, in one call (the
        population engine's delivery batches): on a violation the values
        before it are recorded and the same error is raised."""
        vals = [int(t) for t in np.asarray(taus).reshape(-1)]
        for i, v in enumerate(vals):
            if v < 0 or (self.max_allowed and v > self.max_allowed):
                self.history.extend(vals[:i])
                self.observe(v)  # raises observe's error
        self.history.extend(vals)

    def would_drop(self, tau: int) -> bool:
        """True when the drop policy rejects an upload of staleness tau."""
        return bool(self.max_allowed) and tau > self.max_allowed

    def record_dropped(self, tau: int) -> None:
        self.dropped.append(int(tau))

    @property
    def tau_max(self) -> int:
        return max(self.history, default=0)

    @property
    def tau_mean(self) -> float:
        return sum(self.history) / len(self.history) if self.history else 0.0

    def histogram(self, bins: int = 8) -> Dict[str, Tuple]:
        """Counts per power-of-two bucket ``[0, 1, 2, 4, ...)``, accepted
        and dropped; the last bucket is open-ended."""
        if bins < 2:
            raise ValueError(f"histogram needs >= 2 bins, got {bins}")
        edges = [0] + [1 << i for i in range(bins - 1)]

        def bucketize(taus):
            counts = [0] * bins
            for tau in taus:
                for i in range(bins - 1, -1, -1):
                    if tau >= edges[i]:
                        counts[i] += 1
                        break
            return tuple(counts)

        return {"edges": tuple(edges), "accepted": bucketize(self.history),
                "dropped": bucketize(self.dropped)}

    def summary(self) -> Dict[str, Any]:
        return {"tau_max": self.tau_max, "tau_mean": self.tau_mean,
                "n": len(self.history),
                "stale_dropped": len(self.dropped),
                "tau_max_dropped": max(self.dropped, default=0),
                "tau_hist": self.histogram()}


def tau_max_for_buffer(tau_max_1: int, k: int) -> int:
    """Appendix A of FedBuff: tau_max,K <= ceil(tau_max,1 / K)."""
    return math.ceil(tau_max_1 / max(k, 1))
