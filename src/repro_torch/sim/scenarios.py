"""Client-heterogeneity scenarios for the async simulators.

Counterpart of ``repro/sim/scenarios.py``, pure numpy, so the port keeps
its own copy. A scenario bundles three models, all drawn from one seeded
numpy ``Generator`` so whole runs replay deterministically:

* **latency** — per-client training duration: ``half_normal`` (|N(0,1)|,
  the sequential simulator's model), ``lognormal`` (heavy right tail),
  ``uniform`` (U(0.5, 1.5)) or ``trace`` (a measured duration array,
  cycled);
* **arrival** — ``constant`` rate (client n starts at n / r) or
  ``poisson`` (exponential interarrivals);
* **behaviour** — dropout probability (the update is computed but never
  arrives), a straggler multiplier for a slow fraction of clients, and
  per-client quantizer bit-width tiers (a fraction of clients upload
  through a narrower quantizer, e.g. 2-bit qsgd).

``SCENARIOS`` maps preset names to configs. The default config is the
**identity scenario**, the sequential ``AsyncFLSimulator``'s timing model,
under which the cohort engine at ``cohort_size=1`` reproduces the
sequential trajectory bit for bit. The arrival rate is calibrated by
Little's law, ``rate = concurrency / E[duration]``, stragglers included.

The sampler must consume the generator in exactly the reference's order —
a disabled feature draws nothing — or the two packages' timelines part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import numpy as np

HALF_NORMAL_MEAN = math.sqrt(2.0 / math.pi)

_LATENCIES = ("half_normal", "lognormal", "uniform", "trace")
_ARRIVALS = ("constant", "poisson")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Declarative description of one client-heterogeneity regime."""

    latency: str = "half_normal"  # one of _LATENCIES
    latency_scale: float = 1.0  # multiplies every sampled duration
    lognormal_sigma: float = 1.0  # lognormal shape (mu = -sigma^2/2 -> mean 1)
    trace: Tuple[float, ...] = ()  # trace-replay durations, cycled
    arrival: str = "constant"  # one of _ARRIVALS
    dropout: float = 0.0  # P(upload lost after local training)
    straggler_frac: float = 0.0  # fraction of clients slowed down
    straggler_mult: float = 1.0  # duration multiplier for stragglers
    # ((fraction, quantizer_name), ...): each admitted client falls into tier
    # j with probability fraction_j and uploads through that quantizer; the
    # remaining probability mass uses the algorithm's default client quantizer.
    tiers: Tuple[Tuple[float, str], ...] = ()

    def __post_init__(self):
        if self.latency not in _LATENCIES:
            raise ValueError(f"unknown latency model: {self.latency!r}")
        if self.arrival not in _ARRIVALS:
            raise ValueError(f"unknown arrival process: {self.arrival!r}")
        if self.latency == "trace" and not self.trace:
            raise ValueError("trace latency model needs a non-empty trace")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError("straggler_frac must be in [0, 1]")
        if self.straggler_mult < 1.0:
            raise ValueError("straggler_mult must be >= 1")
        if sum(f for f, _ in self.tiers) > 1.0 + 1e-9:
            raise ValueError("tier fractions must sum to <= 1")

    @property
    def mean_duration(self) -> float:
        """E[duration] before the straggler slowdown."""
        if self.latency == "half_normal":
            base = HALF_NORMAL_MEAN
        elif self.latency == "lognormal":
            base = 1.0  # mu = -sigma^2/2 normalizes the mean to 1
        elif self.latency == "uniform":
            base = 1.0  # U(0.5, 1.5)
        else:
            base = float(np.mean(self.trace))
        return base * self.latency_scale

    @property
    def effective_mean_duration(self) -> float:
        """E[duration] including the straggler fraction."""
        return self.mean_duration * (
            1.0 + self.straggler_frac * (self.straggler_mult - 1.0))

    def arrival_rate(self, concurrency: int) -> float:
        """Rate achieving the requested average concurrency (Little's law)."""
        return concurrency / self.effective_mean_duration


class ScenarioSampler:
    """Vectorized per-cohort sampling of one scenario.

    Disabled features draw NOTHING from the generator, so the identity
    scenario consumes the numpy stream exactly like the sequential
    simulator: one standard normal per admitted client, nothing else —
    which is what makes the cohort_size=1 equivalence bit-exact.
    """

    def __init__(self, cfg: ScenarioConfig, concurrency: int,
                 rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self.rate = cfg.arrival_rate(concurrency)
        self._trace_pos = 0

    def interarrivals(self, size: int) -> np.ndarray:
        if self.cfg.arrival == "constant":
            return np.full(size, 1.0 / self.rate)
        return self.rng.exponential(1.0 / self.rate, size)

    def durations(self, size: int) -> np.ndarray:
        cfg = self.cfg
        if cfg.latency == "half_normal":
            d = np.abs(self.rng.normal(0.0, 1.0, size))
        elif cfg.latency == "lognormal":
            mu = -0.5 * cfg.lognormal_sigma ** 2
            d = self.rng.lognormal(mu, cfg.lognormal_sigma, size)
        elif cfg.latency == "uniform":
            d = self.rng.uniform(0.5, 1.5, size)
        else:  # trace replay, cycled
            tr = np.asarray(cfg.trace, dtype=np.float64)
            idx = (self._trace_pos + np.arange(size)) % tr.size
            self._trace_pos = int((self._trace_pos + size) % tr.size)
            d = tr[idx]
        d = d * cfg.latency_scale
        if cfg.straggler_frac > 0.0:
            slow = self.rng.random(size) < cfg.straggler_frac
            d = np.where(slow, d * cfg.straggler_mult, d)
        return d

    def dropouts(self, size: int) -> np.ndarray:
        if self.cfg.dropout <= 0.0:
            return np.zeros(size, dtype=bool)
        return self.rng.random(size) < self.cfg.dropout

    def tier_indices(self, size: int) -> np.ndarray:
        """Tier index per client: -1 = default quantizer, j >= 0 indexes
        ``cfg.tiers``."""
        if not self.cfg.tiers:
            return np.full(size, -1, dtype=np.int64)
        u = self.rng.random(size)
        out = np.full(size, -1, dtype=np.int64)
        lo = 0.0
        for j, (frac, _) in enumerate(self.cfg.tiers):
            out = np.where((u >= lo) & (u < lo + frac), j, out)
            lo += frac
        return out


# ---------------------------------------------------------------------------
# Named presets
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, ScenarioConfig] = {
    # the sequential simulator's exact timing model
    "identity": ScenarioConfig(),
    # heavy-tailed device speeds + bursty arrivals + 10% lost uploads
    "lognormal_dropout": ScenarioConfig(
        latency="lognormal", lognormal_sigma=1.0, arrival="poisson",
        dropout=0.1),
    # very heavy production tail (sigma=1.5 puts p99 at ~30x the median)
    "production_tail": ScenarioConfig(latency="lognormal",
                                      lognormal_sigma=1.5),
    # 20% of devices are 4x slower (bimodal fleet)
    "bimodal_stragglers": ScenarioConfig(straggler_frac=0.2,
                                         straggler_mult=4.0),
    # bounded durations, Poisson arrivals
    "uniform_poisson": ScenarioConfig(latency="uniform", arrival="poisson"),
    # replay a short measured duration trace
    "trace_replay": ScenarioConfig(
        latency="trace", trace=(0.2, 0.5, 0.9, 1.4, 2.5, 0.3, 0.7, 1.1)),
    # 30% of clients sit on a low-bandwidth link and upload 2-bit qsgd
    "tiered_bits": ScenarioConfig(tiers=((0.3, "qsgd2"),)),
}


def get_scenario(scenario: Union[str, ScenarioConfig]) -> ScenarioConfig:
    """Resolve a scenario by preset name (or pass a config through)."""
    if isinstance(scenario, ScenarioConfig):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown scenario {scenario!r}; known: "
                         f"{sorted(SCENARIOS)}") from None
