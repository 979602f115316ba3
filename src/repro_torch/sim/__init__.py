"""Event-driven asynchronous FL simulation."""
from repro_torch.sim.events import AsyncFLSimulator, SimConfig, SimResult

__all__ = ["AsyncFLSimulator", "SimConfig", "SimResult"]
