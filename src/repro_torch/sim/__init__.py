"""Event-driven asynchronous FL simulation: the sequential, cohort and
population engines, and the client-heterogeneity scenarios."""
from repro_torch.sim.cohort import CohortAsyncFLSimulator
from repro_torch.sim.events import AsyncFLSimulator, SimConfig, SimResult
from repro_torch.sim.population import (PopulationAsyncFLSimulator,
                                        PopulationEngine, compile_scenario)
from repro_torch.sim.scenarios import (SCENARIOS, ScenarioConfig,
                                       ScenarioSampler, get_scenario)

__all__ = ["AsyncFLSimulator", "CohortAsyncFLSimulator",
           "PopulationAsyncFLSimulator", "PopulationEngine", "SCENARIOS",
           "ScenarioConfig", "ScenarioSampler", "SimConfig", "SimResult",
           "compile_scenario", "get_scenario"]
