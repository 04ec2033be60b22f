from .sweep import (
    MegakernelGroupSweep,
    ParticleScenarioSweep,
    ScenarioSweep,
    broadcast_scenarios,
)

__all__ = ["MegakernelGroupSweep", "ParticleScenarioSweep", "ScenarioSweep",
           "broadcast_scenarios"]
