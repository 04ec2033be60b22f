from .sweep import (
    MegakernelGroupSweep,
    ParticleScenarioSweep,
    broadcast_scenarios,
)

__all__ = ["MegakernelGroupSweep", "ParticleScenarioSweep",
           "broadcast_scenarios"]
