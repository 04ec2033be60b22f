"""dust_tpu_torch — the DuSt-MPC engine in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card.

A port of `dust_tpu` (JAX/Pallas) that keeps its layout and names, so each
module's counterpart is found under the same path:

    simulation.py          closed-loop pendulum and particle-navigation
                           episode harnesses (+ the whole-episode and
                           sweep kernel adapters)
    experiments.py         config -> stack builders (the pendulum's four
                           cases, particle)
    parallel/              MegakernelGroupSweep (sweep groups, one
                           launch), ScenarioSweep (pendulum),
                           ParticleScenarioSweep
      inference/           likelihoods, SVMPC (+ FusedPendulumSVMPC,
                           FusedParticleSVMPC), MPF (+ ClosedFormPendulumMPF,
                           FusedPendulumMPF, FusedParticleMPF, the large-m
                           FusedMPF), generic SVGD
        controllers/       MultiDisco rollout and update engine, AMPPI,
                           derivative helpers (base.py)
          models/          batched pendulum, point-mass, cart-pole and
                           skid-steer dynamics, the obstacle map
      utils/               Merwe sigma points (MerweScaledUTF)
      ops/                 distances, bandwidth rules, RBF kernels, the
                           rollout-cost, MPF-loop, whole-solve, episode and
                           sweep kernels of both tasks, the streamed SVGD,
                           GMM-score and fused MPF-step kernels
                           (csrc/*.cu)
      distributions.py     MVN / Normal / Uniform / GMM on tensors
    convert.py             state carried across from numpy arrays

The package imports `torch` and `numpy` only. Its entry points
(`build_pendulum_stack`, `PendulumSimulation`, `build_particle_stack`,
the controllers, models, SVGD and the sweeps) run on the card unless the caller passes `device="cpu"`; the CUDA kernels are compiled on first use
(`ops/_build.py`), never at import.
"""

__version__ = "0.1.0"

from .spaces import Box
from .distributions import GMM, MVN, Normal, Uniform
from .utils import MerweScaledUTF
from .models import (
    BaseModel,
    CartPoleModel,
    ObstacleMap,
    Particle,
    PendulumModel,
    SkidSteerRobot,
)
from .controllers import AMPPI, AMPPIState, DiscoState, MultiDisco
from .inference import (
    MPF,
    SVGD,
    ClosedFormPendulumMPF,
    MPFState,
    SVMPC,
    SVMPCState,
    CostLikelihood,
    ExpectedCost,
    ExponentiatedUtility,
    FusedMPF,
    FusedParticleMPF,
    FusedParticleSVMPC,
    FusedPendulumMPF,
    FusedPendulumSVMPC,
    FusedSVMPCState,
    GaussianLikelihood,
    LikelihoodState,
)
from .experiments import (
    PARTICLE_DEMO_CONFIG,
    PENDULUM_DEMO_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from .simulation import (
    PendulumSimulation,
    megakernel_particle_episode_fn,
    megakernel_particle_sweep_fn,
    megakernel_pendulum_episode_fn,
    megakernel_pendulum_sweep_fn,
    particle_episode_fn,
    run_particle_episode,
    to_dataframe,
)
from .parallel import (
    MegakernelGroupSweep,
    ParticleScenarioSweep,
    ScenarioSweep,
    broadcast_scenarios,
)

__all__ = [
    "Box", "GMM", "MVN", "Normal", "Uniform",
    "MerweScaledUTF",
    "BaseModel", "CartPoleModel", "ObstacleMap", "Particle", "PendulumModel",
    "SkidSteerRobot",
    "AMPPI", "AMPPIState", "DiscoState", "MultiDisco",
    "MPF", "MPFState", "SVGD", "SVMPC", "SVMPCState",
    "ClosedFormPendulumMPF",
    "CostLikelihood", "ExpectedCost", "ExponentiatedUtility",
    "FusedMPF", "FusedParticleMPF", "FusedParticleSVMPC",
    "FusedPendulumMPF", "FusedPendulumSVMPC", "FusedSVMPCState",
    "GaussianLikelihood", "LikelihoodState",
    "PARTICLE_DEMO_CONFIG", "PENDULUM_DEMO_CONFIG", "build_particle_stack",
    "build_pendulum_stack",
    "PendulumSimulation", "megakernel_pendulum_episode_fn",
    "megakernel_pendulum_sweep_fn", "megakernel_particle_episode_fn",
    "megakernel_particle_sweep_fn", "particle_episode_fn",
    "run_particle_episode", "to_dataframe",
    "MegakernelGroupSweep", "ParticleScenarioSweep", "ScenarioSweep",
    "broadcast_scenarios",
]
