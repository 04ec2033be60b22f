"""dust_tpu_torch — the DuSt-MPC engine in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card.

A port of `dust_tpu` (JAX/Pallas) that keeps its layout and names, so each
module's counterpart is found under the same path:

    demo/                  the entry points (`python -m
                           dust_tpu_torch.demo.<name>`): the four pendulum
                           cases, particle navigation, sweeps, tuning
    simulation.py          closed-loop pendulum and particle-navigation
                           episode harnesses (+ the whole-episode and
                           sweep kernel adapters, the cart-pole's sweep)
    experiments.py         config -> stack builders (the pendulum's four
                           cases, the cart-pole by `task`, particle)
    tuning.py              random search, successive halving, the
                           per-lane learning-rate sweep and the sweep-
                           kernel objectives
    parallel/              the multi-device layer on torch.distributed:
                           make_mesh, the particle-sharded SVGD / MPF /
                           SVMPC, the rollout-sharded DISCO forward;
                           MegakernelGroupSweep (sweep groups, one
                           launch), ScenarioSweep (pendulum),
                           ParticleScenarioSweep, each over a mesh
      inference/           likelihoods, SVMPC (+ FusedPendulumSVMPC,
                           FusedParticleSVMPC), MPF (+ ClosedFormPendulumMPF,
                           FusedPendulumMPF, FusedParticleMPF, the large-m
                           FusedMPF), generic SVGD
        controllers/       MultiDisco rollout and update engine, AMPPI,
                           derivative helpers (base.py)
          models/          batched pendulum, point-mass, cart-pole and
                           skid-steer dynamics, the obstacle map
      utils/               Merwe sigma points (MerweScaledUTF),
                           checkpoints and results folders (helper.py),
                           tracing and timing (profiling.py), plots
                           (plots.py) and HTML reports (plots_html.py)
      ops/                 distances, bandwidth rules, RBF kernels, the
                           rollout-cost, MPF-loop, whole-solve, episode and
                           sweep kernels of both tasks, the cart-pole's
                           sweep kernel, the streamed SVGD,
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
    SkidSteerNavigation,
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
    CARTPOLE_DEMO_CONFIG,
    PARTICLE_DEMO_CONFIG,
    PARTICLE_TUNED_CONFIG,
    PENDULUM_DEMO_CONFIG,
    PENDULUM_TUNED_CONFIG,
    SKID_STEER_DEMO_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from .simulation import (
    PendulumSimulation,
    megakernel_cartpole_sweep_fn,
    megakernel_particle_episode_fn,
    megakernel_particle_sweep_fn,
    megakernel_pendulum_episode_fn,
    megakernel_pendulum_sweep_fn,
    megakernel_skid_steer_sweep_fn,
    particle_episode_fn,
    run_particle_episode,
    to_dataframe,
)
from .parallel import (
    MegakernelGroupSweep,
    ParticleScenarioSweep,
    ScenarioSweep,
    ShardedMPF,
    ShardedSVMPC,
    broadcast_scenarios,
    initialize_distributed,
    make_mesh,
    make_sharded_disco_forward,
    make_sharded_gmm_score,
    make_sharded_svgd_phi,
    replicated_sharding,
    scenario_sharding,
)

__all__ = [
    "Box", "GMM", "MVN", "Normal", "Uniform",
    "MerweScaledUTF",
    "BaseModel", "CartPoleModel", "ObstacleMap", "Particle", "PendulumModel",
    "SkidSteerNavigation", "SkidSteerRobot",
    "AMPPI", "AMPPIState", "DiscoState", "MultiDisco",
    "MPF", "MPFState", "SVGD", "SVMPC", "SVMPCState",
    "ClosedFormPendulumMPF",
    "CostLikelihood", "ExpectedCost", "ExponentiatedUtility",
    "FusedMPF", "FusedParticleMPF", "FusedParticleSVMPC",
    "FusedPendulumMPF", "FusedPendulumSVMPC", "FusedSVMPCState",
    "GaussianLikelihood", "LikelihoodState",
    "CARTPOLE_DEMO_CONFIG", "PARTICLE_DEMO_CONFIG", "PARTICLE_TUNED_CONFIG",
    "PENDULUM_DEMO_CONFIG",
    "PENDULUM_TUNED_CONFIG", "SKID_STEER_DEMO_CONFIG",
    "build_particle_stack",
    "build_pendulum_stack",
    "PendulumSimulation", "megakernel_pendulum_episode_fn",
    "megakernel_pendulum_sweep_fn", "megakernel_particle_episode_fn",
    "megakernel_particle_sweep_fn", "megakernel_cartpole_sweep_fn",
    "megakernel_skid_steer_sweep_fn",
    "particle_episode_fn",
    "run_particle_episode", "to_dataframe",
    "MegakernelGroupSweep", "ParticleScenarioSweep", "ScenarioSweep",
    "broadcast_scenarios",
    "ShardedMPF", "ShardedSVMPC", "initialize_distributed", "make_mesh",
    "make_sharded_disco_forward", "make_sharded_gmm_score",
    "make_sharded_svgd_phi", "replicated_sharding", "scenario_sharding",
]
