"""dust_tpu_torch — the DuSt-MPC engine in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card.

A port of `dust_tpu` (JAX/Pallas) that keeps its layout and names, so each
module's counterpart is found under the same path:

    simulation.py          closed-loop pendulum episode harness (+ the
                           whole-episode and sweep kernel adapters)
    experiments.py         config -> stack builders
    parallel/              MegakernelGroupSweep (sweep groups, one launch)
      inference/           likelihoods, SVMPC (+ FusedPendulumSVMPC), MPF
                           (+ FusedPendulumMPF)
        controllers/       MultiDisco rollout and update engine
          models/          batched pendulum dynamics
      ops/                 distances, bandwidth rules, RBF kernels, the
                           rollout-cost, MPF-loop, whole-solve, episode and
                           sweep kernels (csrc/*.cu)
      distributions.py     MVN / Normal / Uniform / GMM on tensors
    convert.py             state carried across from numpy arrays

The package imports `torch` and `numpy` only. Its entry points
(`build_pendulum_stack`, `PendulumSimulation`) run on the card unless the
caller passes `device="cpu"`; the CUDA kernels are compiled on first use
(`ops/_build.py`), never at import.
"""

__version__ = "0.1.0"

from .spaces import Box
from .distributions import GMM, MVN, Normal, Uniform
from .models import BaseModel, PendulumModel
from .controllers import DiscoState, MultiDisco
from .inference import (
    MPF,
    MPFState,
    SVMPC,
    SVMPCState,
    CostLikelihood,
    ExpectedCost,
    ExponentiatedUtility,
    FusedPendulumMPF,
    FusedPendulumSVMPC,
    FusedSVMPCState,
    GaussianLikelihood,
    LikelihoodState,
)
from .experiments import PENDULUM_DEMO_CONFIG, build_pendulum_stack
from .simulation import (
    PendulumSimulation,
    megakernel_pendulum_episode_fn,
    megakernel_pendulum_sweep_fn,
    to_dataframe,
)
from .parallel import MegakernelGroupSweep

__all__ = [
    "Box", "GMM", "MVN", "Normal", "Uniform",
    "BaseModel", "PendulumModel",
    "DiscoState", "MultiDisco",
    "MPF", "MPFState", "SVMPC", "SVMPCState",
    "CostLikelihood", "ExpectedCost", "ExponentiatedUtility",
    "FusedPendulumMPF", "FusedPendulumSVMPC", "FusedSVMPCState",
    "GaussianLikelihood", "LikelihoodState",
    "PENDULUM_DEMO_CONFIG", "build_pendulum_stack",
    "PendulumSimulation", "megakernel_pendulum_episode_fn",
    "megakernel_pendulum_sweep_fn", "to_dataframe", "MegakernelGroupSweep",
]
