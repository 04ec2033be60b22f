from .likelihoods import (
    CostLikelihood,
    ExpectedCost,
    ExponentiatedUtility,
    GaussianLikelihood,
    LikelihoodState,
)
from .svmpc import (
    SVMPC,
    FusedParticleSVMPC,
    FusedPendulumSVMPC,
    FusedSVMPCState,
    SVMPCState,
)
from .mpf import MPF, FusedMPF, FusedParticleMPF, FusedPendulumMPF, MPFState

__all__ = [
    "CostLikelihood",
    "ExpectedCost",
    "ExponentiatedUtility",
    "GaussianLikelihood",
    "LikelihoodState",
    "SVMPC",
    "SVMPCState",
    "FusedParticleSVMPC",
    "FusedPendulumSVMPC",
    "FusedSVMPCState",
    "MPF",
    "FusedMPF",
    "FusedParticleMPF",
    "FusedPendulumMPF",
    "MPFState",
]
