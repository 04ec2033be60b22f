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
from .mpf import (
    MPF,
    ClosedFormPendulumMPF,
    FusedMPF,
    FusedParticleMPF,
    FusedPendulumMPF,
    MPFState,
)
from .svgd import SVGD

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
    "ClosedFormPendulumMPF",
    "FusedMPF",
    "FusedParticleMPF",
    "FusedPendulumMPF",
    "MPFState",
    "SVGD",
]
