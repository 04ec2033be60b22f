from .likelihoods import (
    CostLikelihood,
    ExpectedCost,
    ExponentiatedUtility,
    GaussianLikelihood,
    LikelihoodState,
)
from .svmpc import (
    SVMPC,
    FusedPendulumSVMPC,
    FusedSVMPCState,
    SVMPCState,
)
from .mpf import MPF, FusedPendulumMPF, MPFState

__all__ = [
    "CostLikelihood",
    "ExpectedCost",
    "ExponentiatedUtility",
    "GaussianLikelihood",
    "LikelihoodState",
    "SVMPC",
    "SVMPCState",
    "FusedPendulumSVMPC",
    "FusedSVMPCState",
    "MPF",
    "FusedPendulumMPF",
    "MPFState",
]
