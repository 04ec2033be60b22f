from .likelihoods import (
    CostLikelihood,
    ExpectedCost,
    ExponentiatedUtility,
    GaussianLikelihood,
    LikelihoodState,
)
from .svmpc import SVMPC, SVMPCState
from .mpf import MPF, FusedPendulumMPF, MPFState

__all__ = [
    "CostLikelihood",
    "ExpectedCost",
    "ExponentiatedUtility",
    "GaussianLikelihood",
    "LikelihoodState",
    "SVMPC",
    "SVMPCState",
    "MPF",
    "FusedPendulumMPF",
    "MPFState",
]
