from .amppi import AMPPI, AMPPIState
from .base import get_hessian, get_jacobian, linearize_model
from .disco import DiscoState, MultiDisco

__all__ = ["AMPPI", "AMPPIState", "DiscoState", "MultiDisco",
           "get_hessian", "get_jacobian", "linearize_model"]
