from .base import BaseModel
from .pendulum import PendulumModel

__all__ = ["BaseModel", "PendulumModel"]
