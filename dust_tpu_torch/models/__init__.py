from .base import BaseModel
from .obstacle_map import ObstacleMap
from .particle import Particle
from .pendulum import PendulumModel

__all__ = ["BaseModel", "ObstacleMap", "Particle", "PendulumModel"]
