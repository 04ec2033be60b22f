from .base import BaseModel
from .cartpole import CartPoleModel
from .obstacle_map import ObstacleMap
from .particle import Particle
from .pendulum import PendulumModel
from .skid_steer import SkidSteerNavigation, SkidSteerRobot

__all__ = ["BaseModel", "CartPoleModel", "ObstacleMap", "Particle",
           "PendulumModel", "SkidSteerNavigation", "SkidSteerRobot"]
