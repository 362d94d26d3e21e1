"""Batched legged-robot environments for the PyTorch port (flat ground and
heightfield terrain)."""

from .env import HumanoidEnv, Transition, make_env
from .state import EnvState

__all__ = ["EnvState", "HumanoidEnv", "Transition", "make_env"]
