"""Batched legged-robot environments for the PyTorch port (flat ground and
heightfield terrain), and the joint batch of several robots."""

from .env import HumanoidEnv, Transition, make_env
from .joint import JointEnv, make_joint_xbot_env
from .state import EnvState

__all__ = ["EnvState", "HumanoidEnv", "JointEnv", "Transition", "make_env", "make_joint_xbot_env"]
