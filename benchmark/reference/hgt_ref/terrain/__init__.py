"""Terrain synthesis (host-side NumPy, once at init) and the heightfield
lookups in PyTorch.

Port of humanoid_gym_tpu/terrain: the same grid from the same seed, and
torch height functions closed over it on the env's device (observation
3-tap min, bilinear contact surface, its slope).
"""

from .primitives import (
    SubGrid,
    discrete_obstacles,
    gap,
    pit,
    pyramid_sloped,
    pyramid_stairs,
    random_uniform,
    stepping_stones,
)
from .terrain import (
    TerrainMap,
    flat_height_fn,
    make_contact_height_fn,
    make_grad_fn,
    make_height_fn,
)

__all__ = [
    "SubGrid",
    "TerrainMap",
    "discrete_obstacles",
    "flat_height_fn",
    "gap",
    "make_contact_height_fn",
    "make_grad_fn",
    "make_height_fn",
    "pit",
    "pyramid_sloped",
    "pyramid_stairs",
    "random_uniform",
    "stepping_stones",
]
