"""Heightfield sub-terrain primitives (host-side NumPy, int16 height units).

The port's own copy of humanoid_gym_tpu/terrain/primitives.py (NumPy, no
JAX; the port imports nothing of the JAX package). Fresh implementations of
the capability surface the reference pulls from Isaac Gym's
``terrain_utils`` (reference humanoid/utils/terrain.py:100-143:
pyramid_sloped_terrain, random_uniform_terrain, pyramid_stairs_terrain,
discrete_obstacles_terrain, stepping_stones_terrain) plus the repo-local
gap/pit terrains (reference terrain.py:166-187).

All primitives mutate a ``SubGrid`` in place and take explicit RNGs
(``numpy.random.Generator``) — no global RNG, so terrain synthesis is
reproducible from a seed, and the same seed gives the JAX package's grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SubGrid:
    """One sub-terrain patch: an int16 heightfield with its scales."""

    width: int  # pixels along x
    length: int  # pixels along y
    horizontal_scale: float  # m / pixel
    vertical_scale: float  # m / height unit
    hf: np.ndarray = field(default=None)  # (width, length) int16

    def __post_init__(self):
        if self.hf is None:
            self.hf = np.zeros((self.width, self.length), dtype=np.int16)

    def to_units(self, meters: float) -> int:
        return int(meters / self.vertical_scale)

    def to_px(self, meters: float) -> int:
        return int(meters / self.horizontal_scale)


def random_uniform(
    g: SubGrid,
    rng: np.random.Generator,
    min_height: float,
    max_height: float,
    step: float = 0.005,
    downsampled_scale: float = 0.2,
) -> SubGrid:
    """Uniform random bumps sampled on a coarse grid, bilinearly upsampled.

    Matches the parameterization the reference uses (terrain.py:128,220:
    min/max height, step granularity, downsampled_scale in meters).
    """
    lo = g.to_units(min_height)
    hi = g.to_units(max_height)
    step_u = max(1, g.to_units(step))
    choices = np.arange(lo, hi + step_u, step_u)

    ratio = downsampled_scale / g.horizontal_scale
    cw = max(2, int(np.ceil(g.width / ratio)) + 1)
    cl = max(2, int(np.ceil(g.length / ratio)) + 1)
    coarse = rng.choice(choices, size=(cw, cl)).astype(np.float64)

    # bilinear upsample coarse -> fine
    xi = np.linspace(0, cw - 1, g.width)
    yi = np.linspace(0, cl - 1, g.length)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, cw - 1)
    y1 = np.minimum(y0 + 1, cl - 1)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    fine = (
        coarse[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
        + coarse[np.ix_(x1, y0)] * fx * (1 - fy)
        + coarse[np.ix_(x0, y1)] * (1 - fx) * fy
        + coarse[np.ix_(x1, y1)] * fx * fy
    )
    g.hf += fine.astype(np.int16)
    return g


def pyramid_sloped(g: SubGrid, slope: float, platform_size: float = 1.0) -> SubGrid:
    """Pyramid ramp rising (slope>0) or sinking (slope<0) toward the center,
    with a flat central platform (reference terrain.py:125,222-224)."""
    cx, cy = (g.width - 1) / 2.0, (g.length - 1) / 2.0
    x = np.abs(np.arange(g.width) - cx) / max(cx, 1)
    y = np.abs(np.arange(g.length) - cy) / max(cy, 1)
    frac = 1.0 - np.maximum(x[:, None], y[None, :])  # 0 at edge, 1 at center
    max_h = slope * (g.width / 2.0) * g.horizontal_scale / g.vertical_scale
    h = frac * max_h

    # flatten the central platform at its rim height
    half_plat = g.to_px(platform_size) // 2
    if half_plat > 0:
        rim_frac = 1.0 - half_plat / max(cx, 1)
        rim_h = rim_frac * max_h
        if slope > 0:
            h = np.minimum(h, rim_h)
        else:
            h = np.maximum(h, rim_h)
    g.hf += h.astype(np.int16)
    return g


def pyramid_stairs(
    g: SubGrid, step_width: float, step_height: float, platform_size: float = 1.0
) -> SubGrid:
    """Concentric rectangular steps toward the center (reference
    terrain.py:132,226-228). step_height<0 builds descending stairs."""
    sw = max(1, g.to_px(step_width))
    sh = g.to_units(step_height)
    half_plat = max(1, g.to_px(platform_size) // 2)
    cx, cy = (g.width - 1) / 2.0, (g.length - 1) / 2.0
    dx = np.abs(np.arange(g.width) - cx)
    dy = np.abs(np.arange(g.length) - cy)
    d = np.maximum(dx[:, None], dy[None, :])  # Chebyshev distance from center
    edge = max(cx, cy)
    ring = np.floor(np.maximum(edge - d, 0.0) / sw).astype(np.int64)  # 0 at edge
    ring_plat = int(np.floor(max(edge - half_plat, 0.0) / sw))
    ring = np.minimum(ring, ring_plat + 1)
    g.hf += (ring * sh).astype(np.int16)
    return g


def discrete_obstacles(
    g: SubGrid,
    rng: np.random.Generator,
    max_height: float,
    min_size: float,
    max_size: float,
    num_rects: int,
    platform_size: float = 1.0,
) -> SubGrid:
    """Random raised/sunken boxes; flat central platform (reference
    terrain.py:133-137,214-218)."""
    h_u = g.to_units(max_height)
    heights = np.array([-h_u, -h_u // 2, h_u // 2, h_u])
    for _ in range(num_rects):
        w = g.to_px(rng.uniform(min_size, max_size))
        l = g.to_px(rng.uniform(min_size, max_size))
        w = max(1, min(w, g.width - 1))
        l = max(1, min(l, g.length - 1))
        x = rng.integers(0, g.width - w + 1)
        y = rng.integers(0, g.length - l + 1)
        g.hf[x : x + w, y : y + l] = rng.choice(heights)
    # clear center platform
    half = max(1, g.to_px(platform_size) // 2)
    cx, cy = g.width // 2, g.length // 2
    g.hf[cx - half : cx + half, cy - half : cy + half] = 0
    return g


def stepping_stones(
    g: SubGrid,
    rng: np.random.Generator,
    stone_size: float,
    stone_distance: float,
    max_height: float,
    platform_size: float = 1.0,
    depth: float = -10.0,
) -> SubGrid:
    """Grid of stones over a deep trench (reference terrain.py:139)."""
    ss = max(1, g.to_px(stone_size))
    sd = max(0, g.to_px(stone_distance))
    pitch = ss + sd
    floor = g.to_units(depth)
    h_u = g.to_units(max_height)
    g.hf[:] = floor
    for x0 in range(0, g.width, pitch):
        xoff = int(rng.integers(0, max(sd, 1))) if sd else 0
        for y0 in range(0, g.length, pitch):
            x1 = min(x0 + xoff + ss, g.width)
            y1 = min(y0 + ss, g.length)
            top = int(rng.integers(-h_u, h_u + 1)) if h_u > 0 else 0
            g.hf[x0 + xoff : x1, y0:y1] = top
    half = max(1, g.to_px(platform_size) // 2)
    cx, cy = g.width // 2, g.length // 2
    g.hf[cx - half : cx + half, cy - half : cy + half] = 0
    return g


def gap(g: SubGrid, gap_size: float, platform_size: float = 1.0) -> SubGrid:
    """Deep square moat around a central platform (reference terrain.py:166-178)."""
    gp = g.to_px(gap_size)
    half_plat = g.to_px(platform_size) // 2
    cx, cy = g.width // 2, g.length // 2
    outer = half_plat + gp
    g.hf[cx - outer : cx + outer, cy - outer : cy + outer] = -1000
    g.hf[cx - half_plat : cx + half_plat, cy - half_plat : cy + half_plat] = 0
    return g


def pit(g: SubGrid, depth: float, platform_size: float = 1.0) -> SubGrid:
    """Sunken central platform (reference terrain.py:180-187)."""
    d = g.to_units(depth)
    half = g.to_px(platform_size) // 2
    cx, cy = g.width // 2, g.length // 2
    g.hf[cx - half : cx + half, cy - half : cy + half] = -d
    return g
