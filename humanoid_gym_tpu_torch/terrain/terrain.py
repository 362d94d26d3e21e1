"""Terrain map assembly (host-side NumPy) and the height lookups in PyTorch.

Port of humanoid_gym_tpu/terrain/terrain.py. `TerrainMap` reproduces the
grid-of-subterrains layout (reference humanoid/utils/terrain.py:38-164):
num_rows difficulty levels x num_cols terrain types surrounded by a flat
border, env origins at the subterrain centers with z the highest point of
the central 2 x 2 m. The same config and `numpy.random.Generator` give the
JAX package's grid, node for node.

Menus (`cfg.style`): "humanoid" (the reference HumanoidTerrain menu, the
XBot-L default), "legged" (the base Terrain menu), "rubble" (deployment-
matched coarse unevenness), "deploy" (windows of the MuJoCo deployment
heightfield, read from its MJCF and PNG without `mujoco`) and the
`selected` mode (one named primitive everywhere).

World convention (reference legged_robot.py:777-795): world (x, y) in meters
maps to grid node (x + border_size) / horizontal_scale along axis 0.

The height functions are torch functions closed over the grid as a float32
tensor on one device, with direct gathers (the JAX package's tile-window
gathers are a TPU layout device that yields the same values):
- `make_height_fn`: the 3-tap min of (px, py), (px+1, py), (px, py+1), the
  frozen OBSERVATION contract (termination probes, measured heights);
- `make_contact_height_fn`: the bilinear surface, the CONTACT geometry;
- `make_grad_fn`: that surface's slope in the cell, for sloped contact
  frames.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from . import primitives as P


@dataclass
class TerrainMap:
    height_field: np.ndarray  # (tot_rows, tot_cols) int16
    horizontal_scale: float
    vertical_scale: float
    border_size: float
    env_origins: np.ndarray  # (num_rows, num_cols, 3) float
    env_length: float
    env_width: float
    num_rows: int
    num_cols: int

    @staticmethod
    def build(cfg, rng: np.random.Generator | None = None, style: str = "humanoid") -> "TerrainMap":
        """cfg: config.base.TerrainCfg."""
        rng = rng or np.random.default_rng(0)
        style = getattr(cfg, "style", style) or style
        w_px = int(cfg.terrain_width / cfg.horizontal_scale)
        l_px = int(cfg.terrain_length / cfg.horizontal_scale)
        border = int(cfg.border_size / cfg.horizontal_scale)
        tot_rows = cfg.num_rows * l_px + 2 * border
        tot_cols = cfg.num_cols * w_px + 2 * border
        hf = np.zeros((tot_rows, tot_cols), dtype=np.int16)
        origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
        proportions = np.cumsum(cfg.terrain_proportions).tolist()

        selected = bool(getattr(cfg, "selected", False))
        # Froude height-amplitude scale: menu height constants multiply by fs
        # at synthesis time; slopes and horizontal extents stay. `selected`
        # passes the user's kwargs through verbatim.
        fs = float(getattr(cfg, "froude_scale", 1.0))
        for i in range(cfg.num_rows):
            for j in range(cfg.num_cols):
                if cfg.curriculum:
                    difficulty = i / cfg.num_rows
                    choice = j / cfg.num_cols + 0.001
                elif style == "humanoid":
                    choice = rng.uniform(0, 1)
                    difficulty = rng.uniform(0, 1)
                else:
                    choice = rng.uniform(0, 1)
                    difficulty = rng.choice([0.5, 0.75, 0.9])
                g = P.SubGrid(l_px, w_px, cfg.horizontal_scale, cfg.vertical_scale)
                if selected:
                    _selected_menu(g, rng, cfg.terrain_kwargs)
                elif style == "humanoid":
                    _humanoid_menu(g, rng, choice, difficulty, proportions, fs)
                elif style == "rubble":
                    _rubble_menu(
                        g, rng, choice, difficulty, proportions,
                        base=getattr(cfg, "rubble_base", 0.05) * fs,
                        span=getattr(cfg, "rubble_span", 0.30) * fs,
                        fs=fs,
                    )
                elif style == "deploy":
                    _deploy_menu(
                        g, rng, choice, difficulty, proportions,
                        mjcf=getattr(cfg, "deploy_mjcf", None),
                        base=getattr(cfg, "rubble_base", 0.05),
                        span=getattr(cfg, "rubble_span", 0.30),
                        fs=fs,
                    )
                else:
                    _legged_menu(g, rng, choice, difficulty, proportions, fs)
                x0 = border + i * l_px
                y0 = border + j * w_px
                hf[x0 : x0 + l_px, y0 : y0 + w_px] = g.hf
                # origin: center of the patch; z from the central 2 x 2 m
                ox = (i + 0.5) * cfg.terrain_length
                oy = (j + 0.5) * cfg.terrain_width
                cx1 = int((cfg.terrain_length / 2.0 - 1) / cfg.horizontal_scale)
                cx2 = int((cfg.terrain_length / 2.0 + 1) / cfg.horizontal_scale)
                cy1 = int((cfg.terrain_width / 2.0 - 1) / cfg.horizontal_scale)
                cy2 = int((cfg.terrain_width / 2.0 + 1) / cfg.horizontal_scale)
                oz = np.max(g.hf[cx1:cx2, cy1:cy2]) * cfg.vertical_scale
                origins[i, j] = [ox, oy, oz]

        return TerrainMap(
            height_field=hf,
            horizontal_scale=cfg.horizontal_scale,
            vertical_scale=cfg.vertical_scale,
            border_size=cfg.border_size,
            env_origins=origins,
            env_length=cfg.terrain_length,
            env_width=cfg.terrain_width,
            num_rows=cfg.num_rows,
            num_cols=cfg.num_cols,
        )


# name -> (primitive fn, needs rng). Keys accept both the local primitive
# names and the reference's Isaac `terrain_utils` names ("*_terrain").
_SELECTED_PRIMS = {
    "random_uniform": (P.random_uniform, True),
    "pyramid_sloped": (P.pyramid_sloped, False),
    "pyramid_stairs": (P.pyramid_stairs, False),
    "discrete_obstacles": (P.discrete_obstacles, True),
    "stepping_stones": (P.stepping_stones, True),
    "gap": (P.gap, False),
    "pit": (P.pit, False),
}


def _selected_menu(g, rng, terrain_kwargs):
    """`cfg.terrain.selected` mode (reference terrain.py:94-107): every
    subterrain is ONE named primitive with `terrain_kwargs` as its
    arguments; dispatch by a dict lookup, the caller's kwargs are copied."""
    kwargs = dict(terrain_kwargs or {})
    name = kwargs.pop("type", None)
    if not name:
        raise ValueError("terrain.selected=True requires terrain_kwargs={'type': <name>, ...}")
    key = name[: -len("_terrain")] if name.endswith("_terrain") else name
    if key not in _SELECTED_PRIMS:
        raise ValueError(f"unknown selected terrain type {name!r}; known: {sorted(_SELECTED_PRIMS)}")
    fn, needs_rng = _SELECTED_PRIMS[key]
    if needs_rng:
        fn(g, rng, **kwargs)
    else:
        fn(g, **kwargs)


def _legged_menu(g, rng, choice, difficulty, prop, fs=1.0):
    """Base Terrain menu (reference terrain.py:109-145). fs scales the
    height amplitudes (Froude; slopes and horizontal extents stay)."""
    slope = difficulty * 0.4
    step_height = (0.05 + 0.18 * difficulty) * fs
    obstacle_h = (0.05 + difficulty * 0.2) * fs
    stone_size = 1.5 * (1.05 - difficulty)
    stone_dist = 0.05 if difficulty == 0 else 0.1
    gap_size = 1.0 * difficulty
    pit_depth = 1.0 * difficulty * fs
    prop = prop + [1.0] * (7 - len(prop))
    if choice < prop[0]:
        if choice < prop[0] / 2:
            slope = -slope
        P.pyramid_sloped(g, slope=slope, platform_size=3.0)
    elif choice < prop[1]:
        P.pyramid_sloped(g, slope=slope, platform_size=3.0)
        P.random_uniform(g, rng, -0.05 * fs, 0.05 * fs, step=0.005, downsampled_scale=0.2)
    elif choice < prop[3]:
        if choice < prop[2]:
            step_height = -step_height
        P.pyramid_stairs(g, step_width=0.31, step_height=step_height, platform_size=3.0)
    elif choice < prop[4]:
        P.discrete_obstacles(g, rng, obstacle_h, 1.0, 2.0, 20, platform_size=3.0)
    elif choice < prop[5]:
        P.stepping_stones(g, rng, stone_size, stone_dist, max_height=0.0, platform_size=4.0)
    elif choice < prop[6]:
        P.gap(g, gap_size=gap_size, platform_size=3.0)
    else:
        P.pit(g, depth=pit_depth, platform_size=4.0)


def _rubble_menu(g, rng, choice, difficulty, prop, base=0.05, span=0.30, fs=1.0):
    """Deployment-matched coarse unevenness: prop[0] of the columns keep
    the gentle humanoid roughness, the rest are coarse random cells of
    amplitude base + span * difficulty (the caller pre-scales base / span
    by the Froude factor; fs scales the gentle slice)."""
    if choice < prop[0]:
        r_height = difficulty * 0.07 * fs
        P.random_uniform(g, rng, -r_height, r_height, step=0.005, downsampled_scale=0.2)
    else:
        max_h = base + span * difficulty
        P.random_uniform(g, rng, 0.0, max_h, step=0.01, downsampled_scale=1.0)


def _png_gray8(path: str) -> np.ndarray:
    """An 8-bit grayscale, non-interlaced PNG as a (height, width) uint8
    array, top row first: the IDAT stream inflated with zlib and each row
    unfiltered (none, sub, up, average, Paeth; one byte per pixel)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = hdr
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale, non-interlaced PNGs are read "
                         f"(bit depth {depth}, color type {color}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {width} x {height}")
    img = np.zeros((height, width), np.uint8)
    prev = [0] * width
    for r in range(height):
        filt = raw[r * (width + 1)]
        line = raw[r * (width + 1) + 1:(r + 1) * (width + 1)]
        row = [0] * width
        for c in range(width):
            a = row[c - 1] if c else 0
            b = prev[c]
            if filt == 0:
                pred = 0
            elif filt == 1:
                pred = a
            elif filt == 2:
                pred = b
            elif filt == 3:
                pred = (a + b) >> 1
            elif filt == 4:
                ul = prev[c - 1] if c else 0
                p = a + b - ul
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else ul)
            else:
                raise ValueError(f"{path}: row {r} has unknown filter {filt}")
            row[c] = (line[c] + pred) & 0xFF
        img[r] = row
        prev = row
    return img


def _mjcf_hfield(mjcf_path: str):
    """(size (4,), PNG path) of the hfield under the MJCF's first hfield
    geom, the file resolved against the MJCF's directory."""
    root = ET.parse(mjcf_path).getroot()
    geom = next((g for g in root.iter("geom") if g.get("type") == "hfield"), None)
    if geom is None:
        raise ValueError(f"{mjcf_path}: no hfield geom")
    name = geom.get("hfield")
    field = next((h for h in root.iter("hfield") if h.get("name") == name), None)
    if field is None or field.get("file") is None:
        raise ValueError(f"{mjcf_path}: hfield {name!r} has no PNG file")
    size = np.array(field.get("size").split(), dtype=np.float64)
    return size, os.path.join(os.path.dirname(os.path.abspath(mjcf_path)), field.get("file"))


_DEPLOY_FIELD_CACHE: dict = {}


def _load_deploy_field(mjcf_path: str):
    """The deployment heightfield of an MJCF as (heights in meters indexed
    [x, y], cell_x, cell_y), cached per path. What MuJoCo's loader makes of
    the PNG: rows flipped top to bottom (MuJoCo's row 0 is the image's
    bottom row), min-max normalised, times size[2]; its rows span y and its
    columns x, so the grid is transposed to [x, y] with per-axis cell sizes
    (2 size[0] / (ncol - 1), 2 size[1] / (nrow - 1))."""
    if mjcf_path in _DEPLOY_FIELD_CACHE:
        return _DEPLOY_FIELD_CACHE[mjcf_path]
    size, png = _mjcf_hfield(mjcf_path)
    img = _png_gray8(png)[::-1].astype(np.float32)
    span = float(img.max() - img.min())
    norm = (img - img.min()) / span if span > 0 else np.zeros_like(img)
    nr, nc = img.shape
    h = norm.astype(np.float64) * float(size[2])
    out = (np.ascontiguousarray(h.T), 2.0 * float(size[0]) / (nc - 1),
           2.0 * float(size[1]) / (nr - 1))
    _DEPLOY_FIELD_CACHE[mjcf_path] = out
    return out


def _deploy_menu(g, rng, choice, difficulty, prop, mjcf=None, base=0.05, span=0.30, fs=1.0):
    """Deployment-matched terrain (reference terrain.py:256-310): random
    windows of the MuJoCo deployment heightfield, upsampled to the training
    grid with MuJoCo's triangulated interpolation (cells split along the
    (i, j) -> (i+1, j+1) diagonal), amplitude ramped with the curriculum
    difficulty as (base + span * difficulty) / 0.35. prop[0] of the columns
    keep the gentle humanoid roughness (fs scales it; the window heights
    take their scale from the field, `deploy_mjcf`)."""
    if choice < prop[0]:
        r_height = difficulty * 0.07 * fs
        P.random_uniform(g, rng, -r_height, r_height, step=0.005, downsampled_scale=0.2)
        return
    from .. import XBOT_TERRAIN_MJCF

    h, cell_x, cell_y = _load_deploy_field(mjcf or XBOT_TERRAIN_MJCF)
    # window of the field covering the subgrid's world extent
    # (SubGrid.hf is (width, length) = (x-pixels, y-pixels); h is [x, y])
    wl = g.width * g.horizontal_scale / cell_x
    ww = g.length * g.horizontal_scale / cell_y
    nx, ny = h.shape
    if wl > nx - 1 or ww > ny - 1:
        raise ValueError(
            f"deploy field ({(nx - 1) * cell_x:.0f}x{(ny - 1) * cell_y:.0f} m) is smaller than "
            f"the terrain patch ({g.width * g.horizontal_scale:.0f}x"
            f"{g.length * g.horizontal_scale:.0f} m)")
    r0 = rng.uniform(0, nx - 1 - wl)
    c0 = rng.uniform(0, ny - 1 - ww)
    xi = r0 + np.linspace(0.0, wl, g.width)
    yi = c0 + np.linspace(0.0, ww, g.length)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    h00 = h[np.ix_(x0, y0)]
    h10 = h[np.ix_(x1, y0)]
    h01 = h[np.ix_(x0, y1)]
    h11 = h[np.ix_(x1, y1)]
    lower = h00 + (h10 - h00) * fx + (h11 - h10) * fy
    upper = h00 + (h01 - h00) * fy + (h11 - h01) * fx
    win = np.where(fx >= fy, lower, upper)
    win = win - win.min()
    amp = np.clip((base + span * difficulty) / 0.35, 0.0, 1.0)
    g.hf[:, :] = np.round(win * amp / g.vertical_scale).astype(np.int16)


def _humanoid_menu(g, rng, choice, difficulty, prop, fs=1.0):
    """HumanoidTerrain menu (reference terrain.py:203-231). fs scales the
    height amplitudes (Froude; the slope is dimensionless and stays)."""
    obstacle_h = difficulty * 0.04 * fs
    r_height = difficulty * 0.07 * fs
    h_slope = difficulty * 0.15
    prop = prop + [1.0] * (7 - len(prop))
    if choice < prop[0]:
        pass  # flat
    elif choice < prop[1]:
        P.discrete_obstacles(g, rng, obstacle_h, 1.0, 2.0, 20, platform_size=3.0)
    elif choice < prop[2]:
        P.random_uniform(g, rng, -r_height, r_height, step=0.005, downsampled_scale=0.2)
    elif choice < prop[3]:
        P.pyramid_sloped(g, slope=h_slope, platform_size=0.1)
    elif choice < prop[4]:
        P.pyramid_sloped(g, slope=-h_slope, platform_size=0.1)
    elif choice < prop[5]:
        P.pyramid_stairs(g, step_width=0.4, step_height=obstacle_h, platform_size=1.0)
    elif choice < prop[6]:
        P.pyramid_stairs(g, step_width=0.4, step_height=-obstacle_h, platform_size=1.0)


def grid_tensor(tmap: TerrainMap, device, scaled: bool) -> torch.Tensor:
    """The height grid as float32 on `device`: raw height units, or meters
    (`scaled`: each node times vertical_scale in float32)."""
    hf = torch.as_tensor(np.asarray(tmap.height_field, np.float32), device=device)
    return hf * tmap.vertical_scale if scaled else hf


def make_height_fn(tmap: TerrainMap, device="cpu"):
    """Height lookup h(x, y) with the reference's observation semantics
    (legged_robot.py:782-795): floor indexing after the border shift, the
    min of 3 taps, clipped to the grid; meters. x, y: tensors of one shape
    on `device`."""
    hf = grid_tensor(tmap, device, scaled=False)
    inv_h = 1.0 / tmap.horizontal_scale
    border = tmap.border_size
    vscale = tmap.vertical_scale
    nrow, ncol = tmap.height_field.shape

    def height_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        px = torch.clamp(((x + border) * inv_h).to(torch.int64), 0, nrow - 2)
        py = torch.clamp(((y + border) * inv_h).to(torch.int64), 0, ncol - 2)
        h1 = hf[px, py]
        h2 = hf[px + 1, py]
        h3 = hf[px, py + 1]
        return torch.minimum(torch.minimum(h1, h2), h3) * vscale

    return height_fn


def _cell(tmap: TerrainMap, x: torch.Tensor, y: torch.Tensor):
    """Bilinear cell of world (x, y): node indices (x0, y0) and fractions."""
    inv_h = 1.0 / tmap.horizontal_scale
    border = tmap.border_size
    nrow, ncol = tmap.height_field.shape
    gx = torch.clamp((x + border) * inv_h, 0.0, nrow - 1.001)
    gy = torch.clamp((y + border) * inv_h, 0.0, ncol - 1.001)
    x0 = gx.to(torch.int64)
    y0 = gy.to(torch.int64)
    return x0, y0, gx - x0, gy - y0


def make_contact_height_fn(tmap: TerrainMap, device="cpu"):
    """The BILINEAR terrain height for contact resolution. The 3-tap-min
    lookup stays the observation contract, but as contact geometry it turns
    every slope into 10 cm terraces; contacts use the continuous bilinear
    surface (the family of MuJoCo's hfield prisms and PhysX trimesh
    collision)."""
    hf = grid_tensor(tmap, device, scaled=True)

    def height_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x0, y0, fx, fy = _cell(tmap, x, y)
        h00 = hf[x0, y0]
        h10 = hf[x0 + 1, y0]
        h01 = hf[x0, y0 + 1]
        h11 = hf[x0 + 1, y0 + 1]
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    return height_fn


def make_grad_fn(tmap: TerrainMap, device="cpu"):
    """The slope (dh/dx, dh/dy) of the bilinear contact surface at world
    (x, y): the gradient in `make_contact_height_fn`'s cell, so contact
    frames tilt with the height the solver feels."""
    hf = grid_tensor(tmap, device, scaled=True)
    inv_h = 1.0 / tmap.horizontal_scale

    def grad_fn(x: torch.Tensor, y: torch.Tensor):
        x0, y0, fx, fy = _cell(tmap, x, y)
        h00 = hf[x0, y0]
        h10 = hf[x0 + 1, y0]
        h01 = hf[x0, y0 + 1]
        h11 = hf[x0 + 1, y0 + 1]
        gx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) * inv_h
        gy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) * inv_h
        return gx, gy

    return grad_fn


def flat_height_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plane terrain (mesh_type 'plane', the XBot-L default)."""
    return torch.zeros_like(x)
