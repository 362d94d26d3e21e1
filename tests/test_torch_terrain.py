"""The port's terrain module vs the JAX package: the terrain map from one
config and seed, the three height functions, the sloped contact frames,
the mega kernel's IN2 rows (`terrain_patches`) and the kernel's patch
lookup, at small sizes (2-4 x 2-4 subterrains, a 5 m border). Inputs are
made with numpy from a seed and handed to both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.config.base import TerrainCfg as JaxTerrainCfg
from humanoid_gym_tpu.physics import contact as JC
from humanoid_gym_tpu.physics import mega_kernel as JMK
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu.terrain import terrain as JT
from humanoid_gym_tpu_torch.algo.convert import terrain_map_from_jax
from humanoid_gym_tpu_torch.config.base import TerrainCfg as TorchTerrainCfg
from humanoid_gym_tpu_torch.physics import contact as TC
from humanoid_gym_tpu_torch.physics import mega as MG
from humanoid_gym_tpu_torch.physics.kinematics import fk
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model
from humanoid_gym_tpu_torch.terrain import terrain as TT

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

KP = np.asarray([200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15], np.float32)
KD = np.full(12, 10.0, np.float32)


def _cfg(cls, style, curriculum, froude=1.0, rows=3, cols=4):
    cfg = cls()
    cfg.num_rows, cfg.num_cols = rows, cols
    cfg.border_size = 5.0
    cfg.curriculum = curriculum
    cfg.style = style
    cfg.froude_scale = froude
    if style == "selected":
        cfg.selected = True
        cfg.terrain_kwargs = {"type": "pyramid_stairs_terrain", "step_width": 0.4,
                              "step_height": 0.1, "platform_size": 1.0}
    if style in ("legged", "rubble"):
        cfg.terrain_proportions = [0.1, 0.1, 0.35, 0.25, 0.2] if style == "legged" else [0.3]
    return cfg


@pytest.mark.parametrize("style, curriculum, froude", [
    ("humanoid", True, 1.0), ("humanoid", False, 1.0), ("legged", True, 1.0),
    ("legged", False, 1.0), ("rubble", True, 1.0), ("rubble", False, 1.0),
    ("selected", False, 1.0), ("humanoid", True, 0.5), ("rubble", True, 0.5),
])
def test_terrain_map_matches_jax(style, curriculum, froude):
    """Same config and default_rng(0): the int16 grid and the env origins
    exactly equal, and the scalars carried over."""
    want = JT.TerrainMap.build(_cfg(JaxTerrainCfg, style, curriculum, froude),
                               np.random.default_rng(0))
    got = TT.TerrainMap.build(_cfg(TorchTerrainCfg, style, curriculum, froude),
                              np.random.default_rng(0))
    assert got.height_field.dtype == np.int16
    np.testing.assert_array_equal(got.height_field, want.height_field)
    np.testing.assert_array_equal(got.env_origins, want.env_origins)
    for k in ("horizontal_scale", "vertical_scale", "border_size", "env_length", "env_width",
              "num_rows", "num_cols"):
        assert getattr(got, k) == getattr(want, k), k
    assert np.abs(got.height_field).max() > 0 or (style, curriculum) == ("humanoid", True)


def test_deploy_style_raises():
    """The deploy style refuses an MJCF without an hfield geom (the flat
    XBot-L model) and a field smaller than a terrain patch."""
    from humanoid_gym_tpu_torch import XBOT_MJCF

    cfg = _cfg(TorchTerrainCfg, "deploy", True)
    cfg.deploy_mjcf = XBOT_MJCF
    with pytest.raises(ValueError, match="hfield"):
        TT.TerrainMap.build(cfg, np.random.default_rng(0))
    cfg = _cfg(TorchTerrainCfg, "deploy", True)
    cfg.terrain_length = cfg.terrain_width = 120.0
    cfg.num_rows = cfg.num_cols = 1
    cfg.horizontal_scale = 1.0
    cfg.terrain_proportions = [0.0]
    with pytest.raises(ValueError, match="smaller than the terrain patch"):
        TT.TerrainMap.build(cfg, np.random.default_rng(0))


@pytest.mark.parametrize("mjcf", ["XBOT_TERRAIN_MJCF", "XBOT_S_TERRAIN_MJCF"])
def test_deploy_field_matches_jax(mjcf):
    """The deployment heightfield read from the MJCF and its PNG without
    `mujoco` equals the JAX package's, which MuJoCo's loader reads (heights
    to 1e-6 m, cell sizes exactly), on XBot-L's field and on XBot-S's
    Froude-scaled one."""
    import humanoid_gym_tpu as J
    import humanoid_gym_tpu_torch as T

    assert os.path.basename(getattr(T, mjcf)) == os.path.basename(getattr(J, mjcf))
    h, cx, cy = TT._load_deploy_field(getattr(T, mjcf))
    jh, jcx, jcy = JT._load_deploy_field(getattr(J, mjcf))
    assert h.shape == jh.shape == (100, 100) and (cx, cy) == (jcx, jcy)
    np.testing.assert_allclose(h, jh, atol=1e-6)
    assert 0.2 < h.max() <= 0.35 + 1e-9 and h.min() == 0.0


def _png(img, path):
    """A grayscale PNG of `img` whose row r is written with filter r % 5."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w = img.shape
    x = img.astype(np.int64)
    raw = b""
    for r in range(h):
        a = np.concatenate([[0], x[r, :-1]])
        b = x[r - 1] if r else np.zeros(w, np.int64)
        c = np.concatenate([[0], b[:-1]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [np.zeros(w, np.int64), a, b, (a + b) // 2, paeth][r % 5]
        raw += bytes([r % 5]) + ((x[r] - pred) % 256).astype(np.uint8).tobytes()
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def test_png_reader_undoes_every_row_filter(tmp_path):
    """The shipped field's rows are all unfiltered; a 37 x 23 image written
    with each of the five PNG row filters reads back exactly, and as PIL
    reads it."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (37, 23)).astype(np.uint8)
    _png(img, str(tmp_path / "f.png"))
    got = TT._png_gray8(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(Image.open(str(tmp_path / "f.png"))))


def test_deploy_task_map_matches_jax():
    """`humanoid_ppo_deploy`'s full map (20 x 20 subterrains of 5 x 8 m on
    the rubble ladder, 80% windows of the deployment field): the grid and
    the origins equal the JAX package's TerrainMap from default_rng(0)."""
    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu_torch import registry as treg

    jcfg = jreg.get_task("humanoid_ppo_deploy").make_env_cfg().terrain
    tcfg = treg.get_task("humanoid_ppo_deploy").make_env_cfg().terrain
    assert tcfg.style == "deploy" and (tcfg.num_rows, tcfg.num_cols) == (20, 20)
    want = JT.TerrainMap.build(jcfg, np.random.default_rng(0))
    got = TT.TerrainMap.build(tcfg, np.random.default_rng(0))
    np.testing.assert_array_equal(got.height_field, want.height_field)
    np.testing.assert_array_equal(got.env_origins, want.env_origins)
    assert got.height_field.max() * got.vertical_scale > 0.3


@pytest.fixture(scope="module")
def maps():
    """One reference map with slopes, stairs, obstacles and roughness, and
    its port copy."""
    cfg = _cfg(JaxTerrainCfg, "humanoid", True, rows=4, cols=4)
    cfg.terrain_proportions = [0.1, 0.2, 0.4, 0.6, 0.8, 1.0, 1.0]
    jmap = JT.TerrainMap.build(cfg, np.random.default_rng(0))
    return jmap, terrain_map_from_jax(jmap)


def _points(tmap, n, seed, margin=2.0):
    """n world (x, y) points over the grid and up to `margin` m beyond it."""
    rng = np.random.default_rng(seed)
    nrow, ncol = tmap.height_field.shape
    hs, b = tmap.horizontal_scale, tmap.border_size
    x = rng.uniform(-b - margin, nrow * hs - b + margin, n).astype(np.float32)
    y = rng.uniform(-b - margin, ncol * hs - b + margin, n).astype(np.float32)
    return x, y


def test_height_functions_match_jax(maps):
    """1,000 points, some off the grid: the 3-tap min exactly equal, the
    bilinear height and its gradient within 1e-6 (f32 association order)."""
    jmap, tmap = maps
    x, y = _points(jmap, 1000, seed=1)
    assert ((x < -jmap.border_size) | (y < -jmap.border_size)).any()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_array_equal(TT.make_height_fn(tmap)(tx, ty).numpy(),
                                  np.asarray(JT.make_height_fn(jmap)(jx, jy)))
    np.testing.assert_allclose(TT.make_contact_height_fn(tmap)(tx, ty).numpy(),
                               np.asarray(JT.make_contact_height_fn(jmap)(jx, jy)), atol=1e-6)
    for g, w in zip(TT.make_grad_fn(tmap)(tx, ty), JT.make_grad_fn(jmap)(jx, jy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert float(TT.make_grad_fn(tmap)(tx, ty)[0].abs().max()) > 0.05  # slopes present
    assert float(TT.flat_height_fn(tx, ty).abs().max()) == 0.0


def test_terrain_contact_frames_match_jax():
    """Frames of 1,000 slopes (up to 45 degrees) within 1e-6, orthonormal."""
    rng = np.random.default_rng(2)
    gx, gy = (rng.uniform(-1.0, 1.0, (50, 20)).astype(np.float32) for _ in range(2))
    got = TC.terrain_contact_frames(torch.from_numpy(gx), torch.from_numpy(gy)).numpy()
    want = np.asarray(jax.vmap(JC.terrain_contact_frames)(jnp.asarray(gx), jnp.asarray(gy)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    eye = np.einsum("nkdc,nkec->nkde", got, got)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-6)


def _qpos_over(tmap, n, seed):
    """Standing-pose qpos with the base over random points of the grid."""
    rng = np.random.default_rng(seed)
    x, y = _points(tmap, n, seed, margin=0.0)
    qpos = np.zeros((n, 19), np.float32)
    qpos[:, 0], qpos[:, 1] = x, y
    qpos[:, 2] = 0.9
    yaw = rng.uniform(-np.pi, np.pi, n)
    qpos[:, 3], qpos[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    qpos[:, 7:] = rng.uniform(-0.2, 0.2, (n, 12))
    return qpos


def _contact_xy_by_fk(tm, qpos):
    """The sole contact points' world xy through the generic `fk`."""
    k = fk(tm, qpos)
    idx = list(tm.contact_point_body)
    pos = k.p[:, idx] + torch.einsum("nkij,kj->nki", k.R[:, idx], tm.contact_point_offset)
    return pos[..., :2]


def test_terrain_patches_match_jax(maps):
    """The IN2 rows from direct gathers against the TPU package's windowed
    `terrain_patches`: the taps and the patch origin bit-identical, the
    slope rows (bias added) within 1e-5."""
    jmap, tmap = maps
    jm, tm = jax_model(), torch_model()
    qpos = _qpos_over(jmap, 8, seed=3)
    sbias = np.random.default_rng(4).uniform(-0.1, 0.1, (8, 2)).astype(np.float32)
    tl = np.asarray(jm.dof_effort) * 0.85
    jstep = JMK.make_mega_step_batched(jm, 0.001, 10, KP, KD, tl, iterations=8, terrain_map=jmap)
    want = np.asarray(jax.jit(jstep.terrain_patches)(jnp.asarray(qpos), jnp.asarray(sbias)))
    got = MG.make_terrain_patches(tm, tmap)(torch.from_numpy(qpos), torch.from_numpy(sbias)).numpy()
    assert got.shape == (8, MG.IN2_ROWS) == want.shape
    np.testing.assert_array_equal(got[:, :MG.IN2_GX], want[:, :MG.IN2_GX])
    np.testing.assert_allclose(got[:, MG.IN2_GX:], want[:, MG.IN2_GX:], atol=1e-5)
    assert np.abs(got[:, :MG.IN2_OX]).max() > 0.01  # the patches are not all flat
    for name in ("IN2_PMIN", "IN2_OX", "IN2_OY", "IN2_GX", "IN2_GY", "IN2_ROWS"):
        assert getattr(MG, name) == getattr(JMK, name), name


def test_patch_lookup_equals_contact_height_fn(maps):
    """The kernel's lookup (`make_patch_height_fn`, from one step's IN2
    rows) equals the bilinear grid height within 1e-6 for points inside
    their 3x3 window (grid coordinate u, v relative to the patch origin in
    [0, 1.999]), and clamps to the window edge outside it."""
    jmap, tmap = maps
    tm = torch_model()
    qpos = torch.from_numpy(_qpos_over(jmap, 8, seed=5))
    in2 = MG.make_terrain_patches(tm, tmap)(qpos, torch.zeros((8, 2)))
    terr = MG.terrain_constants(tmap)
    lookup = MG.make_patch_height_fn(in2, terr)
    grid = TT.make_contact_height_fn(tmap)
    border, inv_h = terr[0], terr[1]
    ox, oy = in2[:, MG.IN2_OX:MG.IN2_OY], in2[:, MG.IN2_OY:MG.IN2_GX]
    xy0 = _contact_xy_by_fk(tm, qpos)
    rng = np.random.default_rng(6)
    inside_total = 0
    for _ in range(20):  # moves of up to 1.5 cells: some leave the window
        d = torch.from_numpy(rng.uniform(-0.15, 0.15, (8, 16, 2)).astype(np.float32))
        x, y = xy0[..., 0] + d[..., 0], xy0[..., 1] + d[..., 1]
        u, v = (x + border) * inv_h - ox, (y + border) * inv_h - oy
        inside = (u >= 0) & (u < 1.999) & (v >= 0) & (v < 1.999)
        got, want = lookup(x, y), grid(x, y)
        np.testing.assert_allclose(got[inside].numpy(), want[inside].numpy(), atol=1e-6)
        inside_total += int(inside.sum())
    assert 0 < inside_total < 20 * 8 * 16
    far = lookup(xy0[..., 0] + 5.0, xy0[..., 1])  # 50 cells away: the patch edge
    edge = lookup(xy0[..., 0] + 0.3, xy0[..., 1])
    np.testing.assert_array_equal(far.numpy(), edge.numpy())


def test_leg_chain_contact_xy_matches_fk():
    """`make_contact_xy` (both legs walked together, the joint rotations at
    once, the base added last) against the generic `fk`: the same contact
    points within 1e-6 m near the origin and within 2 ulp of the coordinate
    (2e-5 m) at 100 m, random poses and joint angles."""
    tm = torch_model()
    rng = np.random.default_rng(11)
    q = np.zeros((64, 19), np.float32)
    quat = rng.normal(size=(64, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-1.0, 1.0, (64, 12))
    xy = MG.make_contact_xy(tm)
    for span, tol in ((0.0, 1e-6), (100.0, 2e-5)):
        q[:, :3] = rng.uniform(-span, span, (64, 3))
        t = torch.from_numpy(q)
        np.testing.assert_allclose(xy(t).numpy(), _contact_xy_by_fk(tm, t).numpy(), atol=tol)
