"""The port's mega-kernel path vs the JAX package.

- The plain solve (`solve.fused_solve_plain`) against the TPU solve stage
  `_fused_core_opt(leg_blocks=True)`, run through
  `pl.pallas_call(..., interpret=True)` as tests/test_fused_core_opt.py
  does.
- The plain mega step (`mega.mega_step_plain`) against the JAX single-env
  fallback `step`, per env, and against the Pallas kernel in interpret
  mode under vmap (slow).
- The Python side of the CUDA kernel that the CPU can check: the
  model-constant layout and the shared-memory maps against csrc/mega.cu,
  csrc/solve.cuh, csrc/dense_solve.cu and csrc/apgd.cuh, and the row layouts
  against mega_kernel.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from humanoid_gym_tpu.physics import mega_kernel as JMK
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu.physics.pallas_solver import ENV_TILE, NV, NVP, ROWS, _fused_core_opt
from humanoid_gym_tpu_torch.physics import mega as MG
from humanoid_gym_tpu_torch.physics import solve as SV
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

KP = np.asarray([200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15], np.float32)
KD = np.full(12, 10.0, np.float32)
OUT_NAMES = ("qpos", "qvel", "lam", "tau", "ff", "fk14")


def _leg_problem(seed, n=ENV_TILE):
    """Leg-structured solve operands in the solver-internal order [L 0:6,
    R 6:12, base 12:18], env-major: cross-leg M blocks zero, each leg's J
    rows supported on its own contact and limit rows."""
    rng = np.random.default_rng(seed)
    Mt = np.zeros((n, NV, NV), np.float32)
    for e in range(n):
        W = rng.normal(size=(NV, NV)) * 0.3
        M = W @ W.T + np.eye(NV) * 2.0
        M[0:6, 6:12] = 0.0
        M[6:12, 0:6] = 0.0
        Mt[e] = M
    Jt = np.zeros((n, NV, 60), np.float32)
    Jt[:, 12:18, :] = rng.normal(size=(n, 6, 60)) * 0.5  # base: dense
    Jt[:, 0:6, 0:24] = rng.normal(size=(n, 6, 24)) * 0.5  # leg L
    Jt[:, 0:6, 48:54] = rng.normal(size=(n, 6, 6)) * 0.5
    Jt[:, 6:12, 24:48] = rng.normal(size=(n, 6, 24)) * 0.5  # leg R
    Jt[:, 6:12, 54:60] = rng.normal(size=(n, 6, 6)) * 0.5
    qvel = (rng.normal(size=(n, NV)) * 0.3).astype(np.float32)
    rhs = (rng.normal(size=(n, NV)) * 0.05).astype(np.float32)
    target = (rng.normal(size=(n, 60)) * 0.1).astype(np.float32)
    sign = np.ones((n, 60), np.float32)
    sign[:, 48:60] = np.sign(rng.normal(size=(n, 12))).astype(np.float32)
    mu = rng.uniform(0.3, 1.2, n).astype(np.float32)
    comp = rng.uniform(0.0, 0.2, n).astype(np.float32)
    lam0 = (rng.normal(size=(n, 60)) * 0.05).astype(np.float32)
    return Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0


@jax.jit
def _pallas_opt_lanes(Mt, Jt, qvel, rhs, target, sign, mu, valid, comp, lam0, iters):
    """The TPU solve stage in interpret mode on one 128-lane tile; the
    iteration count is traced, so every case shares one compile."""

    def kern(Mt_r, Jt_r, qv, rh, tg, sg, mu_r, vd, cp, l0, it, o1, o2, L_s):
        qn, lam = _fused_core_opt(
            L_s, Mt_r[...], Jt_r[...], qv[...], rh[...], tg[...], sg[...], mu_r[...], vd[...],
            it[0], compliance=cp[...][0], lam0=l0[...], leg_blocks=True,
        )
        o1[...] = qn
        o2[...] = lam

    return pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((NVP, ENV_TILE), jnp.float32),
                   jax.ShapeDtypeStruct((ROWS, ENV_TILE), jnp.float32)],
        interpret=True,
        scratch_shapes=[pltpu.VMEM((NVP, NVP, ENV_TILE), jnp.float32)],
    )(Mt, Jt, qvel, rhs, target, sign, mu, valid, comp, lam0, iters)


def _pallas_opt(Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, iters):
    """Env-major operands -> padded env-lane-major tiles -> the TPU solve."""
    def lanes(x, rows):
        x = np.moveaxis(x, 0, -1)
        pad = [(0, r - s) for r, s in zip(rows, x.shape[:-1])] + [(0, 0)]
        return np.pad(x, pad)

    Mt_l = lanes(Mt, (NVP, NVP))
    for k in range(NV, NVP):
        Mt_l[k, k, :] = 1.0
    sign_l = np.ones((ROWS, ENV_TILE), np.float32)
    sign_l[:60] = np.moveaxis(sign, 0, -1)
    valid = np.zeros((ROWS, ENV_TILE), np.float32)
    valid[:60] = 1.0
    q, lam = _pallas_opt_lanes(
        Mt_l, lanes(Jt, (NVP, ROWS)), lanes(qvel, (NVP,)), lanes(rhs, (NVP,)),
        lanes(target, (ROWS,)), sign_l, mu[None], valid, comp[None], lanes(lam0, (ROWS,)),
        np.asarray([iters], np.int32),
    )
    return np.moveaxis(np.asarray(q), -1, 0)[:, :NV], np.moveaxis(np.asarray(lam), -1, 0)[:, :60]


@pytest.mark.parametrize("iters, tol_q, tol_lam", [(8, 1e-5, 1e-4), (60, 2e-4, 2e-3)])
def test_plain_solve_matches_pallas_opt_core(iters, tol_q, tol_lam):
    """Same algorithm and DOF order: agreement to f32 association order,
    which grows with the iteration count. At the main path's 8 iterations
    qvel within 1e-5 (velocities ~0.3) and lam within 1e-4 (impulses ~1);
    at 60, the tolerances tests/test_fused_core_opt.py holds the TPU solve
    stages to (qvel 2e-4, lam 2e-3)."""
    ops = _leg_problem(seed=iters)
    q_ref, l_ref = _pallas_opt(*ops, iters)
    q, lam = SV.fused_solve(*[torch.from_numpy(x) for x in ops], iterations=iters)
    np.testing.assert_allclose(q.numpy(), q_ref, atol=tol_q)
    np.testing.assert_allclose(lam.numpy(), l_ref, atol=tol_lam)


@pytest.fixture(scope="module")
def models():
    return jax_model(), torch_model()


def _states(n, seed):
    """Perturbed standing states with DR values, drawn as
    tests/test_mega_kernel.py:_states draws them."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((n, 19), np.float32)
    qpos[:, 2] = 0.9 + rng.uniform(-0.02, 0.02, n)
    qpos[:, 3] = 1.0
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (n, 12))
    qvel = (rng.normal(size=(n, 18)) * 0.2).astype(np.float32)
    dr = [rng.uniform(a, b, n).astype(np.float32) for a, b in (
        (0.3, 1.2), (0.9, 1.1), (0.7, 1.5), (0.004, 0.025), (0.8, 1.2), (0.8, 1.2), (0.0, 0.2))]
    lam0 = (np.abs(rng.normal(size=(n, 60))) * 0.02).astype(np.float32)
    tgt = rng.uniform(-0.2, 0.2, (n, 12)).astype(np.float32)
    return [qpos, qvel, *dr, lam0, tgt]


def _torch_step(tm, tl, iters, args):
    """The port's batched step on the 11 per-env arrays of `_states` (the
    slope bias, read only on terrain, is zeros)."""
    step = MG.make_mega_step_batched(tm, 0.001, 10, torch.from_numpy(KP), torch.from_numpy(KD),
                                     tl, iterations=iters)
    t = [torch.from_numpy(a) for a in args]
    return [x.numpy() for x in step(*t[:10], torch.zeros((t[0].shape[0], 2)), t[10])]


def test_plain_mega_matches_jax_fallback(models):
    """Plain mega step vs the JAX single-env fallback `step` (un-vmapped),
    per env, one policy step. Both solve to convergence (200 APGD
    iterations): the fallback factors in the external DOF order and the
    kernel (and its plain version) in [L, R, base], and the APGD step
    bound depends on that order, so the two agree at convergence. Tolerances:
    qpos 2e-4, qvel 5e-3, tau 5e-2, lam / ff 5 N of force (5e-3 N s),
    fk14 2e-4 on positions and 5e-3 on velocities."""
    jm, tm = models
    n, iters = 4, 200
    args = _states(n, seed=0)
    tl = np.asarray(jm.dof_effort) * 0.85
    got = _torch_step(tm, tm.dof_effort * 0.85, iters, args)
    jstep = jax.jit(JMK.make_mega_step_batched(jm, 0.001, 10, KP, KD, tl, iterations=iters))
    tols = {"qpos": 2e-4, "qvel": 5e-3, "lam": 5e-3, "tau": 5e-2, "ff": 5e-3}
    for e in range(n):
        want = jstep(*[jnp.asarray(a[e]) for a in args[:10]], jnp.zeros(2), jnp.asarray(args[10][e]))
        for k, name in enumerate(OUT_NAMES[:5]):
            np.testing.assert_allclose(got[k][e], want[k], atol=tols[name], err_msg=name)
        np.testing.assert_allclose(got[5][e][:10], want[5][:10], atol=2e-4, err_msg="fk14 pos")
        np.testing.assert_allclose(got[5][e][10:], want[5][10:], atol=5e-3, err_msg="fk14 vel")
    assert np.abs(got[4]).max() > 1e-3, "no contact impulse: the check would be vacuous"


def test_plain_mega_with_s_constants_matches_jax_fallback():
    """The plain mega step of the XBot-S model (its own constants: the
    scaled masses, inertias, joint origins, efforts and contact points, kp
    x s^4, kd x s^4.5) vs the JAX fallback `step` of the same model, per
    env, one policy step from states at S's standing height, both solved to
    convergence (200 APGD iterations, the DOF-order condition of
    test_plain_mega_matches_jax_fallback) and held to its tolerances."""
    from humanoid_gym_tpu.config.xbots import XBotSCfg as JaxSCfg

    cfg = JaxSCfg()
    jm = jax_model(cfg.asset.file, mesh_dir=cfg.asset.mesh_dir)
    tm = torch_model(cfg.asset.file, mesh_dir=cfg.asset.mesh_dir)
    np.testing.assert_allclose(tm.body_mass.numpy(), np.asarray(jm.body_mass), rtol=1e-6)
    s = 1.2 / 1.65
    kp, kd = KP * np.float32(s**4), KD * np.float32(s**4.5)
    n, iters = 4, 200
    args = _states(n, seed=0)
    args[0][:, 2] *= s
    tl = np.asarray(jm.dof_effort) * 0.85
    step = MG.make_mega_step_batched(tm, 0.001, 10, torch.from_numpy(kp), torch.from_numpy(kd),
                                     tm.dof_effort * 0.85, iterations=iters)
    t = [torch.from_numpy(a) for a in args]
    got = [x.numpy() for x in step(*t[:10], torch.zeros((n, 2)), t[10])]
    jstep = jax.jit(JMK.make_mega_step_batched(jm, 0.001, 10, kp, kd, tl, iterations=iters))
    tols = {"qpos": 2e-4, "qvel": 5e-3, "lam": 5e-3, "tau": 5e-2, "ff": 5e-3}
    for e in range(n):
        want = jstep(*[jnp.asarray(a[e]) for a in args[:10]], jnp.zeros(2), jnp.asarray(args[10][e]))
        for k, name in enumerate(OUT_NAMES[:5]):
            np.testing.assert_allclose(got[k][e], want[k], atol=tols[name], err_msg=name)
        np.testing.assert_allclose(got[5][e][:10], want[5][:10], atol=2e-4, err_msg="fk14 pos")
        np.testing.assert_allclose(got[5][e][10:], want[5][10:], atol=5e-3, err_msg="fk14 vel")
    assert np.abs(got[4]).max() > 1e-3, "no contact impulse: the check would be vacuous"
    consts_l = MG.pack_model_constants(torch_model(), KP, KD, torch_model().dof_effort * 0.85)
    assert np.abs(step.consts - consts_l).max() > 1.0  # its own constants, not XBot-L's
    assert step.consts_dev is None  # a CPU model keeps no device copy


@pytest.mark.slow
def test_plain_mega_matches_pallas_kernel_interpret(models):
    """Plain mega step vs the TPU mega kernel (interpret mode, under vmap)
    at the main path's 8 iterations: the same DOF order, so the
    association-order tolerances qpos 2e-4, qvel 5e-3, tau 5e-2, lam / ff
    5e-3, fk14 2e-4 / 5e-3 hold without solving to convergence."""
    jm, tm = models
    n, iters = 4, 8
    args = _states(n, seed=1)
    tl = np.asarray(jm.dof_effort) * 0.85
    got = _torch_step(tm, tm.dof_effort * 0.85, iters, args)
    jstep = JMK.make_mega_step_batched(jm, 0.001, 10, KP, KD, tl, iterations=iters, interpret=True)
    want = jax.jit(jax.vmap(jstep))(*[jnp.asarray(a) for a in args[:10]], jnp.zeros((n, 2)),
                                    jnp.asarray(args[10]))
    tols = {"qpos": 2e-4, "qvel": 5e-3, "lam": 5e-3, "tau": 5e-2, "ff": 5e-3}
    for k, name in enumerate(OUT_NAMES[:5]):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tols[name], err_msg=name)
    np.testing.assert_allclose(got[5][:, :10], np.asarray(want[5])[:, :10], atol=2e-4)
    np.testing.assert_allclose(got[5][:, 10:], np.asarray(want[5])[:, 10:], atol=5e-3)



@pytest.fixture(scope="module")
def terrain_maps():
    """A small reference map (4 x 4 subterrains: slopes up and down,
    stairs, obstacles, roughness; 5 m border) and its port copy."""
    from humanoid_gym_tpu.config.base import TerrainCfg
    from humanoid_gym_tpu.terrain.terrain import TerrainMap
    from humanoid_gym_tpu_torch.algo.convert import terrain_map_from_jax

    cfg = TerrainCfg()
    cfg.num_rows, cfg.num_cols, cfg.border_size = 4, 4, 5.0
    cfg.terrain_proportions = [0.0, 0.1, 0.3, 0.6, 0.9, 1.0, 1.0]
    jmap = TerrainMap.build(cfg, np.random.default_rng(0))
    return jmap, terrain_map_from_jax(jmap)


def _terrain_args(jmap, n, seed):
    """`_states` with the base over random points of the map's sloped rows
    (levels 1-3: slopes, stairs, obstacles, roughness), 0.87 m (+-0.02)
    above the bilinear ground there, and a slope bias of up to 0.05: the 11
    per-env arrays and the (n, 2) bias."""
    from humanoid_gym_tpu.terrain.terrain import make_contact_height_fn

    args = _states(n, seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.uniform(jmap.env_length, 4 * jmap.env_length, n).astype(np.float32)
    y = rng.uniform(0.5, 4 * jmap.env_width - 0.5, n).astype(np.float32)
    qpos = args[0]
    qpos[:, 0], qpos[:, 1] = x, y
    qpos[:, 2] += np.asarray(make_contact_height_fn(jmap)(jnp.asarray(x), jnp.asarray(y))) - 0.03
    return args, rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)


def _torch_terrain_step(tm, tmap, iters, args, sbias):
    step = MG.make_mega_step_batched(tm, 0.001, 10, torch.from_numpy(KP), torch.from_numpy(KD),
                                     tm.dof_effort * 0.85, iterations=iters, terrain_map=tmap)
    t = [torch.from_numpy(a) for a in args]
    return [x.numpy() for x in step(*t[:10], torch.from_numpy(sbias), t[10])]


def test_plain_terrain_mega_matches_jax_fallback(models, terrain_maps):
    """The plain terrain mega step (the kernel's patch lookup and frames
    from the IN2 rows) vs the JAX single-env fallback `step` with the
    terrain map (the grid's bilinear height, frames from the step-start
    gradient), per env, on envs over slopes, stairs and roughness, both
    solved to convergence (200 iterations, the Queue C rule). The
    tolerances of `test_plain_mega_matches_jax_fallback`."""
    jm, tm = models
    jmap, tmap = terrain_maps
    n, iters = 4, 200
    args, sbias = _terrain_args(jmap, n, seed=9)
    got = _torch_terrain_step(tm, tmap, iters, args, sbias)
    tl = np.asarray(jm.dof_effort) * 0.85
    jstep = jax.jit(JMK.make_mega_step_batched(jm, 0.001, 10, KP, KD, tl, iterations=iters,
                                               terrain_map=jmap))
    tols = {"qpos": 2e-4, "qvel": 5e-3, "lam": 5e-3, "tau": 5e-2, "ff": 5e-3}
    for e in range(n):
        want = jstep(*[jnp.asarray(a[e]) for a in args[:10]], jnp.asarray(sbias[e]),
                     jnp.asarray(args[10][e]))
        for k, name in enumerate(OUT_NAMES[:5]):
            np.testing.assert_allclose(got[k][e], want[k], atol=tols[name], err_msg=name)
        np.testing.assert_allclose(got[5][e][:10], want[5][:10], atol=2e-4, err_msg="fk14 pos")
        np.testing.assert_allclose(got[5][e][10:], want[5][10:], atol=5e-3, err_msg="fk14 vel")
    ff = got[4].reshape(n, 2, 3)
    assert np.abs(ff[..., 2]).max() > 1e-2, "no contact impulse: the check would be vacuous"
    assert np.abs(ff[..., :2]).max() > 1e-3, "no tangential world impulse: frames untested"


@pytest.mark.slow
def test_plain_terrain_mega_matches_pallas_kernel_interpret(models, terrain_maps):
    """The plain terrain mega step vs the TPU kernel built with the terrain
    (interpret mode, under vmap) at the main path's 8 iterations, on the
    same IN2 rows in both: the tolerances of the flat interpret check."""
    jm, tm = models
    jmap, tmap = terrain_maps
    n, iters = 4, 8
    args, sbias = _terrain_args(jmap, n, seed=10)
    got = _torch_terrain_step(tm, tmap, iters, args, sbias)
    tl = np.asarray(jm.dof_effort) * 0.85
    jstep = JMK.make_mega_step_batched(jm, 0.001, 10, KP, KD, tl, iterations=iters, interpret=True,
                                       terrain_map=jmap)
    want = jax.jit(jax.vmap(jstep))(*[jnp.asarray(a) for a in args[:10]], jnp.asarray(sbias),
                                    jnp.asarray(args[10]))
    tols = {"qpos": 2e-4, "qvel": 5e-3, "lam": 5e-3, "tau": 5e-2, "ff": 5e-3}
    for k, name in enumerate(OUT_NAMES[:5]):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tols[name], err_msg=name)
    np.testing.assert_allclose(got[5][:, :10], np.asarray(want[5])[:, :10], atol=2e-4)
    np.testing.assert_allclose(got[5][:, 10:], np.asarray(want[5])[:, 10:], atol=5e-3)
    assert np.abs(got[4]).max() > 1e-2

def test_row_layouts_match_tpu_kernel():
    for name in ("IN_QPOS", "IN_QVEL", "IN_TGT", "IN_FRIC", "IN_MS", "IN_CSTIFF", "IN_COFF",
                 "IN_KPS", "IN_KDS", "IN_COMP", "IN_LAM", "IN_ROWS", "OUT_QPOS", "OUT_QVEL",
                 "OUT_LAM", "OUT_TAU", "OUT_FF", "OUT_FK", "OUT_ROWS"):
        assert getattr(MG, name) == getattr(JMK, name), name


def test_pack_and_unpack_roundtrip(models):
    _, tm = models
    args = _states(3, seed=2)
    t = [torch.from_numpy(a) for a in args]
    packed = MG.pack_inputs(*t)
    assert packed.shape == (3, MG.IN_ROWS) and packed.is_contiguous()
    np.testing.assert_array_equal(packed[:, MG.IN_LAM:MG.IN_LAM + 60].numpy(), args[9])
    np.testing.assert_array_equal(packed[:, MG.IN_TGT:MG.IN_TGT + 12].numpy(), args[10])
    np.testing.assert_array_equal(packed[:, MG.IN_COMP].numpy(), args[8])
    out = torch.arange(3 * MG.OUT_ROWS, dtype=torch.float32).reshape(3, MG.OUT_ROWS)
    sizes = [x.shape[1] for x in MG.unpack_outputs(out)]
    assert sizes == [19, 18, 60, 12, 6, 14]


def test_const_layout_matches_cuda_source(models):
    """The constant block's offsets in csrc/mega.cu are the running sums
    of CONST_LAYOUT, and the packed block carries the model's values."""
    _, tm = models
    src = open(os.path.join(os.path.dirname(MG.__file__), "..", "csrc", "mega.cu")).read()
    defs = dict(re.findall(r"#define (C_[A-Z]+) (\d+)", src))
    off = 0
    for name, size in MG.CONST_LAYOUT:
        assert int(defs["C_" + name.upper()]) == off, name
        off += size
    assert int(defs["C_TOTAL"]) == off == MG.CONST_COUNT
    consts = MG.pack_model_constants(tm, KP, KD, tm.dof_effort * 0.85)
    assert consts.shape == (MG.CONST_COUNT,) and consts.dtype == np.float32
    np.testing.assert_array_equal(consts[:13], tm.body_mass.numpy())
    parent = consts[int(defs["C_PARENT"]):int(defs["C_PARENT"]) + 13]
    assert tuple(int(p) for p in parent) == tm.body_parent


def _defines(*names):
    """Integer #defines of the named csrc files."""
    csrc = os.path.join(os.path.dirname(MG.__file__), "..", "csrc")
    out = {}
    for name in names:
        src = open(os.path.join(csrc, name)).read()
        out.update({k: int(v) for k, v in re.findall(r"#define (\w+) +(\d+)\b", src)})
    return out


def test_shared_memory_map_matches_cuda_source():
    """The row widths and problem sizes the wrappers pass are the #defines
    of the sources (the launch shape and the shared-memory map live only
    there); the per-warp regions of that map do not overlap, stay 16-byte
    aligned, and the blocks fit the card's 227 KB at the residency the
    source note reckons with (32 warps per SM)."""
    d = _defines("mega.cu", "solve.cuh", "apgd.cuh")
    assert (d["HGT_NV"], d["HGT_NP"], d["HGT_NR"]) == (SV.NV, SV.N_POINTS, SV.ROWS)
    assert (d["IN_ROWS"], d["OUT_ROWS"]) == (MG.IN_ROWS, MG.OUT_ROWS)
    # the solve's scratch: M/L, 1/diag, t, x in order, t and x on 16-byte bounds
    assert d["HGT_LS"] % 2 == 1
    assert d["HGT_SM_M"] + SV.NV * d["HGT_LS"] <= d["HGT_SM_DINV"]
    assert d["HGT_SM_DINV"] + SV.NV <= d["HGT_SM_T"] and d["HGT_SM_T"] + 20 <= d["HGT_SM_X"]
    assert d["HGT_SM_X"] + 64 == d["HGT_SOLVE_FLOATS"]
    assert d["HGT_SM_T"] % 4 == 0 and d["HGT_SM_X"] % 4 == 0
    assert SV.NV * d["HGT_LS"] <= d["HGT_GRAM_FLOATS"]
    assert d["SV_WARP_FLOATS"] == d["HGT_SOLVE_FLOATS"] + d["HGT_GRAM_FLOATS"]
    # the mega kernel's regions, in the order of the map, none overlapping
    sizes = [("MG_S", MG.IN_ROWS), ("MG_SOLVE", d["HGT_SOLVE_FLOATS"]), ("MG_TAU", 12),
             ("MG_QN", 18), ("MG_SC", 24), ("MG_ALOC", 36), ("MG_RLOC", 108), ("MG_R", 117),
             ("MG_P", 39), ("MG_AXW", 36), ("MG_OM", 39), ("MG_VO", 39), ("MG_AL", 39),
             ("MG_AO", 39), ("MG_CSS", 13 * d["CS"]), ("MG_SW", 54), ("MG_SVL", 54)]
    end = 0
    for name, size in sizes:
        assert d[name] >= end, name
        end = d[name] + size
    assert end <= d["MG_WARP_FLOATS"] and d["MG_WARP_FLOATS"] % 4 == 0
    assert d["MG_SOLVE"] % 4 == 0 and d["MG_HEAD_FLOATS"] % 4 == 0
    assert d["MG_R"] + d["HGT_GRAM_FLOATS"] <= d["MG_AO"] + 39  # Gram scratch over dead kinematics
    assert MG.OUT_ROWS <= 13 * d["CS"]  # the output row is staged over the composites
    assert 4 * d["MG_HEAD_FLOATS"] >= 4 * 544 + 2 * d["HGT_NPAIR"] and MG.CONST_COUNT <= 544
    assert 4 * d["SV_HEAD_FLOATS"] >= 2 * d["HGT_NPAIR"]
    # the pair table: lower-triangle entries outside the cross-leg block
    pairs = [(i, a) for i in range(SV.NV) for a in range(i + 1) if not (a < 6 <= i < 12)]
    assert len(pairs) == d["HGT_NPAIR"]
    # the terrain variant's region after the flat map: the IN2 row as it
    # comes (taps, ox, oy; gx, gy at IN2_GX), then the frames over gx, gy
    for name in ("IN2_PMIN", "IN2_OX", "IN2_OY", "IN2_GX", "IN2_GY", "IN2_ROWS"):
        assert d[name] == getattr(MG, name), name
    assert d["MG_T"] >= d["MG_WARP_FLOATS"] and d["MG_T"] % 4 == 0
    assert d["MG_T_FR"] == MG.IN2_GX and d["MG_T_FR"] + 5 * SV.N_POINTS <= d["MG_T_FLOATS"]
    assert MG.IN2_ROWS <= d["MG_T_FLOATS"]
    assert d["MG_WARP_FLOATS_T"] == d["MG_T"] + d["MG_T_FLOATS"] and d["MG_WARP_FLOATS_T"] % 4 == 0
    # residency: 32 warps per SM within 227 KB (1 KB reserved per block),
    # for the flat and the terrain variant
    solve_bytes = 4 * (d["SV_HEAD_FLOATS"] + d["SV_WARPS"] * d["SV_WARP_FLOATS"])
    assert d["MG_MIN_BLOCKS"] * d["MG_WARPS"] == 32
    for per_warp in ("MG_WARP_FLOATS", "MG_WARP_FLOATS_T"):
        mega_bytes = 4 * (d["MG_HEAD_FLOATS"] + d["MG_WARPS"] * d[per_warp])
        assert d["MG_MIN_BLOCKS"] * (mega_bytes + 1024) <= 232448, per_warp
    assert (32 // d["SV_WARPS"]) * (solve_bytes + 1024) <= 232448


def _check_regions(d, regions, total):
    """Regions (name, floats) in map order: none overlaps the one before,
    each starts on a 16-byte boundary, all end inside `total`."""
    end = 0
    for name, size in regions:
        assert d[name] >= end and d[name] % 4 == 0, name
        end = d[name] + size
    assert end <= d[total] and d[total] % 4 == 0


def test_dense_shared_memory_map_matches_cuda_source():
    """csrc/dense_solve.cu and csrc/apgd.cuh: the compile-time problem shape
    is the one the wrappers insist on; the per-warp regions of both kernels
    do not overlap; every stage and every vector read 16 bytes at a time
    starts on a 16-byte boundary; an env's matrix is a whole number of
    16-byte units (the bulk copy's rule); the blocks fit the card's 227 KB at
    the residency the source note states (12 warps per SM, 168 registers)."""
    d = _defines("dense_solve.cu", "apgd.cuh")
    nv, rows, pts = SV.NV, SV.ROWS, SV.N_POINTS
    assert (d["HGT_NV"], d["HGT_NR"], d["HGT_NP"], d["HGT_MAX_ROWS"]) == (nv, rows, pts, SV.MAX_ROWS)
    assert d["HGT_NC"] == 3 * pts and d["HGT_NC"] >= 32  # rows 0..31 are contact rows: sign 1
    assert rows <= SV.MAX_ROWS == 64  # two rows per lane
    # the bulk copy: one env's matrix, 16-byte units, every env on a 16-byte boundary
    assert d["DS_A_FLOATS"] == rows * rows and (4 * rows * rows) % 16 == 0
    # hgt_apgd_kernel
    _check_regions(d, [("AP_SM_STAGE", rows * rows), ("AP_SM_Y", SV.MAX_ROWS),
                       ("AP_SM_X", SV.MAX_ROWS), ("AP_SM_S", SV.MAX_ROWS)], "AP_WARP_FLOATS")
    assert d["AP_HEAD_FLOATS"] % 4 == 0 and 4 * d["AP_HEAD_FLOATS"] >= 8 * d["DS_WARPS"]
    assert (4 * rows) % 16 == 0  # every row of the raw stage starts on a 16-byte boundary
    for first in range(0, rows - 7):  # a quarter-warp on 8 successive rows covers all 32 banks
        banks = {(r * rows + k) % 32 for r in range(first, first + 8) for k in range(4)}
        assert len(banks) == 32
    # hgt_fused_dense_kernel
    _check_regions(d, [("FD_SM_B", rows * d["FD_BS"]), ("FD_SM_L", nv * d["HGT_LS"]),
                       ("FD_SM_DINV", nv), ("FD_SM_T", 20), ("FD_SM_Y", SV.MAX_ROWS),
                       ("FD_SM_X", SV.MAX_ROWS)], "FD_WARP_FLOATS")
    assert d["FD_BS"] >= nv and d["FD_BS"] % 4 == 0 and d["HGT_LS"] % 2 == 1
    assert nv * d["HGT_LS"] <= d["FD_SM_L"] - d["FD_SM_B"]  # Gram scratch inside the B region
    for first in range(0, rows - 7):  # 8 successive columns of B, 16 bytes each: all 32 banks
        banks = {(r * d["FD_BS"] + k) % 32 for r in range(first, first + 8) for k in range(4)}
        assert len(banks) == 32
    assert (4 * nv) % 8 == 0  # rows of Mtilde and of J are read 8 bytes at a time
    # residency
    warps = d["DS_MIN_BLOCKS"] * d["DS_WARPS"]
    assert warps == 12 and 65536 // (warps * 32) >= 168
    for head, per_warp in ((d["AP_HEAD_FLOATS"], "AP_WARP_FLOATS"), (0, "FD_WARP_FLOATS")):
        block = 4 * (head + d["DS_WARPS"] * d[per_warp])
        assert d["DS_MIN_BLOCKS"] * (block + 1024) <= 232448


def test_cpu_tensors_take_the_plain_path(models):
    """A CPU tensor never reaches the kernel: the launch counters stay."""
    _, tm = models
    before = (MG.mega_kernel_launch.launches, SV.fused_solve.launches)
    _torch_step(tm, tm.dof_effort * 0.85, 2, _states(2, seed=3))
    SV.fused_solve(*[torch.from_numpy(x) for x in _leg_problem(4, n=2)], iterations=2)
    assert (MG.mega_kernel_launch.launches, SV.fused_solve.launches) == before
    with pytest.raises(ValueError):
        MG.mega_kernel_launch(torch.zeros((2, MG.IN_ROWS)), None, 0.001, 10, 8, 1.0)
    consts = MG.model_constants_tensor(MG.pack_model_constants(tm, KP, KD, tm.dof_effort), "cpu")
    assert consts.dtype == torch.float32 and tuple(consts.shape) == (MG.CONST_COUNT,)
    with pytest.raises(ValueError, match="CUDA"):
        MG.mega_kernel_launch(torch.zeros((2, MG.IN_ROWS)), consts, 0.001, 10, 8, 1.0)


def test_mega_fk_out_matches_fk(models):
    """The port of tests/test_mega_kernel.py:251: the plain mega step's
    end-of-step OUT_FK rows (feet p and knee xy base-relative; feet
    v_origin in the world frame) equal `fk` / `body_velocities` at the
    state it returns, which they replace in the env (atol 2e-4, 4 envs, 3
    policy steps, 24 iterations). The kernel's rows are held to the same
    functions on the card (chip_smoke.py phase 4)."""
    from humanoid_gym_tpu_torch.physics.kinematics import body_velocities, fk

    _, tm = models
    n = 4
    args = _states(n, seed=3)
    args[-1] = np.random.default_rng(4).uniform(-0.2, 0.2, (n, 12)).astype(np.float32)
    for _ in range(3):
        qpos, qvel, lam, _, _, fk14 = _torch_step(tm, tm.dof_effort * 0.85, 24, args)
        args = [qpos, qvel, *args[2:9], lam, args[10]]
    qp, qv = torch.from_numpy(qpos), torch.from_numpy(qvel)
    k = fk(tm, qp)
    bv = body_velocities(tm, qp, qv, k)
    f, kn = list(tm.feet_body_idx), list(tm.knee_body_idx)
    p_rel = k.p - qp[:, None, :3]
    want = torch.cat([p_rel[:, f, 0], p_rel[:, f, 1], p_rel[:, f, 2], p_rel[:, kn, 0],
                      p_rel[:, kn, 1], bv.v_origin[:, f, 0], bv.v_origin[:, f, 1]], dim=1)
    np.testing.assert_allclose(fk14, want.numpy(), atol=2e-4)
