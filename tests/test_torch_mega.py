"""The port's mega-kernel path vs the JAX package.

- The plain solve (`solve.fused_solve_plain`) against the TPU solve stage
  `_fused_core_opt(leg_blocks=True)`, run through
  `pl.pallas_call(..., interpret=True)` as tests/test_fused_core_opt.py
  does.
- The plain mega step (`mega.mega_step_plain`) against the JAX single-env
  fallback `step`, per env, and against the Pallas kernel in interpret
  mode under vmap (slow).
- The Python side of the CUDA kernel that the CPU can check: the
  __constant__ layout against csrc/mega.cu, and the row layouts against
  mega_kernel.py.
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
    step = MG.make_mega_step_batched(tm, 0.001, 10, torch.from_numpy(KP), torch.from_numpy(KD),
                                     tl, iterations=iters)
    return [x.numpy() for x in step(*[torch.from_numpy(a) for a in args])]


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
    """The __constant__ block's offsets in csrc/mega.cu are the running sums
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


def test_cpu_tensors_take_the_plain_path(models):
    """A CPU tensor never reaches the kernel: the launch counters stay."""
    _, tm = models
    before = (MG.mega_kernel_launch.launches, SV.fused_solve.launches)
    _torch_step(tm, tm.dof_effort * 0.85, 2, _states(2, seed=3))
    SV.fused_solve(*[torch.from_numpy(x) for x in _leg_problem(4, n=2)], iterations=2)
    assert (MG.mega_kernel_launch.launches, SV.fused_solve.launches) == before
    with pytest.raises(ValueError):
        MG.mega_kernel_launch(torch.zeros((2, MG.IN_ROWS)), None, 0.001, 10, 8, 1.0)
