"""PyTorch port vs the JAX package: kinematics, dynamics, contact rows and
the APGD solve on `conftest.random_state` draws. The port runs a batch; the
reference runs each env alone. Tolerances are float32-scale: ~1e-5 on
unit-size quantities, relative 1e-5 on forces (h carries ~300 N of
gravity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_state
from humanoid_gym_tpu.physics import contact as JC
from humanoid_gym_tpu.physics import dynamics as JD
from humanoid_gym_tpu.physics import kinematics as JK
from humanoid_gym_tpu.physics import linalg as JL
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu.terrain.terrain import flat_height_fn as jax_flat
from humanoid_gym_tpu_torch.physics import contact as TC
from humanoid_gym_tpu_torch.physics import dynamics as TD
from humanoid_gym_tpu_torch.physics import kinematics as TK
from humanoid_gym_tpu_torch.physics import linalg as TL
from humanoid_gym_tpu_torch.physics.mega import flat_height_fn as torch_flat
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

N = 6
DT = 0.001


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    qpos, qvel = [], []
    for _ in range(N):
        pos, quat, qj, qv = random_state(rng)
        qpos.append(np.concatenate([pos, quat, qj]))
        qvel.append(qv)
    qpos = np.asarray(qpos, np.float32)
    qvel = np.asarray(qvel, np.float32)
    tm = torch_model()
    # lift each env so its lowest sole point sits within +-1 cm of the
    # ground: some contact rows live, some inactive
    k = TK.fk(tm, torch.from_numpy(qpos))
    cb = list(tm.contact_point_body)
    z = (k.p[:, cb] + torch.einsum("nkij,kj->nki", k.R[:, cb], tm.contact_point_offset))[..., 2]
    qpos[:, 2] += -z.min(dim=1).values.numpy() + rng.uniform(-0.01, 0.01, N).astype(np.float32)
    ms = np.ones((N, 13), np.float32)
    ms[:, 0] = rng.uniform(0.9, 1.1, N)
    damp = rng.uniform(5.0, 15.0, (N, 12)).astype(np.float32)
    return jax_model(), tm, qpos, qvel, ms, damp, rng


def _per_env(fn, *arrays):
    fn = jax.jit(fn)
    return [fn(*[jnp.asarray(a[e]) for a in arrays]) for e in range(N)]


def test_fk_matches(setup):
    jm, tm, qpos, *_ = setup
    got = TK.fk(tm, torch.from_numpy(qpos))
    for e, want in enumerate(_per_env(lambda q: JK.fk(jm, q), qpos)):
        for name in ("R", "p", "com", "axis_w", "pivot_w"):
            np.testing.assert_allclose(getattr(got, name)[e].numpy(), getattr(want, name),
                                       atol=1e-5, err_msg=name)


def test_body_velocities_match(setup):
    jm, tm, qpos, qvel, *_ = setup
    got = TK.body_velocities(tm, torch.from_numpy(qpos), torch.from_numpy(qvel))
    wants = _per_env(lambda q, v: JK.body_velocities(jm, q, v), qpos, qvel)
    for e, want in enumerate(wants):
        for name in ("omega", "v_origin", "v_com"):
            np.testing.assert_allclose(getattr(got, name)[e].numpy(), getattr(want, name),
                                       atol=1e-5, err_msg=name)


def test_mass_matrix_and_bias_match(setup):
    jm, tm, qpos, qvel, ms, *_ = setup
    qp, qv = torch.from_numpy(qpos), torch.from_numpy(qvel)
    k = TK.fk(tm, qp)
    mask = TK.ancestor_mask(tm)
    M = TD.mass_matrix(tm, k, mask, torch.from_numpy(ms))
    h = TD.bias_forces_explicit(tm, qp, qv, k, mask, torch.from_numpy(ms))
    jmask = JK.ancestor_mask(jm)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))

    def ref(q, v, s):
        kj = JK.fk(jm, q)
        return JD.mass_matrix(jm, kj, jmask, s), JD.bias_forces_explicit(jm, q, v, kj, jmask, s)

    for e, (Mj, hj) in enumerate(_per_env(ref, qpos, qvel, ms)):
        np.testing.assert_allclose(M[e].numpy(), Mj, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h[e].numpy(), hj, atol=1e-4, rtol=1e-5)


def test_compute_dynamics_matches(setup):
    jm, tm, qpos, qvel, ms, damp, _ = setup
    got = TD.compute_dynamics(tm, torch.from_numpy(qpos), torch.from_numpy(qvel), DT,
                              torch.from_numpy(damp), torch.from_numpy(ms))
    wants = _per_env(lambda q, v, d, s: JD.compute_dynamics(jm, q, v, DT, d, s), qpos, qvel, damp, ms)
    for e, want in enumerate(wants):
        np.testing.assert_allclose(got.M[e].numpy(), want.M, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.Mtilde_chol[e].numpy(), want.Mtilde_chol, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.h[e].numpy(), want.h, atol=1e-4, rtol=1e-5)


def test_linalg_matches(setup):
    *_, rng = setup
    W = rng.normal(size=(N, 18, 18)).astype(np.float32)
    A = W @ np.swapaxes(W, 1, 2) + 2.0 * np.eye(18, dtype=np.float32)
    b = rng.normal(size=(N, 18, 5)).astype(np.float32)
    L = TL.chol_unrolled(torch.from_numpy(A))
    x = TL.solve_spd_chol(L, torch.from_numpy(b))
    ref = lambda a, bb: (JL.chol_unrolled(a), JL.solve_spd_chol(JL.chol_unrolled(a), bb))  # noqa: E731
    for e, (Lj, xj) in enumerate(_per_env(ref, A, b)):
        np.testing.assert_allclose(L[e].numpy(), Lj, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(x[e].numpy(), xj, atol=1e-4, rtol=1e-4)


def test_contact_setup_and_limits_match(setup):
    jm, tm, qpos, qvel, ms, damp, rng = setup
    coff = rng.uniform(0.004, 0.025, N).astype(np.float32)
    bmg = rng.uniform(0.14, 0.3, N).astype(np.float32)
    dyn = TD.compute_dynamics(tm, torch.from_numpy(qpos), torch.from_numpy(qvel), DT,
                              torch.from_numpy(damp), torch.from_numpy(ms))
    got = TC.build_contact_setup(tm, dyn, torch_flat, DT, contact_offset=torch.from_numpy(coff),
                                 baumgarte=torch.from_numpy(bmg))
    sign, lb = TC.joint_limit_bounds(tm, torch.from_numpy(qpos), DT)

    def ref(q, v, d, s, c, b):
        dj = JD.compute_dynamics(jm, q, v, DT, d, s)
        return JC.build_contact_setup(jm, dj, jax_flat, DT, contact_offset=c, baumgarte=b)

    wants = _per_env(ref, qpos, qvel, damp, ms, coff, bmg)
    for e, want in enumerate(wants):
        np.testing.assert_allclose(got.J[e].numpy(), want.J, atol=1e-5)
        np.testing.assert_allclose(got.phi[e].numpy(), want.phi, atol=1e-5)
        np.testing.assert_allclose(got.pos_w[e].numpy(), want.pos_w, atol=1e-5)
        # bounds are gaps / dt: 1e-5 m of gap is 1e-2 m/s of bound
        np.testing.assert_allclose(got.lo_bound[e].numpy(), want.lo_bound, atol=1e-2, rtol=1e-5)
        sj, lbj = JC.joint_limit_bounds(jm, jnp.asarray(qpos[e]), DT)
        np.testing.assert_array_equal(sign[e].numpy(), np.asarray(sj))
        np.testing.assert_allclose(lb[e].numpy(), lbj, atol=1e-3, rtol=1e-5)
    assert (got.lo_bound > -1e8).any() and (got.lo_bound < -1e8).any()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_apgd_solve_matches(setup, warm):
    """APGD on the same SPD Delassus, bounds and warm start; 12 iterations."""
    *_, rng = setup
    nrow = 60
    B = rng.normal(size=(N, 18, nrow)).astype(np.float32) * 0.3
    A = np.swapaxes(B, 1, 2) @ B + 0.01 * np.eye(nrow, dtype=np.float32)
    u0 = rng.normal(size=(N, nrow)).astype(np.float32)
    lo = rng.normal(size=(N, 16)).astype(np.float32) * 0.2
    sign = np.where(rng.uniform(size=(N, 12)) < 0.5, 1.0, -1.0).astype(np.float32)
    lb = rng.normal(size=(N, 12)).astype(np.float32) * 0.1
    mu = rng.uniform(0.3, 1.2, N).astype(np.float32)
    lam0 = rng.normal(size=(N, nrow)).astype(np.float32) if warm else None
    step = np.max(np.sum(np.abs(B @ np.swapaxes(B, 1, 2)), axis=-1), axis=-1).astype(np.float32)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = TC.apgd_solve(t(A), t(u0), 16, t(lo), t(sign), t(lb), t(mu), 12,
                        step_bound=t(step), lam0=t(lam0))
    solve = jax.jit(lambda a, u, lo_, s, b, m, st, l0: JC.apgd_solve(
        a, u, 16, lo_, s, b, m, 12, step_bound=st, lam0=l0))
    for e in range(N):
        want = solve(A[e], u0[e], lo[e], sign[e], lb[e], mu[e], step[e],
                     None if lam0 is None else lam0[e])
        np.testing.assert_allclose(got[e].numpy(), want, atol=1e-5, rtol=1e-4)
    proj = TC._project_cone(t(u0), 16, t(mu), t(sign))
    for e in range(N):
        np.testing.assert_allclose(
            proj[e].numpy(),
            JC._project_cone(jnp.asarray(u0[e]), 16, jnp.asarray(mu[e]), jnp.asarray(sign[e])),
            atol=1e-6,
        )
