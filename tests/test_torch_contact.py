"""The port's contact solvers (`pgs_solve`, `apgd_solve`,
`resolve_contacts`) vs the JAX package on the same numpy inputs, plus the
solver properties the JAX package's tests/test_contact_solvers.py checks
(complementarity, the friction cone, PGS ~ APGD on the robot)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.physics import contact as JC
from humanoid_gym_tpu.physics.dynamics import compute_dynamics as jax_dynamics
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu.terrain.terrain import flat_height_fn as jax_flat
from humanoid_gym_tpu_torch.physics import contact as TC
from humanoid_gym_tpu_torch.physics.dynamics import compute_dynamics as torch_dynamics
from humanoid_gym_tpu_torch.physics.mega import flat_height_fn as torch_flat
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)


def _random_problem(rng, n_points=4, nlim=3):
    """SPD Delassus + random free velocity with some penetrating contacts
    (tests/test_contact_solvers.py:_random_problem), as float32 numpy."""
    nrow = 3 * n_points + nlim
    B = rng.normal(size=(nrow, nrow))
    A = B @ B.T / nrow + 0.5 * np.eye(nrow)
    u0 = rng.normal(size=nrow) * 2.0
    lo = rng.uniform(-0.5, 0.5, n_points)
    sign = np.where(rng.normal(size=nlim) > 0, 1.0, -1.0)
    lb = rng.uniform(-1e9, 0.1, nlim)
    return [np.asarray(x, np.float32) for x in (A, u0, lo, sign, lb)]


def _batched(arrs):
    """One problem as a batch of one, in torch."""
    return [torch.from_numpy(a)[None] for a in arrs]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("solver", ["pgs", "apgd"])
def test_solver_matches_jax(solver, seed):
    """Same problem, same iteration count, with and without a warm start:
    impulses within 2e-4 of the JAX solver (impulses of order 1; the
    iterates differ only by float32 summation order)."""
    rng = np.random.default_rng(seed)
    A, u0, lo, sign, lb = _random_problem(rng)
    lam0 = (rng.normal(size=u0.shape) * 0.3).astype(np.float32)
    mu = np.float32(0.6)
    jfn = {"pgs": JC.pgs_solve, "apgd": JC.apgd_solve}[solver]
    tfn = {"pgs": TC.pgs_solve, "apgd": TC.apgd_solve}[solver]
    tA, tu0, tlo, tsign, tlb = _batched([A, u0, lo, sign, lb])
    for warm in (None, lam0):
        want = jfn(jnp.asarray(A), jnp.asarray(u0), 4, jnp.asarray(lo), jnp.asarray(sign),
                   jnp.asarray(lb), jnp.asarray(mu), 20,
                   lam0=None if warm is None else jnp.asarray(warm))
        got = tfn(tA, tu0, 4, tlo, tsign, tlb, torch.tensor([mu]), 20,
                  lam0=None if warm is None else torch.from_numpy(warm)[None])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frictionless_complementarity(seed):
    """mu=0: a plain LCP; both solvers satisfy complementarity and agree on
    the normal impulses."""
    rng = np.random.default_rng(seed)
    A, u0, lo, sign, lb = _random_problem(rng)
    t = _batched([A, u0, lo, sign, lb])
    mu = torch.zeros(1)
    lam_pgs = TC.pgs_solve(t[0], t[1], 4, t[2], t[3], t[4], mu, iterations=300)[0].numpy()
    lam_apgd = TC.apgd_solve(t[0], t[1], 4, t[2], t[3], t[4], mu, iterations=600)[0].numpy()
    for lam in (lam_pgs, lam_apgd):
        u = A @ lam + u0
        for k in range(4):
            nrm = 3 * k + 2
            assert lam[nrm] >= -1e-6
            assert u[nrm] >= lo[k] - 2e-3
            if lam[nrm] > 1e-3:
                assert u[nrm] <= lo[k] + 2e-2
    idx = np.arange(4) * 3 + 2
    np.testing.assert_allclose(lam_apgd[idx], lam_pgs[idx], rtol=0.05, atol=2e-2)


def test_apgd_friction_cone_respected():
    rng = np.random.default_rng(9)
    A, u0, lo, sign, lb = _random_problem(rng)
    t = _batched([A, u0, lo, sign, lb])
    lam = TC.apgd_solve(t[0], t[1], 4, t[2], t[3], t[4], torch.tensor([0.5]), 300)[0].numpy()
    for k in range(4):
        assert np.linalg.norm(lam[3 * k:3 * k + 2]) <= 0.5 * lam[3 * k + 2] + 1e-5
    assert np.all(lam[12:] * sign >= -1e-6)


@pytest.fixture(scope="module")
def models():
    return jax_model(), torch_model()


def _robot_states(rng, n, z=0.858):
    qpos = np.zeros((n, 19), np.float32)
    qpos[:, 2] = z
    qpos[:, 3] = 1.0
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (n, 12))
    qvel = (rng.normal(size=(n, 18)) * 0.3).astype(np.float32)
    v_free = qvel + (rng.normal(size=(n, 18)) * 0.01).astype(np.float32)
    return qpos, qvel, v_free


def _torch_dyn(tm, qpos, qvel):
    n = qpos.shape[0]
    return torch_dynamics(tm, torch.from_numpy(qpos), torch.from_numpy(qvel), 0.001,
                          torch.full((n, 12), 10.0), torch.ones((n, 13)))


@pytest.mark.parametrize("seed", [0, 1])
def test_frictional_agreement_on_robot(models, seed):
    """On the robot resting / moving on a plane PGS and APGD resolve to
    nearly the same post-contact velocity (0.05) and total normal impulse
    (10 %)."""
    _, tm = models
    qpos, qvel, v_free = _robot_states(np.random.default_rng(seed), 1)
    dyn = _torch_dyn(tm, qpos, qvel)
    mu = torch.tensor([0.7])
    args = (tm, dyn, torch.from_numpy(qpos), torch.from_numpy(v_free), torch_flat, 0.001, mu)
    r_pgs = TC.resolve_contacts(*args, iterations=100, solver="pgs")
    r_apgd = TC.resolve_contacts(*args, iterations=200, solver="apgd")
    np.testing.assert_allclose(r_apgd.qvel_new.numpy(), r_pgs.qvel_new.numpy(), atol=0.05)
    fz_pgs = float(r_pgs.impulses[..., 2].sum())
    fz_apgd = float(r_apgd.impulses[..., 2].sum())
    assert fz_apgd == pytest.approx(fz_pgs, rel=0.1, abs=1e-3)


@pytest.mark.parametrize("solver", ["apgd", "pgs", "apgd_pallas"])
def test_resolve_contacts_matches_jax(models, solver):
    """`resolve_contacts` on 4 robot states against the JAX function under
    vmap, warm-started, with per-env friction, offset, stiffness and
    compliance: qvel_new within 2e-4 (the JAX package's own tolerance for
    its solver paths), lam within 1e-4 N s, gaps within 1e-6 m. On the CPU
    "apgd_pallas" runs the APGD kernel's plain version; its JAX partner is
    "apgd", which the Pallas kernel is held to."""
    jm, tm = models
    rng = np.random.default_rng(3)
    n = 4
    qpos, qvel, v_free = _robot_states(rng, n, z=0.85)
    qpos[:, 2] += (0.02 * rng.normal(size=n)).astype(np.float32)
    mu = rng.uniform(0.4, 1.0, n).astype(np.float32)
    coff = rng.uniform(0.005, 0.02, n).astype(np.float32)
    bmg = (0.2 * rng.uniform(0.7, 1.5, n)).astype(np.float32)
    comp = rng.uniform(0.0, 0.2, n).astype(np.float32)
    lam0 = (np.abs(rng.normal(size=(n, 60))) * 0.02).astype(np.float32)
    iters = 30

    def one(qp, qv, vf, mu_i, co, bm, cp, l0):
        dyn = jax_dynamics(jm, qp, qv, 0.001, jnp.full(12, 10.0), jnp.ones(13))
        r = JC.resolve_contacts(
            jm, dyn, qp, vf, jax_flat, 0.001, mu_i, iterations=iters,
            solver="pgs" if solver == "pgs" else "apgd", contact_offset=co, baumgarte=bm,
            compliance=cp, lam0=l0)
        return r.qvel_new, r.lam, r.phi, r.impulses

    want = jax.jit(jax.vmap(one))(*[jnp.asarray(x) for x in (qpos, qvel, v_free, mu, coff, bmg,
                                                             comp, lam0)])
    f = torch.from_numpy
    got = TC.resolve_contacts(
        tm, _torch_dyn(tm, qpos, qvel), f(qpos), f(v_free), torch_flat, 0.001, f(mu),
        iterations=iters, solver=solver, contact_offset=f(coff), baumgarte=f(bmg),
        compliance=f(comp), lam0=f(lam0))
    np.testing.assert_allclose(got.qvel_new.numpy(), np.asarray(want[0]), atol=2e-4)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want[2]), atol=1e-6)
    np.testing.assert_allclose(got.impulses.numpy(), np.asarray(want[3]), atol=1e-4)
    assert np.abs(np.asarray(want[1])).max() > 1e-3, "no contact impulse: the check would be vacuous"


def test_resolve_contacts_rejects_frames_and_unknown_solver(models):
    _, tm = models
    qpos, qvel, v_free = _robot_states(np.random.default_rng(0), 1)
    dyn = _torch_dyn(tm, qpos, qvel)
    args = (tm, dyn, torch.from_numpy(qpos), torch.from_numpy(v_free), torch_flat, 0.001,
            torch.tensor([0.7]))
    # sloped frames are taken (tests/test_torch_terrain.py); frames that are
    # not one (3, 3) frame per contact point are refused
    with pytest.raises(ValueError, match="frames_override"):
        TC.resolve_contacts(*args, frames_override=torch.zeros((1, 15, 3, 3)))
    with pytest.raises(ValueError, match="unknown contact solver"):
        TC.resolve_contacts(*args, solver="tgs")
