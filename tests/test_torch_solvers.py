"""The plain versions of the two dense solver kernels vs the JAX package.

`apgd_solve_kernel_plain` (the APGD kernel) and `fused_dense_solve_plain`
(the fused Cholesky + Delassus + APGD kernel) against
- the Pallas kernels they replace, `apgd_solve_pallas` and
  `fused_solve_pallas`, run in interpret mode on the CPU, and
- the JAX package's plain paths: `apgd_solve` with the shared step bound,
  and the single-env fallback of `make_fused_batched`,
on operands built from real XBot-L contact states (one numpy draw, fed to
both packages), at 8 and 50 iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.physics import pallas_solver as PS
from humanoid_gym_tpu.physics.contact import apgd_solve as jax_apgd_solve
from humanoid_gym_tpu_torch.physics import solve as SV
from humanoid_gym_tpu_torch.physics import step as ST
from humanoid_gym_tpu_torch.physics.contact import delassus_operands
from humanoid_gym_tpu_torch.physics.dynamics import solve_mtilde
from humanoid_gym_tpu_torch.physics.mega import flat_height_fn
from humanoid_gym_tpu_torch.physics.model import build_xbot_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

N = 6
KP = torch.tensor([200, 200, 350, 350, 15, 15] * 2, dtype=torch.float32)
KD = torch.full((12,), 10.0)


@pytest.fixture(scope="module")
def operands():
    """Both kernels' operands at N robot states one policy step into
    contact (so lam0 is a real warm start), with per-env DR values."""
    model = build_xbot_model()
    rng = np.random.default_rng(11)
    st = ST.default_state(model, N, [0.0, 0.0, 0.9], [1.0, 0.0, 0.0, 0.0])
    qpos = st.qpos.numpy().copy()
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (N, 12))
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    st = st.replace(
        qpos=f(qpos), qvel=f(rng.normal(size=(N, 18)) * 0.2),
        friction=f(rng.uniform(0.3, 1.2, N)), contact_stiffness=f(rng.uniform(0.7, 1.5, N)),
        contact_offset=f(rng.uniform(0.004, 0.025, N)),
        contact_compliance=f(rng.uniform(0.0, 0.2, N)),
    )
    tgt = f(rng.uniform(-0.2, 0.2, (N, 12)))
    tl = model.dof_effort * 0.85
    st = ST.make_physics_step(model, 0.001, 10, KP, KD, tl, 8, solver="apgd")(st, tgt)
    # push two joints past their limits so limit rows of both signs are live
    qpos = st.qpos.clone()
    qpos[0, 7 + 3] = model.dof_upper[3] + 0.01
    qpos[1, 7 + 9] = model.dof_lower[9] - 0.01
    st = st.replace(qpos=qpos)
    _, _, fused = ST.fused_operands(model, 0.001, st, tgt, KP, KD, tl)
    _, dyn, _, rhs = ST.substep_dynamics(model, 0.001, st, tgt, KP, KD, tl)
    v_free = st.qvel + solve_mtilde(dyn.Mtilde_chol, rhs)
    setup, sign, lb, _, A, u0, step_bound = delassus_operands(
        model, dyn, st.qpos, v_free, flat_height_fn, 0.001, contact_offset=st.contact_offset,
        baumgarte=0.2 * st.contact_stiffness, compliance=st.contact_compliance)
    apgd = (A, u0, setup.lo_bound, sign, lb, st.friction, step_bound, st.contact_lam)
    assert float(st.contact_lam.abs().max()) > 0.05, "no contact: the checks would be vacuous"
    assert float(lb.max()) > 0.0, "no violated joint limit"
    return fused, apgd


def _j(ts):
    return [None if t is None else jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("iters", [8, 50])
@pytest.mark.parametrize("bound", ["shared", "default"])
def test_apgd_plain_matches_pallas_kernel(operands, iters, bound):
    """`apgd_solve_kernel_plain` vs `apgd_solve_pallas(interpret=True)`,
    with the shared step bound and with the default ||A||_inf: lam within
    1e-4 N s (impulses of order 0.1 - 0.5 N s)."""
    _, apgd = operands
    apgd = list(apgd)
    if bound == "default":
        apgd[6] = None
    want = PS.apgd_solve_pallas(*_j(apgd), iterations=iters, interpret=True)
    got = SV.apgd_solve_kernel(*apgd, iterations=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("iters", [8, 50])
def test_apgd_plain_matches_jax_apgd_solve(operands, iters):
    """... and vs the JAX package's plain `apgd_solve` (unfolded signs,
    `_project_cone`) under vmap with the shared step bound: lam 1e-4."""
    _, apgd = operands
    A, u0, lo, sign, lb, mu, sb, lam0 = _j(apgd)
    want = jax.vmap(
        lambda a, u, l, s, b, m, t, w: jax_apgd_solve(a, u, 16, l, s, b, m, iters,
                                                      step_bound=t, lam0=w)
    )(A, u0, lo, sign, lb, mu, sb, lam0)
    got = SV.apgd_solve_kernel_plain(*apgd, iterations=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_apgd_cold_start_is_zero_warm_start(operands):
    _, apgd = operands
    cold = SV.apgd_solve_kernel_plain(*apgd[:7], None, iterations=8)
    zero = SV.apgd_solve_kernel_plain(*apgd[:7], torch.zeros_like(apgd[1]), iterations=8)
    np.testing.assert_array_equal(cold.numpy(), zero.numpy())


@pytest.mark.parametrize("iters", [8, 50])
def test_fused_dense_plain_matches_pallas_kernel(operands, iters):
    """`fused_dense_solve_plain` vs `fused_solve_pallas(interpret=True)`:
    qvel_new within 2e-4, lam within 1e-4 N s."""
    fused, _ = operands
    q_want, l_want = PS.fused_solve_pallas(*_j(fused), iterations=iters, interpret=True)
    q, lam = SV.fused_dense_solve(*fused, iterations=iters)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_want), atol=2e-4)
    np.testing.assert_allclose(lam.numpy(), np.asarray(l_want), atol=1e-4)


@pytest.mark.parametrize("iters", [8, 50])
def test_fused_dense_plain_matches_jax_fallback(operands, iters):
    """... and vs the single-env fallback of `make_fused_batched`
    (pallas_solver.py:867-887), called un-vmapped per env: qvel_new 2e-4,
    lam 1e-4."""
    fused, _ = operands
    solve = jax.jit(PS.make_fused_batched(iters))
    q, lam = SV.fused_dense_solve_plain(*fused, iterations=iters)
    ops = _j(fused)
    for e in range(N):
        q_want, l_want = solve(*[o[e] for o in ops])
        np.testing.assert_allclose(q[e].numpy(), np.asarray(q_want), atol=2e-4)
        np.testing.assert_allclose(lam[e].numpy(), np.asarray(l_want), atol=1e-4)


def test_fused_dense_equals_apgd_path(operands):
    """The fused solve is the `apgd` path's chain in one call: on the same
    state both plain versions give the same impulses (1e-5) at 8
    iterations, which is what makes "fused_pallas" iterate-for-iterate
    equal to "apgd"."""
    fused, apgd = operands
    _, lam_f = SV.fused_dense_solve_plain(*fused, iterations=8)
    lam_a = SV.apgd_solve_kernel_plain(*apgd, iterations=8)
    np.testing.assert_allclose(lam_f.numpy(), lam_a.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_versions(operands):
    fused, apgd = operands
    before = (SV.apgd_solve_kernel.launches, SV.fused_dense_solve.launches)
    SV.apgd_solve_kernel(*apgd, iterations=2)
    SV.fused_dense_solve(*fused, iterations=2)
    assert (SV.apgd_solve_kernel.launches, SV.fused_dense_solve.launches) == before


def test_minus_1e9_bounds_stay_finite(operands):
    """Inactive rows carry -1e9 bounds; r = u0 - target must stay finite in
    float32 and the rows' impulses zero."""
    fused, apgd = operands
    lam = SV.apgd_solve_kernel_plain(*apgd, iterations=8)
    q, lam_f = SV.fused_dense_solve_plain(*fused, iterations=8)
    assert torch.isfinite(lam).all() and torch.isfinite(q).all() and torch.isfinite(lam_f).all()
    inactive = apgd[4] == -1e9
    assert inactive.any()
    assert float(lam[:, 48:][inactive].abs().max()) == 0.0
