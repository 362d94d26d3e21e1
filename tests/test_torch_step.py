"""The port's per-substep physics path (`make_substep` through
`make_physics_step`, solvers apgd / pgs / apgd_pallas / fused_pallas on
the CPU) vs the JAX package's `make_physics_step` under vmap.

These solvers share the external DOF order, so they follow the JAX
solver's iterates and are compared at the configured 8 iterations, after
one policy step of 10 substeps. "apgd_pallas" and "fused_pallas" run their
kernels' plain versions on the CPU and are compared with the JAX "apgd"
path, which the JAX package holds its two Pallas kernels to
(tests/test_contact_solvers.py:134-212); the kernels' plain versions are
held to the Pallas kernels themselves in tests/test_torch_solvers.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.physics import step as JS
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu.terrain.terrain import flat_height_fn as jax_flat
from humanoid_gym_tpu_torch.algo.convert import physics_state_from_jax
from humanoid_gym_tpu_torch.physics import step as TS
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

KP = np.asarray([200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15], np.float32)
KD = np.full(12, 10.0, np.float32)


@pytest.fixture(scope="module")
def models():
    return jax_model(), torch_model()


def _jax_states(jm, n, seed):
    """n perturbed standing states with DR values and a warm-start lam, as
    one batched JAX PhysicsState, and joint targets."""
    rng = np.random.default_rng(seed)
    st = JS.default_state(jm, jnp.asarray([0.0, 0.0, 0.9]), jnp.asarray([1.0, 0, 0, 0]))
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), st)
    qpos = np.array(st.qpos)
    qpos[:, 2] += rng.uniform(-0.02, 0.02, n)
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (n, 12))
    f = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    st = st.replace(
        qpos=f(qpos), qvel=f(rng.normal(size=(n, 18)) * 0.2),
        friction=f(rng.uniform(0.3, 1.2, n)), base_mass_scale=f(rng.uniform(0.9, 1.1, n)),
        contact_stiffness=f(rng.uniform(0.7, 1.5, n)),
        contact_offset=f(rng.uniform(0.004, 0.025, n)),
        contact_compliance=f(rng.uniform(0.0, 0.2, n)),
        kp_scale=f(rng.uniform(0.8, 1.2, n)), kd_scale=f(rng.uniform(0.8, 1.2, n)),
        contact_lam=f(np.abs(rng.normal(size=(n, 60))) * 0.02),
    )
    return st, rng.uniform(-0.2, 0.2, (n, 12)).astype(np.float32)


@pytest.mark.parametrize("solver, jax_solver", [
    ("apgd", "apgd"), ("pgs", "pgs"), ("apgd_pallas", "apgd"), ("fused_pallas", "apgd"),
])
def test_physics_step_matches_jax(models, solver, jax_solver):
    """One policy step (10 substeps, 8 solver iterations) from 4 shared
    states. Tolerances are the JAX package's own for its solver paths
    (tests/test_contact_solvers.py:203-212): qpos 2e-4, qvel 5e-3, contact
    forces 2 N; torques 5e-2 N m, lam 2e-3 N s (2 N of force at dt)."""
    jm, tm = models
    n = 4
    jst, tgt = _jax_states(jm, n, seed=5)
    jstep = JS.make_physics_step(jm, 0.001, 10, jnp.asarray(KP), jnp.asarray(KD),
                                 jm.dof_effort * 0.85, jax_flat, solver_iterations=8,
                                 solver=jax_solver)
    want = jax.jit(jax.vmap(jstep))(jst, jnp.asarray(tgt))
    tstep = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85,
                                 solver_iterations=8, solver=solver)
    got = tstep(physics_state_from_jax(jst), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos, atol=2e-4)
    np.testing.assert_allclose(got.qvel.numpy(), want.qvel, atol=5e-3)
    np.testing.assert_allclose(got.contact_forces.numpy(), want.contact_forces, atol=2.0)
    np.testing.assert_allclose(got.torques.numpy(), want.torques, atol=5e-2)
    np.testing.assert_allclose(got.contact_lam.numpy(), want.contact_lam, atol=2e-3)
    assert float(np.abs(np.asarray(want.contact_forces)).max()) > 20.0, "no contact force"
    # DR values pass through; fk_out stays zeros off the mega path
    np.testing.assert_array_equal(got.friction.numpy(), np.asarray(want.friction))
    assert float(got.fk_out.abs().max()) == 0.0 and float(np.abs(want.fk_out).max()) == 0.0


def test_substep_fields_match_jax(models):
    """One single substep of the apgd path, field by field, at tighter
    tolerances (no accumulation over the decimation window): qpos 1e-5,
    qvel 2e-4, torques 1e-3, lam 1e-4."""
    jm, tm = models
    jst, tgt = _jax_states(jm, 3, seed=6)
    jsub = JS.make_substep(jm, 0.001, jnp.asarray(KP), jnp.asarray(KD), jm.dof_effort * 0.85,
                           jax_flat, solver_iterations=8, solver="apgd")
    want = jax.jit(jax.vmap(jsub))(jst, jnp.asarray(tgt))
    tsub = TS.make_substep(tm, 0.001, torch.from_numpy(KP), torch.from_numpy(KD),
                           tm.dof_effort * 0.85, solver_iterations=8, solver="apgd")
    got = tsub(physics_state_from_jax(jst), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos, atol=1e-5)
    np.testing.assert_allclose(got.qvel.numpy(), want.qvel, atol=2e-4)
    np.testing.assert_allclose(got.torques.numpy(), want.torques, atol=1e-3)
    np.testing.assert_allclose(got.contact_lam.numpy(), want.contact_lam, atol=1e-4)
    np.testing.assert_allclose(got.contact_forces.numpy(), want.contact_forces, atol=0.1)


def test_standing_equilibrium_apgd(models):
    """Full substep path with APGD: the robot standing at the default pose
    is held by contact forces ~ its weight after 0.3 s, and stays upright."""
    _, tm = models
    step = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85,
                                solver_iterations=24, solver="apgd")
    st = TS.default_state(tm, 2, [0.0, 0.0, 0.95], [1.0, 0.0, 0.0, 0.0])
    for _ in range(30):
        st = step(st, torch.zeros((2, 12)))
    total_fz = st.contact_forces[..., 2].sum(dim=1)
    weight = float(tm.body_mass.sum()) * 9.81
    for fz in total_fz.tolist():
        assert fz == pytest.approx(weight, rel=0.25), (fz, weight)
    assert float(st.qpos[:, 2].min()) > 0.6


@pytest.mark.parametrize("solver", ["apgd_pallas_interpret", "fused_pallas_interpret",
                                    "mega_interpret"])
def test_interpret_spellings_raise(models, solver):
    """The port has no interpret mode: the device of the tensors picks the
    kernel or its plain version."""
    _, tm = models
    with pytest.raises(ValueError, match="no interpret mode"):
        TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85, solver=solver)


def test_unknown_solver_raises(models):
    _, tm = models
    with pytest.raises(ValueError, match="unknown solver"):
        TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85, solver="tgs")
    with pytest.raises(ValueError):
        TS.make_substep(tm, 0.001, KP, KD, tm.dof_effort * 0.85, solver="mega")


def test_physics_state_from_jax_covers_every_field(models):
    jm, _ = models
    jst, _ = _jax_states(jm, 2, seed=7)
    tst = physics_state_from_jax(jst)
    for f in dataclasses.fields(TS.PhysicsState):
        np.testing.assert_array_equal(getattr(tst, f.name).numpy(), np.asarray(getattr(jst, f.name)))
