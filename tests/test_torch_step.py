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


# ------------------------------------------------------------------ terrain


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


def _terrain_states(jm, jmap, n, seed):
    """`_jax_states` moved over the map: the base over random points of the
    sloped rows (levels 1-3), 0.87 m (+-0.02) above the bilinear ground
    there, so that the soles start 0-5 cm from it, and a contact-slope bias
    of up to 0.05."""
    from humanoid_gym_tpu.terrain.terrain import make_contact_height_fn

    st, tgt = _jax_states(jm, n, seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.uniform(jmap.env_length, 4 * jmap.env_length, n).astype(np.float32)
    y = rng.uniform(0.5, 4 * jmap.env_width - 0.5, n).astype(np.float32)
    ground = np.asarray(make_contact_height_fn(jmap)(jnp.asarray(x), jnp.asarray(y)))
    qpos = np.array(st.qpos)
    qpos[:, 0], qpos[:, 1] = x, y
    qpos[:, 2] += ground - 0.03
    sb = rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    return st.replace(qpos=jnp.asarray(qpos), slope_bias=jnp.asarray(sb)), tgt


@pytest.mark.parametrize("solver, jax_solver", [
    ("apgd", "apgd"), ("pgs", "pgs"), ("apgd_pallas", "apgd"), ("fused_pallas", "apgd"),
])
def test_terrain_physics_step_matches_jax(models, terrain_maps, solver, jax_solver):
    """One policy step on the heightfield: contacts on the bilinear surface
    with the sloped frames frozen at the step start (gradient + slope
    bias), in every substep solver. Same tolerances as the flat case:
    qpos 2e-4, qvel 5e-3, world-frame contact forces 2 N, torques 5e-2,
    lam (frame components) 2e-3."""
    from humanoid_gym_tpu.terrain.terrain import make_height_fn as jax_height
    from humanoid_gym_tpu_torch.terrain.terrain import make_height_fn as torch_height

    jm, tm = models
    jmap, tmap = terrain_maps
    n = 4
    jst, tgt = _terrain_states(jm, jmap, n, seed=8)
    jstep = JS.make_physics_step(jm, 0.001, 10, jnp.asarray(KP), jnp.asarray(KD),
                                 jm.dof_effort * 0.85, jax_height(jmap), solver_iterations=8,
                                 solver=jax_solver, terrain_map=jmap)
    want = jax.jit(jax.vmap(jstep))(jst, jnp.asarray(tgt))
    tstep = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85,
                                 solver_iterations=8, solver=solver,
                                 terrain_height_fn=torch_height(tmap), terrain_map=tmap)
    got = tstep(physics_state_from_jax(jst), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos, atol=2e-4)
    np.testing.assert_allclose(got.qvel.numpy(), want.qvel, atol=5e-3)
    np.testing.assert_allclose(got.contact_forces.numpy(), want.contact_forces, atol=2.0)
    np.testing.assert_allclose(got.torques.numpy(), want.torques, atol=5e-2)
    np.testing.assert_allclose(got.contact_lam.numpy(), want.contact_lam, atol=2e-3)
    forces = np.asarray(want.contact_forces)
    assert np.abs(forces[..., 2]).max() > 20.0, "no contact force"
    assert np.abs(forces[..., :2]).max() > 1.0, "no tangential world force: frames untested"


def test_terrain_frames_differ_from_flat(models, terrain_maps):
    """The frames matter: the same states solved with identity frames on the
    same bilinear ground move differently (so the comparison above cannot
    pass on flat frames)."""
    from humanoid_gym_tpu_torch.terrain.terrain import make_contact_height_fn, make_height_fn

    jm, tm = models
    jmap, tmap = terrain_maps
    jst, tgt = _terrain_states(jm, jmap, 4, seed=8)
    tst = physics_state_from_jax(jst)
    sloped = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85, solver="apgd",
                                  terrain_height_fn=make_height_fn(tmap), terrain_map=tmap)
    level = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85, solver="apgd",
                                 terrain_height_fn=make_contact_height_fn(tmap))
    a, b = sloped(tst, torch.from_numpy(tgt)), level(tst, torch.from_numpy(tgt))
    assert float((a.qvel - b.qvel).abs().max()) > 1e-2


# --------------------------------------------- goldens of the JAX package
# (tests/test_contact_solvers.py:270, 310), on the port's engine alone


def test_contact_compliance_softens(models):
    """CFM compliance: positive compliance reduces contact impulses and lets
    the robot settle lower (soft contact); both still carry it."""
    _, tm = models
    step = TS.make_physics_step(tm, 0.001, 10, KP, KD, tm.dof_effort * 0.85,
                                solver_iterations=24, solver="apgd")
    st0 = TS.default_state(tm, 1, [0.0, 0.0, 0.93], [1.0, 0, 0, 0])

    def settle(comp):
        s = st0.replace(contact_compliance=torch.full((1,), comp))
        for _ in range(40):
            s = step(s, torch.zeros((1, 12)))
        return s

    rigid, soft = settle(0.0), settle(0.5)
    fz_r = float(rigid.contact_forces[0, :, 2].sum())
    fz_s = float(soft.contact_forces[0, :, 2].sum())
    assert fz_r > 300.0 and fz_s > 200.0
    pen_r, pen_s = float(rigid.qpos[0, 2]), float(soft.qpos[0, 2])
    assert pen_s < pen_r  # compliant envs settle measurably lower
    assert pen_r - pen_s > 1e-4


def test_warm_start_accuracy(models):
    """The APGD warm start (contact_lam, carried across substeps and policy
    steps) beats the cold start: at equal iterations the warm solve is
    strictly more accurate against a converged (200-iteration) solve, and
    warm@8 and warm@4 beat cold@16 (the basis of the 8-iteration default)."""
    _, tm = models
    tl = tm.dof_effort * 0.85

    def mk(iters):
        return TS.make_physics_step(tm, 0.001, 10, KP, KD, tl, solver_iterations=iters,
                                    solver="apgd")

    rng = np.random.default_rng(0)
    n = 8
    s = TS.default_state(tm, n, [0.0, 0.0, 0.95], [1.0, 0, 0, 0])
    qpos = s.qpos.clone()
    qpos[:, 7:] = torch.as_tensor(rng.uniform(-0.1, 0.1, (n, 12)), dtype=torch.float32)
    s = s.replace(qpos=qpos)
    # settle into a dynamic contact-rich state with a converged solver
    ref = mk(200)
    for i in range(20):
        s = ref(s, float(0.3 * np.sin(0.05 * i)) * torch.ones((n, 12)))
    tgt = float(0.3 * np.sin(0.05 * 20)) * torch.ones((n, 12))
    gold = ref(s, tgt)

    s_cold = s.replace(contact_lam=torch.zeros_like(s.contact_lam))

    def err(out):
        return float((out.qvel - gold.qvel).abs().max())

    warm4, warm8 = err(mk(4)(s, tgt)), err(mk(8)(s, tgt))
    cold8, cold16 = err(mk(8)(s_cold, tgt)), err(mk(16)(s_cold, tgt))
    assert warm8 < cold8, (warm8, cold8)
    assert warm8 < cold16, (warm8, cold16)
    assert warm4 < cold16, (warm4, cold16)
