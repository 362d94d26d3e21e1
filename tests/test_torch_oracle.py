"""MuJoCo oracles against the port's engine: the ports of
tests/test_physics_oracle.py (FK, body velocities, mass matrix, bias
forces, free fall), tests/test_trajectory_oracle.py (the PD hold with
contacts) and tests/test_terrain_contact.py (the incline), at those tests'
cases and tolerances. MuJoCo gets its model from the port's
`physics/mjcf_export.py` `model_to_mjcf` on the port's RobotModel, so it
ground-truths the port's kinematics, dynamics and contact on identical
parameters.

Convention bridge: MuJoCo's free-joint qvel is [v_world, omega_BODY,
qdot]; the engine's is [v_world, omega_WORLD, qdot]. T = blockdiag(I3, R,
I12) maps MuJoCo velocities to the engine's; M_mj = T^T M T, h_mj = T^T h.
The engine runs one env at a time here (batch of 1), in float32."""

import mujoco
import numpy as np
import pytest
import torch

from conftest import random_state
from humanoid_gym_tpu_torch.physics import dynamics as D
from humanoid_gym_tpu_torch.physics import kinematics as K
from humanoid_gym_tpu_torch.physics.mjcf_export import model_to_mjcf
from humanoid_gym_tpu_torch.physics.model import build_xbot_model
from humanoid_gym_tpu_torch.physics.step import default_state, make_physics_step
from humanoid_gym_tpu_torch.terrain.terrain import TerrainMap, make_height_fn

torch.set_num_threads(1)

KP = np.array([200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15], float)
KD = np.full(12, 10.0)
SLOPE = 0.105  # tan(6 deg): a passively standable incline for this robot


@pytest.fixture(scope="module")
def model():
    return build_xbot_model()


@pytest.fixture(scope="module")
def mj_oracle(model):
    return mujoco.MjModel.from_xml_string(model_to_mjcf(model))


def _mk_T(R):
    T = np.eye(18)
    T[3:6, 3:6] = R
    return T


def _quat_mat(quat):
    R = np.zeros(9)
    mujoco.mju_quat2Mat(R, quat)
    return R.reshape(3, 3)


def _set_mj(mj, pos, quat, qj, qvel_eng=None):
    data = mujoco.MjData(mj)
    data.qpos[:3] = pos
    data.qpos[3:7] = quat
    data.qpos[7:] = qj
    if qvel_eng is not None:
        R = _quat_mat(quat)
        data.qvel[:3] = qvel_eng[:3]
        data.qvel[3:6] = R.T @ qvel_eng[3:6]  # world -> body angular
        data.qvel[6:] = qvel_eng[6:]
    mujoco.mj_forward(mj, data)
    return data


def _qpos(pos, quat, qj):
    return torch.as_tensor(np.concatenate([pos, quat, qj])[None], dtype=torch.float32)


def _dyn(model, qpos, qvel):
    k = K.fk(model, qpos)
    mask = K.ancestor_mask(model)
    ms = torch.ones((1, model.nbody))
    return (D.mass_matrix(model, k, mask, ms)[0].double().numpy(),
            D.bias_forces_explicit(model, qpos, qvel, k, mask, ms)[0].double().numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fk_matches_mujoco(model, mj_oracle, seed):
    pos, quat, qj, _ = random_state(np.random.default_rng(seed))
    data = _set_mj(mj_oracle, pos, quat, qj)
    kin = K.fk(model, _qpos(pos, quat, qj))
    for i, name in enumerate(model.body_names):
        bid = mujoco.mj_name2id(mj_oracle, mujoco.mjtObj.mjOBJ_BODY, name)
        np.testing.assert_allclose(kin.p[0, i].numpy(), data.xpos[bid], atol=2e-6)
        np.testing.assert_allclose(kin.R[0, i].numpy(), data.xmat[bid].reshape(3, 3), atol=2e-6)
        np.testing.assert_allclose(kin.com[0, i].numpy(), data.xipos[bid], atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_body_velocities_match_mujoco(model, mj_oracle, seed):
    pos, quat, qj, qvel = random_state(np.random.default_rng(seed))
    data = _set_mj(mj_oracle, pos, quat, qj, qvel)
    bv = K.body_velocities(model, _qpos(pos, quat, qj),
                           torch.as_tensor(qvel[None], dtype=torch.float32))
    for i, name in enumerate(model.body_names):
        bid = mujoco.mj_name2id(mj_oracle, mujoco.mjtObj.mjOBJ_BODY, name)
        # (rot(3), lin(3)) at the body's COM (xipos), world axes
        vel = np.zeros(6)
        mujoco.mj_objectVelocity(mj_oracle, data, mujoco.mjtObj.mjOBJ_BODY.value, bid, vel, 0)
        np.testing.assert_allclose(bv.omega[0, i].numpy(), vel[:3], atol=1e-5)
        np.testing.assert_allclose(bv.v_com[0, i].numpy(), vel[3:], atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mass_matrix_matches_mujoco(model, mj_oracle, seed):
    pos, quat, qj, qvel = random_state(np.random.default_rng(seed))
    data = _set_mj(mj_oracle, pos, quat, qj)
    Mmj = np.zeros((18, 18))
    mujoco.mj_fullM(mj_oracle, data, Mmj)
    M, _ = _dyn(model, _qpos(pos, quat, qj), torch.zeros((1, 18)))
    T = _mk_T(_quat_mat(quat))
    np.testing.assert_allclose(T.T @ M @ T, Mmj, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bias_forces_match_mujoco(model, mj_oracle, seed):
    pos, quat, qj, qvel = random_state(np.random.default_rng(seed))
    data = _set_mj(mj_oracle, pos, quat, qj, qvel)
    _, h = _dyn(model, _qpos(pos, quat, qj), torch.as_tensor(qvel[None], dtype=torch.float32))
    T = _mk_T(_quat_mat(quat))
    np.testing.assert_allclose(T.T @ h, data.qfrc_bias, atol=2e-3, rtol=1e-3)


def test_free_fall_acceleration(model):
    """Contact-free forward dynamics of a free robot: qacc ~= g."""
    qpos = _qpos([0.0, 0.0, 2.0], [1.0, 0, 0, 0], np.zeros(12))
    M, h = _dyn(model, qpos, torch.zeros((1, 18)))
    qacc = np.linalg.solve(M, -h)
    np.testing.assert_allclose(qacc[0:3], [0, 0, -9.81], atol=1e-4)


# ------------------------------------------------- trajectories with contact


def _run_engine(model, n_steps, z0, mu, terrain=None, xy=(0.0, 0.0), decimation=1):
    kw = {} if terrain is None else dict(terrain_height_fn=make_height_fn(terrain),
                                         terrain_map=terrain)
    step = make_physics_step(model, 0.001, decimation, KP, KD, model.dof_effort * 0.85,
                             solver_iterations=16, solver="apgd", **kw)
    st = default_state(model, 1, [xy[0], xy[1], z0], [1.0, 0, 0, 0])
    st = st.replace(friction=torch.full((1,), mu))
    traj = []
    for _ in range(n_steps):
        st = step(st, torch.zeros((1, 12)))
        traj.append(st.qpos[0].double().numpy())
    return np.stack(traj), st


def _run_mujoco(model, n_steps, z0, mu, plane_zaxis=None):
    # kd goes into joint damping so MuJoCo integrates it implicitly, as the
    # engine does (dynamics.py Mtilde); explicit kd via qfrc_applied is
    # unstable on the near-massless ankle bodies at 1 kHz
    mj = mujoco.MjModel.from_xml_string(model_to_mjcf(
        model, with_contacts=True, friction=mu, joint_damping=KD, plane_zaxis=plane_zaxis))
    d = mujoco.MjData(mj)
    d.qpos[2] = z0
    d.qpos[3] = 1.0
    mujoco.mj_forward(mj, d)
    tl = model.dof_effort.double().numpy() * 0.85
    traj = []
    for _ in range(n_steps):
        tau = np.clip(KP * (0.0 - d.qpos[7:]), -tl, tl)
        d.qfrc_applied[6:] = tau
        mujoco.mj_step(mj, d)
        traj.append(d.qpos.copy())
    return np.stack(traj)


def test_pd_hold_trajectory_close(model):
    """0.4 s standing settle from z = 0.95 (tests/test_trajectory_oracle.py:65):
    base height and joint trajectories track MuJoCo within behavioural
    tolerances; neither falls."""
    n = 400
    ours, _ = _run_engine(model, n, 0.95, 0.7)
    theirs = _run_mujoco(model, n, 0.95, 0.7)
    assert ours[-1, 2] > 0.7 and theirs[-1, 2] > 0.7
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], atol=0.04)
    assert np.all(np.abs(ours[:, :2]) < 0.05)
    assert np.all(np.abs(theirs[:, :2]) < 0.05)
    np.testing.assert_allclose(ours[-1, 7:], theirs[-1, 7:], atol=0.08)
    assert ours[-1, 3] > 0.99 and theirs[-1, 3] > 0.99


def _slope_map(slope=SLOPE):
    h_scale, v_scale = 0.1, 0.005
    n = 200  # 20 m x 20 m
    hf = np.zeros((n, n), np.int16)
    xs = np.arange(n) * h_scale
    hf[:] = (slope * xs / v_scale).astype(np.int16)[:, None]
    return TerrainMap(height_field=hf, horizontal_scale=h_scale, vertical_scale=v_scale,
                      border_size=0.0, env_origins=np.zeros((1, 1, 3)), env_length=20.0,
                      env_width=20.0, num_rows=1, num_cols=1)


def test_incline_trajectory_matches_mujoco(model):
    """0.4 s PD hold on the 6-degree incline (tests/test_terrain_contact.py:97):
    slope-relative height and the downhill lean / drift track MuJoCo's
    tilted plane."""
    n, x0 = 400, 10.0
    ours, _ = _run_engine(model, n, SLOPE * x0 + 0.92, 0.7, terrain=_slope_map(), xy=(x0, 10.0))
    ours[:, 0] -= x0
    ours[:, 1] -= 10.0
    ours[:, 2] -= SLOPE * x0
    nrm = np.array([-SLOPE, 0.0, 1.0])
    theirs = _run_mujoco(model, n, 0.92, 0.7, plane_zaxis=nrm / np.linalg.norm(nrm))
    assert ours[-1, 2] > 0.7 and theirs[-1, 2] > 0.7
    assert ours[-1, 0] < -0.005 and theirs[-1, 0] < -0.005
    # different solvers AND a 3-tap-min terraced heightfield vs an exact plane
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], atol=0.045)
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], atol=0.03)
    np.testing.assert_allclose(ours[-1, 7:], theirs[-1, 7:], atol=0.12)


def test_incline_static_support(model):
    """Settled on the incline (tests/test_terrain_contact.py:114), the world
    contact force balances gravity (vertical), while the solver resolved it
    along the tilted normal."""
    _, st = _run_engine(model, 40, SLOPE * 10.0 + 0.92, 1.0, terrain=_slope_map(),
                        xy=(10.0, 10.0), decimation=10)
    f = st.contact_forces[0].sum(dim=0).double().numpy()
    assert f[2] > 300.0, f
    assert abs(f[0]) < 0.3 * f[2], f
