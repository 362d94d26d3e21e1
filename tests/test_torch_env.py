"""The port's flat-ground XBot-L env vs the JAX package: observation
layouts, every reward term on shared inputs, and batched env steps from one
shared state.

The step comparison uses a config with noise, pushes, action delay and
action noise off, and states where no reset and no command resample fall
in the compared steps, so neither package draws a random number that
matters. Both packages solve contact to convergence there (200 APGD
iterations): the JAX env's `apgd` path factors in the external DOF order
and the port's mega path in the kernel's [L, R, base] order, and the APGD
step bound depends on that order (see test_torch_mega.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.config.xbotl import XBotLCfg as JaxCfg
from humanoid_gym_tpu.envs import make_env as jax_make_env
from humanoid_gym_tpu.envs import rewards as JR
from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg as TorchCfg
from humanoid_gym_tpu_torch.envs import make_env as torch_make_env
from humanoid_gym_tpu_torch.envs import rewards as TR

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)


def _quiet(cfg, n, iters):
    cfg.env.num_envs = n
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.action_delay = 0.0
    cfg.domain_rand.action_noise = 0.0
    cfg.sim.solver.solver_iterations = iters
    return cfg


# ------------------------------------------------------------------ layouts


@pytest.fixture(scope="module")
def torch_rollout():
    cfg = _quiet(TorchCfg(), 2, 8)
    cfg.sim.solver.solver_type = "mega"
    env = torch_make_env(cfg, device="cpu", seed=0)
    state = env.init_state()
    actions = 0.1 * torch.ones((2, 12))
    trs = []
    for _ in range(3):
        state, tr = env.step(state, actions)
        trs.append(tr)
    return env, cfg, state, trs


def test_obs_layout(torch_rollout):
    """Actor obs frame: [cmd_input(5), q(12), dq(12), actions(12),
    ang_vel(3), euler(3)] stacked x15, newest last."""
    env, cfg, state, trs = torch_rollout
    obs = trs[-1].obs.numpy().reshape(2, 15, 47)
    newest = obs[:, -1]
    phase = state.episode_length.numpy().astype(np.float64) * env.dt / cfg.rewards.cycle_time
    np.testing.assert_allclose(newest[:, 0], np.sin(2 * np.pi * phase), atol=1e-5)
    np.testing.assert_allclose(newest[:, 1], np.cos(2 * np.pi * phase), atol=1e-5)
    cmd = state.commands.numpy()
    np.testing.assert_allclose(newest[:, 2:5], cmd[:, :3] * [2.0, 2.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(newest[:, 5:17], state.phys.qpos[:, 7:].numpy(), atol=1e-5)
    np.testing.assert_allclose(newest[:, 17:29], state.phys.qvel[:, 6:].numpy() * 0.05, atol=1e-5)
    np.testing.assert_allclose(newest[:, 29:41], state.actions.numpy(), atol=1e-5)
    np.testing.assert_allclose(newest[:, 41:44], state.base_ang_vel.numpy(), atol=1e-5)
    np.testing.assert_allclose(newest[:, 44:47], state.base_euler.numpy(), atol=1e-5)
    assert np.all(obs[:, :12] == 0) and np.any(obs[:, 12] != 0)


def test_privileged_obs_layout(torch_rollout):
    """Critic frame (73): [cmd(5), q(12), dq(12), actions(12), q - ref(12),
    lin_vel*2(3), ang_vel(3), euler(3), push force xy(2), push torque(3),
    friction(1), base mass/30(1), stance(2), contact(2)] stacked x3."""
    env, cfg, state, trs = torch_rollout
    priv = trs[-1].privileged_obs.numpy().reshape(2, 3, 73)
    f = priv[:, -1]
    np.testing.assert_allclose(f[:, 41:53], (state.phys.qpos[:, 7:] - state.ref_dof_pos).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(f[:, 53:56], state.base_lin_vel.numpy() * 2.0, atol=1e-5)
    np.testing.assert_allclose(f[:, 62:64], state.rand_push_force[:, :2].numpy(), atol=1e-6)
    np.testing.assert_allclose(f[:, 67], state.env_friction.numpy(), atol=1e-6)
    mass = env.model.body_mass[0].item() * state.phys.base_mass_scale.numpy() / 30.0
    np.testing.assert_allclose(f[:, 68], mass, rtol=1e-6)
    assert set(np.unique(f[:, 69:73])) <= {0.0, 1.0}
    assert np.isfinite(priv).all()


# ------------------------------------------------------------------ rewards


def _reward_ctx(n=6, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa: E731
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (n,) + s).astype(np.float32)  # noqa: E731
    b = lambda *s: rng.uniform(size=(n,) + s) < 0.5  # noqa: E731
    cmd = u(-0.6, 0.6, 4)
    cmd[0, 0] = 0.05  # |command| below the low_speed gate
    lin = f(3) * 0.4
    lin[1, 0] = 0.2 * cmd[1, 0]  # too slow
    lin[2, 0] = 2.0 * cmd[2, 0]  # too fast
    lin[3, 0] = cmd[3, 0]  # desired
    lin[4, 0] = -cmd[4, 0]  # sign mismatch
    return dict(
        dof_pos=f(12) * 0.2, dof_vel=f(12), last_dof_vel=f(12), actions=f(12),
        last_actions=f(12), last_last_actions=f(12), torques=f(12) * 30,
        base_lin_vel=lin, base_ang_vel=f(3) * 0.3, base_euler=f(3) * 0.1,
        projected_gravity=f(3) * 0.1, commands=cmd, root_z=u(0.8, 1.0),
        root_vel=f(6), last_root_vel=f(6), feet_z=u(0.03, 0.12, 2),
        feet_vel_xy=f(2, 2) * 0.3, feet_pos_xy=f(2, 2) * 0.3, knee_pos_xy=f(2, 2) * 0.2,
        feet_contact_force=np.abs(f(2, 3)) * 500, contact=b(2),
        stance_mask=rng.choice([0.0, 1.0], size=(n, 2)).astype(np.float32),
        ref_dof_pos=f(12) * 0.2, collision_flags=b(1), feet_air_time=u(0.0, 0.6, 2),
        last_contacts=b(2), feet_height=u(0.0, 0.1, 2), last_feet_z=u(0.0, 0.1, 2),
    )


_STATIC = dict(dt=0.01, cycle_time=0.64, target_joint_pos_scale=0.17, target_feet_height=0.06,
               base_height_target=0.89, min_dist=0.2, max_dist=0.5, tracking_sigma=5.0,
               max_contact_force=700.0, sole_offset=0.05)


def _eval_both(fn_j, fn_t):
    dyn = _reward_ctx()
    dpos = np.linspace(-0.05, 0.05, 12).astype(np.float32)
    tctx = TR.RewardCtx(default_dof_pos=torch.from_numpy(dpos), **_STATIC,
                        **{k: torch.from_numpy(np.asarray(v)) for k, v in dyn.items()})
    got = fn_t(tctx)

    def one(d):
        return fn_j(JR.RewardCtx(default_dof_pos=jnp.asarray(dpos), **_STATIC, **d))

    want = jax.vmap(one)({k: jnp.asarray(v) for k, v in dyn.items()})
    return got, want


@pytest.mark.parametrize("name", sorted(JR.REWARD_FUNCTIONS))
def test_reward_term_matches(name):
    """Every reward term on the same inputs (branches of low_speed, contact
    filters and clamps included); relative 1e-5 in f32."""
    assert set(TR.REWARD_FUNCTIONS) == set(JR.REWARD_FUNCTIONS)
    got, want = _eval_both(JR.REWARD_FUNCTIONS[name], TR.REWARD_FUNCTIONS[name])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_feet_state_update_matches():
    got, want = _eval_both(JR.feet_state_update, TR.feet_state_update)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ step


def test_env_step_matches_jax():
    """Two batched env steps from one shared state. Tolerances: qpos 2e-4,
    qvel 5e-3 (the plain-mega vs fallback contract), obs / privileged obs
    5e-3 (they carry qvel-derived entries), reward 1e-4, exact done flags."""
    n, iters = 3, 200
    jcfg = _quiet(JaxCfg(), n, iters)
    jcfg.sim.solver.solver_type = "apgd"
    tcfg = _quiet(TorchCfg(), n, iters)
    tcfg.sim.solver.solver_type = "mega"
    jenv = jax_make_env(jcfg)
    tenv = torch_make_env(tcfg, device="cpu", seed=0)
    assert tenv.reward_names == jenv.reward_names
    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(3), n), jnp.arange(n))
    ts = env_state_from_jax(js)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    for _ in range(2):
        a = rng.uniform(-0.5, 0.5, (n, 12)).astype(np.float32)
        js, jtr = jstep(js, jnp.asarray(a))
        ts, ttr = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        assert not np.asarray(jtr.done).any()
        np.testing.assert_allclose(ts.phys.qpos.numpy(), js.phys.qpos, atol=2e-4)
        np.testing.assert_allclose(ts.phys.qvel.numpy(), js.phys.qvel, atol=5e-3)
        np.testing.assert_allclose(ttr.obs.numpy(), jtr.obs, atol=5e-3)
        np.testing.assert_allclose(ttr.privileged_obs.numpy(), jtr.privileged_obs, atol=5e-3)
        np.testing.assert_allclose(ttr.reward.numpy(), jtr.reward, atol=1e-4)
        np.testing.assert_allclose(ts.commands.numpy(), js.commands, atol=1e-5)
        np.testing.assert_allclose(ts.episode_sums.numpy(), js.episode_sums, atol=1e-4)
        np.testing.assert_array_equal(ts.episode_length.numpy(), js.episode_length)


@pytest.mark.parametrize("solver", ["apgd", "fused_pallas"])
def test_env_step_substep_solver_matches_jax(solver):
    """Two batched env steps with a per-substep solver in the port and
    `solver_type="apgd"` in the JAX package, at the configured 8 solver
    iterations (the two share the external DOF order, so no run to
    convergence is needed). The feet / knee kinematics come from `fk` /
    `body_velocities` here, not from the mega kernel's rows. Tolerances:
    qpos 2e-4, qvel 5e-3, obs / privileged obs 5e-3, reward and every
    reward term 1e-4, exact done flags."""
    n = 3
    jcfg = _quiet(JaxCfg(), n, 8)
    jcfg.sim.solver.solver_type = "apgd"
    tcfg = _quiet(TorchCfg(), n, 8)
    tcfg.sim.solver.solver_type = solver
    jenv = jax_make_env(jcfg)
    tenv = torch_make_env(tcfg, device="cpu", seed=0)
    assert tenv.reward_names == jenv.reward_names
    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(3), n), jnp.arange(n))
    ts = env_state_from_jax(js)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    for _ in range(2):
        a = rng.uniform(-0.5, 0.5, (n, 12)).astype(np.float32)
        js_prev, ts_prev = js, ts
        js, jtr = jstep(js, jnp.asarray(a))
        ts, ttr = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        assert not np.asarray(jtr.done).any()
        np.testing.assert_allclose(ts.phys.qpos.numpy(), js.phys.qpos, atol=2e-4)
        np.testing.assert_allclose(ts.phys.qvel.numpy(), js.phys.qvel, atol=5e-3)
        np.testing.assert_allclose(ttr.obs.numpy(), jtr.obs, atol=5e-3)
        np.testing.assert_allclose(ttr.privileged_obs.numpy(), jtr.privileged_obs, atol=5e-3)
        np.testing.assert_allclose(ttr.reward.numpy(), jtr.reward, atol=1e-4)
        # every reward term: the step's increment of the per-term sums
        np.testing.assert_allclose(
            (ts.episode_sums - ts_prev.episode_sums).numpy(),
            np.asarray(js.episode_sums - js_prev.episode_sums), atol=1e-4)
        np.testing.assert_allclose(ts.feet_air_time.numpy(), js.feet_air_time, atol=1e-6)
        np.testing.assert_allclose(ts.last_feet_z.numpy(), js.last_feet_z, atol=2e-4)
        np.testing.assert_array_equal(ts.episode_length.numpy(), js.episode_length)
    assert float(ts.phys.fk_out.abs().max()) == 0.0
