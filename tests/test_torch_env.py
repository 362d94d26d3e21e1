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


def test_nonfinite_env_auto_resets():
    """The port of tests/test_env.py:270: a numerically exploded env flags
    done, gets a finite reward and finite observations, comes back with a
    finite state, and leaves the healthy env alone."""
    cfg = _quiet(TorchCfg(), 2, 8)
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    env = torch_make_env(cfg, device="cpu", seed=5)
    state, _ = env.step(env.init_state(), torch.zeros((2, 12)))
    qvel = state.phys.qvel.clone()
    qvel[0, 3] = float("nan")
    state, tr = env.step(state.replace(phys=state.phys.replace(qvel=qvel)), torch.zeros((2, 12)))
    assert bool(tr.done[0])
    assert int(tr.nonfinite[0]) == 1 and int(tr.nonfinite[1]) == 0
    assert bool(torch.isfinite(tr.reward[0]))
    assert bool(torch.isfinite(tr.obs).all()) and bool(torch.isfinite(tr.privileged_obs).all())
    assert bool(torch.isfinite(state.phys.qpos[0]).all())
    assert not bool(tr.done[1])


# ------------------------------------------------------------------ terrain


def _small_terrain(cfg, mode="survival"):
    """A 3 x 3 map with a 5 m border (levels start at 0-1), the curriculum
    in `mode`."""
    cfg.terrain.num_rows, cfg.terrain.num_cols, cfg.terrain.border_size = 3, 3, 5.0
    cfg.terrain.max_init_terrain_level = 1
    cfg.terrain.curriculum_mode = mode
    return cfg


def _measured(cfg):
    """measure_heights on: the 17 x 11 height samples join the privileged
    frame."""
    pts = len(cfg.terrain.measured_points_x) * len(cfg.terrain.measured_points_y)
    cfg.terrain.measure_heights = True
    cfg.env.single_num_privileged_obs = 73 + pts
    cfg.env.num_privileged_obs = cfg.env.c_frame_stack * (73 + pts)
    return cfg


def _terrain_pair(n, iters):
    """The JAX env (solver apgd) and the port's env (solver mega) for
    `humanoid_ppo_terrain_robust` on the small map with measured heights,
    quiet, from one config: both build the same map
    (tests/test_torch_terrain.py)."""
    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu_torch import registry as treg

    def jov(c):
        _measured(_small_terrain(_quiet(c, n, iters)))
        c.sim.solver.solver_type = "apgd"

    def tov(c):
        _measured(_small_terrain(_quiet(c, n, iters)))
        c.sim.solver.solver_type = "mega"

    jenv, _ = jreg.make_env("humanoid_ppo_terrain_robust", num_envs=n, cfg_overrides=jov)
    tenv, tcfg = treg.make_env("humanoid_ppo_terrain_robust", num_envs=n, cfg_overrides=tov,
                               device="cpu")
    np.testing.assert_array_equal(tenv.terrain_map.height_field, jenv.terrain_map.height_field)
    return jenv, tenv, tcfg


def test_terrain_env_step_matches_jax():
    """`humanoid_ppo_terrain_robust` on a small map, with the measured
    heights in the privileged obs: two batched env steps
    from one shared state whose robots stand on the terrain (the base 0.87 m
    over the bilinear ground, so the soles touch it), then a third in which
    every env times out, so the survival curriculum moves each level (none
    past the top row, where the re-entry level is drawn). The tolerances of
    `test_env_step_matches_jax`; levels and origins exact."""
    from humanoid_gym_tpu.terrain.terrain import make_contact_height_fn

    n, iters = 3, 200
    jenv, tenv, _ = _terrain_pair(n, iters)
    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(5), n), jnp.arange(n))
    qpos = np.array(js.phys.qpos)
    ground = make_contact_height_fn(jenv.terrain_map)(jnp.asarray(qpos[:, 0]), jnp.asarray(qpos[:, 1]))
    qpos[:, 2] = np.asarray(ground) + 0.87
    js = js.replace(phys=js.phys.replace(qpos=jnp.asarray(qpos)))
    ts = env_state_from_jax(js)
    np.testing.assert_array_equal(ts.terrain_level.numpy(), np.asarray(js.terrain_level))
    assert int(ts.terrain_level.max()) <= 1
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    max_force = 0.0
    for i in range(3):
        if i == 2:  # every env times out with a zero command: promoted
            js = js.replace(episode_length=jnp.full((n,), jenv.max_episode_length, jnp.int32),
                            commands=jnp.zeros_like(js.commands))
            ts = env_state_from_jax(js)
        a = rng.uniform(-0.3, 0.3, (n, 12)).astype(np.float32)
        js, jtr = jstep(js, jnp.asarray(a))
        ts, ttr = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_array_equal(ts.terrain_level.numpy(), np.asarray(js.terrain_level))
        np.testing.assert_array_equal(ttr.terrain_level.numpy(), np.asarray(jtr.terrain_level))
        np.testing.assert_allclose(ts.env_origin.numpy(), js.env_origin, atol=1e-6)
        if i == 2:
            assert np.asarray(jtr.done).all() and np.asarray(jtr.time_out).all()
            break
        assert not np.asarray(jtr.done).any()
        np.testing.assert_allclose(ts.phys.qpos.numpy(), js.phys.qpos, atol=2e-4)
        np.testing.assert_allclose(ts.phys.qvel.numpy(), js.phys.qvel, atol=5e-3)
        np.testing.assert_allclose(ttr.obs.numpy(), jtr.obs, atol=5e-3)
        np.testing.assert_allclose(ttr.privileged_obs.numpy(), jtr.privileged_obs, atol=5e-3)
        np.testing.assert_allclose(ttr.reward.numpy(), jtr.reward, atol=1e-4)
        np.testing.assert_allclose(ts.phys.contact_forces.numpy(), js.phys.contact_forces, atol=5.0)
        heights = ttr.privileged_obs.numpy().reshape(n, 3, -1)[:, -1, 73:]
        assert heights.shape == (n, 187) and np.ptp(heights) > 0.0
        max_force = max(max_force, float(np.abs(np.asarray(js.phys.contact_forces)).max()))
    assert max_force > 20.0, "no contact force: the robots never touched the terrain"


def test_terrain_reset_placement():
    """init_state: levels in [0, max_init_terrain_level] with the curriculum
    and over every row without it; types spread over the env index
    (env * num_cols // num_envs); the base at the subterrain origin plus
    the init height, with at most 1 m of xy jitter."""
    from humanoid_gym_tpu_torch import registry as treg

    for curriculum, top in ((True, 1), (False, 2)):
        def ov(c, curriculum=curriculum):
            _small_terrain(c)
            c.terrain.curriculum = curriculum
            c.sim.solver.solver_type = "apgd"

        env, cfg = treg.make_env("humanoid_ppo_terrain", num_envs=60, cfg_overrides=ov,
                                 device="cpu", seed=2)
        st = env.init_state()
        lv, tp = st.terrain_level.numpy(), st.terrain_type.numpy()
        assert lv.min() == 0 and lv.max() == top
        np.testing.assert_array_equal(tp, np.arange(60) * 3 // 60)
        origin = env.terrain_map.env_origins[lv, tp]
        np.testing.assert_allclose(st.env_origin.numpy(), origin, atol=1e-6)
        d = st.phys.qpos[:, :3].numpy() - origin
        assert np.abs(d[:, :2]).max() <= 1.0 and np.abs(d[:, :2]).max() > 0.5
        np.testing.assert_allclose(d[:, 2], cfg.init_state.pos[2], atol=1e-6)


def _curriculum_reference(mode, level, ttype, origin, qpos, commands, done, time_out, ep_len,
                          rand_level, origins, num_rows, terrain_length, ep_len_s, max_len):
    """The JAX package's terrain curriculum (envs/env.py:686-716) in numpy."""
    dist = np.linalg.norm(qpos[:, :2] - origin[:, :2], axis=1)
    need = np.linalg.norm(commands[:, :2], axis=1) * ep_len_s * 0.5
    if mode == "survival":
        up = time_out & (dist >= need)
        down = ~time_out & (ep_len < max_len // 2)
    else:
        up = dist > terrain_length / 2
        down = (dist < need) & ~up
    new = level + up.astype(np.int32) - down.astype(np.int32)
    new = np.where(new >= num_rows, rand_level, np.maximum(new, 0))
    level = np.where(done, new, level)
    return level, np.where(done[:, None], origins[level, ttype], origin)


@pytest.mark.parametrize("mode", ["distance", "survival"])
def test_terrain_curriculum_update(mode):
    """`_terrain_curriculum` with injected draws against the reference rule
    on 200 envs: every branch (promoted, demoted, kept, above the top row
    re-entering at the injected level, envs that do not reset)."""
    from humanoid_gym_tpu_torch import registry as treg

    def ov(c):
        _small_terrain(c, mode)
        c.sim.solver.solver_type = "apgd"

    env, cfg = treg.make_env("humanoid_ppo_terrain_robust", num_envs=200, cfg_overrides=ov,
                             device="cpu")
    st = env.init_state()
    rng = np.random.default_rng(7)
    n = 200
    level = rng.integers(0, 3, n).astype(np.int32)
    ttype = st.terrain_type.numpy()
    origins = env.terrain_map.env_origins.astype(np.float32)
    origin = origins[level, ttype]
    qpos = st.phys.qpos.numpy().copy()
    qpos[:, :2] = origin[:, :2] + rng.uniform(-6.0, 6.0, (n, 2))
    commands = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    commands[:20] = 0.0
    done = rng.uniform(size=n) < 0.7
    time_out = done & (rng.uniform(size=n) < 0.5)
    ep_len = rng.integers(0, env.max_episode_length, n).astype(np.int32)
    rand_level = rng.integers(0, 3, n)
    st = st.replace(terrain_level=torch.from_numpy(level), env_origin=torch.from_numpy(origin),
                    episode_length=torch.from_numpy(ep_len))
    got_l, got_o = env._terrain_curriculum(st, torch.from_numpy(qpos), torch.from_numpy(commands),
                                           torch.from_numpy(done), torch.from_numpy(time_out),
                                           torch.from_numpy(rand_level))
    want_l, want_o = _curriculum_reference(
        mode, level, ttype, origin, qpos, commands, done, time_out, ep_len, rand_level, origins,
        3, cfg.terrain.terrain_length, cfg.env.episode_length_s, env.max_episode_length)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=1e-6)
    moved = want_l - level
    assert (moved[done] > 0).any() and (moved[done] < 0).any() and (moved[done] == 0).any()
    assert (moved[~done] == 0).all() and ((level == 2) & done & (moved != 1)).any()


def test_survival_curriculum_promotes_standing_survivor():
    """Port of tests/test_terrain.py:202 with injected state: an env that
    reaches timeout at zero command without walking is promoted in the
    survival mode and held in the distance mode (walked 0 m < half a
    subterrain, but not less than the zero distance it was asked for)."""
    from humanoid_gym_tpu_torch import registry as treg

    for mode, want in (("survival", 1), ("distance", 0)):
        def ov(c, mode=mode):
            _small_terrain(c, mode)
            c.sim.solver.solver_type = "apgd"

        env, _ = treg.make_env("humanoid_ppo_rubble", num_envs=2, cfg_overrides=ov, device="cpu")
        st = env.init_state()
        st = st.replace(terrain_level=torch.zeros(2, dtype=torch.int32),
                        env_origin=torch.from_numpy(
                            env.terrain_map.env_origins[0, st.terrain_type.numpy()].astype(np.float32)))
        qpos = st.phys.qpos.clone()
        qpos[:, :2] = st.env_origin[:, :2]
        yes = torch.ones(2, dtype=torch.bool)
        lvl, _ = env._terrain_curriculum(st, qpos, torch.zeros((2, 4)), yes, yes,
                                         torch.zeros(2, dtype=torch.int64))
        assert lvl.tolist() == [want, want], mode


def test_terrain_level_past_the_top_row_matches_jax():
    """A drawn level may equal num_rows (max_init_terrain_level = num_rows,
    as `humanoid_joint_deploy` sets 20 on 20 rows): the JAX package's
    clamped gather stands such an env on the top row's origin and keeps the
    level in the state. At num_rows = 2, max_init_terrain_level = 2,
    curriculum on, 64 envs:
    - the port's own draws: levels over 0-2, origins those of
      min(level, 1);
    - JAX's draws injected into the port's lookup: origins equal to 1e-6;
    - one env step of both from the shared state at zero command, every
      other env timing out (so a resetting env keeps its level, and one at
      level 2 re-enters at a drawn level): levels exact and origins to 1e-6
      wherever the level is not the re-entry draw, and no lookup past the
      top row for the envs that stay at level 2; then the port's curriculum
      with JAX's re-entry levels injected: every level exact, every origin
      to 1e-6."""
    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu_torch import registry as treg

    n = 64

    def ov(c):
        _quiet(c, n, 8)
        c.terrain.num_rows, c.terrain.num_cols, c.terrain.border_size = 2, 3, 5.0
        c.terrain.max_init_terrain_level = 2
        c.sim.solver.solver_type = "apgd"

    jenv, _ = jreg.make_env("humanoid_ppo_terrain", num_envs=n, cfg_overrides=ov)
    tenv, _ = treg.make_env("humanoid_ppo_terrain", num_envs=n, cfg_overrides=ov, device="cpu",
                            seed=1)
    origins = tenv.terrain_map.env_origins.astype(np.float32)
    np.testing.assert_array_equal(origins, np.asarray(jenv.terrain_origins))

    own = tenv.init_state()
    lv, tp = own.terrain_level.numpy(), own.terrain_type.numpy()
    assert set(lv.tolist()) == {0, 1, 2}
    np.testing.assert_allclose(own.env_origin.numpy(), origins[np.minimum(lv, 1), tp], atol=1e-6)

    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(0), n), jnp.arange(n))
    jl = np.array(js.terrain_level)
    assert set(jl.tolist()) == {0, 1, 2}
    got = tenv.terrain_origin(torch.from_numpy(jl), torch.from_numpy(np.array(js.terrain_type)))
    np.testing.assert_allclose(got.numpy(), js.env_origin, atol=1e-6)

    ep = np.zeros(n, np.int32)
    ep[::2] = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray(ep), commands=jnp.zeros_like(js.commands))
    ts = env_state_from_jax(js)
    np.testing.assert_array_equal(ts.terrain_level.numpy(), jl)
    a = np.zeros((n, 12), np.float32)
    js1, jtr = jax.jit(jenv.step)(js, jnp.asarray(a))
    ts1, ttr = tenv.step(ts, torch.from_numpy(a))
    done = np.array(jtr.done)
    np.testing.assert_array_equal(ttr.done.numpy(), done)
    assert done[::2].all() and not done[1::2].any()
    drawn = done & (jl == 2)  # kept at 2, the top: a re-entry draw
    assert drawn.any() and (~done & (jl == 2)).any()
    want_l, want_o = np.asarray(js1.terrain_level), np.asarray(js1.env_origin)
    np.testing.assert_array_equal(ts1.terrain_level.numpy()[~drawn], want_l[~drawn])
    np.testing.assert_allclose(ts1.env_origin.numpy()[~drawn], want_o[~drawn], atol=1e-6)
    lv1, tp1 = ts1.terrain_level.numpy(), ts1.terrain_type.numpy()
    assert (lv1[drawn] < 2).all()
    np.testing.assert_allclose(ts1.env_origin.numpy(), origins[np.minimum(lv1, 1), tp1], atol=1e-6)

    # the walked distance is read at the step-start pose: 10 ms of physics
    # move the base by millimetres, far from the 4 m promotion distance
    level, origin = tenv._terrain_curriculum(
        ts, ts.phys.qpos, torch.zeros((n, 4)), torch.from_numpy(done),
        torch.from_numpy(np.array(jtr.time_out)), torch.from_numpy(want_l.astype(np.int64)))
    np.testing.assert_array_equal(level.numpy(), want_l)
    np.testing.assert_allclose(origin.numpy(), want_o, atol=1e-6)


# ------------------------------------------------------------------ command curriculum


def _curriculum_cfg(cfg, n):
    """The quiet config with the command curriculum on (max_curriculum
    1.7), as tests/test_env.py:339 sets it up."""
    _quiet(cfg, n, 8)
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.commands.curriculum = True
    cfg.commands.max_curriculum = 1.7
    cfg.sim.solver.solver_type = "apgd"
    return cfg


def _at_the_gate(js, env, track, ep_len, common_step, vx_range=None):
    """JAX state `js` with env i's tracking_lin_vel episode sum at track[i] x
    its per-step maximum x max_episode_length, the episode lengths and the
    common step given (the step taken next is the gate's when common_step
    = L - 1, and envs with ep_len = L time out in it)."""
    ti = env.reward_names.index("tracking_lin_vel")
    L = env.max_episode_length
    es = np.zeros(js.episode_sums.shape, np.float32)
    es[:, ti] = np.asarray(track, np.float32) * float(env.reward_scales[ti]) * L
    n = es.shape[0]
    kw = dict(episode_sums=jnp.asarray(es),
              episode_length=jnp.asarray(np.asarray(ep_len, np.int32)),
              common_step=jnp.full((n,), common_step, jnp.int32))
    if vx_range is not None:
        kw["cmd_vx_range"] = jnp.asarray(np.broadcast_to(np.float32(vx_range), (n, 2)))
    return js.replace(**kw)


def test_command_curriculum_matches_jax():
    """Port of tests/test_env.py:339 against the JAX package from one
    injected state (4 envs, every one timing out at the gate step unless
    said otherwise): the range widens by +-0.5 when the mean tracking
    reward over the resetting envs exceeds 80% of its maximum; it stays at
    0 tracking, off the gate step, and when the mean is taken over the
    resetting half only (0.85 there, 0.425 over all envs: it widens); it
    clips at max_curriculum. Ranges equal to 1e-6, done flags exact."""
    n = 4
    jenv = jax_make_env(_curriculum_cfg(JaxCfg(), n))
    tenv = torch_make_env(_curriculum_cfg(TorchCfg(), n), device="cpu", seed=0)
    assert tenv.reward_names == jenv.reward_names
    js0 = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(7), n), jnp.arange(n))
    jstep = jax.jit(jenv.step)
    L = jenv.max_episode_length
    base = np.asarray(TorchCfg().commands.ranges.lin_vel_x, np.float32)
    grown = np.array([max(base[0] - 0.5, -1.7), min(base[1] + 0.5, 1.7)], np.float32)
    cases = [
        ([0.95] * 4, [L] * 4, L - 1, None, grown),
        ([0.0] * 4, [L] * 4, L - 1, None, base),
        ([0.95] * 4, [L] * 4, L, None, base),  # off the gate step
        ([0.85, 0.85, 0.0, 0.0], [L, L, 0, 0], L - 1, None, grown),
        ([0.95] * 4, [L] * 4, L - 1, [-1.5, 1.5], np.array([-1.7, 1.7], np.float32)),
    ]
    zero = np.zeros((n, 12), np.float32)
    for track, ep_len, common, vx_range, want in cases:
        js = _at_the_gate(js0, jenv, track, ep_len, common, vx_range)
        js1, jtr = jstep(js, jnp.asarray(zero))
        ts1, ttr = tenv.step(env_state_from_jax(js), torch.from_numpy(zero))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_array_equal(np.asarray(jtr.done), np.asarray(ep_len) == L)
        np.testing.assert_allclose(ts1.cmd_vx_range.numpy(), np.asarray(js1.cmd_vx_range),
                                   atol=1e-6)
        np.testing.assert_allclose(ts1.cmd_vx_range.numpy(), np.broadcast_to(want, (n, 2)),
                                   atol=1e-6, err_msg=str((track, ep_len, common)))


def test_command_curriculum_one_resample_lag():
    """The envs resetting on the widening step draw their commands from
    the range before it (the JAX package's one-resample lag, envs/env.py:
    906-910); the next resets draw from the widened range. 64 envs."""
    n = 64
    tenv = torch_make_env(_curriculum_cfg(TorchCfg(), n), device="cpu", seed=3)
    L = tenv.max_episode_length
    ti = tenv.reward_names.index("tracking_lin_vel")
    st = tenv.init_state()
    es = torch.zeros_like(st.episode_sums)
    es[:, ti] = 0.95 * tenv.reward_scales[ti] * L
    st = st.replace(episode_sums=es, episode_length=torch.full((n,), L, dtype=torch.int32),
                    common_step=torch.full((n,), L - 1, dtype=torch.int32))
    zero = torch.zeros((n, 12))
    st1, tr1 = tenv.step(st, zero)
    assert bool(tr1.done.all())
    np.testing.assert_allclose(st1.cmd_vx_range[0].numpy(), [-0.8, 1.1], atol=1e-6)
    vx1 = st1.commands[:, 0]
    assert bool(((vx1 >= -0.3) & (vx1 <= 0.6)).all())
    st2, tr2 = tenv.step(st1.replace(episode_length=torch.full((n,), L, dtype=torch.int32)), zero)
    assert bool(tr2.done.all())
    np.testing.assert_allclose(st2.cmd_vx_range[0].numpy(), [-0.8, 1.1], atol=1e-6)
    vx2 = st2.commands[:, 0]
    assert bool(((vx2 >= -0.8) & (vx2 <= 1.1)).all())
    assert bool(((vx2 < -0.3) | (vx2 > 0.6)).any())


CURRICULUM_WORKER = r'''
import os, sys
sys.path.insert(0, os.environ["HGT_REPO"])
import torch
torch.set_num_threads(1)
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
from humanoid_gym_tpu_torch.envs import make_env
from humanoid_gym_tpu_torch.parallel import make_env_group
from humanoid_gym_tpu_torch.runner.on_policy_runner import _env_state_from_saved
work = sys.argv[1]
group = make_env_group("gloo", device="cpu", init_method=f"file://{work}/rdv")
inp = torch.load(f"{work}/in.pt", weights_only=True)
cfg = XBotLCfg()
cfg.noise.add_noise = False
cfg.domain_rand.push_robots = False
cfg.domain_rand.action_delay = 0.0
cfg.domain_rand.action_noise = 0.0
cfg.domain_rand.randomize_friction = False
cfg.domain_rand.randomize_base_mass = False
cfg.commands.curriculum = True
cfg.commands.max_curriculum = 1.7
cfg.sim.solver.solver_type = "apgd"
cfg.sim.solver.solver_iterations = 8
n = inp["n"]
per = n // group.world
lo = group.rank * per
env = make_env(cfg, num_envs=per, device="cpu", seed=0, env_offset=lo, num_envs_global=n,
               group=group)

def cut(d):
    return {k: cut(v) if isinstance(v, dict) else v[lo:lo + per] for k, v in d.items()}

out = []
for saved in inp["states"]:
    st = _env_state_from_saved(cut(saved), env.init_state())
    st, _ = env.step(st, torch.zeros((per, 12)))
    out.append(st.cmd_vx_range)
torch.save(out, f"{work}/out{group.rank}.pt")
group.close()
'''


def test_command_curriculum_over_two_ranks_widens_with_one_process(tmp_path):
    """The same 4-env states split over 2 gloo ranks (envs 0-1, 2-3): every
    rank's range equals one process's on the same step. Rank 0's envs track
    at 100% and rank 1's at 70% of the maximum (mean 85%: widens, though
    rank 1 alone would not), then 90% and 60% (mean 75%: stays, though
    rank 0 alone would widen)."""
    import os
    import sys

    from humanoid_gym_tpu_torch.parallel.launch import RankJob
    from humanoid_gym_tpu_torch.runner.on_policy_runner import _env_state_to_saved

    n = 4
    jenv = jax_make_env(_curriculum_cfg(JaxCfg(), n))
    tenv = torch_make_env(_curriculum_cfg(TorchCfg(), n), device="cpu", seed=0)
    js0 = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(7), n), jnp.arange(n))
    L = jenv.max_episode_length
    states = [env_state_from_jax(_at_the_gate(js0, jenv, track, [L] * n, L - 1))
              for track in ([1.0, 1.0, 0.7, 0.7], [0.9, 0.9, 0.6, 0.6])]
    one = [tenv.step(st, torch.zeros((n, 12)))[0].cmd_vx_range for st in states]
    np.testing.assert_allclose(one[0].numpy(), np.broadcast_to([-0.8, 1.1], (n, 2)), atol=1e-6)
    np.testing.assert_allclose(one[1].numpy(), np.broadcast_to([-0.3, 0.6], (n, 2)), atol=1e-6)

    torch.save({"n": n, "states": [_env_state_to_saved(s) for s in states]}, tmp_path / "in.pt")
    (tmp_path / "worker.py").write_text(CURRICULUM_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    RankJob([sys.executable, str(tmp_path / "worker.py"), str(tmp_path)], 2,
            dict(os.environ, HGT_REPO=root, OMP_NUM_THREADS="1")).wait(240)
    for r in range(2):
        got = torch.load(tmp_path / f"out{r}.pt", weights_only=True)
        for case in range(2):
            assert torch.equal(got[case], one[case][2 * r:2 * r + 2]), (r, case)
