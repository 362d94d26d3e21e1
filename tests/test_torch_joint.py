"""The port's joint XBot-L + XBot-S batch (`envs/joint.py`,
`humanoid_joint_ppo`, `humanoid_joint_deploy`) on the CPU at 4 envs:
ports of tests/test_joint_env.py, plus the concatenation contract, the
runner's list state and the deploy task's configuration against the JAX
package's."""

import dataclasses

import numpy as np
import pytest
import torch

from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.envs.joint import JointEnv, sub_env_seed
from humanoid_gym_tpu_torch.runner import OnPolicyRunner

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("HGT_WANDB", "0")


def _apgd(cfg):
    cfg.sim.solver.solver_type = "apgd"


def _train_cfg(task):
    tcfg = registry.get_task(task).make_train_cfg()
    tcfg.runner.num_steps_per_env = 2
    tcfg.runner.save_interval = 100
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 1
    return tcfg


def test_joint_state_and_transitions_concatenate():
    """`humanoid_joint_ppo` at 2 + 2 envs: an XBot-L and an XBot-S sub-env
    with their own generators; reset_all's obs (4, 705) and (4, 219); L
    stands above 0.85 m and S below 0.75 m; a joint step equals each
    sub-env stepped on its slice (same generator states), concatenated in
    order, field for field, exactly."""
    env, cfg = registry.make_env("humanoid_joint_ppo", num_envs=4, cfg_overrides=_apgd,
                                 device="cpu", seed=3)
    assert isinstance(env, JointEnv) and env.num_envs == 4 and env.counts == [2, 2]
    l_env, s_env = env.envs
    assert l_env.cfg.asset.name != s_env.cfg.asset.name
    assert float(s_env.model.body_mass[0]) < float(l_env.model.body_mass[0])
    seeds = [int(e.gen.initial_seed()) for e in env.envs]
    assert seeds == [sub_env_seed(3, 0), sub_env_seed(3, 1)] and seeds[0] != seeds[1]
    state, obs, priv = env.reset_all()
    assert obs.shape == (4, 705) and priv.shape == (4, 219) and torch.isfinite(obs).all()
    assert isinstance(state, list) and len(state) == 2
    zs = torch.cat([st.phys.qpos[:, 2] for st in state])
    assert float(zs[:2].mean()) > 0.85 and float(zs[2:].mean()) < 0.75

    actions = torch.from_numpy(np.random.default_rng(0).uniform(-0.3, 0.3, (4, 12)).astype(np.float32))
    gens = [e.gen.get_state() for e in env.envs]
    joint_state, joint_tr = env.step(state, actions)
    for e, g in zip(env.envs, gens):
        e.gen.set_state(g)
    parts = [l_env.step(state[0], actions[:2]), s_env.step(state[1], actions[2:])]
    for f in dataclasses.fields(joint_tr):
        want = torch.cat([getattr(tr, f.name) for _, tr in parts])
        assert torch.equal(getattr(joint_tr, f.name), want), f.name
    for js, (ps, _) in zip(joint_state, parts):
        assert torch.equal(js.phys.qpos, ps.phys.qpos) and torch.equal(js.commands, ps.commands)


def test_joint_ppo_iteration_and_list_state_resume(tmp_path):
    """One joint PPO iteration (T = 2, the estimator head on with coef 1.0)
    through OnPolicyRunner.learn: finite metrics, including the logged
    estimator loss; random episode lengths spread over both sub-envs; the
    final checkpoint's list state restores into a runner of another seed,
    sub-env by sub-env."""
    import json

    env, _ = registry.make_env("humanoid_joint_ppo", num_envs=4, cfg_overrides=_apgd,
                               device="cpu", seed=0)
    tcfg = _train_cfg("humanoid_joint_ppo")
    assert (tcfg.policy.estimator_dim, tcfg.algorithm.estimator_coef) == (3, 1.0)
    run_a = OnPolicyRunner(env, tcfg, log_dir=str(tmp_path / "a"), seed=5)
    assert run_a.net.estimator_dim == 3
    run_a.learn(1, init_at_random_ep_len=True)
    line = json.loads(open(tmp_path / "a" / "metrics.jsonl").readline())
    assert all(np.isfinite(v) for v in line.values())
    assert line["Loss/estimator"] > 0.0
    assert all(int(st.episode_length.max()) > 2 for st in run_a.env_state)

    env_b, _ = registry.make_env("humanoid_joint_ppo", num_envs=4, cfg_overrides=_apgd,
                                 device="cpu", seed=9)
    run_b = OnPolicyRunner(env_b, tcfg, log_dir=None, seed=6)
    assert not torch.equal(run_b.env_state[1].phys.qpos, run_a.env_state[1].phys.qpos)
    run_b.load(str(tmp_path / "a" / "model_1.ckpt"))
    assert isinstance(run_b.env_state, list) and len(run_b.env_state) == 2
    for sa, sb in zip(run_a.env_state, run_b.env_state):
        assert torch.equal(sa.phys.qpos, sb.phys.qpos)
        assert torch.equal(sa.episode_length, sb.episode_length)
    assert torch.equal(run_a.obs, run_b.obs)
    run_b.learn(1)
    assert run_b.current_learning_iteration == 2


def test_joint_deploy_task_builds_as_the_reference():
    """`humanoid_joint_deploy` at 4 envs: estimator dims 3 and coef 1.0;
    both sub-envs on the deploy style with the curriculum, slope DR, every
    level from the start (20 of 20 rows) and the joint pins froude_scale
    1.0 and deploy_mjcf None, so XBot-S trains on the full-size field; each
    sub-env's terrain and DR config equals the JAX package's, and so does
    its map; reset_all gives finite obs."""
    from humanoid_gym_tpu import registry as jreg

    env, _ = registry.make_env("humanoid_joint_deploy", num_envs=4, cfg_overrides=_apgd,
                               device="cpu")
    tcfg = registry.get_task("humanoid_joint_deploy").make_train_cfg()
    assert (tcfg.policy.estimator_dim, tcfg.algorithm.estimator_coef) == (3, 1.0)
    jenv, _ = jreg.make_env("humanoid_joint_deploy", num_envs=4)
    assert env.num_envs == 4 and len(env.envs) == len(jenv.envs) == 2
    for sub, jsub in zip(env.envs, jenv.envs):
        t = sub.cfg.terrain
        assert (t.style, t.curriculum, t.curriculum_mode) == ("deploy", True, "survival")
        assert (t.num_rows, t.max_init_terrain_level) == (20, 20)
        assert t.froude_scale == 1.0 and t.deploy_mjcf is None
        assert sub.cfg.domain_rand.randomize_contact_slope
        for part in ("terrain", "domain_rand"):
            assert vars(getattr(sub.cfg, part)) == vars(getattr(jsub.cfg, part)), part
        assert sub.cfg.rewards.scales.low_speed == jsub.cfg.rewards.scales.low_speed == 0.6
        np.testing.assert_array_equal(sub.terrain_map.height_field, jsub.terrain_map.height_field)
    state, obs, priv = env.reset_all()
    assert obs.shape == (4, 705) and torch.isfinite(obs).all() and torch.isfinite(priv).all()
    levels = torch.cat([st.terrain_level for st in state])
    assert int(levels.min()) >= 0 and int(levels.max()) <= 20


def test_joint_deploy_env_step_matches_jax():
    """Both robots of `humanoid_joint_deploy` on the deploy field (20 rows)
    at 3 + 3 envs, quiet as test_torch_env.py's `_quiet`, from one JAX
    state carried into the port: each robot's bases over the bilinear
    ground (0.87 m for XBot-L, x s for XBot-S, so the soles touch it), its
    envs on levels 0, 19 and 20 (20 stands on the top row). Two joint steps
    (the port's solver mega, JAX's apgd, both at 200 iterations), then a
    third in which every env times out at zero command, so the survival
    curriculum promotes each one: a level below the top moves up, one on
    or past the top re-enters at a drawn level. The tolerances of
    `test_terrain_env_step_matches_jax`; levels and origins exact, and the
    drawn re-entry levels, JAX's injected into the port's curriculum,
    give the same levels and origins."""
    import jax
    import jax.numpy as jnp

    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu.terrain.terrain import make_contact_height_fn
    from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax
    from humanoid_gym_tpu_torch.config.xbots import SCALE

    n, iters = 6, 200

    def quiet(c, solver):
        c.noise.add_noise = False
        c.domain_rand.push_robots = False
        c.domain_rand.action_delay = 0.0
        c.domain_rand.action_noise = 0.0
        c.sim.solver.solver_iterations = iters
        c.sim.solver.solver_type = solver

    jenv, _ = jreg.make_env("humanoid_joint_deploy", num_envs=n,
                            cfg_overrides=lambda c: quiet(c, "apgd"))
    tenv, _ = registry.make_env("humanoid_joint_deploy", num_envs=n,
                                cfg_overrides=lambda c: quiet(c, "mega"), device="cpu")
    assert tenv.counts == jenv.counts == [3, 3]
    js = jenv.init_state(jax.random.split(jax.random.PRNGKey(5), n), jnp.arange(n))
    origins = []
    for i, (je, te) in enumerate(zip(jenv.envs, tenv.envs)):
        np.testing.assert_array_equal(te.terrain_map.height_field, je.terrain_map.height_field)
        o = np.asarray(je.terrain_origins)
        np.testing.assert_array_equal(te.terrain_origins.numpy(), o)
        origins.append(o)
        rows = te.cfg.terrain.num_rows
        lvl = np.array([0, rows - 1, rows], np.int32)
        ttype = np.asarray(js[i].terrain_type)
        origin = o[np.minimum(lvl, rows - 1), ttype]
        qpos = np.array(js[i].phys.qpos)
        qpos[:, :2] += origin[:, :2] - np.asarray(js[i].env_origin)[:, :2]
        ground = make_contact_height_fn(je.terrain_map)(jnp.asarray(qpos[:, 0]),
                                                        jnp.asarray(qpos[:, 1]))
        qpos[:, 2] = np.asarray(ground) + 0.87 * (SCALE if i == 1 else 1.0)
        js[i] = js[i].replace(phys=js[i].phys.replace(qpos=jnp.asarray(qpos)),
                              terrain_level=jnp.asarray(lvl), env_origin=jnp.asarray(origin))
    ts = [env_state_from_jax(s) for s in js]
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    max_force = [0.0, 0.0]
    for k in range(3):
        if k == 2:  # every env times out with a zero command: promoted
            js = [s.replace(episode_length=jnp.full((3,), e.max_episode_length, jnp.int32),
                            commands=jnp.zeros_like(s.commands))
                  for s, e in zip(js, jenv.envs)]
            ts = [env_state_from_jax(s) for s in js]
        a = rng.uniform(-0.3, 0.3, (n, 12)).astype(np.float32)
        js_prev, ts_prev = js, ts
        js, jtr = jstep(js, jnp.asarray(a))
        ts, ttr = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        if k == 2:
            assert np.asarray(jtr.done).all() and np.asarray(jtr.time_out).all()
            break
        assert not np.asarray(jtr.done).any()
        for i, (j, t) in enumerate(zip(js, ts)):
            np.testing.assert_array_equal(t.terrain_level.numpy(), np.asarray(j.terrain_level))
            np.testing.assert_allclose(t.env_origin.numpy(), j.env_origin, atol=1e-6)
            np.testing.assert_allclose(t.phys.qpos.numpy(), j.phys.qpos, atol=2e-4)
            np.testing.assert_allclose(t.phys.qvel.numpy(), j.phys.qvel, atol=5e-3)
            np.testing.assert_allclose(t.phys.contact_forces.numpy(), j.phys.contact_forces,
                                       atol=5.0)
            max_force[i] = max(max_force[i], float(np.abs(np.asarray(j.phys.contact_forces)).max()))
        np.testing.assert_allclose(ttr.obs.numpy(), jtr.obs, atol=5e-3)
        np.testing.assert_allclose(ttr.privileged_obs.numpy(), jtr.privileged_obs, atol=5e-3)
        np.testing.assert_allclose(ttr.reward.numpy(), jtr.reward, atol=1e-4)
    assert min(max_force) > 20.0, f"a robot never touched the terrain: {max_force}"

    # the promotion: level 0 -> 1 exactly; 19 and 20 re-enter at a drawn level
    for i, (j, t, jp, tp, te) in enumerate(zip(js, ts, js_prev, ts_prev, tenv.envs)):
        want_l, want_o = np.asarray(j.terrain_level), np.asarray(j.env_origin)
        got_l = t.terrain_level.numpy()
        assert want_l[0] == got_l[0] == 1
        assert ((got_l[1:] >= 0) & (got_l[1:] < te.cfg.terrain.num_rows)).all()
        np.testing.assert_allclose(t.env_origin.numpy(),
                                   origins[i][got_l, t.terrain_type.numpy()], atol=1e-6)
        np.testing.assert_allclose(t.env_origin.numpy()[0], want_o[0], atol=1e-6)
        sl = slice(3 * i, 3 * i + 3)
        level, origin = te._terrain_curriculum(
            tp, tp.phys.qpos, torch.zeros((3, 4)), ttr.done[sl], ttr.time_out[sl],
            torch.from_numpy(want_l.astype(np.int64)))
        np.testing.assert_array_equal(level.numpy(), want_l)
        np.testing.assert_allclose(origin.numpy(), want_o, atol=1e-6)
