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
