"""The port's OnPolicyRunner on the CPU at N = 8: it adds nothing to
`make_train_iter` numerically, logs the reference's scalar names in
iteration order, and its checkpoints resume the train state, the env state
(when the env count matches) and the net's compute dtype — ports of the
JAX package's tests/test_resume_env_state.py. One test runs the JAX
package's runner beside it from shared weights, env state and observations
and compares the logged losses and the resumed state."""

import ast
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import humanoid_gym_tpu.runner.on_policy_runner as jax_runner_module
from humanoid_gym_tpu.config.xbotl import XBotLCfg as JaxCfg
from humanoid_gym_tpu.config.xbotl import XBotLCfgPPO as JaxCfgPPO
from humanoid_gym_tpu.envs import make_env as jax_make_env
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax, env_state_from_jax
from humanoid_gym_tpu_torch.algo.networks import ActorCritic
from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
from humanoid_gym_tpu_torch.runner import OnPolicyRunner

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("HGT_WANDB", "0")


def _train_cfg():
    tcfg = XBotLCfgPPO()
    tcfg.runner.num_steps_per_env = 2
    tcfg.runner.save_interval = 100
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 1
    return tcfg


def _env(n=8, seed=0, solver="apgd"):
    def ov(cfg):
        cfg.sim.solver.solver_type = solver

    env, _ = registry.make_env("humanoid_ppo", num_envs=n, cfg_overrides=ov, device="cpu",
                               seed=seed)
    return env


def test_learn_equals_hand_calls_of_train_iter(tmp_path):
    """`learn(2)` leaves exactly the train state, env state and obs that two
    hand calls of `make_train_iter` from the same seeds leave (bitwise: the
    same operations in the same order), and the double-buffered fetch logs
    iterations 0 and 1 in order."""
    tcfg = _train_cfg()
    runner = OnPolicyRunner(_env(), tcfg, log_dir=str(tmp_path / "run"), seed=5)
    runner.learn(2)

    env = _env()
    ec = env.cfg.env
    net = ActorCritic(ec.num_observations, ec.num_privileged_obs, ec.num_actions,
                      actor_hidden=tuple(tcfg.policy.actor_hidden_dims),
                      critic_hidden=tuple(tcfg.policy.critic_hidden_dims),
                      init_noise_std=tcfg.policy.init_noise_std, seed=5)
    pcfg = PPOConfig.from_cfg(tcfg.algorithm)
    pcfg.num_steps_per_env = 2
    ts = init_train_state(net, pcfg.learning_rate)
    gen = torch.Generator()
    gen.manual_seed(5)
    state, obs, priv = env.reset_all()
    it = make_train_iter(env, net, pcfg, 8)
    for _ in range(2):
        ts, state, obs, priv, _ = it(ts, state, obs, priv, gen)

    for (name, p), (_, q) in zip(runner.net.state_dict().items(), net.state_dict().items()):
        assert torch.equal(p, q), name
    assert runner.train_state.opt_count == ts.opt_count == 4
    assert runner.train_state.iteration == ts.iteration == 2
    assert float(runner.train_state.lr) == float(ts.lr)
    assert torch.equal(runner.env_state.phys.qpos, state.phys.qpos)
    assert torch.equal(runner.obs, obs) and torch.equal(runner.priv_obs, priv)
    assert runner.current_learning_iteration == 2 and runner.tot_timesteps == 2 * 2 * 8

    lines = [json.loads(ln) for ln in open(tmp_path / "run" / "metrics.jsonl")]
    assert [ln["iter"] for ln in lines] == [0, 1]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    ckpts = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "run" / "model_*.ckpt")))
    assert ckpts == ["model_0.ckpt", "model_2.ckpt"]


def _parity_cfgs(env_cfg, train_cfg, n):
    """The env without the draws that the two packages make from different
    generators (observation noise, pushes, action delay and noise), one
    minibatch and one epoch (no minibatch permutation), and the action noise
    at the nets' floor of 1e-3: the sampled actions of the two packages then
    differ by about 1e-3 of an action unit and everything else is shared."""
    env_cfg.env.num_envs = n
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.action_delay = 0.0
    env_cfg.domain_rand.action_noise = 0.0
    env_cfg.sim.solver.solver_type = "apgd"
    train_cfg.runner.num_steps_per_env = 2
    train_cfg.runner.save_interval = 100
    train_cfg.algorithm.num_mini_batches = 1
    train_cfg.algorithm.num_learning_epochs = 1
    train_cfg.policy.init_noise_std = 1e-3
    return env_cfg, train_cfg


def _assert_env_states_close(t_state, t_obs, t_priv, j_state, j_obs, j_priv):
    """The band the 1e-3 action noise leaves after two policy steps: qpos
    1e-3, qvel 0.1 rad/s (joint velocities there reach 2 rad/s), obs and
    privileged obs 2e-2, commands 1e-4 (the yaw command follows the
    heading); what no action touches is equal."""
    np.testing.assert_allclose(t_state.phys.qpos.numpy(), j_state.phys.qpos, atol=1e-3)
    np.testing.assert_allclose(t_state.phys.qvel.numpy(), j_state.phys.qvel, atol=0.1)
    np.testing.assert_allclose(t_obs.numpy(), j_obs, atol=2e-2)
    np.testing.assert_allclose(t_priv.numpy(), j_priv, atol=2e-2)
    np.testing.assert_array_equal(t_state.episode_length.numpy(), j_state.episode_length)
    np.testing.assert_allclose(t_state.commands.numpy(), j_state.commands, atol=1e-4)
    np.testing.assert_array_equal(t_state.phys.friction.numpy(), j_state.phys.friction)
    np.testing.assert_allclose(t_state.episode_sums.numpy(), j_state.episode_sums, atol=1e-3)


def test_iteration_and_resume_match_the_jax_runner(tmp_path):
    """Both packages' runners from the same weights (converted from flax),
    the same env state and the same observations: one `learn(1)` logs the
    same losses and leaves the same env state within the band of the action
    noise, and a fresh runner of each package that loads the final
    checkpoint resumes at the same iteration, learning rate and optimizer
    count with that env state restored."""
    from humanoid_gym_tpu.runner import OnPolicyRunner as JaxRunner

    n = 8
    jcfg, jtcfg = _parity_cfgs(JaxCfg(), JaxCfgPPO(), n)
    jenv = jax_make_env(jcfg)
    run_j = JaxRunner(jenv, jtcfg, log_dir=str(tmp_path / "j"), seed=5)

    def ov(cfg):
        _parity_cfgs(cfg, XBotLCfgPPO(), n)

    tenv, _ = registry.make_env("humanoid_ppo", num_envs=n, cfg_overrides=ov, device="cpu", seed=0)
    ttcfg = _parity_cfgs(tenv.cfg, XBotLCfgPPO(), n)[1]
    run_t = OnPolicyRunner(tenv, ttcfg, log_dir=str(tmp_path / "t"), seed=5)
    run_t.net.load_state_dict(
        actor_critic_from_flax(jax.tree.map(np.asarray, run_j.train_state.params)))
    run_t.env_state = env_state_from_jax(run_j.env_state)
    run_t.obs = torch.from_numpy(np.array(run_j.obs))
    run_t.priv_obs = torch.from_numpy(np.array(run_j.priv_obs))

    run_j.learn(1)
    run_t.learn(1)
    line_j = json.loads(open(tmp_path / "j" / "metrics.jsonl").readline())
    line_t = json.loads(open(tmp_path / "t" / "metrics.jsonl").readline())
    assert list(line_t) == list(line_j)
    # measured agreement is about ten times tighter than each band
    np.testing.assert_allclose(line_t["Loss/value_function"], line_j["Loss/value_function"],
                               rtol=2e-3)
    np.testing.assert_allclose(line_t["Train/mean_step_reward"], line_j["Train/mean_step_reward"],
                               rtol=2e-4)
    np.testing.assert_allclose(line_t["Loss/entropy"], line_j["Loss/entropy"], rtol=1e-6)
    np.testing.assert_allclose(line_t["Loss/kl"], line_j["Loss/kl"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(line_t["Loss/learning_rate"], line_j["Loss/learning_rate"],
                               rtol=1e-6)
    np.testing.assert_allclose(line_t["Policy/mean_noise_std"], line_j["Policy/mean_noise_std"],
                               rtol=1e-2)
    # the normalised advantages of the one full batch sum to zero in both
    assert abs(line_t["Loss/surrogate"]) < 1e-4 and abs(line_j["Loss/surrogate"]) < 1e-4
    for k in ("Train/mean_reward", "Train/mean_episode_length", "Train/nonfinite_resets",
              "Episode/terrain_level", "Loss/estimator"):
        assert line_t[k] == line_j[k] == 0.0, k
    _assert_env_states_close(run_t.env_state, run_t.obs, run_t.priv_obs,
                             run_j.env_state, run_j.obs, run_j.priv_obs)

    # resume: fresh runners from another seed load their package's checkpoint
    res_j = JaxRunner(jenv, jtcfg, log_dir=None, seed=123)
    res_t = OnPolicyRunner(tenv, ttcfg, log_dir=None, seed=123)
    assert not np.allclose(res_t.env_state.phys.qpos.numpy(), run_t.env_state.phys.qpos.numpy())
    res_j.load(str(tmp_path / "j" / "model_1.ckpt"))
    res_t.load(str(tmp_path / "t" / "model_1.ckpt"))
    assert res_t.current_learning_iteration == res_j.current_learning_iteration == 1
    assert res_t.train_state.iteration == int(res_j.train_state.iteration) == 1
    assert res_t.train_state.opt_count == int(res_j.train_state.opt_count) == 1
    np.testing.assert_allclose(float(res_t.train_state.lr), float(res_j.train_state.lr), rtol=1e-6)
    # each restores exactly what it saved, so the two restored states stand
    # in the same band as the saved ones
    np.testing.assert_array_equal(np.asarray(res_j.env_state.phys.qpos),
                                  np.asarray(run_j.env_state.phys.qpos))
    assert torch.equal(res_t.env_state.phys.qpos, run_t.env_state.phys.qpos)
    _assert_env_states_close(res_t.env_state, res_t.obs, res_t.priv_obs,
                             res_j.env_state, res_j.obs, res_j.priv_obs)


def _reference_scalar_names():
    """The keys of the `scalars` dict in the JAX runner's `_log`."""
    tree = ast.parse(open(jax_runner_module.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_log":
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign) and getattr(sub.targets[0], "id", "") == "scalars"
                        and isinstance(sub.value, ast.Dict)):
                    return [k.value for k in sub.value.keys]
    raise AssertionError("scalars dict not found in the reference runner")


def test_log_scalar_names_equal_the_reference(tmp_path, capsys):
    """metrics.jsonl carries the reference runner's scalar names, in its
    order, plus `Episode/rew_<term>` per reward term once an episode ended;
    the console line has the reference's fields."""
    want = _reference_scalar_names()
    assert len(want) == 14 and "Loss/value_function" in want
    env = _env()
    runner = OnPolicyRunner(env, _train_cfg(), log_dir=str(tmp_path / "run"), seed=1)
    # end every episode inside the first rollout, so the per-term means appear
    runner.env_state = runner.env_state.replace(
        episode_length=torch.full((8,), env.max_episode_length, dtype=torch.int32))
    runner.learn(1)
    line = json.loads(open(tmp_path / "run" / "metrics.jsonl").readline())
    keys = [k for k in line if k != "iter"]
    assert keys[:len(want)] == want
    assert keys[len(want):] == [f"Episode/rew_{n}" for n in env.reward_names]
    out = capsys.readouterr().out
    for field in ("it 0/1", "fps", "rew", "len", "vloss", "lr", "std", "eta"):
        assert field in out


def test_env_state_survives_resume(tmp_path):
    """The final checkpoint bundles the env state and its obs; a runner
    built from another seed restores them, the train state and the
    iteration count."""
    tcfg = _train_cfg()
    run_a = OnPolicyRunner(_env(seed=0), tcfg, log_dir=str(tmp_path / "a"), seed=5)
    run_a.learn(2, init_at_random_ep_len=True)
    qpos_a = run_a.env_state.phys.qpos.clone()
    ep_len_a = run_a.env_state.episode_length.clone()
    assert int(ep_len_a.max()) > 2  # the random episode lengths were applied
    ckpts = sorted(glob.glob(str(tmp_path / "a" / "model_*.ckpt")),
                   key=lambda p: int(p.split("_")[-1].split(".")[0]))

    run_b = OnPolicyRunner(_env(seed=7), tcfg, log_dir=None, seed=123)
    assert not torch.allclose(run_b.env_state.phys.qpos, qpos_a)
    w_b = run_b.net.actor.layers[0].weight.detach().clone()
    run_b.load(ckpts[-1])
    assert torch.equal(run_b.env_state.phys.qpos, qpos_a)
    assert torch.equal(run_b.env_state.episode_length, ep_len_a)
    assert torch.equal(run_b.env_state.phys.friction, run_a.env_state.phys.friction)
    assert torch.equal(run_b.obs, run_a.obs) and torch.equal(run_b.priv_obs, run_a.priv_obs)
    assert not torch.equal(run_b.net.actor.layers[0].weight, w_b)
    for (name, p), (_, q) in zip(run_b.net.state_dict().items(), run_a.net.state_dict().items()):
        assert torch.equal(p, q), name
    for k in run_a.train_state.opt_mu:
        assert torch.equal(run_b.train_state.opt_mu[k], run_a.train_state.opt_mu[k])
        assert torch.equal(run_b.train_state.opt_nu[k], run_a.train_state.opt_nu[k])
    assert run_b.train_state.opt_count == run_a.train_state.opt_count
    assert float(run_b.train_state.lr) == float(run_a.train_state.lr)
    assert run_b.current_learning_iteration == 2
    # the resumed runner trains on; the periodic checkpoint has no env state
    run_b.learn(1)
    assert run_b.current_learning_iteration == 3
    assert "env_state" not in torch.load(ckpts[0], weights_only=True)
    # load_optimizer=False keeps the fresh Adam moments
    run_c = OnPolicyRunner(_env(seed=0), tcfg, log_dir=None, seed=1)
    run_c.load(ckpts[-1], load_optimizer=False)
    assert run_c.train_state.opt_count == 0
    assert all(float(v.abs().max()) == 0.0 for v in run_c.train_state.opt_mu.values())


def test_env_state_skipped_on_shape_mismatch(tmp_path, capsys):
    """A runner of another env count loading a bundled checkpoint keeps its
    own env state; the params and the iteration count still load."""
    tcfg = _train_cfg()
    run_a = OnPolicyRunner(_env(), tcfg, log_dir=str(tmp_path / "a"), seed=5)
    run_a.learn(1)
    ckpt = str(tmp_path / "a" / "model_1.ckpt")
    run_c = OnPolicyRunner(_env(n=4), _train_cfg(), log_dir=None, seed=5)
    qpos_c = run_c.env_state.phys.qpos.clone()
    run_c.load(ckpt)
    assert torch.equal(run_c.env_state.phys.qpos, qpos_c)
    assert run_c.obs.shape[0] == 4
    assert run_c.current_learning_iteration == run_a.current_learning_iteration == 1
    assert "env state in ckpt not restored" in capsys.readouterr().out


def test_ckpt_records_and_honors_compute_dtype(tmp_path, capsys):
    """Checkpoints record the resolved net compute dtype ("auto" is f32 on
    the CPU, bf16 on the card); loading honours it unless the task pins
    one."""
    tcfg = _train_cfg()
    env = _env()
    run_a = OnPolicyRunner(env, tcfg, log_dir=str(tmp_path / "a"), seed=5)
    run_a.learn(1)
    payload = torch.load(str(tmp_path / "a" / "model_1.ckpt"), weights_only=True)
    assert payload["compute_dtype"] == "float32"

    run_b = OnPolicyRunner(env, tcfg, log_dir=None, seed=1)
    run_b._honor_ckpt_dtype("bfloat16")
    assert run_b.net.compute_dtype == "bfloat16"
    assert run_b.net.actor.compute_dtype == run_b.net.critic.compute_dtype == "bfloat16"
    obs = torch.randn((3, env.cfg.env.num_observations))
    f32 = OnPolicyRunner(env, tcfg, log_dir=None, seed=1).get_inference_policy()(obs)
    bf16 = run_b.get_inference_policy()(obs)
    assert bf16.dtype == torch.float32 and not torch.equal(bf16, f32)
    assert float((bf16 - f32).abs().max()) < 0.1

    tcfg2 = _train_cfg()
    tcfg2.policy.compute_dtype = "float32"
    run_c = OnPolicyRunner(env, tcfg2, log_dir=None, seed=1)
    run_c._honor_ckpt_dtype("bfloat16")
    assert run_c.net.compute_dtype == "float32"
    assert "WARNING" in capsys.readouterr().out

    run_d = OnPolicyRunner(env, tcfg, log_dir=None, seed=1)
    run_d._honor_ckpt_dtype("float32")
    run_d._honor_ckpt_dtype(None)
    assert run_d.net.compute_dtype == "auto"


def test_estimator_head_is_refused(tmp_path):
    """The runner builds the estimator head that `policy.estimator_dim`
    asks for (hidden dims from `estimator_hidden_dims`), and a runner
    without one refuses a checkpoint that carries one: the strict
    state-dict load names the estimator's keys."""
    tcfg = _train_cfg()
    tcfg.policy.estimator_dim = 3
    run_e = OnPolicyRunner(_env(n=2), tcfg, log_dir=None)
    assert [lin.out_features for lin in run_e.net.estimator.layers] == [256, 128, 3]
    path = str(tmp_path / "e.ckpt")
    run_e.save(path)
    run_plain = OnPolicyRunner(_env(n=2), _train_cfg(), log_dir=None)
    with pytest.raises(RuntimeError, match="estimator"):
        run_plain.load(path)


def test_profile_dir_traces_the_second_iteration(tmp_path, monkeypatch, capsys):
    """HGT_PROFILE_DIR (the JAX runner's on_policy_runner.py:209-243): learn(2)
    writes one Chrome trace, of its second iteration, into the directory and
    prints where; the run trains exactly as it does without the variable."""
    tcfg = _train_cfg()
    prof_dir = tmp_path / "prof"
    nets = {}
    for name in ("plain", "profiled"):
        if name == "profiled":
            monkeypatch.setenv("HGT_PROFILE_DIR", str(prof_dir))
        else:
            monkeypatch.delenv("HGT_PROFILE_DIR", raising=False)
        runner = OnPolicyRunner(_env(n=4), tcfg, log_dir=None, seed=1)
        runner.learn(2)
        nets[name] = runner.net.state_dict()
    assert os.listdir(prof_dir) == ["trace_iter1.json"]
    events = json.load(open(prof_dir / "trace_iter1.json"))["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert f"[profiler] trace written to {prof_dir / 'trace_iter1.json'}" in capsys.readouterr().out
    for k, v in nets["plain"].items():
        assert torch.equal(v, nets["profiled"][k]), k
