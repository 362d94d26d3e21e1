"""graft_entry_torch.py, the port's counterpart of __graft_entry__.py, on
the CPU: `entry()`'s policy + env step against the JAX package's `entry()`
on the same parameters and state, and `dryrun_multichip(2)` over two gloo
ranks against one process running the same iteration.

Both `entry()`s build their config with their module's `_small_cfg`; the
comparison swaps in a noise-free one (noise, pushes, action delay and
action noise off, as tests/test_torch_env.py compares steps), so no random
draw of either package reaches the compared step."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as JG  # noqa: E402
import graft_entry_torch as TG  # noqa: E402
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax, env_state_from_jax  # noqa: E402

torch.set_num_threads(1)


def _quiet(small_cfg):
    def make(num_envs):
        cfg = small_cfg(num_envs)
        cfg.noise.add_noise = False
        cfg.domain_rand.push_robots = False
        cfg.domain_rand.action_delay = 0.0
        cfg.domain_rand.action_noise = 0.0
        return cfg

    return make


def test_entry_matches_jax_entry(monkeypatch):
    """The 16-env forward step (actor mean -> env.step, critic value) from
    JAX entry()'s parameters and initial state, both with the config's own
    solver (apgd, 8 iterations). Tolerances as tests/test_torch_env.py's
    step comparison: obs and privileged obs 5e-3, reward 1e-4; the value
    (the same critic on zero inputs) 1e-5."""
    monkeypatch.setattr(JG, "_small_cfg", _quiet(JG._small_cfg))
    monkeypatch.setattr(TG, "_small_cfg", _quiet(TG._small_cfg))
    jfn, (params, jstate, jobs, jpriv) = JG.entry()
    want = jax.jit(jfn)(params, jstate, jobs, jpriv)

    fn, (net, _, obs, priv) = TG.entry(device="cpu")
    assert fn.env.cfg.sim.solver.solver_type == "apgd" and not fn.env.cfg.noise.add_noise
    net.load_state_dict(actor_critic_from_flax(jax.device_get(params)))
    state = env_state_from_jax(jstate)
    got = fn(net, state, obs, priv)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w, tol in zip(got, want, (5e-3, 5e-3, 1e-4, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    # fn.step is the same step, with the new state
    new_state, again = fn.step(net, state, obs, priv)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert new_state.phys.qpos.shape == (TG.NUM_ENVS, 19)


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TG.entry()


def _one_process_update(results):
    """The dryrun's iteration in one process over the global batch: each
    rank's 2-env rollout, drawn as that rank draws it (its env's seed and
    offset, its action-noise seed), joined along the env axis, then GAE
    and the update over all 4 envs with the run's permutation seed."""
    from humanoid_gym_tpu_torch.algo import ppo as TP
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg, XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.parallel import EnvGroup, rank_seed

    world = len(results)
    cfg = XBotLCfg()
    cfg.env.num_envs = 2 * world
    cfg.sim.solver.solver_type = "mega"
    net = actor_critic_from_cfg(cfg.env, XBotLCfgPPO().policy, seed=0)
    algo = TP.PPOConfig()
    algo.num_steps_per_env, algo.num_mini_batches, algo.num_learning_epochs = 2, 2, 1
    init = {k: v.clone() for k, v in net.state_dict().items()}
    ts = TP.init_train_state(net, algo.learning_rate)
    rolls, lasts = [], []
    for r in range(world):
        group = EnvGroup(rank=r, world=world, device=torch.device("cpu"), backend="gloo")
        env = make_env(cfg, num_envs=2, device="cpu", seed=rank_seed(0, group), env_offset=2 * r,
                       num_envs_global=2 * world)
        gen = torch.Generator()
        gen.manual_seed(rank_seed(1, group))
        obs = torch.zeros((2, cfg.env.num_observations))
        priv = torch.zeros((2, cfg.env.num_privileged_obs))
        rollout = TP.make_train_pieces(env, net, algo, 2)["rollout_phase"]
        _, _, last_priv, roll, _ = rollout(ts, env.init_state(), obs, priv, gen)
        rolls.append(roll)
        lasts.append(last_priv)
    roll = TP.Rollout(*[torch.cat(parts, dim=1) for parts in zip(*rolls)])
    pieces = TP.make_train_pieces(None, net, algo, 2 * world, perm_seed=0)
    adv, ret = pieces["compute_gae"](ts, roll, torch.cat(lasts))
    perm_gen = torch.Generator()
    perm_gen.manual_seed(TP.permutation_seed(0, 0))
    ts, metrics = pieces["update_phase"](ts, roll, adv, ret, perm_gen)
    return ts.net.state_dict(), metrics, init


def test_dryrun_multichip_two_gloo_ranks(capsys):
    """dryrun_multichip(2) on the CPU: the JAX package's line, a finite
    value loss equal on both ranks, the replicated update bit-equal across
    the ranks, and within 5e-6 of one process running the same iteration
    over the whole batch (the ranks' rollouts, GAE over 4 envs, the update
    with the run's permutation)."""
    results = TG.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out
    assert "dryrun_multichip(2): ok — solver=mega" in line and "value_loss=" in line
    assert [r["rank"] for r in results] == [0, 1]
    assert np.isfinite(results[0]["value_loss"])
    assert results[0]["value_loss"] == results[1]["value_loss"]
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
    want, metrics, init = _one_process_update(results)
    # two Adam steps at the recipe's learning rate (1e-5) move the weights
    # by ~2e-5: more than the tolerance, so a rank that skipped its update fails
    assert max(float((want[k] - init[k]).abs().max()) for k in want) > 1e-5
    for k, v in results[0]["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-6, err_msg=k)
    np.testing.assert_allclose(results[0]["value_loss"], float(metrics["value_loss"]), rtol=1e-5)
