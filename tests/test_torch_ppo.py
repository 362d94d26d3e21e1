"""The port's nets and PPO vs the JAX package: GAE, the Gaussian helpers,
weights carried over from flax, one minibatch update from identical params
and batch (float32 on the CPU), and a tiny end-to-end train iteration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.algo import networks as JN
from humanoid_gym_tpu.algo import ppo as JP
from humanoid_gym_tpu_torch.algo import networks as TN
from humanoid_gym_tpu_torch.algo import ppo as TP
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

O, P, A = 705, 219, 12
ACTOR, CRITIC = (512, 256, 128), (768, 256, 128)


def test_gae_matches():
    rng = np.random.default_rng(0)
    T, n = 7, 5
    rew = rng.normal(size=(T, n)).astype(np.float32)
    val = rng.normal(size=(T, n)).astype(np.float32)
    done = rng.uniform(size=(T, n)) < 0.2
    last = rng.normal(size=n).astype(np.float32)
    adv, ret = TP.gae(*[torch.from_numpy(x) for x in (rew, val, done, last)], 0.994, 0.9)
    jadv, jret = JP.gae(*[jnp.asarray(x) for x in (rew, val, done, last)], 0.994, 0.9)
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), jret, rtol=1e-5, atol=1e-6)


def test_gaussian_helpers_match():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(4, A)).astype(np.float32)
    std = rng.uniform(0.2, 1.5, A).astype(np.float32)
    x = rng.normal(size=(4, A)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (mean, std, x)]
    np.testing.assert_allclose(TN.normal_log_prob(*t).numpy(),
                               JN.normal_log_prob(*[jnp.asarray(v) for v in (mean, std, x)]),
                               rtol=1e-5)
    np.testing.assert_allclose(TN.normal_entropy(t[1], (4,)).numpy(),
                               JN.normal_entropy(jnp.asarray(std), (4,)), rtol=1e-6)


@pytest.fixture(scope="module")
def nets():
    jnet = JN.ActorCritic(num_actions=A, actor_hidden=ACTOR, critic_hidden=CRITIC)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, O)), jnp.zeros((1, P)))
    # a non-trivial std so the log-prob / KL terms see distinct components
    params["params"]["std"] = jnp.linspace(0.6, 1.4, A)
    tnet = TN.ActorCritic(O, P, A, ACTOR, CRITIC)
    tnet.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_converted_forward_matches(nets):
    """Same weights, same outputs: mean, std, value (f32 on the CPU)."""
    jnet, params, tnet = nets
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(8, O)).astype(np.float32)
    priv = rng.normal(size=(8, P)).astype(np.float32)
    mean, std = tnet.act(torch.from_numpy(obs))
    value = tnet.evaluate(torch.from_numpy(priv))
    jmean, jstd = jnet.apply(params, jnp.asarray(obs), method=JN.ActorCritic.act)
    jval = jnet.apply(params, jnp.asarray(priv), method=JN.ActorCritic.evaluate)
    np.testing.assert_allclose(mean.detach().numpy(), jmean, atol=1e-5)
    np.testing.assert_allclose(std.detach().numpy(), jstd, atol=1e-7)
    np.testing.assert_allclose(value.detach().numpy(), jval, atol=1e-5)


def test_compute_dtype_resolution():
    assert TN.resolve_compute_dtype("auto", torch.device("cpu")) == torch.float32
    assert TN.resolve_compute_dtype("auto", torch.device("cuda")) == torch.bfloat16
    assert TN.resolve_compute_dtype("float32", torch.device("cuda")) == torch.float32


def _batch(rng, n):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(n, O), f(n, P), f(n, A), f(n) - 15.0, f(n), f(n), f(n),
            f(n, A) * 0.3, np.abs(f(n, A)) * 0.3 + 0.7)


@pytest.mark.parametrize("n_updates", [1, 2])
def test_minibatch_update_matches(nets, n_updates):
    """Minibatch updates (loss, grad, KL-adaptive lr, grad clip, Adam) from
    converted params and an identical batch. Metrics within relative 1e-4.
    Params: lr 1e-3 moves them ~1e-3; 99.9% of elements agree within 1e-6
    and every element within 0.1 lr — where a gradient element is near
    Adam's eps (1e-8), the first steps' update lr g / (|g| + eps) turns the
    last bits of g into a fraction of lr."""
    jnet, params, _ = nets
    cfg = dict(learning_rate=1e-3, num_steps_per_env=4)
    jcfg, tcfg = JP.PPOConfig(**cfg), TP.PPOConfig(**cfg)
    jts = JP.init_train_state(jax.random.PRNGKey(0), jnet, O, P, 1e-3).replace(params=params)
    tnet = TN.ActorCritic(O, P, A, ACTOR, CRITIC)
    tnet.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray, params)))
    tts = TP.init_train_state(tnet, 1e-3)
    jupd = jax.jit(JP.make_train_pieces(None, jnet, jcfg, 8)["minibatch_update"])
    tupd = TP.make_train_pieces(None, tnet, tcfg, 8)["minibatch_update"]
    rng = np.random.default_rng(3)
    for _ in range(n_updates):
        mb = _batch(rng, 64)
        jts, jm = jupd(jts, tuple(jnp.asarray(x) for x in mb))
        tts, tm = tupd(tts, tuple(torch.from_numpy(x) for x in mb))
        for k in ("value_loss", "surrogate_loss", "entropy", "kl", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(tts.lr), float(jts.lr), rtol=1e-6)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jts.params))
    for name, p in tts.net.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= 1e-4, (name, diff.max())
        assert np.mean(diff <= 1e-6) >= 0.999, (name, np.mean(diff <= 1e-6))


def test_train_iter_runs_on_cpu():
    """make_train_iter at N=8, T=4 through the env's plain physics: finite
    losses, the iteration counter moves, the params change."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg, XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = "mega"
    n = 8
    env = make_env(cfg, num_envs=n, device="cpu", seed=0)
    tc = XBotLCfgPPO()
    net = TN.ActorCritic(cfg.env.num_observations, cfg.env.num_privileged_obs, 12,
                         tuple(tc.policy.actor_hidden_dims), tuple(tc.policy.critic_hidden_dims))
    pc = TP.PPOConfig.from_cfg(tc.algorithm)
    pc.num_steps_per_env = 4
    ts = TP.init_train_state(net, pc.learning_rate)
    before = net.actor.layers[0].weight.detach().clone()
    it = TP.make_train_iter(env, net, pc, n)
    state = env.init_state()
    obs = torch.zeros((n, cfg.env.num_observations))
    priv = torch.zeros((n, cfg.env.num_privileged_obs))
    gen = torch.Generator()
    gen.manual_seed(0)
    for _ in range(2):
        ts, state, obs, priv, metrics = it(ts, state, obs, priv, gen)
    assert ts.iteration == 2 and ts.opt_count == 2 * pc.num_learning_epochs * pc.num_mini_batches
    for k in ("value_loss", "surrogate_loss", "entropy", "kl", "grad_norm", "mean_step_reward"):
        assert np.isfinite(float(metrics[k])), k
    assert obs.shape == (n, 705) and torch.isfinite(obs).all()
    assert not torch.equal(before, net.actor.layers[0].weight)


def test_estimator_head_trains():
    """Port of tests/test_ppo.py:87: the estimator head exists, its
    gradient flows, and its supervised loss on a fixed batch falls below
    half its first value in 50 Adam steps."""
    net = TN.ActorCritic(O, P, A, ACTOR, CRITIC, estimator_dim=3)
    assert any(k.startswith("estimator.") for k in net.state_dict())
    assert net.estimate(torch.zeros((2, O))).shape == (2, 3)
    gen = torch.Generator().manual_seed(0)
    obs = torch.randn((64, O), generator=gen)
    target = obs[:, :3] * 0.5  # recoverable mapping
    opt = torch.optim.Adam(net.estimator.parameters(), lr=1e-3)
    losses = []
    for _ in range(51):
        loss = torch.mean(torch.square(net.estimate(obs) - target))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.5 * losses[0]


@pytest.fixture(scope="module")
def est_nets():
    """The JAX ActorCritic with an estimator head (init from PRNGKey(5))
    and the port's net with the same weights."""
    jnet = JN.ActorCritic(num_actions=A, estimator_dim=3, compute_dtype="float32")
    params = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, O)), jnp.zeros((1, P)))
    tnet = TN.ActorCritic(O, P, A, ACTOR, CRITIC, estimator_dim=3)
    tnet.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_estimator_loss_matches_jax(est_nets):
    """Converted params and one batch: the estimate within 1e-5, and one
    minibatch update with estimator_coef 1.0 gives the JAX package's
    estimator_loss and total-loss metrics (relative 1e-4) and moves the
    estimator's weights as JAX moves them (within 1e-4); with coef 0 the
    loss term is off (metric 0) and the head gets no update."""
    jnet, params, tnet = est_nets
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(16, O)).astype(np.float32)
    got = tnet.estimate(torch.from_numpy(obs)).detach().numpy()
    want = jnet.apply(params, jnp.asarray(obs), method=JN.ActorCritic.estimate)
    np.testing.assert_allclose(got, want, atol=1e-5)

    for coef in (1.0, 0.0):
        cfg = dict(learning_rate=1e-3, num_steps_per_env=4, estimator_coef=coef)
        jcfg, tcfg = JP.PPOConfig(**cfg), TP.PPOConfig(**cfg)
        assert tcfg.estimator_slice == jcfg.estimator_slice == (199, 202)
        jts = JP.init_train_state(jax.random.PRNGKey(0), jnet, O, P, 1e-3).replace(params=params)
        net = TN.ActorCritic(O, P, A, ACTOR, CRITIC, estimator_dim=3)
        net.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray, params)))
        tts = TP.init_train_state(net, 1e-3)
        before = net.estimator.layers[0].weight.detach().clone()
        mb = _batch(np.random.default_rng(8), 64)
        jts, jm = jax.jit(JP.make_train_pieces(None, jnet, jcfg, 8)["minibatch_update"])(
            jts, tuple(jnp.asarray(x) for x in mb))
        tts, tm = TP.make_train_pieces(None, net, tcfg, 8)["minibatch_update"](
            tts, tuple(torch.from_numpy(x) for x in mb))
        for k in ("estimator_loss", "value_loss", "surrogate_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
        want = actor_critic_from_flax(jax.tree.map(np.asarray, jts.params))
        for name, p in tts.net.state_dict().items():
            if name.startswith("estimator."):
                assert np.abs(p.numpy() - want[name].numpy()).max() <= 1e-4, name
        moved = float((net.estimator.layers[0].weight.detach() - before).abs().max())
        if coef:
            assert float(tm["estimator_loss"]) > 0.0 and moved > 1e-5
        else:
            assert float(tm["estimator_loss"]) == 0.0 and moved == 0.0
