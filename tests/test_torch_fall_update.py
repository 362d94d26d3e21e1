"""The PPO update of the production recipe's falling run, held against the
JAX package on the falling run's own rows.

`tests/data/joint_deploy_fall_update.npz` is a cut of one training
iteration of `humanoid_joint_deploy` (seed 7, 3001 iterations from scratch
on the card), recorded by `chip_smoke.py --train ... --probe 2800` deep in
the run's late fall: iteration 2801 forked from checkpoint 2800 (fork 1,
the first whose rollout holds a non-finite reset). It holds the rollout of
16 of its 4096 envs over the iteration's 60 steps (the env that reset
non-finite first, then those with the largest value and estimator
targets), their last values, the card's advantages and returns, the rows
of each minibatch of the iteration's permutation that belong to those
envs, and the net, learning rate and Adam count before the update. The
run's own net alone is 4.35 MB, so the file is 4.8 MB. The run's Adam
moments are not in it: they would add 8.7 MB to a repository of ~55 MB.
So both packages start the update from the same stand-in moments at the
recorded count (NU0), and the moments compared are those after one update
from them, not the run's own.

On those rows, in float32 on the CPU, the JAX package's `gae` and
`compute_gae` and the port's take the same advantages and returns (the
recorded dones include the non-finite resets), and one `minibatch_update`
of each package, on each minibatch's rows, gives the same loss terms, KL,
gradient norm, clip scale, learning rate, parameters and Adam moments.
On the card the nets' hidden layers ran in bf16; here both run float32,
so the recorded log-probs and values differ slightly from the CPU's
forward, as they would in either package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu import registry as jax_registry
from humanoid_gym_tpu.algo import networks as JN
from humanoid_gym_tpu.algo import ppo as JP
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo import networks as TN
from humanoid_gym_tpu_torch.algo import ppo as TP
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "joint_deploy_fall_update.npz")
TASK = "humanoid_joint_deploy"
# GAE: float32 sums of up to 60 discounted terms; the tolerance is
# relative to the largest |return| (at least 1)
GAE_TOL = 1e-5
# loss terms, gradient norm and clip scale: relative, as
# tests/test_torch_ppo.py::test_minibatch_update_matches; the KL also
# absolutely, since each of its 12 terms per row is a float32 difference
# (sigma^2 + d^2) / (2 std^2) - 0.5 of two numbers near 0.5
TERM_RTOL = 1e-4
KL_ATOL = 1e-6
# the Adam moments after the update, per tensor, relative to the tensor's
# largest |moment|: the first moment is 0.1 x the clipped gradient, which
# each package sums over the minibatch's rows in its own float32 order
MOMENT_TOL = 5e-4
# the updated parameters: within PARAM_TOL of the tensor's largest |step|
# plus one float32 spacing of the updated value (a step of ~1e-6 on a
# weight of ~0.5 rounds to a few spacings of 6e-8)
PARAM_TOL = 1e-3
# The file holds no Adam moments (they would add 8.7 MB to the 4.8 MB).
# Both packages start from first moments 0 and second moments NU0 / P in
# every element, P the parameter count: the mean square of a gradient
# clipped to norm 1 (max_grad_norm), as every probed minibatch of the run
# was. From second moments 0 the step would be lr g / (|g| + eps) ~ lr
# sign(g), and a gradient element below float32 resolution would take
# either sign in either package.
NU0 = 1.0


@pytest.fixture(scope="module")
def cut():
    z = np.load(DATA)
    return {k: z[k] for k in z.files}


def _net_state(cut):
    return {k[len("net/"):]: torch.from_numpy(v.copy()) for k, v in cut.items()
            if k.startswith("net/")}


def flax_from_state_dict(sd) -> dict:
    """The inverse of `actor_critic_from_flax`: a state dict of the port's
    ActorCritic as the JAX package's flax params."""
    p = {"std": jnp.asarray(sd["std"].numpy())}
    for head in ("actor", "critic", "estimator"):
        n = sum(1 for k in sd if k.startswith(f"{head}.layers.") and k.endswith(".weight"))
        if n:
            p[head] = {f"Dense_{i}": {
                "kernel": jnp.asarray(sd[f"{head}.layers.{i}.weight"].numpy().T),
                "bias": jnp.asarray(sd[f"{head}.layers.{i}.bias"].numpy())} for i in range(n)}
    return {"params": p}


def _configs():
    jcfg = JP.PPOConfig.from_cfg(jax_registry.get_task(TASK).make_train_cfg().algorithm)
    tcfg = TP.PPOConfig.from_cfg(registry.get_task(TASK).make_train_cfg().algorithm)
    return jcfg, tcfg


def _nets(cut):
    """The JAX and the port's ActorCritic (float32) with the cut's net."""
    sd = _net_state(cut)
    A = sd["std"].shape[0]
    hidden = lambda h: tuple(  # noqa: E731
        sd[f"{h}.layers.{i}.weight"].shape[0]
        for i in range(sum(k.startswith(f"{h}.layers.") and k.endswith("weight") for k in sd) - 1))
    est_dim = sd["estimator.layers.2.weight"].shape[0]
    jnet = JN.ActorCritic(num_actions=A, actor_hidden=hidden("actor"),
                          critic_hidden=hidden("critic"), estimator_dim=est_dim,
                          estimator_hidden=hidden("estimator"), compute_dtype="float32")
    O, P = sd["actor.layers.0.weight"].shape[1], sd["critic.layers.0.weight"].shape[1]
    tnet = TN.ActorCritic(O, P, A, hidden("actor"), hidden("critic"), compute_dtype="float32",
                          estimator_dim=est_dim, estimator_hidden=hidden("estimator"))
    tnet.load_state_dict(sd)
    return jnet, flax_from_state_dict(sd), tnet


def _train_states(cut, jnet, params, tnet):
    """The JAX and the port's train states at the cut's net, learning rate
    and Adam count; first moments 0 and second moments NU0 / (the
    parameter count) in every element."""
    lr, count = float(cut["lr"]), int(cut["opt_count"])
    nu0 = NU0 / sum(p.numel() for p in tnet.parameters())
    jts = JP.init_train_state(jax.random.PRNGKey(0), jnet, cut["obs"].shape[-1],
                              cut["priv_obs"].shape[-1], lr)
    jts = jts.replace(params=params, opt_count=jnp.asarray(count, jnp.int32),
                      opt_nu=jax.tree.map(lambda p: jnp.full_like(p, nu0), params))
    tts = TP.init_train_state(tnet, lr)
    tts.opt_count.fill_(count)
    for v in tts.opt_nu.values():
        v.fill_(nu0)
    return jts, tts


def test_the_cut_is_a_falling_iteration(cut):
    """The carry into the JAX package is exact, the cut holds the rows its
    comparisons need, and it holds a non-finite reset, among its dones."""
    sd = _net_state(cut)
    back = actor_critic_from_flax(jax.tree.map(np.asarray, flax_from_state_dict(sd)))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    k, T = cut["rewards"].shape
    assert k == 16 and T == registry.get_task(TASK).make_train_cfg().runner.num_steps_per_env
    assert cut["nonfinite"].any() and not (cut["nonfinite"] & ~cut["dones"]).any()
    assert len(cut["mb_sizes"]) == _configs()[1].num_mini_batches
    assert int(cut["mb_sizes"].sum()) == len(cut["mb_rows"]) == len(set(cut["mb_rows"]))
    assert float(cut["lr"]) > 0 and int(cut["opt_count"]) > 0


def test_gae_on_the_falling_rollout_matches_jax(cut):
    """`gae` of both packages on the cut's rewards, values, dones (the
    non-finite resets among them) and the card's last values: the same
    advantages and returns, and the card's own (the port's GAE on the
    card, in float32); the card's normalised advantages are its raw ones
    over the whole batch's mean and std. Then `compute_gae` of both (the
    critic on the last privileged obs, then the cut's own normalisation)."""
    jcfg, tcfg = _configs()
    tm = lambda x: np.ascontiguousarray(np.swapaxes(x, 0, 1))  # noqa: E731  (T, k)
    rew, val, done = tm(cut["rewards"]), tm(cut["values"]), tm(cut["dones"])
    last = cut["last_value"]
    adv, ret = TP.gae(*[torch.from_numpy(x) for x in (rew, val, done, last)], tcfg.gamma, tcfg.lam)
    jadv, jret = JP.gae(*[jnp.asarray(x) for x in (rew, val, done, last)], jcfg.gamma, jcfg.lam)
    scale = max(1.0, float(np.abs(cut["card_ret"]).max()))
    for mine, theirs, card in ((adv.numpy(), np.asarray(jadv), tm(cut["card_adv"])),
                               (ret.numpy(), np.asarray(jret), tm(cut["card_ret"]))):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=GAE_TOL * scale)
        np.testing.assert_allclose(mine, card, rtol=0, atol=GAE_TOL * scale)
    norm = (cut["card_adv"] - cut["card_adv_mean"]) / (cut["card_adv_std"] + 1e-8)
    np.testing.assert_allclose(norm, cut["card_adv_normalized"], rtol=0, atol=1e-5)

    jnet, params, tnet = _nets(cut)
    k = rew.shape[1]
    tpieces = TP.make_train_pieces(None, tnet, tcfg, k)
    jpieces = JP.make_train_pieces(None, jnet, jcfg, k)
    troll = TP.Rollout(*[None] * 6, *[torch.from_numpy(x) for x in (val, rew, done)])
    jroll = JP.Rollout(None, None, *[jnp.asarray(x) for x in (val, rew, done)])
    jts, tts = _train_states(cut, jnet, params, tnet)
    t_adv, t_ret = tpieces["compute_gae"](tts, troll, torch.from_numpy(cut["last_priv_obs"]))
    j_adv, j_ret = jpieces["compute_gae"](jts, jroll, jnp.asarray(cut["last_priv_obs"]))
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=GAE_TOL * scale)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=0, atol=1e-4)


def _minibatch(cut, i):
    """Minibatch `i`'s rows of the cut (the run's permutation order), as the
    nine arrays of an update: obs, priv, actions, log_probs, values, the
    card's normalised advantages, its returns, mu, sigma."""
    start = int(cut["mb_sizes"][:i].sum())
    rows = cut["mb_rows"][start:start + int(cut["mb_sizes"][i])]
    flat = lambda x: np.swapaxes(x, 0, 1).reshape((-1,) + x.shape[2:])  # noqa: E731  t * k + j
    return tuple(np.ascontiguousarray(flat(cut[name])[rows]) for name in (
        "obs", "priv_obs", "actions", "log_probs", "values", "card_adv_normalized", "card_ret",
        "mu", "sigma"))


@pytest.mark.parametrize("index", range(4))
def test_minibatch_update_on_the_falling_rows_matches_jax(cut, index):
    """One `minibatch_update` of each package on minibatch `index`'s rows of
    the cut, from its net, learning rate and Adam count (moments as
    `_train_states` sets them): the loss terms, KL, gradient norm and clip
    scale (TERM_RTOL, KL_ATOL), the learning rate after the KL rule (1e-6
    relative), the Adam moments (MOMENT_TOL) and the updated parameters
    (PARAM_TOL)."""
    jcfg, tcfg = _configs()
    jnet, params, tnet = _nets(cut)
    mb = _minibatch(cut, index)
    assert len(mb[0]) > 0
    count = int(cut["opt_count"])
    jts, tts = _train_states(cut, jnet, params, tnet)
    jts, jm = jax.jit(JP.make_train_pieces(None, jnet, jcfg, 1)["minibatch_update"])(
        jts, tuple(jnp.asarray(x) for x in mb))
    tts, tm = TP.make_train_pieces(None, tnet, tcfg, 1)["minibatch_update"](
        tts, tuple(torch.from_numpy(x) for x in mb))
    for k in ("value_loss", "surrogate_loss", "entropy", "estimator_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TERM_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tm["kl"]), float(jm["kl"]), rtol=TERM_RTOL, atol=KL_ATOL)
    clip = lambda g: min(1.0, tcfg.max_grad_norm / (float(g) + 1e-12))  # noqa: E731
    np.testing.assert_allclose(clip(tm["grad_norm"]), clip(jm["grad_norm"]), rtol=TERM_RTOL)
    np.testing.assert_allclose(float(tts.lr), float(jts.lr), rtol=1e-6)
    assert int(tts.opt_count) == int(jts.opt_count) == count + 1

    before = _net_state(cut)
    for what, mine, theirs in (
            ("params", tts.net.state_dict(), jts.params),
            ("opt_mu", tts.opt_mu, jts.opt_mu), ("opt_nu", tts.opt_nu, jts.opt_nu)):
        want = actor_critic_from_flax(jax.tree.map(np.asarray, theirs))
        for name, got in mine.items():
            got, ref = got.detach().numpy(), want[name].numpy()
            diff = np.abs(got - ref)
            if what == "params":
                step = float(np.abs(ref - before[name].numpy()).max())
                assert (diff <= PARAM_TOL * step + np.spacing(np.abs(ref))).all(), (
                    name, diff.max(), step)
            else:
                assert diff.max() <= MOMENT_TOL * float(np.abs(ref).max()), (what, name)
