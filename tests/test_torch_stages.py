"""The pieces the measurement tools time, held against the JAX package on
the CPU: the train iteration's stage entries (`make_loss_fn` with its
gradient, `actor_apply`, `critic_apply`) from converted params and one
numpy batch, and the AD form of the bias forces (`bias_forces`,
`qpos_derivative`) against the JAX package's and the port's explicit form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_state
from humanoid_gym_tpu.algo import networks as JN
from humanoid_gym_tpu.algo import ppo as JP
from humanoid_gym_tpu.physics import dynamics as JD
from humanoid_gym_tpu.physics import kinematics as JK
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu_torch.algo import networks as TN
from humanoid_gym_tpu_torch.algo import ppo as TP
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax
from humanoid_gym_tpu_torch.physics import dynamics as TD
from humanoid_gym_tpu_torch.physics import kinematics as TK
from humanoid_gym_tpu_torch.physics import step as TS
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

O, P, A = 705, 219, 12
ACTOR, CRITIC = (512, 256, 128), (768, 256, 128)
ROWS = 16


@pytest.fixture(scope="module", params=[0, 3], ids=["no-estimator", "estimator"])
def pieces(request):
    """JAX and port nets with the same weights, and each package's stage
    entries for a config whose estimator term is on when the net has the
    head."""
    est = request.param
    jnet = JN.ActorCritic(num_actions=A, actor_hidden=ACTOR, critic_hidden=CRITIC,
                          estimator_dim=est, compute_dtype="float32")
    params = jnet.init(jax.random.PRNGKey(11), jnp.zeros((1, O)), jnp.zeros((1, P)))
    params["params"]["std"] = jnp.linspace(0.6, 1.4, A)
    tnet = TN.ActorCritic(O, P, A, ACTOR, CRITIC, estimator_dim=est)
    tnet.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray, params)))
    cfg = dict(num_steps_per_env=4, estimator_coef=1.0 if est else 0.0)
    jp = JP.make_train_pieces(None, jnet, JP.PPOConfig(**cfg), 8)
    tp = TP.make_train_pieces(None, tnet, TP.PPOConfig(**cfg), 8)
    return jp, params, tp, tnet


def _batch(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(ROWS, O), f(ROWS, P), f(ROWS, A), f(ROWS) - 15.0, f(ROWS), f(ROWS), f(ROWS),
            f(ROWS, A) * 0.3, np.abs(f(ROWS, A)) * 0.3 + 0.7)


def test_stage_entries_are_exposed():
    d = TP.make_train_pieces(None, TN.ActorCritic(O, P, A), TP.PPOConfig(num_steps_per_env=4), 8)
    for k in ("train_iter", "rollout_phase", "compute_gae", "update_phase", "permute_batch",
              "minibatch_update", "make_loss_fn", "actor_apply", "critic_apply"):
        assert callable(d[k]), k


def test_actor_and_critic_apply_match(pieces):
    """actor_apply / critic_apply against the JAX package's: mean, std,
    value within 1e-6 (relative to the outputs' scale of ~1)."""
    jp, params, tp, tnet = pieces
    mb = _batch(1)
    mean, std = tp["actor_apply"](tnet, torch.from_numpy(mb[0]))
    value = tp["critic_apply"](tnet, torch.from_numpy(mb[1]))
    jmean, jstd = jp["actor_apply"](params, jnp.asarray(mb[0]))
    jvalue = jp["critic_apply"](params, jnp.asarray(mb[1]))
    np.testing.assert_allclose(mean.detach().numpy(), jmean, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(std.detach().numpy(), jstd, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(value.detach().numpy(), jvalue, atol=1e-6, rtol=1e-6)


def test_make_loss_fn_and_its_gradient_match(pieces):
    """The exposed make_loss_fn gives the JAX function's value, the
    mean-form total and its aux terms (surrogate, value, entropy,
    estimator, KL), within 1e-5 relative; torch.autograd.grad of it equals
    jax.grad within 1e-5 relative to each tensor's largest entry."""
    jp, params, tp, tnet = pieces
    mb = _batch(2)
    jloss = jp["make_loss_fn"](tuple(jnp.asarray(x) for x in mb))
    (jtotal, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    total, aux = tp["make_loss_fn"](tuple(torch.from_numpy(x) for x in mb))(tnet)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for name, got, want in zip(("surrogate", "value", "entropy", "estimator", "kl"), aux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7, err_msg=name)
    names, ps = zip(*tnet.named_parameters())
    grads = torch.autograd.grad(total, ps, materialize_grads=True)
    assert all(p.grad is None for p in ps)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, name


def test_group_grad_norms_match_jax_subtrees(pieces):
    """`group_grad_norms` (the update probe's reading) of the exposed loss:
    each group's norm equals the global norm of the JAX gradient's subtree
    (actor with std, critic, estimator where the net has one) within 1e-5
    relative, and the groups' norms add up, in squares, to the global norm
    `minibatch_update` clips (the JAX update's, 1e-5 relative); the update's
    "minibatches" entry is exposed."""
    import optax

    jp, params, tp, tnet = pieces
    mb = _batch(4)
    jgrads = jax.grad(lambda p: jp["make_loss_fn"](tuple(jnp.asarray(x) for x in mb))(p)[0])(
        params)["params"]
    total, _ = tp["make_loss_fn"](tuple(torch.from_numpy(x) for x in mb))(tnet)
    got = {k: float(v) for k, v in TP.group_grad_norms(tnet, total).items()}
    want = {"actor": float(optax.global_norm((jgrads["actor"], jgrads["std"]))),
            "critic": float(optax.global_norm(jgrads["critic"]))}
    if "estimator" in jgrads:
        want["estimator"] = float(optax.global_norm(jgrads["estimator"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.sqrt(sum(v * v for v in got.values())),
                               float(optax.global_norm(jgrads)), rtol=1e-5)
    assert callable(tp["minibatches"])

def test_minibatch_update_still_uses_the_sum_form():
    """minibatch_update's step equals one taken by hand from the exposed
    mean-form loss's gradient (clip and Adam as the update does them), so
    the exposed entry and the update compute the same loss."""
    tnet = TN.ActorCritic(O, P, A, ACTOR, CRITIC, seed=4)
    cfg = TP.PPOConfig(num_steps_per_env=4, learning_rate=1e-3, schedule="fixed")
    tp = TP.make_train_pieces(None, tnet, cfg, 8)
    mb = tuple(torch.from_numpy(x) for x in _batch(3))
    ref = TP.init_train_state(TN.ActorCritic(O, P, A, ACTOR, CRITIC, seed=4), 1e-3)
    total, _ = tp["make_loss_fn"](mb)(ref.net)
    names, ps = zip(*ref.net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, ps)))
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-12), max=1.0)
    TP._adam_step(ref, {k: g * scale for k, g in grads.items()}, ref.lr)
    ts, _ = tp["minibatch_update"](TP.init_train_state(tnet, 1e-3), mb)
    for (name, p), (_, q) in zip(ts.net.named_parameters(), ref.net.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(21)
    qpos, qvel = [], []
    for _ in range(4):
        pos, quat, qj, qv = random_state(rng)
        qpos.append(np.concatenate([pos, quat, qj]))
        qvel.append(qv)
    return jax_model(), torch_model(), np.asarray(qpos, np.float32), np.asarray(qvel, np.float32)


def test_qpos_derivative_matches(states):
    _, _, qpos, qvel = states
    got = TD.qpos_derivative(torch.from_numpy(qpos), torch.from_numpy(qvel)).numpy()
    for e in range(len(qpos)):
        want = JD.qpos_derivative(jnp.asarray(qpos[e]), jnp.asarray(qvel[e]))
        np.testing.assert_allclose(got[e], want, atol=1e-6, rtol=1e-6)


def test_ad_bias_forces_match_jax_and_the_explicit_form(states):
    """The AD form (torch.func.jvp over body_velocities) against the JAX
    package's AD form and against the port's explicit recursion, at
    tests/test_physics_oracle.py's tolerance for the explicit form against
    AD (atol 1e-3, rtol 1e-4)."""
    jm, tm, qpos, qvel = states
    q, v = torch.from_numpy(qpos), torch.from_numpy(qvel)
    k = TK.fk(tm, q)
    mask = TK.ancestor_mask(tm)
    ms = torch.ones((len(qpos), 13))
    h_ad = TD.bias_forces(tm, q, v, k, mask, ms).numpy()
    h_ex = TD.bias_forces_explicit(tm, q, v, k, mask, ms).numpy()
    np.testing.assert_allclose(h_ad, h_ex, atol=1e-3, rtol=1e-4)
    jmask = JK.ancestor_mask(jm)
    jh = jax.jit(lambda jq, jv: JD.bias_forces(jm, jq, jv, JK.fk(jm, jq), jmask, jnp.ones(13)))
    for e in range(len(qpos)):
        want = jh(jnp.asarray(qpos[e]), jnp.asarray(qvel[e]))
        np.testing.assert_allclose(h_ad[e], want, atol=1e-3, rtol=1e-4)


def test_physics_step_is_make_physics_step():
    assert TS.physics_step is TS.make_physics_step


@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_joint_deploy"])
def test_actor_critic_from_cfg_builds_the_recipe_net(task):
    """The shared net-from-recipe helper gives the nets the recipe names
    (hidden dims, noise std, estimator head), seeded as ActorCritic is."""
    from humanoid_gym_tpu_torch import registry

    spec = registry.get_task(task)
    ec, pol = spec.make_env_cfg().env, spec.make_train_cfg().policy
    net = TN.actor_critic_from_cfg(ec, pol, seed=7)
    ref = TN.ActorCritic(ec.num_observations, ec.num_privileged_obs, ec.num_actions,
                         tuple(pol.actor_hidden_dims), tuple(pol.critic_hidden_dims),
                         init_noise_std=pol.init_noise_std, seed=7,
                         estimator_dim=pol.estimator_dim,
                         estimator_hidden=tuple(pol.estimator_hidden_dims))
    got, want = net.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert net.compute_dtype == pol.compute_dtype
    assert hasattr(net, "estimator") == (pol.estimator_dim > 0)
