"""PPO train iteration: rollout + GAE + minibatched clipped update.

Port of humanoid_gym_tpu/algo/ppo.py with the same numerical contract:
- log-probs on the pre-clip sampled action
- timeout bootstrap: rew += gamma * V(s_t) * timeout
- GAE by a reverse loop with (1-done) masking, batch-global advantage
  normalization
- num_learning_epochs x num_mini_batches over ONE random permutation of the
  flattened T*N batch
- KL-adaptive learning rate x/÷1.5 in [1e-5, 1e-2], applied before each
  minibatch's Adam step
- clipped surrogate + clipped value loss + entropy bonus, global grad-norm
  clip (a non-finite norm drops the minibatch's update), plain Adam
- with an estimator head and `estimator_coef > 0`, the supervised term
  coef * mean((estimate(obs) - priv[:, lo:hi])^2), the target detached
  (`estimator_slice`, the newest privileged frame's base linear velocity)

`make_train_iter(env, net, cfg, num_envs)` returns
train_iter(ts, env_state, obs, priv_obs, gen) ->
(ts, env_state, obs, priv_obs, metrics), with random draws from the
torch.Generator `gen` on the env's device. The loop over T steps is plain
Python; every env step is one mega-kernel launch on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..physics.kinematics import use_full_f32_matmul
from .networks import ActorCritic, normal_entropy, normal_log_prob


@dataclasses.dataclass
class PPOConfig:
    """Algorithm hyperparameters (reference humanoid_config.py:230-261)."""

    clip_param: float = 0.2
    num_learning_epochs: int = 2
    num_mini_batches: int = 4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.001
    learning_rate: float = 1e-5
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    schedule: str = "adaptive"
    desired_kl: float = 0.01
    gamma: float = 0.994
    lam: float = 0.9
    num_steps_per_env: int = 60
    # DWL-style estimator head: supervised on a slice of the privileged obs
    # (the base linear velocity at [199:202] of the stacked XBot critic obs)
    estimator_coef: float = 0.0
    estimator_slice: tuple = (199, 202)

    @staticmethod
    def from_cfg(a) -> "PPOConfig":
        return PPOConfig(
            clip_param=a.clip_param,
            num_learning_epochs=a.num_learning_epochs,
            num_mini_batches=a.num_mini_batches,
            value_loss_coef=a.value_loss_coef,
            entropy_coef=a.entropy_coef,
            learning_rate=a.learning_rate,
            max_grad_norm=a.max_grad_norm,
            use_clipped_value_loss=a.use_clipped_value_loss,
            schedule=a.schedule,
            desired_kl=a.desired_kl,
            gamma=a.gamma,
            lam=a.lam,
            estimator_coef=getattr(a, "estimator_coef", 0.0),
            estimator_slice=tuple(getattr(a, "estimator_slice", (199, 202))),
        )


@dataclasses.dataclass
class TrainState:
    net: ActorCritic
    opt_mu: Dict[str, torch.Tensor]  # Adam first moments, by parameter name
    opt_nu: Dict[str, torch.Tensor]  # Adam second moments
    opt_count: int
    lr: torch.Tensor  # () adaptive learning rate
    iteration: int


class Rollout(NamedTuple):
    obs: torch.Tensor  # (T, N, O)
    priv_obs: torch.Tensor  # (T, N, P)
    actions: torch.Tensor  # (T, N, A)
    mu: torch.Tensor  # (T, N, A)
    sigma: torch.Tensor  # (T, N, A)
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N) post-bootstrap
    dones: torch.Tensor  # (T, N) bool


def init_train_state(net: ActorCritic, lr0: float) -> TrainState:
    params = dict(net.named_parameters())
    dev = next(net.parameters()).device
    return TrainState(
        net=net,
        opt_mu={k: torch.zeros_like(p) for k, p in params.items()},
        opt_nu={k: torch.zeros_like(p) for k, p in params.items()},
        opt_count=0,
        lr=torch.tensor(lr0, dtype=torch.float32, device=dev),
        iteration=0,
    )


@torch.no_grad()
def _adam_step(ts: TrainState, grads: Dict[str, torch.Tensor], lr: torch.Tensor,
               b1=0.9, b2=0.999, eps=1e-8) -> None:
    """Plain Adam, in place, with the state-carried learning rate."""
    ts.opt_count += 1
    c1 = 1 - b1 ** ts.opt_count
    c2 = 1 - b2 ** ts.opt_count
    for name, p in ts.net.named_parameters():
        g = grads[name]
        m = ts.opt_mu[name].mul_(b1).add_((1 - b1) * g)
        v = ts.opt_nu[name].mul_(b2).add_((1 - b2) * torch.square(g))
        p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over (T, N) inputs and (N,)
    last_value -> (advantages, returns), both (T, N)."""
    T = rewards.shape[0]
    adv = torch.zeros_like(rewards)
    adv_next = torch.zeros_like(last_value)
    value_next = last_value
    for t in reversed(range(T)):
        not_done = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * value_next * not_done - values[t]
        adv_next = delta + gamma * lam * not_done * adv_next
        adv[t] = adv_next
        value_next = values[t]
    return adv, adv + values


def make_train_pieces(env, net: ActorCritic, cfg: PPOConfig, num_envs: int) -> dict:
    """The train iteration and its stages: train_iter = rollout_phase ->
    compute_gae -> update_phase (minibatch_update over make_loss_fn). Each
    stage in the returned dict can be called, and timed, on its own."""
    use_full_f32_matmul()
    T = cfg.num_steps_per_env
    batch = T * num_envs
    mb_size = batch // cfg.num_mini_batches

    @torch.no_grad()
    def rollout_phase(ts: TrainState, env_state, obs, priv_obs, gen):
        dev = obs.device
        A = ts.net.num_actions
        n = obs.shape[0]
        buf = Rollout(
            obs=torch.empty((T,) + tuple(obs.shape), device=dev),
            priv_obs=torch.empty((T,) + tuple(priv_obs.shape), device=dev),
            actions=torch.empty((T, n, A), device=dev),
            mu=torch.empty((T, n, A), device=dev),
            sigma=torch.empty((T, n, A), device=dev),
            log_probs=torch.empty((T, n), device=dev),
            values=torch.empty((T, n), device=dev),
            rewards=torch.empty((T, n), device=dev),
            dones=torch.empty((T, n), dtype=torch.bool, device=dev),
        )
        infos = []
        for t in range(T):
            mean, std = ts.net.act(obs)
            value = ts.net.evaluate(priv_obs)
            noise = torch.randn(mean.shape, generator=gen, device=dev)
            action = mean + std * noise
            logp = normal_log_prob(mean, std, action)
            env_state, tr = env.step(env_state, action)
            rew = tr.reward + cfg.gamma * value * tr.time_out
            buf.obs[t], buf.priv_obs[t], buf.actions[t] = obs, priv_obs, action
            buf.mu[t], buf.sigma[t] = mean, std.expand_as(mean)
            buf.log_probs[t], buf.values[t], buf.rewards[t], buf.dones[t] = logp, value, rew, tr.done
            infos.append(tr)
            obs, priv_obs = tr.obs, tr.privileged_obs
        return env_state, obs, priv_obs, buf, infos

    @torch.no_grad()
    def compute_gae(ts: TrainState, roll: Rollout, last_priv_obs):
        last_value = ts.net.evaluate(last_priv_obs)
        advantages, returns = gae(roll.rewards, roll.values, roll.dones, last_value, cfg.gamma, cfg.lam)
        adv_n = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        return adv_n, returns

    def make_loss_fn(mb):
        obs, priv, act, old_logp, old_v, adv, ret, old_mu, old_sigma = mb

        def loss_fn(net: ActorCritic):
            mean, std = net.act(obs)
            value = net.evaluate(priv)
            if cfg.schedule == "adaptive":
                kl = torch.sum(
                    torch.log(std / old_sigma + 1e-5)
                    + (torch.square(old_sigma) + torch.square(mean - old_mu)) / (2.0 * torch.square(std))
                    - 0.5,
                    dim=-1,
                )
                kl_mean = kl.mean().detach()
            else:
                kl_mean = torch.zeros((), device=obs.device)
            logp = normal_log_prob(mean, std, act)
            ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
            surr = -adv * ratio
            surr_clipped = -adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
            surrogate_loss = torch.mean(torch.maximum(surr, surr_clipped))
            if cfg.use_clipped_value_loss:
                v_clipped = old_v + torch.clamp(value - old_v, -cfg.clip_param, cfg.clip_param)
                value_loss = torch.mean(
                    torch.maximum(torch.square(value - ret), torch.square(v_clipped - ret))
                )
            else:
                value_loss = torch.mean(torch.square(ret - value))
            entropy = normal_entropy(std, logp.shape)
            total = surrogate_loss + cfg.value_loss_coef * value_loss - cfg.entropy_coef * entropy.mean()
            if cfg.estimator_coef > 0.0 and net.estimator_dim > 0:
                lo, hi = cfg.estimator_slice
                est_loss = torch.mean(torch.square(net.estimate(obs) - priv[:, lo:hi].detach()))
                total = total + cfg.estimator_coef * est_loss
            else:
                est_loss = torch.zeros((), device=obs.device)
            aux = (surrogate_loss.detach(), value_loss.detach(), entropy.mean().detach(), kl_mean,
                   est_loss.detach())
            return total, aux

        return loss_fn

    def minibatch_update(ts: TrainState, mb) -> Tuple[TrainState, Dict]:
        net = ts.net
        total, (surr_l, val_l, ent, kl_mean, est_l) = make_loss_fn(mb)(net)
        names, params = zip(*net.named_parameters())
        # an estimator head that the loss does not use (coef 0) gets zero
        # gradients, as under jax.grad
        grads = dict(zip(names, torch.autograd.grad(total, params, materialize_grads=True)))
        lr = ts.lr
        if cfg.schedule == "adaptive":
            lr = torch.where(
                kl_mean > cfg.desired_kl * 2.0,
                torch.clamp(lr / 1.5, min=1e-5),
                torch.where(
                    (kl_mean < cfg.desired_kl / 2.0) & (kl_mean > 0.0),
                    torch.clamp(lr * 1.5, max=1e-2),
                    lr,
                ),
            )
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
        ok = torch.isfinite(gnorm)
        scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-12), max=1.0)
        grads = {k: torch.where(ok, g * scale, torch.zeros_like(g)) for k, g in grads.items()}
        _adam_step(ts, grads, lr)
        ts.lr = lr
        return ts, {
            "value_loss": val_l,
            "surrogate_loss": surr_l,
            "entropy": ent,
            "kl": kl_mean,
            "grad_norm": gnorm.detach(),
            "estimator_loss": est_l,
        }

    def update_phase(ts: TrainState, roll: Rollout, adv, ret, gen):
        """num_learning_epochs x num_mini_batches updates over one shared
        permutation of the flattened batch; returns the mean metrics."""
        flat = lambda x: x.reshape((batch,) + tuple(x.shape[2:]))  # noqa: E731
        perm = torch.randperm(batch, generator=gen, device=adv.device)
        data = [flat(x)[perm] for x in (
            roll.obs, roll.priv_obs, roll.actions, roll.log_probs, roll.values, adv, ret,
            roll.mu, roll.sigma,
        )]
        metrics_acc = None
        for _ in range(cfg.num_learning_epochs):
            for i in range(cfg.num_mini_batches):
                mb = tuple(x[i * mb_size:(i + 1) * mb_size] for x in data)
                ts, mets = minibatch_update(ts, mb)
                metrics_acc = mets if metrics_acc is None else {
                    k: metrics_acc[k] + v for k, v in mets.items()
                }
        n_updates = cfg.num_learning_epochs * cfg.num_mini_batches
        return ts, {k: v / n_updates for k, v in metrics_acc.items()}

    def train_iter(ts: TrainState, env_state, obs, priv_obs, gen):
        env_state, obs, priv_obs, roll, infos = rollout_phase(ts, env_state, obs, priv_obs, gen)
        adv, ret = compute_gae(ts, roll, priv_obs)
        ts, metrics = update_phase(ts, roll, adv, ret, gen)
        stack = lambda f: torch.stack([getattr(tr, f) for tr in infos])  # noqa: E731
        metrics.update(
            mean_step_reward=stack("reward").mean(),
            ep_term_sums=stack("ep_term_sums").sum(dim=(0, 1)),
            ep_reset_count=stack("ep_reset_count").sum(),
            ep_len_sum=stack("ep_len_at_reset").sum(),
            ep_reward_sum=stack("ep_reward_at_reset").sum(),
            nonfinite_resets=stack("nonfinite").sum(),
            mean_terrain_level=stack("terrain_level").mean(),
            lr=ts.lr,
            action_std_mean=ts.net.std.detach().abs().mean(),
        )
        ts.iteration += 1
        return ts, env_state, obs, priv_obs, metrics

    return {
        "train_iter": train_iter,
        "rollout_phase": rollout_phase,
        "compute_gae": compute_gae,
        "update_phase": update_phase,
        "minibatch_update": minibatch_update,
    }


def make_train_iter(env, net: ActorCritic, cfg: PPOConfig, num_envs: int) -> Callable:
    """train_iter(ts, env_state, obs, priv_obs, gen) ->
    (ts, env_state, obs, priv_obs, metrics)."""
    return make_train_pieces(env, net, cfg, num_envs)["train_iter"]
