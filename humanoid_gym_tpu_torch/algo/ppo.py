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
(ts, env_state, obs, priv_obs, metrics), with the action noise drawn from
the torch.Generator `gen` on the env's device and the minibatch
permutation from a generator of its own. The loop over T steps is plain
Python; every env step is one mega-kernel launch on the card. Under env
sharding (`group=`) the batch-global means are sums over the ranks
(SURVEY.md §2.3); at world size 1 no collective runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import EnvGroup, all_reduce_sum
from ..parallel.multihost import local_env_slice
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


def permutation_seed(seed: int, iteration: int) -> int:
    """The seed of the minibatch permutation of train iteration `iteration`
    in a run seeded `seed`: the same on every rank, and apart from the
    stream of the action noise."""
    return int(np.random.SeedSequence([seed, iteration, 1]).generate_state(1)[0])


def make_train_pieces(env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                      group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None) -> dict:
    """The train iteration and its stages: train_iter = rollout_phase ->
    compute_gae -> update_phase (minibatch_update over the loss). Each
    stage in the returned dict can be called, and timed, on its own, as
    can the pieces of an update: `permute_batch` (the minibatches of one
    permutation), `make_loss_fn(mb)` (the mean-form loss of one minibatch,
    as the JAX package's), `actor_apply(net, obs)` and
    `critic_apply(net, priv_obs)`.

    `num_envs` is the global env count. Under a `group` of several ranks
    the rollout holds this rank's envs (`env.global_env_ids()`; with no env,
    the rank's contiguous block), and every mean over the global batch is a
    sum over the ranks: the advantage statistics, each minibatch's
    gradients, losses and KL (one all-reduce per minibatch), and the
    metrics. The minibatch permutation is drawn over the global T x
    num_envs batch from a generator seeded by `permutation_seed(perm_seed,
    iteration)` (`perm_seed` defaults to the seed of train_iter's `gen`),
    identically on every rank; each rank updates on the rows of each
    minibatch whose env it holds, so the ranks together take the update of
    one process over the whole batch."""
    use_full_f32_matmul()
    T = cfg.num_steps_per_env
    batch = T * num_envs
    mb_size = batch // cfg.num_mini_batches
    n_mb = cfg.num_mini_batches
    sharded = group is not None and group.world > 1
    if sharded:
        if env is not None:
            ids = env.global_env_ids()
        else:
            start, count = local_env_slice(num_envs, group)
            ids = torch.arange(start, start + count)
        # global env -> this rank's env axis position, -1 where another
        # rank holds the env
        local_of_global = torch.full((num_envs,), -1, dtype=torch.long)
        local_of_global[ids] = torch.arange(len(ids))
        n_local = len(ids)

    def minibatch_rows(perm: torch.Tensor):
        """(rows, counts): this rank's flat rollout rows (t * n_local +
        local env) of the minibatches of the global permutation `perm`, in
        minibatch order, and how many fall in each minibatch. A global row
        t * num_envs + e belongs to the rank that holds env e."""
        used = perm[:n_mb * mb_size]
        if not sharded:
            return used, [mb_size] * n_mb
        loc = local_of_global.to(perm.device)[used % num_envs]
        keep = loc >= 0
        rows = ((used // num_envs) * n_local + loc)[keep]
        mb_of_row = torch.arange(used.numel(), device=perm.device) // mb_size
        counts = torch.bincount(mb_of_row[keep], minlength=n_mb).tolist()
        return rows, counts

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
        """GAE, then the advantages normalised by the global batch's mean
        and population std, in two passes (the mean, then the squared
        deviations from it), as jnp.std computes it."""
        last_value = ts.net.evaluate(last_priv_obs)
        advantages, returns = gae(roll.rewards, roll.values, roll.dones, last_value, cfg.gamma, cfg.lam)
        count = torch.full((), float(advantages.numel()), device=advantages.device)
        total, count = all_reduce_sum([advantages.sum(), count], group)
        mean = total / count
        (sq,) = all_reduce_sum([torch.square(advantages - mean).sum()], group)
        adv_n = (advantages - mean) / (torch.sqrt(sq / count) + 1e-8)
        return adv_n, returns

    def actor_apply(net: ActorCritic, obs):
        """(mean, std) of the policy at obs."""
        return net.act(obs)

    def critic_apply(net: ActorCritic, priv_obs):
        """The state value at priv_obs."""
        return net.evaluate(priv_obs)

    def make_sum_loss_fn(mb):
        """loss_fn(net) -> (total, sums): the loss and its terms as sums
        over the minibatch rows given (surrogate, value, entropy, KL,
        estimator); the caller divides by the global row count."""
        obs, priv, act, old_logp, old_v, adv, ret, old_mu, old_sigma = mb

        def loss_fn(net: ActorCritic):
            mean, std = actor_apply(net, obs)
            value = critic_apply(net, priv)
            if cfg.schedule == "adaptive":
                kl = torch.sum(
                    torch.log(std / old_sigma + 1e-5)
                    + (torch.square(old_sigma) + torch.square(mean - old_mu)) / (2.0 * torch.square(std))
                    - 0.5,
                    dim=-1,
                )
                kl_sum = kl.sum().detach()
            else:
                kl_sum = torch.zeros((), device=obs.device)
            logp = normal_log_prob(mean, std, act)
            ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
            surr = -adv * ratio
            surr_clipped = -adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
            surrogate_loss = torch.sum(torch.maximum(surr, surr_clipped))
            if cfg.use_clipped_value_loss:
                v_clipped = old_v + torch.clamp(value - old_v, -cfg.clip_param, cfg.clip_param)
                value_loss = torch.sum(
                    torch.maximum(torch.square(value - ret), torch.square(v_clipped - ret))
                )
            else:
                value_loss = torch.sum(torch.square(ret - value))
            entropy = normal_entropy(std, logp.shape).sum()
            total = surrogate_loss + cfg.value_loss_coef * value_loss - cfg.entropy_coef * entropy
            if cfg.estimator_coef > 0.0 and net.estimator_dim > 0:
                lo, hi = cfg.estimator_slice
                est_loss = torch.square(net.estimate(obs) - priv[:, lo:hi].detach()).mean(-1).sum()
                total = total + cfg.estimator_coef * est_loss
            else:
                est_loss = torch.zeros((), device=obs.device)
            sums = torch.stack([surrogate_loss.detach(), value_loss.detach(), entropy.detach(),
                                kl_sum, est_loss.detach()])
            return total, sums

        return loss_fn

    def make_loss_fn(mb):
        """loss_fn(net) -> (total, (surrogate, value, entropy, estimator,
        KL)): the JAX package's loss of minibatch `mb`, each term the mean
        over its rows (the sum form divided by the row count)."""
        sum_loss = make_sum_loss_fn(mb)
        rows = mb[0].shape[0]

        def loss_fn(net: ActorCritic):
            total, sums = sum_loss(net)
            surr, value, ent, kl, est = (sums / rows).unbind()
            return total / rows, (surr, value, ent, est, kl)

        return loss_fn

    def minibatch_update(ts: TrainState, mb) -> Tuple[TrainState, Dict]:
        """One Adam step on minibatch `mb` (this rank's rows of it): the
        gradients, loss sums and row counts of every rank summed by one
        all-reduce, then divided by the global row count, so every rank
        takes the step of the global mean with the global KL."""
        net = ts.net
        total, sums = make_sum_loss_fn(mb)(net)
        names, params = zip(*net.named_parameters())
        # an estimator head that the loss does not use (coef 0) gets zero
        # gradients, as under jax.grad
        grads = torch.autograd.grad(total, params, materialize_grads=True)
        rows = torch.full((), float(mb[0].shape[0]), device=sums.device)
        *grads, sums, rows = all_reduce_sum([*grads, sums, rows], group)
        grads = {k: g / rows for k, g in zip(names, grads)}
        surr_l, val_l, ent, kl_mean, est_l = (sums / rows).unbind()
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

    def permute_batch(roll: Rollout, adv, ret, perm_gen):
        """The minibatches of one update phase: a permutation of the global
        flattened batch drawn from `perm_gen`, this rank's rows of it
        gathered from the rollout, as num_mini_batches tuples (obs, priv,
        actions, log_probs, values, adv, ret, mu, sigma)."""
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
        perm = torch.randperm(batch, generator=perm_gen, device=adv.device)
        rows, counts = minibatch_rows(perm)
        data = [torch.split(flat(x)[rows], counts) for x in (
            roll.obs, roll.priv_obs, roll.actions, roll.log_probs, roll.values, adv, ret,
            roll.mu, roll.sigma,
        )]
        return [tuple(x[i] for x in data) for i in range(n_mb)]

    def update_phase(ts: TrainState, roll: Rollout, adv, ret, perm_gen):
        """num_learning_epochs x num_mini_batches updates over one shared
        permutation of the global flattened batch, drawn from `perm_gen`;
        returns the mean metrics."""
        mbs = permute_batch(roll, adv, ret, perm_gen)
        metrics_acc = None
        for _ in range(cfg.num_learning_epochs):
            for mb in mbs:
                ts, mets = minibatch_update(ts, mb)
                metrics_acc = mets if metrics_acc is None else {
                    k: metrics_acc[k] + v for k, v in mets.items()
                }
        n_updates = cfg.num_learning_epochs * n_mb
        return ts, {k: v / n_updates for k, v in metrics_acc.items()}

    def train_iter(ts: TrainState, env_state, obs, priv_obs, gen):
        env_state, obs, priv_obs, roll, infos = rollout_phase(ts, env_state, obs, priv_obs, gen)
        adv, ret = compute_gae(ts, roll, priv_obs)
        perm_gen = torch.Generator(device=obs.device)
        perm_gen.manual_seed(permutation_seed(
            gen.initial_seed() if perm_seed is None else perm_seed, ts.iteration))
        ts, metrics = update_phase(ts, roll, adv, ret, perm_gen)
        stack = lambda f: torch.stack([getattr(tr, f) for tr in infos])  # noqa: E731
        (reward_sum, ep_term_sums, ep_reset_count, ep_len_sum, ep_reward_sum, nonfinite,
         level_sum) = all_reduce_sum([
             stack("reward").sum(), stack("ep_term_sums").sum(dim=(0, 1)),
             stack("ep_reset_count").sum(), stack("ep_len_at_reset").sum(),
             stack("ep_reward_at_reset").sum(), stack("nonfinite").sum(),
             stack("terrain_level").sum()], group)
        metrics.update(
            mean_step_reward=reward_sum / batch,
            ep_term_sums=ep_term_sums,
            ep_reset_count=ep_reset_count,
            ep_len_sum=ep_len_sum,
            ep_reward_sum=ep_reward_sum,
            nonfinite_resets=nonfinite,
            mean_terrain_level=level_sum / batch,
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
        "permute_batch": permute_batch,
        "minibatch_update": minibatch_update,
        "minibatch_rows": minibatch_rows,
        "make_loss_fn": make_loss_fn,
        "actor_apply": actor_apply,
        "critic_apply": critic_apply,
    }


def make_train_iter(env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                    group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None) -> Callable:
    """train_iter(ts, env_state, obs, priv_obs, gen) ->
    (ts, env_state, obs, priv_obs, metrics); see make_train_pieces."""
    return make_train_pieces(env, net, cfg, num_envs, group, perm_seed)["train_iter"]
