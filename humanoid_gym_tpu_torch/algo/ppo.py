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

The iteration's body (`iteration_body`, everything after the permutation
is drawn) updates the train state's tensors in place and reads no host
value that changes from one iteration to the next, at any world size, so
on the card it is captured (`algo/capture.py`: one CUDA graph at world size
1, a chain of graphs cut at each all-reduce under several ranks); the eager
iteration is the same body.

A recurrent net (`networks.ActorCriticRecurrent`) trains by the pieces of
`algo/recurrent.py`, which `make_train_pieces` hands it to: the same loss,
update and metrics (`loss_terms`, `apply_update`, `normalized_gae`,
`rollout_metrics`), with the memory's state in the train state
(`TrainState.memory`) and minibatches of whole env rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import EnvGroup, all_reduce_sum
from ..parallel.multihost import local_env_slice
from ..physics.kinematics import use_full_f32_matmul
from ..utils.tracing import ROOT, stage
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
    opt_count: torch.Tensor  # () int32 Adam step count, advanced in place
    lr: torch.Tensor  # () adaptive learning rate, written in place
    iteration: int  # host counter: seeds each iteration's minibatch permutation
    # a recurrent net's memory (h_a, c_a, h_c, c_c), each (layers, N, H),
    # carried from iteration to iteration and written in place; None for
    # a feed-forward net
    memory: Optional[Tuple[torch.Tensor, ...]] = None


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


def init_train_state(net: ActorCritic, lr0: float, num_envs: int = 0) -> TrainState:
    """Zero Adam moments and count, the learning rate `lr0`, and for a
    recurrent net the zero memory of `num_envs` envs."""
    params = dict(net.named_parameters())
    dev = next(net.parameters()).device
    memory = None
    if getattr(net, "is_recurrent", False):
        if num_envs <= 0:
            raise ValueError("a recurrent net's train state holds its memory: give num_envs")
        memory = net.initial_memory(num_envs, dev)
    return TrainState(
        net=net,
        opt_mu={k: torch.zeros_like(p) for k, p in params.items()},
        opt_nu={k: torch.zeros_like(p) for k, p in params.items()},
        opt_count=torch.zeros((), dtype=torch.int32, device=dev),
        lr=torch.tensor(lr0, dtype=torch.float32, device=dev),
        iteration=0,
        memory=memory,
    )


@torch.no_grad()
def _adam_step(ts: TrainState, grads: Dict[str, torch.Tensor], lr: torch.Tensor,
               b1=0.9, b2=0.999, eps=1e-8) -> None:
    """Plain Adam, in place, with the state-carried learning rate. The count
    is a device tensor and the bias corrections are float32 on the device,
    as the JAX package computes them (`b1**count.astype(jnp.float32)`)."""
    ts.opt_count.add_(1)
    count = ts.opt_count.to(torch.float32)
    c1 = 1 - b1 ** count
    c2 = 1 - b2 ** count
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


# standard deviations above its mean of the fixed minibatch split
# (`split_rows`): a rank's count of own rows in a minibatch exceeds it with a
# probability of about 6e-16 (the normal tail at 8 sigma)
SPLIT_SIGMAS = 8.0


def split_rows(batch: int, num_mini_batches: int, own: int) -> int:
    """C, the rows a rank gathers for each minibatch under several ranks:
    the count of its own rows in a minibatch of m = batch / num_mini_batches
    rows drawn without replacement from the global batch, of which it holds
    `own`, is hypergeometric with mean m own / batch and variance
    m (own / batch) (1 - own / batch) (batch - m) / (batch - 1); C is that
    mean plus SPLIT_SIGMAS standard deviations, rounded up, and at most m
    and `own` (so exact when the minibatch is the whole batch)."""
    m = batch // num_mini_batches
    p = own / batch
    var = m * p * (1.0 - p) * (batch - m) / (batch - 1)
    return min(m, own, math.ceil(m * own / batch + SPLIT_SIGMAS * math.sqrt(var)))


def check_minibatch_split(metrics: dict) -> None:
    """Raise if an iteration's padded minibatch split overflowed: under
    several ranks, a minibatch held more of this rank's rows than the
    split's fixed size, so rows beyond it were left out of that update.
    Reads `minibatch_own_rows` and `minibatch_split_rows` of the iteration's
    metrics on the host (the runner calls it where it reads the metrics);
    metrics of world size 1 carry no split and pass."""
    own = metrics.get("minibatch_own_rows")
    if own is None:
        return
    split = int(metrics["minibatch_split_rows"])
    if int(own.max()) > split:
        raise RuntimeError(f"this rank's rows in the minibatches, {own.tolist()}, exceed the "
                           f"padded split of {split} rows; the update left rows out")


def permutation_seed(seed: int, iteration: int) -> int:
    """The seed of the minibatch permutation of train iteration `iteration`
    in a run seeded `seed`: the same on every rank, and apart from the
    stream of the action noise."""
    return int(np.random.SeedSequence([seed, iteration, 1]).generate_state(1)[0])


def seeded_permutation(n: int, iteration: int, gen: torch.Generator,
                       perm_seed: Optional[int] = None) -> torch.Tensor:
    """A permutation of n for train iteration `iteration`, on `gen`'s
    device, from a generator seeded by `permutation_seed(perm_seed,
    iteration)` (`perm_seed` defaults to the seed of `gen`)."""
    perm_gen = torch.Generator(device=gen.device)
    perm_gen.manual_seed(permutation_seed(
        gen.initial_seed() if perm_seed is None else perm_seed, iteration))
    return torch.randperm(n, generator=perm_gen, device=gen.device)


def update_epochs(cfg: PPOConfig, ts: TrainState, mbs, minibatch_update):
    """num_learning_epochs passes of `minibatch_update` over the minibatches
    `mbs`; returns the mean metrics."""
    metrics_acc = None
    for _ in range(cfg.num_learning_epochs):
        for mb in mbs:
            ts, mets = minibatch_update(ts, mb)
            metrics_acc = mets if metrics_acc is None else {
                k: metrics_acc[k] + v for k, v in mets.items()
            }
    n_updates = cfg.num_learning_epochs * len(mbs)
    return ts, {k: v / n_updates for k, v in metrics_acc.items()}


def normalized_gae(cfg: PPOConfig, roll, last_value, group: Optional[EnvGroup] = None):
    """GAE of the rollout, then the advantages normalised by the global
    batch's mean and population std, in two passes (the mean, then the
    squared deviations from it), as jnp.std computes it -> (advantages,
    returns)."""
    advantages, returns = gae(roll.rewards, roll.values, roll.dones, last_value, cfg.gamma,
                              cfg.lam)
    count = torch.full((), float(advantages.numel()), device=advantages.device)
    total, count = all_reduce_sum([advantages.sum(), count], group)
    mean = total / count
    (sq,) = all_reduce_sum([torch.square(advantages - mean).sum()], group)
    adv_n = (advantages - mean) / (torch.sqrt(sq / count) + 1e-8)
    return adv_n, returns


def loss_terms(cfg: PPOConfig, mean, std, value, act, old_logp, old_v, adv, ret, old_mu,
               old_sigma, row_sum):
    """(total, surrogate, value loss, entropy, KL) of the policy at (mean,
    std) and the values `value` against the rollout's rows, each a sum
    over the rows by `row_sum`; the KL is detached."""
    if cfg.schedule == "adaptive":
        kl = torch.sum(
            torch.log(std / old_sigma + 1e-5)
            + (torch.square(old_sigma) + torch.square(mean - old_mu)) / (2.0 * torch.square(std))
            - 0.5,
            dim=-1,
        )
        kl_sum = row_sum(kl).detach()
    else:
        kl_sum = torch.zeros((), device=mean.device)
    logp = normal_log_prob(mean, std, act)
    ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
    surr = -adv * ratio
    surr_clipped = -adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
    surrogate_loss = row_sum(torch.maximum(surr, surr_clipped))
    if cfg.use_clipped_value_loss:
        v_clipped = old_v + torch.clamp(value - old_v, -cfg.clip_param, cfg.clip_param)
        value_loss = row_sum(
            torch.maximum(torch.square(value - ret), torch.square(v_clipped - ret))
        )
    else:
        value_loss = row_sum(torch.square(ret - value))
    entropy = row_sum(normal_entropy(std, logp.shape))
    total = surrogate_loss + cfg.value_loss_coef * value_loss - cfg.entropy_coef * entropy
    return total, surrogate_loss, value_loss, entropy, kl_sum


def apply_update(cfg: PPOConfig, ts: TrainState, names, grads, sums, rows,
                 group: Optional[EnvGroup] = None) -> Tuple[TrainState, Dict]:
    """The step of one minibatch from its gradient sums `grads` (in the
    order of `names`), loss sums and row count: every rank's summed by one
    all-reduce and divided by the global row count, the KL-adaptive
    learning rate, the global norm clip (a non-finite norm drops the step)
    and Adam, in place; -> (ts, the minibatch's metrics)."""
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
    ts.lr.copy_(lr)
    return ts, {
        "value_loss": val_l,
        "surrogate_loss": surr_l,
        "entropy": ent,
        "kl": kl_mean,
        "grad_norm": gnorm.detach(),
        "estimator_loss": est_l,
    }


def rollout_metrics(ts: TrainState, metrics: dict, infos, batch: int,
                    group: Optional[EnvGroup] = None) -> dict:
    """The iteration's metrics: the update's means `metrics`, with the
    rollout's sums over the ranks (of `batch` global samples), the learning
    rate and the action std."""
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
        # a copy: the next iteration writes ts.lr in place
        lr=ts.lr.clone(),
        action_std_mean=ts.net.std.detach().abs().mean(),
    )
    return metrics


def make_train_pieces(env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                      group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None) -> dict:
    """The train iteration and its stages: train_iter = draw_permutation,
    then iteration_body (rollout_phase -> compute_gae -> the update phase,
    minibatch_update over the loss, and the metrics). Each stage in the
    returned dict can be called, and timed, on its own, as can the pieces
    of an update: `update_phase` and `permute_batch` (the update and the
    minibatches of a permutation drawn from a generator given),
    `make_loss_fn(mb)` (the mean-form loss of one minibatch, as the JAX
    package's), `actor_apply(net, obs)` and `critic_apply(net, priv_obs)`.

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
    one process over the whole batch. Each rank gathers the same fixed
    number of rows for each minibatch, `split_rows(...)`, its own rows
    first and then padding rows of weight 0 (`minibatch_rows`), so no step
    of the iteration waits for the host.

    A recurrent net gets `algo/recurrent.py`'s pieces instead."""
    if getattr(net, "is_recurrent", False):
        from .recurrent import make_recurrent_pieces

        return make_recurrent_pieces(env, net, cfg, num_envs, group, perm_seed)
    use_full_f32_matmul()
    T = cfg.num_steps_per_env
    batch = T * num_envs
    mb_size = batch // cfg.num_mini_batches
    n_mb = cfg.num_mini_batches
    sharded = group is not None and group.world > 1
    if sharded:
        dev = env.device if env is not None else group.device
        if env is not None:
            ids = env.global_env_ids().to(dev)
        else:
            start, count = local_env_slice(num_envs, group)
            ids = torch.arange(start, start + count, device=dev)
        # global env -> this rank's env axis position, -1 where another
        # rank holds the env; made once, on the device the permutation is
        # drawn on
        local_of_global = torch.full((num_envs,), -1, dtype=torch.long, device=dev)
        local_of_global[ids] = torch.arange(len(ids), device=dev)
        n_local = len(ids)
        split = split_rows(batch, n_mb, T * n_local)
        split_index = torch.arange(split, device=dev)
        split_size = torch.full((), split, dtype=torch.long, device=dev)

    def minibatch_rows(perm: torch.Tensor):
        """(rows, weight, own) of the minibatches of the global permutation
        `perm`: rows (num_mini_batches, width) are this rank's flat rollout
        rows (t * n_local + local env) of each minibatch; a global row t *
        num_envs + e belongs to the rank that holds env e. At world size 1
        the width is mb_size and weight and own are None. Under several
        ranks the width is the fixed split C (`split_rows`): a minibatch's
        own rows first, in the permutation's order, then padding rows (row
        0) up to C; weight (num_mini_batches, C) float32 is 1 on own rows
        and 0 on padding, own (num_mini_batches,) counts the own rows. A
        minibatch with more than C own rows keeps its first C, and its
        count in own makes `check_minibatch_split` raise."""
        used = perm[:n_mb * mb_size].view(n_mb, mb_size)
        if not sharded:
            return used, None, None
        loc = local_of_global[used % num_envs]
        keep = loc >= 0
        pos = torch.cumsum(keep, dim=1) - 1
        own = pos[:, -1] + 1
        # each own row to its place in the split, every other (and any
        # beyond C) to a spare last column that is cut off
        dest = torch.where(keep & (pos < split), pos, split)
        rows = torch.zeros((n_mb, split + 1), dtype=torch.long, device=used.device)
        rows.scatter_(1, dest, (used // num_envs) * n_local + loc)
        weight = (split_index < own[:, None]).to(torch.float32)
        return rows[:, :split], weight, own

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
            with stage("rollout.policy"):
                mean, std = ts.net.act(obs)
                value = ts.net.evaluate(priv_obs)
                noise = torch.randn(mean.shape, generator=gen, device=dev)
                action = mean + std * noise
                logp = normal_log_prob(mean, std, action)
            env_state, tr = env.step(env_state, action)
            with stage("rollout.store"):
                rew = tr.reward + cfg.gamma * value * tr.time_out
                buf.obs[t], buf.priv_obs[t], buf.actions[t] = obs, priv_obs, action
                buf.mu[t], buf.sigma[t] = mean, std.expand_as(mean)
                buf.log_probs[t], buf.values[t], buf.rewards[t], buf.dones[t] = (
                    logp, value, rew, tr.done)
            infos.append(tr)
            obs, priv_obs = tr.obs, tr.privileged_obs
        return env_state, obs, priv_obs, buf, infos

    @torch.no_grad()
    def compute_gae(ts: TrainState, roll: Rollout, last_priv_obs):
        """GAE, then the advantages normalised by the global batch's mean
        and population std, in two passes (the mean, then the squared
        deviations from it), as jnp.std computes it."""
        with stage("gae"):
            last_value = ts.net.evaluate(last_priv_obs)
            return normalized_gae(cfg, roll, last_value, group)

    def actor_apply(net: ActorCritic, obs):
        """(mean, std) of the policy at obs."""
        return net.act(obs)

    def critic_apply(net: ActorCritic, priv_obs):
        """The state value at priv_obs."""
        return net.evaluate(priv_obs)

    def make_sum_loss_fn(mb):
        """loss_fn(net) -> (total, sums): the loss and its terms as sums
        over the minibatch rows given (surrogate, value, entropy, KL,
        estimator), each row weighted by the minibatch's tenth element
        where it has one (the padded split); the caller divides by the
        global row count."""
        obs, priv, act, old_logp, old_v, adv, ret, old_mu, old_sigma, *weight = mb

        def row_sum(x):
            """The sum over the rows; a padding row (weight 0) adds 0."""
            return torch.sum(weight[0] * x) if weight else torch.sum(x)

        def loss_fn(net: ActorCritic):
            mean, std = actor_apply(net, obs)
            value = critic_apply(net, priv)
            total, surrogate_loss, value_loss, entropy, kl_sum = loss_terms(
                cfg, mean, std, value, act, old_logp, old_v, adv, ret, old_mu, old_sigma, row_sum)
            if cfg.estimator_coef > 0.0 and net.estimator_dim > 0:
                lo, hi = cfg.estimator_slice
                est = torch.square(net.estimate(obs) - priv[:, lo:hi].detach())
                est_loss = row_sum(est.mean(-1))
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
        with stage("update.grad"):
            total, sums = make_sum_loss_fn(mb)(net)
            names, params = zip(*net.named_parameters())
            # an estimator head that the loss does not use (coef 0) gets zero
            # gradients, as under jax.grad
            grads = torch.autograd.grad(total, params, materialize_grads=True)
            rows = mb[9].sum() if len(mb) > 9 else torch.full((), float(mb[0].shape[0]),
                                                              device=sums.device)
        with stage("update.adam"):
            return apply_update(cfg, ts, names, grads, sums, rows, group)

    def gather(roll: Rollout, adv, ret, rows, weight):
        """The minibatches of `minibatch_rows`' rows and weights, gathered
        from the rollout: num_mini_batches tuples (obs, priv, actions,
        log_probs, values, adv, ret, mu, sigma), under several ranks with
        the rows' weights appended."""
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
        data = [torch.split(flat(x)[rows.reshape(-1)], rows.shape[1]) for x in (
            roll.obs, roll.priv_obs, roll.actions, roll.log_probs, roll.values, adv, ret,
            roll.mu, roll.sigma,
        )]
        mbs = [tuple(x[i] for x in data) for i in range(n_mb)]
        if weight is not None:
            mbs = [mb + (w,) for mb, w in zip(mbs, weight)]
        return mbs

    def minibatches(roll: Rollout, adv, ret, perm: torch.Tensor):
        """The minibatches of the global permutation `perm`: this rank's
        rows of each, gathered from the rollout (`gather`)."""
        return gather(roll, adv, ret, *minibatch_rows(perm)[:2])

    def permute_batch(roll: Rollout, adv, ret, perm_gen):
        """The minibatches of one update phase: a permutation of the global
        flattened batch drawn from `perm_gen`, then `minibatches`."""
        perm = torch.randperm(batch, generator=perm_gen, device=adv.device)
        return minibatches(roll, adv, ret, perm)

    def update_minibatches(ts: TrainState, mbs):
        """num_learning_epochs x num_mini_batches updates over the gathered
        minibatches `mbs`; returns the mean metrics."""
        return update_epochs(cfg, ts, mbs, minibatch_update)

    def update_split(ts: TrainState, roll: Rollout, adv, ret, rows, weight):
        """`update_minibatches` over the minibatches of `minibatch_rows`."""
        return update_minibatches(ts, gather(roll, adv, ret, rows, weight))

    def update_on(ts: TrainState, roll: Rollout, adv, ret, perm: torch.Tensor):
        """`update_split` over the global permutation `perm`."""
        return update_split(ts, roll, adv, ret, *minibatch_rows(perm)[:2])

    def update_phase(ts: TrainState, roll: Rollout, adv, ret, perm_gen):
        """`update_on` a permutation of the global flattened batch drawn
        from `perm_gen`."""
        perm = torch.randperm(batch, generator=perm_gen, device=adv.device)
        return update_on(ts, roll, adv, ret, perm)

    def draw_permutation(ts: TrainState, gen):
        """The minibatch permutation of iteration `ts.iteration`: drawn over
        the global flattened batch, on `gen`'s device, from a generator
        seeded by `permutation_seed(perm_seed, ts.iteration)` (`perm_seed`
        defaults to the seed of `gen`), the same on every rank."""
        return seeded_permutation(batch, ts.iteration, gen, perm_seed)

    def iteration_body(ts: TrainState, env_state, obs, priv_obs, gen, perm: torch.Tensor):
        """One training iteration on the minibatch permutation `perm`:
        rollout, GAE, the update phase and the metrics; -> (env_state, obs,
        priv_obs, metrics). It updates the parameters, Adam moments, count
        and learning rate of `ts` in place and leaves `ts.iteration` alone.
        Its stages (`utils/tracing.py`) partition it: under the root, per env
        step rollout.policy, the env's stages and rollout.store, then gae,
        update.gather, per minibatch update.grad and update.adam, and
        iter.metrics."""
        with stage(ROOT):
            env_state, obs, priv_obs, roll, infos = rollout_phase(ts, env_state, obs, priv_obs,
                                                                  gen)
            adv, ret = compute_gae(ts, roll, priv_obs)
            with stage("update.gather"):
                rows, weight, own = minibatch_rows(perm)
                mbs = gather(roll, adv, ret, rows, weight)
            ts, metrics = update_minibatches(ts, mbs)
            with stage("iter.metrics"):
                metrics = iteration_metrics(ts, metrics, infos, own)
        return env_state, obs, priv_obs, metrics

    def iteration_metrics(ts: TrainState, metrics: dict, infos, own):
        """`rollout_metrics`, and under several ranks this rank's split."""
        metrics = rollout_metrics(ts, metrics, infos, batch, group)
        if sharded:  # this rank's split, for check_minibatch_split
            metrics.update(minibatch_own_rows=own, minibatch_split_rows=split_size)
        return metrics

    def train_iter(ts: TrainState, env_state, obs, priv_obs, gen):
        perm = draw_permutation(ts, gen)
        env_state, obs, priv_obs, metrics = iteration_body(ts, env_state, obs, priv_obs, gen, perm)
        ts.iteration += 1
        return ts, env_state, obs, priv_obs, metrics

    return {
        "train_iter": train_iter,
        "iteration_body": iteration_body,
        "draw_permutation": draw_permutation,
        "rollout_phase": rollout_phase,
        "compute_gae": compute_gae,
        "update_phase": update_phase,
        "permute_batch": permute_batch,
        "minibatch_update": minibatch_update,
        "minibatch_rows": minibatch_rows,
        "minibatches": minibatches,
        "make_loss_fn": make_loss_fn,
        "actor_apply": actor_apply,
        "critic_apply": critic_apply,
    }


def make_train_iter(env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                    group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None) -> Callable:
    """train_iter(ts, env_state, obs, priv_obs, gen) ->
    (ts, env_state, obs, priv_obs, metrics); see make_train_pieces."""
    return make_train_pieces(env, net, cfg, num_envs, group, perm_seed)["train_iter"]


def group_grad_norms(net: ActorCritic, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A reading of an update, not a part of one: the gradient norm of
    `loss` over each disjoint parameter group of `net` alone, {"actor" (its
    layers and `std`), "critic", "estimator" (where the net has one)}. The
    squares of the groups' norms sum to the square of the global norm that
    `minibatch_update` clips."""
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    sq: Dict[str, torch.Tensor] = {}
    for name, g in zip(names, grads):
        group = "actor" if name == "std" else name.split(".", 1)[0]
        sq[group] = sq.get(group, 0.0) + torch.sum(torch.square(g))
    return {k: torch.sqrt(v) for k, v in sq.items()}
