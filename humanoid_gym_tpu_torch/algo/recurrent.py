"""The PPO training iteration of a recurrent net (rsl_rl's
ActorCriticRecurrent, `networks.ActorCriticRecurrent`): rsl_rl's
rollout, storage and update with its memory, on `algo/ppo.py`'s loss,
optimizer step and metrics.

- Rollout. At each env step both memories take one cell step (the actor's
  on the obs, the critic's on the privileged obs; stage `rollout.memory`,
  inside `rollout.policy`), and after the env step h and c are zeroed for
  the envs that are done (rsl_rl's `reset(dones)`; stage `rollout.memory`,
  inside `rollout.store`). The buffers are `ppo.Rollout`'s; beside them
  the rollout keeps the memory's state before row 0 (`memory0`), which the
  update's scans start from. The state lives in the train state
  (`TrainState.memory`), written in place at the end of the rollout, and
  carries into the next iteration: rsl_rl does not reset it when an
  iteration starts.
- Last value. rsl_rl's `compute_returns` evaluates the critic on the last
  privileged obs in inference mode, where `Memory.forward` keeps the state
  it returns; so the critic's memory takes one more step here, from the
  state after the last row, and the next iteration starts from it (and its
  row 0 steps the critic on the same obs again, as rsl_rl's does).
- Update. Minibatches are whole env rows: a permutation of the envs drawn
  from the iteration's seed (`ppo.permutation_seed`), cut into
  num_mini_batches blocks of num_envs / num_mini_batches envs, the same
  blocks in every epoch. Each minibatch's memories run over its T rows from
  the state the rows started the rollout with, h and c zeroed after each
  done: at static shapes, the result of rsl_rl's
  `split_and_pad_trajectories` and its padded BPTT, the padding left out of
  the loss. The loss sums over the T x envs rows. The scan's forward and
  its backward are the stage `update.bptt`, inside `update.grad`: the
  gradient is taken in two parts, the loss's down to the memories' outputs
  (and the heads' parameters), then the memories' parameters' from there,
  so that the scan's backward has stamps of its own. The two parts launch
  the same kernels as one `autograd.grad` over every parameter (on an H100
  at 4,096 envs: 61,915 a traced iteration either way, the replay 151.74
  against 151.76 ms).

One rank only: under a group of several ranks it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import EnvGroup
from ..physics.kinematics import use_full_f32_matmul
from ..utils.tracing import ROOT, stage
from . import ppo
from .networks import (ActorCriticRecurrent, lstm_scan, normal_log_prob, reset_memory,
                       resolve_compute_dtype)


def make_recurrent_pieces(env, net: ActorCriticRecurrent, cfg: ppo.PPOConfig, num_envs: int,
                          group: Optional[EnvGroup] = None,
                          perm_seed: Optional[int] = None) -> dict:
    """`ppo.make_train_pieces` for a recurrent net: train_iter = the env
    permutation (`draw_permutation`), then `iteration_body` (rollout_phase
    -> compute_gae -> minibatches -> num_learning_epochs x
    minibatch_update -> the metrics); see the module docstring."""
    if group is not None and group.world > 1:
        raise ValueError("the recurrent policy trains on one rank; its minibatches of env rows "
                         "have no split over ranks")
    use_full_f32_matmul()
    T, n_mb = cfg.num_steps_per_env, cfg.num_mini_batches
    batch = T * num_envs
    mb_envs = num_envs // n_mb
    mem_names = {f"memory_{k}.{n}" for k in "ac" for n, _ in net.memory_a.named_parameters()}

    @torch.no_grad()
    def rollout_phase(ts: ppo.TrainState, env_state, obs, priv_obs, gen):
        dev = obs.device
        A = ts.net.num_actions
        n = obs.shape[0]
        memory = ts.memory
        buf = ppo.Rollout(
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
        memory0 = tuple(m.clone() for m in memory)
        infos = []
        for t in range(T):
            with stage("rollout.policy"):
                with stage("rollout.memory"):
                    out_a, out_c, memory = ts.net.memory_steps(obs[None], priv_obs[None], memory)
                mean, std, value = ts.net.heads(out_a[0], out_c[0])
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
                with stage("rollout.memory"):
                    memory = reset_memory(memory, tr.done)
            infos.append(tr)
            obs, priv_obs = tr.obs, tr.privileged_obs
        for m, new in zip(ts.memory, memory):
            m.copy_(new)
        return env_state, obs, priv_obs, buf, memory0, infos

    @torch.no_grad()
    def compute_gae(ts: ppo.TrainState, roll, last_priv_obs):
        """The last value from one more step of the critic's memory, which
        keeps it (module docstring), then `ppo.normalized_gae`."""
        with stage("gae"):
            dt = resolve_compute_dtype(ts.net.compute_dtype, last_priv_obs.device)
            (out_c,), ((h, c),) = lstm_scan([ts.net.memory_c], [last_priv_obs[None]],
                                            [ts.memory[2:]], None, dt)
            ts.memory[2].copy_(h)
            ts.memory[3].copy_(c)
            last_value = ts.net.critic(out_c[0])[..., 0]
            return ppo.normalized_gae(cfg, roll, last_value, group)

    def draw_permutation(ts: ppo.TrainState, gen):
        """The env permutation of iteration `ts.iteration` (`ppo.seeded_permutation`)."""
        return ppo.seeded_permutation(num_envs, ts.iteration, gen, perm_seed)

    def minibatches(roll, memory0, adv, ret, perm: torch.Tensor):
        """num_mini_batches tuples (obs, priv, actions, log_probs, values,
        adv, ret, mu, sigma, dones, memory0) of the env rows of each block
        of `perm`, each (T, envs, ...), memory0 (layers, envs, H) each."""
        data = (roll.obs, roll.priv_obs, roll.actions, roll.log_probs, roll.values, adv, ret,
                roll.mu, roll.sigma, roll.dones)
        return [tuple(x[:, envs] for x in data) + (tuple(m[:, envs] for m in memory0),)
                for envs in perm[:n_mb * mb_envs].view(n_mb, mb_envs)]

    def minibatch_update(ts: ppo.TrainState, mb):
        """One step on minibatch `mb`: the memories scanned over its rows,
        the loss of `ppo.loss_terms`, the gradient in two parts (module
        docstring), then `ppo.apply_update`."""
        net = ts.net
        obs, priv, act, old_logp, old_v, adv, ret, old_mu, old_sigma, dones, memory0 = mb
        names, params = zip(*net.named_parameters())
        with stage("update.grad"):
            with stage("update.bptt"):
                out_a, out_c, _ = net.memory_steps(obs, priv, memory0, dones)
            mean, std, value = net.heads(out_a, out_c)
            total, surr, value_loss, entropy, kl_sum = ppo.loss_terms(
                cfg, mean, std, value, act, old_logp, old_v, adv, ret, old_mu, old_sigma,
                torch.sum)
            sums = torch.stack([surr.detach(), value_loss.detach(), entropy.detach(), kl_sum,
                                torch.zeros((), device=obs.device)])
            head = [k for k in names if k not in mem_names]
            mem = [k for k in names if k in mem_names]
            by_name = dict(zip(names, params))
            *g_head, g_a, g_c = torch.autograd.grad(
                total, [by_name[k] for k in head] + [out_a, out_c], materialize_grads=True)
            with stage("update.bptt"):
                g_mem = torch.autograd.grad((out_a, out_c), [by_name[k] for k in mem],
                                            grad_outputs=(g_a, g_c), materialize_grads=True)
            grads = dict(zip(head, g_head)) | dict(zip(mem, g_mem))
            rows = torch.full((), float(old_logp.numel()), device=obs.device)
        with stage("update.adam"):
            return ppo.apply_update(cfg, ts, names, [grads[k] for k in names], sums, rows, group)

    def iteration_body(ts: ppo.TrainState, env_state, obs, priv_obs, gen, perm: torch.Tensor):
        """One iteration on the env permutation `perm` -> (env_state, obs,
        priv_obs, metrics); `ts`'s parameters, Adam state and memory are
        updated in place, `ts.iteration` left alone."""
        with stage(ROOT):
            env_state, obs, priv_obs, roll, memory0, infos = rollout_phase(
                ts, env_state, obs, priv_obs, gen)
            adv, ret = compute_gae(ts, roll, priv_obs)
            with stage("update.gather"):
                mbs = minibatches(roll, memory0, adv, ret, perm)
            ts, metrics = ppo.update_epochs(cfg, ts, mbs, minibatch_update)
            with stage("iter.metrics"):
                metrics = ppo.rollout_metrics(ts, metrics, infos, batch, group)
        return env_state, obs, priv_obs, metrics

    def train_iter(ts: ppo.TrainState, env_state, obs, priv_obs, gen):
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
        "minibatches": minibatches,
        "minibatch_update": minibatch_update,
    }

