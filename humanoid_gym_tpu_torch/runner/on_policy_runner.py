"""OnPolicyRunner: the training orchestration loop, on one device or one
rank of an env-sharded run.

Port of humanoid_gym_tpu/runner/on_policy_runner.py: the same scalar names
on TensorBoard and in metrics.jsonl, the same console line, a checkpoint
every save_interval, resumable. The per-iteration work (rollout + GAE +
update) is `algo.ppo.make_train_iter`; the runner adds no arithmetic.

Under env sharding the env's group (`env.group`, from `registry.make_env(
..., group=)`) makes this process one rank: the parameters are broadcast
from rank 0 at start; the action noise draws from the rank's own seed, the
minibatch permutation and the random episode lengths from the run's seed
on every rank; TensorBoard, metrics.jsonl, the console and the model
checkpoints are rank 0's, while every rank keeps rank 0's (broadcast)
checkpoint directory. The final checkpoint's env state is one file per
rank, `<path>.envshard<rank>`, which `load` reads back, raising on another
world size or env count.

Metrics stay on the device until they are logged. Logging is double
buffered: iteration i+1 is enqueued before iteration i's metrics are read,
and on the card the read waits on an event recorded after a non-blocking
copy into pinned memory, so it never waits for the newer iteration.

With HGT_PROFILE_DIR set, the second iteration of `learn` (the first
builds and warms up) runs under `torch.profiler` and ends in a
synchronisation inside the trace; the profiler writes a Chrome trace
(`trace_iter<N>.json`, `trace_iter<N>_rank<r>.json` under sharding) into
that directory and the runner prints where. Without the variable nothing
of `learn` changes.

Checkpoints are `torch.save` files of tensors and plain Python values:
the train state (net weights, Adam moments and count, adaptive learning
rate, iteration), the resolved net compute dtype, and on the final
checkpoint the env state with its observations (for a joint env, the list
of its sub-envs' states).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from collections import deque
from typing import Optional

import torch

from ..algo.networks import actor_critic_from_cfg, dtype_name, resolve_compute_dtype
from ..algo.ppo import PPOConfig, init_train_state, make_train_iter
from ..envs.state import EnvState
from ..parallel.mesh import replicate
from ..parallel.multihost import broadcast_str, rank_seed, shard_path


def _atomic_save(obj, path: str) -> None:
    """torch.save into `<path>.tmp`, then rename: a reader that lists
    `model_*.ckpt` while training runs (the eval scripts' watch modes)
    never opens a half-written checkpoint."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _state_to_dict(obj) -> dict:
    """A (nested) state dataclass as a dict of CPU tensors."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _state_to_dict(v) if dataclasses.is_dataclass(v) else v.detach().cpu()
    return out


def _env_state_to_saved(state):
    """An env state (an EnvState, or a joint env's list of them) as CPU
    tensors in dicts."""
    if isinstance(state, list):
        return [_state_to_dict(s) for s in state]
    return _state_to_dict(state)


def _env_state_from_saved(saved, template):
    """The inverse of `_env_state_to_saved` on the template's devices;
    raises ValueError on a mismatch of the sub-env or env counts, KeyError
    on a missing field."""
    if isinstance(template, list):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError("ckpt env state does not hold one state per sub-env")
        return [_env_state_from_dict(d, t, t.episode_length.shape[0])
                for d, t in zip(saved, template)]
    if isinstance(saved, list):
        raise ValueError("ckpt env state is a joint env's, the env is not joint")
    return _env_state_from_dict(saved, template, template.episode_length.shape[0])


def _env_state_from_dict(d: dict, template: EnvState, num_envs: int) -> EnvState:
    """The inverse of `_state_to_dict` for an EnvState, on the template's
    device; raises ValueError on an env-count mismatch, KeyError on a
    missing field."""
    def leaves(dd, tmpl, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            t = getattr(tmpl, f.name)
            if dataclasses.is_dataclass(t):
                kw[f.name] = leaves(dd[f.name], t, type(t))
                continue
            v = dd[f.name]
            if v.shape[:1] != (num_envs,):
                raise ValueError(f"ckpt env batch {v.shape[0]} != num_envs {num_envs}")
            kw[f.name] = v.to(device=t.device, dtype=t.dtype)
        return cls(**kw)

    return leaves(d, template, EnvState)


class OnPolicyRunner:
    def __init__(self, env, train_cfg, log_dir: Optional[str] = None, seed: Optional[int] = None):
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        self.seed = train_cfg.seed if seed is None else seed
        self.device = env.device
        self.group = env.group
        self.is_main_process = self.group is None or self.group.is_main

        self.num_envs = env.num_envs_global
        self.num_steps_per_env = train_cfg.runner.num_steps_per_env
        self.save_interval = train_cfg.runner.save_interval

        self.net = actor_critic_from_cfg(env.cfg.env, train_cfg.policy, seed=self.seed).to(self.device)
        replicate(list(self.net.parameters()), self.group)
        algo_cfg = PPOConfig.from_cfg(train_cfg.algorithm)
        algo_cfg.num_steps_per_env = self.num_steps_per_env
        self.algo_cfg = algo_cfg
        self.train_state = init_train_state(self.net, algo_cfg.learning_rate)

        # the action noise of this rank's envs; the minibatch permutation
        # and the random episode lengths draw from the run's seed, the same
        # on every rank, and the env from its own generator
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(rank_seed(self.seed, self.group))

        # env state + first obs (reference on_policy_runner.py:91 env.reset())
        self.env_state, self.obs, self.priv_obs = env.reset_all()
        self._train_iter = make_train_iter(env, self.net, algo_cfg, self.num_envs, self.group,
                                           perm_seed=self.seed)

        # every rank keeps rank 0's checkpoint directory (each would name a
        # timestamped one by its own clock); the log sinks are rank 0's
        self._ckpt_dir = broadcast_str(log_dir, self.group) or None
        if self._ckpt_dir:
            os.makedirs(self._ckpt_dir, exist_ok=True)
        if not self.is_main_process:
            log_dir = self.log_dir = None
        self.last_scalars = None
        self.writer = None
        self.wandb_run = None
        self._metrics_file = None
        self.current_learning_iteration = 0
        self.rewbuffer = deque(maxlen=100)
        self.lenbuffer = deque(maxlen=100)
        self.tot_timesteps = 0
        self.tot_time = 0.0
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._metrics_file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=log_dir, flush_secs=10)
            except Exception:
                self.writer = None
            # wandb is an optional sink; HGT_WANDB=0 turns it off
            if os.environ.get("HGT_WANDB", "1") != "0":
                try:
                    import wandb

                    self.wandb_run = wandb.init(
                        project=os.environ.get("HGT_WANDB_PROJECT", "XBot"),
                        sync_tensorboard=True, dir=log_dir, name=os.path.basename(log_dir),
                    )
                except Exception:
                    self.wandb_run = None

    # ------------------------------------------------------------------ #

    def _start_fetch(self, metrics: dict):
        """Begin moving one iteration's metrics to the host. On the card:
        non-blocking copies into pinned memory and an event after them; on
        the CPU the tensors are already there."""
        if self.device.type != "cuda":
            return metrics, None
        host = {}
        for k, v in metrics.items():
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v.detach(), non_blocking=True)
            host[k] = buf
        event = torch.cuda.Event()
        event.record()
        return host, event

    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = False):
        if init_at_random_ep_len:
            # (reference on_policy_runner.py:103-106): drawn for the global
            # batch from the run's seed, each rank taking its envs' lengths
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            ep_len = torch.randint(
                0, self.env.max_episode_length, (self.num_envs,), generator=gen,
                device=self.device, dtype=torch.int32,
            )[self.env.global_env_ids().to(self.device)]
            if isinstance(self.env_state, list):  # a joint env: one slice per sub-env
                parts = torch.split(ep_len, [st.episode_length.shape[0] for st in self.env_state])
                self.env_state = [st.replace(episode_length=p)
                                  for st, p in zip(self.env_state, parts)]
            else:
                self.env_state = self.env_state.replace(episode_length=ep_len)

        start_iter = self.current_learning_iteration
        tot_iter = start_iter + num_learning_iterations
        steps_per_iter = self.num_steps_per_env * self.num_envs

        profile_dir = os.environ.get("HGT_PROFILE_DIR")
        pending = None  # (it, seconds since the previous dispatch, metrics, event)
        t_prev = time.time()

        def consume(p_it, p_dt, metrics, event):
            if event is not None:
                event.synchronize()
            self.tot_timesteps += steps_per_iter
            self.tot_time += p_dt
            n_resets = float(metrics["ep_reset_count"])
            if n_resets > 0:
                self.rewbuffer.append(float(metrics["ep_reward_sum"]) / n_resets)
                self.lenbuffer.append(float(metrics["ep_len_sum"]) / n_resets)
            fps = steps_per_iter / max(p_dt, 1e-9)
            self._log(p_it, tot_iter, metrics, fps, p_dt, n_resets)

        for it in range(start_iter, tot_iter):
            prof = self._start_profile() if profile_dir and it == start_iter + 1 else None
            self.train_state, self.env_state, self.obs, self.priv_obs, metrics = self._train_iter(
                self.train_state, self.env_state, self.obs, self.priv_obs, self.gen
            )
            if prof is not None:
                self._write_profile(prof, profile_dir, it)
            fetch = self._start_fetch(metrics)
            if pending is not None:
                consume(*pending)
            now = time.time()
            pending = (it, now - t_prev, *fetch)
            t_prev = now
            self.current_learning_iteration = it + 1
            if self.log_dir and (it % self.save_interval == 0):
                self.save(os.path.join(self.log_dir, f"model_{it}.ckpt"))
        if pending is not None:
            consume(*pending)
        if self._ckpt_dir:
            # the final checkpoint bundles the env state (command ranges, DR
            # draws, histories) with its observations, so a resumed run
            # continues from the same envs; every rank writes its shard
            self.save(
                os.path.join(self._ckpt_dir, f"model_{self.current_learning_iteration}.ckpt"),
                include_env_state=True,
            )
        self.close()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _write_profile(self, prof, profile_dir: str, it: int):
        """Wait for the profiled iteration's device work, stop the profiler
        and write its Chrome trace into profile_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        rank = f"_rank{self.group.rank}" if self.group is not None and self.group.world > 1 else ""
        path = os.path.join(profile_dir, f"trace_iter{it}{rank}.json")
        prof.export_chrome_trace(path)
        print(f"[profiler] trace written to {path}", flush=True)

    def close(self):
        """Flush and release the log sinks."""
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
            self.writer = None
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None
        if self.wandb_run is not None:
            try:
                self.wandb_run.finish()
            except Exception:
                pass
            self.wandb_run = None

    # ------------------------------------------------------------------ #

    def _log(self, it, tot_iter, metrics, fps, dt_iter, n_resets):
        mean_rew = statistics.mean(self.rewbuffer) if self.rewbuffer else 0.0
        mean_len = statistics.mean(self.lenbuffer) if self.lenbuffer else 0.0
        scalars = {
            "Loss/value_function": float(metrics["value_loss"]),
            "Loss/surrogate": float(metrics["surrogate_loss"]),
            "Loss/entropy": float(metrics["entropy"]),
            "Loss/learning_rate": float(metrics["lr"]),
            "Loss/kl": float(metrics["kl"]),
            "Loss/estimator": float(metrics["estimator_loss"]),
            "Policy/mean_noise_std": float(metrics["action_std_mean"]),
            "Perf/total_fps": fps,
            "Perf/iter_time": dt_iter,
            "Train/mean_reward": mean_rew,
            "Train/mean_episode_length": mean_len,
            "Train/mean_step_reward": float(metrics["mean_step_reward"]),
            "Train/nonfinite_resets": float(metrics["nonfinite_resets"]),
            "Episode/terrain_level": float(metrics["mean_terrain_level"]),
        }
        # per-term episode reward means (reference Episode/rew_* scalars)
        if n_resets > 0:
            for name, s in zip(self.env.reward_names, metrics["ep_term_sums"].tolist()):
                scalars[f"Episode/rew_{name}"] = float(s) / n_resets
        self.last_scalars = scalars
        if not self.is_main_process:
            return
        if self.writer:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, it)
        if self._metrics_file:
            self._metrics_file.write(json.dumps({"iter": it, **scalars}) + "\n")
            self._metrics_file.flush()
        eta = (tot_iter - it - 1) * dt_iter
        print(
            f"it {it}/{tot_iter} | fps {fps:,.0f} | rew {mean_rew:.2f} | "
            f"len {mean_len:.0f} | vloss {scalars['Loss/value_function']:.3f} | "
            f"lr {scalars['Loss/learning_rate']:.1e} | "
            f"std {scalars['Policy/mean_noise_std']:.2f} | eta {eta/60:.1f}m",
            flush=True,
        )

    # ------------------------------------------------------------------ #

    def _resolved_dtype(self) -> str:
        return dtype_name(resolve_compute_dtype(self.net.compute_dtype, self.device))

    def _honor_ckpt_dtype(self, recorded):
        """Checkpoints record the RESOLVED net compute dtype: "auto" is
        bf16 on the card and f32 on the CPU, so a checkpoint trained on one
        would silently continue under the other's numerics. If the task
        config left the dtype on "auto" and the checkpoint disagrees with
        the local resolution, the net switches to the checkpoint's dtype;
        an explicit per-task pin wins but the mismatch is reported."""
        if not recorded:
            return
        current = self._resolved_dtype()
        if recorded == current:
            return
        if self.net.compute_dtype not in (None, "", "auto"):
            print(
                f"[runner] WARNING: checkpoint was trained with compute_dtype={recorded} but "
                f"policy.compute_dtype pins {self.net.compute_dtype}; keeping the explicit pin.",
                flush=True,
            )
            return
        print(
            f"[runner] checkpoint records compute_dtype={recorded} (local 'auto' resolves to "
            f"{current}); honoring the checkpoint.",
            flush=True,
        )
        self.net.set_compute_dtype(recorded)

    def save(self, path: str, include_env_state: bool = False):
        """Rank 0 writes the model checkpoint `path`. With the env state:
        at world size 1 it goes into `path`; under sharding every rank
        writes its own `<path>.envshard<rank>` and the ranks then wait for
        each other, so every shard is on disk when any rank returns."""
        sharded = self.group is not None and self.group.world > 1
        if include_env_state and sharded:
            torch.save({
                "env_state": _env_state_to_saved(self.env_state),
                "obs": self.obs.detach().cpu(),
                "priv_obs": self.priv_obs.detach().cpu(),
                "world": self.group.world,
            }, shard_path(path, self.group.rank))
        if self.is_main_process:
            self._save_model(path, include_env_state and not sharded,
                             self.group.world if include_env_state and sharded else None)
        if include_env_state and sharded:
            self.group.barrier()

    def _save_model(self, path: str, include_env_state: bool, env_shards):
        ts = self.train_state
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        payload = {
            "train_state": {
                "net": cpu(ts.net.state_dict()),
                "opt_mu": cpu(ts.opt_mu),
                "opt_nu": cpu(ts.opt_nu),
                "opt_count": int(ts.opt_count),
                "lr": ts.lr.detach().cpu(),
                "iteration": int(ts.iteration),
            },
            "iter": self.current_learning_iteration,
            "compute_dtype": self._resolved_dtype(),
        }
        if env_shards:
            payload["env_shards"] = env_shards
        if include_env_state:
            payload["env_state"] = _env_state_to_saved(self.env_state)
            # the obs that correspond to that state, so the first resumed
            # rollout step is exactly on-policy
            payload["obs"] = self.obs.detach().cpu()
            payload["priv_obs"] = self.priv_obs.detach().cpu()
        _atomic_save(payload, path)

    def load(self, path: str, load_optimizer: bool = True):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self._honor_ckpt_dtype(payload.get("compute_dtype"))
        saved, ts = payload["train_state"], self.train_state
        ts.net.load_state_dict(saved["net"])
        if load_optimizer:
            for mine, theirs in ((ts.opt_mu, saved["opt_mu"]), (ts.opt_nu, saved["opt_nu"])):
                for k in mine:
                    mine[k].copy_(theirs[k])
            ts.opt_count = int(saved["opt_count"])
        ts.lr = saved["lr"].to(self.device)
        ts.iteration = int(saved["iteration"])
        self.current_learning_iteration = int(payload.get("iter", 0))
        world = 1 if self.group is None else self.group.world
        shards = payload.get("env_shards")
        if shards is not None or (world > 1 and "env_state" in payload):
            if shards != world:
                raise ValueError(f"ckpt env state has {shards or 1} shard(s), "
                                 f"the run has {world} rank(s)")
            shard = torch.load(shard_path(path, self.group.rank), map_location="cpu",
                               weights_only=True)
            self.env_state = _env_state_from_saved(shard["env_state"], self.env_state)
            self.obs = shard["obs"].to(self.device)
            self.priv_obs = shard["priv_obs"].to(self.device)
            return payload.get("infos")
        # bundled env state (final checkpoints): restored when the env count
        # matches, skipped otherwise (an eval runner of another size)
        es = payload.get("env_state")
        if es is not None:
            try:
                self.env_state = _env_state_from_saved(es, self.env_state)
                if payload.get("obs") is not None:
                    self.obs = payload["obs"].to(self.device)
                    self.priv_obs = payload["priv_obs"].to(self.device)
            except (ValueError, KeyError) as e:
                print(f"[runner] env state in ckpt not restored: {e}")
        return payload.get("infos")

    def get_inference_policy(self):
        """Deterministic policy obs -> action mean."""
        net = self.net

        @torch.no_grad()
        def policy(obs):
            return net.act(obs)[0]

        return policy
