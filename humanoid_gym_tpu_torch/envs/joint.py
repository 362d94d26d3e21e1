"""Joint multi-robot environment: heterogeneous robots in one batch.

Port of humanoid_gym_tpu/envs/joint.py. XBot-L and XBot-S share the
observation and action contract (47-dim frames x 15, 73 x 3 privileged, 12
actions), so one policy drives both: the batch is split at static
boundaries, each slice is stepped by its own robot's env (its own model,
gains, physics step and, on the card, its own mega-kernel launch with that
model's constants), and the transitions are concatenated along the env
axis. The joint state is the list of the sub-envs' EnvStates.

Under env sharding each rank holds its block of every sub-env (1/world of
each robot's envs), and the global env axis is the sub-envs' global
batches concatenated in order, as the JAX runner's list state, each
sub-env sharded over the env axis, lays it out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import EnvGroup
from ..parallel.multihost import rank_seed
from ..utils.tracing import robot, stage
from .env import HumanoidEnv, Transition


def sub_env_seed(seed: int, index: int) -> int:
    """The seed of sub-env `index`'s generator under the joint seed."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class JointEnv:
    """Wraps sub-envs with identical obs / action sizes into one batch of
    sum(counts) envs, counts[i] of sub-env i, concatenated in order. Offers
    the surface of HumanoidEnv that the trainer and the runner use."""

    def __init__(self, envs: Sequence[HumanoidEnv], counts: Sequence[int]):
        assert len(envs) == len(counts) and len(envs) >= 1
        e0 = envs[0]
        for e in envs[1:]:
            assert e.cfg.env.num_single_obs == e0.cfg.env.num_single_obs
            assert e.cfg.env.single_num_privileged_obs == e0.cfg.env.single_num_privileged_obs
            assert e.num_actions == e0.num_actions
            assert e.n_reward_terms == e0.n_reward_terms, (
                "reward term sets must match for concatenated episode sums")
            assert e.device == e0.device
        assert all(e.num_envs == c for e, c in zip(envs, counts))
        self.envs = list(envs)
        self.counts = list(counts)
        self.num_envs = sum(counts)
        self.num_actions = e0.num_actions
        self.cfg = e0.cfg
        self.dt = e0.dt
        self.device = e0.device
        self.max_episode_length = max(e.max_episode_length for e in envs)
        self.reward_names = e0.reward_names
        self.model = e0.model  # flagship model (for tooling that needs one)
        self.group = e0.group
        self.num_envs_global = sum(e.num_envs_global for e in envs)
        self._offsets = np.cumsum([0] + self.counts[:-1]).tolist()

    def global_env_ids(self) -> torch.Tensor:
        """The global env index of each env of the batch: sub-env i's
        indices shifted by the global counts of the sub-envs before it."""
        base = np.cumsum([0] + [e.num_envs_global for e in self.envs[:-1]]).tolist()
        return torch.cat([b + e.global_env_ids() for b, e in zip(base, self.envs)])

    def generators(self) -> list:
        """The sub-envs' generators, in order."""
        return [g for e in self.envs for g in e.generators()]

    def init_state(self) -> list:
        """The joint state: each sub-env's initial state, in order."""
        return [e.init_state() for e in self.envs]

    def step(self, state_list: List, actions: torch.Tensor):
        """Each sub-env's step on its slice of the actions, its stages
        traced under its robot index, then the transitions joined."""
        new_states, transitions = [], []
        for i, (e, c, off, st) in enumerate(zip(self.envs, self.counts, self._offsets,
                                                state_list)):
            with robot(i):
                ns, tr = e.step(st, actions[off:off + c])
            new_states.append(ns)
            transitions.append(tr)
        with stage("env.join"):
            joined = Transition(**{
                f.name: torch.cat([getattr(tr, f.name) for tr in transitions], dim=0)
                for f in dataclasses.fields(Transition)})
        return new_states, joined

    def reset_all(self):
        """Fresh joint state + first obs via a zero-action step."""
        state = self.init_state()
        zero = torch.zeros((self.num_envs, self.num_actions), device=self.device)
        state, tr = self.step(state, zero)
        return state, tr.obs, tr.privileged_obs


def make_joint_xbot_env(num_envs_l: int, num_envs_s: int, cfg_overrides=None, device="cuda",
                        seed: int = 0, group: Optional[EnvGroup] = None) -> JointEnv:
    """XBot-L + XBot-S in one batch of `num_envs_l` + `num_envs_s` global
    envs; `cfg_overrides` (a callable editing each sub-env's config)
    reaches both robots' env builds. Each sub-env draws from its own
    generator, seeded by `sub_env_seed(rank_seed(seed, group), index)`; under
    a group the world size must divide both counts."""
    from .. import registry

    seed = rank_seed(seed, group)
    env_l, _ = registry.make_env_block("humanoid_ppo", num_envs_l, cfg_overrides, device,
                                       sub_env_seed(seed, 0), group)
    env_s, _ = registry.make_env_block("humanoid_s_ppo", num_envs_s, cfg_overrides, device,
                                       sub_env_seed(seed, 1), group)
    return JointEnv([env_l, env_s], [env_l.num_envs, env_s.num_envs])
