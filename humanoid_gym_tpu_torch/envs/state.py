"""EnvState: the complete batched per-env state.

Port of humanoid_gym_tpu/envs/state.py. Every field carries the env axis
first; the env's step builds a new EnvState each policy step. The JAX
package keeps a per-env PRNG key in the state; the port draws from one
`torch.Generator` held by the env instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..physics.step import PhysicsState


@dataclass
class EnvState:
    phys: PhysicsState

    # episode bookkeeping
    episode_length: torch.Tensor  # (N,) int32, steps since reset
    common_step: torch.Tensor  # (N,) int32, total policy steps (push timing)
    reset_buf: torch.Tensor  # (N,) bool — this step ended in reset
    time_out_buf: torch.Tensor  # (N,) bool — reset was a timeout

    commands: torch.Tensor  # (N, 4) [vx, vy, vyaw, heading]

    # action pipeline
    actions: torch.Tensor  # (N, na) current clipped actions
    last_actions: torch.Tensor  # (N, na)
    last_last_actions: torch.Tensor  # (N, na)
    last_dof_vel: torch.Tensor  # (N, nj)
    last_root_vel: torch.Tensor  # (N, 6) [lin, ang] world

    # gait / reward carried state
    feet_air_time: torch.Tensor  # (N, 2)
    last_contacts: torch.Tensor  # (N, 2) bool
    feet_height: torch.Tensor  # (N, 2)
    last_feet_z: torch.Tensor  # (N, 2)
    ref_dof_pos: torch.Tensor  # (N, nj) gait target from the last obs pass

    # push randomization
    rand_push_force: torch.Tensor  # (N, 3)
    rand_push_torque: torch.Tensor  # (N, 3)

    # per-env shape friction as reported in the privileged obs
    env_friction: torch.Tensor  # (N,)

    # frame-stacked histories, oldest first
    obs_history: torch.Tensor  # (N, frame_stack, num_single_obs)
    critic_history: torch.Tensor  # (N, c_frame_stack, single_num_privileged_obs)

    # base quantities cached at post-physics time
    base_lin_vel: torch.Tensor  # (N, 3) body frame
    base_ang_vel: torch.Tensor  # (N, 3) body frame
    base_euler: torch.Tensor  # (N, 3)
    projected_gravity: torch.Tensor  # (N, 3)

    episode_sums: torch.Tensor  # (N, n_reward_terms)
    episode_reward: torch.Tensor  # (N,)

    cmd_vx_range: torch.Tensor  # (N, 2) command-curriculum lin_vel_x range

    # terrain placement: the subterrain row (curriculum level) and column
    # (type) and its origin (flat ground: zeros)
    terrain_level: torch.Tensor  # (N,) int32
    terrain_type: torch.Tensor  # (N,) int32
    env_origin: torch.Tensor  # (N, 3)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)
