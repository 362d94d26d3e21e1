"""HumanoidEnv: the XBot-L locomotion environment, batched.

Port of humanoid_gym_tpu/envs/env.py. One call of `step(state, actions)` keeps the reference's per-step order:

  action pipeline (ref-action add, clip, delay mix, multiplicative noise)
  -> decimation x 1 kHz PD physics (solver "mega": one kernel launch on
     the card; the other solvers: a loop of substeps)
  -> episode counters, base quantities
  -> command resample / heading / push
  -> termination probes
  -> reward terms + episode sums + only-positive clip + feet state (on the
     card one kernel launch, `envs/rewards.py` `make_rewards`)
  -> terrain curriculum (levels move on reset)
  -> masked auto-reset
  -> observations with frame stacking + noise
  -> last_* buffer rotation
  -> command curriculum (one lin_vel_x range for the whole batch)

Random draws come from one `torch.Generator` on the env's device (the JAX
package splits a per-env key). Masked draws (command resample, push, reset)
are made for every env each step, so the step never waits on the host;
the action delay and noise draws are skipped when their scale is zero.
Feet and knee kinematics come from the mega kernel's end-of-step `fk_out`
rows, or from `fk` / `body_velocities` with any other solver (static
dispatch, by solver type).

On terrain (`mesh_type` "heightfield" or "trimesh", built by `make_env`
from `cfg.terrain`): envs start at their subterrain's origin (level drawn in
[0, max_init_terrain_level], every row without the curriculum; type spread
over the env index; a level past the top row stands on the top row's
origin, as the JAX package's clamped gather puts it) with +-1 m of xy
jitter; the termination probes and
the measured heights read the 3-tap-min observation height function; the
physics resolves contacts on the bilinear surface with sloped frames; the
terrain curriculum moves a resetting env's level by distance walked or by
survival (`curriculum_mode`), with a random re-entry above the top level.

Under env sharding (`parallel/`) an env holds one rank's block of the
global batch: `env_offset` is its first global index and
`num_envs_global` the global count, so the terrain types spread over the
global index as the JAX package's `init_state(keys, idx)` spreads them, and
the command curriculum's mean over resetting envs is summed over the ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config.base import LeggedRobotCfg
from ..parallel.mesh import EnvGroup, all_reduce_sum
from ..physics import spatial as S
from ..physics.kinematics import body_velocities, fk, index_tensor, use_full_f32_matmul
from ..physics.model import RobotModel, build_model_from_urdf
from ..physics.step import PhysicsState, make_physics_step
from ..terrain.terrain import TerrainMap, flat_height_fn, make_height_fn
from ..utils.tracing import stage
from . import rewards as R
from .state import EnvState


@dataclass
class Transition:
    obs: torch.Tensor  # (N, num_observations)
    privileged_obs: torch.Tensor  # (N, num_privileged_obs)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor  # (N,) bool
    time_out: torch.Tensor  # (N,) bool
    ep_term_sums: torch.Tensor  # (N, n_terms) episode sums at reset / ep_len_s
    ep_reset_count: torch.Tensor  # (N,) int32
    ep_len_at_reset: torch.Tensor  # (N,) float
    ep_reward_at_reset: torch.Tensor  # (N,) float
    nonfinite: torch.Tensor  # (N,) int32 — env exploded and was auto-reset
    terrain_level: torch.Tensor  # (N,) float


def _match_gains(dof_names, table: dict, default: float = 0.0) -> np.ndarray:
    """Substring gain matching (reference legged_robot.py:487-501)."""
    out = np.full(len(dof_names), default, dtype=np.float32)
    for i, n in enumerate(dof_names):
        for key, val in table.items():
            if key in n:
                out[i] = val
    return out


class HumanoidEnv:
    """Holds the model, config-derived constants and the physics step; the
    state lives in EnvState tensors on `device`."""

    def __init__(
        self,
        cfg: LeggedRobotCfg,
        model: Optional[RobotModel] = None,
        num_envs: Optional[int] = None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        terrain_height_fn=None,
        terrain_origins: Optional[np.ndarray] = None,
        terrain_map: Optional[TerrainMap] = None,
        env_offset: int = 0,
        num_envs_global: Optional[int] = None,
        group: Optional[EnvGroup] = None,
    ):
        use_full_f32_matmul()
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_envs = num_envs or cfg.env.num_envs
        # this env's block of the global env axis, and the group whose
        # ranks hold the other blocks (None: one process holds them all)
        self.env_offset = env_offset
        self.num_envs_global = num_envs_global or self.num_envs
        self.group = group
        model = model or build_model_from_urdf(
            cfg.asset.file,
            dof_order=list(cfg.init_state.default_joint_angles.keys()),
            foot_name=cfg.asset.foot_name,
            knee_name=cfg.asset.knee_name,
            termination_names=tuple(cfg.asset.terminate_after_contacts_on),
            penalized_names=tuple(cfg.asset.penalize_contacts_on),
            armature=cfg.asset.armature,
            mesh_dir=cfg.asset.mesh_dir,
        )
        self.model = m = model.to(self.device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        self.gen = generator
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.dt  # policy dt
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self.default_dof_pos = t([cfg.init_state.default_joint_angles[n] for n in m.dof_names])
        self.p_gains = t(_match_gains(m.dof_names, cfg.control.stiffness))
        self.d_gains = t(_match_gains(m.dof_names, cfg.control.damping))
        self.torque_limits = m.dof_effort * cfg.safety.torque_limit
        self.max_episode_length = int(math.ceil(cfg.env.episode_length_s / self.dt))
        self.resampling_interval = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(math.ceil(cfg.domain_rand.push_interval_s / self.dt))

        # terrain: the observation height function (3-tap min on a
        # heightfield), the subterrain origins and the map the physics reads
        self.custom_origins = cfg.terrain.mesh_type in ("heightfield", "trimesh")
        self.terrain_height_fn = terrain_height_fn or flat_height_fn
        self.terrain_map = terrain_map
        self.terrain_origins = None if terrain_origins is None else t(terrain_origins)
        self.max_terrain_level = cfg.terrain.num_rows

        self._kernel_fk = cfg.sim.solver.solver_type == "mega"
        self._phys_step = make_physics_step(
            m, cfg.sim.dt, cfg.control.decimation, self.p_gains, self.d_gains,
            self.torque_limits, solver_iterations=cfg.sim.solver.solver_iterations,
            solver=cfg.sim.solver.solver_type,
            max_depen_vel=cfg.sim.solver.max_depenetration_velocity,
            terrain_height_fn=self.terrain_height_fn, terrain_map=terrain_map,
        )
        if not all(int(b) == 0 for b in m.probe_point_body):
            raise ValueError("termination probes must all sit on the base")

        # reward stage: nonzero scales, premultiplied by dt; on the card one
        # kernel launch a step (envs/rewards.py make_rewards)
        self.rewards = R.make_rewards(cfg.rewards, self.dt, self.default_dof_pos,
                                      m.feet_body_idx, feet_base=self._kernel_fk)
        self.reward_names: Tuple[str, ...] = self.rewards.names
        self.reward_scales = self.rewards.scales
        self.termination_scale = self.rewards.termination_scale
        self.n_reward_terms = len(self.reward_names)

        ns, os_ = cfg.noise.noise_scales, cfg.normalization.obs_scales
        nv = np.zeros(cfg.env.num_single_obs, np.float32)
        nv[5:17] = ns.dof_pos * os_.dof_pos
        nv[17:29] = ns.dof_vel * os_.dof_vel
        nv[41:44] = ns.ang_vel * os_.ang_vel
        nv[44:47] = ns.quat * os_.quat
        self.noise_scale_vec = t(nv)
        self.commands_scale = t([os_.lin_vel, os_.lin_vel, os_.ang_vel])
        self._probe_body = np.asarray(m.probe_point_body)
        self._term_masks = [t(self._probe_body == b) > 0 for b in m.termination_body_idx]
        self._pen_masks = [t(self._probe_body == b) > 0 for b in m.penalized_body_idx]
        self._gravity_dir = t([0.0, 0.0, -1.0])
        # the step's and a reset's constants, made here once: a tensor built
        # from a Python list in the step is a copy from host memory, which
        # on the card waits for the host and cannot be captured in a CUDA graph
        rot = cfg.init_state.rot  # x, y, z, w
        self._init_pos = t(cfg.init_state.pos)
        self._init_quat = t([rot[3], rot[0], rot[1], rot[2]])
        self._init_vel = t(list(cfg.init_state.lin_vel) + list(cfg.init_state.ang_vel))
        self._forward = t([1.0, 0.0, 0.0])
        self._vx_range0 = t(cfg.commands.ranges.lin_vel_x)
        self._feet_idx = index_tensor(m.feet_body_idx, dev)
        self._knee_idx = index_tensor(m.knee_body_idx, dev)
        # height sample grid around the base (legged_robot.py:743-757), read
        # under the base yaw when terrain.measure_heights is on; appended to
        # the privileged frame as clip(root_z - 0.5 - h) * scale
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y), indexing="ij")
        self.height_points = t(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=-1))
        self.measure_heights = cfg.terrain.measure_heights and self.custom_origins

    # ------------------------------------------------------------------ #

    def _uniform(self, shape, lo, hi) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return lo + u * (hi - lo)

    def _sample_commands(self, old_commands: torch.Tensor, vx_range: torch.Tensor) -> torch.Tensor:
        """Resample commands (reference legged_robot.py:322-336)."""
        cr = self.cfg.commands.ranges
        n = old_commands.shape[0]
        vx = self._uniform((n,), vx_range[:, 0], vx_range[:, 1])
        vy = self._uniform((n,), cr.lin_vel_y[0], cr.lin_vel_y[1])
        if self.cfg.commands.heading_command:
            heading = self._uniform((n,), cr.heading[0], cr.heading[1])
            cmd = torch.stack([vx, vy, old_commands[:, 2], heading], dim=1)
        else:
            vyaw = self._uniform((n,), cr.ang_vel_yaw[0], cr.ang_vel_yaw[1])
            cmd = torch.stack([vx, vy, vyaw, old_commands[:, 3]], dim=1)
        keep = (torch.linalg.norm(cmd[:, :2], dim=1) > 0.2).to(cmd.dtype)
        return torch.cat([cmd[:, :2] * keep[:, None], cmd[:, 2:]], dim=1)

    def _ref_dof_pos(self, phase: torch.Tensor) -> torch.Tensor:
        sin_pos = torch.sin(2 * math.pi * phase)
        s1 = self.cfg.rewards.target_joint_pos_scale
        s2 = 2 * s1
        sin_l = torch.clamp(sin_pos, max=0.0)
        sin_r = torch.clamp(sin_pos, min=0.0)
        ref = torch.zeros((phase.shape[0], self.num_actions), device=self.device)
        ref[:, 2], ref[:, 3], ref[:, 4] = sin_l * s1, sin_l * s2, sin_l * s1
        ref[:, 8], ref[:, 9], ref[:, 10] = sin_r * s1, sin_r * s2, sin_r * s1
        return torch.where(torch.abs(sin_pos)[:, None] < 0.1, 0.0, ref)

    def _probe_flags(self, qpos: torch.Tensor):
        """Base-box corner penetration flags per termination / penalized
        body (probes all sit on the base; the ground by the observation
        height function)."""
        n = qpos.shape[0]
        if len(self._probe_body) == 0:
            z = torch.zeros((n, max(len(self._term_masks), 1)), dtype=torch.bool, device=self.device)
            return z, z
        offs = self.model.probe_point_offset  # (P,3)
        pos = qpos[:, None, :3] + S.quat_rotate(qpos[:, None, 3:7], offs[None])
        h = self.terrain_height_fn(pos[..., 0], pos[..., 1])
        pen = (pos[..., 2] - h) < 0.0
        term = torch.stack([torch.any(pen & mk, dim=1) for mk in self._term_masks], dim=1)
        pflags = torch.stack([torch.any(pen & mk, dim=1) for mk in self._pen_masks], dim=1)
        return term, pflags

    def _reset_phys(self, n: int, env_origin: torch.Tensor):
        """Fresh (qpos, qvel): default dofs + U(-0.1, 0.1) jitter, the init
        root pose at the env origin, +-1 m xy jitter on terrain origins
        (reference legged_robot.py:359-397)."""
        qj = self.default_dof_pos + self._uniform((n, self.model.nj), -0.1, 0.1)
        pos = self._init_pos + env_origin
        if self.custom_origins:
            pos = torch.cat([pos[:, :2] + self._uniform((n, 2), -1.0, 1.0), pos[:, 2:]], dim=1)
        qpos = torch.cat([pos, self._init_quat.expand(n, 4), qj], dim=1)
        qvel = torch.cat(
            [self._init_vel.expand(n, 6), torch.zeros((n, self.model.nj), device=self.device)],
            dim=1,
        )
        return qpos, qvel

    def _log_uniform(self, n, lo, hi):
        u = torch.rand((n,), generator=self.gen, device=self.device)
        return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))

    def init_state(self, n: Optional[int] = None) -> EnvState:
        """Initial batched state: friction/base-mass/contact/motor DR drawn
        once per env (reference legged_robot.py:257-269, 296-302), commands
        sampled."""
        n = n or self.num_envs
        m, cfg, dev = self.model, self.cfg, self.device
        dr = cfg.domain_rand
        ones = torch.ones((n,), device=dev)
        if dr.randomize_friction:
            # uniform per env: the same law as the reference's 256-bucket pick
            shape_friction = self._uniform((n,), *dr.friction_range)
        else:
            shape_friction = ones * cfg.terrain.static_friction
        friction = 0.5 * (shape_friction + cfg.terrain.static_friction)
        if dr.randomize_base_mass:
            base_mass = m.body_mass[0]
            mass_scale = (base_mass + self._uniform((n,), *dr.added_mass_range)) / base_mass
        else:
            mass_scale = ones.clone()
        cstiff = self._log_uniform(n, *dr.contact_stiffness_range) \
            if dr.randomize_contact_stiffness else ones.clone()
        coff = self._log_uniform(n, *dr.contact_offset_range) \
            if dr.randomize_contact_offset else ones * 0.01
        ccomp = self._log_uniform(n, *dr.contact_compliance_range) \
            if dr.randomize_contact_compliance else ones * 0.0
        if dr.randomize_motor_strength:
            ks = self._uniform((n, 2), *dr.motor_strength_range)
            kp_scale, kd_scale = ks[:, 0].contiguous(), ks[:, 1].contiguous()
        else:
            kp_scale, kd_scale = ones.clone(), ones.clone()
        slope_bias = self._uniform((n, 2), *dr.contact_slope_range) \
            if dr.randomize_contact_slope else torch.zeros((n, 2), device=dev)

        # terrain placement: a level below max_init (any row without the
        # curriculum), types spread evenly over the global env index
        # (legged_robot.py:694)
        if self.custom_origins and self.terrain_origins is not None:
            tc = cfg.terrain
            max_init = tc.max_init_terrain_level if tc.curriculum else tc.num_rows - 1
            level = torch.randint(0, max_init + 1, (n,), generator=self.gen, device=dev,
                                  dtype=torch.int32)
            idx = torch.arange(self.env_offset, self.env_offset + n, device=dev)
            ttype = (idx * tc.num_cols // max(self.num_envs_global, 1)).to(torch.int32)
            origin = self.terrain_origin(level, ttype)
        else:
            level = torch.zeros((n,), dtype=torch.int32, device=dev)
            ttype = torch.zeros((n,), dtype=torch.int32, device=dev)
            origin = torch.zeros((n, 3), device=dev)

        qpos, qvel = self._reset_phys(n, origin)
        phys = PhysicsState(
            qpos=qpos, qvel=qvel, friction=friction, base_mass_scale=mass_scale,
            contact_stiffness=cstiff, contact_offset=coff, contact_compliance=ccomp,
            kp_scale=kp_scale, kd_scale=kd_scale,
            contact_forces=torch.zeros((n, m.nbody, 3), device=dev),
            torques=torch.zeros((n, m.nj), device=dev),
            contact_lam=torch.zeros((n, 3 * m.ncon + m.nj), device=dev),
            slope_bias=slope_bias, fk_out=torch.zeros((n, 14), device=dev),
        )
        na, nj = self.num_actions, m.nj
        z = lambda *s: torch.zeros((n,) + s, device=dev)  # noqa: E731
        vx_range = self._vx_range0.expand(n, 2).clone()
        quat = qpos[:, 3:7]
        return EnvState(
            phys=phys,
            episode_length=torch.zeros((n,), dtype=torch.int32, device=dev),
            common_step=torch.zeros((n,), dtype=torch.int32, device=dev),
            reset_buf=torch.ones((n,), dtype=torch.bool, device=dev),
            time_out_buf=torch.zeros((n,), dtype=torch.bool, device=dev),
            commands=self._sample_commands(z(4), vx_range),
            actions=z(na), last_actions=z(na), last_last_actions=z(na),
            last_dof_vel=z(nj), last_root_vel=z(6),
            feet_air_time=z(2),
            last_contacts=torch.zeros((n, 2), dtype=torch.bool, device=dev),
            feet_height=z(2), last_feet_z=torch.full((n, 2), 0.05, device=dev),
            ref_dof_pos=z(nj), rand_push_force=z(3), rand_push_torque=z(3),
            env_friction=shape_friction,
            obs_history=z(cfg.env.frame_stack, cfg.env.num_single_obs),
            critic_history=z(cfg.env.c_frame_stack, cfg.env.single_num_privileged_obs),
            base_lin_vel=z(3), base_ang_vel=z(3),
            base_euler=S.quat_to_euler_xyz(quat),
            projected_gravity=S.quat_rotate_inverse(quat, self._gravity_dir.expand(n, 3)),
            episode_sums=z(self.n_reward_terms),
            episode_reward=z(),
            cmd_vx_range=vx_range,
            terrain_level=level,
            terrain_type=ttype,
            env_origin=origin,
        )

    def terrain_origin(self, level: torch.Tensor, ttype: torch.Tensor) -> torch.Tensor:
        """The origin of subterrain (level, ttype), the level clamped to the
        top row: the state keeps a drawn level of up to
        max_init_terrain_level, which may equal num_rows, and the JAX
        package's gather clamps such an index (envs/env.py:401-412)."""
        return self.terrain_origins[torch.clamp(level.long(), max=self.max_terrain_level - 1),
                                    ttype.long()]

    def _terrain_curriculum(self, state: EnvState, qpos, commands, done, time_out, rand_level):
        """(level, env_origin) after the terrain curriculum
        (legged_robot.py:400-420; reference env.py:686-716): a resetting env
        moves up a level when it walked more than half a subterrain, down
        when it walked less than half its commanded distance
        ("distance"), or up when it timed out having covered half the
        commanded distance and down when it fell in the first half of the
        episode ("survival"); past the top row it re-enters at
        `rand_level`. Envs that do not reset keep theirs."""
        tc = self.cfg.terrain
        level, env_origin = state.terrain_level, state.env_origin
        dist = torch.linalg.norm(qpos[:, :2] - env_origin[:, :2], dim=1)
        need = torch.linalg.norm(commands[:, :2], dim=1) * self.cfg.env.episode_length_s * 0.5
        if getattr(tc, "curriculum_mode", "distance") == "survival":
            move_up = time_out & (dist >= need)
            move_down = ~time_out & (state.episode_length < self.max_episode_length // 2)
        else:
            move_up = dist > tc.terrain_length / 2
            move_down = (dist < need) & ~move_up
        new_level = level + move_up.to(level.dtype) - move_down.to(level.dtype)
        new_level = torch.where(new_level >= self.max_terrain_level, rand_level.to(level.dtype),
                                torch.clamp(new_level, min=0))
        level = torch.where(done, new_level, level)
        origin = self.terrain_origin(level, state.terrain_type)
        return level, torch.where(done[:, None], origin, env_origin)

    def _command_curriculum(self, vx_range, common_step, done, ep_term_sums):
        """The lin_vel_x range after the command curriculum (reference
        legged_robot.py:422-431; JAX package envs/env.py:897-936): every
        range widens by +-0.5 (clipped to max_curriculum) when the mean
        tracking_lin_vel episode reward over the envs resetting this step
        exceeds 80% of its per-step maximum, at most once per
        max_episode_length common steps. The count and the sum behind the
        mean are summed over the ranks, so every rank widens on the same
        step. As in the JAX package, this step's resetting envs drew their
        commands from the range before the update (a one-resample lag)."""
        cfg = self.cfg.commands
        if not cfg.curriculum or "tracking_lin_vel" not in self.reward_names:
            return vx_range
        ti = self.reward_names.index("tracking_lin_vel")
        n_reset, track_sum = all_reduce_sum(
            [done.sum().to(torch.float32), ep_term_sums[:, ti].sum()], self.group)
        # ep_term_sums = episode sums / episode_length_s at reset, so x dt
        # gives sums / max_episode_length
        mean_track = track_sum * self.dt / torch.clamp(n_reset, min=1.0)
        check = (common_step[0] % self.max_episode_length) == 0
        good = (n_reset > 0) & check & (mean_track > 0.8 * self.reward_scales[ti])
        mc = cfg.max_curriculum
        grown = torch.stack([torch.clamp(vx_range[:, 0] - 0.5, -mc, 0.0),
                             torch.clamp(vx_range[:, 1] + 0.5, 0.0, mc)], dim=-1)
        return torch.where(good, grown, vx_range)

    def global_env_ids(self) -> torch.Tensor:
        """The global env index of each of this env's envs, in order."""
        return torch.arange(self.env_offset, self.env_offset + self.num_envs)

    def generators(self) -> list:
        """The generators that `step` and `init_state` draw from."""
        return [self.gen]

    # ------------------------------------------------------------------ #

    def step(self, state: EnvState, policy_action: torch.Tensor):
        cfg, m, dev = self.cfg, self.model, self.device
        n = policy_action.shape[0]
        clip_a = cfg.normalization.clip_actions
        dr = cfg.domain_rand

        with stage("env.actions"):
            # ---- XBot action pipeline (humanoid_env.py:189-197) ----
            a = policy_action
            if cfg.env.use_ref_actions:
                a = a + 2.0 * state.ref_dof_pos
            a = torch.clamp(a, -clip_a, clip_a)
            if dr.action_delay != 0.0:
                delay = torch.rand((n, 1), generator=self.gen, device=dev) * dr.action_delay
                a = (1.0 - delay) * a + delay * state.actions
            if dr.action_noise != 0.0:
                a = a + dr.action_noise * torch.randn(a.shape, generator=self.gen, device=dev) * a
            actions = torch.clamp(a, -clip_a, clip_a)

        with stage("env.physics"):
            # ---- physics ----
            targets = actions * cfg.control.action_scale + self.default_dof_pos
            phys = self._phys_step(state.phys, targets)

        with stage("env.state"):
            # ---- post-physics base quantities ----
            finite = torch.all(torch.isfinite(phys.qpos), dim=1) & torch.all(torch.isfinite(phys.qvel), dim=1)
            episode_length = state.episode_length + 1
            common_step = state.common_step + 1
            quat = phys.qpos[:, 3:7]
            base_lin_vel = S.quat_rotate_inverse(quat, phys.qvel[:, 0:3])
            base_ang_vel = S.quat_rotate_inverse(quat, phys.qvel[:, 3:6])
            projected_gravity = S.quat_rotate_inverse(quat, self._gravity_dir.expand(n, 3))
            base_euler = S.quat_to_euler_xyz(quat)

            # ---- commands / heading / push ----
            resample = (episode_length % self.resampling_interval) == 0
            commands = torch.where(
                resample[:, None], self._sample_commands(state.commands, state.cmd_vx_range),
                state.commands,
            )
            if cfg.commands.heading_command:
                fwd = S.quat_rotate(quat, self._forward.expand(n, 3))
                heading = torch.atan2(fwd[:, 1], fwd[:, 0])
                cmd_yaw = torch.clamp(0.5 * S.wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
                commands = torch.cat(
                    [commands[:, :2], torch.where(finite, cmd_yaw, 0.0)[:, None], commands[:, 3:]], dim=1
                )

            rand_push_force, rand_push_torque = state.rand_push_force, state.rand_push_torque
            if dr.push_robots:
                dp = ((common_step % self.push_interval) == 0)[:, None]
                pf = self._uniform((n, 2), -dr.max_push_vel_xy, dr.max_push_vel_xy)
                pt = self._uniform((n, 3), -dr.max_push_ang_vel, dr.max_push_ang_vel)
                rand_push_force = torch.where(dp, torch.cat([pf, torch.zeros_like(pf[:, :1])], 1),
                                              rand_push_force)
                rand_push_torque = torch.where(dp, pt, rand_push_torque)
                qvel_pushed = torch.cat([pf, phys.qvel[:, 2:3], pt, phys.qvel[:, 6:]], dim=1)
                phys = phys.replace(qvel=torch.where(dp, qvel_pushed, phys.qvel))

            # ---- feet / knee kinematics ----
            if self._kernel_fk:
                # the mega kernel's end-of-step rows: positions base-relative,
                # velocities world-frame
                feet_rows = phys.fk_out
            else:
                # the same rows from fk / body_velocities, world-frame
                kfk = fk(m, phys.qpos)
                bv = body_velocities(m, phys.qpos, phys.qvel, kfk)
                pf, pk = kfk.p[:, self._feet_idx], kfk.p[:, self._knee_idx]
                vf = bv.v_origin[:, self._feet_idx]
                feet_rows = torch.cat([pf[..., 0], pf[..., 1], pf[..., 2], pk[..., 0], pk[..., 1],
                                       vf[..., 0], vf[..., 1]], dim=1)
            term_flags, pen_flags = self._probe_flags(phys.qpos)

            # ---- termination ----
            contact_term = torch.any(term_flags, dim=1) | ~finite
            time_out = episode_length > self.max_episode_length
            done = contact_term | time_out

            def safe(x, d=0.0):
                return torch.where(finite[:, None], torch.nan_to_num(x, nan=d, posinf=d, neginf=d),
                                   torch.full_like(x, d))

            base_lin_vel = safe(base_lin_vel)
            base_ang_vel = safe(base_ang_vel)
            base_euler = safe(base_euler)
            projected_gravity = torch.where(finite[:, None], projected_gravity, self._gravity_dir)

        with stage("env.rewards"):
            # ---- rewards: terms, episode sums, only-positive clip, feet state ----
            reward, episode_sums, fsu, contact = self.rewards(R.RewardInputs(
                episode_length=episode_length, qpos=phys.qpos, qvel=phys.qvel,
                last_dof_vel=state.last_dof_vel, actions=actions, last_actions=state.last_actions,
                last_last_actions=state.last_last_actions, torques=phys.torques,
                ref_dof_pos=state.ref_dof_pos, base_lin_vel=base_lin_vel,
                base_ang_vel=base_ang_vel, base_euler=base_euler,
                projected_gravity=projected_gravity, commands=commands,
                last_root_vel=state.last_root_vel, feet_rows=feet_rows,
                contact_forces=phys.contact_forces, collision_flags=pen_flags,
                feet_air_time=state.feet_air_time, last_contacts=state.last_contacts,
                feet_height=state.feet_height, last_feet_z=state.last_feet_z,
                episode_sums=state.episode_sums, finite=finite, done=done, time_out=time_out,
            ))

        with stage("env.reset"):
            # ---- terrain curriculum (legged_robot.py:400-420) ----
            level, env_origin = state.terrain_level, state.env_origin
            if cfg.terrain.curriculum and self.terrain_origins is not None:
                rand_level = torch.randint(0, self.max_terrain_level, (n,), generator=self.gen,
                                           device=dev)
                level, env_origin = self._terrain_curriculum(state, phys.qpos, commands, done,
                                                             time_out, rand_level)

            # ---- masked auto-reset ----
            d1 = done[:, None]
            qpos_r, qvel_r = self._reset_phys(n, env_origin)
            phys = phys.replace(
                qpos=torch.where(d1, qpos_r, phys.qpos),
                qvel=torch.where(d1, qvel_r, phys.qvel),
                contact_lam=torch.where(d1, torch.zeros_like(phys.contact_lam), phys.contact_lam),
            )
            commands = torch.where(d1, self._sample_commands(commands, state.cmd_vx_range), commands)

            def zero_if_done(x):
                return torch.where(done.view((n,) + (1,) * (x.dim() - 1)), torch.zeros_like(x), x)

            actions_post = zero_if_done(actions)
            last_actions = zero_if_done(state.last_actions)
            feet_air_time = zero_if_done(fsu.feet_air_time)
            episode_length = torch.where(done, torch.zeros_like(episode_length), episode_length)
            obs_history = zero_if_done(state.obs_history)
            critic_history = zero_if_done(state.critic_history)
            ep_term_sums = torch.where(d1, episode_sums / cfg.env.episode_length_s,
                                       torch.zeros_like(episode_sums))
            ep_len_at_reset = torch.where(done, state.episode_length + 1, 0).to(torch.float32)
            episode_reward = state.episode_reward + reward
            ep_reward_at_reset = torch.where(done, episode_reward, 0.0)
            episode_reward = torch.where(done, 0.0, episode_reward)
            episode_sums = zero_if_done(episode_sums)
            cmd_vx_range = self._command_curriculum(state.cmd_vx_range, common_step, done,
                                                    ep_term_sums)
            quat_post = phys.qpos[:, 3:7]
            base_euler = torch.where(d1, S.quat_to_euler_xyz(quat_post), base_euler)
            projected_gravity = torch.where(
                d1, S.quat_rotate_inverse(quat_post, self._gravity_dir.expand(n, 3)), projected_gravity
            )

        with stage("env.obs"):
            # ---- observations (humanoid_env.py:200-262) ----
            phase = R.gait_phase(episode_length, self.dt, cfg.rewards.cycle_time)
            sin_pos = torch.sin(2 * math.pi * phase)
            cos_pos = torch.cos(2 * math.pi * phase)
            ref_dof_pos = self._ref_dof_pos(phase)
            stance_mask_obs = R.stance_mask(phase)
            os_ = cfg.normalization.obs_scales
            command_input = torch.cat(
                [sin_pos[:, None], cos_pos[:, None], commands[:, :3] * self.commands_scale], dim=1
            )
            dof_pos = phys.qpos[:, 7:]
            dof_vel = phys.qvel[:, 6:]
            q = (dof_pos - self.default_dof_pos) * os_.dof_pos
            dq = dof_vel * os_.dof_vel
            single_obs = torch.cat(
                [command_input, q, dq, actions_post, base_ang_vel * os_.ang_vel, base_euler * os_.quat],
                dim=1,
            )
            single_priv = torch.cat(
                [
                    command_input, q, dq, actions_post, dof_pos - ref_dof_pos,
                    base_lin_vel * os_.lin_vel, base_ang_vel * os_.ang_vel, base_euler * os_.quat,
                    rand_push_force[:, :2], rand_push_torque, state.env_friction[:, None],
                    (m.body_mass[0] * phys.base_mass_scale)[:, None] / 30.0,
                    stance_mask_obs, contact.to(torch.float32),
                ],
                dim=1,
            )
            if self.measure_heights:
                # yaw-rotated sample grid around the base (legged_robot.py:759-795)
                pts = S.quat_apply_yaw(quat_post[:, None, :],
                                       self.height_points.expand(n, -1, -1))
                h = self.terrain_height_fn(pts[..., 0] + phys.qpos[:, 0:1], pts[..., 1] + phys.qpos[:, 1:2])
                h_obs = torch.clamp(phys.qpos[:, 2:3] - 0.5 - h, -1.0, 1.0) * os_.height_measurements
                single_priv = torch.cat([single_priv, h_obs], dim=1)
            if single_obs.shape[1] != cfg.env.num_single_obs:
                raise ValueError(f"obs frame {single_obs.shape[1]} != {cfg.env.num_single_obs}")
            if single_priv.shape[1] != cfg.env.single_num_privileged_obs:
                raise ValueError(f"priv frame {single_priv.shape[1]} != "
                                 f"{cfg.env.single_num_privileged_obs}")
            if cfg.noise.add_noise:
                single_obs = single_obs + (
                    torch.randn(single_obs.shape, generator=self.gen, device=dev)
                    * self.noise_scale_vec * cfg.noise.noise_level
                )
            obs_history = torch.cat([obs_history[:, 1:], single_obs[:, None]], dim=1)
            critic_history = torch.cat([critic_history[:, 1:], single_priv[:, None]], dim=1)
            clip_o = cfg.normalization.clip_observations
            obs = torch.clamp(obs_history.reshape(n, -1), -clip_o, clip_o)
            priv_obs = torch.clamp(critic_history.reshape(n, -1), -clip_o, clip_o)

            new_state = EnvState(
                phys=phys,
                episode_length=episode_length,
                common_step=common_step,
                reset_buf=done,
                time_out_buf=time_out,
                commands=commands,
                actions=actions_post,
                last_actions=actions_post,
                last_last_actions=last_actions,
                last_dof_vel=dof_vel,
                last_root_vel=phys.qvel[:, 0:6],
                feet_air_time=feet_air_time,
                last_contacts=fsu.last_contacts,
                feet_height=fsu.feet_height,
                last_feet_z=fsu.last_feet_z,
                ref_dof_pos=ref_dof_pos,
                rand_push_force=rand_push_force,
                rand_push_torque=rand_push_torque,
                env_friction=state.env_friction,
                obs_history=obs_history,
                critic_history=critic_history,
                base_lin_vel=base_lin_vel,
                base_ang_vel=base_ang_vel,
                base_euler=base_euler,
                projected_gravity=projected_gravity,
                episode_sums=episode_sums,
                episode_reward=episode_reward,
                cmd_vx_range=cmd_vx_range,
                terrain_level=level,
                terrain_type=state.terrain_type,
                env_origin=env_origin,
            )
            trans = Transition(
                obs=obs,
                privileged_obs=priv_obs,
                reward=reward,
                done=done,
                time_out=time_out,
                ep_term_sums=ep_term_sums,
                ep_reset_count=done.to(torch.int32),
                ep_len_at_reset=ep_len_at_reset,
                ep_reward_at_reset=ep_reward_at_reset,
                nonfinite=(~finite).to(torch.int32),
                terrain_level=level.to(torch.float32),
            )
            return new_state, trans

    def reset_all(self):
        """Fresh batched state + first obs via a zero-action step
        (reference legged_robot.py:112-117 reset())."""
        state = self.init_state()
        zero = torch.zeros((self.num_envs, self.num_actions), device=self.device)
        state, trans = self.step(state, zero)
        return state, trans.obs, trans.privileged_obs


def make_env(cfg: LeggedRobotCfg, num_envs: Optional[int] = None, device="cuda", **kw) -> HumanoidEnv:
    """Build an env on `device` (default: the card), synthesizing the
    terrain from `cfg.terrain` (seeded `default_rng(0)`, as the JAX
    package does) when the config asks for a heightfield; `terrain_map`,
    `terrain_origins` and `terrain_height_fn` passed in take precedence."""
    if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
        tmap = kw.get("terrain_map") or TerrainMap.build(cfg.terrain, np.random.default_rng(0))
        kw.setdefault("terrain_height_fn", make_height_fn(tmap, device))
        kw.setdefault("terrain_origins", tmap.env_origins)
        kw.setdefault("terrain_map", tmap)
    return HumanoidEnv(cfg, num_envs=num_envs, device=device, **kw)
