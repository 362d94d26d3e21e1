"""XBot-L task configuration.

Every number here reproduces the reference's frozen numerical contract
(reference: humanoid/envs/custom/humanoid_config.py:34-261). See SURVEY.md §2.4.
The PyTorch port's copy of humanoid_gym_tpu/config/xbotl.py.
"""

from __future__ import annotations

from . import base as B
from .. import XBOT_URDF

# DOF order is the URDF declaration order of the 12 actuated revolute joints
# (left leg 6, right leg 6) — same ordering the reference relies on
# (sim2sim.py:188-190 gain layout; humanoid_env.py:131-138 ref-gait indices).
XBOT_DOF_NAMES = [
    "left_leg_roll_joint",
    "left_leg_yaw_joint",
    "left_leg_pitch_joint",
    "left_knee_joint",
    "left_ankle_pitch_joint",
    "left_ankle_roll_joint",
    "right_leg_roll_joint",
    "right_leg_yaw_joint",
    "right_leg_pitch_joint",
    "right_knee_joint",
    "right_ankle_pitch_joint",
    "right_ankle_roll_joint",
]


def XBotLCfg() -> B.LeggedRobotCfg:
    cfg = B.LeggedRobotCfg()

    # env (humanoid_config.py:38-49)
    cfg.env.frame_stack = 15
    cfg.env.c_frame_stack = 3
    cfg.env.num_single_obs = 47
    cfg.env.num_observations = 15 * 47  # 705
    cfg.env.single_num_privileged_obs = 73
    cfg.env.num_privileged_obs = 3 * 73  # 219
    cfg.env.num_actions = 12
    cfg.env.num_envs = 4096
    cfg.env.episode_length_s = 24.0
    cfg.env.use_ref_actions = False

    # safety (humanoid_config.py:51-55)
    cfg.safety.pos_limit = 1.0
    cfg.safety.vel_limit = 1.0
    cfg.safety.torque_limit = 0.85

    # asset (humanoid_config.py:57-69)
    cfg.asset.file = XBOT_URDF
    cfg.asset.name = "XBot-L"
    cfg.asset.foot_name = "ankle_roll"
    cfg.asset.knee_name = "knee"
    cfg.asset.terminate_after_contacts_on = ["base_link"]
    cfg.asset.penalize_contacts_on = ["base_link"]

    # terrain (humanoid_config.py:71-86)
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.curriculum = False
    cfg.terrain.measure_heights = False
    cfg.terrain.static_friction = 0.6
    cfg.terrain.dynamic_friction = 0.6
    cfg.terrain.terrain_length = 8.0
    cfg.terrain.terrain_width = 8.0
    cfg.terrain.num_rows = 20
    cfg.terrain.num_cols = 20
    cfg.terrain.max_init_terrain_level = 10
    cfg.terrain.terrain_proportions = [0.2, 0.2, 0.4, 0.1, 0.1, 0, 0]
    cfg.terrain.restitution = 0.0

    # noise (humanoid_config.py:88-98)
    cfg.noise.add_noise = True
    cfg.noise.noise_level = 0.6
    cfg.noise.noise_scales.dof_pos = 0.05
    cfg.noise.noise_scales.dof_vel = 0.5
    cfg.noise.noise_scales.ang_vel = 0.1
    cfg.noise.noise_scales.lin_vel = 0.05
    cfg.noise.noise_scales.quat = 0.03
    cfg.noise.noise_scales.height_measurements = 0.1

    # init state (humanoid_config.py:100-116)
    cfg.init_state.pos = [0.0, 0.0, 0.95]
    cfg.init_state.default_joint_angles = {n: 0.0 for n in XBOT_DOF_NAMES}

    # control (humanoid_config.py:118-128)
    cfg.control.stiffness = {
        "leg_roll": 200.0,
        "leg_pitch": 350.0,
        "leg_yaw": 200.0,
        "knee": 350.0,
        "ankle": 15.0,
    }
    cfg.control.damping = {
        "leg_roll": 10.0,
        "leg_pitch": 10.0,
        "leg_yaw": 10.0,
        "knee": 10.0,
        "ankle": 10.0,
    }
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 10  # 100 Hz policy

    # sim (humanoid_config.py:130-147)
    cfg.sim.dt = 0.001  # 1 kHz physics
    cfg.sim.substeps = 1
    cfg.sim.up_axis = 1

    # domain rand (humanoid_config.py:149-160)
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.1, 2.0]
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-5.0, 5.0]
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = 4.0
    cfg.domain_rand.max_push_vel_xy = 0.2
    cfg.domain_rand.max_push_ang_vel = 0.4
    cfg.domain_rand.action_delay = 0.5
    cfg.domain_rand.action_noise = 0.02

    # commands (humanoid_config.py:162-172)
    cfg.commands.num_commands = 4
    cfg.commands.resampling_time = 8.0
    cfg.commands.heading_command = True
    cfg.commands.ranges.lin_vel_x = [-0.3, 0.6]
    cfg.commands.ranges.lin_vel_y = [-0.3, 0.3]
    cfg.commands.ranges.ang_vel_yaw = [-0.3, 0.3]
    cfg.commands.ranges.heading = [-3.14, 3.14]

    # rewards (humanoid_config.py:174-216)
    cfg.rewards.base_height_target = 0.89
    cfg.rewards.min_dist = 0.2
    cfg.rewards.max_dist = 0.5
    cfg.rewards.target_joint_pos_scale = 0.17
    cfg.rewards.target_feet_height = 0.06
    cfg.rewards.cycle_time = 0.64
    cfg.rewards.only_positive_rewards = True
    cfg.rewards.tracking_sigma = 5.0
    cfg.rewards.max_contact_force = 700.0
    s = cfg.rewards.scales
    # zero out the base-class terms not used by XBot-L
    s.termination = 0.0
    s.lin_vel_z = 0.0
    s.ang_vel_xy = 0.0
    s.feet_stumble = 0.0
    s.action_rate = 0.0
    s.stand_still = 0.0
    # XBot-L active set
    s.joint_pos = 1.6
    s.feet_clearance = 1.0
    s.feet_contact_number = 1.2
    s.feet_air_time = 1.0
    s.foot_slip = -0.05
    s.feet_distance = 0.2
    s.knee_distance = 0.2
    s.feet_contact_forces = -0.01
    s.tracking_lin_vel = 1.2
    s.tracking_ang_vel = 1.1
    s.vel_mismatch_exp = 0.5
    s.low_speed = 0.2
    s.track_vel_hard = 0.5
    s.default_joint_pos = 0.5
    s.orientation = 1.0
    s.base_height = 0.2
    s.base_acc = 0.2
    s.action_smoothness = -0.002
    s.torques = -1e-5
    s.dof_vel = -5e-4
    s.dof_acc = -1e-7
    s.collision = -1.0

    # normalization (humanoid_config.py:218-227)
    cfg.normalization.obs_scales.lin_vel = 2.0
    cfg.normalization.obs_scales.ang_vel = 1.0
    cfg.normalization.obs_scales.dof_pos = 1.0
    cfg.normalization.obs_scales.dof_vel = 0.05
    cfg.normalization.obs_scales.quat = 1.0
    cfg.normalization.obs_scales.height_measurements = 5.0
    cfg.normalization.clip_observations = 18.0
    cfg.normalization.clip_actions = 18.0

    return cfg


def XBotLCfgPPO() -> B.PPOCfg:
    """PPO hyperparameters (humanoid_config.py:230-261)."""
    cfg = B.PPOCfg()
    cfg.seed = 5
    cfg.runner_class_name = "OnPolicyRunner"

    cfg.policy.init_noise_std = 1.0
    cfg.policy.actor_hidden_dims = [512, 256, 128]
    cfg.policy.critic_hidden_dims = [768, 256, 128]

    a = cfg.algorithm
    a.value_loss_coef = 1.0
    a.use_clipped_value_loss = True
    a.clip_param = 0.2
    a.entropy_coef = 0.001
    a.num_learning_epochs = 2
    a.num_mini_batches = 4
    a.learning_rate = 1e-5
    a.schedule = "adaptive"
    a.gamma = 0.994
    a.lam = 0.9
    a.desired_kl = 0.01
    a.max_grad_norm = 1.0

    r = cfg.runner
    r.num_steps_per_env = 60
    r.max_iterations = 3001
    r.save_interval = 100
    r.experiment_name = "XBot_ppo"

    return cfg
