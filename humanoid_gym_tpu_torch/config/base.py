"""Config tree for legged-robot tasks.

Field names and default values deliberately mirror the reference config tree
(reference: humanoid/envs/base/legged_robot_config.py:34-237) so configs are
portable. This is the PyTorch port's own copy of humanoid_gym_tpu's config
tree; tests/test_torch_model.py pins the two `dataclasses.asdict` trees equal
field for field.

Configs are plain (mutable) dataclasses read once when an env or trainer is
built: mutating a config afterwards does not reach an already-built object.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _f(factory):
    return field(default_factory=factory)


@dataclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_privileged_obs: Optional[int] = None
    num_actions: int = 12
    env_spacing: float = 3.0
    send_timeouts: bool = True
    episode_length_s: float = 20.0
    # frame stacking (reference: humanoid/envs/custom/humanoid_config.py:40-45)
    frame_stack: int = 1
    c_frame_stack: int = 1
    num_single_obs: int = 235
    single_num_privileged_obs: Optional[int] = None
    use_ref_actions: bool = False


@dataclass
class TerrainCfg:
    mesh_type: str = "trimesh"  # none, plane, heightfield, trimesh
    horizontal_scale: float = 0.1  # [m]
    vertical_scale: float = 0.005  # [m]
    border_size: float = 25.0  # [m]
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: List[float] = _f(
        lambda: [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
    )
    measured_points_y: List[float] = _f(
        lambda: [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
    )
    selected: bool = False
    terrain_kwargs: Optional[dict] = None
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: List[float] = _f(lambda: [0.1, 0.1, 0.35, 0.25, 0.2])
    slope_treshold: float = 0.75  # (sic — reference spelling)
    # EXTENSION (no reference field): terrain menu style — "humanoid"
    # (reference HumanoidTerrain menu), "legged" (base Terrain menu), or
    # "rubble" (deployment-matched coarse unevenness; terrain.py:_rubble_menu)
    style: str = "humanoid"
    # rubble-style amplitude ramp: cell height ~ U[0, base + span*difficulty]
    rubble_base: float = 0.05
    rubble_span: float = 0.30
    # EXTENSION: MJCF whose hfield the "deploy" style samples windows from
    # (None = the shipped XBot-L deployment terrain). A Froude-scaled
    # morphology points this at its scaled terrain model.
    deploy_mjcf: Optional[str] = None
    # EXTENSION: Froude length scale applied to every menu HEIGHT amplitude
    # at map-build time (slopes are dimensionless and stay). Lets a scaled
    # morphology (XBot-S, config/xbots.py) train on terrain whose relative
    # difficulty matches what the full-size robot sees, even when task
    # recipes set absolute amplitudes (e.g. rubble_base=0.12) after the
    # robot config ran. 1.0 = reference behavior.
    froude_scale: float = 1.0
    # EXTENSION: curriculum promotion rule. "distance" is the reference's
    # frozen formula (promote when walked > terrain_length/2 — which caps
    # exposure at the amplitude the policy can WALK). "survival" promotes
    # envs that reach timeout AND covered >=50% of the commanded distance
    # (standing at cmd~0 counts), demotes only on a fall before half the
    # episode — pushing exposure to the amplitude the policy can SURVIVE,
    # which is what the deployment hfield actually demands.
    curriculum_mode: str = "distance"


@dataclass
class CommandRanges:
    lin_vel_x: List[float] = _f(lambda: [-1.0, 1.0])
    lin_vel_y: List[float] = _f(lambda: [-1.0, 1.0])
    ang_vel_yaw: List[float] = _f(lambda: [-1.0, 1.0])
    heading: List[float] = _f(lambda: [-3.14, 3.14])


@dataclass
class CommandsCfg:
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4  # lin_vel_x, lin_vel_y, ang_vel_yaw, heading
    resampling_time: float = 10.0  # [s]
    heading_command: bool = True
    ranges: CommandRanges = _f(CommandRanges)


@dataclass
class InitStateCfg:
    pos: List[float] = _f(lambda: [0.0, 0.0, 1.0])
    rot: List[float] = _f(lambda: [0.0, 0.0, 0.0, 1.0])  # x,y,z,w
    lin_vel: List[float] = _f(lambda: [0.0, 0.0, 0.0])
    ang_vel: List[float] = _f(lambda: [0.0, 0.0, 0.0])
    default_joint_angles: Dict[str, float] = _f(dict)


@dataclass
class ControlCfg:
    stiffness: Dict[str, float] = _f(dict)  # matched by joint-name substring
    damping: Dict[str, float] = _f(dict)
    action_scale: float = 0.5
    decimation: int = 4


@dataclass
class AssetCfg:
    file: str = ""
    name: str = "legged_robot"
    mesh_dir: Optional[str] = None  # default: <urdf_dir>/../meshes
    foot_name: str = "None"
    knee_name: str = "None"
    penalize_contacts_on: List[str] = _f(list)
    terminate_after_contacts_on: List[str] = _f(list)
    disable_gravity: bool = False
    collapse_fixed_joints: bool = True
    fix_base_link: bool = False
    self_collisions: int = 0
    density: float = 0.001
    angular_damping: float = 0.0
    linear_damping: float = 0.0
    max_angular_velocity: float = 1000.0
    max_linear_velocity: float = 1000.0
    armature: float = 0.0
    thickness: float = 0.01


@dataclass
class SafetyCfg:
    pos_limit: float = 1.0
    vel_limit: float = 1.0
    torque_limit: float = 1.0


@dataclass
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: List[float] = _f(lambda: [0.5, 1.25])
    randomize_base_mass: bool = False
    added_mass_range: List[float] = _f(lambda: [-1.0, 1.0])
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    max_push_ang_vel: float = 0.0
    action_delay: float = 0.0
    action_noise: float = 0.0
    # contact-model DR: per-env Baumgarte stabilization scale (engine-gap
    # robustness; reference has no analog — PhysX params are global)
    randomize_contact_stiffness: bool = False
    contact_stiffness_range: List[float] = _f(lambda: [0.5, 2.0])
    # per-env contact-offset (activation distance) jitter, log-uniform [m]
    randomize_contact_offset: bool = False
    contact_offset_range: List[float] = _f(lambda: [0.005, 0.02])
    # per-env contact compliance (CFM): A + c*mean(diag(A))*I — randomizes
    # over the rigid<->soft contact family (MuJoCo's solref/solimp add the
    # same kind of diagonal regularizer); log-uniform, 0 disabled
    randomize_contact_compliance: bool = False
    contact_compliance_range: List[float] = _f(lambda: [0.002, 0.2])
    # per-env actuator-strength scale on kp/kd (sim2real staple; attacks
    # policies that overfit the exact contact/actuation loop timing)
    randomize_motor_strength: bool = False
    motor_strength_range: List[float] = _f(lambda: [0.8, 1.2])
    # contact-slope DR (EXTENSION; terrain tasks only): per-env bias added
    # to the terrain gradient the sloped contact frames are built from —
    # the slope analog of the contact-model DR family. Range is in height
    # gradient units (0.1 ~ 5.7 deg of normal tilt).
    randomize_contact_slope: bool = False
    contact_slope_range: List[float] = _f(lambda: [-0.12, 0.12])


@dataclass
class RewardScales:
    """Reward term -> scale. Zero scale disables the term entirely
    (reference: legged_robot.py:522-528). Scales are multiplied by the policy
    dt when the reward pipeline is built."""

    termination: float = 0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -2.0
    ang_vel_xy: float = -0.05
    orientation: float = -0.0
    torques: float = -0.00001
    dof_vel: float = -0.0
    dof_acc: float = -2.5e-7
    base_height: float = -0.0
    feet_air_time: float = 1.0
    collision: float = -1.0
    feet_stumble: float = -0.0
    action_rate: float = -0.0
    stand_still: float = -0.0
    # XBot-L extended set (reference: humanoid_config.py:188-216)
    joint_pos: float = 0.0
    feet_clearance: float = 0.0
    feet_contact_number: float = 0.0
    foot_slip: float = 0.0
    feet_distance: float = 0.0
    knee_distance: float = 0.0
    feet_contact_forces: float = 0.0
    vel_mismatch_exp: float = 0.0
    low_speed: float = 0.0
    track_vel_hard: float = 0.0
    default_joint_pos: float = 0.0
    base_acc: float = 0.0
    action_smoothness: float = 0.0

    def nonzero_terms(self) -> Dict[str, float]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) != 0.0
        }


@dataclass
class RewardsCfg:
    scales: RewardScales = _f(RewardScales)
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    max_contact_force: float = 100.0
    base_height_target: float = 1.0
    min_dist: float = 0.2
    max_dist: float = 0.5
    target_joint_pos_scale: float = 0.17
    target_feet_height: float = 0.06
    cycle_time: float = 0.64
    sole_offset: float = 0.05  # foot origin height above sole


@dataclass
class ObsScales:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    quat: float = 1.0
    height_measurements: float = 5.0


@dataclass
class NormalizationCfg:
    obs_scales: ObsScales = _f(ObsScales)
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass
class NoiseScales:
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    quat: float = 0.0
    height_measurements: float = 0.1


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: NoiseScales = _f(NoiseScales)


@dataclass
class PhysxLikeSolverCfg:
    """Contact/constraint solver knobs (capability analog of the reference's
    PhysX block, humanoid_config.py:135-147, re-expressed for the JAX engine)."""

    solver_type: str = "apgd"  # 'apgd' (batched, TPU-native) or 'pgs'
    # Solver iterations per 1 kHz substep. Every APGD path warm-starts from
    # the previous substep's impulses (PhysicsState.contact_lam), which is
    # worth >2x in iterations: measured single-step max|qvel| error vs a
    # 300-iteration solve is 0.12 warm@8 vs 0.20 for the round-2 cold@16
    # (tests/test_contact_solvers.py::test_warm_start_accuracy).
    # DO NOT lower to 4 for throughput (~1.0M vs 0.9M env steps/s): warm@4
    # also beats cold@16 on single-step error (0.131 vs 0.146), but round-3
    # retrains showed sim2sim transfer COLLAPSES — terrain_robust went 0/16
    # on MuJoCo from ckpt 400 on (16/16 everywhere at 8): policies learn to
    # exploit the under-converged contact (docs/ROUND3.md negative result).
    solver_iterations: int = 8
    substep_unroll: int = 1  # lax.scan unroll of the decimation loop
    contact_offset: float = 0.01  # [m] candidate activation margin
    stabilization_time: float = 0.02  # Baumgarte time constant [s]
    max_depenetration_velocity: float = 1.0  # [m/s]
    contact_damping_ratio: float = 1.0


@dataclass
class SimCfg:
    dt: float = 0.005
    substeps: int = 1
    gravity: List[float] = _f(lambda: [0.0, 0.0, -9.81])
    up_axis: int = 1  # 0 is y, 1 is z
    solver: PhysxLikeSolverCfg = _f(PhysxLikeSolverCfg)


@dataclass
class ViewerCfg:
    ref_env: int = 0
    pos: List[float] = _f(lambda: [10.0, 0.0, 6.0])
    lookat: List[float] = _f(lambda: [11.0, 5.0, 3.0])


@dataclass
class LeggedRobotCfg:
    env: EnvCfg = _f(EnvCfg)
    terrain: TerrainCfg = _f(TerrainCfg)
    commands: CommandsCfg = _f(CommandsCfg)
    init_state: InitStateCfg = _f(InitStateCfg)
    control: ControlCfg = _f(ControlCfg)
    asset: AssetCfg = _f(AssetCfg)
    safety: SafetyCfg = _f(SafetyCfg)
    domain_rand: DomainRandCfg = _f(DomainRandCfg)
    rewards: RewardsCfg = _f(RewardsCfg)
    normalization: NormalizationCfg = _f(NormalizationCfg)
    noise: NoiseCfg = _f(NoiseCfg)
    viewer: ViewerCfg = _f(ViewerCfg)
    sim: SimCfg = _f(SimCfg)

    # ---- derived quantities (reference: legged_robot.py:710-720) ----
    @property
    def dt(self) -> float:
        """Policy dt = decimation * sim dt."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        import math

        return int(math.ceil(self.env.episode_length_s / self.dt))

    @property
    def push_interval(self) -> int:
        import math

        return int(math.ceil(self.domain_rand.push_interval_s / self.dt))

    @property
    def resampling_interval(self) -> int:
        return int(self.commands.resampling_time / self.dt)


# ------------------------------- PPO ---------------------------------------


@dataclass
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: List[int] = _f(lambda: [512, 256, 128])
    critic_hidden_dims: List[int] = _f(lambda: [512, 256, 128])
    # DWL-style privileged-state estimator head (0 = off)
    estimator_dim: int = 0
    estimator_hidden_dims: List[int] = _f(lambda: [256, 128])
    # Hidden-matmul compute dtype: "auto" = bf16 on accelerators (MXU
    # rate; f32 params/heads/log-prob math), f32 on CPU (bit-stable test
    # goldens). EXTENSION vs the reference (torch f32 throughout);
    # fidelity-gated in docs/ROUND4.md.
    compute_dtype: str = "auto"


@dataclass
class RecurrentPolicyCfg(PolicyCfg):
    """The policy block of rsl_rl's ActorCriticRecurrent (the runner's
    `policy_class_name = "ActorCriticRecurrent"`): PolicyCfg's keys, the
    heads' widths being the MLPs after the memory, and the memory's, with
    rsl_rl's defaults. EXTENSION: the JAX package has no recurrent policy."""

    rnn_type: str = "lstm"
    rnn_hidden_size: int = 256
    rnn_num_layers: int = 1


@dataclass
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    estimator_coef: float = 0.0
    estimator_slice: Tuple[int, int] = (199, 202)


@dataclass
class RunnerCfg:
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 100
    experiment_name: str = "test"
    run_name: str = ""
    resume: bool = False
    load_run: int = -1
    checkpoint: int = -1
    resume_path: Optional[str] = None


@dataclass
class PPOCfg:
    seed: int = 1
    runner_class_name: str = "OnPolicyRunner"
    policy: PolicyCfg = _f(PolicyCfg)
    algorithm: AlgorithmCfg = _f(AlgorithmCfg)
    runner: RunnerCfg = _f(RunnerCfg)
