"""Task registry: name -> (env config factory, train config factory,
optional custom env factory).

Port of humanoid_gym_tpu/registry.py with every task of the reference,
built as the reference builds them (registry.py:72-291): XBot-L flat
`humanoid_ppo`, `humanoid_ppo_small`, `humanoid_ppo_robust`; XBot-L terrain
`humanoid_ppo_terrain`, `humanoid_ppo_terrain_robust` (the production
recipe), `humanoid_ppo_rubble`, `humanoid_ppo_deploy` (windows of the
MuJoCo deployment heightfield); the Froude-scaled `humanoid_s_ppo`; and the
joint XBot-L + XBot-S batches `humanoid_joint_ppo` and
`humanoid_joint_deploy` under one policy with the estimator head, whose
envs come from their custom factory (`make_env_custom`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional


class TaskSpec(NamedTuple):
    make_env_cfg: Callable  # () -> LeggedRobotCfg
    make_train_cfg: Callable  # () -> PPOCfg
    # (num_envs, cfg_overrides, device, seed) -> env
    make_env_custom: Optional[Callable] = None


_REGISTRY: Dict[str, TaskSpec] = {}


def register(name: str, make_env_cfg, make_train_cfg, make_env_custom=None) -> None:
    _REGISTRY[name] = TaskSpec(make_env_cfg, make_train_cfg, make_env_custom)


def get_task(name: str) -> TaskSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def task_names():
    return sorted(_REGISTRY)


def make_env(name: str, num_envs: Optional[int] = None, cfg_overrides=None, device="cuda",
             seed: int = 0):
    """Build (env, env_cfg) for a registered task on `device` (default: the
    card). `cfg_overrides(cfg)` edits the config before the env is built
    (for a joint task, each sub-env's config)."""
    from .envs import make_env as _make

    spec = get_task(name)
    cfg = spec.make_env_cfg()
    if cfg_overrides:
        cfg_overrides(cfg)
    if num_envs is not None:
        cfg.env.num_envs = num_envs
    if spec.make_env_custom is not None:
        return spec.make_env_custom(cfg.env.num_envs, cfg_overrides, device, seed), cfg
    return _make(cfg, device=device, seed=seed), cfg


def _register_builtin():
    from .config.xbotl import XBotLCfg, XBotLCfgPPO

    register("humanoid_ppo", XBotLCfg, XBotLCfgPPO)

    def small_flat():  # 256 envs, flat, short horizon
        cfg = XBotLCfg()
        cfg.env.num_envs = 256
        cfg.env.episode_length_s = 12.0
        return cfg

    def small_flat_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.max_iterations = 500
        cfg.runner.experiment_name = "XBot_ppo_small"
        return cfg

    register("humanoid_ppo_small", small_flat, small_flat_ppo)

    def robust():  # full recipe + contact-model DR (stiffness, offset, CFM)
        cfg = XBotLCfg()
        cfg.domain_rand.randomize_contact_stiffness = True
        cfg.domain_rand.randomize_contact_offset = True
        cfg.domain_rand.randomize_contact_compliance = True
        return cfg

    def robust_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_robust"
        return cfg

    register("humanoid_ppo_robust", robust, robust_ppo)

    def terrain():  # trimesh curriculum + push + full DR
        cfg = XBotLCfg()
        cfg.terrain.mesh_type = "trimesh"
        cfg.terrain.curriculum = True
        return cfg

    def terrain_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_terrain"
        return cfg

    register("humanoid_ppo_terrain", terrain, terrain_ppo)

    def terrain_robust():  # production config: terrain curriculum + the
        # contact-model DR transfer recipe, with survival promotion and the
        # speed-tracking terms of its v2 recipe
        cfg = terrain()
        cfg.domain_rand.randomize_contact_stiffness = True
        cfg.domain_rand.randomize_contact_offset = True
        cfg.domain_rand.randomize_contact_compliance = True
        cfg.domain_rand.randomize_contact_slope = True
        cfg.terrain.curriculum_mode = "survival"
        cfg.rewards.scales.low_speed = 0.6
        cfg.rewards.scales.track_vel_hard = 1.0
        return cfg

    def terrain_robust_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_terrain_robust"
        return cfg

    register("humanoid_ppo_terrain_robust", terrain_robust, terrain_robust_ppo)

    def _apply_rubble(cfg):  # deployment-matched coarse unevenness + contact DR
        cfg.terrain.mesh_type = "trimesh"
        cfg.terrain.curriculum = True
        cfg.terrain.style = "rubble"
        cfg.terrain.terrain_proportions = [0.2]  # 20% gentle, 80% rubble
        # the finer level ladder (20 rows, init spread 10), 5 m patches and
        # an amplitude floor of 8 cm cells at level 0
        cfg.terrain.num_rows = 20
        cfg.terrain.max_init_terrain_level = 10
        cfg.terrain.terrain_length = 5.0
        cfg.terrain.rubble_base = 0.08
        cfg.terrain.rubble_span = 0.27
        cfg.domain_rand.randomize_contact_stiffness = True
        cfg.domain_rand.randomize_contact_offset = True
        cfg.domain_rand.randomize_contact_compliance = True
        cfg.domain_rand.randomize_contact_slope = True

    def rubble():
        cfg = XBotLCfg()
        _apply_rubble(cfg)
        return cfg

    def rubble_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_rubble"
        return cfg

    register("humanoid_ppo_rubble", rubble, rubble_ppo)

    def deploy():  # rubble, on windows of the deployment heightfield
        cfg = rubble()
        cfg.terrain.style = "deploy"
        return cfg

    def deploy_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_deploy"
        return cfg

    register("humanoid_ppo_deploy", deploy, deploy_ppo)

    from .config.xbots import XBotSCfg, XBotSCfgPPO

    register("humanoid_s_ppo", XBotSCfg, XBotSCfgPPO)

    # joint XBot-L + XBot-S batch under one policy, half of the envs each
    def joint_env(num_envs, cfg_overrides=None, device="cuda", seed=0):
        from .envs.joint import make_joint_xbot_env

        half = num_envs // 2
        return make_joint_xbot_env(num_envs - half, half, cfg_overrides, device=device, seed=seed)

    def joint_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_joint_ppo"
        # DWL-style estimator head supervised on the newest privileged
        # frame's base linear velocity (slice 199:202 of the 219 critic input)
        cfg.policy.estimator_dim = 3
        cfg.algorithm.estimator_coef = 1.0
        return cfg

    register("humanoid_joint_ppo", XBotLCfg, joint_ppo, make_env_custom=joint_env)

    # joint XBot-L + XBot-S on the deployment heightfield (the v5 recipe of
    # the reference, registry.py:219-262)
    def _apply_joint_deploy_v2(cfg):
        _apply_rubble(cfg)
        cfg.terrain.style = "deploy"
        # every level from iteration 0 (a draw of num_rows stands on the top
        # row), a 34% amplitude floor, stronger pushes
        cfg.terrain.max_init_terrain_level = 20
        cfg.terrain.rubble_base = 0.12
        cfg.domain_rand.max_push_vel_xy = 0.3
        cfg.domain_rand.max_push_ang_vel = 0.6
        # survival promotion and the sharp speed-tracking terms
        cfg.terrain.curriculum_mode = "survival"
        cfg.rewards.scales.low_speed = 0.6
        cfg.rewards.scales.track_vel_hard = 1.0
        # XBot-S keeps the unscaled terrain in joint training: the full-size
        # deployment field and no Froude height scale (XBotSCfg sets both
        # for the stand-alone S task)
        cfg.terrain.froude_scale = 1.0
        cfg.terrain.deploy_mjcf = None

    def joint_deploy_env(num_envs, cfg_overrides=None, device="cuda", seed=0):
        from .envs.joint import make_joint_xbot_env

        def ov(cfg):
            _apply_joint_deploy_v2(cfg)
            if cfg_overrides:
                cfg_overrides(cfg)

        half = num_envs // 2
        return make_joint_xbot_env(num_envs - half, half, ov, device=device, seed=seed)

    def joint_deploy_cfg():
        cfg = XBotLCfg()
        _apply_joint_deploy_v2(cfg)
        return cfg

    def joint_deploy_ppo():
        cfg = joint_ppo()
        cfg.runner.experiment_name = "XBot_joint_deploy"
        return cfg

    register("humanoid_joint_deploy", joint_deploy_cfg, joint_deploy_ppo,
             make_env_custom=joint_deploy_env)


_register_builtin()
