"""Task registry: name -> (env config factory, train config factory).

Port of humanoid_gym_tpu/registry.py with the XBot-L tasks the port can
run: flat `humanoid_ppo`, `humanoid_ppo_small`, `humanoid_ppo_robust`, and
terrain `humanoid_ppo_terrain`, `humanoid_ppo_terrain_robust` (the
production recipe), `humanoid_ppo_rubble`, built as the reference builds
them (registry.py:72-169). Not registered, so their names raise the same
KeyError as any unknown one: `humanoid_ppo_deploy`, whose "deploy" terrain
style samples the MuJoCo deployment heightfield through `mujoco` (the
port does not use it), and the XBot-S and joint tasks (and with them the
custom env factory of the reference's TaskSpec), which are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional


class TaskSpec(NamedTuple):
    make_env_cfg: Callable  # () -> LeggedRobotCfg
    make_train_cfg: Callable  # () -> PPOCfg


_REGISTRY: Dict[str, TaskSpec] = {}


def register(name: str, make_env_cfg, make_train_cfg) -> None:
    _REGISTRY[name] = TaskSpec(make_env_cfg, make_train_cfg)


def get_task(name: str) -> TaskSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def task_names():
    return sorted(_REGISTRY)


def make_env(name: str, num_envs: Optional[int] = None, cfg_overrides=None, device="cuda",
             seed: int = 0):
    """Build (env, env_cfg) for a registered task on `device` (default: the
    card). `cfg_overrides(cfg)` edits the config before the env is built."""
    from .envs import make_env as _make

    spec = get_task(name)
    cfg = spec.make_env_cfg()
    if cfg_overrides:
        cfg_overrides(cfg)
    if num_envs is not None:
        cfg.env.num_envs = num_envs
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

    def rubble():  # deployment-matched coarse unevenness + contact DR
        cfg = XBotLCfg()
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
        return cfg

    def rubble_ppo():
        cfg = XBotLCfgPPO()
        cfg.runner.experiment_name = "XBot_ppo_rubble"
        return cfg

    register("humanoid_ppo_rubble", rubble, rubble_ppo)


_register_builtin()
