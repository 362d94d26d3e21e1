"""Task registry: name -> (env config factory, train config factory).

Port of humanoid_gym_tpu/registry.py with the flat-ground XBot-L tasks the
port can run: `humanoid_ppo`, `humanoid_ppo_small`, `humanoid_ppo_robust`.
The terrain, XBot-S and joint tasks (and with them the custom env factory
of the reference's TaskSpec) are registered when those paths are ported;
until then their names raise the same KeyError as any unknown one.
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


_register_builtin()
