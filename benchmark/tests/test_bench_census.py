"""The frozen census: the physics kernel's operations per env, and the
flat iteration's least time counted term by term; the nets counted as
the MLP actor-critic for the configurations that name no reference module
of their own."""

import pytest

from benchmark import census


def test_physics_operations_per_env():
    assert census.mega_ops(10, 8) == 966_140
    assert census.mega_terrain_ops(10, 8) == 991_212


def test_flat_iteration_work():
    cfg = {"steps_per_env": 60, "learning_epochs": 2, "num_obs": 705, "num_privileged_obs": 219,
           "num_actions": 12, "actor_hidden": [512, 256, 128], "critic_hidden": [768, 256, 128],
           "estimator_dim": 0, "estimator_coef": 0.0, "terrain": "flat", "decimation": 10,
           "solver_iterations": 8}
    n, T = 4096, 60
    actor = 705 * 512 + 512 * 256 + 256 * 128 + 128 * 12
    critic = 219 * 768 + 768 * 256 + 256 * 128 + 128 * 1
    nets = n * T * 2 * (actor + critic) + n * 2 * critic + n * T * 2 * 3 * 2 * (actor + critic)
    assert census.net_flops(cfg, n) == nets
    least = (n * T * 966_140 + n * T * 10) / 67e12 + nets / 989e12
    assert abs(census.iteration_least_s(cfg, [n]) - least) <= 1e-15


def test_estimator_counts_only_where_the_loss_uses_it():
    cfg = {"steps_per_env": 60, "learning_epochs": 2, "num_obs": 705, "num_privileged_obs": 219,
           "num_actions": 12, "actor_hidden": [512, 256, 128], "critic_hidden": [768, 256, 128],
           "estimator_dim": 3, "estimator_hidden": [256, 128], "estimator_coef": 1.0}
    est = 705 * 256 + 256 * 128 + 128 * 3
    base = census.net_flops(dict(cfg, estimator_coef=0.0), 10)
    assert census.net_flops(cfg, 10) - base == 10 * 60 * 2 * 3 * 2 * est


@pytest.mark.parametrize("config", ["xbotl_flat", "xbot_joint_deploy"])
def test_existing_configs_keep_follow_and_the_mlp_census(config):
    """A configuration that names no reference module, or names `follow`,
    is judged by follow.Reference and counted by census.net_flops."""
    from benchmark import run
    from benchmark.reference import follow

    cfg = dict(run.load_json(run.BENCH_DIR, "configs", f"{config}.json"), steps_per_env=60)
    assert "reference" not in cfg
    for c in (cfg, dict(cfg, reference="follow")):
        assert run.reference_module(c) is follow and run.reference_module(c).Reference is \
            follow.Reference
        assert census.nets_census(c) is census.net_flops
    envs = [2048, 2048] if config == "xbot_joint_deploy" else [4096]
    phys = 60 * sum(census.physics_call(n, cfg["terrain"] != "flat", 10, 8)[0] for n in envs)
    least = (phys + 4096 * 60 * 10) / 67e12 + census.net_flops(cfg, 4096) / 989e12
    assert census.iteration_least_s(cfg, envs) == least
