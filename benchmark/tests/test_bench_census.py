"""The frozen census: the physics kernel's operations per env, and the
flat iteration's least time counted term by term."""

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
