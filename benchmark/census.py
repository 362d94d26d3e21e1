"""The yardstick's census: operations and bytes of the work one training
iteration needs, and the H100's peaks they are divided by.

A frozen copy of the port's `utils/roofline.py` counts (`solve_ops`,
`mega_ops`, `mega_terrain_ops`, `net_flops`), kept here so that a change to
the program cannot change what its work is counted as. The counts are of
the work the function needs, whatever implements it. `net_flops` counts the
MLP actor-critic; a configuration whose reference module defines its own
`net_flops` is counted by that one (`nets_census`).

Peaks: NVIDIA H100 SXM 80 GB, public data sheet, dense rates at the 700 W
limit: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores, 989
TFLOP/s bf16 on the tensor cores.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# the physics kernel's row layouts (floats per env): inputs, outputs, and
# the heightfield variant's second input
IN_ROWS, OUT_ROWS, IN2_ROWS = 120, 136, 208
# float32 operations of GAE per sample, as the JAX package's census counts
GAE_OPS_PER_SAMPLE = 10


def _lz(i, k):
    return k < 6 and 6 <= i < 12


def solve_ops(iterations: int) -> int:
    """Operations of the contact solve of one substep for one env (factor
    form, 18 velocities, 60 rows, the legs' zero blocks skipped)."""
    nv, nr = 18, 60
    ops = 0
    for k in range(nv):  # Cholesky
        ops += 2
        rows = [i for i in range(k + 1, nv) if not _lz(i, k)]
        ops += len(rows)
        for j in range(k + 1, nv):
            if _lz(j, k):
                continue
            ops += 2 * sum(1 for i in range(j, nv) if not _lz(i, k))
    tri = sum(1 + 2 * sum(1 for i in range(k + 1, nv) if not _lz(i, k)) for k in range(nv))
    ops += 2 * tri + nv  # v_free: forward + backward substitution + add
    ops += nr * (2 * nv + 2)  # r = sign * J v_free - target
    ops += sum(nr + 2 * nr * sum(1 for i in range(k + 1, nv) if not _lz(i, k)) for k in range(nv))
    ops += nv * nr  # sign fold
    pairs = sum(1 for v in range(nv) for w in range(v, nv) if not _lz(w, v))
    ops += pairs * (2 * nr + 3) + nv  # Gram row sums + max
    ops += nr * (2 * nv + 1) + 4  # CFM regularizer and step
    proj = 16 * 20 + 12
    ops += nr + proj  # warm start fold + projection
    per_iter = nv * 2 * nr + nr * (2 * nv + 3) + 2 * nr + proj + 3 * nr + 12 + 3 * nr
    ops += iterations * per_iter
    ops += nv * 2 * nr + tri + nv + nr  # dv = L^-T (B lam), qvel_new, unfold
    return ops


def mega_ops(decimation: int, iterations: int) -> int:
    """Operations of one whole-policy-step physics call for one env on flat
    ground: per substep PD, FK and the velocity / bias recursion, the body
    stage, subtree sums, bias forces, the mass matrix, contact and limit
    rows, the right-hand side, the solve, integration and impulse sums;
    then the final FK pass."""
    sub = (12 * 8 + 12 * 190 + 13 * 190 + 12 * 16 + 12 * 14
           + (21 + 72 + 42) * 40 + 16 * 60 + 12 * 8 + 12 * 10 + 150
           + solve_ops(iterations))
    return decimation * sub + 12 * 110


def mega_terrain_ops(decimation: int, iterations: int) -> int:
    """The same on a heightfield: per substep and contact point the patch
    lookup, t2, phi and the sloped rows; per call the 16 frames and the
    rotated impulse sums."""
    per_point = 30 + 4 + 3 + 3 * (9 + 6 * 5)
    return mega_ops(decimation, iterations) + decimation * 16 * per_point + 16 * 12 + 6 * 8 * 5


def physics_call(envs: int, terrain: bool, decimation: int, iterations: int):
    """(operations, bytes) of one physics call over `envs` envs: the
    function's float32 operations, and its rows read and written once."""
    ops = (mega_terrain_ops if terrain else mega_ops)(decimation, iterations)
    floats = IN_ROWS + OUT_ROWS + (IN2_ROWS if terrain else 0)
    return envs * ops, envs * floats * 4


def physics_bound_s(envs: int, terrain: bool, decimation: int, iterations: int) -> float:
    """The least time the card could take for one physics call: the larger
    of its operations over the float32 peak and its bytes over the memory
    rate."""
    ops, nbytes = physics_call(envs, terrain, decimation, iterations)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def net_flops(cfg: dict, envs: int) -> int:
    """Matmul FLOPs of the nets in one iteration: the rollout's actor and
    critic forward at every step, the value of the last step's privileged
    obs, and `epochs` passes of forward + backward (twice the forward) of
    the actor, the critic and, where the loss uses it, the estimator head
    over the batch."""
    T, epochs = cfg["steps_per_env"], cfg["learning_epochs"]
    actor = mlp_macs((cfg["num_obs"], *cfg["actor_hidden"], cfg["num_actions"]))
    critic = mlp_macs((cfg["num_privileged_obs"], *cfg["critic_hidden"], 1))
    est = 0
    if cfg.get("estimator_dim", 0) > 0 and cfg.get("estimator_coef", 0.0) > 0.0:
        est = mlp_macs((cfg["num_obs"], *cfg["estimator_hidden"], cfg["estimator_dim"]))
    batch = envs * T
    rollout = batch * 2 * (actor + critic) + envs * 2 * critic
    learn = batch * epochs * 3 * 2 * (actor + critic + est)
    return rollout + learn


def nets_census(cfg: dict):
    """`net_flops(cfg, envs)` of the configuration's nets: its reference
    module's where that defines one, the MLP actor-critic's otherwise."""
    from .reference import module

    return getattr(module(cfg), "net_flops", net_flops)


def iteration_least_s(cfg: dict, envs_per_robot) -> float:
    """The least time one training iteration's work needs on the card: the
    float32 physics operations (one call per robot a policy step) and GAE
    at the float32 peak, plus the nets' matmul FLOPs (`nets_census`) at the
    bf16 peak."""
    T = cfg["steps_per_env"]
    terrain = cfg["terrain"] != "flat"
    envs = sum(envs_per_robot)
    phys = T * sum(physics_call(n, terrain, cfg["decimation"], cfg["solver_iterations"])[0]
                   for n in envs_per_robot)
    gae = envs * T * GAE_OPS_PER_SAMPLE
    return (phys + gae) / PEAK_F32_FLOPS + nets_census(cfg)(cfg, envs) / PEAK_BF16_FLOPS
