"""Operation and byte census of the port's work on the H100: the bounds of
the hand-written kernels and the FLOPs of one training iteration.

The counterpart of humanoid_gym_tpu/utils/roofline.py, which counts the
TPU kernel's jaxpr against TPU peaks; the port counts its CUDA kernels'
loop nests by hand (the kernels are `csrc/*.cu`, with no jaxpr to walk).
- `solve_ops`, `mega_ops`, `mega_terrain_ops`, `apgd_ops`,
  `fused_dense_ops`, `terrain_patches_ops`, `rewards_ops`: float32 operations a kernel's
  function needs for one env; each multiply, add, divide, square root and
  comparison-select in the loops counts as one. The `*_executed` variants count what one warp
  issues, every lane counted whether or not its result is used.
- `bound_ms`: the least time the card could take for a kernel's work, the
  larger of its bytes over the memory rate and its operations over the
  float32 rate.
- `net_flops`, `iteration_flops`: the actor / critic matmul FLOPs and the
  whole flat-task training iteration (physics + nets + GAE), the census a
  GPU benchmark divides by.
- `physics_flops_per_step`, `physics_issue_per_step`, `hbm_bytes`: one
  policy step of physics for a batch of envs (the function's operations,
  and what the warps issue, every lane counted: the axis the issue-bound
  mega kernel's run time tracks) and the major device-memory flows of one
  iteration, as `scripts/roofline_torch.py` prints them.

Peaks: NVIDIA H100 SXM 80 GB, public data sheet: 3.35 TB/s HBM3, 67
TFLOP/s float32 outside the tensor cores, 989 TFLOP/s dense bf16 on the
tensor cores. A card run below its 700 W maximum reaches less.
"""

from __future__ import annotations

from ..physics.mega import IN2_ROWS, IN_ROWS, N_POINTS, OUT_ROWS

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def _lz(i, k):
    return k < 6 and 6 <= i < 12


def solve_ops(iterations: int) -> int:
    """Operations of hgt_solve_env for one env (csrc/solve.cuh)."""
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
    """Operations of one mega-kernel launch for one env (csrc/mega.cu):
    per substep PD (12 x 8), FK + velocity/bias recursion (12 bodies x
    ~190), body stage (13 x ~190), subtree sums (12 x 16), h (12 x 14),
    mass matrix (21 base + 12 x 6 base couplings + 42 chain pairs, ~40
    each), contact rows (16 x ~60), limit rows (12 x 8), rhs (12 x 10),
    the solve, integration and impulse sums (~150); plus the final FK
    pass (12 x ~110)."""
    sub = (12 * 8 + 12 * 190 + 13 * 190 + 12 * 16 + 12 * 14
           + (21 + 72 + 42) * 40 + 16 * 60 + 12 * 8 + 12 * 10 + 150
           + solve_ops(iterations))
    return decimation * sub + 12 * 110


def solve_ops_executed(iterations: int) -> int:
    """Float32 operations one warp executes in hgt_solve_env (csrc/solve.cuh),
    every lane counted whether or not its result is used: 32 x the float
    instructions of the loop nests (a multiply-add counts 2)."""
    nv, pairs = 18, 117  # strictly-lower structurally non-zero entries
    w = 0
    w += nv * 4 + 2 * pairs                      # Cholesky: max, sqrt, 1/d, scale; updates
    w += 3 * nv * 3                              # three substitutions: scale + multiply-add
    w += 2 * nv * 2 + 4                          # u = J v_free for two columns, r
    w += 2 * nv + 2 * 2 * pairs                  # B = L^-1 J^T for two columns
    w += 2 * nv * 3 + 3                          # sign fold, diag(B^T B), regularizer
    w += 8 * (nv * 3 + 20 + 1) + nv + 3          # Gram batches, row sums, step
    proj = 20 + 1                                # a cone and a clamp per lane
    w += 2 + proj                                # warm start
    per_iter = nv * 3 + 20 + 2 * nv * 2 + 6 + 4 + proj + 4 + 5 + 12 + 4
    w += iterations * per_iter
    w += nv * 3 + 20 + nv * 3 + 3                # B lam, substitution, outputs
    return 32 * w


def mega_ops_executed(decimation: int, iterations: int) -> int:
    """Float32 operations one warp executes in one launch of hgt_mega_kernel
    (csrc/mega.cu), every lane counted: per substep PD (8), joint rotations
    (4 rounds x 30), the 7 chain steps (6 + 30 each), the body stage (190),
    screws (9), subtree sums (7), the mass matrix (5 rounds x 45), rhs (30),
    two constraint columns (2 x 90), the solve, integration (60); plus the
    final chain (4 x 30 + 7 x 20)."""
    sub = (8 + 4 * 30 + 7 * 36 + 190 + 9 + 7 + 5 * 45 + 30 + 2 * 90 + 60)
    return decimation * (32 * sub + solve_ops_executed(iterations)) + 32 * (4 * 30 + 7 * 20)


def mega_terrain_ops(decimation: int, iterations: int) -> int:
    """Operations of one launch of the terrain variant for one env
    (csrc/mega.cu hgt_mega_kernel<true>): the flat launch's, plus per
    substep and contact point the patch lookup (~30), t2 (4) and phi (3),
    and per row the base-rotation entries (X x d, 9) and the six joint
    entries projected on d (5 each); per launch the 16 frames (12 each) and
    the rotated impulse sums (6 x 8 x 5)."""
    per_point = 30 + 4 + 3 + 3 * (9 + 6 * 5)
    return mega_ops(decimation, iterations) + decimation * 16 * per_point + 16 * 12 + 6 * 8 * 5


def mega_terrain_ops_executed(decimation: int, iterations: int) -> int:
    """Float32 operations one warp executes in one launch of the terrain
    variant, every lane counted: the flat launch's, plus per substep the
    two constraint columns each lane builds (rows lane and lane + 32; the
    warp issues the contact-row code for both) with the ground lookup, t2
    and phi (30 + 4 + 3) and the row direction's base-rotation (9) and joint
    entries (6 x 5); per launch the frames (12) and the rotated impulse
    sums (8 points x 8)."""
    per_row = 30 + 4 + 3 + 9 + 6 * 5
    return mega_ops_executed(decimation, iterations) + 32 * (decimation * 2 * per_row + 12 + 8 * 8)


PROJ_OPS = 16 * 20 + 12  # 16 cone projections + 12 clamps


def terrain_patches_ops() -> int:
    """Operations of one env's IN2 rows (csrc/terrain_patches.cu
    hgt_terrain_patches_kernel): the base rotation (30); per joint of the
    two 6-joint legs the offset step (3 x 5 + 3), Rodrigues (sine, cosine,
    1 - cos and 9 x 4) and the two 3 x 3 products (2 x 9 x 5); per contact
    point the xy (2 x 5 + 4), the grid coordinates (2 x 4) and the slope
    (2 + 2 x 8)."""
    per_joint = 3 * 5 + 3 + 3 + 9 * 4 + 2 * 9 * 5
    per_point = 2 * 5 + 4 + 2 * 4 + 2 + 2 * 8
    return 30 + 2 * 6 * per_joint + 16 * per_point


def rewards_ops(nj: int = 12, n_pen: int = 3) -> int:
    """Operations of one env's reward stage (csrc/rewards.cu
    hgt_rewards_kernel), each expf, sqrtf and sinf counted as one: per joint
    the five differences and the nine sums of squares and magnitudes (26);
    the phase and stance (9), the feet (2 x 17), the 26 terms (239 with 2
    per collision flag), the sums over the 26 kernel terms (4 each) with
    the clip and the termination term (107), the feet state (12)."""
    return 26 * nj + 9 + 2 * 17 + 239 + 2 * n_pen + 107 + 12


def rewards_bytes(nj: int = 12, n_cols: int = 22, n_pen: int = 3) -> int:
    """Bytes one env's reward stage moves (csrc/rewards.cu): in, the floats
    it reads (root xyz, qpos and qvel joints, the root velocity, six
    nj-rows, 13 of the base quantities and commands, the last root
    velocity, the 14 FK rows, two feet's forces, the carried feet state,
    the episode sums), the episode length, the flags; out, the reward, the
    sums, the float feet state and four flags."""
    floats_in = 3 + nj + 6 + nj + 6 * nj + 13 + 6 + 14 + 6 + 6 + n_cols
    return 4 * floats_in + 4 + n_pen + 2 + 3 + 4 * (1 + n_cols + 6) + 4


def apgd_loop_ops(iterations: int, nrow: int = 60) -> int:
    """Operations of hgt_warp_apgd for one env (csrc/apgd.cuh): the warm
    start's projection, then per iteration the dense matvec, the trial
    point, its projection, the restart test and the momentum step."""
    per_iter = 2 * nrow * nrow + nrow + 2 * nrow + PROJ_OPS + nrow + 2 * nrow + 12 + 2 * nrow
    return PROJ_OPS + iterations * per_iter


def apgd_ops(iterations: int, nrow: int = 60) -> int:
    """Operations of hgt_apgd_kernel for one env (csrc/dense_solve.cu): sign
    folding of A, r and the warm start, the loop, the unfolding."""
    return 2 * nrow * nrow + 2 * nrow + nrow + apgd_loop_ops(iterations, nrow) + nrow


def fused_dense_ops(iterations: int, nv: int = 18, nrow: int = 60, executed: bool = False) -> int:
    """Operations the function of hgt_fused_dense_kernel needs for one env.
    The Delassus matrix A = B^T B and the Gram matrix B B^T are symmetric,
    so the function needs one triangle of each (diagonal included); the
    kernel builds A in full (each lane its two whole rows) and the Gram
    matrix by its 171 pairs, and `executed=True` counts that."""
    delassus_entries = nrow * nrow if executed else nrow * (nrow + 1) // 2
    gram_entries = nv * (nv + 1) // 2
    ops = 0
    for k in range(nv):  # Cholesky: root, column scale, trailing update
        ops += 2 + (nv - 1 - k) + 2 * sum(i - k for i in range(k + 1, nv))
    tri = sum(1 + 2 * (nv - 1 - k) for k in range(nv))
    ops += 2 * tri + nv  # v_free
    ops += nrow * (2 * nv + 2)  # r = sign * J v_free - target
    ops += nrow * tri + nv * nrow  # B = L^-1 J^T, sign fold
    ops += 2 * nv * nrow + 3 + nrow  # trace, regularizer, diagonal
    ops += delassus_entries * 2 * nv  # dense Delassus
    ops += gram_entries * (2 * nrow + 1) + nv + 3  # Gram row sums, max, step
    ops += nrow + apgd_loop_ops(iterations, nrow)  # warm-start fold + loop
    ops += nv * 2 * nrow + tri + nv + nrow  # dv, qvel_new, unfold
    return ops


def bound_ms(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the larger of the time to move
    `nbytes` at the memory rate and to do `ops` float32 operations at the
    float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def net_flops(envs, T=60, epochs=2,
              obs=705, priv=219, act=12,
              actor_hidden=(512, 256, 128), critic_hidden=(768, 256, 128)):
    """Actor/critic matmul FLOPs (logical, unpadded) of one iteration:
    (rollout forward, learn forward + backward with backward = 2x forward).
    Defaults are the flat XBot-L nets. The same count as the JAX package's
    `net_flops`."""
    def mlp(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))

    actor = mlp((obs, *actor_hidden, act))
    critic = mlp((priv, *critic_hidden, 1))
    per_sample_fwd = 2 * (actor + critic)  # MAC = 2 FLOP
    batch = envs * T
    rollout = batch * per_sample_fwd
    learn = batch * epochs * per_sample_fwd * 3  # fwd + bwd(2x)
    return rollout, learn


def iteration_flops(envs, T=60, epochs=2):
    """FLOPs of one flat-task training iteration: T policy steps of physics
    (one mega launch each: `mega_ops` per env at the main path's 10
    substeps and 8 solver iterations), the nets (`net_flops`) and GAE (~10
    FLOP a sample, as the JAX census)."""
    phys = envs * T * mega_ops(10, 8)
    roll_nn, learn_nn = net_flops(envs, T, epochs)
    gae = envs * T * 10
    return phys + roll_nn + learn_nn + gae


def physics_flops_per_step(envs, terrain=False, decimation=10, iterations=8):
    """Operations of ONE policy step of physics for `envs` envs: one mega
    launch (`mega_ops`, or `mega_terrain_ops` on a heightfield) per env."""
    ops = mega_terrain_ops if terrain else mega_ops
    return envs * ops(decimation, iterations)


def physics_issue_per_step(envs, terrain=False, decimation=10, iterations=8):
    """Float32 operations the warps issue in ONE policy step of physics, every
    lane counted whether or not its result is used (`mega_ops_executed`, or
    `mega_terrain_ops_executed`, per env: one warp an env). This, and not
    the function's operations, is what the issue-bound kernel's run time
    tracks."""
    ops = mega_terrain_ops_executed if terrain else mega_ops_executed
    return envs * ops(decimation, iterations)


def hbm_bytes(envs, T=60, terrain=False):
    """Major per-iteration device-memory flows (bytes), both directions
    counted. The rollout's three flows are the JAX package's: the storage
    written once, the permutation's gathers (read + write) and two epochs
    of minibatch reads of its rows (obs 705 + privileged 219 + 3 x 12
    actions, means, stds + 4 scalars, float32). The kernel's flow is what
    the mega launches' inputs and outputs hold: (IN_ROWS + OUT_ROWS) floats
    an env, + IN2_ROWS on a heightfield, T launches. On a heightfield
    `make_terrain_patches` also reads each point's 3 x 3 taps from the grid
    and writes the IN2 rows once a policy step."""
    batch = envs * T
    row = (705 + 219 + 12 * 3 + 4) * 4
    kernel_floats = IN_ROWS + OUT_ROWS + (IN2_ROWS if terrain else 0)
    flows = {
        "rollout storage write": batch * row,
        "perm gathers (read+write)": 2 * batch * row,
        "learn minibatch reads (2 epochs)": 2 * batch * row,
        f"kernel in/out rows ({T} launches)": batch * kernel_floats * 4,
    }
    if terrain:
        flows["terrain patches (taps read, IN2 rows written)"] = batch * (9 * N_POINTS + IN2_ROWS) * 4
    return flows
