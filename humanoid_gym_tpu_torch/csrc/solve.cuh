// Contact solve for one environment by one warp: Cholesky of Mtilde, free
// velocity, B = L^-1 J^T, factor-form APGD over friction cones and
// joint-limit rows, and the post-impulse velocity.
//
// Replaces humanoid_gym_tpu/physics/pallas_solver.py:_fused_core_opt with
// leg_blocks=True (the solve stage of the TPU mega kernel). Same math:
// DOFs in the solver-internal order [left leg 0:6, right leg 6:12, base
// 12:18], so the factor has no cross-leg fill-in and every structurally
// zero block is skipped (HgtLegZeros, resolved at compile time); 60 constraint
// rows = 16 contact points x (tx, ty, n) followed by 12 joint-limit rows;
// each APGD iteration is t = B y then g = B^T t + reg y + r (never the
// dense 60x60 Delassus); the step is 1 / max(||B B^T||_inf + reg, 1e-6)
// with reg = comp * sum diag(B^T B) / 60; cones projected with nt floored at
// 1e-24 under the root; warm start in physical signs, sign-folded then
// projected; lam unfolded on the way out.
//
// What bounds it on the H100: about 85 k float32 operations per env on
// 6.5 KB of operands, as a chain of small dependent steps. It is far below
// both the bandwidth and the FLOP roofline; what limits it is instruction
// throughput (the mega kernel loses 1-2% when its resident warps are halved,
// see mega.cu), so the design spreads one env over the 32 lanes of a warp,
// keeps every operand in registers or that warp's shared memory, and spends
// as few shuffles and shared-memory reads as it can.
//
// Lane assignment (lane l of the env's warp):
//   Cholesky        lane i < 18 holds row i of M in 18 registers; step k
//                   takes the pivot and each L[j][k] from its owner by
//                   shuffle (135 shuffles, 117 multiply-adds per lane);
//                   1 / L[k][k] is computed once per k and reused by every
//                   substitution (a multiply where the plain version divides).
//   substitutions   lane i holds entry i; the pivot entry goes round by
//                   shuffle; forward steps use the register row, backward
//                   steps read column entries of L from shared memory.
//   J^T and B       lane l owns constraint columns l and l + 32 (the second
//                   exists for l < 28) in 2 x 18 registers, from the moment
//                   the caller's functor builds them: r = s (J v_free) -
//                   target, the triangular solve down each column and the
//                   sign fold are lane-local; B never lies in shared memory.
//   t = B y         each lane forms its 18 partial sums from its two
//                   columns; hgt_warp_reduce18 sums 18 values over the warp
//                   in 9+5+3+2+1 = 20 shuffles (each round a lane hands half
//                   of its values to its partner) and leaves value v on one
//                   lane, which writes t[v] to shared memory.
//   g, y, lam       lane-local (t read back as 5 float4 broadcasts).
//   projection      lanes 0..15 one cone each, lanes over the limit rows
//                   (hgt_warp_project of apgd.cuh) on the shared vector x.
//   restart test    shuffle sum.
//   Gram bound      the 135 structurally non-zero pairs v <= w of B B^T in
//                   8 batches of 18 through hgt_warp_reduce18; |G| is
//                   scattered into an 18 x 19 shared matrix and lane v sums
//                   row v in a fixed order.
// The other assignment (lanes on DOF rows, t lane-local, g by reduction)
// would need a row of 60 in registers or B in shared memory (18 x 61 floats
// per env, which does not fit one wave, see mega.cu) and 60 reductions per
// iteration instead of 18; it was not built.
//
// Shared memory of one warp's solve: HGT_SOLVE_FLOATS = 448 floats, 1,792 B
// (M/L 18 x 19, 1/diag, t, x) plus a Gram scratch of HGT_GRAM_FLOATS = 344
// floats, 1,376 B, that the mega kernel overlays on its dead kinematics
// scratch. Residency of the stand-alone launch (mega.cu hgt_solve_kernel, 8
// envs per block): 8 x 3,168 + 288 = 25,632 B per block and 64 registers per
// thread, so four blocks (32 warps) are resident per SM and 4096 envs are one
// wave; the mega kernel's reckoning is in mega.cu. Tried and dropped: a thread
// per env with M, B and the APGD vectors in local memory (0.49 ms stand-alone
// at 4096 envs against 0.04-0.06 ms now, NVIDIA H100 80GB HBM3, 700.00 W).
// The Cholesky, the substitutions, the column solve, hgt_warp_reduce18 and the
// Gram batches are the templates of apgd.cuh, instantiated here with the
// leg-block zero pattern; dense_solve.cu instantiates them without zeros.

#pragma once

#include "apgd.cuh"

#define HGT_NPAIR 135 // structurally non-zero entries (i, a <= i) of M, L and B B^T
static_assert(hgt_npair<HgtLegZeros>() == HGT_NPAIR, "pair count of the leg-block pattern");

// per-warp shared scratch of the solve (float offsets; T and X 16-byte aligned)
#define HGT_SM_M 0           // 18 x 19 (HGT_LS), padded to 344
#define HGT_SM_DINV 344      // 1 / L[k][k], 18 padded to 20
#define HGT_SM_T 364         // v_free, then t = B y, then B lam; 18 padded to 20
#define HGT_SM_X 384         // trial point, 64
#define HGT_SOLVE_FLOATS 448
#define HGT_GRAM_FLOATS 344  // |B B^T|, 18 x 19 padded

// Block-wide: fill the (row, column) byte table of the non-zero pairs in
// shared memory. The caller synchronises the block afterwards.
__device__ __forceinline__ void hgt_fill_pairs(unsigned char* pairs) {
    for (int t = threadIdx.x; t < HGT_NPAIR; t += blockDim.x) {
        int p = hgt_pair<HgtLegZeros>(t);
        pairs[2 * t] = (unsigned char)(p >> 5);
        pairs[2 * t + 1] = (unsigned char)(p & 31);
    }
}

// One environment's solve by one warp; every lane of the warp calls it.
//   sm     HGT_SOLVE_FLOATS of this warp's shared memory. On entry the lower
//          triangle of Mtilde (solver order, structurally zero cross-leg
//          entries excepted) lies at sm[HGT_SM_M + i * HGT_LS + a] and the
//          warp is synchronised.
//   gs     HGT_GRAM_FLOATS of scratch, free once `cols` has run.
//   pairs  the block's table from hgt_fill_pairs.
//   rhs_i, qvel_i   entry `lane` (< 18) of dt * (S tau + tau_fric - h) and of
//          the velocity, solver order.
//   lamp0, lamp1    warm start of rows lane and lane + 32, physical signs.
//   cols(b0, b1, tg0, tg1, s0, s1)   fills this lane's two columns of J^T
//          (NOT sign-folded), their desired constraint velocities (limit
//          rows in their sign-local form) and signs; a missing second column
//          is zeros with target 0 and sign 1.
// Returns entry `lane` of the new velocity (lanes < 18) and the impulses of
// rows lane and lane + 32 in physical signs.
template <class Cols>
__device__ __forceinline__ void hgt_solve_env(float* sm, float* gs, const unsigned char* pairs,
                                              int lane, float rhs_i, float qvel_i, float mu,
                                              float comp, float lamp0, float lamp1,
                                              int iterations, Cols& cols, float& qn_i,
                                              float& lam_out0, float& lam_out1) {
    float* Ms = sm + HGT_SM_M;
    float* dinv = sm + HGT_SM_DINV;
    float* tv = sm + HGT_SM_T;
    float* x = sm + HGT_SM_X;
    const bool dof = lane < HGT_NV;
    const bool v1 = lane + 32 < HGT_NR;
    const int slot = hgt_reduce18_slot(lane);

    // ---- right-looking Cholesky, row `lane` in registers ----
    float Lr[HGT_NV];
#pragma unroll
    for (int j = 0; j < HGT_NV; ++j) {
        bool have = dof && j <= lane && !HgtLegZeros::at(lane, j);
        Lr[j] = have ? Ms[(dof ? lane : 0) * HGT_LS + j] : 0.0f;
    }
    hgt_warp_cholesky<HgtLegZeros>(Lr, dinv, lane);
    if (dof) {
#pragma unroll
        for (int j = 0; j < HGT_NV; ++j) Ms[lane * HGT_LS + j] = Lr[j];
    }
    if (lane >= HGT_NV && lane < 20) tv[lane] = 0.0f;  // the float4 reads of t cover 20
    __syncwarp();

    // ---- v_free = qvel + L^-T L^-1 rhs, lane i holds entry i ----
    float xi = hgt_warp_forward_sub(dof ? rhs_i : 0.0f, Lr, dinv, lane);
    xi = hgt_warp_backward_sub(xi, Ms, dinv, lane);
    const float vfi = dof ? qvel_i + xi : 0.0f;
    if (dof) tv[lane] = vfi;
    __syncwarp();

    // ---- this lane's two columns of J^T; r = sign * (J v_free) - target ----
    float b0[HGT_NV], b1[HGT_NV];
    float tg0, tg1, s0, s1;
    cols(b0, b1, tg0, tg1, s0, s1);
    float tt[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
        float4 f = reinterpret_cast<const float4*>(tv)[q];
        tt[4 * q] = f.x; tt[4 * q + 1] = f.y; tt[4 * q + 2] = f.z; tt[4 * q + 3] = f.w;
    }
    float u0 = 0.0f, u1 = 0.0f;
#pragma unroll
    for (int v = 0; v < HGT_NV; ++v) {
        u0 = u0 + b0[v] * tt[v];
        u1 = u1 + b1[v] * tt[v];
    }
    const float rr0 = u0 * s0 - tg0;
    const float rr1 = v1 ? u1 * s1 - tg1 : 0.0f;

    // ---- B = L^-1 J^T down each column, then sign-folded ----
    const float diag = hgt_solve_columns<HgtLegZeros>(b0, b1, Ms, dinv, s0, s1);
    const float reg = comp * hgt_warp_sum(diag) / (float)HGT_NR;

    // ---- step bound ||B B^T||_inf + reg (cross-leg entries are exact zeros) ----
    // every lane is past its reads of the caller's scratch under gs: `cols`
    // ran before the shuffles above
    for (int idx = lane; idx < HGT_GRAM_FLOATS; idx += 32) gs[idx] = 0.0f;
    __syncwarp();
    hgt_gram_batches<HgtLegZeros, 0>(gs, pairs, b0, b1, lane, slot);
    __syncwarp();
    float rowsum = 0.0f;
    if (dof) {
#pragma unroll
        for (int w = 0; w < HGT_NV; ++w) rowsum += gs[lane * HGT_LS + w];
    }
    const float step = 1.0f / fmaxf(hgt_warp_max(rowsum) + reg, 1e-6f);

    // ---- warm start: fold, project ----
    x[lane] = lamp0 * s0;
    x[lane + 32] = v1 ? lamp1 * s1 : 0.0f;
    __syncwarp();
    hgt_warp_project(x, HGT_NP, HGT_NR, mu, lane);
    float lam0 = x[lane], lam1 = v1 ? x[lane + 32] : 0.0f;
    float y0 = lam0, y1 = lam1;

    // ---- APGD with Nesterov momentum and adaptive restart ----
    float theta = 1.0f;
    float p[HGT_NV];
    for (int it = 0; it < iterations; ++it) {
#pragma unroll
        for (int v = 0; v < HGT_NV; ++v) p[v] = b0[v] * y0 + b1[v] * y1;
        float tsum = hgt_warp_reduce18(p, lane);
        if (slot >= 0) tv[slot] = tsum;
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 5; ++q) {
            float4 f = reinterpret_cast<const float4*>(tv)[q];
            tt[4 * q] = f.x; tt[4 * q + 1] = f.y; tt[4 * q + 2] = f.z; tt[4 * q + 3] = f.w;
        }
        float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
        for (int v = 0; v < HGT_NV; ++v) {
            g0 = g0 + b0[v] * tt[v];
            g1 = g1 + b1[v] * tt[v];
        }
        g0 = g0 + reg * y0 + rr0;
        g1 = v1 ? g1 + reg * y1 + rr1 : 0.0f;
        x[lane] = y0 - step * g0;
        if (v1) x[lane + 32] = y1 - step * g1;
        __syncwarp();
        hgt_warp_project(x, HGT_NP, HGT_NR, mu, lane);
        float ln0 = x[lane], ln1 = v1 ? x[lane + 32] : 0.0f;
        float e0 = ln0 - lam0, e1 = ln1 - lam1;
        float gd = hgt_warp_sum(g0 * e0 + g1 * e1);
        bool restart = gd > 0.0f;
        if (restart) theta = 1.0f;
        float theta_new = 0.5f * (theta * sqrtf(theta * theta + 4.0f) - theta * theta);
        float beta = restart ? 0.0f : theta * (1.0f - theta) / (theta * theta + theta_new);
        y0 = ln0 + beta * e0;
        y1 = ln1 + beta * e1;
        lam0 = ln0;
        lam1 = ln1;
        theta = theta_new;
        // the next write of x follows the synchronisation after the next write of t
    }

    // ---- qvel_new = v_free + L^-T (B lam) ----
#pragma unroll
    for (int v = 0; v < HGT_NV; ++v) p[v] = b0[v] * lam0 + b1[v] * lam1;
    float bl = hgt_warp_reduce18(p, lane);
    if (slot >= 0) tv[slot] = bl;
    __syncwarp();
    const float yi = hgt_warp_backward_sub(dof ? tv[lane] : 0.0f, Ms, dinv, lane);
    qn_i = vfi + yi;
    lam_out0 = lam0 * s0;
    lam_out1 = lam1 * s1;
    __syncwarp();  // the caller may overwrite sm
}
