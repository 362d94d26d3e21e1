// Warp-cooperative APGD on a dense Delassus matrix held in shared memory.
//
// The iteration shared by the two dense contact-solve kernels of
// dense_solve.cu (the counterparts of humanoid_gym_tpu/physics/
// pallas_solver.py `_apgd_kernel` and `_fused_kernel`): accelerated
// projected gradient with Nesterov momentum and adaptive restart on
//   min 0.5 lam^T A lam + lam^T r
// over n_points friction cones ((tx, ty, n) blocks) and non-negative
// (sign-folded) limit rows.
//
// One warp owns one environment. The matrix sits in that warp's shared
// memory with an odd row stride, so that lanes reading one column of 32
// different rows hit 32 different banks; lane l owns rows l and l + 32
// (nrow <= 64), y and the trial point x are shared vectors, lane k < n_points
// projects cone k, and the restart test sum(g * d) is a shuffle reduction.

#pragma once

#define HGT_FULL_MASK 0xffffffffu
#define HGT_MAX_ROWS 64  // two rows per lane

__device__ __forceinline__ float hgt_warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(HGT_FULL_MASK, v, o);
    return v;
}

__device__ __forceinline__ float hgt_warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(HGT_FULL_MASK, v, o));
    return v;
}

// Desired velocity of constraint row r: the normal rows of the contact
// blocks carry lo_bound, the limit rows their sign-local bound.
__device__ __forceinline__ float hgt_row_target(int r, int n_points, const float* lo,
                                                const float* lbound) {
    int nc3 = 3 * n_points;
    if (r >= nc3) return lbound[r - nc3];
    return (r % 3 == 2) ? lo[r / 3] : 0.0f;
}

// Projection of the shared vector x, in place: cones by lanes over contact
// points (nt floored at 1e-24 under the root, as the TPU kernels do),
// max(., 0) on the limit rows. The caller has synchronised the warp after
// writing x; the function synchronises before it returns.
__device__ __forceinline__ void hgt_warp_project(float* x, int n_points, int nrow, float mu,
                                                 int lane) {
    for (int k = lane; k < n_points; k += 32) {
        float tx = x[3 * k], ty = x[3 * k + 1], n = x[3 * k + 2];
        float nt = sqrtf(tx * tx + ty * ty + 1e-24f);
        bool inside = nt <= mu * n;
        bool polar = mu * nt <= -n;
        float n_p = fmaxf((mu * nt + n) / (1.0f + mu * mu), 0.0f);
        float scale = mu * n_p / nt;
        if (inside) {
            // keep
        } else if (polar) {
            x[3 * k] = 0.0f; x[3 * k + 1] = 0.0f; x[3 * k + 2] = 0.0f;
        } else {
            x[3 * k] = tx * scale; x[3 * k + 1] = ty * scale; x[3 * k + 2] = n_p;
        }
    }
    for (int r = 3 * n_points + lane; r < nrow; r += 32) x[r] = fmaxf(x[r], 0.0f);
    __syncwarp();
}

// The APGD loop of one warp.
//   A    shared, nrow rows of stride `as`, sign-folded, regularizer included
//   y, x shared vectors of HGT_MAX_ROWS floats; on entry x holds the
//        sign-folded warm start (not yet projected) and the warp is
//        synchronised
//   rr0, rr1  the gradient offset r of this lane's rows (0 for a row >= nrow)
// Returns this lane's two entries of lam (solver signs) in lam0 / lam1.
__device__ __forceinline__ void hgt_warp_apgd(const float* A, int as, float* y, float* x,
                                              float rr0, float rr1, float step, float mu,
                                              int nrow, int n_points, int iterations, int lane,
                                              float& lam0, float& lam1) {
    const int r0 = lane, r1 = lane + 32;
    const bool v0 = r0 < nrow, v1 = r1 < nrow;
    // a lane without a second (or first) row reads a valid row and drops the sum
    const float* a0 = A + (v0 ? r0 : 0) * as;
    const float* a1 = A + (v1 ? r1 : (v0 ? r0 : 0)) * as;

    hgt_warp_project(x, n_points, nrow, mu, lane);
    lam0 = v0 ? x[r0] : 0.0f;
    lam1 = v1 ? x[r1] : 0.0f;
    if (v0) y[r0] = lam0;
    if (v1) y[r1] = lam1;
    __syncwarp();

    float theta = 1.0f;
    for (int it = 0; it < iterations; ++it) {
        float g0 = 0.0f, g1 = 0.0f;
        for (int c = 0; c < nrow; ++c) {
            float yc = y[c];
            g0 = g0 + a0[c] * yc;
            g1 = g1 + a1[c] * yc;
        }
        g0 = v0 ? g0 + rr0 : 0.0f;
        g1 = v1 ? g1 + rr1 : 0.0f;
        if (v0) x[r0] = y[r0] - step * g0;
        if (v1) x[r1] = y[r1] - step * g1;
        __syncwarp();
        hgt_warp_project(x, n_points, nrow, mu, lane);
        float ln0 = v0 ? x[r0] : 0.0f;
        float ln1 = v1 ? x[r1] : 0.0f;
        float d0 = ln0 - lam0, d1 = ln1 - lam1;
        float gd = hgt_warp_sum(g0 * d0 + g1 * d1);
        bool restart = gd > 0.0f;
        if (restart) theta = 1.0f;
        float theta_new = 0.5f * (theta * sqrtf(theta * theta + 4.0f) - theta * theta);
        float beta = restart ? 0.0f : theta * (1.0f - theta) / (theta * theta + theta_new);
        // every lane passed the synchronisation above after its last read of y
        if (v0) y[r0] = ln0 + beta * d0;
        if (v1) y[r1] = ln1 + beta * d1;
        lam0 = ln0;
        lam1 = ln1;
        theta = theta_new;
        __syncwarp();
    }
}
