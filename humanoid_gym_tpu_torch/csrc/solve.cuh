// Contact solve for one environment: Cholesky of Mtilde, free velocity,
// B = L^-1 J^T, factor-form APGD over friction cones and joint-limit rows,
// and the post-impulse velocity.
//
// Replaces humanoid_gym_tpu/physics/pallas_solver.py:_fused_core_opt with
// leg_blocks=True (the solve stage of the TPU mega kernel). Same math, same
// operand order: DOFs in the solver-internal order [left leg 0:6, right
// leg 6:12, base 12:18], so the factor has no cross-leg fill-in and every
// structurally zero block is skipped; 60 constraint rows = 16 contact
// points x (tx, ty, n) followed by 12 joint-limit rows; the APGD step bound
// is ||B B^T||_inf plus the compliance (CFM) regularizer; projection onto
// the cones in the kernel's form (nt with a 1e-24 floor); warm start from
// lam0 in physical signs, sign-folded only inside the solve.
//
// What bounds it on the H100: one thread does one environment's scalar
// work (an 18x18 factor, an 18x60 triangular solve, 8 APGD iterations of
// two 18x60 matvecs), so the kernel is issue- and latency-bound, as the TPU
// version was; it sits far below both the memory-bandwidth and the FLOP
// roofline (a few KB of input per env). The design keeps every per-env
// operand in thread-local arrays (local memory, which the L1/L2 caches
// serve) and launches small blocks so that 4096 environments spread over
// all 132 SMs. Making it faster (warp-cooperative factorization, operands
// in shared memory) is later work.

#pragma once

#define HGT_NV 18     // generalized velocities
#define HGT_NP 16     // contact points (8 sole points x 2 feet)
#define HGT_NC 48     // contact rows
#define HGT_NR 60     // constraint rows (contact + 12 joint limits)
#define HGT_HALF 6    // joints per leg (and base DOF count)

// L[i][k] is structurally zero: a right-leg row under a left-leg column.
__device__ __forceinline__ bool hgt_lz(int i, int k) {
    return k < HGT_HALF && i >= HGT_HALF && i < 2 * HGT_HALF;
}

// Friction-cone projection of the 16 (tx, ty, n) blocks and nonnegativity
// of the 12 (sign-folded) limit rows, in place.
__device__ __forceinline__ void hgt_project(float* x, float mu) {
    for (int k = 0; k < HGT_NP; ++k) {
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
    for (int r = HGT_NC; r < HGT_NR; ++r) x[r] = fmaxf(x[r], 0.0f);
}

// One environment's solve.
//   M      (18x18) Mtilde in solver order; overwritten by its Cholesky
//          factor in the lower triangle.
//   B      (18x60) J^T in solver order, NOT sign-folded; overwritten by
//          the sign-folded B = L^-1 J^T.
//   qvel, rhs (18): velocity and dt * (S tau + tau_fric - h), solver order.
//   target, sign (60): desired constraint velocities (limit rows in their
//          sign-local form) and +-1 per limit row (1 elsewhere).
//   lam0 (60): warm start in physical signs.
// Writes qvel_new (18, solver order) and lam (60, physical signs).
__device__ void hgt_solve_env(float (*M)[HGT_NV], float (*B)[HGT_NR],
                              const float* qvel, const float* rhs,
                              const float* target, const float* sign,
                              float mu, float comp, const float* lam0,
                              int iterations, float* qvel_new, float* lam) {
    // ---- in-place right-looking Cholesky (leg-block sparsity) ----
    for (int k = 0; k < HGT_NV; ++k) {
        float d = sqrtf(fmaxf(M[k][k], 1e-12f));
        M[k][k] = d;
        for (int i = k + 1; i < HGT_NV; ++i)
            if (!hgt_lz(i, k)) M[i][k] = M[i][k] / d;
        for (int j = k + 1; j < HGT_NV; ++j) {
            if (hgt_lz(j, k)) continue;
            float cj = M[j][k];
            for (int i = j; i < HGT_NV; ++i)
                if (!hgt_lz(i, k)) M[i][j] = M[i][j] - M[i][k] * cj;
        }
    }

    // ---- v_free = qvel + L^-T L^-1 rhs ----
    float vf[HGT_NV];
    for (int k = 0; k < HGT_NV; ++k) vf[k] = rhs[k];
    for (int k = 0; k < HGT_NV; ++k) {
        float xk = vf[k] / M[k][k];
        vf[k] = xk;
        for (int i = k + 1; i < HGT_NV; ++i)
            if (!hgt_lz(i, k)) vf[i] = vf[i] - M[i][k] * xk;
    }
    for (int k = HGT_NV - 1; k >= 0; --k) {
        float xk = vf[k] / M[k][k];
        vf[k] = xk;
        for (int i = 0; i < k; ++i)
            if (!hgt_lz(k, i)) vf[i] = vf[i] - M[k][i] * xk;
    }
    for (int k = 0; k < HGT_NV; ++k) vf[k] = qvel[k] + vf[k];

    // ---- r = sign * (J v_free) - target (J^T still unfactored in B) ----
    float rr[HGT_NR];
    for (int r = 0; r < HGT_NR; ++r) {
        float u = 0.0f;
        for (int k = 0; k < HGT_NV; ++k) u = u + B[k][r] * vf[k];
        rr[r] = u * sign[r] - target[r];
    }

    // ---- B = L^-1 J^T, then sign-folded ----
    for (int k = 0; k < HGT_NV; ++k) {
        float dk = M[k][k];
        for (int r = 0; r < HGT_NR; ++r) B[k][r] = B[k][r] / dk;
        for (int i = k + 1; i < HGT_NV; ++i) {
            if (hgt_lz(i, k)) continue;
            float lik = M[i][k];
            for (int r = 0; r < HGT_NR; ++r) B[i][r] = B[i][r] - lik * B[k][r];
        }
    }
    for (int k = 0; k < HGT_NV; ++k)
        for (int r = 0; r < HGT_NR; ++r) B[k][r] = B[k][r] * sign[r];

    // ---- step bound ||G||_inf (G = B B^T, cross-leg entries are exact
    // zeros and skipped) + CFM regularizer ----
    float rows[HGT_NV];
    for (int v = 0; v < HGT_NV; ++v) rows[v] = 0.0f;
    for (int v = 0; v < HGT_NV; ++v) {
        for (int w = v; w < HGT_NV; ++w) {
            if (hgt_lz(w, v)) continue;
            float g = 0.0f;
            for (int r = 0; r < HGT_NR; ++r) g = g + B[v][r] * B[w][r];
            g = fabsf(g);
            rows[v] += g;
            if (w != v) rows[w] += g;
        }
    }
    float bound = rows[0];
    for (int v = 1; v < HGT_NV; ++v) bound = fmaxf(bound, rows[v]);
    float dsum = 0.0f;
    for (int r = 0; r < HGT_NR; ++r) {
        float dA = 0.0f;
        for (int v = 0; v < HGT_NV; ++v) dA = dA + B[v][r] * B[v][r];
        dsum = dsum + dA;
    }
    float reg = comp * dsum / (float)HGT_NR;
    float step = 1.0f / fmaxf(bound + reg, 1e-6f);

    // ---- APGD with Nesterov momentum and adaptive restart ----
    float y[HGT_NR], g[HGT_NR], t[HGT_NV];
    for (int r = 0; r < HGT_NR; ++r) lam[r] = lam0[r] * sign[r];
    hgt_project(lam, mu);
    for (int r = 0; r < HGT_NR; ++r) y[r] = lam[r];
    float theta = 1.0f;
    for (int it = 0; it < iterations; ++it) {
        for (int v = 0; v < HGT_NV; ++v) {
            float s = 0.0f;
            for (int r = 0; r < HGT_NR; ++r) s = s + B[v][r] * y[r];
            t[v] = s;
        }
        for (int r = 0; r < HGT_NR; ++r) {
            float s = 0.0f;
            for (int v = 0; v < HGT_NV; ++v) s = s + B[v][r] * t[v];
            g[r] = s + reg * y[r] + rr[r];
        }
        // g holds the gradient; y becomes the projected step
        for (int r = 0; r < HGT_NR; ++r) y[r] = y[r] - step * g[r];
        hgt_project(y, mu);
        float gd = 0.0f;
        for (int r = 0; r < HGT_NR; ++r) gd = gd + g[r] * (y[r] - lam[r]);
        bool restart = gd > 0.0f;
        if (restart) theta = 1.0f;
        float theta_new = 0.5f * (theta * sqrtf(theta * theta + 4.0f) - theta * theta);
        float beta = restart ? 0.0f : theta * (1.0f - theta) / (theta * theta + theta_new);
        for (int r = 0; r < HGT_NR; ++r) {
            float ln = y[r];
            float d = ln - lam[r];
            lam[r] = ln;
            y[r] = ln + beta * d;
        }
        theta = theta_new;
    }

    // ---- qvel_new = v_free + L^-T (B lam) ----
    float dv[HGT_NV];
    for (int v = 0; v < HGT_NV; ++v) {
        float s = 0.0f;
        for (int r = 0; r < HGT_NR; ++r) s = s + B[v][r] * lam[r];
        dv[v] = s;
    }
    for (int k = HGT_NV - 1; k >= 0; --k) {
        float xk = dv[k] / M[k][k];
        dv[k] = xk;
        for (int i = 0; i < k; ++i)
            if (!hgt_lz(k, i)) dv[i] = dv[i] - M[k][i] * xk;
    }
    for (int v = 0; v < HGT_NV; ++v) qvel_new[v] = vf[v] + dv[v];
    for (int r = 0; r < HGT_NR; ++r) lam[r] = lam[r] * sign[r];
}
