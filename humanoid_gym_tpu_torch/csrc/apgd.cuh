// Warp-cooperative pieces shared by the contact-solve kernels of both
// libraries: solve.cuh (the factor-form solve inside the mega kernel) and
// dense_solve.cu (the two dense solves of the per-substep path, the
// counterparts of humanoid_gym_tpu/physics/pallas_solver.py `_apgd_kernel`
// and `_fused_kernel` -> `_fused_core`).
//
// One warp owns one environment everywhere. What lives here:
//   sizes          the one problem shape every model of the package builds:
//                  18 generalized velocities, 16 contact points x (tx, ty, n)
//                  + 12 joint-limit rows = 60 constraint rows. They are
//                  compile-time sizes because the kernels keep rows and
//                  columns in register arrays; the wrappers raise on any
//                  other shape.
//   reductions     shuffle sum / max, and hgt_warp_reduce18: 18 per-lane
//                  values summed over the warp in 9+5+3+2+1 = 20 shuffles.
//   factorisation  hgt_warp_cholesky: lane i holds row i of the 18 x 18
//                  matrix in 18 registers; step k takes the pivot and each
//                  L[j][k] from its owner by shuffle; 1 / L[k][k] is formed
//                  once per k and every substitution multiplies by it. The
//                  zero pattern of the factor is a template argument
//                  (HgtLegZeros: solver-internal DOF order, no cross-leg
//                  fill-in, 135 entries; HgtNoZeros: external order, the
//                  base comes first and the factor fills in, all 171).
//                  hgt_solve_columns: B = L^-1 J^T down the lane's two
//                  constraint columns in 2 x 18 registers, sign-folded.
//   Gram bound     the structurally non-zero pairs v <= w of B B^T from the
//                  lanes' two column registers, 18 at a time through
//                  hgt_warp_reduce18, |G| scattered to an 18 x 19 shared
//                  matrix and summed by row in a fixed order. The pairs'
//                  (row, column) table is built by the compiler
//                  (hgt_pair_table, in device memory).
//   projection     friction cones by lanes 0..15, clamps on the limit rows.
//   hgt_warp_apgd  the dense APGD loop (accelerated projected gradient,
//                  Nesterov momentum, adaptive restart) on
//                    min 0.5 lam^T A lam + lam^T r
//                  with the matrix IN REGISTERS: lane l holds rows l and
//                  l + 32 of the sign-folded matrix as 2 x 60 floats for the
//                  whole loop. An iteration is 15 sixteen-byte broadcast
//                  reads of y and 120 multiply-adds a lane, four partial sums
//                  a row; shared memory holds only y and the trial point x.
//                  Before, the matrix lay in shared memory with an odd row
//                  stride and every iteration read all of it again four bytes
//                  a read (180 shared-memory wavefronts an iteration): that
//                  pipe alone was 1.8x the APGD kernel's bytes bound. With the
//                  rows in registers 8 iterations at 4096 envs take 0.0105 ms
//                  in hgt_apgd_kernel (NVIDIA H100 80GB HBM3, 700.00 W); the
//                  kernels' times are in dense_solve.cu's note.

#pragma once

#define HGT_FULL_MASK 0xffffffffu
#define HGT_NV 18        // generalized velocities
#define HGT_NP 16        // contact points (8 sole points x 2 feet)
#define HGT_NC 48        // contact rows
#define HGT_NR 60        // constraint rows (contact + 12 joint limits)
#define HGT_HALF 6       // joints per leg (and base DOF count)
#define HGT_MAX_ROWS 64  // two rows per lane: the padded length of y and x
#define HGT_LS 19        // row stride of M / L (odd: lane i on row i hits bank i * 19)

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

// ---- zero patterns of the 18 x 18 factor ----

// Solver-internal DOF order [left leg, right leg, base]: L[i][k] is
// structurally zero for a right-leg row under a left-leg column.
struct HgtLegZeros {
    static __host__ __device__ constexpr bool at(int i, int k) {
        return k < HGT_HALF && i >= HGT_HALF && i < 2 * HGT_HALF;
    }
};

// External DOF order [base, left leg, right leg]: the factor fills in.
struct HgtNoZeros {
    static __host__ __device__ constexpr bool at(int, int) { return false; }
};

// Number of structurally non-zero entries (i, a <= i) of M, L and B B^T.
template <class Z>
__host__ __device__ constexpr int hgt_npair() {
    int count = 0;
    for (int i = 0; i < HGT_NV; ++i)
        for (int a = 0; a <= i; ++a)
            if (!Z::at(i, a)) ++count;
    return count;
}

// The idx-th structurally non-zero entry (row i, column a <= i) of the lower
// triangle, rows in order: packed as i * 32 + a.
template <class Z>
__host__ __device__ constexpr int hgt_pair(int idx) {
    int count = 0;
    for (int i = 0; i < HGT_NV; ++i)
        for (int a = 0; a <= i; ++a) {
            if (Z::at(i, a)) continue;
            if (count == idx) return i * 32 + a;
            ++count;
        }
    return -1;
}

// The (row, column) byte table of the non-zero pairs, built by the compiler:
// entry idx at rc[2 * idx], rc[2 * idx + 1]. hgt_pair_table<Z> lies in device
// memory, so a kernel can read it with no set-up of its own.
template <class Z>
struct HgtPairTable {
    unsigned char rc[2 * hgt_npair<Z>()];
    constexpr HgtPairTable() : rc() {
        int count = 0;
        for (int i = 0; i < HGT_NV; ++i)
            for (int a = 0; a <= i; ++a) {
                if (Z::at(i, a)) continue;
                rc[2 * count] = (unsigned char)i;
                rc[2 * count + 1] = (unsigned char)a;
                ++count;
            }
    }
};

template <class Z>
__device__ constexpr HgtPairTable<Z> hgt_pair_table{};

// ---- sum of 18 per-lane values over the warp ----

// Round by round (lane offsets 16, 8, 4, 2, 1) a lane keeps one half of its
// values and hands the other half to its partner, so 20 shuffles do the work
// of 18 x 5. The sum of value v ends on the one lane with
// hgt_reduce18_slot(lane) == v; other lanes return 0.
__device__ __forceinline__ float hgt_warp_reduce18(const float (&p)[HGT_NV], int lane) {
    const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2, h0 = lane & 1;
    float q[9], r[5], s[3], u[2];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        float lo = p[i], hi = p[9 + i];
        q[i] = (h4 ? hi : lo) + __shfl_xor_sync(HGT_FULL_MASK, h4 ? lo : hi, 16);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        float lo = q[i], hi = (i + 5 < 9) ? q[i + 5] : 0.0f;
        r[i] = (h3 ? hi : lo) + __shfl_xor_sync(HGT_FULL_MASK, h3 ? lo : hi, 8);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float lo = r[i], hi = (i + 3 < 5) ? r[i + 3] : 0.0f;
        s[i] = (h2 ? hi : lo) + __shfl_xor_sync(HGT_FULL_MASK, h2 ? lo : hi, 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float lo = s[i], hi = (i + 2 < 3) ? s[i + 2] : 0.0f;
        u[i] = (h1 ? hi : lo) + __shfl_xor_sync(HGT_FULL_MASK, h1 ? lo : hi, 2);
    }
    return (h0 ? u[1] : u[0]) + __shfl_xor_sync(HGT_FULL_MASK, h0 ? u[0] : u[1], 1);
}

// Which of the 18 values this lane holds after hgt_warp_reduce18, or -1.
__device__ __forceinline__ int hgt_reduce18_slot(int lane) {
    int base = 0, cnt = HGT_NV;
    const int halves[5] = {9, 5, 3, 2, 1};
#pragma unroll
    for (int r = 0; r < 5; ++r) {
        int h = halves[r];
        if (lane & (16 >> r)) { base += h; cnt = max(cnt - h, 0); }
        else cnt = min(cnt, h);
    }
    return cnt > 0 ? base : -1;
}

// ---- Cholesky and substitutions, row `lane` of the matrix in registers ----

// Right-looking Cholesky. On entry Lr holds the lower triangle of row `lane`
// (zeros above the diagonal, in structurally zero entries and on lanes >= 18);
// on exit row `lane` of L. dinv (shared, 18 floats) receives 1 / L[k][k]; the
// caller synchronises the warp before it reads dinv.
template <class Z>
__device__ __forceinline__ void hgt_warp_cholesky(float (&Lr)[HGT_NV], float* dinv, int lane) {
#pragma unroll
    for (int k = 0; k < HGT_NV; ++k) {
        float d = sqrtf(fmaxf(__shfl_sync(HGT_FULL_MASK, Lr[k], k), 1e-12f));
        float di = 1.0f / d;
        float lik = (lane == k) ? d : Lr[k] * di;  // 0 above the diagonal and in the zero block
        Lr[k] = lik;
        if (lane == k) dinv[k] = di;
#pragma unroll
        for (int j = k + 1; j < HGT_NV; ++j) {
            if (Z::at(j, k)) continue;
            float ljk = __shfl_sync(HGT_FULL_MASK, lik, j);
            if (j <= lane) Lr[j] = Lr[j] - lik * ljk;
        }
    }
}

// x <- L^-1 x: lane i holds entry i (0 on lanes >= 18), L by register rows.
__device__ __forceinline__ float hgt_warp_forward_sub(float xi, const float (&Lr)[HGT_NV],
                                                      const float* dinv, int lane) {
#pragma unroll
    for (int k = 0; k < HGT_NV; ++k) {
        float xk = __shfl_sync(HGT_FULL_MASK, xi, k) * dinv[k];
        if (lane == k) xi = xk;
        else if (lane > k) xi = xi - Lr[k] * xk;
    }
    return xi;
}

// x <- L^-T x: column entries L[k][lane] from the shared copy (stride HGT_LS).
__device__ __forceinline__ float hgt_warp_backward_sub(float xi, const float* Ms,
                                                       const float* dinv, int lane) {
#pragma unroll
    for (int k = HGT_NV - 1; k >= 0; --k) {
        float xk = __shfl_sync(HGT_FULL_MASK, xi, k) * dinv[k];
        if (lane == k) xi = xk;
        else if (lane < k) xi = xi - Ms[k * HGT_LS + lane] * xk;
    }
    return xi;
}

// B = L^-1 J^T down this lane's two columns of J^T (L's entries as broadcast
// reads of the shared copy), then sign-folded. Returns this lane's share of
// trace(B^T B).
template <class Z>
__device__ __forceinline__ float hgt_solve_columns(float (&b0)[HGT_NV], float (&b1)[HGT_NV],
                                                   const float* Ms, const float* dinv, float s0,
                                                   float s1) {
#pragma unroll
    for (int k = 0; k < HGT_NV; ++k) {
        float dk = dinv[k];
        b0[k] = b0[k] * dk;
        b1[k] = b1[k] * dk;
#pragma unroll
        for (int i = k + 1; i < HGT_NV; ++i) {
            if (Z::at(i, k)) continue;
            float lik = Ms[i * HGT_LS + k];
            b0[i] = b0[i] - lik * b0[k];
            b1[i] = b1[i] - lik * b1[k];
        }
    }
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int v = 0; v < HGT_NV; ++v) {
        b0[v] = b0[v] * s0;
        b1[v] = b1[v] * s1;
        d0 = d0 + b0[v] * b0[v];
        d1 = d1 + b1[v] * b1[v];
    }
    return d0 + d1;
}

// ---- Gram step bound from the column registers ----

// One batch of 18 Gram entries: this lane's partial products of the pairs
// B * 18 .. B * 18 + 17 (compile-time indices into the register columns).
template <class Z, int B, int I>
__device__ __forceinline__ void hgt_gram_partials(float (&p)[HGT_NV], const float (&b0)[HGT_NV],
                                                  const float (&b1)[HGT_NV]) {
    constexpr int idx = B * HGT_NV + I;
    if constexpr (idx < hgt_npair<Z>()) {
        constexpr int w = hgt_pair<Z>(idx) >> 5, v = hgt_pair<Z>(idx) & 31;
        p[I] = b0[v] * b0[w] + b1[v] * b1[w];
    } else {
        p[I] = 0.0f;
    }
    if constexpr (I + 1 < HGT_NV) hgt_gram_partials<Z, B, I + 1>(p, b0, b1);
}

// |B B^T| of every non-zero pair into gs (18 x HGT_LS, zeroed by the caller,
// warp synchronised), both triangles. `pairs` is the byte table of the pattern's
// pairs: hgt_pair_table<Z>.rc, or a copy of it in shared memory.
template <class Z, int B>
__device__ __forceinline__ void hgt_gram_batches(float* gs, const unsigned char* pairs,
                                                 const float (&b0)[HGT_NV],
                                                 const float (&b1)[HGT_NV], int lane, int slot) {
    float p[HGT_NV];
    hgt_gram_partials<Z, B, 0>(p, b0, b1);
    float g = fabsf(hgt_warp_reduce18(p, lane));
    int idx = B * HGT_NV + slot;
    if (slot >= 0 && idx < hgt_npair<Z>()) {
        int w = pairs[2 * idx], v = pairs[2 * idx + 1];
        gs[w * HGT_LS + v] = g;
        gs[v * HGT_LS + w] = g;
    }
    if constexpr ((B + 1) * HGT_NV < hgt_npair<Z>())
        hgt_gram_batches<Z, B + 1>(gs, pairs, b0, b1, lane, slot);
}

// ---- projection and the dense loop ----

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

// The dense APGD loop of one warp, the matrix in registers.
//   a0, a1  rows `lane` and `lane + 32` of the sign-folded matrix, regularizer
//           included; a1 is all zeros on the lanes without a second row
//   y, x    shared vectors of HGT_MAX_ROWS floats on 16-byte boundaries; on
//           entry x holds the sign-folded warm start (not yet projected) and
//           the warp is synchronised
//   rr0, rr1  the gradient offset r of this lane's rows (0 without a row)
// Returns this lane's two entries of lam (solver signs) in lam0 / lam1. The
// warp is synchronised on return and no lane reads y or x again.
__device__ __forceinline__ void hgt_warp_apgd(const float (&a0)[HGT_NR], const float (&a1)[HGT_NR],
                                              float* y, float* x, float rr0, float rr1,
                                              float step, float mu, int iterations, int lane,
                                              float& lam0, float& lam1) {
    const bool v1 = lane + 32 < HGT_NR;
    hgt_warp_project(x, HGT_NP, HGT_NR, mu, lane);
    lam0 = x[lane];
    lam1 = v1 ? x[lane + 32] : 0.0f;
    float y0 = lam0, y1 = lam1;
    y[lane] = y0;
    if (v1) y[lane + 32] = y1;
    __syncwarp();

    float theta = 1.0f;
    for (int it = 0; it < iterations; ++it) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f}, q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < HGT_NR / 4; ++c) {
            float4 f = reinterpret_cast<const float4*>(y)[c];
            p[0] += a0[4 * c] * f.x; p[1] += a0[4 * c + 1] * f.y;
            p[2] += a0[4 * c + 2] * f.z; p[3] += a0[4 * c + 3] * f.w;
            q[0] += a1[4 * c] * f.x; q[1] += a1[4 * c + 1] * f.y;
            q[2] += a1[4 * c + 2] * f.z; q[3] += a1[4 * c + 3] * f.w;
        }
        float g0 = (p[0] + p[1]) + (p[2] + p[3]) + rr0;
        float g1 = v1 ? (q[0] + q[1]) + (q[2] + q[3]) + rr1 : 0.0f;
        x[lane] = y0 - step * g0;
        if (v1) x[lane + 32] = y1 - step * g1;
        __syncwarp();
        hgt_warp_project(x, HGT_NP, HGT_NR, mu, lane);
        float ln0 = x[lane], ln1 = v1 ? x[lane + 32] : 0.0f;
        float d0 = ln0 - lam0, d1 = ln1 - lam1;
        float gd = hgt_warp_sum(g0 * d0 + g1 * d1);
        bool restart = gd > 0.0f;
        if (restart) theta = 1.0f;
        float theta_new = 0.5f * (theta * sqrtf(theta * theta + 4.0f) - theta * theta);
        float beta = restart ? 0.0f : theta * (1.0f - theta) / (theta * theta + theta_new);
        y0 = ln0 + beta * d0;
        y1 = ln1 + beta * d1;
        // every lane passed the projection's synchronisation after its last read of y
        y[lane] = y0;
        if (v1) y[lane + 32] = y1;
        lam0 = ln0;
        lam1 = ln1;
        theta = theta_new;
        __syncwarp();  // y complete; every lane is past its reads of x
    }
}
