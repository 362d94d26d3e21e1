// The two dense contact-solve kernels of the per-substep physics path.
//
//   hgt_apgd_kernel         replaces humanoid_gym_tpu/physics/pallas_solver.py
//                           `_apgd_kernel` (solver "apgd_pallas"): APGD on a
//                           prebuilt Delassus matrix.
//   hgt_fused_dense_kernel  replaces `_fused_kernel` -> `_fused_core` of the
//                           same file (solver "fused_pallas"): Cholesky of
//                           Mtilde, v_free, B = L^-1 J^T, the DENSE Delassus
//                           A = B^T B + CFM, the Gram-norm step bound, APGD,
//                           qvel_new = v_free + L^-T (B lam), all in the
//                           EXTERNAL DOF order [base, left leg, right leg].
//
// Both read the env-major float32 tensors the substep builds, (N,60,60),
// (N,60,18), (N,18,18), ..., with no marshalling pass; nrow and n_points are
// arguments (60 = 48 + 12 and 16 for XBot-L; nrow <= 64, nv = 18).
//
// What bounds them on the H100: the APGD kernel moves ~15 KB per env and does
// ~60 k operations on it, so its floor is memory bandwidth; the fused kernel
// moves ~7 KB and does ~250 k operations, so its floor is the float32 rate.
// Both sit well above their floors because the work per env is a chain of
// dependent small steps. The design: one warp per env, the env's matrices in
// that warp's shared memory (the Delassus matrix is read `iterations` times
// and never goes back to device memory), coalesced loads, lanes over rows for
// every matvec, lanes over columns for the triangular solve of J^T, shuffles
// for the serial substitutions and reductions. Four warps share a block, so a
// block needs 58 KB / 86 KB of dynamic shared memory.

#include <cuda_runtime.h>

#include "apgd.cuh"

#define DS_WARPS 4   // envs per block
#define DS_NV 18     // generalized velocities
#define DS_LS 19     // row stride of the Cholesky factor in shared memory

// Shared floats of one warp.
__host__ __device__ inline int hgt_apgd_warp_floats(int nrow) {
    return nrow * (nrow | 1) + 3 * HGT_MAX_ROWS;  // A, y, x, sign
}

__host__ __device__ inline int hgt_dense_warp_floats(int nrow) {
    // A, B (18 rows), L, v_free, y, x, sign
    return nrow * (nrow | 1) + DS_NV * (nrow | 1) + DS_NV * DS_LS + 32 + 3 * HGT_MAX_ROWS;
}

__global__ void __launch_bounds__(DS_WARPS * 32)
hgt_apgd_kernel(const float* __restrict__ A, const float* __restrict__ u0,
                const float* __restrict__ lo, const float* __restrict__ lsign,
                const float* __restrict__ lbound, const float* __restrict__ mu,
                const float* __restrict__ step_bound, const float* __restrict__ lam_in,
                float* __restrict__ lam_out, int n, int nrow, int n_points, int iterations) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * DS_WARPS + warp;
    if (e >= n) return;  // whole warps leave; the kernel has no block-wide barrier
    const int as = nrow | 1, nc3 = 3 * n_points, nlim = nrow - nc3;
    float* As = smem + warp * hgt_apgd_warp_floats(nrow);
    float* y = As + nrow * as;
    float* x = y + HGT_MAX_ROWS;
    float* s = x + HGT_MAX_ROWS;

    for (int r = lane; r < nrow; r += 32)
        s[r] = r < nc3 ? 1.0f : lsign[(size_t)e * nlim + r - nc3];
    __syncwarp();

    // A' = s s^T o A, coalesced from device memory into the padded rows
    const float* Ae = A + (size_t)e * nrow * nrow;
    for (int idx = lane; idx < nrow * nrow; idx += 32) {
        int r = idx / nrow, c = idx - r * nrow;
        As[r * as + c] = Ae[idx] * s[r] * s[c];
    }

    const int r0 = lane, r1 = lane + 32;
    const bool v0 = r0 < nrow, v1 = r1 < nrow;
    const float* lo_e = lo + (size_t)e * n_points;
    const float* lb_e = lbound + (size_t)e * nlim;
    const float* u_e = u0 + (size_t)e * nrow;
    const float* l_e = lam_in + (size_t)e * nrow;
    float rr0 = 0.0f, rr1 = 0.0f;
    if (v0) {
        rr0 = s[r0] * u_e[r0] - hgt_row_target(r0, n_points, lo_e, lb_e);
        x[r0] = s[r0] * l_e[r0];
    }
    if (v1) {
        rr1 = s[r1] * u_e[r1] - hgt_row_target(r1, n_points, lo_e, lb_e);
        x[r1] = s[r1] * l_e[r1];
    }
    __syncwarp();

    float bound;
    if (step_bound != nullptr) {
        bound = step_bound[e];
    } else {  // ||A'||_inf
        float s0 = 0.0f, s1 = 0.0f;
        if (v0) for (int c = 0; c < nrow; ++c) s0 += fabsf(As[r0 * as + c]);
        if (v1) for (int c = 0; c < nrow; ++c) s1 += fabsf(As[r1 * as + c]);
        bound = hgt_warp_max(fmaxf(s0, s1));
    }
    float step = 1.0f / fmaxf(bound, 1e-6f);

    float lam0, lam1;
    hgt_warp_apgd(As, as, y, x, rr0, rr1, step, mu[e], nrow, n_points, iterations, lane,
                  lam0, lam1);
    if (v0) lam_out[(size_t)e * nrow + r0] = lam0 * s[r0];
    if (v1) lam_out[(size_t)e * nrow + r1] = lam1 * s[r1];
}

__global__ void __launch_bounds__(DS_WARPS * 32)
hgt_fused_dense_kernel(const float* __restrict__ Mt, const float* __restrict__ J,
                       const float* __restrict__ qvel, const float* __restrict__ rhs,
                       const float* __restrict__ lo, const float* __restrict__ lsign,
                       const float* __restrict__ lbound, const float* __restrict__ mu,
                       const float* __restrict__ comp, const float* __restrict__ lam_in,
                       float* __restrict__ qvel_out, float* __restrict__ lam_out,
                       int n, int nrow, int n_points, int iterations) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * DS_WARPS + warp;
    if (e >= n) return;  // whole warps leave; the kernel has no block-wide barrier
    const int as = nrow | 1, nc3 = 3 * n_points, nlim = nrow - nc3;
    float* As = smem + warp * hgt_dense_warp_floats(nrow);
    float* Bs = As + nrow * as;        // B[v][r] at Bs[v * as + r]
    float* Ls = Bs + DS_NV * as;       // L[i][k] at Ls[i * DS_LS + k]
    float* vf = Ls + DS_NV * DS_LS;
    float* y = vf + 32;
    float* x = y + HGT_MAX_ROWS;
    float* s = x + HGT_MAX_ROWS;

    // ---- loads: Mtilde, J^T (transposed on the way in), signs ----
    const float* Me = Mt + (size_t)e * DS_NV * DS_NV;
    for (int idx = lane; idx < DS_NV * DS_NV; idx += 32) {
        int i = idx / DS_NV, k = idx - i * DS_NV;
        Ls[i * DS_LS + k] = Me[idx];
    }
    const float* Je = J + (size_t)e * nrow * DS_NV;
    for (int idx = lane; idx < nrow * DS_NV; idx += 32) {
        int r = idx / DS_NV, v = idx - r * DS_NV;
        Bs[v * as + r] = Je[idx];
    }
    for (int r = lane; r < nrow; r += 32)
        s[r] = r < nc3 ? 1.0f : lsign[(size_t)e * nlim + r - nc3];
    __syncwarp();

    // ---- right-looking Cholesky, lane i on row i ----
    for (int k = 0; k < DS_NV; ++k) {
        float d = sqrtf(fmaxf(Ls[k * DS_LS + k], 1e-12f));
        __syncwarp();
        if (lane == k) Ls[k * DS_LS + k] = d;
        else if (lane > k && lane < DS_NV) Ls[lane * DS_LS + k] = Ls[lane * DS_LS + k] / d;
        __syncwarp();
        if (lane > k && lane < DS_NV) {
            float lik = Ls[lane * DS_LS + k];
            for (int j = k + 1; j <= lane; ++j)
                Ls[lane * DS_LS + j] = Ls[lane * DS_LS + j] - lik * Ls[j * DS_LS + k];
        }
        __syncwarp();
    }

    // ---- v_free = qvel + L^-T L^-1 rhs, lane i holds entry i ----
    float xi = lane < DS_NV ? rhs[(size_t)e * DS_NV + lane] : 0.0f;
    for (int k = 0; k < DS_NV; ++k) {
        float xk = __shfl_sync(HGT_FULL_MASK, xi, k) / Ls[k * DS_LS + k];
        if (lane == k) xi = xk;
        else if (lane > k && lane < DS_NV) xi = xi - Ls[lane * DS_LS + k] * xk;
    }
    for (int k = DS_NV - 1; k >= 0; --k) {
        float xk = __shfl_sync(HGT_FULL_MASK, xi, k) / Ls[k * DS_LS + k];
        if (lane == k) xi = xk;
        else if (lane < k) xi = xi - Ls[k * DS_LS + lane] * xk;
    }
    const float vfi = lane < DS_NV ? qvel[(size_t)e * DS_NV + lane] + xi : 0.0f;
    if (lane < DS_NV) vf[lane] = vfi;
    __syncwarp();

    // ---- this lane's two constraint rows = two columns of J^T ----
    const int r0 = lane, r1 = lane + 32;
    const bool v0 = r0 < nrow, v1 = r1 < nrow;
    const int c0 = v0 ? r0 : 0, c1 = v1 ? r1 : c0;
    float b0[DS_NV], b1[DS_NV];
#pragma unroll
    for (int v = 0; v < DS_NV; ++v) {
        b0[v] = v0 ? Bs[v * as + c0] : 0.0f;
        b1[v] = v1 ? Bs[v * as + c1] : 0.0f;
    }
    const float s0 = s[c0], s1 = s[c1];

    // r = sign * (J v_free) - target
    float u0 = 0.0f, u1 = 0.0f;
#pragma unroll
    for (int v = 0; v < DS_NV; ++v) {
        u0 = u0 + b0[v] * vf[v];
        u1 = u1 + b1[v] * vf[v];
    }
    const float* lo_e = lo + (size_t)e * n_points;
    const float* lb_e = lbound + (size_t)e * nlim;
    const float rr0 = v0 ? u0 * s0 - hgt_row_target(r0, n_points, lo_e, lb_e) : 0.0f;
    const float rr1 = v1 ? u1 * s1 - hgt_row_target(r1, n_points, lo_e, lb_e) : 0.0f;

    // B = L^-1 J^T by forward substitution down each column, sign-folded
#pragma unroll
    for (int k = 0; k < DS_NV; ++k) {
        float lkk = Ls[k * DS_LS + k];
        b0[k] = b0[k] / lkk;
        b1[k] = b1[k] / lkk;
#pragma unroll
        for (int i = k + 1; i < DS_NV; ++i) {
            float lik = Ls[i * DS_LS + k];
            b0[i] = b0[i] - lik * b0[k];
            b1[i] = b1[i] - lik * b1[k];
        }
    }
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int v = 0; v < DS_NV; ++v) {
        b0[v] = b0[v] * s0;
        b1[v] = b1[v] * s1;
        d0 = d0 + b0[v] * b0[v];
        d1 = d1 + b1[v] * b1[v];
        if (v0) Bs[v * as + r0] = b0[v];
        if (v1) Bs[v * as + r1] = b1[v];
    }
    __syncwarp();

    // ---- dense Delassus A = B^T B + reg I, reg = comp * trace(A) / nrow ----
    const float reg = comp[e] * hgt_warp_sum(d0 + d1) / (float)nrow;
    for (int c = 0; c < nrow; ++c) {
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int v = 0; v < DS_NV; ++v) {
            float bc = Bs[v * as + c];
            a0 = a0 + b0[v] * bc;
            a1 = a1 + b1[v] * bc;
        }
        if (v0) As[r0 * as + c] = (c == r0) ? a0 + reg : a0;
        if (v1) As[r1 * as + c] = (c == r1) ? a1 + reg : a1;
    }

    // ---- step bound ||B B^T||_inf + reg, lane v on row v of the Gram ----
    float rowsum = 0.0f;
    if (lane < DS_NV) {
        for (int w = 0; w < DS_NV; ++w) {
            float g = 0.0f;
            for (int r = 0; r < nrow; ++r) g = g + Bs[lane * as + r] * Bs[w * as + r];
            rowsum += fabsf(g);
        }
    }
    const float step = 1.0f / fmaxf(hgt_warp_max(rowsum) + reg, 1e-6f);

    // ---- warm start (physical signs -> solver signs) and APGD ----
    const float* l_e = lam_in + (size_t)e * nrow;
    if (v0) x[r0] = s0 * l_e[r0];
    if (v1) x[r1] = s1 * l_e[r1];
    __syncwarp();
    float lam0, lam1;
    hgt_warp_apgd(As, as, y, x, rr0, rr1, step, mu[e], nrow, n_points, iterations, lane,
                  lam0, lam1);

    // ---- qvel_new = v_free + L^-T (B lam) ----
    if (v0) x[r0] = lam0;
    if (v1) x[r1] = lam1;
    __syncwarp();
    float yi = 0.0f;
    if (lane < DS_NV)
        for (int r = 0; r < nrow; ++r) yi = yi + Bs[lane * as + r] * x[r];
    for (int k = DS_NV - 1; k >= 0; --k) {
        float xk = __shfl_sync(HGT_FULL_MASK, yi, k) / Ls[k * DS_LS + k];
        if (lane == k) yi = xk;
        else if (lane < k) yi = yi - Ls[k * DS_LS + lane] * xk;
    }
    if (lane < DS_NV) qvel_out[(size_t)e * DS_NV + lane] = vfi + yi;
    if (v0) lam_out[(size_t)e * nrow + r0] = lam0 * s0;
    if (v1) lam_out[(size_t)e * nrow + r1] = lam1 * s1;
}

// Raise the kernel's dynamic shared memory limit once per size.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
    if (bytes <= *allowed) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) *allowed = bytes;
    return err;
}

static bool bad_rows(int nrow, int n_points) {
    return nrow < 1 || nrow > HGT_MAX_ROWS || n_points < 0 || 3 * n_points > nrow;
}

extern "C" {

int hgt_dense_nv(void) { return DS_NV; }

// step_bound may be null: the kernel then uses ||A'||_inf.
int hgt_apgd(const float* A, const float* u0, const float* lo, const float* lsign,
             const float* lbound, const float* mu, const float* step_bound,
             const float* lam_in, float* lam_out, int n, int nrow, int n_points,
             int iterations, void* stream) {
    if (n <= 0) return 0;
    if (bad_rows(nrow, n_points)) return (int)cudaErrorInvalidValue;
    static size_t allowed = 0;
    size_t bytes = sizeof(float) * DS_WARPS * hgt_apgd_warp_floats(nrow);
    cudaError_t err = allow_smem(hgt_apgd_kernel, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    int grid = (n + DS_WARPS - 1) / DS_WARPS;
    hgt_apgd_kernel<<<grid, DS_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        A, u0, lo, lsign, lbound, mu, step_bound, lam_in, lam_out, n, nrow, n_points,
        iterations);
    return (int)cudaGetLastError();
}

int hgt_fused_dense(const float* Mt, const float* J, const float* qvel, const float* rhs,
                    const float* lo, const float* lsign, const float* lbound,
                    const float* mu, const float* comp, const float* lam_in,
                    float* qvel_out, float* lam_out, int n, int nrow, int n_points,
                    int iterations, void* stream) {
    if (n <= 0) return 0;
    if (bad_rows(nrow, n_points)) return (int)cudaErrorInvalidValue;
    static size_t allowed = 0;
    size_t bytes = sizeof(float) * DS_WARPS * hgt_dense_warp_floats(nrow);
    cudaError_t err = allow_smem(hgt_fused_dense_kernel, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    int grid = (n + DS_WARPS - 1) / DS_WARPS;
    hgt_fused_dense_kernel<<<grid, DS_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        Mt, J, qvel, rhs, lo, lsign, lbound, mu, comp, lam_in, qvel_out, lam_out, n, nrow,
        n_points, iterations);
    return (int)cudaGetLastError();
}

}  // extern "C"
