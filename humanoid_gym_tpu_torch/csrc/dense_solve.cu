// The two dense contact-solve kernels of the per-substep physics path.
//
//   hgt_apgd_kernel         replaces humanoid_gym_tpu/physics/pallas_solver.py
//                           `_apgd_kernel` (solver "apgd_pallas"): APGD on a
//                           prebuilt Delassus matrix, with the sign folding,
//                           r and the step that its front end does around it.
//   hgt_fused_dense_kernel  replaces `_fused_kernel` -> `_fused_core` of the
//                           same file (solver "fused_pallas"): Cholesky of
//                           Mtilde, v_free, B = L^-1 J^T, the DENSE Delassus
//                           A = B^T B + CFM, the Gram-norm step bound, APGD,
//                           qvel_new = v_free + L^-T (B lam), all in the
//                           EXTERNAL DOF order [base, left leg, right leg].
//
// Both read the env-major float32 tensors the substep builds, (N,60,60),
// (N,60,18), (N,18,18), ..., with no marshalling pass. The problem shape is a
// compile-time size (HGT_NV 18, HGT_NR 60, HGT_NP 16 of apgd.cuh, the only
// shape a model of the package builds): the Delassus rows live in register
// arrays, which a run-time row count cannot index. The wrappers raise on any
// other shape. One warp works on one env; lane l owns constraint rows l and
// l + 32 (the second exists for l < 28). Rows 0..31 are contact rows, so the
// first row's sign is 1.
//
// ---- hgt_apgd_kernel: bound by bytes ----
// It moves 15,288 B per env and does ~72 k operations on them, so the least
// time is the matrix's 14,400 B over the memory rate. The design moves those
// bytes once and keeps them in registers:
//   - persistent warps: the grid is (SM count) x DS_MIN_BLOCKS blocks of
//     DS_WARPS warps, each warp walks envs w, w + W, ...;
//   - the matrix comes in by ONE bulk asynchronous copy per env
//     (bulk_copy.cuh), issued by lane 0, landing in the warp's stage in its
//     raw layout. A row stride of 60 floats needs no padding for 16-byte
//     reads: the eight lanes of a quarter-warp on eight successive rows start
//     at banks 0, 28, 24, 20, 16, 12, 8, 4 and cover all 32;
//   - lane l moves rows l and l + 32 to 2 x 60 registers with 30 sixteen-byte
//     reads and folds the signs there; as soon as the registers hold env e,
//     lane 0 issues the copy for env e + W, which flies during e's loop;
//   - the loop is hgt_warp_apgd of apgd.cuh (the matrix in registers, only y
//     and x in shared memory); without a caller's step bound, ||A'||_inf comes
//     from the registers.
// Shared memory of a warp: stage 3600 floats, y, x, signs 64 each = 15,168 B;
// a block of DS_WARPS = 4 takes 4 x 15,168 + 32 B of barriers = 60,704 B.
// Residency: __launch_bounds__(128, 3) caps the registers at 168 a thread, so
// three blocks = 12 warps per SM with 182 KB of stages, 1,584 envs of 4096 in
// flight on 132 SMs.
//
// ---- hgt_fused_dense_kernel: bound by operations ----
// ~180 k operations on 6,480 B per env, as a chain of small dependent steps;
// what limits it is instruction issue. The design executes fewer
// instructions and keeps 12 warps per SM to issue them:
//   loads        lane i < 18 reads row i of Mtilde, every lane its two rows of
//                J, as 8-byte loads straight into registers (an env's Mtilde
//                and J are 1,296 and 4,320 contiguous bytes; a row of 18
//                floats is aligned to 8 bytes);
//   Cholesky     hgt_warp_cholesky<HgtNoZeros> of apgd.cuh: row i in lane i's
//                registers, pivots by shuffle, all 171 entries (in the
//                external order the base comes first and the factor fills
//                in); the substitutions and the column solve B = L^-1 J^T are
//                the shared templates too;
//   Gram bound   the 171 pairs v <= w of B B^T from the column registers in 10
//                batches through hgt_warp_reduce18, |G| scattered to an
//                18 x 19 scratch that lies where B is stored afterwards; the
//                pairs' (row, column) table is built by the compiler and lies
//                in device memory (hgt_pair_table), so a block has no set-up;
//   A = B^T B    B goes to shared memory column by column (60 x 20 floats, so
//                column c is five 16-byte broadcast reads) and the dense
//                Delassus matrix is built STRAIGHT INTO the lane's row
//                registers a0[c], a1[c], regularizer on the diagonal, in one
//                pass over the columns; A never lies in shared memory;
//   loop         hgt_warp_apgd, as above;
//   B lam        the lane's columns are read back from shared memory (the
//                stride of 20 floats is conflict-free for 16-byte reads), so
//                they hold no registers during the loop.
// Shared memory of a warp: B 1200 floats, L 18 x 19, 1/diag, t, y, x =
// 1,712 floats = 6,848 B; a block of 4 takes 27,392 B.
// Residency: 168 registers, three blocks = 12 warps per SM.
//
// ---- measured (NVIDIA H100 80GB HBM3, 700.00 W; 4096 envs, 8 iterations;
// CUDA events around 20-50 launches queued behind a spin kernel; chip_smoke.py
// phases 6 and 7, and scripts/time_dense_variants_torch.py for what was
// dropped, every design in one run on one card) ----
// hgt_apgd_kernel 0.0355 ms a launch (0.0956 with the matrix in shared memory
// behind an odd stride, four bytes a read); 0.0252 ms with 0 iterations, so
// load and set-up are 70% and the loop 30%. ptxas: 167 registers, no stack.
// hgt_fused_dense_kernel 0.0685-0.0694 ms (0.2187 before); 0.0489-0.0495 ms
// with 0 iterations (load, factorisation, Gram bound and the A build are 71%).
// ptxas: 168 registers, 48 B of stack and spills.
// Tried and dropped (shipped: 0.0355-0.0358 and 0.0694 in that run):
//   - hgt_apgd_kernel with no stage, each lane reading its two rows straight
//     from device memory 16 bytes a load: 0.0467-0.0469 ms at the same shared
//     memory, 0.0447 ms with only y, x and the signs there. The bulk copy wins
//     because the next env's matrix flies during the loop and no load
//     instruction waits on device memory;
//   - block shapes at 12 warps per SM: 2 warps x 6 blocks 0.0364 (APGD) and
//     0.0731 (fused); 6 warps x 2 blocks 0.0377-0.0379 and 0.0805-0.0807.
//     8 warps per SM with no register cap to speak of (179 / 225 registers, no
//     spills): 0.0368 and 0.0757: the warps are worth more than the spills;
//   - the fused kernel with persistent warps like the APGD kernel: 0.0811
//     (164 B of spills; its operands are too small to gain from a copy in
//     flight, and a fixed share of envs per warp ends ragged);
//   - the pair table filled into shared memory by every block at run time (a
//     loop per thread, then a block-wide barrier), as solve.cuh does once per
//     16 envs x 10 substeps: 0.0906; with four envs a block that set-up was a
//     quarter of the kernel;
//   - the A build row by row in two passes over the columns (one column of B
//     live instead of two, B read twice): 0.0706-0.0711, 128 B of spills;
//   - four partial sums per entry of A instead of two: 0.0704-0.0708, 96 B.

#include <cuda_runtime.h>

#include "apgd.cuh"
#include "bulk_copy.cuh"

#define DS_WARPS 4        // warps (envs in flight) per block
#define DS_MIN_BLOCKS 3   // resident blocks per SM both kernels are compiled for
#define DS_A_FLOATS 3600  // HGT_NR x HGT_NR: one env's matrix, 14,400 B, one bulk copy

// per-warp shared memory of hgt_apgd_kernel (float offsets, all 16-byte aligned)
#define AP_SM_STAGE 0     // the matrix as it lies in device memory, 60 x 60
#define AP_SM_Y 3600      // 64
#define AP_SM_X 3664      // 64
#define AP_SM_S 3728      // row signs, 64
#define AP_WARP_FLOATS 3792
#define AP_HEAD_FLOATS 8  // per block: DS_WARPS mbarriers of 8 bytes

// per-warp shared memory of hgt_fused_dense_kernel
#define FD_SM_B 0         // 60 x 20: row r is column r of B (18 + 2 zeros); before that the Gram scratch
#define FD_SM_L 1200      // 18 x 19 (HGT_LS), padded to 344
#define FD_SM_DINV 1544   // 1 / L[k][k], 18 padded to 20
#define FD_SM_T 1564      // v_free, then B lam; 18 padded to 20
#define FD_SM_Y 1584      // 64
#define FD_SM_X 1648      // 64
#define FD_WARP_FLOATS 1712
#define FD_BS 20          // row stride of B in shared memory

static_assert(HGT_NC >= 32 && HGT_NR <= HGT_MAX_ROWS, "rows 0..31 are contact rows");
static_assert(DS_A_FLOATS == HGT_NR * HGT_NR && (DS_A_FLOATS * 4) % 16 == 0, "bulk copy size");
static_assert(AP_HEAD_FLOATS * 4 >= DS_WARPS * 8 && AP_HEAD_FLOATS % 4 == 0, "barriers");
static_assert(HGT_NV * HGT_LS <= FD_SM_L - FD_SM_B, "Gram scratch inside the B region");

// An 18-entry column of B or J^T against 20 shared floats (18 + 2 pads) on a
// 16-byte boundary, read as five 16-byte loads; two partial sums.
__device__ __forceinline__ float hgt_dot18(const float (&b)[HGT_NV], const float* v) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 f = v4[q];
        acc0 += b[4 * q] * f.x;
        acc1 += b[4 * q + 1] * f.y;
        acc0 += b[4 * q + 2] * f.z;
        acc1 += b[4 * q + 3] * f.w;
    }
    const float4 f = v4[4];
    acc0 += b[16] * f.x;
    acc1 += b[17] * f.y;
    return acc0 + acc1;
}

// The column to its 20 shared floats and back.
__device__ __forceinline__ void hgt_store18(float* v, const float (&b)[HGT_NV]) {
    float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        v4[q] = make_float4(b[4 * q], b[4 * q + 1], b[4 * q + 2], b[4 * q + 3]);
    v4[4] = make_float4(b[16], b[17], 0.0f, 0.0f);
}

__device__ __forceinline__ void hgt_load18(float (&b)[HGT_NV], const float* v) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 f = v4[q];
        b[4 * q] = f.x; b[4 * q + 1] = f.y; b[4 * q + 2] = f.z; b[4 * q + 3] = f.w;
    }
    const float4 f = v4[4];
    b[16] = f.x; b[17] = f.y;
}

__global__ void __launch_bounds__(DS_WARPS * 32, DS_MIN_BLOCKS)
hgt_apgd_kernel(const float* __restrict__ A, const float* __restrict__ u0,
                const float* __restrict__ lo, const float* __restrict__ lsign,
                const float* __restrict__ lbound, const float* __restrict__ mu,
                const float* __restrict__ step_bound, const float* __restrict__ lam_in,
                float* __restrict__ lam_out, int n, int iterations) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = gridDim.x * DS_WARPS;
    int e = blockIdx.x * DS_WARPS + warp;
    if (e >= n) return;  // whole warps leave; the kernel has no block-wide barrier
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
    float* sm = smem + AP_HEAD_FLOATS + warp * AP_WARP_FLOATS;
    float* stage = sm + AP_SM_STAGE;
    float* y = sm + AP_SM_Y;
    float* x = sm + AP_SM_X;
    float* s = sm + AP_SM_S;
    constexpr int nlim = HGT_NR - HGT_NC;
    const int r0 = lane, r1 = lane + 32;
    const bool v1 = r1 < HGT_NR;

    if (lane == 0) {
        hgt_mbarrier_init(bar);
        hgt_bulk_copy(stage, A + (size_t)e * DS_A_FLOATS, DS_A_FLOATS * 4, bar);
    }
    __syncwarp();

    uint32_t parity = 0;
    for (; e < n; e += stride) {
        // the small operands, in flight while the matrix lands
        const float* lo_e = lo + (size_t)e * HGT_NP;
        const float* lb_e = lbound + (size_t)e * nlim;
        const float s1 = (v1 && r1 >= HGT_NC) ? lsign[(size_t)e * nlim + r1 - HGT_NC] : 1.0f;
        const float tg0 = hgt_row_target(r0, HGT_NP, lo_e, lb_e);
        const float tg1 = v1 ? hgt_row_target(r1, HGT_NP, lo_e, lb_e) : 0.0f;
        const float u_0 = u0[(size_t)e * HGT_NR + r0];
        const float u_1 = v1 ? u0[(size_t)e * HGT_NR + r1] : 0.0f;
        const float w0 = lam_in[(size_t)e * HGT_NR + r0];
        const float w1 = v1 ? lam_in[(size_t)e * HGT_NR + r1] : 0.0f;
        const float mu_e = mu[e];
        float bound = step_bound != nullptr ? step_bound[e] : 0.0f;
        const float rr0 = u_0 - tg0;
        const float rr1 = v1 ? s1 * u_1 - tg1 : 0.0f;
        s[r0] = 1.0f;
        s[r1] = s1;
        x[r0] = w0;
        x[r1] = s1 * w1;
        __syncwarp();

        // A' = s s^T o A: this lane's two rows from the stage into registers
        hgt_mbarrier_wait(bar, parity);
        parity ^= 1u;
        float a0[HGT_NR], a1[HGT_NR];
        const float4* row0 = reinterpret_cast<const float4*>(stage + r0 * HGT_NR);
        const float4* row1 = reinterpret_cast<const float4*>(stage + (v1 ? r1 : r0) * HGT_NR);
        const float k1 = v1 ? s1 : 0.0f;  // a lane without a second row holds zeros
#pragma unroll
        for (int q = 0; q < HGT_NR / 4; ++q) {
            const float4 f = row0[q], g = row1[q], sc = reinterpret_cast<const float4*>(s)[q];
            a0[4 * q] = f.x * sc.x; a0[4 * q + 1] = f.y * sc.y;
            a0[4 * q + 2] = f.z * sc.z; a0[4 * q + 3] = f.w * sc.w;
            a1[4 * q] = g.x * (k1 * sc.x); a1[4 * q + 1] = g.y * (k1 * sc.y);
            a1[4 * q + 2] = g.z * (k1 * sc.z); a1[4 * q + 3] = g.w * (k1 * sc.w);
        }
        __syncwarp();  // every lane has left the stage
        if (lane == 0 && e + stride < n)
            hgt_bulk_copy(stage, A + (size_t)(e + stride) * DS_A_FLOATS, DS_A_FLOATS * 4, bar);

        if (step_bound == nullptr) {  // ||A'||_inf
            float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
            for (int c = 0; c < HGT_NR; ++c) {
                t0 += fabsf(a0[c]);
                t1 += fabsf(a1[c]);
            }
            bound = hgt_warp_max(fmaxf(t0, t1));
        }
        const float step = 1.0f / fmaxf(bound, 1e-6f);

        float lam0, lam1;
        hgt_warp_apgd(a0, a1, y, x, rr0, rr1, step, mu_e, iterations, lane, lam0, lam1);
        lam_out[(size_t)e * HGT_NR + r0] = lam0;
        if (v1) lam_out[(size_t)e * HGT_NR + r1] = lam1 * s1;
    }
}

__global__ void __launch_bounds__(DS_WARPS * 32, DS_MIN_BLOCKS)
hgt_fused_dense_kernel(const float* __restrict__ Mt, const float* __restrict__ J,
                       const float* __restrict__ qvel, const float* __restrict__ rhs,
                       const float* __restrict__ lo, const float* __restrict__ lsign,
                       const float* __restrict__ lbound, const float* __restrict__ mu,
                       const float* __restrict__ comp, const float* __restrict__ lam_in,
                       float* __restrict__ qvel_out, float* __restrict__ lam_out,
                       int n, int iterations) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * DS_WARPS + warp;
    if (e >= n) return;  // whole warps leave; the kernel has no block-wide barrier
    float* sm = smem + warp * FD_WARP_FLOATS;
    float* Bs = sm + FD_SM_B;
    float* Ms = sm + FD_SM_L;
    float* dinv = sm + FD_SM_DINV;
    float* tv = sm + FD_SM_T;
    float* y = sm + FD_SM_Y;
    float* x = sm + FD_SM_X;
    constexpr int nlim = HGT_NR - HGT_NC;
    const int r0 = lane, r1 = lane + 32;
    const bool dof = lane < HGT_NV, v1 = r1 < HGT_NR;
    const int slot = hgt_reduce18_slot(lane);

    // ---- loads: row `lane` of Mtilde, this lane's two rows of J, the vectors ----
    float Lr[HGT_NV], b0[HGT_NV], b1[HGT_NV];
    const float2* mrow = reinterpret_cast<const float2*>(
        Mt + (size_t)e * HGT_NV * HGT_NV + (dof ? lane : 0) * HGT_NV);
    const float* Je = J + (size_t)e * HGT_NR * HGT_NV;
    const float2* jrow0 = reinterpret_cast<const float2*>(Je + r0 * HGT_NV);
    const float2* jrow1 = reinterpret_cast<const float2*>(Je + (v1 ? r1 : r0) * HGT_NV);
#pragma unroll
    for (int q = 0; q < HGT_NV / 2; ++q) {
        const float2 m = mrow[q], j0 = jrow0[q], j1 = jrow1[q];
        Lr[2 * q] = (dof && 2 * q <= lane) ? m.x : 0.0f;
        Lr[2 * q + 1] = (dof && 2 * q + 1 <= lane) ? m.y : 0.0f;
        b0[2 * q] = j0.x; b0[2 * q + 1] = j0.y;
        b1[2 * q] = v1 ? j1.x : 0.0f; b1[2 * q + 1] = v1 ? j1.y : 0.0f;
    }
    const float* lo_e = lo + (size_t)e * HGT_NP;
    const float* lb_e = lbound + (size_t)e * nlim;
    const float s1 = (v1 && r1 >= HGT_NC) ? lsign[(size_t)e * nlim + r1 - HGT_NC] : 1.0f;
    const float tg0 = hgt_row_target(r0, HGT_NP, lo_e, lb_e);
    const float tg1 = v1 ? hgt_row_target(r1, HGT_NP, lo_e, lb_e) : 0.0f;
    const float rhs_i = dof ? rhs[(size_t)e * HGT_NV + lane] : 0.0f;
    const float qvel_i = dof ? qvel[(size_t)e * HGT_NV + lane] : 0.0f;
    const float w0 = lam_in[(size_t)e * HGT_NR + r0];
    const float w1 = v1 ? lam_in[(size_t)e * HGT_NR + r1] : 0.0f;
    const float mu_e = mu[e], comp_e = comp[e];

    // ---- Cholesky in registers; L to shared memory for the column reads ----
    hgt_warp_cholesky<HgtNoZeros>(Lr, dinv, lane);
    if (dof) {
#pragma unroll
        for (int j = 0; j < HGT_NV; ++j) Ms[lane * HGT_LS + j] = Lr[j];
    }
    if (lane >= HGT_NV && lane < 20) tv[lane] = 0.0f;  // the float4 reads of t cover 20
    __syncwarp();

    // ---- v_free = qvel + L^-T L^-1 rhs, lane i holds entry i ----
    float xi = hgt_warp_forward_sub(rhs_i, Lr, dinv, lane);
    xi = hgt_warp_backward_sub(xi, Ms, dinv, lane);
    const float vfi = dof ? qvel_i + xi : 0.0f;
    if (dof) tv[lane] = vfi;
    __syncwarp();

    // ---- r = sign * (J v_free) - target ----
    const float u_0 = hgt_dot18(b0, tv), u_1 = hgt_dot18(b1, tv);
    const float rr0 = u_0 - tg0;
    const float rr1 = v1 ? u_1 * s1 - tg1 : 0.0f;

    // ---- B = L^-1 J^T down each column, sign-folded; reg = comp * trace / rows ----
    const float diag = hgt_solve_columns<HgtNoZeros>(b0, b1, Ms, dinv, 1.0f, s1);
    const float reg = comp_e * hgt_warp_sum(diag) / (float)HGT_NR;

    // ---- step bound ||B B^T||_inf + reg; the scratch lies in the B region ----
    for (int idx = lane; idx < HGT_NV * HGT_LS; idx += 32) Bs[idx] = 0.0f;
    __syncwarp();
    hgt_gram_batches<HgtNoZeros, 0>(Bs, hgt_pair_table<HgtNoZeros>.rc, b0, b1, lane, slot);
    __syncwarp();
    float rowsum = 0.0f;
    if (dof) {
#pragma unroll
        for (int w = 0; w < HGT_NV; ++w) rowsum += Bs[lane * HGT_LS + w];
    }
    const float step = 1.0f / fmaxf(hgt_warp_max(rowsum) + reg, 1e-6f);
    __syncwarp();  // every lane has read its row of the scratch

    // ---- B to shared memory, column r at Bs[r * FD_BS]; the warm start ----
    float* col0 = Bs + r0 * FD_BS;
    float* col1 = Bs + (v1 ? r1 : r0) * FD_BS;
    hgt_store18(col0, b0);
    if (v1) hgt_store18(col1, b1);
    x[r0] = w0;
    x[r1] = s1 * w1;
    __syncwarp();

    // ---- dense Delassus A = B^T B + reg I, straight into the row registers ----
    float a0[HGT_NR], a1[HGT_NR];
#pragma unroll
    for (int c = 0; c < HGT_NR; ++c) {
        a0[c] = hgt_dot18(b0, Bs + c * FD_BS) + (c == r0 ? reg : 0.0f);
        a1[c] = hgt_dot18(b1, Bs + c * FD_BS) + (c == r1 ? reg : 0.0f);
    }

    // ---- APGD ----
    float lam0, lam1;
    hgt_warp_apgd(a0, a1, y, x, rr0, rr1, step, mu_e, iterations, lane, lam0, lam1);

    // ---- qvel_new = v_free + L^-T (B lam); the columns come back from shared memory ----
    hgt_load18(b0, col0);
    if (v1) hgt_load18(b1, col1);  // else still zeros
    float p[HGT_NV];
#pragma unroll
    for (int v = 0; v < HGT_NV; ++v) p[v] = b0[v] * lam0 + b1[v] * lam1;
    const float bl = hgt_warp_reduce18(p, lane);
    if (slot >= 0) tv[slot] = bl;
    __syncwarp();
    const float yi = hgt_warp_backward_sub(dof ? tv[lane] : 0.0f, Ms, dinv, lane);
    if (dof) qvel_out[(size_t)e * HGT_NV + lane] = vfi + yi;
    lam_out[(size_t)e * HGT_NR + r0] = lam0;
    if (v1) lam_out[(size_t)e * HGT_NR + r1] = lam1 * s1;
}

// Raise the kernel's dynamic shared memory limit once.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, bool* allowed) {
    if (*allowed) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) *allowed = true;
    return err;
}

extern "C" {

// The matrices are (n,60,60) with 16 contact points; A must lie on a 16-byte
// boundary (the bulk copy's rule; the caller checks). step_bound may be null:
// the kernel then uses ||A'||_inf.
int hgt_apgd(const float* A, const float* u0, const float* lo, const float* lsign,
             const float* lbound, const float* mu, const float* step_bound,
             const float* lam_in, float* lam_out, int n, int iterations, void* stream) {
    if (n <= 0) return 0;
    static bool allowed = false;
    static int sm_count = 0;
    const size_t bytes = sizeof(float) * (AP_HEAD_FLOATS + DS_WARPS * AP_WARP_FLOATS);
    cudaError_t err = allow_smem(hgt_apgd_kernel, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    if (sm_count == 0) {
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    int grid = (n + DS_WARPS - 1) / DS_WARPS;
    if (grid > sm_count * DS_MIN_BLOCKS) grid = sm_count * DS_MIN_BLOCKS;
    hgt_apgd_kernel<<<grid, DS_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        A, u0, lo, lsign, lbound, mu, step_bound, lam_in, lam_out, n, iterations);
    return (int)cudaGetLastError();
}

// Mt (n,18,18) and J (n,60,18) must lie on 8-byte boundaries (the caller checks).
int hgt_fused_dense(const float* Mt, const float* J, const float* qvel, const float* rhs,
                    const float* lo, const float* lsign, const float* lbound,
                    const float* mu, const float* comp, const float* lam_in,
                    float* qvel_out, float* lam_out, int n, int iterations, void* stream) {
    if (n <= 0) return 0;
    static bool allowed = false;
    const size_t bytes = sizeof(float) * DS_WARPS * FD_WARP_FLOATS;
    cudaError_t err = allow_smem(hgt_fused_dense_kernel, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    const int grid = (n + DS_WARPS - 1) / DS_WARPS;
    hgt_fused_dense_kernel<<<grid, DS_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        Mt, J, qvel, rhs, lo, lsign, lbound, mu, comp, lam_in, qvel_out, lam_out, n, iterations);
    return (int)cudaGetLastError();
}

}  // extern "C"
