// The terrain mega kernel's second input: the IN2 rows of every env from
// its step-start state, in one launch.
//
// Replaces no Pallas kernel: the TPU package builds these rows with XLA
// (humanoid_gym_tpu/physics/mega_kernel.py `terrain_patches`, :1575-1664,
// and `make_contact_xy_batched`, :475), and the port's plain version is
// physics/mega.py `make_terrain_patches` with `make_contact_xy`, about 150
// small PyTorch operations a call (3 x 3 products through cuBLAS, the grid
// gathers, the concatenation). This kernel computes the same rows:
//   per contact point k (16 sole points, the left foot's 8 first): its world
//   xy from the leg's 6-joint chain; the grid coordinate
//   g = clamp((xy + border) * inv_h, 0, n - 1.001); the node p = (int) g;
//   the 3 x 3 patch at o = clamp(p - 1, 0, n - 3), tap-major at row
//   (i * 3 + j) * 16 + k, in meters; o as float32; the slope of the
//   bilinear cell at p, plus the env's slope DR bias.
//
// What bounds it on the H100: per env 76 B of qpos and 8 B of bias in,
// 832 B out, 144 taps of 4 B from a grid (17.6 MB on the deploy field) that
// stays in the 50 MB L2; about 2,400 float32 operations (utils/roofline.py
// terrain_patches_ops). So bytes bound it
// (0.9 us for the 2,048 envs of a joint-deploy robot) and, at that size, the
// launch. The design keeps it a single short pass: one thread per (env,
// point), 16 lanes an env, so each output row is written as 64 B runs and
// 32,768 threads keep enough loads in flight to hide L2 latency; each
// thread walks its own leg's chain (6 joints, ~400 operations, R and p in
// registers), which costs less than sharing it through shared memory; the
// bilinear cell's corners always lie in the 3 x 3 patch (p - o is 0 or 1),
// so the slope takes them from the taps by selects and loads nothing more.
//
// Arithmetic: float32, rounded as the plain version rounds. Elementwise
// steps use the _rn intrinsics, which the compiler never contracts into a
// fused multiply-add (the grid coordinate, its clamp and truncation, the
// quaternion's matrix, Rodrigues' I + sin q K + (1 - cos q) K^2 with the
// accurate sinf / cosf, the slope); each 3-term product is a chain of fmaf
// in index order, as cuBLAS's float32 SIMT GEMM takes the plain version's
// products: on the H100 the rows equal the plain version's bit for bit.
// Where a library sums otherwise an xy moves by an ulp, and a point within
// that of a grid line takes the neighbouring node.
//
// The model's geometry comes from the (541,) constants every mega launch of
// that robot reads (physics/mega.py CONST_LAYOUT: joint offsets and
// rotations, unit joint axes, contact-point offsets), so XBot-L and XBot-S
// launches differ only in the pointer. qpos and the bias may be row-strided
// views (the env carries qpos as a view of the mega kernel's output rows);
// the output is a fresh contiguous (N, 208) array.

#include <cuda_runtime.h>

#define N_POINTS 16
#define DEPTH 6  // joints of a leg chain
// IN2 layout (physics/mega.py IN2_*)
#define IN2_PMIN 0
#define IN2_OX 144
#define IN2_OY 160
#define IN2_GX 176
#define IN2_GY 192
#define IN2_ROWS 208
// model-constant offsets (physics/mega.py CONST_LAYOUT, as csrc/mega.cu has them)
#define C_JPOS 169
#define C_JROT 205
#define C_JAXIS 313
#define C_COFF 349
#define TP_THREADS 256  // threads a block: 16 envs

// a[r] . v as the chain fma(a2, v2, fma(a1, v1, a0 * v0))
__device__ __forceinline__ float dot3(float a0, float a1, float a2, const float* v) {
    return fmaf(a2, v[2], fmaf(a1, v[1], __fmul_rn(a0, v[0])));
}

// C = A B for row-major 3 x 3, each entry a dot3 chain
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            C[3 * a + b] = fmaf(A[3 * a + 2], B[6 + b],
                                fmaf(A[3 * a + 1], B[3 + b], __fmul_rn(A[3 * a], B[b])));
        }
    }
}

__global__ void __launch_bounds__(TP_THREADS) hgt_terrain_patches_kernel(
    const float* __restrict__ qpos, int qpos_stride, const float* __restrict__ bias,
    int bias_stride, const float* __restrict__ model, const float* __restrict__ grid, int nrow,
    int ncol, float border, float inv_h, float gx_max, float gy_max, float* __restrict__ out,
    int n) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int env = t / N_POINTS;
    if (env >= n) return;
    const int k = t % N_POINTS;
    const int leg = k / (N_POINTS / 2);
    const float* q = qpos + (size_t)env * qpos_stride;

    // the base rotation (physics/spatial.py quat_to_mat)
    const float w = q[3], x = q[4], y = q[5], z = q[6];
    const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
    const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
    const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
    float R[9] = {
        __fsub_rn(1.f, 2.f * __fadd_rn(yy, zz)), 2.f * __fsub_rn(xy, wz), 2.f * __fadd_rn(xz, wy),
        2.f * __fadd_rn(xy, wz), __fsub_rn(1.f, 2.f * __fadd_rn(xx, zz)), 2.f * __fsub_rn(yz, wx),
        2.f * __fsub_rn(xz, wy), 2.f * __fadd_rn(yz, wx), __fsub_rn(1.f, 2.f * __fadd_rn(xx, yy)),
    };
    float p[3] = {0.f, 0.f, 0.f};

    // the leg's chain: p += R jpos_j, R = (R jrot_j) Rot(axis_j, q_j)
#pragma unroll 1
    for (int d = 0; d < DEPTH; ++d) {
        const int j = leg * DEPTH + d;
        const float* jp = model + C_JPOS + 3 * j;
#pragma unroll
        for (int a = 0; a < 3; ++a)
            p[a] = __fadd_rn(dot3(R[3 * a], R[3 * a + 1], R[3 * a + 2], jp), p[a]);
        const float* ax = model + C_JAXIS + 3 * j;
        const float K[9] = {0.f, -ax[2], ax[1], ax[2], 0.f, -ax[0], -ax[1], ax[0], 0.f};
        float K2[9];
        matmul3(K, K, K2);
        const float s = sinf(q[7 + j]), c1 = __fsub_rn(1.f, cosf(q[7 + j]));
        float rot[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) {
            const float eye = (e % 4 == 0) ? 1.f : 0.f;
            rot[e] = __fadd_rn(__fadd_rn(eye, __fmul_rn(s, K[e])), __fmul_rn(c1, K2[e]));
        }
        float RJ[9];
        matmul3(R, model + C_JROT + 9 * j, RJ);
        matmul3(RJ, rot, R);
    }

    // the point's world xy, base-relative first, then the base added
    const float* off = model + C_COFF + 3 * k;
    const float px_w = __fadd_rn(__fadd_rn(dot3(R[0], R[1], R[2], off), p[0]), q[0]);
    const float py_w = __fadd_rn(__fadd_rn(dot3(R[3], R[4], R[5], off), p[1]), q[1]);

    // the grid coordinate, its node and the patch origin (fmaxf maps NaN to 0)
    const float gxf = fminf(fmaxf(__fmul_rn(__fadd_rn(px_w, border), inv_h), 0.f), gx_max);
    const float gyf = fminf(fmaxf(__fmul_rn(__fadd_rn(py_w, border), inv_h), 0.f), gy_max);
    const int px = (int)gxf, py = (int)gyf;
    const int ox = min(max(px - 1, 0), nrow - 3), oy = min(max(py - 1, 0), ncol - 3);

    float* o = out + (size_t)env * IN2_ROWS + k;
    float tap[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float* row = grid + (size_t)(ox + i) * ncol + oy;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            tap[3 * i + j] = __ldg(row + j);
            o[IN2_PMIN + (3 * i + j) * N_POINTS] = tap[3 * i + j];
        }
    }
    o[IN2_OX] = (float)ox;
    o[IN2_OY] = (float)oy;

    // the cell's corners h(px + a, py + b): patch rows di, di + 1 and
    // columns dj, dj + 1, with di = px - ox and dj = py - oy each 0 or 1
    const bool di = px != ox, dj = py != oy;
    float lo[3], hi[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        lo[j] = di ? tap[3 + j] : tap[j];
        hi[j] = di ? tap[6 + j] : tap[3 + j];
    }
    const float h00 = dj ? lo[1] : lo[0], h01 = dj ? lo[2] : lo[1];
    const float h10 = dj ? hi[1] : hi[0], h11 = dj ? hi[2] : hi[1];
    const float fx = __fsub_rn(gxf, (float)px), fy = __fsub_rn(gyf, (float)py);
    const float* b = bias + (size_t)env * bias_stride;
    const float gx = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(h10, h00), __fsub_rn(1.f, fy)),
                                         __fmul_rn(__fsub_rn(h11, h01), fy)), inv_h);
    const float gy = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(h01, h00), __fsub_rn(1.f, fx)),
                                         __fmul_rn(__fsub_rn(h11, h10), fx)), inv_h);
    o[IN2_GX] = __fadd_rn(gx, b[0]);
    o[IN2_GY] = __fadd_rn(gy, b[1]);
}

extern "C" {

// qpos (n rows of >= 19 floats, qpos_stride apart), bias (n rows of 2,
// bias_stride apart), model (541 constants), grid (nrow x ncol meters,
// row-major), out (n x 208), all on one device; the launch goes to `stream`.
int hgt_terrain_patches(const float* qpos, int qpos_stride, const float* bias, int bias_stride,
                        const float* model, const float* grid, int nrow, int ncol, float border,
                        float inv_h, float gx_max, float gy_max, float* out, int n, void* stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)n * N_POINTS;
    const int blocks = (int)((threads + TP_THREADS - 1) / TP_THREADS);
    hgt_terrain_patches_kernel<<<blocks, TP_THREADS, 0, (cudaStream_t)stream>>>(
        qpos, qpos_stride, bias, bias_stride, model, grid, nrow, ncol, border, inv_h, gx_max,
        gy_max, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
