// Whole-policy-step physics for XBot-L: one launch runs all `decimation`
// 1 kHz substeps for every environment, one warp per environment.
//
// Replaces humanoid_gym_tpu/physics/mega_kernel.py:_build_mega_kernel (the
// inner `kernel`, launched by `_mega_call`). Each substep: PD torques with
// the DR kp/kd scales and torque clip; FK with the velocity and bias
// recursion, positions BASE-RELATIVE (FK seeded at the origin; world-origin
// composites in f32 made the Cholesky go NaN past ~100 m); per-body forces
// and world-origin composite moments; the CRBA mass matrix with implicit
// damping, assembled in the solver-internal DOF order [left leg, right leg,
// base] with the cross-leg blocks never written; 16 sole-contact rows
// (Baumgarte, max_depen_vel) and 12 joint-limit rows (margin 0.05,
// Baumgarte 0.2, cap 2.0, inactive sentinel -1e9); the tanh(dq/0.05) joint
// friction; the contact solve of solve.cuh warm-started from the carried
// impulses; the joint-velocity clip; semi-implicit integration with the
// quaternion exponential map. After the loop one more FK pass writes the
// end-of-step feet/knee kinematics (fk14).
//
// What bounds it on the H100: about a million float32 operations per env
// per launch on 480 B in and 544 B out, in chains of small dependent steps.
// It is far below both the bandwidth and the FLOP roofline; instruction
// throughput and latency limit it. So one env gets a warp, its state lives in
// that warp's shared memory and registers for all substeps (nothing goes
// through device memory between them), and enough warps stay resident on an
// SM for the schedulers to switch among.
//
// Lane assignment of each stage (lane l of the env's warp, leg = l >> 4,
// m = l & 15 where a stage splits the warp by leg):
//   load / store     120 input and 136 output floats through shared memory,
//                    coalesced.
//   PD               lane j < 12: tau[j], sin/cos of joint j.
//   joint rotations  jrot_j * Rot(axis_j, q_j) for all 12 joints before the
//                    chain, 108 entries over the lanes; jrot_j * axis_j once
//                    per launch.
//   chain            7 steps for the 6 levels of both legs at once; in step s
//                    lanes m < 9 / 9..11 / 12..14 of each leg form R, p and
//                    the world joint axis of level s (a row of the parent's R
//                    times a 3-vector), and lanes m < 12 the om / vo / al / ao
//                    components of level s - 1.
//   per body         lane b < 13: force, moment, composite inertia of body b
//                    (row stride 17); lanes < 18 the 18 motion screws.
//   subtree sums     lane (leg, component) runs down its leg, then 16 lanes
//                    add both legs into the base.
//   mass matrix      the 135 structurally non-zero lower-triangle entries
//                    (pair table shared with the solve), one screw pair each,
//                    over the lanes; written straight into the solve's M.
//   rhs              lane i < 18: entry i (h, joint friction, PD torque).
//   contact / limit  lane l builds constraint columns l and l + 32 of J^T in
//                    registers, with target and sign, inside the solve
//                    (MegaCols): its sole point, 6 ancestor joints, the base.
//   solve            solve.cuh.
//   integration      lane i < 18 owns velocity entry i; every lane forms the
//                    quaternion step, lane 18 stores it.
//
// Shared memory: MG_WARP_FLOATS = 1448 floats (5792 B) per env, see the map
// below, plus per block the 541 model constants (copied once per block from
// the launch's `model` argument, a (541,) float32 device array: lanes on
// different bodies or joints read different addresses, which __constant__
// memory serialises) and the pair table.
// Residency: 4096 envs / 132 SMs = 31.03, so one wave needs 32 resident
// warps per SM: at most 64 registers per thread (65,536 / 1024) and
// (232,448 - 2 x 1,024 reserved) / 32 = 7,200 B per env. With MG_WARPS = 16
// a block takes 16 x 5,792 + 2,464 = 95,136 B, two blocks (32 warps) fit an
// SM, and the 256 blocks of 4096 envs are one wave (1.94 blocks per SM).
// B (18 x 61 floats more per env) is what would not have fitted; it stays
// in registers. ptxas holds the kernel to 64 registers with about 110 bytes
// of spills. Tried at 4096 envs on an NVIDIA H100 80GB HBM3, 700.00 W, by
// rebuilding with other block sizes and register caps (PERF.md has the
// readings): 8, 4 and 2 envs per block were each slower than 16; an 85-
// register cap (two waves) and a 128-register cap (no spills, half the
// resident warps) were both slower too, the latter only slightly: halving
// the resident warps costs little, so the kernel is bound by instruction
// throughput, not by latency. Dropped: a thread per env with everything in
// local memory (255 registers, 7-10 KB of stack per thread, one warp per SM;
// 4.0 ms per launch).
//
// Terrain variant (template <bool TERRAIN>, launched by
// hgt_mega_step_terrain; replaces the TPU kernel built with `terrain=`,
// mega_kernel.py:560, 585-595, 731-751, 1096-1198, 1306-1311). A second
// input of IN2_ROWS = 208 floats per env, built once per policy step from
// the step-start state (physics/mega.py make_terrain_patches): per contact
// point the 3 x 3 node patch of the grid in meters, tap-major, its origin
// (ox, oy) in grid units, and the step-start slope (gx, gy) with the slope
// DR bias. At load the warp copies the taps and the origins to MG_T and turns
// the slope into the point's frame, n = normalize(-gx, -gy, 1) and t1 =
// normalize(n_z, 0, -n_x) (t2 = n x t1 is formed where it is used, t1_y =
// 0), once per launch. In each column of a contact row: the ground
// bilinearly from the point's patch, (u, v) relative to the patch origin
// clipped to [0, 1.999] (a point that moved more than a cell since the step
// start clamps to the patch edge); phi = (z - ground) n_z; the row's
// direction d (t1, t2 or n) gives the base-translation entries d_c, the
// base-rotation entries (X x d)_c and the ancestor-joint entries
// (a_j x (X - p_j)) . d. The zero pattern of J (a foot's rows touch its own
// leg and the base) is that of flat ground, so the leg-block Cholesky and
// the pair table of the solve hold as they are. After the loop the per-foot
// impulse sums are sum_k (lam_t1 t1 + lam_t2 t2 + lam_n n). The flat
// instantiation compiles the code of the flat kernel unchanged (every
// terrain statement is under `if constexpr`). Shared memory: 256 floats more
// per env (MG_T, 1,024 B): 16 x 6,816 + 2,464 = 111,520 B a block, two
// blocks still fit an SM, so 4096 envs remain one wave.
//
// Host side: each launch names its model's constants by pointer, as the TPU
// kernel takes them as an input block (mega_kernel.py:1442-1458), so
// launches of two models (XBot-L and XBot-S in a joint batch) may follow one
// another on one stream, or run on two, with no upload and no
// synchronisation between them. The constants array must stay allocated
// until the launch has run; the caller keeps one per model on the device of
// the inputs. Launches go to the stream the caller names.
//
// Layouts (env-major, float32): input (N, 120) rows
//   0:19 qpos, 19:37 qvel, 37:49 targets, 49 friction, 50 base-mass scale,
//   51 contact stiffness, 52 contact offset, 53 kp scale, 54 kd scale,
//   55 contact compliance, 56:116 warm-start impulses;
// output (N, 136) rows
//   0:19 qpos, 19:37 qvel, 37:97 lam, 97:109 tau, 109:115 per-foot
//   world-frame impulse sums, 115:129 fk14, 129:136 zero.

#include <cuda_runtime.h>

#include "solve.cuh"

#define NB 13
#define NJ 12
#define NQ 19

#define IN_ROWS 120
#define OUT_ROWS 136
#define IN_QPOS 0
#define IN_QVEL 19
#define IN_TGT 37
#define IN_FRIC 49
#define IN_MS 50
#define IN_CSTIFF 51
#define IN_COFF 52
#define IN_KPS 53
#define IN_KDS 54
#define IN_COMP 55
#define IN_LAM 56
#define OUT_QPOS 0
#define OUT_QVEL 19
#define OUT_LAM 37
#define OUT_TAU 97
#define OUT_FF 109
#define OUT_FK 115
// terrain second input (physics/mega.py IN2_*): 9 x 16 taps, ox, oy, gx, gy
#define IN2_PMIN 0
#define IN2_OX 144
#define IN2_OY 160
#define IN2_GX 176
#define IN2_GY 192
#define IN2_ROWS 208

// model-constant layout (must match physics/mega.py CONST_LAYOUT)
#define C_MASS 0
#define C_COM 13
#define C_INERTIA 52
#define C_JPOS 169
#define C_JROT 205
#define C_JAXIS 313
#define C_COFF 349
#define C_KP 397
#define C_KD 409
#define C_TLIM 421
#define C_LOW 433
#define C_UP 445
#define C_VLIM 457
#define C_JFRIC 469
#define C_JDAMP 481
#define C_ARM 493
#define C_GRAV 505
#define C_PARENT 508
#define C_CBODY 521
#define C_FEET 537
#define C_KNEE 539
#define C_TOTAL 541

// launch shape and shared-memory map (float offsets within one warp's region)
#define MG_WARPS 16         // envs per block of the mega kernel
#define MG_MIN_BLOCKS 2     // resident blocks per SM the register budget allows
#define SV_WARPS 8          // envs per block of the stand-alone solve
#define MG_HEAD_FLOATS 616  // per block: 541 constants padded to 544, 270 pair bytes padded to 288
#define CS 17               // row stride of the composites (16 used)
#define MG_S 0              // 120: qpos, qvel, targets, DR values in the input row layout
#define MG_SOLVE 120        // HGT_SOLVE_FLOATS
#define MG_TAU 568          // 12
#define MG_QN 580           // 18 (+2): new velocity, solver order
#define MG_SC 600           // 24: sin, cos of the joint angles
#define MG_ALOC 624         // 36: jrot_j * axis_j
#define MG_RLOC 660         // 108: jrot_j * Rot(axis_j, q_j)
#define MG_R 768            // 117; the solve's Gram scratch overlays R..AL
#define MG_P 885            // 39
#define MG_AXW 924          // 36
#define MG_OM 960           // 39
#define MG_VO 999           // 39
#define MG_AL 1038          // 39
#define MG_AO 1077          // 39
#define MG_CSS 1116         // 13 x 17 = 221; the output row is staged here
#define MG_SW 1337          // 54: angular parts of the 18 motion screws
#define MG_SVL 1391         // 54: linear parts
#define MG_WARP_FLOATS 1448 // padded to a multiple of 4
#define MG_T 1448           // terrain variant only: taps and patch origin in the IN2 layout (176),
#define MG_T_FR 176         //   then per point n_x, n_y, n_z, t1_x, t1_z (5 x 16) at MG_T + MG_T_FR
#define MG_T_FLOATS 256
#define MG_WARP_FLOATS_T 1704  // MG_T + MG_T_FLOATS
#define SV_WARP_FLOATS 792  // HGT_SOLVE_FLOATS + HGT_GRAM_FLOATS
#define SV_HEAD_FLOATS 72   // per block of the stand-alone solve: 270 pair bytes padded to 288

static_assert(MG_SOLVE + HGT_SOLVE_FLOATS <= MG_TAU, "solve scratch overlaps");
static_assert(MG_R + HGT_GRAM_FLOATS <= MG_AO + 39, "Gram scratch leaves the kinematics scratch");
static_assert(MG_SVL + 54 <= MG_WARP_FLOATS && MG_WARP_FLOATS % 4 == 0, "warp region");
static_assert(MG_SOLVE % 4 == 0 && MG_HEAD_FLOATS % 4 == 0, "float4 alignment");
static_assert(SV_WARP_FLOATS == HGT_SOLVE_FLOATS + HGT_GRAM_FLOATS, "solve region");
static_assert(MG_HEAD_FLOATS * 4 >= 544 * 4 + 2 * HGT_NPAIR && SV_HEAD_FLOATS * 4 >= 2 * HGT_NPAIR
              && SV_HEAD_FLOATS % 4 == 0, "block headers");
static_assert(OUT_ROWS <= 13 * CS, "output staging");
static_assert(MG_T >= MG_WARP_FLOATS && MG_T % 4 == 0 && MG_T_FR == IN2_GX
              && MG_T_FR + 5 * HGT_NP <= MG_T_FLOATS && IN2_ROWS <= MG_T_FLOATS
              && MG_WARP_FLOATS_T == MG_T + MG_T_FLOATS, "terrain region");

// launch constants of the terrain variant: the world-to-grid map and the
// clip of the grid coordinate (nrow - 1.001, ncol - 1.001)
struct MgTerrain {
    float border, inv_h, gx_max, gy_max;
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

// component q of a x b (all three formed, one selected: no indexed registers)
__device__ __forceinline__ float cross_c(const float* a, const float* b, int q) {
    float c0 = a[1] * b[2] - a[2] * b[1];
    float c1 = a[2] * b[0] - a[0] * b[2];
    float c2 = a[0] * b[1] - a[1] * b[0];
    return q == 0 ? c0 : (q == 1 ? c1 : c2);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Block-wide: the launch's model constants and the pair table into the
// block's header.
__device__ __forceinline__ void load_header(float* smem, const float* __restrict__ model) {
    for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) smem[i] = model[i];
    hgt_fill_pairs(reinterpret_cast<unsigned char*>(smem + 544));
    __syncthreads();
}

// FK and the velocity recursion by one warp, base-relative (base origin at
// 0), for two 6-joint chains off the base (bodies 1..6 and 7..12, each the
// child of the one before; physics/mega.py check_mega_topology holds the
// model to that): R (NB x 9), p (NB x 3), axw (NJ x 3), om / vo (NB x 3); with_bias also
// fills al / ao with the bias accelerations (qacc = 0). Reads qpos / qvel
// from sm[MG_S]; the caller has synchronised the warp after writing them,
// and MG_ALOC is filled. Ends synchronised.
__device__ __forceinline__ void chain_kin(float* sm, const float* cm, int lane, bool with_bias) {
    const float* qpos = sm + MG_S + IN_QPOS;
    const float* qvel = sm + MG_S + IN_QVEL;
    float* sc = sm + MG_SC;
    float* Rloc = sm + MG_RLOC;
    float* R = sm + MG_R;
    float* p = sm + MG_P;
    float* axw = sm + MG_AXW;
    float* om = sm + MG_OM;
    float* vo = sm + MG_VO;
    float* al = sm + MG_AL;
    float* ao = sm + MG_AO;

    if (lane < NJ) {
        float q = qpos[7 + lane];
        sc[lane] = sinf(q);
        sc[NJ + lane] = cosf(q);
    }
    if (lane == 31) {  // base rotation from the quaternion
        float w = qpos[3], x = qpos[4], y = qpos[5], z = qpos[6];
        float xx = x * x, yy = y * y, zz = z * z;
        float xy = x * y, xz = x * z, yz = y * z;
        float wx = w * x, wy = w * y, wz = w * z;
        R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz); R[2] = 2 * (xz + wy);
        R[3] = 2 * (xy + wz); R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
        R[6] = 2 * (xz - wy); R[7] = 2 * (yz + wx); R[8] = 1 - 2 * (xx + yy);
    }
    if (lane >= 16 && lane < 19) {
        int c = lane - 16;
        p[c] = 0.0f;
        om[c] = qvel[3 + c];
        vo[c] = qvel[c];
        al[c] = 0.0f;
        ao[c] = 0.0f;
    }
    __syncwarp();
    // rotation about the (unit) joint axis, I + s K + (1 - c) K^2, behind jrot
    for (int t = lane; t < NJ * 9; t += 32) {
        int j = t / 9, e = t - 9 * j, r = e / 3, q = e - 3 * r;
        const float* ax = cm + C_JAXIS + 3 * j;
        const float* jr = cm + C_JROT + 9 * j + 3 * r;
        float s = sc[j], c1 = 1.0f - sc[NJ + j];
        float aq = ax[q];
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
            // K = [a]x, K^2 = a a^T - |a|^2 I, entry (k, q)
            float kkq = (q == k) ? 0.0f : (q == k1 ? -ax[k2] : ax[k1]);
            float ksq = (q == k) ? -(ax[k1] * ax[k1] + ax[k2] * ax[k2]) : ax[k] * aq;
            float rax = (k == q ? 1.0f : 0.0f) + s * kkq + c1 * ksq;
            acc = acc + jr[k] * rax;
        }
        Rloc[t] = acc;
    }
    __syncwarp();

    const int leg = lane >> 4, m = lane & 15;
    for (int st = 0; st <= NJ / 2; ++st) {
        if (st < NJ / 2 && m < 15) {  // R, p, world axis of level st
            int b = 1 + (NJ / 2) * leg + st, par = st == 0 ? 0 : b - 1, j = b - 1;
            int r = m < 9 ? m / 3 : (m < 12 ? m - 9 : m - 12);
            const float* Rp = R + 9 * par + 3 * r;
            const float* vec;
            int stride = 1;
            if (m < 9) { vec = Rloc + 9 * j + (m - 3 * r); stride = 3; }
            else if (m < 12) vec = cm + C_JPOS + 3 * j;
            else vec = sm + MG_ALOC + 3 * j;
            float v = Rp[0] * vec[0] + Rp[1] * vec[stride] + Rp[2] * vec[2 * stride];
            if (m < 9) R[9 * b + m] = v;
            else if (m < 12) p[3 * b + r] = v + p[3 * par + r];
            else axw[3 * j + r] = v;
        }
        if (st >= 1 && m < (with_bias ? 12 : 6)) {  // velocities of level st - 1
            int b = (NJ / 2) * leg + st, par = st == 1 ? 0 : b - 1, j = b - 1;
            int kind = m / 3, q = m - 3 * kind;
            float rel[3] = {p[3 * b] - p[3 * par], p[3 * b + 1] - p[3 * par + 1],
                            p[3 * b + 2] - p[3 * par + 2]};
            float qd = qvel[6 + j];
            const float* omp = om + 3 * par;
            const float* aj = axw + 3 * j;
            if (kind == 0) {
                om[3 * b + q] = omp[q] + aj[q] * qd;
            } else if (kind == 1) {
                vo[3 * b + q] = vo[3 * par + q] + cross_c(omp, rel, q);
            } else if (kind == 2) {
                al[3 * b + q] = al[3 * par + q] + cross_c(omp, aj, q) * qd;
            } else {
                float wxr[3];
                cross3(omp, rel, wxr);
                ao[3 * b + q] = ao[3 * par + q] + cross_c(al + 3 * par, rel, q) + cross_c(omp, wxr, q);
            }
        }
        __syncwarp();
    }
}

// M entry = screw a against the momentum of composite cs moved by screw b.
__device__ __forceinline__ float screw_pair(const float* cs, const float* wa, const float* va,
                                            const float* wb, const float* vb) {
    const float m = cs[6];
    const float* s = &cs[7];
    const float* I = &cs[10];
    float wxs[3], sxv[3];
    cross3(wb, s, wxs);
    cross3(s, vb, sxv);
    float f[3], t[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) f[q] = vb[q] * m + wxs[q];
    t[0] = I[0] * wb[0] + I[3] * wb[1] + I[4] * wb[2] + sxv[0];
    t[1] = I[3] * wb[0] + I[1] * wb[1] + I[5] * wb[2] + sxv[1];
    t[2] = I[4] * wb[0] + I[5] * wb[1] + I[2] * wb[2] + sxv[2];
    return dot3(wa, t) + dot3(va, f);
}

// Force, moment about the world origin, mass, first moment and inertia about
// the origin of body b: F(3) T(3) m s(3) Io(6: xx yy zz xy xz yz).
__device__ __forceinline__ void body_stage(float* sm, const float* cm, int b, float ms) {
    const float* Rb = sm + MG_R + 9 * b;
    const float* pb = sm + MG_P + 3 * b;
    const float* omb = sm + MG_OM + 3 * b;
    const float* alb = sm + MG_AL + 3 * b;
    const float* aob = sm + MG_AO + 3 * b;
    const float* cb = cm + C_COM + 3 * b;
    const float* Ib = cm + C_INERTIA + 9 * b;
    const float* g = cm + C_GRAV;
    float msc = (b == 0) ? ms : 1.0f;
    float mass = cm[C_MASS + b] * msc;
    float com[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
        com[r] = pb[r] + (Rb[3 * r] * cb[0] + Rb[3 * r + 1] * cb[1] + Rb[3 * r + 2] * cb[2]);
    // world inertia I_w = R I R^T (base scaled by the mass DR)
    float IR[9], Iw[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q)
            IR[3 * r + q] = Rb[3 * r] * Ib[q] + Rb[3 * r + 1] * Ib[3 + q] + Rb[3 * r + 2] * Ib[6 + q];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q)
            Iw[3 * r + q] = (IR[3 * r] * Rb[3 * q] + IR[3 * r + 1] * Rb[3 * q + 1] + IR[3 * r + 2] * Rb[3 * q + 2]) * msc;
    float rc[3] = {com[0] - pb[0], com[1] - pb[1], com[2] - pb[2]};
    float wxrc[3], axrc[3], wxwxrc[3];
    cross3(omb, rc, wxrc);
    cross3(alb, rc, axrc);
    cross3(omb, wxrc, wxwxrc);
    float f[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) f[q] = mass * (aob[q] + axrc[q] + wxwxrc[q] - g[q]);
    float Iww[3], Ia[3], wxIw[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        Iww[r] = Iw[3 * r] * omb[0] + Iw[3 * r + 1] * omb[1] + Iw[3 * r + 2] * omb[2];
        Ia[r] = Iw[3 * r] * alb[0] + Iw[3 * r + 1] * alb[1] + Iw[3 * r + 2] * alb[2];
    }
    cross3(omb, Iww, wxIw);
    float cxf[3];
    cross3(com, f, cxf);
    float* c = sm + MG_CSS + CS * b;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        c[q] = f[q];
        c[3 + q] = Ia[q] + wxIw[q] + cxf[q];
        c[7 + q] = mass * com[q];
    }
    c[6] = mass;
    float c2 = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
    c[10] = Iw[0] + mass * (c2 - com[0] * com[0]);
    c[11] = Iw[4] + mass * (c2 - com[1] * com[1]);
    c[12] = Iw[8] + mass * (c2 - com[2] * com[2]);
    c[13] = Iw[1] - mass * (com[0] * com[1]);
    c[14] = Iw[2] - mass * (com[0] * com[2]);
    c[15] = Iw[5] - mass * (com[1] * com[2]);
}

// Builds, inside the solve, the two constraint columns of a lane from the
// kinematics scratch: contact rows (flat ground and identity frames, or the
// heightfield patch and sloped frames of MG_T) and joint-limit rows, with
// their targets and signs.
template <bool TERRAIN>
struct MegaCols {
    const float* sm;
    const float* cm;
    int lane;
    float inv_dt, bmg, coffset, max_depen_vel;
    MgTerrain terr;

    // Contact row (point k, direction i) on the heightfield: the ground
    // bilinearly inside the point's 3x3 patch (clamped to it), the gap along
    // the normal, and the row projected on its direction d (t1, t2 = n x t1
    // or n) of the point's frame.
    __device__ __forceinline__ void terrain_row(const float (&X)[3], int k, int i, bool left,
                                                float (&b)[HGT_NV], float& tg) const {
        const float* qpos = sm + MG_S + IN_QPOS;
        const float* tr = sm + MG_T;
        float fx = fminf(fmaxf((X[0] + qpos[0] + terr.border) * terr.inv_h, 0.0f), terr.gx_max);
        float fy = fminf(fmaxf((X[1] + qpos[1] + terr.border) * terr.inv_h, 0.0f), terr.gy_max);
        float u = fminf(fmaxf(fx - tr[IN2_OX + k], 0.0f), 1.999f);
        float v = fminf(fmaxf(fy - tr[IN2_OY + k], 0.0f), 1.999f);
        float iu = floorf(u), iv = floorf(v);
        float fu = u - iu, fv = v - iv;
        const float* p = tr + IN2_PMIN + ((int)iu * 3 + (int)iv) * HGT_NP + k;  // tap (iu, iv)
        float lo0 = (1.0f - fv) * p[0] + fv * p[HGT_NP];                   // (iu, iv), (iu, iv + 1)
        float lo1 = (1.0f - fv) * p[3 * HGT_NP] + fv * p[4 * HGT_NP];      // (iu + 1, .)
        float ground = (1.0f - fu) * lo0 + fu * lo1;
        const float* fr = tr + MG_T_FR + k;
        float nx = fr[0], ny = fr[HGT_NP], nz = fr[2 * HGT_NP];
        float t1x = fr[3 * HGT_NP], t1z = fr[4 * HGT_NP];
        float d[3] = {i == 0 ? t1x : (i == 1 ? ny * t1z : nx),
                      i == 0 ? 0.0f : (i == 1 ? nz * t1x - nx * t1z : ny),
                      i == 0 ? t1z : (i == 1 ? -ny * t1x : nz)};
        float phi = (X[2] + qpos[2] - ground) * nz;
        float b_pen = fminf(bmg * (-phi) * inv_dt, max_depen_vel);
        float b_gap = -phi * inv_dt;
        float lo = phi <= 0.0f ? b_pen : b_gap;
        if (phi > coffset) lo = -1e9f;
        if (i == 2) tg = lo;
        // base translation d_c and rotation (X x d)_c
        float xd[3];
        cross3(X, d, xd);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            b[NJ + c] = d[c];
            b[NJ + 3 + c] = xd[c];
        }
        // the foot's six ancestor joints: (a_j x (X - pivot_j)) . d
        int j0 = left ? 0 : NJ / 2;
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
            const float* pj = sm + MG_P + 3 * (j0 + jj + 1);
            float rx[3] = {X[0] - pj[0], X[1] - pj[1], X[2] - pj[2]};
            float col[3];
            cross3(sm + MG_AXW + 3 * (j0 + jj), rx, col);
            float val = col[0] * d[0] + col[1] * d[1] + col[2] * d[2];
            b[jj] = left ? val : 0.0f;
            b[NJ / 2 + jj] = left ? 0.0f : val;
        }
    }

    __device__ __forceinline__ void column(int r, float (&b)[HGT_NV], float& tg, float& sg) const {
        const float* qpos = sm + MG_S + IN_QPOS;
#pragma unroll
        for (int v = 0; v < HGT_NV; ++v) b[v] = 0.0f;
        tg = 0.0f;
        sg = 1.0f;
        if (r < HGT_NC) {
            int k = r / 3, i = r - 3 * k;
            int fb = (int)cm[C_CBODY + k];
            bool left = fb <= NJ / 2;
            const float* o = cm + C_COFF + 3 * k;
            const float* Rf = sm + MG_R + 9 * fb;
            const float* pf = sm + MG_P + 3 * fb;
            float X[3];
#pragma unroll
            for (int q = 0; q < 3; ++q)
                X[q] = Rf[3 * q] * o[0] + Rf[3 * q + 1] * o[1] + Rf[3 * q + 2] * o[2] + pf[q];
            if constexpr (TERRAIN) {
                terrain_row(X, k, i, left, b, tg);
                return;
            }
            float phi = X[2] + qpos[2];
            float b_pen = fminf(bmg * (-phi) * inv_dt, max_depen_vel);
            float b_gap = -phi * inv_dt;
            float lo = phi <= 0.0f ? b_pen : b_gap;
            if (phi > coffset) lo = -1e9f;
            if (i == 2) tg = lo;
            // base translation e_c and rotation (e_c x X), component i
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                int c1 = c == 2 ? 0 : c + 1, c2 = c == 0 ? 2 : c - 1;
                b[NJ + c] = (i == c) ? 1.0f : 0.0f;
                b[NJ + 3 + c] = (i == c1) ? -X[c2] : ((i == c2) ? X[c1] : 0.0f);
            }
            // the foot's six ancestor joints: a_j x (X - pivot_j), component i
            int j0 = left ? 0 : NJ / 2;
#pragma unroll
            for (int jj = 0; jj < NJ / 2; ++jj) {
                const float* pj = sm + MG_P + 3 * (j0 + jj + 1);
                float rx[3] = {X[0] - pj[0], X[1] - pj[1], X[2] - pj[2]};
                float val = cross_c(sm + MG_AXW + 3 * (j0 + jj), rx, i);
                b[jj] = left ? val : 0.0f;
                b[NJ / 2 + jj] = left ? 0.0f : val;
            }
        } else if (r < HGT_NR) {
            int j = r - HGT_NC;
            float q = qpos[7 + j];
            float low = cm[C_LOW + j], up = cm[C_UP + j];
            bool near_lower = q < 0.5f * (low + up);
            float viol = near_lower ? low - q : q - up;
            float lb_pen = fminf(0.2f * viol * inv_dt, 2.0f);
            float bb = viol >= 0.0f ? lb_pen : viol * inv_dt;
            if (viol < -0.05f) bb = -1e9f;
#pragma unroll
            for (int v = 0; v < NJ; ++v) b[v] = (v == j) ? 1.0f : 0.0f;
            sg = near_lower ? 1.0f : -1.0f;
            tg = bb;
        }
    }

    __device__ __forceinline__ void operator()(float (&b0)[HGT_NV], float (&b1)[HGT_NV], float& tg0,
                                               float& tg1, float& s0, float& s1) const {
        column(lane, b0, tg0, s0);
        column(lane + 32, b1, tg1, s1);
    }
};

template <bool TERRAIN>
__device__ __forceinline__ void substep(float* sm, const float* cm, const unsigned char* pairs,
                                        int lane, float& lam0, float& lam1, float dt,
                                        int iterations, float max_depen_vel, const MgTerrain& terr) {
    float* S = sm + MG_S;
    float* qpos = S + IN_QPOS;
    float* qvel = S + IN_QVEL;
    const float mu = S[IN_FRIC], ms = S[IN_MS], cstiff = S[IN_CSTIFF], coffset = S[IN_COFF];
    const float kps = S[IN_KPS], kds = S[IN_KDS], comp = S[IN_COMP];
    float* tau = sm + MG_TAU;
    float* cs = sm + MG_CSS;
    float* sw = sm + MG_SW;
    float* sv = sm + MG_SVL;

    // ---- PD torques with motor-strength DR ----
    if (lane < NJ) {
        float t = kps * cm[C_KP + lane] * (S[IN_TGT + lane] - qpos[7 + lane])
                  - kds * cm[C_KD + lane] * qvel[6 + lane];
        float tl = cm[C_TLIM + lane];
        tau[lane] = fminf(fmaxf(t, -tl), tl);
    }

    // ---- FK + velocity / bias recursion ----
    chain_kin(sm, cm, lane, true);

    // ---- per-body forces and world-origin composite moments; motion screws
    // in solver order (joints: axis, pivot x axis; base: translations, then
    // rotations about the base origin) ----
    if (lane < NB) body_stage(sm, cm, lane, ms);
    if (lane < NJ) {
        const float* aj = sm + MG_AXW + 3 * lane;
        const float* pj = sm + MG_P + 3 * (lane + 1);
        float lin[3];
        cross3(pj, aj, lin);
        for (int q = 0; q < 3; ++q) { sw[3 * lane + q] = aj[q]; sv[3 * lane + q] = lin[q]; }
    } else if (lane < HGT_NV) {
        int c = lane - NJ;
        for (int q = 0; q < 3; ++q) {
            sw[3 * lane + q] = (c >= 3 && c - 3 == q) ? 1.0f : 0.0f;
            sv[3 * lane + q] = (c < 3 && c == q) ? 1.0f : 0.0f;
        }
    }
    __syncwarp();
    // subtree sums: down each leg, then both legs into the base
    {
        int leg = lane >> 4, q = lane & 15;
        float acc = cs[CS * ((NJ / 2) * leg + NJ / 2) + q];
        for (int b = (NJ / 2) * leg + NJ / 2 - 1; b >= (NJ / 2) * leg + 1; --b) {
            acc = cs[CS * b + q] + acc;
            cs[CS * b + q] = acc;
        }
    }
    __syncwarp();
    if (lane < 16) cs[lane] = (cs[lane] + cs[CS * (1 + NJ / 2) + lane]) + cs[CS + lane];
    __syncwarp();

    // ---- mass matrix through composite screws, lower triangle, cross-leg
    // block never written ----
    float* Ms = sm + MG_SOLVE + HGT_SM_M;
    for (int t = lane; t < HGT_NPAIR; t += 32) {
        int i = pairs[2 * t], a = pairs[2 * t + 1];
        float v;
        if (i < NJ) {  // joint i against its ancestor joint a (itself included)
            v = screw_pair(cs + CS * (i + 1), sw + 3 * a, sv + 3 * a, sw + 3 * i, sv + 3 * i);
            if (a == i)
                v = v + (dt * cm[C_KD + i]) * kds + (cm[C_ARM + i] + dt * cm[C_JDAMP + i]);
        } else if (a < NJ) {  // base screw i against joint a
            v = screw_pair(cs + CS * (a + 1), sw + 3 * i, sv + 3 * i, sw + 3 * a, sv + 3 * a);
        } else {  // base against base
            v = screw_pair(cs, sw + 3 * a, sv + 3 * a, sw + 3 * i, sv + 3 * i);
        }
        Ms[i * HGT_LS + a] = v;
    }

    // ---- rhs = dt (S tau + tau_fric - h) and the velocity, entry `lane`,
    // solver order (joints 0:12, base 12:18) ----
    float rhs_i = 0.0f, qv_i = 0.0f;
    if (lane < NJ) {
        const float* c = cs + CS * (lane + 1);
        float pxf[3];
        cross3(sm + MG_P + 3 * (lane + 1), c, pxf);
        float tt[3] = {c[3] - pxf[0], c[4] - pxf[1], c[5] - pxf[2]};
        float h = dot3(sm + MG_AXW + 3 * lane, tt);
        float dq = qvel[6 + lane];
        float tf = -cm[C_JFRIC + lane] * tanhf(dq / 0.05f) - cm[C_JDAMP + lane] * dq;
        rhs_i = dt * (tau[lane] + tf - h);
        qv_i = dq;
    } else if (lane < HGT_NV) {
        rhs_i = (-dt) * cs[lane - NJ];
        qv_i = qvel[lane - NJ];
    }
    __syncwarp();

    MegaCols<TERRAIN> cols{sm, cm, lane, 1.0f / dt, 0.2f * cstiff, coffset, max_depen_vel, terr};
    float qn_i, l0, l1;
    hgt_solve_env(sm + MG_SOLVE, sm + MG_R, pairs, lane, rhs_i, qv_i, mu, comp, lam0, lam1,
                  iterations, cols, qn_i, l0, l1);
    lam0 = l0;
    lam1 = l1;

    // ---- velocity limits + semi-implicit integration ----
    float* qn = sm + MG_QN;
    if (lane < NJ) {
        float vl = cm[C_VLIM + lane];
        qn[lane] = fminf(fmaxf(qn_i, -vl), vl);
    } else if (lane < HGT_NV) {
        qn[lane] = qn_i;
    }
    __syncwarp();
    float ax = qn[NJ + 3] * dt, ay = qn[NJ + 4] * dt, az = qn[NJ + 5] * dt;
    float theta = sqrtf(ax * ax + ay * ay + az * az);
    float half = 0.5f * theta;
    float kfac = theta > 1e-9f ? sinf(half) / fmaxf(theta, 1e-12f) : 0.5f;
    float dw = cosf(half), dx = ax * kfac, dy = ay * kfac, dz = az * kfac;
    float qw = qpos[3], qx = qpos[4], qy = qpos[5], qz = qpos[6];
    float nw = dw * qw - dx * qx - dy * qy - dz * qz;
    float nx = dw * qx + dx * qw + dy * qz - dz * qy;
    float ny = dw * qy - dx * qz + dy * qw + dz * qx;
    float nz = dw * qz + dx * qy - dy * qx + dz * qw;
    float qnrm = rsqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
    __syncwarp();  // every lane has read the old quaternion
    if (lane < NJ) {
        float vj = qn[lane];
        qpos[7 + lane] = qpos[7 + lane] + dt * vj;
        qvel[6 + lane] = vj;
    } else if (lane < HGT_NV) {
        int c = lane - NJ;
        if (c < 3) qpos[c] = qpos[c] + dt * qn[lane];
        qvel[c] = qn[lane];
    } else if (lane == HGT_NV) {
        qpos[3] = nw * qnrm; qpos[4] = nx * qnrm; qpos[5] = ny * qnrm; qpos[6] = nz * qnrm;
    }
    __syncwarp();
}

template <bool TERRAIN>
__global__ void __launch_bounds__(MG_WARPS * 32, MG_MIN_BLOCKS)
hgt_mega_kernel(const float* __restrict__ in, float* __restrict__ out, int n, float dt,
                int decimation, int iterations, float max_depen_vel,
                const float* __restrict__ in2, MgTerrain terr, const float* __restrict__ model) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    load_header(smem, model);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * MG_WARPS + warp;
    if (e >= n) return;  // whole warps leave; no block-wide barrier follows
    const float* cm = smem;
    const unsigned char* pairs = reinterpret_cast<const unsigned char*>(smem + 544);
    float* sm = smem + MG_HEAD_FLOATS + warp * (TERRAIN ? MG_WARP_FLOATS_T : MG_WARP_FLOATS);

    const float* ip = in + (size_t)e * IN_ROWS;
    for (int i = lane; i < IN_ROWS; i += 32) sm[MG_S + i] = ip[i];
    if constexpr (TERRAIN) {
        // the IN2 row as it is, then the slope of point `lane` as its frame
        float* tr = sm + MG_T;
        const float* ip2 = in2 + (size_t)e * IN2_ROWS;
        for (int i = lane; i < IN2_ROWS; i += 32) tr[i] = ip2[i];
        __syncwarp();
        float gx = 0.0f, gy = 0.0f;
        if (lane < HGT_NP) {
            gx = tr[IN2_GX + lane];
            gy = tr[IN2_GY + lane];
        }
        __syncwarp();  // every slope is read before the frames overwrite it
        if (lane < HGT_NP) {
            float n_inv = rsqrtf(gx * gx + gy * gy + 1.0f);
            float nx = -gx * n_inv, ny = -gy * n_inv, nz = n_inv;
            float t1_inv = rsqrtf(nz * nz + nx * nx);
            float* fr = tr + MG_T_FR + lane;
            fr[0] = nx;
            fr[HGT_NP] = ny;
            fr[2 * HGT_NP] = nz;
            fr[3 * HGT_NP] = nz * t1_inv;
            fr[4 * HGT_NP] = -nx * t1_inv;
        }
    }
    if (lane < NJ) sm[MG_TAU + lane] = 0.0f;
    for (int t = lane; t < NJ * 3; t += 32) {  // jrot_j * axis_j
        int j = t / 3, r = t - 3 * j;
        const float* jr = cm + C_JROT + 9 * j + 3 * r;
        const float* ax = cm + C_JAXIS + 3 * j;
        sm[MG_ALOC + t] = jr[0] * ax[0] + jr[1] * ax[1] + jr[2] * ax[2];
    }
    __syncwarp();
    // impulses of rows lane and lane + 32, physical signs, carried in registers
    float lam0 = sm[MG_S + IN_LAM + lane];
    float lam1 = lane + 32 < HGT_NR ? sm[MG_S + IN_LAM + lane + 32] : 0.0f;

    for (int s = 0; s < decimation; ++s)
        substep<TERRAIN>(sm, cm, pairs, lane, lam0, lam1, dt, iterations, max_depen_vel, terr);

    // ---- end-of-step feet/knee kinematics: feet p and knee xy
    // base-relative, feet v_origin world-frame ----
    chain_kin(sm, cm, lane, false);
    float* o = sm + MG_CSS;  // the output row, staged
    for (int i = lane; i < NQ + HGT_NV; i += 32) o[i] = sm[MG_S + i];  // qpos, qvel
    o[OUT_LAM + lane] = lam0;
    if (lane + 32 < HGT_NR) o[OUT_LAM + lane + 32] = lam1;
    if (lane < NJ) o[OUT_TAU + lane] = sm[MG_TAU + lane];
    if (lane < 14) {
        int side = lane & 1, w = lane >> 1;  // fk14: [fLx,fRx, fLy,fRy, fLz,fRz, kLx,kRx, kLy,kRy, vLx,vRx, vLy,vRy]
        int foot = (int)cm[C_FEET + side], knee = (int)cm[C_KNEE + side];
        float v;
        if (w < 3) v = sm[MG_P + 3 * foot + w];
        else if (w < 5) v = sm[MG_P + 3 * knee + (w - 3)];
        else v = sm[MG_VO + 3 * foot + (w - 5)];
        o[OUT_FK + lane] = v;
    }
    if (lane >= 14 && lane < 14 + OUT_ROWS - OUT_FK - 14) o[OUT_FK + lane] = 0.0f;
    __syncwarp();
    // per-foot world-frame impulse sums (contact points are two contiguous
    // runs, one per foot); zero when no substep ran
    if (lane < 6) {
        int foot = lane / 3, c = lane - 3 * foot;
        float acc = 0.0f;
        if constexpr (TERRAIN) {  // lam_t1 t1 + lam_t2 t2 + lam_n n, component c
            for (int k = foot * (HGT_NP / 2); k < (foot + 1) * (HGT_NP / 2); ++k) {
                const float* fr = sm + MG_T + MG_T_FR + k;
                float nx = fr[0], ny = fr[HGT_NP], nz = fr[2 * HGT_NP];
                float t1x = fr[3 * HGT_NP], t1z = fr[4 * HGT_NP];
                float t1c = c == 0 ? t1x : (c == 1 ? 0.0f : t1z);
                float t2c = c == 0 ? ny * t1z : (c == 1 ? nz * t1x - nx * t1z : -ny * t1x);
                float nc = c == 0 ? nx : (c == 1 ? ny : nz);
                const float* l = o + OUT_LAM + 3 * k;
                acc += l[0] * t1c + l[1] * t2c + l[2] * nc;
            }
        } else {
            for (int k = foot * (HGT_NP / 2); k < (foot + 1) * (HGT_NP / 2); ++k)
                acc += o[OUT_LAM + 3 * k + c];
        }
        o[OUT_FF + lane] = decimation > 0 ? acc : 0.0f;
    }
    __syncwarp();
    float* op = out + (size_t)e * OUT_ROWS;
    for (int i = lane; i < OUT_ROWS; i += 32) op[i] = o[i];
}

// The solve's columns read from device memory: Jt (n,18,60) env-major, so
// for each DOF row the lanes read neighbouring addresses.
struct GlobalCols {
    const float* Je;
    const float* tg;
    const float* sg;
    int lane;

    __device__ __forceinline__ void operator()(float (&b0)[HGT_NV], float (&b1)[HGT_NV], float& tg0,
                                               float& tg1, float& s0, float& s1) const {
        const bool v1 = lane + 32 < HGT_NR;
#pragma unroll
        for (int v = 0; v < HGT_NV; ++v) {
            b0[v] = Je[v * HGT_NR + lane];
            b1[v] = v1 ? Je[v * HGT_NR + lane + 32] : 0.0f;
        }
        tg0 = tg[lane];
        s0 = sg[lane];
        tg1 = v1 ? tg[lane + 32] : 0.0f;
        s1 = v1 ? sg[lane + 32] : 1.0f;
    }
};

// Stand-alone launch of the solve stage (operands built outside), for
// holding the solve against its plain version: the very device function
// the mega kernel calls. Env-major float32: Mt (n,18,18), Jt (n,18,60),
// qvel/rhs (n,18), target/sign/lam0 (n,60), mu/comp (n,) ->
// qvel_out (n,18), lam_out (n,60).
__global__ void __launch_bounds__(SV_WARPS * 32, 4)
hgt_solve_kernel(const float* __restrict__ Mt, const float* __restrict__ Jt,
                 const float* __restrict__ qvel, const float* __restrict__ rhs,
                 const float* __restrict__ target, const float* __restrict__ sign,
                 const float* __restrict__ mu, const float* __restrict__ comp,
                 const float* __restrict__ lam0, float* __restrict__ qvel_out,
                 float* __restrict__ lam_out, int n, int iterations) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    unsigned char* pairs = reinterpret_cast<unsigned char*>(smem);
    hgt_fill_pairs(pairs);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * SV_WARPS + warp;
    if (e >= n) return;  // whole warps leave; no block-wide barrier follows
    float* sm = smem + SV_HEAD_FLOATS + warp * SV_WARP_FLOATS;
    const float* Me = Mt + (size_t)e * HGT_NV * HGT_NV;
    for (int idx = lane; idx < HGT_NV * HGT_NV; idx += 32) {
        int i = idx / HGT_NV, a = idx - i * HGT_NV;
        sm[HGT_SM_M + i * HGT_LS + a] = Me[idx];
    }
    __syncwarp();
    const bool dof = lane < HGT_NV, v1 = lane + 32 < HGT_NR;
    float rhs_i = dof ? rhs[(size_t)e * HGT_NV + lane] : 0.0f;
    float qv_i = dof ? qvel[(size_t)e * HGT_NV + lane] : 0.0f;
    const float* l0 = lam0 + (size_t)e * HGT_NR;
    GlobalCols cols{Jt + (size_t)e * HGT_NV * HGT_NR, target + (size_t)e * HGT_NR,
                    sign + (size_t)e * HGT_NR, lane};
    float qn_i, o0, o1;
    hgt_solve_env(sm, sm + HGT_SOLVE_FLOATS, pairs, lane, rhs_i, qv_i, mu[e], comp[e], l0[lane],
                  v1 ? l0[lane + 32] : 0.0f, iterations, cols, qn_i, o0, o1);
    if (dof) qvel_out[(size_t)e * HGT_NV + lane] = qn_i;
    lam_out[(size_t)e * HGT_NR + lane] = o0;
    if (v1) lam_out[(size_t)e * HGT_NR + lane + 32] = o1;
}

// Raise a kernel's dynamic shared memory limit, once per device (the
// attribute is per device).
#define MAX_DEVICES 64
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, bool (&allowed)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool known = dev >= 0 && dev < MAX_DEVICES;
    if (known && allowed[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && known) allowed[dev] = true;
    return err;
}

extern "C" {

int hgt_const_count(void) { return C_TOTAL; }

// model: the (C_TOTAL,) constants of the model this launch steps, on the
// device of in / out.
int hgt_mega_step(const float* in, const float* model, float* out, int n, float dt,
                  int decimation, int iterations, float max_depen_vel, void* stream) {
    if (n <= 0) return 0;
    size_t bytes = sizeof(float) * (MG_HEAD_FLOATS + MG_WARPS * MG_WARP_FLOATS);
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(hgt_mega_kernel<false>, bytes, allowed);
    if (err != cudaSuccess) return (int)err;
    int grid = (n + MG_WARPS - 1) / MG_WARPS;
    hgt_mega_kernel<false><<<grid, MG_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        in, out, n, dt, decimation, iterations, max_depen_vel, nullptr, MgTerrain{}, model);
    return (int)cudaGetLastError();
}

// The terrain variant: in2 (n, IN2_ROWS) env-major beside in (n, IN_ROWS).
int hgt_mega_step_terrain(const float* in, const float* in2, const float* model, float* out,
                          int n, float dt, int decimation, int iterations, float max_depen_vel,
                          float border, float inv_h, float gx_max, float gy_max, void* stream) {
    if (n <= 0) return 0;
    size_t bytes = sizeof(float) * (MG_HEAD_FLOATS + MG_WARPS * MG_WARP_FLOATS_T);
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(hgt_mega_kernel<true>, bytes, allowed);
    if (err != cudaSuccess) return (int)err;
    int grid = (n + MG_WARPS - 1) / MG_WARPS;
    hgt_mega_kernel<true><<<grid, MG_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        in, out, n, dt, decimation, iterations, max_depen_vel, in2,
        MgTerrain{border, inv_h, gx_max, gy_max}, model);
    return (int)cudaGetLastError();
}

int hgt_solve(const float* Mt, const float* Jt, const float* qvel, const float* rhs,
              const float* target, const float* sign, const float* mu, const float* comp,
              const float* lam0, float* qvel_out, float* lam_out, int n, int iterations,
              void* stream) {
    if (n <= 0) return 0;
    size_t bytes = sizeof(float) * (SV_HEAD_FLOATS + SV_WARPS * SV_WARP_FLOATS);
    static bool allowed[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(hgt_solve_kernel, bytes, allowed);
    if (err != cudaSuccess) return (int)err;
    int grid = (n + SV_WARPS - 1) / SV_WARPS;
    hgt_solve_kernel<<<grid, SV_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, qvel_out, lam_out, n, iterations);
    return (int)cudaGetLastError();
}

}  // extern "C"
