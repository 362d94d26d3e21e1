// Whole-policy-step physics for XBot-L: one launch runs all `decimation`
// 1 kHz substeps for every environment, one thread per environment.
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
// What bounds it on the H100: per-environment scalar work, a few thousand
// dependent floating-point operations per substep on ~2 KB of per-env
// state. It is issue- and latency-bound, as on the TPU, and far below both
// the bandwidth roofline (480 B in, 544 B out per env per launch) and the
// FLOP roofline. The design: one thread per env with all state in
// thread-local arrays, the model constants in __constant__ memory (uploaded
// once from the port's RobotModel, read uniformly by every thread), all
// substeps in one launch so the state never round-trips through device
// memory between substeps, and 32-thread blocks so 4096 environments give
// 128 blocks over the 132 SMs. The local arrays (M 18x18, B 18x60) live in
// local memory; moving them to shared memory or registers is later work.
//
// Layouts (env-major, float32): input (N, 120) rows
//   0:19 qpos, 19:37 qvel, 37:49 targets, 49 friction, 50 base-mass scale,
//   51 contact stiffness, 52 contact offset, 53 kp scale, 54 kd scale,
//   55 contact compliance, 56:116 warm-start impulses;
// output (N, 136) rows
//   0:19 qpos, 19:37 qvel, 37:97 lam, 97:109 tau, 109:115 per-foot
//   world-frame impulse sums, 115:129 fk14, 129:136 zero.

#include <cuda_runtime.h>
#include <stdint.h>

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

__constant__ float c_model[C_TOTAL];

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ int parent_of(int b) { return (int)c_model[C_PARENT + b]; }

// FK and the velocity recursion, base-relative (base origin at 0).
// R (NB x 9), p (NB x 3), axw (NJ x 3), om / vo (NB x 3); with_bias also
// fills al / ao (NB x 3) with the bias accelerations (qacc = 0).
__device__ void chain_kin(const float* quat, const float* qj, const float* vlin,
                          const float* omg0, const float* dqj, float (*R)[9],
                          float (*p)[3], float (*axw)[3], float (*om)[3],
                          float (*vo)[3], float (*al)[3], float (*ao)[3],
                          bool with_bias) {
    float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
    float xx = x * x, yy = y * y, zz = z * z;
    float xy = x * y, xz = x * z, yz = y * z;
    float wx = w * x, wy = w * y, wz = w * z;
    R[0][0] = 1 - 2 * (yy + zz); R[0][1] = 2 * (xy - wz); R[0][2] = 2 * (xz + wy);
    R[0][3] = 2 * (xy + wz); R[0][4] = 1 - 2 * (xx + zz); R[0][5] = 2 * (yz - wx);
    R[0][6] = 2 * (xz - wy); R[0][7] = 2 * (yz + wx); R[0][8] = 1 - 2 * (xx + yy);
    for (int c = 0; c < 3; ++c) {
        p[0][c] = 0.0f;
        om[0][c] = omg0[c];
        vo[0][c] = vlin[c];
        if (with_bias) { al[0][c] = 0.0f; ao[0][c] = 0.0f; }
    }
    for (int b = 1; b < NB; ++b) {
        int par = parent_of(b);
        int j = b - 1;
        const float* Rp = R[par];
        const float* jr = &c_model[C_JROT + 9 * j];
        const float* jp = &c_model[C_JPOS + 3 * j];
        const float* ax = &c_model[C_JAXIS + 3 * j];
        float Rj[9];
        for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c)
                Rj[3 * r + c] = Rp[3 * r] * jr[c] + Rp[3 * r + 1] * jr[3 + c] + Rp[3 * r + 2] * jr[6 + c];
        for (int r = 0; r < 3; ++r) {
            p[b][r] = Rp[3 * r] * jp[0] + Rp[3 * r + 1] * jp[1] + Rp[3 * r + 2] * jp[2] + p[par][r];
            axw[j][r] = Rj[3 * r] * ax[0] + Rj[3 * r + 1] * ax[1] + Rj[3 * r + 2] * ax[2];
        }
        // rotation about the (unit) joint axis: I + s K + (1 - c) K^2
        float s = sinf(qj[j]), c = cosf(qj[j]);
        float K[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
        float Rax[9];
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q) {
                float k2 = K[3 * r] * K[q] + K[3 * r + 1] * K[3 + q] + K[3 * r + 2] * K[6 + q];
                Rax[3 * r + q] = (r == q ? 1.0f : 0.0f) + s * K[3 * r + q] + (1.0f - c) * k2;
            }
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                R[b][3 * r + q] = Rj[3 * r] * Rax[q] + Rj[3 * r + 1] * Rax[3 + q] + Rj[3 * r + 2] * Rax[6 + q];
        // velocity / bias recursion (world frame, body origins at pivots)
        float rel[3] = {p[b][0] - p[par][0], p[b][1] - p[par][1], p[b][2] - p[par][2]};
        float wxr[3];
        cross3(om[par], rel, wxr);
        float qd = dqj[j];
        for (int q = 0; q < 3; ++q) {
            om[b][q] = om[par][q] + axw[j][q] * qd;
            vo[b][q] = vo[par][q] + wxr[q];
        }
        if (with_bias) {
            float wxa[3], axr[3], wxwxr[3];
            cross3(om[par], axw[j], wxa);
            cross3(al[par], rel, axr);
            cross3(om[par], wxr, wxwxr);
            for (int q = 0; q < 3; ++q) {
                al[b][q] = al[par][q] + wxa[q] * qd;
                ao[b][q] = ao[par][q] + axr[q] + wxwxr[q];
            }
        }
    }
}

// composite per body, after the subtree sums: F(3) T(3) m s(3) Io(6: xx yy zz xy xz yz)
#define CS 16

// F = momentum of composite cs moved by screw (w_s, v_s); M entry = pair.
__device__ __forceinline__ float screw_pair(const float* cs, const float* wa, const float* va,
                                            const float* wb, const float* vb) {
    // momentum through composite cs of screw b
    const float m = cs[6];
    const float* s = &cs[7];
    const float* I = &cs[10];
    float wxs[3], sxv[3];
    cross3(wb, s, wxs);
    cross3(s, vb, sxv);
    float f[3], t[3];
    for (int q = 0; q < 3; ++q) f[q] = vb[q] * m + wxs[q];
    t[0] = I[0] * wb[0] + I[3] * wb[1] + I[4] * wb[2] + sxv[0];
    t[1] = I[3] * wb[0] + I[1] * wb[1] + I[5] * wb[2] + sxv[1];
    t[2] = I[4] * wb[0] + I[5] * wb[1] + I[2] * wb[2] + sxv[2];
    return dot3(wa, t) + dot3(va, f);
}

__device__ void substep(float* qpos, float* qvel, const float* tgt, float* lam, float* tau,
                        float* ff, float mu, float ms, float cstiff, float coffset, float kps,
                        float kds, float comp, float dt, int iterations, float max_depen_vel) {
    const float* qj = qpos + 7;
    const float* dqj = qvel + 6;
    float inv_dt = 1.0f / dt;

    // ---- PD torques with motor-strength DR ----
    for (int j = 0; j < NJ; ++j) {
        float t = kps * c_model[C_KP + j] * (tgt[j] - qj[j]) - kds * c_model[C_KD + j] * dqj[j];
        float tl = c_model[C_TLIM + j];
        tau[j] = fminf(fmaxf(t, -tl), tl);
    }

    // ---- FK + velocity / bias recursion ----
    float R[NB][9], p[NB][3], axw[NJ][3], om[NB][3], vo[NB][3], al[NB][3], ao[NB][3];
    chain_kin(qpos + 3, qj, qvel, qvel + 3, dqj, R, p, axw, om, vo, al, ao, true);

    // ---- per-body forces and world-origin composite moments ----
    float cs[NB][CS];
    const float* g = &c_model[C_GRAV];
    for (int b = 0; b < NB; ++b) {
        const float* Rb = R[b];
        const float* cb = &c_model[C_COM + 3 * b];
        const float* Ib = &c_model[C_INERTIA + 9 * b];
        float msc = (b == 0) ? ms : 1.0f;
        float mass = c_model[C_MASS + b] * msc;
        float com[3];
        for (int r = 0; r < 3; ++r)
            com[r] = p[b][r] + (Rb[3 * r] * cb[0] + Rb[3 * r + 1] * cb[1] + Rb[3 * r + 2] * cb[2]);
        // world inertia I_w = R I R^T (base scaled by the mass DR)
        float IR[9], Iw[9];
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                IR[3 * r + q] = Rb[3 * r] * Ib[q] + Rb[3 * r + 1] * Ib[3 + q] + Rb[3 * r + 2] * Ib[6 + q];
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                Iw[3 * r + q] = (IR[3 * r] * Rb[3 * q] + IR[3 * r + 1] * Rb[3 * q + 1] + IR[3 * r + 2] * Rb[3 * q + 2]) * msc;
        float rc[3] = {com[0] - p[b][0], com[1] - p[b][1], com[2] - p[b][2]};
        float wxrc[3], axrc[3], wxwxrc[3];
        cross3(om[b], rc, wxrc);
        cross3(al[b], rc, axrc);
        cross3(om[b], wxrc, wxwxrc);
        float f[3];
        for (int q = 0; q < 3; ++q) f[q] = mass * (ao[b][q] + axrc[q] + wxwxrc[q] - g[q]);
        float Iww[3], Ia[3], wxIw[3];
        for (int r = 0; r < 3; ++r) {
            Iww[r] = Iw[3 * r] * om[b][0] + Iw[3 * r + 1] * om[b][1] + Iw[3 * r + 2] * om[b][2];
            Ia[r] = Iw[3 * r] * al[b][0] + Iw[3 * r + 1] * al[b][1] + Iw[3 * r + 2] * al[b][2];
        }
        cross3(om[b], Iww, wxIw);
        float cxf[3];
        cross3(com, f, cxf);
        float* c = cs[b];
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
    // subtree sums: children have larger indices than their parents
    for (int b = NB - 1; b >= 1; --b) {
        int par = parent_of(b);
        for (int q = 0; q < CS; ++q) cs[par][q] += cs[b][q];
    }

    // ---- bias vector h (solver order: joints 0:12, base 12:18) ----
    float h[HGT_NV];
    for (int q = 0; q < 3; ++q) {
        h[NJ + q] = cs[0][q];
        h[NJ + 3 + q] = cs[0][3 + q];
    }
    for (int j = 0; j < NJ; ++j) {
        const float* c = cs[j + 1];
        float pxf[3];
        cross3(p[j + 1], c, pxf);
        float tt[3] = {c[3] - pxf[0], c[4] - pxf[1], c[5] - pxf[2]};
        h[j] = dot3(axw[j], tt);
    }

    // ---- mass matrix through composite screws (cross-leg blocks stay 0) ----
    float M[HGT_NV][HGT_NV];
    for (int a = 0; a < HGT_NV; ++a)
        for (int b = 0; b < HGT_NV; ++b) M[a][b] = 0.0f;
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    float e3[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    // base screws: translation (0, e_c), rotation about the base origin (e_c, 0)
    for (int c2 = 0; c2 < 6; ++c2) {
        const float* w2 = c2 < 3 ? zero3 : e3[c2 - 3];
        const float* v2 = c2 < 3 ? e3[c2] : zero3;
        for (int c1 = 0; c1 <= c2; ++c1) {
            const float* w1 = c1 < 3 ? zero3 : e3[c1 - 3];
            const float* v1 = c1 < 3 ? e3[c1] : zero3;
            float v = screw_pair(cs[0], w1, v1, w2, v2);
            M[NJ + c1][NJ + c2] = v;
            M[NJ + c2][NJ + c1] = v;
        }
    }
    float sv[NJ][3];  // joint screw linear parts: p_j x a_j
    for (int j = 0; j < NJ; ++j) cross3(p[j + 1], axw[j], sv[j]);
    for (int j = 0; j < NJ; ++j) {
        const float* cj = cs[j + 1];
        for (int c = 0; c < 6; ++c) {
            const float* w1 = c < 3 ? zero3 : e3[c - 3];
            const float* v1 = c < 3 ? e3[c] : zero3;
            float v = screw_pair(cj, w1, v1, axw[j], sv[j]);
            M[NJ + c][j] = v;
            M[j][NJ + c] = v;
        }
        // ancestor joints of body j+1, itself included
        for (int b = j + 1; b != 0; b = parent_of(b)) {
            int a = b - 1;
            float v = screw_pair(cj, axw[a], sv[a], axw[j], sv[j]);
            if (a == j) {
                v = v + (dt * c_model[C_KD + j]) * kds + (c_model[C_ARM + j] + dt * c_model[C_JDAMP + j]);
                M[j][j] = v;
            } else {
                M[a][j] = v;
                M[j][a] = v;
            }
        }
    }

    // ---- contact rows (flat ground, identity frames) and J^T ----
    float B[HGT_NV][HGT_NR];
    float target[HGT_NR], sign[HGT_NR];
    for (int v = 0; v < HGT_NV; ++v)
        for (int r = 0; r < HGT_NR; ++r) B[v][r] = 0.0f;
    float bmg = 0.2f * cstiff;
    for (int k = 0; k < HGT_NP; ++k) {
        int fb = (int)c_model[C_CBODY + k];
        const float* o = &c_model[C_COFF + 3 * k];
        const float* Rf = R[fb];
        float X[3];
        for (int r = 0; r < 3; ++r)
            X[r] = Rf[3 * r] * o[0] + Rf[3 * r + 1] * o[1] + Rf[3 * r + 2] * o[2] + p[fb][r];
        float phi = X[2] + qpos[2];
        float b_pen = fminf(bmg * (-phi) * inv_dt, max_depen_vel);
        float b_gap = -phi * inv_dt;
        float lo = phi <= 0.0f ? b_pen : b_gap;
        if (phi > coffset) lo = -1e9f;
        target[3 * k] = 0.0f;
        target[3 * k + 1] = 0.0f;
        target[3 * k + 2] = lo;
        for (int i = 0; i < 3; ++i) {
            sign[3 * k + i] = 1.0f;
            B[NJ + i][3 * k + i] = 1.0f;  // base translation
        }
        // base rotation: e_c x X
        B[NJ + 3][3 * k + 1] = -X[2]; B[NJ + 3][3 * k + 2] = X[1];
        B[NJ + 4][3 * k + 0] = X[2];  B[NJ + 4][3 * k + 2] = -X[0];
        B[NJ + 5][3 * k + 0] = -X[1]; B[NJ + 5][3 * k + 1] = X[0];
        // ancestor joints of the foot body: a_j x (X - pivot_j)
        for (int b = fb; b != 0; b = parent_of(b)) {
            int j = b - 1;
            float rx[3] = {X[0] - p[b][0], X[1] - p[b][1], X[2] - p[b][2]};
            float col[3];
            cross3(axw[j], rx, col);
            for (int i = 0; i < 3; ++i) B[j][3 * k + i] = col[i];
        }
    }
    // ---- joint-limit rows ----
    for (int j = 0; j < NJ; ++j) {
        float low = c_model[C_LOW + j], up = c_model[C_UP + j];
        bool near_lower = qj[j] < 0.5f * (low + up);
        float viol = near_lower ? low - qj[j] : qj[j] - up;
        float lb_pen = fminf(0.2f * viol * inv_dt, 2.0f);
        float bb = viol >= 0.0f ? lb_pen : viol * inv_dt;
        if (viol < -0.05f) bb = -1e9f;
        B[j][HGT_NC + j] = 1.0f;
        sign[HGT_NC + j] = near_lower ? 1.0f : -1.0f;
        target[HGT_NC + j] = bb;
    }

    // ---- rhs = dt (S tau + tau_fric - h), velocities, solver order ----
    float rhs[HGT_NV], qv[HGT_NV];
    for (int j = 0; j < NJ; ++j) {
        float tf = -c_model[C_JFRIC + j] * tanhf(dqj[j] / 0.05f) - c_model[C_JDAMP + j] * dqj[j];
        rhs[j] = dt * (tau[j] + tf - h[j]);
        qv[j] = dqj[j];
    }
    for (int c = 0; c < 6; ++c) {
        rhs[NJ + c] = (-dt) * h[NJ + c];
        qv[NJ + c] = qvel[c];
    }

    float qn[HGT_NV], lam_new[HGT_NR];
    hgt_solve_env(M, B, qv, rhs, target, sign, mu, comp, lam, iterations, qn, lam_new);

    // ---- velocity limits + semi-implicit integration ----
    float vj[NJ];
    for (int j = 0; j < NJ; ++j) {
        float vl = c_model[C_VLIM + j];
        vj[j] = fminf(fmaxf(qn[j], -vl), vl);
    }
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
    for (int c = 0; c < 3; ++c) qpos[c] = qpos[c] + dt * qn[NJ + c];
    qpos[3] = nw * qnrm; qpos[4] = nx * qnrm; qpos[5] = ny * qnrm; qpos[6] = nz * qnrm;
    for (int j = 0; j < NJ; ++j) qpos[7 + j] = qpos[7 + j] + dt * vj[j];
    for (int c = 0; c < 6; ++c) qvel[c] = qn[NJ + c];
    for (int j = 0; j < NJ; ++j) qvel[6 + j] = vj[j];
    for (int r = 0; r < HGT_NR; ++r) lam[r] = lam_new[r];

    // ---- per-foot world-frame impulse sums (contact points are two
    // contiguous runs, one per foot) ----
    for (int q = 0; q < 6; ++q) ff[q] = 0.0f;
    for (int k = 0; k < HGT_NP; ++k) {
        int foot = k < HGT_NP / 2 ? 0 : 1;
        for (int c = 0; c < 3; ++c) ff[3 * foot + c] += lam[3 * k + c];
    }
}

__global__ void __launch_bounds__(32)
hgt_mega_kernel(const float* __restrict__ in, float* __restrict__ out, int n, float dt,
                int decimation, int iterations, float max_depen_vel) {
    int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const float* ip = in + (size_t)e * IN_ROWS;
    float qpos[NQ], qvel[HGT_NV], tgt[NJ], lam[HGT_NR], tau[NJ], ff[6];
    for (int i = 0; i < NQ; ++i) qpos[i] = ip[IN_QPOS + i];
    for (int i = 0; i < HGT_NV; ++i) qvel[i] = ip[IN_QVEL + i];
    for (int i = 0; i < NJ; ++i) { tgt[i] = ip[IN_TGT + i]; tau[i] = 0.0f; }
    for (int i = 0; i < HGT_NR; ++i) lam[i] = ip[IN_LAM + i];
    for (int i = 0; i < 6; ++i) ff[i] = 0.0f;
    float mu = ip[IN_FRIC], ms = ip[IN_MS], cstiff = ip[IN_CSTIFF], coffset = ip[IN_COFF];
    float kps = ip[IN_KPS], kds = ip[IN_KDS], comp = ip[IN_COMP];

    for (int s = 0; s < decimation; ++s)
        substep(qpos, qvel, tgt, lam, tau, ff, mu, ms, cstiff, coffset, kps, kds, comp, dt,
                iterations, max_depen_vel);

    // ---- end-of-step feet/knee kinematics: feet p and knee xy
    // base-relative, feet v_origin world-frame ----
    float R[NB][9], p[NB][3], axw[NJ][3], om[NB][3], vo[NB][3];
    chain_kin(qpos + 3, qpos + 7, qvel, qvel + 3, qvel + 6, R, p, axw, om, vo, nullptr, nullptr,
              false);
    int fl = (int)c_model[C_FEET], fr = (int)c_model[C_FEET + 1];
    int kl = (int)c_model[C_KNEE], kr = (int)c_model[C_KNEE + 1];
    float* op = out + (size_t)e * OUT_ROWS;
    for (int i = 0; i < NQ; ++i) op[OUT_QPOS + i] = qpos[i];
    for (int i = 0; i < HGT_NV; ++i) op[OUT_QVEL + i] = qvel[i];
    for (int i = 0; i < HGT_NR; ++i) op[OUT_LAM + i] = lam[i];
    for (int i = 0; i < NJ; ++i) op[OUT_TAU + i] = tau[i];
    for (int i = 0; i < 6; ++i) op[OUT_FF + i] = ff[i];
    float fk[14] = {p[fl][0], p[fr][0], p[fl][1], p[fr][1], p[fl][2], p[fr][2],
                    p[kl][0], p[kr][0], p[kl][1], p[kr][1],
                    vo[fl][0], vo[fr][0], vo[fl][1], vo[fr][1]};
    for (int i = 0; i < 14; ++i) op[OUT_FK + i] = fk[i];
    for (int i = OUT_FK + 14; i < OUT_ROWS; ++i) op[i] = 0.0f;
}

// Stand-alone launch of the solve stage (operands built outside), for
// holding the solve against its plain version. Env-major float32:
// Mt (n,18,18), Jt (n,18,60), qvel/rhs (n,18), target/sign/lam0 (n,60),
// mu/comp (n,) -> qvel_out (n,18), lam_out (n,60).
__global__ void __launch_bounds__(32)
hgt_solve_kernel(const float* __restrict__ Mt, const float* __restrict__ Jt,
                 const float* __restrict__ qvel, const float* __restrict__ rhs,
                 const float* __restrict__ target, const float* __restrict__ sign,
                 const float* __restrict__ mu, const float* __restrict__ comp,
                 const float* __restrict__ lam0, float* __restrict__ qvel_out,
                 float* __restrict__ lam_out, int n, int iterations) {
    int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    float M[HGT_NV][HGT_NV], B[HGT_NV][HGT_NR];
    float qv[HGT_NV], rh[HGT_NV], tg[HGT_NR], sg[HGT_NR], l0[HGT_NR];
    const float* Me = Mt + (size_t)e * HGT_NV * HGT_NV;
    const float* Je = Jt + (size_t)e * HGT_NV * HGT_NR;
    for (int a = 0; a < HGT_NV; ++a)
        for (int b = 0; b < HGT_NV; ++b) M[a][b] = Me[a * HGT_NV + b];
    for (int a = 0; a < HGT_NV; ++a)
        for (int r = 0; r < HGT_NR; ++r) B[a][r] = Je[a * HGT_NR + r];
    for (int a = 0; a < HGT_NV; ++a) {
        qv[a] = qvel[(size_t)e * HGT_NV + a];
        rh[a] = rhs[(size_t)e * HGT_NV + a];
    }
    for (int r = 0; r < HGT_NR; ++r) {
        tg[r] = target[(size_t)e * HGT_NR + r];
        sg[r] = sign[(size_t)e * HGT_NR + r];
        l0[r] = lam0[(size_t)e * HGT_NR + r];
    }
    float qn[HGT_NV], lam[HGT_NR];
    hgt_solve_env(M, B, qv, rh, tg, sg, mu[e], comp[e], l0, iterations, qn, lam);
    for (int a = 0; a < HGT_NV; ++a) qvel_out[(size_t)e * HGT_NV + a] = qn[a];
    for (int r = 0; r < HGT_NR; ++r) lam_out[(size_t)e * HGT_NR + r] = lam[r];
}

#define HGT_BLOCK 32

extern "C" {

int hgt_set_model(const float* host_consts, int count) {
    if (count != C_TOTAL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemcpyToSymbol(c_model, host_consts, sizeof(float) * C_TOTAL);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

int hgt_const_count(void) { return C_TOTAL; }

int hgt_mega_step(const float* in, float* out, int n, float dt, int decimation,
                  int iterations, float max_depen_vel, void* stream) {
    if (n <= 0) return 0;
    int grid = (n + HGT_BLOCK - 1) / HGT_BLOCK;
    hgt_mega_kernel<<<grid, HGT_BLOCK, 0, (cudaStream_t)stream>>>(
        in, out, n, dt, decimation, iterations, max_depen_vel);
    return (int)cudaGetLastError();
}

int hgt_solve(const float* Mt, const float* Jt, const float* qvel, const float* rhs,
              const float* target, const float* sign, const float* mu, const float* comp,
              const float* lam0, float* qvel_out, float* lam_out, int n, int iterations,
              void* stream) {
    if (n <= 0) return 0;
    int grid = (n + HGT_BLOCK - 1) / HGT_BLOCK;
    hgt_solve_kernel<<<grid, HGT_BLOCK, 0, (cudaStream_t)stream>>>(
        Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, qvel_out, lam_out, n, iterations);
    return (int)cudaGetLastError();
}

}  // extern "C"
