// The env step's reward stage in one launch: every reward term the env's
// config keeps, the episode sums, the reward with its only-positive clip
// and termination term, and the feet state the stateful terms carry.
//
// Replaces no Pallas kernel: the TPU package computes the rewards with XLA
// (humanoid_gym_tpu/envs/env.py, envs/rewards.py), and the port's plain
// version is envs/rewards.py `make_rewards(...).plain`, about 220 small
// PyTorch operations a step: the gait phase and stance mask, the feet
// kinematics from the mega kernel's FK rows, a RewardCtx, the 22 XBot-L
// terms stacked, masked, scaled and summed, and `feet_state_update`. This
// kernel computes the same values, term by term as envs/rewards.py writes
// them:
//   the phase len * dt * (1 / cycle_time) (a PyTorch division by a Python
//   number on the card is a multiply by the float32 reciprocal) and
//   sin(6.2831855 * phase); the stance mask from its sign, both feet where
//   |sin| < 0.1;
//   the 26 terms of REWARD_FUNCTIONS (`enum Term`, in that order); a term
//   whose column is -1 is left out of the sums; where the step's state is
//   not finite every term is 0;
//   episode_sums + term * (scale * dt), their sum, clamped at 0 when the
//   config clips, plus termination_scale * dt where done and not time_out;
//   feet_air_time, last_contacts, feet_height and last_feet_z of
//   FeetStateUpdate, masked as the env masks them, and the raw contact
//   flags the observations read.
//
// What bounds it on the H100: per env about 0.7 KB in (the 12-joint rows of
// the state, the base quantities, the FK rows, the feet's contact forces and
// the carried feet state) and 0.12 KB out, about 720 float32 operations
// with 13 expf, 11 sqrtf and a sinf (utils/roofline.py rewards_bytes,
// rewards_ops). Bytes bound it (1.0 us at 4,096 envs), and at that size the
// launch and the latency of one pass. The design keeps it one short pass
// with enough loads in flight: RW_LANES threads an env, the joint-vector
// sums split over the lanes (joint j on lane j % RW_LANES) and summed by xor
// shuffles, so that every lane holds every sum; the scalar terms computed
// alike by every lane of the env from the same (broadcast) loads;
// episode-sum column c written by lane c % RW_LANES. Every lane runs every
// shuffle: a lane past the last env works on the last env and writes
// nothing. 16 lanes an env ran 8.2 us a launch at 4,096 envs and 7.4 at
// 2,048 on the H100, against 8.9 / 9.0 for a thread an env, 8.2 / 8.0 for
// 8 lanes and 12.9 / 8.3 for 32 (CUDA-graph timing).
//
// Arithmetic: float32 with the accurate expf, sqrtf and sinf (no fast-math).
// A norm is the square root of the sum of squares, as torch.linalg.norm
// takes it. Where a term compares (the stance mask, feet_clearance's 0.01
// band, low_speed, the contact and air-time flags) its operands are rounded
// as the plain version rounds them on the card, so the flags agree bit for
// bit; the continuous values may differ from the plain version's by the
// order of a sum and contracted multiply-adds, a few ulp.
//
// Inputs may be row-strided views with unit column stride (the env passes
// qpos[:, 7:]'s parent qpos, the FK rows of the mega kernel's output); the
// outputs are fresh contiguous arrays.

#include <cuda_runtime.h>
#include <stdint.h>

// REWARD_FUNCTIONS' order (envs/rewards.py KERNEL_TERMS)
enum Term {
    T_JOINT_POS,
    T_FEET_CLEARANCE,
    T_FEET_CONTACT_NUMBER,
    T_FEET_AIR_TIME,
    T_FOOT_SLIP,
    T_FEET_DISTANCE,
    T_KNEE_DISTANCE,
    T_FEET_CONTACT_FORCES,
    T_TRACKING_LIN_VEL,
    T_TRACKING_ANG_VEL,
    T_VEL_MISMATCH_EXP,
    T_LOW_SPEED,
    T_TRACK_VEL_HARD,
    T_DEFAULT_JOINT_POS,
    T_ORIENTATION,
    T_BASE_HEIGHT,
    T_BASE_ACC,
    T_ACTION_SMOOTHNESS,
    T_TORQUES,
    T_DOF_VEL,
    T_DOF_ACC,
    T_COLLISION,
    T_LIN_VEL_Z,
    T_ANG_VEL_XY,
    T_ACTION_RATE,
    T_STAND_STILL,
    N_TERMS
};

// the pointer slots of `ptrs` / `strides` (envs/rewards.py SLOTS); a stride
// is a row stride in elements, 0 for a (N,) array
enum Slot {
    S_EPISODE_LENGTH,     // int32 (N,)
    S_QPOS,               // (N, >= 7 + nj): root z at 2, joints at 7
    S_QVEL,               // (N, >= 6 + nj): root velocity at 0-5, joints at 6
    S_LAST_DOF_VEL,       // (N, nj)
    S_ACTIONS,            // (N, nj)
    S_LAST_ACTIONS,       // (N, nj)
    S_LAST_LAST_ACTIONS,  // (N, nj)
    S_TORQUES,            // (N, nj)
    S_REF_DOF_POS,        // (N, nj)
    S_BASE_LIN_VEL,       // (N, 3)
    S_BASE_ANG_VEL,       // (N, 3)
    S_BASE_EULER,         // (N, 3)
    S_PROJECTED_GRAVITY,  // (N, 3)
    S_COMMANDS,           // (N, 4)
    S_LAST_ROOT_VEL,      // (N, 6)
    S_FEET_ROWS,          // (N, 14): x, y, z of both feet, knee x, y, feet vx, vy
    S_CONTACT_FORCES,     // (N, nbody, 3), the bodies packed
    S_COLLISION_FLAGS,    // bool (N, n_pen)
    S_FEET_AIR_TIME,      // (N, 2)
    S_LAST_CONTACTS,      // bool (N, 2)
    S_FEET_HEIGHT,        // (N, 2)
    S_LAST_FEET_Z,        // (N, 2)
    S_EPISODE_SUMS,       // (N, n_terms)
    S_FINITE,             // bool (N,)
    S_DONE,               // bool (N,)
    S_TIME_OUT,           // bool (N,)
    S_DEFAULT_DOF_POS,    // (nj,)
    // outputs, contiguous
    S_OUT_REWARD,         // (N,)
    S_OUT_EPISODE_SUMS,   // (N, n_terms)
    S_OUT_FEET_AIR_TIME,  // (N, 2)
    S_OUT_LAST_CONTACTS,  // bool (N, 2)
    S_OUT_FEET_HEIGHT,    // (N, 2)
    S_OUT_LAST_FEET_Z,    // (N, 2)
    S_OUT_CONTACT,        // bool (N, 2)
    N_SLOTS
};

// the float parameters `fparams` (envs/rewards.py FPARAMS), then N_TERMS scales
enum FParam {
    F_DT,
    F_INV_DT,
    F_INV_CYCLE_TIME,
    F_TARGET_FEET_HEIGHT,
    F_BASE_HEIGHT_TARGET,
    F_MIN_DIST,
    F_MAX_DIST,
    F_HALF_MAX_DIST,
    F_TRACKING_SIGMA,
    F_MAX_CONTACT_FORCE,
    F_SOLE_OFFSET,
    F_TERMINATION_SCALE,
    N_FPARAMS
};

// the int parameters `iparams` (envs/rewards.py IPARAMS), then N_TERMS columns
enum IParam {
    I_NJ,
    I_N_PEN,
    I_N_COLS,
    I_FOOT_BODY_0,
    I_FOOT_BODY_1,
    I_FEET_BASE,      // 1: the feet rows are base-relative (the mega kernel's FK rows)
    I_ONLY_POSITIVE,
    N_IPARAMS
};

#define RW_LANES 16     // threads an env
#define RW_THREADS 128  // threads a block: 8 envs

struct RewardArgs {
    const void* p[N_SLOTS];
    int s[N_SLOTS];
    float f[N_FPARAMS];
    float scale[N_TERMS];
    int i[N_IPARAMS];
    int col[N_TERMS];
    int n;
};

template <typename T>
__device__ __forceinline__ const T* row(const RewardArgs& a, int slot, int env) {
    return static_cast<const T*>(a.p[slot]) + (size_t)env * a.s[slot];
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// (exp(-|clamp(d - min, -0.5, 0)| 100) + exp(-|clamp(d - max, 0, 0.5)| 100)) / 2
__device__ __forceinline__ float pair_distance(float dist, float min_d, float max_d) {
    const float d_min = clampf(dist - min_d, -0.5f, 0.f);
    const float d_max = clampf(dist - max_d, 0.f, 0.5f);
    return (expf(-fabsf(d_min) * 100.f) + expf(-fabsf(d_max) * 100.f)) * 0.5f;
}

// torch.sign
__device__ __forceinline__ float signf(float x) {
    return (float)(0.f < x) - (float)(x < 0.f);
}

// the sum of x over the env's RW_LANES lanes, on every one of them
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
    for (int o = RW_LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, RW_LANES);
    return x;
}

__global__ void __launch_bounds__(RW_THREADS) hgt_rewards_kernel(const RewardArgs a) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = t % RW_LANES;
    const bool live = t / RW_LANES < a.n;
    const int e = live ? t / RW_LANES : a.n - 1;
    const int nj = a.i[I_NJ];
    const float dt = a.f[F_DT];

    const float* q = row<float>(a, S_QPOS, e);
    const float* qv = row<float>(a, S_QVEL, e);

    // ---- the joint-vector sums, joint j on lane j % RW_LANES ----
    float s_ref = 0.f, s_def = 0.f, s_def_abs = 0.f, s_tau = 0.f, s_vel = 0.f, s_acc = 0.f;
    float s_rate = 0.f, s_smooth = 0.f, s_act_abs = 0.f;
    {
        const float* ldv = row<float>(a, S_LAST_DOF_VEL, e);
        const float* act = row<float>(a, S_ACTIONS, e);
        const float* la = row<float>(a, S_LAST_ACTIONS, e);
        const float* lla = row<float>(a, S_LAST_LAST_ACTIONS, e);
        const float* tau = row<float>(a, S_TORQUES, e);
        const float* ref = row<float>(a, S_REF_DOF_POS, e);
        const float* dflt = static_cast<const float*>(a.p[S_DEFAULT_DOF_POS]);
        const float inv_dt = a.f[F_INV_DT];
        for (int j = lane; j < nj; j += RW_LANES) {
            const float pos = q[7 + j], vel = qv[6 + j];
            const float d_ref = pos - ref[j], d_def = pos - dflt[j];
            const float acc = (ldv[j] - vel) * inv_dt;
            const float ac = act[j], l1 = la[j], l2 = lla[j];
            const float rate = l1 - ac, smooth = (ac + l2) - 2.f * l1;
            const float tq = tau[j];
            s_ref += d_ref * d_ref;
            s_def += d_def * d_def;
            s_def_abs += fabsf(d_def);
            s_tau += tq * tq;
            s_vel += vel * vel;
            s_acc += acc * acc;
            s_rate += rate * rate;
            s_smooth += smooth * smooth;
            s_act_abs += fabsf(ac);
        }
        s_ref = lane_sum(s_ref);
        s_def = lane_sum(s_def);
        s_def_abs = lane_sum(s_def_abs);
        s_tau = lane_sum(s_tau);
        s_vel = lane_sum(s_vel);
        s_acc = lane_sum(s_acc);
        s_rate = lane_sum(s_rate);
        s_smooth = lane_sum(s_smooth);
        s_act_abs = lane_sum(s_act_abs);
    }

    // ---- the gait phase and the stance mask (env.py _gait_phase, _stance_mask) ----
    const int len = *row<int>(a, S_EPISODE_LENGTH, e);
    const float phase = __fmul_rn(__fmul_rn((float)len, dt), a.f[F_INV_CYCLE_TIME]);
    const float sin_pos = sinf(__fmul_rn(6.2831855f, phase));
    const bool both = fabsf(sin_pos) < 0.1f;
    const float stance[2] = {both || sin_pos >= 0.f ? 1.f : 0.f, both || sin_pos < 0.f ? 1.f : 0.f};

    // ---- the feet: FK rows (base-relative when I_FEET_BASE), forces, carried state ----
    const float* fr = row<float>(a, S_FEET_ROWS, e);
    const bool based = a.i[I_FEET_BASE] != 0;
    const float bx = based ? q[0] : 0.f, by = based ? q[1] : 0.f, bz = based ? q[2] : 0.f;
    const float* cf = row<float>(a, S_CONTACT_FORCES, e);
    const unsigned char* lc_in = row<unsigned char>(a, S_LAST_CONTACTS, e);
    const float* fat_in = row<float>(a, S_FEET_AIR_TIME, e);
    const float* fh_in = row<float>(a, S_FEET_HEIGHT, e);
    const float* lfz_in = row<float>(a, S_LAST_FEET_Z, e);
    float fx[2], fy[2], fz[2], kx[2], ky[2], fvx[2], fvy[2], force[2], sole_z[2], fh[2];
    bool contact[2], filt[2];
    const float sole = a.f[F_SOLE_OFFSET];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        fx[k] = based ? fr[k] + bx : fr[k];
        fy[k] = based ? fr[2 + k] + by : fr[2 + k];
        fz[k] = based ? fr[4 + k] + bz : fr[4 + k];
        kx[k] = based ? fr[6 + k] + bx : fr[6 + k];
        ky[k] = based ? fr[8 + k] + by : fr[8 + k];
        fvx[k] = fr[10 + k];
        fvy[k] = fr[12 + k];
        const float* f3 = cf + 3 * a.i[I_FOOT_BODY_0 + k];
        force[k] = sqrtf(f3[0] * f3[0] + f3[1] * f3[1] + f3[2] * f3[2]);
        contact[k] = f3[2] > 5.f;
        filt[k] = contact[k] || stance[k] > 0.5f || lc_in[k] != 0;
        sole_z[k] = fz[k] - sole;
        fh[k] = fh_in[k] + (sole_z[k] - lfz_in[k]);
    }

    const float* blv = row<float>(a, S_BASE_LIN_VEL, e);
    const float* bav = row<float>(a, S_BASE_ANG_VEL, e);
    const float* eul = row<float>(a, S_BASE_EULER, e);
    const float* grav = row<float>(a, S_PROJECTED_GRAVITY, e);
    const float* cmd = row<float>(a, S_COMMANDS, e);
    const float* lrv = row<float>(a, S_LAST_ROOT_VEL, e);
    const float sigma = a.f[F_TRACKING_SIGMA];

    // ---- the terms (envs/rewards.py, each as its function there) ----
    float term[N_TERMS];
    {
        const float d = sqrtf(s_ref);
        term[T_JOINT_POS] = expf(-2.f * d) - 0.2f * clampf(d, 0.f, 0.5f);
    }
    {
        const float target = a.f[F_TARGET_FEET_HEIGHT];
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k)
            r += (fabsf(fh[k] - target) < 0.01f ? 1.f : 0.f) * (1.f - stance[k]);
        term[T_FEET_CLEARANCE] = r;
    }
    {
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) r += contact[k] == (stance[k] > 0.5f) ? 1.f : -0.3f;
        term[T_FEET_CONTACT_NUMBER] = r * 0.5f;
    }
    {
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k)
            r += clampf(fat_in[k] + dt, 0.f, 0.5f) * (fat_in[k] > 0.f && filt[k] ? 1.f : 0.f);
        term[T_FEET_AIR_TIME] = r;
    }
    {
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k)
            r += sqrtf(sqrtf(fvx[k] * fvx[k] + fvy[k] * fvy[k])) * (contact[k] ? 1.f : 0.f);
        term[T_FOOT_SLIP] = r;
    }
    {
        const float dx = fx[0] - fx[1], dy = fy[0] - fy[1];
        term[T_FEET_DISTANCE] = pair_distance(sqrtf(dx * dx + dy * dy), a.f[F_MIN_DIST],
                                              a.f[F_MAX_DIST]);
        const float kdx = kx[0] - kx[1], kdy = ky[0] - ky[1];
        term[T_KNEE_DISTANCE] = pair_distance(sqrtf(kdx * kdx + kdy * kdy), a.f[F_MIN_DIST],
                                              a.f[F_HALF_MAX_DIST]);
    }
    {
        const float fmax = a.f[F_MAX_CONTACT_FORCE];
        term[T_FEET_CONTACT_FORCES] =
            clampf(force[0] - fmax, 0.f, 400.f) + clampf(force[1] - fmax, 0.f, 400.f);
    }
    const float ex = cmd[0] - blv[0], ey = cmd[1] - blv[1];
    const float ang_err = fabsf(cmd[2] - bav[2]);
    term[T_TRACKING_LIN_VEL] = expf(-(ex * ex + ey * ey) * sigma);
    {
        const float ez = cmd[2] - bav[2];
        term[T_TRACKING_ANG_VEL] = expf(-(ez * ez) * sigma);
    }
    {
        const float lin = expf(-(blv[2] * blv[2]) * 10.f);
        const float ang = expf(-sqrtf(bav[0] * bav[0] + bav[1] * bav[1]) * 5.f);
        term[T_VEL_MISMATCH_EXP] = (lin + ang) * 0.5f;
    }
    {
        const float v = blv[0], c = cmd[0];
        const float av = fabsf(v), ac = fabsf(c);
        const bool too_low = av < 0.5f * ac, too_high = av > 1.2f * ac;
        float r = too_low ? -1.f : 0.f;
        if (too_high) r = 0.f;
        if (!(too_low || too_high)) r = 1.2f;
        if (signf(v) != signf(c)) r = -2.f;
        term[T_LOW_SPEED] = r * (ac > 0.1f ? 1.f : 0.f);
    }
    {
        const float lin_err = sqrtf(ex * ex + ey * ey);
        term[T_TRACK_VEL_HARD] = (expf(-lin_err * 10.f) + expf(-ang_err * 10.f)) * 0.5f -
                                 0.2f * (lin_err + ang_err);
    }
    {
        const float* dflt = static_cast<const float*>(a.p[S_DEFAULT_DOF_POS]);
        const float d0 = q[7] - dflt[0], d1 = q[8] - dflt[1];
        const float d6 = q[13] - dflt[6], d7 = q[14] - dflt[7];
        const float yaw_roll =
            clampf(sqrtf(d0 * d0 + d1 * d1) + sqrtf(d6 * d6 + d7 * d7) - 0.1f, 0.f, 50.f);
        term[T_DEFAULT_JOINT_POS] = expf(-yaw_roll * 100.f) - 0.01f * sqrtf(s_def);
    }
    {
        const float quat_mismatch = expf(-(fabsf(eul[0]) + fabsf(eul[1])) * 10.f);
        const float g = expf(-sqrtf(grav[0] * grav[0] + grav[1] * grav[1]) * 20.f);
        term[T_ORIENTATION] = (quat_mismatch + g) * 0.5f;
    }
    {
        const float mean_z = (fz[0] * stance[0] + fz[1] * stance[1]) /
                             fmaxf(stance[0] + stance[1], 1e-9f);
        const float h = q[2] - (mean_z - sole);
        term[T_BASE_HEIGHT] = expf(-fabsf(h - a.f[F_BASE_HEIGHT_TARGET]) * 100.f);
    }
    {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            const float d = lrv[k] - qv[k];
            s += d * d;
        }
        term[T_BASE_ACC] = expf(-sqrtf(s) * 3.f);
    }
    term[T_ACTION_SMOOTHNESS] = s_rate + s_smooth + 0.05f * s_act_abs;
    term[T_TORQUES] = s_tau;
    term[T_DOF_VEL] = s_vel;
    term[T_DOF_ACC] = s_acc;
    {
        const unsigned char* pen = row<unsigned char>(a, S_COLLISION_FLAGS, e);
        float r = 0.f;
        for (int k = 0; k < a.i[I_N_PEN]; ++k) r += pen[k] ? 1.f : 0.f;
        term[T_COLLISION] = r;
    }
    term[T_LIN_VEL_Z] = blv[2] * blv[2];
    term[T_ANG_VEL_XY] = bav[0] * bav[0] + bav[1] * bav[1];
    term[T_ACTION_RATE] = s_rate;
    term[T_STAND_STILL] = s_def_abs * (sqrtf(cmd[0] * cmd[0] + cmd[1] * cmd[1]) < 0.1f ? 1.f : 0.f);

    // ---- the sums: a state that is not finite scores 0 in every term ----
    const bool fin = *row<unsigned char>(a, S_FINITE, e) != 0;
    const float* es_in = row<float>(a, S_EPISODE_SUMS, e);
    float* es_out = static_cast<float*>(const_cast<void*>(a.p[S_OUT_EPISODE_SUMS])) +
                    (size_t)e * a.i[I_N_COLS];
    float reward = 0.f;
#pragma unroll
    for (int k = 0; k < N_TERMS; ++k) {
        const int c = a.col[k];
        if (c < 0) continue;
        const float scaled = (fin ? term[k] : 0.f) * a.scale[k];
        reward += scaled;
        if (live && c % RW_LANES == lane) es_out[c] = es_in[c] + scaled;
    }
    if (a.i[I_ONLY_POSITIVE] && reward < 0.f) reward = 0.f;  // torch.clamp(min=0): NaN stays
    const float ts = a.f[F_TERMINATION_SCALE];
    if (ts != 0.f) {
        const bool fell = *row<unsigned char>(a, S_DONE, e) && !*row<unsigned char>(a, S_TIME_OUT, e);
        reward += fell ? ts : 0.f;
    }
    if (!live) return;
    if (lane == 0) static_cast<float*>(const_cast<void*>(a.p[S_OUT_REWARD]))[e] = reward;

    // ---- the feet state (rewards.py feet_state_update, masked as env.py masks it) ----
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        if (k % RW_LANES != lane) continue;
        const size_t o = (size_t)e * 2 + k;
        const float air = (fat_in[k] + dt) * (filt[k] ? 0.f : 1.f);
        const float height = fh[k] * (contact[k] ? 0.f : 1.f);
        static_cast<float*>(const_cast<void*>(a.p[S_OUT_FEET_AIR_TIME]))[o] = fin ? air : 0.f;
        static_cast<unsigned char*>(const_cast<void*>(a.p[S_OUT_LAST_CONTACTS]))[o] =
            contact[k] && fin;
        static_cast<float*>(const_cast<void*>(a.p[S_OUT_FEET_HEIGHT]))[o] = fin ? height : 0.f;
        static_cast<float*>(const_cast<void*>(a.p[S_OUT_LAST_FEET_Z]))[o] =
            fin ? sole_z[k] : 0.05f;
        static_cast<unsigned char*>(const_cast<void*>(a.p[S_OUT_CONTACT]))[o] = contact[k];
    }
}

extern "C" {

// ptrs: N_SLOTS device addresses; strides: N_SLOTS row strides (elements);
// fparams: N_FPARAMS floats then N_TERMS scales (scale * dt, 0 where the
// config drops the term); iparams: N_IPARAMS ints then N_TERMS episode-sum
// columns (-1: dropped); all on one device; the launch goes to `stream`.
int hgt_rewards(const uint64_t* ptrs, const int* strides, const float* fparams,
                const int* iparams, int n, void* stream) {
    if (n <= 0) return 0;
    RewardArgs a;
    for (int k = 0; k < N_SLOTS; ++k) {
        a.p[k] = reinterpret_cast<const void*>(ptrs[k]);
        a.s[k] = strides[k];
    }
    for (int k = 0; k < N_FPARAMS; ++k) a.f[k] = fparams[k];
    for (int k = 0; k < N_TERMS; ++k) a.scale[k] = fparams[N_FPARAMS + k];
    for (int k = 0; k < N_IPARAMS; ++k) a.i[k] = iparams[k];
    for (int k = 0; k < N_TERMS; ++k) a.col[k] = iparams[N_IPARAMS + k];
    a.n = n;
    const long long threads = (long long)n * RW_LANES;
    const int blocks = (int)((threads + RW_THREADS - 1) / RW_THREADS);
    hgt_rewards_kernel<<<blocks, RW_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
