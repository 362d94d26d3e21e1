#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-4, 4t, 10, 10t, 6 and 7, then the records; no contract line

Phases (each prints one line of its numbers; any failure raises, so the
script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from humanoid_gym_tpu_torch/csrc;
  3. the contact-solve kernel against its plain PyTorch version at 4096, 37
     and 1 envs, on operands built from real XBot-L states;
  4. the mega kernel (one policy step of physics) against its plain
     version at 4096 envs over 1 and 5 policy steps and at 37 and 1 envs
     over one, and its end-of-step FK rows after the 5 steps against the
     port's fk / body_velocities at the state it returned; one launch timed
     as it runs, with no APGD iterations and with one substep, for the
     split loop / rest of a substep / fixed cost;
  4t. the terrain variant of the mega kernel against its plain version on
     the full-size map of `humanoid_ppo_terrain_robust` (2100 x 2100 nodes),
     envs placed by the port's `init_state`, standing on it after LAND_STEPS
     policy steps at the default pose: 4096 envs over
     1 and 5 policy steps, 37 and 1 envs over one, both fed from one
     `terrain_patches` call; the count of active contacts on sloped cells;
     its launch timed beside the flat launch on the same states;
  5. the main path: XBot-L PPO training (4096 envs, T=60, solver mega)
     through `make_train_iter`, one warm-up iteration and 3 timed ones,
     with the kernels' launch counters zeroed just before the timed run;
  5c. OnPolicyRunner.learn(2) at 4096 envs (humanoid_ppo, solver mega)
     with HGT_PROFILE_DIR set: one Chrome trace of the second iteration,
     which names hgt_mega_kernel 60 times;
  6. the APGD kernel (solver apgd_pallas) against its plain version on the
     operands `resolve_contacts` builds: 4096 envs at 8 and 50 iterations;
     37 envs, 1 env and 4096 + 37 (more than one round of the kernel's
     persistent warps, not a multiple of its block) at 8; a launch with 0
     iterations timed beside the 8-iteration one (load and set-up / loop);
  7. the fused dense kernel (solver fused_pallas) against its plain version
     on the operands `make_substep` builds, at the same four sizes and with
     the same 0-iteration split, and against the mega kernel's factor-form
     solve at 200 (reported) and 1000 iterations (dense and factor form
     agree at convergence);
  8. the substep path through the entry points: `registry.make_env` ->
     `OnPolicyRunner.learn` at 4096 envs, T=60, with solver fused_pallas
     (warm-up, 1 timed iteration, resume from its own checkpoint) and
     apgd_pallas (warm-up, 1 timed iteration), launch counters zeroed just
     before each timed run and read just after;
  9. the terrain path through the entry points: `registry.make_env(
     "humanoid_ppo_terrain_robust")` -> `OnPolicyRunner.learn` at 4096 envs,
     T=60, solver mega (warm-up, 2 timed iterations): 60 terrain-kernel
     launches per iteration and no flat one, the terrain levels, and the
     launches per iteration under the profiler;
 10. two robot models in one stream (run after phase 4t): the mega kernel
     launched with XBot-S's constants against the plain XBot-S step at 4096
     envs over 1 and 5 policy steps; XBot-L and XBot-S launches queued L,
     S, L, S on one stream with no synchronisation, each bit-equal to the
     same launch run alone; both timed in turns;
 10t. the same for the terrain variant: XBot-S landed on phase 4t's map
     against the plain XBot-S terrain step, interleaved with XBot-L on
     phase 4t's landed states;
 11. joint XBot-L + XBot-S training through the entry points:
     `registry.make_env("humanoid_joint_ppo")` and `("humanoid_joint_deploy")`
     -> `OnPolicyRunner.learn` at 2048 + 2048 envs, T=60, solver mega, the
     estimator head on (warm-up, 2 timed iterations): 120 flat (joint_ppo)
     or 120 terrain (joint_deploy) launches per iteration and no other,
     finite losses, an estimator loss that falls on a fixed batch (the
     observations ending the warm-up iteration, initial weights against
     the last iteration's; the logged per-iteration loss is reported), and
     on the deploy task envs that drew level 20 on the 20 rows standing on
     row 19's origin;
 12. the repo's trained policies through the kernel (`actor_critic_from_npz`,
     deployment-clean overrides, 4096 envs, 400 policy steps): (a)
     `xbotl_walk_demo` on `humanoid_ppo` at vx 0.4, at least 95% survive and
     the median distance is at least 0.8 m; (b) `xbotl_footing_demo` (the
     joint policy) on `humanoid_s_ppo` at vx 0.4 sqrt(s), at least 95%
     survive and the median distance is at least half the ideal; (c)
     `xbotl_footing_demo` on `humanoid_ppo_rubble` through the terrain
     variant, reported;
 13. env-sharded training on the one card: `humanoid_ppo` at 4096 envs,
     T=60, solver mega, as 2 ranks x 2048 envs over gloo, each started by
     this script with the launcher's variables and going through
     `registry.make_env(..., group=)` -> `OnPolicyRunner.learn` on the kernel
     library of phase 2 (warm-up, 2 timed iterations): 60 mega launches per
     rank per iteration, finite losses, parameters, Adam moments, learning
     rate and logged metrics bit-equal across the ranks after every
     iteration (compared through the group), one all-reduce per minibatch
     (timed, with its bytes); the sharded compute_gae + update_phase of one
     fixed 4096-env rollout within SHARDED_UPDATE_TOL of one process on it;
     then 2 fresh ranks restore the final checkpoint's env shards exactly
     and train on, beside 1 nccl rank at world size 1 (an all-reduce and a
     broadcast on the card, one iteration);
 14. play on the card: `play(get_args([...]))` of scripts/play_torch.py
     (HGT_PLAY_VIDEO=0) on a humanoid_ppo checkpoint whose actor is the
     walk demo's, 1 env, 1200 policy steps at vx 0.5: the counts zeroed
     just before the rollout and read just after show 1200 mega launches
     and no plain mega step; the exported policy.npz equals the shipped
     demo's arrays; the trace is finite, the robot never falls and its mean
     base_vel_x is at least PLAY_MIN_VX; then the first 20 noise-free steps
     of `play_rollout` on the card against the same rollout on the CPU
     (PLAY_TOLS), with the card's host synchronisations counted;
 15. the learning-curve band on the card: the seeded 16-env run of
     tests/test_learning_regression.py (seed 5, T=60, 12 iterations through
     `make_train_iter`) with solver mega, held to that test's bands
     unchanged (humanoid_gym_tpu_torch/utils/learning_band.py);
 16. the stage profile of the training iteration on the card:
     `scripts/learn_profile_torch.py` at 4096 envs, T=60 (flat
     humanoid_ppo, solver mega), all eight stages (full, rollout, gae,
     permute, update1, fwd, fwdbwd, adam), each as host wall time and
     profiler device time: 60 mega launches per full and per rollout call,
     every time finite and positive, device time at most wall time, and
     full's device time within 0.8-1.25 of phase 5b's profiled iteration;
 17. the 16,384-env joint footprint: `scripts/config4_dryrun_torch.py`
     (humanoid_joint_deploy, 8192 XBot-L + 8192 XBot-S envs on the deploy
     field, T=60, one rank, its own process): 120 terrain launches (each
     robot's B1t a policy step) and no flat one in the timed iteration, a
     finite value loss, a peak below the card's memory; the measured peak
     beside the JAX formula's projection;
 18. the SASS census of B1 and B1t (`physics/sass_census.py`): the
     -lineinfo cubin's instruction count equal to the loaded library's for
     both instances, at least 95% of instructions on a line of mega.cu /
     solve.cuh / apgd.cuh; the top opcodes and lines;
 19. the roofline CLI (`scripts/roofline_torch.py`) at phase 5's measured
     iteration time, its total equal to `iteration_flops`; the example
     (`examples/minimal_train_loop_torch.py`) at 8 envs on the card, 3
     finite iterations through the kernel;
 20. one JSON line with a record per kernel, the card line, then the
     contract line {"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA card, or outside a checkout of
the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the kernels' operation counts and bounds (H100 SXM peaks): the port's
# census, importable only from a checkout of the repo (main() refuses to
# run outside one)
if os.path.isdir(os.path.join(HERE, "humanoid_gym_tpu_torch")):
    sys.path.insert(0, HERE)
    from humanoid_gym_tpu_torch.utils.roofline import (  # noqa: E402
        apgd_ops,
        fused_dense_ops,
        mega_ops,
        mega_ops_executed,
        mega_terrain_ops,
        solve_ops,
        solve_ops_executed,
    )
    from humanoid_gym_tpu_torch.utils.roofline import bound_ms as _bound_ms  # noqa: E402

N_ENVS = 4096
T_STEPS = 60
TIMED_ITERS = 3
TERRAIN_TASK = "humanoid_ppo_terrain_robust"
# policy steps at the default pose before phase 4t compares: long enough
# that the robots stand on the terrain rather than land on it (the impacts
# of the landing make the 8-iteration solve's iterates most sensitive to
# rounding)
LAND_STEPS = 50


def _solver_mega(cfg):
    """cfg_overrides of the terrain task: solver mega, as scripts/train.py
    and scripts/train_torch.py run it on the card."""
    cfg.sim.solver.solver_type = "mega"


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, on CUDA events. A spin
    kernel of ~10 ms holds the card while the host enqueues the calls, so
    that the events bracket kernels running back to back and not the host's
    launch rate (a wrapper's checks cost the host more than a 0.04 ms kernel
    costs the card)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _maxerr(a, b) -> float:
    return float((a - b).abs().max().item())


# ---- inputs ----

def _states(model, n, seed, device, z=0.9):
    """Perturbed standing states with DR values drawn as the JAX package's
    tests/test_mega_kernel.py:_states draws them; the base at height z."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch.physics.step import default_state

    rng = np.random.default_rng(seed)
    st = default_state(model, n, [0.0, 0.0, z], [1.0, 0.0, 0.0, 0.0])
    qpos = st.qpos.cpu().numpy()
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (n, 12))
    qpos[:, 2] += rng.uniform(-0.02, 0.02, n)
    qvel = rng.normal(size=(n, 18)) * 0.2
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return st.replace(
        qpos=f(qpos), qvel=f(qvel),
        friction=f(rng.uniform(0.3, 1.2, n)),
        base_mass_scale=f(rng.uniform(0.9, 1.1, n)),
        contact_stiffness=f(rng.uniform(0.7, 1.5, n)),
        contact_offset=f(rng.uniform(0.004, 0.025, n)),
        contact_compliance=f(rng.uniform(0.0, 0.2, n)),
        kp_scale=f(rng.uniform(0.8, 1.2, n)),
        kd_scale=f(rng.uniform(0.8, 1.2, n)),
    ), f(rng.uniform(-0.2, 0.2, (n, 12)))


def _solve_operands(model, st, targets, kp, kd, tlim, dt):
    """The solve's operands at state `st` (solver-internal DOF order), as
    the plain mega step builds them each substep."""
    import torch

    from humanoid_gym_tpu_torch.physics.mega import solve_operands

    ms = torch.ones((st.qpos.shape[0], model.nbody), device=st.qpos.device)
    ms[:, 0] = st.base_mass_scale
    _, ops, _ = solve_operands(
        model, dt, st.qpos, st.qvel, targets, kp * st.kp_scale[:, None],
        kd * st.kd_scale[:, None], tlim, ms, st.friction, st.contact_stiffness,
        st.contact_offset, st.contact_compliance, st.contact_lam,
    )
    return ops


# tolerances of the JAX package's kernel-vs-XLA check
# (tests/test_mega_kernel.py:70-76): qpos 5e-4, qvel 1e-2, tau 5e-2, contact
# force 5 N (ff / dt); lam rows at the same force, 5 N * dt; fk14 positions
# at the qpos tolerance, foot velocities at qvel's.
def _mega_tols(sim_dt):
    return {"qpos": 5e-4, "qvel": 1e-2, "lam": 5.0 * sim_dt, "tau": 5e-2,
            "ff": 5.0 * sim_dt, "fk_pos": 5e-4, "fk_vel": 1e-2}


def _setup(dev, robot="L"):
    """The XBot-L (or, robot="S", the XBot-S) model, gains and the mega step
    (kernel and plain) that phases 3, 4 and 10 share."""
    import types

    import torch

    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.config.xbots import SCALE, XBotSCfg
    from humanoid_gym_tpu_torch.envs.env import _match_gains
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    c = types.SimpleNamespace(dev=dev, robot=robot)
    c.cfg = XBotLCfg() if robot == "L" else XBotSCfg()
    c.cfg.sim.solver.solver_type = "mega"
    c.model = build_xbot_model(c.cfg.asset.file, mesh_dir=c.cfg.asset.mesh_dir).to(dev)
    c.z = 0.9 if robot == "L" else 0.9 * SCALE  # standing base height of the perturbed states
    c.sim_dt, c.dec = c.cfg.sim.dt, c.cfg.control.decimation
    c.iters = c.cfg.sim.solver.solver_iterations
    c.kp = torch.as_tensor(_match_gains(c.model.dof_names, c.cfg.control.stiffness), device=dev)
    c.kd = torch.as_tensor(_match_gains(c.model.dof_names, c.cfg.control.damping), device=dev)
    c.tlim = c.model.dof_effort * c.cfg.safety.torque_limit
    c.mega = MG.make_mega_step_batched(c.model, c.sim_dt, c.dec, c.kp, c.kd, c.tlim,
                                       iterations=c.iters)

    def plain(st, tgt):
        return MG.mega_step_plain(
            c.model, c.sim_dt, c.dec, c.kp, c.kd, c.tlim, c.iters, 1.0, st.qpos, st.qvel,
            st.friction, st.base_mass_scale, st.contact_stiffness, st.contact_offset, st.kp_scale,
            st.kd_scale, st.contact_compliance, st.contact_lam, tgt,
        )

    def kernel(st, tgt):
        return c.mega(st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
                      st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance,
                      st.contact_lam, st.slope_bias, tgt)

    def advance(st, out):
        qpos, qvel, lam, tau, ff, fk14 = out
        return st.replace(qpos=qpos, qvel=qvel, contact_lam=lam, torques=tau, fk_out=fk14)

    c.plain, c.kernel, c.advance = plain, kernel, advance
    return c


def _one_step_in(c, n):
    """n perturbed states advanced one policy step by the plain mega step
    (so they carry a warm-start lam), and their targets."""
    st0, tgt0 = _states(c.model, n, seed=0, device=c.dev)
    return c.advance(st0, c.plain(st0, tgt0)), tgt0


def _apgd_operands(c, st, tgt):
    """The APGD kernel's operands at state `st`, as `resolve_contacts` builds them."""
    from humanoid_gym_tpu_torch.physics import mega as MG, step as ST
    from humanoid_gym_tpu_torch.physics.contact import delassus_operands
    from humanoid_gym_tpu_torch.physics.dynamics import solve_mtilde

    _, dyn, _, rhs = ST.substep_dynamics(c.model, c.sim_dt, st, tgt, c.kp, c.kd, c.tlim)
    v_free = st.qvel + solve_mtilde(dyn.Mtilde_chol, rhs)
    setup, sign, lb, _, A, u0, bound = delassus_operands(
        c.model, dyn, st.qpos, v_free, MG.flat_height_fn, c.sim_dt,
        contact_offset=st.contact_offset, baumgarte=0.2 * st.contact_stiffness,
        compliance=st.contact_compliance)
    return [t.contiguous() for t in (A, u0, setup.lo_bound, sign, lb, st.friction, bound,
                                     st.contact_lam)]


def _fused_operands(c, st, tgt):
    """The fused dense kernel's operands at state `st`, as `make_substep` builds them."""
    from humanoid_gym_tpu_torch.physics import step as ST

    return ST.fused_operands(c.model, c.sim_dt, st, tgt, c.kp, c.kd, c.tlim)[2]


# one round of the APGD kernel's persistent warps is (SM count) x 3 blocks x 4
# warps = 1584 envs on an H100; 4096 + 37 is several rounds with a ragged end
DENSE_SIZES = (N_ENVS, 37, 1, N_ENVS + 37)


def _phase3_solve(c, records):
    """Phase 3: the solve kernel against its plain version at 4096, 37 and 1
    envs. Returns the 4096-env state one policy step in, its targets and the
    solve's operands there."""
    import torch

    from humanoid_gym_tpu_torch.physics import solve as SV

    keep = None
    for n in (N_ENVS, 37, 1):
        st1, tgt0 = _one_step_in(c, n)  # a warm-start lam from one real step
        ops_in = _solve_operands(c.model, st1, tgt0, c.kp, c.kd, c.tlim, c.sim_dt)
        q_k, l_k = SV.fused_solve(*ops_in, iterations=c.iters)
        q_p, l_p = SV.fused_solve_plain(*ops_in, iterations=c.iters)
        torch.cuda.synchronize()
        eq, el = _maxerr(q_k, q_p), _maxerr(l_k, l_p)
        finite = bool(torch.isfinite(q_k).all() and torch.isfinite(l_k).all())
        if n != N_ENVS:
            _log(f"phase 3 solve: {n} env(s), {c.iters} iters | max|dqvel| {eq:.3e} (tol 5e-4) "
                 f"max|dlam| {el:.3e} (tol 2e-3) | finite {finite}")
        else:
            keep = (st1, tgt0, ops_in)
            ms_k = _time_ms(lambda: SV.fused_solve(*ops_in, iterations=c.iters), reps=20)
            ms_0 = _time_ms(lambda: SV.fused_solve(*ops_in, iterations=0), reps=20)
            ms_p = _time_ms(lambda: SV.fused_solve_plain(*ops_in, iterations=c.iters), reps=3)
            nbytes = n * 4 * (sum(t[0].numel() for t in ops_in) + 18 + 60)
            b_ms, b_by = _bound_ms(nbytes, n * solve_ops(c.iters))
            _log(f"phase 3 solve: {n} envs, {c.iters} iters | max|dqvel| {eq:.3e} (tol 5e-4) "
                 f"max|dlam| {el:.3e} (tol 2e-3) | finite {finite} | kernel {ms_k:.4f} ms "
                 f"(with 0 iterations {ms_0:.4f} ms) plain {ms_p:.3f} ms bound {b_ms:.5f} ms "
                 f"({b_by}; {solve_ops(c.iters)} operations per env, the warp executes "
                 f"{solve_ops_executed(c.iters)} with every lane counted)")
            records["solve"] = dict(max_abs_err=max(eq, el), ms=ms_k, plain_ms=ms_p,
                                    bound_ms=b_ms, bound_by=b_by)
        if not (eq <= 5e-4 and el <= 2e-3 and finite):
            raise AssertionError(f"solve kernel disagrees with its plain version at {n} envs: "
                                 f"{eq}, {el}")
    return keep


def _mega_errors(ok, op):
    return {
        "qpos": _maxerr(ok[0], op[0]), "qvel": _maxerr(ok[1], op[1]),
        "lam": _maxerr(ok[2], op[2]), "tau": _maxerr(ok[3], op[3]),
        "ff": _maxerr(ok[4], op[4]), "fk_pos": _maxerr(ok[5][:, :10], op[5][:, :10]),
        "fk_vel": _maxerr(ok[5][:, 10:], op[5][:, 10:]),
    }


# the kernel's OUT_FK rows against the engine's fk / body_velocities
# (tests/test_mega_kernel.py:251)
FK_ROWS_TOL = 2e-4


def _fk_rows_error(model, out):
    """Max |OUT_FK rows - the same quantities from fk / body_velocities| at
    the state a mega launch returned (feet p and knee xy base-relative,
    feet v_origin world-frame)."""
    import torch

    from humanoid_gym_tpu_torch.physics.kinematics import body_velocities, fk

    qpos, qvel, fk14 = out[0], out[1], out[5]
    k = fk(model, qpos)
    bv = body_velocities(model, qpos, qvel, k)
    f, kn = list(model.feet_body_idx), list(model.knee_body_idx)
    p = k.p - qpos[:, None, :3]
    want = torch.cat([p[:, f, 0], p[:, f, 1], p[:, f, 2], p[:, kn, 0], p[:, kn, 1],
                      bv.v_origin[:, f, 0], bv.v_origin[:, f, 1]], dim=1)
    return _maxerr(fk14, want)


def _phase4_mega(c, records):
    """Phase 4: the mega kernel against its plain version (4096 envs over 1
    and 5 policy steps, 37 and 1 envs over one), its time, and the time of
    one launch without APGD iterations and with a single substep."""
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG

    tols = _mega_tols(c.sim_dt)
    worst = 0.0
    st1 = None
    for n, n_steps in ((N_ENVS, 1), (N_ENVS, 5), (37, 1), (1, 1)):
        st0, tgt0 = _states(c.model, n, seed=0, device=c.dev)
        sk, sp = st0, st0
        for _ in range(n_steps):
            ok = c.kernel(sk, tgt0)
            op = c.plain(sp, tgt0)
            sk, sp = c.advance(sk, ok), c.advance(sp, op)
        torch.cuda.synchronize()
        if (n, n_steps) == (N_ENVS, 1):
            st1, tgt1 = sp, tgt0
        errs = _mega_errors(ok, op)
        finite = all(bool(torch.isfinite(t).all()) for t in ok)
        _log(f"phase 4 mega: {n} env(s), {n_steps} step(s) | " + " ".join(
            f"{k} {v:.3e}/{tols[k]:.0e}" for k, v in errs.items()) + f" | finite {finite}")
        bad = {k: v for k, v in errs.items() if not v <= tols[k]}
        if bad or not finite:
            raise AssertionError(f"mega kernel disagrees with its plain version at {n} envs: {bad}")
        worst = max(worst, max(errs.values()))
        if (n, n_steps) == (N_ENVS, 5):
            e_fk = _fk_rows_error(c.model, ok)
            _log(f"phase 4 mega FK rows: {n} envs after {n_steps} steps, the kernel's end-of-step "
                 f"OUT_FK rows against fk / body_velocities at its qpos, qvel | max err {e_fk:.3e} "
                 f"(tol {FK_ROWS_TOL:.0e}, tests/test_mega_kernel.py:251)")
            if not e_fk <= FK_ROWS_TOL:
                raise AssertionError(f"the kernel's OUT_FK rows differ from fk by {e_fk}")
    packed = MG.pack_inputs(st1.qpos, st1.qvel, st1.friction, st1.base_mass_scale,
                            st1.contact_stiffness, st1.contact_offset, st1.kp_scale,
                            st1.kd_scale, st1.contact_compliance, st1.contact_lam, tgt1)

    def launch(decimation, iterations):
        return MG.mega_kernel_launch(packed, c.mega.consts_dev, c.sim_dt, decimation, iterations, 1.0)

    ms_mk = _time_ms(lambda: launch(c.dec, c.iters), reps=20)
    ms_i0 = _time_ms(lambda: launch(c.dec, 0), reps=20)
    ms_d1 = _time_ms(lambda: launch(1, c.iters), reps=20)
    ms_d0 = _time_ms(lambda: launch(0, c.iters), reps=20)
    ms_mp = _time_ms(lambda: c.plain(st1, tgt1), reps=2)
    b_ms, b_by = _bound_ms(N_ENVS * 4 * (MG.IN_ROWS + MG.OUT_ROWS),
                           N_ENVS * mega_ops(c.dec, c.iters))
    _log(f"phase 4 mega timing: {N_ENVS} envs, one launch {ms_mk:.3f} ms, plain {ms_mp:.2f} ms, "
         f"bound {b_ms:.5f} ms ({b_by}; {mega_ops(c.dec, c.iters)} operations per env, the warp "
         f"executes {mega_ops_executed(c.dec, c.iters)} with every lane counted)")
    _log(f"phase 4 mega split: {c.dec} substeps x {c.iters} iterations {ms_mk:.3f} ms | "
         f"{c.dec} substeps x 0 iterations {ms_i0:.3f} ms | 1 substep x {c.iters} iterations "
         f"{ms_d1:.3f} ms | 0 substeps {ms_d0:.3f} ms => APGD loop "
         f"{(ms_mk - ms_i0) / c.dec:.4f} ms per substep, rest of a substep "
         f"{(ms_i0 - ms_d0) / c.dec:.4f} ms, fixed cost (load, final FK, store) {ms_d0:.4f} ms")
    records["mega"] = dict(max_abs_err=worst, ms=ms_mk, plain_ms=ms_mp, bound_ms=b_ms,
                           bound_by=b_by)


def _landed_terrain_states(dev):
    """Phase 4t's inputs: the port's env for the terrain task at 4096 envs
    (placed by `init_state` over the levels of the full-size map),
    LAND_STEPS policy steps at the default pose so that the robots stand on
    the terrain, and the default pose as the targets."""
    import torch

    from humanoid_gym_tpu_torch import registry

    env, cfg = registry.make_env(TERRAIN_TASK, num_envs=N_ENVS, cfg_overrides=_solver_mega,
                                 device=dev, seed=0)
    state = env.init_state()
    zero = torch.zeros((N_ENVS, cfg.env.num_actions), device=dev)
    for _ in range(LAND_STEPS):
        state, _ = env.step(state, zero)
    return env, cfg, state, env.default_dof_pos.expand(N_ENVS, -1).contiguous()


def _phase4t_mega_terrain(c, records):
    """Phase 4t: the terrain variant against its plain version on the full
    map. Each step's IN2 rows come from one `terrain_patches` call on the
    state it starts from; where kernel and plain start from one state (the
    first step) they read the same call's rows. Returns the landed states,
    their targets and the terrain step, which phase 10t reuses."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.terrain.terrain import TerrainMap

    t0 = time.perf_counter()
    tmap = TerrainMap.build(registry.get_task(TERRAIN_TASK).make_env_cfg().terrain,
                            np.random.default_rng(0))
    build_s = time.perf_counter() - t0
    env, cfg, state, tgt_all = _landed_terrain_states(c.dev)
    if not np.array_equal(env.terrain_map.height_field, tmap.height_field):
        raise AssertionError("the env's terrain map is not the task's map from default_rng(0)")
    step = MG.make_mega_step_batched(env.model, cfg.sim.dt, cfg.control.decimation, env.p_gains,
                                     env.d_gains, env.torque_limits, iterations=c.iters,
                                     terrain_map=env.terrain_map)
    terr, consts = step.terrain, step.consts_dev

    def kernel(st, tgt, in2):
        packed = MG.pack_inputs(*_phys_args(st, tgt))
        return MG.unpack_outputs(MG.mega_kernel_launch(packed, consts, c.sim_dt, c.dec, c.iters,
                                                       1.0, packed2=in2, terrain=terr))

    def plain(st, tgt, in2):
        return MG.mega_step_plain(env.model, c.sim_dt, c.dec, env.p_gains, env.d_gains,
                                  env.torque_limits, c.iters, 1.0, *_phys_args(st, tgt), in2=in2,
                                  terrain=terr)

    tols = _mega_tols(c.sim_dt)
    worst = 0.0
    st_all = state.phys
    lv = state.terrain_level
    _log(f"phase 4t terrain: {TERRAIN_TASK} map {tmap.height_field.shape[0]} x "
         f"{tmap.height_field.shape[1]} nodes ({tmap.height_field.nbytes / 1e6:.1f} MB int16) built "
         f"in {build_s:.2f} s | {N_ENVS} envs on levels {int(lv.min())}-{int(lv.max())} (mean "
         f"{float(lv.float().mean()):.2f}) after {LAND_STEPS} steps at the default pose")
    for n, n_steps in ((N_ENVS, 1), (N_ENVS, 5), (37, 1), (1, 1)):
        idx = torch.linspace(0, N_ENVS - 1, n, device=c.dev).round().long()
        st0 = st_all.replace(**{f: getattr(st_all, f)[idx] for f in (
            "qpos", "qvel", "friction", "base_mass_scale", "contact_stiffness", "contact_offset",
            "kp_scale", "kd_scale", "contact_compliance", "contact_lam", "slope_bias", "torques",
            "fk_out", "contact_forces")})
        tgt = tgt_all[idx]
        in2 = step.terrain_patches(st0.qpos, st0.slope_bias)
        ok, op = kernel(st0, tgt, in2), plain(st0, tgt, in2)
        sk, sp = c.advance(st0, ok), c.advance(st0, op)
        for _ in range(n_steps - 1):
            ok = kernel(sk, tgt, step.terrain_patches(sk.qpos, sk.slope_bias))
            op = plain(sp, tgt, step.terrain_patches(sp.qpos, sp.slope_bias))
            sk, sp = c.advance(sk, ok), c.advance(sp, op)
        torch.cuda.synchronize()
        errs = _mega_errors(ok, op)
        finite = all(bool(torch.isfinite(t).all()) for t in ok)
        line = (f"phase 4t mega terrain: {n} env(s), {n_steps} step(s) | " + " ".join(
            f"{k} {v:.3e}/{tols[k]:.0e}" for k, v in errs.items()) + f" | finite {finite}")
        if (n, n_steps) == (N_ENVS, 1):
            keep = (MG.pack_inputs(*_phys_args(st0, tgt)), in2, st0, tgt)
            level_in2 = step.terrain_patches(st0.qpos, torch.zeros_like(st0.slope_bias))
            slope = torch.hypot(level_in2[:, MG.IN2_GX:MG.IN2_GY], level_in2[:, MG.IN2_GY:])
            lam_n = ok[2][:, 2:3 * MG.N_POINTS:3]
            on_slope = int(((lam_n > 0) & (slope > 1e-6)).sum())
            line += (f" | active contact points {int((lam_n > 0).sum())}, on sloped cells "
                     f"{on_slope} (steepest cell under a point: slope {float(slope.max()):.3f})")
        _log(line)
        bad = {k: v for k, v in errs.items() if not v <= tols[k]}
        if bad or not finite:
            raise AssertionError(f"terrain mega kernel disagrees with its plain version at {n} "
                                 f"envs: {bad}")
        if (n, n_steps) == (N_ENVS, 1) and on_slope == 0:
            raise AssertionError("no active contact on a sloped cell: the terrain check is vacuous")
        worst = max(worst, max(errs.values()))
    packed, in2, st0, tgt = keep

    def launch(terrain):
        if terrain:
            return MG.mega_kernel_launch(packed, consts, c.sim_dt, c.dec, c.iters, 1.0,
                                         packed2=in2, terrain=terr)
        return MG.mega_kernel_launch(packed, consts, c.sim_dt, c.dec, c.iters, 1.0)

    turns = [_time_ms(lambda: launch(t), reps=20) for t in (False, True, True, False)]
    ms_k = 0.5 * (turns[1] + turns[2])
    ms_p = _time_ms(lambda: plain(st0, tgt, in2), reps=2)
    ms_patches = _time_ms(lambda: step.terrain_patches(st0.qpos, st0.slope_bias), reps=20)
    n_patches = _kernel_launches(lambda: step.terrain_patches(st0.qpos, st0.slope_bias))
    ops = mega_terrain_ops(c.dec, c.iters)
    b_ms, b_by = _bound_ms(N_ENVS * 4 * (MG.IN_ROWS + MG.IN2_ROWS + MG.OUT_ROWS), N_ENVS * ops)
    _log(f"phase 4t mega terrain timing: {N_ENVS} envs, same states, in turns flat {turns[0]:.3f} "
         f"| terrain {turns[1]:.3f} | terrain {turns[2]:.3f} | flat {turns[3]:.3f} ms per launch; "
         f"terrain_patches {ms_patches:.3f} ms, {n_patches} kernel launches a call; plain "
         f"{ms_p:.2f} ms; bound {b_ms:.5f} ms ({b_by}; "
         f"{ops} operations per env)")
    records["mega_terrain"] = dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                   bound_by=b_by)
    return st_all, tgt_all, step


def _phys_args(st, tgt):
    return (st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
            st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance, st.contact_lam, tgt)


def _interleave(runs, launch):
    """`runs`: name -> the packed inputs of one launch. Each launch run
    alone (synchronised after it), then L, S, L, S queued on one stream
    with no synchronisation between them: True if every queued output is
    bit-equal to the same launch run alone."""
    import torch

    alone = {}
    for name, args in runs.items():
        alone[name] = launch(name, *args)
        torch.cuda.synchronize()
    queued = [(name, launch(name, *runs[name])) for name in ("L", "S", "L", "S")]
    torch.cuda.synchronize()
    return all(torch.equal(out, alone[name]) for name, out in queued)


def _phase10_two_models(c, cs, extra):
    """Phase 10: the flat mega kernel under XBot-S's constants against the
    plain XBot-S step (4096 envs over 1 and 5 policy steps); then XBot-L
    and XBot-S launches interleaved on one stream; both launches timed in
    turns (L, S, S, L)."""
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG

    tols = _mega_tols(cs.sim_dt)
    worst = 0.0
    for n_steps in (1, 5):
        st0, tgt0 = _states(cs.model, N_ENVS, seed=0, device=cs.dev, z=cs.z)
        sk, sp = st0, st0
        for _ in range(n_steps):
            ok, op = cs.kernel(sk, tgt0), cs.plain(sp, tgt0)
            sk, sp = cs.advance(sk, ok), cs.advance(sp, op)
        torch.cuda.synchronize()
        errs = _mega_errors(ok, op)
        finite = all(bool(torch.isfinite(t).all()) for t in ok)
        _log(f"phase 10 mega, XBot-S constants: {N_ENVS} envs, {n_steps} step(s) | " + " ".join(
            f"{k} {v:.3e}/{tols[k]:.0e}" for k, v in errs.items()) + f" | finite {finite} | "
            f"base height {float(ok[0][:, 2].mean()):.3f} m")
        bad = {k: v for k, v in errs.items() if not v <= tols[k]}
        if bad or not finite:
            raise AssertionError(f"mega kernel with XBot-S constants disagrees with the plain "
                                 f"XBot-S step: {bad}")
        worst = max(worst, max(errs.values()))
    runs, models = {}, {"L": c, "S": cs}
    for name, m in models.items():
        st, tgt = _states(m.model, N_ENVS, seed=1, device=m.dev, z=m.z)
        runs[name] = (MG.pack_inputs(*_phys_args(m.advance(st, m.plain(st, tgt)), tgt)),)

    def launch(name, packed):
        m = models[name]
        return MG.mega_kernel_launch(packed, m.mega.consts_dev, m.sim_dt, m.dec, m.iters, 1.0)

    same = _interleave(runs, launch)
    if not same:
        raise AssertionError("interleaved XBot-L / XBot-S launches differ from the lone launches")
    turns = [_time_ms(lambda n=n: launch(n, *runs[n]), reps=20) for n in ("L", "S", "S", "L")]
    _log(f"phase 10 two models in one stream: L, S, L, S queued with no synchronisation, each "
         f"bit-equal to its lone launch: {same} | {N_ENVS} envs, in turns L {turns[0]:.3f} | "
         f"S {turns[1]:.3f} | S {turns[2]:.3f} | L {turns[3]:.3f} ms per launch (the flat "
         f"launch with its constants in a __device__ array, same card: 0.527-0.533 ms)")
    extra["mega"] = dict(s_model_max_abs_err=worst, interleaved_bit_equal=same,
                         s_model_ms=0.5 * (turns[1] + turns[2]))


def _s_on_the_terrain_map(dev):
    """XBot-S envs (`humanoid_s_ppo`, solver mega) on the map of phase 4t's
    task: the same terrain config with no Froude height scale, so the same
    grid; placed by `init_state`, LAND_STEPS policy steps at the default
    pose."""
    import torch

    from humanoid_gym_tpu_torch import registry

    terrain = registry.get_task(TERRAIN_TASK).make_env_cfg().terrain

    def ov(cfg):
        cfg.terrain = terrain
        cfg.sim.solver.solver_type = "mega"

    env, cfg = registry.make_env("humanoid_s_ppo", num_envs=N_ENVS, cfg_overrides=ov, device=dev,
                                 seed=0)
    state = env.init_state()
    zero = torch.zeros((N_ENVS, cfg.env.num_actions), device=dev)
    for _ in range(LAND_STEPS):
        state, _ = env.step(state, zero)
    return env, cfg, state.phys, env.default_dof_pos.expand(N_ENVS, -1).contiguous()


def _phase10t_two_models_terrain(c, landed_l, extra):
    """Phase 10t: the terrain variant under XBot-S's constants against the
    plain XBot-S terrain step, on S robots landed on phase 4t's map (4096
    envs over 1 and 5 policy steps); then XBot-L (phase 4t's landed states)
    and XBot-S terrain launches interleaved on one stream; both timed in
    turns."""
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG

    st_l, tgt_l, step_l = landed_l
    env, cfg, st_s, tgt_s = _s_on_the_terrain_map(c.dev)
    step_s = MG.make_mega_step_batched(env.model, cfg.sim.dt, cfg.control.decimation,
                                       env.p_gains, env.d_gains, env.torque_limits,
                                       iterations=c.iters, terrain_map=env.terrain_map)
    if step_s.terrain != step_l.terrain:
        raise AssertionError("the XBot-S envs are not on phase 4t's map")
    tols = _mega_tols(c.sim_dt)

    def kernel(step, st, tgt):
        in2 = step.terrain_patches(st.qpos, st.slope_bias)
        return MG.unpack_outputs(MG.mega_kernel_launch(
            MG.pack_inputs(*_phys_args(st, tgt)), step.consts_dev, c.sim_dt, c.dec, c.iters, 1.0,
            packed2=in2, terrain=step.terrain))

    def plain(st, tgt):
        in2 = step_s.terrain_patches(st.qpos, st.slope_bias)
        return MG.mega_step_plain(env.model, c.sim_dt, c.dec, env.p_gains, env.d_gains,
                                  env.torque_limits, c.iters, 1.0, *_phys_args(st, tgt), in2=in2,
                                  terrain=step_s.terrain)

    worst = 0.0
    for n_steps in (1, 5):
        sk, sp = st_s, st_s
        for _ in range(n_steps):
            ok, op = kernel(step_s, sk, tgt_s), plain(sp, tgt_s)
            sk, sp = c.advance(sk, ok), c.advance(sp, op)
        torch.cuda.synchronize()
        errs = _mega_errors(ok, op)
        finite = all(bool(torch.isfinite(t).all()) for t in ok)
        _log(f"phase 10t mega terrain, XBot-S constants: {N_ENVS} envs, {n_steps} step(s) | "
             + " ".join(f"{k} {v:.3e}/{tols[k]:.0e}" for k, v in errs.items())
             + f" | finite {finite} | base height {float(ok[0][:, 2].mean()):.3f} m")
        bad = {k: v for k, v in errs.items() if not v <= tols[k]}
        if bad or not finite:
            raise AssertionError(f"terrain mega kernel with XBot-S constants disagrees with the "
                                 f"plain XBot-S terrain step: {bad}")
        worst = max(worst, max(errs.values()))
    steps = {"L": step_l, "S": step_s}
    runs = {name: (MG.pack_inputs(*_phys_args(st, tgt)),
                   steps[name].terrain_patches(st.qpos, st.slope_bias))
            for name, st, tgt in (("L", st_l, tgt_l), ("S", st_s, tgt_s))}

    def launch(name, packed, in2):
        return MG.mega_kernel_launch(packed, steps[name].consts_dev, c.sim_dt, c.dec, c.iters, 1.0,
                                     packed2=in2, terrain=steps[name].terrain)

    same = _interleave(runs, launch)
    if not same:
        raise AssertionError("interleaved XBot-L / XBot-S terrain launches differ from the lone "
                             "launches")
    turns = [_time_ms(lambda n=n: launch(n, *runs[n]), reps=20) for n in ("L", "S", "S", "L")]
    _log(f"phase 10t two models in one stream (terrain): L, S, L, S queued with no "
         f"synchronisation, each bit-equal to its lone launch: {same} | {N_ENVS} envs, in turns "
         f"L {turns[0]:.3f} | S {turns[1]:.3f} | S {turns[2]:.3f} | L {turns[3]:.3f} ms per "
         f"launch (the terrain launch with its constants in a __device__ array, same card: "
         f"0.546-0.558 ms)")
    extra["mega_terrain"] = dict(s_model_max_abs_err=worst, interleaved_bit_equal=same,
                                 s_model_ms=0.5 * (turns[1] + turns[2]))


def _joint_path(task, card, dev, timed_iters=2):
    """Phase 11 for one joint task: XBot-L + XBot-S (2048 + 2048 envs), T=60,
    solver mega, through registry.make_env -> OnPolicyRunner.learn. A first
    runner warms up with one iteration and leaves its final checkpoint (the
    list state of both sub-envs); a second loads it and runs the timed
    iterations with the launch counters zeroed just before and read just
    after; then one more iteration from its state unprofiled and one under
    the profiler. The estimator head is held on one fixed batch, the observations
    that end the warm-up iteration: its loss there with the initial weights
    against the loss after the last timed iteration must fall (the logged
    per-iteration loss is reported: each iteration measures it on its own
    rollout, whose velocity spread grows as the untrained policy's robots
    fall, so it need not fall while the head learns). Returns the launch
    counts of the timed run."""
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    def est_loss(net, obs, priv):
        lo, hi = tcfg.algorithm.estimator_slice
        with torch.no_grad():
            return float(torch.mean(torch.square(net.estimate(obs) - priv[:, lo:hi])))

    t0 = time.perf_counter()
    env, cfg = registry.make_env(task, num_envs=N_ENVS, cfg_overrides=_solver_mega, device=dev,
                                 seed=0)
    make_s = time.perf_counter() - t0
    tcfg = registry.get_task(task).make_train_cfg()
    shape = ([e.num_envs for e in env.envs], [e.model.body_mass.sum().item() for e in env.envs],
             tcfg.runner.num_steps_per_env, cfg.env.num_observations, cfg.env.num_privileged_obs,
             tcfg.policy.estimator_dim, tcfg.algorithm.estimator_coef)
    if shape[0] != [N_ENVS // 2] * 2 or not shape[1][1] < shape[1][0] or shape[2:] != (
            T_STEPS, 705, 219, 3, 1.0):
        raise AssertionError(f"{task}: not the full-width joint XBot-L + XBot-S recipe: {shape}")
    terrain = cfg.terrain.mesh_type == "trimesh"
    with tempfile.TemporaryDirectory(prefix="hgt_smoke_") as root:
        t0 = time.perf_counter()
        warm = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "warm"), seed=1)
        levels0, top = None, ""
        if terrain:
            # levels as drawn in [0, max_init_terrain_level] = [0, num_rows]:
            # a level of num_rows stands on the top row's origin
            levels0 = torch.cat([st.terrain_level for st in warm.env_state])
            rows = cfg.terrain.num_rows
            for sub, st in zip(env.envs, warm.env_state):
                at_top = st.terrain_level == rows
                want = sub.terrain_origins[rows - 1, st.terrain_type.long()]
                if not torch.equal(st.env_origin[at_top], want[at_top]):
                    raise AssertionError(f"{task}: a level of {rows} is not on row {rows - 1}")
            n_top = int((levels0 == rows).sum())
            if n_top == 0:
                raise AssertionError(f"{task}: no env drew the level {rows} on {rows} rows")
            top = f" | {n_top} envs drew level {rows} on {rows} rows, each on row {rows - 1}'s origin"
        net0 = copy.deepcopy(warm.net)
        warm.learn(1)
        batch = (warm.obs.clone(), warm.priv_obs.clone())
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        first = [json.loads(ln) for ln in open(os.path.join(root, "warm", "metrics.jsonl"))]
        timed = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "timed"), seed=2)
        timed.load(os.path.join(root, "warm", "model_1.ckpt"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
        SV.fused_solve.launches = SV.fused_dense_solve.launches = SV.apgd_solve_kernel.launches = 0
        t0 = time.perf_counter()
        timed.learn(timed_iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"mega": MG.mega_kernel_launch.launches,
                    "mega_terrain": MG.mega_kernel_launch.terrain_launches,
                    "solve_standalone": SV.fused_solve.launches,
                    "fused_dense": SV.fused_dense_solve.launches,
                    "apgd": SV.apgd_solve_kernel.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        lines = first + [json.loads(ln) for ln in open(os.path.join(root, "timed", "metrics.jsonl"))]
        fixed = (est_loss(net0, *batch), est_loss(timed.net, *batch))
    if [ln["iter"] for ln in lines] != list(range(1 + timed_iters)):
        raise AssertionError(f"{task}: metrics.jsonl iterations {[ln['iter'] for ln in lines]}")
    for ln in lines:
        for k in ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                  "Loss/estimator", "Train/mean_step_reward", "Episode/terrain_level"):
            if not np.isfinite(ln[k]):
                raise AssertionError(f"{task}: non-finite {k} = {ln[k]}")
    est = [ln["Loss/estimator"] for ln in lines]
    if not (all(np.isfinite(fixed)) and fixed[1] < fixed[0]):
        raise AssertionError(f"{task}: the estimator loss on the fixed batch did not fall: {fixed}")
    own = "mega_terrain" if terrain else "mega"
    want = 2 * T_STEPS * timed_iters  # one launch per sub-env and policy step
    if launches[own] != want or any(v for k, v in launches.items() if k != own):
        raise AssertionError(f"{task}: launches {launches}, expected {own} = {want} only")
    mean_ms = wall_ms / timed_iters
    iter_ms = [ln["Perf/iter_time"] * 1e3 for ln in lines[1:]]
    _log(f"phase 11 joint path: {task} XBot-L + XBot-S {N_ENVS // 2} + {N_ENVS // 2} envs "
         f"T={T_STEPS} solver mega through registry.make_env -> OnPolicyRunner.learn | env built in "
         f"{make_s:.1f} s, warm-up {warm_s:.1f} s | {timed_iters} iterations in {wall_ms:.1f} ms "
         f"(dispatch to dispatch: {', '.join(f'{x:.1f}' for x in iter_ms)} ms) | "
         f"{T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | {own} launches {launches[own]} "
         f"(= 2 x {T_STEPS} x {timed_iters}), "
         f"{'flat' if terrain else 'terrain'} {launches['mega' if terrain else 'mega_terrain']} | "
         f"estimator loss on the fixed batch {fixed[0]:.4g} -> {fixed[1]:.4g}, logged "
         f"{', '.join(f'{x:.4g}' for x in est)} (iterations 0-{timed_iters}) | "
         f"value_loss {lines[-1]['Loss/value_function']:.4g} mean_step_reward "
         f"{lines[-1]['Train/mean_step_reward']:.4g}{top} | peak mem {peak_gib:.2f} GiB | {card}")
    t0 = time.perf_counter()
    timed._train_iter(timed.train_state, timed.env_state, timed.obs, timed.priv_obs, timed.gen)
    torch.cuda.synchronize()
    plain_iter_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed._train_iter(timed.train_state, timed.env_state, timed.obs, timed.priv_obs, timed.gen)
        torch.cuda.synchronize()
    _profile_line(f"phase 11 profile ({task}, one iteration; unprofiled {plain_iter_ms:.1f} ms)",
                  prof, plain_iter_ms, "iteration")
    return launches


def _roll_policy(task, policy, vx, terrain, dev, n_steps=400):
    """Roll a shipped actor (loaded by actor_critic_from_npz) on 4096 envs of
    `task` with the deployment-clean overrides of tests/test_xbots.py:71-83
    (no noise, pushes, friction / mass DR, action delay or noise, no
    heading command; `terrain` keeps the task's map and curriculum
    placement, else flat), solver mega, the command held at (vx, 0, 0), for
    n_steps policy steps through the kernel. Returns (share of envs that
    never fell, median forward distance in m; a fallen env counts the
    distance it had walked when it fell)."""
    import torch

    from humanoid_gym_tpu_torch import HGT_ROOT_DIR, registry
    from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic

    def ov(cfg):
        if not terrain:
            cfg.terrain.mesh_type = "plane"
            cfg.terrain.curriculum = False
        cfg.noise.add_noise = False
        cfg.domain_rand.push_robots = False
        cfg.domain_rand.randomize_friction = False
        cfg.domain_rand.randomize_base_mass = False
        cfg.domain_rand.action_delay = 0.0
        cfg.domain_rand.action_noise = 0.0
        cfg.commands.heading_command = False
        cfg.sim.solver.solver_type = "mega"

    env, cfg = registry.make_env(task, num_envs=N_ENVS, cfg_overrides=ov, device=dev, seed=0)
    net = ActorCritic(cfg.env.num_observations, cfg.env.num_privileged_obs, cfg.env.num_actions,
                      seed=0).to(dev)
    actor_critic_from_npz(net, os.path.join(HGT_ROOT_DIR, "resources", "policies", f"{policy}.npz"))
    state, obs, _ = env.reset_all()
    cmd = torch.tensor([vx, 0.0, 0.0, 0.0], device=dev).expand(N_ENVS, 4).contiguous()
    x0 = state.phys.qpos[:, 0].clone()
    alive = torch.ones(N_ENVS, dtype=torch.bool, device=dev)
    dist = torch.zeros(N_ENVS, device=dev)
    with torch.no_grad():
        for _ in range(n_steps):
            state = state.replace(commands=cmd)
            state, tr = env.step(state, net.act(obs)[0])
            obs = tr.obs
            alive &= ~(tr.done & ~tr.time_out)
            dist = torch.where(alive, state.phys.qpos[:, 0] - x0, dist)
    torch.cuda.synchronize()
    return float(alive.float().mean()), float(dist.median())


def _phase12_trained_policies(card, dev):
    """Phase 12: the repo's trained policies on the card through the kernel,
    400 policy steps at 4096 envs: (a) the flat walk demo on XBot-L, (b) the
    joint (footing) demo on XBot-S at the Froude-scaled command, both gated;
    (c) the footing demo on the rubble map through B1t, reported."""
    import math

    from humanoid_gym_tpu_torch.config.xbots import SCALE
    from humanoid_gym_tpu_torch.physics import mega as MG

    vx_s = 0.4 * math.sqrt(SCALE)
    cases = (("a", "humanoid_ppo", "xbotl_walk_demo", 0.4, False, 0.8),
             ("b", "humanoid_s_ppo", "xbotl_footing_demo", vx_s, False, 0.5 * vx_s * 4.0),
             ("c", "humanoid_ppo_rubble", "xbotl_footing_demo", 0.4, True, None))
    for tag, task, policy, vx, terrain, need in cases:
        n0 = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
        t0 = time.perf_counter()
        survived, median = _roll_policy(task, policy, vx, terrain, dev)
        seconds = time.perf_counter() - t0
        n1 = (MG.mega_kernel_launch.launches - n0[0], MG.mega_kernel_launch.terrain_launches - n0[1])
        if n1 != ((0, 401) if terrain else (401, 0)):
            raise AssertionError(f"phase 12 ({tag}): kernel launches (flat, terrain) {n1}")
        gate = "reported, not gated" if need is None else f"gate >= 0.95 and >= {need:.3f} m"
        _log(f"phase 12 ({tag}) trained policy: {policy} on {task}, {N_ENVS} envs, vx "
             f"{vx:.4f} m/s, 400 steps (4 s) in {seconds:.1f} s | survived {survived:.4f}, median "
             f"forward distance {median:.3f} m ({gate}) | {card}")
        if need is not None and not (survived >= 0.95 and median >= need):
            raise AssertionError(f"phase 12 ({tag}): {policy} on {task} survived {survived}, "
                                 f"median {median} m")


def _phase6_apgd(c, st1, tgt1, records):
    """Phase 6: the APGD kernel against its plain version, operands as
    `resolve_contacts` builds them; st1 / tgt1 are the 4096-env state."""
    import torch

    from humanoid_gym_tpu_torch.physics import solve as SV

    iters = c.iters
    worst = 0.0
    for n in DENSE_SIZES:
        apgd_in = _apgd_operands(c, *((st1, tgt1) if n == N_ENVS else _one_step_in(c, n)))
        for n_it in ((iters, 50) if n == N_ENVS else (iters,)):
            l_k = SV.apgd_solve_kernel(*apgd_in, iterations=n_it)
            l_p = SV.apgd_solve_kernel_plain(*apgd_in, iterations=n_it)
            torch.cuda.synchronize()
            el = _maxerr(l_k, l_p)
            finite = bool(torch.isfinite(l_k).all())
            _log(f"phase 6 apgd: {n} env(s), {n_it} iters | max|dlam| {el:.3e} (tol 2e-3) | "
                 f"max|lam| {float(l_p.abs().max()):.3f} | finite {finite}")
            if not (el <= 2e-3 and finite):
                raise AssertionError(f"APGD kernel disagrees with its plain version at {n} envs, "
                                     f"{n_it} iterations: {el}")
            worst = max(worst, el)
        if n == N_ENVS:
            ms_k = _time_ms(lambda: SV.apgd_solve_kernel(*apgd_in, iterations=iters), reps=20)
            ms_0 = _time_ms(lambda: SV.apgd_solve_kernel(*apgd_in, iterations=0), reps=20)
            ms_p = _time_ms(lambda: SV.apgd_solve_kernel_plain(*apgd_in, iterations=iters),
                            reps=3)
            nbytes = 4 * (sum(t.numel() for t in apgd_in) + N_ENVS * 60)
            b_ms, b_by = _bound_ms(nbytes, N_ENVS * apgd_ops(iters))
            _log(f"phase 6 apgd timing: kernel {ms_k:.4f} ms (with 0 iterations {ms_0:.4f} ms: "
                 f"load and set-up; the loop {ms_k - ms_0:.4f} ms) plain {ms_p:.3f} ms bound "
                 f"{b_ms:.5f} ms ({b_by}; {nbytes / N_ENVS:.0f} bytes and {apgd_ops(iters)} "
                 f"operations per env)")
    records["apgd"] = dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)


def _phase7_fused_dense(c, st1, tgt1, ops_in, records):
    """Phase 7: the fused dense kernel against its plain version, operands
    as `make_substep` builds them, and against the factor-form solve on
    `ops_in` (the same 4096-env state in the solver-internal order)."""
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV

    iters = c.iters
    worst = 0.0
    for n in DENSE_SIZES:
        fused_in = _fused_operands(c, *((st1, tgt1) if n == N_ENVS else _one_step_in(c, n)))
        q_k, l_k = SV.fused_dense_solve(*fused_in, iterations=iters)
        q_p, l_p = SV.fused_dense_solve_plain(*fused_in, iterations=iters)
        torch.cuda.synchronize()
        eq, el = _maxerr(q_k, q_p), _maxerr(l_k, l_p)
        finite = bool(torch.isfinite(q_k).all() and torch.isfinite(l_k).all())
        line = (f"phase 7 fused dense: {n} env(s), {iters} iters | max|dqvel| {eq:.3e} (tol 5e-4) "
                f"max|dlam| {el:.3e} (tol 2e-3) | finite {finite}")
        if n == N_ENVS:
            ms_k = _time_ms(lambda: SV.fused_dense_solve(*fused_in, iterations=iters), reps=20)
            ms_0 = _time_ms(lambda: SV.fused_dense_solve(*fused_in, iterations=0), reps=20)
            ms_p = _time_ms(lambda: SV.fused_dense_solve_plain(*fused_in, iterations=iters),
                            reps=3)
            nbytes = 4 * (sum(t.numel() for t in fused_in) + N_ENVS * (18 + 60))
            b_ms, b_by = _bound_ms(nbytes, N_ENVS * fused_dense_ops(iters))
            line += (f" | kernel {ms_k:.4f} ms (with 0 iterations {ms_0:.4f} ms: load, "
                     f"factorisation, Gram bound and A; the loop {ms_k - ms_0:.4f} ms) plain "
                     f"{ms_p:.3f} ms bound {b_ms:.5f} ms ({b_by}; {nbytes / N_ENVS:.0f} bytes and "
                     f"{fused_dense_ops(iters)} operations per env with the symmetric halves of "
                     f"A and of the Gram matrix counted once; the kernel executes "
                     f"{fused_dense_ops(iters, executed=True)})")
            dense_in = fused_in
        _log(line)
        if not (eq <= 5e-4 and el <= 2e-3 and finite):
            raise AssertionError(f"fused dense kernel disagrees with its plain version at {n} "
                                 f"envs: {eq}, {el}")
        worst = max(worst, eq, el)
    records["fused_dense"] = dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                  bound_by=b_by)
    # dense form (external DOF order) vs factor form (solver-internal order):
    # the step bound differs with the DOF order, so the two follow different
    # iterates and meet at convergence. 200 iterations are reported (the
    # worst of 4096 envs is not converged there); 1000 are held to 1e-3.
    for n_it, tol in ((200, None), (1000, 1e-3)):
        q_dense, _ = SV.fused_dense_solve(*dense_in, iterations=n_it)
        q_fact, _ = SV.fused_solve(*ops_in, iterations=n_it)
        torch.cuda.synchronize()
        per_env = (q_dense - q_fact[:, MG.INV_PERM]).abs().amax(dim=1)
        e23 = float(per_env.max())
        p999 = float(per_env.sort().values[int(N_ENVS * 0.999)])
        _log(f"phase 7 dense vs factor form at {n_it} iters: max|dqvel| {e23:.3e} "
             f"(99.9th percentile of envs {p999:.3e})"
             + (f" (tol {tol:.0e})" if tol else " (reported, not held)"))
        if tol is not None and not e23 <= tol:
            raise AssertionError(f"dense and factor-form solves disagree at convergence: {e23}")


# ---- phase 14: play on the card ----

PLAY_STEPS = 1200
PLAY_MIN_VX = 0.25  # mean base_vel_x at the 0.5 m/s command
# the first 20 noise-free play steps on the card (the kernel) against the
# same rollout on the CPU (the plain mega step): phase 4 holds 5 steps of
# the kernel to the JAX package's tolerances (qpos 5e-4, qvel 1e-2, tau
# 5e-2) on perturbed states, where it measured ~5e-4 in qvel; 20 steps are
# four times as many, and each step's difference carries into the next, so
# this check allows four times those tolerances: joint positions and the
# joint targets (rad) 2e-3, joint and base velocities 4e-2, torque 0.2 N m
PLAY_CMP_STEPS = 20
PLAY_TOLS = {"dof_pos_target": 2e-3, "dof_pos": 2e-3, "dof_vel": 4e-2, "base_vel_x": 4e-2,
             "base_vel_y": 4e-2, "base_vel_z": 4e-2, "base_vel_yaw": 4e-2, "dof_torque": 0.2}


def _env_state_to(state, dev):
    """An EnvState (nested dataclasses of tensors) on another device."""
    import dataclasses

    return type(state)(**{
        f.name: (_env_state_to(getattr(state, f.name), dev)
                 if dataclasses.is_dataclass(getattr(state, f.name))
                 else getattr(state, f.name).to(dev))
        for f in dataclasses.fields(state)})


def _demo_actor(dev):
    """The walk demo's actor as a float32 policy obs -> action on dev."""
    import torch

    from humanoid_gym_tpu_torch import HGT_ROOT_DIR
    from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic

    net = ActorCritic(705, 219, 12, compute_dtype="float32", seed=0).to(dev)
    actor_critic_from_npz(net, os.path.join(HGT_ROOT_DIR, "resources", "policies",
                                            "xbotl_walk_demo.npz"))

    def policy(obs):
        with torch.no_grad():
            return net.act(obs)[0]

    return policy


def _play_card_vs_cpu(dev, PT):
    """The first PLAY_CMP_STEPS steps of `play_rollout` with noise off, on
    the card and on the CPU from one state (the CPU env's reset), with the
    walk demo's float32 actor on both; the card's run counts its host
    synchronisations (CUDA sync debug mode). Returns (max error per trace,
    a Counter of the synchronisations by source line, falls on the
    card)."""
    import warnings
    from collections import Counter

    import numpy as np
    import torch

    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env

    def cfg():
        c = XBotLCfg()
        PT.play_overrides(c)
        c.noise.add_noise = False
        c.sim.solver.solver_type = "mega"
        return c

    cpu = torch.device("cpu")
    cenv, genv = make_env(cfg(), device=cpu, seed=0), make_env(cfg(), device=dev, seed=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one env's tiny tensors: more threads only add overhead
    try:
        state, obs, _ = cenv.reset_all()
        _, _, want, _ = PT.play_rollout(cenv, _demo_actor(cpu), state, obs, PLAY_CMP_STEPS)
    finally:
        torch.set_num_threads(threads)
    gstate, gobs, gpol = _env_state_to(state, dev), obs.to(dev), _demo_actor(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, _, got, falls = PT.play_rollout(genv, gpol, gstate, gobs, PLAY_CMP_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in PLAY_TOLS}
    return errs, where, falls


def _phase14_play(card, dev):
    """Phase 14: `play(get_args([...]))` of scripts/play_torch.py on the
    card (HGT_PLAY_VIDEO=0) for a humanoid_ppo checkpoint whose actor is the
    walk demo's: the mega kernel launched once per policy step of the
    rollout and no plain mega step, the exported policy.npz equal to the
    demo's arrays, a finite trace, no fall, the demo walking at the 0.5
    command; then the first 20 noise-free steps against the CPU. Returns
    the rollout's kernel launches."""
    import numpy as np

    import scripts.play_torch as PT
    from humanoid_gym_tpu_torch import HGT_ROOT_DIR, registry
    from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.utils.helpers import get_args

    demo = os.path.join(HGT_ROOT_DIR, "resources", "policies", "xbotl_walk_demo.npz")
    counts = {}
    real_rollout, real_plain = PT.play_rollout, MG.mega_step_plain

    def plain_counted(*a, **k):
        counts["plain"] += 1
        return real_plain(*a, **k)

    def rollout_counted(*a, **k):
        MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
        counts["plain"] = 0
        out = real_rollout(*a, **k)
        counts.update(flat=MG.mega_kernel_launch.launches,
                      terrain=MG.mega_kernel_launch.terrain_launches)
        return out

    with tempfile.TemporaryDirectory() as root:
        env, _ = registry.make_env("humanoid_ppo", num_envs=1, cfg_overrides=_solver_mega,
                                   device=dev, seed=0)
        runner = OnPolicyRunner(env, registry.get_task("humanoid_ppo").make_train_cfg(),
                                log_dir=None)
        actor_critic_from_npz(runner.net, demo)
        os.makedirs(os.path.join(root, "run0"))
        runner.save(os.path.join(root, "run0", "model_1.ckpt"))
        os.environ["HGT_PLAY_VIDEO"] = "0"
        PT.play_rollout, MG.mega_step_plain = rollout_counted, plain_counted
        t0 = time.perf_counter()
        try:
            res = PT.play(get_args(["--task", "humanoid_ppo", "--log_root", root]))
        finally:
            PT.play_rollout, MG.mega_step_plain = real_rollout, real_plain
        play_s = time.perf_counter() - t0
        exported = np.load(os.path.join(root, "exported", "policies", "policy.npz"))
        shipped = np.load(demo)
        same = exported.files == shipped.files and all(
            np.array_equal(exported[k], shipped[k]) for k in shipped.files)
        trace = dict(np.load(res["trace"]))
    finite = all(bool(np.isfinite(v).all()) for v in trace.values())
    mean_vx = float(trace["base_vel_x"].mean())
    errs, where, falls20 = _play_card_vs_cpu(dev, PT)
    syncs = sum(where.values())
    _log(f"phase 14 play: scripts/play_torch.py play() on the card, humanoid_ppo, 1 env, "
         f"{PLAY_STEPS} steps at vx 0.5 | rollout {res['rollout_s']:.2f} s "
         f"({res['rollout_s'] / PLAY_STEPS * 1e3:.2f} ms a step), play() {play_s:.1f} s | mega "
         f"launches {counts['flat']} (terrain {counts['terrain']}, plain steps {counts['plain']}) | "
         f"export equal to the shipped demo {same} | trace keys {len(trace)}, finite {finite}, "
         f"falls {res['falls']}, mean base_vel_x {mean_vx:.4f} m/s (gate >= {PLAY_MIN_VX}), mean "
         f"reward {float(trace['reward'].mean()):.4f} | dashboard {res['dashboard']}, video "
         f"{res['video']} | {card}")
    _log(f"phase 14 play, card vs CPU: {PLAY_CMP_STEPS} noise-free steps from one state, the "
         f"kernel against the plain mega step | " + " ".join(
             f"{k} {v:.3e}/{PLAY_TOLS[k]:.0e}" for k, v in errs.items())
         + f" | host synchronisations on the card {syncs} ({syncs / PLAY_CMP_STEPS:.2f} a step; "
         f"by source {dict(where.most_common(6))}) | falls {falls20}")
    if counts != {"flat": PLAY_STEPS, "terrain": 0, "plain": 0}:
        raise AssertionError(f"phase 14: launches in the play rollout {counts}")
    if not (same and finite and res["falls"] == 0 and mean_vx >= PLAY_MIN_VX):
        raise AssertionError(f"phase 14: export equal {same}, finite {finite}, falls "
                             f"{res['falls']}, mean base_vel_x {mean_vx}")
    bad = {k: v for k, v in errs.items() if not v <= PLAY_TOLS[k]}
    if bad or falls20:
        raise AssertionError(f"phase 14: the card's play rollout differs from the CPU's: {bad}")
    return counts["flat"]


# ---- phase 15: the learning-curve band on the card ----

def _phase15_learning_band(card, dev):
    """Phase 15: the seeded 16-env run of tests/test_learning_regression.py
    (seed 5, T=60, 12 iterations through make_train_iter) with solver mega
    on the card, held to that test's bands unchanged. Returns the mega
    launches of the run."""
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.utils.learning_band import band_misses, learning_curve

    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    t0 = time.perf_counter()
    c = learning_curve(device=dev, solver="mega", seed=5, n=16, T=60, iters=12)
    seconds = time.perf_counter() - t0
    launches = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
    misses = band_misses(c)
    _log(f"phase 15 learning band: XBot-L 16 envs, seed 5, T=60, 12 iterations, solver mega, "
         f"{seconds:.1f} s | mega launches {launches[0]} (terrain {launches[1]}) | late step reward "
         f"{c['late_rew']:.4f} [0.006, 0.030], late episode length {c['late_len']:.1f} [100, 280], "
         f"tracking_lin_vel {c['terms']['tracking_lin_vel']:.4f} (>= 0.016), feet_contact_number "
         f"{c['terms']['feet_contact_number']:.4f} (>= 0.020), value loss "
         f"{c['vloss'][0]:.4f} -> {c['vloss'][-1]:.4f}, non-finite resets {c['nonfinite']} | "
         f"misses {misses} | {card}")
    if launches != (1 + 12 * 60, 0):  # the reset step, then one launch per policy step
        raise AssertionError(f"phase 15: mega launches (flat, terrain) {launches}")
    if misses:
        raise AssertionError(f"phase 15: the port's learning curve misses {misses}")
    return launches[0]


# ---- phases 16-19: the measurement tools on the card ----

# timed calls per stage after the warm-up (the stage times' median)
LP_REPS = 3
CONFIG4_ENVS = 16384
CONFIG4_TIMEOUT_S = 600
MIN_ATTRIBUTED = 0.95
# phase 16's profiled `full` iteration against phase 5b's profiled
# iteration: the same train_iter at the same width, so the device-busy
# times agree within this ratio unless a window lost events
BUSY_RATIO = (0.8, 1.25)


def _phase16_learn_profile(card, dev, busy5_ms):
    """Phase 16: scripts/learn_profile_torch.py at 4096 envs, T=60, every
    stage: 60 mega launches per full and rollout call, finite positive
    times, device time at most wall time, and full's device time within
    BUSY_RATIO of phase 5b's profiled iteration (busy5_ms). Returns the
    summary."""
    import math

    from scripts import learn_profile_torch as LP

    t0 = time.perf_counter()
    s = LP.profile_stages(envs=N_ENVS, reps=LP_REPS, horizon=T_STEPS, device=dev)
    seconds = time.perf_counter() - t0
    wall, dms = s["stages_ms"], s["device_ms"]
    upd = s["n_updates"] * wall["update1"]
    parts = wall["rollout"] + wall["gae"] + wall["permute"] + upd
    _log(f"phase 16 learn profile: scripts/learn_profile_torch.py, XBot-L {N_ENVS} envs T={T_STEPS} "
         f"solver {s['solver']}, {LP_REPS} reps, {seconds:.1f} s | stage wall / device ms (share): "
         + ", ".join(f"{k} {wall[k]:.3f} / {dms[k]:.3f} ({dms[k] / wall[k]:.3f})" for k in LP.STAGES)
         + f" | rollout + gae + permute + {s['n_updates']} x update1 = {parts:.1f} ms against full "
         f"{wall['full']:.1f} ms ({parts / wall['full']:.3f}) | mega launches {s['mega_launches']} | "
         f"full's device ms against phase 5b's {busy5_ms} ms: "
         + (f"{dms['full'] / busy5_ms:.3f}" if busy5_ms else "no phase 5b number")
         + f" | {card}")
    bad = [k for k in LP.STAGES if k not in wall or not (
        math.isfinite(wall[k]) and math.isfinite(dms[k]) and 0 < dms[k] <= wall[k])]
    launches = s["mega_launches"]
    if bad or any(n != T_STEPS for k in ("full", "rollout") for n in launches[k]):
        raise AssertionError(f"phase 16: stages {bad} out of bounds or launches {launches}")
    if not busy5_ms or not BUSY_RATIO[0] <= dms["full"] / busy5_ms <= BUSY_RATIO[1]:
        raise AssertionError(f"phase 16: full's device time {dms['full']} ms against phase 5b's "
                             f"{busy5_ms} ms is outside {BUSY_RATIO}")
    return s


def _phase17_config4(card):
    """Phase 17: scripts/config4_dryrun_torch.py at 16,384 envs, T=60, one
    rank, in its own process (so its memory counts alone): 120 terrain
    launches and no flat one in the timed iteration, a finite value loss, a
    peak below the card's memory. Returns the script's record."""
    import math

    import torch

    torch.cuda.empty_cache()  # this process's cached blocks, so the dry run has the card
    with tempfile.TemporaryDirectory(prefix="hgt_smoke_") as tmp:
        out = os.path.join(tmp, "config4.json")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.join(HERE, "scripts", "config4_dryrun_torch.py"),
                              "--envs", str(CONFIG4_ENVS), "--horizon", str(T_STEPS), "--out", out],
                             capture_output=True, text=True, timeout=CONFIG4_TIMEOUT_S, cwd=HERE)
        seconds = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"phase 17: config4_dryrun_torch.py exited {run.returncode}:\n"
                                 f"{run.stdout[-3000:]}\n{run.stderr[-6000:]}")
        with open(out) as f:
            r = json.load(f)
    gib = 2**30
    peak, proj, total = r["measured_T60_peak_bytes"], r["projection_T60_per_device_bytes"], \
        r["card_total_memory_bytes"]
    _log(f"phase 17 config4: scripts/config4_dryrun_torch.py {r['task']} {r['envs']} envs "
         f"({r['mesh']}) T={r['horizon']} solver {r['solver']}, {seconds:.1f} s in all | set-up "
         f"{r['setup_s']:.1f} s, warm-up {r['warmup_s']:.1f} s, iteration {r['iter_s']:.2f} s | "
         f"launches {r['mega_launches']} | value_loss {r['value_loss']:.4g} | measured peak "
         f"{peak / gib:.2f} GiB against the JAX formula's projection {proj / gib:.2f} GiB "
         f"({peak / proj:.3f}x) of {total / gib:.2f} GiB | live after set-up "
         f"{r['per_rank_live_bytes_after_setup']['0'] / gib:.2f} GiB, after the iteration "
         f"{r['per_rank_live_bytes_after_iter']['0'] / gib:.2f} GiB | env state "
         f"{r['env_state_bytes_per_env']:.1f} B an env ({r['env_state_bytes_total'] / gib:.3f} GiB), "
         f"rollout at T {r['rollout_bytes_total_at_T'] / gib:.3f} GiB, peak "
         f"{peak / r['envs']:.0f} B an env | host peak RSS {r['host_peak_rss_bytes'] / gib:.2f} GiB"
         f" | {r['device']}")
    if (r["mega_launches"] != {"flat": 0, "terrain": 2 * T_STEPS} or not math.isfinite(r["value_loss"])
            or not (peak and peak < total)):
        raise AssertionError(f"phase 17: launches {r['mega_launches']}, value_loss {r['value_loss']}, "
                             f"peak {peak} of {total}")
    return r


def _phase18_sass_census(card):
    """Phase 18: the SASS census of B1 and B1t: the -lineinfo cubin's count
    equal to the loaded library's for both instances, at least
    MIN_ATTRIBUTED of the instructions on a line of the kernel's sources."""
    from humanoid_gym_tpu_torch.physics.sass_census import mega_census
    from humanoid_gym_tpu_torch.utils.roofline import mega_ops_executed, mega_terrain_ops_executed

    t0 = time.perf_counter()
    both = mega_census(opcodes=12, lines=20)
    seconds = time.perf_counter() - t0
    for key, dyn in (("flat", mega_ops_executed(1, 8)), ("terrain", mega_terrain_ops_executed(1, 8))):
        c = both[key]
        _log(f"phase 18 SASS census {key} ({c['function']}), {seconds:.1f} s: {c['instructions']} "
             f"instructions with -lineinfo, {c['production_instructions']} in the loaded library | "
             f"{c['attributed_share'] * 100:.2f}% on a line of mega.cu / solve.cuh / apgd.cuh | per "
             f"file {c['per_file']}, innermost {c['per_innermost_file']} | top opcodes "
             + ", ".join(f"{k} {v}" for k, v in c["top_opcodes"]) + " | top lines "
             + ", ".join(f"{k} {v}" for k, v in c["top_lines"])
             + f" | static count, a loop body once; dynamic by hand for one substep: {dyn:,} f32 "
             f"operations a warp ({dyn // 32:,} warp instructions) | {card}")
        if c["instructions"] != c["production_instructions"] or c["attributed_share"] < MIN_ATTRIBUTED:
            raise AssertionError(f"phase 18 ({key}): {c['instructions']} against "
                                 f"{c['production_instructions']}, attributed {c['attributed_share']}")
    return both


def _phase19_roofline_and_example(card, dev, iter_ms):
    """Phase 19: the roofline CLI at phase 5's measured iteration time (its
    total equal to iteration_flops), then the example at 8 envs on the
    card (3 finite iterations, one mega launch a policy step)."""
    import math

    import examples.minimal_train_loop_torch as EX
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.utils.roofline import iteration_flops
    from scripts import roofline_torch as RL

    c = RL.main(["--envs", str(N_ENVS), "--iter-ms", repr(iter_ms)])
    sh = c["shares"]
    _log(f"phase 19 roofline: scripts/roofline_torch.py --iter-ms {iter_ms:.1f} (phase 5's mean) | "
         f"total {c['total_flops']:,} FLOP (iteration_flops {iteration_flops(N_ENVS):,}), bytes "
         f"{c['total_bytes']:,} | shares of the data sheet's peaks: FLOPs / bf16 "
         f"{sh['flops_share_of_bf16_peak']:.6f}, physics / f32 {sh['physics_share_of_f32_peak']:.6f}, "
         f"bytes / HBM {sh['bytes_share_of_hbm_peak']:.6f}, physics issued "
         f"{sh['physics_issued_ops_per_s'] / 1e12:.4f} T f32 ops/s | {card}")
    if c["total_flops"] != iteration_flops(N_ENVS):
        raise AssertionError(f"phase 19: the CLI's total {c['total_flops']} != iteration_flops")
    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    t0 = time.perf_counter()
    history, action = EX.main(num_envs=8, iterations=3, horizon=8, device=dev)
    seconds = time.perf_counter() - t0
    launches = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
    finite = all(math.isfinite(v) for h in history for v in h.values()) and bool(
        action.isfinite().all())
    _log(f"phase 19 example: examples/minimal_train_loop_torch.py, 8 envs, horizon 8, 3 iterations "
         f"in {seconds:.1f} s | {history} | mega launches {launches} | finite {finite} | {card}")
    if len(history) != 3 or not finite or launches != (1 + 3 * 8, 0):
        raise AssertionError(f"phase 19: example history {history}, launches {launches}")
    return c


# ---- phase 5c: the runner's HGT_PROFILE_DIR trace ----

def _phase5c_profile_dir(card, dev):
    """Phase 5c: OnPolicyRunner.learn(2) at 4096 envs (humanoid_ppo, solver
    mega) with HGT_PROFILE_DIR set: one Chrome trace of the second
    iteration, naming the mega kernel once per policy step."""
    import json as _json

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    with tempfile.TemporaryDirectory() as prof_dir:
        env, _ = registry.make_env("humanoid_ppo", num_envs=N_ENVS, cfg_overrides=_solver_mega,
                                   device=dev, seed=1)
        runner = OnPolicyRunner(env, registry.get_task("humanoid_ppo").make_train_cfg(),
                                log_dir=None)
        os.environ["HGT_PROFILE_DIR"] = prof_dir
        t0 = time.perf_counter()
        try:
            runner.learn(2)
        finally:
            del os.environ["HGT_PROFILE_DIR"]
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(prof_dir))
        if files != ["trace_iter1.json"]:
            raise AssertionError(f"phase 5c: files in HGT_PROFILE_DIR {files}")
        path = os.path.join(prof_dir, files[0])
        size = os.path.getsize(path)
        events = _json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mega = [e for e in kernels if "hgt_mega_kernel" in e.get("name", "")]
    _log(f"phase 5c HGT_PROFILE_DIR: learn(2) at {N_ENVS} envs in {seconds:.1f} s wrote {files[0]} "
         f"({size / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} kernels) | hgt_mega_kernel "
         f"{len(mega)} times (= {T_STEPS}) | {card}")
    if len(mega) != T_STEPS:
        raise AssertionError(f"phase 5c: the trace names hgt_mega_kernel {len(mega)} times")


def _kernel_class(name: str) -> str:
    if "hgt_mega" in name:
        return "mega"
    if "hgt_fused_dense" in name or "hgt_apgd" in name:
        return "dense_solve"
    if any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_")):
        return "matmul"
    return "other"


def _where_the_time_goes(env, net, pcfg, ts, state, obs, priv, gen, mean_iter_ms):
    """Phase 5b, after the main path's counters were read: one iteration
    stage by stage on CUDA events, then one under torch.profiler for the
    device time by kernel class and the device's idle share. Returns the
    profiled iteration's device-busy ms (None if the profiler saw no
    kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch.algo.ppo import make_train_pieces

    pieces = make_train_pieces(env, net, pcfg, N_ENVS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    state, obs, priv, roll, _ = pieces["rollout_phase"](ts, state, obs, priv, gen)
    ev[1].record()
    adv, ret = pieces["compute_gae"](ts, roll, priv)
    ev[2].record()
    ts, _ = pieces["update_phase"](ts, roll, adv, ret, gen)
    ev[3].record()
    torch.cuda.synchronize()
    stages = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    _log(f"phase 5b stages: rollout {stages[0]:.1f} ms, gae {stages[1]:.1f} ms, "
         f"update {stages[2]:.1f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pieces["train_iter"](ts, state, obs, priv, gen)
        torch.cuda.synchronize()
    return _profile_line("phase 5b profile", prof, mean_iter_ms, "iteration")


def _kernel_launches(fn) -> int:
    """Device kernels one call of fn() launches, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _device_time(prof):
    """(device us by kernel class, kernel launches, [(us, count, name)]) of
    a profiled window."""
    import torch

    by_class = {"mega": 0.0, "dense_solve": 0.0, "matmul": 0.0, "other": 0.0}
    launches = 0
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
        by_class[_kernel_class(e.key)] += us
        launches += e.count
        top.append((us, e.count, e.key[:60]))
    return by_class, launches, top


def _profile_line(tag, prof, window_ms, what):
    """Device time by kernel class, launch count and idle share of a
    profiled window that took window_ms. Returns the device-busy ms (None
    if the profiler saw no kernel)."""
    by_class, launches, top = _device_time(prof)
    busy_ms = sum(by_class.values()) / 1e3
    if busy_ms == 0.0:
        _log(f"{tag}: device time not measured (the profiler saw no kernels)")
        return None
    top.sort(reverse=True)
    _log(f"{tag}: device busy {busy_ms:.1f} ms of a {window_ms:.1f} ms {what} "
         f"(idle share {1.0 - busy_ms / window_ms:.3f}) over {launches} kernel launches | "
         + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in by_class.items())
         + " | top: " + "; ".join(f"{n} x{c} {u / 1e3:.1f} ms" for u, c, n in top[:5]))
    return busy_ms


def _substep_path(solver, timed_iters, resume, card):
    """Phase 8 for one solver: XBot-L PPO at 4096 envs, T=60, through
    registry.make_env -> OnPolicyRunner.learn. A first runner warms up with
    one iteration and leaves its final checkpoint; a second loads it and
    runs the timed iterations with the launch counters zeroed just before
    and read just after; with `resume`, a third loads the second's
    checkpoint and trains one more. Returns the launch counts of the timed
    run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    def ov(c):
        c.sim.solver.solver_type = solver

    env, cfg = registry.make_env("humanoid_ppo", num_envs=N_ENVS, cfg_overrides=ov, device="cuda",
                                 seed=0)
    tcfg = registry.get_task("humanoid_ppo").make_train_cfg()
    if (cfg.sim.solver.solver_type, tcfg.runner.num_steps_per_env, cfg.env.num_observations,
            cfg.env.num_privileged_obs) != (solver, T_STEPS, 705, 219):
        raise AssertionError(f"{solver}: the task is not the full-width XBot-L recipe")
    dec = cfg.control.decimation
    counters = {"mega": MG.mega_kernel_launch, "solve_standalone": SV.fused_solve,
                "fused_dense": SV.fused_dense_solve, "apgd": SV.apgd_solve_kernel}
    own = "fused_dense" if solver == "fused_pallas" else "apgd"

    def records(run_dir, first_iter, n):
        lines = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
        if [ln["iter"] for ln in lines] != list(range(first_iter, first_iter + n)):
            raise AssertionError(f"{solver}: metrics.jsonl iterations {[ln['iter'] for ln in lines]}")
        for ln in lines:
            for k in ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                      "Train/mean_step_reward"):
                if not np.isfinite(ln[k]):
                    raise AssertionError(f"{solver}: non-finite {k} = {ln[k]}")
        return lines

    with tempfile.TemporaryDirectory(prefix="hgt_smoke_") as root:
        t0 = time.perf_counter()
        warm = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "warm"), seed=1)
        warm.learn(1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        records(os.path.join(root, "warm"), 0, 1)
        ckpt = os.path.join(root, "warm", "model_1.ckpt")
        if not os.path.exists(ckpt):
            raise AssertionError(f"{solver}: no checkpoint {ckpt}")

        timed = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "timed"), seed=2)
        timed.load(ckpt)
        if timed.current_learning_iteration != 1:
            raise AssertionError(f"{solver}: resumed at {timed.current_learning_iteration}, not 1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        MG.mega_kernel_launch.terrain_launches = 0
        t0 = time.perf_counter()
        timed.learn(timed_iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        launches["mega_terrain"] = MG.mega_kernel_launch.terrain_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        lines = records(os.path.join(root, "timed"), 1, timed_iters)
        want = T_STEPS * dec * timed_iters
        if launches[own] != want or any(v for k, v in launches.items() if k != own):
            raise AssertionError(f"{solver}: launches {launches}, expected {own} = {want} only")
        last_ckpt = os.path.join(root, "timed", f"model_{1 + timed_iters}.ckpt")
        if not os.path.exists(last_ckpt):
            raise AssertionError(f"{solver}: no checkpoint {last_ckpt}")
        iter_ms = [ln["Perf/iter_time"] * 1e3 for ln in lines]
        mean_ms = wall_ms / timed_iters
        _log(f"phase 8 substep path: XBot-L {N_ENVS} envs T={T_STEPS} solver {solver} through "
             f"registry.make_env -> OnPolicyRunner.learn | warm-up {warm_s:.1f} s | "
             f"{timed_iters} iteration(s) in {wall_ms:.1f} ms (dispatch to dispatch: "
             f"{', '.join(f'{x:.1f}' for x in iter_ms)} ms) | "
             f"{T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | {own} launches "
             f"{launches[own]} (= {T_STEPS} x {dec} x {timed_iters}), mega launches "
             f"{launches['mega']} | value_loss {lines[-1]['Loss/value_function']:.4g} "
             f"mean_step_reward {lines[-1]['Train/mean_step_reward']:.4g} | peak mem "
             f"{peak_gib:.2f} GiB | {card}")

        if resume:
            again = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "resumed"), seed=3)
            again.load(last_ckpt)
            qpos_saved = timed.env_state.phys.qpos
            if not torch.equal(again.env_state.phys.qpos, qpos_saved):
                raise AssertionError(f"{solver}: the env state did not survive save -> load")
            again.learn(1)
            torch.cuda.synchronize()
            records(os.path.join(root, "resumed"), 1 + timed_iters, 1)
            if again.current_learning_iteration != 2 + timed_iters:
                raise AssertionError(f"{solver}: resumed run ended at "
                                     f"{again.current_learning_iteration}")
            _log(f"phase 8 resume: solver {solver} save -> load -> iteration "
                 f"{again.current_learning_iteration - 1} ok")

        # where the time goes on this path: two env steps under the profiler
        state, act = timed.env_state, torch.zeros((N_ENVS, cfg.env.num_actions), device=env.device)
        state, _ = env.step(state, act)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = env.step(state, act)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                state, _ = env.step(state, act)
            torch.cuda.synchronize()
        _profile_line(f"phase 8 profile ({solver}, 2 env steps = {2 * dec} substeps, unprofiled "
                      f"env step {step_ms:.1f} ms)", prof, 2 * step_ms, "window")
    return launches


def _phase9_terrain_path(card):
    """Phase 9: XBot-L terrain PPO at 4096 envs, T=60, solver mega, through
    registry.make_env -> OnPolicyRunner.learn. A first runner warms up with
    one iteration and leaves its final checkpoint; a second loads it and
    runs 2 timed iterations with the launch counters zeroed just before and
    read just after; then one more iteration from its state under the
    profiler. Returns the timed run's terrain-kernel launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    timed_iters = 2
    t0 = time.perf_counter()
    env, cfg = registry.make_env(TERRAIN_TASK, num_envs=N_ENVS, cfg_overrides=_solver_mega,
                                 device="cuda", seed=0)
    make_s = time.perf_counter() - t0
    tcfg = registry.get_task(TERRAIN_TASK).make_train_cfg()
    if (cfg.sim.solver.solver_type, tcfg.runner.num_steps_per_env, cfg.env.num_observations,
            cfg.env.num_privileged_obs, cfg.terrain.mesh_type, env.terrain_map.height_field.shape) \
            != ("mega", T_STEPS, 705, 219, "trimesh", (2100, 2100)):
        raise AssertionError("the terrain task is not the full-width XBot-L recipe on the full map")
    with tempfile.TemporaryDirectory(prefix="hgt_smoke_") as root:
        t0 = time.perf_counter()
        warm = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "warm"), seed=1)
        warm.learn(1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        timed = OnPolicyRunner(env, tcfg, log_dir=os.path.join(root, "timed"), seed=2)
        timed.load(os.path.join(root, "warm", "model_1.ckpt"))
        levels0 = timed.env_state.terrain_level.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
        SV.fused_solve.launches = SV.fused_dense_solve.launches = SV.apgd_solve_kernel.launches = 0
        t0 = time.perf_counter()
        timed.learn(timed_iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"mega_terrain": MG.mega_kernel_launch.terrain_launches,
                    "mega": MG.mega_kernel_launch.launches, "solve_standalone": SV.fused_solve.launches,
                    "fused_dense": SV.fused_dense_solve.launches,
                    "apgd": SV.apgd_solve_kernel.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        lines = [json.loads(ln) for ln in open(os.path.join(root, "timed", "metrics.jsonl"))]
    if [ln["iter"] for ln in lines] != [1, 2]:
        raise AssertionError(f"terrain path: metrics.jsonl iterations {[ln['iter'] for ln in lines]}")
    for ln in lines:
        for k in ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                  "Train/mean_step_reward", "Episode/terrain_level"):
            if not np.isfinite(ln[k]):
                raise AssertionError(f"terrain path: non-finite {k} = {ln[k]}")
    if launches["mega_terrain"] != T_STEPS * timed_iters or any(
            v for k, v in launches.items() if k != "mega_terrain"):
        raise AssertionError(f"terrain path: launches {launches}, expected mega_terrain = "
                             f"{T_STEPS * timed_iters} only")
    levels = timed.env_state.terrain_level
    if int(levels.min()) < 0 or int(levels.max()) >= cfg.terrain.num_rows:
        raise AssertionError(f"terrain levels out of range: {int(levels.min())}-{int(levels.max())}")
    changed = int((levels != levels0).sum())
    mean_ms = wall_ms / timed_iters
    iter_ms = [ln["Perf/iter_time"] * 1e3 for ln in lines]
    _log(f"phase 9 terrain path: XBot-L {N_ENVS} envs T={T_STEPS} {TERRAIN_TASK} solver mega "
         f"through registry.make_env -> OnPolicyRunner.learn | env built in {make_s:.1f} s, warm-up "
         f"{warm_s:.1f} s | {timed_iters} iterations in {wall_ms:.1f} ms (dispatch to dispatch: "
         f"{', '.join(f'{x:.1f}' for x in iter_ms)} ms) | {T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} "
         f"env steps/s | terrain-kernel launches {launches['mega_terrain']} (= {T_STEPS} x "
         f"{timed_iters}), flat {launches['mega']} | terrain level mean {float(levels.float().mean()):.3f} "
         f"(range {int(levels.min())}-{int(levels.max())}), {changed} envs changed level | "
         f"value_loss {lines[-1]['Loss/value_function']:.4g} mean_step_reward "
         f"{lines[-1]['Train/mean_step_reward']:.4g} | peak mem {peak_gib:.2f} GiB | {card}")
    t0 = time.perf_counter()
    timed._train_iter(timed.train_state, timed.env_state, timed.obs, timed.priv_obs, timed.gen)
    torch.cuda.synchronize()
    plain_iter_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed._train_iter(timed.train_state, timed.env_state, timed.obs, timed.priv_obs, timed.gen)
        torch.cuda.synchronize()
    _profile_line(f"phase 9 profile (one terrain iteration; unprofiled {plain_iter_ms:.1f} ms)",
                  prof, plain_iter_ms, "iteration")
    return launches


# ---- phase 13: env-sharded training on two ranks of the one card ----

RANKS = 2
RANK_TIMED_ITERS = 2  # after one warm-up iteration; the final checkpoint is model_3.ckpt
RANK_TIMEOUT_S = 420
# the sharded update against one process: float32 nets at the recipe's
# learning rate (1e-5), 8 Adam steps; the sums of 245,760 rows run in
# another order on two ranks, and an element of the gradient near Adam's eps
# turns its last bits into a fraction of a step, so a parameter may differ by
# a fraction of the 1e-5 step (the CPU test at 64 rows: 5.9e-7 against JAX)
SHARDED_UPDATE_TOL = 5e-6


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (on the host)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _state_tensors(d):
    """The leaves of a saved env state (nested dicts), in field order."""
    for v in d.values():
        yield from (_state_tensors(v) if isinstance(v, dict) else (v,))


def _train_state_tensors(ts):
    return [*ts.net.state_dict().values(), *ts.opt_mu.values(), *ts.opt_nu.values(), ts.lr]


def _same_on_every_rank(text: str, group) -> bool:
    """Whether every rank holds rank 0's `text`, decided through the group
    (rank 0's sha256 of it broadcast, the mismatches all-reduced)."""
    import hashlib

    import torch

    from humanoid_gym_tpu_torch.parallel import all_reduce_sum, broadcast_str

    digest = hashlib.sha256(text.encode()).hexdigest()
    differs = torch.tensor(float(broadcast_str(digest, group) != digest), device=group.device)
    (n,) = all_reduce_sum([differs], group)
    return float(n) == 0.0


def _phase13_rank(work: str, role: str) -> int:
    """One rank of phase 13, started by `_phase13_ranks` with the launcher's
    variables. Roles: "train" (2 gloo ranks: warm-up, 2 timed iterations,
    the sharded update against one process), "resume" (2 gloo ranks: load
    the final checkpoint's shards, one more iteration) and "nccl" (1 rank,
    world size 1: one iteration). Writes its numbers to
    <work>/<role>_rank<r>.json."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.parallel import all_reduce_sum, make_env_group
    from humanoid_gym_tpu_torch.physics import cuda_build, mega as MG, solve as SV
    from humanoid_gym_tpu_torch.physics.kinematics import use_full_f32_matmul
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.runner.on_policy_runner import _env_state_to_saved

    use_full_f32_matmul()
    group = make_env_group("nccl" if role == "nccl" else "gloo", device="cuda:0")
    out = {"rank": group.rank, "world": group.world, "backend": group.backend}
    try:
        lib = cuda_build.kernel_library()
        if lib.log:  # nvcc ran: the libraries of phase 2 were not found
            raise AssertionError(f"rank {group.rank} built the kernels itself")
        t0 = time.perf_counter()
        env, cfg = registry.make_env("humanoid_ppo", num_envs=N_ENVS, cfg_overrides=_solver_mega,
                                     device=group.device, seed=0, group=group)
        tcfg = registry.get_task("humanoid_ppo").make_train_cfg()
        if (env.num_envs, env.num_envs_global, tcfg.runner.num_steps_per_env,
                cfg.commands.curriculum) != (N_ENVS // group.world, N_ENVS, T_STEPS, False):
            raise AssertionError(f"rank {group.rank}: not {N_ENVS // group.world} of {N_ENVS} "
                                 f"envs at T={T_STEPS}")
        counters = (MG.mega_kernel_launch, SV.fused_solve, SV.fused_dense_solve, SV.apgd_solve_kernel)

        def one_iteration(runner):
            """learn(1) with the counters zeroed just before and read just after."""
            for c in counters:
                c.launches = 0
            MG.mega_kernel_launch.terrain_launches = 0
            n0 = group.collectives
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner.learn(1)
            torch.cuda.synchronize()
            rec = {"wall_ms": (time.perf_counter() - t) * 1e3,
                   "iter_ms": runner.last_scalars["Perf/iter_time"] * 1e3,
                   "mega": MG.mega_kernel_launch.launches,
                   "other_launches": MG.mega_kernel_launch.terrain_launches
                   + sum(c.launches for c in counters[1:]),
                   "collectives": group.collectives - n0,
                   "scalars": {k: v for k, v in runner.last_scalars.items()
                               if not k.startswith("Perf/")}}
            for k in ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                      "Train/mean_step_reward"):
                if not np.isfinite(rec["scalars"][k]):
                    raise AssertionError(f"rank {group.rank}: non-finite {k}")
            if rec["mega"] != T_STEPS or rec["other_launches"]:
                raise AssertionError(f"rank {group.rank}: {rec['mega']} mega launches "
                                     f"(and {rec['other_launches']} others) in one iteration")
            rec["train_state_equal"] = _same_on_every_rank(
                _digest(_train_state_tensors(runner.train_state)), group)
            rec["metrics_equal"] = _same_on_every_rank(
                json.dumps(rec["scalars"], sort_keys=True), group)
            if not (rec["train_state_equal"] and rec["metrics_equal"]):
                raise AssertionError(f"rank {group.rank}: the ranks' train states or logged "
                                     f"metrics differ: {rec}")
            return rec

        if role == "resume":
            runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=2)
            runner.load(os.path.join(work, "run", f"model_{1 + RANK_TIMED_ITERS}.ckpt"))
            out["resumed_at"] = runner.current_learning_iteration
            out["env_digest"] = _digest([*_state_tensors(_env_state_to_saved(runner.env_state)),
                                         runner.obs, runner.priv_obs])
            out["train_digest"] = _digest(_train_state_tensors(runner.train_state))
            out["iterations"] = [one_iteration(runner)]
        elif role == "nccl":
            x = torch.full((1024,), 2.0, device=group.device)
            torch.distributed.all_reduce(x)
            torch.distributed.broadcast(x, src=0)
            torch.cuda.synchronize()
            if float(x.sum()) != 2.0 * 1024:
                raise AssertionError("the nccl all-reduce at world size 1 changed the values")
            runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=1)
            out["iterations"] = [one_iteration(runner)]
        else:
            runner = OnPolicyRunner(env, tcfg, log_dir=os.path.join(work, "run"), seed=1)
            out["env_build_s"] = time.perf_counter() - t0
            t = time.perf_counter()
            out["warmup"] = one_iteration(runner)
            out["warmup_s"] = time.perf_counter() - t
            torch.cuda.reset_peak_memory_stats()
            out["iterations"] = [one_iteration(runner) for _ in range(RANK_TIMED_ITERS)]
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out["env_digest"] = _digest([*_state_tensors(_env_state_to_saved(runner.env_state)),
                                         runner.obs, runner.priv_obs])
            out["train_digest"] = _digest(_train_state_tensors(runner.train_state))

            # one minibatch's all-reduce: the gradients, the 5 loss sums and the row count
            payload = [torch.ones_like(p) for p in runner.net.parameters()]
            payload += [torch.ones(5, device=group.device), torch.ones((), device=group.device)]
            b0 = group.reduced_bytes
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                all_reduce_sum(payload, group)
            torch.cuda.synchronize()
            out["allreduce_ms"] = (time.perf_counter() - t) * 1e3 / 20
            out["allreduce_bytes"] = (group.reduced_bytes - b0) // 20

            # where the time goes: one iteration per rank unprofiled, one profiled
            def train_iter():
                r = runner
                r.train_state, r.env_state, r.obs, r.priv_obs, _ = r._train_iter(
                    r.train_state, r.env_state, r.obs, r.priv_obs, r.gen)
                torch.cuda.synchronize()

            t = time.perf_counter()
            train_iter()
            out["plain_iter_ms"] = (time.perf_counter() - t) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                train_iter()
            by_class, out["kernel_launches"], _ = _device_time(prof)
            out["device_ms"] = {k: v / 1e3 for k, v in by_class.items()}

            # the sharded update against one process on one fixed rollout
            out.update(_sharded_update_check(group, cfg, tcfg))
            if not out["sharded_equal"] or out.get("sharded_vs_single", 0.0) > SHARDED_UPDATE_TOL:
                raise AssertionError(f"rank {group.rank}: sharded update: {out}")
    finally:
        with open(os.path.join(work, f"{role}_rank{group.rank}.json"), "w") as f:
            json.dump(out, f)
        group.close()
    return 0


def _sharded_update_check(group, cfg, tcfg):
    """compute_gae + update_phase of one fixed 4096-env, T=60 rollout (made
    from a seed on the card, the same on every rank): each rank on its 2048
    envs, rank 0 also as one process on all of them, float32 nets from one
    seed, one permutation seed. Returns the largest parameter difference,
    whether the ranks' results are bit-equal, and the two update times."""
    import torch

    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, Rollout, init_train_state, make_train_pieces

    dev = group.device
    g = torch.Generator(device=dev).manual_seed(11)
    O, P, A = cfg.env.num_observations, cfg.env.num_privileged_obs, cfg.env.num_actions
    f = lambda *s: torch.randn((T_STEPS, N_ENVS) + s, generator=g, device=dev)  # noqa: E731
    full = Rollout(obs=f(O), priv_obs=f(P), actions=f(A), mu=0.3 * f(A), sigma=0.3 * f(A).abs() + 0.7,
                   log_probs=f() - 15.0, values=f(), rewards=f(), dones=f() > 0.8)
    last_priv = torch.randn((N_ENVS, P), generator=g, device=dev)
    pcfg = PPOConfig.from_cfg(tcfg.algorithm)
    pcfg.num_steps_per_env = T_STEPS
    lo, n = group.rank * (N_ENVS // group.world), N_ENVS // group.world

    def run(grp, roll, last):
        net = ActorCritic(O, P, A, tuple(tcfg.policy.actor_hidden_dims),
                          tuple(tcfg.policy.critic_hidden_dims), compute_dtype="float32",
                          seed=3).to(dev)
        initial = {k: v.clone() for k, v in net.state_dict().items()}
        ts = init_train_state(net, pcfg.learning_rate)
        pieces = make_train_pieces(None, net, pcfg, N_ENVS, grp)
        torch.cuda.synchronize()
        t = time.perf_counter()
        adv, ret = pieces["compute_gae"](ts, roll, last)
        ts, _ = pieces["update_phase"](ts, roll, adv, ret,
                                       torch.Generator(device=dev).manual_seed(5))
        torch.cuda.synchronize()
        return ts, (time.perf_counter() - t) * 1e3, initial

    mine = Rollout(*(x[:, lo:lo + n] for x in full))
    ts, ms, _ = run(group, mine, last_priv[lo:lo + n])
    out = {"sharded_update_ms": ms,
           "sharded_equal": _same_on_every_rank(_digest(_train_state_tensors(ts)), group)}
    if group.rank == 0:
        single, ms1, initial = run(None, full, last_priv)
        a, b = ts.net.state_dict(), single.net.state_dict()
        out["sharded_vs_single"] = max(float((a[k] - b[k]).abs().max()) for k in a)
        out["params_moved"] = max(float((b[k] - p).abs().max()) for k, p in initial.items())
        out["single_update_ms"] = ms1
    return out


def _phase13_ranks(card):
    """Phase 13: `humanoid_ppo` at 4096 envs, T=60, solver mega, as 2 ranks
    x 2048 envs sharing the card over gloo, each through registry.make_env
    -> OnPolicyRunner.learn; then 2 fresh ranks resuming from the shards
    beside 1 nccl rank at world size 1. Returns the launches per rank of
    the timed iterations."""
    from humanoid_gym_tpu_torch.parallel.launch import RankJob

    argv = [sys.executable, os.path.abspath(__file__), "--phase13-rank"]
    with tempfile.TemporaryDirectory(prefix="hgt_smoke_ranks_") as work:
        t0 = time.perf_counter()
        RankJob(argv + [work, "train"], RANKS).wait(RANK_TIMEOUT_S)
        train_s = time.perf_counter() - t0
        train = [json.load(open(os.path.join(work, f"train_rank{r}.json"))) for r in range(RANKS)]
        shards = sorted(f for f in os.listdir(os.path.join(work, "run")) if "envshard" in f)
        final = 1 + RANK_TIMED_ITERS
        if shards != [f"model_{i}.ckpt.envshard{r}" for i in range(1, final + 1)
                      for r in range(RANKS)]:
            raise AssertionError(f"phase 13: env shards {shards}")
        if len({r["train_digest"] for r in train}) != 1:
            raise AssertionError("phase 13: the ranks' final train states differ")
        t0 = time.perf_counter()
        resume = RankJob(argv + [work, "resume"], RANKS)
        nccl = RankJob(argv + [work, "nccl"], 1)
        resume.wait(RANK_TIMEOUT_S)
        nccl.wait(RANK_TIMEOUT_S)
        second_s = time.perf_counter() - t0
        res = [json.load(open(os.path.join(work, f"resume_rank{r}.json"))) for r in range(RANKS)]
        one = json.load(open(os.path.join(work, "nccl_rank0.json")))
    for r in range(RANKS):
        if (res[r]["env_digest"], res[r]["train_digest"], res[r]["resumed_at"]) != (
                train[r]["env_digest"], train[r]["train_digest"], final):
            raise AssertionError(f"phase 13: rank {r} did not resume the saved state")
    its = [t["iterations"] for t in train]
    col = {it["collectives"] for t in its for it in t}

    def ms(xs):
        return ", ".join(f"{x:.1f}" for x in xs)

    per_rank = "; ".join(
        f"rank {r}: " + ", ".join(f"{it['wall_ms']:.1f} (dispatch {it['iter_ms']:.1f})"
                                  for it in its[r]) for r in range(RANKS))
    _log(f"phase 13 two ranks: humanoid_ppo {N_ENVS} envs as {RANKS} gloo ranks x "
         f"{N_ENVS // RANKS} on one card, T={T_STEPS} solver mega, through registry.make_env -> "
         f"OnPolicyRunner.learn | env built in {ms(t['env_build_s'] for t in train)} s, warm-up "
         f"{ms(t['warmup_s'] for t in train)} s | iteration ms per rank (learn(1) with its "
         f"checkpoint; dispatch to dispatch) {per_rank} | mega launches per rank per iteration "
         f"{[it['mega'] for t in its for it in t]} | all-reduces per iteration {sorted(col)}, one "
         f"per minibatch of {train[0]['allreduce_bytes']} bytes in "
         f"{train[0]['allreduce_ms']:.3f} ms | train state, Adam moments, lr and logged metrics "
         f"bit-equal across ranks after every iteration | value_loss "
         f"{its[0][-1]['scalars']['Loss/value_function']:.4g} | peak mem "
         f"{', '.join(f'{g:.2f}' for g in (t['peak_gib'] for t in train))} GiB | {train_s:.1f} s | "
         f"{card}")
    busy = [sum(t["device_ms"].values()) for t in train]
    window = sum(t["plain_iter_ms"] for t in train) / RANKS
    if min(busy) == 0.0:
        _log("phase 13 profile: device time not measured (the profiler saw no kernels)")
    else:
        _log(f"phase 13 profile (one iteration per rank; unprofiled {ms(t['plain_iter_ms'] for t in train)}"
             f" ms): device busy per rank {ms(busy)} ms ("
             + "; ".join(", ".join(f"{k} {v:.1f}" for k, v in t["device_ms"].items()) for t in train)
             + f"), together {sum(busy):.1f} ms of a {window:.1f} ms iteration (idle share "
             f"{1.0 - sum(busy) / window:.3f}) over {[t['kernel_launches'] for t in train]} kernel "
             f"launches | {card}")
    _log(f"phase 13 sharded update vs one process: {N_ENVS} envs x T={T_STEPS}, float32, "
         f"max |param difference| {train[0]['sharded_vs_single']:.3e} (tol {SHARDED_UPDATE_TOL:.0e}; "
         f"the update moved a parameter by up to {train[0]['params_moved']:.3e}), ranks bit-equal | "
         f"gae + update ms sharded {ms(t['sharded_update_ms'] for t in train)}, one process "
         f"{train[0]['single_update_ms']:.1f} | {card}")
    _log(f"phase 13 resume: {RANKS} fresh gloo ranks read model_{final}.ckpt.envshard0-"
         f"{RANKS - 1}: env state, obs and train state equal the saved ones, iteration "
         f"{final} ok ({res[0]['iterations'][0]['wall_ms']:.1f} ms); nccl at world size 1: "
         f"all-reduce and broadcast on the card, one iteration of {N_ENVS} envs in "
         f"{one['iterations'][0]['wall_ms']:.1f} ms with {one['iterations'][0]['mega']} mega "
         f"launches | {second_s:.1f} s | {card}")
    return [[it["mega"] for it in t] for t in its]


def _ptxas_summary(log: str) -> str:
    """Per kernel: registers, stack frame and spills from `ptxas -v`."""
    import re

    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            raw = m.group(1)
            name = re.sub(r"^_Z\d+", "", raw)
            name = re.match(r"[a-z_]+", name).group(0) if re.match(r"[a-z_]+", name) else name
            # template instantiations: hgt_mega_kernel<false> / <true>
            name += "<true>" if "ILb1E" in raw else ("<false>" if "ILb0E" in raw else "")
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('ptxas info    :')[-1].strip()}; {frame}")
    return " | ".join(out)


def _phase12_card_and_build() -> str:
    """Phases 1 and 2: the card line, then the kernels' build. Returns the
    card line."""
    import torch

    from humanoid_gym_tpu_torch.physics import cuda_build
    from humanoid_gym_tpu_torch.physics.kinematics import use_full_f32_matmul
    from humanoid_gym_tpu_torch.utils.platform import card_line

    use_full_f32_matmul()
    card = card_line(torch.device("cuda", 0))
    _log(f"phase 1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    lib = cuda_build.kernel_library()
    _log(f"phase 2 build: {lib.build_seconds:.1f} s -> "
         f"{', '.join(os.path.relpath(p, HERE) for p in lib.paths.values())} | "
         + _ptxas_summary(lib.log))
    return card


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "humanoid_gym_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repo (humanoid_gym_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--phase13-rank"]:
        return _phase13_rank(*sys.argv[2:4])

    import numpy as np

    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV

    dev = torch.device("cuda")
    card = _phase12_card_and_build()

    c = _setup(dev)
    cfg = c.cfg
    records = {}
    st1, tgt0, ops_in = _phase3_solve(c, records)
    _phase4_mega(c, records)
    landed_l = _phase4t_mega_terrain(c, records)
    extra = {}  # phase 10's results for the B1 and B1t rows
    _phase10_two_models(c, _setup(dev, robot="S"), extra)
    _phase10t_two_models_terrain(c, landed_l, extra)
    del landed_l
    if "--kernels-only" in sys.argv[1:]:
        _phase6_apgd(c, st1, tgt0, records)
        _phase7_fused_dense(c, st1, tgt0, ops_in, records)
        print(json.dumps({"records": records, "two_models": extra}), flush=True)
        print(f"card: {card}", flush=True)
        return 0

    # ---- phase 5: the main path ----
    tcfg = XBotLCfgPPO()
    env = make_env(cfg, num_envs=N_ENVS, device=dev, seed=0)
    net = ActorCritic(
        cfg.env.num_observations, cfg.env.num_privileged_obs, cfg.env.num_actions,
        actor_hidden=tuple(tcfg.policy.actor_hidden_dims),
        critic_hidden=tuple(tcfg.policy.critic_hidden_dims), seed=0,
    ).to(dev)
    pcfg = PPOConfig.from_cfg(tcfg.algorithm)
    pcfg.num_steps_per_env = tcfg.runner.num_steps_per_env
    assert pcfg.num_steps_per_env == T_STEPS
    ts = init_train_state(net, pcfg.learning_rate)
    train_iter = make_train_iter(env, net, pcfg, N_ENVS)
    state = env.init_state()
    obs = torch.zeros((N_ENVS, cfg.env.num_observations), device=dev)
    priv = torch.zeros((N_ENVS, cfg.env.num_privileged_obs), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    t0 = time.perf_counter()
    ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    SV.fused_solve.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS + 1)]
    all_metrics = []
    ev[0].record()
    for i in range(TIMED_ITERS):
        ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        ev[i + 1].record()
        all_metrics.append(metrics)
    torch.cuda.synchronize()
    launches = {"mega": MG.mega_kernel_launch.launches, "solve_standalone": SV.fused_solve.launches,
                "mega_terrain": MG.mega_kernel_launch.terrain_launches}
    iter_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TIMED_ITERS)]
    for m in all_metrics:
        for k in ("value_loss", "surrogate_loss", "entropy", "mean_step_reward", "kl", "grad_norm"):
            v = float(m[k])
            if not np.isfinite(v):
                raise AssertionError(f"non-finite {k} = {v}")
    if launches["mega"] != T_STEPS * TIMED_ITERS or launches["mega_terrain"]:
        raise AssertionError(f"mega launches {launches}, expected mega = {T_STEPS * TIMED_ITERS} "
                             f"and no terrain launch")
    mean_ms = sum(iter_ms) / len(iter_ms)
    last = all_metrics[-1]
    _log(f"phase 5 main path: XBot-L {N_ENVS} envs T={T_STEPS} solver mega | warm-up {warm_s:.1f} s | "
         f"iter ms {', '.join(f'{x:.1f}' for x in iter_ms)} | "
         f"{T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | mega launches {launches['mega']} "
         f"(= {T_STEPS} x {TIMED_ITERS}) | value_loss {float(last['value_loss']):.4g} "
         f"surrogate {float(last['surrogate_loss']):.4g} mean_step_reward "
         f"{float(last['mean_step_reward']):.4g} | peak mem "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")

    busy5_ms = _where_the_time_goes(env, net, pcfg, ts, state, obs, priv, gen, mean_ms)
    del env, net, ts, state, obs, priv
    _phase5c_profile_dir(card, dev)

    _phase6_apgd(c, st1, tgt0, records)
    _phase7_fused_dense(c, st1, tgt0, ops_in, records)

    # ---- phase 8: the substep path through the entry points ----
    os.environ["HGT_WANDB"] = "0"
    launches_fused = _substep_path("fused_pallas", timed_iters=1, resume=True, card=card)
    launches_apgd = _substep_path("apgd_pallas", timed_iters=1, resume=False, card=card)

    # ---- phase 9: the terrain path through the entry points ----
    launches_terrain = _phase9_terrain_path(card)

    # ---- phase 11: joint XBot-L + XBot-S training through the entry points ----
    launches_joint = _joint_path("humanoid_joint_ppo", card, dev)
    launches_joint_deploy = _joint_path("humanoid_joint_deploy", card, dev)

    # ---- phase 12: the repo's trained policies through the kernel ----
    _phase12_trained_policies(card, dev)

    # ---- phase 13: env-sharded training, two ranks on the card ----
    launches_ranks = _phase13_ranks(card)

    # ---- phase 14: play on the card ----
    launches_play = _phase14_play(card, dev)

    # ---- phase 15: the learning-curve band on the card ----
    launches_band = _phase15_learning_band(card, dev)

    # ---- phases 16-19: the measurement tools on the card ----
    _phase16_learn_profile(card, dev, busy5_ms)
    _phase17_config4(card)
    _phase18_sass_census(card)
    _phase19_roofline_and_example(card, dev, mean_ms)

    kernels = [
        dict(name="hgt_mega_kernel (whole policy step of physics)", route="cuda",
             source="humanoid_gym_tpu_torch/csrc/mega.cu",
             replaces="humanoid_gym_tpu/physics/mega_kernel.py:550",
             launches=launches["mega"], joint_launches=launches_joint["mega"],
             two_rank_launches=launches_ranks, play_launches=launches_play,
             band_launches=launches_band, library_ms=None,
             **records["mega"], **extra["mega"]),
        dict(name="hgt_solve_env (contact solve; runs inside hgt_mega_kernel, "
                  "timed through its stand-alone launch hgt_solve_kernel)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/solve.cuh",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:422",
             launches=launches["mega"], standalone_launches=launches["solve_standalone"],
             two_rank_launches=launches_ranks, play_launches=launches_play,
             band_launches=launches_band, library_ms=None, **records["solve"]),
        dict(name="hgt_fused_dense_kernel (Cholesky + dense Delassus + APGD, solver fused_pallas)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/dense_solve.cu",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:740",
             launches=launches_fused["fused_dense"], library_ms=None, **records["fused_dense"]),
        dict(name="hgt_apgd_kernel (APGD on a prebuilt Delassus matrix, solver apgd_pallas)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/dense_solve.cu",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:60",
             launches=launches_apgd["apgd"], library_ms=None, **records["apgd"]),
        dict(name="hgt_mega_kernel<true> (terrain variant: whole policy step on a heightfield, "
                  "the TPU kernel's IN2 rows)", route="cuda",
             source="humanoid_gym_tpu_torch/csrc/mega.cu",
             replaces="humanoid_gym_tpu/physics/mega_kernel.py:560",
             launches=launches_terrain["mega_terrain"],
             joint_deploy_launches=launches_joint_deploy["mega_terrain"], library_ms=None,
             **records["mega_terrain"], **extra["mega_terrain"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
