#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-4, 6 and 7, then the records; no contract line

Phases (each prints one line of its numbers; any failure raises, so the
script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from humanoid_gym_tpu_torch/csrc;
  3. the contact-solve kernel against its plain PyTorch version at 4096, 37
     and 1 envs, on operands built from real XBot-L states;
  4. the mega kernel (one policy step of physics) against its plain
     version at 4096 envs over 1 and 5 policy steps and at 37 and 1 envs
     over one; one launch timed as it runs, with no APGD iterations and
     with one substep, for the split loop / rest of a substep / fixed cost;
  5. the main path: XBot-L PPO training (4096 envs, T=60, solver mega)
     through `make_train_iter`, one warm-up iteration and 3 timed ones,
     with the kernels' launch counters zeroed just before the timed run;
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
  9. one JSON line with a record per kernel, the card line, then the
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

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

N_ENVS = 4096
T_STEPS = 60
TIMED_ITERS = 3


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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


# ---- operation counts of the kernels' loop nests (per env), for the
# bound. Each multiply, add, divide, square root and comparison-select in
# the loops counts as one float32 operation. ----

def _lz(i, k):
    return k < 6 and 6 <= i < 12


def solve_ops(iterations: int) -> int:
    """Operations of hgt_solve_env for one env (csrc/solve.cuh)."""
    nv, nr = 18, 60
    ops = 0
    for k in range(nv):  # Cholesky
        ops += 2
        rows = [i for i in range(k + 1, nv) if not _lz(i, k)]
        ops += len(rows)
        for j in range(k + 1, nv):
            if _lz(j, k):
                continue
            ops += 2 * sum(1 for i in range(j, nv) if not _lz(i, k))
    tri = sum(1 + 2 * sum(1 for i in range(k + 1, nv) if not _lz(i, k)) for k in range(nv))
    ops += 2 * tri + nv  # v_free: forward + backward substitution + add
    ops += nr * (2 * nv + 2)  # r = sign * J v_free - target
    ops += sum(nr + 2 * nr * sum(1 for i in range(k + 1, nv) if not _lz(i, k)) for k in range(nv))
    ops += nv * nr  # sign fold
    pairs = sum(1 for v in range(nv) for w in range(v, nv) if not _lz(w, v))
    ops += pairs * (2 * nr + 3) + nv  # Gram row sums + max
    ops += nr * (2 * nv + 1) + 4  # CFM regularizer and step
    proj = 16 * 20 + 12
    ops += nr + proj  # warm start fold + projection
    per_iter = nv * 2 * nr + nr * (2 * nv + 3) + 2 * nr + proj + 3 * nr + 12 + 3 * nr
    ops += iterations * per_iter
    ops += nv * 2 * nr + tri + nv + nr  # dv = L^-T (B lam), qvel_new, unfold
    return ops


def mega_ops(decimation: int, iterations: int) -> int:
    """Operations of one mega-kernel launch for one env (csrc/mega.cu):
    per substep PD (12 x 8), FK + velocity/bias recursion (12 bodies x
    ~190), body stage (13 x ~190), subtree sums (12 x 16), h (12 x 14),
    mass matrix (21 base + 12 x 6 base couplings + 42 chain pairs, ~40
    each), contact rows (16 x ~60), limit rows (12 x 8), rhs (12 x 10),
    the solve, integration and impulse sums (~150); plus the final FK
    pass (12 x ~110)."""
    sub = (12 * 8 + 12 * 190 + 13 * 190 + 12 * 16 + 12 * 14
           + (21 + 72 + 42) * 40 + 16 * 60 + 12 * 8 + 12 * 10 + 150
           + solve_ops(iterations))
    return decimation * sub + 12 * 110


def solve_ops_executed(iterations: int) -> int:
    """Float32 operations one warp executes in hgt_solve_env (csrc/solve.cuh),
    every lane counted whether or not its result is used: 32 x the float
    instructions of the loop nests (a multiply-add counts 2)."""
    nv, pairs = 18, 117  # strictly-lower structurally non-zero entries
    w = 0
    w += nv * 4 + 2 * pairs                      # Cholesky: max, sqrt, 1/d, scale; updates
    w += 3 * nv * 3                              # three substitutions: scale + multiply-add
    w += 2 * nv * 2 + 4                          # u = J v_free for two columns, r
    w += 2 * nv + 2 * 2 * pairs                  # B = L^-1 J^T for two columns
    w += 2 * nv * 3 + 3                          # sign fold, diag(B^T B), regularizer
    w += 8 * (nv * 3 + 20 + 1) + nv + 3          # Gram batches, row sums, step
    proj = 20 + 1                                # a cone and a clamp per lane
    w += 2 + proj                                # warm start
    per_iter = nv * 3 + 20 + 2 * nv * 2 + 6 + 4 + proj + 4 + 5 + 12 + 4
    w += iterations * per_iter
    w += nv * 3 + 20 + nv * 3 + 3                # B lam, substitution, outputs
    return 32 * w


def mega_ops_executed(decimation: int, iterations: int) -> int:
    """Float32 operations one warp executes in one launch of hgt_mega_kernel
    (csrc/mega.cu), every lane counted: per substep PD (8), joint rotations
    (4 rounds x 30), the 7 chain steps (6 + 30 each), the body stage (190),
    screws (9), subtree sums (7), the mass matrix (5 rounds x 45), rhs (30),
    two constraint columns (2 x 90), the solve, integration (60); plus the
    final chain (4 x 30 + 7 x 20)."""
    sub = (8 + 4 * 30 + 7 * 36 + 190 + 9 + 7 + 5 * 45 + 30 + 2 * 90 + 60)
    return decimation * (32 * sub + solve_ops_executed(iterations)) + 32 * (4 * 30 + 7 * 20)


PROJ_OPS = 16 * 20 + 12  # 16 cone projections + 12 clamps


def apgd_loop_ops(iterations: int, nrow: int = 60) -> int:
    """Operations of hgt_warp_apgd for one env (csrc/apgd.cuh): the warm
    start's projection, then per iteration the dense matvec, the trial
    point, its projection, the restart test and the momentum step."""
    per_iter = 2 * nrow * nrow + nrow + 2 * nrow + PROJ_OPS + nrow + 2 * nrow + 12 + 2 * nrow
    return PROJ_OPS + iterations * per_iter


def apgd_ops(iterations: int, nrow: int = 60) -> int:
    """Operations of hgt_apgd_kernel for one env (csrc/dense_solve.cu): sign
    folding of A, r and the warm start, the loop, the unfolding."""
    return 2 * nrow * nrow + 2 * nrow + nrow + apgd_loop_ops(iterations, nrow) + nrow


def fused_dense_ops(iterations: int, nv: int = 18, nrow: int = 60, executed: bool = False) -> int:
    """Operations the function of hgt_fused_dense_kernel needs for one env.
    The Delassus matrix A = B^T B and the Gram matrix B B^T are symmetric,
    so the function needs one triangle of each (diagonal included); the
    kernel builds A in full (each lane its two whole rows) and the Gram
    matrix by its 171 pairs, and `executed=True` counts that."""
    delassus_entries = nrow * nrow if executed else nrow * (nrow + 1) // 2
    gram_entries = nv * (nv + 1) // 2
    ops = 0
    for k in range(nv):  # Cholesky: root, column scale, trailing update
        ops += 2 + (nv - 1 - k) + 2 * sum(i - k for i in range(k + 1, nv))
    tri = sum(1 + 2 * (nv - 1 - k) for k in range(nv))
    ops += 2 * tri + nv  # v_free
    ops += nrow * (2 * nv + 2)  # r = sign * J v_free - target
    ops += nrow * tri + nv * nrow  # B = L^-1 J^T, sign fold
    ops += 2 * nv * nrow + 3 + nrow  # trace, regularizer, diagonal
    ops += delassus_entries * 2 * nv  # dense Delassus
    ops += gram_entries * (2 * nrow + 1) + nv + 3  # Gram row sums, max, step
    ops += nrow + apgd_loop_ops(iterations, nrow)  # warm-start fold + loop
    ops += nv * 2 * nrow + tri + nv + nrow  # dv, qvel_new, unfold
    return ops


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- inputs ----

def _states(model, n, seed, device):
    """Perturbed standing states with DR values drawn as the JAX package's
    tests/test_mega_kernel.py:_states draws them."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch.physics.step import default_state

    rng = np.random.default_rng(seed)
    st = default_state(model, n, [0.0, 0.0, 0.9], [1.0, 0.0, 0.0, 0.0])
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
    _, ops = solve_operands(
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


def _setup(dev):
    """The XBot-L model, gains and the mega step (kernel and plain) that
    phases 3 and 4 share."""
    import types

    import torch

    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs.env import _match_gains
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    c = types.SimpleNamespace(dev=dev)
    c.cfg = XBotLCfg()
    c.cfg.sim.solver.solver_type = "mega"
    c.model = build_xbot_model().to(dev)
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
                      st.contact_lam, tgt)

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
    packed = MG.pack_inputs(st1.qpos, st1.qvel, st1.friction, st1.base_mass_scale,
                            st1.contact_stiffness, st1.contact_offset, st1.kp_scale,
                            st1.kd_scale, st1.contact_compliance, st1.contact_lam, tgt1)

    def launch(decimation, iterations):
        return MG.mega_kernel_launch(packed, c.mega.consts, c.sim_dt, decimation, iterations, 1.0)

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
    device time by kernel class and the device's idle share."""
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
    _profile_line("phase 5b profile", prof, mean_iter_ms, "iteration")


def _profile_line(tag, prof, window_ms, what):
    """Device time by kernel class, launch count and idle share of a
    profiled window that took window_ms."""
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
    busy_ms = sum(by_class.values()) / 1e3
    if busy_ms == 0.0:
        _log(f"{tag}: device time not measured (the profiler saw no kernels)")
        return
    top.sort(reverse=True)
    _log(f"{tag}: device busy {busy_ms:.1f} ms of a {window_ms:.1f} ms {what} "
         f"(idle share {1.0 - busy_ms / window_ms:.3f}) over {launches} kernel launches | "
         + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in by_class.items())
         + " | top: " + "; ".join(f"{n} x{c} {u / 1e3:.1f} ms" for u, c, n in top[:5]))


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
        t0 = time.perf_counter()
        timed.learn(timed_iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
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


def _ptxas_summary(log: str) -> str:
    """Per kernel: registers, stack frame and spills from `ptxas -v`."""
    import re

    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = re.sub(r"^_Z\d+", "", m.group(1))
            name = re.match(r"[a-z_]+", name).group(0) if re.match(r"[a-z_]+", name) else name
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

    use_full_f32_matmul()
    card = _card_line()
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
    if "--kernels-only" in sys.argv[1:]:
        _phase6_apgd(c, st1, tgt0, records)
        _phase7_fused_dense(c, st1, tgt0, ops_in, records)
        print(json.dumps(records), flush=True)
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

    MG.mega_kernel_launch.launches = 0
    SV.fused_solve.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS + 1)]
    all_metrics = []
    ev[0].record()
    for i in range(TIMED_ITERS):
        ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        ev[i + 1].record()
        all_metrics.append(metrics)
    torch.cuda.synchronize()
    launches = {"mega": MG.mega_kernel_launch.launches, "solve_standalone": SV.fused_solve.launches}
    iter_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TIMED_ITERS)]
    for m in all_metrics:
        for k in ("value_loss", "surrogate_loss", "entropy", "mean_step_reward", "kl", "grad_norm"):
            v = float(m[k])
            if not np.isfinite(v):
                raise AssertionError(f"non-finite {k} = {v}")
    if launches["mega"] != T_STEPS * TIMED_ITERS:
        raise AssertionError(f"mega launches {launches['mega']} != {T_STEPS * TIMED_ITERS}")
    mean_ms = sum(iter_ms) / len(iter_ms)
    last = all_metrics[-1]
    _log(f"phase 5 main path: XBot-L {N_ENVS} envs T={T_STEPS} solver mega | warm-up {warm_s:.1f} s | "
         f"iter ms {', '.join(f'{x:.1f}' for x in iter_ms)} | "
         f"{T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | mega launches {launches['mega']} "
         f"(= {T_STEPS} x {TIMED_ITERS}) | value_loss {float(last['value_loss']):.4g} "
         f"surrogate {float(last['surrogate_loss']):.4g} mean_step_reward "
         f"{float(last['mean_step_reward']):.4g} | peak mem "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")

    _where_the_time_goes(env, net, pcfg, ts, state, obs, priv, gen, mean_ms)

    _phase6_apgd(c, st1, tgt0, records)
    _phase7_fused_dense(c, st1, tgt0, ops_in, records)

    # ---- phase 8: the substep path through the entry points ----
    os.environ["HGT_WANDB"] = "0"
    launches_fused = _substep_path("fused_pallas", timed_iters=1, resume=True, card=card)
    launches_apgd = _substep_path("apgd_pallas", timed_iters=1, resume=False, card=card)

    kernels = [
        dict(name="hgt_mega_kernel (whole policy step of physics)", route="cuda",
             source="humanoid_gym_tpu_torch/csrc/mega.cu",
             replaces="humanoid_gym_tpu/physics/mega_kernel.py:550",
             launches=launches["mega"], library_ms=None, **records["mega"]),
        dict(name="hgt_solve_env (contact solve; runs inside hgt_mega_kernel, "
                  "timed through its stand-alone launch hgt_solve_kernel)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/solve.cuh",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:422",
             launches=launches["mega"], standalone_launches=launches["solve_standalone"],
             library_ms=None, **records["solve"]),
        dict(name="hgt_fused_dense_kernel (Cholesky + dense Delassus + APGD, solver fused_pallas)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/dense_solve.cu",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:740",
             launches=launches_fused["fused_dense"], library_ms=None, **records["fused_dense"]),
        dict(name="hgt_apgd_kernel (APGD on a prebuilt Delassus matrix, solver apgd_pallas)",
             route="cuda", source="humanoid_gym_tpu_torch/csrc/dense_solve.cu",
             replaces="humanoid_gym_tpu/physics/pallas_solver.py:60",
             launches=launches_apgd["apgd"], library_ms=None, **records["apgd"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
