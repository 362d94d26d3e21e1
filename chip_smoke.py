#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line of its numbers; any failure raises, so the
script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from humanoid_gym_tpu_torch/csrc;
  3. the contact-solve kernel against its plain PyTorch version at 4096
     envs, on operands built from real XBot-L states;
  4. the mega kernel (one policy step of physics) against its plain
     version at 4096 envs, over 1 and 5 policy steps;
  5. the main path: XBot-L PPO training (4096 envs, T=60, solver mega)
     through `make_train_iter`, one warm-up iteration and 3 timed ones,
     with the kernels' launch counters zeroed just before the timed run;
  6. one JSON line per kernel record, then the contract line
     {"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA card, or outside a checkout of
the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
    """Mean device time of fn() over reps calls, on CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def _kernel_class(name: str) -> str:
    if "hgt_mega" in name:
        return "mega"
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
    by_class = {"mega": 0.0, "matmul": 0.0, "other": 0.0}
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
        _log("phase 5b profile: device time not measured (the profiler saw no kernels)")
        return
    top.sort(reverse=True)
    _log(f"phase 5b profile: device busy {busy_ms:.1f} ms of a {mean_iter_ms:.1f} ms iteration "
         f"(idle share {1.0 - busy_ms / mean_iter_ms:.3f}) over {launches} kernel launches | "
         + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in by_class.items())
         + " | top: " + "; ".join(f"{n} x{c} {u / 1e3:.1f} ms" for u, c, n in top[:5]))


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
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg, XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.physics import cuda_build, mega as MG, solve as SV
    from humanoid_gym_tpu_torch.physics.kinematics import use_full_f32_matmul
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    dev = torch.device("cuda")
    use_full_f32_matmul()
    card = _card_line()
    _log(f"phase 1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2: build ----
    lib = cuda_build.kernel_library()
    ptx = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln]
    _log(f"phase 2 build: {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path, HERE)}"
         + (" | " + " | ".join(ptx) if ptx else ""))

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = "mega"
    model = build_xbot_model().to(dev)
    sim_dt, dec = cfg.sim.dt, cfg.control.decimation
    iters = cfg.sim.solver.solver_iterations
    from humanoid_gym_tpu_torch.envs.env import _match_gains

    kp = torch.as_tensor(_match_gains(model.dof_names, cfg.control.stiffness), device=dev)
    kd = torch.as_tensor(_match_gains(model.dof_names, cfg.control.damping), device=dev)
    tlim = model.dof_effort * cfg.safety.torque_limit
    mega = MG.make_mega_step_batched(model, sim_dt, dec, kp, kd, tlim, iterations=iters)

    def plain(st, tgt):
        return MG.mega_step_plain(
            model, sim_dt, dec, kp, kd, tlim, iters, 1.0, st.qpos, st.qvel, st.friction,
            st.base_mass_scale, st.contact_stiffness, st.contact_offset, st.kp_scale,
            st.kd_scale, st.contact_compliance, st.contact_lam, tgt,
        )

    def advance(st, out):
        qpos, qvel, lam, tau, ff, fk14 = out
        return st.replace(qpos=qpos, qvel=qvel, contact_lam=lam, torques=tau, fk_out=fk14)

    records = {}

    # ---- phase 3: solve kernel vs plain ----
    st0, tgt0 = _states(model, N_ENVS, seed=0, device=dev)
    st1 = advance(st0, plain(st0, tgt0))  # a warm-start lam from one real step
    ops_in = _solve_operands(model, st1, tgt0, kp, kd, tlim, sim_dt)
    q_k, l_k = SV.fused_solve(*ops_in, iterations=iters)
    q_p, l_p = SV.fused_solve_plain(*ops_in, iterations=iters)
    torch.cuda.synchronize()
    eq, el = _maxerr(q_k, q_p), _maxerr(l_k, l_p)
    ms_k = _time_ms(lambda: SV.fused_solve(*ops_in, iterations=iters), reps=20)
    ms_p = _time_ms(lambda: SV.fused_solve_plain(*ops_in, iterations=iters), reps=3)
    nbytes = N_ENVS * 4 * (sum(t[0].numel() for t in ops_in) + 18 + 60)
    b_ms, b_by = _bound_ms(nbytes, N_ENVS * solve_ops(iters))
    _log(f"phase 3 solve: {N_ENVS} envs, {iters} iters | max|dqvel| {eq:.3e} (tol 5e-4) "
         f"max|dlam| {el:.3e} (tol 2e-3) | kernel {ms_k:.4f} ms plain {ms_p:.3f} ms "
         f"bound {b_ms:.5f} ms ({b_by})")
    if not (eq <= 5e-4 and el <= 2e-3):
        raise AssertionError(f"solve kernel disagrees with its plain version: {eq}, {el}")
    records["solve"] = dict(max_abs_err=max(eq, el), ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                            bound_by=b_by)

    # ---- phase 4: mega kernel vs plain over 1 and 5 policy steps ----
    # tolerances of the JAX package's kernel-vs-XLA check
    # (tests/test_mega_kernel.py:70-76): qpos 5e-4, qvel 1e-2, tau 5e-2,
    # contact force 5 N (ff / dt); lam rows at the same force, 5 N * dt;
    # fk14 positions at the qpos tolerance, foot velocities at qvel's.
    tols = {"qpos": 5e-4, "qvel": 1e-2, "lam": 5.0 * sim_dt, "tau": 5e-2,
            "ff": 5.0 * sim_dt, "fk_pos": 5e-4, "fk_vel": 1e-2}
    worst = 0.0
    for n_steps in (1, 5):
        sk, sp = st0, st0
        for _ in range(n_steps):
            ok = mega(sk.qpos, sk.qvel, sk.friction, sk.base_mass_scale, sk.contact_stiffness,
                      sk.contact_offset, sk.kp_scale, sk.kd_scale, sk.contact_compliance,
                      sk.contact_lam, tgt0)
            op = plain(sp, tgt0)
            sk, sp = advance(sk, ok), advance(sp, op)
        torch.cuda.synchronize()
        errs = {
            "qpos": _maxerr(ok[0], op[0]), "qvel": _maxerr(ok[1], op[1]),
            "lam": _maxerr(ok[2], op[2]), "tau": _maxerr(ok[3], op[3]),
            "ff": _maxerr(ok[4], op[4]), "fk_pos": _maxerr(ok[5][:, :10], op[5][:, :10]),
            "fk_vel": _maxerr(ok[5][:, 10:], op[5][:, 10:]),
        }
        finite = all(bool(torch.isfinite(t).all()) for t in ok)
        _log(f"phase 4 mega: {n_steps} step(s) | " + " ".join(
            f"{k} {v:.3e}/{tols[k]:.0e}" for k, v in errs.items()) + f" | finite {finite}")
        bad = {k: v for k, v in errs.items() if not v <= tols[k]}
        if bad or not finite:
            raise AssertionError(f"mega kernel disagrees with its plain version: {bad}")
        worst = max(worst, max(errs.values()))
    packed = MG.pack_inputs(st1.qpos, st1.qvel, st1.friction, st1.base_mass_scale,
                            st1.contact_stiffness, st1.contact_offset, st1.kp_scale,
                            st1.kd_scale, st1.contact_compliance, st1.contact_lam, tgt0)
    ms_mk = _time_ms(lambda: MG.mega_kernel_launch(packed, mega.consts, sim_dt, dec, iters, 1.0),
                     reps=20)
    ms_mp = _time_ms(lambda: plain(st1, tgt0), reps=2)
    b_ms, b_by = _bound_ms(N_ENVS * 4 * (MG.IN_ROWS + MG.OUT_ROWS), N_ENVS * mega_ops(dec, iters))
    _log(f"phase 4 mega timing: {N_ENVS} envs, one launch {ms_mk:.3f} ms, plain {ms_mp:.2f} ms, "
         f"bound {b_ms:.5f} ms ({b_by})")
    records["mega"] = dict(max_abs_err=worst, ms=ms_mk, plain_ms=ms_mp, bound_ms=b_ms,
                           bound_by=b_by)

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
