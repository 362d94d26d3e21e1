#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-4, 4t, 4r, 10, 10t, 6 and 7, then the records; no contract line
    python3 chip_smoke.py --train TASK ITERS SEED [--probe C1,C2,...]   # phases 1-2, then a training run as phase 22's, no gate; the update probe at the checkpoints given
    python3 chip_smoke.py --roll POLICY.npz N_ENVS STEPS [STEPS ...]   # phases 1-2, then phase 12 (a)'s roll
    python3 chip_smoke.py --nonfinite CKPT STEPS [ACTOR.npz]   # phases 1-2, then the non-finite probe
    python3 chip_smoke.py --curve METRICS.jsonl[.gz] [ROBOTS]   # a run's learning curve; needs no card
    python3 chip_smoke.py --compare METRICS.jsonl[.gz] METRICS.jsonl[.gz]   # two runs line by line; needs no card
    python3 chip_smoke.py --probe-table PROBE.jsonl   # the update probe's lines as a table; needs no card

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
     its launch timed beside the flat launch on the same states; the
     terrain patches kernel against the plain chain at 4096 envs (worst
     slope gap at most 1e-5, taps or origin differing at no more than
     0.1 % of the points, one launch a call), both timed;
  4r. the rewards kernel (the env step's reward stage in one launch)
     against the plain chain at 4096 and 2048 envs, on random states that
     reach every branch of every term (`_reward_inputs`): reward and
     episode sums within REWARD_TOLS relative, the float feet state within
     1e-6, the flags equal, one launch a call; timed as a CUDA graph
     beside the plain chain, eager and as a CUDA graph;
  5. the main path: XBot-L PPO training (4096 envs, T=60, solver mega)
     through `CapturedTrainIter` (the iteration as one CUDA graph): one
     warm-up iteration, which captures the graph, and 3 timed replays,
     with the kernels' launch counters zeroed just before the timed run
     (the replays add the launches the capture recorded); 5b: one
     iteration of the eager stages on CUDA events and one eager iteration
     under torch.profiler;
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
     `OnPolicyRunner.learn` at 4096 envs, T=10 (CUT_T_STEPS), with solver
     fused_pallas (warm-up, 1 timed iteration, resume from its own
     checkpoint) and apgd_pallas (warm-up, 1 timed iteration), launch
     counters zeroed just before each timed run and read just after; one
     env step profiled;
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
     -> `OnPolicyRunner.learn` at 2048 + 2048 envs, T=10 (CUT_T_STEPS),
     solver mega, the estimator head on (warm-up, 2 timed iterations): 20
     flat (joint_ppo) or 20 terrain (joint_deploy) launches per iteration
     and no other,
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
     library of phase 2, every iteration a replay of the runner's capture,
     cut at each of its RANK_ALLREDUCES all-reduces (warm-up with the
     capture, 2 timed iterations): 60 mega launches per rank per iteration
     counted from the replays, 11 all-reduces, finite losses, parameters,
     Adam moments, learning rate and logged metrics bit-equal across the
     ranks after every iteration (compared through the group), one
     all-reduce per minibatch (timed, with its bytes); the sharded
     compute_gae + update_phase of one fixed 4096-env rollout within
     SHARDED_UPDATE_TOL of one process on it; the captured iteration
     against the eager one on the two ranks (phase 24's comparison, 3
     iterations a side from one snapshot, bit-equal or within
     CAPTURE_REL_TOL with the tensor named, the ranks bit-equal), at T=60
     and with the command curriculum on at T=CUT_T_STEPS (T more cuts),
     with the iteration ms per rank eager and replayed and the capture
     seconds; then 2 fresh ranks restore the final checkpoint's env shards
     exactly and train on, captured anew, beside 1 nccl rank at world size
     1 (an all-reduce and a broadcast on the card, one iteration);
 14. play on the card: `play(get_args([...]))` of scripts/play_torch.py
     (HGT_PLAY_VIDEO=0) on a humanoid_ppo checkpoint whose actor is the
     walk demo's, 1 env, 1200 policy steps at vx 0.5: the counts zeroed
     just before the rollout and read just after show 1200 mega launches
     and no plain mega step; the exported policy.npz equals the shipped
     demo's arrays; the trace is finite, the robot never falls and its mean
     base_vel_x is at least PLAY_MIN_VX; then the first 20 noise-free steps
     of `play_rollout` on the card against the same rollout on the CPU
     (PLAY_TOLS), with the card's host synchronisations counted: none in
     the env step's modules;
 15. the learning-curve band on the card: the seeded 16-env run of
     tests/test_learning_regression.py (seed 5, T=60, 12 iterations through
     `compiled_train_iter`, one CUDA graph an iteration) with solver mega,
     held to that test's bands unchanged
     (humanoid_gym_tpu_torch/utils/learning_band.py);
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
 20. the env step with no host synchronisation, and captured:
     `HumanoidEnv.step` at 4096 envs, solver mega, flat and on the terrain
     task, under `torch.cuda.set_sync_debug_mode("error")` with resets and
     command resamples in the window; `graft_entry_torch.entry()` captured
     as one CUDA graph (solver apgd, then mega), three replays fed forward
     against three eager steps from the same state and generator state
     (bit-equal expected, fail above 1e-6), hgt_mega_kernel once per
     replay in the profiler; `dryrun_multichip(1)` over nccl;
 21. `bench_torch.py` in its own process at 4096 envs: flat pipelined,
     flat HGT_BENCH_SYNC=1, HGT_BENCH_TASK=humanoid_ppo_terrain_robust,
     HGT_BENCH_MESH=1, each JSON line printed; value finite and > 0, solver
     mega, 0 < mfu < 1, 60 launches of the task's mega kernel per timed
     iteration and none of the other;
 22. the flat recipe trained from scratch: `scripts/train_torch.py`'s
     `train` in its own process, `--task humanoid_ppo --num_envs 4096
     --max_iterations 200` (the config's seed, solver mega, HGT_WANDB=0),
     the run directory under chiprun_out/phase22/: exit 0, 200 lines in
     metrics.jsonl with finite losses and no non-finite reset, 60 x 200
     flat mega launches plus the reset step and no terrain launch,
     model_100 and model_200 written; checkpoints 100 and 200 exported
     (`export_checkpoint`) and rolled as phase 12 (a) rolls the walk demo,
     checkpoint 200 held to the walk demo's gate (at least 95% survive,
     median distance at least 0.8 m), checkpoint 100 reported; the
     training metrics at iterations 1, 50, 100, 150 and 200, the seconds an
     iteration and the phase's wall time printed;
 22j. the production joint recipe through the same path: `train` of
     `humanoid_joint_deploy` (2048 XBot-L + 2048 XBot-S envs on the deploy
     field, the estimator head, the survival curriculum) for 10 iterations
     in its own process, in a temporary directory: exit 0, 10 metrics
     lines, finite losses, no non-finite reset, 2 x 60 x 10 terrain
     launches plus the reset step of each robot and no flat one (the
     expectation read from the env the registry builds, not from the
     task's name), checkpoints 0 and 10; checkpoint 10 exported and rolled
     as XBot-L (phase 12 (a)) and XBot-S (phase 12 (b)), reported; then a
     second process resumed from checkpoint 10 for 2 iterations, its
     metrics numbered 10-11, its launches as many; then the update probe
     of `--train ... --probe` on checkpoint 10 (one eager iteration at
     4096 envs: per minibatch the gradient norm of each parameter group,
     the clip scale, the learning rate, the KL and the loss terms; the
     rollout's largest targets and blown-up rows), its line complete and
     finite and its cut whole; the phase's wall time beside its
     prediction;
 23. the random draw sites of the training path, each held to the
     closed-form law of its config at 4096 envs with the env's CUDA
     generator (the checks of tests/test_torch_random_paths.py, whose
     limits follow from the sample size at a false-alarm rate of 1e-4):
     through B1 on `humanoid_ppo`, the joint offsets, friction, added base
     mass, motor strength and the commands of `init_state`, then over two
     steps with a push and a command resample on every second step the
     action delay and noise, the push, the resampled commands and the
     observation noise; through B1t on `humanoid_ppo_terrain_robust`, the
     base xy about the origin, the contact stiffness, offset, compliance
     and slope bias and the initial level and type, then the re-entry level
     and reset pose after a time-out on the top row; through B1t on
     `humanoid_joint_deploy` (2048 + 2048 on the deploy field), for XBot-L
     and XBot-S each, the initial level over 0..20, the type spread, the
     deploy origins and the spawn, the contact DR (friction, added mass,
     stiffness, offset, compliance), the slope bias and the commands of
     `init_state`, then the re-entry level and reset pose after a time-out
     on or past the top row (one launch a robot); the runner's random
     initial episode lengths. One line a site; a miss fails the run;
 24. the training iteration captured as one CUDA graph against the eager
     one (`algo/capture.py`), at 4096 envs and T=60 for humanoid_ppo,
     humanoid_ppo_terrain_robust, humanoid_joint_ppo (2048 + 2048) and
     humanoid_joint_deploy (2048 + 2048 on the deploy field, the survival
     curriculum): 3 iterations a side from one snapshot (train state, env
     state, obs, every generator) taken after 2 eager warm-up iterations,
     parameters, Adam moments, count, learning rate, env state (terrain
     levels and origins included), obs and metrics bit-equal (a difference
     up to CAPTURE_REL_TOL relative passes only with its tensor named); the
     env's kernel kind launched T times a robot an iteration on each side,
     counted from the replays, none of the other, and as often in one
     profiled replay where the profiler lists a graph's kernels; with a
     terrain curriculum, levels that changed inside the compared window
     (at least one); capture seconds, eager and replayed iteration ms on
     CUDA events and on the host clock, the replay's device idle share,
     the peak memory with the graph's pool;
 25. the card's own tests: `python -m pytest tests/test_torch_cuda.py -q
     --noconftest -p no:cacheprovider` in its own process (tests/conftest.py
     imports JAX, which the card's host lacks), CARD_TESTS_TIMEOUT_S to run:
     exit 0, and every collected case passed (none skipped but those named
     in CARD_TESTS_SKIPS); passed, collected and seconds on one line, the
     child's tail printed on a failure;
 26. one JSON line with each phase's wall seconds on the host clock and
     their total since main() began (`phase_seconds`), one JSON line with a
     record per kernel, the card line, then the contract line {"ok": true,
     "device": {...}}.

Phases 5, 5c, 8, 9, 11, 13, 15, 17, 19, 20 (`dryrun_multichip(1)`), 21,
22 and 22j train through entry points that run the captured iteration on the
card (phase 13's two gloo ranks as graphs cut at each all-reduce), as the
JAX package jit-compiles them; phase 16's stages run eagerly.

It imports nothing of JAX. Without a CUDA card, or outside a checkout of
the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
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
        rewards_bytes,
        rewards_ops,
        terrain_patches_ops,
    )
    from humanoid_gym_tpu_torch.utils.roofline import bound_ms as _bound_ms  # noqa: E402

N_ENVS = 4096
T_STEPS = 60
# the horizon of phases 8 and 11 (the substep solvers' paths and the joint
# paths), cut from the recipe's T_STEPS so that the whole script, phase 22's
# 200 iterations included, stays inside its time on a slow host; their
# checks are the same, counted at this horizon
CUT_T_STEPS = 10
TIMED_ITERS = 3
TERRAIN_TASK = "humanoid_ppo_terrain_robust"
JOINT_TASK = "humanoid_joint_ppo"
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


def _graph_ms(fn, calls: int, reps: int = 20) -> float:
    """Device ms of one fn() call: `calls` calls captured as one CUDA graph,
    its replays timed by `_time_ms`, over `calls`."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, reps=reps) / calls


def _maxerr(a, b) -> float:
    return float((a - b).abs().max().item())


# ---- inputs ----

def _reward_inputs(n, rcfg, n_cols, device, seed, feet_base=True, nj=12, nbody=13, feet=(6, 12),
                   n_pen=3):
    """`RewardInputs` of n envs for the reward stage of `rcfg` (a
    RewardsCfg) with n_cols episode-sum columns, drawn from `seed` so that
    every branch of every term is reached: rows whose state is not finite
    (NaN and inf in qpos, qvel and the FK rows), each case of low_speed (too
    slow, too fast and desired, each also within 2 % of its edge; a sign
    mismatch, |command| <= 0.1, a base at rest), commands below
    stand_still's 0.1, episode lengths over many gait cycles (so |sin| <
    0.1 at the stance boundaries), foot forces about the 5 N contact line,
    last contacts and zero or positive air times, feet heights in and about
    feet_clearance's band, collision flags, done and time-out flags. Every input is a strided view of a wider array, as the
    env passes the mega kernel's output rows (the episode length and the
    flags too); `feet_base` as `make_rewards` takes it."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch.envs.rewards import RewardInputs

    rng = np.random.default_rng(seed)
    f32 = np.float32
    f = lambda *s: rng.normal(size=(n,) + s).astype(f32)  # noqa: E731
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (n,) + s).astype(f32)  # noqa: E731
    b = lambda p, *s: rng.uniform(size=(n,) + s) < p  # noqa: E731
    row = np.arange(n)
    qpos = np.concatenate([u(-2, 2, 2), u(0.8, 1.0, 1), f(4), f(nj) * 0.2], 1)
    qvel = f(6 + nj)
    cmd, lin = u(-0.6, 0.6, 4), f(3) * 0.4
    # low_speed: v / c of 0.2 and 0.49 (too slow), 2 and 1.21 (too fast), 1, 0.51 and 1.19
    # (desired), -1 (a sign mismatch); |c| <= 0.1; a base at rest; free
    ratio = np.array([0.2, 0.49, 2.0, 1.21, 1.0, 0.51, 1.19, -1.0], f32)
    case = row % (len(ratio) + 3)
    ruled = case < len(ratio)
    lin[ruled, 0] = ratio[case[ruled]] * cmd[ruled, 0]
    cmd[case == len(ratio), 0] = u(-0.1, 0.1)[case == len(ratio)]
    lin[case == len(ratio) + 1, 0] = 0.0
    cmd[row % 5 == 0, :2] *= 0.1  # stand_still's |command| < 0.1
    rel = np.concatenate([f(2) * 0.2, f(2) * 0.2, u(-0.97, -0.8, 2), f(2) * 0.15, f(2) * 0.15,
                          f(2) * 0.3, f(2) * 0.3], 1)
    if not feet_base:
        rel[:, 0:2] += qpos[:, 0:1]
        rel[:, 2:4] += qpos[:, 1:2]
        rel[:, 4:6] += qpos[:, 2:3]
        rel[:, 6:8] += qpos[:, 0:1]
        rel[:, 8:10] += qpos[:, 1:2]
    cf = np.abs(f(nbody, 3)) * 300
    cf[:, list(feet), 2] = u(0.0, 10.0, 2)
    cf[row % 11 == 0, feet[0], 2] = 5.0  # on the contact line: no contact
    fz = (rel[:, 4:6] + qpos[:, 2:3]) if feet_base else rel[:, 4:6]
    sole_z = fz - f32(rcfg.sole_offset)
    last_feet_z = u(0.0, 0.15, 2)
    feet_height = (f32(rcfg.target_feet_height) - (sole_z - last_feet_z) + u(-0.015, 0.015, 2))
    air = np.where(b(0.3, 2), f32(0.0), u(0.0, 0.6, 2)).astype(f32)
    bad = b(0.04)
    qpos[bad, 7] = np.nan
    qvel[bad, 3] = np.inf
    rel[bad, 4] = np.nan
    done = b(0.1)

    def put(x, before=1, after=2):
        """x as a view of a wider array on the device: a row stride of its
        width + before + after."""
        x = np.asarray(x)
        wide = np.zeros((n, (x.shape[1] if x.ndim == 2 else 1) + before + after), x.dtype)
        if x.ndim == 1:
            wide[:, before] = x
            return torch.as_tensor(wide, device=device)[:, before]
        wide[:, before:before + x.shape[1]] = x
        return torch.as_tensor(wide, device=device)[:, before:before + x.shape[1]]

    last_qvel = put(f(6 + nj))
    return RewardInputs(
        episode_length=put(rng.integers(0, 1000, n).astype(np.int32)),
        qpos=put(qpos), qvel=put(qvel), last_dof_vel=last_qvel[:, 6:], actions=put(f(nj)),
        last_actions=put(f(nj)), last_last_actions=put(f(nj)), torques=put(f(nj) * 30),
        ref_dof_pos=put(f(nj) * 0.2), base_lin_vel=put(lin), base_ang_vel=put(f(3) * 0.3),
        base_euler=put(f(3) * 0.1), projected_gravity=put(f(3) * 0.1), commands=put(cmd),
        last_root_vel=last_qvel[:, :6], feet_rows=put(rel),
        contact_forces=torch.as_tensor(cf, device=device), collision_flags=put(b(0.3, n_pen)),
        feet_air_time=put(air), last_contacts=put(b(0.5, 2)), feet_height=put(feet_height),
        last_feet_z=put(last_feet_z), episode_sums=put(f(n_cols)), finite=put(~bad),
        done=put(done), time_out=put(done & b(0.5)))


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
    ops = mega_terrain_ops(c.dec, c.iters)
    b_ms, b_by = _bound_ms(N_ENVS * 4 * (MG.IN_ROWS + MG.IN2_ROWS + MG.OUT_ROWS), N_ENVS * ops)
    _log(f"phase 4t mega terrain timing: {N_ENVS} envs, same states, in turns flat {turns[0]:.3f} "
         f"| terrain {turns[1]:.3f} | terrain {turns[2]:.3f} | flat {turns[3]:.3f} ms per launch; "
         f"plain {ms_p:.2f} ms; bound {b_ms:.5f} ms ({b_by}; {ops} operations per env)")
    records["mega_terrain"] = dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                   bound_by=b_by)
    _terrain_patches_check(step.terrain_patches, st0)
    return st_all, tgt_all, step


def _terrain_patches_check(patches, st):
    """The terrain patches kernel (csrc/terrain_patches.cu) against the
    plain chain (`patches.plain`) on the same states: the worst slope gap
    and the points whose taps or patch origin differ (allowed where the
    chain's xy sum lands an ulp across a grid line: at most 0.1 % of the
    points), one launch a call; both timed, their launches counted."""
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG

    n = st.qpos.shape[0]
    n0 = MG.terrain_patches_launch.launches
    got = patches(st.qpos, st.slope_bias)
    want = patches.plain(st.qpos, st.slope_bias)
    torch.cuda.synchronize()
    calls = MG.terrain_patches_launch.launches - n0
    slope_gap = float((got[:, MG.IN2_GX:] - want[:, MG.IN2_GX:]).abs().max())
    finite = bool(torch.isfinite(got).all())
    points = (got[:, :MG.IN2_GX] != want[:, :MG.IN2_GX]).reshape(n, 11, MG.N_POINTS).any(1)
    differ = int(points.sum())
    slope_equal = int((got[:, MG.IN2_GX:] == want[:, MG.IN2_GX:]).reshape(n, 2, MG.N_POINTS)
                      .all(1).sum())
    ms_k = _time_ms(lambda: patches(st.qpos, st.slope_bias), reps=50)
    ms_p = _time_ms(lambda: patches.plain(st.qpos, st.slope_bias), reps=20)
    n_k = _kernel_launches(lambda: patches(st.qpos, st.slope_bias))
    n_p = _kernel_launches(lambda: patches.plain(st.qpos, st.slope_bias))
    env_bytes = 4 * (MG.NQ + 2 + MG.IN2_ROWS + 9 * MG.N_POINTS)  # rows in and out, the taps once
    b_ms, b_by = _bound_ms(n * env_bytes, n * terrain_patches_ops())
    _log(f"phase 4t terrain patches: {n} envs | kernel {ms_k:.4f} ms, {n_k} kernel launch(es) a "
         f"call, {calls} on its counter | plain {ms_p:.3f} ms, {n_p} kernel launches a call | "
         f"bound {b_ms:.5f} ms ({b_by}) | worst slope gap {slope_gap:.3e} (limit 1e-5) | taps or "
         f"origin differ at {differ} of {n * MG.N_POINTS} points (limit 0.1 %), slope rows "
         f"bit-equal at {slope_equal} | finite {finite}")
    if not finite or calls != 1 or slope_gap > 1e-5 or differ > 1e-3 * n * MG.N_POINTS:
        raise AssertionError(f"terrain patches kernel disagrees with the plain chain: slope gap "
                             f"{slope_gap:.3e}, {differ} points differ, {calls} launches, finite "
                             f"{finite}")


def _reward_gaps(stage, inp, got, want):
    """The rewards kernel's outputs `got` against the plain chain's `want`
    on `inp`: (the worst reward gap over |reward| plus the magnitudes of the
    row's scaled terms, the worst episode-sum gap over |sum| plus |scaled
    term|, the worst gap of the float feet state, last_contacts equal,
    contact equal). The scaled terms are the plain chain's episode sums
    from zero sums."""
    import torch

    scaled = stage.plain(inp._replace(episode_sums=torch.zeros_like(inp.episode_sums)))
    scaled = scaled.episode_sums.abs()
    reward = float(((got.reward - want.reward).abs()
                    / (want.reward.abs() + scaled.sum(1)).clamp(min=1e-30)).max())
    sums = float(((got.episode_sums - want.episode_sums).abs()
                  / (want.episode_sums.abs() + scaled).clamp(min=1e-30)).max()) \
        if scaled.numel() else 0.0
    feet = max(float((g - w).abs().max()) for g, w in (
        (got.feet.feet_air_time, want.feet.feet_air_time),
        (got.feet.feet_height, want.feet.feet_height),
        (got.feet.last_feet_z, want.feet.last_feet_z)))
    return (reward, sums, feet, torch.equal(got.feet.last_contacts, want.feet.last_contacts),
            torch.equal(got.contact, want.contact))


REWARD_TOLS = (1e-5, 1e-5, 1e-6)  # reward and episode sums relative, float feet state absolute


def _all_reward_terms():
    """XBot-L's reward config with every term of REWARD_FUNCTIONS and the
    termination term scaled (seeded scales of both signs), no clip."""
    import numpy as np

    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs.rewards import KERNEL_TERMS

    rcfg = XBotLCfg().rewards
    rng = np.random.default_rng(0)
    for name in KERNEL_TERMS + ("termination",):
        setattr(rcfg.scales, name, float(rng.uniform(0.5, 2.0) * rng.choice([-1.0, 1.0])))
    rcfg.only_positive_rewards = False
    return rcfg


def _phase4r_rewards(c, records, build_log):
    """Phase 4r: the rewards kernel (csrc/rewards.cu) against the plain
    chain at 4096 and 2048 envs on `_reward_inputs` (XBot-L's reward set,
    its model's feet bodies), one launch a call; the kernel and the plain
    chain timed as CUDA graphs (what a replayed iteration runs; the plain
    chain eagerly too), with the launches of each and the kernel's
    registers, stack and spills; the bound from `rewards_bytes` /
    `rewards_ops`."""
    import torch

    from humanoid_gym_tpu_torch.envs import rewards as R

    rcfg = c.cfg.rewards
    dflt = torch.as_tensor([c.cfg.init_state.default_joint_angles[n] for n in c.model.dof_names],
                           dtype=torch.float32, device=c.dev)
    stage = R.make_rewards(rcfg, c.cfg.dt, dflt, c.model.feet_body_idx, feet_base=True)
    regs = [x for x in _ptxas_summary(build_log).split(" | ") if x.startswith("hgt_rewards")]
    for n in (4096, 2048):
        inp = _reward_inputs(n, rcfg, len(stage.names), c.dev, seed=4000 + n,
                             nbody=c.model.nbody, feet=c.model.feet_body_idx)
        n0 = R.rewards_launch.launches
        got = stage(inp)
        torch.cuda.synchronize()
        calls = R.rewards_launch.launches - n0
        want = stage.plain(inp)
        gaps = _reward_gaps(stage, inp, got, want)
        abs_err = max(_maxerr(a.float(), b.float()) for a, b in zip(
            (got.reward, got.episode_sums, *got.feet, got.contact),
            (want.reward, want.episode_sums, *want.feet, want.contact)))
        # device ms a call: the calls captured as one CUDA graph, as a replayed
        # iteration runs them (timing eager launches reads the wrapper's host time)
        ms_k = _graph_ms(lambda: stage(inp), 50)
        ms_plain = _time_ms(lambda: stage.plain(inp), reps=10)
        ms_graph = _graph_ms(lambda: stage.plain(inp), 5)
        n_k = _kernel_launches(lambda: stage(inp))
        n_p = _kernel_launches(lambda: stage.plain(inp))
        nbytes = n * rewards_bytes(len(dflt), len(stage.names), inp.collision_flags.shape[1])
        b_ms, b_by = _bound_ms(nbytes, n * rewards_ops(len(dflt), inp.collision_flags.shape[1]))
        _log(f"phase 4r rewards: {n} envs, {len(stage.names)} terms | kernel {ms_k:.4f} ms a "
             f"launch (as a graph), {n_k} kernel launch(es) a call, {calls} on its counter | plain "
             f"{ms_plain:.3f} ms eager, {ms_graph:.3f} ms as a graph, {n_p} kernel launches a call "
             f"| bound {b_ms:.5f} ms ({b_by}, {nbytes / n:.0f} B an env) | gaps: reward "
             f"{gaps[0]:.2e}, episode sums {gaps[1]:.2e} (limit {REWARD_TOLS[0]:.0e} relative), "
             f"feet state {gaps[2]:.2e} (limit {REWARD_TOLS[2]:.0e}), last_contacts equal "
             f"{gaps[3]}, contact equal {gaps[4]}, largest |difference| {abs_err:.3e} | "
             f"{'; '.join(regs)}")
        if calls != 1 or gaps[0] > REWARD_TOLS[0] or gaps[1] > REWARD_TOLS[1] \
                or gaps[2] > REWARD_TOLS[2] or not (gaps[3] and gaps[4]):
            raise AssertionError(f"rewards kernel disagrees with the plain chain at {n} envs: "
                                 f"gaps {gaps}, {calls} launches")
        if n == 4096:
            records["rewards"] = dict(max_abs_err=abs_err, ms=ms_k, plain_ms=ms_plain,
                                      bound_ms=b_ms, bound_by=b_by)


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
    """Phase 11 for one joint task: XBot-L + XBot-S (2048 + 2048 envs), T=CUT_T_STEPS,
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
    tcfg.runner.num_steps_per_env = CUT_T_STEPS
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
    want = 2 * CUT_T_STEPS * timed_iters  # one launch per sub-env and policy step
    if launches[own] != want or any(v for k, v in launches.items() if k != own):
        raise AssertionError(f"{task}: launches {launches}, expected {own} = {want} only")
    mean_ms = wall_ms / timed_iters
    iter_ms = [ln["Perf/iter_time"] * 1e3 for ln in lines[1:]]
    _log(f"phase 11 joint path: {task} XBot-L + XBot-S {N_ENVS // 2} + {N_ENVS // 2} envs "
         f"T={CUT_T_STEPS} solver mega through registry.make_env -> OnPolicyRunner.learn | env built in "
         f"{make_s:.1f} s, warm-up {warm_s:.1f} s | {timed_iters} iterations in {wall_ms:.1f} ms "
         f"(dispatch to dispatch: {', '.join(f'{x:.1f}' for x in iter_ms)} ms) | "
         f"{CUT_T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | {own} launches {launches[own]} "
         f"(= 2 x {CUT_T_STEPS} x {timed_iters}), "
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


def _roll_policy(task, npz, vx, terrain, dev, n_steps=400, n_envs=N_ENVS):
    """Roll the actor of a `policy.npz` (loaded by actor_critic_from_npz) on
    n_envs envs of `task` with the deployment-clean overrides of
    tests/test_xbots.py:71-83 (no noise, pushes, friction / mass DR, action
    delay or noise, no heading command; `terrain` keeps the task's map and
    curriculum placement, else flat), solver mega, the command held at (vx,
    0, 0), for n_steps policy steps through the kernel (its plain version
    on the CPU). Returns (share of envs that never fell, median forward
    distance in m; a fallen env counts the distance it had walked when it
    fell)."""
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.utils.platform import synchronize

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

    env, cfg = registry.make_env(task, num_envs=n_envs, cfg_overrides=ov, device=dev, seed=0)
    net = ActorCritic(cfg.env.num_observations, cfg.env.num_privileged_obs, cfg.env.num_actions,
                      seed=0).to(dev)
    actor_critic_from_npz(net, npz)
    state, obs, _ = env.reset_all()
    cmd = torch.tensor([vx, 0.0, 0.0, 0.0], device=dev).expand(n_envs, 4).contiguous()
    x0 = state.phys.qpos[:, 0].clone()
    alive = torch.ones(n_envs, dtype=torch.bool, device=dev)
    dist = torch.zeros(n_envs, device=dev)
    with torch.no_grad():
        for _ in range(n_steps):
            state = state.replace(commands=cmd)
            state, tr = env.step(state, net.act(obs)[0])
            obs = tr.obs
            alive &= ~(tr.done & ~tr.time_out)
            dist = torch.where(alive, state.phys.qpos[:, 0] - x0, dist)
    synchronize(torch.device(dev))
    return float(alive.float().mean()), float(dist.median())


def _phase12_trained_policies(card, dev):
    """Phase 12: the repo's trained policies on the card through the kernel,
    400 policy steps at 4096 envs: (a) the flat walk demo on XBot-L, (b) the
    joint (footing) demo on XBot-S at the Froude-scaled command, both gated;
    (c) the footing demo on the rubble map through B1t, reported."""
    import math

    from humanoid_gym_tpu_torch import HGT_ROOT_DIR
    from humanoid_gym_tpu_torch.config.xbots import SCALE
    from humanoid_gym_tpu_torch.physics import mega as MG

    vx_s = 0.4 * math.sqrt(SCALE)
    cases = (("a", "humanoid_ppo", "xbotl_walk_demo", 0.4, False, 0.8),
             ("b", "humanoid_s_ppo", "xbotl_footing_demo", vx_s, False, 0.5 * vx_s * 4.0),
             ("c", "humanoid_ppo_rubble", "xbotl_footing_demo", 0.4, True, None))
    for tag, task, policy, vx, terrain, need in cases:
        n0 = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
        t0 = time.perf_counter()
        npz = os.path.join(HGT_ROOT_DIR, "resources", "policies", f"{policy}.npz")
        survived, median = _roll_policy(task, npz, vx, terrain, dev)
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
# the env step's modules: none of them may synchronise the host
STEP_FILES = ("env.py", "rewards.py", "step.py", "mega.py", "contact.py", "dynamics.py",
              "kinematics.py", "spatial.py", "terrain.py")
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
    in_step = {k: v for k, v in where.items() if k.split(":")[0] in STEP_FILES}
    if in_step:
        raise AssertionError(f"phase 14: host synchronisations in the env step {in_step}")
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


# ---- phase 20: the env step with no host synchronisation, captured ----

CAPTURE_REPLAYS = 3
CAPTURE_TOL = 1e-6  # replays against eager steps: bit-equal expected
TIMED_STEPS = 10


def _sync_free_steps(card, dev):
    """`HumanoidEnv.step` at N_ENVS envs, solver mega, flat and on the
    terrain task, and `JointEnv.step` of `humanoid_joint_ppo` at N_ENVS / 2
    XBot-L + N_ENVS / 2 XBot-S envs, three steps each under
    `torch.cuda.set_sync_debug_mode("error")` (any host synchronisation
    raises), with a command resample on every step and half the envs (of
    each robot) at their time-out in the first step (resets and, on
    terrain, curriculum moves). Returns the kernel launches by task."""
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG

    def half_timed_out(e, st):
        half = (torch.arange(st.episode_length.shape[0], device=dev) % 2 == 0).to(torch.int32)
        return st.replace(episode_length=half * e.max_episode_length)

    launches = {}
    for task in ("humanoid_ppo", TERRAIN_TASK, JOINT_TASK):
        def ov(c):
            c.sim.solver.solver_type = "mega"
            c.commands.resampling_time = c.dt

        env, cfg = registry.make_env(task, num_envs=N_ENVS, cfg_overrides=ov, device=dev, seed=0)
        zero = torch.zeros((N_ENVS, cfg.env.num_actions), device=dev)
        state, _ = env.step(env.init_state(), zero)
        if isinstance(state, list):  # the joint env: one state per robot
            state = [half_timed_out(e, st) for e, st in zip(env.envs, state)]
        else:
            state = half_timed_out(env, state)
        dones = []
        MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, tr = env.step(state, zero)
                dones.append(tr.done)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches[task] = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
        resets = [int(d.sum()) for d in dones]
        _log(f"phase 20 no host synchronisation: {type(env).__name__}.step, {task}, {N_ENVS} "
             f"envs, solver mega, 3 steps under set_sync_debug_mode('error'): none raised | "
             f"resets per step {resets} (half the envs timed out in the first), a resample "
             f"every step | mega "
             f"launches (flat, terrain) {launches[task]} | {card}")
        if resets[0] < N_ENVS // 2:
            raise AssertionError(f"phase 20: {resets[0]} resets in the first step, expected at "
                                 f"least {N_ENVS // 2}")
        del env, state, tr, dones
    if launches != {"humanoid_ppo": (3, 0), TERRAIN_TASK: (0, 3), JOINT_TASK: (6, 0)}:
        raise AssertionError(f"phase 20: launches in the sync-free steps {launches}")
    return launches


def _captured_entry(card, dev, solver):
    """`graft_entry_torch.entry(solver=)` captured as one CUDA graph: three
    replays that feed the state forward against three eager steps from the
    same state and the same generator state (largest difference over the
    outputs, qpos and qvel; bit-equal expected, fail above CAPTURE_TOL);
    the mega kernel seen by the profiler once per replay; eager step and
    replay timed over TIMED_STEPS. Returns the launches counted while
    capturing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import graft_entry_torch as GE
    from humanoid_gym_tpu_torch.physics import mega as MG

    fn, (net, state0, obs0, priv0) = GE.entry(device=dev, solver=solver)
    gen = fn.env.gen
    g0 = gen.get_state()
    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    t0 = time.perf_counter()
    graph = GE.CapturedStep(fn.step, net, state0, obs0, priv0, gen)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_launches = MG.mega_kernel_launch.launches  # warm-up calls + the capture

    def rollout(step):
        gen.set_state(g0)
        st, o, p = state0, obs0, priv0
        seen = []
        for _ in range(CAPTURE_REPLAYS):
            st, out = step(st, o, p)
            o, p = out[0], out[1]
            seen.append([x.clone() for x in (*out, st.phys.qpos, st.phys.qvel)])
        return seen

    eager = rollout(lambda s, o, p: fn.step(net, s, o, p))
    MG.mega_kernel_launch.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replayed = rollout(graph)
        torch.cuda.synchronize()
    replay_launches = MG.mega_kernel_launch.launches
    mega_events = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "hgt_mega_kernel" in e.key)
    err = max(_maxerr(a, b) for ea, ra in zip(eager, replayed) for a, b in zip(ea, ra))
    bit_equal = all(torch.equal(a, b) for ea, ra in zip(eager, replayed) for a, b in zip(ea, ra))

    def host_ms(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TIMED_STEPS * 1e3

    eager_ms = host_ms(lambda: fn.step(net, state0, obs0, priv0))
    replay_ms = host_ms(lambda: graph(state0, obs0, priv0))
    _log(f"phase 20 capture: graft_entry_torch.entry(solver={solver!r}), {GE.NUM_ENVS} envs, one "
         f"CUDA graph ({capture_s:.2f} s with {GE.CAPTURE_WARMUP} warm-up calls) | {CAPTURE_REPLAYS} replays fed "
         f"forward against {CAPTURE_REPLAYS} eager steps: max|diff| {err:.3e} (tol "
         f"{CAPTURE_TOL:.0e}), bit-equal {bit_equal} | hgt_mega_kernel in the profiled replays "
         f"{mega_events}, wrapper launches while capturing {capture_launches}, while replaying "
         f"{replay_launches} | a step eager {eager_ms:.3f} ms, replayed {replay_ms:.3f} ms (host "
         f"clock, {TIMED_STEPS} calls) | {card}")
    if not err <= CAPTURE_TOL:
        raise AssertionError(f"phase 20 ({solver}): replays differ from eager steps by {err}")
    want_events = CAPTURE_REPLAYS if solver == "mega" else 0
    want_capture = GE.CAPTURE_WARMUP + 1 if solver == "mega" else 0
    if (mega_events, capture_launches, replay_launches) != (want_events, want_capture, 0):
        raise AssertionError(f"phase 20 ({solver}): mega kernels in the replays {mega_events}, "
                             f"wrapper launches capturing {capture_launches}, replaying "
                             f"{replay_launches}")
    return capture_launches


def _phase20_capture(card, dev):
    """Phase 20: the env step free of host synchronisation (flat and
    terrain), `entry()` captured and replayed with solver apgd and mega,
    and `dryrun_multichip(1)` over nccl. Returns the flat mega launches of
    the sync-free steps, of the capture and of the dry run's process
    (read from its line)."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    import graft_entry_torch as GE

    sync_free = _sync_free_steps(card, dev)
    _captured_entry(card, dev, "apgd")
    capture_launches = _captured_entry(card, dev, "mega")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with redirect_stdout(buf):
        results = GE.dryrun_multichip(1)
    line = buf.getvalue().strip()
    _log(f"phase 20 {line} | {time.perf_counter() - t0:.1f} s, its own process | {card}")
    if not (line.startswith("dryrun_multichip(1): ok — solver=mega (1 nccl")
            and np.isfinite(results[0]["value_loss"])):
        raise AssertionError(f"phase 20: dryrun_multichip(1) printed {line!r}")
    return {"sync_free": sync_free["humanoid_ppo"][0], "capture": capture_launches}


# ---- phase 21: bench_torch.py on the card ----

BENCH_RUNS = (
    ("flat, pipelined", {}),
    ("flat, sync", {"HGT_BENCH_SYNC": "1"}),
    ("terrain", {"HGT_BENCH_TASK": TERRAIN_TASK}),
    ("flat, mesh 1", {"HGT_BENCH_MESH": "1"}),
)
BENCH_TIMEOUT_S = 300


def _phase21_bench(card):
    """Phase 21: `bench_torch.py` in its own process four times (flat
    pipelined, flat sync, the terrain task, HGT_BENCH_MESH=1), at 4096 envs
    with the default solver: each JSON line printed; value finite and > 0,
    solver mega, 0 < mfu < 1 where the line has mfu, and 60 launches of
    the task's mega kernel per timed iteration (none of the other one).
    Returns the launches of the flat pipelined and the terrain run."""
    import math
    import re

    launches = {}
    for tag, extra in BENCH_RUNS:
        env = dict(os.environ, **extra)
        for k in ("HGT_SOLVER", "HGT_BENCH_ENVS", "HGT_BENCH_ITERS", "HGT_BENCH_DEVICE"):
            env.pop(k, None)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py")],
                             capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=HERE,
                             env=env)
        seconds = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"phase 21 ({tag}): bench_torch.py exited {run.returncode}:\n"
                                 f"{run.stdout[-3000:]}\n{run.stderr[-6000:]}")
        out = json.loads(run.stdout.strip().splitlines()[-1])
        note = [ln for ln in run.stderr.splitlines() if ln.startswith("# bench:")][-1]
        m = re.search(r"mega launches (\d+) terrain (\d+) in (\d+) timed iterations", note)
        flat, terrain, iters = (int(x) for x in m.groups())
        on_terrain = "HGT_BENCH_TASK" in extra
        launches[tag] = terrain if on_terrain else flat
        print(json.dumps(out), flush=True)
        _log(f"phase 21 bench_torch.py ({tag}): {seconds:.1f} s in its own process | {note[2:]} | "
             f"{card}")
        want = (0, T_STEPS * iters) if on_terrain else (T_STEPS * iters, 0)
        mfu_ok = on_terrain or 0 < out.get("mfu", -1) < 1
        if not (math.isfinite(out["value"]) and out["value"] > 0 and out["solver"] == "mega"
                and mfu_ok and (flat, terrain) == want):
            raise AssertionError(f"phase 21 ({tag}): {out}, launches (flat, terrain) "
                                 f"{(flat, terrain)}, expected {want}")
    return launches


# ---- phase 22: the flat recipe trained from scratch on the card ----

TRAIN_TASK = "humanoid_ppo"
TRAIN_ITERS = 200
TRAIN_TIMEOUT_S = 600
# the run directory; under chiprun_out/ so that it can be evaluated on a
# host with MuJoCo after the run (scripts/robustness_curve_torch.py)
TRAIN_ROOT = os.path.join(HERE, "chiprun_out", "phase22")
WALK_VX = 0.4
# the walk demo's gate (phase 12 (a)): share of envs that never fall in 400
# policy steps, median forward distance in m
WALK_GATE = (0.95, 0.8)


def _ckpt_iteration(path):
    """The iteration of a runner checkpoint, `.../model_<it>.ckpt`."""
    return int(os.path.basename(path)[len("model_"):-len(".ckpt")])


def _saved_checkpoints(run_dir):
    """The iterations of the runner checkpoints in `run_dir`, sorted."""
    return sorted(_ckpt_iteration(p) for p in os.listdir(run_dir)
                  if p.startswith("model_") and p.endswith(".ckpt"))


# the child process (run from the checkout's root): scripts/train_torch.py's
# train() on the command line's flags, then the process's peak device
# memory in GiB and, on the last line, the mega kernel's launch counts of
# the whole process
TRAIN_CHILD = """
import json, os, sys, torch
sys.path.insert(0, "scripts")
from chip_smoke import _ckpt_iteration
from train_torch import train
from humanoid_gym_tpu_torch.physics import mega as MG
from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner
from humanoid_gym_tpu_torch.utils.helpers import get_args
full = {int(c) for c in os.environ.get("HGT_FULL_CKPTS", "").split(",") if c}
if full:
    # the checkpoints an update probe starts from carry the env state and
    # obs, as the run's last one does; what the run computes is unchanged
    save = OnPolicyRunner.save
    OnPolicyRunner.save = lambda self, path, include_env_state=False: save(
        self, path, include_env_state or _ckpt_iteration(path) in full)
train(get_args(sys.argv[1:]))
print(json.dumps({"peak_gib": torch.cuda.max_memory_allocated() / 2**30
                  if torch.cuda.is_available() else None}))
print(json.dumps({"flat": MG.mega_kernel_launch.launches,
                  "terrain": MG.mega_kernel_launch.terrain_launches}))
"""
# a run rolls every ROLL_EVERY-th checkpoint and its last; a run longer
# than LONG_RUN iterations every ROLL_EVERY_LONG-th
ROLL_EVERY, ROLL_EVERY_LONG, LONG_RUN = 100, 500, 1000
# what `--train` keeps of a run's checkpoints once they are rolled: the
# last KEEP_LAST with their nets, every CURVE_EVERY-th with its actor only
# (all that export and the MuJoCo farm read), no other, so that a
# 3001-iteration joint run (4.6 MB a net, 2.1 MB an actor) comes back
# from the GPU machine under 64 MiB
KEEP_LAST, CURVE_EVERY = 4, 200


def _env_kernels(env):
    """(kind of mega kernel the env's steps launch, "flat" or "terrain";
    number of robots, one launch each a policy step) of a HumanoidEnv or a
    JointEnv."""
    subs = getattr(env, "envs", [env])
    (kind,) = {"flat" if e.terrain_map is None else "terrain" for e in subs}
    return kind, len(subs)


def _training_launches(task, iters):
    """The launches a training process of `iters` iterations of `task`
    makes, read from the env the registry builds for it (2 envs on the
    CPU) and the task's horizon T: T x robots x iters of its kernel kind
    plus the runner's reset step (one launch a robot), none of the other
    kind. Returns ({"flat": n, "terrain": n}, robots)."""
    from humanoid_gym_tpu_torch import registry

    env, _ = registry.make_env(task, num_envs=2, device="cpu", seed=0)
    kind, robots = _env_kernels(env)
    t = registry.get_task(task).make_train_cfg().runner.num_steps_per_env
    want = {"flat": 0, "terrain": 0}
    want[kind] = t * robots * iters + robots
    return want, robots


def _train_process(card, task, iters, seed, root, tag, resume=None, full_ckpts=()):
    """`scripts/train_torch.py`'s `train` in a fresh process, `--task task
    --num_envs 4096 --max_iterations iters` (`seed` None: the config's;
    solver mega on the card, HGT_WANDB=0), the run directory under `root`;
    `resume` (run directory, checkpoint) adds `--resume --load_run
    --checkpoint` and the new run directory sits beside it; the checkpoints
    of the iterations in `full_ckpts` carry the env state and obs as the
    last one does (HGT_FULL_CKPTS, read by TRAIN_CHILD). Hard checks:
    exit 0; `iters` lines in metrics.jsonl numbered on from the loaded
    iteration, every loss finite and no non-finite reset; the launches of
    `_training_launches`; a checkpoint every save_interval iterations and at
    the end. Returns (run directory, metrics lines, launches, robots,
    seconds of the process)."""
    import glob

    from humanoid_gym_tpu_torch import registry

    env = dict(os.environ, HGT_WANDB="0")
    env["HGT_FULL_CKPTS"] = ",".join(map(str, full_ckpts))
    for k in ("HGT_SOLVER", "HGT_PROFILE_DIR"):
        env.pop(k, None)
    flags = ["--task", task, "--num_envs", str(N_ENVS), "--max_iterations", str(iters),
             "--log_root", root] + ([] if seed is None else ["--seed", str(seed)])
    start, before = 0, set(glob.glob(os.path.join(root, "*", "")))
    if resume is not None:
        start = resume[1]
        flags += ["--resume", "--load_run", os.path.basename(os.path.normpath(resume[0])),
                  "--checkpoint", str(start)]
    t0 = time.perf_counter()
    timeout = TRAIN_TIMEOUT_S * max(iters, TRAIN_ITERS) // TRAIN_ITERS
    run = subprocess.run([sys.executable, "-c", TRAIN_CHILD] + flags, capture_output=True,
                         text=True, timeout=timeout, cwd=HERE, env=env)
    train_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"{tag}: the training process exited {run.returncode}:\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-6000:]}")
    peak, launches = map(json.loads, run.stdout.strip().splitlines()[-2:])
    peak = "not measured" if peak["peak_gib"] is None else f"{peak['peak_gib']:.2f} GiB"
    (run_dir,) = set(glob.glob(os.path.join(root, "*", ""))) - before
    with open(os.path.join(run_dir, "train_stdout.txt"), "w") as f:
        f.write(run.stdout)
    lines = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    ckpts = [f"model_{i}.ckpt" for i in _saved_checkpoints(run_dir)]
    losses = [v for ln in lines for k, v in ln.items() if k.startswith("Loss/")]
    nonfinite = sum(ln["Train/nonfinite_resets"] for ln in lines)
    want, robots = _training_launches(task, iters)
    save = registry.get_task(task).make_train_cfg().runner.save_interval
    saved = {i for i in range(start, start + iters) if i % save == 0} | {start + iters}
    first = 1 if len(lines) > 1 else 0  # after the first (warm-up) iteration
    dts = [ln["Perf/iter_time"] for ln in lines[first:]]
    seed_txt = "seed of the config" if seed is None else f"seed {seed}"
    resumed = "" if resume is None else f", resumed from checkpoint {start}"
    shown = ckpts if len(ckpts) <= 8 else ckpts[:3] + ["..."] + ckpts[-3:]
    _log(f"{tag} train: scripts/train_torch.py train() in its own process, {task} "
         f"{N_ENVS} envs ({robots} robot{'s' if robots > 1 else ''}), {iters} iterations, "
         f"{seed_txt}{resumed}, solver mega | {train_s:.1f} s | s an iteration (dispatch to "
         f"dispatch, iterations {start + first + 1}-{start + iters}) median "
         f"{statistics.median(dts):.3f}, min {min(dts):.3f}, max {max(dts):.3f} | mega "
         f"launches {launches} (expected {want}: T x {robots} x {iters} + {robots} reset "
         f"step{'s' if robots > 1 else ''}) | peak device memory {peak} | metrics lines "
         f"{len(lines)}, losses finite "
         f"{all(map(math.isfinite, losses))}, non-finite resets {nonfinite:g} | {len(ckpts)} "
         f"checkpoints: {', '.join(shown)} | {card}")
    _log(f"{tag} curve: {_curve_line(lines, robots)} | {card}")
    numbered = [ln["iter"] for ln in lines] == list(range(start, start + iters))
    if not (len(lines) == iters and numbered
            and all(map(math.isfinite, losses)) and nonfinite == 0 and launches == want
            and {f"model_{i}.ckpt" for i in saved} <= set(ckpts)):
        raise AssertionError(f"{tag}: {len(lines)} metrics lines, non-finite resets "
                             f"{nonfinite}, launches {launches} (expected {want}), {ckpts}")
    return run_dir, lines, launches, robots, train_s


def _curve_line(lines, robots):
    """The learning curve of metrics.jsonl lines: mean reward, mean episode
    length (and, with two robots, the estimator loss) at the first
    iteration, every 50th (every 250th past LONG_RUN iterations) and the
    last; the non-finite resets and the iterations with a non-finite loss
    or step reward; the last learning rate. Iterations count from 1
    (metrics.jsonl's `iter` + 1)."""
    n = len(lines)
    every = 250 if n > LONG_RUN else 50
    at = sorted({1, n} | set(range(every, n + 1, every)))
    bad = [ln["iter"] + 1 for ln in lines if not all(
        math.isfinite(v) for k, v in ln.items() if k.startswith("Loss/")
        or k == "Train/mean_step_reward")]
    resets = [ln["iter"] + 1 for ln in lines if ln["Train/nonfinite_resets"]]
    return (" | ".join(
        f"iteration {i}: mean_reward {lines[i - 1]['Train/mean_reward']:.4g}, mean_episode_length "
        f"{lines[i - 1]['Train/mean_episode_length']:.1f}"
        + (f", estimator loss {lines[i - 1]['Loss/estimator']:.4g}" if robots > 1 else "")
        for i in at)
        + f" | non-finite resets {sum(ln['Train/nonfinite_resets'] for ln in lines):g} in "
        f"{len(resets)} iterations (first {resets[:1]}), iterations with a non-finite loss or "
        f"step reward {bad} | learning rate at the last iteration "
        f"{lines[-1]['Loss/learning_rate']:.3e}")


def _read_metrics(path):
    """The lines of a run's metrics.jsonl, or of its gzip (`.gz`)."""
    import gzip

    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return [json.loads(ln) for ln in f]


# keys of a metrics line that are times, not results
TIME_KEYS = ("Perf/",)


def _compare_runs(a, b):
    """Two runs' metrics lines side by side, iteration by iteration, every
    key but the times (TIME_KEYS): "identical through N iterations", or the
    first iteration (counted from 1) and key at which they differ with both
    values, and how many lines differ (NaN equal to NaN)."""
    def same(x, y):
        return x == y or (isinstance(x, float) and isinstance(y, float)
                          and math.isnan(x) and math.isnan(y))

    n = min(len(a), len(b))
    diff = [(i, k) for i in range(n) for k in sorted(set(a[i]) | set(b[i]))
            if not k.startswith(TIME_KEYS) and not same(a[i].get(k), b[i].get(k))]
    if not diff:
        return f"identical through {n} iterations (times {', '.join(TIME_KEYS)} not compared)"
    i, k = diff[0]
    return (f"first difference at iteration {i + 1}, key {k}: {a[i].get(k)!r} against "
            f"{b[i].get(k)!r}; {len({j for j, _ in diff})} of {n} iterations differ")


def _roll_checkpoint(path, robots, dev):
    """The actor of the checkpoint at `path` exported (`export_checkpoint`)
    and rolled as phase 12 rolls the demos: XBot-L on `humanoid_ppo` at
    WALK_VX (12 (a)); for a joint policy (two robots) also XBot-S on
    `humanoid_s_ppo` at WALK_VX sqrt(s) (12 (b)). Each roll must launch the
    flat kernel 401 times and the terrain one never. Returns {robot:
    (survived, median m, vx, seconds)}."""
    from humanoid_gym_tpu_torch.config.xbots import SCALE
    from humanoid_gym_tpu_torch.export import export_checkpoint
    from humanoid_gym_tpu_torch.physics import mega as MG

    cases = [("L", TRAIN_TASK, WALK_VX)]
    if robots == 2:
        cases.append(("S", "humanoid_s_ppo", WALK_VX * math.sqrt(SCALE)))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        export_checkpoint(path, d)
        for robot, task, vx in cases:
            MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
            t0 = time.perf_counter()
            survived, median = _roll_policy(task, os.path.join(d, "policy.npz"), vx, False, dev)
            n = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
            if n != (401, 0):
                raise AssertionError(f"{path} on {task}: kernel launches (flat, terrain) {n}")
            out[robot] = (survived, median, vx, time.perf_counter() - t0)
    return out


def _train_and_roll(card, dev, task, iters, seed, root, tag, gate_at=None, full_ckpts=()):
    """`_train_process` of `task` under a fresh `root`, then every
    ROLL_EVERY-th saved checkpoint past 0 (ROLL_EVERY_LONG-th past LONG_RUN
    iterations) and the last rolled by `_roll_checkpoint` (XBot-L; XBot-S
    too for a joint task); the line of
    checkpoint `gate_at` names WALK_GATE, which the caller holds its
    XBot-L roll to. model_0 (the untrained net) is removed. Returns (run
    directory, {checkpoint: {robot: (survived, median, vx, s)}}, launches,
    robots, seconds of the training process). `full_ckpts` goes to
    `_train_process`."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    run_dir, lines, launches, robots, train_s = _train_process(card, task, iters, seed, root, tag,
                                                               full_ckpts=full_ckpts)
    saved = _saved_checkpoints(run_dir)
    roll_every = ROLL_EVERY_LONG if iters > LONG_RUN else ROLL_EVERY
    rolled = {}
    for ck in [c for c in saved if c and (c % roll_every == 0 or c == saved[-1])]:
        rolled[ck] = _roll_checkpoint(os.path.join(run_dir, f"model_{ck}.ckpt"), robots, dev)
        for robot, (survived, median, vx, seconds) in rolled[ck].items():
            gate = (f"gate >= {WALK_GATE[0]} and >= {WALK_GATE[1]} m"
                    if ck == gate_at and robot == "L" else "reported, not gated")
            _log(f"{tag} checkpoint {ck}: export_checkpoint -> policy.npz, XBot-{robot} rolled as "
                 f"phase 12 ({'a' if robot == 'L' else 'b'}): {N_ENVS} envs, vx {vx:.4f} m/s, 400 "
                 f"steps in {seconds:.1f} s | survived {survived:.4f}, median forward distance "
                 f"{median:.3f} m ({gate}) | mega launches (flat, terrain) (401, 0) | {card}")
    # model_0 is the untrained net; dropping it keeps phase 22's run
    # directory under 60 MiB (the last checkpoint carries the 4096 envs'
    # state: ~45 MB)
    os.remove(os.path.join(run_dir, "model_0.ckpt"))
    return run_dir, rolled, launches, robots, train_s


def _phase22_train_from_scratch(card, dev):
    """Phase 22: `_train_and_roll` of `humanoid_ppo` for 200 iterations
    (the config's seed) under TRAIN_ROOT; checkpoint 200 is held to
    WALK_GATE, checkpoint 100 reported. Returns the launches of the
    training process."""
    t_phase = time.perf_counter()
    run_dir, rolled, launches, _, train_s = _train_and_roll(
        card, dev, TRAIN_TASK, TRAIN_ITERS, None, TRAIN_ROOT, "phase 22", gate_at=TRAIN_ITERS)
    _log(f"phase 22 wall time {time.perf_counter() - t_phase:.1f} s (training process "
         f"{train_s:.1f} s) | run directory {os.path.relpath(run_dir, HERE)} | {card}")
    survived, median = rolled[TRAIN_ITERS]["L"][:2]
    if not (survived >= WALK_GATE[0] and median >= WALK_GATE[1]):
        raise AssertionError(f"phase 22: checkpoint {TRAIN_ITERS} survived {survived}, median "
                             f"{median} m (gate {WALK_GATE})")
    return launches


# ---- phase 22j: the production joint recipe through `--train`'s path ----

JOINT_TRAIN_TASK = "humanoid_joint_deploy"
JOINT_TRAIN_ITERS = 10
JOINT_RESUME_ITERS = 2
# predicted wall time of phase 22j on the card (two training processes of
# ~8 s start-up, ~10 s env build and capture each, 12 iterations of ~0.3 s,
# two checkpoints with the env state; two 400-step rolls of ~8 s; the
# update probe: an env build and one eager iteration, ~10 s)
JOINT_TRAIN_PREDICTED_S = (50, 90)


def _phase22j_joint_train(card, dev):
    """Phase 22j: `_train_and_roll` of `humanoid_joint_deploy` (2048 XBot-L
    + 2048 XBot-S envs on the deploy field, the estimator head, the
    survival curriculum) for JOINT_TRAIN_ITERS iterations, the config's
    seed, in a temporary directory: every hard check of `_train_process`
    (B1t 2 x 60 x iters + 2 times, no flat launch), the last checkpoint
    exported and rolled as XBot-L and XBot-S; then `_train_process` again,
    resumed from that checkpoint (`--resume --load_run --checkpoint`) for
    JOINT_RESUME_ITERS iterations, its metrics numbered on from it and the
    launches as many; then `_update_probe` of the last checkpoint, its line
    complete and finite (`_probe_problems`) and its cut whole
    (`_fall_cut_problems`)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hgt_22j_") as root:
        run_dir, rolled, launches, robots, train_s = _train_and_roll(
            card, dev, JOINT_TRAIN_TASK, JOINT_TRAIN_ITERS, None, root, "phase 22j")
        if robots != 2 or sorted(rolled) != [JOINT_TRAIN_ITERS] or sorted(
                rolled[JOINT_TRAIN_ITERS]) != ["L", "S"]:
            raise AssertionError(f"phase 22j: robots {robots}, rolled {rolled}")
        _, lines, resumed, _, resume_s = _train_process(
            card, JOINT_TRAIN_TASK, JOINT_RESUME_ITERS, None, root, "phase 22j resume",
            resume=(run_dir, JOINT_TRAIN_ITERS))
        # the update probe of `--train --probe` on the run's last checkpoint,
        # so that it cannot rot: its line complete and finite, its cut whole
        cut = os.path.join(root, "fall_cut.npz")
        probe = _update_probe(os.path.join(run_dir, f"model_{JOINT_TRAIN_ITERS}.ckpt"),
                              JOINT_TRAIN_TASK, None, dev, cut=cut)
        _log(f"phase 22j probe {_probe_table([probe]).splitlines()[-1]} | {card}")
        problems = _probe_problems(probe) + _fall_cut_problems(cut)
        if problems:
            raise AssertionError(f"phase 22j: the update probe's line or cut: {problems}")
    wall = time.perf_counter() - t0
    _log(f"phase 22j wall time {wall:.1f} s (predicted {JOINT_TRAIN_PREDICTED_S[0]}-"
         f"{JOINT_TRAIN_PREDICTED_S[1]} s; training processes {train_s:.1f} + {resume_s:.1f} s) | "
         f"launches {launches}; resumed from checkpoint {JOINT_TRAIN_ITERS}: iterations "
         f"{lines[0]['iter']}-{lines[-1]['iter']}, launches {resumed} | {card}")


def _kept_checkpoints(saved):
    """Of the saved checkpoints (sorted), those `--train` keeps with their
    nets (the last KEEP_LAST) and those it keeps with their actors only
    (the other CURVE_EVERY-th)."""
    nets = saved[-KEEP_LAST:]
    return nets, [c for c in saved if c not in nets and c % CURVE_EVERY == 0]


def _cut_run(run_dir):
    """Cut a `--train` run directory to what comes back from the card: the
    checkpoints of `_kept_checkpoints` (the nets, or the actors only; no
    Adam moments, no env state), no other, no TensorBoard file
    (metrics.jsonl holds the same scalars). Returns (the checkpoints kept
    with their nets, those kept with their actors, MiB left)."""
    import glob

    import torch

    saved = _saved_checkpoints(run_dir)
    nets, actors = _kept_checkpoints(saved)
    for ck in saved:
        path = os.path.join(run_dir, f"model_{ck}.ckpt")
        if ck not in nets + actors:
            os.remove(path)
            continue
        net = torch.load(path, map_location="cpu", weights_only=True)["train_state"]["net"]
        if ck in actors:
            net = {k: v for k, v in net.items() if k.startswith("actor.")}
        torch.save({"train_state": {"net": net}}, path)
    for p in glob.glob(os.path.join(run_dir, "events.out.tfevents*")):
        os.remove(p)
    size = sum(os.path.getsize(os.path.join(run_dir, p)) for p in os.listdir(run_dir))
    return nets, actors, size / 2**20


def _diagnostic_train(task: str, iters: int, seed: int, probe=()) -> int:
    """`python3 chip_smoke.py --train TASK ITERS SEED [--probe C1,C2,...]`:
    the card line, the kernels' build, then `_train_and_roll` of TASK for
    ITERS iterations from SEED under chiprun_out/train/<task>_s<seed>/, no
    gate, the checkpoints in `probe` saved with their env state. Then, also
    when a check failed: `_probe_run` on those checkpoints (probe.jsonl,
    the last one's fall cut, blow-up traces), then the run directory is
    cut (`_cut_run`) and the kept checkpoints are printed. Prints no
    contract line."""
    import glob

    import torch

    card = _phase12_card_and_build()
    t0 = time.perf_counter()
    root = os.path.join(HERE, "chiprun_out", "train", f"{task}_s{seed}")
    dev = torch.device("cuda")
    try:
        _train_and_roll(card, dev, task, iters, seed, root, f"train {task} seed {seed}",
                        full_ckpts=probe)
    finally:
        for run_dir in glob.glob(os.path.join(root, "*", "")):
            try:
                if probe:
                    _probe_run(card, dev, task, seed, run_dir, probe)
            finally:
                nets, actors, mib = _cut_run(run_dir)
                _log(f"train {task} seed {seed} wall time {time.perf_counter() - t0:.1f} s | run "
                     f"directory {os.path.relpath(run_dir, HERE)}, {mib:.1f} MiB | kept with "
                     f"their nets: {nets}; their actors only: {actors} | {card}")
    return 0


def _train_argv(argv):
    """(task, iters, seed, probe checkpoints) of `--train TASK ITERS SEED
    [--probe C1,C2,...]`'s arguments (after `--train`)."""
    task, iters, seed, *rest = argv
    probe = ()
    if rest:
        if len(rest) != 2 or rest[0] != "--probe":
            raise SystemExit(f"--train TASK ITERS SEED [--probe C1,C2,...]: got {argv}")
        probe = tuple(sorted(int(c) for c in rest[1].split(",")))
    return task, int(iters), int(seed), probe


def _diagnostic_roll(npz: str, n_envs: int, horizons) -> int:
    """`python3 chip_smoke.py --roll NPZ N_ENVS STEPS [STEPS ...]`: the card
    line, the kernels' build, then the actor of NPZ rolled as phase 12 (a)
    rolls the walk demo (flat `humanoid_ppo`, vx WALK_VX, through the
    kernel) on N_ENVS envs, once for each horizon. Prints no contract
    line."""
    import torch

    card = _phase12_card_and_build()
    for n in horizons:
        t0 = time.perf_counter()
        survived, median = _roll_policy(TRAIN_TASK, npz, WALK_VX, False, torch.device("cuda"),
                                        n_steps=n, n_envs=n_envs)
        _log(f"roll {npz}: {n_envs} envs, vx {WALK_VX} m/s, {n} steps in "
             f"{time.perf_counter() - t0:.1f} s | survived {survived:.4f}, median forward "
             f"distance {median:.3f} m | {card}")
    return 0


# ---- the non-finite probe: physics inputs of the steps that explode ----

NONFINITE_TASK = "humanoid_joint_deploy"
NONFINITE_HISTORY = 200  # policy steps of physics inputs kept before an event
NONFINITE_ROOT = os.path.join(HERE, "chiprun_out", "nonfinite")


NONFINITE_KEPT = 16  # events whose inputs are kept; every event is counted


def _nonfinite_events(ckpt, steps, dev, n_envs=N_ENVS, actor_npz=None):
    """NONFINITE_TASK at n_envs envs on `dev` with its training config (DR,
    noise, pushes, the curriculum; solver mega) driven for `steps` policy
    steps by the net of the checkpoint `ckpt` (actions drawn from its
    Gaussian as the rollout draws them), its actor replaced by
    `actor_npz`'s where one is given (an exported policy keeps no std).
    Every sub-env's physics step is wrapped: an env whose state leaves the
    step non-finite, or whose reward is non-finite with a finite state, is
    an event. Returns ({(robot, kind): count}, the first NONFINITE_KEPT events,
    each with its robot, kind, step, env, terrain level and type, episode
    length, the physics inputs (PhysicsState rows and targets) of its last
    NONFINITE_HISTORY steps, the velocities, positions and contact impulses
    each of those steps returned, and the event step's outputs)."""
    import collections
    import dataclasses

    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg

    env, cfg = registry.make_env(NONFINITE_TASK, num_envs=n_envs, cfg_overrides=_solver_mega,
                                 device=dev, seed=0)
    tcfg = registry.get_task(NONFINITE_TASK).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0).to(dev)
    net.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True)
                        ["train_state"]["net"])
    if actor_npz is not None:
        actor_critic_from_npz(net, actor_npz)
    subs = getattr(env, "envs", [env])
    offsets = [0]
    for e in subs[:-1]:
        offsets.append(offsets[-1] + e.num_envs)
    history = [collections.deque(maxlen=NONFINITE_HISTORY) for _ in subs]
    last_out = [None] * len(subs)

    def rows(ps, i):
        return {f.name: getattr(ps, f.name)[i].detach().cpu().clone()
                for f in dataclasses.fields(ps)}

    def wrap(k, real):
        def step(phys, targets):
            out = real(phys, targets)
            history[k].append((phys, targets.clone(), out))
            last_out[k] = out
            return out
        return step

    def returned(out, i):
        return {f: getattr(out, f)[i].detach().cpu().clone()
                for f in ("qpos", "qvel", "contact_lam")}

    for k, e in enumerate(subs):
        e._phys_step = wrap(k, e._phys_step)
    events, counts = [], collections.Counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state, obs, _ = env.reset_all()
    with torch.no_grad():
        for t in range(steps):
            mean, std = net.act(obs)
            action = mean + std * torch.randn(mean.shape, generator=gen, device=dev)
            prev = state if isinstance(state, list) else [state]
            state, tr = env.step(state, action)
            bad_rew = ~torch.isfinite(tr.reward)
            for k, e in enumerate(subs):
                out = last_out[k]
                exploded = ~(torch.isfinite(out.qpos).all(1) & torch.isfinite(out.qvel).all(1))
                reward = bad_rew[offsets[k]:offsets[k] + e.num_envs] & ~exploded
                for kind, mask in (("state", exploded), ("reward", reward)):
                    for i in mask.nonzero()[:, 0].tolist():
                        counts[(k, kind)] += 1
                        if len(events) < NONFINITE_KEPT:
                            events.append({
                                "robot": k, "kind": kind, "step": t, "env": i,
                                "terrain_level": float(prev[k].terrain_level[i]),
                                "terrain_type": float(prev[k].terrain_type[i]),
                                "episode_length": int(prev[k].episode_length[i]),
                                "inputs": [(rows(p, i), tg[i].cpu()) for p, tg, _ in history[k]],
                                "returned": [returned(o, i) for _, _, o in history[k]],
                                "out": rows(out, i)})
            obs = tr.obs
    return counts, events


def _diagnostic_nonfinite(ckpt: str, steps: int, actor_npz=None) -> int:
    """`python3 chip_smoke.py --nonfinite CKPT STEPS [ACTOR_NPZ]`: the card
    line, the kernels' build, then `_nonfinite_events` at 4096 envs; the
    events are saved to chiprun_out/nonfinite/events_<CKPT or ACTOR_NPZ's
    name>.pt for a replay on the CPU (tests/test_torch_nonfinite.py).
    Prints one JSON line of the counts and the events and no contract
    line."""
    import torch

    card = _phase12_card_and_build()
    t0 = time.perf_counter()
    counts, events = _nonfinite_events(ckpt, steps, torch.device("cuda"), actor_npz=actor_npz)
    os.makedirs(NONFINITE_ROOT, exist_ok=True)
    tag = os.path.splitext(os.path.basename(actor_npz or ckpt))[0]
    torch.save({"task": NONFINITE_TASK, "ckpt": ckpt, "actor": actor_npz, "steps": steps,
                "events": events}, os.path.join(NONFINITE_ROOT, f"events_{tag}.pt"))
    print(json.dumps({
        "task": NONFINITE_TASK, "ckpt": ckpt, "actor": actor_npz, "envs": N_ENVS,
        "steps": steps, "seconds": round(time.perf_counter() - t0, 1),
        "counts": {f"robot {k} {kind}": n for (k, kind), n in sorted(counts.items())},
        "events": [{k: v for k, v in ev.items() if k not in ("inputs", "returned", "out")}
                   for ev in events],
        "card": card}), flush=True)
    return 0


# ---- the update probe: what drives the PPO update at a checkpoint ----

# a probe's line (`_update_probe`): its keys, those of its rollout reading
# and of each minibatch's reading; `_probe_problems` holds a line to them
PROBE_KEYS = ("checkpoint", "iteration", "envs", "horizon", "lr_before", "opt_count", "rollout",
              "minibatches", "means", "run_line", "seconds")
PROBE_ROLLOUT_KEYS = (
    "mean_step_reward", "max_abs_reward", "max_abs_return", "max_abs_advantage",
    "max_abs_advantage_normalized", "advantage_mean", "advantage_std",
    "max_abs_estimator_target", "done_rows", "nonfinite_resets", "nonfinite_envs",
    "blown_rows", "blown_row_share", "blown_value_loss_share", "blown_estimator_loss_share",
    "blown_max_abs_reward", "blown_max_abs_return", "blown_max_abs_estimator_target",
    "blown_events", "observation_clip", "runaway_rows", "runaway_envs", "runaway_row_share",
    "runaway_value_loss_share", "runaway_estimator_loss_share", "runaway_max_abs_return")
PROBE_TERMS = ("surrogate_loss", "value_loss", "entropy", "estimator_loss", "kl")
PROBE_MINIBATCH_KEYS = ("epoch", "minibatch", "grad_norm", "grad_share", "global_norm",
                        "clip_scale", "lr", "lr_at_floor") + PROBE_TERMS
# the adaptive learning rate's floor (algo/ppo.py minibatch_update, as the
# JAX package's)
LR_FLOOR = 1e-5


def _at_lr_floor(lr):
    """Whether a learning rate sits at LR_FLOOR: within 1e-6 relative, since
    a decrease from 1.5e-5 lands one float32 spacing above it and the next
    one clamps to it."""
    return lr <= LR_FLOOR * (1 + 1e-6)
PROBE_EVENTS_KEPT = 16  # non-finite resets listed with their last steps
PROBE_LAST_STEPS = 5  # steps listed of each, its reset step last
# the run's metrics read beside a probe (the iteration after its checkpoint)
PROBE_RUN_KEYS = ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                  "Loss/estimator", "Loss/learning_rate", "Train/mean_step_reward",
                  "Train/nonfinite_resets", "Episode/terrain_level")
FALL_CUT_ENVS = 16  # envs of a probed iteration kept for the CPU comparison
# forks of the cut's iteration tried, in turn, for a rollout that holds a
# non-finite reset (one in 2 to 3 iterations of seed 7 from 2400 on)
FALL_CUT_FORKS = 8
# the blow-up traces (tests/data/joint_deploy_blow_up*.npz): policy steps a
# trace holds, and what its window must show on the card: the base's
# angular velocity (rad/s) below the first bound after the first step and
# past the second within the window, no contact impulse after the last
TRACE_STEPS = 8
TRACE_SPIN = (9.0, 66.0)
PROBE_NONFINITE_STEPS = 1500  # policy steps driven for traces at a probed checkpoint
PROBE_TRACES = 2  # traces kept a checkpoint


def _update_probe(ckpt, task, seed, dev, n_envs=N_ENVS, horizon=None, run_lines=None, cut=None,
                  fork=0):
    """One eager training iteration of `task` from the full checkpoint
    `ckpt` (net, Adam moments and count, learning rate, the env state and
    obs of its iteration) of a run seeded `seed` (None: the task's config's)
    at `n_envs` envs (the card's solver mega, apgd on the CPU; `horizon`
    cuts T), through `make_train_pieces`' stages, the
    same code the captured iteration replays: a fork of the run, since a
    checkpoint keeps no generator (`fork` is added to the runner's seed,
    for another draw of the same iteration). Reads, before the update, the
    rollout: the largest |reward|, |return|, |advantage| (raw and normalised) and
    |estimator target|; the non-finite resets, the rows of each blown-up
    episode in the rollout (from the env's previous done to its reset) and
    those rows' share of the value-loss and estimator-loss row sums at the
    checkpoint's net, and of the first PROBE_EVENTS_KEPT resets the last
    PROBE_LAST_STEPS rewards, returns and values; the runaway rows, whose
    estimator target (the base's linear velocity) sits at the observation
    clip (a base moving at clip / scale, 9 m/s in the recipe: a robot
    spinning up or in flight, as before a blow-up, which this rollout may
    not reach), and their shares of those sums. Then, for each minibatch
    of the update (`num_learning_epochs` x `num_mini_batches`): the
    gradient norm of each parameter group alone (`group_grad_norms`) and
    its share of the squared global norm, the global norm and clip scale
    `minibatch_update` applies, the learning rate after the KL rule and
    whether it sits at LR_FLOOR, the KL and each loss term. `run_lines`
    (the run's metrics lines) adds the run's own line of that iteration.
    With `cut` a path, `_write_fall_cut` writes the iteration's cut there.
    Returns the probe's line (PROBE_KEYS)."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.ppo import group_grad_norms, make_train_pieces
    from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner

    t0 = time.perf_counter()
    dev = torch.device(dev)

    def solver(c):
        c.sim.solver.solver_type = "apgd" if dev.type == "cpu" else "mega"

    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    if "env_state" not in payload or payload["obs"].shape[0] != n_envs:
        raise ValueError(f"{ckpt}: an update probe needs a checkpoint with the env state of "
                         f"{n_envs} envs")
    tcfg = registry.get_task(task).make_train_cfg()
    seed = tcfg.seed if seed is None else seed
    env, cfg = registry.make_env(task, num_envs=n_envs, cfg_overrides=solver, device=dev,
                                 seed=seed)
    clip = cfg.normalization.clip_observations
    if horizon is not None:
        tcfg.runner.num_steps_per_env = horizon
    runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=seed + fork)
    runner.load(ckpt)
    ts, net, pcfg = runner.train_state, runner.net, runner.algo_cfg
    pieces = make_train_pieces(env, net, pcfg, n_envs, perm_seed=runner.seed)
    lr_before, count_before = float(ts.lr), int(ts.opt_count)
    net_before = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    perm = pieces["draw_permutation"](ts, runner.gen)
    _, _, last_priv, roll, infos = pieces["rollout_phase"](
        ts, runner.env_state, runner.obs, runner.priv_obs, runner.gen)
    adv_n, ret = pieces["compute_gae"](ts, roll, last_priv)
    lo, hi = pcfg.estimator_slice
    with torch.no_grad():
        adv = ret - roll.values
        last_value = net.evaluate(last_priv)
        target = roll.priv_obs[..., lo:hi]
        if pcfg.estimator_coef > 0.0 and net.estimator_dim > 0:
            est_rows = torch.stack([torch.square(net.estimate(o) - g).mean(-1)
                                    for o, g in zip(roll.obs, target)])
        else:
            est_rows = torch.zeros_like(ret)
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    rew, r, v, dones = np_(roll.rewards), np_(ret), np_(roll.values), np_(roll.dones)
    nonfin = np_(torch.stack([tr.nonfinite for tr in infos])) > 0
    val_rows, est_np = np.square(v - r), np_(est_rows)
    tgt_max = np_(target.abs().amax(-1))
    subs = getattr(env, "envs", [env])
    ends = np.cumsum([e.num_envs for e in subs])
    blown = np.zeros_like(dones)
    events = []
    for t, e in zip(*np.nonzero(nonfin)):
        prev = np.nonzero(dones[:t, e])[0]
        start = int(prev[-1]) + 1 if len(prev) else 0
        blown[start:t + 1, e] = True
        if len(events) < PROBE_EVENTS_KEPT:
            steps = slice(max(start, t - PROBE_LAST_STEPS + 1), t + 1)
            events.append({"step": int(t), "env": int(e),
                           "robot": int(np.searchsorted(ends, e, side="right")),
                           "rewards": rew[steps, e].tolist(), "returns": r[steps, e].tolist(),
                           "values": v[steps, e].tolist()})

    runaway = tgt_max >= clip

    def share(x, rows=blown):
        total = float(x.sum())
        return float(x[rows].sum()) / total if total > 0 else 0.0

    def amax(x):
        return float(np.abs(x).max()) if x.size else 0.0

    adv_np = np_(adv)
    rollout = {
        "mean_step_reward": float(torch.stack([tr.reward for tr in infos]).mean()),
        "max_abs_reward": amax(rew), "max_abs_return": amax(r), "max_abs_advantage": amax(adv_np),
        "max_abs_advantage_normalized": amax(np_(adv_n)),
        "advantage_mean": float(adv_np.mean()), "advantage_std": float(adv_np.std()),
        "max_abs_estimator_target": amax(tgt_max), "done_rows": int(dones.sum()),
        "nonfinite_resets": int(nonfin.sum()), "nonfinite_envs": int(nonfin.any(0).sum()),
        "blown_rows": int(blown.sum()), "blown_row_share": float(blown.mean()),
        "blown_value_loss_share": share(val_rows), "blown_estimator_loss_share": share(est_np),
        "blown_max_abs_reward": amax(rew[blown]), "blown_max_abs_return": amax(r[blown]),
        "blown_max_abs_estimator_target": amax(tgt_max[blown]), "blown_events": events,
        "observation_clip": clip, "runaway_rows": int(runaway.sum()),
        "runaway_envs": int(runaway.any(0).sum()), "runaway_row_share": float(runaway.mean()),
        "runaway_value_loss_share": share(val_rows, runaway),
        "runaway_estimator_loss_share": share(est_np, runaway),
        "runaway_max_abs_return": amax(r[runaway])}
    if cut is not None:
        _write_fall_cut(cut, roll, adv, adv_n, ret, last_value, last_priv, nonfin, perm, tgt_max,
                        ends, pcfg, net_before, lr_before, count_before, payload["iter"])

    mbs = pieces["minibatches"](roll, adv_n, ret, perm)
    minibatches = []
    for epoch in range(pcfg.num_learning_epochs):
        for i, mb in enumerate(mbs):
            loss, _ = pieces["make_loss_fn"](mb)(net)
            norms = {k: float(x) for k, x in group_grad_norms(net, loss).items()}
            ts, m = pieces["minibatch_update"](ts, mb)
            g, lr = float(m["grad_norm"]), float(ts.lr)
            sq = sum(x * x for x in norms.values())
            minibatches.append({
                "epoch": epoch, "minibatch": i, "grad_norm": norms,
                "grad_share": {k: x * x / sq if sq > 0 else 0.0 for k, x in norms.items()},
                "global_norm": g,
                "clip_scale": min(1.0, pcfg.max_grad_norm / (g + 1e-12)) if math.isfinite(g)
                else 0.0,
                "lr": lr, "lr_at_floor": _at_lr_floor(lr),
                **{k: float(m[k]) for k in PROBE_TERMS}})
    means = {k: statistics.fmean(mb[k] for mb in minibatches)
             for k in PROBE_TERMS + ("global_norm",)}
    run_line = next(({k: ln.get(k) for k in PROBE_RUN_KEYS} for ln in run_lines or ()
                     if ln["iter"] == payload["iter"]), None)
    return {"checkpoint": os.path.basename(ckpt), "iteration": int(payload["iter"]),
            "envs": n_envs, "horizon": pcfg.num_steps_per_env, "lr_before": lr_before,
            "opt_count": count_before, "rollout": rollout, "minibatches": minibatches,
            "means": means, "run_line": run_line,
            "seconds": round(time.perf_counter() - t0, 1)}


def _write_fall_cut(path, roll, adv, adv_n, ret, last_value, last_priv, nonfin, perm, tgt_max,
                    ends, pcfg, net, lr, count, iteration):
    """The cut of a probed iteration that tests/test_torch_fall_update.py
    holds against the JAX package on the CPU, as a compressed npz: the
    rollout of FALL_CUT_ENVS envs over its T steps, env-major (obs, priv,
    actions, mu, sigma, log_probs, values, rewards, dones, nonfinite), the
    envs that reset non-finite first, then in turn those with the largest
    |return| and the largest |estimator target|; their last values and
    privileged obs; the card's advantages (raw and normalised by the whole
    batch, with its mean and std) and returns; for each minibatch, the cut's
    rows (t * FALL_CUT_ENVS + index) in the permutation's order
    (`mb_rows`, split by `mb_sizes`); the net before the update (`net/...`),
    the learning rate and Adam count. The Adam moments are left out: they
    would add twice the net's 4.35 MB to the file."""
    import numpy as np
    import torch

    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    T, n = roll.rewards.shape
    r = np_(ret)
    order = [list(np.nonzero(nonfin.any(0))[0]), list(np.argsort(-np.abs(r).max(0))),
             list(np.argsort(-tgt_max.max(0)))]
    envs = order[0][:FALL_CUT_ENVS]
    for e in (e for pair in zip(order[1], order[2]) for e in pair):
        if len(envs) == FALL_CUT_ENVS:
            break
        if e not in envs:
            envs.append(e)
    envs = np.array(envs, dtype=np.int64)
    idx = torch.as_tensor(envs, device=roll.rewards.device)
    k = len(envs)
    where = np.full(n, -1)
    where[envs] = np.arange(k)
    mb = T * n // pcfg.num_mini_batches
    rows, sizes = [], []
    for i in range(pcfg.num_mini_batches):
        g = np_(perm[i * mb:(i + 1) * mb])
        j = where[g % n]
        keep = j >= 0
        rows.append((g // n)[keep] * k + j[keep])
        sizes.append(int(keep.sum()))
    env_major = lambda x: np.ascontiguousarray(np_(x[:, idx]).swapaxes(0, 1))  # noqa: E731
    arrays = {name: env_major(getattr(roll, name)) for name in (
        "obs", "priv_obs", "actions", "mu", "sigma", "log_probs", "values", "rewards", "dones")}
    arrays.update(
        nonfinite=np.ascontiguousarray(nonfin[:, envs].T), card_adv=env_major(adv),
        card_adv_normalized=env_major(adv_n), card_ret=env_major(ret),
        card_adv_mean=np.float32(float(adv.mean())),
        card_adv_std=np.float32(float(torch.sqrt(torch.square(adv - adv.mean()).mean()))),
        last_value=np_(last_value[idx]), last_priv_obs=np_(last_priv[idx]), envs=envs,
        robot=np.searchsorted(ends, envs, side="right"), mb_rows=np.concatenate(rows),
        mb_sizes=np.array(sizes), lr=np.float32(lr), opt_count=np.int64(count),
        iteration=np.int64(iteration),
        **{f"net/{name}": v.numpy() for name, v in net.items()})
    np.savez_compressed(path, **arrays)


# the arrays of a fall cut, each with its leading shape in terms of the cut's
# envs (k), the horizon (T) and the rows of the minibatches (m)
FALL_CUT_ARRAYS = {
    "obs": ("k", "T"), "priv_obs": ("k", "T"), "actions": ("k", "T"), "mu": ("k", "T"),
    "sigma": ("k", "T"), "log_probs": ("k", "T"), "values": ("k", "T"), "rewards": ("k", "T"),
    "dones": ("k", "T"), "nonfinite": ("k", "T"), "card_adv": ("k", "T"),
    "card_adv_normalized": ("k", "T"), "card_ret": ("k", "T"), "last_value": ("k",),
    "last_priv_obs": ("k",), "envs": ("k",), "robot": ("k",), "mb_rows": ("m",),
    "card_adv_mean": (), "card_adv_std": (), "mb_sizes": (), "lr": (), "opt_count": (),
    "iteration": ()}


def _fall_cut_problems(path):
    """What the fall cut at `path` (`_write_fall_cut`) lacks: a missing
    array, a leading shape that disagrees with the others, a minibatch row
    out of range, a non-finite float, no net."""
    import numpy as np

    z = np.load(path)
    problems = [k for k in FALL_CUT_ARRAYS if k not in z.files]
    if problems:
        return problems
    k, T = z["rewards"].shape
    dims = {"k": k, "T": T, "m": int(z["mb_sizes"].sum())}
    for name, lead in FALL_CUT_ARRAYS.items():
        if z[name].shape[:len(lead)] != tuple(dims[d] for d in lead):
            problems.append(f"{name} {z[name].shape}")
    if len(z["mb_rows"]) and not 0 <= z["mb_rows"].min() <= z["mb_rows"].max() < k * T:
        problems.append("mb_rows out of range")
    nets = [n for n in z.files if n.startswith("net/")]
    problems += [] if nets else ["no net/ arrays"]
    problems += [n for n in z.files if z[n].dtype.kind == "f" and not np.isfinite(z[n]).all()]
    return problems


def _blow_up_trace(ev):
    """A blow-up trace in the format of tests/data/joint_deploy_blow_up.npz
    (`state_<field>` the PhysicsState row before the first step,
    `targets` and `card_qvel` the joint targets and returned velocities of
    TRACE_STEPS steps, `robot`) cut from a `_nonfinite_events` event: the
    latest window of TRACE_STEPS steps, all returned finite, each step's
    input the previous one's output (no push or reset between), the base's
    angular velocity below TRACE_SPIN[0] after the first step and past
    TRACE_SPIN[1] within the window, and no contact impulse after the
    last. None if the event has no such window."""
    import numpy as np
    import torch

    ins, outs = ev["inputs"], ev["returned"]
    spin = [float(o["qvel"][3:6].abs().max()) for o in outs]
    for s in range(len(ins) - TRACE_STEPS, -1, -1):
        w = range(s, s + TRACE_STEPS)
        if not (all(torch.isfinite(outs[k]["qvel"]).all() and torch.isfinite(outs[k]["qpos"]).all()
                    for k in w)
                and all(torch.equal(ins[k + 1][0][f], outs[k][f]) for k in w[:-1]
                        for f in ("qpos", "qvel"))
                and spin[s] < TRACE_SPIN[0] and max(spin[s:s + TRACE_STEPS]) > TRACE_SPIN[1]
                and float(outs[w[-1]]["contact_lam"].abs().max()) == 0.0):
            continue
        return {**{f"state_{k}": v.numpy() for k, v in ins[s][0].items()},
                "targets": np.stack([ins[k][1].numpy() for k in w]),
                "card_qvel": np.stack([outs[k]["qvel"].numpy() for k in w]),
                "robot": np.int64(ev["robot"])}
    return None


def _probe_problems(line, groups=("actor", "critic", "estimator")):
    """What a probe line (`_update_probe`) lacks: each missing key of
    PROBE_KEYS, PROBE_ROLLOUT_KEYS, PROBE_MINIBATCH_KEYS and of `groups` in
    each minibatch's norms, and each number in it that is not finite. An
    empty list: the line is complete and finite."""
    problems = [k for k in PROBE_KEYS if k not in line]
    problems += [f"rollout.{k}" for k in PROBE_ROLLOUT_KEYS if k not in line.get("rollout", {})]
    for i, mb in enumerate(line.get("minibatches") or [None]):
        if mb is None:
            problems.append("minibatches: none")
            continue
        problems += [f"minibatches[{i}].{k}" for k in PROBE_MINIBATCH_KEYS if k not in mb]
        problems += [f"minibatches[{i}].grad_norm.{g}" for g in groups
                     if g not in mb.get("grad_norm", {})]

    def walk(x, at):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{at}.{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{at}[{i}]")
        elif isinstance(x, float) and not math.isfinite(x):
            problems.append(f"{at} = {x}")

    walk({k: v for k, v in line.items() if k != "run_line"}, "line")
    return problems


def _probe_table(lines):
    """The probe lines of a probe.jsonl as a markdown table, a row a
    checkpoint: the global gradient norm (median and range over the
    minibatches), each group's median share of its square, the clip scale
    (median, least), the learning rate at the first and last minibatch and
    how many sat at the floor (`_at_lr_floor`), the mean KL, the value and estimator losses
    (the probe's mean beside the run's own line of that iteration), the
    rollout's non-finite resets, its runaway rows (envs) with their shares
    of the value- and estimator-loss sums, and its largest |estimator
    target|."""
    head = ("| checkpoint | \\|g\\| median (range) | share of \\|g\\|^2 actor / critic / "
            "estimator | clip median (least) | lr first -> last (at floor) | KL | value loss "
            "probe / run | estimator loss probe / run | non-finite resets | runaway rows (envs); "
            "value / estimator share | max \\|est. target\\| |")
    rows = [head, "|" + "---|" * 11]
    for ln in lines:
        mbs, ro, run = ln["minibatches"], ln["rollout"], ln["run_line"] or {}
        g = [mb["global_norm"] for mb in mbs]
        share = {k: statistics.median(mb["grad_share"][k] for mb in mbs)
                 for k in mbs[0]["grad_share"]}
        clip = [mb["clip_scale"] for mb in mbs]
        run_v, run_e = run.get("Loss/value_function"), run.get("Loss/estimator")
        rows.append(
            f"| {_ckpt_iteration(ln['checkpoint'])} | {statistics.median(g):.3g} "
            f"({min(g):.3g}-{max(g):.3g}) | "
            + " / ".join(f"{share[k]:.3f}" for k in ("actor", "critic", "estimator") if k in share)
            + f" | {statistics.median(clip):.3g} ({min(clip):.3g}) | {mbs[0]['lr']:.3g} -> "
            f"{mbs[-1]['lr']:.3g} ({sum(_at_lr_floor(mb['lr']) for mb in mbs)} of {len(mbs)}) | "
            f"{ln['means']['kl']:.3g} | {ln['means']['value_loss']:.3g} / "
            f"{'-' if run_v is None else f'{run_v:.3g}'} | {ln['means']['estimator_loss']:.3g} / "
            f"{'-' if run_e is None else f'{run_e:.3g}'} | {ro['nonfinite_resets']} | "
            f"{ro['runaway_rows']} ({ro['runaway_envs']}); {ro['runaway_value_loss_share']:.3g}"
            f" / {ro['runaway_estimator_loss_share']:.3g} | "
            f"{ro['max_abs_estimator_target']:.3g} |")
    return "\n".join(rows)


def _probe_run(card, dev, task, seed, run_dir, probe):
    """`--train ... --probe`: `_update_probe` of each checkpoint in `probe`
    of the run directory, one line each appended to its probe.jsonl, the
    last one's cut written to fall_cut_<c>.npz, from the first of its
    FALL_CUT_FORKS forks whose rollout holds a non-finite reset (or the
    last); then the last two probed checkpoints drive `_nonfinite_events`
    for PROBE_NONFINITE_STEPS policy steps and up to PROBE_TRACES blow-up
    traces of each (`_blow_up_trace`) are written to blow_up_<c>_<k>.npz."""
    import numpy as np

    lines = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    for c in probe:
        ckpt = os.path.join(run_dir, f"model_{c}.ckpt")
        cut = os.path.join(run_dir, f"fall_cut_{c}.npz") if c == probe[-1] else None
        line = _update_probe(ckpt, task, seed, dev, run_lines=lines, cut=cut)
        with open(os.path.join(run_dir, "probe.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        _log(f"probe {_probe_table([line]).splitlines()[-1]} | {card}")
        fork = 1
        while cut is not None and not line["rollout"]["nonfinite_resets"] \
                and fork < FALL_CUT_FORKS:
            line = _update_probe(ckpt, task, seed, dev, cut=cut, fork=fork)
            _log(f"probe cut: fork {fork} of model_{c}.ckpt, non-finite resets "
                 f"{line['rollout']['nonfinite_resets']} | {card}")
            fork += 1
    for c in probe[-2:]:
        t0 = time.perf_counter()
        counts, events = _nonfinite_events(os.path.join(run_dir, f"model_{c}.ckpt"),
                                           PROBE_NONFINITE_STEPS, dev)
        kept = []
        for ev in events:
            trace = _blow_up_trace(ev)
            if trace is not None and len(kept) < PROBE_TRACES:
                kept.append((ev, trace))
                np.savez_compressed(os.path.join(run_dir, f"blow_up_{c}_{len(kept)}.npz"), **trace)
        _log(f"probe blow-ups of model_{c}.ckpt: {PROBE_NONFINITE_STEPS} steps, counts "
             f"{dict(counts)}, traces kept "
             f"{[(ev['robot'], ev['step'], ev['env']) for ev, _ in kept]} | "
             f"{time.perf_counter() - t0:.1f} s | {card}")


# ---- phase 23: the random draw sites held to their laws on the card ----

# The law checks of tests/test_torch_random_paths.py, copied here (the
# port's package has no use for them; tests/test_torch_chip_smoke.py pins
# the copies equal): every comparison has a false-alarm rate of LAW_ALPHA
# for a sample that follows the law, so the KS limit is LAW_KS_C / sqrt(n)
# and a mean or a variance may miss by LAW_Z standard errors.
LAW_ALPHA = 1e-4
LAW_KS_C = math.sqrt(-math.log(LAW_ALPHA / 2) / 2)
LAW_Z = statistics.NormalDist().inv_cdf(1 - LAW_ALPHA / 2)


def _ks_discrete(x, support, cdf):
    """sup |F_n - F| over the support of a discrete law (exact there)."""
    import numpy as np

    ecdf = np.searchsorted(np.sort(x), support, side="right") / len(x)
    return float(np.max(np.abs(ecdf - cdf(support))))


def _var_se(x, var, excess_kurtosis):
    """Standard error of the sample variance of len(x) draws."""
    return var * ((excess_kurtosis + 2.0) / len(x)) ** 0.5


def _hold(name, x, law, support=None):
    """The checks of one sample against a frozen scipy law, each (label,
    statistic, limit): KS, the mean and the variance."""
    import numpy as np
    from scipy import stats

    x = np.asarray(x, np.float64).ravel()
    mu, var, _, kurt = (float(v) for v in law.stats(moments="mvsk"))
    dk = (stats.kstest(x, law.cdf).statistic if support is None
          else _ks_discrete(x, support, law.cdf))
    return [(f"{name}: KS", dk, LAW_KS_C / len(x) ** 0.5),
            (f"{name}: mean", abs(x.mean() - mu), LAW_Z * (var / len(x)) ** 0.5),
            (f"{name}: variance", abs(x.var() - var), LAW_Z * _var_se(x, var, kurt))]


def _exact(name, got, want, atol=1e-6):
    """A deterministic relation the path must keep (label, max error, limit)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return [(name, float(np.max(np.abs(got - want))) if got.size else 0.0, atol)]


def _dead_zone_kept_cdf(box, r, a):
    """CDF of one command component given that the pair (vx, vy), uniform
    on box = ((x0, x1), (y0, y1)), lies outside the disk of radius r about
    0 (the resampler's dead zone, inside the box). `a`: 0 for vx, 1 for
    vy."""
    import numpy as np

    (x0, x1), (y0, y1) = box
    lo, other = (x0, y1 - y0) if a == 0 else (y0, x1 - x0)
    kept = (x1 - x0) * (y1 - y0) - math.pi * r * r

    def cdf(x):
        u = np.clip(x, -r, r)
        disk = u * np.sqrt(r * r - u * u) + r * r * (np.arcsin(u / r) + math.pi / 2)
        return ((np.asarray(x) - lo) * other - disk) / kept

    return cdf


def _dead_zone(name, c, vx_range, vy_range, r=0.2):
    """Commands (N, >=2): the share of zeroed pairs against the closed
    form, and each kept component against its conditional law."""
    import numpy as np
    from scipy import stats

    box = (tuple(vx_range), tuple(vy_range))
    p0 = math.pi * r * r / ((box[0][1] - box[0][0]) * (box[1][1] - box[1][0]))
    c = np.asarray(c, np.float64)
    zero = (c[:, 0] == 0) & (c[:, 1] == 0)
    out = [(f"{name}: zeroed share - {p0:.4f}", abs(zero.mean() - p0),
            LAW_Z * (p0 * (1 - p0) / len(c)) ** 0.5)]
    out += _exact(f"{name}: kept pairs outside the dead zone",
                  np.minimum(np.hypot(c[~zero, 0], c[~zero, 1]) - r, 0.0), 0.0)
    for a, comp in ((0, "vx"), (1, "vy")):
        x = c[~zero, a]
        out.append((f"{name}: KS kept {comp}",
                    stats.kstest(x, _dead_zone_kept_cdf(box, r, a)).statistic,
                    LAW_KS_C / len(x) ** 0.5))
    return out


def _delay_law(d_max, sigma, k):
    """(CDF, mean, variance) of 1 - mean_k((1 - d)(1 + sigma z_i)), d ~
    U(0, d_max), z_i standard normal: d - (1 - d) sigma zbar, zbar ~ N(0,
    1/k)."""
    import numpy as np
    from scipy import stats

    d = np.linspace(0.0, d_max, 4001)

    def cdf(x):
        x = np.atleast_1d(np.asarray(x, np.float64))
        s = (1 - d)[None] * sigma / math.sqrt(k)
        return np.trapezoid(stats.norm.cdf((x[:, None] - d[None]) / s), d, axis=1) / d_max

    var = d_max ** 2 / 12 + sigma ** 2 / k * (1 - d_max + d_max ** 2 / 3)
    return cdf, d_max / 2, var


def _phase23_laws(card, dev, n_envs=N_ENVS):
    """Phase 23: the random draw sites of the training path on the card,
    each held to the closed-form law of its config (the env's CUDA
    generator; `humanoid_ppo` through B1, `humanoid_ppo_terrain_robust`
    through B1t; solver mega). Flat, from `init_state`: the joint offsets,
    friction, added base mass, motor strength (switched on) and the
    commands; from two steps after `reset_all` with a push and a command
    resample on every second step: the action delay and noise, the push,
    the resampled commands, the observation noise. Terrain, from
    `init_state`: the base xy about the origin, the contact stiffness,
    offset and compliance, the slope bias, the initial level and type; from
    a time-out step on the top row: the re-entry level and the reset pose.
    The production recipe `humanoid_joint_deploy` (B1t, each robot): from
    `init_state` the initial level, type, origin and spawn, the contact DR,
    the slope bias and the commands; from a time-out step on or past the
    top row the re-entry level and the reset pose. Then the runner's
    random initial episode lengths. Prints one line a site; a miss fails
    the run."""
    import numpy as np
    import torch
    from scipy import stats

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"

    def npy(x):
        return x.detach().cpu().numpy().astype(np.float64)

    def uniform(lo, hi):
        return stats.uniform(lo, hi - lo)

    def flat_ov(c):
        _solver_mega(c)
        c.domain_rand.randomize_motor_strength = True
        c.domain_rand.push_interval_s = 1.5 * c.dt  # a push on every second step
        c.commands.resampling_time = 2 * c.dt  # and a command resample

    sites = {}
    env, cfg = registry.make_env(TRAIN_TASK, num_envs=n_envs, cfg_overrides=flat_ov, device=dev,
                                 seed=23)
    dr, cr = cfg.domain_rand, cfg.commands.ranges
    st = env.init_state()
    dof = npy(env.default_dof_pos)
    sites["initial joint pose"] = _hold("joint offset", npy(st.phys.qpos[:, 7:]) - dof,
                                        uniform(-0.1, 0.1))
    sites["friction"] = _hold("env_friction", npy(st.env_friction), uniform(*dr.friction_range))
    sites["added mass"] = _hold(
        "added base mass (kg)", (npy(st.phys.base_mass_scale) - 1) * float(env.model.body_mass[0]),
        uniform(*dr.added_mass_range))
    sites["motor strength"] = (
        _hold("kp_scale", npy(st.phys.kp_scale), uniform(*dr.motor_strength_range))
        + _hold("kd_scale", npy(st.phys.kd_scale), uniform(*dr.motor_strength_range)))
    c0 = npy(st.commands)
    sites["commands at init"] = (_dead_zone("command", c0, cr.lin_vel_x, cr.lin_vel_y)
                                 + _hold("heading", c0[:, 3], uniform(*cr.heading)))

    # two steps after reset_all (common_step 1): the first pushes and
    # resamples, the second does neither. Previous actions 1 on joints 0-5
    # and 0 on 6-11, the policy action 1: joints 0-5 read the noise, 6-11
    # the delay (tests/test_torch_random_paths.py says how)
    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    st, _, _ = env.reset_all()
    prev = torch.zeros((n_envs, 12), device=dev)
    prev[:, :6] = 1.0
    st = st.replace(actions=prev, ref_dof_pos=torch.zeros_like(st.ref_dof_pos))
    ones = torch.ones((n_envs, 12), device=dev)
    st1, tr1 = env.step(st, ones)
    st2, tr2 = env.step(st1, ones)
    flat_launches = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
    k = ~(npy(tr1.done) > 0) & ~(npy(tr2.done) > 0)
    a1 = npy(st1.actions)[k]
    cdf, mean, var = _delay_law(dr.action_delay, dr.action_noise, 6)
    delay = 1 - a1[:, 6:].mean(1)
    sites["action delay and noise"] = (
        _hold("action noise z", (a1[:, :6] - 1) / dr.action_noise, stats.norm())
        + [("delay estimate: KS", stats.kstest(delay, cdf).statistic,
            LAW_KS_C / len(delay) ** 0.5),
           ("delay estimate: mean", abs(delay.mean() - mean), LAW_Z * (var / len(delay)) ** 0.5)])
    pf1, pt1, qv1 = npy(st1.rand_push_force), npy(st1.rand_push_torque), npy(st1.phys.qvel)
    pushes = []
    for a in (0, 1):
        pushes += _hold(f"push v_{'xy'[a]}", pf1[:, a],
                        uniform(-dr.max_push_vel_xy, dr.max_push_vel_xy))
    for a in range(3):
        pushes += _hold(f"push w_{'xyz'[a]}", pt1[:, a],
                        uniform(-dr.max_push_ang_vel, dr.max_push_ang_vel))
    pushes += _exact("qvel = push", np.concatenate([qv1[k, 0:2], qv1[k, 3:6]], 1),
                     np.concatenate([pf1[k, :2], pt1[k]], 1), 0.0)
    pushes += _exact("no push off the interval",
                     np.concatenate([npy(st2.rand_push_force), npy(st2.rand_push_torque)], 1),
                     np.concatenate([pf1, pt1], 1), 0.0)
    sites["pushes"] = pushes
    c1, c2 = npy(st1.commands)[k], npy(st2.commands)[k]
    sites["commands at a resample"] = (
        _dead_zone("command", c1, cr.lin_vel_x, cr.lin_vel_y)
        + _hold("heading", c1[:, 3], uniform(*cr.heading))
        + _exact("no resample off the interval", c2[:, [0, 1, 3]], c1[:, [0, 1, 3]], 0.0))
    os_ = cfg.normalization.obs_scales
    scale = npy(env.noise_scale_vec) * cfg.noise.noise_level
    phase = npy(st1.episode_length) * env.dt / cfg.rewards.cycle_time
    clean = np.concatenate([
        np.sin(2 * np.pi * phase)[:, None], np.cos(2 * np.pi * phase)[:, None],
        npy(st1.commands)[:, :3] * [os_.lin_vel, os_.lin_vel, os_.ang_vel],
        (npy(st1.phys.qpos[:, 7:]) - dof) * os_.dof_pos, npy(st1.phys.qvel[:, 6:]) * os_.dof_vel,
        npy(st1.actions), npy(st1.base_ang_vel) * os_.ang_vel, npy(st1.base_euler) * os_.quat],
        axis=1)
    diff = npy(tr1.obs).reshape(n_envs, -1, cfg.env.num_single_obs)[:, -1] - clean
    noisy = scale > 0
    sites["observation noise"] = (
        _hold("observation noise z", diff[:, noisy] / scale[noisy], stats.norm())
        + _exact("noise-free entries", diff[:, ~noisy], 0.0, 1e-5))

    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    tenv, tcfg = registry.make_env(TERRAIN_TASK, num_envs=n_envs, cfg_overrides=_solver_mega,
                                   device=dev, seed=23)
    tdr, tc = tcfg.domain_rand, tcfg.terrain
    st = tenv.init_state()
    origins = npy(tenv.terrain_origins)
    lvl, ty = npy(st.terrain_level).astype(int), npy(st.terrain_type).astype(int)
    xy = npy(st.phys.qpos[:, :2]) - npy(st.env_origin[:, :2])
    sites["initial base xy"] = (_hold("base x - origin", xy[:, 0], uniform(-1.0, 1.0))
                                + _hold("base y - origin", xy[:, 1], uniform(-1.0, 1.0)))
    sites["contact stiffness, offset, compliance"] = sum(
        (_hold(f, npy(getattr(st.phys, f)), stats.loguniform(*rng)) for f, rng in (
            ("contact_stiffness", tdr.contact_stiffness_range),
            ("contact_offset", tdr.contact_offset_range),
            ("contact_compliance", tdr.contact_compliance_range))), [])
    sites["contact slope bias"] = (
        _hold("slope_bias x", npy(st.phys.slope_bias[:, 0]), uniform(*tdr.contact_slope_range))
        + _hold("slope_bias y", npy(st.phys.slope_bias[:, 1]), uniform(*tdr.contact_slope_range)))
    hi = tc.max_init_terrain_level
    sites["initial terrain level and type"] = (
        _hold("terrain_level", lvl, stats.randint(0, hi + 1), support=np.arange(hi + 1))
        + _exact("terrain_type", ty, np.arange(n_envs) * tc.num_cols // n_envs, 0.0)
        + _exact("env_origin", npy(st.env_origin),
                 origins[np.minimum(lvl, tc.num_rows - 1), ty]))
    # a time-out on the top row with no command: the survival curriculum
    # moves every env past the top, so it re-enters at a uniform level
    st, _, _ = tenv.reset_all()
    top = torch.full_like(st.terrain_level, tc.num_rows - 1)
    st = st.replace(episode_length=torch.full_like(st.episode_length, tenv.max_episode_length),
                    terrain_level=top, env_origin=tenv.terrain_origin(top, st.terrain_type),
                    commands=torch.zeros_like(st.commands))
    st1, tr1 = tenv.step(st, torch.zeros((n_envs, 12), device=dev))
    terrain_launches = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
    lvl1, ty1 = npy(st1.terrain_level).astype(int), npy(st1.terrain_type).astype(int)
    xy1 = npy(st1.phys.qpos[:, :2]) - npy(st1.env_origin[:, :2])
    sites["reset pose and level"] = (
        _exact("every env timed out", npy(tr1.time_out), 1.0, 0.0)
        + _hold("re-entry level", lvl1, stats.randint(0, tc.num_rows),
                support=np.arange(tc.num_rows))
        + _exact("reset origin", npy(st1.env_origin), origins[lvl1, ty1])
        + _hold("reset joint offset", npy(st1.phys.qpos[:, 7:]) - npy(tenv.default_dof_pos),
                uniform(-0.1, 0.1))
        + _hold("reset base x - origin", xy1[:, 0], uniform(-1.0, 1.0))
        + _hold("reset base y - origin", xy1[:, 1], uniform(-1.0, 1.0)))
    del tenv, st, st1

    # the production recipe: each robot's sites on the deploy field
    # (tests/test_torch_random_paths_deploy.py holds them to the JAX package)
    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    denv, _ = registry.make_env(JOINT_TRAIN_TASK, num_envs=n_envs, cfg_overrides=_solver_mega,
                                device=dev, seed=23)
    step_in = []
    for sub, st in zip(denv.envs, denv.init_state()):
        robot, sdr, sc, scr = sub.cfg.asset.name, sub.cfg.domain_rand, sub.cfg.terrain, \
            sub.cfg.commands.ranges
        m, origins = st.terrain_level.shape[0], npy(sub.terrain_origins)
        lvl, ty = npy(st.terrain_level).astype(int), npy(st.terrain_type).astype(int)
        hi = sc.max_init_terrain_level
        xy = npy(st.phys.qpos[:, :2]) - npy(st.env_origin[:, :2])
        sites[f"{robot} deploy level, origin and spawn"] = (
            _hold("terrain_level", lvl, stats.randint(0, hi + 1), support=np.arange(hi + 1))
            + _exact("terrain_type", ty, np.arange(m) * sc.num_cols // m, 0.0)
            + _exact("env_origin", npy(st.env_origin),
                     origins[np.minimum(lvl, sc.num_rows - 1), ty])
            + _hold("base x - origin", xy[:, 0], uniform(-1.0, 1.0))
            + _hold("base y - origin", xy[:, 1], uniform(-1.0, 1.0))
            + _hold("joint offset", npy(st.phys.qpos[:, 7:]) - npy(sub.default_dof_pos),
                    uniform(-0.1, 0.1)))
        sites[f"{robot} deploy contact DR"] = (
            _hold("env_friction", npy(st.env_friction), uniform(*sdr.friction_range))
            + _hold("added base mass (kg)",
                    (npy(st.phys.base_mass_scale) - 1) * float(sub.model.body_mass[0]),
                    uniform(*sdr.added_mass_range))
            + sum((_hold(f, npy(getattr(st.phys, f)), stats.loguniform(*rng)) for f, rng in (
                ("contact_stiffness", sdr.contact_stiffness_range),
                ("contact_offset", sdr.contact_offset_range),
                ("contact_compliance", sdr.contact_compliance_range))), []))
        sites[f"{robot} deploy slope bias"] = sum(
            (_hold(f"slope_bias {ax}", npy(st.phys.slope_bias[:, a]),
                   uniform(*sdr.contact_slope_range)) for a, ax in ((0, "x"), (1, "y"))), [])
        cs = npy(st.commands)
        sites[f"{robot} deploy commands at init"] = (
            _dead_zone("command", cs, scr.lin_vel_x, scr.lin_vel_y)
            + _hold("heading", cs[:, 3], uniform(*scr.heading)))
        # on the top row (19) or past it (20), timing out with no command
        past = torch.where(torch.arange(m, device=dev) % 2 == 0, sc.num_rows - 1, sc.num_rows)
        past = past.to(st.terrain_level.dtype)
        step_in.append(st.replace(
            episode_length=torch.full_like(st.episode_length, sub.max_episode_length),
            terrain_level=past, env_origin=sub.terrain_origin(past, st.terrain_type),
            commands=torch.zeros_like(st.commands)))
    dst1, dtr1 = denv.step(step_in, torch.zeros((n_envs, 12), device=dev))
    deploy_launches = (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches)
    for sub, st1 in zip(denv.envs, dst1):
        rows, origins = sub.cfg.terrain.num_rows, npy(sub.terrain_origins)
        lvl1, ty1 = npy(st1.terrain_level).astype(int), npy(st1.terrain_type).astype(int)
        xy1 = npy(st1.phys.qpos[:, :2]) - npy(st1.env_origin[:, :2])
        sites[f"{sub.cfg.asset.name} deploy re-entry and reset pose"] = (
            _hold("re-entry level", lvl1, stats.randint(0, rows), support=np.arange(rows))
            + _exact("reset origin", npy(st1.env_origin), origins[lvl1, ty1])
            + _hold("reset joint offset", npy(st1.phys.qpos[:, 7:]) - npy(sub.default_dof_pos),
                    uniform(-0.1, 0.1))
            + _hold("reset base x - origin", xy1[:, 0], uniform(-1.0, 1.0))
            + _hold("reset base y - origin", xy1[:, 1], uniform(-1.0, 1.0)))
    sites["deploy time-outs"] = _exact("every env timed out", npy(dtr1.time_out), 1.0, 0.0)
    del denv, step_in, dst1

    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO

    runner = OnPolicyRunner(env, XBotLCfgPPO(), log_dir=None)
    runner.learn(0, init_at_random_ep_len=True)
    sites["runner's initial episode lengths"] = _hold(
        "episode_length", npy(runner.env_state.episode_length),
        stats.randint(0, env.max_episode_length), support=np.arange(env.max_episode_length))

    misses = []
    for site, checks in sites.items():
        label, stat, limit = max(checks, key=lambda c: c[1] / c[2] if c[2] > 0 else
                                 (0.0 if c[1] == 0 else float("inf")))
        bad = [c for c in checks if not c[1] <= c[2]]
        misses += [f"{site}: {lab} {s:.4g} > {lim:.4g}" for lab, s, lim in bad]
        _log(f"phase 23 {site}: {len(checks)} checks, {len(bad)} missed | closest: {label} "
             f"{stat:.4g} (limit {limit:.4g}) | {n_envs} envs | {card}")
    want = ((3, 0), (0, 2), (0, 2)) if on_card else ((0, 0), (0, 0), (0, 0))
    got = (flat_launches, terrain_launches, deploy_launches)
    _log(f"phase 23 wall time {time.perf_counter() - t_phase:.1f} s | mega launches (flat, "
         f"terrain): flat steps {flat_launches}, terrain steps {terrain_launches}, deploy step "
         f"{deploy_launches} | {card}")
    if misses or got != want:
        raise AssertionError("phase 23: " + "; ".join(misses)
                             + f" | launches {got} (expected {want})")
    return {"flat": flat_launches[0], "terrain": terrain_launches[1],
            "deploy": deploy_launches[1]}


# ---- phase 24: the training iteration captured as one CUDA graph ----

CAPTURE_TASKS = ("humanoid_ppo", TERRAIN_TASK, JOINT_TASK, "humanoid_joint_deploy")
CAPTURE_ITERS = 3  # compared iterations a side, then as many timed replays
# eager iterations before the snapshot, so that the untrained robots fall
# and reset inside the compared window (and a terrain curriculum moves
# their levels there)
CAPTURE_WARM_ITERS = 2
# captured against eager: the same kernels on the same inputs and generator
# offsets, so bit-equal is expected; a difference up to this (relative to
# the tensor's largest magnitude) passes only with the tensor named
CAPTURE_REL_TOL = 1e-5


def _leaf_names(tree, prefix):
    """Names of tensor_leaves(tree), by field path."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return [n for f in dataclasses.fields(tree)
                for n in _leaf_names(getattr(tree, f.name), f"{prefix}.{f.name}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}[{i}]")]
    return [prefix]


def _captured_against_eager(task, dev, n_envs=N_ENVS, horizon=T_STEPS, iters=CAPTURE_ITERS,
                            group=None, curriculum=None, warm=0):
    """`task` at n_envs (global) envs, T = horizon, solver mega, on this
    rank of `group` (None: one process), the command curriculum forced to
    `curriculum` where given: after `warm` eager iterations from the
    reset, one snapshot (train state, env state, obs, every generator),
    then `iters` iterations of the eager `make_train_iter` from it, then
    `iters` of `CapturedTrainIter`, with the launch counters zeroed before
    each side; then `iters` more replays timed and one under
    torch.profiler. Returns the record: the env's kernel kind and robots,
    whether its terrain curriculum is on, the terrain levels that changed
    inside the eager window (summed over its iterations), the largest
    relative difference and the tensor it is in, the launches of each
    side, the capture seconds, the iteration ms (CUDA events and host
    clock) of each side, the replay's device busy ms, the profiler's count
    of hgt_mega_kernel in one replay, the peak memory of each side, and
    under a group the capture's cuts, the all-reduces of a timed replay and
    the digest of the final train state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.capture import (
        CapturedTrainIter,
        clone_tree,
        launch_counts,
        tensor_leaves,
        train_state_tensors,
    )
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
    from humanoid_gym_tpu_torch.parallel import rank_seed, replicate

    def overrides(c):
        _solver_mega(c)
        if curriculum is not None:
            c.commands.curriculum = curriculum

    env, cfg = registry.make_env(task, num_envs=n_envs, cfg_overrides=overrides, device=dev,
                                 seed=0, group=group)
    tcfg = registry.get_task(task).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0,
                                class_name=tcfg.runner.policy_class_name).to(dev)
    replicate(list(net.parameters()), group)
    pc = PPOConfig.from_cfg(tcfg.algorithm)
    pc.num_steps_per_env = horizon
    ts = init_train_state(net, pc.learning_rate, env.num_envs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank_seed(1, group))
    generators = [gen, *env.generators()]
    inputs = env.reset_all()
    eager_iter = make_train_iter(env, net, pc, n_envs, group)
    for _ in range(warm):
        _, *inputs, _ = eager_iter(ts, *inputs, gen)
    snap_inputs, snap_iteration = clone_tree(inputs), ts.iteration
    del inputs
    snap_ts = [t.detach().clone() for t in train_state_tensors(ts)]
    snap_gens = [g.get_state() for g in generators]
    names = ([f"param {k}" for k, _ in net.named_parameters()] + [f"mu {k}" for k in ts.opt_mu]
             + [f"nu {k}" for k in ts.opt_nu] + ["opt_count", "lr"]
             + [f"memory {i}" for i in range(len(ts.memory or ()))]
             + _leaf_names(snap_inputs, "(state, obs, priv)"))

    metric_names = []
    levels_moved = [0]

    def levels(inputs):
        state = inputs[0]
        return torch.cat([s.terrain_level for s in (state if isinstance(state, list) else [state])])

    def timed(train_iter, inputs, n):
        """n calls from inputs: (per-call outputs, event ms, host ms, inputs after)."""
        outs, ev_ms, host_ms = [], [], []
        levels_moved[0] = 0
        for _ in range(n):
            before = levels(inputs).clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            _, *inputs, metrics = train_iter(ts, *inputs, gen)
            ev[1].record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(ev[0].elapsed_time(ev[1]))
            metric_names[:] = [f"metric {k}" for k in sorted(metrics)]
            kept = train_state_tensors(ts) + tensor_leaves(inputs)
            outs.append([t.detach().clone() for t in kept] + [metrics[k] for k in sorted(metrics)])
            levels_moved[0] += int((levels(inputs) != before).sum())
        return outs, ev_ms, host_ms, inputs

    def side(train_iter):
        with torch.no_grad():
            for t, s in zip(train_state_tensors(ts), snap_ts):
                t.copy_(s)
        ts.iteration = snap_iteration
        for g, s in zip(generators, snap_gens):
            g.set_state(s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        res = timed(train_iter, clone_tree(snap_inputs), iters)
        launches = [a - b for a, b in zip(launch_counts(), before)]
        return res, launches, torch.cuda.max_memory_allocated() / 2**30

    (eager, e_ev, e_host, _), e_launch, e_peak = side(eager_iter)
    moved = levels_moved[0]
    captured = CapturedTrainIter(env, net, pc, n_envs, group)
    (got, c_ev, c_host, inputs), c_launch, c_peak = side(captured)
    names += metric_names
    worst, where = 0.0, None
    for i, (a_it, b_it) in enumerate(zip(got, eager)):
        for name, a, b in zip(names, a_it, b_it, strict=True):
            diff = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            rel = diff / max(float(b.double().abs().max()), 1e-30) if diff else 0.0
            if rel > worst:
                worst, where = rel, f"iteration {i + 1}, {name}"
    reduced = group.collectives if group is not None else 0
    _, r_ev, r_host, inputs = timed(captured, inputs, iters)
    reduced = (group.collectives - reduced) / iters if group is not None else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, *inputs, _ = captured(ts, *inputs, gen)
        torch.cuda.synchronize()
    by_class, n_kernels, _ = _device_time(prof)
    cuda = torch.autograd.DeviceType.CUDA
    in_trace = sum(e.count for e in prof.key_averages()
                   if e.device_type == cuda and "hgt_mega_kernel" in e.key)
    # the replay's kernels from the first one's start to the last one's end
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == cuda]
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3 if spans else None
    kind, robots = _env_kernels(env)
    rec = {"task": task, "envs": n_envs, "T": horizon, "kind": kind, "robots": robots,
           "curriculum": bool(cfg.terrain.curriculum) and kind == "terrain", "warm": warm,
           "levels_moved": moved, "worst_rel": worst, "where": where,
           "launches_eager": e_launch, "launches_replayed": c_launch,
           "capture_s": captured.capture_seconds, "eager_ms": e_ev, "eager_host_ms": e_host,
           "captured_ms": c_ev, "captured_host_ms": c_host, "replay_ms": r_ev,
           "replay_host_ms": r_host, "replay_busy_ms": sum(by_class.values()) / 1e3,
           "replay_span_ms": span_ms,
           "replay_busy_by_class_ms": {k: v / 1e3 for k, v in by_class.items()},
           "replay_kernels": n_kernels, "mega_in_trace": in_trace,
           "peak_gib_eager": e_peak, "peak_gib_captured": c_peak}
    if group is not None:
        rec.update(cuts=len(captured.graph.buffers), allreduces_per_replay=reduced,
                   train_digest=_digest(_train_state_tensors(ts)))
    captured.reset()
    del captured, got, eager, inputs
    torch.cuda.empty_cache()
    return rec


def _phase24_captured(card, dev):
    """Phase 24: the training iteration captured as one CUDA graph against
    the eager one, at 4096 envs and T = 60, for flat `humanoid_ppo` (B1),
    `humanoid_ppo_terrain_robust` (B1t), `humanoid_joint_ppo` (B1 twice a
    step, 2048 + 2048 envs) and the production recipe
    `humanoid_joint_deploy` (B1t twice a step, 2048 + 2048 envs on the
    deploy field, the survival curriculum): the snapshot taken after
    CAPTURE_WARM_ITERS eager iterations, then 3 iterations a side from it,
    bit-equal (a difference within CAPTURE_REL_TOL passes with its tensor
    named); the kernel kind the env runs launched T times a robot an
    iteration on each side, counted from the replays, none of the other,
    and named as often in one profiled replay where the profiler lists a
    graph's kernels; on a task with a terrain curriculum some levels must
    change inside the compared window (their count printed); capture
    seconds, eager and replayed iteration ms on CUDA events and on the
    host clock, the replay's device idle share, the peak memory with the
    graph's pool. Returns the records."""
    records = []
    for task in CAPTURE_TASKS:
        t0 = time.perf_counter()
        r = _captured_against_eager(task, dev, warm=CAPTURE_WARM_ITERS)
        # launch_counts(): flat, terrain, the three solvers, the terrain patches, the rewards
        own = 1 if r["kind"] == "terrain" else 0
        want = [0] * 7
        want[own] = r["robots"] * T_STEPS * CAPTURE_ITERS
        want[6] = want[own]
        if r["kind"] == "terrain":
            want[5] = want[own]
        per_iter = want[own] // CAPTURE_ITERS
        replay_ms = statistics.median(r["replay_host_ms"])
        span = r["replay_span_ms"]
        idle = "not measured (no kernel in the trace)" if not span else (
            f"idle share {1.0 - r['replay_busy_ms'] / span:.3f} of the {span:.1f} ms from its "
            f"first kernel's start to its last one's end; "
            f"{1.0 - r['replay_busy_ms'] / replay_ms:.3f} of the unprofiled replays' median "
            f"{replay_ms:.1f} ms")
        ms = lambda xs: ", ".join(f"{x:.1f}" for x in xs)  # noqa: E731
        levels = (f"terrain levels changed in the compared window {r['levels_moved']} (env x "
                  f"iteration, after {r['warm']} warm-up iterations)" if r["curriculum"]
                  else "no terrain curriculum")
        _log(f"phase 24 captured iteration: {task} {r['envs']} envs ({r['robots']} robot"
             f"{'s' if r['robots'] > 1 else ''}, {r['kind']} kernel) T={r['T']} solver mega | "
             f"{levels} | capture {r['capture_s']:.2f} s | eager ms {ms(r['eager_ms'])} (host "
             f"{ms(r['eager_host_ms'])}) | captured ms {ms(r['captured_ms'])} (host "
             f"{ms(r['captured_host_ms'])}; the first holds the capture) | replayed ms "
             f"{ms(r['replay_ms'])} (host {ms(r['replay_host_ms'])}) | one profiled replay: device "
             f"busy {r['replay_busy_ms']:.1f} ms over {r['replay_kernels']} kernels ("
             + ", ".join(f"{k} {v:.1f}" for k, v in r["replay_busy_by_class_ms"].items())
             + f" ms), {idle} | "
             f"launches an iteration eager {r['launches_eager'][own] / CAPTURE_ITERS:g}"
             f", replayed {r['launches_replayed'][own] / CAPTURE_ITERS:g} (= {per_iter}); "
             f"hgt_mega_kernel in one profiled replay {r['mega_in_trace']} | largest difference "
             f"{r['worst_rel']:.3g} relative"
             + (f" ({r['where']})" if r["where"] else " (bit-equal)")
             + f" | peak mem eager {r['peak_gib_eager']:.2f} GiB, captured "
             f"{r['peak_gib_captured']:.2f} GiB | {time.perf_counter() - t0:.1f} s | {card}")
        if r["launches_eager"] != want or r["launches_replayed"] != want:
            raise AssertionError(f"phase 24 {task}: launches eager {r['launches_eager']}, "
                                 f"replayed {r['launches_replayed']}, expected {want}")
        if r["curriculum"] and not r["levels_moved"]:
            raise AssertionError(f"phase 24 {task}: no terrain level changed in the compared "
                                 f"window")
        if r["mega_in_trace"] not in (0, per_iter):
            raise AssertionError(f"phase 24 {task}: the profiler names hgt_mega_kernel "
                                 f"{r['mega_in_trace']} times in one replay")
        if r["worst_rel"] > CAPTURE_REL_TOL:
            raise AssertionError(f"phase 24 {task}: captured against eager {r['worst_rel']:.3g} "
                                 f"relative at {r['where']}")
        records.append(r)
    return records


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
    """Phase 5b, after the main path's counters were read: one eager
    iteration stage by stage on CUDA events, then one eager iteration under
    torch.profiler for the device time by kernel class and the device's
    idle share over the staged iteration's time (phase 5's replayed mean,
    `mean_iter_ms`, is printed beside it). Returns the profiled iteration's
    device-busy ms (None if the profiler saw no kernel)."""
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
    return _profile_line(f"phase 5b profile (eager; phase 5 replayed {mean_iter_ms:.1f} ms an "
                         f"iteration)", prof, sum(stages), "staged eager iteration")


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
    """Phase 8 for one solver: XBot-L PPO at 4096 envs, T=CUT_T_STEPS, through
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
    tcfg.runner.num_steps_per_env = CUT_T_STEPS
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
        want = CUT_T_STEPS * dec * timed_iters
        if launches[own] != want or any(v for k, v in launches.items() if k != own):
            raise AssertionError(f"{solver}: launches {launches}, expected {own} = {want} only")
        last_ckpt = os.path.join(root, "timed", f"model_{1 + timed_iters}.ckpt")
        if not os.path.exists(last_ckpt):
            raise AssertionError(f"{solver}: no checkpoint {last_ckpt}")
        iter_ms = [ln["Perf/iter_time"] * 1e3 for ln in lines]
        mean_ms = wall_ms / timed_iters
        _log(f"phase 8 substep path: XBot-L {N_ENVS} envs T={CUT_T_STEPS} solver {solver} through "
             f"registry.make_env -> OnPolicyRunner.learn | warm-up {warm_s:.1f} s | "
             f"{timed_iters} iteration(s) in {wall_ms:.1f} ms (dispatch to dispatch: "
             f"{', '.join(f'{x:.1f}' for x in iter_ms)} ms) | "
             f"{CUT_T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | {own} launches "
             f"{launches[own]} (= {CUT_T_STEPS} x {dec} x {timed_iters}), mega launches "
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

        # where the time goes on this path: one env step under the profiler
        state, act = timed.env_state, torch.zeros((N_ENVS, cfg.env.num_actions), device=env.device)
        state, _ = env.step(state, act)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = env.step(state, act)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = env.step(state, act)
            torch.cuda.synchronize()
        _profile_line(f"phase 8 profile ({solver}, 1 env step = {dec} substeps, unprofiled "
                      f"env step {step_ms:.1f} ms)", prof, step_ms, "window")
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
# the all-reduces of a sharded flat iteration, each a cut of its capture:
# 2 for the advantage statistics, 2 epochs x 4 minibatches, 1 for the
# metrics; with the command curriculum on, one more a policy step
RANK_ALLREDUCES = 11
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
    variables. Roles: "train" (2 gloo ranks: warm-up with the capture, 2
    timed replayed iterations, the sharded update against one process, the
    captured iteration against the eager one, flat at T = 60 and with the
    command curriculum on at T = CUT_T_STEPS), "resume" (2 gloo ranks: load
    the final checkpoint's shards, one more iteration, captured anew) and
    "nccl" (1 rank, world size 1: one iteration). Every `learn` iteration
    must be a replay of the runner's capture. Writes its numbers to
    <work>/<role>_rank<r>.json."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.capture import CapturedTrainIter
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
        algo = tcfg.algorithm
        want_reduces = 0 if group.world == 1 else (
            2 + algo.num_learning_epochs * algo.num_mini_batches + 1)
        if group.world > 1 and want_reduces != RANK_ALLREDUCES:
            raise AssertionError(f"the recipe's iteration has {want_reduces} all-reduces")

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
            it = runner._train_iter
            if not isinstance(it, CapturedTrainIter) or it.graph is None:
                raise AssertionError(f"rank {group.rank}: learn ran no captured iteration")
            rec = {"wall_ms": (time.perf_counter() - t) * 1e3,
                   "iter_ms": runner.last_scalars["Perf/iter_time"] * 1e3,
                   "mega": MG.mega_kernel_launch.launches,
                   "other_launches": MG.mega_kernel_launch.terrain_launches
                   + sum(c.launches for c in counters[1:]),
                   "collectives": group.collectives - n0,
                   "cuts": len(it.graph.buffers), "capture_s": it.capture_seconds,
                   "scalars": {k: v for k, v in runner.last_scalars.items()
                               if not k.startswith("Perf/")}}
            for k in ("Loss/value_function", "Loss/surrogate", "Loss/entropy", "Loss/kl",
                      "Train/mean_step_reward"):
                if not np.isfinite(rec["scalars"][k]):
                    raise AssertionError(f"rank {group.rank}: non-finite {k}")
            if rec["mega"] != T_STEPS or rec["other_launches"]:
                raise AssertionError(f"rank {group.rank}: {rec['mega']} mega launches "
                                     f"(and {rec['other_launches']} others) in one iteration")
            if rec["collectives"] != want_reduces or rec["cuts"] != want_reduces:
                raise AssertionError(f"rank {group.rank}: {rec['collectives']} all-reduces and "
                                     f"{rec['cuts']} cuts in one iteration, not {want_reduces}")
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

            # the captured iteration against the eager one on the two ranks,
            # flat and with the command curriculum on (one cut more a step)
            del runner, env
            torch.cuda.empty_cache()
            for key, horizon, curriculum in (("captured", T_STEPS, None),
                                             ("curriculum", CUT_T_STEPS, True)):
                t = time.perf_counter()
                rec = _captured_against_eager("humanoid_ppo", group.device, horizon=horizon,
                                              group=group, curriculum=curriculum)
                rec["ranks_equal"] = _same_on_every_rank(rec.pop("train_digest"), group)
                rec["seconds"] = time.perf_counter() - t
                out[key] = rec
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
    -> OnPolicyRunner.learn, captured (graphs cut at each all-reduce); the
    captured iteration against the eager one on the two ranks, flat and
    with the command curriculum on; then 2 fresh ranks resuming from the
    shards beside 1 nccl rank at world size 1. Returns the launches per
    rank of the timed iterations."""
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
         f"OnPolicyRunner.learn, replays of its capture cut at each all-reduce "
         f"({train[0]['warmup']['cuts']} cuts; capture "
         f"{ms(t['warmup']['capture_s'] for t in train)} s) | env built in "
         f"{ms(t['env_build_s'] for t in train)} s, warm-up "
         f"{ms(t['warmup_s'] for t in train)} s | iteration ms per rank (learn(1) with its "
         f"checkpoint; dispatch to dispatch) {per_rank} | mega launches per rank per iteration "
         f"{[it['mega'] for t in its for it in t]} (from the replays) | all-reduces per iteration "
         f"{sorted(col)}, one per minibatch of {train[0]['allreduce_bytes']} bytes in "
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
    for horizon, key, reduces in ((T_STEPS, "captured", RANK_ALLREDUCES),
                                  (CUT_T_STEPS, "curriculum", RANK_ALLREDUCES + CUT_T_STEPS)):
        recs = [t[key] for t in train]
        # capture.LAUNCH_COUNTERS: the flat mega kernel and the rewards kernel
        want = [horizon * CAPTURE_ITERS, 0, 0, 0, 0, 0, horizon * CAPTURE_ITERS]
        worst = max(recs, key=lambda x: x["worst_rel"])
        _log(f"phase 13 captured vs eager: humanoid_ppo {N_ENVS} envs as {RANKS} gloo ranks x "
             f"{N_ENVS // RANKS}, T={horizon}, command curriculum "
             f"{'on' if key == 'curriculum' else 'off'}, {CAPTURE_ITERS} iterations a side from "
             f"one snapshot | capture s per rank {ms(x['capture_s'] for x in recs)} | iteration "
             f"ms per rank, eager (events) "
             + "; ".join(ms(x["eager_ms"]) for x in recs) + " | replayed (events) "
             + "; ".join(ms(x["replay_ms"]) for x in recs) + " (host "
             + "; ".join(ms(x["replay_host_ms"]) for x in recs) + ") | one profiled replay per "
             f"rank: device busy {ms(x['replay_busy_ms'] for x in recs)} ms | cuts "
             f"{[x['cuts'] for x in recs]}, all-reduces per replay "
             f"{[x['allreduces_per_replay'] for x in recs]} (= {reduces}) | mega launches a side "
             f"eager {[x['launches_eager'][0] for x in recs]}, replayed "
             f"{[x['launches_replayed'][0] for x in recs]} (= {horizon} x {CAPTURE_ITERS}) | "
             f"largest difference {worst['worst_rel']:.3g} relative"
             + (f" ({worst['where']})" if worst["where"] else " (bit-equal)")
             + f", ranks bit-equal {all(x['ranks_equal'] for x in recs)} | "
             f"{ms(x['seconds'] for x in recs)} s | {card}")
        for r, x in enumerate(recs):
            if x["launches_eager"] != want or x["launches_replayed"] != want:
                raise AssertionError(f"phase 13 {key}: rank {r} launches eager "
                                     f"{x['launches_eager']}, replayed {x['launches_replayed']}")
            if x["cuts"] != reduces or x["allreduces_per_replay"] != reduces:
                raise AssertionError(f"phase 13 {key}: rank {r} has {x['cuts']} cuts and "
                                     f"{x['allreduces_per_replay']} all-reduces a replay")
            if x["worst_rel"] > CAPTURE_REL_TOL or not x["ranks_equal"]:
                raise AssertionError(f"phase 13 {key}: rank {r} captured against eager "
                                     f"{x['worst_rel']:.3g} relative at {x['where']}, ranks "
                                     f"equal {x['ranks_equal']}")
    _log(f"phase 13 resume: {RANKS} fresh gloo ranks read model_{final}.ckpt.envshard0-"
         f"{RANKS - 1}: env state, obs and train state equal the saved ones, iteration "
         f"{final} ok, replayed from a capture of the restored shards "
         f"({res[0]['iterations'][0]['wall_ms']:.1f} ms); nccl at world size 1: "
         f"all-reduce and broadcast on the card, one iteration of {N_ENVS} envs in "
         f"{one['iterations'][0]['wall_ms']:.1f} ms with {one['iterations'][0]['mega']} mega "
         f"launches | {second_s:.1f} s | {card}")
    return [[it["mega"] for it in t] for t in its]


# ---- phase 25: the card's own tests ----

CARD_TESTS = "tests/test_torch_cuda.py"
CARD_TESTS_TIMEOUT_S = 600
# cases of CARD_TESTS that skip on the card by their own condition -> why
CARD_TESTS_SKIPS = {}


def _card_test_counts(xml_path):
    """(collected, passed, names of the skipped cases, names of the failed
    ones) from pytest's JUnit XML; no report counts as nothing collected."""
    import xml.etree.ElementTree as ET

    if not os.path.exists(xml_path):
        return 0, 0, [], []
    cases = list(ET.parse(xml_path).getroot().iter("testcase"))
    skipped = [c.get("name") for c in cases if c.find("skipped") is not None]
    failed = [c.get("name") for c in cases
              if c.find("failure") is not None or c.find("error") is not None]
    return len(cases), len(cases) - len(skipped) - len(failed), skipped, failed


def _phase25_card_tests(card):
    """Phase 25: tests/test_torch_cuda.py in its own pytest process on the
    card, the kernels' edge cases (n = 1, 37, 1621; no active contact row;
    every limit row inactive; rejected operands and constants), the env
    step, the captured entry and the captured iteration: exit 0, and every
    collected case passed but those CARD_TESTS_SKIPS names. A failure or a
    timeout raises. Returns (passed, collected)."""
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = os.path.join(tmp, "card_tests.xml")
        cmd = [sys.executable, "-m", "pytest", CARD_TESTS, "-q", "--noconftest",
               "-p", "no:cacheprovider", f"--junitxml={xml_path}"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=CARD_TESTS_TIMEOUT_S,
                             cwd=HERE)
        seconds = time.perf_counter() - t0
        collected, passed, skipped, failed = _card_test_counts(xml_path)
    _log(f"phase 25 card tests: {CARD_TESTS} {passed} passed of {collected} collected, "
         f"{len(skipped)} skipped {skipped}, {len(failed)} failed {failed} | {seconds:.1f} s in "
         f"its own process | {card}")
    if (run.returncode != 0 or not collected or passed + len(skipped) != collected
            or not set(skipped) <= set(CARD_TESTS_SKIPS)):
        raise AssertionError(f"phase 25: {' '.join(cmd[1:])} exited {run.returncode}, "
                             f"{passed} passed of {collected}, skipped {skipped}, failed "
                             f"{failed}:\n{run.stdout[-6000:]}\n{run.stderr[-3000:]}")
    return passed, collected


class _Laps:
    """Each phase's wall seconds on the host clock: `lap(name)` closes the
    phase that ran since the previous lap (or since the start)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 3)
        self.last = now

    def line(self) -> str:
        total = round(time.perf_counter() - self.start, 3)
        return json.dumps({"phase_seconds": {**self.seconds, "total": total}})


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
    if sys.argv[1:2] == ["--curve"]:
        # a training run's curve from its metrics.jsonl (or its gzip), on any host
        lines = _read_metrics(sys.argv[2])
        print(_curve_line(lines, int(sys.argv[3]) if len(sys.argv) > 3 else 1), flush=True)
        return 0
    if sys.argv[1:2] == ["--probe-table"]:
        # a probe.jsonl as a markdown table, on any host
        with open(sys.argv[2]) as f:
            print(_probe_table([json.loads(ln) for ln in f]), flush=True)
        return 0
    if sys.argv[1:2] == ["--compare"]:
        # two runs' metrics line by line, on any host
        print(_compare_runs(_read_metrics(sys.argv[2]), _read_metrics(sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--phase13-rank"]:
        return _phase13_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--train"]:
        return _diagnostic_train(*_train_argv(sys.argv[2:]))
    if sys.argv[1:2] == ["--nonfinite"]:
        return _diagnostic_nonfinite(sys.argv[2], int(sys.argv[3]), *sys.argv[4:5])
    if sys.argv[1:2] == ["--roll"]:
        return _diagnostic_roll(sys.argv[2], int(sys.argv[3]), [int(s) for s in sys.argv[4:]])

    import numpy as np

    from humanoid_gym_tpu_torch.algo.capture import CapturedTrainIter
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.physics import mega as MG, solve as SV
    from humanoid_gym_tpu_torch.physics.cuda_build import kernel_library

    dev = torch.device("cuda")
    laps = _Laps()
    card = _phase12_card_and_build()
    laps.lap("1-2")

    c = _setup(dev)
    cfg = c.cfg
    records = {}
    st1, tgt0, ops_in = _phase3_solve(c, records)
    laps.lap("3")
    _phase4_mega(c, records)
    laps.lap("4")
    landed_l = _phase4t_mega_terrain(c, records)
    laps.lap("4t")
    _phase4r_rewards(c, records, kernel_library().log)
    laps.lap("4r")
    extra = {}  # phase 10's results for the B1 and B1t rows
    _phase10_two_models(c, _setup(dev, robot="S"), extra)
    laps.lap("10")
    _phase10t_two_models_terrain(c, landed_l, extra)
    laps.lap("10t")
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
    train_iter = CapturedTrainIter(env, net, pcfg, N_ENVS)
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
    _log(f"phase 5 main path: XBot-L {N_ENVS} envs T={T_STEPS} solver mega, one CUDA graph an "
         f"iteration | warm-up {warm_s:.1f} s (capture {train_iter.capture_seconds:.1f} s) | "
         f"replayed iter ms {', '.join(f'{x:.1f}' for x in iter_ms)} | "
         f"{T_STEPS * N_ENVS / (mean_ms / 1e3):.1f} env steps/s | mega launches {launches['mega']} "
         f"(= {T_STEPS} x {TIMED_ITERS}) | value_loss {float(last['value_loss']):.4g} "
         f"surrogate {float(last['surrogate_loss']):.4g} mean_step_reward "
         f"{float(last['mean_step_reward']):.4g} | peak mem "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    laps.lap("5")

    busy5_ms = _where_the_time_goes(env, net, pcfg, ts, state, obs, priv, gen, mean_ms)
    del env, net, ts, state, obs, priv, train_iter
    laps.lap("5b")
    _phase5c_profile_dir(card, dev)
    laps.lap("5c")

    _phase6_apgd(c, st1, tgt0, records)
    laps.lap("6")
    _phase7_fused_dense(c, st1, tgt0, ops_in, records)
    laps.lap("7")

    # ---- phase 8: the substep path through the entry points ----
    os.environ["HGT_WANDB"] = "0"
    launches_fused = _substep_path("fused_pallas", timed_iters=1, resume=True, card=card)
    launches_apgd = _substep_path("apgd_pallas", timed_iters=1, resume=False, card=card)
    laps.lap("8")

    # ---- phase 9: the terrain path through the entry points ----
    launches_terrain = _phase9_terrain_path(card)
    laps.lap("9")

    # ---- phase 11: joint XBot-L + XBot-S training through the entry points ----
    launches_joint = _joint_path("humanoid_joint_ppo", card, dev)
    launches_joint_deploy = _joint_path("humanoid_joint_deploy", card, dev)
    laps.lap("11")

    # ---- phase 12: the repo's trained policies through the kernel ----
    _phase12_trained_policies(card, dev)
    laps.lap("12")

    # ---- phase 13: env-sharded training, two ranks on the card ----
    launches_ranks = _phase13_ranks(card)
    laps.lap("13")

    # ---- phase 14: play on the card ----
    launches_play = _phase14_play(card, dev)
    laps.lap("14")

    # ---- phase 15: the learning-curve band on the card ----
    launches_band = _phase15_learning_band(card, dev)
    laps.lap("15")

    # ---- phases 16-19: the measurement tools on the card ----
    _phase16_learn_profile(card, dev, busy5_ms)
    laps.lap("16")
    _phase17_config4(card)
    laps.lap("17")
    _phase18_sass_census(card)
    laps.lap("18")
    _phase19_roofline_and_example(card, dev, mean_ms)
    laps.lap("19")

    # ---- phase 20: the env step with no host synchronisation, captured ----
    launches_graph = _phase20_capture(card, dev)
    laps.lap("20")

    # ---- phase 21: bench_torch.py on the card ----
    launches_bench = _phase21_bench(card)
    laps.lap("21")

    # ---- phase 22: the flat recipe trained from scratch on the card ----
    _phase22_train_from_scratch(card, dev)
    laps.lap("22")

    # ---- phase 22j: the production joint recipe through the training process ----
    _phase22j_joint_train(card, dev)
    laps.lap("22j")

    # ---- phase 23: the random draw sites held to their laws on the card ----
    _phase23_laws(card, dev)
    laps.lap("23")

    # ---- phase 24: the training iteration as one CUDA graph against eager ----
    _phase24_captured(card, dev)
    laps.lap("24")

    # ---- phase 25: the card's own tests ----
    _phase25_card_tests(card)
    laps.lap("25")

    print(laps.line(), flush=True)
    kernels = [
        dict(name="hgt_mega_kernel (whole policy step of physics)", route="cuda",
             source="humanoid_gym_tpu_torch/csrc/mega.cu",
             replaces="humanoid_gym_tpu/physics/mega_kernel.py:550",
             launches=launches["mega"], joint_launches=launches_joint["mega"],
             two_rank_launches=launches_ranks, play_launches=launches_play,
             band_launches=launches_band, sync_free_step_launches=launches_graph["sync_free"],
             graph_capture_launches=launches_graph["capture"],
             bench_launches=launches_bench["flat, pipelined"], library_ms=None,
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
             joint_deploy_launches=launches_joint_deploy["mega_terrain"],
             bench_launches=launches_bench["terrain"], library_ms=None,
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
