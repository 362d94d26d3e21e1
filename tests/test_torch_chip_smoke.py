"""chip_smoke.py's parts that need no card: its refusal to run without one,
the operation counts behind the kernels' bounds, and the keys of the
per-kernel records."""

import ast
import importlib.util
import inspect
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [(), ("--kernels-only",)], ids=["all-phases", "kernels-only"])
def test_without_a_card_exits_nonzero_and_prints_no_result(args):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = subprocess.run([sys.executable, SCRIPT, *args], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode not in (0, None)
    assert run.stdout.strip() == ""
    assert "CUDA card" in run.stderr


def test_operation_counts_behind_the_bounds(smoke):
    """The bounds count the function's work, not the kernels' loop nests:
    linear in substeps and iterations, the executed counts never below
    them, and the figures the kernel table quotes for 10 substeps of 8
    iterations."""
    per_iter = smoke.solve_ops(9) - smoke.solve_ops(8)
    assert per_iter > 0 and smoke.solve_ops(8) - smoke.solve_ops(0) == 8 * per_iter
    per_sub = smoke.mega_ops(2, 8) - smoke.mega_ops(1, 8)
    assert smoke.mega_ops(10, 8) == smoke.mega_ops(0, 8) + 10 * per_sub
    assert per_sub > smoke.solve_ops(8)
    assert 9.0e5 < smoke.mega_ops(10, 8) < 1.0e6
    assert smoke.solve_ops_executed(8) >= smoke.solve_ops(8)
    assert smoke.mega_ops_executed(10, 8) >= smoke.mega_ops(10, 8)
    assert smoke.fused_dense_ops(8) == 181554
    # executed: A in full (each lane two whole rows), the Gram matrix by its 171 pairs
    assert smoke.fused_dense_ops(8, executed=True) == 263787 - (18 * 18 - 171) * (2 * 60 + 1)
    t, by = smoke._bound_ms(4096 * 4 * 256, 4096 * smoke.mega_ops(10, 8))
    assert by == "operations" and abs(t - 0.05906) < 1e-4
    # the terrain variant: the flat launch's work plus the terrain work,
    # linear in substeps, a few percent more; still bound by operations
    extra = smoke.mega_terrain_ops(10, 8) - smoke.mega_ops(10, 8)
    assert 0.01 * smoke.mega_ops(10, 8) < extra < 0.05 * smoke.mega_ops(10, 8)
    per_sub_t = smoke.mega_terrain_ops(2, 8) - smoke.mega_terrain_ops(1, 8)
    assert smoke.mega_terrain_ops(10, 8) == smoke.mega_terrain_ops(0, 8) + 10 * per_sub_t
    t, by = smoke._bound_ms(4096 * 4 * (120 + 208 + 136), 4096 * smoke.mega_terrain_ops(10, 8))
    assert by == "operations" and t > 0.05906


def test_kernel_records_hold_only_measured_keys_and_the_bound():
    """Every `records[...] = dict(...)` of the script carries the contract's
    keys and no other: what the run measured, plus `bound_ms` / `bound_by`."""
    allowed = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"}
    tree = ast.parse(open(SCRIPT).read(), filename=SCRIPT)
    found = 0
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "records"):
            continue
        call = node.value
        assert isinstance(call, ast.Call) and getattr(call.func, "id", None) == "dict"
        assert {k.arg for k in call.keywords} == allowed, ast.unparse(node.targets[0])
        found += 1
    assert found == 6


def test_dense_variant_patches_apply_to_the_shipped_source():
    """scripts/time_dense_variants_torch.py rebuilds the designs that were
    tried and dropped by replacing lines of csrc/dense_solve.cu: every
    replacement still applies, and each variant differs from the shipped
    source."""
    path = os.path.join(ROOT, "scripts", "time_dense_variants_torch.py")
    spec = importlib.util.spec_from_file_location("dense_variants_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sources = mod.patched_sources()
    shipped = open(os.path.join(mod.CSRC, "dense_solve.cu")).read()
    assert sources["shipped"] == shipped and len(sources) >= 8
    others = [src for name, src in sources.items() if name != "shipped"]
    assert all(src != shipped for src in others) and len(set(others)) == len(others)
    for header in mod.HEADERS:
        assert os.path.exists(os.path.join(mod.CSRC, header))


def test_kernels_line_has_the_terrain_variant():
    """The `kernels` line lists five kernels, the terrain variant among them
    with the TPU kernel it replaces, and its launches come from phase 9."""
    src = open(SCRIPT).read()
    assert src.count('route="cuda"') == 5
    assert 'replaces="humanoid_gym_tpu/physics/mega_kernel.py:560"' in src
    assert 'launches=launches_terrain["mega_terrain"]' in src
    assert "_phase4t_mega_terrain(c, records)" in src and "_phase9_terrain_path(card)" in src


def test_ptxas_summary_names_both_instantiations(smoke):
    """ptxas names the two instantiations of hgt_mega_kernel by their
    mangled template arguments; the summary tells them apart."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z15hgt_mega_kernelILb0EEvPKfS1_Pfiffiif9MgTerrain' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z15hgt_mega_kernelILb0EEv",
        "    112 bytes stack frame, 108 bytes spill stores, 108 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 416 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z15hgt_mega_kernelILb1EEvPKfS1_Pfiffiif9MgTerrain' "
        "for 'sm_90a'",
        "    200 bytes stack frame, 190 bytes spill stores, 190 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 416 bytes cmem[0]",
    ])
    out = smoke._ptxas_summary(log)
    assert "hgt_mega_kernel<false>: Used 64 registers" in out and "112 bytes stack" in out
    assert "hgt_mega_kernel<true>: Used 64 registers" in out and "200 bytes stack" in out


def test_phase13_is_wired_and_its_digests(smoke):
    """Phase 13 runs after phase 12, its ranks re-enter the script through
    `--phase13-rank`, and the B1 and B2 records carry its launches per rank;
    the digests it compares between ranks read every tensor of a saved
    state, in field order."""
    import torch

    src = open(SCRIPT).read()
    assert "launches_ranks = _phase13_ranks(card)" in src
    assert src.count("two_rank_launches=launches_ranks") == 2
    assert 'sys.argv[1:2] == ["--phase13-rank"]' in src
    saved = {"phys": {"qpos": torch.ones(2, 3)}, "commands": torch.zeros(2, 4)}
    assert [tuple(t.shape) for t in smoke._state_tensors(saved)] == [(2, 3), (2, 4)]
    one = smoke._digest(smoke._state_tensors(saved))
    assert one == smoke._digest([torch.ones(2, 3), torch.zeros(2, 4)])
    assert one != smoke._digest([torch.ones(2, 3), torch.ones(2, 4)])


def test_phase13_holds_the_captured_iteration(smoke):
    """Phase 13: every `learn` iteration of its ranks must be a
    replay with RANK_ALLREDUCES all-reduces and cuts (11: 2 advantage
    statistics, 2 epochs x 4 minibatches, 1 metrics), and the train role
    holds the captured iteration against the eager one on the two ranks
    through phase 24's comparison, flat at T = 60 and with the command
    curriculum at T = CUT_T_STEPS (T more cuts), bit-equal or within
    CAPTURE_REL_TOL, the ranks bit-equal."""
    src = open(SCRIPT).read()
    assert smoke.RANK_ALLREDUCES == 11 and smoke.CUT_T_STEPS == 10
    assert 'raise AssertionError(f"rank {group.rank}: learn ran no captured iteration")' in src
    assert 'if rec["collectives"] != want_reduces or rec["cuts"] != want_reduces:' in src
    assert 'for key, horizon, curriculum in (("captured", T_STEPS, None),' in src
    assert '("curriculum", CUT_T_STEPS, True)):' in src
    assert "group=group, curriculum=curriculum)" in src
    assert '(CUT_T_STEPS, "curriculum", RANK_ALLREDUCES + CUT_T_STEPS)' in src
    assert 'if x["cuts"] != reduces or x["allreduces_per_replay"] != reduces:' in src
    assert 'if x["worst_rel"] > CAPTURE_REL_TOL or not x["ranks_equal"]:' in src
    assert "captured = CapturedTrainIter(env, net, pc, n_envs, group)" in src


def test_phases_14_15_and_5c_are_wired(smoke):
    """Phase 5c runs after phase 5b, phases 14 and 15 after phase 13; the B1
    and B2 records carry their launches; phase 14's card-vs-CPU tolerances
    are four times phase 4's (20 steps against 5), and phase 15 reads the
    bands of tests/test_learning_regression.py through the package."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "_where_the_time_goes(env, net, pcfg, ts, state, obs, priv, gen, mean_ms)",
        "    _phase5c_profile_dir(card, dev)", "launches_ranks = _phase13_ranks(card)",
        "launches_play = _phase14_play(card, dev)",
        "launches_band = _phase15_learning_band(card, dev)", 'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert src.count("play_launches=launches_play") == 2
    assert src.count("band_launches=launches_band") == 2
    tols = smoke._mega_tols(0.001)
    scale = smoke.PLAY_CMP_STEPS / 5
    assert smoke.PLAY_TOLS["dof_pos"] == pytest.approx(scale * tols["qpos"])
    assert smoke.PLAY_TOLS["dof_vel"] == pytest.approx(scale * tols["qvel"])
    assert smoke.PLAY_TOLS["dof_torque"] == pytest.approx(scale * tols["tau"])
    assert smoke.PLAY_STEPS == 1200 and smoke.FK_ROWS_TOL == 2e-4
    assert "from humanoid_gym_tpu_torch.utils.learning_band import band_misses" in src


def test_phases_16_to_19_are_wired(smoke):
    """Phases 16-19 run after phase 15 and before the kernels line, each
    through the tool a user would run: learn_profile_torch in the process,
    config4_dryrun_torch in its own process at 16,384 envs and T=60, the
    SASS census of both mega instances, the roofline CLI at phase 5's
    measured iteration time and the example at 8 envs. Their gates are the
    contract's: 60 launches per full / rollout call, 120 terrain launches,
    equal instruction counts and 95% of them on a kernel line; full's
    device time is held against phase 5b's profiled iteration."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "launches_band = _phase15_learning_band(card, dev)",
        "    _phase16_learn_profile(card, dev, busy5_ms)", "    _phase17_config4(card)",
        "    _phase18_sass_census(card)", "    _phase19_roofline_and_example(card, dev, mean_ms)",
        'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert "LP.profile_stages(envs=N_ENVS, reps=LP_REPS, horizon=T_STEPS, device=dev)" in src
    assert "busy5_ms = _where_the_time_goes(" in src and smoke.BUSY_RATIO == (0.8, 1.25)
    assert 'BUSY_RATIO[0] <= dms["full"] / busy5_ms <= BUSY_RATIO[1]' in src
    assert '"config4_dryrun_torch.py"' in src and smoke.CONFIG4_ENVS == 16384
    assert '{"flat": 0, "terrain": 2 * T_STEPS}' in src
    assert "mega_census(opcodes=12, lines=20)" in src and smoke.MIN_ATTRIBUTED == 0.95
    assert 'RL.main(["--envs", str(N_ENVS), "--iter-ms", repr(iter_ms)])' in src
    assert "EX.main(num_envs=8, iterations=3, horizon=8, device=dev)" in src
    assert src.count('route="cuda"') == 5  # the kernels line is unchanged
    for n in (16, 17, 18, 19, 20):
        assert f"\n {n}. " in smoke.__doc__


def test_fk_rows_error_reads_the_out_fk_layout(smoke):
    """The phase-4 FK check on the CPU: the plain mega step's rows agree
    with fk / body_velocities, and a row off by 1e-3 shows as 1e-3."""
    import numpy as np
    import torch

    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model()
    kp = torch.tensor([200, 200, 350, 350, 15, 15] * 2, dtype=torch.float32)
    step = MG.make_mega_step_batched(model, 0.001, 10, kp, torch.full((12,), 10.0),
                                     model.dof_effort * 0.85, iterations=8)
    st, tgt = smoke._states(model, 3, seed=0, device="cpu")
    out = step(st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
               st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance,
               st.contact_lam, st.slope_bias, tgt)
    assert smoke._fk_rows_error(model, out) < 1e-5
    bumped = list(out)
    bumped[5] = out[5].clone()
    bumped[5][1, 7] += 1e-3
    assert np.isclose(smoke._fk_rows_error(model, bumped), 1e-3, atol=2e-5)


def test_profile_line_returns_the_busy_time(smoke):
    """Phase 5b's device-busy ms, which phase 16 holds full's device time
    against, is the sum of the profiled window's CUDA events; None when the
    window holds no CUDA event."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def prof(*events):
        evs = [types.SimpleNamespace(device_type=d, key=k, count=n, self_device_time_total=us)
               for d, k, n, us in events]
        return types.SimpleNamespace(key_averages=lambda: evs)

    busy = smoke._profile_line("t", prof((cuda, "hgt_mega_kernel<false>", 60, 32000.0),
                                         (cuda, "elementwise_kernel", 900, 1500.0),
                                         (cpu, "aten::add", 900, 0.0)), 900.0, "iteration")
    assert busy == pytest.approx(33.5)
    assert smoke._profile_line("t", prof((cpu, "aten::add", 3, 0.0)), 10.0, "iteration") is None


def test_phase22_is_wired(smoke):
    """Phase 22 runs after phase 21 and before the kernels line, which it
    leaves as it was: scripts/train_torch.py's `train` in a fresh process on
    the recipe's flags (4096 envs, 200 iterations, the config's seed, the
    default solver, HGT_WANDB=0) with its run directory under chiprun_out/,
    60 x 200 flat launches plus the reset step and no terrain launch (the
    expectation read from the env the registry builds); checkpoints 100
    and 200 exported and rolled as phase 12 (a), checkpoint 200 held to the
    walk demo's gate. Phase 20's sync-free steps take the joint env too.
    The training and the rolls live in `_train_and_roll`, which `--train`
    and phase 22j also run."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "launches_bench = _phase21_bench(card)", "    _phase22_train_from_scratch(card, dev)",
        'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert src.count('route="cuda"') == 5 and "train_launches" not in src
    assert (smoke.TRAIN_TASK, smoke.TRAIN_ITERS, smoke.N_ENVS) == ("humanoid_ppo", 200, 4096)
    assert smoke.WALK_GATE == (0.95, 0.8) and smoke.WALK_VX == 0.4
    assert os.path.relpath(smoke.TRAIN_ROOT, ROOT).split(os.sep)[0] == "chiprun_out"
    assert "from train_torch import train" in smoke.TRAIN_CHILD
    assert "train(get_args(sys.argv[1:]))" in smoke.TRAIN_CHILD
    assert ('card, dev, TRAIN_TASK, TRAIN_ITERS, None, TRAIN_ROOT, "phase 22", '
            'gate_at=TRAIN_ITERS)') in src
    assert '"--max_iterations", str(iters),' in src and '"--log_root", root]' in src
    assert '([] if seed is None else ["--seed", str(seed)])' in src
    assert 'env = dict(os.environ, HGT_WANDB="0")' in src
    assert "want, robots = _training_launches(task, iters)" in src and "launches == want" in src
    assert '"terrain" in task' not in src
    assert smoke._training_launches(smoke.TRAIN_TASK, smoke.TRAIN_ITERS) == (
        {"flat": 60 * 200 + 1, "terrain": 0}, 1)
    assert ("saved = {i for i in range(start, start + iters) if i % save == 0} | "
            "{start + iters}") in src
    assert "c % roll_every == 0 or c == saved[-1]" in src and smoke.ROLL_EVERY == 100
    assert "roll_every = ROLL_EVERY_LONG if iters > LONG_RUN else ROLL_EVERY" in src
    assert 'cases = [("L", TRAIN_TASK, WALK_VX)]' in src
    assert "survived, median = _roll_policy(task, npz, vx, terrain, dev)" in src  # phase 12
    assert "n != (401, 0)" in src and "survived >= WALK_GATE[0] and median >= WALK_GATE[1]" in src
    assert 'survived, median = rolled[TRAIN_ITERS]["L"][:2]' in src
    assert 'for task in ("humanoid_ppo", TERRAIN_TASK, JOINT_TASK):' in src
    assert smoke.JOINT_TASK == "humanoid_joint_ppo"
    assert "\n 22. the flat recipe trained from scratch" in smoke.__doc__
    assert "\n 26. one JSON line with each phase's wall seconds" in smoke.__doc__
    assert "one JSON line with a record per kernel" in " ".join(smoke.__doc__.split())


def test_phase23_is_wired(smoke):
    """Phase 23 runs after phase 22 and before the kernels line, which it
    leaves as it was; `--train` and `--roll` run the diagnostics and print
    no contract line."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "    _phase22_train_from_scratch(card, dev)", "    _phase23_laws(card, dev)",
        'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert src.count('route="cuda"') == 5
    assert "\n 23. the random draw sites" in smoke.__doc__
    assert 'sys.argv[1:2] == ["--train"]' in src and 'sys.argv[1:2] == ["--roll"]' in src
    for fn in (smoke._diagnostic_train, smoke._diagnostic_roll):
        assert '"ok"' not in inspect.getsource(fn)


def test_phase23_law_checks_are_the_random_path_tests(smoke):
    """Phase 23's copies of the law checks give what
    tests/test_torch_random_paths.py's give."""
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "random_paths_under_test", os.path.join(ROOT, "tests", "test_torch_random_paths.py"))
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)

    assert (smoke.LAW_ALPHA, smoke.LAW_KS_C) == (T.ALPHA, T.KS_C)
    assert smoke.LAW_Z == pytest.approx(T.Z, rel=1e-9)
    x = np.linspace(-0.5, 0.7, 97)
    box = ((-0.3, 0.6), (-0.3, 0.3))
    for a in (0, 1):
        np.testing.assert_array_equal(smoke._dead_zone_kept_cdf(box, 0.2, a)(x),
                                      T._dead_zone_kept_cdf(box, 0.2, a)(x))
    mine, theirs = smoke._delay_law(0.5, 0.02, 6), T._delay_law(0.5, 0.02, 6)
    np.testing.assert_array_equal(mine[0](x), theirs[0](x))
    assert mine[1:] == theirs[1:]
    support = np.arange(11)
    draws = np.random.default_rng(0).integers(0, 11, 500)
    cdf = lambda k: (k + 1) / 11  # noqa: E731
    assert smoke._ks_discrete(draws, support, cdf) == T._ks_discrete(draws, support, cdf)
    assert smoke._var_se(draws, 2.0, -1.2) == T._var_se(draws, 2.0, -1.2)


def test_phase23_rehearsal_on_the_cpu(smoke):
    """Phase 23 at 256 envs on the CPU through the plain mega step: every
    site within its limits, the deploy task's too, no launch counted (the
    plain version)."""
    assert smoke._phase23_laws("cpu card", "cpu", n_envs=256) == {"flat": 0, "terrain": 0,
                                                                  "deploy": 0}


def test_phase23_misses_a_wrong_law(smoke, monkeypatch):
    """A joint jitter of U(-0.2, 0.2) where the config says U(-0.1, 0.1)
    fails phase 23 at the initial and the reset pose, on the deploy field
    too, for both robots."""
    from humanoid_gym_tpu_torch.envs.env import HumanoidEnv

    real = HumanoidEnv._uniform

    def wide(self, shape, lo, hi):
        if isinstance(lo, float) and (lo, hi) == (-0.1, 0.1):  # the joint jitter
            lo, hi = -0.2, 0.2
        return real(self, shape, lo, hi)

    monkeypatch.setattr(HumanoidEnv, "_uniform", wide)
    with pytest.raises(AssertionError) as err:
        smoke._phase23_laws("cpu card", "cpu", n_envs=256)
    assert "initial joint pose: joint offset" in str(err.value)
    assert "reset pose and level: reset joint offset" in str(err.value)
    for robot in ("XBot-L", "XBot-S"):
        assert f"{robot} deploy level, origin and spawn: joint offset" in str(err.value)
        assert f"{robot} deploy re-entry and reset pose: reset joint offset" in str(err.value)


def test_phase24_is_wired(smoke):
    """Phase 24 runs after phase 23 and before the kernels line, which it
    leaves as it was: the captured iteration against the eager one for
    the flat, terrain and joint tasks and the production recipe
    `humanoid_joint_deploy` at 4096 envs and T = 60, 3 iterations a side
    after 2 warm-up iterations, a difference above 1e-5 relative failing
    the run, the launch counts T an iteration a robot of the env's kernel
    kind on both sides, and a window with no level change failing a task
    with a terrain curriculum. The main path of phase 5 replays the
    captured iteration."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "    _phase23_laws(card, dev)", "    _phase24_captured(card, dev)",
        'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert src.count('route="cuda"') == 5 and "captured_launches" not in src
    assert smoke.CAPTURE_TASKS == ("humanoid_ppo", "humanoid_ppo_terrain_robust",
                                   "humanoid_joint_ppo", "humanoid_joint_deploy")
    assert (smoke.CAPTURE_ITERS, smoke.CAPTURE_REL_TOL, smoke.N_ENVS, smoke.T_STEPS) == (
        3, 1e-5, 4096, 60)
    assert smoke.CAPTURE_WARM_ITERS == 2
    assert "r = _captured_against_eager(task, dev, warm=CAPTURE_WARM_ITERS)" in src
    assert 'want[own] = r["robots"] * T_STEPS * CAPTURE_ITERS' in src
    assert 'if r["curriculum"] and not r["levels_moved"]:' in src
    assert 'r["launches_eager"] != want or r["launches_replayed"] != want' in src
    assert 'if r["worst_rel"] > CAPTURE_REL_TOL:' in src
    assert "train_iter = CapturedTrainIter(env, net, pcfg, N_ENVS)" in src
    assert "\n 24. the training iteration captured as one CUDA graph" in smoke.__doc__


def test_phase24_names_every_compared_tensor(smoke):
    """The names phase 24 reports a difference under follow tensor_leaves'
    order over a joint env's list state."""
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.capture import tensor_leaves

    env, _ = registry.make_env("humanoid_joint_ppo", num_envs=2, device="cpu", seed=0)
    tree = env.reset_all()
    names = smoke._leaf_names(tree, "x")
    assert len(names) == len(tensor_leaves(tree)) == len(set(names))
    assert "x[0][0].phys.qpos" in names and "x[0][1].phys.qpos" in names
    assert names[-2:] == ["x[1]", "x[2]"]
    assert all(isinstance(t, torch.Tensor) for t in tensor_leaves(tree))


_LAUNCH_TASKS = {"humanoid_ppo": ("flat", 1), "humanoid_ppo_terrain_robust": ("terrain", 1),
                 "humanoid_joint_ppo": ("flat", 2), "humanoid_joint_deploy": ("terrain", 2)}


@pytest.mark.parametrize("task", list(_LAUNCH_TASKS))
def test_train_launches_match_the_env_the_registry_builds(smoke, task, monkeypatch):
    """`_training_launches` (what `_train_and_roll` expects of a training
    process) against the env the registry builds for the task: the mega
    step's plain version, counted by kind on the CPU, runs once a robot
    in the runner's reset (`reset_all`) and once a robot in each env step,
    so a process of `iters` iterations of T steps launches T x that x
    iters + the reset's of the one kind and none of the other."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG

    calls = {"flat": 0, "terrain": 0}
    real = MG.mega_step_plain

    def counted(*a, terrain=None, **k):
        calls["flat" if terrain is None else "terrain"] += 1
        return real(*a, terrain=terrain, **k)

    monkeypatch.setattr(MG, "mega_step_plain", counted)

    def ov(c):
        c.sim.solver.solver_type = "mega"
        c.sim.solver.solver_iterations = 2

    env, _ = registry.make_env(task, num_envs=2, cfg_overrides=ov, device="cpu", seed=0)
    state, _, _ = env.reset_all()
    reset = dict(calls)
    env.step(state, torch.zeros((2, env.num_actions)))
    step = {k: calls[k] - reset[k] for k in calls}
    kind, robots = _LAUNCH_TASKS[task]
    assert reset == step == {"flat": 0, "terrain": 0, kind: robots}
    t = registry.get_task(task).make_train_cfg().runner.num_steps_per_env
    assert t == 60
    want = {k: t * step[k] * 7 + reset[k] for k in calls}
    assert smoke._training_launches(task, 7) == (want, robots)


def test_phase22j_is_wired(smoke):
    """Phase 22j runs after phase 22 and before phase 23, leaving the
    kernels line as it was: `_train_and_roll` of humanoid_joint_deploy for
    10 iterations in a temporary directory (the rolls of XBot-L and XBot-S
    on its last checkpoint), then `_train_process` resumed from it for 2
    more; its wall time printed beside the prediction. `--train` rolls
    every 500th checkpoint of a run past 1000 iterations and keeps the
    last four checkpoints' nets and every 200th one's actor."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "    _phase22_train_from_scratch(card, dev)", "    _phase22j_joint_train(card, dev)",
        "    _phase23_laws(card, dev)", 'print(json.dumps({"kernels"')]
    assert order == sorted(order)
    assert src.count('route="cuda"') == 5
    assert (smoke.JOINT_TRAIN_TASK, smoke.JOINT_TRAIN_ITERS, smoke.JOINT_RESUME_ITERS) == (
        "humanoid_joint_deploy", 10, 2)
    assert smoke._training_launches(smoke.JOINT_TRAIN_TASK, smoke.JOINT_TRAIN_ITERS) == (
        {"flat": 0, "terrain": 2 * 60 * 10 + 2}, 2)
    body = inspect.getsource(smoke._phase22j_joint_train)
    assert "tempfile.TemporaryDirectory" in body and "resume=(run_dir, JOINT_TRAIN_ITERS)" in body
    assert 'rolled[JOINT_TRAIN_ITERS]) != ["L", "S"]' in body
    assert "JOINT_TRAIN_PREDICTED_S" in body
    roll = inspect.getsource(smoke._roll_checkpoint)
    assert 'cases.append(("S", "humanoid_s_ppo", WALK_VX * math.sqrt(SCALE)))' in roll
    assert '"--resume", "--load_run"' in inspect.getsource(smoke._train_process)
    assert "\n 22j. the production joint recipe" in smoke.__doc__
    assert (smoke.ROLL_EVERY, smoke.ROLL_EVERY_LONG, smoke.LONG_RUN) == (100, 500, 1000)
    saved = list(range(100, 3001, 100)) + [3001]
    nets, actors = smoke._kept_checkpoints(saved)
    assert nets == [2800, 2900, 3000, 3001] and actors == list(range(200, 2601, 200))
    assert smoke._kept_checkpoints([100, 200, 300]) == ([100, 200, 300], [])
    assert '"ok"' not in inspect.getsource(smoke._diagnostic_train)
    assert "_update_probe(os.path.join(run_dir, f\"model_{JOINT_TRAIN_ITERS}.ckpt\")" in body
    assert "_probe_problems(probe) + _fall_cut_problems(cut)" in body


def test_nonfinite_probe_records_an_injected_explosion(smoke, tmp_path, monkeypatch):
    """`_nonfinite_events` (the probe behind `--nonfinite`) on the CPU at
    4 envs: an XBot-S env whose physics step returns a non-finite velocity
    at the second policy step is one event of robot 1, with the physics
    inputs of every step before it (the reset step included) and the
    step's non-finite output; nothing else counts. `--nonfinite` prints no
    contract line."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg

    env, cfg = registry.make_env(smoke.NONFINITE_TASK, num_envs=4, device="cpu", seed=0)
    tcfg = registry.get_task(smoke.NONFINITE_TASK).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0)
    ckpt = str(tmp_path / "model_1.ckpt")
    torch.save({"train_state": {"net": net.state_dict()}}, ckpt)
    real_make, calls = registry.make_env, [0]

    def make(*a, **k):
        env, cfg = real_make(*a, **k)
        real = env.envs[1]._phys_step

        def exploding(phys, targets):
            out = real(phys, targets)
            calls[0] += 1
            if calls[0] == 3:  # the reset step, then policy steps 0 and 1
                out = out.replace(qvel=out.qvel.index_fill(0, torch.tensor([1]), float("nan")))
            return out

        env.envs[1]._phys_step = exploding
        return env, cfg

    monkeypatch.setattr(registry, "make_env", make)
    counts, events = smoke._nonfinite_events(ckpt, 3, "cpu", n_envs=4)
    assert dict(counts) == {(1, "state"): 1}
    (ev,) = events
    assert (ev["robot"], ev["kind"], ev["step"], ev["env"]) == (1, "state", 1, 1)
    assert len(ev["inputs"]) == 3 and ev["inputs"][-1][1].shape == (12,)
    assert set(ev["inputs"][0][0]) >= {"qpos", "qvel", "contact_lam", "slope_bias"}
    assert not torch.isfinite(ev["out"]["qvel"]).all()
    assert 'sys.argv[1:2] == ["--nonfinite"]' in open(SCRIPT).read()
    assert '"ok"' not in inspect.getsource(smoke._diagnostic_nonfinite)


def test_curve_line_reads_the_committed_production_run(smoke):
    """`--curve` (`_curve_line`) on the committed metrics of the port's
    3001-iteration `humanoid_joint_deploy` run (seed 5): the curve every
    250 iterations, the non-finite resets and the one iteration whose
    step reward was non-finite, as docs/standings_torch/RESULTS.md quotes
    them; it runs without a card."""
    path = os.path.join(ROOT, "docs", "standings_torch", "joint_deploy_s5_metrics.jsonl")
    run = subprocess.run([sys.executable, SCRIPT, "--curve", path, "2"], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    line = run.stdout.strip()
    assert line.count("iteration ") >= 14 and "iteration 3001: mean_reward" in line
    assert "non-finite resets 84 in 82 iterations (first [376])" in line
    assert "iterations with a non-finite loss or step reward [2954]" in line


def test_curve_line_reads_a_gzipped_run(smoke):
    """`--curve` reads a gzipped metrics file: the seed-5 rerun on the
    repaired streams, committed as `joint_deploy_s5_rerun_metrics.jsonl.gz`,
    gives its 3001 iterations, its non-finite resets and no non-finite
    step reward, as docs/standings_torch/RESULTS.md quotes them."""
    path = os.path.join(ROOT, "docs", "standings_torch", "joint_deploy_s5_rerun_metrics.jsonl.gz")
    run = subprocess.run([sys.executable, SCRIPT, "--curve", path, "2"], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    line = run.stdout.strip()
    assert line.count("iteration ") >= 14 and "iteration 3001: mean_reward 77.06" in line
    assert "non-finite resets 52 in 51 iterations (first [570])" in line
    assert "iterations with a non-finite loss or step reward []" in line


def test_train_argv_takes_probe_checkpoints(smoke):
    """`--train TASK ITERS SEED [--probe C1,C2,...]`: the probed
    checkpoints sorted; anything else after the seed refused. `--train`
    prints no contract line."""
    assert smoke._at_lr_floor(1e-5) and smoke._at_lr_floor(1.0000001e-5)
    assert not smoke._at_lr_floor(1.5e-5)
    assert smoke._train_argv(["humanoid_joint_deploy", "3001", "7"]) == (
        "humanoid_joint_deploy", 3001, 7, ())
    assert smoke._train_argv(["humanoid_joint_deploy", "3001", "7", "--probe",
                              "2800,1500,2400,2000"]) == (
        "humanoid_joint_deploy", 3001, 7, (1500, 2000, 2400, 2800))
    for bad in (["t", "1", "2", "--probe"], ["t", "1", "2", "--curve", "5"]):
        with pytest.raises(SystemExit):
            smoke._train_argv(bad)
    src = open(SCRIPT).read()
    assert "return _diagnostic_train(*_train_argv(sys.argv[2:]))" in src
    assert "full_ckpts=probe" in inspect.getsource(smoke._diagnostic_train)
    assert '"ok"' not in inspect.getsource(smoke._diagnostic_train)


def test_train_child_saves_the_probed_checkpoints_whole(smoke, tmp_path):
    """The training child (`TRAIN_CHILD`, scripts/train_torch.py's
    `train`) on the CPU, humanoid_ppo at 2 envs for 1 iteration with
    HGT_FULL_CKPTS=0: checkpoint 0, which the runner saves without the
    env state, carries it and the obs, as the last one does."""
    env = dict(os.environ, HGT_WANDB="0", HGT_FULL_CKPTS="0", OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-c", smoke.TRAIN_CHILD, "--task", "humanoid_ppo", "--num_envs", "2",
         "--max_iterations", "1", "--log_root", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    (run_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    for ck in ("model_0.ckpt", "model_1.ckpt"):
        payload = torch.load(run_dir / ck, map_location="cpu", weights_only=True)
        assert {"env_state", "obs", "priv_obs"} <= set(payload), ck
        assert payload["obs"].shape[0] == 2
    assert 'env["HGT_FULL_CKPTS"] = ",".join(map(str, full_ckpts))' in inspect.getsource(
        smoke._train_process)


@pytest.fixture(scope="module")
def probed(smoke, tmp_path_factory):
    """`_update_probe` on the CPU: a humanoid_joint_deploy runner at 4 envs
    (T cut to 2) trained 1 iteration and saved with its env state, probed
    with its cut written; the checkpoint without the env state, and the
    one with it."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner

    task, d = "humanoid_joint_deploy", tmp_path_factory.mktemp("probe")

    def apgd(c):
        c.sim.solver.solver_type = "apgd"

    env, _ = registry.make_env(task, num_envs=4, cfg_overrides=apgd, device="cpu", seed=7)
    tcfg = registry.get_task(task).make_train_cfg()
    tcfg.runner.num_steps_per_env = 2
    runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=7)
    runner.learn(1)
    full, bare = str(d / "model_1.ckpt"), str(d / "model_bare.ckpt")
    runner.save(full, include_env_state=True)
    runner.save(bare)
    run_lines = [{"iter": 1, "Loss/value_function": 0.5}, {"iter": 2}]
    line = smoke._update_probe(full, task, 7, "cpu", n_envs=4, horizon=2, run_lines=run_lines,
                               cut=str(d / "cut.npz"))
    return line, str(d / "cut.npz"), bare, full


def test_update_probe_line_on_the_cpu(smoke, probed):
    """The probe's line at 4 envs: complete and finite (`_probe_problems`,
    the check phase 22j makes on the card), one reading a minibatch of
    the recipe's 2 x 4, the groups' norms adding up to the global norm that
    `minibatch_update` clipped, the clip scale and the floor flag read
    from it, the run's line of the iteration after the checkpoint; a
    checkpoint without the env state is refused; another fork draws
    another rollout; `--probe-table` (`_probe_table`) makes one row of the
    line."""
    line, _, bare, full = probed
    assert smoke._probe_problems(line) == []
    assert (line["iteration"], line["envs"], line["horizon"]) == (1, 4, 2)
    assert [(mb["epoch"], mb["minibatch"]) for mb in line["minibatches"]] == [
        (e, i) for e in range(2) for i in range(4)]
    for mb in line["minibatches"]:
        groups = mb["grad_norm"]
        assert sorted(groups) == ["actor", "critic", "estimator"]
        assert abs(math.hypot(*groups.values()) - mb["global_norm"]) <= 1e-4 * mb["global_norm"]
        assert abs(sum(mb["grad_share"].values()) - 1.0) < 1e-9
        assert mb["clip_scale"] == min(1.0, 1.0 / (mb["global_norm"] + 1e-12))
        assert mb["lr_at_floor"] == (mb["lr"] <= 1.00001e-5)
    assert line["run_line"]["Loss/value_function"] == 0.5
    ro = line["rollout"]
    assert ro["nonfinite_resets"] == 0 and ro["blown_events"] == []
    assert ro["max_abs_advantage_normalized"] > 0 and ro["max_abs_return"] > 0
    broken = dict(line, rollout={k: v for k, v in ro.items() if k != "max_abs_return"})
    broken["minibatches"] = [dict(line["minibatches"][0], kl=float("nan"))]
    problems = smoke._probe_problems(broken)
    assert "rollout.max_abs_return" in problems and "line.minibatches[0].kl = nan" in problems
    with pytest.raises(ValueError, match="env state"):
        smoke._update_probe(bare, "humanoid_joint_deploy", 7, "cpu", n_envs=4, horizon=2)
    other = smoke._update_probe(full, "humanoid_joint_deploy", 7, "cpu", n_envs=4, horizon=2,
                                fork=1)
    assert other["rollout"]["mean_step_reward"] != ro["mean_step_reward"]
    assert "_probe_table([line])" in inspect.getsource(smoke._probe_run)
    table = smoke._probe_table([line]).splitlines()
    assert len(table) == 3 and table[1] == "|" + "---|" * 11
    assert table[2].startswith("| 1 | ") and table[2].count("|") == 12
    assert f"| {line['means']['kl']:.3g} |" in table[2] and "| 0 | 0 (0); 0 / 0 |" in table[2]


def test_fall_cut_on_the_cpu(smoke, probed):
    """The probe's cut of its iteration at 4 envs: whole
    (`_fall_cut_problems`), every env of the rollout kept (fewer than
    FALL_CUT_ENVS), the minibatch rows covering the cut once, the
    normalised advantages the raw ones over the batch's mean and std, the
    net beside them."""
    import numpy as np

    _, cut, _, _ = probed
    assert smoke._fall_cut_problems(cut) == []
    z = np.load(cut)
    assert sorted(z["envs"]) == [0, 1, 2, 3] and list(z["robot"][np.argsort(z["envs"])]) == [
        0, 0, 1, 1]
    assert sorted(z["mb_rows"]) == list(range(4 * 2))
    assert np.allclose((z["card_adv"] - z["card_adv_mean"]) / (z["card_adv_std"] + 1e-8),
                       z["card_adv_normalized"], atol=1e-5)
    assert z["net/actor.layers.0.weight"].shape == (512, 705) and "net/estimator.layers.0.bias" in z
    assert not any(k.startswith(("opt_mu", "opt_nu")) for k in z.files)
    broken = str(cut).replace(".npz", "_broken.npz")
    np.savez(broken, **{k: z[k] for k in z.files if k != "card_ret"})
    assert smoke._fall_cut_problems(broken) == ["card_ret"]


def test_blow_up_trace_takes_the_latest_chained_window(smoke):
    """`_blow_up_trace` on a made-up event of 14 steps: the base's angular
    velocity after each step 5 rad/s up to step 5, then 20, 40, 80, 120
    with contact impulses until step 8 and none after, the last step
    non-finite. The latest window of TRACE_STEPS steps that starts below
    TRACE_SPIN[0], passes TRACE_SPIN[1], ends with no contact and stays
    finite starts at step 5; with a push between steps 6 and 7 (the next
    input not the last output) no window is left."""
    spin = [5.0] * 6 + [20.0, 40.0, 80.0, 120.0, 150.0, 180.0, 200.0, float("nan")]

    def event(push_at=None):
        ins, outs = [], []
        for k, w in enumerate(spin):
            qvel = torch.zeros(18)
            qvel[4] = w
            out = {"qpos": torch.full((19,), float(k + 1)), "qvel": qvel,
                   "contact_lam": torch.full((60,), 1.0 if k < 9 else 0.0)}
            prev = outs[-1] if outs else {"qpos": torch.zeros(19), "qvel": torch.zeros(18)}
            rows = {"qpos": prev["qpos"].clone(), "qvel": prev["qvel"].clone(),
                    "contact_lam": torch.zeros(60), "slope_bias": torch.zeros(2)}
            if k == push_at:
                rows["qvel"] = rows["qvel"] + 1.0
            ins.append((rows, torch.full((12,), float(k))))
            outs.append(out)
        return {"robot": 1, "inputs": ins, "returned": outs}

    assert smoke.TRACE_STEPS == 8 and smoke.TRACE_SPIN == (9.0, 66.0)
    trace = smoke._blow_up_trace(event())
    assert trace["targets"][:, 0].tolist() == list(range(5, 13))
    assert trace["card_qvel"][:, 4].tolist() == spin[5:13]
    assert float(trace["state_qpos"][0]) == 5.0 and int(trace["robot"]) == 1
    assert set(trace) == {"state_qpos", "state_qvel", "state_contact_lam", "state_slope_bias",
                          "targets", "card_qvel", "robot"}
    assert smoke._blow_up_trace(event(push_at=7)) is None


def test_compare_runs_finds_the_first_difference(smoke):
    """`--compare` (`_compare_runs`) on the committed seed-7 rerun: against
    itself identical through its 3001 iterations, times aside; with one
    value moved at iteration 2000, that iteration and key first; against
    the earlier seed-7 run, `joint_deploy_s7_metrics.jsonl`, trained on
    other random streams, different from the first iteration. It runs
    without a card."""
    path = os.path.join(ROOT, "docs", "standings_torch", "joint_deploy_s7_rerun_metrics.jsonl.gz")
    lines = smoke._read_metrics(path)
    assert smoke._compare_runs(lines, lines) == (
        "identical through 3001 iterations (times Perf/ not compared)")
    moved = [dict(ln) for ln in lines]
    moved[1999]["Loss/kl"] *= 1.5
    moved[2500]["Perf/iter_time"] += 1.0
    got = smoke._compare_runs(lines, moved)
    assert got.startswith("first difference at iteration 2000, key Loss/kl: ")
    assert got.endswith("; 1 of 3001 iterations differ")
    old = os.path.join(ROOT, "docs", "standings_torch", "joint_deploy_s7_metrics.jsonl")
    run = subprocess.run([sys.executable, SCRIPT, "--compare", old, path], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("first difference at iteration 1, key ")


PHASES = ("1-2", "3", "4", "4t", "4r", "10", "10t", "5", "5b", "5c", "6", "7", "8", "9", "11",
          "12", "13", "14", "15", "16", "17", "18", "19", "20", "21", "22", "22j", "23", "24", "25")


def test_phase25_and_phase_seconds_are_wired(smoke):
    """Phase 25 runs the card's own tests after phase 24; the phase_seconds
    line, with a lap for every phase in the order they run, comes after it
    and before the kernels line and the contract line; no `except` in the
    phase swallows a failure."""
    src = open(SCRIPT).read()
    order = [src.index(s) for s in (
        "    _phase24_captured(card, dev)", "    _phase25_card_tests(card)",
        "    print(laps.line(), flush=True)", 'print(json.dumps({"kernels"',
        'print(json.dumps({"ok": True')]
    assert order == sorted(order)
    assert src.count('route="cuda"') == 5
    assert smoke.CARD_TESTS == "tests/test_torch_cuda.py" and smoke.CARD_TESTS_SKIPS == {}
    assert smoke.CARD_TESTS_TIMEOUT_S == 600
    body = inspect.getsource(smoke._phase25_card_tests)
    assert '[sys.executable, "-m", "pytest", CARD_TESTS, "-q", "--noconftest",' in body
    assert '"-p", "no:cacheprovider"' in body and "timeout=CARD_TESTS_TIMEOUT_S" in body
    assert "passed + len(skipped) != collected" in body
    for fn in (smoke._phase25_card_tests, smoke._card_test_counts):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    main = inspect.getsource(smoke.main)
    assert list(PHASES) == re.findall(r'laps\.lap\("([0-9a-z-]+)"\)', main)
    assert "\n 25. the card's own tests" in smoke.__doc__


def test_phase_seconds_line_holds_every_lap_and_the_total(smoke, monkeypatch):
    clock = iter([10.0, 12.5, 13.0, 20.25, 21.0])
    monkeypatch.setattr(smoke.time, "perf_counter", lambda: next(clock))
    laps = smoke._Laps()
    laps.lap("1-2")
    laps.lap("3")
    laps.lap("4")
    line = json.loads(laps.line())
    assert line == {"phase_seconds": {"1-2": 2.5, "3": 0.5, "4": 7.25, "total": 11.0}}


def _junit(cases):
    """A JUnit report in pytest's layout; each case is (name, outcome)."""
    tag = {"skipped": '<skipped message="s"/>', "failed": '<failure message="f"/>',
           "error": '<error message="e"/>', "passed": ""}
    body = "".join(f'<testcase classname="tests.test_torch_cuda" name="{n}">{tag[o]}</testcase>'
                   for n, o in cases)
    return (f'<?xml version="1.0" encoding="utf-8"?><testsuites><testsuite name="pytest" '
            f'tests="{len(cases)}">{body}</testsuite></testsuites>')


@pytest.mark.parametrize("outcomes, rc, ok", [
    (("passed", "passed", "passed"), 0, True),
    (("passed", "skipped", "passed"), 0, False),
    (("passed", "failed", "passed"), 1, False),
    (("passed", "error", "passed"), 1, False),
    (("passed", "passed", "passed"), 1, False),
    ((), 5, False),
    (None, 4, False),
], ids=["all-pass", "a-skip", "a-failure", "an-error", "nonzero-exit", "nothing-collected",
        "no-report"])
def test_phase25_holds_passes_to_collected(smoke, monkeypatch, outcomes, rc, ok):
    """Phase 25 passes only when the child exits 0 and every collected case
    passed; otherwise it raises with the child's tail."""
    def fake_run(cmd, **kw):
        xml = next(a for a in cmd if a.startswith("--junitxml=")).split("=", 1)[1]
        if outcomes is not None:
            with open(xml, "w") as f:
                f.write(_junit([(f"test_case[{i}]", o) for i, o in enumerate(outcomes)]))
        return subprocess.CompletedProcess(cmd, rc, stdout="child tail", stderr="")

    monkeypatch.setattr(smoke.subprocess, "run", fake_run)
    if ok:
        assert smoke._phase25_card_tests("card") == (3, 3)
    else:
        with pytest.raises(AssertionError, match="child tail"):
            smoke._phase25_card_tests("card")


def test_phase25_rehearsal_on_the_cpu(smoke):
    """The child's command collects the card tests on a host with no card
    (no conftest, so no JAX) and every case skips for want of one, which
    phase 25 refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the child would run the card tests")
    with pytest.raises(AssertionError, match=r"0 passed of (\d+), skipped") as err:
        smoke._phase25_card_tests("no card")
    collected = int(re.search(r"0 passed of (\d+)", str(err.value)).group(1))
    assert collected >= 25 and f"{collected} skipped" in str(err.value)
    assert "failed []" in str(err.value)
