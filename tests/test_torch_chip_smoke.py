"""chip_smoke.py's parts that need no card: its refusal to run without one,
the operation counts behind the kernels' bounds, and the keys of the
per-kernel records."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

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
    assert found == 5


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
