"""The port's measurement tools on the CPU: the roofline census against the
JAX package's, the config4 accounting against the JAX artifact, the SASS
census's parsers on output cut from the toolkit (nvdisasm 12.9 and
cuobjdump on an sm_90a build of csrc/mega.cu), the device rule every
script follows, learn_profile_torch and the example at a few envs."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import examples.minimal_train_loop_torch as EX  # noqa: E402
from humanoid_gym_tpu.utils import roofline as JR  # noqa: E402
from humanoid_gym_tpu_torch.physics import cuda_build  # noqa: E402
from humanoid_gym_tpu_torch.physics import mega as MG  # noqa: E402
from humanoid_gym_tpu_torch.physics import mega_sass, sass_census  # noqa: E402
from humanoid_gym_tpu_torch.utils import roofline as TR  # noqa: E402
from humanoid_gym_tpu_torch.utils.platform import card_line, resolve_device  # noqa: E402
from scripts import config4_dryrun_torch as C4  # noqa: E402
from scripts import kernel_census_torch as KC  # noqa: E402
from scripts import learn_profile_torch as LP  # noqa: E402
from scripts import roofline_torch as RL  # noqa: E402

torch.set_num_threads(1)

ROLLOUT_FLOWS = ("rollout storage write", "perm gathers (read+write)",
                 "learn minibatch reads (2 epochs)")


@pytest.mark.parametrize("envs,T", [(4096, 60), (16384, 4)])
def test_hbm_rollout_flows_equal_jax(envs, T):
    """The three rollout flows are layout-free: entry for entry the JAX
    package's; the kernel's flow is the port's own rows, T launches."""
    for terrain in (False, True):
        got, want = TR.hbm_bytes(envs, T, terrain), JR.hbm_bytes(envs, T, terrain)
        for k in ROLLOUT_FLOWS:
            assert got[k] == want[k], k
        per_env = 4 * (MG.IN_ROWS + MG.OUT_ROWS + (MG.IN2_ROWS if terrain else 0))
        assert got[f"kernel in/out rows ({T} launches)"] == envs * T * per_env
    assert 4 * (MG.IN_ROWS + MG.IN2_ROWS + MG.OUT_ROWS) == 1856  # B1t's bytes an env


def test_physics_census_is_the_kernels_count():
    for envs in (1, 4096):
        assert TR.physics_flops_per_step(envs) == envs * TR.mega_ops(10, 8)
        assert TR.physics_flops_per_step(envs, terrain=True) == envs * TR.mega_terrain_ops(10, 8)
        assert TR.physics_issue_per_step(envs) == envs * TR.mega_ops_executed(10, 8)
        assert TR.physics_issue_per_step(envs, True) == envs * TR.mega_terrain_ops_executed(10, 8)
    # what a warp issues is never below what the function needs; the terrain
    # variant issues more than the flat one, linear in substeps
    assert TR.mega_terrain_ops_executed(10, 8) > TR.mega_ops_executed(10, 8)
    assert TR.mega_terrain_ops_executed(10, 8) >= TR.mega_terrain_ops(10, 8)
    d = TR.mega_terrain_ops_executed(2, 8) - TR.mega_terrain_ops_executed(1, 8)
    assert TR.mega_terrain_ops_executed(10, 8) == TR.mega_terrain_ops_executed(0, 8) + 10 * d


def test_roofline_cli_census_and_shares(capsys):
    c = RL.main(["--device", "cpu", "--iter-ms", "1000"])
    out = capsys.readouterr().out
    assert "peaks: H100 SXM data sheet, no card read" in out
    assert c["total_flops"] == TR.iteration_flops(4096)
    assert c["total_bytes"] == sum(TR.hbm_bytes(4096).values())
    assert json.loads(out.strip().splitlines()[-1])["total_flops"] == c["total_flops"]
    s = c["shares"]
    assert s["env_steps_per_s"] == 4096 * 60
    assert math.isclose(s["flops_share_of_bf16_peak"], c["total_flops"] / TR.PEAK_BF16_FLOPS)
    assert math.isclose(s["physics_share_of_f32_peak"], c["physics_flops"] / TR.PEAK_F32_FLOPS)
    assert math.isclose(s["bytes_share_of_hbm_peak"], c["total_bytes"] / TR.PEAK_BYTES_PER_S)
    t = RL.census(4096, terrain=True)
    assert t["physics_flops"] == 60 * TR.physics_flops_per_step(4096, True)


def test_config4_accounting_reproduces_the_jax_artifact():
    """The rollout formula (964 floats a joint sample) and the T = 60
    projection reproduce docs/config4_dryrun.json at its envs, horizon,
    state bytes and device count."""
    with open(os.path.join(ROOT, "docs", "config4_dryrun.json")) as f:
        art = json.load(f)
    row = C4.rollout_row_floats(705, 219, 12)
    assert row == 964
    assert art["envs"] * art["horizon"] * row * 4 == art["rollout_bytes_total_at_T"] == 252706816
    proj = C4.projection_t60_per_rank(art["env_state_bytes_total"], art["envs"], row,
                                      art["devices"])
    assert round(proj) == art["projection_T60_per_device_bytes"]
    assert 16384 * 60 * row * 4 == 3790602240


@pytest.mark.parametrize("script", ["roofline_torch", "learn_profile_torch", "config4_dryrun_torch",
                                    "scaling_bench_torch", "kernel_census_torch"])
def test_scripts_default_to_the_card_and_raise_without_one(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", f"{script}.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert run.returncode != 0
    assert "no CUDA card found; pass --device cpu" in run.stderr


def test_resolve_device_and_card_line():
    assert resolve_device("cpu") == torch.device("cpu")
    assert card_line(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card found"):
            resolve_device("cuda")


def test_census_says_it_needs_nvcc():
    """On a host without the CUDA toolkit the census raises, naming nvcc."""
    try:
        cuda_build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KC.main(["--device", "cpu"])


# nvdisasm --print-line-info-inline of an sm_90a cubin of csrc/mega.cu
# (-lineinfo), cut to a few lines of each mega instance
NVDISASM = r'''
//--------------------- .nv.info                  --------------------------
	.section	.nv.info,"",@"SHT_CUDA_INFO"
        /*0000*/ 	.byte	0x04, 0x2f
//--------------------- .text._Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_ --------------------------
	.section	.text._Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_,"ax",@progbits
	.sectionflags	@"SHF_BARRIERS=1"
	.align	128
        .global         _Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_
_Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_:
.text._Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_:
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 705
        /*0000*/                   LDC R1, c[0x0][0x28] ;
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 247 inlined at "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 710
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 710
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0070*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*00e0*/                   IMAD.WIDE R2, R7, 0x4, R4 ;
	//## File "/repo/humanoid_gym_tpu_torch/csrc/apgd.cuh", line 260 inlined at "/repo/humanoid_gym_tpu_torch/csrc/solve.cuh", line 167
	//## File "/repo/humanoid_gym_tpu_torch/csrc/solve.cuh", line 167 inlined at "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 663
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 663 inlined at "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 757
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 757
        /*12740*/                   FADD R16, R16, R17 ;
	//## File "/usr/local/cuda/bin/../targets/x86_64-linux/include/sm_30_intrinsics.hpp", line 449 inlined at "/repo/humanoid_gym_tpu_torch/csrc/apgd.cuh", line 61
	//## File "/repo/humanoid_gym_tpu_torch/csrc/apgd.cuh", line 61 inlined at "/repo/humanoid_gym_tpu_torch/csrc/solve.cuh", line 168
	//## File "/repo/humanoid_gym_tpu_torch/csrc/solve.cuh", line 168 inlined at "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 663
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 757
        /*12750*/                   SHFL.BFLY PT, R17, R16, 0x10, 0x1f ;
        /*12760*/                   FMUL.FTZ R8, R16, R11 ;
        /*1ebf0*/                   NOP;
.L_x_1913:


//--------------------- .text._Z15hgt_mega_kernelILb0EEvPKfPfifiifS1_9MgTerrainS1_ --------------------------
	.section	.text._Z15hgt_mega_kernelILb0EEvPKfPfifiifS1_9MgTerrainS1_,"ax",@progbits
_Z15hgt_mega_kernelILb0EEvPKfPfifiifS1_9MgTerrainS1_:
.text._Z15hgt_mega_kernelILb0EEvPKfPfifiifS1_9MgTerrainS1_:
        /*0000*/                   LDC R1, c[0x0][0x28] ;
	//## File "/repo/humanoid_gym_tpu_torch/csrc/mega.cu", line 274
        /*5070*/                   LDS.128 R4, [R36+0xa60] ;
        /*5080*/              @!P0 FFMA.FTZ R4, R5, R6, R7 ;
'''

# cuobjdump -sass of the shared library the port loads, cut likewise
CUOBJDUMP = r'''
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a

Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z15hgt_mega_kernelILb1EEvPKfPfifiifS1_9MgTerrainS1_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                            /* 0x00000a00ff017b82 */
                                                                                                     /* 0x000e220000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                                                /* 0x0000000000007919 */
                                                                                                     /* 0x000e620000002100 */
        /*0070*/               @P0 BRA 0x150 ;                                                       /* 0x0000000000340947 */
                                                                                                     /* 0x000fea0003800000 */
		..........


		Function : _Z15hgt_mega_kernelILb0EEvPKfPfifiifS1_9MgTerrainS1_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                            /* 0x00000a00ff017b82 */
                                                                                                     /* 0x000e220000000800 */
        /*1ebe0*/                   NOP;                                                             /* 0x0000000000007918 */
                                                                                                     /* 0x000fc00000000000 */
		..........
'''


def test_nvdisasm_parser_on_toolkit_output():
    funcs = sass_census.parse_nvdisasm(NVDISASM)
    t = mega_sass.mega_kernel_name(funcs, terrain=True)
    f = mega_sass.mega_kernel_name(funcs, terrain=False)
    assert "ILb1E" in t and "ILb0E" in f and len(funcs) == 2
    terr = funcs[t]
    assert [i for i, _, _ in terr] == [
        "LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "@P0 BRA `(.L_x_1)",
        "IMAD.WIDE R2, R7, 0x4, R4", "FADD R16, R16, R17", "SHFL.BFLY PT, R17, R16, 0x10, 0x1f",
        "FMUL.FTZ R8, R16, R11", "NOP"]
    # the innermost location of each run, kept until the next run
    assert [w for _, w, _ in terr] == [
        "mega.cu:705", "mega.cu:247", "mega.cu:247", "mega.cu:247", "apgd.cuh:260",
        "sm_30_intrinsics.hpp:449", "sm_30_intrinsics.hpp:449", "sm_30_intrinsics.hpp:449"]
    # a toolkit header's instruction goes to the kernel line that calls it
    assert [k for _, _, k in terr][5:] == ["apgd.cuh:61"] * 3
    flat = funcs[f]
    assert [k for _, _, k in flat] == ["?", "mega.cu:274", "mega.cu:274"]


def test_opcodes_lose_predicates_and_modifiers():
    assert sass_census.opcode("@!P0 BRA `(.L_x_2)") == "BRA"
    assert sass_census.opcode("FFMA.FTZ R4, R5, R6, R7") == "FFMA"
    assert sass_census.opcode("LDS.U.128 R4, [R36]") == "LDS"
    assert sass_census.opcode("SHFL.BFLY PT, R17, R16, 0x10, 0x1f") == "SHFL"
    assert sass_census.opcode("NOP") == "NOP"


def test_census_summary():
    funcs = sass_census.parse_nvdisasm(NVDISASM)
    s = sass_census.summarise(funcs[mega_sass.mega_kernel_name(funcs, True)], opcodes=3, lines=2)
    assert s["instructions"] == 8 and s["attributed_share"] == 1.0
    assert s["top_opcodes"] == [("LDC", 1), ("S2R", 1), ("BRA", 1)]
    assert s["top_lines"] == [("mega.cu:247", 3), ("apgd.cuh:61", 3)]
    assert s["per_file"] == {"mega.cu": 4, "apgd.cuh": 4}
    assert s["per_innermost_file"] == {"mega.cu": 4, "sm_30_intrinsics.hpp": 3, "apgd.cuh": 1}
    flat = sass_census.summarise(funcs[mega_sass.mega_kernel_name(funcs, False)])
    assert flat["attributed_share"] == pytest.approx(2 / 3)


def test_cuobjdump_parser_tells_the_instances_apart():
    funcs = mega_sass.sass_functions(CUOBJDUMP)
    t = funcs[mega_sass.mega_kernel_name(funcs, terrain=True)]
    f = funcs[mega_sass.mega_kernel_name(funcs, terrain=False)]
    assert t == ["LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;", "@P0 BRA 0x150 ;"]
    assert f == ["LDC R1, c[0x0][0x28] ;", "NOP;"]
    with pytest.raises(RuntimeError, match="expected one flat"):
        mega_sass.mega_kernel_name(["hgt_solve_kernel"])


def test_learn_profile_on_the_cpu():
    """Every stage at 8 envs, T = 4: the JAX script's keys plus the new
    ones; wall times finite and positive; device times not measured on the
    CPU (None); no mega launch with solver apgd."""
    s = LP.profile_stages(envs=8, reps=1, horizon=4, device="cpu")
    for k in ("envs", "T", "dtype", "stages_ms", "n_updates", "n_updates_x_update1_ms",
              "device_ms", "device", "mega_launches", "profile_protocol"):
        assert k in s, k
    assert (s["envs"], s["T"], s["n_updates"], s["solver"]) == (8, 4, 8, "apgd")
    assert set(s["stages_ms"]) == set(LP.STAGES) == set(s["device_ms"])
    assert all(math.isfinite(v) and v > 0 for v in s["stages_ms"].values())
    assert all(v is None for v in s["device_ms"].values())
    assert s["n_updates_x_update1_ms"] == 8 * s["stages_ms"]["update1"]
    assert s["mega_launches"] == {"full": [0], "rollout": [0]}
    assert s["device"] == "cpu"


def test_example_runs_on_the_cpu():
    history, action = EX.main(num_envs=8, iterations=3, horizon=4, device="cpu")
    assert len(history) == 3
    assert all(math.isfinite(v) for h in history for v in h.values())
    assert action.shape == (1, 12) and bool(torch.isfinite(action).all())
