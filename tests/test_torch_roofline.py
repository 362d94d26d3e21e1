"""The port's census (humanoid_gym_tpu_torch/utils/roofline.py): the
operation counts and bounds the kernel table in PERF.md quotes, the net
FLOPs equal to the JAX package's census, and chip_smoke.py reading the
census from the package."""

import importlib.util
import os

import pytest

from humanoid_gym_tpu.utils import roofline as JR
from humanoid_gym_tpu_torch import HGT_ROOT_DIR
from humanoid_gym_tpu_torch.physics import mega as MG
from humanoid_gym_tpu_torch.utils import roofline as R

N = 4096


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (R.PEAK_BYTES_PER_S, R.PEAK_F32_FLOPS, R.PEAK_BF16_FLOPS) == (3.35e12, 67e12, 989e12)


@pytest.mark.parametrize("kernel, ops, nbytes, want_ops, want_ms, want_by", [
    # B1: one flat policy step, IN and OUT rows
    ("B1", lambda: R.mega_ops(10, 8), 4 * (MG.IN_ROWS + MG.OUT_ROWS), 966_140, 0.05906,
     "operations"),
    # B1t: plus the (N, 208) IN2 rows
    ("B1t", lambda: R.mega_terrain_ops(10, 8), 4 * (MG.IN_ROWS + MG.IN2_ROWS + MG.OUT_ROWS),
     991_212, 0.06060, "operations"),
    # B2 alone (chip_smoke.py phase 3's byte count): Mt (18x18), Jt (18x60),
    # qvel, rhs, target, sign, mu, comp, lam0 in; qvel, lam out
    ("B2", lambda: R.solve_ops(8), 4 * (18 * 18 + 18 * 60 + 18 + 18 + 60 + 60 + 1 + 1 + 60
                                        + 18 + 60), 84_550, 0.00831, "bytes"),
    # B3: the fused dense solve
    ("B3", lambda: R.fused_dense_ops(8), 6_480, 181_554, 0.01110, "operations"),
    # B4: APGD on a prebuilt 60x60 matrix
    ("B4", lambda: R.apgd_ops(8), 15_288, 71_964, 0.01869, "bytes"),
])
def test_kernel_counts_and_bounds_are_perf_md_s(kernel, ops, nbytes, want_ops, want_ms,
                                                 want_by):
    """PERF.md section 6: operations per env and the bound at 4096 envs."""
    assert ops() == want_ops, kernel
    ms, by = R.bound_ms(N * nbytes, N * ops())
    assert by == want_by and abs(ms - want_ms) < 5e-6, (kernel, ms)  # PERF.md rounds to 1e-5


@pytest.mark.parametrize("envs, T, epochs", [(4096, 60, 2), (16, 60, 2), (1, 24, 5)])
def test_net_flops_equal_the_jax_census(envs, T, epochs):
    assert R.net_flops(envs, T, epochs) == JR.net_flops(envs, T, epochs)
    small = dict(obs=47, priv=73, act=6, actor_hidden=(32,), critic_hidden=(16, 8))
    assert R.net_flops(envs, T, epochs, **small) == JR.net_flops(envs, T, epochs, **small)


def test_iteration_flops_add_physics_nets_and_gae():
    roll, learn = R.net_flops(N)
    assert R.iteration_flops(N) == N * 60 * R.mega_ops(10, 8) + roll + learn + N * 60 * 10
    assert R.iteration_flops(N, T=24, epochs=5) == (N * 24 * R.mega_ops(10, 8)
                                                    + sum(R.net_flops(N, 24, 5)) + N * 24 * 10)


def test_chip_smoke_reads_the_census_from_the_package():
    path = os.path.join(HGT_ROOT_DIR, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_census", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("solve_ops", "mega_ops", "mega_terrain_ops", "apgd_ops", "fused_dense_ops",
                 "solve_ops_executed", "mega_ops_executed"):
        assert getattr(mod, name) is getattr(R, name)
    assert mod._bound_ms is R.bound_ms
    src = open(path).read()
    assert "def mega_ops" not in src and "PEAK_F32_FLOPS =" not in src
