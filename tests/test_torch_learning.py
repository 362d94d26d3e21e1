"""The port's learning curve held to the JAX package's bands
(tests/test_learning_regression.py:80-90, unchanged; the check is
`humanoid_gym_tpu_torch/utils/learning_band.py`): a seeded 16-env short
training run on the CPU, solver apgd as the JAX test runs it, seed 5,
T = 60, 12 iterations through `make_train_iter`. It takes ~135 s on one
CPU thread, so it is marked slow; the card runs the same check with solver
mega in every run of chip_smoke.py (phase 15)."""

import pytest
import torch

from humanoid_gym_tpu_torch.utils.learning_band import band_misses, learning_curve

torch.set_num_threads(1)


@pytest.mark.slow
def test_learning_curve_bands():
    c = learning_curve(device="cpu", solver="apgd", seed=5, n=16, T=60, iters=12)
    assert band_misses(c) == [], c


def test_band_misses_names_each_band():
    healthy = {"late_rew": 0.0132, "late_len": 138.0,
               "terms": {"tracking_lin_vel": 0.0218, "feet_contact_number": 0.0268},
               "step_rew": [0.01] * 12, "ep_len": [138.0] * 12,
               "vloss": [0.066] + [0.03] * 10 + [0.015], "nonfinite": 0}
    assert band_misses(healthy) == []
    broken = dict(healthy, late_len=80.0, terms={"tracking_lin_vel": 0.0128,
                                                 "feet_contact_number": 0.0157}, nonfinite=1)
    assert band_misses(broken) == ["late episode length in [100, 280]",
                                   "tracking_lin_vel >= 0.016", "feet_contact_number >= 0.020",
                                   "no non-finite reset"]
