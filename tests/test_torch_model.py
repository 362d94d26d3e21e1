"""PyTorch port vs the JAX package: config trees, the robot model, and the
quaternion helpers. Inputs are made with numpy from a seed and fed to both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.config import base as JB
from humanoid_gym_tpu.config import xbotl as JX
from humanoid_gym_tpu.physics import spatial as JS
from humanoid_gym_tpu.physics.model import build_xbot_model as jax_model
from humanoid_gym_tpu_torch.config import base as TB
from humanoid_gym_tpu_torch.config import xbotl as TX
from humanoid_gym_tpu_torch.physics import spatial as TS
from humanoid_gym_tpu_torch.physics.model import build_xbot_model as torch_model

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)


@pytest.mark.parametrize(
    "jax_cfg, torch_cfg",
    [
        (JX.XBotLCfg, TX.XBotLCfg),
        (JX.XBotLCfgPPO, TX.XBotLCfgPPO),
        (JB.LeggedRobotCfg, TB.LeggedRobotCfg),
        (JB.PPOCfg, TB.PPOCfg),
    ],
    ids=["XBotLCfg", "XBotLCfgPPO", "LeggedRobotCfg", "PPOCfg"],
)
def test_config_trees_equal(jax_cfg, torch_cfg):
    """The port's dataclasses.asdict tree equals the reference's, field for
    field (exact)."""
    assert dataclasses.asdict(torch_cfg()) == dataclasses.asdict(jax_cfg())


def test_config_derived_quantities_equal():
    j, t = JX.XBotLCfg(), TX.XBotLCfg()
    for name in ("dt", "max_episode_length", "push_interval", "resampling_interval"):
        assert getattr(t, name) == getattr(j, name), name
    assert TX.XBOT_DOF_NAMES == JX.XBOT_DOF_NAMES


@pytest.fixture(scope="module")
def models():
    return jax_model(), torch_model()


def test_robot_model_arrays_equal(models):
    """Every RobotModel array equals build_xbot_model()'s exactly, and every
    topology field is the same tuple."""
    jm, tm = models
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert tuple(a) == tuple(b), f.name
    assert tm.contact_point_runs() == jm.contact_point_runs()
    assert (tm.nbody, tm.nj, tm.nv, tm.nq, tm.ncon) == (jm.nbody, jm.nj, jm.nv, jm.nq, jm.ncon)


def test_model_to_device_roundtrip(models):
    _, tm = models
    moved = tm.to("cpu")
    assert moved.device == torch.device("cpu")
    np.testing.assert_array_equal(moved.joint_rot.numpy(), tm.joint_rot.numpy())


def _quat(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


_rng = np.random.default_rng(0)
_N = 16
_Q, _Q2 = _quat(_rng, _N), _quat(_rng, _N)
_V = _rng.normal(size=(_N, 3)).astype(np.float32)
_ANG = _rng.uniform(-4, 4, _N).astype(np.float32)
_AX = (_V / np.linalg.norm(_V, axis=1, keepdims=True)).astype(np.float32)

QUAT_CASES = {
    "quat_mul": lambda m: m.quat_mul(_Q, _Q2),
    "quat_conj": lambda m: m.quat_conj(_Q),
    "quat_rotate": lambda m: m.quat_rotate(_Q, _V),
    "quat_rotate_inverse": lambda m: m.quat_rotate_inverse(_Q, _V),
    "quat_to_mat": lambda m: m.quat_to_mat(_Q),
    "quat_from_axis_angle": lambda m: m.quat_from_axis_angle(_AX, _ANG),
    "quat_from_euler_zyx_rpy": lambda m: m.quat_from_euler_zyx_rpy(_V),
    "quat_to_euler_xyz": lambda m: m.quat_to_euler_xyz(_Q),
    "quat_integrate": lambda m: m.quat_integrate(_Q, _V * 3.0, 0.01),
    "quat_derivative": lambda m: m.quat_derivative(_Q, _V),
    "quat_apply_yaw": lambda m: m.quat_apply_yaw(_Q, _V),
    "wrap_to_pi": lambda m: m.wrap_to_pi(_ANG * 3.0),
    "skew": lambda m: m.skew(_V),
    "quat_normalize": lambda m: m.quat_normalize(_Q * 2.5),
}


class _JaxArgs:
    """Calls the JAX helpers with jnp inputs."""

    def __getattr__(self, name):
        fn = getattr(JS, name)
        return lambda *a: np.asarray(
            fn(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in a])
        )


class _TorchArgs:
    def __getattr__(self, name):
        fn = getattr(TS, name)
        return lambda *a: fn(
            *[torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in a]
        ).numpy()


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_helpers_match(name):
    """Each quaternion helper agrees with the reference within 1e-6 (f32)."""
    got = QUAT_CASES[name](_TorchArgs())
    want = QUAT_CASES[name](_JaxArgs())
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
