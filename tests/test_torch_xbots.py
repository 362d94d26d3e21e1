"""The port's XBot-S against the JAX package: the scaled URDF, the model
built from it, the task config, and env steps of `humanoid_s_ppo`; the
scaling invariants of tests/test_xbots.py:12-44 on the port's models."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from humanoid_gym_tpu import registry as jreg
from humanoid_gym_tpu.config.xbots import SCALE as JSCALE
from humanoid_gym_tpu.config.xbots import XBotSCfg as JaxSCfg
from humanoid_gym_tpu.utils.scale_urdf import scale_urdf as jax_scale_urdf
from humanoid_gym_tpu_torch import XBOT_URDF, registry as treg
from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax
from humanoid_gym_tpu_torch.config.xbots import SCALE, XBotSCfg
from humanoid_gym_tpu_torch.utils.scale_urdf import ensure_xbot_s, scale_urdf

torch.set_num_threads(1)


def test_scaled_urdf_equals_the_shipped_and_is_not_rewritten(tmp_path):
    """`scale_urdf` of XBot-L writes the bytes of the shipped XBot-S URDF
    and of the JAX package's `scale_urdf`; `ensure_xbot_s` leaves the
    shipped file as it is (same bytes and modification time)."""
    shipped = ensure_xbot_s()
    before = (open(shipped, "rb").read(), os.stat(shipped).st_mtime_ns)
    assert ensure_xbot_s() == shipped
    assert (open(shipped, "rb").read(), os.stat(shipped).st_mtime_ns) == before
    ours = scale_urdf(XBOT_URDF, str(tmp_path / "ours.urdf"), SCALE, name_suffix="-S")
    theirs = jax_scale_urdf(XBOT_URDF, str(tmp_path / "theirs.urdf"), SCALE, name_suffix="-S")
    assert filecmp.cmp(ours, shipped, shallow=False)
    assert filecmp.cmp(ours, theirs, shallow=False)


def _tree(obj):
    """A config object as nested dicts of plain values."""
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return {k: _tree(v) for k, v in vars(obj).items() if not k.startswith("_")}
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    return obj


def test_xbot_s_config_matches_jax():
    """Every field of XBotSCfg equals the JAX package's: the Froude rules
    for gains, gait cycle, heights, commands, pushes, mass DR, froude_scale
    and the scaled deployment terrain (paths compared by file name, since
    each package names its own root)."""
    assert SCALE == JSCALE
    got, want = _tree(XBotSCfg()), _tree(JaxSCfg())
    for tree in (got, want):
        tree["asset"]["file"] = os.path.basename(tree["asset"]["file"])
        tree["asset"]["mesh_dir"] = os.path.basename(tree["asset"]["mesh_dir"])
        tree["terrain"]["deploy_mjcf"] = os.path.basename(tree["terrain"]["deploy_mjcf"])
    assert got == want
    assert got["terrain"]["froude_scale"] == SCALE
    assert got["terrain"]["deploy_mjcf"] == "XBot-S-terrain.xml"


def test_xbot_s_model_matches_jax_and_scales():
    """The S model the port builds for `humanoid_s_ppo` equals the JAX
    package's at rtol 1e-6 (masses, inertias, joint origins, efforts,
    contact offsets), and against the port's XBot-L model it holds the
    invariants of tests/test_xbots.py:12-44: masses x s^3, joint origins x
    s, inertias x s^5, efforts x s^4, contact points x s, the standing
    height x s."""
    jenv, _ = jreg.make_env("humanoid_s_ppo", num_envs=1)
    tenv, tcfg = treg.make_env("humanoid_s_ppo", num_envs=1, device="cpu")
    lenv, _ = treg.make_env("humanoid_ppo", num_envs=1, device="cpu")
    jm, ms, ml = jenv.model, tenv.model, lenv.model
    assert ms.dof_names == tuple(jm.dof_names) and ms.nbody == jm.nbody
    for name in ("body_mass", "body_inertia", "joint_pos", "dof_effort", "contact_point_offset",
                 "body_com", "dof_vel_limit", "dof_damping"):
        np.testing.assert_allclose(getattr(ms, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    s = SCALE
    assert ms.nbody == ml.nbody and ms.dof_names == ml.dof_names
    np.testing.assert_allclose(ms.body_mass.numpy(), ml.body_mass.numpy() * s**3, rtol=1e-4)
    np.testing.assert_allclose(ms.joint_pos.numpy(), ml.joint_pos.numpy() * s, atol=1e-6)
    np.testing.assert_allclose(ms.body_inertia.numpy(), ml.body_inertia.numpy() * s**5,
                               rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(ms.dof_effort.numpy(), ml.dof_effort.numpy() * s**4, rtol=1e-4)
    np.testing.assert_allclose(ms.contact_point_offset.numpy(),
                               ml.contact_point_offset.numpy() * s, atol=1e-6)
    assert abs(tcfg.init_state.pos[2] - 0.95 * s) < 1e-6
    np.testing.assert_allclose(tenv.p_gains.numpy(), lenv.p_gains.numpy() * s**4, rtol=1e-6)
    np.testing.assert_allclose(tenv.d_gains.numpy(), lenv.d_gains.numpy() * s**4.5, rtol=1e-6)


def test_xbot_s_env_steps_match_jax():
    """Five batched env steps of `humanoid_s_ppo` from one shared state,
    solver `apgd` at its 8 iterations in both packages (the same external
    DOF order), with the quiet config of tests/test_torch_env.py. The
    tolerances of its substep-solver test: qpos 2e-4, qvel 5e-3, obs /
    privileged obs 5e-3, reward 1e-4, exact done flags; the robots stay up
    at S's standing height."""
    n = 3

    def quiet(cfg):
        cfg.noise.add_noise = False
        cfg.domain_rand.push_robots = False
        cfg.domain_rand.action_delay = 0.0
        cfg.domain_rand.action_noise = 0.0
        cfg.sim.solver.solver_type = "apgd"

    jenv, _ = jreg.make_env("humanoid_s_ppo", num_envs=n, cfg_overrides=quiet)
    tenv, _ = treg.make_env("humanoid_s_ppo", num_envs=n, cfg_overrides=quiet, device="cpu")
    assert tenv.reward_names == jenv.reward_names
    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(3), n), jnp.arange(n))
    ts = env_state_from_jax(js)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    for _ in range(5):
        a = rng.uniform(-0.5, 0.5, (n, 12)).astype(np.float32)
        js, jtr = jstep(js, jnp.asarray(a))
        ts, ttr = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        assert not np.asarray(jtr.done).any()
        np.testing.assert_allclose(ts.phys.qpos.numpy(), js.phys.qpos, atol=2e-4)
        np.testing.assert_allclose(ts.phys.qvel.numpy(), js.phys.qvel, atol=5e-3)
        np.testing.assert_allclose(ttr.obs.numpy(), jtr.obs, atol=5e-3)
        np.testing.assert_allclose(ttr.privileged_obs.numpy(), jtr.privileged_obs, atol=5e-3)
        np.testing.assert_allclose(ttr.reward.numpy(), jtr.reward, atol=1e-4)
        np.testing.assert_array_equal(ts.episode_length.numpy(), js.episode_length)
    z = ts.phys.qpos[:, 2].numpy()
    assert np.all(np.isfinite(ttr.obs.numpy())) and (z > 0.4).all() and (z < 0.75).all()
