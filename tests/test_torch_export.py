"""The port's policy export against the JAX package's
(humanoid_gym_tpu/export/policy_export.py), the loader of the shipped
actor artifacts, and the shipped walking policy in the port's env on the
CPU: the first check of the port's physics with a trained policy."""

import math
import os
import zipfile

import numpy as np
import pytest
import torch

from humanoid_gym_tpu.export import policy_export as JE
from humanoid_gym_tpu_torch import HGT_ROOT_DIR, registry
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
from humanoid_gym_tpu_torch.algo.networks import ActorCritic
from humanoid_gym_tpu_torch.export import NumpyPolicy, export_policy, load_policy

torch.set_num_threads(1)

POLICIES = os.path.join(HGT_ROOT_DIR, "resources", "policies")


def _net(seed=0):
    return ActorCritic(705, 219, 12, seed=seed)


def _flax_params(net):
    """The port net's actor as the flax params tree the JAX export reads."""
    return {"params": {"actor": {
        f"Dense_{i}": {"kernel": np.ascontiguousarray(lin.weight.detach().numpy().T),
                       "bias": lin.bias.detach().numpy()}
        for i, lin in enumerate(net.actor.layers)}}}


def _obs(n=16, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 705)).astype(np.float32)


def test_artifacts_equal_the_reference_export(tmp_path):
    """Same weights through both exports: policy.bin byte for byte; every
    array member of policy.npz byte for byte, in the same order (the zip
    container also stamps each member's write time, which is not
    compared); policy_jit.pt loads with torch.jit.load and gives the
    actor's actions."""
    net = _net()
    ours = export_policy(net, str(tmp_path / "ours"))
    theirs = JE.export_policy(_flax_params(net), str(tmp_path / "theirs"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] == [
        "policy.npz", "policy.bin", "policy_jit.pt"]
    assert open(ours[1], "rb").read() == open(theirs[1], "rb").read()
    with zipfile.ZipFile(ours[0]) as a, zipfile.ZipFile(theirs[0]) as b:
        assert a.namelist() == b.namelist()
        assert len(a.namelist()) == 9
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    mod = torch.jit.load(ours[2])
    obs = _obs()
    with torch.no_grad():
        want = net.act(torch.from_numpy(obs))[0].numpy()
        np.testing.assert_allclose(mod(torch.from_numpy(obs)).numpy(), want, atol=1e-5)


def test_reference_loader_reads_the_port_artifacts(tmp_path):
    """The JAX package's load_policy on the port's policy.npz and
    policy_jit.pt gives the port actor's actions (atol 1e-5), as the port's
    own load_policy does."""
    net = _net(seed=3)
    npz, _, pt = export_policy(net, str(tmp_path))
    obs = _obs(seed=2)
    with torch.no_grad():
        want = net.act(torch.from_numpy(obs))[0].numpy()
    for path in (npz, pt):
        np.testing.assert_allclose(JE.load_policy(path)(obs), want, atol=1e-5)
        np.testing.assert_allclose(load_policy(path)(obs), want, atol=1e-5)
    assert isinstance(load_policy(npz), NumpyPolicy)


@pytest.mark.parametrize("name", ["xbotl_walk_demo", "xbotl_footing_demo"])
def test_shipped_actor_loads_into_the_port_net(name):
    """actor_critic_from_npz puts a shipped actor-only artifact into the
    port's ActorCritic: its actions are the artifact's NumpyPolicy's and
    the TorchScript twin's (atol 1e-5); the critic and the std stay as they
    were; a net of other widths is refused."""
    net = _net(seed=4)
    critic = {k: v.clone() for k, v in net.state_dict().items() if not k.startswith("actor.")}
    assert actor_critic_from_npz(net, os.path.join(POLICIES, f"{name}.npz")) is net
    for k, v in net.state_dict().items():
        if not k.startswith("actor."):
            assert torch.equal(v, critic[k]), k
    obs = _obs(seed=5)
    with torch.no_grad():
        got = net.act(torch.from_numpy(obs))[0].numpy()
    np.testing.assert_allclose(got, JE.load_policy(os.path.join(POLICIES, f"{name}.npz"))(obs),
                               atol=1e-5)
    np.testing.assert_allclose(got, load_policy(os.path.join(POLICIES, f"{name}_jit.pt"))(obs),
                               atol=1e-5)
    with pytest.raises(ValueError, match="layer"):
        actor_critic_from_npz(ActorCritic(705, 219, 12, actor_hidden=(256, 128)),
                              os.path.join(POLICIES, f"{name}.npz"))


def _deploy_overrides(cfg):
    """Deployment-clean setup (tests/test_xbots.py:71-83): flat, no DR or
    noise, no heading command."""
    cfg.env.num_envs = 1
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


def _walk(task, policy, vx, n_steps):
    """Roll the shipped actor deterministically on one env of `task` with
    the command held at (vx, 0, 0): (fell at step or None, x distance)."""
    env, _ = registry.make_env(task, num_envs=1, cfg_overrides=_deploy_overrides, device="cpu")
    net = actor_critic_from_npz(_net(), os.path.join(POLICIES, f"{policy}.npz"))
    state, obs, _ = env.reset_all()
    cmd = torch.tensor([[vx, 0.0, 0.0, 0.0]])
    x0 = float(state.phys.qpos[0, 0])
    for i in range(n_steps):
        state = state.replace(commands=cmd)
        with torch.no_grad():
            action = net.act(obs)[0]
        state, tr = env.step(state, action)
        obs = tr.obs
        if bool(tr.done[0]) and not bool(tr.time_out[0]):
            return i, float(state.phys.qpos[0, 0]) - x0
    return None, float(state.phys.qpos[0, 0]) - x0


def test_walk_demo_first_second_on_cpu():
    """The first second of the demo walk below (100 policy steps through
    the plain mega step, about 15 s on one CPU thread): no fall, and at
    least a quarter of the 0.4 m commanded (the gait starts from standing
    within that second)."""
    fell, dist = _walk("humanoid_ppo", "xbotl_walk_demo", 0.4, 100)
    assert fell is None, f"fell at step {fell}"
    assert dist >= 0.1, dist


@pytest.mark.slow
def test_walk_demo_walks_on_cpu():
    """The shipped flat walking policy walks the port's XBot-L env: 1 env,
    commanded vx 0.4 m/s, 400 policy steps (4 s) through the plain mega
    step, no fall and at least 0.8 m covered (tests/test_xbots.py:86 with
    the repo's own demo). About a minute on one CPU thread, hence slow."""
    fell, dist = _walk("humanoid_ppo", "xbotl_walk_demo", 0.4, 400)
    assert fell is None, f"fell at step {fell}"
    assert dist >= 0.8, dist


@pytest.mark.slow
def test_joint_policy_walks_xbot_s_on_cpu():
    """tests/test_xbots.py:86 on the port: the shipped joint policy walks
    XBot-S at the Froude-scaled command 0.4 sqrt(s), 400 steps, no fall,
    at least half the ideal distance."""
    from humanoid_gym_tpu_torch.config.xbots import SCALE

    vx = 0.4 * math.sqrt(SCALE)
    fell, dist = _walk("humanoid_s_ppo", "xbotl_footing_demo", vx, 400)
    assert fell is None, f"fell at step {fell}"
    assert dist >= 0.5 * vx * 400 * 0.01, dist
