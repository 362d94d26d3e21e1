"""The env step's reward stage (envs/rewards.py `make_rewards`) on the CPU.

CPU tensors take the plain chain, bit for bit, and never load the kernel
library; the plain chain keeps the parent's values (env steps equal the
frozen copy of the port's plain path, benchmark/reference/hgt_ref); the
launcher's term, slot and parameter tables are csrc/rewards.cu's; a config
naming a term with no function raises when the env is built. The kernel
itself is held to the plain chain on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from humanoid_gym_tpu_torch.envs import rewards as R

# one intra-op thread per process keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "humanoid_gym_tpu_torch", "csrc", "rewards.cu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _enum(name):
    """The member names of csrc/rewards.cu's `enum <name>`, in order, the
    closing N_* count left out."""
    body = re.search(r"enum %s \{(.*?)\};" % name, open(SOURCE).read(), re.S).group(1)
    names = re.findall(r"^\s*([A-Z_0-9]+),", body, re.M)
    return names[:-1] if names[-1].startswith("N_") else names


def _xbotl_rewards(feet_base=True, rcfg=None):
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg

    cfg = XBotLCfg()
    return R.make_rewards(rcfg or cfg.rewards, cfg.dt, torch.linspace(-0.05, 0.05, 12), (6, 12),
                          feet_base=feet_base)


def test_kernel_term_table_is_reward_functions():
    """The kernel's terms are REWARD_FUNCTIONS', in its order, as the
    source's `enum Term` lists them; the launcher's pointer slots, float and
    int parameters are the source's `enum Slot`, `FParam`, `IParam`."""
    assert R.KERNEL_TERMS == tuple(R.REWARD_FUNCTIONS)
    assert len(R.KERNEL_TERMS) == 26
    assert [n[2:].lower() for n in _enum("Term")] == list(R.KERNEL_TERMS)
    assert [n[2:].lower() for n in _enum("Slot")] == list(R.SLOTS)
    assert [n[2:].lower() for n in _enum("FParam")] == list(R.FPARAMS)
    assert [n[2:].lower() for n in _enum("IParam")] == list(R.IPARAMS)
    assert R.RewardInputs._fields == R.SLOTS[:len(R.RewardInputs._fields)]


@pytest.mark.parametrize("which", ["xbotl", "all"])
def test_the_table_holds_each_terms_column_and_scale(smoke, which):
    """`table`: per kernel term its episode-sum column (-1 where the config
    drops it) and scale * dt as float32, the env's `names` and `scales`;
    the float parameters rounded as PyTorch rounds a Python number on the
    card (1 / dt and 1 / cycle_time as float32 reciprocals)."""
    rcfg = None if which == "xbotl" else smoke._all_reward_terms()
    rw = _xbotl_rewards(rcfg=rcfg)
    fparams, ivals, cols = rw.table
    assert len(cols) == len(R.KERNEL_TERMS) and len(fparams) == len(R.FPARAMS) + len(cols)
    kept = [n for n, c in zip(R.KERNEL_TERMS, cols) if c >= 0]
    assert sorted(kept) == sorted(rw.names) and len(rw.names) == (22 if which == "xbotl" else 26)
    scales = fparams[len(R.FPARAMS):]
    for name, c, s in zip(R.KERNEL_TERMS, cols, scales):
        assert (rw.names[c] == name and s == float(rw.scales[c])) if c >= 0 else s == 0.0
    f = dict(zip(R.FPARAMS, fparams))
    assert f["inv_dt"] == float(np.float32(1.0) / np.float32(0.01))
    assert f["inv_cycle_time"] == float(np.float32(1.0) / np.float32(0.64))
    assert f["termination_scale"] == (0.0 if which == "xbotl" else float(
        np.float32(rw.termination_scale)))
    assert ivals["n_cols"] == len(rw.names) and ivals["feet_base"] == 1


@pytest.mark.parametrize("feet_base", [True, False])
@pytest.mark.parametrize("which", ["xbotl", "all"])
def test_cpu_rewards_take_the_plain_chain(smoke, monkeypatch, feet_base, which):
    """On CPU tensors the stage is `plain`, bit for bit, on states that
    reach every branch; the kernel library is never loaded and the
    rewards kernel's launch counter (one of the captured iteration's
    launch counters) does not move; the launcher refuses CPU tensors."""
    from humanoid_gym_tpu_torch.algo.capture import LAUNCH_COUNTERS
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg

    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(R, "kernel_library", refuse)
    rcfg = XBotLCfg().rewards if which == "xbotl" else smoke._all_reward_terms()
    rw = _xbotl_rewards(feet_base, rcfg)
    inp = smoke._reward_inputs(64, rcfg, len(rw.names), "cpu", seed=7, feet_base=feet_base)
    n0 = R.rewards_launch.launches
    got, want = rw(inp), rw.plain(inp)
    assert torch.equal(got.reward, want.reward) and bool(torch.isfinite(got.reward).all())
    assert torch.equal(got.episode_sums, want.episode_sums)
    assert all(torch.equal(g, w) for g, w in zip(got.feet, want.feet))
    assert torch.equal(got.contact, want.contact)
    assert R.rewards_launch.launches == n0
    assert (R.rewards_launch, "launches") in LAUNCH_COUNTERS
    with pytest.raises(ValueError, match="CUDA"):
        R.rewards_launch(inp, torch.zeros(12), rw.table)
    assert R.rewards_launch.launches == n0


def test_reward_inputs_reach_every_branch(smoke):
    """The random states the card's tests and chip_smoke.py phase 4r hold
    the kernel on reach every branch: rows that are not finite, |sin| < 0.1
    at the stance boundary, every value of low_speed and its |command| gate,
    stand_still's gate, contacts on both sides of 5 N (and on the line),
    feet_clearance's band, air times zero and positive, collision flags,
    the termination term; every input a strided view."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg

    rcfg = XBotLCfg().rewards
    inp = smoke._reward_inputs(1000, rcfg, 22, "cpu", seed=1)
    assert all(t.stride(0) > (t.shape[1] if t.dim() == 2 else 1) for t in inp
               if t is not inp.contact_forces)
    assert 0 < int((~inp.finite).sum()) < 100
    phase = R.gait_phase(inp.episode_length, 0.01, rcfg.cycle_time)
    sin = torch.sin(2 * np.pi * phase)
    assert int((sin.abs() < 0.1).sum()) > 10
    assert (R.stance_mask(phase).sum(1) == 2).any() and (R.stance_mask(phase).sum(1) == 1).any()
    low = R.low_speed(types.SimpleNamespace(base_lin_vel=inp.base_lin_vel, commands=inp.commands))
    assert {-2.0, -1.0, 0.0, float(np.float32(1.2))} <= set(low.tolist())
    assert (inp.commands[:, 0].abs() <= 0.1).any()
    assert (torch.linalg.norm(inp.commands[:, :2], dim=1) < 0.1).any()
    fz = inp.contact_forces[:, [6, 12], 2]
    assert (fz > 5).any() and (fz < 5).any() and (fz == 5).any()
    fz_world = inp.feet_rows[:, 4:6] + inp.qpos[:, 2:3]
    fh = inp.feet_height + ((fz_world - rcfg.sole_offset) - inp.last_feet_z)
    near = (fh - rcfg.target_feet_height).abs() < 0.01
    assert near.any() and (~near).any()
    assert (inp.feet_air_time == 0).any() and (inp.feet_air_time > 0).any()
    assert inp.collision_flags.any() and inp.last_contacts.any() and (~inp.last_contacts).any()
    assert (inp.done & ~inp.time_out).any() and inp.time_out.any()


def test_a_term_with_no_function_raises_when_the_env_is_built():
    """A config that scales a term outside REWARD_FUNCTIONS (the base
    class's feet_stumble) is refused at construction, naming the term."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = "apgd"
    cfg.rewards.scales.feet_stumble = -0.1
    with pytest.raises(ValueError, match="feet_stumble"):
        make_env(cfg, num_envs=2, device="cpu", seed=0)
    with pytest.raises(ValueError, match="feet_stumble"):
        _xbotl_rewards(rcfg=cfg.rewards)


def test_rewards_kernel_is_its_own_hand_written_library():
    """csrc/rewards.cu builds as a library of its own; its kernel is one
    the benchmark's device trace classes as hand-written, not as the
    physics kernel that `mega_roofline` reads."""
    from benchmark import devtrace
    from humanoid_gym_tpu_torch.physics import cuda_build as CB

    assert CB.SOURCES["rewards"] == ("rewards.cu",)
    src = open(SOURCE).read()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?(\w+)\(", src)
    assert kernels == ["hgt_rewards_kernel"]
    for name in kernels + ["hgt_rewards_kernel(RewardArgs)"]:
        assert devtrace.HAND_WRITTEN.search(name) and not devtrace.MEGA.search(name), name
        assert devtrace.kernel_class(name) == "hand_written"


@pytest.mark.parametrize("task, solver", [("humanoid_ppo", "mega"), ("humanoid_ppo", "apgd"),
                                          ("humanoid_joint_deploy", "mega")])
def test_env_steps_equal_the_frozen_copy(task, solver):
    """Four CPU env steps of the port (its rewards from the FK rows of the
    mega step, or from fk / body_velocities) bit-equal to the frozen copy of
    the port's plain path (hgt_ref) from the same seed and actions:
    rewards, observations, privileged observations, episode sums at reset."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark", "reference"))
    try:
        import hgt_ref.registry as rreg
    finally:
        sys.path.pop(0)
    from humanoid_gym_tpu_torch import registry

    def ov(c):
        c.sim.solver.solver_type = solver
        c.sim.solver.solver_iterations = 2

    outs = []
    for reg in (registry, rreg):
        env, _ = reg.make_env(task, num_envs=6, cfg_overrides=ov, device="cpu", seed=11)
        state = env.init_state()
        gen = torch.Generator()
        gen.manual_seed(1)
        seen = []
        for _ in range(4):
            state, tr = env.step(state, torch.randn((6, 12), generator=gen))
            seen += [tr.reward, tr.obs, tr.privileged_obs, tr.ep_term_sums, tr.done]
        outs.append(seen)
    assert all(torch.equal(a, b) for a, b in zip(*outs))

