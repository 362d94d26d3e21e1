"""A CPU rehearsal of chip_smoke.py's phase 22 (the flat recipe trained from
scratch on the card, then held to the walk demo's gate), at 8 envs: the
port's train script, the export of its last checkpoint, the JAX package's
loader reading that export, and the gate's roll on an exported `.npz`."""

import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from humanoid_gym_tpu.export.policy_export import load_policy as jax_load_policy
from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg, XBotLCfgPPO
from humanoid_gym_tpu_torch.export import export_checkpoint
from humanoid_gym_tpu_torch.parallel.multihost import stream_seed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
N_ENVS, ITERS = 8, 2


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """scripts/train_torch.py's `train` as phase 22 calls it, at 8 envs for 2
    iterations on the CPU (solver apgd, the recipe's T = 60); the run
    directory and its exported last checkpoint."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from train_torch import train
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    from humanoid_gym_tpu_torch.utils.helpers import get_args

    root = tmp_path_factory.mktemp("phase22")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGT_WANDB", "0")
        train(get_args(["--task", "humanoid_ppo", "--num_envs", str(N_ENVS), "--max_iterations",
                        str(ITERS), "--log_root", str(root / "runs"), "--device", "cpu"]))
    (run_dir,) = glob.glob(str(root / "runs" / "*"))
    written = export_checkpoint(os.path.join(run_dir, f"model_{ITERS}.ckpt"),
                                str(root / "exported"))
    return run_dir, written


def test_train_script_writes_the_run_phase22_reads(trained):
    """The run directory holds what phase 22 checks: one metrics line an
    iteration with finite losses and no non-finite reset, and the runner's
    checkpoints, the final one after the last iteration; the export writes
    policy.npz and policy.bin."""
    run_dir, written = trained
    lines = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [ln["iter"] for ln in lines] == list(range(ITERS))
    assert all(np.isfinite(v) for ln in lines for k, v in ln.items() if k.startswith("Loss/"))
    assert all(ln["Train/nonfinite_resets"] == 0 for ln in lines)
    assert {"Train/mean_reward", "Train/mean_episode_length", "Perf/iter_time"} <= set(lines[0])
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(run_dir, "model_*.ckpt"))) \
        == ["model_0.ckpt", f"model_{ITERS}.ckpt"]
    assert [os.path.basename(p) for p in written] == ["policy.npz", "policy.bin"]


def test_jax_loader_acts_as_the_trained_net(trained):
    """The JAX package's `load_policy` on the export of the trained
    checkpoint gives the trained port net's actor means on 64 seeded
    observations within 1e-6: its float32 output against the trained
    actor evaluated in float64 (the port's float32 forward rounds apart
    from JAX's by about as much again, so the exact function is the
    reference)."""
    run_dir, written = trained
    payload = torch.load(os.path.join(run_dir, f"model_{ITERS}.ckpt"), map_location="cpu",
                         weights_only=True)
    net = actor_critic_from_cfg(XBotLCfg().env, XBotLCfgPPO().policy, seed=0)
    net.load_state_dict(payload["train_state"]["net"])
    assert payload["train_state"]["opt_count"] == ITERS * 2 * 4  # 2 epochs x 4 minibatches
    obs = np.random.default_rng(0).normal(size=(64, 705)).astype(np.float32)
    layers = [(lin.weight.detach().double().numpy(), lin.bias.detach().double().numpy())
              for lin in net.actor.layers]
    want = obs.astype(np.float64)
    for i, (w, b) in enumerate(layers):
        want = want @ w.T + b
        if i < len(layers) - 1:
            want = np.where(want > 0, want, np.expm1(want))  # ELU
    got = jax_load_policy(written[0])(obs)
    assert got.shape == (64, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the net moved from its initial weights (the runner's net_init
    # stream): the export is the trained actor
    init = actor_critic_from_cfg(XBotLCfg().env, XBotLCfgPPO().policy,
                                 seed=stream_seed(5, "net_init"))
    with torch.no_grad():
        assert not np.allclose(init.act(torch.from_numpy(obs))[0].numpy(), want, atol=1e-6)


def test_roll_policy_takes_an_npz_path(trained, smoke):
    """Phase 12 / 22's roll on the exported `.npz`, at 4 envs for 5 policy
    steps through the plain mega step on the CPU: a share of survivors in
    [0, 1] and a finite median distance; the shipped walk demo the same
    way."""
    _, written = trained
    for npz in (written[0], os.path.join(ROOT, "resources", "policies", "xbotl_walk_demo.npz")):
        survived, median = smoke._roll_policy("humanoid_ppo", npz, smoke.WALK_VX, False, "cpu",
                                              n_steps=5, n_envs=4)
        assert 0.0 <= survived <= 1.0 and np.isfinite(median)
