"""Minimal custom training loop against the port's library API (no runner);
the counterpart of examples/minimal_train_loop.py.

The three layers a framework user composes:
  env   = make_env(cfg)                   # batched step / reset on a device
  net   = ActorCritic(...)                # policy and value MLPs (nn.Module)
  iter  = make_train_iter(env, net, ...)  # one PPO iteration

On the card (the default) every env step is one launch of the CUDA mega
kernel (solver mega); `--device cpu` runs the plain versions (solver apgd).

    python examples/minimal_train_loop_torch.py [--num-envs 8] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(num_envs=8, iterations=3, horizon=8, device="cuda"):
    """Train `iterations` iterations; returns the per-iteration metrics and
    the deterministic action of the first env."""
    import torch

    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    cfg = XBotLCfg()
    cfg.env.num_envs = num_envs
    cfg.sim.solver.solver_type = "mega" if device.type == "cuda" else "apgd"

    env = make_env(cfg, num_envs=num_envs, device=device, seed=0)
    net = ActorCritic(cfg.env.num_observations, cfg.env.num_privileged_obs,
                      cfg.env.num_actions, seed=0).to(device)
    algo = PPOConfig()
    algo.num_steps_per_env = horizon

    ts = init_train_state(net, algo.learning_rate)
    state, obs, priv = env.reset_all()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    train_iter = make_train_iter(env, net, algo, num_envs)
    history = []
    for i in range(iterations):
        ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        history.append({k: float(metrics[k]) for k in ("mean_step_reward", "value_loss")})
        print(f"iter {i}: step reward {history[-1]['mean_step_reward']:.4f} "
              f"value loss {history[-1]['value_loss']:.4f}")

    # deterministic policy for deployment: the mean action
    with torch.no_grad():
        action = ts.net.act(obs[:1])[0]
    print("action sample:", action[0, :4].cpu().numpy())
    return history, action


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-envs", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args()
    main(a.num_envs, a.iterations, a.horizon, a.device)
