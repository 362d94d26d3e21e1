"""The learning-curve regression check: a seeded short training run held
to the JAX package's bands (tests/test_learning_regression.py:80-90).

`learning_curve` trains `n` XBot-L envs for `iters` iterations of T steps
through `make_train_iter` and returns the metrics the bands read;
`band_misses` lists the bands a curve misses. The bands were pinned on the
JAX package (seed 5, 16 envs, T = 60, 12 iterations: late step reward
0.0132, late episode length 138, value loss 0.066 -> 0.015); each lower
bound sits ~35% under the healthy run and well above a torque-broken one.
The port's random streams are not the JAX package's, so its run is another
draw of the same training. The CPU test runs it with solver apgd, the card
(chip_smoke.py) with solver mega.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algo.networks import actor_critic_from_cfg
from ..algo.ppo import PPOConfig, init_train_state, make_train_iter
from ..config.xbotl import XBotLCfg, XBotLCfgPPO
from ..envs import make_env

LATE_FROM = 4  # iterations from which the late means are taken


def learning_curve(device="cpu", solver="apgd", seed=5, n=16, T=60, iters=12) -> dict:
    """Late step reward, late episode length, the late per-term episode
    means (per reset), the step rewards, episode lengths and value losses
    of every iteration, and the count of non-finite resets."""
    cfg = XBotLCfg()
    cfg.env.num_envs = n
    cfg.sim.solver.solver_type = solver
    tcfg = XBotLCfgPPO()
    env = make_env(cfg, device=device, seed=seed)
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=seed).to(device)
    acfg = PPOConfig.from_cfg(tcfg.algorithm)
    acfg.num_steps_per_env = T
    ts = init_train_state(net, acfg.learning_rate)
    state, obs, priv = env.reset_all()
    train_iter = make_train_iter(env, net, acfg, n, perm_seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    step_rew, ep_len, vloss, nonfinite = [], [], [], 0
    term_sums = np.zeros(env.n_reward_terms)
    late_resets = 0.0
    for it in range(iters):
        ts, state, obs, priv, m = train_iter(ts, state, obs, priv, gen)
        resets = float(m["ep_reset_count"])
        step_rew.append(float(m["mean_step_reward"]))
        ep_len.append(float(m["ep_len_sum"]) / max(resets, 1.0))
        vloss.append(float(m["value_loss"]))
        nonfinite += int(m["nonfinite_resets"])
        if it >= LATE_FROM:
            term_sums += m["ep_term_sums"].double().cpu().numpy()
            late_resets += resets
    return {
        "late_rew": float(np.mean(step_rew[LATE_FROM:])),
        "late_len": float(np.mean(ep_len[LATE_FROM:])),
        "terms": dict(zip(env.reward_names, term_sums / max(late_resets, 1.0))),
        "step_rew": step_rew, "ep_len": ep_len, "vloss": vloss, "nonfinite": nonfinite,
    }


def band_misses(c: dict) -> list:
    """The bands of tests/test_learning_regression.py:80-90 that curve `c`
    misses (empty: inside every band)."""
    v = c["vloss"]
    checks = {
        "late step reward in [0.006, 0.030]": 0.006 <= c["late_rew"] <= 0.030,
        "late episode length in [100, 280]": 100.0 <= c["late_len"] <= 280.0,
        "tracking_lin_vel >= 0.016": c["terms"]["tracking_lin_vel"] >= 0.016,
        "feet_contact_number >= 0.020": c["terms"]["feet_contact_number"] >= 0.020,
        "first value loss > 0.03": v[0] > 0.03,
        "last value loss < 0.035 and < 0.6 x the first": v[-1] < 0.035 and v[-1] < 0.6 * v[0],
        "no non-finite reset": c["nonfinite"] == 0,
        "finite step rewards and value losses": bool(np.all(np.isfinite(c["step_rew"]))
                                                     and np.all(np.isfinite(v))),
    }
    return [name for name, ok in checks.items() if not ok]
