"""The rollout's rows held to each other: a sound rollout reads 0, a row
written at the wrong index or a done flag that the frames contradict does
not."""

import torch

from benchmark import correct
from benchmark.reference.hgt_ref.algo.networks import normal_log_prob

T, N, F, W, A = 6, 5, 4, 3, 2


def _rollout(seed=0):
    """A rollout stacked as the env stacks its frames: after a done the
    carried frames are zeros."""
    g = torch.Generator().manual_seed(seed)
    dones = torch.zeros(T, N, dtype=torch.bool)
    dones[1, 0] = dones[3, 2] = True
    hist, obs = torch.randn(N, F, W, generator=g), []
    for t in range(T):
        obs.append(hist.reshape(N, -1).clone())
        kept = torch.where(dones[t][:, None, None], torch.zeros_like(hist), hist)
        hist = torch.cat([kept[:, 1:], torch.randn(N, 1, W, generator=g)], 1)
    obs = torch.stack(obs)
    mu = torch.randn(T, N, A, generator=g)
    actions = mu + torch.randn(T, N, A, generator=g)
    std = torch.full((A,), 0.7)
    return {"obs": obs, "priv_obs": obs.clone(), "dones": dones, "mu": mu, "actions": actions,
            "log_probs": normal_log_prob(mu, std, actions)}, std


def test_sound_rows_read_zero():
    roll, std = _rollout()
    assert correct.stack_gap(roll, (F, F)) == 0.0
    assert correct.logp_gap(roll, normal_log_prob(roll["mu"], std, roll["actions"])) == 0.0


def test_a_row_at_the_wrong_index_is_read():
    roll, std = _rollout()
    bad = correct.shifted_rows(roll)
    assert correct.stack_gap(bad, (F, F)) > 0.1
    assert correct.logp_gap(bad, normal_log_prob(bad["mu"], std, bad["actions"])) > 0.1


def test_a_done_flag_the_frames_contradict_is_read():
    roll, _ = _rollout()
    roll["dones"] = roll["dones"].clone()
    roll["dones"][1, 0] = False
    assert correct.stack_gap(roll, (F, F)) > 0.1
