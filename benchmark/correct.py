"""How `correct` is decided: the numbers that hold what the timed path
produced against the plain reference, and their limits.

Every number is a gap between a side under test ("the program": the
program's snapshots, or a reference variant put in its place) and the
reference at the stated precision, both from the same state:

- start_params_gap: the largest |difference| of the initial weights, which
  both make from the seed (exact: limit 0).
- start_obs_gap: relative gap of the first observations of a reset.
- step0_gap, step1_gap, step2_gap: each of the rollout's first env steps,
  env by env: the relative gap of an env's observations, privileged
  observations and reward together, at the 99th percentile over the envs,
  the worst of the followed iterations. (An env whose termination test
  sits on its threshold may end on one side and not the other, and the
  whole batch's gap then follows that one env.)
- stack_gap: every later row of the rollout against the row before it:
  the largest |difference| between the frames that obs[t + 1] (and the
  privileged obs) carry over and the frames of obs[t] shifted by one, or
  zeros where the step ended the episode (done[t]). The frames are copied,
  so the gap is exact.
- logp_gap: the relative gap of the rollout's log-probabilities against
  the actions' log-density under the rollout's means and the policy's std,
  every row.
- nets_gap: relative gap of the actor's means and the critic's values over
  the whole rollout, the worst iteration.
- loss_gap: |loss - reference loss| of each followed iteration's update
  over the reference's scale of the loss (the sum of its terms'
  magnitudes: the terms have both signs and the loss can sit near 0), the
  worst.
- grad_gap: the first iteration's Adam first moments (the clipped gradients
  as the optimizer holds them), by the worst leaf: the gap of the two norms
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger.
- change_gap: each followed iteration's change of the parameters, by the
  same measure, the worst leaf and iteration. Leaves whose reference
  gradient is under a thousandth of the median leaf's move by round-off
  alone and are left out.

A relative gap is ||a - b|| / ||b|| over the whole tensor.
"""

from __future__ import annotations

import math
import statistics

import torch

from .reference.follow import STEPS

NUMBERS = ("start_params_gap", "start_obs_gap") + tuple(f"step{t}_gap" for t in range(STEPS)) + (
    "stack_gap", "logp_gap", "nets_gap", "loss_gap", "grad_gap", "change_gap")
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def per_env_gap(side: dict, ref: dict) -> torch.Tensor:
    """Each env's relative gap of its observations, privileged observations
    and reward together."""
    a = torch.cat([side["obs"], side["priv_obs"], side["reward"][:, None]], 1).double()
    b = torch.cat([ref["obs"], ref["priv_obs"], ref["reward"][:, None]], 1).double()
    return torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1).clamp(
        min=1e-30)


def env_gap(side: dict, ref: dict, q: float = 0.99) -> float:
    """The q-quantile over envs of `per_env_gap`."""
    return float(torch.quantile(per_env_gap(side, ref), q))


def step_outliers(side: dict, ref: dict, over: float = 1e-3) -> list:
    """Per followed iteration and step: (envs whose step gap is over
    `over`, those of them whose done flag differs, the whole batch's
    relative gap), for reading a seed whose step gap stands out."""
    out = []
    for i in ref:
        for a, b in zip(side[i]["steps"], ref[i]["steps"]):
            far = per_env_gap(a, b) > over
            flips = a["done"].bool() != b["done"].bool()
            whole = max(rel(a[k], b[k]) for k in ("obs", "priv_obs", "reward"))
            out.append((int(far.sum()), int((far & flips).sum()), whole))
    return out


def stack_gap(roll: dict, frames: tuple) -> float:
    """The largest |difference| between the frames each later row carries
    over and the row before it shifted by one frame (zeros after a done),
    over the observations and the privileged observations."""
    worst = 0.0
    done = roll["dones"].bool()
    for key, f in zip(("obs", "priv_obs"), frames):
        x = roll[key]
        T, n, width = x.shape
        x = x.reshape(T, n, f, width // f)
        for t in range(T - 1):
            carried = torch.where(done[t][:, None, None], torch.zeros_like(x[t, :, 1:]),
                                  x[t, :, 1:])
            worst = max(worst, float((x[t + 1, :, :-1] - carried).abs().max()))
    return worst


def logp_gap(roll: dict, ref_logp: torch.Tensor) -> float:
    return rel(roll["log_probs"], ref_logp)


def shifted_rows(roll: dict) -> dict:
    """The rollout with a row written at the wrong index: from row 2 on,
    each of obs, privileged obs and actions holds the row after its own (a
    fault that the reference's steps, which read rows 0-2, do not see)."""
    out = dict(roll)
    for k in ("obs", "priv_obs", "actions"):
        x = roll[k]
        out[k] = torch.cat([x[:2], x[3:], x[-1:]])
    return out


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |‖got‖ - ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = statistics.median(norms.values())
    worst = 0.0
    for k, r in norms.items():
        if keep is not None and k not in keep:
            continue
        g = float(torch.linalg.vector_norm(got[k].double()))
        worst = max(worst, abs(g - r) / max(r, med, 1e-30))
    return worst


def moving_leaves(ref_mu: dict) -> set:
    """The leaves whose reference gradient (its Adam first moment) is at
    least STILL of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_mu.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= STILL * med}


def change(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def gaps(side: dict, ref: dict, snaps: dict, start: dict | None, ref_start: dict | None) -> dict:
    """The numbers of one side against the reference. `side` and `ref` map
    each followed iteration to {"step", "nets", "update"} outputs; `snaps`
    holds the states they started from."""
    out = {}
    if start is not None:
        out["start_params_gap"] = max(float((start["params"][k] - v).abs().max())
                                      for k, v in ref_start["params"].items())
        out["start_obs_gap"] = max(rel(start["obs"], ref_start["obs"]),
                                   rel(start["priv_obs"], ref_start["priv_obs"]))
    for t in range(STEPS):
        out[f"step{t}_gap"] = max(env_gap(side[i]["steps"][t], ref[i]["steps"][t]) for i in ref)
    if "rows" in side[0]:
        out["stack_gap"] = max(side[i]["rows"]["stack_gap"] for i in ref)
        out["logp_gap"] = max(side[i]["rows"]["logp_gap"] for i in ref)
    out["nets_gap"] = max(max(rel(side[i]["nets"][k], ref[i]["nets"][k]) for k in ("mu", "values"))
                          for i in ref)
    out["loss_gap"] = max(abs(side[i]["update"]["loss"] - ref[i]["update"]["loss"])
                          / max(ref[i]["update"]["loss_scale"], 1e-30) for i in ref)
    out["grad_gap"] = leaf_gap(side[0]["update"]["opt_mu"], ref[0]["update"]["opt_mu"])
    worst = 0.0
    for i in ref:
        keep = moving_leaves(ref[i]["update"]["opt_mu"])
        before = snaps[i]["params"]
        worst = max(worst, leaf_gap(change(side[i]["update"]["params"], before),
                                    change(ref[i]["update"]["params"], before), keep))
    out["change_gap"] = worst
    return out


def rows(ref, snap: dict, roll: dict) -> dict:
    """The rollout's rows held to each other: `stack_gap` and `logp_gap`."""
    return {"stack_gap": stack_gap(roll, ref.frames()),
            "logp_gap": logp_gap(roll, ref.log_probs(snap["params"], roll))}


def program_outputs(snaps: dict, ref) -> dict:
    """What the timed path produced in each followed iteration, in the
    reference's output layout: the rollout's observations and rewards of
    its first steps, its means and values, the iteration's losses, Adam
    first moments and parameters after; and its rows held to each other."""
    out = {}
    for i, s in snaps.items():
        roll = s["rollout"]
        m = s["metrics"]
        terms = {k: float(m[k]) for k in ("surrogate_loss", "value_loss", "entropy",
                                          "estimator_loss")}
        out[i] = {
            "steps": [{"obs": roll["obs"][t + 1], "priv_obs": roll["priv_obs"][t + 1],
                       "reward": roll["rewards"][t], "done": roll["dones"][t]}
                      for t in range(STEPS)],
            "nets": {"mu": roll["mu"], "values": roll["values"]},
            "update": {"loss": ref.total_loss(terms), "opt_mu": s["opt_mu_after"],
                       "params": s["params_after"]},
            "rows": rows(ref, s, roll),
        }
    return out


def reference_outputs(ref, snaps: dict, variant: str) -> dict:
    """The reference's outputs (or a variant's) from each snapshot."""
    return {i: {"steps": ref.steps(s, variant), "nets": ref.nets(s, variant),
                "update": ref.update(s, variant)} for i, s in snaps.items()}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number finite and within
    its limit. A limit given as null marks a number the cell does not
    compare (it has no reading that a fault or the control gives, so it
    could only fail sound runs); it is printed, not judged. A number the
    cell's limits do not name fails."""
    rows = [(k, numbers[k], limits.get(k, "missing")) for k in NUMBERS if k in numbers]
    ok = all(lim is None or (lim != "missing" and math.isfinite(v) and v <= lim)
             for _, v, lim in rows)
    return ok, rows
