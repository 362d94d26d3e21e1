"""Carry actor-critic weights from the JAX package's flax params.

flax `Dense` kernels are (in, out); `nn.Linear` weights are (out, in). The
std is a plain (num_actions,) parameter in both.
"""

from __future__ import annotations

import numpy as np
import torch


def _layers(tree: dict):
    names = sorted(tree, key=lambda k: int(k.split("_")[1]))
    return [tree[k] for k in names]


def actor_critic_from_flax(params_np) -> dict:
    """flax ActorCritic params ({"params": {...}} or the inner dict, numpy
    or jax arrays) -> a state_dict for humanoid_gym_tpu_torch's
    ActorCritic."""
    p = params_np.get("params", params_np)
    sd = {}
    for head in ("actor", "critic"):
        for i, layer in enumerate(_layers(p[head])):
            k = np.array(layer["kernel"], np.float32)
            sd[f"{head}.layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(k.T))
            sd[f"{head}.layers.{i}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    sd["std"] = torch.from_numpy(np.array(p["std"], np.float32))
    return sd
