"""Carry weights and state across from the JAX package's objects.

- `actor_critic_from_flax`: flax `Dense` kernels are (in, out);
  `nn.Linear` weights are (out, in). The std is a plain (num_actions,)
  parameter in both.
- `physics_state_from_jax` / `env_state_from_jax`: a batched JAX
  `PhysicsState` / `EnvState` (any object whose attributes convert with
  `numpy.array`) as the port's dataclasses, leaf for leaf. The JAX
  EnvState's per-env PRNG key has no counterpart and is dropped.

Nothing here imports JAX: the callers hand over the objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..envs.state import EnvState
from ..physics.step import PhysicsState


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


def _leaf(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def physics_state_from_jax(js, device="cpu") -> PhysicsState:
    return PhysicsState(**{f.name: _leaf(getattr(js, f.name), device)
                           for f in dataclasses.fields(PhysicsState)})


def env_state_from_jax(js, device="cpu") -> EnvState:
    kw = {f.name: _leaf(getattr(js, f.name), device)
          for f in dataclasses.fields(EnvState) if f.name != "phys"}
    return EnvState(phys=physics_state_from_jax(js.phys, device), **kw)
