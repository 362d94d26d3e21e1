"""Carry weights and state across from the JAX package's objects.

- `actor_critic_from_flax`: flax `Dense` kernels are (in, out);
  `nn.Linear` weights are (out, in). The std is a plain (num_actions,)
  parameter in both; the estimator head comes across where it exists.
- `actor_critic_from_npz`: an actor-only policy artifact (`W{i}` (in, out),
  `b{i}`, `n_layers`; `export/policy_export.py`, the shipped
  `resources/policies/*.npz`) into the actor of the port's ActorCritic.
- `physics_state_from_jax` / `env_state_from_jax`: a batched JAX
  `PhysicsState` / `EnvState` (any object whose attributes convert with
  `numpy.array`) as the port's dataclasses, leaf for leaf. The JAX
  EnvState's per-env PRNG key has no counterpart and is dropped; the
  terrain fields (level, type, origin) come across with the rest.
- `terrain_map_from_jax`: the JAX package's `TerrainMap` (NumPy arrays and
  floats) as the port's, so both packages can run on one grid.

Nothing here imports JAX: the callers hand over the objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..envs.state import EnvState
from ..physics.step import PhysicsState
from ..terrain.terrain import TerrainMap


def _layers(tree: dict):
    names = sorted(tree, key=lambda k: int(k.split("_")[1]))
    return [tree[k] for k in names]


def actor_critic_from_flax(params_np) -> dict:
    """flax ActorCritic params ({"params": {...}} or the inner dict, numpy
    or jax arrays) -> a state_dict for humanoid_gym_tpu_torch's
    ActorCritic."""
    p = params_np.get("params", params_np)
    sd = {}
    for head in ("actor", "critic", "estimator"):
        for i, layer in enumerate(_layers(p.get(head, {}))):
            k = np.array(layer["kernel"], np.float32)
            sd[f"{head}.layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(k.T))
            sd[f"{head}.layers.{i}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    sd["std"] = torch.from_numpy(np.array(p["std"], np.float32))
    return sd


def actor_critic_from_npz(net, path: str):
    """Load the actor-only `.npz` at `path` into `net.actor` (an
    ActorCritic of the port), in place; the critic, the std and any
    estimator stay as they are. Raises ValueError if the layer count or a
    shape differs from the net's. Returns `net`."""
    data = np.load(path)
    n = int(data["n_layers"])
    layers = net.actor.layers
    if n != len(layers):
        raise ValueError(f"{path}: {n} layers, the actor has {len(layers)}")
    with torch.no_grad():
        for i, lin in enumerate(layers):
            W, b = data[f"W{i}"], data[f"b{i}"]
            if W.shape != tuple(lin.weight.shape[::-1]) or b.shape != tuple(lin.bias.shape):
                raise ValueError(f"{path}: layer {i} is {W.shape}, the actor's "
                                 f"{tuple(lin.weight.shape[::-1])}")
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(W.T, np.float32)))
            lin.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return net


def _leaf(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def physics_state_from_jax(js, device="cpu") -> PhysicsState:
    return PhysicsState(**{f.name: _leaf(getattr(js, f.name), device)
                           for f in dataclasses.fields(PhysicsState)})


def env_state_from_jax(js, device="cpu") -> EnvState:
    kw = {f.name: _leaf(getattr(js, f.name), device)
          for f in dataclasses.fields(EnvState) if f.name != "phys"}
    return EnvState(phys=physics_state_from_jax(js.phys, device), **kw)


def terrain_map_from_jax(tmap) -> TerrainMap:
    """The reference TerrainMap's arrays and scalars, copied."""
    return TerrainMap(**{
        f.name: (np.array(getattr(tmap, f.name)) if isinstance(getattr(tmap, f.name), np.ndarray)
                 else getattr(tmap, f.name))
        for f in dataclasses.fields(TerrainMap)})
