"""Policy export: the port's ActorCritic -> deployment artifacts.

Port of humanoid_gym_tpu/export/policy_export.py, with the same three
artifacts in the same formats, so that the JAX package's tools
(`export/sim2sim.py`, `export/native_eval.py`, `native/`) read the port's:
- `policy.npz`: `W{i}` (in, out) float32, `b{i}`, `n_layers` (int64);
- `policy.bin`: "HGTP", int32 n_layers, then per layer int32 (in, out),
  row-major float32 W, float32 b (the native evaluator's format);
- `policy_jit.pt`: a TorchScript `nn.Sequential` of Linear / ELU layers,
  the layout of the reference's deployment loader.
`NumpyPolicy` is the framework-free actor: obs -> deterministic action mean.
`export_checkpoint` writes the same artifacts from a port checkpoint
(`model_N.ckpt`) without building a net.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
from torch import nn


class NumpyPolicy:
    """Actor MLP in NumPy: obs (705,) -> action (12,)."""

    def __init__(self, weights: List[Tuple[np.ndarray, np.ndarray]]):
        self.weights = weights  # [(W, b), ...] with W shaped (in, out)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, np.float32)
        n = len(self.weights)
        for i, (W, b) in enumerate(self.weights):
            x = x @ W + b
            if i < n - 1:
                x = np.where(x > 0, x, np.expm1(x))  # ELU
        return x


def _actor_layers(net) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(W (in, out), b) float32 of each actor layer of the port's ActorCritic."""
    return [(np.ascontiguousarray(lin.weight.detach().cpu().numpy().T, np.float32),
             np.ascontiguousarray(lin.bias.detach().cpu().numpy(), np.float32))
            for lin in net.actor.layers]


def export_policy(net, path: str, torchscript: bool = True) -> List[str]:
    """Write <path>/policy.npz, policy.bin and (with `torchscript`)
    policy_jit.pt for the actor of `net`; returns the written paths."""
    return _write_artifacts(_actor_layers(net), path, torchscript)


def export_checkpoint(ckpt_path: str, path: str, torchscript: bool = False) -> List[str]:
    """The artifacts of the actor saved in a port checkpoint (the runner's
    `torch.save` file: `train_state.net` holds `actor.layers.<i>.weight`
    (out, in) and `.bias`); returns the written paths."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = payload["train_state"]["net"]
    n = len({k.split(".")[2] for k in sd if k.startswith("actor.layers.")})
    if n == 0:
        raise ValueError(f"{ckpt_path}: no actor layers in the checkpoint's net")
    layers = [(np.ascontiguousarray(sd[f"actor.layers.{i}.weight"].float().numpy().T),
               np.ascontiguousarray(sd[f"actor.layers.{i}.bias"].float().numpy()))
              for i in range(n)]
    return _write_artifacts(layers, path, torchscript)


def _write_artifacts(layers, path: str, torchscript: bool) -> List[str]:
    os.makedirs(path, exist_ok=True)
    npz = {}
    for i, (W, b) in enumerate(layers):
        npz[f"W{i}"] = W
        npz[f"b{i}"] = b
    npz["n_layers"] = np.asarray(len(layers))
    f_npz = os.path.join(path, "policy.npz")
    np.savez(f_npz, **npz)
    written = [f_npz]

    f_bin = os.path.join(path, "policy.bin")
    with open(f_bin, "wb") as f:
        f.write(b"HGTP")
        f.write(np.asarray([len(layers)], np.int32).tobytes())
        for W, b in layers:
            f.write(np.asarray(W.shape, np.int32).tobytes())
            f.write(W.tobytes())
            f.write(b.tobytes())
    written.append(f_bin)

    if torchscript:
        written.append(_export_torchscript(layers, path))
    return written


def _export_torchscript(layers, path: str) -> str:
    mods: List[nn.Module] = []
    for i, (W, b) in enumerate(layers):
        lin = nn.Linear(W.shape[0], W.shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(W.T)))
            lin.bias.copy_(torch.from_numpy(b.copy()))
        mods.append(lin)
        if i < len(layers) - 1:
            mods.append(nn.ELU())
    f = os.path.join(path, "policy_jit.pt")
    torch.jit.script(nn.Sequential(*mods)).save(f)
    return f


class _TorchScriptPolicy(NumpyPolicy):
    """A TorchScript actor behind NumpyPolicy's call."""

    def __init__(self, module):
        super().__init__([])
        self.module = module

    def __call__(self, obs):
        with torch.no_grad():
            return self.module(torch.from_numpy(np.asarray(obs, np.float32))).numpy()


def load_policy(path: str) -> NumpyPolicy:
    """Load a policy artifact: `.npz` (this format) or a TorchScript `.pt`."""
    if path.endswith(".npz"):
        data = np.load(path)
        n = int(data["n_layers"])
        return NumpyPolicy([(data[f"W{i}"], data[f"b{i}"]) for i in range(n)])
    module = torch.jit.load(path, map_location="cpu")
    module.eval()
    return _TorchScriptPolicy(module)
