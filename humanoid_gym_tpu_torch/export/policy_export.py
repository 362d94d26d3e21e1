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

A recurrent policy (`ActorCriticRecurrent`) is exported as `policy_jit.pt`
alone, legged_gym's `PolicyExporterLSTM`: a TorchScript module holding the
actor's LSTM and head, which carries h and c from call to call (one robot,
or a batch of one) and exposes `reset_memory()`. The `.npz` and `.bin`
formats hold MLP layers only.
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


class MemoryPolicyExporter(nn.Module):
    """legged_gym's PolicyExporterLSTM: the actor's LSTM (`memory`) and head
    (`actor`, Linear / ELU) in float32, with the LSTM's h and c as buffers
    (layers, 1, H). `forward(obs)` takes one observation (O,) or a batch of
    one (1, O), steps the memory and returns the action mean; `reset_memory`
    zeroes h and c."""

    def __init__(self, rnn: nn.LSTM, actor: nn.Sequential):
        super().__init__()
        self.memory = rnn
        self.actor = actor
        self.register_buffer("hidden_state", torch.zeros(rnn.num_layers, 1, rnn.hidden_size))
        self.register_buffer("cell_state", torch.zeros(rnn.num_layers, 1, rnn.hidden_size))

    def forward(self, x):
        single = x.dim() == 1
        if single:
            x = x.unsqueeze(0)
        out, (h, c) = self.memory(x.unsqueeze(0), (self.hidden_state, self.cell_state))
        self.hidden_state.copy_(h)
        self.cell_state.copy_(c)
        y = self.actor(out.squeeze(0))
        return y.squeeze(0) if single else y

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state.zero_()
        self.cell_state.zero_()


def _memory_exporter(sd: dict) -> MemoryPolicyExporter:
    """The exporter of a recurrent net's state dict (`memory_a.rnn.*`,
    `actor.layers.<i>.*`), on the CPU in float32."""
    rnn_sd = {k[len("memory_a.rnn."):]: v.float() for k, v in sd.items()
              if k.startswith("memory_a.rnn.")}
    layers = len([k for k in rnn_sd if k.startswith("weight_ih_l")])
    hidden, inputs = rnn_sd["weight_hh_l0"].shape[1], rnn_sd["weight_ih_l0"].shape[1]
    rnn = nn.LSTM(inputs, hidden, layers)
    rnn.load_state_dict(rnn_sd)
    n = len({k.split(".")[2] for k in sd if k.startswith("actor.layers.")})
    mods: List[nn.Module] = []
    for i in range(n):
        w, b = sd[f"actor.layers.{i}.weight"].float(), sd[f"actor.layers.{i}.bias"].float()
        lin = nn.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        mods.append(lin)
        if i < n - 1:
            mods.append(nn.ELU())
    return MemoryPolicyExporter(rnn, nn.Sequential(*mods))


def _export_memory_torchscript(sd: dict, path: str) -> List[str]:
    os.makedirs(path, exist_ok=True)
    f = os.path.join(path, "policy_jit.pt")
    torch.jit.script(_memory_exporter(sd)).save(f)
    return [f]


def export_policy(net, path: str, torchscript: bool = True) -> List[str]:
    """Write <path>/policy.npz, policy.bin and (with `torchscript`)
    policy_jit.pt for the actor of `net`; for a recurrent net policy_jit.pt
    alone (`MemoryPolicyExporter`). Returns the written paths."""
    if getattr(net, "is_recurrent", False):
        return _export_memory_torchscript({k: v.detach().cpu() for k, v in
                                           net.state_dict().items()}, path)
    return _write_artifacts(_actor_layers(net), path, torchscript)


def export_checkpoint(ckpt_path: str, path: str, torchscript: bool = False) -> List[str]:
    """The artifacts of the actor saved in a port checkpoint (the runner's
    `torch.save` file: `train_state.net` holds `actor.layers.<i>.weight`
    (out, in) and `.bias`); returns the written paths."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = payload["train_state"]["net"]
    if "memory_a.rnn.weight_ih_l0" in sd:  # a recurrent net: its TorchScript policy alone
        return _export_memory_torchscript(sd, path)
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
    """A TorchScript actor behind NumpyPolicy's call; `reset()` zeroes the
    memory of a recurrent one (`reset_memory`) and does nothing otherwise."""

    def __init__(self, module):
        super().__init__([])
        self.module = module

    def __call__(self, obs):
        with torch.no_grad():
            return self.module(torch.from_numpy(np.asarray(obs, np.float32))).numpy()

    def reset(self) -> None:
        if hasattr(self.module, "reset_memory"):
            self.module.reset_memory()


def load_policy(path: str) -> NumpyPolicy:
    """Load a policy artifact: `.npz` (this format) or a TorchScript `.pt`."""
    if path.endswith(".npz"):
        data = np.load(path)
        n = int(data["n_layers"])
        return NumpyPolicy([(data[f"W{i}"], data[f"b{i}"]) for i in range(n)])
    module = torch.jit.load(path, map_location="cpu")
    module.eval()
    return _TorchScriptPolicy(module)
