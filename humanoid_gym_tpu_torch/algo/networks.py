"""Actor-critic MLPs as torch.nn.Modules.

Port of humanoid_gym_tpu/algo/networks.py: two independent ELU MLPs —
actor obs -> hidden dims -> num_actions (mean), critic priv_obs -> hidden
dims -> 1 (value) — plus a state-independent learned std kept as a raw
parameter initialised to init_noise_std, and with `estimator_dim > 0` the
DWL-style estimator head: an ELU MLP obs -> estimator_hidden ->
estimator_dim that predicts privileged quantities (the base linear
velocity) from the deployable actor observation (`estimate`).

Mixed precision follows the JAX package's `compute_dtype="auto"`: on the
card the HIDDEN-layer matmuls run in bf16 (float32 master weights, cast per
layer); each MLP's output layer and all distribution math stay float32. On
the CPU everything is float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resolve_compute_dtype(name: str, device: torch.device) -> torch.dtype:
    """'auto' -> bf16 on the card, f32 on the CPU; else the named dtype."""
    if name in (None, "", "auto"):
        return torch.float32 if device.type == "cpu" else torch.bfloat16
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dtype_name(dt: torch.dtype) -> str:
    """'float32' / 'bfloat16': the name a checkpoint records."""
    return str(dt).replace("torch.", "")


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal (+-2 sigma) with
    variance 1/fan_in."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out: int, compute_dtype: str = "auto"):
        super().__init__()
        dims = [in_dim, *hidden, out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in self.layers:
            _lecun_normal_(lin.weight, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = resolve_compute_dtype(self.compute_dtype, x.device)
        for lin in self.layers[:-1]:
            x = F.elu(F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt)))
        last = self.layers[-1]
        # output layer in f32: log-probs and values downstream stay f32
        return F.linear(x.to(torch.float32), last.weight, last.bias)


class ActorCritic(nn.Module):
    def __init__(
        self,
        num_obs: int,
        num_priv: int,
        num_actions: int,
        actor_hidden: Sequence[int] = (512, 256, 128),
        critic_hidden: Sequence[int] = (768, 256, 128),
        init_noise_std: float = 1.0,
        compute_dtype: str = "auto",
        seed: int = 0,
        estimator_dim: int = 0,
        estimator_hidden: Sequence[int] = (256, 128),
    ):
        super().__init__()
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        self.estimator_dim = estimator_dim
        self.actor = MLP(num_obs, actor_hidden, num_actions, compute_dtype)
        self.critic = MLP(num_priv, critic_hidden, 1, compute_dtype)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.actor.reset_parameters(gen)
        self.critic.reset_parameters(gen)
        if estimator_dim > 0:
            self.estimator = MLP(num_obs, estimator_hidden, estimator_dim, compute_dtype)
            self.estimator.reset_parameters(gen)

    def set_compute_dtype(self, name: str) -> None:
        """Switch the hidden-layer compute dtype of every MLP."""
        self.compute_dtype = name
        for mlp in self.children():
            mlp.compute_dtype = name

    def act(self, obs):
        """Policy distribution parameters; the raw std is floored at 1e-3."""
        return self.actor(obs), torch.clamp(self.std, min=1e-3)

    def evaluate(self, priv_obs):
        """State value."""
        return self.critic(priv_obs)[..., 0]

    def estimate(self, obs):
        """Privileged-state estimate from the deployable obs (estimator head)."""
        return self.estimator(obs)


def normal_log_prob(mean, std, x):
    """Diagonal Gaussian log-density, summed over the action axis."""
    var = torch.square(std)
    lp = -0.5 * (torch.square(x - mean) / var + torch.log(2 * math.pi * var))
    return torch.sum(lp, dim=-1)


def normal_entropy(std, batch_shape):
    """Entropy summed over the action axis, broadcast to batch_shape."""
    ent = torch.sum(0.5 * torch.log(2 * math.pi * math.e * torch.square(std)))
    return ent.expand(batch_shape)
