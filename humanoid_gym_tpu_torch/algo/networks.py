"""Actor-critic MLPs as torch.nn.Modules.

Port of humanoid_gym_tpu/algo/networks.py: two independent ELU MLPs —
actor obs -> hidden dims -> num_actions (mean), critic priv_obs -> hidden
dims -> 1 (value) — plus a state-independent learned std kept as a raw
parameter initialised to init_noise_std, and with `estimator_dim > 0` the
DWL-style estimator head: an ELU MLP obs -> estimator_hidden ->
estimator_dim that predicts privileged quantities (the base linear
velocity) from the deployable actor observation (`estimate`).

`ActorCriticRecurrent` is rsl_rl's recurrent actor-critic
(rsl_rl/modules/actor_critic_recurrent.py): an LSTM memory on the actor's
input and another on the critic's (`memory_a`, `memory_c`, each holding
nn.LSTM's parameters under nn.LSTM's names in `.rnn`), ELU MLP heads that
read the memories' output, and the same learned std. The port steps the
LSTMs itself (`lstm_scan`): one step a rollout step, and in the update a
scan over the rollout's rows whose state is zeroed after each done, which
computes what rsl_rl's split-and-pad of the rows into trajectories does, at
static shapes. `actor_critic_from_cfg` builds either, by the runner's
`policy_class_name`.

Mixed precision follows the JAX package's `compute_dtype="auto"`: on the
card the HIDDEN-layer matmuls run in bf16 (float32 master weights, cast per
layer); each MLP's output layer and all distribution math stay float32. On
the CPU everything is float32. In the recurrent net the LSTM's gate matmuls
(input and recurrent weights) are the hidden matmuls; h, c, the biases and
the gate nonlinearities stay float32.
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


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class Memory(nn.Module):
    """rsl_rl's `Memory` with an LSTM: the parameters of an `nn.LSTM`
    (input_size, hidden_size, num_layers) under its names in `self.rnn`
    (`weight_ih_l{k}` (4H, in), `weight_hh_l{k}` (4H, H), `bias_ih_l{k}`,
    `bias_hh_l{k}` (4H,); gates in the order i, f, g, o), so a state dict
    moves between the two. `lstm_scan` steps it."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        shapes = []
        for k in range(num_layers):
            fan = input_size if k == 0 else hidden_size
            shapes += [(f"weight_ih_l{k}", (4 * hidden_size, fan)),
                       (f"weight_hh_l{k}", (4 * hidden_size, hidden_size)),
                       (f"bias_ih_l{k}", (4 * hidden_size,)), (f"bias_hh_l{k}", (4 * hidden_size,))]
        # (name, parameter) pairs keep nn.LSTM's order (a dict would be sorted)
        self.rnn = nn.ParameterDict([(k, nn.Parameter(torch.empty(v))) for k, v in shapes])

    def reset_parameters(self, gen: torch.Generator) -> None:
        """nn.LSTM's init: every parameter uniform in +-1/sqrt(H), in
        nn.LSTM's order."""
        for p in self.rnn.values():
            _uniform_(p, 1.0 / math.sqrt(self.hidden_size), gen)


def _input_gates(mem: Memory, x: torch.Tensor, layer: int, dt: torch.dtype) -> torch.Tensor:
    """x W_ih^T (in `dt`) + b_ih + b_hh, float32: the gates' input part."""
    p = mem.rnn
    gx = F.linear(x.to(dt), p[f"weight_ih_l{layer}"].to(dt)).to(torch.float32)
    return gx + (p[f"bias_ih_l{layer}"] + p[f"bias_hh_l{layer}"])


def lstm_scan(mems, xs, state, dones=None, dtype: torch.dtype = torch.float32):
    """T steps of the LSTMs `mems` (Memory modules of one hidden size and
    depth), stepped together: `xs[i]` (T, B, in_i) are the inputs of
    `mems[i]`, `state[i]` = (h, c), each (L, B, H) float32, its state before
    the first step, and where `dones[t]` ((T, B) bool, or None) holds, h
    and c are zeroed after step t (rsl_rl's `reset(dones)`). The gate
    matmuls run in `dtype`, the rest in float32. Returns (outs, state):
    `outs[i]` (T, B, H), the last layer's h at each step (before any
    zeroing), and the state after the last step (zeroed where dones[-1])."""
    T = xs[0].shape[0]
    keep = None if dones is None else (~dones).to(torch.float32)[..., None]
    inputs = list(xs)
    final = []
    for layer in range(mems[0].num_layers):
        # one tensor a step: a slice a step of one tensor would make autograd
        # add a whole-size gradient for each step
        gx = torch.stack([_input_gates(m, x, layer, dtype) for m, x in zip(mems, inputs)],
                         1).unbind(0)
        w_hh = torch.stack([m.rnn[f"weight_hh_l{layer}"] for m in mems]).to(dtype).transpose(1, 2)
        h = torch.stack([s[0][layer] for s in state])
        c = torch.stack([s[1][layer] for s in state])
        outs = []
        for t in range(T):
            i, f, g, o = (gx[t] + torch.bmm(h.to(dtype), w_hh).to(torch.float32)).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
            if keep is not None:
                h, c = h * keep[t], c * keep[t]
        final.append((h, c))
        out = torch.stack(outs, 1)
        inputs = list(out.unbind(0))
    state = [(torch.stack([hc[0][i] for hc in final]), torch.stack([hc[1][i] for hc in final]))
             for i in range(len(mems))]
    return inputs, state


class ActorCriticRecurrent(nn.Module):
    """rsl_rl's ActorCriticRecurrent with an LSTM (module docstring): the
    memories `memory_a` (obs) and `memory_c` (privileged obs), the heads
    `actor` (H -> actor_hidden -> num_actions) and `critic` (H ->
    critic_hidden -> 1), `std`. Weights as rsl_rl's modules make them
    (nn.LSTM's and nn.Linear's default init), drawn from a generator seeded
    `seed` in the order memory_a, memory_c, actor, critic.

    Its state, the memories' (h, c), is the caller's: a flat tuple (h_a,
    c_a, h_c, c_c), each (num_layers, envs, H) float32 (`initial_memory`).
    `memory_steps` steps both memories over T rows (with dones, the masked
    scan of the update), `heads` reads their outputs."""

    is_recurrent = True

    def __init__(self, num_obs: int, num_priv: int, num_actions: int,
                 actor_hidden: Sequence[int] = (256, 256, 256),
                 critic_hidden: Sequence[int] = (256, 256, 256), init_noise_std: float = 1.0,
                 rnn_type: str = "lstm", rnn_hidden_size: int = 256, rnn_num_layers: int = 1,
                 compute_dtype: str = "auto", seed: int = 0):
        super().__init__()
        if rnn_type.lower() != "lstm":
            raise ValueError(f"rnn_type {rnn_type!r}: the port's recurrent policy is an LSTM")
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        self.memory_a = Memory(num_obs, rnn_hidden_size, rnn_num_layers)
        self.memory_c = Memory(num_priv, rnn_hidden_size, rnn_num_layers)
        self.actor = MLP(rnn_hidden_size, actor_hidden, num_actions, compute_dtype)
        self.critic = MLP(rnn_hidden_size, critic_hidden, 1, compute_dtype)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.memory_a.reset_parameters(gen)
        self.memory_c.reset_parameters(gen)
        for mlp in (self.actor, self.critic):
            for lin in mlp.layers:
                bound = 1.0 / math.sqrt(lin.weight.shape[1])
                _uniform_(lin.weight, bound, gen)
                _uniform_(lin.bias, bound, gen)

    def set_compute_dtype(self, name: str) -> None:
        """Switch the compute dtype of the gate and hidden-layer matmuls."""
        self.compute_dtype = name
        self.actor.compute_dtype = self.critic.compute_dtype = name

    def initial_memory(self, num_envs: int, device) -> tuple:
        """Zero (h_a, c_a, h_c, c_c) for `num_envs` envs."""
        shape = (self.memory_a.num_layers, num_envs, self.memory_a.hidden_size)
        return tuple(torch.zeros(shape, device=device) for _ in range(4))

    def memory_steps(self, obs, priv_obs, memory, dones=None):
        """Both memories over T rows: obs (T, B, O), priv_obs (T, B, P),
        `memory` the flat state before the first row, `dones` (T, B) or
        None (`lstm_scan`) -> (out_a, out_c, memory after the last row)."""
        dt = resolve_compute_dtype(self.compute_dtype, obs.device)
        (out_a, out_c), ((h_a, c_a), (h_c, c_c)) = lstm_scan(
            [self.memory_a, self.memory_c], [obs, priv_obs],
            [memory[:2], memory[2:]], dones, dt)
        return out_a, out_c, (h_a, c_a, h_c, c_c)

    def heads(self, out_a, out_c):
        """(mean, std, value) from the memories' outputs; the raw std is
        floored at 1e-3, as ActorCritic.act does."""
        return self.actor(out_a), torch.clamp(self.std, min=1e-3), self.critic(out_c)[..., 0]


def reset_memory(memory: tuple, dones: torch.Tensor) -> tuple:
    """The flat memory state with h and c zeroed for the envs that are done
    (rsl_rl's `Memory.reset`)."""
    keep = (~dones).to(torch.float32)[:, None]
    return tuple(m * keep for m in memory)


class MemoryPolicy:
    """The deterministic policy of a recurrent net with its actor memory:
    obs (envs, O) -> action mean, the memory carried from call to call
    (zeros at the first, sized by its envs), as rsl_rl's `act_inference`;
    `reset(dones)` zeroes the memory of the envs that are done (all, with
    no argument)."""

    def __init__(self, net: ActorCriticRecurrent):
        self.net = net
        self.state = None

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        if self.state is None or self.state[0][0].shape[0] != obs.shape[0]:
            self.state = self.net.initial_memory(obs.shape[0], obs.device)[:2]
        dt = resolve_compute_dtype(self.net.compute_dtype, obs.device)
        (out,), (self.state,) = lstm_scan([self.net.memory_a], [obs[None]], [self.state], None, dt)
        return self.net.actor(out[0])

    def reset(self, dones=None) -> None:
        if self.state is not None:
            self.state = (tuple(torch.zeros_like(s) for s in self.state) if dones is None
                          else reset_memory(self.state, dones))


POLICY_CLASSES = ("ActorCritic", "ActorCriticRecurrent")


def actor_critic_from_cfg(env_cfg, policy_cfg, seed: int = 0, compute_dtype=None,
                          class_name: str = "ActorCritic"):
    """The recipe's policy, by the runner's `policy_class_name`
    (`class_name`): the widths of `env_cfg` (a config's `.env`) and the nets
    of `policy_cfg` (a train config's `.policy`): hidden dims, noise std,
    compute dtype (unless `compute_dtype` is given) and the estimator head
    (ActorCritic), or the memory's `rnn_type`, `rnn_hidden_size` and
    `rnn_num_layers` (ActorCriticRecurrent). On the CPU; the caller moves
    it."""
    if class_name not in POLICY_CLASSES:
        raise ValueError(f"policy_class_name {class_name!r}; the port has {POLICY_CLASSES}")
    if class_name == "ActorCriticRecurrent":
        return ActorCriticRecurrent(
            env_cfg.num_observations, env_cfg.num_privileged_obs, env_cfg.num_actions,
            actor_hidden=tuple(policy_cfg.actor_hidden_dims),
            critic_hidden=tuple(policy_cfg.critic_hidden_dims),
            init_noise_std=policy_cfg.init_noise_std, rnn_type=policy_cfg.rnn_type,
            rnn_hidden_size=policy_cfg.rnn_hidden_size, rnn_num_layers=policy_cfg.rnn_num_layers,
            compute_dtype=compute_dtype or getattr(policy_cfg, "compute_dtype", "auto"), seed=seed)
    return ActorCritic(
        env_cfg.num_observations, env_cfg.num_privileged_obs, env_cfg.num_actions,
        actor_hidden=tuple(policy_cfg.actor_hidden_dims),
        critic_hidden=tuple(policy_cfg.critic_hidden_dims),
        init_noise_std=policy_cfg.init_noise_std,
        compute_dtype=compute_dtype or getattr(policy_cfg, "compute_dtype", "auto"),
        seed=seed,
        estimator_dim=getattr(policy_cfg, "estimator_dim", 0),
        estimator_hidden=tuple(getattr(policy_cfg, "estimator_hidden_dims", (256, 128))),
    )


def normal_log_prob(mean, std, x):
    """Diagonal Gaussian log-density, summed over the action axis."""
    var = torch.square(std)
    lp = -0.5 * (torch.square(x - mean) / var + torch.log(2 * math.pi * var))
    return torch.sum(lp, dim=-1)


def normal_entropy(std, batch_shape):
    """Entropy summed over the action axis, broadcast to batch_shape."""
    ent = torch.sum(0.5 * torch.log(2 * math.pi * math.e * torch.square(std)))
    return ent.expand(batch_shape)
