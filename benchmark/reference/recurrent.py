"""The plain reference of the recurrent actor-critic: rsl_rl's
ActorCriticRecurrent with an LSTM (https://github.com/leggedrobotics/rsl_rl
`rsl_rl/modules/actor_critic_recurrent.py`), its rollout storage and its
recurrent minibatches (`rsl_rl/storage/rollout_storage.py`
`reccurent_mini_batch_generator`, `rsl_rl/utils/utils.py`
`split_and_pad_trajectories` / `unpad_trajectories`), written as rsl_rl
writes them, in float32 with TF32 off, on the frozen copy's env
(`hgt_ref`). It judges configurations whose file names `"reference":
"recurrent"` and keeps `follow.py`'s contract (`STEPS`, the `Reference`
methods and the variants "stated", "control" and "half"); the env's
steps, the stacked frames and the loss's scale are `follow.Reference`'s.

- The nets: `Memory` (one `nn.LSTM`; in inference mode it keeps the state
  it returns, `reset(dones)` zeroes it where envs are done) on the obs and
  on the privileged obs, ELU heads, a learned std. The weights are drawn
  as the program's policy draws them (nn.LSTM's and nn.Linear's default
  init from one generator seeded by the run's `net_init` stream, in the
  order memory_a, memory_c, actor, critic), so `start_params_gap` holds
  both to 0.
- The memory it starts each followed iteration from is its own: zeros
  before the run's first iteration (iteration 0), and after that the state
  its own rollout of the iteration before left, the last value's step
  included. A program that carries a wrong state, zeroes it at an
  iteration's start or skips the last value's step departs from it in the
  next iteration's `nets` and `update`. (So the iterations are followed in
  order, as `correct.reference_outputs` does.)
- `nets`: the means and values at every row of the program's rollout, as
  rsl_rl's rollout computes them: one inference-mode step of each memory a
  row, from the start memory above, the memory zeroed after each done;
  then the last value, the critic's memory stepped once more on the last
  privileged obs (it keeps that state, as `compute_returns` does), whose
  state the next iteration starts from.
- `update`: rsl_rl's storage of the same rollout (the hidden states saved
  before each row), the last value as above, GAE, the envs in
  the order of the iteration's permutation, and for each minibatch of env
  rows the trajectories split at the dones and padded, each LSTM run over
  them from the hidden states saved at each trajectory's first row, the
  outputs unpadded, and the port's PPO loss and Adam step over the rows.

Variants: "control" runs the gate and hidden-layer matmuls in float8 (e4m3,
one scale a tensor: the nearest precision below the configuration's bf16)
and lets float32 matmuls run in TF32; "half" leaves half of each
minibatch's env rows out. The planted faults `FAULTS`, put in the
program's place by `benchmark/calibrate_faults.py`: "no_reset" never
zeroes the memory at a done (the rows are one trajectory each),
"zero_start" starts each rollout from a zero memory instead of the one
carried over.

`net_flops` counts the nets' matmul FLOPs of an iteration for
`census.iteration_least_s` (`mfu`); `bptt_work` and
`bptt_least_s` count the work of the update's scans (stage `update.bptt`)
for `bptt_roofline`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from . import follow
from .hgt_ref.algo import networks
from .hgt_ref.algo.ppo import TrainState, _adam_step, gae, permutation_seed
from .hgt_ref.parallel.multihost import stream_seed

STEPS = follow.STEPS
# the env of the configuration: XBotLCfg whole, the frozen copy's flat task
ENV_TASK = "humanoid_ppo"
FAULTS = ("no_reset", "zero_start")
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# float32 operations of an LSTM cell's forward elementwise work per hidden
# unit and row: three sigmoids and two tanh (4 each), c = f c + i g (3),
# h = o tanh(c) (1), the two gate sums (2 per gate: 8); the backward counts
# twice that
CELL_OPS = 3 * 4 + 2 * 4 + 3 + 1 + 8


def split_and_pad_trajectories(tensor: torch.Tensor, dones: torch.Tensor):
    """rsl_rl's: the (T, N, ...) `tensor` split at the dones (T, N) into
    trajectories, env by env, each padded with zeros to T rows -> (padded
    (T, trajectories, ...), masks (T, trajectories) bool)."""
    dones = dones.clone()
    dones[-1] = 1
    flat_dones = dones.transpose(1, 0).reshape(-1, 1)
    done_indices = torch.cat((flat_dones.new_tensor([-1], dtype=torch.int64),
                              flat_dones.nonzero()[:, 0]))
    trajectory_lengths = done_indices[1:] - done_indices[:-1]
    trajectories = torch.split(tensor.transpose(1, 0).flatten(0, 1),
                               trajectory_lengths.tolist())
    # at least one full-length trajectory, so every padded tensor has T rows
    trajectories = trajectories + (torch.zeros(tensor.shape[0], *tensor.shape[2:],
                                               device=tensor.device, dtype=tensor.dtype),)
    padded = torch.nn.utils.rnn.pad_sequence(trajectories)[:, :-1]
    masks = trajectory_lengths > torch.arange(0, tensor.shape[0], device=tensor.device)[:, None]
    return padded, masks


def unpad_trajectories(trajectories: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """rsl_rl's inverse of `split_and_pad_trajectories`: (T, envs, ...)."""
    return trajectories.transpose(1, 0)[masks.transpose(1, 0)].view(
        -1, trajectories.shape[0], trajectories.shape[-1]).transpose(1, 0)


def _fp8_lstm(rnn: nn.LSTM, x: torch.Tensor, hc):
    """`rnn(x, hc)` with its gate matmuls in float8 (the control): the same
    equations step by step, operands rounded by `follow._fp8`."""
    h0, c0 = hc
    H = rnn.hidden_size
    hs, cs = [], []
    for k in range(rnn.num_layers):
        w_ih, w_hh = getattr(rnn, f"weight_ih_l{k}"), getattr(rnn, f"weight_hh_l{k}")
        b = getattr(rnn, f"bias_ih_l{k}") + getattr(rnn, f"bias_hh_l{k}")
        gx = (follow._fp8(x) @ follow._fp8(w_ih).T) + b
        h, c = h0[k], c0[k]
        outs = []
        for t in range(x.shape[0]):
            g = gx[t] + follow._fp8(h) @ follow._fp8(w_hh).T
            i, f, gg, o = g.split(H, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs)
        hs.append(h)
        cs.append(c)
    return x, (torch.stack(hs), torch.stack(cs))


class Memory(nn.Module):
    """rsl_rl's Memory with an LSTM."""

    fp8 = False  # the control's gate matmuls (`precision`)

    def __init__(self, input_size: int, num_layers: int, hidden_size: int):
        super().__init__()
        self.rnn = nn.LSTM(input_size=input_size, hidden_size=hidden_size, num_layers=num_layers)
        self.hidden_states = None

    def _rnn(self, x, hc):
        return _fp8_lstm(self.rnn, x, hc) if Memory.fp8 else self.rnn(x, hc)

    def forward(self, input, masks=None, hidden_states=None):
        if masks is not None:  # batch mode (policy update): the saved hidden states
            out, _ = self._rnn(input, hidden_states)
            return unpad_trajectories(out, masks)
        # inference mode (collection): the state of the last step, kept
        out, self.hidden_states = self._rnn(input.unsqueeze(0), self.hidden_states)
        return out

    def reset(self, dones):
        for hidden_state in self.hidden_states:
            hidden_state[..., dones, :] = 0.0


class ActorCriticRecurrent(nn.Module):
    """rsl_rl's ActorCriticRecurrent: memories, ELU heads (the frozen
    copy's MLP in float32), std."""

    def __init__(self, num_obs, num_priv, num_actions, actor_hidden, critic_hidden,
                 init_noise_std, rnn_hidden_size, rnn_num_layers, seed):
        super().__init__()
        self.memory_a = Memory(num_obs, rnn_num_layers, rnn_hidden_size)
        self.memory_c = Memory(num_priv, rnn_num_layers, rnn_hidden_size)
        self.actor = networks.MLP(rnn_hidden_size, actor_hidden, num_actions, "float32")
        self.critic = networks.MLP(rnn_hidden_size, critic_hidden, 1, "float32")
        self.std = nn.Parameter(init_noise_std * torch.ones(num_actions))
        gen = torch.Generator()
        gen.manual_seed(seed)
        with torch.no_grad():
            for mem in (self.memory_a, self.memory_c):
                for p in mem.rnn.parameters():
                    p.uniform_(-1.0 / math.sqrt(rnn_hidden_size), 1.0 / math.sqrt(rnn_hidden_size),
                               generator=gen)
            for mlp in (self.actor, self.critic):
                for lin in mlp.layers:
                    bound = 1.0 / math.sqrt(lin.weight.shape[1])
                    lin.weight.uniform_(-bound, bound, generator=gen)
                    lin.bias.uniform_(-bound, bound, generator=gen)

    def act(self, obs, masks=None, hidden_states=None):
        """The action mean (the memory's output through the actor head)."""
        return self.actor(self.memory_a(obs, masks, hidden_states).squeeze(0))

    def evaluate(self, priv_obs, masks=None, hidden_states=None):
        return self.critic(self.memory_c(priv_obs, masks, hidden_states).squeeze(0))[..., 0]

    def get_hidden_states(self):
        return self.memory_a.hidden_states, self.memory_c.hidden_states

    def set_hidden_states(self, memory):
        """rsl_rl's state from the program's flat (h_a, c_a, h_c, c_c)."""
        self.memory_a.hidden_states = (memory[0].clone(), memory[1].clone())
        self.memory_c.hidden_states = (memory[2].clone(), memory[3].clone())

    def reset(self, dones):
        self.memory_a.reset(dones)
        self.memory_c.reset(dones)


@contextlib.contextmanager
def precision(variant: str):
    """`follow.precision`, and in the control the memories' gate matmuls in
    float8."""
    with follow.precision(variant):
        Memory.fp8 = variant == "control"
        try:
            yield
        finally:
            Memory.fp8 = False


def _clone_states(states):
    return tuple(s.clone() for s in states)


class Reference(follow.Reference):
    """`follow.Reference` on the configuration's env with rsl_rl's
    recurrent nets and update (module docstring)."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, steps_per_env: int):
        super().__init__(dict(cfg, task=ENV_TASK), wl, seed, device, steps_per_env)
        pol = cfg["policy"]
        e = self.env.cfg.env
        self.net = ActorCriticRecurrent(
            e.num_observations, e.num_privileged_obs, e.num_actions, cfg["actor_hidden"],
            cfg["critic_hidden"], pol["init_noise_std"], pol["rnn_hidden_size"],
            pol["rnn_num_layers"], stream_seed(seed, "net_init")).to(device)
        self.pieces = None
        self.init_params = {k: follow._cpu(v) for k, v in self.net.named_parameters()}
        self.layers, self.hidden = pol["rnn_num_layers"], pol["rnn_hidden_size"]
        # the memory a followed iteration starts from, by (variant, iteration)
        self.carry = {}

    def _start_memory(self, snap: dict, variant: str):
        """Zeros at iteration 0 (and every iteration under "zero_start"),
        else the state this reference's own rollout of the iteration before
        left (`_rollout`)."""
        it = snap["iteration"]
        if it == 0 or variant == "zero_start":
            n = snap["rollout"]["dones"].shape[1]
            return [torch.zeros(self.layers, n, self.hidden, device=self.device)
                    for _ in range(4)]
        if (variant, it) not in self.carry:
            raise RuntimeError(f"iteration {it} starts from the memory that iteration {it - 1} "
                               f"leaves: follow that one first ({variant!r})")
        return list(self.carry[(variant, it)])

    @torch.no_grad()
    def log_probs(self, params: dict, roll: dict) -> torch.Tensor:
        self._load_params(params)
        std = torch.clamp(self.net.std, min=1e-3)
        return torch.stack([follow._cpu(networks.normal_log_prob(
            roll["mu"][t].to(self.device), std, roll["actions"][t].to(self.device)))
            for t in range(roll["mu"].shape[0])])

    @torch.no_grad()
    def _rollout(self, snap: dict, variant: str):
        """rsl_rl's rollout of the snapshot's rows from `_start_memory`,
        then the last value, whose critic step the memory keeps; records
        the state after it as the next iteration's start -> (means, values,
        saved hidden states, last value)."""
        dev, roll = self.device, snap["rollout"]
        mu, val, saved = collect(self.net, roll["obs"].to(dev), roll["priv_obs"].to(dev),
                                 roll["dones"].to(dev).bool(), self._start_memory(snap, variant),
                                 reset=variant != "no_reset")
        last_value = self.net.evaluate(snap["last_priv_obs"].to(dev))
        ha, hc = self.net.get_hidden_states()
        self.carry[(variant, snap["iteration"] + 1)] = _clone_states(ha) + _clone_states(hc)
        return mu, val, saved, last_value

    def nets(self, snap: dict, variant: str = "stated") -> dict:
        self._load_params(snap["params"])
        with precision(variant):
            mu, val, _, _ = self._rollout(snap, variant)
        return {"mu": follow._cpu(mu), "values": follow._cpu(val)}

    def update(self, snap: dict, variant: str = "stated") -> dict:
        dev, a = self.device, self.algo
        self._load_params(snap["params"])
        ts = TrainState(
            net=self.net,
            opt_mu={k: v.to(dev, copy=True) for k, v in snap["opt_mu"].items()},
            opt_nu={k: v.to(dev, copy=True) for k, v in snap["opt_nu"].items()},
            opt_count=torch.tensor(snap["opt_count"], dtype=torch.int32, device=dev),
            lr=torch.tensor(snap["lr"], dtype=torch.float32, device=dev),
            iteration=snap["iteration"],
        )
        roll = {k: v.to(dev) for k, v in snap["rollout"].items()}
        N = roll["dones"].shape[1]
        with precision(variant):
            _, _, saved, last_value = self._rollout(snap, variant)
            with torch.no_grad():
                adv, ret = gae(roll["rewards"], roll["values"], roll["dones"], last_value,
                               a.gamma, a.lam)
                adv = (adv - adv.mean()) / (torch.sqrt(torch.square(adv - adv.mean()).mean())
                                            + 1e-8)
            gen = torch.Generator(device=dev)
            gen.manual_seed(permutation_seed(self.seed, snap["iteration"]))
            perm = torch.randperm(N, generator=gen, device=dev)
            # the storage in the permutation's order of envs, then rsl_rl's
            # generator over consecutive blocks of envs
            store = {"obs": roll["obs"], "priv": roll["priv_obs"], "actions": roll["actions"],
                     "log_probs": roll["log_probs"], "values": roll["values"], "adv": adv,
                     "ret": ret, "mu": roll["mu"], "sigma": roll["sigma"],
                     "dones": roll["dones"].bool()}
            store = {k: v[:, perm] for k, v in store.items()}
            if variant == "no_reset":
                store["dones"] = torch.zeros_like(store["dones"])
            saved = tuple(s[:, :, perm] for s in saved)
            size = N // a.num_mini_batches
            acc = None
            for _ in range(a.num_learning_epochs):
                for i in range(a.num_mini_batches):
                    envs = slice(i * size, i * size + (size // 2 if variant == "half" else size))
                    mb = {k: v[:, envs] for k, v in store.items()}
                    mean, value = rows_forward(self.net, mb["obs"], mb["priv"], mb["dones"],
                                               tuple(s[:, :, envs] for s in saved))
                    loss, kl, terms = ppo_loss(a, self.net, mb, mean, value)
                    ppo_step(a, ts, loss, kl)
                    terms = {k: float(v.detach()) for k, v in terms.items()}
                    acc = terms if acc is None else {k: acc[k] + v for k, v in terms.items()}
        n = a.num_learning_epochs * a.num_mini_batches
        terms = {k: v / n for k, v in acc.items()}
        terms["estimator_loss"] = 0.0
        return {"loss": self.total_loss(terms), "loss_scale": self.loss_scale(terms),
                "opt_mu": {k: follow._cpu(v) for k, v in ts.opt_mu.items()},
                "params": {k: follow._cpu(v) for k, v in self.net.named_parameters()}}


@torch.no_grad()
def collect(net: ActorCriticRecurrent, obs, priv_obs, dones, memory0, reset: bool = True):
    """rsl_rl's rollout of the nets over T rows (obs (T, N, O), priv_obs,
    dones (T, N) bool) from the flat state `memory0` (h_a, c_a, h_c, c_c):
    per row the hidden states saved before it, the mean and the value, and
    with `reset` the memory zeroed after a done -> (means, values, saved
    (h_a, c_a, h_c, c_c) each (T, layers, N, H)); the nets keep the state
    after the last row."""
    net.set_hidden_states(memory0)
    means, values, saved = [], [], []
    for t in range(obs.shape[0]):
        ha, hc = net.get_hidden_states()
        saved.append(_clone_states(ha) + _clone_states(hc))
        means.append(net.act(obs[t]))
        values.append(net.evaluate(priv_obs[t]))
        if reset:
            net.reset(dones[t])
    saved = tuple(torch.stack([s[i] for s in saved]) for i in range(4))
    return torch.stack(means), torch.stack(values), saved


def rows_forward(net: ActorCriticRecurrent, obs, priv_obs, dones, saved):
    """rsl_rl's batch mode over env rows (obs (T, B, O), priv_obs, dones (T,
    B) bool, `saved` the hidden states of `collect` for these envs): the
    rows split into trajectories at the dones and padded, each memory run
    over them from the hidden states saved at each trajectory's first row,
    the outputs unpadded -> (means, values) (T, B, ...). (rsl_rl splits the
    whole storage once and takes each minibatch's trajectories from it;
    trajectories never cross envs, so splitting a minibatch's rows alone
    gives the same ones.)"""
    pad_obs, masks = split_and_pad_trajectories(obs, dones)
    pad_priv, _ = split_and_pad_trajectories(priv_obs, dones)
    last_was_done = torch.zeros_like(dones)
    last_was_done[1:] = dones[:-1]
    last_was_done[0] = True
    starts = last_was_done.permute(1, 0)
    # (T, layers, B, H) -> the states at each trajectory's first row (layers, traj, H)
    first = [s.permute(2, 0, 1, 3)[starts].transpose(1, 0).contiguous() for s in saved]
    return (net.act(pad_obs, masks, (first[0], first[1])),
            net.evaluate(pad_priv, masks, (first[2], first[3])))


def ppo_loss(algo, net: ActorCriticRecurrent, mb: dict, mean, value):
    """The port's PPO loss of one minibatch at (mean, value), each term the
    mean over its rows -> (loss, KL mean (detached), {terms})."""
    a = algo
    std = torch.clamp(net.std, min=1e-3)
    kl = torch.sum(torch.log(std / mb["sigma"] + 1e-5)
                   + (torch.square(mb["sigma"]) + torch.square(mean - mb["mu"]))
                   / (2.0 * torch.square(std)) - 0.5, dim=-1).mean()
    logp = networks.normal_log_prob(mean, std, mb["actions"])
    ratio = torch.exp(torch.clamp(logp - mb["log_probs"], -20.0, 20.0))
    surrogate = torch.maximum(-mb["adv"] * ratio, -mb["adv"] * torch.clamp(
        ratio, 1.0 - a.clip_param, 1.0 + a.clip_param)).mean()
    v_clipped = mb["values"] + torch.clamp(value - mb["values"], -a.clip_param, a.clip_param)
    value_loss = torch.maximum(torch.square(value - mb["ret"]),
                               torch.square(v_clipped - mb["ret"])).mean()
    entropy = networks.normal_entropy(std, logp.shape).mean()
    loss = surrogate + a.value_loss_coef * value_loss - a.entropy_coef * entropy
    return loss, kl.detach(), {"surrogate_loss": surrogate, "value_loss": value_loss,
                               "entropy": entropy}


def ppo_step(algo, ts: TrainState, loss, kl) -> None:
    """The port's step on `ts.net`: the KL-adaptive learning rate, the
    global norm clip (a non-finite norm drops the step), Adam."""
    a = algo
    names, params = zip(*ts.net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params, materialize_grads=True)))
    lr = ts.lr
    if kl > a.desired_kl * 2.0:
        lr = torch.clamp(lr / 1.5, min=1e-5)
    elif a.desired_kl / 2.0 > kl > 0.0:
        lr = torch.clamp(lr * 1.5, max=1e-2)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    if torch.isfinite(gnorm):
        scale = torch.clamp(a.max_grad_norm / (gnorm + 1e-12), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    else:
        grads = {k: torch.zeros_like(g) for k, g in grads.items()}
    _adam_step(ts, grads, lr)
    ts.lr.copy_(lr)


def _lstm_macs(inputs: int, hidden: int, layers: int) -> int:
    """Multiply-adds of one LSTM step of one row: 4H x (in + H) a layer."""
    return sum(4 * hidden * ((inputs if k == 0 else hidden) + hidden) for k in range(layers))


def _widths(cfg: dict):
    pol = cfg["policy"]
    return pol["rnn_hidden_size"], pol["rnn_num_layers"]


def net_flops(cfg: dict, envs: int) -> int:
    """Matmul FLOPs of the nets in one iteration: both memories and heads at
    every rollout step, the critic's memory and head once more for the last
    value, and `epochs` passes of forward + backward (three times the
    forward) over the batch."""
    H, L = _widths(cfg)
    T, epochs = cfg["steps_per_env"], cfg["learning_epochs"]
    actor = _lstm_macs(cfg["num_obs"], H, L) + sum(
        a * b for a, b in zip((H, *cfg["actor_hidden"]), (*cfg["actor_hidden"], cfg["num_actions"])))
    critic = _lstm_macs(cfg["num_privileged_obs"], H, L) + sum(
        a * b for a, b in zip((H, *cfg["critic_hidden"]), (*cfg["critic_hidden"], 1)))
    batch = envs * T
    return batch * 2 * (actor + critic) + envs * 2 * critic + batch * epochs * 3 * 2 * (
        actor + critic)


def _bptt_macs(inputs: int, hidden: int, layers: int) -> int:
    """Multiply-adds of one row's scan step forward and backward: each
    layer's recurrent matmul three times (forward, the state's gradient,
    the weights'), its input matmul twice (forward, the weights' gradient)
    in the first layer, whose inputs are observations and take no
    gradient, and three times in the layers above it."""
    return sum(4 * hidden * ((2 * inputs if k == 0 else 3 * hidden) + 3 * hidden)
               for k in range(layers))


def bptt_work(cfg: dict, envs: int) -> dict:
    """The work of the update's scans in one iteration (stage `update.bptt`:
    both memories' forward and backward over the T x envs rows, in every
    epoch): `matmul_flops`, the gate matmuls (`_bptt_macs`); `cell_flops`,
    the cells' float32 elementwise work (`CELL_OPS` a hidden unit and row
    forward, twice that backward); `bytes`, the least traffic: each memory's inputs
    read in the forward and again for the weights' gradient, and its outputs
    and cell states written once and read once (float32)."""
    H, L = _widths(cfg)
    T, epochs = cfg["steps_per_env"], cfg["learning_epochs"]
    rows = envs * T * epochs
    macs = _bptt_macs(cfg["num_obs"], H, L) + _bptt_macs(cfg["num_privileged_obs"], H, L)
    inputs = cfg["num_obs"] + cfg["num_privileged_obs"]
    return {"matmul_flops": rows * 2 * macs, "cell_flops": rows * 2 * L * H * 3 * CELL_OPS,
            "bytes": rows * 4 * (2 * inputs + 2 * L * 2 * 2 * H)}


def bptt_least_s(cfg: dict, envs: int) -> float:
    """The least time of `bptt_work` at the configuration's stated
    precision: the larger of the gate matmuls at the bf16 peak plus the
    cells' work at the float32 peak, and the bytes at the memory rate."""
    w = bptt_work(cfg, envs)
    return max(w["matmul_flops"] / PEAK_BF16_FLOPS + w["cell_flops"] / PEAK_F32_FLOPS,
               w["bytes"] / PEAK_BYTES_PER_S)
