"""The reference's side of the correctness check: the plain frozen copy
(`hgt_ref`) works out again, from the program's own state before each
followed iteration, what that iteration should have produced.

- `start`: the nets' initial weights from the seed and the first
  observations of a fresh reset (the reference builds both itself).
- `steps`: the first `STEPS` env steps (actions, physics, rewards,
  observations, resets, the curriculum's draws) from the program's env
  state and its env generators' state, with the rollout's actions; past
  them two sound rollouts part after a few contacts, so the later rows are
  held to each other instead (`correct.stack_gap`, `correct.logp_gap`).
- `nets`: the actor's means and the critic's values at every row of the
  program's rollout, from the weights the iteration started with.
- `update`: GAE, the advantage normalisation, the minibatch permutation of
  the iteration, the losses, gradients, clip and Adam steps of both epochs,
  on the program's rollout from the program's train state.

A `variant` changes the reference as the check's control and faults do:
"stated" is the plain float32 reference (TF32 off); "control" computes the
hidden layers' matmuls in float8 (e4m3, one scale a tensor) and lets float32
matmuls run in TF32: the nearest precisions below the configuration's bf16
and float32; "half" leaves half of each minibatch out of the update and takes
the mean over the rest.

This module judges every configuration whose file names no `"reference"`.
A file that names one (`"reference": "<module>"`) is judged by the module or
package `benchmark/reference/<module>` (`benchmark.reference.module`), which
keeps this module's contract:

- `STEPS`, equal to this module's (`correct.NUMBERS` names a gap for each
  followed step; `run.py` refuses another count before the window);
- a class `Reference` with `__init__(cfg, wl, seed, device, steps_per_env)`
  and the methods `start(variant)`, `steps(snap, variant)`, `frames()`,
  `log_probs(params, roll)`, `nets(snap, variant)`, `update(snap,
  variant)`, `total_loss(terms)`, `loss_scale(terms)` and `close()`, each
  returning what this module's does, and every `variant` taking the values
  "stated", "control" and "half";
- optionally `net_flops(cfg, envs)`, the matmul FLOPs of the
  configuration's nets in one iteration, which `census.iteration_least_s`
  (and so `mfu`) takes in place of `census.net_flops`, the MLP
  actor-critic's.

Such a module may import `hgt_ref`, torch and numpy, and never the port or
JAX (`benchmark/tests/test_bench_imports.py` scans every module here).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .hgt_ref import registry
from .hgt_ref.algo import networks
from .hgt_ref.algo.ppo import PPOConfig, Rollout, TrainState, make_train_pieces
from .hgt_ref.envs.state import EnvState
from .hgt_ref.parallel.multihost import stream_seed
from .hgt_ref.physics.step import PhysicsState

CHUNK = 65536  # rows a forward pass of `nets` takes at once
STEPS = 3  # env steps followed from the program's state


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude to 448), passed straight through by autograd."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


def _fp8_forward(self, x):
    for lin in self.layers[:-1]:
        x = F.elu(F.linear(_fp8(x.float()), _fp8(lin.weight), lin.bias))
    last = self.layers[-1]
    return F.linear(x.float(), last.weight, last.bias)


@contextlib.contextmanager
def precision(variant: str):
    """The control's lower precisions for the duration; the stated ones
    otherwise (float32 matmuls with TF32 off)."""
    tf32 = variant == "control"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    forward = networks.MLP.forward
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    if variant == "control":
        networks.MLP.forward = _fp8_forward
    try:
        yield
    finally:
        networks.MLP.forward = forward
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cpu(x: torch.Tensor) -> torch.Tensor:
    """A host copy that shares no storage with `x`."""
    return x.detach().to("cpu", copy=True)


def _env_state(d, device):
    """The reference's EnvState from a snapshot's dict of host tensors."""
    phys = PhysicsState(**{k: v.to(device) for k, v in d["phys"].items()})
    return EnvState(phys=phys, **{k: v.to(device) for k, v in d.items() if k != "phys"})


class Reference:
    """The frozen copy built for one cell: its env (the plain physics on
    `device`), its nets in float32 and its PPO pieces."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, steps_per_env: int):
        self.device = device
        self.seed = seed
        envs = sum(wl["envs_per_robot"])

        def overrides(c):
            c.sim.solver.solver_type = cfg["solver"]

        self.env, _ = registry.make_env(cfg["task"], num_envs=envs, cfg_overrides=overrides,
                                        device=device, seed=seed)
        train_cfg = registry.get_task(cfg["task"]).make_train_cfg()
        self.net = networks.actor_critic_from_cfg(
            self.env.cfg.env, train_cfg.policy, seed=stream_seed(seed, "net_init"),
            compute_dtype="float32").to(device)
        algo = PPOConfig.from_cfg(train_cfg.algorithm)
        algo.num_steps_per_env = steps_per_env
        self.algo = algo
        self.pieces = make_train_pieces(self.env, self.net, algo, envs, None, perm_seed=seed)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        self.init_params = {k: _cpu(v) for k, v in self.net.named_parameters()}
        self.init_gen = [g.get_state() for g in self.env.generators()]

    # ------------------------------------------------------------------ #

    def start(self, variant: str = "stated") -> dict:
        """The initial weights from the seed and the obs of a reset from the
        env generators' initial state."""
        for g, s in zip(self.env.generators(), self.init_gen):
            g.set_state(s)
        with precision(variant):
            _, obs, priv = self.env.reset_all()
        return {"params": self.init_params, "obs": _cpu(obs), "priv_obs": _cpu(priv)}

    def _load_params(self, params: dict) -> None:
        with torch.no_grad():
            for k, p in self.net.named_parameters():
                p.copy_(params[k].to(self.device))

    @torch.no_grad()
    def steps(self, snap: dict, variant: str = "stated") -> list:
        """The first `STEPS` env steps from the program's state with the
        rollout's actions: each step's next obs, privileged obs, the
        bootstrapped reward and the done flags."""
        roll = snap["rollout"]
        env_state = snap["env_state"]
        state = [_env_state(s, self.device) for s in env_state] if isinstance(env_state, list) \
            else _env_state(env_state, self.device)
        for g, s in zip(self.env.generators(), snap["env_gen"]):
            g.set_state(s)
        out = []
        with precision(variant):
            for t in range(STEPS):
                state, tr = self.env.step(state, roll["actions"][t].to(self.device))
                value = roll["values"][t].to(self.device)
                out.append({"obs": _cpu(tr.obs), "priv_obs": _cpu(tr.privileged_obs),
                            "reward": _cpu(tr.reward + self.algo.gamma * value * tr.time_out),
                            "done": _cpu(tr.done)})
        return out

    def frames(self) -> tuple:
        """The frames stacked in an observation and in a privileged one."""
        e = self.env.cfg.env
        return e.frame_stack, e.c_frame_stack

    @torch.no_grad()
    def log_probs(self, params: dict, roll: dict) -> torch.Tensor:
        """The log-density of every row's actions under the rollout's means
        and the policy's std of `params`."""
        self._load_params(params)
        std = self.net.act(roll["obs"][0, :1].to(self.device))[1]
        return torch.stack([_cpu(networks.normal_log_prob(roll["mu"][t].to(self.device), std,
                                                          roll["actions"][t].to(self.device)))
                            for t in range(roll["mu"].shape[0])])

    @torch.no_grad()
    def nets(self, snap: dict, variant: str = "stated") -> dict:
        """The means and values at every row of the program's rollout."""
        self._load_params(snap["params"])
        roll = snap["rollout"]
        obs = roll["obs"].reshape(-1, roll["obs"].shape[-1])
        priv = roll["priv_obs"].reshape(-1, roll["priv_obs"].shape[-1])
        mu, val = [], []
        with precision(variant):
            for i in range(0, obs.shape[0], CHUNK):
                mu.append(_cpu(self.net.act(obs[i:i + CHUNK].to(self.device))[0]))
                val.append(_cpu(self.net.evaluate(priv[i:i + CHUNK].to(self.device))))
        return {"mu": torch.cat(mu).reshape(roll["mu"].shape),
                "values": torch.cat(val).reshape(roll["values"].shape)}

    def update(self, snap: dict, variant: str = "stated") -> dict:
        """The iteration's update on the program's rollout from the
        program's train state: (loss terms, Adam first moments after,
        parameters after)."""
        dev = self.device
        self._load_params(snap["params"])
        ts = TrainState(
            net=self.net,
            opt_mu={k: v.to(dev, copy=True) for k, v in snap["opt_mu"].items()},
            opt_nu={k: v.to(dev, copy=True) for k, v in snap["opt_nu"].items()},
            opt_count=torch.tensor(snap["opt_count"], dtype=torch.int32, device=dev),
            lr=torch.tensor(snap["lr"], dtype=torch.float32, device=dev),
            iteration=snap["iteration"],
        )
        roll = Rollout(**{k: v.to(dev) for k, v in snap["rollout"].items()})
        p = self.pieces
        gen = torch.Generator(device=dev)
        with precision(variant):
            adv, ret = p["compute_gae"](ts, roll, snap["last_priv_obs"].to(dev))
            perm = p["draw_permutation"](ts, gen)
            mbs = p["minibatches"](roll, adv, ret, perm)
            if variant == "half":
                mbs = [tuple(x[: x.shape[0] // 2] for x in mb) for mb in mbs]
            acc = None
            for _ in range(self.algo.num_learning_epochs):
                for mb in mbs:
                    ts, m = p["minibatch_update"](ts, mb)
                    acc = m if acc is None else {k: acc[k] + v for k, v in m.items()}
        n = self.algo.num_learning_epochs * len(mbs)
        terms = {k: float(v) / n for k, v in acc.items()}
        return {"loss": self.total_loss(terms), "loss_scale": self.loss_scale(terms),
                "opt_mu": {k: _cpu(v) for k, v in ts.opt_mu.items()},
                "params": {k: _cpu(v) for k, v in self.net.named_parameters()}}

    def total_loss(self, terms: dict) -> float:
        """The minibatch loss the update minimises, from its mean terms."""
        a = self.algo
        return (terms["surrogate_loss"] + a.value_loss_coef * terms["value_loss"]
                - a.entropy_coef * terms["entropy"] + a.estimator_coef * terms["estimator_loss"])

    def loss_scale(self, terms: dict) -> float:
        """The size of the loss's terms: the sum of their magnitudes, which
        `loss_gap` divides by (the terms have both signs, and the loss
        itself can sit near 0: a flat run's value loss ~0.017 against the
        entropy bonus 0.001 x ~17)."""
        a = self.algo
        return (abs(terms["surrogate_loss"]) + a.value_loss_coef * abs(terms["value_loss"])
                + a.entropy_coef * abs(terms["entropy"])
                + a.estimator_coef * abs(terms["estimator_loss"]))

    def close(self) -> None:
        del self.env, self.net, self.pieces
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

