"""The PPO training iteration as one CUDA graph: the port's counterpart of
`jax.jit(make_train_iter(...), donate_argnums=(0, 1))`.

`CapturedTrainIter(env, net, cfg, num_envs, group=None, perm_seed=None)`
takes `make_train_iter`'s arguments and is called as its train_iter is:
(ts, env_state, obs, priv_obs, gen) -> (ts, env_state, obs, priv_obs,
metrics). Its first call captures one whole iteration of
`make_train_pieces`'s `iteration_body` (the T env steps with their kernel
launches, GAE, the advantage normalisation, the minibatch updates with
their backward passes and Adam) as one CUDA graph; every call, the first
included, replays it:

- Warm-up. Before the capture the iteration runs once on a side stream
  (the kernel library loads, cuBLAS and autograd make their handles and
  streams), and then everything it changed is put back: the parameters,
  Adam moments, count and learning rate of `ts`, the env state, obs and
  priv_obs, and the state of every generator the iteration draws from. The
  warm-up does not move the training trajectory.
- Generators. `gen` (the action noise) and the env's own (`env.generators()`,
  one per sub-env of a joint env) are registered with the graph, so each
  replay draws the next numbers of each stream, as an eager iteration would.
- Donation. The env state, obs and priv_obs live in static tensors: the
  graph reads them and, at its end, overwrites them with the new ones. The
  returned env state, obs and priv_obs are those tensors, valid until the
  next call; passing other tensors copies them in first.
- The train state. The graph reads and updates the tensors of `ts` in
  place; a caller that replaces one of them (another `ts`, a rebound `lr`)
  calls `reset()` first, and the next call captures anew. `ts.iteration`
  is a host counter, which each call advances.
- The minibatch permutation is drawn before each replay
  (`draw_permutation`, the eager iteration's numbers) into a static index
  tensor that the graph reads.
- The metrics are copied after each replay, so a caller may keep them.
- Launch counts. The kernel wrappers count launches on the host, so they
  count the warm-up's launches and the capture's recording only; both are
  taken back, and each replay adds the launches the capture recorded.

There is no fallback: a capture or a replay that fails raises, and on a
CPU device or under several ranks the constructor raises.
`compiled_train_iter` picks the captured iteration on the card at world
size 1 and the eager one elsewhere (under several ranks the command
curriculum's all-reduce and `minibatch_rows`' host read sit in the
iteration).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..parallel.mesh import EnvGroup
from ..physics.mega import mega_kernel_launch
from ..physics.solve import apgd_solve_kernel, fused_dense_solve, fused_solve
from .networks import ActorCritic
from .ppo import PPOConfig, TrainState, make_train_iter, make_train_pieces

# the kernel wrappers' launch counters: (wrapper, attribute)
LAUNCH_COUNTERS = ((mega_kernel_launch, "launches"), (mega_kernel_launch, "terrain_launches"),
                   (fused_solve, "launches"), (fused_dense_solve, "launches"),
                   (apgd_solve_kernel, "launches"))


def launch_counts() -> list:
    """The counters' values, in LAUNCH_COUNTERS' order."""
    return [getattr(fn, name) for fn, name in LAUNCH_COUNTERS]


def _set_launch_counts(counts) -> None:
    for (fn, name), n in zip(LAUNCH_COUNTERS, counts):
        setattr(fn, name, n)


def tensor_leaves(tree) -> list:
    """The tensors of a nested dataclass / tuple / list, in field order."""
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensor_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return [tree]


def clone_tree(tree):
    """A copy of a nested dataclass / tuple / list of tensors."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: clone_tree(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x) for x in tree)
    return tree.clone()


def copy_into(dst_tree, src_tree) -> None:
    """Copy the tensors of `src_tree` into those of `dst_tree` (the same
    structure). A source that is its destination is left alone; a source
    that shares storage with another destination is copied out first, so no
    copy reads what an earlier one wrote."""
    dst, src = tensor_leaves(dst_tree), tensor_leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} tensors to copy into {len(dst)}")
    storages = {d.untyped_storage().data_ptr() for d in dst}
    pairs = []
    for d, s in zip(dst, src):
        if (s.data_ptr(), s.shape, s.stride()) == (d.data_ptr(), d.shape, d.stride()):
            continue
        pairs.append((d, s.clone() if s.untyped_storage().data_ptr() in storages else s))
    for d, s in pairs:
        d.copy_(s)


def train_state_tensors(ts: TrainState) -> list:
    """Every tensor of the train state that an iteration updates."""
    return [*ts.net.parameters(), *ts.opt_mu.values(), *ts.opt_nu.values(), ts.opt_count, ts.lr]


def warm_up(run, ts: TrainState, inputs, generators) -> None:
    """Call `run()` once, on a side stream on the card, then put back what
    it changed: the tensors of `ts` (`train_state_tensors`), the tensors of
    `inputs` and the state of each generator."""
    with torch.no_grad():
        tensors = train_state_tensors(ts) + tensor_leaves(inputs)
        saved = [t.clone() for t in tensors]
    states = [g.get_state() for g in generators]
    if saved[0].is_cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
    else:
        run()
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    for g, s in zip(generators, states):
        g.set_state(s)


def captures(device, group: Optional[EnvGroup]) -> bool:
    """Whether the training iteration on `device` under `group` runs
    captured: on a CUDA device with no group or a group of one rank."""
    return torch.device(device).type == "cuda" and (group is None or group.world == 1)


class CapturedTrainIter:
    """The training iteration captured as one CUDA graph; see the module
    docstring. `capture_seconds` is the last capture's time (warm-up
    included), None before the first call."""

    def __init__(self, env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                 group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None):
        device = next(net.parameters()).device
        if not captures(device, group):
            raise ValueError(f"the training iteration is captured on a CUDA device at world size "
                             f"1, not on {device} with {group.world if group else 1} rank(s)")
        pieces = make_train_pieces(env, net, cfg, num_envs, group, perm_seed)
        self._body, self._draw = pieces["iteration_body"], pieces["draw_permutation"]
        self._env_generators = env.generators()
        self.capture_seconds = None
        self.reset()

    def reset(self) -> None:
        """Drop the graph and its memory: the next call captures anew."""
        self.graph = None
        self._ts = self._gen = self._inputs = self._perm = self._metrics = None

    def _run(self):
        """The body on the static inputs, its new env state, obs and
        priv_obs copied back into them; returns the metrics."""
        *new, metrics = self._body(self._ts, *self._inputs, self._gen, self._perm)
        copy_into(self._inputs, tuple(new))
        return metrics

    def _capture(self, ts: TrainState, env_state, obs, priv_obs, gen) -> None:
        t0 = time.perf_counter()
        self._ts, self._gen = ts, gen
        self._bound = [t.data_ptr() for t in train_state_tensors(ts)]
        self._inputs = clone_tree((env_state, obs, priv_obs))
        self._perm = self._draw(ts, gen)
        generators = list({id(g): g for g in [gen, *self._env_generators]}.values())
        before = launch_counts()
        warm_up(self._run, ts, self._inputs, generators)
        warm = launch_counts()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            self._metrics = self._run()
        self._replay_launches = [a - b for a, b in zip(launch_counts(), warm)]
        _set_launch_counts(before)
        self.graph = graph
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, ts: TrainState, env_state, obs, priv_obs, gen):
        if self.graph is None:
            self._capture(ts, env_state, obs, priv_obs, gen)
        elif (ts is not self._ts or gen is not self._gen
              or [t.data_ptr() for t in train_state_tensors(ts)] != self._bound):
            raise RuntimeError("the train state or the generator is not the captured one; "
                               "call reset() after replacing either")
        else:
            copy_into(self._inputs, (env_state, obs, priv_obs))
        self._perm.copy_(self._draw(ts, gen))
        self.graph.replay()
        _set_launch_counts([a + b for a, b in zip(launch_counts(), self._replay_launches)])
        ts.iteration += 1
        return (ts, *self._inputs, {k: v.clone() for k, v in self._metrics.items()})


def compiled_train_iter(env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                        group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None):
    """The training iteration of a caller that the JAX package jit-compiles:
    `CapturedTrainIter` where `captures(device, group)`, else the eager
    `make_train_iter` (the CPU, several ranks)."""
    make = CapturedTrainIter if captures(next(net.parameters()).device, group) else make_train_iter
    return make(env, net, cfg, num_envs, group, perm_seed)
