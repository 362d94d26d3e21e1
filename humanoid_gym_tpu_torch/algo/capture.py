"""The PPO training iteration as CUDA graphs: the port's counterpart of
`jax.jit(make_train_iter(...), donate_argnums=(0, 1))`, at every world size.

`CapturedTrainIter(env, net, cfg, num_envs, group=None, perm_seed=None)`
takes `make_train_iter`'s arguments and is called as its train_iter is:
(ts, env_state, obs, priv_obs, gen) -> (ts, env_state, obs, priv_obs,
metrics). Its first call captures one whole iteration of
`make_train_pieces`'s `iteration_body` (the T env steps with their kernel
launches, GAE, the advantage normalisation, the minibatch updates with
their backward passes and Adam); every call, the first included, replays
it:

- Cuts. At world size 1 no collective runs and the iteration is one CUDA
  graph. Under several ranks each `all_reduce_sum` (the advantage
  statistics, each minibatch's gradients, the metrics, and with the
  command curriculum on one a step) cuts the capture (`CutGraphs`): the
  graph recorded so far ends with the packing of the all-reduce's buffer,
  the next begins in the same memory pool, and a replay runs graph 0,
  all-reduce, graph 1, ... in the order of capture. The flat recipe has 11
  cuts an iteration (2 + 2 epochs x 4 minibatches + 1).
- Warm-up. Before the capture the iteration runs once on a side stream
  (the kernel library loads, cuBLAS and autograd make their handles and
  streams), and then everything it changed is put back: the parameters,
  Adam moments, count and learning rate of `ts` (and a recurrent net's
  memory), the env state, obs and priv_obs, and the state of every
  generator the iteration draws from. The warm-up does not move the
  training trajectory.
- Generators. `gen` (the action noise) and the env's own (`env.generators()`,
  one per sub-env of a joint env) are registered with every graph, so each
  replay draws the next numbers of each stream, as an eager iteration would,
  also where the draws of one iteration spread over several graphs.
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
- Counts. The kernel wrappers count launches, and the group its
  collectives and their bytes, on the host, so they count the warm-up and
  the recording; both are taken back, each replay adds the launches the
  capture recorded, and each all-reduce between two graphs counts itself.
- Spans. The warm-up and the recording are timed on the host clock
  (`spans`: `capture.warm_up`, `capture.record`; `utils/tracing.py`
  `record_capture`). Where a stage tracer is active during the capture
  (`OnPolicyRunner.set_tracing`), its buffer is allocated and the card's
  clock read first, and the graph records the stage stamps with the work;
  without one it records none.

There is no fallback: a capture or a replay that fails raises, and on a
CPU device the constructor raises. `compiled_train_iter` picks the captured
iteration on the card and the eager one on the CPU.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from ..parallel.mesh import EnvGroup, all_reduce_flat
from ..envs.rewards import rewards_launch
from ..physics.mega import mega_kernel_launch, terrain_patches_launch
from ..physics.solve import apgd_solve_kernel, fused_dense_solve, fused_solve
from ..utils import tracing
from .networks import ActorCritic
from .ppo import PPOConfig, TrainState, make_train_iter, make_train_pieces

# the kernel wrappers' launch counters: (wrapper, attribute)
LAUNCH_COUNTERS = ((mega_kernel_launch, "launches"), (mega_kernel_launch, "terrain_launches"),
                   (fused_solve, "launches"), (fused_dense_solve, "launches"),
                   (apgd_solve_kernel, "launches"), (terrain_patches_launch, "launches"),
                   (rewards_launch, "launches"))


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
    """Every tensor of the train state that an iteration updates (a
    recurrent net's memory last)."""
    return [*ts.net.parameters(), *ts.opt_mu.values(), *ts.opt_nu.values(), ts.opt_count, ts.lr,
            *(ts.memory or ())]


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


def captures(device, group: Optional[EnvGroup] = None) -> bool:
    """Whether the training iteration on `device` runs captured: on a CUDA
    device, under any group (a collective cuts the capture, `CutGraphs`);
    never on the CPU, which has no graphs."""
    return torch.device(device).type == "cuda"


def _group_counts(group: Optional[EnvGroup]):
    return None if group is None else (group.collectives, group.reduced_bytes)


def _set_group_counts(group: Optional[EnvGroup], counts) -> None:
    if group is not None:
        group.collectives, group.reduced_bytes = counts


class CutGraphs:
    """A body recorded as a chain of CUDA graphs, cut at each collective.

    While `record(body)` runs, each `all_reduce_sum` of `group` ends the
    graph being recorded (its last work packs the all-reduce's buffer),
    keeps the buffer and begins the next graph in the same memory pool.
    `replay()` replays the graphs in their order of capture, with each
    buffer's all-reduce (`all_reduce_flat`) on the stream between two of
    them: gloo stages it through the host and makes the stream wait for
    its copy back before the next graph runs, NCCL enqueues it. The
    buffers stay referenced here for the object's life: the next graph
    reads what the all-reduce wrote into them, and no allocation of a
    later graph may take their memory. Every graph registers `generators`,
    so draws spread over several graphs advance each Philox stream as one
    eager run does. No autograd edge crosses a cut: a minibatch's backward
    ends before its gradients are packed.

    With `graphs=False` nothing is captured: `record` runs the body once,
    eagerly, each collective all-reduced at its cut (the cut plan on the
    CPU), and there is nothing to replay. `buffers` then holds the cuts as
    well."""

    def __init__(self, group: Optional[EnvGroup], generators=(), graphs: bool = True):
        self.group, self.generators, self.graphs = group, list(generators), graphs
        self.segments, self.buffers = [], []
        self._pool = torch.cuda.graph_pool_handle() if graphs else None

    def _begin(self) -> None:
        if self.graphs:
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            graph.capture_begin(pool=self._pool)
            self.segments.append(graph)

    def _end(self) -> None:
        if self.graphs:
            self.segments[-1].capture_end()

    def _cut(self, flat: torch.Tensor, group: EnvGroup) -> None:
        self._end()
        self.buffers.append((flat, group))
        if not self.graphs:
            all_reduce_flat(flat, group)
        self._begin()

    def record(self, body):
        """Run `body()` with the group's collectives cut here; returns what
        it returns. On the card the graphs are recorded on a side stream
        after a synchronisation, as `torch.cuda.graph` records one."""
        if self.segments or self.buffers:
            raise RuntimeError("CutGraphs records once")
        if self.group is not None:
            self.group.on_collective = self._cut
        try:
            if not self.graphs:
                return body()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                self._begin()
                try:
                    out = body()
                finally:
                    self._end()
            torch.cuda.current_stream().wait_stream(stream)
            return out
        finally:
            if self.group is not None:
                self.group.on_collective = None

    def replay(self) -> None:
        """The graphs in their order of capture, each cut's all-reduce
        after the graph that packed its buffer."""
        if not self.graphs:
            raise RuntimeError("nothing was captured (graphs=False)")
        for i, graph in enumerate(self.segments):
            graph.replay()
            if i < len(self.buffers):
                all_reduce_flat(*self.buffers[i])


class CapturedTrainIter:
    """The training iteration captured as CUDA graphs cut at each
    collective (one graph at world size 1); see the module docstring.
    `graph` is the `CutGraphs` of the capture (None before the first call),
    `capture_seconds` the last capture's time (warm-up included), `spans`
    its warm-up's and recording's host spans (name -> (start ns, end ns),
    `time.perf_counter_ns`)."""

    def __init__(self, env, net: ActorCritic, cfg: PPOConfig, num_envs: int,
                 group: Optional[EnvGroup] = None, perm_seed: Optional[int] = None):
        device = next(net.parameters()).device
        if not captures(device, group):
            raise ValueError(f"the training iteration is captured on a CUDA device, "
                             f"not on {device}")
        pieces = make_train_pieces(env, net, cfg, num_envs, group, perm_seed)
        self._body, self._draw = pieces["iteration_body"], pieces["draw_permutation"]
        self._env_generators = env.generators()
        self._group = group
        self.capture_seconds = None
        self.spans = {}
        self.reset()

    def reset(self) -> None:
        """Drop the graph and its memory: the next call captures anew."""
        self.graph = None
        self._ts = self._gen = self._inputs = self._perm = self._metrics = None

    def _run(self):
        """The body on the static inputs, its new env state, obs and
        priv_obs copied back into them; returns the metrics."""
        *new, metrics = self._body(self._ts, *self._inputs, self._gen, self._perm)
        with tracing.stage("iter.inputs"):
            copy_into(self._inputs, tuple(new))
        return metrics

    def _capture(self, ts: TrainState, env_state, obs, priv_obs, gen) -> None:
        t0 = time.perf_counter()
        tracer = tracing.active()
        if tracer is not None:
            tracer.prepare()
        self._ts, self._gen = ts, gen
        self._bound = [t.data_ptr() for t in train_state_tensors(ts)]
        self._inputs = clone_tree((env_state, obs, priv_obs))
        self._perm = self._draw(ts, gen)
        generators = list({id(g): g for g in [gen, *self._env_generators]}.values())
        before, collectives = launch_counts(), _group_counts(self._group)
        w0 = time.perf_counter_ns()
        warm_up(self._run, ts, self._inputs, generators)
        w1 = time.perf_counter_ns()
        warm = launch_counts()
        graph = CutGraphs(self._group, generators)
        self._metrics = graph.record(self._run)
        self.spans = {"capture.warm_up": (w0, w1), "capture.record": (w1, time.perf_counter_ns())}
        tracing.record_capture(self.spans)
        self._replay_launches = [a - b for a, b in zip(launch_counts(), warm)]
        _set_launch_counts(before)
        _set_group_counts(self._group, collectives)
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
    `CapturedTrainIter` on the card (at any world size), the eager
    `make_train_iter` on the CPU."""
    make = CapturedTrainIter if captures(next(net.parameters()).device, group) else make_train_iter
    return make(env, net, cfg, num_envs, group, perm_seed)
