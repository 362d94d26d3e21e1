"""The stage tracer (humanoid_gym_tpu_torch/utils/tracing.py) on the CPU at
4 envs: one eager iteration records every stage in order and its leaf
stages cover it; tracing changes no number of the training; off, it
records and allocates nothing; the runner's host spans and the gaps
between iterations. The card's stamps (the `hgt_stamp` kernel captured into
the graph) are tested in tests/test_torch_cuda.py."""

import tracemalloc

import numpy as np
import pytest
import torch

from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo.capture import clone_tree, tensor_leaves, train_state_tensors
from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
from humanoid_gym_tpu_torch.runner import OnPolicyRunner
from humanoid_gym_tpu_torch.utils import tracing
from humanoid_gym_tpu_torch.utils.tracing import IterationStamps, StageTracer

torch.set_num_threads(1)

T = 3
ENVS = 4
TASKS = ["humanoid_ppo", "humanoid_joint_deploy"]


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("HGT_WANDB", "0")


def _apgd(cfg):
    cfg.sim.solver.solver_type = "apgd"


def _parts(task, seed=0):
    """(env, net, train state, ppo config, generator, (env_state, obs, priv_obs))
    at ENVS envs, T steps, the task's own update (2 epochs x 4 minibatches)."""
    env, cfg = registry.make_env(task, num_envs=ENVS, cfg_overrides=_apgd, device="cpu",
                                 seed=seed)
    tcfg = registry.get_task(task).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=seed)
    pc = PPOConfig.from_cfg(tcfg.algorithm)
    pc.num_steps_per_env = T
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    return env, net, init_train_state(net, pc.learning_rate), pc, gen, env.reset_all()


def _env_stages(terrain):
    return (["env.actions", "env.physics"] + (["env.physics.terrain"] if terrain else [])
            + ["env.state", "env.rewards", "env.reset", "env.obs"])


def _expected(task, pc):
    """(name, robot) of each stage instance of one iteration, in order of entry."""
    if task == "humanoid_joint_deploy":
        step = [(n, r) for r in (0, 1) for n in _env_stages(True)] + [("env.join", None)]
    else:
        step = [(n, None) for n in _env_stages(False)]
    updates = [("update.grad", None), ("update.adam", None)] * (
        pc.num_learning_epochs * pc.num_mini_batches)
    return ([(tracing.ROOT, None)]
            + ([("rollout.policy", None)] + step + [("rollout.store", None)]) * T
            + [("gae", None), ("update.gather", None)] + updates + [("iter.metrics", None)])


@pytest.mark.parametrize("task", TASKS)
def test_eager_iteration_records_every_stage_in_order(task):
    """Every stage in order: T times each env stage (per robot on the joint
    task, the terrain patches inside the physics), 2 x 4 times each update
    stage; the stages under the root follow each other and sum to the
    iteration's span within 2 %."""
    env, net, ts, pc, gen, inputs = _parts(task)
    tracer = StageTracer("cpu")
    train_iter = make_train_iter(env, net, pc, ENVS)
    with tracer.activate():
        train_iter(ts, *inputs, gen)
    assert [(r.name, r.robot) for r in tracer.stages] == _expected(task, pc)
    assert pc.num_learning_epochs * pc.num_mini_batches == 8
    assert tracer.slots == 2 * len(tracer.stages)
    it = tracer.add_iteration(tracer.stamps())
    root = tracer.stages[0]
    top = [r for r in tracer.stages if tracing.top_level(r)]
    assert [r.name for r in tracer.stages if r.depth == 2] == (
        ["env.physics.terrain"] * (2 * T if "joint" in task else 0))
    assert [r for r in tracer.stages if r.depth > 2] == []
    s = tracer.stamps().numpy()
    # in order, none overlapping: each starts after the one before ends
    assert all(a.exit < b.enter for a, b in zip(top, top[1:]))
    assert all(s[a.exit] <= s[b.enter] for a, b in zip(top, top[1:]))
    span = s[root.exit] - s[root.enter]
    assert it.end - it.start == span
    assert abs(it.covered_ns - span) <= 0.02 * span
    assert sum(it.totals[k] for k in {(r.name, r.robot) for r in top}) == it.covered_ns


@pytest.mark.parametrize("task", TASKS)
def test_tracing_leaves_the_training_bit_identical(task):
    """Two iterations with the tracer on and off from one snapshot: the same
    train state, env state, obs and metrics, to the bit."""
    env, net, ts, pc, gen, inputs = _parts(task)
    train_iter = make_train_iter(env, net, pc, ENVS)
    snap_ts = [t.detach().clone() for t in train_state_tensors(ts)]
    snap_inputs = clone_tree(inputs)
    snap_gens = [g.get_state() for g in [gen, *env.generators()]]

    def run(tracer):
        with torch.no_grad():
            for t, v in zip(train_state_tensors(ts), snap_ts):
                t.copy_(v)
        ts.iteration = 0
        for g, v in zip([gen, *env.generators()], snap_gens):
            g.set_state(v)
        state = clone_tree(snap_inputs)
        with tracing.activated(tracer):
            for _ in range(2):
                _, *state, metrics = train_iter(ts, *state, gen)
        return ([t.detach().clone() for t in train_state_tensors(ts)] + tensor_leaves(state)
                + [metrics[k] for k in sorted(metrics)])

    off = run(None)
    tracer = StageTracer("cpu")
    on = run(tracer)
    assert tracer.stages and len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_tracing_off_records_nothing_and_allocates_nothing():
    """Off (no tracer active), `stage` and `robot` hand out the one shared
    null context, an iteration leaves a tracer that was not activated
    empty, and entering a stage allocates no Python memory."""
    assert tracing.active() is None
    assert tracing.stage("env.physics") is tracing.NULL is tracing.robot(1)
    assert tracing.host_span(None, "runner.log") is tracing.NULL is tracing.activated(None)
    env, net, ts, pc, gen, inputs = _parts("humanoid_ppo")
    idle = StageTracer("cpu")
    make_train_iter(env, net, pc, ENVS)(ts, *inputs, gen)
    assert idle.stages == [] and idle.slots == 0 and idle.iterations == []
    assert idle.host_spans == []

    def enter_many():
        for _ in range(1000):
            with tracing.stage("env.physics"):
                pass

    enter_many()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        enter_many()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename.endswith("tracing.py") and d.size_diff > 0]
    assert grown == []


def test_learn_records_the_runner_spans_and_the_gaps(tmp_path):
    """`learn(3)` with tracing on: `runner.dispatch`, `runner.fetch_wait`
    and `runner.log` once an iteration, `runner.save` at each save (the
    iterations 0 and 2 at an interval of 2, and the closing one); each
    iteration's stage totals; each gap between two iterations charged to a
    runner span."""
    env, _ = registry.make_env("humanoid_ppo", num_envs=ENVS, cfg_overrides=_apgd, device="cpu",
                               seed=3)
    tcfg = registry.get_task("humanoid_ppo").make_train_cfg()
    tcfg.runner.num_steps_per_env = 2
    tcfg.runner.save_interval = 2
    runner = OnPolicyRunner(env, tcfg, log_dir=str(tmp_path / "run"), seed=3)
    runner.set_tracing(True)
    tracer = runner.tracer
    runner.learn(3)
    names = [n for n, _, _ in tracer.host_spans]
    assert {n: names.count(n) for n in set(names)} == {
        "runner.dispatch": 3, "runner.fetch_wait": 3, "runner.log": 3, "runner.save": 3}
    assert all(a <= b for _, a, b in tracer.host_spans)
    assert len(tracer.iterations) == 3
    ms = tracer.stage_ms(first=1)
    assert ms[("env.physics", None)] > 0 and ms[(tracing.ROOT, None)] > ms[("gae", None)]
    gaps = tracer.gaps(first=1)
    assert len(gaps) == 2
    assert all(ns > 0 and name.startswith("runner.") for ns, name in gaps)
    runner.set_tracing(False)
    assert runner.tracer is None


def test_gaps_are_charged_to_the_span_open_at_their_start():
    """The gap after an iteration goes to the innermost host span open when
    the iteration's last stamp fell, or to "none"."""
    tracer = StageTracer("cpu")
    tracer.host_spans = [("runner.dispatch", 0, 50), ("runner.save", 60, 200),
                         ("runner.fetch_wait", 205, 300), ("capture.record", 210, 220)]
    tracer.iterations = [IterationStamps(0, 100, 0, {}), IterationStamps(150, 202, 0, {}),
                         IterationStamps(204, 215, 0, {}), IterationStamps(400, 500, 0, {})]
    assert tracer.gaps() == [(50, "runner.save"), (2, "none"), (185, "capture.record")]
    assert tracer.gaps(first=3) == [(185, "capture.record")]


def test_stamps_past_the_capacity_raise(monkeypatch):
    """An iteration whose stages take more stamps than the buffer holds
    raises, at the stamp that overflows."""
    env, net, ts, pc, gen, inputs = _parts("humanoid_ppo")
    monkeypatch.setattr(tracing, "STAMP_CAPACITY", 20)
    tracer = StageTracer("cpu")
    with tracer.activate(), pytest.raises(RuntimeError, match="more than 20 stamps"):
        make_train_iter(env, net, pc, ENVS)(ts, *inputs, gen)


def test_a_stage_outside_an_iteration_raises():
    tracer = StageTracer("cpu")
    with tracer.activate(), pytest.raises(RuntimeError, match="outside an iteration"):
        with tracing.stage("env.physics"):
            pass
    assert tracing.active() is None


def test_stamps_in_another_map_are_refused():
    tracer = StageTracer("cpu")
    with tracer.activate():
        with tracing.stage(tracing.ROOT):
            with tracing.stage("gae"):
                pass
    assert tracer.slots == 4
    with pytest.raises(ValueError, match="3 stamps for a map of 4"):
        tracer.add_iteration(np.arange(3))
    it = tracer.add_iteration(np.array([10, 12, 17, 20]))
    assert (it.start, it.end, it.covered_ns) == (10, 20, 5)
    assert it.totals == {("gae", None): 5, (tracing.ROOT, None): 10}
