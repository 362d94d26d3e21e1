"""The training iteration's capture as CUDA graphs (`algo/capture.py`),
in the parts that run on the CPU: the iteration's body reads no host data,
the Adam step with its device count against the JAX package's, the warm-up
that leaves no trace, the cut plan without graphs, the refusal to capture
on the CPU, and which iteration the runner picks. The cut plan on two
ranks is in `tests/test_torch_parallel.py`; the captured iteration against
the eager one runs on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`
phases 13 and 24)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import HOST_DATA_CALLS, _quiet, _small_terrain

from humanoid_gym_tpu.algo import ppo as JP
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo import capture as CP
from humanoid_gym_tpu_torch.algo import ppo as TP
from humanoid_gym_tpu_torch.algo.networks import ActorCritic, actor_critic_from_cfg
from humanoid_gym_tpu_torch.parallel.mesh import EnvGroup

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

T = 2


def _setup(task, solver, n=4):
    """(env, ts, pieces, (state, obs, priv), gen) for `task` at n envs on
    the CPU, T = 2, 2 minibatches, 1 epoch, every command resampled each
    step."""
    def ov(c):
        _quiet(c, n, 2)
        c.sim.solver.solver_type = solver
        c.commands.resampling_time = c.dt
        if "terrain" in task:
            _small_terrain(c)

    env, cfg = registry.make_env(task, num_envs=n, cfg_overrides=ov, device="cpu", seed=0)
    tcfg = registry.get_task(task).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0)
    pc = TP.PPOConfig.from_cfg(tcfg.algorithm)
    pc.num_steps_per_env, pc.num_mini_batches, pc.num_learning_epochs = T, 2, 1
    ts = TP.init_train_state(net, pc.learning_rate)
    gen = torch.Generator().manual_seed(3)
    return env, ts, TP.make_train_pieces(env, net, pc, n), env.reset_all(), gen


@pytest.mark.parametrize("solver", ["mega", "apgd"])
@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_ppo_terrain_robust",
                                  "humanoid_joint_ppo", "humanoid_joint_deploy"])
def test_train_iter_reads_no_host_data(task, solver, monkeypatch):
    """After one warm-up iteration, a whole world-size-1 train_iter (the
    permutation, the rollout with the env's draws and resets, GAE, the
    updates with Adam, the metrics) calls none of HOST_DATA_CALLS: each
    would wait for the host and break the iteration's capture."""
    env, ts, pieces, (state, obs, priv), gen = _setup(task, solver)
    ts, state, obs, priv, _ = pieces["train_iter"](ts, state, obs, priv, gen)
    counts = {}
    for owner, name in HOST_DATA_CALLS:
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, counted)
    ts, state, obs, priv, metrics = pieces["train_iter"](ts, state, obs, priv, gen)
    monkeypatch.undo()
    assert counts == {}
    assert ts.iteration == 2 and int(ts.opt_count) == 4
    assert all(torch.isfinite(v).all() for v in metrics.values())


def test_adam_step_with_device_count_matches_jax():
    """The port's Adam step (the count an int32 tensor, the bias
    corrections float32) against the JAX package's `_adam_step` over 20
    steps from the same numpy parameters and gradients: parameters and
    moments within 1e-7 of each array's largest magnitude, equal counts."""
    rng = np.random.default_rng(0)
    net = ActorCritic(5, 4, 3, actor_hidden=(8,), critic_hidden=(6,), seed=0)
    named = dict(net.named_parameters())
    with torch.no_grad():
        for p in named.values():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    ts = TP.init_train_state(net, 1e-3)
    # copies: on the CPU jnp.asarray may share the numpy buffer, which sub_ writes
    params = {k: jnp.asarray(p.detach().numpy().copy()) for k, p in named.items()}
    mu = {k: jnp.zeros_like(v) for k, v in params.items()}
    nu = {k: jnp.zeros_like(v) for k, v in params.items()}
    count, lr = jnp.asarray(0, jnp.int32), jnp.asarray(1e-3, jnp.float32)
    for _ in range(20):
        g = {k: rng.normal(size=tuple(p.shape)).astype(np.float32) for k, p in named.items()}
        TP._adam_step(ts, {k: torch.from_numpy(v) for k, v in g.items()}, ts.lr)
        params, mu, nu, count = JP._adam_step(params, {k: jnp.asarray(v) for k, v in g.items()},
                                              mu, nu, count, lr)
    assert ts.opt_count.dtype == torch.int32 and int(ts.opt_count) == int(count) == 20
    for mine, theirs in ((named, params), (ts.opt_mu, mu), (ts.opt_nu, nu)):
        for k in named:
            a, b = mine[k].detach().numpy(), np.asarray(theirs[k])
            assert np.max(np.abs(a - b)) <= 1e-7 * np.max(np.abs(b)), k


def test_warm_up_restores_everything_it_changed():
    """The capture's warm-up, on the CPU: one iteration of the body on the
    static inputs, then parameters, Adam moments, count, lr, env state,
    obs, priv_obs and every generator's state are bit-equal to before; the
    next eager iteration equals one from an un-warmed copy."""
    env, ts, pieces, inputs, gen = _setup("humanoid_ppo", "apgd")
    ts_cold, inputs_cold = copy.deepcopy(ts), CP.clone_tree(inputs)
    before = [t.clone() for t in CP.train_state_tensors(ts) + CP.tensor_leaves(inputs)]
    generators = [gen, *env.generators()]
    g_states = [g.get_state() for g in generators]
    perm = pieces["draw_permutation"](ts, gen)

    def run():
        *new, _ = pieces["iteration_body"](ts, *inputs, gen, perm)
        CP.copy_into(inputs, tuple(new))

    CP.warm_up(run, ts, inputs, generators)
    after = CP.train_state_tensors(ts) + CP.tensor_leaves(inputs)
    assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(after, before))
    assert all(torch.equal(g.get_state(), s) for g, s in zip(generators, g_states))

    warm = pieces["train_iter"](ts, *inputs, gen)
    for g, s in zip(generators, g_states):
        g.set_state(s)
    cold = pieces["train_iter"](ts_cold, *inputs_cold, gen)
    assert warm[0].iteration == cold[0].iteration == 1
    pairs = list(zip(CP.train_state_tensors(warm[0]) + CP.tensor_leaves(warm[1:4]),
                     CP.train_state_tensors(cold[0]) + CP.tensor_leaves(cold[1:4])))
    pairs += [(warm[4][k], cold[4][k]) for k in cold[4]]
    assert all(torch.equal(a, b) for a, b in pairs)


def test_copy_into_reads_no_source_it_already_overwrote():
    """Donation when a new tensor is an old one's storage: swapping two
    static tensors through copy_into gives each the other's old value."""
    x, y = torch.arange(3.0), torch.arange(3.0) + 10
    CP.copy_into((x, y), (y, x))
    assert x.tolist() == [10.0, 11.0, 12.0] and y.tolist() == [0.0, 1.0, 2.0]
    z = torch.ones(2)
    CP.copy_into((z,), (z,))  # a tensor into itself: left alone
    assert z.tolist() == [1.0, 1.0]


def test_captured_train_iter_raises_on_the_cpu():
    env, ts, _, _, _ = _setup("humanoid_ppo", "apgd", n=2)
    with pytest.raises(ValueError, match="captured on a CUDA device, not on cpu"):
        CP.CapturedTrainIter(env, ts.net, TP.PPOConfig(num_steps_per_env=T), 2)


@pytest.mark.parametrize("device, world, want", [
    ("cpu", None, False), ("cpu", 1, False), ("cuda", None, True), ("cuda", 1, True),
    ("cuda", 2, True), ("cpu", 2, False)])
def test_which_iteration_runs(device, world, want):
    """Captured on a CUDA device at any world size (under two ranks, gloo,
    cut at each all-reduce); eager on the CPU, which has no graphs."""
    group = None if world is None else EnvGroup(rank=0, world=world, device=torch.device(device),
                                                backend="gloo")
    assert CP.captures(torch.device(device), group) is want


def test_cut_plan_of_one_process_is_one_segment():
    """`CutGraphs` without graphs at world size 1: the body runs once,
    eagerly, with no cut (no collective runs), its result bit-equal to the
    plain body's from the same snapshot; nothing to replay."""
    env, ts, pieces, inputs, gen = _setup("humanoid_ppo", "apgd")
    generators = [gen, *env.generators()]
    snap = [t.clone() for t in CP.train_state_tensors(ts)], [g.get_state() for g in generators]
    perm = pieces["draw_permutation"](ts, gen)

    def side(run):
        with torch.no_grad():
            for t, s in zip(CP.train_state_tensors(ts), snap[0]):
                t.copy_(s)
        for g, s in zip(generators, snap[1]):
            g.set_state(s)
        *new, mets = run(lambda: pieces["iteration_body"](ts, *CP.clone_tree(inputs), gen, perm))
        return ([t.clone() for t in CP.train_state_tensors(ts) + CP.tensor_leaves(new)]
                + [mets[k] for k in sorted(mets)])

    plain = side(lambda body: body())
    cuts = CP.CutGraphs(None, generators, graphs=False)
    assert all(torch.equal(a, b) for a, b in zip(plain, side(cuts.record)))
    assert cuts.buffers == [] and cuts.segments == []
    with pytest.raises(RuntimeError, match="nothing was captured"):
        cuts.replay()


def test_cut_plan_releases_the_group_when_the_body_raises():
    """The group's collectives go back to running at once after a
    recording, also one whose body raised."""
    group = EnvGroup(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    cuts = CP.CutGraphs(group, graphs=False)

    def body():
        assert group.on_collective == cuts._cut
        raise KeyError("body")

    with pytest.raises(KeyError, match="body"):
        cuts.record(body)
    assert group.on_collective is None


def test_runner_runs_the_eager_iteration_on_the_cpu():
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    env, _ = registry.make_env("humanoid_ppo", num_envs=2, device="cpu", seed=0,
                               cfg_overrides=lambda c: _quiet(c, 2, 2))
    tcfg = XBotLCfgPPO()
    tcfg.runner.num_steps_per_env = T
    runner = OnPolicyRunner(env, tcfg, log_dir=None)
    assert not isinstance(runner._train_iter, CP.CapturedTrainIter)
    assert callable(runner._train_iter)
