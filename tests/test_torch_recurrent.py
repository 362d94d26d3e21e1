"""The recurrent actor-critic (networks.ActorCriticRecurrent,
algo/recurrent.py) against the benchmark's plain reference of it
(benchmark/reference/recurrent.py: rsl_rl's nn.LSTM memories, split-and-pad
BPTT), on the CPU with seeded random weights, a few envs and T = 8, dones
forced at known rows.

Tolerances: both sides compute in float32 on the CPU, in different orders
(one fused scan of both memories against nn.LSTM, trajectory by
trajectory), so outputs agree to ~1e-6 relative; TOL = 1e-5 leaves ten
times that. The planted faults (no reset at a done, the start state zeroed
instead of carried over) move the outputs by 1e-2 or more, a thousand
times TOL. Also here: the memory carried from iteration to iteration and
through the captured iteration's replays (its warm-up and static buffers,
with a stand-in for the CUDA graph on the CPU), the checkpoint, the
exported TorchScript policy, and the MLP path bit-equal to the frozen copy
of the parent's (benchmark/reference/hgt_ref).
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import recurrent as ref  # noqa: E402
from humanoid_gym_tpu_torch.algo import capture, ppo  # noqa: E402
from humanoid_gym_tpu_torch.algo.networks import (  # noqa: E402
    ActorCriticRecurrent,
    MemoryPolicy,
    actor_critic_from_cfg,
    lstm_scan,
    reset_memory,
)
from humanoid_gym_tpu_torch.algo.recurrent import make_recurrent_pieces  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
O, P, A, H, T, N = 11, 7, 3, 6, 8, 5
# forced dones: env 0 at rows 2 and 5, env 1 at 7, env 2 never, env 3 at 0,
# env 4 at 3 and 4 (a one-row trajectory)
DONE_AT = {0: (2, 5), 1: (7,), 3: (0,), 4: (3, 4)}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def _nets(layers=1, seed=4):
    port = ActorCriticRecurrent(O, P, A, (5,), (4,), 0.8, "lstm", H, layers, "float32", seed)
    plain = ref.ActorCriticRecurrent(O, P, A, (5,), (4,), 0.8, H, layers, seed)
    return port, plain


def _rows(seed=0, layers=1, n=N):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(T, n, O, generator=g)
    priv = torch.randn(T, n, P, generator=g)
    dones = torch.zeros(T, n, dtype=torch.bool)
    for env, rows in DONE_AT.items():
        if env < n:
            dones[list(rows), env] = True
    memory0 = tuple(0.5 * torch.randn(layers, n, H, generator=g) for _ in range(4))
    return obs, priv, dones, memory0


@pytest.mark.parametrize("layers", [1, 2])
def test_the_weights_are_the_references(layers):
    """Both draw rsl_rl's init from the seed in one order: exactly equal."""
    port, plain = _nets(layers)
    mine = dict(port.named_parameters())
    theirs = dict(plain.named_parameters())
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)


@pytest.mark.parametrize("layers", [1, 2])
def test_rollout_steps_match_rsl_rls_rollout(layers):
    """The rollout's memory step a row, zeroed after a done, against the
    reference's inference-mode steps with `reset(dones)`."""
    port, plain = _nets(layers)
    obs, priv, dones, memory0 = _rows(layers=layers)
    means, values = [], []
    memory = memory0
    with torch.no_grad():
        for t in range(T):
            out_a, out_c, memory = port.memory_steps(obs[t:t + 1], priv[t:t + 1], memory)
            mean, _, value = port.heads(out_a[0], out_c[0])
            means.append(mean)
            values.append(value)
            memory = reset_memory(memory, dones[t])
    want_mu, want_v, _ = ref.collect(plain, obs, priv, dones, memory0)
    assert _rel(torch.stack(means), want_mu) < TOL
    assert _rel(torch.stack(values), want_v) < TOL
    # the state after the last row: what the reference's memories keep
    ha, hc = plain.get_hidden_states()
    for got, want in zip(memory, (*ha, *hc)):
        assert _rel(got, want) < TOL


def _scan_and_reference(layers, planted=None):
    """(port outputs and gradients, reference outputs and gradients) of
    the masked scan over the rows against rsl_rl's split-and-pad, for the
    loss sum(mean * w) + sum(value * v) with fixed random weights w, v."""
    port, plain = _nets(layers)
    obs, priv, dones, memory0 = _rows(layers=layers)
    g = torch.Generator().manual_seed(9)
    w, v = torch.randn(T, N, A, generator=g), torch.randn(T, N, generator=g)
    scan_dones = torch.zeros_like(dones) if planted == "no_reset" else dones
    scan_memory = tuple(torch.zeros_like(m) for m in memory0) if planted == "zero_start" \
        else memory0
    out_a, out_c, _ = port.memory_steps(obs, priv, scan_memory, scan_dones)
    mean, _, value = port.heads(out_a, out_c)
    loss = (mean * w).sum() + (value * v).sum()
    names, params = zip(*port.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params, materialize_grads=True)))
    _, _, saved = ref.collect(plain, obs, priv, dones, memory0)
    want_mu, want_v = ref.rows_forward(plain, obs, priv, dones, saved)
    loss = (want_mu * w).sum() + (want_v * v).sum()
    names, params = zip(*plain.named_parameters())
    want = dict(zip(names, torch.autograd.grad(loss, params, materialize_grads=True)))
    return (mean, value, got), (want_mu, want_v, want)


@pytest.mark.parametrize("layers", [1, 2])
def test_masked_scan_matches_split_and_pad(layers):
    """The update's scan over whole env rows from the rows' start state,
    zeroed after each done: means, values and every parameter's gradient
    as rsl_rl's padded trajectories give them."""
    (mean, value, got), (want_mu, want_v, want) = _scan_and_reference(layers)
    assert _rel(mean, want_mu) < TOL and _rel(value, want_v) < TOL
    for k in want:
        if k != "std":  # the loss does not reach the std
            assert _rel(got[k], want[k]) < TOL, k


@pytest.mark.parametrize("planted", ["no_reset", "zero_start"])
def test_a_planted_fault_exceeds_the_tolerance(planted):
    """No reset at a done, or the start state zeroed instead of carried
    over: the outputs and gradients move by far more than TOL."""
    (mean, value, got), (want_mu, want_v, want) = _scan_and_reference(1, planted)
    assert max(_rel(mean, want_mu), _rel(value, want_v)) > 1000 * TOL
    assert max(_rel(got[k], want[k]) for k in want if k != "std") > 1000 * TOL


def _minibatch(seed=1):
    """One minibatch of the update (the rollout's fields and start memory for
    N env rows), random but consistent."""
    obs, priv, dones, memory0 = _rows(seed)
    g = torch.Generator().manual_seed(seed + 10)
    mu = 0.3 * torch.randn(T, N, A, generator=g)
    sigma = torch.full((T, N, A), 0.8)
    act = mu + sigma * torch.randn(T, N, A, generator=g)
    from humanoid_gym_tpu_torch.algo.networks import normal_log_prob

    logp = normal_log_prob(mu, sigma, act) + 0.05 * torch.randn(T, N, generator=g)
    values = torch.randn(T, N, generator=g)
    adv, ret = torch.randn(T, N, generator=g), values + 0.3 * torch.randn(T, N, generator=g)
    return (obs, priv, act, logp, values, adv, ret, mu, sigma, dones, memory0)


def test_minibatch_update_matches_the_reference():
    """One minibatch step of algo/recurrent.py (the gradient taken in its two
    parts, then ppo.apply_update) against the reference's loss and step
    over split-and-padded trajectories: the loss terms, the Adam first
    moments and the parameters after."""
    port, plain = _nets()
    cfg = ppo.PPOConfig(learning_rate=1e-3)
    ts = ppo.init_train_state(port, cfg.learning_rate, N)
    pieces = make_recurrent_pieces(None, port, cfg, N)
    mb = _minibatch()
    _, metrics = pieces["minibatch_update"](ts, mb)
    obs, priv, act, logp, values, adv, ret, mu, sigma, dones, memory0 = mb
    rts = ppo.TrainState(net=plain, opt_mu={k: torch.zeros_like(p) for k, p in
                                            plain.named_parameters()},
                         opt_nu={k: torch.zeros_like(p) for k, p in plain.named_parameters()},
                         opt_count=torch.zeros((), dtype=torch.int32),
                         lr=torch.tensor(cfg.learning_rate), iteration=0)
    _, _, saved = ref.collect(plain, obs, priv, dones, memory0)
    mean, value = ref.rows_forward(plain, obs, priv, dones, saved)
    rmb = {"actions": act, "log_probs": logp, "values": values, "adv": adv, "ret": ret,
           "mu": mu, "sigma": sigma}
    loss, kl, terms = ref.ppo_loss(cfg, plain, rmb, mean, value)
    ref.ppo_step(cfg, rts, loss, kl)
    for k in ("surrogate_loss", "value_loss", "entropy"):
        want = float(terms[k].detach())
        assert abs(float(metrics[k]) - want) <= TOL * abs(want), k
    assert abs(float(metrics["kl"]) - float(kl)) <= TOL * abs(float(kl)) + 1e-9
    for k, p in plain.named_parameters():
        assert _rel(ts.opt_mu[k], rts.opt_mu[k]) < 1e-4, k
        assert _rel(dict(port.named_parameters())[k], p) < TOL, k
    assert float(ts.lr) == float(rts.lr)


def _flat_env(n=4, seed=7):
    from humanoid_gym_tpu_torch import registry

    def apgd(c):
        c.sim.solver.solver_type = "apgd"

    env, cfg = registry.make_env("humanoid_ppo_lstm", num_envs=n, cfg_overrides=apgd,
                                 device="cpu", seed=seed)
    tcfg = registry.get_task("humanoid_ppo_lstm").make_train_cfg()
    return env, cfg, tcfg


def _train_parts(horizon=3, n=4):
    env, cfg, tcfg = _flat_env(n)
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=2,
                                class_name=tcfg.runner.policy_class_name)
    pc = ppo.PPOConfig.from_cfg(tcfg.algorithm)
    pc.num_steps_per_env = horizon
    ts = ppo.init_train_state(net, pc.learning_rate, n)
    gen = torch.Generator()
    gen.manual_seed(1)
    return env, net, pc, ts, gen


def test_the_memory_carries_from_iteration_to_iteration():
    """Each iteration's rollout starts from the memory the last one left,
    as the plain reference carries it: zeros before the first, then its
    rows with resets and the critic's step on the last privileged obs
    (rsl_rl's last value keeps that state). Held to the reference's
    nn.LSTM memories: the rollout's means and values, and the train
    state's memory after each iteration."""
    env, net, pc, ts, gen = _train_parts()
    _, cfg, tcfg = _flat_env()
    p = tcfg.policy
    plain = ref.ActorCriticRecurrent(
        cfg.env.num_observations, cfg.env.num_privileged_obs, cfg.env.num_actions,
        tuple(p.actor_hidden_dims), tuple(p.critic_hidden_dims), p.init_noise_std,
        p.rnn_hidden_size, p.rnn_num_layers, 0)
    pieces = ppo.make_train_pieces(env, net, pc, 4)
    rolls = []
    real = ppo.Rollout

    def record(*a, **k):
        rolls.append(real(*a, **k))
        return rolls[-1]

    ppo.Rollout = record
    try:
        inputs = env.reset_all()
        memory = tuple(torch.zeros_like(m) for m in ts.memory)
        for _ in range(2):
            with torch.no_grad():
                for k, v in plain.named_parameters():
                    v.copy_(dict(net.named_parameters())[k])
            _, *inputs, _ = pieces["train_iter"](ts, *inputs, gen)
            roll = rolls[-1]
            assert type(roll) is real
            want_mu, want_v, _ = ref.collect(plain, roll.obs, roll.priv_obs, roll.dones, memory)
            assert _rel(roll.mu, want_mu) < TOL and _rel(roll.values, want_v) < TOL
            with torch.no_grad():
                plain.evaluate(inputs[2])  # the last value: the critic keeps its step
            ha, hc = plain.get_hidden_states()
            memory = (*ha, *hc)
            for got, want in zip(ts.memory, memory):
                assert _rel(got, want) < TOL
    finally:
        ppo.Rollout = real
    assert float(memory[2].abs().sum()) > 0.0
    assert len(rolls) == 2


def test_warm_up_restores_the_memory():
    """The capture's warm-up puts the memory back with the rest of the
    train state (`capture.train_state_tensors` holds it)."""
    env, net, pc, ts, gen = _train_parts()
    pieces = ppo.make_train_pieces(env, net, pc, 4)
    inputs = capture.clone_tree(env.reset_all())
    perm = pieces["draw_permutation"](ts, gen)
    before = [t.clone() for t in ts.memory]
    assert len(capture.train_state_tensors(ts)) == 3 * len(list(net.parameters())) + 2 + 4
    capture.warm_up(lambda: pieces["iteration_body"](ts, *inputs, gen, perm), ts, inputs,
                    [gen, *env.generators()])
    assert all(torch.equal(a, b) for a, b in zip(ts.memory, before))


class _EagerGraph:
    """A stand-in for the CUDA graph on the CPU: `record` keeps the body and
    runs nothing (a capture computes nothing), `replay` runs the body again
    and writes its metrics into the recorded ones, as a replay rewrites the
    graph's static tensors."""

    def __init__(self, group, generators=(), graphs=True):
        self.buffers, self.metrics = [], {}

    def record(self, body):
        self.body = body
        return self.metrics

    def replay(self):
        for k, v in self.body().items():
            if k in self.metrics:
                self.metrics[k].copy_(v)
            else:
                self.metrics[k] = v


def test_captured_replays_carry_the_memory_as_eager(monkeypatch):
    """The captured iteration (warm-up, static inputs, the permutation drawn
    into its static tensor, the memory in the train state) over 3 calls
    against 3 eager iterations from one snapshot: equal train state,
    memory, env state, obs and metrics. On the CPU the graph is a stand-in
    that runs the body at each replay (the card's test,
    tests/test_torch_cuda.py, replays the real graph)."""
    env, net, pc, ts, gen = _train_parts()
    inputs0 = capture.clone_tree(env.reset_all())
    gens = [gen, *env.generators()]
    snap = ([t.detach().clone() for t in capture.train_state_tensors(ts)],
            [g.get_state() for g in gens])

    def restore():
        with torch.no_grad():
            for t, v in zip(capture.train_state_tensors(ts), snap[0]):
                t.copy_(v)
        ts.iteration = 0
        for g, v in zip(gens, snap[1]):
            g.set_state(v)
        return capture.clone_tree(inputs0)

    def run(train_iter):
        inputs = restore()
        outs = []
        for _ in range(3):
            _, *inputs, metrics = train_iter(ts, *inputs, gen)
            outs.append([t.detach().clone() for t in capture.train_state_tensors(ts)]
                        + [t.clone() for t in capture.tensor_leaves(inputs)]
                        + [metrics[k].clone() for k in sorted(metrics)])
        return outs

    eager = run(ppo.make_train_iter(env, net, pc, 4))
    monkeypatch.setattr(capture, "captures", lambda device, group=None: True)
    monkeypatch.setattr(capture, "CutGraphs", _EagerGraph)
    monkeypatch.setattr(capture.torch.cuda, "synchronize", lambda *a: None)
    captured = run(capture.CapturedTrainIter(env, net, pc, 4))
    for a_it, b_it in zip(captured, eager):
        assert len(a_it) == len(b_it)
        assert all(torch.equal(a, b) for a, b in zip(a_it, b_it))


@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_joint_ppo"])
def test_mlp_iterations_equal_the_frozen_copy(task):
    """The MLP actor-critic's path is the parent's: two training iterations
    bit-equal to the frozen copy of the port's plain path (hgt_ref)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark", "reference"))
    try:
        import hgt_ref.algo.networks as rnet
        import hgt_ref.algo.ppo as rppo
        import hgt_ref.registry as rreg
    finally:
        sys.path.pop(0)
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo import networks

    def apgd(c):
        c.sim.solver.solver_type = "apgd"

    outs = []
    for reg, nets, pp in ((registry, networks, ppo), (rreg, rnet, rppo)):
        env, cfg = reg.make_env(task, num_envs=4, cfg_overrides=apgd, device="cpu", seed=11)
        tcfg = reg.get_task(task).make_train_cfg()
        net = nets.actor_critic_from_cfg(cfg.env, tcfg.policy, seed=3)
        pc = pp.PPOConfig.from_cfg(tcfg.algorithm)
        pc.num_steps_per_env = 3
        ts = pp.init_train_state(net, pc.learning_rate)
        train_iter = pp.make_train_iter(env, net, pc, 4)
        gen = torch.Generator()
        gen.manual_seed(5)
        inputs = env.reset_all()
        for _ in range(2):
            ts, *inputs, metrics = train_iter(ts, *inputs, gen)
        outs.append([p.detach() for p in net.parameters()] + list(ts.opt_mu.values())
                    + list(inputs[1:]) + [metrics[k] for k in sorted(metrics)])
    assert len(outs[0]) == len(outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_checkpoint_keeps_the_memory(tmp_path):
    """The runner saves the memory with the train state and restores it
    into a runner of the same size; one of another size keeps its own."""
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    env, _, tcfg = _flat_env()
    tcfg.runner.num_steps_per_env = 2
    runner = OnPolicyRunner(env, tcfg, log_dir=str(tmp_path), seed=3)
    runner.learn(1)
    path = str(tmp_path / "model_1.ckpt")
    saved = torch.load(path, weights_only=True)["train_state"]["memory"]
    assert [tuple(m.shape) for m in saved] == [(1, 4, 64)] * 4
    assert all(torch.equal(a, b) for a, b in zip(saved, runner.train_state.memory))
    other = OnPolicyRunner(env, tcfg, log_dir=None, seed=4)
    other.load(path)
    assert all(torch.equal(a, b) for a, b in zip(other.train_state.memory, saved))
    small_env, _, _ = _flat_env(n=1)
    small = OnPolicyRunner(small_env, tcfg, log_dir=None, seed=4)
    small.load(path)
    assert all(float(m.abs().sum()) == 0.0 for m in small.train_state.memory)


def test_exported_policy_carries_its_memory(tmp_path):
    """The TorchScript policy (legged_gym's PolicyExporterLSTM) over 20
    steps with `reset_memory()` before step 10, against the training net's
    means from its memory steps with the state zeroed at the same step, and
    against the runner's inference policy."""
    from humanoid_gym_tpu_torch.export import export_policy, load_policy

    net = ActorCriticRecurrent(705, 219, 12, (32,), (32,), 0.8, "lstm", 64, 1, "float32", 2)
    written = export_policy(net, str(tmp_path))
    assert [os.path.basename(p) for p in written] == ["policy_jit.pt"]
    module = torch.jit.load(written[0])
    policy, inference = load_policy(written[0]), MemoryPolicy(net)
    obs = torch.randn(20, 705, generator=torch.Generator().manual_seed(0))
    memory = net.initial_memory(1, "cpu")
    for t in range(20):
        if t == 10:
            module.reset_memory()
            policy.reset()
            inference.reset()
            memory = tuple(torch.zeros_like(m) for m in memory)
        with torch.no_grad():
            out_a, _, memory = net.memory_steps(obs[t:t + 1, None], torch.zeros(1, 1, 219),
                                                memory)
            want = net.actor(out_a[0])[0]
            got = module(obs[t])
        assert float((got - want).abs().max()) < 1e-5
        assert float((torch.from_numpy(policy(obs[t].numpy())) - want).abs().max()) < 1e-5
        assert float((inference(obs[t:t + 1])[0] - want).abs().max()) < 1e-5
    # a batch of one gives the same, and the module's buffers are its memory
    assert module(obs[0][None]).shape == (1, 12)
    assert module.hidden_state.shape == (1, 1, 64)


def test_the_policy_class_and_its_limits():
    """The runner's policy_class_name picks the net; an unknown one, a
    recurrent net without an env count for its memory, a recurrent net
    under several ranks and a non-LSTM memory are refused."""
    from types import SimpleNamespace

    _, cfg, tcfg = _flat_env()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, class_name="ActorCriticRecurrent")
    assert net.is_recurrent and net.memory_a.hidden_size == 64
    assert [p.shape for p in net.actor.parameters()] == [(32, 64), (32,), (12, 32), (12,)]
    with pytest.raises(ValueError, match="policy_class_name"):
        actor_critic_from_cfg(cfg.env, tcfg.policy, class_name="ActorCriticTransformer")
    with pytest.raises(ValueError, match="num_envs"):
        ppo.init_train_state(net, 1e-3)
    with pytest.raises(ValueError, match="one rank"):
        make_recurrent_pieces(None, net, ppo.PPOConfig(), 4, SimpleNamespace(world=2))
    with pytest.raises(ValueError, match="LSTM"):
        ActorCriticRecurrent(O, P, A, rnn_type="gru")


def test_play_and_sim2sim_step_the_recurrent_policy(tmp_path, monkeypatch):
    """scripts/play_torch.py on a recurrent checkpoint: it exports the
    TorchScript policy alone and steps the runner's inference policy (its
    memory zeroed where the env is done) for 20 steps; then the exported
    policy walks 0.3 s of the MuJoCo sim2sim loop (scripts/sim2sim_torch.py's
    `run_mujoco`), its memory carried from step to step."""
    import importlib.util

    import numpy as np

    from humanoid_gym_tpu_torch import XBOT_MJCF
    from humanoid_gym_tpu_torch.export import load_policy
    from humanoid_gym_tpu_torch.export.sim2sim import Sim2SimCfg, run_mujoco
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.utils.helpers import get_args

    monkeypatch.setenv("HGT_WANDB", "0")
    monkeypatch.setenv("HGT_PLAY_VIDEO", "0")
    env, _, tcfg = _flat_env(n=1)
    os.makedirs(tmp_path / "run0")
    OnPolicyRunner(env, tcfg, log_dir=None, seed=3).save(str(tmp_path / "run0" / "model_1.ckpt"))
    spec = importlib.util.spec_from_file_location(
        "play_torch_recurrent", os.path.join(ROOT, "scripts", "play_torch.py"))
    play = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(play)
    res = play.play(get_args(["--task", "humanoid_ppo_lstm", "--log_root", str(tmp_path),
                              "--device", "cpu"]), n_steps=20)
    assert [os.path.basename(p) for p in res["exported"]] == ["policy_jit.pt"]
    trace = np.load(res["trace"])
    assert all(np.isfinite(trace[k]).all() for k in play.TRACE_KEYS)
    out = run_mujoco(load_policy(res["exported"][0]),
                     Sim2SimCfg(mujoco_model_path=XBOT_MJCF, sim_duration=0.3))
    assert out["duration_s"] == 0.3 and 0.5 < out["mean_height"] < 1.5
