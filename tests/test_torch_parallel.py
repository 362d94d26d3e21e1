"""Env-sharded training of the port over two CPU processes (gloo), against
the JAX package and against one process.

The ranks are spawned by `humanoid_gym_tpu_torch.parallel.launch.RankJob` and meet
through a file rendezvous in the test's tmp_path (no TCP port, so parallel
test workers never collide); they import no JAX. The JAX side runs in the
test's own process with the JAX package's functions, on the whole batch
that the ranks split by the membership rule of `make_train_pieces`: a row
of the global T x N batch belongs to the rank that holds its env."""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.algo import networks as JN
from humanoid_gym_tpu.algo import ppo as JP
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_flax
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
from humanoid_gym_tpu_torch.parallel import EnvGroup, local_env_slice, rank_seed, shard_path
from humanoid_gym_tpu_torch.parallel.launch import RankJob
from humanoid_gym_tpu_torch.runner import OnPolicyRunner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O, P, A = 705, 219, 12
WORLD = 2
# the calls that build a tensor from host data, read one back or move one
# between devices (Tensor.to counted where it names a device; the first five
# as in tests/test_torch_env.py)
HOST_DATA_CALLS = ((torch, "tensor"), (torch, "as_tensor"), (torch.Tensor, "tolist"),
                   (torch.Tensor, "item"), (torch.Tensor, "cpu"), (torch.Tensor, "to"))

# One rank's program. argv: case, working dir, tag. It joins the group
# through a file in the working dir, runs the case and saves what the test
# compares as <dir>/<tag>_rank<r>.pt.
WORKER = r'''
import dataclasses, os, sys
sys.path.insert(0, os.environ["HGT_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from humanoid_gym_tpu_torch.parallel import make_env_group
case, work, tag = sys.argv[1], sys.argv[2], sys.argv[3]
group = make_env_group("gloo", device="cpu", init_method=f"file://{work}/rdv_{tag}")
r = group.rank
out = {}

if case == "update":
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic
    from humanoid_gym_tpu_torch.algo import ppo as TP
    inp = torch.load(f"{work}/update_in.pt", weights_only=False)  # written by the test
    T, N = inp["T"], inp["N"]
    lo, hi = r * N // group.world, (r + 1) * N // group.world

    def fresh_net():
        net = ActorCritic(705, 219, 12)
        net.load_state_dict(inp["params"])
        return net

    def block(x):  # this rank's envs of a (T, N, ...) array
        return torch.from_numpy(x[:, lo:hi].copy())

    # (b) minibatch updates: one minibatch of the whole batch, permuted
    cfg = TP.PPOConfig(learning_rate=inp["lr"], num_steps_per_env=T, num_mini_batches=1)
    net = fresh_net()
    ts = TP.init_train_state(net, inp["lr"])
    pieces = TP.make_train_pieces(None, net, cfg, N, group)
    out["mb_rows"], out["mb_metrics"] = [], []
    for mb_np, perm in zip(inp["minibatches"], inp["perms"]):
        rows, weight, _ = pieces["minibatch_rows"](torch.from_numpy(perm))
        mb = tuple(block(x).reshape((-1,) + x.shape[2:])[rows[0]] for x in mb_np) + (weight[0],)
        ts, mets = pieces["minibatch_update"](ts, mb)
        out["mb_rows"].append(rows[0][weight[0] > 0])
        out["mb_metrics"].append({k: float(v) for k, v in mets.items()})
    out["mb_params"] = {k: v.clone() for k, v in net.state_dict().items()}
    out["mb_lr"] = float(ts.lr)
    out["mb_opt"] = torch.cat([v.reshape(-1) for d in (ts.opt_mu, ts.opt_nu) for v in d.values()])

    # (c) GAE and the global advantage normalisation, and the update phase
    # (2 epochs x 2 minibatches over one permutation) sharded; rank 0 also
    # runs it as one process on the whole rollout
    cfg = TP.PPOConfig(learning_rate=inp["lr"], num_steps_per_env=T, num_mini_batches=2)
    names = ("obs", "priv_obs", "actions", "mu", "sigma", "log_probs", "values", "rewards", "dones")

    def phases(g, cut):
        net = fresh_net()
        ts = TP.init_train_state(net, inp["lr"])
        pc = TP.make_train_pieces(None, net, cfg, N, g)
        roll = TP.Rollout(**{k: cut(inp["rollout"][k]) for k in names})
        adv, ret = pc["compute_gae"](ts, roll, cut(inp["last_priv"][None])[0])
        gen = torch.Generator().manual_seed(inp["perm_seed"])
        ts, mets = pc["update_phase"](ts, roll, adv, ret, gen)
        return adv, ret, {k: v.clone() for k, v in net.state_dict().items()}, mets

    out["adv"], out["ret"], out["upd_params"], mets = phases(group, block)
    out["upd_metrics"] = {k: float(v) for k, v in mets.items()}
    # the padded split of that update phase's permutation
    perm = torch.randperm(T * N, generator=torch.Generator().manual_seed(inp["perm_seed"]))
    split_of = TP.make_train_pieces(None, fresh_net(), cfg, N, group)["minibatch_rows"]
    out["upd_split"] = split_of(perm)
    if r == 0:
        _, _, out["single_params"], mets = phases(None, torch.from_numpy)
        out["single_metrics"] = {k: float(v) for k, v in mets.items()}

elif case == "hostcalls":
    # one train_iter of 8 global envs (4 a rank, T = 2) after a warm-up
    # one, with the test's HOST_DATA_CALLS counted
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo import ppo as TP
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic

    env, _ = registry.make_env("humanoid_ppo", num_envs=8, device="cpu", seed=0, group=group,
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    net = ActorCritic(705, 219, 12, seed=0)
    cfg = TP.PPOConfig(num_steps_per_env=2, num_mini_batches=2, num_learning_epochs=1)
    train_iter = TP.make_train_iter(env, net, cfg, 8, group, perm_seed=5)
    ts = TP.init_train_state(net, cfg.learning_rate)
    state, obs, priv = env.reset_all()
    gen = torch.Generator().manual_seed(r)
    ts, state, obs, priv, _ = train_iter(ts, state, obs, priv, gen)
    counts = {}
    for owner, name in ((torch, "tensor"), (torch, "as_tensor"), (torch.Tensor, "tolist"),
                        (torch.Tensor, "item"), (torch.Tensor, "cpu"), (torch.Tensor, "to")):
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **k):
            moves = k.get("device") is not None or any(
                isinstance(x, (torch.device, str, torch.Tensor)) for x in a[1:])
            if _name != "to" or moves:  # Tensor.to only where it names a device
                counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        setattr(owner, name, counted)
    ts, state, obs, priv, mets = train_iter(ts, state, obs, priv, gen)
    out["counts"] = counts
    out["value_loss"] = float(mets["value_loss"])

elif case == "cuts":
    # the iteration of 8 global envs (4 a rank, T = 2, the recipe's 2 epochs
    # x 4 minibatches) as CutGraphs' eager segments against the plain body,
    # from one snapshot, with the command curriculum off and on; then with
    # the split forced to 1 row, the overflow's error
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo import capture as CP
    from humanoid_gym_tpu_torch.algo import ppo as TP
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic

    def build(curriculum):
        def ov(c):
            c.sim.solver.solver_type = "apgd"
            c.commands.curriculum = curriculum
        env, _ = registry.make_env("humanoid_ppo", num_envs=8, device="cpu", seed=0, group=group,
                                   cfg_overrides=ov)
        net = ActorCritic(705, 219, 12, seed=0)
        cfg = TP.PPOConfig(num_steps_per_env=2)
        pieces = TP.make_train_pieces(env, net, cfg, 8, group, perm_seed=5)
        gen = torch.Generator().manual_seed(r)
        ts = TP.init_train_state(net, cfg.learning_rate)
        return env, pieces, ts, gen, [gen, *env.generators()]

    for curriculum in (False, True):
        env, pieces, ts, gen, gens = build(curriculum)
        inputs = env.reset_all()
        snap_ts = [t.detach().clone() for t in CP.train_state_tensors(ts)]
        snap_gens = [g.get_state() for g in gens]
        perm = pieces["draw_permutation"](ts, gen)

        def side(run):
            with torch.no_grad():
                for t, s in zip(CP.train_state_tensors(ts), snap_ts):
                    t.copy_(s)
            for g, s in zip(gens, snap_gens):
                g.set_state(s)
            n0 = group.collectives
            body = pieces["iteration_body"]
            *new, mets = run(lambda: body(ts, *CP.clone_tree(inputs), gen, perm))
            kept = [t.detach().clone() for t in CP.train_state_tensors(ts) + CP.tensor_leaves(new)]
            return kept + [mets[k] for k in sorted(mets)], group.collectives - n0

        plain, n_plain = side(lambda body: body())
        cuts = CP.CutGraphs(group, gens, graphs=False)
        segmented, n_seg = side(cuts.record)
        out[f"curriculum{int(curriculum)}"] = {
            "cuts": len(cuts.buffers), "collectives": [n_plain, n_seg],
            "equal": len(plain) == len(segmented) and all(
                torch.equal(a, b) for a, b in zip(plain, segmented)),
            "train_state": segmented[:len(snap_ts)]}

    TP.split_rows = lambda *a: 1
    env, pieces, ts, gen, _ = build(False)
    mets = pieces["train_iter"](ts, *env.reset_all(), gen)[-1]
    try:
        TP.check_minibatch_split(mets)
    except RuntimeError as e:
        out["overflow"] = str(e)

elif case in ("train", "resume"):
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.runner.on_policy_runner import _env_state_to_saved

    def ov(c):
        c.sim.solver.solver_type = "apgd"

    tcfg = XBotLCfgPPO()
    tcfg.runner.num_steps_per_env = 2
    tcfg.runner.save_interval = 100
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 1
    env, _ = registry.make_env("humanoid_ppo", num_envs=8, cfg_overrides=ov, device="cpu", seed=0,
                               group=group)
    if case == "train":
        runner = OnPolicyRunner(env, tcfg, log_dir=f"{work}/run_{tag}_rank{r}", seed=5)
        out["ckpt_dir"] = runner._ckpt_dir
        runner.learn(2, init_at_random_ep_len=True)
        out["scalars"] = runner.last_scalars
    else:
        runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=123)
        runner.load(sys.argv[4])
        out["iter"] = runner.current_learning_iteration
    out["env_state"] = _env_state_to_saved(runner.env_state)
    out["obs"], out["priv_obs"] = runner.obs.clone(), runner.priv_obs.clone()
    ts = runner.train_state
    out["params"] = {k: v.clone() for k, v in runner.net.state_dict().items()}
    out["opt"] = torch.cat([v.reshape(-1) for d in (ts.opt_mu, ts.opt_nu) for v in d.values()])
    out["lr"], out["opt_count"] = float(ts.lr), ts.opt_count
    if case == "resume":
        runner.learn(1)
        out["after_iter"] = runner.current_learning_iteration
        out["after_scalars"] = runner.last_scalars
        # the same world size with another env count refuses the shards
        small, _ = registry.make_env("humanoid_ppo", num_envs=4, cfg_overrides=ov, device="cpu",
                                     seed=0, group=group)
        try:
            OnPolicyRunner(small, tcfg, log_dir=None, seed=1).load(sys.argv[4])
        except ValueError as e:
            out["count_mismatch"] = str(e)

torch.save(out, f"{work}/{tag}_rank{r}.pt")
group.close()
'''


def _spawn(tmp_path, case, tag, *extra):
    """Run WORKER's `case` on WORLD gloo ranks; each rank's saved dict."""
    script = tmp_path / "worker.py"
    if not script.exists():
        script.write_text(WORKER)
    env = dict(os.environ, HGT_REPO=ROOT, OMP_NUM_THREADS="1")
    RankJob([sys.executable, str(script), case, str(tmp_path), tag, *extra], WORLD, env).wait(240)
    return [torch.load(tmp_path / f"{tag}_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_local_env_slice_and_rank_seeds():
    """(start, count) of each rank's block; a world size that does not
    divide the env count raises; rank seeds are the seed itself at world
    size 1 and distinct per rank otherwise."""
    groups = [EnvGroup(rank=r, world=4, device=torch.device("cpu"), backend="gloo")
              for r in range(4)]
    assert [local_env_slice(4096, g) for g in groups] == [(0, 1024), (1024, 1024),
                                                         (2048, 1024), (3072, 1024)]
    assert local_env_slice(8, None) == (0, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        local_env_slice(10, groups[1])
    one = EnvGroup(rank=0, world=1, device=torch.device("cpu"), backend="gloo")
    assert rank_seed(5, None) == rank_seed(5, one) == 5
    seeds = [rank_seed(5, g) for g in groups]
    assert len(set(seeds)) == 4 and 5 not in seeds
    assert shard_path("run/model_3.ckpt", 1) == "run/model_3.ckpt.envshard1"


def test_joint_env_rank_blocks_and_minibatch_rows():
    """The joint XBot-L + XBot-S batch of 8 global envs (4 + 4) on rank 1 of
    2: a block of each robot (global envs 2-3 of the L half and 6-7 of the
    S half), each sub-env's generator seeded by sub_env_seed(rank_seed(seed,
    group), index); the minibatch membership rule takes exactly the rows of
    those envs, at their local positions, each minibatch's own rows
    first (the split is the whole minibatch here: C = 12)."""
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, make_train_pieces
    from humanoid_gym_tpu_torch.envs.joint import sub_env_seed

    g = EnvGroup(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    env, _ = registry.make_env("humanoid_joint_ppo", num_envs=8, device="cpu", seed=3, group=g,
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type",
                                                               "apgd"))
    assert env.counts == [2, 2] and env.num_envs == 4 and env.num_envs_global == 8
    assert [(e.env_offset, e.num_envs_global) for e in env.envs] == [(2, 4), (2, 4)]
    assert env.global_env_ids().tolist() == [2, 3, 6, 7]
    assert [e.gen.initial_seed() for e in env.envs] == [sub_env_seed(rank_seed(3, g), i)
                                                        for i in range(2)]
    T = 3
    pieces = make_train_pieces(env, None, PPOConfig(num_steps_per_env=T, num_mini_batches=2), 8, g)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(T * 8))
    rows, weight, own = pieces["minibatch_rows"](perm)
    local = {2: 0, 3: 1, 6: 2, 7: 3}
    want = [(int(x) // 8) * 4 + local[int(x) % 8] for x in perm if int(x) % 8 in local]
    assert rows.shape == weight.shape == (2, 12)
    assert rows[weight > 0].tolist() == want and int(own.sum()) == len(want) == T * 4
    assert own.tolist() == [sum(int(x) % 8 in local for x in perm[:12]),
                            sum(int(x) % 8 in local for x in perm[12:])]


@pytest.mark.parametrize("world, rank, T, N, n_mb", [
    (2, 0, 8, 8, 2), (2, 1, 8, 8, 4), (4, 3, 5, 8, 4), (2, 1, 60, 16, 4)])
def test_padded_split_keeps_each_minibatchs_rows(world, rank, T, N, n_mb):
    """The padded split of a random permutation, on rank `rank` of `world`
    (contiguous env blocks): each minibatch's kept rows are the rows the
    membership rule gives it (a global row's env on this rank, at its local
    position), in the permutation's order; every row after them points at
    row 0 with weight 0; the width is `split_rows` of the batch."""
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, make_train_pieces, split_rows

    g = EnvGroup(rank=rank, world=world, device=torch.device("cpu"), backend="gloo")
    pieces = make_train_pieces(None, None, PPOConfig(num_steps_per_env=T, num_mini_batches=n_mb),
                               N, g)
    perm = np.random.default_rng(T * N + rank).permutation(T * N)
    rows, weight, own = pieces["minibatch_rows"](torch.from_numpy(perm))
    n_local, m = N // world, T * N // n_mb
    split = split_rows(T * N, n_mb, T * n_local)
    assert rows.shape == weight.shape == (n_mb, split) and weight.dtype == torch.float32
    for i in range(n_mb):
        mine = [x for x in perm[i * m:(i + 1) * m] if x % N // n_local == rank]
        want = [(x // N) * n_local + x % N - rank * n_local for x in mine]
        assert int(own[i]) == len(want) <= split
        assert rows[i, :len(want)].tolist() == want
        assert weight[i, :len(want)].eq(1).all() and weight[i, len(want):].eq(0).all()
        assert rows[i, len(want):].eq(0).all()
    if (T, N) == (60, 16):  # the bound pads here: 174 rows for 240-row minibatches
        assert split == 174 and int(own.max()) < split


def test_split_rows_is_the_hypergeometric_bound():
    """C = mean + 8 standard deviations of the hypergeometric count of a
    rank's rows in a minibatch, clamped to min(m, own): 31,579 at 4096 envs,
    T = 60, 4 minibatches and 2 ranks (mean 30,720, sigma 107.3); the whole
    minibatch or the rank's rows where the bound passes them (tiny sizes);
    the moments behind it within 1% of 200,000 numpy draws."""
    from humanoid_gym_tpu_torch.algo.ppo import split_rows

    assert split_rows(60 * 4096, 4, 60 * 2048) == 31579
    assert split_rows(64, 1, 32) == 32  # one minibatch: exactly the rank's rows
    assert split_rows(64, 2, 32) == 32  # the bound (33) clamped
    assert split_rows(16, 4, 8) == 4  # the bound (10) clamped to m
    assert split_rows(960, 4, 480) == 174
    batch, m, own = 960, 240, 480
    draws = np.random.default_rng(0).hypergeometric(own, batch - own, m, size=200_000)
    p = own / batch
    assert abs(draws.mean() / (m * p) - 1) < 0.01
    assert abs(draws.var() / (m * p * (1 - p) * (batch - m) / (batch - 1)) - 1) < 0.01


def test_split_overflow_raises_and_names_the_counts(monkeypatch):
    """With the split forced below the rows a minibatch holds, the first C
    own rows are kept, `own` counts them all, and `check_minibatch_split`
    on the iteration's split raises with the counts; a split that holds
    them, and metrics of world size 1, pass."""
    from humanoid_gym_tpu_torch.algo import ppo as TP

    g = EnvGroup(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    cfg = TP.PPOConfig(num_steps_per_env=4, num_mini_batches=2)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(32))
    full = TP.make_train_pieces(None, None, cfg, 8, g)["minibatch_rows"](perm)
    monkeypatch.setattr(TP, "split_rows", lambda *a: 3)
    rows, weight, own = TP.make_train_pieces(None, None, cfg, 8, g)["minibatch_rows"](perm)
    assert rows.shape == (2, 3) and weight.eq(1).all() and torch.equal(own, full[2])
    assert torch.equal(rows, full[0][:, :3])
    counts = r"\[%d, %d\]" % tuple(own.tolist())
    with pytest.raises(RuntimeError, match=counts + ".*padded split of 3 rows"):
        TP.check_minibatch_split({"minibatch_own_rows": own,
                                  "minibatch_split_rows": torch.tensor(3)})
    TP.check_minibatch_split({"minibatch_own_rows": own,
                              "minibatch_split_rows": torch.tensor(int(own.max()))})
    TP.check_minibatch_split({"value_loss": torch.tensor(1.0)})


@pytest.fixture(scope="module")
def jax_nets():
    jnet = JN.ActorCritic(num_actions=A, compute_dtype="float32")
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, O)), jnp.zeros((1, P)))
    params["params"]["std"] = jnp.linspace(0.6, 1.4, A)
    return jnet, params


def _rollout(rng, T, n):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(obs=f(T, n, O), priv_obs=f(T, n, P), actions=f(T, n, A), mu=f(T, n, A) * 0.3,
                sigma=np.abs(f(T, n, A)) * 0.3 + 0.7, log_probs=f(T, n) - 15.0, values=f(T, n),
                rewards=f(T, n), dones=rng.uniform(size=(T, n)) < 0.2)


@pytest.fixture(scope="module")
def update_run(tmp_path_factory, jax_nets):
    """The ranks' results of the `update` case and its inputs: T = 8 steps of
    N = 8 envs (4 per rank), the converted weights, two minibatches of the
    whole batch (each under its own permutation) and one rollout."""
    jnet, params = jax_nets
    tmp = tmp_path_factory.mktemp("update")
    rng = np.random.default_rng(11)
    T, N = 8, 8
    mbs, perms = [], []
    for _ in range(2):
        r = _rollout(rng, T, N)
        mbs.append([r[k] for k in ("obs", "priv_obs", "actions", "log_probs", "values")]
                   + [rng.normal(size=(T, N)).astype(np.float32) for _ in range(2)]
                   + [r["mu"], r["sigma"]])
        perms.append(rng.permutation(T * N))
    inp = dict(T=T, N=N, lr=1e-5, perm_seed=3, minibatches=mbs, perms=perms,
               rollout=_rollout(rng, T, N), last_priv=rng.normal(size=(N, P)).astype(np.float32),
               params=actor_critic_from_flax(jax.tree.map(np.asarray, params)))
    torch.save(inp, tmp / "update_in.pt")
    return _spawn(tmp, "update", "update"), inp


def test_sharded_minibatch_update_matches_jax(update_run, jax_nets):
    """Two minibatch updates, each minibatch split over the ranks by the
    membership rule (rows of envs 0-3 on rank 0, 4-7 on rank 1), against
    the JAX package's `minibatch_update` on the whole minibatch. At the
    recipe's learning rate (1e-5, so the two steps move a parameter by up
    to 2e-5): every parameter within 1e-5 of JAX's (measured: 5.9e-7 at
    most, where a gradient element is near Adam's eps) and 99% of each
    tensor's updates within 1e-8 (measured: 99.8% or more), the
    losses, KL and gradient norm within relative 1e-4, the learning rate to
    1e-6; the two ranks' parameters and Adam moments bit-equal."""
    outs, inp = update_run
    jnet, params = jax_nets
    T, N = inp["T"], inp["N"]
    jcfg = JP.PPOConfig(learning_rate=inp["lr"], num_steps_per_env=T, num_mini_batches=1)
    jts = JP.init_train_state(jax.random.PRNGKey(0), jnet, O, P, inp["lr"]).replace(params=params)
    jupd = jax.jit(JP.make_train_pieces(None, jnet, jcfg, N)["minibatch_update"])
    for i, (mb, perm) in enumerate(zip(inp["minibatches"], inp["perms"])):
        # each rank took exactly its envs' rows of the permuted batch
        mine = [np.flatnonzero((perm % N) // (N // WORLD) == r) for r in range(WORLD)]
        assert sorted(np.concatenate(mine).tolist()) == list(range(T * N))
        for r in range(WORLD):
            g = perm[mine[r]]
            want = (g // N) * (N // WORLD) + (g % N - r * (N // WORLD))
            np.testing.assert_array_equal(outs[r]["mb_rows"][i].numpy(), want)
        jts, jm = jupd(jts, tuple(jnp.asarray(x.reshape((T * N,) + x.shape[2:])[perm]) for x in mb))
        for k in ("value_loss", "surrogate_loss", "entropy", "kl", "grad_norm"):
            for r in range(WORLD):
                np.testing.assert_allclose(outs[r]["mb_metrics"][i][k], float(jm[k]), rtol=1e-4,
                                           err_msg=k)
    np.testing.assert_allclose(outs[0]["mb_lr"], float(jts.lr), rtol=1e-6)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jts.params))
    for name, p in outs[0]["mb_params"].items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= 1e-5, (name, diff.max())
        moved = np.abs((p - inp["params"][name]).numpy() - (want[name] - inp["params"][name]).numpy())
        assert np.mean(moved <= 1e-8) >= 0.99, (name, np.mean(moved <= 1e-8))
        assert torch.equal(p, outs[1]["mb_params"][name]), name
    assert torch.equal(outs[0]["mb_opt"], outs[1]["mb_opt"])


def test_sharded_gae_normalisation_matches_jax(update_run, jax_nets):
    """GAE with the global advantage mean and population std, each rank on
    its envs, against the JAX package's `compute_gae` on the whole rollout:
    within 1e-5 (advantages) and 1e-5 relative (returns)."""
    outs, inp = update_run
    jnet, params = jax_nets
    T, N = inp["T"], inp["N"]
    jcfg = JP.PPOConfig(num_steps_per_env=T)
    jts = JP.init_train_state(jax.random.PRNGKey(0), jnet, O, P, 1e-5).replace(params=params)
    roll = inp["rollout"]
    jroll = JP.Rollout(vec=None, log_probs=None, values=jnp.asarray(roll["values"]),
                       rewards=jnp.asarray(roll["rewards"]), dones=jnp.asarray(roll["dones"]))
    jadv, jret = JP.make_train_pieces(None, jnet, jcfg, N)["compute_gae"](
        jts, jroll, jnp.asarray(inp["last_priv"]))
    adv = torch.cat([o["adv"] for o in outs], dim=1).numpy()
    ret = torch.cat([o["ret"] for o in outs], dim=1).numpy()
    np.testing.assert_allclose(adv, np.asarray(jadv), atol=1e-5)
    np.testing.assert_allclose(ret, np.asarray(jret), rtol=1e-5, atol=1e-6)
    assert abs(adv.mean()) < 1e-6 and abs(adv.std() - 1.0) < 1e-5


def test_sharded_update_phase_equals_one_process(update_run):
    """compute_gae + update_phase (2 epochs x 2 minibatches over one global
    permutation) on two ranks against one process on the whole rollout from
    the same weights and permutation seed: parameters within 1e-6 (the sums
    run in another order), metrics within relative 1e-5, both ranks
    bit-equal."""
    outs, _ = update_run
    for name, p in outs[0]["upd_params"].items():
        single = outs[0]["single_params"][name]
        assert float((p - single).abs().max()) <= 1e-6, name
        assert torch.equal(p, outs[1]["upd_params"][name]), name
    for k, v in outs[0]["single_metrics"].items():
        for r in range(WORLD):
            np.testing.assert_allclose(outs[r]["upd_metrics"][k], v, rtol=1e-5, atol=1e-9,
                                       err_msg=k)


def test_sharded_update_phase_pads_its_minibatches(update_run):
    """The update phase held to one process above ran on the padded split:
    each rank gathered C = 32 rows for each of the 2 minibatches of 32 rows
    (T = 8, N = 8, the bound clamped to the minibatch), its own rows
    weighing 1 and the rest 0; the ranks' own rows make up each minibatch
    once."""
    outs, _ = update_run
    splits = [o["upd_split"] for o in outs]
    for rows, weight, own in splits:
        assert rows.shape == weight.shape == (2, 32)
        assert torch.equal(weight.sum(dim=1), own.to(torch.float32)) and int(own.sum()) == 32
        assert weight.eq(0).any()
    assert (splits[0][2] + splits[1][2]).tolist() == [32, 32]


@pytest.mark.parametrize("world", [1, WORLD])
def test_train_iter_builds_no_tensor_from_host_data(world, tmp_path, monkeypatch):
    """After a warm-up iteration, one `train_iter` (T = 2, 2 minibatches)
    calls none of torch.tensor, torch.as_tensor, Tensor.tolist,
    Tensor.item, Tensor.cpu and Tensor.to(device), at world size 1 and on
    each of two gloo ranks: no index is built on the host and copied over,
    and nothing is read back; under several ranks each minibatch is a
    fixed number of rows with weights (`minibatch_rows`), so no size waits
    for the host."""
    if world == WORLD:
        outs = _spawn(tmp_path, "hostcalls", "hostcalls")
        for o in outs:
            assert o["counts"] == {}, o["counts"]
            assert np.isfinite(o["value_loss"])
        assert outs[0]["value_loss"] == outs[1]["value_loss"]
        return
    from humanoid_gym_tpu_torch.algo import ppo as TP
    from humanoid_gym_tpu_torch.algo.networks import ActorCritic

    env, _ = registry.make_env("humanoid_ppo", num_envs=4, device="cpu", seed=0,
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    net = ActorCritic(O, P, A, seed=0)
    cfg = TP.PPOConfig(num_steps_per_env=2, num_mini_batches=2, num_learning_epochs=1)
    train_iter = TP.make_train_iter(env, net, cfg, 4)
    ts = TP.init_train_state(net, cfg.learning_rate)
    state, obs, priv = env.reset_all()
    gen = torch.Generator().manual_seed(0)
    ts, state, obs, priv, _ = train_iter(ts, state, obs, priv, gen)
    counts = {}
    for owner, name in HOST_DATA_CALLS:
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **k):
            moves = k.get("device") is not None or any(
                isinstance(x, (torch.device, str, torch.Tensor)) for x in a[1:])
            if _name != "to" or moves:  # Tensor.to only where it names a device
                counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, counted)
    _, _, _, _, mets = train_iter(ts, state, obs, priv, gen)
    monkeypatch.undo()
    assert counts == {}
    assert np.isfinite(float(mets["value_loss"]))


@pytest.fixture(scope="module")
def cuts_run(tmp_path_factory):
    """The ranks' results of the `cuts` case."""
    return _spawn(tmp_path_factory.mktemp("cuts"), "cuts", "cuts")


@pytest.mark.parametrize("curriculum, want", [(False, 11), (True, 11 + 2)])
def test_cut_plan_runs_as_segments_bit_equal_to_the_body(cuts_run, curriculum, want):
    """The iteration's cut plan on two gloo ranks (8 envs, T = 2, the
    recipe's 2 epochs x 4 minibatches), run eagerly as `CutGraphs`'
    segments: 11 cuts (2 for the advantage statistics, 8 minibatches, 1
    for the metrics), and T more with the command curriculum on (one
    all-reduce a step); every cut one all-reduce, as many as the plain
    body runs; parameters, Adam moments, count, lr, env state, obs and
    metrics bit-equal to the plain eager body from the same snapshot, and
    the ranks' train states bit-equal to each other."""
    got = [o[f"curriculum{int(curriculum)}"] for o in cuts_run]
    for o in got:
        assert o["cuts"] == want and o["collectives"] == [want, want]
        assert o["equal"]
    assert all(torch.equal(a, b) for a, b in zip(got[0]["train_state"], got[1]["train_state"]))


def test_forced_split_overflow_raises_on_two_ranks(cuts_run):
    """With the split forced to 1 row, a two-rank iteration's metrics carry
    this rank's own rows of each of the 4 minibatches, and reading them
    raises, naming them."""
    for o in cuts_run:
        assert "padded split of 1 rows" in o["overflow"], o.get("overflow")
        counts = json.loads(o["overflow"].split("minibatches, ")[1].split("]")[0] + "]")
        assert len(counts) == 4 and sum(counts) == 8 and max(counts) > 1


def _small_terrain_ov(c):
    c.terrain.num_rows, c.terrain.num_cols, c.terrain.border_size = 2, 3, 5.0
    c.terrain.max_init_terrain_level = 1
    c.sim.solver.solver_type = "apgd"


def test_rank_terrain_placement_follows_the_global_index():
    """Rank 1 of 2 holds envs 6-11 of 12: their terrain types are the JAX
    package's `init_state(keys, arange(6, 12))` types (env * num_cols //
    12 over the global index and count), its origins those of JAX's levels
    and types through the port's lookup, and its own levels stand on their
    subterrains' origins; the map is the same as rank 0's."""
    from humanoid_gym_tpu import registry as jreg

    n, start = 12, 6
    jenv, _ = jreg.make_env("humanoid_ppo_terrain", num_envs=n, cfg_overrides=_small_terrain_ov)
    groups = [EnvGroup(rank=r, world=2, device=torch.device("cpu"), backend="gloo")
              for r in range(2)]
    envs = [registry.make_env("humanoid_ppo_terrain", num_envs=n, cfg_overrides=_small_terrain_ov,
                              device="cpu", seed=1, group=g)[0] for g in groups]
    tenv = envs[1]
    assert (tenv.num_envs, tenv.env_offset, tenv.num_envs_global) == (6, start, n)
    assert tenv.global_env_ids().tolist() == list(range(start, n))
    np.testing.assert_array_equal(tenv.terrain_map.height_field, envs[0].terrain_map.height_field)
    js = jax.jit(jenv.init_state)(jax.random.split(jax.random.PRNGKey(0), n)[start:],
                                  jnp.arange(start, n))
    st = tenv.init_state()
    np.testing.assert_array_equal(st.terrain_type.numpy(), np.asarray(js.terrain_type))
    assert st.terrain_type.tolist() == [1, 1, 2, 2, 2, 2]
    got = tenv.terrain_origin(torch.from_numpy(np.array(js.terrain_level)),
                              torch.from_numpy(np.array(js.terrain_type)))
    np.testing.assert_allclose(got.numpy(), js.env_origin, atol=1e-6)
    origins = tenv.terrain_map.env_origins.astype(np.float32)
    np.testing.assert_allclose(st.env_origin.numpy(),
                               origins[st.terrain_level.numpy(), st.terrain_type.numpy()], atol=1e-6)
    # the two ranks draw from their own seeds
    assert not torch.equal(envs[0].init_state().phys.friction, st.phys.friction)


def _global(scalars):
    """The logged scalars that the ranks share (not the host's timings)."""
    return {k: v for k, v in scalars.items() if not k.startswith("Perf/")}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two 2-rank runs of the same seed (2 iterations each, random episode
    lengths, final checkpoint with env shards), then a fresh pair resuming
    the first run's final checkpoint."""
    tmp = tmp_path_factory.mktemp("train")
    a = _spawn(tmp, "train", "a")
    b = _spawn(tmp, "train", "b")
    ckpt = os.path.join(a[0]["ckpt_dir"], "model_2.ckpt")
    resumed = _spawn(tmp, "resume", "resume", ckpt)
    return tmp, a, b, resumed, ckpt


def test_two_rank_run_saves_shards_and_resumes(trained):
    """Counterpart of tests/test_multihost.py:187 at the sizes of
    tests/test_torch_runner.py (8 envs, T = 2): both ranks keep rank 0's
    run directory and hold bit-equal parameters, Adam moments and learning
    rate, and log the same global metrics; only rank 0 writes
    metrics.jsonl and the model checkpoint, every rank its env shard; a
    fresh pair of ranks restores each rank's env state and observations
    exactly, the train state and the iteration, and trains on; ranks of
    another env count, and a single process, refuse the sharded
    checkpoint."""
    tmp, a, _, resumed, ckpt = trained
    assert a[0]["ckpt_dir"] == a[1]["ckpt_dir"] == str(tmp / "run_a_rank0")
    assert not os.path.exists(tmp / "run_a_rank1")
    for k, v in a[0]["params"].items():
        assert torch.equal(v, a[1]["params"][k]), k
    assert torch.equal(a[0]["opt"], a[1]["opt"]) and a[0]["lr"] == a[1]["lr"]
    assert _global(a[0]["scalars"]) == _global(a[1]["scalars"])
    assert a[0]["opt_count"] == 2 * 2
    lines = [json.loads(ln) for ln in open(tmp / "run_a_rank0" / "metrics.jsonl")]
    assert [ln["iter"] for ln in lines] == [0, 1]
    assert lines[-1]["Loss/value_function"] == a[0]["scalars"]["Loss/value_function"]
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp / "run_a_rank0" / "model_*"))) == [
        "model_0.ckpt", "model_2.ckpt", "model_2.ckpt.envshard0", "model_2.ckpt.envshard1"]
    # the ranks' envs differ (own seeds), and each resumed rank has its own back
    assert not torch.equal(a[0]["env_state"]["phys"]["qpos"], a[1]["env_state"]["phys"]["qpos"])
    for r in range(WORLD):
        saved, got = a[r]["env_state"], resumed[r]["env_state"]

        def same(x, y, path=""):
            if isinstance(x, dict):
                for k in x:
                    same(x[k], y[k], f"{path}.{k}")
            else:
                assert torch.equal(x, y), f"rank {r}: {path}"

        same(saved, got)
        assert torch.equal(a[r]["obs"], resumed[r]["obs"])
        assert torch.equal(a[r]["priv_obs"], resumed[r]["priv_obs"])
        assert resumed[r]["iter"] == 2 and resumed[r]["after_iter"] == 3
        for k, v in a[r]["params"].items():
            assert torch.equal(v, resumed[r]["params"][k]), k
        assert torch.equal(a[r]["opt"], resumed[r]["opt"]) and resumed[r]["lr"] == a[r]["lr"]
    assert _global(resumed[0]["after_scalars"]) == _global(resumed[1]["after_scalars"])
    assert all("!= num_envs 2" in resumed[r]["count_mismatch"] for r in range(WORLD))
    assert all(np.isfinite(v) for v in resumed[0]["after_scalars"].values())

    # one process (world size 1) refuses the two-shard checkpoint
    env, _ = registry.make_env("humanoid_ppo", num_envs=8, device="cpu",
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    tcfg = XBotLCfgPPO()
    with pytest.raises(ValueError, match="2 shard"):
        OnPolicyRunner(env, tcfg, log_dir=None).load(ckpt)
    assert os.path.exists(shard_path(ckpt, 1))


def test_same_seed_two_rank_runs_are_bit_equal(trained):
    """A 2-rank run repeated with one seed gives, per rank, bit-equal env
    states, observations, parameters, Adam moments and logged metrics."""
    _, a, b, _, _ = trained
    for r in range(WORLD):
        for k, v in a[r]["params"].items():
            assert torch.equal(v, b[r]["params"][k]), (r, k)
        assert torch.equal(a[r]["opt"], b[r]["opt"])
        assert torch.equal(a[r]["env_state"]["phys"]["qpos"], b[r]["env_state"]["phys"]["qpos"])
        assert torch.equal(a[r]["env_state"]["commands"], b[r]["env_state"]["commands"])
        assert torch.equal(a[r]["obs"], b[r]["obs"])
        assert _global(a[r]["scalars"]) == _global(b[r]["scalars"])


def test_same_seed_runs_are_bit_equal_at_world_size_one():
    """Counterpart of tests/test_determinism.py:27: two single-process runs
    of the port with one seed (env, net, random episode lengths, 2
    iterations) end in bit-equal env states, observations and parameters;
    another seed ends elsewhere."""
    def run(seed):
        env, _ = registry.make_env("humanoid_ppo", num_envs=4, device="cpu", seed=seed,
                                   cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type",
                                                                   "apgd"))
        tcfg = XBotLCfgPPO()
        tcfg.runner.num_steps_per_env = 2
        tcfg.algorithm.num_mini_batches = 2
        tcfg.algorithm.num_learning_epochs = 1
        runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=seed)
        runner.learn(2, init_at_random_ep_len=True)
        return runner

    r1, r2, r3 = run(7), run(7), run(8)
    for f in dataclasses.fields(r1.env_state):
        x, y = getattr(r1.env_state, f.name), getattr(r2.env_state, f.name)
        if dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                assert torch.equal(getattr(x, g.name), getattr(y, g.name)), g.name
        else:
            assert torch.equal(x, y), f.name
    assert torch.equal(r1.obs, r2.obs) and torch.equal(r1.priv_obs, r2.priv_obs)
    for (k, p), (_, q) in zip(r1.net.state_dict().items(), r2.net.state_dict().items()):
        assert torch.equal(p, q), k
    assert not torch.equal(r1.env_state.phys.qpos, r3.env_state.phys.qpos)
