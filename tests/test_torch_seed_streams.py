"""Every random stream of a port run apart from every other.

The JAX package splits one key into independent streams: the net's init
and the env's (humanoid_gym_tpu/runner/on_policy_runner.py:69-70), the
random episode lengths (:178), and each iteration's rollout and minibatch
permutation (algo/ppo.py:330). The port seeds one torch generator per
stream, so the streams are apart exactly when their integer seeds are:
the env's generators (`registry.make_env`), the runner's action noise,
its episode lengths, the net's init, and the permutation of each
iteration (`algo/ppo.py` `permutation_seed`). Each integer is read off
what the code itself hands its generator, at world sizes 1, 2 and 4
(stand-in groups: the collectives of the runner's start are skipped),
for a single-robot task and the joint production recipe, for the
learning band and for the example loop.

On the CPU the env's generator and the net's are both mt19937: with one
integer they give the same numbers, and torch's normal draws are the
Box-Muller transform of its uniform ones, so a noise stream seeded as the
env's repeats the env's first draws. The last test shows that symptom
gone."""

import math

import pytest
import torch

from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.algo import networks
from humanoid_gym_tpu_torch.algo.ppo import permutation_seed
from humanoid_gym_tpu_torch.parallel import EnvGroup
from humanoid_gym_tpu_torch.runner import on_policy_runner as R

torch.set_num_threads(1)

SEED = 5
ITERS = 3002  # the production recipe's 3001 iterations, and the final one
TASKS = ("humanoid_ppo", "humanoid_joint_deploy")


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("HGT_WANDB", "0")


class Seen:
    """The integer seeds handed to the generators of one run, by stream."""

    def __init__(self, monkeypatch):
        self.seeds = {}
        orig_reset = networks.MLP.reset_parameters

        def reset_parameters(mlp, gen):
            self.seeds.setdefault("net_init", int(gen.initial_seed()))
            return orig_reset(mlp, gen)

        monkeypatch.setattr(networks.MLP, "reset_parameters", reset_parameters)
        orig_randint = torch.randint

        def randint(*args, generator=None, **kw):
            if generator is not None and kw.get("dtype") == torch.int32:
                self.seeds["episode_length"] = int(generator.initial_seed())
            return orig_randint(*args, generator=generator, **kw)

        self.randint = randint

    def env(self, env):
        for i, g in enumerate(env.generators()):
            self.seeds[f"env{i}"] = int(g.initial_seed())

    def perms(self, perm_seed):
        for it in range(ITERS):
            self.seeds[f"perm{it}"] = permutation_seed(perm_seed, it)


def _apgd(c):
    c.sim.solver.solver_type = "apgd"


def _runner_seeds(task, group):
    """Every seed of a runner of `task` on `group`'s rank (None: one
    process), its episode lengths drawn as `learn` draws them."""
    with pytest.MonkeyPatch.context() as mp:
        seen = Seen(mp)
        mp.setattr(R, "replicate", lambda params, group: None)
        mp.setattr(R, "broadcast_str", lambda s, group: s or "")
        orig_iter = R.compiled_train_iter

        def compiled_train_iter(env, net, cfg, num_envs, group=None, perm_seed=None):
            seen.env(env)
            seen.perms(perm_seed)
            return orig_iter(env, net, cfg, num_envs, group, perm_seed)

        mp.setattr(R, "compiled_train_iter", compiled_train_iter)
        world = 1 if group is None else group.world
        env, _ = registry.make_env(task, num_envs=2 * world, cfg_overrides=_apgd, device="cpu",
                                   seed=SEED, group=group)
        tcfg = registry.get_task(task).make_train_cfg()
        runner = R.OnPolicyRunner(env, tcfg, log_dir=None, seed=SEED)
        seen.seeds["action_noise"] = int(runner.gen.initial_seed())
        mp.setattr(torch, "randint", seen.randint)
        runner.learn(0, init_at_random_ep_len=True)
    return seen.seeds


def _clash(seeds):
    """The pairs of streams that share a seed."""
    by = {}
    for name, s in seeds.items():
        by.setdefault(s, []).append(name)
    return [names for names in by.values() if len(names) > 1]


SHARED = ("episode_length", "net_init")


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("task", TASKS)
def test_runner_streams_are_pairwise_distinct(task, world):
    """On every rank: the env's generators, the action noise, the episode
    lengths, the net's init and the permutations of 3002 iterations take
    pairwise distinct seeds. Across the ranks the episode lengths, the
    net's init and the permutations agree (they are drawn for the global
    batch or replicated), and every rank's own streams (env, noise) are
    apart from every stream of every other rank."""
    groups = [None] if world == 1 else [
        EnvGroup(rank=r, world=world, device=torch.device("cpu"), backend="gloo")
        for r in range(world)]
    ranks = [_runner_seeds(task, g) for g in groups]
    for r, seeds in enumerate(ranks):
        assert {"env0", "action_noise", "episode_length", "net_init", "perm0"} <= set(seeds)
        assert not _clash(seeds), (r, _clash(seeds))
    for name in SHARED + tuple(f"perm{it}" for it in range(ITERS)):
        assert len({s[name] for s in ranks}) == 1, name
    own = [{k: v for k, v in s.items() if k.startswith("env") or k == "action_noise"}
           for s in ranks]
    for r, mine in enumerate(own):
        for q, theirs in enumerate(ranks):
            if q != r:
                common = set(mine.values()) & set(theirs.values())
                assert not common, (r, q, common)


def test_learning_band_streams_are_pairwise_distinct(monkeypatch):
    """`utils/learning_band.py` seeds as the runner does: the env, the net's
    init, the action noise and the permutations of its iterations take
    pairwise distinct seeds (the band stops before its first iteration)."""
    from humanoid_gym_tpu_torch.utils import learning_band as LB

    seen = Seen(monkeypatch)

    class Stop(Exception):
        pass

    def compiled_train_iter(env, net, cfg, num_envs, group=None, perm_seed=None):
        seen.env(env)
        seen.perms(perm_seed)

        def train_iter(ts, state, obs, priv, gen):
            seen.seeds["action_noise"] = int(gen.initial_seed())
            raise Stop

        return train_iter

    monkeypatch.setattr(LB, "compiled_train_iter", compiled_train_iter)
    with pytest.raises(Stop):
        LB.learning_curve(device="cpu", solver="apgd", seed=SEED, n=2, T=2, iters=1)
    assert {"env0", "action_noise", "net_init", "perm0"} <= set(seen.seeds)
    assert not _clash(seen.seeds), _clash(seen.seeds)


def test_example_loop_streams_are_pairwise_distinct(monkeypatch):
    """`examples/minimal_train_loop_torch.py`: the env, the net's init, the
    action noise and the permutations of its iterations take pairwise
    distinct seeds (the loop stops before its first iteration)."""
    import examples.minimal_train_loop_torch as EX
    from humanoid_gym_tpu_torch.algo import capture

    seen = Seen(monkeypatch)

    class Stop(Exception):
        pass

    def compiled_train_iter(env, net, cfg, num_envs, group=None, perm_seed=None):
        seen.env(env)

        def train_iter(ts, state, obs, priv, gen):
            seen.seeds["action_noise"] = int(gen.initial_seed())
            seen.perms(gen.initial_seed() if perm_seed is None else perm_seed)
            raise Stop

        return train_iter

    monkeypatch.setattr(capture, "compiled_train_iter", compiled_train_iter)
    with pytest.raises(Stop):
        EX.main(num_envs=2, iterations=1, horizon=2, device="cpu")
    assert {"env0", "action_noise", "net_init", "perm0"} <= set(seen.seeds)
    assert not _clash(seen.seeds), _clash(seen.seeds)


def _box_muller(u):
    """torch's CPU normal draws from 16 uniforms (aten normal_fill_16):
    radius from the first 8, angle from the last 8."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[:8]))
    th = 2.0 * math.pi * u[8:]
    return torch.cat([r * torch.cos(th), r * torch.sin(th)])


def test_first_action_noise_is_not_the_envs_draws():
    """`humanoid_ppo` at 16 envs on the CPU, seed 5: the first 16 values
    of the runner's first action-noise draw (a (16, 12) normal, as the
    rollout draws it) are not the Box-Muller transform of the env's first
    16 uniforms. The transform is checked to be torch's own first: it
    reproduces a normal draw seeded as the env to 1e-6."""
    env, _ = registry.make_env("humanoid_ppo", num_envs=16, cfg_overrides=_apgd, device="cpu",
                               seed=SEED)
    runner = R.OnPolicyRunner(env, registry.get_task("humanoid_ppo").make_train_cfg(),
                              log_dir=None, seed=SEED)
    g = torch.Generator().manual_seed(int(env.gen.initial_seed()))
    env_bm = _box_muller(torch.rand(16, generator=g).double())
    g = torch.Generator().manual_seed(int(env.gen.initial_seed()))
    own = torch.randn((16, 12), generator=g).reshape(-1)[:16].double()
    assert float((env_bm - own).abs().max()) < 1e-6
    noise_gen = torch.Generator()
    noise_gen.set_state(runner.gen.get_state())
    noise = torch.randn((16, 12), generator=noise_gen).reshape(-1)[:16].double()
    gap = float((noise - env_bm).abs().max())
    assert gap > 0.1, f"the first action noise is the env's first draws (max gap {gap:.3g})"
