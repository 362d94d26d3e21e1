"""Entry points of the PyTorch/CUDA port for a compile check and a
multi-chip dry run: the counterpart of __graft_entry__.py (whose dunder name
stays the JAX package's hook; this is a plain module, so tests can import
it).

entry(device=None, solver=None) -> (fn, args): the policy MLP and the env
    step of the flagship XBot-L task at 16 envs; fn(net, state, obs, priv)
    -> (obs, privileged_obs, reward, value).
CapturedStep(step, net, state, obs, priv, generator): a step captured as
    one CUDA graph, the port's counterpart of `jax.jit`.
dryrun_multichip(n, device=None): one full PPO training iteration (rollout,
    GAE, minibatch updates) with the env axis sharded over n ranks of
    `parallel/` and the parameters replicated, on tiny shapes (on the card
    captured, `algo.capture`: one CUDA graph at one rank, graphs cut at
    each all-reduce under several).

    python graft_entry_torch.py                 # on the card: capture entry()'s step, replay it
    python graft_entry_torch.py --device cpu    # the same step, eager, on the CPU
    python graft_entry_torch.py --solver mega   # the production solver's kernel in the graph
    python -c "import graft_entry_torch as g; g.dryrun_multichip(2, device='cpu')"
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NUM_ENVS = 16
CAPTURE_WARMUP = 2  # eager calls on a side stream before the capture


def _small_cfg(num_envs: int):
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg

    cfg = XBotLCfg()
    cfg.env.num_envs = num_envs
    return cfg


def entry(device=None, solver=None):
    """(fn, (net, state, obs, priv)) for the flagship task at 16 envs: the
    recipe's ActorCritic (seed 0), `init_state`, zero observations. The
    solver is the config's own (apgd) unless `solver` names another; the
    device is the card unless `device` says otherwise (raises without a
    card). `fn.step(net, state, obs, priv)` is the same step returning
    (new_state, outputs), and `fn.env` the env."""
    import torch

    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device or "cuda")
    cfg = _small_cfg(NUM_ENVS)
    if solver:
        cfg.sim.solver.solver_type = solver
    env = make_env(cfg, device=device, seed=0)
    net = actor_critic_from_cfg(cfg.env, XBotLCfgPPO().policy, seed=0).to(device)
    state = env.init_state()
    obs = torch.zeros((NUM_ENVS, cfg.env.num_observations), device=device)
    priv = torch.zeros((NUM_ENVS, cfg.env.num_privileged_obs), device=device)

    def step(net, state, obs, priv):
        with torch.no_grad():
            mean, _ = net.act(obs)
            value = net.evaluate(priv)
            new_state, tr = env.step(state, mean)
        return new_state, (tr.obs, tr.privileged_obs, tr.reward, value)

    def fn(net, state, obs, priv):
        return step(net, state, obs, priv)[1]

    fn.step, fn.env = step, env
    return fn, (net, state, obs, priv)


class CapturedStep:
    """`step(net, state, obs, priv) -> (new_state, outputs)` captured as one
    CUDA graph. The step is warmed up on a side stream (CAPTURE_WARMUP calls,
    each drawing from `generator`), then captured with `generator` registered, so
    every replay draws the next numbers of its stream as an eager call
    would. Calling the object copies (state, obs, priv) into the graph's
    static inputs, replays it, and returns the graph's (new_state, outputs):
    the next replay overwrites them, so clone what is kept."""

    def __init__(self, step, net, state, obs, priv, generator):
        import torch

        from humanoid_gym_tpu_torch.algo.capture import clone_tree

        self.inputs = clone_tree((state, obs, priv))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                step(net, *self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            self.outputs = step(net, *self.inputs)

    def __call__(self, state, obs, priv):
        from humanoid_gym_tpu_torch.algo.capture import tensor_leaves

        for dst, src in zip(tensor_leaves(self.inputs), tensor_leaves((state, obs, priv))):
            dst.copy_(src)
        self.graph.replay()
        return self.outputs


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One PPO training iteration of the flagship task with the env axis
    sharded over `n_devices` ranks (one process each, started by
    `parallel/launch.py`) and the parameters replicated: 2 envs a rank,
    T = 2, 2 minibatches, 1 epoch, solver mega. On the card the ranks meet
    over nccl, one card each (raises for more ranks than cards); on the
    CPU over gloo, where the plain mega step stands in for the kernel.
    Prints the JAX package's line and returns each rank's result: rank,
    value_loss, mean_step_reward and the updated parameters (CPU tensors
    by name)."""
    import torch

    from humanoid_gym_tpu_torch.parallel.launch import RankJob
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device or "cuda")
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"need {n_devices} cards (one rank a card), have "
                           f"{torch.cuda.device_count()}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="hgt_dryrun_") as work:
        argv = [sys.executable, os.path.abspath(__file__), "--dryrun-rank", work, device.type]
        RankJob(argv, n_devices, dict(os.environ, OMP_NUM_THREADS="1")).wait(timeout_s=900)
        results = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
                   for r in range(n_devices)]
    r0 = results[0]
    print(f"dryrun_multichip({n_devices}): ok — solver=mega ({n_devices} {backend} rank(s), env "
          f"axis sharded), value_loss={r0['value_loss']:.4f}, "
          f"mean_step_reward={r0['mean_step_reward']:.4f}", flush=True)
    return results


def _dryrun_rank(work: str, device_type: str) -> int:
    """One rank of `dryrun_multichip`: writes <work>/rank<r>.pt."""
    import torch

    torch.set_num_threads(1)
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.capture import compiled_train_iter
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, check_minibatch_split, init_train_state
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfgPPO
    from humanoid_gym_tpu_torch.parallel.mesh import make_env_group, replicate
    from humanoid_gym_tpu_torch.parallel.multihost import rank_seed

    on_card = device_type == "cuda"
    group = make_env_group("nccl" if on_card else "gloo", device=None if on_card else "cpu",
                           init_method=f"file://{work}/rdv")
    try:
        device = group.device
        num_envs = 2 * group.world

        def mega(c):
            c.sim.solver.solver_type = "mega"

        env, cfg = registry.make_env("humanoid_ppo", num_envs=num_envs, cfg_overrides=mega,
                                     device=device, seed=0, group=group)
        net = actor_critic_from_cfg(cfg.env, XBotLCfgPPO().policy, seed=0).to(device)
        replicate(list(net.parameters()), group)
        algo = PPOConfig()
        algo.num_steps_per_env = 2
        algo.num_mini_batches = 2
        algo.num_learning_epochs = 1
        ts = init_train_state(net, algo.learning_rate)
        state = env.init_state()
        obs = torch.zeros((env.num_envs, cfg.env.num_observations), device=device)
        priv = torch.zeros((env.num_envs, cfg.env.num_privileged_obs), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(rank_seed(1, group))
        train_iter = compiled_train_iter(env, net, algo, num_envs, group, perm_seed=0)
        ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        check_minibatch_split(metrics)
        out = {
            "rank": group.rank,
            "value_loss": float(metrics["value_loss"]),
            "mean_step_reward": float(metrics["mean_step_reward"]),
            "params": {k: v.detach().cpu() for k, v in ts.net.state_dict().items()},
        }
    finally:
        group.close()
    torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--dryrun-rank"]:
        return _dryrun_rank(*sys.argv[2:4])
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--solver", default=None, help="the contact solver (default: the config's)")
    args = p.parse_args()
    import torch

    fn, args_ = entry(device=args.device, solver=args.solver)
    net, state, obs, priv = args_
    if obs.is_cuda:
        graph = CapturedStep(fn.step, net, state, obs, priv, fn.env.gen)
        _, out = graph(state, obs, priv)
        torch.cuda.synchronize()
        how = "one CUDA graph, replayed"
    else:
        out = fn(*args_)
        how = "eager, on the CPU"
    print("entry(): ok", [tuple(o.shape) for o in out], f"({how})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
