"""One exported policy rolled in both engines, from one state.

`roll_both` builds the JAX package's env and the port's env on the CPU
with the deployment-clean overrides of tests/test_xbots.py:71-82 (flat
ground, no observation noise, pushes, friction or mass DR, action delay or
noise, no heading command) and the same contact solver, starts both from
one JAX `reset_all` state (carried across with `env_state_from_jax`), holds
the command at (vx, 0, 0, 0), and rolls the same `.npz` actor in each: the
JAX package's `load_policy` drives the JAX env, the port's `load_policy`
the port's. Each engine reports the share of envs that never fell and the
median forward distance (a fallen env counts what it had walked when it
fell). A policy that walks in one engine and falls in the other points at
the engines; one that walks the same in both was trained that way.

The tier-1 case rolls the shipped walk demo at 2 envs for 50 steps. The
diagnostic runs by hand on any policy:

    python tests/test_torch_cross_engine.py POLICY.npz [--envs 16] [--steps 400 2000] [--vx 0.4]
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # run as a script from anywhere

from humanoid_gym_tpu import registry as jreg  # noqa: E402
from humanoid_gym_tpu.export.policy_export import load_policy as jax_load_policy  # noqa: E402
from humanoid_gym_tpu_torch import registry as treg  # noqa: E402
from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax  # noqa: E402
from humanoid_gym_tpu_torch.export.policy_export import (  # noqa: E402
    load_policy as port_load_policy,
)

# The tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

WALK_DEMO = os.path.join(ROOT, "resources", "policies", "xbotl_walk_demo.npz")
# 50 steps of the 2e-4 m a step by which the engines' qpos may differ
# (test_torch_env.py's step tolerance), added up
DIST_TOL = 50 * 2e-4  # m


def _deploy_overrides(solver):
    def ov(cfg):
        cfg.terrain.mesh_type = "plane"
        cfg.terrain.curriculum = False
        cfg.noise.add_noise = False
        cfg.domain_rand.push_robots = False
        cfg.domain_rand.randomize_friction = False
        cfg.domain_rand.randomize_base_mass = False
        cfg.domain_rand.action_delay = 0.0
        cfg.domain_rand.action_noise = 0.0
        cfg.commands.heading_command = False
        cfg.sim.solver.solver_type = solver

    return ov


def roll_both(npz, task="humanoid_ppo", n_envs=16, n_steps=400, vx=0.4, report_at=None,
              solver="apgd", seed=0):
    """Roll the actor of `npz` for n_steps policy steps in both engines.
    Returns {step: {"jax": (survived, median), "port": (survived, median)}}
    for each step of `report_at` (default: n_steps alone)."""
    report_at = set(report_at or (n_steps,))
    ov = _deploy_overrides(solver)
    jenv, _ = jreg.make_env(task, num_envs=n_envs, cfg_overrides=ov)
    tenv, _ = treg.make_env(task, num_envs=n_envs, cfg_overrides=ov, device="cpu", seed=seed)
    js, jobs, _ = jenv.reset_all(jax.random.PRNGKey(seed))
    ts, tobs = env_state_from_jax(js), torch.from_numpy(np.array(jobs))
    policy = {"jax": jax_load_policy(npz), "port": port_load_policy(npz)}
    jstep = jax.jit(jenv.step)
    cmd = np.tile(np.asarray([vx, 0.0, 0.0, 0.0], np.float32), (n_envs, 1))
    x0 = np.array(js.phys.qpos[:, 0])
    alive = {k: np.ones(n_envs, bool) for k in policy}
    dist = {k: np.zeros(n_envs) for k in policy}
    out = {}
    for i in range(1, n_steps + 1):
        js, jtr = jstep(js.replace(commands=jnp.asarray(cmd)),
                        jnp.asarray(policy["jax"](np.asarray(jobs))))
        jobs = jtr.obs
        ts, ttr = tenv.step(ts.replace(commands=torch.from_numpy(cmd)),
                            torch.from_numpy(policy["port"](tobs.numpy())))
        tobs = ttr.obs
        for k, done, timeout, x in (
                ("jax", jtr.done, jtr.time_out, js.phys.qpos[:, 0]),
                ("port", ttr.done.numpy(), ttr.time_out.numpy(), ts.phys.qpos[:, 0].numpy())):
            alive[k] &= ~(np.asarray(done) & ~np.asarray(timeout))
            dist[k] = np.where(alive[k], np.asarray(x) - x0, dist[k])
        if i in report_at:
            out[i] = {k: (float(alive[k].mean()), float(np.median(dist[k]))) for k in policy}
    return out


def test_walk_demo_walks_alike_in_both_engines():
    """The shipped walk demo, 2 envs, 50 steps at vx 0.4: no env falls in
    either engine, and the median distances agree within DIST_TOL."""
    (res,) = roll_both(WALK_DEMO, n_envs=2, n_steps=50).values()
    assert res["jax"][0] == 1.0 and res["port"][0] == 1.0, res
    assert res["jax"][1] > 0.01, res  # it set off
    assert abs(res["jax"][1] - res["port"][1]) <= DIST_TOL, res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--steps", type=int, nargs="+", default=[400, 2000])
    p.add_argument("--vx", type=float, default=0.4)
    p.add_argument("--solver", default="apgd")
    args = p.parse_args(argv)
    res = roll_both(args.npz, args.task, args.envs, max(args.steps), args.vx,
                    report_at=args.steps, solver=args.solver)
    for steps, by_engine in sorted(res.items()):
        engines = {k: {"survived": s, "median_m": m} for k, (s, m) in by_engine.items()}
        print(json.dumps({"policy": args.npz, "task": args.task, "envs": args.envs,
                          "steps": steps, "vx": args.vx, "solver": args.solver, **engines}),
              flush=True)
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())
