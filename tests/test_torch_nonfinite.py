"""The physics blow-ups behind the non-finite resets of the production
recipe (`humanoid_joint_deploy`), replayed on the CPU.

`tests/data/joint_deploy_blow_up.npz` holds the physics inputs of eight
policy steps of one XBot-L env on the deploy field, recorded on the card
by `chip_smoke.py --nonfinite` (a policy trained 3001 iterations from
scratch by the port, its actions drawn as the rollout draws them): the
PhysicsState of the first step, the joint targets of all eight and the
velocities the card's kernel returned after each. The other
`joint_deploy_blow_up_*.npz` files hold such traces, in the same format,
cut by `chip_smoke.py --train ... --probe` (`_blow_up_trace`) from the
checkpoints of a run in its late fall (seed 7). In contact, the base's
angular velocity grows from about 6 to about 100 rad/s, and the robot
leaves the ground; in flight it goes on growing until the state is
non-finite, and the env resets it. The port's plain mega step and the JAX
package's mega kernel (interpret mode, as its own tests run it on the
CPU) take the same eight steps from the same inputs, and the card's
kernel took them too: the blow-up is the reference physics', not the
port's.

One more seed-7 trace, `plain_step_departure_s7_2600_2.npz` (XBot-S, its
base at 78 / 126 m), is beyond what a free-running float32 replay can hold
to REL_TOL. There a float32 world coordinate rounds to 7.6e-6 m. Both
kernels and the plain step look the ground up at that rounded world point
(the base-relative point plus the base). A point that lies within ~1e-8 m
of a rounding tie therefore moves the ground by slope x 7.6e-6 m, the gap
row's target by that over dt, and the rest of the blow-up with it. The JAX
kernel itself, with its base moved by one float32 step in x or y, departs
from its own trajectory by up to 2.5e-4 of the step's largest |qvel|. The
plain step departs from it by 1.9e-4 (one point's world y rounds the other
way at the sixth substep of the first step). So on that trace the plain
step is held to the JAX kernel one policy step at a time, from each of the
kernel's states, at REL_TOL; its free run is held within the kernel's own
one-step spread."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu import registry as jax_registry
from humanoid_gym_tpu.physics import pallas_solver
from humanoid_gym_tpu.physics.step import PhysicsState as JaxPhysicsState
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.physics.step import PhysicsState

torch.set_num_threads(1)

TRACES = sorted(glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                                       "joint_deploy_blow_up*.npz")))
TASK = "humanoid_joint_deploy"
# largest |qvel| difference, relative to the step's largest |qvel| (at
# least 1): f32 association order over 10 substeps of 8 APGD iterations
REL_TOL = 5e-5


# a recorded XBot-S trace (seed 7, checkpoint 2600) on which a free run of
# the port's plain step and one of the JAX kernel part by more than REL_TOL
# (module docstring)
DEPARTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "plain_step_departure_s7_2600_2.npz")


def _solver(name):
    def ov(cfg):
        cfg.sim.solver.solver_type = name
    return ov


@pytest.mark.parametrize("trace", TRACES, ids=[os.path.basename(p)[:-4] for p in TRACES])
def test_recorded_blow_up_is_the_reference_kernels(monkeypatch, trace):
    # one env, dispatched by plain vmap: no ambient solver mesh (a JAX
    # runner built earlier in this process may have left its own)
    monkeypatch.setattr(pallas_solver, "_SOLVER_MESH", None)
    z = np.load(trace)
    robot = int(z["robot"])
    rows = {name[len("state_"):]: z[name] for name in z.files if name.startswith("state_")}
    env, _ = registry.make_env(TASK, num_envs=2, cfg_overrides=_solver("mega"), device="cpu",
                               seed=0)
    jenv, _ = jax_registry.make_env(TASK, num_envs=2, cfg_overrides=_solver("mega_interpret"))
    step = env.envs[robot]._phys_step
    jstep = jax.jit(jax.vmap(jenv.envs[robot]._phys_step))
    state = PhysicsState(**{k: torch.from_numpy(v[None].copy()) for k, v in rows.items()})
    jstate = JaxPhysicsState(**{k: jnp.asarray(v[None]) for k, v in rows.items()})
    spin = []
    for i, targets in enumerate(z["targets"]):
        state = step(state, torch.from_numpy(targets[None].copy()))
        jstate = jstep(jstate, jnp.asarray(targets[None]))
        mine, theirs = state.qvel[0].numpy(), np.asarray(jstate.qvel)[0]
        scale = max(1.0, float(np.abs(theirs).max()))
        assert np.abs(mine - theirs).max() <= REL_TOL * scale, (i, mine, theirs)
        assert np.abs(mine - z["card_qvel"][i]).max() <= REL_TOL * scale, i
        spin.append(float(np.abs(mine[3:6]).max()))
    # the base's angular velocity, rad/s: moderate at the start, past 60
    # within the window, and the feet's contact impulses gone by its end
    assert spin[0] < 10.0 and max(spin) > 60.0, spin
    assert float(state.contact_lam.abs().max()) == 0.0


def _ulp_shifted(qpos):
    """The trace's first qpos, and four copies with the base moved by one
    float32 step: x down, x up, y down, y up."""
    out = [qpos]
    for c in (0, 1):
        for to in (-np.inf, np.inf):
            q = qpos.copy()
            q[c] = np.nextafter(q[c], np.float32(to))
            out.append(q)
    return np.stack(out)


@pytest.fixture(scope="module")
def departure():
    """The DEPARTURE trace, the JAX kernel's (interpret mode) states after
    each step from its first state and from the four base shifts of
    `_ulp_shifted` (one vmapped batch), and the port's plain step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_solver, "_SOLVER_MESH", None)
        z = np.load(DEPARTURE)
        robot = int(z["robot"])
        rows = {name[len("state_"):]: z[name] for name in z.files if name.startswith("state_")}
        jenv, _ = jax_registry.make_env(TASK, num_envs=2,
                                        cfg_overrides=_solver("mega_interpret"))
        jstep = jax.jit(jax.vmap(jenv.envs[robot]._phys_step))
        qpos = _ulp_shifted(rows["qpos"])
        b = len(qpos)
        jstate = JaxPhysicsState(**{k: jnp.asarray(qpos if k == "qpos" else
                                                   np.repeat(v[None], b, axis=0))
                                    for k, v in rows.items()})
        states = []
        for targets in z["targets"]:
            jstate = jstep(jstate, jnp.asarray(np.repeat(targets[None], b, axis=0)))
            states.append({k: np.asarray(getattr(jstate, k)) for k in rows})
    env, _ = registry.make_env(TASK, num_envs=2, cfg_overrides=_solver("mega"), device="cpu",
                               seed=0)
    return z, rows, states, env.envs[robot]._phys_step


def _rel(mine, theirs):
    return float(np.abs(mine - theirs).max()) / max(1.0, float(np.abs(theirs).max()))


def test_card_took_the_jax_kernels_steps_where_the_plain_step_departs(departure):
    """On the trace where a free run of the port's plain step departs
    (DEPARTURE), the steps the card's kernel recorded are the JAX kernel's
    (interpret mode), each within REL_TOL of the step's largest |qvel|: the
    training path, which runs the kernel, holds to the reference there."""
    z, _, states, _ = departure
    for i, st in enumerate(states):
        assert _rel(z["card_qvel"][i], st["qvel"][0]) <= REL_TOL, i


def test_plain_step_is_the_jax_kernels_step_from_each_of_its_states(departure):
    """On DEPARTURE, one policy step of the port's plain step from each
    state of the JAX kernel's trajectory (the trace's first state, then the
    kernel's state after each step) lands within REL_TOL of the kernel's
    next state: the plain step is the reference kernel's step there."""
    z, rows, states, step = departure
    start = {k: v[None] for k, v in rows.items()}
    for i, targets in enumerate(z["targets"]):
        src = start if i == 0 else {k: v[:1] for k, v in states[i - 1].items()}
        state = PhysicsState(**{k: torch.from_numpy(v.copy()) for k, v in src.items()})
        state = step(state, torch.from_numpy(targets[None].copy()))
        assert _rel(state.qvel[0].numpy(), states[i]["qvel"][0]) <= REL_TOL, i


def test_plain_steps_free_run_is_within_the_jax_kernels_one_ulp_spread(departure):
    """On DEPARTURE the JAX kernel departs from its own trajectory by more
    than REL_TOL when its base moves by one float32 step (7.6e-6 m at 64-128
    m) in x or y: a free-running float32 replay resolves no more there. The
    free run of the port's plain step departs from the kernel's by less
    than the largest of those four departures."""
    z, rows, states, step = departure
    ref = [st["qvel"][0] for st in states]
    spread = max(max(_rel(st["qvel"][j], r) for st, r in zip(states, ref))
                 for j in range(1, len(states[0]["qvel"])))
    state = PhysicsState(**{k: torch.from_numpy(v[None].copy()) for k, v in rows.items()})
    plain = 0.0
    for targets, r in zip(z["targets"], ref):
        state = step(state, torch.from_numpy(targets[None].copy()))
        plain = max(plain, _rel(state.qvel[0].numpy(), r))
    assert spread > REL_TOL, spread
    assert plain <= spread, (plain, spread)
