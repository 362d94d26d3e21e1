"""The physics blow-up behind the non-finite resets of the production
recipe (`humanoid_joint_deploy`), replayed on the CPU.

`tests/data/joint_deploy_blow_up.npz` holds the physics inputs of eight
policy steps of one XBot-L env on the deploy field, recorded on the card
by `chip_smoke.py --nonfinite` (a policy trained 3001 iterations from
scratch by the port, its actions drawn as the rollout draws them): the
PhysicsState of the first step, the joint targets of all eight and the
velocities the card's kernel returned after each. In contact, the base's
angular velocity grows from about 6 to about 100 rad/s, and the robot
leaves the ground; in flight it goes on growing until the state is
non-finite, and the env resets it. The port's plain mega step and the
JAX package's mega kernel (interpret mode, as its own tests run it on
the CPU) take the same eight steps from the same inputs, and the card's
kernel took them too: the blow-up is the reference physics', not the
port's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from humanoid_gym_tpu import registry as jax_registry
from humanoid_gym_tpu.physics import pallas_solver
from humanoid_gym_tpu.physics.step import PhysicsState as JaxPhysicsState
from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.physics.step import PhysicsState

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "joint_deploy_blow_up.npz")
TASK = "humanoid_joint_deploy"
# largest |qvel| difference, relative to the step's largest |qvel| (at
# least 1): f32 association order over 10 substeps of 8 APGD iterations
REL_TOL = 5e-5


def _solver(name):
    def ov(cfg):
        cfg.sim.solver.solver_type = name
    return ov


def test_recorded_blow_up_is_the_reference_kernels(monkeypatch):
    # one env, dispatched by plain vmap: no ambient solver mesh (a JAX
    # runner built earlier in this process may have left its own)
    monkeypatch.setattr(pallas_solver, "_SOLVER_MESH", None)
    z = np.load(DATA)
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
