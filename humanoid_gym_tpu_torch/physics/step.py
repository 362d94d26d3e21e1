"""The policy-step physics: PhysicsState and the mega-solver step.

Port of humanoid_gym_tpu/physics/step.py for `solver="mega"`: one call
runs `decimation` 1 kHz substeps (PD actuation -> dynamics -> contacts ->
integration) for a batch of envs through physics/mega.py. A CUDA state runs
the CUDA kernel, a CPU state its plain version; there is no other branch.
All state tensors carry the env axis first.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .mega import make_mega_step_batched, pd_torques  # noqa: F401  (re-export)
from .model import RobotModel


@dataclass
class PhysicsState:
    qpos: torch.Tensor  # (N, nq)
    qvel: torch.Tensor  # (N, nv)
    # per-env physical randomization
    friction: torch.Tensor  # (N,) contact friction coefficient
    base_mass_scale: torch.Tensor  # (N,) multiplicative base-mass DR
    contact_stiffness: torch.Tensor  # (N,) Baumgarte scale
    contact_offset: torch.Tensor  # (N,) contact activation distance [m]
    contact_compliance: torch.Tensor  # (N,) CFM scale (0 = rigid)
    kp_scale: torch.Tensor  # (N,) actuator-strength scale on kp
    kd_scale: torch.Tensor  # (N,) actuator-strength scale on kd
    # outputs of the last substep
    contact_forces: torch.Tensor  # (N, nb, 3) net per-body contact force [N]
    torques: torch.Tensor  # (N, nj) last applied actuator torques
    # warm-start carry: the last substep's impulses (physical signs,
    # (N, 3*ncon + nj)); zeroed on env reset
    contact_lam: torch.Tensor
    # contact-slope DR bias (N, 2): inert on flat ground, kept for layout
    slope_bias: torch.Tensor
    # end-of-step feet/knee kinematics (N, 14) in the OUT_FK layout
    fk_out: torch.Tensor

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


def default_state(model: RobotModel, n: int, base_pos, base_quat_wxyz, qj=None) -> PhysicsState:
    """`n` envs standing at one pose with neutral DR values."""
    dev = model.device
    nv, nb, njnt = model.nv, model.nbody, model.nj
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    qj = torch.zeros(njnt, device=dev) if qj is None else f(qj)
    qpos = torch.cat([f(base_pos), f(base_quat_wxyz), qj]).expand(n, -1).clone()
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)  # noqa: E731
    return PhysicsState(
        qpos=qpos,
        qvel=torch.zeros((n, nv), device=dev),
        friction=full(1.0),
        base_mass_scale=full(1.0),
        contact_stiffness=full(1.0),
        contact_offset=full(0.01),
        contact_compliance=full(0.0),
        kp_scale=full(1.0),
        kd_scale=full(1.0),
        contact_forces=torch.zeros((n, nb, 3), device=dev),
        torques=torch.zeros((n, njnt), device=dev),
        contact_lam=torch.zeros((n, 3 * model.ncon + njnt), device=dev),
        slope_bias=torch.zeros((n, 2), device=dev),
        fk_out=torch.zeros((n, 14), device=dev),
    )


def make_physics_step(
    model: RobotModel,
    sim_dt: float,
    decimation: int,
    kp,
    kd,
    torque_limit,
    solver_iterations: int = 8,
    solver: str = "mega",
    max_depen_vel: float = 1.0,
):
    """Returns step(state, joint_targets (N, nj)) -> state, running
    `decimation` substeps at sim_dt with the targets held."""
    if solver != "mega":
        raise ValueError(f"the PyTorch port runs solver 'mega' only, got {solver!r}")
    mega = make_mega_step_batched(
        model, sim_dt, decimation, kp, kd, torque_limit,
        iterations=solver_iterations, max_depen_vel=max_depen_vel,
    )
    foot_idx = [b for b, _, _ in model.contact_point_runs()]
    nb = model.nbody

    def step(state: PhysicsState, targets: torch.Tensor) -> PhysicsState:
        qpos, qvel, lam, tau, ff, fk14 = mega(
            state.qpos, state.qvel, state.friction, state.base_mass_scale,
            state.contact_stiffness, state.contact_offset, state.kp_scale,
            state.kd_scale, state.contact_compliance, state.contact_lam, targets,
        )
        n = qpos.shape[0]
        cf = torch.zeros((n, nb, 3), device=qpos.device, dtype=qpos.dtype)
        cf[:, foot_idx] = ff.reshape(n, len(foot_idx), 3) / sim_dt
        return state.replace(
            qpos=qpos, qvel=qvel, contact_forces=cf, torques=tau,
            contact_lam=lam, fk_out=fk14,
        )

    return step
