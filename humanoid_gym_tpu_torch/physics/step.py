"""The policy-step physics: PhysicsState, the substep and the policy step.

Port of humanoid_gym_tpu/physics/step.py: one call runs `decimation`
1 kHz substeps (PD actuation -> dynamics -> contacts -> integration) for a
batch of envs. Solver "mega" hands the whole policy step to
physics/mega.py (one kernel launch on the card); every other solver
("apgd", "pgs", "apgd_pallas", "fused_pallas") loops `make_substep` in
Python, with the contact solve of "apgd_pallas" / "fused_pallas" in the
CUDA kernels of physics/solve.py. A CUDA state runs the kernels, a CPU
state their plain versions; there is no interpret mode, so the
`*_interpret` solver names are refused. All state tensors carry the env
axis first.

On a heightfield (`terrain_map` with a non-flat `terrain_height_fn`) the
contacts resolve against the bilinear surface with sloped frames frozen at
the policy-step start, from the surface gradient plus the env's contact-
slope DR bias: the mega kernel gathers them once per launch, and every
substep solver gets the same frames for the whole decimation window.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from . import spatial as S
from ..terrain.terrain import flat_height_fn, make_contact_height_fn, make_grad_fn
from ..utils.tracing import stage
from .contact import (
    ContactResult, build_contact_setup, joint_limit_bounds, resolve_contacts,
    terrain_contact_frames, world_impulses,
)
from .dynamics import compute_dynamics, solve_mtilde
from .kinematics import index_tensor
from .mega import make_contact_xy, make_mega_step_batched, pd_torques
from .model import RobotModel
from .solve import fused_dense_solve

SOLVERS = ("mega", "apgd", "pgs", "apgd_pallas", "fused_pallas")


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
    # contact-slope DR bias (N, 2) added to the terrain gradient of the
    # sloped contact frames; inert on flat ground
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


def substep_dynamics(model: RobotModel, dt: float, state: PhysicsState, targets, kp, kd,
                     torque_limit, factor: bool = True):
    """The part of a substep before the contact solve: (tau, dyn,
    implicit_d, rhs) with tau the clipped PD torques under the DR-scaled
    gains, dyn the mass matrix / bias forces (and the Cholesky factor of
    Mtilde when `factor`), implicit_d the damping on Mtilde's diagonal and
    rhs = dt * (S tau + tau_fric - h), the delta-v form
    (M + dt D)(v+ - v) = rhs."""
    qpos, qvel = state.qpos, state.qvel
    n = qpos.shape[0]
    # motor-strength DR scales the effective PD gains per env
    kp_eff = kp * state.kp_scale[:, None]
    kd_eff = kd * state.kd_scale[:, None]
    tau = pd_torques(qpos, qvel, targets, kp_eff, kd_eff, torque_limit)
    # implicit damping: PD kd + URDF viscous damping on joint DOFs
    implicit_d = kd_eff + model.dof_damping
    mass_scale = torch.ones((n, model.nbody), device=qpos.device, dtype=qpos.dtype)
    mass_scale[:, 0] = state.base_mass_scale
    dyn = compute_dynamics(model, qpos, qvel, dt, implicit_d, mass_scale, factor=factor)
    # Coulomb joint friction (smooth sign) plus the explicit part of the
    # URDF viscous damping
    dq = qvel[:, 6:]
    tau_fric = -model.dof_friction * torch.tanh(dq / 0.05) - model.dof_damping * dq
    gen_force = torch.cat([torch.zeros_like(qvel[:, :6]), tau + tau_fric], dim=1)
    return tau, dyn, implicit_d, dt * (gen_force - dyn.h)


def fused_operands(model: RobotModel, dt: float, state: PhysicsState, targets, kp, kd,
                   torque_limit, terrain_height_fn=flat_height_fn, max_depen_vel: float = 1.0,
                   frames_override=None):
    """(tau, setup, operands): the ten operands `solve.fused_dense_solve`
    takes at this state, contiguous, in the external DOF order; with
    sloped frames, J's contact rows are already projected onto them."""
    tau, dyn, implicit_d, rhs = substep_dynamics(
        model, dt, state, targets, kp, kd, torque_limit, factor=False)
    setup = build_contact_setup(
        model, dyn, terrain_height_fn, dt, max_depen_vel=max_depen_vel,
        baumgarte=0.2 * state.contact_stiffness, contact_offset=state.contact_offset,
        frames_override=frames_override,
    )
    sign, lb = joint_limit_bounds(model, state.qpos, dt)
    D = torch.cat([torch.zeros_like(state.qvel[:, :6]), implicit_d], dim=1)
    Mt = dyn.M + dt * torch.diag_embed(D)
    ops = (Mt, setup.J, state.qvel, rhs, setup.lo_bound, sign, lb, state.friction,
           state.contact_compliance, state.contact_lam)
    return tau, setup, tuple(t.contiguous() for t in ops)


def make_substep(
    model: RobotModel,
    dt: float,
    kp,
    kd,
    torque_limit,
    terrain_height_fn=flat_height_fn,
    solver_iterations: int = 24,
    max_depen_vel: float = 1.0,
    solver: str = "apgd",
):
    """Returns substep(state, joint_targets (N, nj), frames_override=None)
    -> state: one 1 kHz step of PD actuation, dynamics, the contact solve
    and semi-implicit integration, for every env. frames_override (N, K,
    3, 3) are the policy-step-start sloped contact frames on a heightfield
    (None: flat ground, identity frames)."""
    if solver not in SOLVERS or solver == "mega":
        raise ValueError(f"make_substep runs solvers {SOLVERS[1:]}, got {solver!r}")
    nb = model.nbody
    body_idx = torch.as_tensor(model.contact_point_body, device=model.device)

    def substep(state: PhysicsState, targets: torch.Tensor, frames_override=None) -> PhysicsState:
        qpos, qvel = state.qpos, state.qvel
        n = qpos.shape[0]
        if solver == "fused_pallas":
            # Cholesky + v_free + Delassus + APGD + dv in one kernel launch
            tau, setup, ops = fused_operands(model, dt, state, targets, kp, kd, torque_limit,
                                             terrain_height_fn, max_depen_vel, frames_override)
            qvel_new, lam = fused_dense_solve(*ops, iterations=solver_iterations)
            res = ContactResult(
                qvel_new=qvel_new, impulses=world_impulses(lam, setup), phi=setup.phi,
                pos_w=setup.pos_w, lam=lam,
            )
        else:
            tau, dyn, _, rhs = substep_dynamics(model, dt, state, targets, kp, kd, torque_limit)
            v_free = qvel + solve_mtilde(dyn.Mtilde_chol, rhs)
            res = resolve_contacts(
                model, dyn, qpos, v_free, terrain_height_fn, dt, state.friction,
                iterations=solver_iterations, max_depen_vel=max_depen_vel, solver=solver,
                baumgarte=0.2 * state.contact_stiffness, contact_offset=state.contact_offset,
                compliance=state.contact_compliance, lam0=state.contact_lam,
                frames_override=frames_override,
            )
        # DOF velocity limits (URDF <limit velocity>)
        vj = torch.maximum(torch.minimum(res.qvel_new[:, 6:], model.dof_vel_limit),
                           -model.dof_vel_limit)
        qvel_new = torch.cat([res.qvel_new[:, :6], vj], dim=1)

        # integrate (semi-implicit Euler; quaternion exponential map)
        pos_new = qpos[:, 0:3] + dt * qvel_new[:, 0:3]
        quat_new = S.quat_integrate(qpos[:, 3:7], qvel_new[:, 3:6], dt)
        qpos_new = torch.cat([pos_new, quat_new, qpos[:, 7:] + dt * vj], dim=1)

        # net contact force per body (world frame, Newtons)
        cf = torch.zeros((n, nb, 3), device=qpos.device, dtype=qpos.dtype)
        cf.index_add_(1, body_idx, res.impulses / dt)
        return state.replace(
            qpos=qpos_new, qvel=qvel_new, contact_forces=cf, torques=tau, contact_lam=res.lam,
        )

    return substep


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
    terrain_height_fn=flat_height_fn,
    terrain_map=None,
):
    """Returns step(state, joint_targets (N, nj)) -> state, running
    `decimation` substeps at sim_dt with the targets held. Solver "mega"
    is one kernel launch per call; the others loop `make_substep` and leave
    `fk_out` untouched (zeros), so the env computes its own kinematics.

    terrain_height_fn is the env's (observation) height function; with a
    non-flat one and the `terrain_map` it came from, contacts use the map's
    bilinear surface and sloped frames (module docstring)."""
    if solver.endswith("_interpret"):
        raise ValueError(
            f"solver {solver!r}: the PyTorch port has no interpret mode (a CPU tensor takes the "
            f"plain version, a CUDA tensor the kernel); use {solver[:-len('_interpret')]!r}")
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; the PyTorch port runs {SOLVERS}")
    on_terrain = terrain_map is not None and terrain_height_fn is not flat_height_fn
    if solver != "mega":
        dev = model.device
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        contact_height_fn = make_contact_height_fn(terrain_map, dev) if on_terrain \
            else terrain_height_fn
        substep = make_substep(
            model, sim_dt, f(kp), f(kd), f(torque_limit), contact_height_fn, solver_iterations,
            max_depen_vel=max_depen_vel, solver=solver,
        )
        frames_at = _make_frames_at(model, make_grad_fn(terrain_map, dev)) if on_terrain else None

        def substep_loop(state: PhysicsState, targets: torch.Tensor) -> PhysicsState:
            frames0 = None
            if on_terrain:
                with stage("env.physics.terrain"):
                    frames0 = frames_at(state.qpos, state.slope_bias)
            for _ in range(decimation):
                state = substep(state, targets, frames0)
            return state

        return substep_loop
    if terrain_height_fn is not flat_height_fn and terrain_map is None:
        raise ValueError("solver 'mega' needs flat ground or the TerrainMap of the height function "
                         "(its kernel reads patches of the map's grid)")
    mega = make_mega_step_batched(
        model, sim_dt, decimation, kp, kd, torque_limit,
        iterations=solver_iterations, max_depen_vel=max_depen_vel,
        terrain_map=terrain_map if on_terrain else None,
    )
    foot_idx = index_tensor(tuple(b for b, _, _ in model.contact_point_runs()), model.device)
    nb = model.nbody

    def step(state: PhysicsState, targets: torch.Tensor) -> PhysicsState:
        qpos, qvel, lam, tau, ff, fk14 = mega(
            state.qpos, state.qvel, state.friction, state.base_mass_scale,
            state.contact_stiffness, state.contact_offset, state.kp_scale,
            state.kd_scale, state.contact_compliance, state.contact_lam, state.slope_bias,
            targets,
        )
        n = qpos.shape[0]
        cf = torch.zeros((n, nb, 3), device=qpos.device, dtype=qpos.dtype)
        cf[:, foot_idx] = ff.reshape(n, len(foot_idx), 3) / sim_dt
        return state.replace(
            qpos=qpos, qvel=qvel, contact_forces=cf, torques=tau,
            contact_lam=lam, fk_out=fk14,
        )

    step.terrain_patches = getattr(mega, "terrain_patches", None)
    return step


# an alias, as the JAX package has one
physics_step = make_physics_step


def _make_frames_at(model: RobotModel, grad_fn):
    """frames_at(qpos, slope_bias) -> (N, K, 3, 3): the sloped contact
    frames at the contact points' positions, the surface gradient there
    plus the env's slope bias."""
    contact_xy = make_contact_xy(model)

    def frames_at(qpos, slope_bias):
        xy = contact_xy(qpos)
        gx, gy = grad_fn(xy[..., 0], xy[..., 1])
        return terrain_contact_frames(gx + slope_bias[:, 0:1], gy + slope_bias[:, 1:2])

    return frames_at
