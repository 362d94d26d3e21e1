"""RobotModel: the static description of the articulated system, as tensors.

Built once on the host from the URDF (see urdf.py) and moved to the compute
device with `.to(device)`. Port of humanoid_gym_tpu/physics/model.py: the
same fields, the same values, float32 tensors instead of jnp arrays.

Layout (XBot-L after fixed-joint collapse):
  bodies: 0=base_link, 1..6 left leg chain, 7..12 right leg chain
  qpos (nq=19): [pos(3), quat wxyz(4), joint angles(12)]
  qvel (nv=18): [v_world(3), omega_world(3), joint vels(12)]
DOF columns of every Jacobian follow the qvel layout.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import urdf as U


@dataclass(frozen=True)
class RobotModel:
    # --- static topology / metadata ---
    body_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]
    body_parent: Tuple[int, ...]  # -1 for base
    feet_body_idx: Tuple[int, ...]
    knee_body_idx: Tuple[int, ...]
    termination_body_idx: Tuple[int, ...]
    penalized_body_idx: Tuple[int, ...]
    contact_point_body: Tuple[int, ...]  # per force-solved candidate
    probe_point_body: Tuple[int, ...]  # detection-only points

    # --- tensors ---
    joint_pos: torch.Tensor  # (nj,3) joint origin in parent body frame
    joint_rot: torch.Tensor  # (nj,3,3) joint frame rotation in parent body frame
    joint_axis: torch.Tensor  # (nj,3) axis in joint(child) frame
    body_mass: torch.Tensor  # (nb,)
    body_com: torch.Tensor  # (nb,3) in body frame
    body_inertia: torch.Tensor  # (nb,3,3) about COM, body frame
    dof_lower: torch.Tensor  # (nj,)
    dof_upper: torch.Tensor  # (nj,)
    dof_effort: torch.Tensor  # (nj,) URDF effort limit
    dof_vel_limit: torch.Tensor  # (nj,)
    dof_damping: torch.Tensor  # (nj,) URDF viscous damping
    dof_friction: torch.Tensor  # (nj,) URDF Coulomb friction
    dof_armature: torch.Tensor  # (nj,)
    contact_point_offset: torch.Tensor  # (K,3) in owning body frame
    probe_point_offset: torch.Tensor  # (P,3) detection-only candidates
    gravity: torch.Tensor  # (3,)

    @property
    def nbody(self) -> int:
        return len(self.body_parent)

    @property
    def nj(self) -> int:
        return len(self.dof_names)

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def ncon(self) -> int:
        return len(self.contact_point_body)

    @property
    def device(self) -> torch.device:
        return self.body_mass.device

    def to(self, device) -> "RobotModel":
        """A copy with every tensor on `device`."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    def contact_point_runs(self) -> Tuple[Tuple[int, int, int], ...]:
        """Contiguous (body, start, end) runs over contact_point_body: the
        per-foot grouping behind the OUT_FF row layout (foot-major,
        xyz-minor) of the mega kernel and its plain version."""
        runs = []
        cb = self.contact_point_body
        g0 = 0
        for k in range(1, len(cb) + 1):
            if k == len(cb) or cb[k] != cb[g0]:
                runs.append((cb[g0], g0, k))
                g0 = k
        return tuple(runs)


def _fk_numpy(bodies, qpos_joints: np.ndarray):
    """Host-side FK at a given joint configuration (identity base). Returns
    per-body (R, p) in base frame. Used only at model-build time."""
    R = [np.eye(3)]
    p = [np.zeros(3)]
    for b in bodies[1:]:
        Rp, pp = R[b.parent], p[b.parent]
        Rj = Rp @ b.joint_rot
        pj = Rp @ b.joint_pos + pp
        axis = b.joint.axis
        ang = qpos_joints[len(R) - 1] if len(qpos_joints) else 0.0
        c, s = np.cos(ang), np.sin(ang)
        a = axis / np.linalg.norm(axis)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        Raxis = np.eye(3) + s * K + (1 - c) * (K @ K)
        R.append(Rj @ Raxis)
        p.append(pj)
    return np.stack(R), np.stack(p)


def build_model_from_urdf(
    urdf_path: str,
    dof_order,
    foot_name: str = "ankle_roll",
    knee_name: str = "knee",
    termination_names=("base_link",),
    penalized_names=("base_link",),
    mesh_dir: str | None = None,
    gravity=(0.0, 0.0, -9.81),
    armature: float = 0.0,
    device="cpu",
) -> RobotModel:
    """Parse URDF, collapse fixed joints, extract contact candidates."""
    parsed = U.parse_urdf(urdf_path)
    bodies = U.collapse_fixed_joints(parsed, dof_order=list(dof_order))
    if mesh_dir is None:
        mesh_dir = os.path.normpath(
            os.path.join(os.path.dirname(urdf_path), "..", "meshes")
        )

    body_names = tuple(b.name for b in bodies)
    feet_idx = tuple(i for i, n in enumerate(body_names) if foot_name in n)
    knee_idx = tuple(i for i, n in enumerate(body_names) if knee_name in n)
    term_idx = tuple(
        i for i, n in enumerate(body_names) if any(t in n for t in termination_names)
    )
    pen_idx = tuple(
        i for i, n in enumerate(body_names) if any(t in n for t in penalized_names)
    )

    # Force-solved candidates: sole points of each foot, from the collision
    # mesh. 'Down' in the foot frame is world -z at the zero pose.
    Rfk, _ = _fk_numpy(bodies, np.zeros(len(dof_order)))
    contact_body: list[int] = []
    contact_off: list[np.ndarray] = []
    for fi in feet_idx:
        down_local = Rfk[fi].T @ np.array([0.0, 0.0, -1.0])
        mesh_col = next(
            ((X, c) for (X, c) in bodies[fi].collisions if c.kind == "mesh"), None
        )
        if mesh_col is None:
            raise ValueError(f"foot body {body_names[fi]} has no collision mesh")
        X, col = mesh_col
        fname = os.path.basename(col.mesh_file)
        pts_link = U.foot_sole_points(os.path.join(mesh_dir, fname), X.R.T @ down_local)
        if col.mesh_scale is not None:
            pts_link = pts_link * col.mesh_scale[None, :]
        pts_body = (X.R @ pts_link.T).T + X.p
        for pt in pts_body:
            contact_body.append(fi)
            contact_off.append(pt)

    # Detection-only probes: corners of the base collision box.
    probe_body: list[int] = []
    probe_off: list[np.ndarray] = []
    for ti in sorted(set(term_idx) | set(pen_idx)):
        for X, c in bodies[ti].collisions:
            if c.kind == "box":
                sx, sy, sz = c.size / 2.0
                for dx in (-sx, sx):
                    for dy in (-sy, sy):
                        for dz in (-sz, sz):
                            probe_body.append(ti)
                            probe_off.append(X.apply(np.array([dx, dy, dz])))

    nj = len(dof_order)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return RobotModel(
        body_names=body_names,
        dof_names=tuple(dof_order),
        body_parent=tuple(b.parent for b in bodies),
        feet_body_idx=feet_idx,
        knee_body_idx=knee_idx,
        termination_body_idx=term_idx,
        penalized_body_idx=pen_idx,
        contact_point_body=tuple(contact_body),
        probe_point_body=tuple(probe_body),
        joint_pos=t(np.stack([b.joint_pos for b in bodies[1:]])),
        joint_rot=t(np.stack([b.joint_rot for b in bodies[1:]])),
        joint_axis=t(np.stack([b.joint.axis for b in bodies[1:]])),
        body_mass=t(np.array([b.mass for b in bodies])),
        body_com=t(np.stack([b.com for b in bodies])),
        body_inertia=t(np.stack([b.inertia for b in bodies])),
        dof_lower=t(np.array([b.joint.lower for b in bodies[1:]])),
        dof_upper=t(np.array([b.joint.upper for b in bodies[1:]])),
        dof_effort=t(np.array([b.joint.effort for b in bodies[1:]])),
        dof_vel_limit=t(np.array([b.joint.velocity for b in bodies[1:]])),
        dof_damping=t(np.array([b.joint.damping for b in bodies[1:]])),
        dof_friction=t(np.array([b.joint.friction for b in bodies[1:]])),
        dof_armature=t(np.full((nj,), armature)),
        contact_point_offset=t(np.stack(contact_off)),
        probe_point_offset=t(np.stack(probe_off) if probe_off else np.zeros((0, 3))),
        gravity=t(np.array(gravity)),
    )


def build_xbot_model(urdf_path: str | None = None, **kw) -> RobotModel:
    from .. import XBOT_URDF
    from ..config.xbotl import XBOT_DOF_NAMES

    return build_model_from_urdf(
        urdf_path or XBOT_URDF,
        dof_order=XBOT_DOF_NAMES,
        foot_name="ankle_roll",
        knee_name="knee",
        termination_names=("base_link",),
        penalized_names=("base_link",),
        **kw,
    )
