"""Generate a minimal MJCF from a RobotModel for MuJoCo oracle tests.

Port of humanoid_gym_tpu/physics/mjcf_export.py for the port's RobotModel,
whose arrays are torch tensors (read here as NumPy on the host). For the
same URDF and arguments it writes the same MJCF string.

The exported model has the exact same bodies/joints/inertias as the
engine's RobotModel, with a floating base, no geoms (contact-free) — so
MuJoCo's mj_fullM / mj_rne / mj_forward ground-truth the engine's FK, mass
matrix, bias forces and free dynamics on identical parameters.

Test-infrastructure and asset generation only; never on the training path.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import RobotModel
from .urdf import mat_to_quat_wxyz


def _np(x) -> np.ndarray:
    """A model field (a tensor on any device, or a tuple) as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def model_to_mjcf(
    model: RobotModel,
    armature: float = 0.0,
    with_contacts: bool = False,
    friction: float = 0.7,
    joint_damping=None,
    plane_zaxis=None,
    deployable: bool = False,
    base_z: float = 0.0,
    hfield_png: str = None,
    hfield_size=None,
) -> str:
    """with_contacts=True adds a ground plane + small spheres at the exact
    16 sole contact candidates, for trajectory-level contact oracles.
    joint_damping: optional (nj,) viscous damping — lets MuJoCo integrate a
    PD controller's kd implicitly (as our engine does), which is required for
    stability of the nearly massless ankle bodies at dt=1 ms.

    hfield_png + hfield_size=(rx, ry, zmax, zbase): replace the flat floor
    with a PNG heightfield ground (reference XBot-L-terrain.xml:151-158
    pattern) — used to synthesize the XBot-S deployment-terrain model with
    Froude-scaled extents from the same uneven.png.

    deployable=True emits a model `export.sim2sim.run_mujoco` can drive:
    per-DOF torque motors (ctrlrange = URDF effort limits), an IMU site on
    the base with the 'orientation' framequat + 'angular-velocity' gyro
    sensors the deployment loop reads (reference XBot-L.xml:512-559), joint
    limits enabled, and the base spawned at `base_z`. Used to synthesize the
    XBot-S validation model (the reference ships no XBot-S assets;
    README.md:19 claims sim2real on both morphologies)."""
    damping = (
        np.zeros(len(model.dof_names))
        if joint_damping is None
        else np.asarray(joint_damping, float)
    )
    mass = _np(model.body_mass)
    com = _np(model.body_com)
    inertia = _np(model.body_inertia)
    jpos = _np(model.joint_pos)
    jrot = _np(model.joint_rot)
    jaxis = _np(model.joint_axis)
    lower = _np(model.dof_lower)
    upper = _np(model.dof_upper)

    def fmt(v):
        return " ".join(f"{x:.10g}" for x in np.atleast_1d(v))

    def body_xml(i: int, depth: int) -> str:
        ind = "  " * depth
        name = model.body_names[i]
        # full inertia via eigendecomposition -> principal frame
        w, V = np.linalg.eigh(inertia[i])
        if np.linalg.det(V) < 0:
            V = -V
        q_i = mat_to_quat_wxyz(V)
        lines = []
        if i == 0:
            lines.append(f'{ind}<body name="{name}" pos="0 0 {base_z:.10g}">')
            lines.append(f'{ind}  <freejoint name="root"/>')
            if deployable:
                lines.append(f'{ind}  <site name="imu" pos="0 0 0"/>')
        else:
            q_j = mat_to_quat_wxyz(jrot[i - 1])
            lines.append(
                f'{ind}<body name="{name}" pos="{fmt(jpos[i-1])}" quat="{fmt(q_j)}">'
            )
            limited = "true" if deployable else "false"
            lines.append(
                f'{ind}  <joint name="{model.dof_names[i-1]}" type="hinge" '
                f'axis="{fmt(jaxis[i-1])}" range="{lower[i-1]:.10g} {upper[i-1]:.10g}" '
                f'limited="{limited}" damping="{damping[i-1]:.10g}" '
                f'armature="{armature}" frictionloss="0"/>'
            )
        lines.append(
            f'{ind}  <inertial pos="{fmt(com[i])}" quat="{fmt(q_i)}" '
            f'mass="{mass[i]:.10g}" diaginertia="{fmt(np.maximum(w, 1e-12))}"/>'
        )
        if with_contacts:
            offs = _np(model.contact_point_offset)
            # oracle tests pin the stiff near-rigid solref; the deployable
            # model keeps MuJoCo's default contact params (solref 0.002 =
            # 2x dt sits exactly on the stability boundary and lets a
            # standing robot sink through the floor)
            solref = "" if deployable else ' solref="0.002 1"'
            size = "0.01" if deployable else "0.002"
            for k, b in enumerate(model.contact_point_body):
                if b == i:
                    lines.append(
                        f'{ind}  <geom name="cp{k}" type="sphere" size="{size}" '
                        f'pos="{fmt(offs[k])}" friction="{friction:.10g} 0 0" '
                        f'condim="3"{solref}/>'
                    )
        for c, par in enumerate(model.body_parent):
            if par == i:
                lines.append(body_xml(c, depth + 1))
        lines.append(f"{ind}</body>")
        return "\n".join(lines)

    # optional tilted floor (slope oracles): plane through the origin with
    # the given outward normal
    zax = (
        f' zaxis="{fmt(np.asarray(plane_zaxis, float))}"'
        if plane_zaxis is not None
        else ""
    )
    assets = ""
    if hfield_png is not None:
        # the hfield floor replaces the plane outright, so arguments that
        # only shape the plane would be silently dropped — reject instead
        # (ADVICE r4)
        if plane_zaxis is not None:
            raise ValueError("plane_zaxis is incompatible with hfield_png")
        if not with_contacts:
            raise ValueError(
                "hfield_png requires with_contacts=True (the hfield IS a "
                "contact floor)"
            )
        hs = np.asarray(hfield_size, float)
        assets = (
            f'  <asset>\n    <hfield name="ground_hf" file="{hfield_png}" '
            f'ncol="0" nrow="0" size="{fmt(hs)}"/>\n  </asset>\n'
        )
        # 1 mm x offset like the reference terrain model (avoids exact
        # grid-edge spawn alignment)
        plane = (
            f'    <geom name="floor" type="hfield" hfield="ground_hf" '
            f'size="0 0 1" pos="0.001 0 0" '
            f'friction="{friction:.10g} 0 0" condim="3"/>\n'
        )
    else:
        plane = (
            f'    <geom name="floor" type="plane" size="50 50 1" '
            f'friction="{friction:.10g} 0 0" condim="3"{zax}/>\n'
            if with_contacts
            else ""
        )
    tail = ""
    if deployable:
        effort = _np(model.dof_effort).astype(float)
        motors = "\n".join(
            f'    <motor name="{n}" joint="{n}" gear="1" '
            f'ctrlrange="-{effort[j]:.10g} {effort[j]:.10g}"/>'
            for j, n in enumerate(model.dof_names)
        )
        tail = f"""  <actuator>
{motors}
  </actuator>
  <sensor>
    <framequat name="orientation" objtype="site" objname="imu"/>
    <gyro name="angular-velocity" site="imu"/>
  </sensor>
"""
    return f"""<mujoco model="hgt-oracle">
  <compiler angle="radian"/>
  <option timestep="0.001" gravity="0 0 -9.81" integrator="Euler"/>
{assets}  <worldbody>
{plane}{body_xml(0, 2)}
  </worldbody>
{tail}</mujoco>
"""
