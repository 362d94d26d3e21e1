"""Rotation / quaternion primitives on batched tensors.

Quaternion convention: (w, x, y, z), unit norm, Hamilton product. Every
function broadcasts over leading batch dimensions. Port of
humanoid_gym_tpu/physics/spatial.py.
"""

from __future__ import annotations

import math

import torch


def quat_identity(batch_shape=(), device="cpu") -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (world = R(q) @ v_local)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (batched)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis: (...,3) unit; angle: (...) radians."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([torch.cos(half)[..., None].expand(axis.shape[:-1] + (1,)), axis * s], dim=-1)


def quat_from_euler_zyx_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """URDF-style fixed-axis roll-pitch-yaw -> quaternion
    (R = Rz(yaw) @ Ry(pitch) @ Rx(roll))."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> intrinsic-xyz (roll, pitch, yaw), each in [-pi, pi]."""
    w, x, y, z = q.unbind(-1)
    t0 = 2.0 * (w * x + y * z)
    t1 = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(t0, t1)
    t2 = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(t2)
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(t3, t4)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """Integrate orientation by world-frame angular velocity over dt with the
    exponential map q' = exp(dt/2 · ω) ⊗ q (sinc form, finite at ω = 0)."""
    ang = omega_world * dt
    theta = torch.linalg.norm(ang, dim=-1, keepdim=True)
    half = 0.5 * theta
    k = torch.where(
        theta > 1e-9, torch.sin(half) / torch.clamp(theta, min=1e-12),
        torch.full_like(theta, 0.5),
    )
    dq = torch.cat([torch.cos(half), ang * k], dim=-1)
    return quat_normalize(quat_mul(dq, q))


def quat_derivative(q: torch.Tensor, omega_world: torch.Tensor) -> torch.Tensor:
    """dq/dt = 0.5 · (0, ω_world) ⊗ q."""
    omega_q = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world], dim=-1)
    return 0.5 * quat_mul(omega_q, q)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    yaw = quat_to_euler_xyz(q)[..., 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return torch.stack([x, y, v[..., 2]], dim=-1)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi]."""
    a = torch.remainder(angle + math.pi, 2 * math.pi)
    a = torch.where(a < 0, a + 2 * math.pi, a)
    return a - math.pi


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u = v × u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
