"""Quaternion math (xyzw convention) over the trailing axis of tensors.

Port of the JAX package's ``ops/quat.py``: every function broadcasts over
leading batch axes. q = [x, y, z, w]; rotating v by q is R(q) v.
"""

from __future__ import annotations

import math

import torch


def normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (xyzw)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack((
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ), dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat((-q[..., :3], q[..., 3:4]), dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: world = R(q) body."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


quat_apply = quat_rotate


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q⁻¹ (world -> body frame)."""
    return quat_rotate(quat_conjugate(q), v)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix, batched on leading axes."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack((
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ), dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor
                         ) -> torch.Tensor:
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat((xyz, torch.cos(half)[..., None]), dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack((
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ), dim=-1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Heading angle of the body x-axis in the world xy-plane."""
    ex = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ex[..., 0] = 1.0
    fwd = quat_rotate(q, ex)
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    yaw_q = torch.zeros_like(q)
    yaw_q[..., 2] = q[..., 2]
    yaw_q[..., 3] = q[..., 3]
    return quat_rotate(normalize(yaw_q), v)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi]."""
    a = torch.remainder(angle, 2.0 * math.pi)
    return torch.where(a > math.pi, a - 2.0 * math.pi, a)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt
                   ) -> torch.Tensor:
    """q' = normalize(q + 0.5 dt ω ⊗ q) for a world-frame ω."""
    omega_quat = torch.cat(
        (omega_world, torch.zeros_like(omega_world[..., :1])), dim=-1)
    dq = 0.5 * quat_mul(omega_quat, q)
    return normalize(q + dt * dq)
