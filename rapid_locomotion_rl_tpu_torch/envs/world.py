"""Per-env static world obstacles (the walls of a corridor) for HLP
navigation: port of the JAX package's ``envs/world.py``.

A corridor of 4 axis-aligned walls per env, placed relative to the env's
origin; the robot's collision spheres collide with them through a penalty
force (closest point on the box to the sphere center). The physics step
computes these forces inside every substep (:func:`..ops.soa_physics.
box_forces_soa`, and the kernel's world branch in ``csrc/
substep_chain.cuh``); :func:`box_sphere_forces` is the batched form of the
same force, which the tests use as a second reference.
"""

from __future__ import annotations

import torch

from ..ops.world import WorldBoxes, default_corridor

__all__ = ["WorldBoxes", "default_corridor", "first_min_axis",
           "box_sphere_forces"]


def first_min_axis(d: torch.Tensor) -> torch.Tensor:
    """One-hot [..., 3] of the first minimal entry of d [..., 3], by the
    ``<=`` chain of the JAX package's SoA form (jnp.argmin's rule; the
    tie rule of torch.argmin on CUDA is not documented)."""
    a0 = (d[..., 0] <= d[..., 1]) & (d[..., 0] <= d[..., 2])
    a1 = ~a0 & (d[..., 1] <= d[..., 2])
    a2 = ~a0 & ~a1
    return torch.stack([a0, a1, a2], dim=-1)


def box_sphere_forces(boxes: WorldBoxes, env_origin, geom_pos, geom_vel,
                      geom_radius, m_eff, *, stiffness: float,
                      damping: float, friction: float,
                      friction_vel_eps: float, dt: float) -> torch.Tensor:
    """World-frame contact forces of all spheres against all boxes, summed
    over the boxes: [..., ng, 3] for env_origin [..., 3], geom_pos and
    geom_vel [..., ng, 3], geom_radius and m_eff [ng]."""
    dev = geom_pos.device
    half = boxes.half_extents.to(dev)
    centers = boxes.centers.to(dev) + env_origin[..., None, :]   # [...,nbox,3]
    rel = geom_pos[..., :, None, :] - centers[..., None, :, :]   # [...,ng,nbox,3]
    clamped = torch.maximum(torch.minimum(rel, half), -half)
    # closest point on the box to the sphere center
    closest = centers[..., None, :, :] + clamped
    delta = geom_pos[..., :, None, :] - closest
    dist = torch.linalg.norm(delta, dim=-1)
    inside = dist < 1e-6
    # outside: normal along closest -> center; inside: out through the
    # nearest face (the first axis of least distance to the surface)
    face_dist = half - rel.abs()
    face_n = torch.sign(rel) * first_min_axis(face_dist).to(rel.dtype)
    n = torch.where(inside[..., None], face_n,
                    delta / torch.clamp_min(dist, 1e-6)[..., None])
    radius = geom_radius[:, None]
    depth_out = torch.clamp_min(radius - dist, 0.0) * ~inside
    depth_in = (face_dist.min(dim=-1).values + radius) * inside
    depth = depth_out + depth_in
    in_contact = depth > 0.0

    v_n = torch.sum(geom_vel[..., :, None, :] * n, dim=-1)
    v_t = geom_vel[..., :, None, :] - n * v_n[..., None]
    c_n = damping + stiffness * dt
    m = m_eff[:, None]
    f_n = torch.clamp_min((stiffness * depth - c_n * v_n)
                          / (1.0 + c_n * dt / m), 0.0) * in_contact
    vt_norm = torch.linalg.norm(v_t, dim=-1)
    c_t = friction * f_n / (vt_norm + friction_vel_eps)
    f_t = -(c_t / (1.0 + c_t * dt / m))[..., None] * v_t
    return torch.sum(n * f_n[..., None] + f_t, dim=-2)
