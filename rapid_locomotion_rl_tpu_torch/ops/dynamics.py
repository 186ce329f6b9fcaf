"""Dynamic state, per-env physical parameters and forward kinematics of
the simulated robot.

Port of the JAX package's ``ops/dynamics.py``: the two records that the
physics step takes, and the world-frame forward kinematics (``fk``,
``geom_world_positions``) that the renderer poses the robot with. The
generic (non-limb) dynamics there is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import quat as Q


class SimState(NamedTuple):
    """Dynamic state of the robots, batched on the leading env axis."""
    base_pos: torch.Tensor      # [N,3] world
    base_quat: torch.Tensor     # [N,4] xyzw, body->world
    base_lin_vel: torch.Tensor  # [N,3] world, velocity of base frame origin
    base_ang_vel: torch.Tensor  # [N,3] world
    q: torch.Tensor             # [N,nv] joint positions
    qd: torch.Tensor            # [N,nv] joint velocities


class PhysParams(NamedTuple):
    """Per-env physical properties entering the dynamics."""
    friction: torch.Tensor          # [N] robot shape friction coeff
    restitution: torch.Tensor       # [N]
    payload: torch.Tensor           # [N] added base mass [kg]
    com_displacement: torch.Tensor  # [N,3] base CoM offset [m]


class BodyFrames(NamedTuple):
    """World-frame kinematics of every dynamics body (leading batch axes
    as the state's, then the body axis)."""
    R: torch.Tensor        # [...,nb,3,3] body->world rotation
    p: torch.Tensor        # [...,nb,3] body frame origin, world
    w: torch.Tensor        # [...,nb,3] angular velocity, world
    v: torch.Tensor        # [...,nb,3] velocity of the body frame origin


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack((zero, -z, y, z, zero, -x, -y, x, zero), dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _axis_rotmat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (constant, unit) axis; broadcasts over
    leading batch axes of both arguments."""
    K = _skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def fk(model, state: SimState) -> BodyFrames:
    """Forward kinematics and world-frame velocity propagation, on the
    device of the state; the state's fields may carry any leading batch
    axes (none for one robot)."""
    q = state.q
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=q.device)
    Rs = [Q.quat_to_rotmat(state.base_quat)]
    ps = [state.base_pos]
    ws = [state.base_ang_vel]
    vs = [state.base_lin_vel]
    for i in range(1, model.nb):
        j = i - 1
        par = int(model.parent[i])
        axis = f(model.axis[j])
        R_pc = f(model.E_tree[j]) @ _axis_rotmat(axis, q[..., j])
        R_w = Rs[par] @ R_pc
        p_w = _mv(Rs[par], f(model.p_tree[j])) + ps[par]
        w_w = ws[par] + _mv(R_w, axis * state.qd[..., j, None])
        v_w = vs[par] + torch.linalg.cross(ws[par], p_w - ps[par], dim=-1)
        Rs.append(R_w)
        ps.append(p_w)
        ws.append(w_w)
        vs.append(v_w)
    d = q.dim() - 1
    return BodyFrames(torch.stack(Rs, d), torch.stack(ps, d),
                      torch.stack(ws, d), torch.stack(vs, d))


def geom_world_positions(model, frames: BodyFrames
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions and point velocities of all collision spheres."""
    gb = torch.as_tensor(model.geom_body, dtype=torch.long,
                         device=frames.p.device)
    off = torch.as_tensor(model.geom_offset, dtype=torch.float32,
                          device=frames.p.device)
    Rg = frames.R[..., gb, :, :]
    pb = frames.p[..., gb, :]
    pg = _mv(Rg, off) + pb
    vg = frames.v[..., gb, :] + torch.linalg.cross(frames.w[..., gb, :],
                                                   pg - pb, dim=-1)
    return pg, vg
