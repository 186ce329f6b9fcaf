"""Dynamic state, per-env physical parameters and forward kinematics of
the simulated robot.

Port of the JAX package's ``ops/dynamics.py``: the two records that the
physics step takes, the world-frame forward kinematics (``fk``,
``geom_world_positions``) that the renderer and the general step pose the
robot with, and the general (body by body) articulated dynamics of the
AoS step (:mod:`.physics`): the Articulated-Body Algorithm (``aba``), its
split into a force-independent inertia sweep and a reusable bias solve
(``articulated_sweeps``), the per-geom inverse apparent inertia
(``osim_from_sweeps``, ``contact_inv_inertia``), joint-limit torques and
semi-implicit Euler (``integrate``).

Every function takes [N, ...] tensors with the env axis first and loops in
Python over the model's static tree; the 6x6 solves keep the JAX package's
unrolled Cholesky (:func:`.spatial.solve_psd6`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import quat as Q
from . import spatial as S


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
    c = model_consts(model, q.device)
    Rs = [Q.quat_to_rotmat(state.base_quat)]
    ps = [state.base_pos]
    ws = [state.base_ang_vel]
    vs = [state.base_lin_vel]
    for i in range(1, model.nb):
        j = i - 1
        par = int(model.parent[i])
        axis = c.axis[j]
        R_pc = c.E_tree[j] @ _axis_rotmat(axis, q[..., j])
        R_w = Rs[par] @ R_pc
        p_w = _mv(Rs[par], c.p_tree[j]) + ps[par]
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
    c = model_consts(model, frames.p.device)
    gb = c.geom_body
    Rg = frames.R[..., gb, :, :]
    pb = frames.p[..., gb, :]
    pg = _mv(Rg, c.geom_offset) + pb
    vg = frames.v[..., gb, :] + torch.linalg.cross(frames.w[..., gb, :],
                                                   pg - pb, dim=-1)
    return pg, vg


# ---------------------------------------------------------------------------
# the general articulated dynamics
# ---------------------------------------------------------------------------
class _Consts(NamedTuple):
    """A model's constants as float32 tensors on one device."""
    E_tree: torch.Tensor     # [nv,3,3]
    p_tree: torch.Tensor     # [nv,3]
    axis: torch.Tensor       # [nv,3]
    S: torch.Tensor          # [nv,6] motion subspace [axis; 0]
    armature: torch.Tensor   # [nv]
    mass: torch.Tensor       # [nb]
    com: torch.Tensor        # [nb,3]
    inertia: torch.Tensor    # [nb,3,3]
    I_body: torch.Tensor     # [nb,6,6] spatial inertias (row 0 unused)
    geom_body: torch.Tensor  # [ng] int64
    geom_offset: torch.Tensor  # [ng,3]
    geom_radius: torch.Tensor  # [ng]


_CONSTS = {}


def model_consts(model, device) -> _Consts:
    """The model's constants on ``device``, built once per (model, device)
    (the entry keeps the model alive, so its id is not reused)."""
    device = torch.device(device)
    key = (id(model), str(device))
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not model:
        f = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=device)
        axis = f(model.axis).reshape(model.nv, 3)
        mass, com, inertia = f(model.mass), f(model.com), f(model.inertia)
        c = _Consts(
            E_tree=f(model.E_tree).reshape(model.nv, 3, 3),
            p_tree=f(model.p_tree).reshape(model.nv, 3), axis=axis,
            S=torch.cat((axis, torch.zeros_like(axis)), -1),
            armature=f(model.dof_armature), mass=mass, com=com,
            inertia=inertia,
            I_body=S.spatial_inertia(mass, com, inertia),
            geom_body=torch.as_tensor(np.asarray(model.geom_body, np.int64),
                                      device=device),
            geom_offset=f(model.geom_offset).reshape(model.ng, 3),
            geom_radius=f(model.geom_radius))
        hit = (model, c)
        _CONSTS[key] = hit
    return hit[1]


def _base_inertia(c: _Consts, payload, com_offset) -> torch.Tensor:
    """[N,6,6] base spatial inertia with the per-env payload and CoM
    displacement (inertia rescaled with the mass)."""
    base_mass = c.mass[0] + payload
    base_com = com_offset + c.com[0]
    base_inertia = c.inertia[0] * (base_mass / c.mass[0])[..., None, None]
    return S.spatial_inertia(base_mass, base_com, base_inertia)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _T(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _body_rotations(model, state: SimState):
    """World rotations of every body (the rotation part of fk)."""
    c = model_consts(model, state.q.device)
    Rs = [Q.quat_to_rotmat(state.base_quat)]
    for i in range(1, model.nb):
        j = i - 1
        Rs.append(Rs[int(model.parent[i])]
                  @ (c.E_tree[j] @ _axis_rotmat(c.axis[j], state.q[:, j])))
    return Rs


def articulated_sweeps(model, state: SimState, gravity: torch.Tensor,
                       payload: torch.Tensor, com_offset: torch.Tensor,
                       fixed_base: bool = False,
                       joint_impedance: Optional[torch.Tensor] = None):
    """The ABA's force-independent half (velocities, bias, the articulated
    inertia backward sweep) and a reusable bias solve, so one substep
    shares ONE inertia sweep between the inverse apparent inertia, the
    free-dynamics pass and the final contact pass.

    Returns (sweeps dict, solve) where solve(tau, f_ext_body,
    return_body_accels=False) -> (qdd [N,nv], a0_true [N,6][, a_body
    [N,nb,6]]); ``f_ext_body`` is [N,nb,6] in each body's own frame, or
    None."""
    nb, nv = model.nb, model.nv
    c = model_consts(model, state.q.device)
    I_body = [_base_inertia(c, payload, com_offset)] + [
        c.I_body[i] for i in range(1, nb)]

    R0 = Q.quat_to_rotmat(state.base_quat)
    R0t = _T(R0)
    v = [torch.cat((S._mv(R0t, state.base_ang_vel),
                    S._mv(R0t, state.base_lin_vel)), -1)]
    cb = [torch.zeros_like(v[0])]
    Xup_E = [None]
    Ss = [None]
    for i in range(1, nb):
        j = i - 1
        E = _T(c.E_tree[j] @ _axis_rotmat(c.axis[j], state.q[:, j]))
        Si = c.S[j]
        sq = Si * state.qd[:, j, None]
        vi = S.xform_motion(E, c.p_tree[j], v[int(model.parent[i])]) + sq
        v.append(vi)
        cb.append(S.crm(vi, sq))
        Xup_E.append(E)
        Ss.append(Si)

    pA_vel = [S.crf(v[i], S._mv(I_body[i], v[i])) for i in range(nb)]

    IA = list(I_body)
    U = [None] * nb
    d = [None] * nb
    Ia_s = [None] * nb
    Xs = [None] * nb
    for i in range(nb - 1, 0, -1):
        j = i - 1
        Si = Ss[i]
        U[i] = S._mv(IA[i], Si)
        dd = _dot(Si, U[i]) + c.armature[j]
        if joint_impedance is not None:
            dd = dd + joint_impedance[:, j]
        d[i] = torch.clamp_min(dd, 1e-9)
        Ia = IA[i] - _outer(U[i], U[i]) / d[i][..., None, None]
        Ia_s[i] = Ia
        par = int(model.parent[i])
        Xs[i] = S.xmat_motion(Xup_E[i], c.p_tree[i - 1])
        IA[par] = IA[par] + _T(Xs[i]) @ Ia @ Xs[i]

    zeros3 = torch.zeros_like(state.base_pos)
    a_grav = torch.cat((zeros3, S._mv(R0t, gravity)), -1)

    def solve(tau, f_ext_body, return_body_accels: bool = False):
        pA = [pA_vel[i] - f_ext_body[:, i] if f_ext_body is not None
              else pA_vel[i] for i in range(nb)]
        u = [None] * nb
        for i in range(nb - 1, 0, -1):
            j = i - 1
            u[i] = tau[:, j] - _dot(Ss[i], pA[i])
            pa = (pA[i] + S._mv(Ia_s[i], cb[i])
                  + U[i] * (u[i] / d[i])[..., None])
            par = int(model.parent[i])
            pA[par] = pA[par] + S.xform_force_to_parent(
                Xup_E[i], c.p_tree[j], pa)
        if fixed_base:
            a0_rel = -a_grav
        else:
            a0_rel = -S.solve_psd6(IA[0], pA[0])
        a = [a0_rel]
        qdd = [None] * nv
        for i in range(1, nb):
            j = i - 1
            par = int(model.parent[i])
            ap = S.xform_motion(Xup_E[i], c.p_tree[j], a[par]) + cb[i]
            qdd[j] = (u[i] - _dot(U[i], ap)) / d[i]
            a.append(ap + Ss[i] * qdd[j][..., None])
        a0_true = a0_rel + a_grav
        if return_body_accels:
            R_list = _body_rotations(model, state)
            a_true = [a[i] + torch.cat(
                (zeros3, S._mv(_T(R_list[i]), gravity)), -1)
                for i in range(nb)]
            return (torch.stack(qdd, -1), a0_true,
                    torch.stack(a_true, 1))
        return torch.stack(qdd, -1), a0_true

    sweeps = dict(IA=IA, U=U, d=d, Xs=Xs, Ss=Ss)
    return sweeps, solve


def aba(model, state: SimState, tau: torch.Tensor,
        f_ext_body: Optional[torch.Tensor], gravity: torch.Tensor,
        payload: torch.Tensor, com_offset: torch.Tensor,
        fixed_base: bool = False, return_body_accels: bool = False,
        joint_impedance: Optional[torch.Tensor] = None):
    """Articulated-Body Algorithm: forward dynamics of the tree.

    ``tau`` [N,nv] joint torques (actuation and passive terms summed);
    ``f_ext_body`` [N,nb,6] external spatial forces in each body's own
    frame, or None; ``gravity`` [3]; ``payload`` [N] added base mass;
    ``com_offset`` [N,3] base CoM offset; ``joint_impedance`` [N,nv] the
    implicit-PD diagonal dt*(Kd_eff + dt*Kp_eff), or None.

    Returns (qdd [N,nv], a0 [N,6]): joint accelerations and the true base
    spatial acceleration in base coordinates ([ang; lin]); with
    ``return_body_accels`` also every body's true spatial acceleration in
    its own coordinates [N,nb,6]. The same arithmetic as the JAX package's
    ``aba``, which is its ``articulated_sweeps`` and one ``solve``."""
    _, solve = articulated_sweeps(model, state, gravity, payload,
                                  com_offset, fixed_base=fixed_base,
                                  joint_impedance=joint_impedance)
    return solve(tau, f_ext_body, return_body_accels=return_body_accels)


def point_accels(model, frames: BodyFrames, a_body: torch.Tensor,
                 arm_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World-frame acceleration [N,ng,3] of a point on each collision
    sphere's body (the sphere center, or the world arms ``arm_w`` [N,ng,3]
    from the body origin), given the true body accelerations [N,nb,6]."""
    c = model_consts(model, frames.p.device)
    gb = c.geom_body
    Rg = frames.R[:, gb]
    ab = a_body[:, gb]
    wg = frames.w[:, gb]
    wdot_w = S._mv(Rg, ab[..., :3])
    a_org_w = S._mv(Rg, ab[..., 3:]) + S.cross(wg, frames.v[:, gb])
    if arm_w is None:
        arm_w = S._mv(Rg, c.geom_offset)
    return (a_org_w + S.cross(wdot_w, arm_w)
            + S.cross(wg, S.cross(wg, arm_w)))


def inv_psd6(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a symmetric positive-definite 6x6 by the unrolled
    Cholesky of :func:`.spatial.solve_psd6`, one column at a time."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    cols = [S.solve_psd6(A, eye[k].expand(A.shape[:-2] + (6,)))
            for k in range(6)]
    return torch.stack(cols, dim=-1)


def _phi(model, sweeps, n: int, device, fixed_base: bool,
         base_split: float):
    """Featherstone's inverse-inertia recursion root to leaf: Phi_0 =
    base_split * IA_0^-1, Phi_i = S d^-1 S^T + P (X Phi_p X^T) P^T with
    P = 1 - S d^-1 U^T."""
    IA, U, d, Xs, Ss = (sweeps["IA"], sweeps["U"], sweeps["d"],
                        sweeps["Xs"], sweeps["Ss"])
    Phi = [None] * model.nb
    if fixed_base:
        Phi[0] = torch.zeros((n, 6, 6), device=device)
    else:
        Phi[0] = base_split * inv_psd6(IA[0])
    eye = torch.eye(6, device=device)
    for i in range(1, model.nb):
        par = int(model.parent[i])
        M = Xs[i] @ Phi[par] @ _T(Xs[i])
        di = d[i][..., None, None]
        P = eye - _outer(Ss[i], U[i]) / di
        Phi[i] = _outer(Ss[i], Ss[i]) / di + P @ M @ _T(P)
    return Phi


def _project(model, Phi, frames: BodyFrames, r: torch.Tensor):
    """Per-geom world 3x3 inverse apparent inertia at the world arms r
    [N,ng,3], and the angular block, from the bodies' Phi."""
    gb = model_consts(model, frames.p.device).geom_body
    Pb = torch.stack(Phi, 1)[:, gb]               # [N,ng,6,6]
    R = frames.R[:, gb]
    Rt = _T(R)
    A_w = R @ Pb[..., :3, :3] @ Rt
    B_w = R @ Pb[..., :3, 3:] @ Rt
    D_w = R @ Pb[..., 3:, 3:] @ Rt
    Sm = -S.skew(r)
    lam = Sm @ A_w @ _T(Sm) + Sm @ B_w + _T(B_w) @ _T(Sm) + D_w
    return lam, A_w


def contact_inv_inertia(model, state: SimState, frames: BodyFrames,
                        payload: torch.Tensor, com_offset: torch.Tensor,
                        fixed_base: bool = False, base_split: float = 4.0,
                        contact_arm_w: Optional[torch.Tensor] = None,
                        joint_impedance: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Per-geom 3x3 inverse apparent inertia [N,ng,3,3] (the diagonal of
    the Delassus operator) in world coordinates, at the sphere centers or
    at the world arms ``contact_arm_w``; ``base_split`` mass-splits the
    base's share by the legs that can push it at once."""
    n = state.q.shape[0]
    if model.ng == 0:
        return torch.zeros((n, 0, 3, 3), device=state.q.device)
    sweeps, _ = articulated_sweeps(
        model, state, torch.zeros(3, device=state.q.device), payload,
        com_offset, fixed_base=fixed_base, joint_impedance=joint_impedance)
    Phi = _phi(model, sweeps, n, state.q.device, fixed_base, base_split)
    if contact_arm_w is None:
        c = model_consts(model, state.q.device)
        contact_arm_w = S._mv(frames.R[:, c.geom_body], c.geom_offset)
    return _project(model, Phi, frames, contact_arm_w)[0]


def osim_from_sweeps(model, sweeps, frames: BodyFrames,
                     contact_arm_w: torch.Tensor, fixed_base: bool = False,
                     base_split: float = 4.0, return_ang: bool = False,
                     return_base: bool = False):
    """Per-geom world 3x3 inverse apparent inertia [N,ng,3,3] from a
    completed inertia sweep, at the world arms ``contact_arm_w``.

    ``return_ang`` adds the per-geom world angular block [N,ng,3,3] (the
    body's angular response to a pure torque, for the torsional patch);
    ``return_base`` adds the world base mobility Phi0_w [N,6,6] about the
    base origin WITHOUT the Jacobi split (the cross-contact coupling of
    the iterated contact solve)."""
    n = frames.p.shape[0]
    dev = frames.p.device
    Phi = _phi(model, sweeps, n, dev, fixed_base, base_split)
    phi0_w = None
    if return_base:
        R0 = frames.R[:, 0]
        Z = torch.zeros_like(R0)
        blk = torch.cat((torch.cat((R0, Z), -1), torch.cat((Z, R0), -1)),
                        -2)
        phi0_w = blk @ (Phi[0] / (base_split if not fixed_base else 1.0)
                        ) @ _T(blk)
    if model.ng == 0:
        z = torch.zeros((n, 0, 3, 3), device=dev)
        out = [z] + ([z] if return_ang else [])
    else:
        lam, ang = _project(model, Phi, frames, contact_arm_w)
        out = [lam] + ([ang] if return_ang else [])
    if return_base:
        out.append(phi0_w)
    return out[0] if len(out) == 1 else tuple(out)


def joint_limit_torque(model, q: torch.Tensor, qd: torch.Tensor,
                       k: float = 300.0, damp: float = 2.0) -> torch.Tensor:
    """Penalty torque enforcing the joint limits (PhysX limit analogue)."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=q.device)
    below = torch.clamp_max(q - f(model.dof_lower), 0.0)
    above = torch.clamp_min(q - f(model.dof_upper), 0.0)
    viol = ((below < 0) | (above > 0)).to(q.dtype)
    return -k * (below + above) - damp * qd * viol


def integrate(state: SimState, qdd: torch.Tensor, a0: torch.Tensor,
              dt: float, fixed_base: bool = False) -> SimState:
    """Semi-implicit Euler update of the full state."""
    if fixed_base:
        new_w = torch.zeros_like(state.base_ang_vel)
        new_v = torch.zeros_like(state.base_lin_vel)
        new_pos = state.base_pos
        new_quat = state.base_quat
    else:
        # base spatial accel (body coords) to world-frame classical
        # accelerations: wdot_w = R wdot_b; rdd_w = R a_lin_b + w_w x rd_w
        R0 = Q.quat_to_rotmat(state.base_quat)
        wdot_w = _mv(R0, a0[:, :3])
        acc_w = _mv(R0, a0[:, 3:]) + torch.linalg.cross(
            state.base_ang_vel, state.base_lin_vel, dim=-1)
        new_w = state.base_ang_vel + dt * wdot_w
        new_v = state.base_lin_vel + dt * acc_w
        new_pos = state.base_pos + dt * new_v
        new_quat = Q.quat_integrate(state.base_quat, new_w, dt)
    new_qd = state.qd + dt * qdd
    new_q = state.q + dt * new_qd
    return SimState(new_pos, new_quat, new_v, new_w, new_q, new_qd)
