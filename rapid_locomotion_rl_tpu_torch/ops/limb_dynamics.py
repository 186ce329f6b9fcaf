"""Limb layout of a quadruped-class tree (host-side NumPy).

A base plus K isomorphic chains of depth D: :func:`detect_limbs` finds the
(D levels x K limbs) layout from a :class:`RobotModel`, and the physics step
(:mod:`.soa_physics`, the CUDA kernel) walks bodies in that order.
:func:`fk_limb` and :func:`aba_limb` are the JAX package's limb-batched
FK and ABA, every per-body operation a per-level operation over [N, K, ...]
tensors; the general step (:mod:`.physics`) runs them for the legacy
contact model when ``SimCfg.use_limb_batching`` is on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import quat as Q
from . import spatial as S
from .dynamics import BodyFrames, SimState, _axis_rotmat


@dataclass(frozen=True)
class LimbLayout:
    """K chains of depth D hanging off the base."""
    K: int
    D: int
    body_index: np.ndarray   # [D,K] dynamics body index of (level, limb)

    @property
    def joint_index(self) -> np.ndarray:
        return self.body_index - 1   # joint j connects body j+1


def detect_limbs(model) -> Optional[LimbLayout]:
    """Partition bodies 1..nb-1 into equal-depth single-child chains."""
    children: List[List[int]] = [[] for _ in range(model.nb)]
    for i in range(1, model.nb):
        children[int(model.parent[i])].append(i)
    roots = children[0]
    if not roots:
        return None
    chains = []
    for r in roots:
        chain = [r]
        cur = r
        while True:
            cs = children[cur]
            if len(cs) == 0:
                break
            if len(cs) != 1:
                return None
            cur = cs[0]
            chain.append(cur)
        chains.append(chain)
    depth = len(chains[0])
    if any(len(c) != depth for c in chains):
        return None
    if len(chains) * depth != model.nb - 1:
        return None
    body_index = np.asarray(chains, dtype=np.int32).T   # [D,K]
    return LimbLayout(K=len(chains), D=depth, body_index=body_index)


def np_spatial_inertia(mass: float, com: np.ndarray,
                       inertia: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia about the body origin, in float64."""
    c = np.array([[0, -com[2], com[1]],
                  [com[2], 0, -com[0]],
                  [-com[1], com[0], 0]])
    out = np.zeros((6, 6))
    out[:3, :3] = inertia + mass * (c @ c.T)
    out[:3, 3:] = mass * c
    out[3:, :3] = mass * c.T
    out[3:, 3:] = mass * np.eye(3)
    return out


def layout_for(model) -> Optional[LimbLayout]:
    """Limb layout of a model, or None when the tree does not decompose."""
    return detect_limbs(model)


class _Packed(NamedTuple):
    """Per-level packed model constants."""
    E_tree: torch.Tensor     # [D,K,3,3]
    p_tree: torch.Tensor     # [D,K,3]
    axis: torch.Tensor       # [D,K,3]
    armature: torch.Tensor   # [D,K]
    damping: torch.Tensor    # [D,K]
    inertia6: torch.Tensor   # [D,K,6,6] spatial inertias
    jidx: np.ndarray         # [D,K] joint index (static)


def _pack(model, layout: LimbLayout, device="cpu") -> _Packed:
    j = layout.joint_index
    I6 = np.zeros((layout.D, layout.K, 6, 6))
    for d in range(layout.D):
        for k in range(layout.K):
            b = int(layout.body_index[d, k])
            I6[d, k] = np_spatial_inertia(
                float(model.mass[b]), np.asarray(model.com[b]),
                np.asarray(model.inertia[b]))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    return _Packed(
        E_tree=f(model.E_tree[j]), p_tree=f(model.p_tree[j]),
        axis=f(model.axis[j]), armature=f(model.dof_armature[j]),
        damping=f(model.dof_damping[j]), inertia6=f(I6), jidx=j)


def fk_limb(model, layout: LimbLayout, state: SimState) -> BodyFrames:
    """Forward kinematics with the limb axis batched; frames [N,nb,...] in
    the model's body order."""
    pk = _pack(model, layout, state.q.device)
    K = layout.K
    R0 = Q.quat_to_rotmat(state.base_quat)
    q_l = state.q[:, pk.jidx]                 # [N,D,K]
    qd_l = state.qd[:, pk.jidx]
    R_par = R0[:, None].expand(-1, K, 3, 3)
    p_par = state.base_pos[:, None].expand(-1, K, 3)
    w_par = state.base_ang_vel[:, None].expand(-1, K, 3)
    v_par = state.base_lin_vel[:, None].expand(-1, K, 3)
    R_all = [R0] + [None] * (model.nb - 1)
    p_all = [state.base_pos] + [None] * (model.nb - 1)
    w_all = [state.base_ang_vel] + [None] * (model.nb - 1)
    v_all = [state.base_lin_vel] + [None] * (model.nb - 1)
    for d in range(layout.D):
        R_pc = pk.E_tree[d] @ _axis_rotmat(pk.axis[d], q_l[:, d])
        R_w = R_par @ R_pc
        p_w = S._mv(R_par, pk.p_tree[d]) + p_par
        w_w = w_par + S._mv(R_w, pk.axis[d] * qd_l[:, d, :, None])
        v_w = v_par + S.cross(w_par, p_w - p_par)
        for k in range(K):
            b = int(layout.body_index[d, k])
            R_all[b], p_all[b] = R_w[:, k], p_w[:, k]
            w_all[b], v_all[b] = w_w[:, k], v_w[:, k]
        R_par, p_par, w_par, v_par = R_w, p_w, w_w, v_w
    return BodyFrames(torch.stack(R_all, 1), torch.stack(p_all, 1),
                      torch.stack(w_all, 1), torch.stack(v_all, 1))


def aba_limb(model, layout: LimbLayout, state: SimState, tau: torch.Tensor,
             f_ext_body: Optional[torch.Tensor], gravity: torch.Tensor,
             payload: torch.Tensor, com_offset: torch.Tensor,
             fixed_base: bool = False,
             joint_impedance: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Limb-batched ABA; the contract of :func:`.dynamics.aba` (without
    body accelerations)."""
    dev = state.q.device
    pk = _pack(model, layout, dev)
    D, K = layout.D, layout.K
    n = state.q.shape[0]
    q_l = state.q[:, pk.jidx]
    qd_l = state.qd[:, pk.jidx]
    tau_l = tau[:, pk.jidx]
    imp_l = None if joint_impedance is None else joint_impedance[:, pk.jidx]

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    mass0 = f(model.mass[0])
    base_mass = mass0 + payload
    base_com = com_offset + f(model.com[0])
    base_inertia = f(model.inertia[0]) * (base_mass / mass0)[:, None, None]
    IA_base = S.spatial_inertia(base_mass, base_com, base_inertia)

    R0 = Q.quat_to_rotmat(state.base_quat)
    R0t = R0.transpose(-1, -2)
    v0 = torch.cat((S._mv(R0t, state.base_ang_vel),
                    S._mv(R0t, state.base_lin_vel)), -1)

    # pass 1: velocities and bias, level by level
    Xup_E, Ss_l, v_lvl, c_lvl = [], [], [], []
    v_par = v0[:, None].expand(n, K, 6)
    zk = torch.zeros((K, 3), device=dev)
    for d in range(D):
        R_pc = pk.E_tree[d] @ _axis_rotmat(pk.axis[d], q_l[:, d])
        E = R_pc.transpose(-1, -2)                         # [N,K,3,3]
        Si = torch.cat((pk.axis[d], zk), dim=-1)           # [K,6]
        sq = Si * qd_l[:, d, :, None]
        vi = S.xform_motion(E, pk.p_tree[d], v_par) + sq
        Xup_E.append(E)
        Ss_l.append(Si)
        v_lvl.append(vi)
        c_lvl.append(S.crm(vi, sq))
        v_par = vi

    IA_lvl = [pk.inertia6[d] for d in range(D)]
    pA_lvl = []
    for d in range(D):
        bias = S.crf(v_lvl[d], S._mv(IA_lvl[d], v_lvl[d]))
        if f_ext_body is not None:
            bias = bias - f_ext_body[:, layout.body_index[d]]
        pA_lvl.append(bias)
    pA_base = S.crf(v0, S._mv(IA_base, v0))
    if f_ext_body is not None:
        pA_base = pA_base - f_ext_body[:, 0]

    # pass 2: backward
    U_l, d_l, u_l = [None] * D, [None] * D, [None] * D
    for d in range(D - 1, -1, -1):
        Si = Ss_l[d]
        U = S._mv(IA_lvl[d], Si)
        dd = torch.sum(Si * U, -1) + pk.armature[d]
        if imp_l is not None:
            dd = dd + imp_l[:, d]
        dd = torch.clamp_min(dd, 1e-9)
        uu = tau_l[:, d] - torch.sum(Si * pA_lvl[d], -1)
        U_l[d], d_l[d], u_l[d] = U, dd, uu
        Ia = IA_lvl[d] - U[..., :, None] * U[..., None, :] / dd[..., None,
                                                                 None]
        pa = (pA_lvl[d] + S._mv(Ia, c_lvl[d]) + U * (uu / dd)[..., None])
        X = S.xmat_motion(Xup_E[d], pk.p_tree[d])          # [N,K,6,6]
        XIaX = X.transpose(-1, -2) @ Ia @ X
        pa_par = S.xform_force_to_parent(Xup_E[d], pk.p_tree[d], pa)
        if d > 0:
            IA_lvl[d - 1] = IA_lvl[d - 1] + XIaX
            pA_lvl[d - 1] = pA_lvl[d - 1] + pa_par
        else:
            IA_base = IA_base + torch.sum(XIaX, dim=1)
            pA_base = pA_base + torch.sum(pa_par, dim=1)

    a_grav = torch.cat((torch.zeros_like(state.base_pos),
                        S._mv(R0t, gravity)), -1)
    if fixed_base:
        a0_rel = -a_grav
    else:
        a0_rel = -S.solve_psd6(IA_base, pA_base)

    # pass 3: forward
    qdd_l = []
    a_par = a0_rel[:, None].expand(n, K, 6)
    for d in range(D):
        ap = S.xform_motion(Xup_E[d], pk.p_tree[d], a_par) + c_lvl[d]
        qdd = (u_l[d] - torch.sum(U_l[d] * ap, -1)) / d_l[d]
        a_par = ap + Ss_l[d] * qdd[..., None]
        qdd_l.append(qdd)

    # back to joint order
    qdd_full = torch.zeros((n, model.nv), device=dev)
    qdd_full[:, torch.as_tensor(pk.jidx.reshape(-1), device=dev)] = \
        torch.stack(qdd_l, 1).reshape(n, -1)
    return qdd_full, a0_rel + a_grav
