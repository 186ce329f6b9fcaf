"""Physics step in structure-of-arrays form: the plain version of the kernel.

Port of the JAX package's ``ops/soa_physics.py``. :func:`substep_chain`
runs ``num_substeps`` substeps (FK, geom kinematics, joint torques, the
limb-ABA articulated inertias, the per-geom inverse apparent inertia, the
TGS-style contact solve, the bias sweep, the 6x6 Cholesky base acceleration
and semi-implicit Euler) as elementwise operations on [N] tensors in the
algebra of :mod:`.soa`. The CUDA kernel (``csrc/substep_chain.cuh``,
bound in :mod:`.cuda_physics`) computes the same function for one env per
thread; this module is what it is held against, and what the CPU runs.

It covers both contact models of ``SimCfg.contact_model``: "apparent"
(the TGS-style solve against the inverse apparent inertia) and "legacy"
(a penalty spring-damper per sphere with regularised Coulomb friction
against the body mass, applied at the sphere centers), with a floating
base, or with the legacy model also a fixed one (``AssetCfg.fix_base_link``:
no base acceleration, the base velocities zeroed and its pose not
integrated), on the plane z=0 or on a
terrain height grid, optionally with world boxes (the walls of the HLP
corridor, :mod:`.world`). With a grid, the height and normal under every
geom are looked up once per call at the entry state
(:func:`sample_geom_terrain`, plain gathers) and enter the chain as inputs,
as they enter the kernel. With world boxes, every substep adds the penalty
force of every sphere against every box (:func:`box_forces_soa`), and each
env's origin enters the chain as an input.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import soa as S
from .world import WorldBoxes
from .contact import (TerrainGrid, Window, square_window,
                      terrain_height_and_normal)
from .dynamics import PhysParams, SimState
from .limb_dynamics import LimbLayout, layout_for, np_spatial_inertia
from .physics import StepOutput


def _v3(a):  # [N,3] -> (x,y,z)
    return (a[:, 0], a[:, 1], a[:, 2])


def _stack_v3(v):
    return torch.stack(v, dim=-1)


def _const_v3(arr):
    return (float(arr[0]), float(arr[1]), float(arr[2]))


FIXED_BASE_APPARENT = (
    "a fixed base needs contact_model='legacy': under the apparent model the "
    "base has a zero mobility, the inverse apparent inertia of the spheres "
    "on the base and the hips is singular, and the reference (the JAX "
    "package's SoA step) returns NaN in every env")


def check_supported(model, sim_cfg, terrain=None, world_boxes=None,
                    fixed_base: bool = False) -> LimbLayout:
    """The layout of ``model``, or an error for what the step does not
    take."""
    layout = layout_for(model)
    if layout is None:
        raise NotImplementedError(
            "the physics step needs a limb-decomposable tree")
    if terrain is not None and not isinstance(terrain, TerrainGrid):
        raise TypeError(f"terrain must be a TerrainGrid, not "
                        f"{type(terrain).__name__}")
    if world_boxes is not None and not isinstance(world_boxes, WorldBoxes):
        raise TypeError(f"world_boxes must be WorldBoxes, not "
                        f"{type(world_boxes).__name__}")
    contact_model = getattr(sim_cfg, "contact_model", "apparent")
    if contact_model not in ("apparent", "legacy"):
        raise ValueError(f"unknown contact model {contact_model!r}")
    if fixed_base and contact_model == "apparent":
        raise ValueError(FIXED_BASE_APPARENT)
    return layout


def fk_geom_xy(model, layout: LimbLayout, base_pos, base_quat, q
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Positions-only FK: world (x, y) of every collision geom — where a
    terrain lookup samples heights for a control step."""
    D, K = layout.D, layout.K
    jidx = layout.joint_index
    R_b = [None] * model.nb
    p_b = [None] * model.nb
    R_b[0] = S.quat_to_m3(base_quat)
    p_b[0] = base_pos
    for d in range(D):
        for k in range(K):
            b = int(layout.body_index[d, k])
            par = int(model.parent[b])
            j = int(jidx[d, k])
            Rj = S.m3_axis_angle(_const_v3(model.axis[j]), q[j])
            Rpc = S.m3_mul(S.m3_from_array(model.E_tree[j]), Rj)
            R_b[b] = S.m3_mul(R_b[par], Rpc)
            p_b[b] = S.v3_add(S.m3_vec(R_b[par], _const_v3(model.p_tree[j])),
                              p_b[par])
    out = []
    for g in range(model.ng):
        b = int(model.geom_body[g])
        off = _const_v3(model.geom_offset[g])
        pg = S.v3_add(S.m3_vec(R_b[b], off), p_b[b])
        out.append((pg[0], pg[1]))
    return out


def box_forces_soa(world_boxes: WorldBoxes, origin, pg, vg, radius: float,
                   m_eff: float, sim_cfg, friction: float, dt: float):
    """World-box penalty force on one sphere (v3 of [N] tensors), summed
    over the boxes: the JAX package's ``_box_forces_soa``, operation for
    operation. ``origin``, ``pg`` and ``vg`` are v3 tuples (env origin,
    sphere center and velocity); ``m_eff`` is the mass of the geom's body.
    A sphere whose center lies inside a box is pushed out through the
    nearest face (the first axis of least distance, by a ``<=`` chain)."""
    centers = world_boxes.centers.detach().cpu().double().numpy()
    halfs = world_boxes.half_extents.detach().cpu().double().numpy()
    stiffness = sim_cfg.contact_stiffness
    c_n = sim_cfg.contact_damping + stiffness * dt
    # the two divisors as float32 tensors on the device: PyTorch divides
    # a CUDA tensor by a python float as a product with its reciprocal,
    # one rounding off the true quotient that JAX and the kernel take
    den_n = pg[0].new_tensor(1.0 + c_n * dt / m_eff)
    m_eff_t = pg[0].new_tensor(m_eff)
    total = None
    for i in range(centers.shape[0]):
        h = [float(halfs[i, a]) for a in range(3)]
        rel = tuple(pg[a] - (origin[a] + float(centers[i, a]))
                    for a in range(3))
        cl = tuple(S.clip(rel[a], -h[a], h[a]) for a in range(3))
        delta = tuple(rel[a] - cl[a] for a in range(3))
        dist = S.v3_norm(delta, 1e-18)
        inside = dist < 1e-6
        fd = tuple(h[a] - torch.abs(rel[a]) for a in range(3))
        min_fd = S.minimum(fd[0], S.minimum(fd[1], fd[2]))
        a0 = (fd[0] <= fd[1]) & (fd[0] <= fd[2])
        a1 = ~a0 & (fd[1] <= fd[2])
        a2 = ~a0 & ~a1
        face_n = (torch.sign(rel[0]) * a0, torch.sign(rel[1]) * a1,
                  torch.sign(rel[2]) * a2)
        inv_d = 1.0 / S.maximum(dist, 1e-6)
        n = tuple(torch.where(inside, face_n[a], delta[a] * inv_d)
                  for a in range(3))
        depth = (S.maximum(radius - dist, 0.0) * ~inside
                 + (min_fd + radius) * inside)
        in_c = depth > 0.0
        v_n = S.v3_dot(vg, n)
        v_t = S.v3_sub(vg, S.v3_scale(n, v_n))
        f_n = S.maximum((stiffness * depth - c_n * v_n) / den_n,
                        0.0) * in_c
        vt_norm = S.v3_norm(v_t, 1e-18)
        c_t = friction * f_n / (vt_norm + sim_cfg.friction_vel_eps)
        ft_scale = -(c_t / (1.0 + c_t * dt / m_eff_t))
        f = S.v3_add(S.v3_scale(n, f_n), S.v3_scale(v_t, ft_scale))
        total = f if total is None else S.v3_add(total, f)
    return total


def legacy_contact_force(pg, vg, h, n, radius: float, m_eff: float, zeta,
                         mu, sim_cfg, dt: float):
    """Legacy penalty contact of one sphere against the ground (v3 of [N]
    tensors): the JAX package's ``legacy_contact_force``, operation for
    operation. A spring-damper along the ground normal ``n`` (damping
    scaled by the per-env ``zeta``) and regularised Coulomb friction, each
    solved implicitly against ``m_eff``, the mass of the geom's body."""
    # the divisor as a float32 tensor on the device (see box_forces_soa)
    m_eff_t = pg[0].new_tensor(m_eff)
    depth = S.maximum(h + radius - pg[2], 0.0)
    in_c = depth > 0.0
    v_n = S.v3_dot(vg, n)
    v_t = S.v3_sub(vg, S.v3_scale(n, v_n))
    c_n = zeta * sim_cfg.contact_damping + sim_cfg.contact_stiffness * dt
    f_n = S.maximum((sim_cfg.contact_stiffness * depth - c_n * v_n)
                    / (1.0 + c_n * dt / m_eff_t), 0.0) * in_c
    vt_norm = S.v3_norm(v_t, 1e-12)
    c_t = mu * f_n / (vt_norm + sim_cfg.friction_vel_eps)
    ft_scale = -(c_t / (1.0 + c_t * dt / m_eff_t))
    return S.v3_add(S.v3_scale(n, f_n), S.v3_scale(v_t, ft_scale))


def substep_chain(model, sim_cfg, layout: LimbLayout, comps: Dict,
                  world_boxes: Optional[WorldBoxes] = None,
                  world_friction: float = 1.0,
                  fixed_base: bool = False) -> Dict:
    """``num_substeps`` physics substeps as one elementwise chain.

    ``comps`` holds same-shaped [N] tensors:

    - ``base_pos``/``base_v``/``base_w``: v3 tuples; ``base_quat``: 4-tuple
    - ``q``/``qd``/``tau``: lists of nv tensors
    - ``payload``, ``restitution``, ``mu``: tensors; ``com_disp``: v3 tuple
    - ``imp``: list of nv tensors (implicit-PD impedance Kd+dt*Kp) or None
    - ``g_h``/``g_n``: optional per-geom terrain height (list of ng
      tensors) and unit normal (list of ng v3 tuples); without them the
      ground is the plane z=0
    - ``origin``: v3 of the env origins, with ``world_boxes``

    ``sim_cfg.contact_model`` picks the ground contact ("apparent" or
    "legacy"); ``fixed_base`` pins the base. Returns the updated state
    components plus ``report`` (list of nr v3, world contact force per
    report body at substep 0) and ``geom_pos`` (list of ng v3, world geom
    centers at substep 0).
    """
    D, K = layout.D, layout.K
    nsub = max(int(sim_cfg.num_substeps), 1)
    dt = sim_cfg.dt / nsub
    gz = float(sim_cfg.gravity[2])

    jidx = layout.joint_index            # [D,K]
    E_tree = [[S.m3_from_array(model.E_tree[jidx[d, k]]) for k in range(K)]
              for d in range(D)]
    p_tree = [[_const_v3(model.p_tree[jidx[d, k]]) for k in range(K)]
              for d in range(D)]
    axis_c = [[_const_v3(model.axis[jidx[d, k]]) for k in range(K)]
              for d in range(D)]
    geoms_of_body = [[] for _ in range(model.nb)]
    for g in range(model.ng):
        geoms_of_body[int(model.geom_body[g])].append(g)

    base_pos = comps["base_pos"]
    base_quat = comps["base_quat"]
    base_v = comps["base_v"]
    base_w = comps["base_w"]
    q = list(comps["q"])
    qd = list(comps["qd"])
    tau = comps["tau"]
    imp = comps.get("imp")
    payload = comps["payload"]
    com_disp = comps["com_disp"]
    restitution = comps["restitution"]
    mu = comps["mu"]
    g_h_in = comps.get("g_h")
    g_n_in = comps.get("g_n")

    report0 = None
    geom_pos_out = None
    lam_w = None          # per-geom world 3x3 inverse apparent inertia
    phi_w = None

    lim_lo = [float(x) for x in model.dof_lower]
    lim_hi = [float(x) for x in model.dof_upper]
    vel_lim = [float(x) for x in model.dof_velocity]

    apparent = getattr(sim_cfg, "contact_model", "apparent") == "apparent"
    # Jacobi mass split of the base between the limbs that can load it
    # simultaneously
    base_split = float(max(int(np.sum(np.asarray(model.parent) == 0)), 1))
    zeta = S.clip(1.0 - restitution, 0.08, 1.0)   # legacy damping scale

    for sub in range(nsub):
        # ---- FK (world frames per body, SoA) ---------------------------
        R0 = S.quat_to_m3(base_quat)
        R_b = [None] * model.nb
        p_b = [None] * model.nb
        w_b = [None] * model.nb
        v_b = [None] * model.nb
        R_b[0], p_b[0], w_b[0], v_b[0] = R0, base_pos, base_w, base_v
        R_pc = [[None] * K for _ in range(D)]
        for d in range(D):
            for k in range(K):
                b = int(layout.body_index[d, k])
                par = int(model.parent[b])
                j = int(jidx[d, k])
                Rj = S.m3_axis_angle(axis_c[d][k], q[j])
                Rpc = S.m3_mul(E_tree[d][k], Rj)
                R_pc[d][k] = Rpc
                R_b[b] = S.m3_mul(R_b[par], Rpc)
                p_b[b] = S.v3_add(S.m3_vec(R_b[par], p_tree[d][k]), p_b[par])
                w_b[b] = S.v3_add(
                    w_b[par],
                    S.m3_vec(R_b[b], S.v3_scale(axis_c[d][k], qd[j])))
                v_b[b] = S.v3_add(
                    v_b[par],
                    S.v3_cross(w_b[par], S.v3_sub(p_b[b], p_b[par])))

        # ---- geom world kinematics; terrain inputs or the plane z=0 -------
        g_pos = [None] * model.ng
        g_vel = [None] * model.ng
        g_h = [None] * model.ng
        g_n = [None] * model.ng
        for g in range(model.ng):
            b = int(model.geom_body[g])
            off = _const_v3(model.geom_offset[g])
            pg = S.v3_add(S.m3_vec(R_b[b], off), p_b[b])
            vg = S.v3_add(v_b[b],
                          S.v3_cross(w_b[b], S.v3_sub(pg, p_b[b])))
            g_pos[g] = pg
            g_vel[g] = vg
            if g_h_in is not None:
                g_h[g] = g_h_in[g]
                g_n[g] = g_n_in[g]
            else:
                g_h[g] = pg[2] * 0.0
                g_n[g] = (pg[2] * 0.0, pg[2] * 0.0, pg[2] * 0.0 + 1.0)

        def gather_f_ext(g_force, g_app, g_torque):
            """world sphere forces applied at g_app[g] plus pure torques ->
            per-body spatial force (own frame)."""
            f_ext = [None] * model.nb
            for b in range(model.nb):
                if not geoms_of_body[b]:
                    continue
                Fw = None
                Nw = None
                for g in geoms_of_body[b]:
                    arm = S.v3_sub(g_app[g], p_b[b])
                    tq = S.v3_cross(arm, g_force[g])
                    if g_torque[g] is not None:
                        tq = S.v3_add(tq, g_torque[g])
                    Fw = (g_force[g] if Fw is None
                          else S.v3_add(Fw, g_force[g]))
                    Nw = tq if Nw is None else S.v3_add(Nw, tq)
                f_ext[b] = (S.m3_tvec(R_b[b], Nw), S.m3_tvec(R_b[b], Fw))
            return f_ext

        # ---- total joint torques (PD input + passive) -------------------
        tau_t = [None] * model.nv
        for j in range(model.nv):
            below = S.minimum(q[j] - lim_lo[j], 0.0)
            above = S.maximum(q[j] - lim_hi[j], 0.0)
            viol = ((q[j] < lim_lo[j]) | (q[j] > lim_hi[j]))
            t = (tau[j]
                 - float(model.dof_damping[j]) * qd[j]
                 - sim_cfg.joint_friction * torch.tanh(qd[j] / 0.1)
                 - 300.0 * (below + above) - 2.0 * qd[j] * viol)
            tau_t[j] = t

        # ---- ABA (limb form, SoA) ---------------------------------------
        base_mass = float(model.mass[0]) + payload
        com0 = _const_v3(model.com[0])
        base_com = (com_disp[0] + com0[0],
                    com_disp[1] + com0[1],
                    com_disp[2] + com0[2])
        scale = base_mass / float(model.mass[0])
        I0 = S.m3_from_array(np.asarray(model.inertia[0]))
        I0s = tuple(tuple(I0[i][j] * scale for j in range(3))
                    for i in range(3))
        IA = [None] * model.nb
        IA[0] = S.spatial_inertia(base_mass, base_com, I0s)
        for d in range(D):
            for k in range(K):
                b = int(layout.body_index[d, k])
                M6 = np_spatial_inertia(float(model.mass[b]),
                                        np.asarray(model.com[b]),
                                        np.asarray(model.inertia[b]))
                IA[b] = tuple(tuple(S.m3_from_array(M6[i * 3:i * 3 + 3,
                                                       j * 3:j * 3 + 3])
                                    for j in range(2)) for i in range(2))

        # velocities in body coords + bias
        v0 = (S.m3_tvec(R0, base_w), S.m3_tvec(R0, base_v))
        v_sp = [None] * model.nb
        c_sp = [None] * model.nb
        E_up = [None] * model.nb
        v_sp[0] = v0
        for d in range(D):
            for k in range(K):
                b = int(layout.body_index[d, k])
                par = int(model.parent[b])
                j = int(jidx[d, k])
                E = S.m3_t(R_pc[d][k])
                E_up[b] = E
                Sqd = (S.v3_scale(axis_c[d][k], qd[j]),
                       S.v3_zeros_like(qd[j]))
                vi = S.sv_add(S.xform_motion(E, p_tree[d][k], v_sp[par]), Sqd)
                v_sp[b] = vi
                c_sp[b] = S.crm(vi, Sqd)

        # velocity bias per body (no external forces yet)
        pA_vel = [None] * model.nb
        for b in range(model.nb):
            pA_vel[b] = S.crf(v_sp[b], S.sm_vec(IA[b], v_sp[b]))

        # backward articulated-inertia sweep (force-independent): U, d, Ia
        U = [None] * model.nb
        dinv = [None] * model.nb
        Ia_s = [None] * model.nb
        for d in range(D - 1, -1, -1):
            for k in range(K):
                b = int(layout.body_index[d, k])
                par = int(model.parent[b])
                j = int(jidx[d, k])
                Si = (axis_c[d][k], (0.0, 0.0, 0.0))
                Ub = S.sm_vec(IA[b], Si)
                db = S.maximum(
                    S.sv_dot(Si, Ub) + float(model.dof_armature[j])
                    + (dt * imp[j] if imp is not None else 0.0), 1e-9)
                U[b], dinv[b] = Ub, 1.0 / db
                Ia = S.sm_add(IA[b],
                              S.sm_scale(S.sm_outer(Ub, Ub), -1.0 / db))
                Ia_s[b] = Ia
                IA[par] = S.sm_add(
                    IA[par],
                    S.xform_inertia_to_parent(E_up[b], p_tree[d][k], Ia))

        g_b = S.m3_tvec(R0, (base_pos[0] * 0.0, base_pos[0] * 0.0,
                             base_pos[0] * 0.0 + gz))

        def bias_and_accels(f_ext):
            """Bias backward sweep + base accel + forward sweep for a given
            external-force set (the inertia sweep above is shared)."""
            pA = [None] * model.nb
            for b in range(model.nb):
                pA[b] = (pA_vel[b] if f_ext is None or f_ext[b] is None
                         else S.sv_sub(pA_vel[b], f_ext[b]))
            u = [None] * model.nb
            for d in range(D - 1, -1, -1):
                for k in range(K):
                    b = int(layout.body_index[d, k])
                    par = int(model.parent[b])
                    j = int(jidx[d, k])
                    Si = (axis_c[d][k], (0.0, 0.0, 0.0))
                    ub = tau_t[j] - S.sv_dot(Si, pA[b])
                    u[b] = ub
                    pa = S.sv_add(
                        S.sv_add(pA[b], S.sm_vec(Ia_s[b], c_sp[b])),
                        S.sv_scale(U[b], ub * dinv[b]))
                    pA[par] = S.sv_add(
                        pA[par],
                        S.xform_force_to_parent(E_up[b], p_tree[d][k], pa))
            if fixed_base:
                a0 = (S.v3_zeros_like(base_pos[0]), S.v3_scale(g_b, -1.0))
            else:
                sol = S.solve_psd6(IA[0], pA[0])
                a0 = (S.v3_scale(sol[0], -1.0), S.v3_scale(sol[1], -1.0))
            a_sp = [None] * model.nb
            a_sp[0] = a0
            qdd = [None] * model.nv
            for d in range(D):
                for k in range(K):
                    b = int(layout.body_index[d, k])
                    par = int(model.parent[b])
                    j = int(jidx[d, k])
                    ap = S.sv_add(
                        S.xform_motion(E_up[b], p_tree[d][k], a_sp[par]),
                        c_sp[b])
                    qdd[j] = (u[b] - S.sv_dot(U[b], ap)) * dinv[b]
                    Si = (axis_c[d][k], (0.0, 0.0, 0.0))
                    a_sp[b] = S.sv_add(ap, S.sv_scale(Si, qdd[j]))
            return a0, a_sp, qdd

        if apparent:
            # ---- inverse apparent inertia per geom (once per call: q drift
            # within one control step is negligible) --------------------------
            if lam_w is None:
                Phi = [None] * model.nb
                Phi[0] = S.sm_scale(S.inv_psd6(IA[0]), base_split)
                for d in range(D):
                    for k in range(K):
                        b = int(layout.body_index[d, k])
                        par = int(model.parent[b])
                        Si = (axis_c[d][k], (0.0, 0.0, 0.0))
                        Phi_x = S.xform_phi_to_child(
                            E_up[b], p_tree[d][k], Phi[par])
                        MU = S.sm_vec(Phi_x, U[b])
                        uMu = S.sv_dot(U[b], MU)
                        Phi_b = S.sm_add(
                            Phi_x,
                            S.sm_scale(S.sm_outer(Si, MU), -dinv[b]))
                        Phi_b = S.sm_add(
                            Phi_b,
                            S.sm_scale(S.sm_outer(MU, Si), -dinv[b]))
                        Phi_b = S.sm_add(
                            Phi_b,
                            S.sm_scale(S.sm_outer(Si, Si),
                                       dinv[b] + uMu * dinv[b] * dinv[b]))
                        Phi[b] = Phi_b
                # world-frame Phi blocks per body (projected per geom with the
                # dynamic contact-point arm below)
                phi_w = [None] * model.nb
                for b in set(int(model.geom_body[g]) for g in range(model.ng)):
                    (A_, B_), (C_, D_) = Phi[b]
                    Rt = S.m3_t(R_b[b])
                    phi_w[b] = (
                        S.m3_mul(S.m3_mul(R_b[b], A_), Rt),
                        S.m3_mul(S.m3_mul(R_b[b], B_), Rt),
                        S.m3_mul(S.m3_mul(R_b[b], D_), Rt))
                lam_w = [None] * model.ng

            # ---- free dynamics -> per-geom free point acceleration ----------
            _, a_free, _ = bias_and_accels(None)
            # per-body active-contact counts for Jacobi mass splitting
            g_in_c = [None] * model.ng
            for g in range(model.ng):
                rad_g = float(model.geom_radius[g])
                g_in_c[g] = (g_h[g] + rad_g - g_pos[g][2] > 0.0
                             ).to(g_pos[g][2].dtype)
            n_active = [None] * model.nb
            for b in range(model.nb):
                tot = None
                for g in geoms_of_body[b]:
                    tot = g_in_c[g] if tot is None else tot + g_in_c[g]
                n_active[b] = tot
            g_force = [None] * model.ng
            g_cp = [None] * model.ng
            g_tq = [None] * model.ng
            a_patch = float(getattr(sim_cfg, "torsional_patch_radius", 0.0))
            for g in range(model.ng):
                b = int(model.geom_body[g])
                pg, n = g_pos[g], g_n[g]
                rad = float(model.geom_radius[g])
                # contact point on the sphere surface
                p_c = S.v3_sub(pg, S.v3_scale(n, rad))
                g_cp[g] = p_c
                r_w = S.v3_sub(p_c, p_b[b])
                v_c = S.v3_add(g_vel[g],
                               S.v3_cross(w_b[b], S.v3_sub(p_c, pg)))

                if lam_w[g] is None:
                    A_w, B_w, D_w = phi_w[b]
                    Sm = S.m3_scale(S.m3_skew(r_w), -1.0)
                    Smt = S.m3_t(Sm)
                    SmB = S.m3_mul(Sm, B_w)
                    lam_w[g] = S.m3_add(
                        S.m3_add(S.m3_mul(S.m3_mul(Sm, A_w), Smt),
                                 S.m3_add(SmB, S.m3_t(SmB))), D_w)

                a_ang, a_lin = a_free[b]
                a_lin_true = S.v3_add(a_lin, S.m3_tvec(R_b[b], (
                    base_pos[0] * 0.0, base_pos[0] * 0.0,
                    base_pos[0] * 0.0 + gz)))
                wdot_w = S.m3_vec(R_b[b], a_ang)
                a_org_w = S.v3_add(S.m3_vec(R_b[b], a_lin_true),
                                   S.v3_cross(w_b[b], v_b[b]))
                a_pt = S.v3_add(
                    S.v3_add(a_org_w, S.v3_cross(wdot_w, r_w)),
                    S.v3_cross(w_b[b], S.v3_cross(w_b[b], r_w)))

                # TGS-style velocity constraint solve against lam_w[g]
                depth = S.maximum(g_h[g] + rad - pg[2], 0.0)
                in_c = g_in_c[g]
                v_pred = S.v3_add(v_c, S.v3_scale(a_pt, dt))
                v_n_now = S.v3_dot(v_c, n)
                bias = S.minimum(sim_cfg.erp / dt * depth,
                                 sim_cfg.max_depenetration_velocity)
                bounce = torch.where(
                    v_n_now < -sim_cfg.bounce_threshold_velocity,
                    -restitution * v_n_now, 0.0)
                v_tgt_n = S.maximum(bias, bounce)
                dv = S.v3_sub(S.v3_scale(n, v_tgt_n), v_pred)
                split = S.maximum(n_active[b], 1.0)
                lam_g = S.m3_scale(lam_w[g], split)
                f = S.m3_solve(lam_g, S.v3_scale(dv, 1.0 / dt))
                f_n = S.v3_dot(f, n)
                f_t = S.v3_sub(f, S.v3_scale(n, f_n))
                f_n = S.maximum(f_n, 0.0) * in_c
                ft_norm = S.v3_norm(f_t, 1e-18)
                scale = S.minimum(1.0, mu * f_n / (ft_norm + 1e-9)) * in_c
                g_force[g] = S.v3_add(S.v3_scale(n, f_n),
                                      S.v3_scale(f_t, scale))

                # torsional friction: spin-stiction about the normal against
                # the apparent angular inertia, clamped to the torsion cone
                # mu * f_n * patch_radius
                if a_patch > 0.0:
                    A_w = phi_w[b][0]
                    w_n = S.v3_dot(w_b[b], n)
                    r_ang = S.maximum(
                        S.v3_dot(n, S.m3_vec(A_w, n)) * split, 1e-6)
                    tau_max = mu * f_n * a_patch
                    tau_n = S.clip(-w_n / (dt * r_ang), -tau_max, tau_max)
                    g_tq[g] = S.v3_scale(n, tau_n)

        else:
            # the penalty forces act at the sphere centers, with no torsion
            g_cp, g_tq = g_pos, [None] * model.ng
            g_force = [legacy_contact_force(
                g_pos[g], g_vel[g], g_h[g], g_n[g],
                float(model.geom_radius[g]),
                float(model.mass[int(model.geom_body[g])]), zeta, mu,
                sim_cfg, dt) for g in range(model.ng)]

        f_ext = gather_f_ext(g_force, g_cp, g_tq)

        # ---- world boxes: penalty forces on the same spheres, applied at
        # the sphere centers, added after the ground contact ---------------
        g_wf = None
        if world_boxes is not None:
            origin = comps["origin"]
            g_wf = [box_forces_soa(
                world_boxes, origin, g_pos[g], g_vel[g],
                float(model.geom_radius[g]),
                float(model.mass[int(model.geom_body[g])]), sim_cfg,
                world_friction, dt) for g in range(model.ng)]
            w_ext = gather_f_ext(g_wf, g_pos, [None] * model.ng)
            for b in range(model.nb):
                if w_ext[b] is not None:
                    f_ext[b] = (w_ext[b] if f_ext[b] is None
                                else S.sv_add(f_ext[b], w_ext[b]))

        if sub == 0:
            # contact report per report body (world frame), walls included
            rep = [None] * model.nr
            for g in range(model.ng):
                rb = int(model.geom_report_body[g])
                f_tot = (g_force[g] if g_wf is None
                         else S.v3_add(g_force[g], g_wf[g]))
                rep[rb] = (f_tot if rep[rb] is None
                           else S.v3_add(rep[rb], f_tot))
            zeros = base_pos[0] * 0.0
            report0 = [r_ if r_ is not None else (zeros, zeros, zeros)
                       for r_ in rep]
            geom_pos_out = list(g_pos)

        a0, _, qdd = bias_and_accels(f_ext)
        a_true0 = (a0[0], S.v3_add(a0[1], g_b))

        # ---- integrate (semi-implicit, SoA) -----------------------------
        if fixed_base:
            base_w = S.v3_zeros_like(base_pos[0])
            base_v = S.v3_zeros_like(base_pos[0])
        else:
            wdot_w = S.m3_vec(R0, a_true0[0])
            acc_w = S.v3_add(S.m3_vec(R0, a_true0[1]),
                             S.v3_cross(base_w, base_v))
            base_w = S.v3_add(base_w, S.v3_scale(wdot_w, dt))
            base_v = S.v3_add(base_v, S.v3_scale(acc_w, dt))
            base_pos = S.v3_add(base_pos, S.v3_scale(base_v, dt))
            base_quat = S.quat_integrate(base_quat, base_w, dt)
        for j in range(model.nv):
            qd[j] = S.clip(qd[j] + dt * qdd[j], -vel_lim[j], vel_lim[j])
            q[j] = q[j] + dt * qd[j]

    return dict(base_pos=base_pos, base_quat=base_quat, base_v=base_v,
                base_w=base_w, q=q, qd=qd,
                report=report0, geom_pos=geom_pos_out)


def sample_geom_terrain(model, layout: LimbLayout, sim_cfg,
                        terrain: TerrainGrid, base_pos, base_quat, q,
                        window: Optional[Window] = None):
    """Terrain height [N, ng] and unit normal [N, ng, 3] under every geom
    at the given state (SoA components, as :func:`fk_geom_xy` takes them).

    The lookup reads the same cells as the JAX package's
    ``_sample_geom_terrain``: inside the hoisted per-step ``window`` when
    the caller passes one, else inside the square
    ``sim_cfg.terrain_patch_size`` window around the base (a per-call
    patch in the JAX package), else (size 0) anywhere on the grid."""
    xy = fk_geom_xy(model, layout, base_pos, base_quat, q)
    xs = torch.stack([x for x, _ in xy], dim=-1)          # [N, ng]
    ys = torch.stack([y for _, y in xy], dim=-1)
    window = lookup_window(sim_cfg, terrain, base_pos[0], base_pos[1],
                           window)
    return terrain_height_and_normal(terrain, xs, ys, window)


def lookup_window(sim_cfg, terrain: TerrainGrid, base_x, base_y,
                  window: Optional[Window] = None) -> Optional[Window]:
    """The window that a physics call's terrain lookup reads through: the
    caller's hoisted ``window``, else the square
    ``sim_cfg.terrain_patch_size`` window around the base; none (the whole
    grid) when that size is 0, whatever the caller passes."""
    P = int(getattr(sim_cfg, "terrain_patch_size", 0) or 0)
    if P <= 0:
        return None
    if window is None:
        window = square_window(terrain, base_x, base_y, P)
    return window


def static_friction(terrain: Optional[TerrainGrid]) -> float:
    """The ground's static friction: the grid's, 1.0 on the plane."""
    return terrain.static_friction if terrain is not None else 1.0


def physics_step_soa(
    model,
    sim_cfg,
    state: SimState,               # batched [N,...]
    tau: torch.Tensor,             # [N,nv]
    params: PhysParams,            # batched
    terrain: Optional[TerrainGrid] = None,
    fixed_base: bool = False,
    implicit_damp: Optional[torch.Tensor] = None,   # [N,nv] Kd_eff+dt*Kp_eff
    world_boxes: Optional[WorldBoxes] = None,
    env_origin: Optional[torch.Tensor] = None,     # [N,3] for world_boxes
    world_friction: float = 1.0,
    terrain_window: Optional[Window] = None,
) -> StepOutput:
    """One control-step physics call (``num_substeps`` substeps) for a
    batch of envs, in plain PyTorch on any device. ``terrain_window`` is
    the env's hoisted per-step window (see :func:`sample_geom_terrain`);
    ``world_boxes`` are placed at each env's ``env_origin`` and collide
    with the spheres at ``world_friction``."""
    layout = check_supported(model, sim_cfg, terrain, world_boxes,
                             fixed_base)
    base_pos = _v3(state.base_pos)
    base_quat = tuple(state.base_quat[:, i] for i in range(4))
    q = [state.q[:, j] for j in range(model.nv)]
    comps = dict(
        base_pos=base_pos,
        base_quat=base_quat,
        base_v=_v3(state.base_lin_vel),
        base_w=_v3(state.base_ang_vel),
        q=q,
        qd=[state.qd[:, j] for j in range(model.nv)],
        tau=[tau[:, j] for j in range(model.nv)],
        imp=(None if implicit_damp is None
             else [implicit_damp[:, j] for j in range(model.nv)]),
        payload=params.payload,
        com_disp=_v3(params.com_displacement),
        restitution=params.restitution,
        mu=0.5 * (params.friction + static_friction(terrain)),
    )
    if terrain is not None:
        hh, nn = sample_geom_terrain(model, layout, sim_cfg, terrain,
                                     base_pos, base_quat, q, terrain_window)
        comps["g_h"] = [hh[:, g] for g in range(model.ng)]
        comps["g_n"] = [(nn[:, g, 0], nn[:, g, 1], nn[:, g, 2])
                        for g in range(model.ng)]
    if world_boxes is not None:
        comps["origin"] = _v3(env_origin)
    out = substep_chain(model, sim_cfg, layout, comps, world_boxes,
                        world_friction, fixed_base)

    new_state = SimState(
        base_pos=_stack_v3(out["base_pos"]),
        base_quat=torch.stack(out["base_quat"], dim=-1),
        base_lin_vel=_stack_v3(out["base_v"]),
        base_ang_vel=_stack_v3(out["base_w"]),
        q=torch.stack(out["q"], dim=-1),
        qd=torch.stack(out["qd"], dim=-1))
    report0 = torch.stack([_stack_v3(r_) for r_ in out["report"]], dim=1)
    geom_pos_out = torch.stack([_stack_v3(p) for p in out["geom_pos"]], dim=1)
    return StepOutput(new_state, report0, geom_pos_out)
