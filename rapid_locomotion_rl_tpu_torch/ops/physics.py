"""The general (AoS) physics step: FK -> contact -> ABA -> semi-implicit
Euler, body by body over the model's tree.

Port of the JAX package's ``ops/physics.py``. The AoS step is not a
kernel: in the JAX package it is XLA code with no ``pallas_call``, and
here it is plain PyTorch on either device, its counterpart, not the plain
twin of a kernel. It takes [N, ...] tensors with the env axis first and
loops in Python over the model's static tree (where the JAX package vmaps
one robot's step over the envs), so on the card it is thousands of small
launches a call.

It serves every tree, limbless ones too (the limb-batched step and its
CUDA kernel, :mod:`.cuda_physics`, need a limb layout), both contact
models, the world-box hook and the velocity clamp. Per call the terrain
under every geom is sampled once on the full grid (no window), and the
apparent model's inverse apparent inertia is computed once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .contact import (TerrainGrid, contact_forces, contact_forces_implicit,
                      report_forces, sample_terrain,
                      spatial_forces_on_bodies)
from .dynamics import (PhysParams, SimState, aba, articulated_sweeps, fk,
                       geom_world_positions, integrate, joint_limit_torque,
                       model_consts, osim_from_sweeps, point_accels)
from .limb_dynamics import aba_limb, fk_limb, layout_for


class StepOutput(NamedTuple):
    state: SimState
    contact_report: torch.Tensor  # [N,nr,3] world net contact force per report body
    geom_pos: torch.Tensor        # [N,ng,3] world sphere centers (pre-step)


# (origin [N,3], pos [N,ng,3], vel [N,ng,3], m_eff [ng], dt) -> [N,ng,3]
ExtraContact = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, float], torch.Tensor]


def physics_step(
    model,
    sim_cfg,
    state: SimState,                 # batched [N,...]
    tau: torch.Tensor,               # [N,nv] actuation torque (limited)
    params: PhysParams,              # batched
    terrain: Optional[TerrainGrid] = None,
    fixed_base: bool = False,
    implicit_damp: Optional[torch.Tensor] = None,   # [N,nv] Kd_eff+dt*Kp_eff
    extra_contact: Optional[ExtraContact] = None,
    env_origin: Optional[torch.Tensor] = None,      # [N,3] for extra_contact
) -> StepOutput:
    """Advance the robots by ``sim_cfg.dt`` in ``sim_cfg.num_substeps``
    substeps with the torque held. ``extra_contact`` adds world-obstacle
    penalty forces on the spheres (at their centers) in every substep."""
    from .soa_physics import FIXED_BASE_APPARENT   # imports this module
    dev = state.q.device
    gravity = torch.as_tensor(np.asarray(sim_cfg.gravity, np.float32),
                              device=dev)
    nsub = max(int(sim_cfg.num_substeps), 1)
    dt = sim_cfg.dt / nsub
    contact_model = getattr(sim_cfg, "contact_model", "apparent")
    if contact_model not in ("apparent", "legacy"):
        raise ValueError(f"unknown contact model {contact_model!r}")
    if fixed_base and contact_model == "apparent":
        raise ValueError(FIXED_BASE_APPARENT)

    # the limb-batched FK/ABA for the legacy model, as the JAX package
    layout = None
    if getattr(sim_cfg, "use_limb_batching", True) \
            and contact_model != "apparent":
        layout = layout_for(model)
    if layout is not None:
        def fk_fn(m, s):
            return fk_limb(m, layout, s)

        def aba_fn(m, *a, **k):
            return aba_limb(m, layout, *a, **k)
    else:
        fk_fn, aba_fn = fk, aba

    # implicit PD: the caller passes Kd_eff + dt*Kp_eff, scaled by this
    # substep's dt into the joint-space diagonal
    joint_imp = None if implicit_damp is None else dt * implicit_damp

    c = model_consts(model, dev)
    gb = c.geom_body
    damping = torch.as_tensor(np.asarray(model.dof_damping, np.float32),
                              device=dev)
    vel_lim = torch.as_tensor(np.asarray(model.dof_velocity, np.float32),
                              device=dev)
    terrain_mu = terrain.static_friction if terrain is not None else 1.0
    report = None
    geom_pos0 = None
    terrain_hn = None
    lam_inv = ang_inv = None
    for _ in range(nsub):
        frames = fk_fn(model, state)
        geom_pos, geom_vel = geom_world_positions(model, frames)
        if geom_pos0 is None:
            geom_pos0 = geom_pos
            # height and normal once per call (xy drift << a grid cell)
            terrain_hn = sample_terrain(model, terrain, geom_pos)

        # passive joint terms: viscous damping, dry friction, limit springs
        tau_total = (tau - damping * state.qd
                     - sim_cfg.joint_friction * torch.tanh(state.qd / 0.1)
                     + joint_limit_torque(model, state.q, state.qd))

        f_world = None
        if extra_contact is not None:
            f_world = extra_contact(env_origin, geom_pos, geom_vel,
                                    c.mass[gb], dt)

        if contact_model == "apparent":
            # free dynamics -> implicit contact against the articulated
            # point response -> final dynamics; the constraint acts at the
            # contact point on the sphere's surface, not at its center
            n_w = terrain_hn[1]
            p_c = geom_pos - n_w * c.geom_radius[:, None]
            arm_w = p_c - frames.p[:, gb]
            v_c = geom_vel + torch.linalg.cross(frames.w[:, gb],
                                                p_c - geom_pos, dim=-1)
            sweeps, solve = articulated_sweeps(
                model, state, gravity, params.payload,
                params.com_displacement, fixed_base=fixed_base,
                joint_impedance=joint_imp)
            c_iters = int(getattr(sim_cfg, "contact_iterations", 1))
            phi0_w = None
            if lam_inv is None:   # q drifts ~nothing within one control step
                n_limbs = float(max(int(np.sum(np.asarray(model.parent)
                                               == 0)), 1))
                base_split = (float(getattr(sim_cfg, "contact_base_split",
                                            0.0)) or n_limbs)
                if c_iters > 1:
                    lam_inv, ang_inv, phi0_w = osim_from_sweeps(
                        model, sweeps, frames, arm_w, fixed_base=fixed_base,
                        base_split=1.0, return_ang=True, return_base=True)
                else:
                    lam_inv, ang_inv = osim_from_sweeps(
                        model, sweeps, frames, arm_w, fixed_base=fixed_base,
                        base_split=base_split, return_ang=True)
            _, _, a_body = solve(tau_total, None, return_body_accels=True)
            a_pt = point_accels(model, frames, a_body, arm_w=arm_w)
            forces, report, ctorques = contact_forces_implicit(
                model, geom_pos, v_c, a_pt, lam_inv,
                params.friction, params.restitution, terrain_hn,
                erp=sim_cfg.erp,
                max_depenetration_velocity=sim_cfg.max_depenetration_velocity,
                bounce_threshold_velocity=sim_cfg.bounce_threshold_velocity,
                dt=dt, terrain_friction=terrain_mu,
                geom_omega=frames.w[:, gb], ang_inv=ang_inv,
                torsional_patch_radius=getattr(
                    sim_cfg, "torsional_patch_radius", 0.0),
                iterations=c_iters, phi0_w=phi0_w,
                arm_base=((p_c - frames.p[:, :1]) if c_iters > 1
                          else None))
            f_ext = spatial_forces_on_bodies(model, frames, p_c, forces,
                                             torques_w=ctorques)
            if f_world is not None:
                f_ext = f_ext + spatial_forces_on_bodies(
                    model, frames, geom_pos, f_world)
                report = report + report_forces(model, f_world)
            qdd, a0 = solve(tau_total, f_ext)
        else:
            forces, report = contact_forces(
                model, geom_pos, geom_vel,
                params.friction, params.restitution, terrain_hn,
                stiffness=sim_cfg.contact_stiffness,
                damping=sim_cfg.contact_damping,
                friction_vel_eps=sim_cfg.friction_vel_eps,
                dt=dt, terrain_friction=terrain_mu)
            if f_world is not None:
                forces = forces + f_world
                report = report + report_forces(model, f_world)
            f_ext = spatial_forces_on_bodies(model, frames, geom_pos, forces)
            qdd, a0 = aba_fn(model, state, tau_total, f_ext, gravity,
                             params.payload, params.com_displacement,
                             fixed_base=fixed_base,
                             joint_impedance=joint_imp)
        state = integrate(state, qdd, a0, dt, fixed_base=fixed_base)
        # the per-DOF velocity limit, as IsaacGym applies dof_props
        # 'velocity'
        state = state._replace(qd=torch.clamp(state.qd, -vel_lim, vel_lim))
    return StepOutput(state, report, geom_pos0)


def default_sim_state(model, base_pos, base_quat, q) -> SimState:
    """Rest state at the given pose (any leading batch axes, none for one
    robot): zero base and joint velocities."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    base_pos, base_quat, q = f(base_pos), f(base_quat), f(q)
    if q.shape[-1] != model.nv:
        raise ValueError(f"q has {q.shape[-1]} entries, the model {model.nv}")
    return SimState(base_pos=base_pos, base_quat=base_quat,
                    base_lin_vel=torch.zeros_like(base_pos),
                    base_ang_vel=torch.zeros_like(base_pos),
                    q=q, qd=torch.zeros_like(q))
