"""The port's general (AoS) physics (rapid_locomotion_rl_tpu_torch.ops:
spatial, dynamics, limb_dynamics, contact, physics) against the JAX
package's, function by function on the 2-limb hopper and on Mini Cheetah,
then the whole step against JAX's vmapped one at 8 envs on a 2 x 3-cell
trimesh.

Both sides get the same numpy inputs made from a seed. Tolerances: 1e-6 on
the spatial helpers and the 6x6 solves (the same unrolled Cholesky, entry
by entry), rtol/atol 2e-5 on dynamics, forces and state, 2e-4/2e-3 on
contact reports, 1e-5 on geom positions; grounded states with random
torques by the bulk rule of tests/test_soa_physics.py (states on a
contact-branch boundary flip on fp-level differences). The JAX side runs
jitted and vmapped over the envs, as its env runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.config import SimCfg as JSimCfg
from rapid_locomotion_rl_tpu.envs.world import (box_sphere_forces as jboxes,
                                                default_corridor as jcorridor)
from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops import contact as JC
from rapid_locomotion_rl_tpu.ops import dynamics as JD
from rapid_locomotion_rl_tpu.ops import limb_dynamics as JL
from rapid_locomotion_rl_tpu.ops import physics as JP
from rapid_locomotion_rl_tpu.ops import spatial as JS
from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.envs.world import (box_sphere_forces,
                                                      default_corridor)
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops import contact as TC
from rapid_locomotion_rl_tpu_torch.ops import dynamics as TD
from rapid_locomotion_rl_tpu_torch.ops import limb_dynamics as TL
from rapid_locomotion_rl_tpu_torch.ops import physics as TP
from rapid_locomotion_rl_tpu_torch.ops import spatial as TS
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import FIXED_BASE_APPARENT
from torch_port_helpers import (MC, TINY, _grids, assert_step_close,
                                assert_step_close_walls, near_walls,
                                on_terrain, physics_inputs, torch_inputs,
                                wall_depth)

N = 8


@pytest.fixture(scope="module")
def robots(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return {"hopper": (jload_urdf(str(p)), load_urdf(str(p))),
            "mini_cheetah": (jload_urdf(MC), load_urdf(MC))}


def _close(a, b, tol=2e-5, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# spatial helpers and the 6x6 solves
# ---------------------------------------------------------------------------
def _spd(rng, n):
    B = rng.normal(size=(n, 6, 6))
    return (B @ np.swapaxes(B, -1, -2) + 6 * np.eye(6)).astype(np.float32)


SPATIAL = {
    "skew": lambda m, a: m.skew(a["v3"]),
    "spatial_inertia": lambda m, a: m.spatial_inertia(a["s"], a["v3"],
                                                      a["I3"]),
    "xmat_motion": lambda m, a: m.xmat_motion(a["E"], a["v3"]),
    "xform_motion": lambda m, a: m.xform_motion(a["E"], a["v3"], a["v6"]),
    "xform_motion_inv": lambda m, a: m.xform_motion_inv(a["E"], a["v3"],
                                                        a["v6"]),
    "xform_force_to_parent": lambda m, a: m.xform_force_to_parent(
        a["E"], a["v3"], a["v6"]),
    "crm": lambda m, a: m.crm(a["v6"], a["w6"]),
    "crf": lambda m, a: m.crf(a["v6"], a["w6"]),
    "solve_psd6": lambda m, a: m.solve_psd6(a["A"], a["v6"]),
}


@pytest.mark.parametrize("name", sorted(SPATIAL) + ["inv_psd6"])
def test_spatial_helpers_match(name):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(N, 3, 3)))
    arrs = dict(v3=rng.normal(size=(N, 3)), s=rng.uniform(0.1, 3, N),
                I3=_spd(rng, N)[:, :3, :3], E=q, v6=rng.normal(size=(N, 6)),
                w6=rng.normal(size=(N, 6)), A=_spd(rng, N))
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    ja = {k: jnp.asarray(v) for k, v in arrs.items()}
    ta = {k: torch.tensor(v) for k, v in arrs.items()}
    if name == "inv_psd6":
        ref, got = JD.inv_psd6(ja["A"]), TD.inv_psd6(ta["A"])
    else:
        ref, got = SPATIAL[name](JS, ja), SPATIAL[name](TS, ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# dynamics and contact functions, per robot
# ---------------------------------------------------------------------------
def _inputs(tm, seed=0, kind="ground"):
    """physics_inputs of the robot (the hopper's own draws for the
    hopper), both packages' forms: (numpy dict, JAX, torch)."""
    kind = "hopper" if tm.nb == 3 else kind
    state, params, tau, imp = physics_inputs(tm, N, seed, kind)
    rng = np.random.default_rng(seed + 100)
    f_ext = rng.normal(0, 5, (N, tm.nb, 6)).astype(np.float32)
    j = (JD.SimState(**{k: jnp.asarray(v) for k, v in state.items()}),
         JD.PhysParams(**{k: jnp.asarray(v) for k, v in params.items()}),
         jnp.asarray(tau), jnp.asarray(imp), jnp.asarray(f_ext))
    t = torch_inputs(state, params, tau, imp) + (torch.tensor(f_ext),)
    return j, t


GRAV = np.array([0.0, 0.0, -9.81], np.float32)


def _vmap(fn, *args):
    return jax.jit(jax.vmap(fn))(*args)


@pytest.mark.parametrize("robot", ["hopper", "mini_cheetah"])
def test_aba_and_sweeps_match(robots, robot):
    jm, tm = robots[robot]
    (js, jp, jt, ji, jf), (ts, tp, tt, ti, tf) = _inputs(tm)
    g = jnp.asarray(GRAV)

    def jfn(s, t, p, i, f):
        a = JD.aba(jm, s, t, f, g, p.payload, p.com_displacement,
                   return_body_accels=True, joint_impedance=i)
        sw, solve = JD.articulated_sweeps(jm, s, g, p.payload,
                                          p.com_displacement,
                                          joint_impedance=i)
        return a, solve(t, f, return_body_accels=True), sw["IA"][0]
    (qdd, a0, ab), sol, IA0 = _vmap(jfn, js, jt, jp, ji, jf)
    got = TD.aba(tm, ts, tt, tf, torch.tensor(GRAV), tp.payload,
                 tp.com_displacement, return_body_accels=True,
                 joint_impedance=ti)
    for r, o, name in zip((qdd, a0, ab), got, ("qdd", "a0", "a_body")):
        _close(o, r, name=name)
    sw, solve = TD.articulated_sweeps(tm, ts, torch.tensor(GRAV),
                                      tp.payload, tp.com_displacement,
                                      joint_impedance=ti)
    _close(sw["IA"][0], IA0, name="IA0")
    for r, o in zip(sol, solve(tt, tf, return_body_accels=True)):
        _close(o, r)
    # a fixed base and no external force
    ref = _vmap(lambda s, t, p: JD.aba(jm, s, t, None, g, p.payload,
                                       p.com_displacement, fixed_base=True),
                js, jt, jp)
    got = TD.aba(tm, ts, tt, None, torch.tensor(GRAV), tp.payload,
                 tp.com_displacement, fixed_base=True)
    for r, o in zip(ref, got):
        _close(o, r)


@pytest.mark.parametrize("robot", ["hopper", "mini_cheetah"])
@pytest.mark.parametrize("fixed", [False, True])
def test_osim_and_contact_inv_inertia_match(robots, robot, fixed):
    jm, tm = robots[robot]
    (js, jp, jt, ji, _), (ts, tp, tt, ti, _) = _inputs(tm, seed=1)
    g = jnp.asarray(GRAV)
    rng = np.random.default_rng(5)
    arm = rng.normal(0, 0.2, (N, tm.ng, 3)).astype(np.float32)

    def jfn(s, p, i, a):
        fr = JD.fk(jm, s)
        sw, _ = JD.articulated_sweeps(jm, s, g, p.payload,
                                      p.com_displacement, fixed_base=fixed,
                                      joint_impedance=i)
        osim = JD.osim_from_sweeps(jm, sw, fr, a, fixed_base=fixed,
                                   base_split=4.0, return_ang=True,
                                   return_base=True)
        cii = JD.contact_inv_inertia(jm, s, fr, p.payload,
                                     p.com_displacement, fixed_base=fixed,
                                     base_split=2.0, joint_impedance=i)
        return osim, cii
    (lam, ang, phi0), cii = _vmap(jfn, js, jp, ji, jnp.asarray(arm))
    fr = TD.fk(tm, ts)
    sw, _ = TD.articulated_sweeps(tm, ts, torch.tensor(GRAV), tp.payload,
                                  tp.com_displacement, fixed_base=fixed,
                                  joint_impedance=ti)
    got = TD.osim_from_sweeps(tm, sw, fr, torch.tensor(arm),
                              fixed_base=fixed, base_split=4.0,
                              return_ang=True, return_base=True)
    for r, o, name in zip((lam, ang, phi0), got, ("lam", "ang", "phi0")):
        _close(o, r, name=name)
    o = TD.contact_inv_inertia(tm, ts, fr, tp.payload, tp.com_displacement,
                               fixed_base=fixed, base_split=2.0,
                               joint_impedance=ti)
    _close(o, cii, name="contact_inv_inertia")


def test_fk_limb_and_aba_limb_match(robots):
    """The limb-batched FK and ABA (Mini Cheetah: 3 levels x 4 limbs; the
    hopper: 1 x 2)."""
    for robot in ("hopper", "mini_cheetah"):
        jm, tm = robots[robot]
        (js, jp, jt, ji, jf), (ts, tp, tt, ti, tf) = _inputs(tm, seed=2)
        g = jnp.asarray(GRAV)
        jl, tl = JL.layout_for(jm), TL.layout_for(tm)
        np.testing.assert_array_equal(tl.body_index, jl.body_index)
        fr, (qdd, a0) = _vmap(lambda s, t, p, i, f: (
            JL.fk_limb(jm, jl, s),
            JL.aba_limb(jm, jl, s, t, f, g, p.payload, p.com_displacement,
                        joint_impedance=i)), js, jt, jp, ji, jf)
        for r, o in zip(fr, TL.fk_limb(tm, tl, ts)):
            _close(o, r)
        got = TL.aba_limb(tm, tl, ts, tt, tf, torch.tensor(GRAV), tp.payload,
                          tp.com_displacement, joint_impedance=ti)
        _close(got[0], qdd, name=robot)
        _close(got[1], a0, name=robot)


def _contact_inputs(tm, seed):
    """Spheres around the ground: heights and normals of a tilted patch,
    velocities, free accelerations, an SPD inverse apparent inertia and
    its angular block, body rates and base arms."""
    rng = np.random.default_rng(seed)
    ng = tm.ng
    pos = rng.normal(0, 0.3, (N, ng, 3))
    pos[..., 2] = rng.uniform(-0.02, 0.06, (N, ng))
    nrm = rng.normal([0, 0, 1], 0.2, (N, ng, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    B = rng.normal(0, 1, (N, ng, 3, 3))
    lam = 0.5 * B @ np.swapaxes(B, -1, -2) + 2 * np.eye(3)
    A = rng.normal(0, 1, (N, ng, 3, 3))
    ang = 20 * (A @ np.swapaxes(A, -1, -2) + np.eye(3))
    Pb = _spd(rng, N).astype(np.float64) * 0.1
    arrs = dict(pos=pos, vel=rng.normal(0, 1, (N, ng, 3)),
                acc=rng.normal(0, 10, (N, ng, 3)), lam=lam, ang=ang,
                h=rng.uniform(-0.01, 0.01, (N, ng)), n=nrm,
                om=rng.normal(0, 3, (N, ng, 3)), arm=rng.normal(0, 0.2,
                                                               (N, ng, 3)),
                phi0=Pb, fr=rng.uniform(0.2, 2, N), rs=rng.uniform(0, 1, N))
    return {k: np.asarray(v, np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("robot", ["hopper", "mini_cheetah"])
@pytest.mark.parametrize("iters", [1, 3])
def test_contact_forces_implicit_match(robots, robot, iters):
    jm, tm = robots[robot]
    a = _contact_inputs(tm, 3)
    kw = dict(erp=0.8, max_depenetration_velocity=1.0,
              bounce_threshold_velocity=0.3, dt=0.0025, terrain_friction=0.8,
              torsional_patch_radius=0.01, iterations=iters)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.tensor(v) for k, v in a.items()}

    def jfn(pos, vel, acc, lam, ang, h, n, om, arm, phi0, fr, rs):
        return JC.contact_forces_implicit(
            jm, pos, vel, acc, lam, fr, rs, (h, n), geom_omega=om,
            ang_inv=ang, phi0_w=phi0 if iters > 1 else None,
            arm_base=arm if iters > 1 else None, **kw)
    keys = ("pos", "vel", "acc", "lam", "ang", "h", "n", "om", "arm", "phi0",
            "fr", "rs")
    ref = _vmap(jfn, *(j[k] for k in keys))
    got = TC.contact_forces_implicit(
        tm, t["pos"], t["vel"], t["acc"], t["lam"], t["fr"], t["rs"],
        (t["h"], t["n"]), geom_omega=t["om"], ang_inv=t["ang"],
        phi0_w=t["phi0"] if iters > 1 else None,
        arm_base=t["arm"] if iters > 1 else None, **kw)
    assert np.abs(np.asarray(ref[0])).max() > 1.0, "no contact force"
    _close(got[0], ref[0], name="forces")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=2e-4, atol=2e-3)
    _close(got[2], ref[2], name="torques")


@pytest.mark.parametrize("robot", ["hopper", "mini_cheetah"])
def test_legacy_contact_and_body_forces_match(robots, robot):
    """contact_forces (legacy), sample_terrain on the plane,
    spatial_forces_on_bodies (with pure torques) and point_accels."""
    jm, tm = robots[robot]
    a = _contact_inputs(tm, 4)
    (js, _, _, _, jf), (ts, _, _, _, tf) = _inputs(tm, seed=4)
    kw = dict(stiffness=3000.0, damping=80.0, friction_vel_eps=0.05,
              dt=0.0025, terrain_friction=0.8)

    def jfn(s, pos, vel, h, n, om, fr, rs, ab):
        frames = JD.fk(jm, s)
        hn0 = JC.sample_terrain(jm, None, pos)
        forces, rep = JC.contact_forces(jm, pos, vel, fr, rs, (h, n), **kw)
        f6 = JC.spatial_forces_on_bodies(jm, frames, pos, forces,
                                         torques_w=om)
        return hn0, forces, rep, f6, JD.point_accels(jm, frames, ab)
    keys = ("pos", "vel", "h", "n", "om", "fr", "rs")
    ref = _vmap(jfn, js, *(jnp.asarray(a[k]) for k in keys), jf)
    t = {k: torch.tensor(v) for k, v in a.items()}
    frames = TD.fk(tm, ts)
    hn0 = TC.sample_terrain(tm, None, t["pos"])
    forces, rep = TC.contact_forces(tm, t["pos"], t["vel"], t["fr"], t["rs"],
                                    (t["h"], t["n"]), **kw)
    f6 = TC.spatial_forces_on_bodies(tm, frames, t["pos"], forces,
                                     torques_w=t["om"])
    pa = TD.point_accels(tm, frames, tf)
    assert np.abs(np.asarray(ref[1])).max() > 1.0, "no contact force"
    _close(hn0[0], ref[0][0])
    _close(hn0[1], ref[0][1])
    _close(forces, ref[1], name="forces")
    np.testing.assert_allclose(rep.numpy(), np.asarray(ref[2]), rtol=2e-4,
                               atol=2e-3)
    _close(f6, ref[3], name="f6")
    _close(pa, ref[4], name="point_accels")


# ---------------------------------------------------------------------------
# the whole step, 8 Mini Cheetah envs on a 2 x 3-cell trimesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trimesh():
    """A non-flat trimesh collision grid of the default TerrainCfg mix at
    2 x 3 cells of 4 m, built by the JAX package, as (JAX grid, torch
    grid)."""
    from rapid_locomotion_rl_tpu.config import TerrainCfg
    from rapid_locomotion_rl_tpu.envs.terrain import Terrain
    c = TerrainCfg()
    c.num_rows, c.num_cols = 2, 3
    c.terrain_length = c.terrain_width = 4.0
    c.border_size = 2.0
    g = Terrain(c, 8, seed=0).as_collision_grid(
        1.0, 1.0, 0.0, upsample=2, slope_threshold=c.slope_treshold)
    return _grids(np.asarray(g.height), g.horizontal_scale, g.border_size)


_JSTEPS = {}


def _jstep(jm, sim_kw, fixed, extra):
    """JAX's physics_step jitted and vmapped over the envs (one compile
    per configuration, shared by the flight and grounded cases)."""
    key = (id(jm), tuple(sorted(sim_kw.items())), fixed, extra is not None)
    if key not in _JSTEPS:
        sim = JSimCfg(**sim_kw)
        if extra is None:
            fn = jax.vmap(lambda s, t, p, i, o, g: JP.physics_step(
                jm, sim, s, t, p, g, fixed_base=fixed, implicit_damp=i),
                in_axes=(0, 0, 0, 0, 0, None))
        else:
            fn = jax.vmap(lambda s, t, p, i, o, g: JP.physics_step(
                jm, sim, s, t, p, g, fixed_base=fixed, implicit_damp=i,
                extra_contact=extra, env_origin=o),
                in_axes=(0, 0, 0, 0, 0, None))
        _JSTEPS[key] = jax.jit(fn)
    return _JSTEPS[key]


def _step_both(robots, grids, kind, sim_kw=None, fixed=False, walls=False,
               seed=0):
    sim_kw = sim_kw or {}
    jm, tm = robots["mini_cheetah"]
    state, params, tau, imp = physics_inputs(tm, N, seed, kind)
    state = on_terrain(state, grids[1], seed)
    origins = np.zeros((N, 3), np.float32)
    jextra = textra = None
    if walls:
        state, origins = near_walls(state, seed, lift=(
            0.75 if kind == "flight" else None))
        c = SimCfg(**sim_kw)
        jb, tb = jcorridor(), default_corridor()
        jr = jnp.asarray(np.asarray(jm.geom_radius, np.float32))
        tr = torch.tensor(np.asarray(tm.geom_radius, np.float32))
        wkw = dict(stiffness=c.contact_stiffness, damping=c.contact_damping,
                   friction=grids[1].static_friction,
                   friction_vel_eps=c.friction_vel_eps)

        def jextra(o, pos, vel, m_eff, dt):
            return jboxes(jb, o, pos, vel, jr, m_eff, dt=dt, **wkw)

        def textra(o, pos, vel, m_eff, dt):
            return box_sphere_forces(tb, o, pos, vel, tr, m_eff, dt=dt,
                                     **wkw)
    js = JD.SimState(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = JD.PhysParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ref = _jstep(jm, sim_kw, fixed, jextra)(
        js, jnp.asarray(tau), jp, jnp.asarray(imp), jnp.asarray(origins),
        grids[0])
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = TP.physics_step(tm, SimCfg(**sim_kw), ts, tt, tp, grids[1],
                          fixed_base=fixed, implicit_damp=ti,
                          extra_contact=textra,
                          env_origin=torch.tensor(origins) if walls else None)
    ref = jax.tree.map(np.asarray, ref)
    return ref, out, origins


@pytest.mark.parametrize("contact_model", ["apparent", "legacy"])
@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_physics_step_matches(robots, trimesh, contact_model, kind):
    ref, out, _ = _step_both(robots, trimesh, kind,
                             dict(contact_model=contact_model))
    if kind == "ground":
        assert np.abs(ref.contact_report).max() > 1.0, "no contact"
    else:
        assert np.abs(ref.contact_report).max() == 0.0
    assert_step_close(ref, out, "ground" if kind == "ground" else "strict")


def test_physics_step_world_boxes_match(robots, trimesh):
    """The world-box hook in the walls of the corridor (flight inside
    the walls' height, each substep pushing the spheres out)."""
    jm, tm = robots["mini_cheetah"]
    ref, out, origins = _step_both(robots, trimesh, "flight", walls=True)
    depth = wall_depth(tm, default_corridor(), ref.geom_pos, origins)
    assert_step_close_walls(ref, out, depth)


def test_physics_step_fixed_base_legacy_matches(robots, trimesh):
    ref, out, _ = _step_both(robots, trimesh, "ground",
                             dict(contact_model="legacy"), fixed=True)
    assert_step_close(ref, out, "ground")
    np.testing.assert_array_equal(out.state.base_pos.numpy(),
                                  ref.state.base_pos)
    assert (out.state.base_lin_vel == 0).all()


def test_fixed_base_apparent_refused_where_jax_gives_nan(robots):
    """A fixed base under the apparent model: the JAX AoS step gives NaN
    (the base's zero mobility makes the inverse apparent inertia of the
    spheres on the base singular); the port refuses the pair."""
    jm, tm = robots["hopper"]
    state, params, tau, imp = physics_inputs(tm, 2, 0, "hopper")
    state["base_pos"][:, 2] = 0.02     # the base sphere on the ground
    js = JD.SimState(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = JD.PhysParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ref = _vmap(lambda s, t, p: JP.physics_step(
        jm, JSimCfg(), s, t, p, None, fixed_base=True), js,
        jnp.asarray(tau), jp)
    assert np.isnan(np.asarray(ref.state.qd)).any()
    ts, tp, tt, _ = torch_inputs(state, params, tau, imp)
    with pytest.raises(ValueError, match="contact_model='legacy'"):
        TP.physics_step(tm, SimCfg(), ts, tt, tp, None, fixed_base=True)
    assert "NaN" in FIXED_BASE_APPARENT


def test_default_sim_state_matches(robots):
    jm, tm = robots["mini_cheetah"]
    q = np.linspace(-0.5, 0.5, tm.nv).astype(np.float32)
    ref = JP.default_sim_state(jm, [0, 0, 0.3], [0, 0, 0, 1], q)
    got = TP.default_sim_state(tm, [0, 0, 0.3], [0, 0, 0, 1], q)
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
