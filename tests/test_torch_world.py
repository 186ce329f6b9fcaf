"""World boxes (the walls of the HLP corridor): the port's box forces and
its plain physics step with boxes against the JAX package's.

- ``envs/world.py::box_sphere_forces`` (batched form) and
  ``ops/soa_physics.py::box_forces_soa`` (the form inside the chain)
  against JAX's ``box_sphere_forces`` and ``_box_forces_soa`` on spheres
  clear of a wall, touching it, crossing it, inside it, and inside it at
  equal distance from two faces (the tie goes to the first axis, by the
  ``<=`` chain of the SoA form).
- The plain physics step with the corridor against JAX's
  ``physics_step_soa`` and its Pallas kernel in interpret mode, on the
  hopper (1x2 limbs) and on Mini Cheetah (3x4), with and without a
  terrain grid. Flight and hopper states agree at the tolerances of
  tests/test_pallas_physics.py (2e-5 state, 2e-4/2e-3 report, 1e-5 geom
  positions): entry by entry where clear of the walls, in bulk where a
  sphere is in a wall (torch_port_helpers.assert_step_close_walls says
  why); grounded random-torque states by the bulk rule of
  tests/test_soa_physics.py. The hopper case is the one of
  test_pallas_physics.py::test_pallas_world_boxes (a 1.2 x 0.5 m corridor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.config import SimCfg as JSimCfg
from rapid_locomotion_rl_tpu.envs import world as JW
from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops.dynamics import PhysParams as JParams
from rapid_locomotion_rl_tpu.ops.dynamics import SimState as JState
from rapid_locomotion_rl_tpu.ops.pallas_physics import physics_step_pallas
from rapid_locomotion_rl_tpu.ops.soa_physics import _box_forces_soa
from rapid_locomotion_rl_tpu.ops.soa_physics import physics_step_soa as jstep
from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.envs import world as TW
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import (box_forces_soa,
                                                           physics_step_soa)
from torch_port_helpers import (MC, TINY, assert_step_close,
                                assert_step_close_walls, generated_grid,
                                near_walls, on_terrain, physics_inputs,
                                step_grid, torch_inputs, wall_depth)

KW = dict(stiffness=30000.0, damping=200.0, friction=1.0,
          friction_vel_eps=0.1, dt=0.0025)


def _boxes():
    """A dyadic box beside the default corridor: (JAX, torch) boxes whose
    face distances are exact in float32, so a tie is a tie."""
    c = np.array([[0.0, -0.8, 0.5], [0.0, 0.8, 0.5], [1.85, 0.0, 0.5],
                  [-1.85, 0.0, 0.5], [4.0, 4.0, 0.5]], np.float32)
    h = np.array([[1.75, 0.1, 0.5], [1.75, 0.1, 0.5], [0.1, 0.9, 0.5],
                  [0.1, 0.9, 0.5], [0.25, 0.5, 0.5]], np.float32)
    return (JW.WorldBoxes(jnp.asarray(c), jnp.asarray(h)),
            TW.WorldBoxes(torch.tensor(c), torch.tensor(h)))


def _spheres():
    """Sphere centers (one env each) and what each case is."""
    cases = {
        "clear": (0.0, 0.5, 0.3),          # 0.2 m from the side wall
        "touching": (0.5, 0.66, 0.3),      # 0.04 m off, radius 0.05
        "crossing": (-1.0, -0.69, 0.2),    # center 0.01 m off the face
        "inside": (0.3, 0.8, 0.6),         # in the side wall's middle
        "inside_end": (1.9, -0.3, 0.4),    # in an end wall
        "corner": (1.74, 0.69, 0.96),      # outside an edge, near a corner
        "tie": (4.125, 4.375, 0.5),        # x and y faces both 0.125 away
    }
    pos = np.array(list(cases.values()), np.float32)
    return list(cases), pos


def _sphere_inputs(seed=0):
    names, pos = _spheres()
    n = len(names)
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    origin = np.zeros((n, 3), np.float32)
    return names, pos, vel, origin


def test_box_sphere_forces_matches_jax():
    names, pos, vel, origin = _sphere_inputs()
    jb, tb = _boxes()
    radius = np.full(1, 0.05, np.float32)
    m_eff = np.full(1, 0.7, np.float32)
    ref = jax.vmap(lambda o, p, v: JW.box_sphere_forces(
        jb, o, p, v, jnp.asarray(radius), jnp.asarray(m_eff), **KW))(
        jnp.asarray(origin), jnp.asarray(pos[:, None]),
        jnp.asarray(vel[:, None]))
    out = TW.box_sphere_forces(tb, torch.tensor(origin),
                               torch.tensor(pos[:, None]),
                               torch.tensor(vel[:, None]),
                               torch.tensor(radius), torch.tensor(m_eff),
                               **KW)
    ref, out = np.asarray(ref)[:, 0], out.numpy()[:, 0]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)
    force = dict(zip(names, ref))
    assert np.all(force["clear"] == 0.0)
    for k in ("touching", "crossing", "inside", "inside_end", "tie"):
        assert np.linalg.norm(force[k]) > 1.0, k
    # the tie pushes out along x, the first of the two nearest faces
    assert abs(force["tie"][0]) > 10 * abs(force["tie"][1])


@pytest.mark.parametrize("rad,m_eff", [(0.05, 0.7), (0.02, 3.3)])
def test_box_forces_soa_matches_jax(rad, m_eff):
    names, pos, vel, origin = _sphere_inputs(1)
    origin = origin + np.float32([0.5, -1.25, 0.0])   # placed off zero
    pos = pos + origin
    jb, tb = _boxes()
    sim = SimCfg()
    v3 = lambda a, f: tuple(f(a[:, i]) for i in range(3))  # noqa: E731
    with jax.disable_jit():
        ref = _box_forces_soa(jb, v3(origin, jnp.asarray),
                              v3(pos, jnp.asarray), v3(vel, jnp.asarray),
                              rad, m_eff, JSimCfg(), 1.0, 0.0025)
    out = box_forces_soa(tb, v3(origin, torch.tensor), v3(pos, torch.tensor),
                         v3(vel, torch.tensor), rad, m_eff, sim, 1.0, 0.0025)
    ref = np.stack([np.asarray(r) for r in ref], -1)
    out = torch.stack(out, -1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    force = dict(zip(names, ref))
    assert np.all(force["clear"] == 0.0)
    assert abs(force["tie"][0]) > 10 * abs(force["tie"][1])
    assert np.linalg.norm(force["inside"]) > 1.0


@pytest.fixture(scope="module")
def hopper_urdf(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return str(p)


def _jax_inputs(state, params, tau, imp):
    return (JState(**{k: jnp.asarray(v) for k, v in state.items()}),
            JParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            jnp.asarray(tau), None if imp is None else jnp.asarray(imp))


@pytest.mark.parametrize("reference,terrain,with_imp", [
    ("soa", False, False), ("soa", True, True), ("pallas", True, True)])
def test_hopper_with_corridor_matches_jax(hopper_urdf, reference, terrain,
                                          with_imp):
    """test_pallas_world_boxes' case (200 envs of the hopper's states, the
    corridor of 1.2 x 0.5 m at the origin), and on the step grid. The
    Pallas kernel in interpret mode takes ~30 s a case here, so it runs the
    case with every input group (terrain, implicit PD, origins); the SoA
    step, which test_pallas_world_boxes holds to the kernel, runs the
    others."""
    jm, tm = jload_urdf(hopper_urdf), load_urdf(hopper_urdf)
    state, params, tau, imp = physics_inputs(tm, 200, 0, "hopper")
    imp = imp if with_imp else None
    jg, tg = step_grid() if terrain else (None, None)
    origins = np.zeros((200, 3), np.float32)
    jwb = JW.default_corridor(1.2, 0.5, wall_height=1.0)
    twb = TW.default_corridor(1.2, 0.5, wall_height=1.0)
    js, jp, jt, ji = _jax_inputs(state, params, tau, imp)
    step = jstep if reference == "soa" else (
        lambda *a, **k: physics_step_pallas(*a, interpret=True, **k))
    with jax.disable_jit():
        ref = step(jm, JSimCfg(), js, jt, jp, jg, implicit_damp=ji,
                   world_boxes=jwb, env_origin=jnp.asarray(origins))
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, terrain=tg,
                           implicit_damp=ti, world_boxes=twb,
                           env_origin=torch.tensor(origins))
    # the corridor is hit: lateral report forces
    assert np.abs(np.asarray(ref.contact_report)[..., 1]).max() > 0.1
    assert_step_close_walls(ref, out, wall_depth(tm, twb, ref.geom_pos,
                                                 origins))


def _half(o, sl):
    return type(o)(type(o.state)(*(np.asarray(x)[sl] for x in o.state)),
                   np.asarray(o.contact_report)[sl],
                   np.asarray(o.geom_pos)[sl])


NF, NG = 64, 8   # Mini Cheetah envs in flight and standing


@pytest.fixture(scope="module", params=[False, True],
                ids=["plane", "terrain"])
def mc_corridor_pair(request):
    """One JAX SoA call on NF + NG Mini Cheetah envs in the default
    corridor (implicit PD on): the first NF torque-free in flight at
    0.75 m, inside the walls' height, the last NG standing with random
    torques; on the plane, or over the generated grid of slopes, stairs
    and obstacles."""
    jm, tm = jload_urdf(MC), load_urdf(MC)
    fl = physics_inputs(tm, NF, 21, "flight")
    gr = physics_inputs(tm, NG, 22, "ground")
    fs, fo = near_walls(fl[0], 23, lift=0.75)
    gs, go = near_walls(gr[0], 24)
    st = {k: np.concatenate([fs[k], gs[k]]) for k in fs}
    origins = np.concatenate([fo, go])
    jg, tg = None, None
    if request.param:
        # over the grid: bases spread over its cells, raised by the height
        # under them, each origin moved with its base
        jg, tg = generated_grid()
        rel = st["base_pos"][:, :2] - origins[:, :2]
        st = on_terrain(st, tg, 25)
        origins[:, :2] = st["base_pos"][:, :2] - rel
    params = {k: np.concatenate([fl[1][k], gr[1][k]]) for k in fl[1]}
    tau, imp = np.concatenate([fl[2], gr[2]]), np.concatenate([fl[3], gr[3]])
    js, jp, jt, ji = _jax_inputs(st, params, tau, imp)
    with jax.disable_jit():
        ref = jstep(jm, JSimCfg(), js, jt, jp, jg, implicit_damp=ji,
                    world_boxes=JW.default_corridor(),
                    env_origin=jnp.asarray(origins))
    ts, tp, tt, ti = torch_inputs(st, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, terrain=tg,
                           implicit_damp=ti, world_boxes=TW.default_corridor(),
                           env_origin=torch.tensor(origins))
    no_walls = physics_step_soa(tm, SimCfg(), ts, tt, tp, terrain=tg,
                                implicit_damp=ti)
    return (ref, out, no_walls.contact_report.numpy(), origins,
            request.param)


@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_mini_cheetah_in_corridor_matches_jax(mc_corridor_pair, kind):
    """Flight (the walls push spheres that the ground does not reach)
    strictly where clear of the walls and at the strict tolerances in bulk
    in them, grounded states by the bulk rule."""
    ref, out, no_walls, origins, on_grid = mc_corridor_pair
    sl = slice(0, NF) if kind == "flight" else slice(NF, NF + NG)
    ref, out = _half(ref, sl), _half(out, sl)
    # the walls act: lateral or longitudinal report forces
    assert np.abs(ref.contact_report[..., :2]).max() > 1.0
    if kind == "flight":
        # on the plane nothing touches the ground: every reported force is
        # a wall's; over the grid a few feet reach steep ground
        ground = np.abs(no_walls[sl]).max(axis=(1, 2)) > 0.0
        assert ground.mean() <= (0.1 if on_grid else 0.0)
        assert_step_close_walls(ref, out, wall_depth(
            load_urdf(MC), TW.default_corridor(), ref.geom_pos, origins[sl]))
    else:
        assert_step_close(ref, out, kind)
