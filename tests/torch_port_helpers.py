"""Shared inputs for the PyTorch-port parity tests: robot models of both
packages, and physics inputs made with numpy from a seed."""

from __future__ import annotations

import numpy as np
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR

GO1 = f"{RLTPU_ROOT_DIR}/resources/robots/go1/urdf/go1.urdf"
MC = f"{RLTPU_ROOT_DIR}/resources/robots/mini_cheetah/urdf/mini_cheetah.urdf"

# the 2-limb hopper of tests/test_pallas_physics.py (nb=3, nv=2, ng=3)
from test_pallas_physics import TINY  # noqa: E402,F401


def physics_inputs(model, n, seed, kind):
    """numpy inputs of one physics call.

    kind "hopper": the state/param/torque draws of test_pallas_physics;
    "flight": Go1-class robot high in the air, joints inside their limits,
    zero torques; "ground": the same robot at standing height, random
    torques (contacts on)."""
    rng = np.random.default_rng(seed)
    nv = model.nv
    if kind == "hopper":
        quat = rng.normal(size=(n, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        state = dict(
            base_pos=np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                     rng.uniform(0.1, 0.3, (n, 1))], -1),
            base_quat=quat,
            base_lin_vel=rng.uniform(-1, 1, (n, 3)),
            base_ang_vel=rng.uniform(-2, 2, (n, 3)),
            q=rng.uniform(-0.6, 0.6, (n, nv)),
            qd=rng.uniform(-3, 3, (n, nv)))
        params = dict(friction=rng.uniform(0.3, 2.0, n),
                      restitution=rng.uniform(0.0, 0.4, n),
                      payload=rng.uniform(-0.5, 2.0, n),
                      com_displacement=rng.uniform(-0.05, 0.05, (n, 3)))
        tau = rng.uniform(-3, 3, (n, nv))
    else:
        airborne = kind == "flight"
        lo, hi = np.asarray(model.dof_lower), np.asarray(model.dof_upper)
        quat = rng.normal([0, 0, 0, 4.0], 0.3, (n, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        state = dict(
            base_pos=rng.normal([0, 0, 1.5 if airborne else 0.30],
                                [0.5, 0.5, 0.02], (n, 3)),
            base_quat=quat,
            base_lin_vel=rng.normal(0, 0.5, (n, 3)),
            base_ang_vel=rng.normal(0, 0.5, (n, 3)),
            q=lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, nv)),
            qd=rng.uniform(-4, 4, (n, nv)))
        params = dict(friction=rng.uniform(0.1, 3.0, n),
                      restitution=rng.uniform(0, 1, n),
                      payload=rng.uniform(-1, 3, n),
                      com_displacement=rng.uniform(-0.1, 0.1, (n, 3)))
        tau = (np.zeros((n, nv)) if airborne
               else rng.uniform(-3, 3, (n, nv)))
    imp = rng.uniform(0.3, 3.0, (n, nv))
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    return (f32(state), f32(params), np.asarray(tau, np.float32),
            np.asarray(imp, np.float32))


def torch_inputs(state, params, tau, imp):
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams, SimState
    t = lambda a: torch.tensor(a)  # noqa: E731
    return (SimState(**{k: t(v) for k, v in state.items()}),
            PhysParams(**{k: t(v) for k, v in params.items()}),
            t(tau), None if imp is None else t(imp))


def mostly_close(a, b, atol, frac=0.80):
    """Bulk rule of tests/test_soa_physics.py: states on a contact-branch
    boundary flip on fp-level differences, so grounded states agree entry
    by entry only in bulk (healthy levels there are 87-99%)."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.abs(a - b) <= atol + 1e-3 * np.abs(b)
    assert ok.mean() >= frac, (ok.mean(), np.abs(a - b).max())


STATE_FIELDS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                "q", "qd")


def assert_step_close(ref, out, kind):
    """Compare two StepOutputs (numpy-convertible) at the tolerances of
    tests/test_pallas_physics.py (strict: identical arithmetic, float
    rounding only) or by the bulk rule (grounded random states)."""
    if kind == "ground":
        mostly_close(ref.state.q, out.state.q, 1e-3)
        mostly_close(ref.state.qd, out.state.qd, 1e-2)
        mostly_close(ref.state.base_pos, out.state.base_pos, 1e-3)
        mostly_close(ref.state.base_lin_vel, out.state.base_lin_vel, 1e-2)
        mostly_close(ref.contact_report, out.contact_report, 0.5)
        np.testing.assert_allclose(np.asarray(out.geom_pos),
                                   np.asarray(ref.geom_pos),
                                   rtol=1e-5, atol=1e-5)
        return
    for name in STATE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(out.state, name)),
                                   np.asarray(getattr(ref.state, name)),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(np.asarray(out.contact_report),
                               np.asarray(ref.contact_report),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.geom_pos),
                               np.asarray(ref.geom_pos), rtol=1e-5, atol=1e-5)


def wall_depth(model, boxes, geom_pos, origins):
    """Per env, the deepest reach of a collision sphere into a world box,
    as the box force measures it (radius less the distance to the box when
    the center is outside, nearest face distance plus radius when it is
    inside; 0 when clear), at a step's geom positions [n, ng, 3]. Takes
    either package's boxes."""
    gp = np.asarray(geom_pos, np.float64)
    c = (np.asarray(origins, np.float64)[:, None, None, :]
         + np.asarray(boxes.centers, np.float64))
    h = np.asarray(boxes.half_extents, np.float64)
    rad = np.asarray(model.geom_radius, np.float64)[None, :, None]
    rel = gp[:, :, None, :] - c
    dist = np.linalg.norm(rel - np.clip(rel, -h, h), axis=-1)
    face = (h - np.abs(rel)).min(-1)
    depth = np.where(dist < 1e-6, face + rad, np.maximum(rad - dist, 0.0))
    return depth.max(axis=(1, 2))


def _rows(o, mask):
    return type(o)(type(o.state)(*(np.asarray(x)[mask] for x in o.state)),
                   np.asarray(o.contact_report)[mask],
                   np.asarray(o.geom_pos)[mask])


def _strict_in_bulk(a, b, rtol, atol, name):
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    assert ok.mean() >= 0.99, (name, ok.mean(), np.abs(a - b).max())


WALL_BULK_ATOL = dict(base_pos=1e-3, base_quat=1e-3, q=1e-3,
                      base_lin_vel=1e-2, base_ang_vel=1e-2, qd=1e-2)


def assert_step_close_walls(ref, out, depth):
    """The strict comparison of ``assert_step_close`` for states in the
    world boxes, with the walls' stiffness taken into account.

    A wall pushes with 30,000 N/m, so a last-place difference in a
    sphere's position (the sin and cos of two libms: glibc's in the g++
    build, PyTorch's or XLA's in the plain versions) moves its force by
    ~0.01 N and can move the fastest joint of a few states in wall
    contact past 2e-5, shallow ones as well as deep ones. So the envs
    with a sphere in a wall (``depth`` > 0, from :func:`wall_depth`) are
    held at the strict tolerances in bulk (>= 99% of each field's
    entries, and of the report's) and, entry by entry, within the
    grounded bulk rule's tolerances (1e-3 on positions, orientation and
    joint angles, 1e-2 on velocities, 0.5 N on the report, each + 1e-3
    |ref|); the envs clear of every wall strictly.
    Geom positions are taken before the solve: strict for every env."""
    wall = np.asarray(depth) > 0.0
    assert wall.any(), "no sphere reaches a wall"
    if (~wall).any():
        assert_step_close(_rows(ref, ~wall), _rows(out, ~wall), "strict")
    r, o = _rows(ref, wall), _rows(out, wall)
    for name in STATE_FIELDS:
        a, b = getattr(o.state, name), getattr(r.state, name)
        _strict_in_bulk(a, b, 2e-5, 2e-5, name)
        mostly_close(a, b, WALL_BULK_ATOL[name], frac=1.0)
    _strict_in_bulk(o.contact_report, r.contact_report, 2e-4, 2e-3,
                    "contact_report")
    mostly_close(o.contact_report, r.contact_report, 0.5, frac=1.0)
    np.testing.assert_allclose(np.asarray(out.geom_pos),
                               np.asarray(ref.geom_pos), rtol=1e-5, atol=1e-5)


def step_grid():
    """The step grid of tests/test_pallas_physics.py (48 x 48 cells of
    0.1 m, a 0.08 m step at row 24), as (JAX grid, torch grid)."""
    h = np.zeros((48, 48), np.float32)
    h[24:, :] = 0.08
    return _grids(h, 0.1, 2.0)


def generated_grid():
    """A non-flat trimesh collision grid from the default TerrainCfg mix
    (sloped pyramids, stairs up and down, obstacles) at 3 x 5 cells of
    4 m with the curriculum's difficulty rows, built by the JAX package,
    as (JAX grid, torch grid)."""
    from rapid_locomotion_rl_tpu.config import TerrainCfg
    from rapid_locomotion_rl_tpu.envs.terrain import Terrain
    c = TerrainCfg()
    c.num_rows, c.num_cols = 3, 5
    c.terrain_length = c.terrain_width = 4.0
    c.border_size = 2.0
    g = Terrain(c, 16, seed=0).as_collision_grid(
        1.0, 1.0, 0.0, upsample=2, slope_threshold=c.slope_treshold)
    return _grids(np.asarray(g.height), g.horizontal_scale, g.border_size)


def _grids(h, scale, border):
    import jax.numpy as jnp
    from rapid_locomotion_rl_tpu.ops.contact import TerrainGrid as JGrid
    from rapid_locomotion_rl_tpu_torch.ops.contact import TerrainGrid
    args = dict(horizontal_scale=scale, border_size=border,
                static_friction=0.8, dynamic_friction=0.8, restitution=0.0)
    return (JGrid(height=jnp.asarray(h), **args),
            TerrainGrid(height=torch.tensor(h), **args))


def on_terrain(state, grid, seed):
    """``physics_inputs`` state moved over the generated grid: bases spread
    over its cells, heights raised by the terrain height under the base
    (so grounded robots stand on slopes, stairs and obstacles)."""
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        terrain_height_bilinear)
    rng = np.random.default_rng(seed)
    n = state["base_pos"].shape[0]
    rows, cols = grid.height.shape
    span_x = (rows - 1) * grid.horizontal_scale - 2 * grid.border_size
    span_y = (cols - 1) * grid.horizontal_scale - 2 * grid.border_size
    pos = state["base_pos"].copy()
    pos[:, 0] = rng.uniform(0.2, span_x - 0.2, n)
    pos[:, 1] = rng.uniform(0.2, span_y - 0.2, n)
    h = terrain_height_bilinear(grid, torch.tensor(pos[:, 0]),
                                torch.tensor(pos[:, 1])).numpy()
    pos[:, 2] += h
    return dict(state, base_pos=pos.astype(np.float32))


def near_walls(state, seed, lift=None):
    """``physics_inputs`` state placed in the default corridor
    (envs/world.py: walls 3.5 m x 1.6 m, 0.2 m thick, 1 m high) around
    per-env origins spread over [-3, 3]^2: each base sits at x in
    [-1.95, 1.95] and |y| in [0.45, 0.95] from its origin, so spheres stay
    clear of, touch, cross and sit inside the side and end walls. ``lift``
    sets the base height (a flight state inside the walls' height).
    Returns (state, origins [n, 3]); origin z is 0."""
    rng = np.random.default_rng(seed)
    n = state["base_pos"].shape[0]
    origins = np.zeros((n, 3), np.float32)
    origins[:, :2] = rng.uniform(-3, 3, (n, 2))
    rel = np.stack([rng.uniform(-1.95, 1.95, n),
                    rng.choice([-1.0, 1.0], n) * rng.uniform(0.45, 0.95, n)],
                   -1)
    pos = state["base_pos"].copy()
    pos[:, :2] = origins[:, :2] + rel
    if lift is not None:
        pos[:, 2] = lift
    return dict(state, base_pos=pos.astype(np.float32)), origins


def mc_env_step(edit):
    """One env step of each package from one JAX initial state:
    config_mini_cheetah cut as tests/test_torch_env_trimesh.py cuts it (64
    envs, 2 x 2 trimesh cells, decimation 2, no observation noise), then
    ``edit(cfg)`` on both configs. Contact collides with that test's wavy
    surface; the terrain grid that height sensing reads is a second,
    different surface (twice the waves, 1 cm up), so a sensor that read the
    collision grid would show. The state is prepared as there: envs 0-7
    time out (0-3 far enough from their origin to move up a level), envs
    8-13 sit near the edges and teleport, every base stands 0.29 m above
    the collision surface; the terrain-level and reset-spawn draws are
    replayed from JAX's key. The JAX step runs jitted.

    Returns ((JAX env, state, new state, result, reward terms), (port env,
    new state, result, reward terms))."""
    import jax
    import jax.numpy as jnp
    from rapid_locomotion_rl_tpu.envs.legged_robot import \
        LeggedRobotEnv as JEnv
    from rapid_locomotion_rl_tpu.ops.contact import TerrainGrid as JGrid
    from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        TerrainGrid, terrain_height_bilinear)
    from test_torch_env_trimesh import (NT, ReplaySampler, _jax_draws,
                                        _mc_cfgs, _wavy)
    jc, tc = _mc_cfgs()
    for c in (jc, tc):
        edit(c)
    jenv, tenv = JEnv(jc), LeggedRobotEnv(tc, device="cpu")
    for attr, gain, lift in (("collision_grid", 1.0, 0.0),
                             ("terrain_grid", 2.0, 0.01)):
        g = getattr(tenv, attr)
        if g is None:           # the port builds the raw grid to sense
            continue
        h = gain * _wavy(g.height.shape, g.horizontal_scale,
                         g.border_size) + np.float32(lift)
        meta = dict(horizontal_scale=g.horizontal_scale,
                    border_size=g.border_size,
                    static_friction=g.static_friction,
                    dynamic_friction=g.dynamic_friction,
                    restitution=g.restitution)
        setattr(jenv, attr, JGrid(height=jnp.asarray(h), **meta))
        setattr(tenv, attr, TerrainGrid(height=torch.tensor(h), **meta))
    if jenv._col_blocks is not None:
        from rapid_locomotion_rl_tpu.ops.contact import make_col_blocks
        jenv._col_blocks = make_col_blocks(jenv.collision_grid)

    jstate = jenv.initial_state(jax.random.PRNGKey(4))
    s = jax.tree.map(np.asarray, jstate)
    pos = s.sim.base_pos.copy()
    origins = s.env_origins
    ep = s.episode_length.copy()
    ep[:8] = jenv.derived.max_episode_length
    pos[:4, 0] = origins[:4, 0] + np.where(origins[:4, 0] < 8.0, 4.5, -4.5)
    pos[:4, 1] = origins[:4, 1]
    pos[8:11, 0] = 1.5
    pos[11:14, 1] = 14.5
    pos[:, 2] = 0.29 + terrain_height_bilinear(
        tenv.collision_grid, torch.tensor(pos[:, 0]),
        torch.tensor(pos[:, 1])).numpy()
    jstate = jstate._replace(
        sim=jstate.sim._replace(base_pos=jnp.asarray(pos)),
        episode_length=jnp.asarray(ep))
    tstate = env_state_from_jax(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    a = np.random.default_rng(7).normal(0, 0.5, (NT, 12)).astype(np.float32)
    sampler = ReplaySampler(7, _jax_draws(jenv, jstate))
    jnew, jres = jax.jit(jenv.step)(jstate, jnp.asarray(a))
    jterms = jax.jit(jenv.reward_terms)(jnew)
    tnew, tres = tenv.step(tstate, torch.tensor(a), sampler)
    return ((jenv, jstate, jnew, jres, jterms),
            (tenv, tnew, tres, tenv.reward_terms(tnew)))


def assert_env_step_close(jax_side, port_side, rows=None):
    """Every field that tests/test_torch_env_trimesh.py checks, at its
    tolerances: dones, time-outs, levels and origins exactly; sim state
    1e-4; contact forces 1e-3/1e-2 where no reset; obs, privileged obs and
    rewards 1e-4, reward terms 1e-4/1e-6 on the envs that did not reset
    (and, with ``rows`` [N] bool, only on those rows)."""
    _, jold, jnew, jres, jterms = jax_side
    _, tnew, tres, tterms = port_side
    done = np.asarray(jres.done)
    assert done[:8].all(), "envs 0-7 should time out"
    np.testing.assert_array_equal(tres.done.numpy(), done)
    np.testing.assert_array_equal(tres.info["time_outs"].numpy(),
                                  np.asarray(jres.info["time_outs"]))
    np.testing.assert_array_equal(tnew.terrain_levels.numpy(),
                                  np.asarray(jnew.terrain_levels))
    np.testing.assert_array_equal(tnew.env_origins.numpy(),
                                  np.asarray(jnew.env_origins))
    assert np.abs(np.asarray(jnew.contact_report)).max() > 1.0
    for name in STATE_FIELDS:
        np.testing.assert_allclose(getattr(tnew.sim, name).numpy(),
                                   np.asarray(getattr(jnew.sim, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    keep = ~done
    np.testing.assert_allclose(tnew.contact_report.numpy()[keep],
                               np.asarray(jnew.contact_report)[keep],
                               rtol=1e-3, atol=1e-2)
    if rows is not None:
        keep = keep & rows
    for field in ("obs", "privileged_obs", "rew"):
        np.testing.assert_allclose(getattr(tres, field).numpy()[keep],
                                   np.asarray(getattr(jres, field))[keep],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    assert set(jterms) == set(tterms)
    for name in jterms:
        np.testing.assert_allclose(tterms[name].numpy()[keep],
                                   np.asarray(jterms[name])[keep],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
