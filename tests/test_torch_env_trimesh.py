"""The port's Mini Cheetah env step on a trimesh grid against the JAX
package's (config_mini_cheetah, cut to 2 x 2 terrain cells of 8 m with a
5 m border and 64 envs; the terrain curriculum on).

The JAX side runs the SoA physics step eagerly under jax.disable_jit(), as
tests/test_torch_env.py does for Go1, with its column-block patch hoisted
once per step; the port looks the same cells up through its window.
config_mini_cheetah's generated grid is flat, so both envs collide with one
wavy surface instead. Observation noise is off. The draws of the terrain
level and of the reset spawn are replayed from JAX's key; the others (DR,
commands) reach only the envs that reset, which are compared on what the
replay fixes: done, level, origin and sim state.

Tolerances as tests/test_torch_env.py: 1e-4 on observations, rewards and
sim state, 1e-3/1e-2 on contact forces, 1e-6 absolute on reward terms."""

import jax
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.sampler import Sampler

# The step runs at decimation 2, not the flagship's 4: each JAX call of the
# eager SoA physics takes ~17 s here, and two calls already reuse the step's
# window.

NT = 64


class ReplaySampler(Sampler):
    """Returns the JAX env's own draws for the named streams."""

    def __init__(self, seed, draws):
        super().__init__(seed, "cpu")
        self.draws = draws

    def uniform(self, name, shape, lo, hi):
        if name in self.draws:
            return self.draws[name]
        return super().uniform(name, shape, lo, hi)

    def integers(self, name, shape, lo, hi):
        if name in self.draws:
            return self.draws[name]
        return super().integers(name, shape, lo, hi)


def _mc_cfgs():
    out = []
    for mod in (jcfg, tcfg):
        c = mod.config_mini_cheetah()
        c.env.num_envs = NT
        c.terrain.num_rows = c.terrain.num_cols = 2
        c.terrain.border_size = 5.0
        c.terrain.curriculum = True
        c.sim.physics_impl = "soa"
        c.noise.add_noise = False
        c.control.decimation = 2
        out.append(c)
    return out


def _wavy(shape, scale, border):
    """A smooth non-flat surface (+-3 cm): config_mini_cheetah's own grid
    is flat, so both envs collide with this one instead."""
    x = np.arange(shape[0]) * scale - border
    y = np.arange(shape[1]) * scale - border
    return (0.03 * np.sin(1.3 * x)[:, None]
            * np.cos(0.9 * y)[None, :]).astype(np.float32)


def _jax_draws(jenv, jstate):
    """The draws of JAX's step for the terrain level and the reset spawn
    (legged_robot.py: step's key split, _reset_sim_states)."""
    c = jenv.cfg
    _, _, _, _, k_reset, _, k_terrain = jax.random.split(jstate.key, 7)
    k1, k2, _ = jax.random.split(jax.random.split(k_reset, 3)[2], 3)
    tc = c.terrain
    lo, hi = c.init_state.dof_init_range
    u = jax.random.uniform
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return {
        "terrain/levels": t(jax.random.randint(k_terrain, (NT,), 0,
                                               tc.num_rows)),
        "reset_sim/x_init": t(u(k1, (NT,), minval=-tc.x_init_range,
                                maxval=tc.x_init_range)),
        "reset_sim/y_init": t(u(jax.random.fold_in(k1, 1), (NT,),
                                minval=-tc.y_init_range,
                                maxval=tc.y_init_range)),
        "reset_sim/dof": t(u(k2, (NT, 12), minval=lo, maxval=hi)),
    }


@pytest.fixture(scope="module")
def trimesh_step():
    """One env step in each package from one JAX initial state, prepared so that the step exercises every terrain path: envs
    0-7 time out (0-3 placed 4.5 m from their origin, so their level moves
    up), envs 8-13 sit near the terrain's edges and teleport, and every
    base stands 0.29 m above the wavy surface so the feet touch it."""
    from rapid_locomotion_rl_tpu.ops.contact import TerrainGrid as JGrid
    from rapid_locomotion_rl_tpu.ops.contact import make_col_blocks
    from rapid_locomotion_rl_tpu_torch.ops.contact import TerrainGrid
    jc, tc = _mc_cfgs()
    jenv, tenv = JEnv(jc), LeggedRobotEnv(tc, device="cpu")
    g = tenv.collision_grid
    h = _wavy(g.height.shape, g.horizontal_scale, g.border_size)
    meta = dict(horizontal_scale=g.horizontal_scale,
                border_size=g.border_size,
                static_friction=g.static_friction,
                dynamic_friction=g.dynamic_friction,
                restitution=g.restitution)
    jenv.collision_grid = JGrid(height=jax.numpy.asarray(h), **meta)
    jenv._col_blocks = make_col_blocks(jenv.collision_grid)
    tenv.collision_grid = TerrainGrid(height=torch.tensor(h), **meta)

    with jax.disable_jit():
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
    hx = torch.tensor(pos[:, 0]), torch.tensor(pos[:, 1])
    from rapid_locomotion_rl_tpu_torch.ops.contact import \
        terrain_height_bilinear
    pos[:, 2] = 0.29 + terrain_height_bilinear(tenv.collision_grid,
                                               *hx).numpy()
    jstate = jstate._replace(
        sim=jstate.sim._replace(base_pos=jax.numpy.asarray(pos)),
        episode_length=jax.numpy.asarray(ep))
    tstate = env_state_from_jax(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    a = np.random.default_rng(7).normal(0, 0.5, (NT, 12)).astype(np.float32)
    sampler = ReplaySampler(7, _jax_draws(jenv, jstate))
    with jax.disable_jit():
        jnew, jres = jenv.step(jstate, jax.numpy.asarray(a))
        jterms = jenv.reward_terms(jnew)
    tnew, tres = tenv.step(tstate, torch.tensor(a), sampler)
    return (jstate, jnew, jres, jterms), (tnew, tres, tenv.reward_terms(tnew))


def test_trimesh_dones_levels_and_origins_match(trimesh_step):
    (jold, jnew, jres, _), (tnew, tres, _) = trimesh_step
    done = np.asarray(jres.done)
    assert done[:8].all(), "envs 0-7 should time out"
    np.testing.assert_array_equal(tres.done.numpy(), done)
    np.testing.assert_array_equal(tres.info["time_outs"].numpy(),
                                  np.asarray(jres.info["time_outs"]))
    lv_old, lv = np.asarray(jold.terrain_levels), np.asarray(
        jnew.terrain_levels)
    assert (lv[:4] != lv_old[:4]).any(), "no level moved"
    np.testing.assert_array_equal(tnew.terrain_levels.numpy(), lv)
    np.testing.assert_array_equal(tnew.env_origins.numpy(),
                                  np.asarray(jnew.env_origins))
    np.testing.assert_allclose(
        tres.info["train/episode/terrain_level"].item(),
        float(jres.info["train/episode/terrain_level"]), rtol=1e-6)


def test_trimesh_sim_state_matches(trimesh_step):
    """Every env: the teleported ones and the others through the physics
    on the wavy grid, the reset ones through the replayed spawn."""
    (_, jnew, _, _), (tnew, _, _) = trimesh_step
    x = np.asarray(jnew.sim.base_pos)
    assert (x[8:11, 0] > 9.0).all() and (x[11:14, 1] < 7.0).all(), \
        "envs 8-13 should have teleported"
    assert np.abs(np.asarray(jnew.contact_report)).max() > 1.0
    for name in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                 "q", "qd"):
        np.testing.assert_allclose(
            getattr(tnew.sim, name).numpy(),
            np.asarray(getattr(jnew.sim, name)),
            rtol=1e-4, atol=1e-4, err_msg=name)
    keep = ~np.asarray(jnew.reset_buf)
    np.testing.assert_allclose(tnew.contact_report.numpy()[keep],
                               np.asarray(jnew.contact_report)[keep],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("field", ["obs", "privileged_obs", "rew"])
def test_trimesh_outputs_match(trimesh_step, field):
    """Envs that did not reset (the reset ones drew other commands and DR
    parameters)."""
    (_, _, jres, _), (_, tres, _) = trimesh_step
    keep = ~np.asarray(jres.done)
    np.testing.assert_allclose(getattr(tres, field).numpy()[keep],
                               np.asarray(getattr(jres, field))[keep],
                               rtol=1e-4, atol=1e-4)


def test_trimesh_reward_terms_match(trimesh_step):
    (_, _, jres, jterms), (_, _, tterms) = trimesh_step
    keep = ~np.asarray(jres.done)
    assert set(jterms) == set(tterms)
    for name in jterms:
        np.testing.assert_allclose(tterms[name].numpy()[keep],
                                   np.asarray(jterms[name])[keep],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
