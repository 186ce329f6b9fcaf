"""The port's renderer and the pose log it draws from, against the JAX
package's.

- FK (``ops/dynamics.py``: ``fk``, ``geom_world_positions``) on Go1 and
  Mini Cheetah poses made with numpy from a seed, against the JAX
  package's ``dynamics.fk`` at rtol/atol 1e-5, one robot and a batch.
- ``render_frame_rgb`` of one pose in each package: both rasterize the
  same triangles, posed by float32 FK that agrees only to rounding, so a
  few edge pixels may flip; >= 99.9% of the pixels are equal.
- ``render_trajectory`` writes GIFs (the counterparts of
  tests/test_render.py), in the rgb and the stick-figure style, from a
  terrain whose heights are a torch tensor.
- The rollout's ``_render/*`` pose log holds env 0's pose after each
  step, ``rollout_states`` collects one env's poses without advancing the
  caller's state, and the Runner keeps the last 10 rollouts' logs and
  renders them to ``videos/{it:05d}.gif``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops import dynamics as JD
from rapid_locomotion_rl_tpu.ops.contact import TerrainGrid as JGrid
from rapid_locomotion_rl_tpu.utils import raster as JR
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops import dynamics as TD
from rapid_locomotion_rl_tpu_torch.ops.contact import TerrainGrid
from rapid_locomotion_rl_tpu_torch.utils import raster as TR
from rapid_locomotion_rl_tpu_torch.utils.render import render_trajectory
from torch_port_helpers import GO1, MC

STAND = np.array([0.0, -0.8, 1.62] * 4)


def _poses(model, n, seed):
    """States inside the joint limits, numpy float32 [n, ...]."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(model.dof_lower), np.asarray(model.dof_upper)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    s = dict(base_pos=rng.uniform(-2, 2, (n, 3)), base_quat=quat,
             base_lin_vel=rng.normal(0, 1, (n, 3)),
             base_ang_vel=rng.normal(0, 1, (n, 3)),
             q=lo + (hi - lo) * rng.uniform(0, 1, (n, model.nv)),
             qd=rng.uniform(-5, 5, (n, model.nv)))
    return {k: v.astype(np.float32) for k, v in s.items()}


@pytest.mark.parametrize("urdf", [GO1, MC], ids=["go1", "mini_cheetah"])
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_fk_matches_jax(urdf, batched):
    jm, tm = jload_urdf(urdf), load_urdf(urdf)
    s = _poses(tm, 8, 3)
    if batched:
        jf = jax.vmap(lambda st: JD.fk(jm, st))(
            JD.SimState(**{k: jnp.asarray(v) for k, v in s.items()}))
        jg = jax.vmap(lambda f: JD.geom_world_positions(jm, f))(jf)
    else:
        s = {k: v[0] for k, v in s.items()}
        jf = JD.fk(jm, JD.SimState(**{k: jnp.asarray(v)
                                       for k, v in s.items()}))
        jg = JD.geom_world_positions(jm, jf)
    tf = TD.fk(tm, TD.SimState(**{k: torch.tensor(v) for k, v in s.items()}))
    tg = TD.geom_world_positions(tm, tf)
    for name in TD.BodyFrames._fields:
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert tf.p.shape[-2] == tm.nb and tg[0].shape[-2] == tm.ng


def _grids(n=60):
    h = np.zeros((n, n), np.float32)
    h[n // 2:, :] = 0.08                  # a step edge in frame
    kw = dict(horizontal_scale=0.05, border_size=1.0, static_friction=1.0,
              dynamic_friction=1.0, restitution=0.0)
    return JGrid(height=h, **kw), TerrainGrid(height=torch.tensor(h), **kw)


@pytest.mark.parametrize("terrain", [True, False], ids=["terrain", "plane"])
def test_frame_matches_jax(terrain):
    jm, tm = jload_urdf(MC), load_urdf(MC)
    jg, tg = _grids() if terrain else (None, None)
    rng = np.random.default_rng(5)
    lo, hi = np.asarray(tm.dof_lower), np.asarray(tm.dof_upper)
    q = lo + (hi - lo) * rng.uniform(0.2, 0.8, tm.nv)
    quat = np.array([0.05, -0.03, 0.2, 1.0])
    quat /= np.linalg.norm(quat)
    pose = ([0.3, 0.3, 0.32], quat, q)
    a = JR.render_frame_rgb(jm, *pose, terrain=jg, width=160, height=120)
    b = TR.render_frame_rgb(tm, *pose, terrain=tg, width=160, height=120)
    assert a.shape == b.shape == (120, 160, 3) and b.dtype == np.uint8
    same = (a == b).all(-1).mean()
    assert same >= 0.999, same
    orange = ((b[..., 0] > 140) & (b[..., 1] > 60) & (b[..., 2] < 120)).sum()
    assert orange > 30, f"robot pixels missing ({orange})"


def _clip(T, x0=0.0):
    pos = np.tile([x0, 0.0, 0.3], (T, 1))
    pos[:, 0] += np.linspace(0, 0.2, T)   # frames must differ
    return (pos, np.tile([0, 0, 0, 1.0], (T, 1)), np.tile(STAND, (T, 1)),
            np.zeros((T, 3)))


@pytest.mark.parametrize("style", ["rgb", "stick"])
def test_render_trajectory_with_terrain(tmp_path, style):
    out = str(tmp_path / "clip.gif")
    got = render_trajectory(load_urdf(MC), *_clip(4), out, stride=1,
                            terrain=_grids(40)[1], style=style)
    assert got == out and os.path.getsize(out) > 4_000


def test_render_trajectory_no_terrain(tmp_path):
    out = str(tmp_path / "clip.gif")
    got = render_trajectory(load_urdf(MC), *_clip(3), out, stride=1)
    assert got == out and os.path.getsize(out) > 2_000


def test_raster_rgb_frame_and_gif(tmp_path):
    from PIL import Image
    m = load_urdf(MC)
    grid = _grids()[1]
    img = TR.render_frame_rgb(m, [0.3, 0.3, 0.3], [0, 0, 0, 1.0], STAND,
                              terrain=grid, width=160, height=120)
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert img.std() > 10.0
    pos, quat, q, _ = _clip(3, 0.3)
    pos[:, 1] = 0.3
    out = str(tmp_path / "rgb.gif")
    got = TR.render_trajectory_rgb(m, pos, quat, q, out, terrain=grid,
                                   stride=1, width=160, height=120)
    assert got == out and os.path.getsize(out) > 2_000
    assert Image.open(out).n_frames == 3


def _small_env(n=4):
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    cfg = config_mini_cheetah()
    cfg.env.num_envs = n
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    cfg.control.decimation = 1
    cfg.sim.num_substeps = 1
    return LeggedRobotEnv(cfg, device="cpu")


def test_rollout_logs_env0_pose():
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = _small_env()
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs())
    sampler = Sampler(0, "cpu")
    s0 = env.initial_state(sampler)
    T = 3
    s, traj, info = rollout(env, ac, PPOArgs(), s0, sampler, T)
    want = {"pos": (T, 3), "quat": (T, 4), "q": (T, env.num_dof),
            "origin": (T, 3)}
    assert {k for k in info if k.startswith("_render/")} == {
        f"_render/{k}" for k in want}
    for k, shape in want.items():
        assert tuple(info[f"_render/{k}"].shape) == shape, k
    assert torch.equal(info["_render/pos"][-1], s.sim.base_pos[0])
    assert torch.equal(info["_render/quat"][-1], s.sim.base_quat[0])
    assert torch.equal(info["_render/q"][-1], s.sim.q[0])
    assert torch.equal(info["_render/origin"][0], s0.env_origins[0])
    # the pose moves: each row is its own step's
    assert (info["_render/q"][0] != info["_render/q"][-1]).any()


def test_rollout_states_leaves_the_state():
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from rapid_locomotion_rl_tpu_torch.utils.render import rollout_states
    env = _small_env()
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs())
    sampler = Sampler(0, "cpu")
    s0 = env.initial_state(sampler)
    q0 = s0.sim.q.clone()
    pos, quat, q, origin = rollout_states(env, ac, s0, sampler, steps=2,
                                          env_index=1)
    assert (pos.shape, quat.shape, q.shape, origin.shape) == (
        (2, 3), (2, 4), (2, env.num_dof), (2, 3))
    assert torch.equal(s0.sim.q, q0)
    np.testing.assert_array_equal(origin[0], s0.env_origins[1].numpy())
    assert np.isfinite(q).all() and (q[1] != q0[1].numpy()).any()


def test_runner_video_ring_buffer(tmp_path):
    """_log_iteration keeps the last 10 rollouts' pose logs (and logs no
    ``_render/*`` key); _log_video renders them to videos/{it:05d}.gif."""
    from rapid_locomotion_rl_tpu_torch.learn.runner import Runner
    runner = Runner(_small_env(), logdir=str(tmp_path))
    nv = runner.env.num_dof
    for it in range(12):
        pos = torch.zeros(2, 3)
        pos[:, 0] = it
        pos[:, 2] = 0.3
        runner._log_iteration(it, {
            "_render/pos": pos,
            "_render/quat": torch.tensor([[0, 0, 0, 1.0]] * 2),
            "_render/q": torch.tensor(np.tile(STAND, (2, 1)),
                                      dtype=torch.float32),
            "_render/origin": torch.zeros(2, 3),
            "mean_reward": torch.tensor(0.5)})
        assert not any(k.startswith("_render/")
                       for k in runner.last_metrics)
    buf = runner._pose_buffer
    assert len(buf) == 10 and [b[0][0, 0] for b in buf] == list(
        range(2, 12))
    assert buf[0][2].shape == (2, nv)
    runner._log_video(7)
    assert (tmp_path / "videos" / "00007.gif").stat().st_size > 2_000
