"""Offline visualization of logged trajectories (port of the JAX package's
``utils/render.py``; the replacement for the IsaacGym viewer and camera
pipeline, reference base_task.py:79-137, legged_robot.py:1332-1355).

Rendering is decoupled from the env step: the rollout logs compact state
trajectories (base pose and joint angles of one env) and this module runs
forward kinematics on the host to draw them: shaded RGB chase-camera
frames by the rasterizer of :mod:`.raster` (the default), or a matplotlib
stick figure. GIFs land in ``<logdir>/videos/{it:05d}.gif`` like the
reference's ``videos/{it:05d}.mp4`` (ppo/__init__.py:267-286). Writing a
GIF needs Pillow; without it nothing is written and the functions return
None. Nothing else is caught: a fault of the state or the FK raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


@torch.no_grad()
def rollout_states(env, ac, env_state, sampler, steps: int = 250,
                   env_index: int = 0):
    """Roll the deterministic student policy and collect env
    ``env_index``'s poses as NumPy arrays [T, ...]: base position,
    quaternion, joint angles and env origin. The caller's state is not
    advanced (its sampler is)."""
    state = env_state
    poses = []
    for _ in range(steps):
        actions = ac.act_student(state.obs, state.obs_history)
        state, _ = env.step(state, actions, sampler)
        poses.append((state.sim.base_pos[env_index],
                      state.sim.base_quat[env_index],
                      state.sim.q[env_index], state.env_origins[env_index]))
    return tuple(torch.stack([p[i] for p in poses]).cpu().numpy()
                 for i in range(4))


def env_terrain(env):
    """The env's raw terrain heights (what height sensing reads, not the
    slope-corrected collision grid) as a TerrainGrid on the CPU, or None
    on the plane."""
    terrain = getattr(env, "terrain", None)
    if terrain is None:
        return None
    tc = env.cfg.terrain
    return terrain.as_grid(tc.static_friction, tc.dynamic_friction,
                           tc.restitution, device="cpu")


def _host_terrain(terrain):
    """The grid with its heights as a NumPy array."""
    if terrain is None or not isinstance(terrain.height, torch.Tensor):
        return terrain
    return terrain._replace(height=terrain.height.detach().cpu().numpy())


def _fk_lines(model, base_pos, base_quat, q):
    """Host-side FK -> (link line segments, collision-sphere centers+radii)."""
    from .raster import posed_frames

    p, R = posed_frames(model, base_pos, base_quat, q)
    segs = []
    for i in range(1, model.nb):
        segs.append((p[int(model.parent[i])], p[i]))
    # collision spheres (what actually touches the terrain)
    spheres = []
    for g in range(model.ng):
        b = int(model.geom_body[g])
        c = p[b] + R[b] @ np.asarray(model.geom_offset[g])
        spheres.append((c, float(model.geom_radius[g])))
        if np.asarray(model.geom_offset[g])[2] < -0.15:
            segs.append((p[b], c))
    return segs, spheres


def _terrain_patch(terrain, cx, cy, half=0.8, max_pts=24):
    """Local terrain surface around (cx, cy) from a TerrainGrid
    (world x,y -> grid via (x + border)/scale, ops/contact.py)."""
    h = np.asarray(_host_terrain(terrain).height)
    s = float(terrain.horizontal_scale)
    b = float(terrain.border_size)
    i0 = int(np.clip(np.floor((cx - half + b) / s), 0, h.shape[0] - 2))
    i1 = int(np.clip(np.ceil((cx + half + b) / s), i0 + 1, h.shape[0] - 1))
    j0 = int(np.clip(np.floor((cy - half + b) / s), 0, h.shape[1] - 2))
    j1 = int(np.clip(np.ceil((cy + half + b) / s), j0 + 1, h.shape[1] - 1))
    step = max(1, (i1 - i0) // max_pts, (j1 - j0) // max_pts)
    ii = np.arange(i0, i1 + 1, step)
    jj = np.arange(j0, j1 + 1, step)
    X = ii[:, None] * s - b + np.zeros_like(jj)[None, :]
    Y = np.zeros_like(ii)[:, None] + jj[None, :] * s - b
    return X, Y, h[np.ix_(ii, jj)]


def render_trajectory(model, pos, quat, q, origin, out_path: str,
                      fps: int = 25, stride: int = 2,
                      title: Optional[str] = None,
                      terrain=None, marker=None,
                      view_half: float = 0.6,
                      style: str = "rgb") -> Optional[str]:
    """Render a camera-style GIF of the logged trajectory: the parity
    artifact for the reference's camera frames (legged_robot.py:1332-1355).

    style="rgb" (default) uses the z-buffered software rasterizer
    (:mod:`.raster`): shaded RGB chase-camera frames of the robot's
    collision geometry and terrain. style="stick" draws the matplotlib
    stick figure; the rgb style falls back to it when it wrote nothing.
    Returns the path written, or None without Pillow (or matplotlib, for
    the stick figure)."""
    terrain = _host_terrain(terrain)
    pos, quat, q, origin = (np.asarray(a) for a in (pos, quat, q, origin))
    if style == "rgb":
        from .raster import render_trajectory_rgb
        got = render_trajectory_rgb(
            model, pos, quat, q, out_path, terrain=terrain, fps=fps,
            stride=stride, marker=marker,
            cam_scale=max(1.0, view_half / 0.6))
        if got:
            return got
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
        import PIL  # noqa: F401  (the GIF writer)
    except ImportError as e:
        print(f"[render] matplotlib or pillow unavailable: {e}")
        return None

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    idx = np.arange(0, len(pos), stride)
    fig = plt.figure(figsize=(6, 4))
    ax = fig.add_subplot(projection="3d")

    def draw(k):
        ax.cla()
        i = idx[k]
        segs, spheres = _fk_lines(model, pos[i], quat[i], q[i])
        c = pos[i]
        z0 = origin[i][2] if origin.ndim > 1 else 0.0
        if terrain is not None:
            X, Y, Z = _terrain_patch(terrain, float(c[0]), float(c[1]))
            ax.plot_surface(X, Y, Z, alpha=0.35, cmap="terrain",
                            linewidth=0, antialiased=False)
            z0 = float(np.min(Z))
        for a, b in segs:
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                    "-", color="tab:blue", lw=2)
        if spheres:
            sc = np.asarray([s[0] for s in spheres])
            sr = np.asarray([s[1] for s in spheres])
            ax.scatter(sc[:, 0], sc[:, 1], sc[:, 2],
                       s=(sr * 250) ** 1.5, color="tab:orange", alpha=0.7)
        ax.scatter(*c, color="tab:red", s=25)
        if marker is not None:
            # e.g. the HLP navigation goal
            ax.scatter(marker[0], marker[1], marker[2], color="tab:green",
                       s=120, marker="*")
        ax.set_xlim(c[0] - view_half, c[0] + view_half)
        ax.set_ylim(c[1] - view_half, c[1] + view_half)
        ax.set_zlim(z0, z0 + max(0.8, view_half * 0.7))
        if title:
            ax.set_title(title)

    anim = animation.FuncAnimation(fig, draw, frames=len(idx))
    try:
        anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    finally:
        plt.close(fig)
    return out_path
