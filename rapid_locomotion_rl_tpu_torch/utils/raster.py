"""Z-buffered software rasterizer: RGB camera frames drawn on the host.

Port of the JAX package's ``utils/raster.py``. The reference attaches
IsaacGym camera sensors to env 0 and writes the frames out as
``videos/<it>.mp4`` (reference legged_robot.py:1301-1355,
base_task.py:113-137). Here a small perspective renderer (look-at camera,
Lambert + head-light shading, per-pixel z-buffer) draws triangle meshes
built from the sim's own geometry: the terrain height grid and the robot's
collision spheres and link capsules, posed by :func:`..ops.dynamics.fk`
on the CPU. Pure NumPy otherwise; a 320x240 frame with a few thousand
triangles rasterizes in well under a second. Writing a GIF needs Pillow.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# mesh builders


@lru_cache(maxsize=4)
def icosphere(subdiv: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (vertices [n,3], faces [m,3]) by midpoint
    subdivision of an icosahedron."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    V = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        verts = list(V)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        newF = []
        for a, b, c in F:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newF += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V = np.asarray(verts)
        F = np.asarray(newF, np.int64)
    return V, F


def capsule_mesh(a: np.ndarray, b: np.ndarray, radius: float,
                 segments: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Closed cylinder from a to b (the link bone); end caps are the
    joint spheres drawn separately, so flat disks suffice."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    axis = b - a
    L = np.linalg.norm(axis)
    if L < 1e-9:
        V, F = icosphere(0)
        return V * radius + a, F
    axis = axis / L
    ref = np.array([0.0, 0.0, 1.0])
    if abs(axis @ ref) > 0.9:
        ref = np.array([1.0, 0.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v) * radius
    V = np.concatenate([ring + a, ring + b, [a], [b]])
    ia, ib = 2 * segments, 2 * segments + 1
    F = []
    for k in range(segments):
        k2 = (k + 1) % segments
        F += [[k, k2, segments + k], [k2, segments + k2, segments + k],
              [k2, k, ia], [segments + k, segments + k2, ib]]
    return V, np.asarray(F, np.int64)


def terrain_mesh(X: np.ndarray, Y: np.ndarray, Z: np.ndarray,
                 checker: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Height-grid patch -> (V, F, per-face base colors). A subtle
    checker over world x/y keeps ego-motion visible on flat ground."""
    nx, ny = Z.shape
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    idx = np.arange(nx * ny).reshape(nx, ny)
    c00, c10 = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c01, c11 = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([c00, c10, c11], 1),
                        np.stack([c00, c11, c01], 1)])
    centers = V[F].mean(axis=1)
    par = (np.floor(centers[:, 0] / checker)
           + np.floor(centers[:, 1] / checker)) % 2
    base = np.array([0.55, 0.47, 0.36])
    alt = np.array([0.47, 0.40, 0.31])
    colors = np.where(par[:, None] > 0.5, alt[None], base[None])
    return V, F, colors


# ---------------------------------------------------------------------------
# camera + rasterization


def look_at(eye: np.ndarray, target: np.ndarray,
            up=(0.0, 0.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera rotation/translation; camera looks down +z."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def rasterize(V: np.ndarray, F: np.ndarray, colors: np.ndarray,
              R: np.ndarray, t: np.ndarray, width: int = 320,
              height: int = 240, fov_deg: float = 55.0,
              light=(0.35, -0.25, 0.9), ambient: float = 0.42,
              background=(0.74, 0.82, 0.90)) -> np.ndarray:
    """Flat-shaded z-buffer raster of one triangle soup -> uint8 RGB.

    Vectorized over triangles: perspective-correct depth per pixel via
    barycentrics evaluated on each triangle's bounding-box patch (the
    patches are small, so the per-triangle Python loop touches a few
    hundred pixels each)."""
    Vc = V @ R.T + t
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    cxy = np.array([width / 2.0, height / 2.0])

    tri = Vc[F]                                    # [m,3,3] camera space
    # face normals + lighting in camera space
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=1)
    ok = nn > 1e-12
    n = n / np.maximum(nn, 1e-12)[:, None]
    lightc = R @ (np.asarray(light) / np.linalg.norm(light))
    lam = np.abs(n @ lightc)                       # double-sided
    shade = np.clip(ambient + (1 - ambient) * lam, 0, 1)
    fcol = np.clip(colors * shade[:, None], 0, 1)

    # project (cull triangles with any vertex behind the near plane)
    z = tri[..., 2]
    ok &= np.all(z > 0.05, axis=1)
    xy = tri[..., :2] / np.maximum(z[..., None], 1e-6) * f + cxy
    img = np.ones((height, width, 3)) * np.asarray(background)
    zbuf = np.full((height, width), np.inf)

    x0 = np.clip(np.floor(xy[..., 0].min(1)), 0, width - 1).astype(int)
    x1 = np.clip(np.ceil(xy[..., 0].max(1)), 0, width - 1).astype(int)
    y0 = np.clip(np.floor(xy[..., 1].min(1)), 0, height - 1).astype(int)
    y1 = np.clip(np.ceil(xy[..., 1].max(1)), 0, height - 1).astype(int)
    ok &= (x1 > x0) & (y1 > y0)

    order = np.argsort(z.mean(1))                  # front-ish first: most
    for i in order:                                # later pixels fail ztest
        if not ok[i]:
            continue
        a, b, c = xy[i]
        d = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(d) < 1e-9:
            continue
        gx, gy = np.meshgrid(np.arange(x0[i], x1[i] + 1),
                             np.arange(y0[i], y1[i] + 1))
        px, py = gx + 0.5, gy + 0.5
        w0 = ((b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])) / d
        w1 = ((a[0] - c[0]) * (py - c[1]) - (a[1] - c[1]) * (px - c[0])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z with SCREEN barys
        iz = (w2 / z[i, 0] + w1 / z[i, 1] + w0 / z[i, 2])
        depth = 1.0 / np.maximum(iz, 1e-9)
        ys, xs = gy[inside], gx[inside]
        dsel = depth[inside]
        closer = dsel < zbuf[ys, xs]
        ys, xs, dsel = ys[closer], xs[closer], dsel[closer]
        zbuf[ys, xs] = dsel
        img[ys, xs] = fcol[i]
    return (img * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# scene assembly


def posed_frames(model, base_pos, base_quat, q):
    """Body origins [nb,3] and rotations [nb,3,3] (NumPy) of one robot
    pose, by the port's FK on the CPU in float32."""
    import torch

    from ..ops.dynamics import SimState, fk

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    z3 = torch.zeros(3)
    state = SimState(base_pos=f(base_pos), base_quat=f(base_quat),
                     base_lin_vel=z3, base_ang_vel=z3, q=f(q),
                     qd=torch.zeros(model.nv))
    frames = fk(model, state)
    return frames.p.numpy(), frames.R.numpy()


def robot_mesh(model, base_pos, base_quat, q, color=(0.82, 0.45, 0.15),
               joint_color=(0.25, 0.35, 0.55)):
    """Triangle soup of one posed robot: collision spheres (icospheres)
    at their FK world placements + capsule bones parent->child."""
    p, Rb = posed_frames(model, base_pos, base_quat, q)
    sv, sf = icosphere(1)
    parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for g in range(model.ng):
        b = int(model.geom_body[g])
        c = p[b] + Rb[b] @ np.asarray(model.geom_offset[g])
        r = float(model.geom_radius[g])
        parts.append((sv * r + c, sf,
                      np.tile(color, (len(sf), 1))))
    for i in range(1, model.nb):
        a, b = p[int(model.parent[i])], p[i]
        if np.linalg.norm(b - a) < 1e-6:
            continue
        cv, cf = capsule_mesh(a, b, 0.016)
        parts.append((cv, cf, np.tile(joint_color, (len(cf), 1))))
    return _merge(parts)


def _merge(parts):
    Vs, Fs, Cs, off = [], [], [], 0
    for V, F, C in parts:
        Vs.append(V)
        Fs.append(F + off)
        Cs.append(C)
        off += len(V)
    return (np.concatenate(Vs), np.concatenate(Fs), np.concatenate(Cs))


def render_frame_rgb(model, base_pos, base_quat, q, terrain=None,
                     width: int = 320, height: int = 240,
                     cam_offset=(-0.9, -0.7, 0.55), cam_scale: float = 1.0,
                     marker: Optional[np.ndarray] = None) -> np.ndarray:
    """One camera frame: chase camera behind-left of the base, terrain
    patch + posed robot (+ optional goal marker pillar)."""
    from .render import _terrain_patch

    cam_offset = tuple(o * cam_scale for o in cam_offset)
    parts = [robot_mesh(model, base_pos, base_quat, q)]
    c = np.asarray(base_pos, np.float64)
    if terrain is not None:
        X, Y, Z = _terrain_patch(terrain, float(c[0]), float(c[1]),
                                 half=1.6 * cam_scale, max_pts=40)
        parts.append(terrain_mesh(X, Y, Z))
    else:
        g = np.arange(-1.6, 1.7, 0.4)
        X, Y = np.meshgrid(c[0] + g, c[1] + g, indexing="ij")
        parts.append(terrain_mesh(X, Y, np.zeros_like(X)))
    if marker is not None:
        m = np.asarray(marker, np.float64)
        mv, mf = capsule_mesh(m, m + [0, 0, 0.5], 0.05)
        parts.append((mv, mf, np.tile((0.1, 0.65, 0.2), (len(mf), 1))))
    V, F, C = _merge(parts)
    eye = c + np.asarray(cam_offset)
    R, t = look_at(eye, c + [0.15, 0.0, -0.05])
    return rasterize(V, F, C, R, t, width, height)


def render_trajectory_rgb(model, pos, quat, q, out_path: str,
                          terrain=None, fps: int = 25, stride: int = 2,
                          width: int = 320, height: int = 240,
                          marker=None, cam_scale: float = 1.0
                          ) -> Optional[str]:
    """Rasterize a logged trajectory into an animated GIF (the drop-in
    RGB upgrade of render.render_trajectory; same calling shape)."""
    try:
        from PIL import Image
    except ImportError as e:
        print(f"[raster] pillow unavailable: {e}")
        return None
    import os
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    frames = []
    for i in range(0, len(pos), stride):
        arr = render_frame_rgb(model, pos[i], quat[i], q[i],
                               terrain=terrain, width=width, height=height,
                               marker=marker, cam_scale=cam_scale)
        frames.append(Image.fromarray(arr))
    if not frames:
        return None
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return out_path
