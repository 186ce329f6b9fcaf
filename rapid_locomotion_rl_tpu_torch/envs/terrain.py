"""Procedural terrain generation (host-side NumPy, init-time only).

The port's own copy of the JAX package's ``envs/terrain.py``: the same
generators drawing from one ``np.random.RandomState`` in the same order, so
the same seed gives the same ``height_field_raw`` and ``env_origins``. Only
the export differs: :meth:`Terrain.as_grid` and
:meth:`Terrain.as_collision_grid` return the port's
:class:`~rapid_locomotion_rl_tpu_torch.ops.contact.TerrainGrid` with the
heights as a float32 torch tensor on a given device.

Layout: a [tot_rows, tot_cols] int16 grid in ``vertical_scale`` units, cells
of ``terrain_length x terrain_width`` meters arranged rows x cols inside a
border, train rows first and eval rows appended along axis 0; per-cell env
origins at the cell center with z = max height of the cell.

The generators re-create the published terrain families (sloped pyramid,
rough slope, stairs, discrete obstacles, stepping stones, uniform noise)
from their behavioral spec.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SubTerrain:
    def __init__(self, width: int, length: int, vertical_scale: float,
                 horizontal_scale: float):
        self.width = width          # pixels along x
        self.length = length        # pixels along y
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(terrain: SubTerrain, min_height: float,
                           max_height: float, step: float = 0.005,
                           downsampled_scale: float = 0.2,
                           rng: Optional[np.random.RandomState] = None):
    """Uniform height noise drawn on a coarse grid and upsampled."""
    rng = rng or np.random
    lo = int(min_height / terrain.vertical_scale)
    hi = int(max_height / terrain.vertical_scale)
    step_i = max(int(step / terrain.vertical_scale), 1)
    levels = np.arange(lo, hi + step_i, step_i)
    ds = max(int(downsampled_scale / terrain.horizontal_scale), 1)
    coarse_w = terrain.width // ds + 2
    coarse_l = terrain.length // ds + 2
    coarse = rng.choice(levels, size=(coarse_w, coarse_l))
    # nearest-neighbor upsample then crop
    up = np.repeat(np.repeat(coarse, ds, axis=0), ds, axis=1)
    terrain.height_field_raw += up[: terrain.width, : terrain.length].astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain: SubTerrain, slope: float,
                           platform_size: float = 1.0):
    """Pyramid rising toward the center with the given slope; a flat platform
    of ``platform_size`` meters caps the middle."""
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = (terrain.width - 1) / 2, (terrain.length - 1) / 2
    # normalized distance-to-edge ramp in [0, 1]
    fx = 1.0 - np.abs(x - cx) / cx
    fy = 1.0 - np.abs(y - cy) / cy
    ramp = np.minimum(fx[:, None], fy[None, :])
    max_h = slope * (terrain.width / 2) * terrain.horizontal_scale
    hf = (ramp * max_h / terrain.vertical_scale).astype(np.int16)
    # flat center platform at the pyramid apex height
    half_plat = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = int(cx) - half_plat, int(cx) + half_plat
    y1, y2 = int(cy) - half_plat, int(cy) + half_plat
    apex = hf[x1:x2, y1:y2].max() if slope >= 0 else hf[x1:x2, y1:y2].min()
    hf[x1:x2, y1:y2] = apex
    terrain.height_field_raw += hf
    return terrain


def pyramid_stairs_terrain(terrain: SubTerrain, step_width: float,
                           step_height: float, platform_size: float = 1.0):
    """Concentric square steps toward the center."""
    step_w = int(step_width / terrain.horizontal_scale)
    step_h = int(step_height / terrain.vertical_scale)
    half_plat = int(platform_size / terrain.horizontal_scale / 2)
    hf = terrain.height_field_raw
    height = 0
    x1, x2 = 0, terrain.width
    y1, y2 = 0, terrain.length
    while (x2 - x1) > 2 * half_plat and (y2 - y1) > 2 * half_plat:
        x1 += step_w
        x2 -= step_w
        y1 += step_w
        y2 -= step_w
        height += step_h
        hf[x1:x2, y1:y2] = height
    return terrain


def discrete_obstacles_terrain(terrain: SubTerrain, max_height: float,
                               min_size: float, max_size: float,
                               num_rects: int, platform_size: float = 1.0,
                               rng: Optional[np.random.RandomState] = None):
    """Random rectangular blocks at +-max_height around zero."""
    rng = rng or np.random
    h_i = int(max_height / terrain.vertical_scale)
    heights = [-h_i, -h_i // 2, h_i // 2, h_i]
    min_i = int(min_size / terrain.horizontal_scale)
    max_i = int(max_size / terrain.horizontal_scale)
    for _ in range(num_rects):
        w = rng.randint(min_i, max_i + 1)
        l = rng.randint(min_i, max_i + 1)
        x = rng.randint(0, max(terrain.width - w, 1))
        y = rng.randint(0, max(terrain.length - l, 1))
        terrain.height_field_raw[x:x + w, y:y + l] = rng.choice(heights)
    # clear center platform
    cx, cy = terrain.width // 2, terrain.length // 2
    half = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - half:cx + half, cy - half:cy + half] = 0
    return terrain


def stepping_stones_terrain(terrain: SubTerrain, stone_size: float,
                            stone_distance: float, max_height: float,
                            platform_size: float = 1.0,
                            depth: float = -10.0,
                            rng: Optional[np.random.RandomState] = None):
    """Grid of stones over a pit."""
    rng = rng or np.random
    stone_i = max(int(stone_size / terrain.horizontal_scale), 1)
    dist_i = int(stone_distance / terrain.horizontal_scale)
    h_i = int(max_height / terrain.vertical_scale)
    pit = int(depth / terrain.vertical_scale)
    terrain.height_field_raw[:] = pit
    y = 0
    while y < terrain.length:
        x = rng.randint(0, stone_i) - stone_i
        while x < terrain.width:
            x2 = min(x + stone_i, terrain.width)
            y2 = min(y + stone_i, terrain.length)
            h = rng.randint(-h_i, h_i + 1) if h_i > 0 else 0
            terrain.height_field_raw[max(x, 0):x2, y:y2] = h
            x += stone_i + dist_i
        y += stone_i + dist_i
    cx, cy = terrain.width // 2, terrain.length // 2
    half = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - half:cx + half, cy - half:cy + half] = 0
    return terrain


class Terrain:
    """Builds the full height grid + per-cell env origins from a TerrainCfg
    (reference mini_gym/utils/terrain.py:13-41), supporting an optional eval
    config whose rows are appended after the train rows (:43-57)."""

    def __init__(self, cfg, num_robots: int, eval_cfg=None,
                 num_eval_robots: int = 0, seed: int = 0):
        self.cfg = cfg
        self.eval_cfg = eval_cfg
        self.rng = np.random.RandomState(seed)
        self.type = cfg.mesh_type
        if self.type in ("none", "plane"):
            return

        self._load_cfg(cfg)
        cfg.x_offset = 0
        cfg.rows_offset = 0
        if eval_cfg is not None:
            self._load_cfg(eval_cfg)
            eval_cfg.x_offset = cfg.tot_rows
            eval_cfg.rows_offset = cfg.num_rows
            self.tot_rows = cfg.tot_rows + eval_cfg.tot_rows
            self.tot_cols = max(cfg.tot_cols, eval_cfg.tot_cols)
        else:
            self.tot_rows = cfg.tot_rows
            self.tot_cols = cfg.tot_cols

        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols),
                                         dtype=np.int16)
        self._initialize(cfg)
        if eval_cfg is not None:
            self._initialize(eval_cfg)
        self.heightsamples = self.height_field_raw

    # -- helpers ---------------------------------------------------------
    def _load_cfg(self, cfg):
        cfg.proportions = [sum(cfg.terrain_proportions[: i + 1])
                           for i in range(len(cfg.terrain_proportions))]
        cfg.num_sub_terrains = cfg.num_rows * cfg.num_cols
        cfg.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
        cfg.width_per_env_pixels = int(cfg.terrain_length / cfg.horizontal_scale)
        cfg.length_per_env_pixels = int(cfg.terrain_width / cfg.horizontal_scale)
        cfg.border = int(cfg.border_size / cfg.horizontal_scale)
        cfg.tot_cols = int(cfg.num_cols * cfg.width_per_env_pixels) + 2 * cfg.border
        cfg.tot_rows = int(cfg.num_rows * cfg.length_per_env_pixels) + 2 * cfg.border

    def _initialize(self, cfg):
        if cfg.curriculum:
            for j in range(cfg.num_cols):
                for i in range(cfg.num_rows):
                    difficulty = i / cfg.num_rows * cfg.difficulty_scale
                    choice = j / cfg.num_cols + 0.001
                    t = self.make_terrain(cfg, choice, difficulty)
                    self.add_terrain_to_map(cfg, t, i, j)
        elif cfg.selected:
            # single chosen generator for every sub-terrain (reference
            # selected_terrain, terrain.py:104-117 — eval(type)(**kwargs);
            # here a registry lookup instead of eval)
            kwargs = dict(cfg.terrain_kwargs or {})
            name = kwargs.pop("type")
            gen = {
                "random_uniform_terrain": random_uniform_terrain,
                "pyramid_sloped_terrain": pyramid_sloped_terrain,
                "pyramid_stairs_terrain": pyramid_stairs_terrain,
                "discrete_obstacles_terrain": discrete_obstacles_terrain,
                "stepping_stones_terrain": stepping_stones_terrain,
            }[name.split(".")[-1]]
            import inspect
            if "rng" in inspect.signature(gen).parameters:
                kwargs.setdefault("rng", self.rng)
            for k in range(cfg.num_sub_terrains):
                i, j = np.unravel_index(k, (cfg.num_rows, cfg.num_cols))
                t = SubTerrain(cfg.width_per_env_pixels,
                               cfg.width_per_env_pixels,
                               cfg.vertical_scale, cfg.horizontal_scale)
                gen(t, **kwargs)
                self.add_terrain_to_map(cfg, t, i, j)
        else:
            for k in range(cfg.num_sub_terrains):
                i, j = np.unravel_index(k, (cfg.num_rows, cfg.num_cols))
                choice = self.rng.uniform(0, 1)
                difficulty = self.rng.choice([0.5, 0.75, 0.9])
                t = self.make_terrain(cfg, choice, difficulty)
                self.add_terrain_to_map(cfg, t, i, j)

    def make_terrain(self, cfg, choice: float, difficulty: float) -> SubTerrain:
        """8-way proportional terrain choice (reference terrain.py:119-164)."""
        t = SubTerrain(cfg.width_per_env_pixels, cfg.width_per_env_pixels,
                       cfg.vertical_scale, cfg.horizontal_scale)
        p = cfg.proportions + [float("inf")] * (10 - len(cfg.proportions))
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        obstacle_height = 0.05 + difficulty * (cfg.max_platform_height - 0.05)
        stone_size = 1.5 * (1.05 - difficulty)
        stone_distance = 0.05 if difficulty == 0 else 0.1
        if choice < p[0]:
            if choice < p[0] / 2:
                slope = -slope
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
        elif choice < p[1]:
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
            random_uniform_terrain(t, -0.05, 0.05, step=cfg.terrain_smoothness,
                                   downsampled_scale=0.2, rng=self.rng)
        elif choice < p[3]:
            if choice < p[2]:
                step_height = -step_height
            pyramid_stairs_terrain(t, step_width=0.31, step_height=step_height,
                                   platform_size=3.0)
        elif choice < p[4]:
            discrete_obstacles_terrain(t, obstacle_height, 1.0, 2.0, 20,
                                       platform_size=3.0, rng=self.rng)
        elif choice < p[5]:
            stepping_stones_terrain(t, stone_size=stone_size,
                                    stone_distance=stone_distance,
                                    max_height=0.0, platform_size=4.0,
                                    rng=self.rng)
        elif choice < p[6]:
            pass
        elif choice < p[7]:
            pass
        elif choice < p[8]:
            random_uniform_terrain(t, -cfg.terrain_noise_magnitude,
                                   cfg.terrain_noise_magnitude, step=0.005,
                                   downsampled_scale=0.2, rng=self.rng)
        elif choice < p[9]:
            random_uniform_terrain(t, -0.05, 0.05, step=cfg.terrain_smoothness,
                                   downsampled_scale=0.2, rng=self.rng)
            t.height_field_raw[: t.length // 2, :] = 0
        return t

    def add_terrain_to_map(self, cfg, terrain: SubTerrain, row: int, col: int):
        i, j = row, col
        sx = cfg.border + i * cfg.length_per_env_pixels + cfg.x_offset
        ex = sx + cfg.length_per_env_pixels
        sy = cfg.border + j * cfg.width_per_env_pixels
        ey = sy + cfg.width_per_env_pixels
        self.height_field_raw[sx:ex, sy:ey] = terrain.height_field_raw

        env_origin_x = (i + 0.5) * cfg.terrain_length + cfg.x_offset * terrain.horizontal_scale
        env_origin_y = (j + 0.5) * cfg.terrain_width
        env_origin_z = (self.height_field_raw[sx:ex, sy:ey].max()
                        * terrain.vertical_scale)
        cfg.env_origins[i, j] = [env_origin_x, env_origin_y, env_origin_z]

    # -- export ----------------------------------------------------------
    def as_grid(self, static_friction: float, dynamic_friction: float,
                restitution: float, device="cuda"):
        """The heights (meters, float32) as a contact TerrainGrid."""
        from ..ops.contact import TerrainGrid
        h = torch.as_tensor(self.height_field_raw.astype(np.float32),
                            device=device) * self.cfg.vertical_scale
        return TerrainGrid(
            height=h,
            horizontal_scale=self.cfg.horizontal_scale,
            border_size=self.cfg.border_size,
            static_friction=static_friction,
            dynamic_friction=dynamic_friction,
            restitution=restitution,
        )

    def as_collision_grid(self, static_friction: float,
                          dynamic_friction: float, restitution: float,
                          upsample: int, slope_threshold: float,
                          device="cuda"):
        """Collision grid with the slope-threshold WALL correction of a
        trimesh upload: transitions steeper than ``slope_threshold`` become
        (near-)vertical faces instead of the bilinear ramps a raw height
        grid gives (on stairs, a bilinear grid turns every riser into a
        climbable ramp).

        Implemented as an ``upsample``x finer grid where steep cells hold
        the LOW side's height through the interior (the wall lands at the
        high vertex); the residual ramp is one fine cell
        (horizontal_scale/upsample) wide. Height sensing reads the coarse
        raw grid (:meth:`as_grid`)."""
        from ..ops.contact import TerrainGrid
        K = max(int(upsample), 1)
        h = self.height_field_raw.astype(np.float32) * self.cfg.vertical_scale
        if K > 1:
            corr = slope_threshold * self.cfg.horizontal_scale

            def up0(h):
                a, b = h[:-1], h[1:]
                steep = np.abs(b - a) > corr
                lo = np.minimum(a, b)
                R = h.shape[0]
                out = np.empty(((R - 1) * K + 1,) + h.shape[1:], np.float32)
                out[::K] = h
                for k in range(1, K):
                    t = k / K
                    out[k::K] = np.where(steep, lo, a * (1 - t) + b * t)
                return out

            h = up0(up0(h).T).T
        return TerrainGrid(
            height=torch.as_tensor(np.ascontiguousarray(h, np.float32),
                                   device=device),
            horizontal_scale=self.cfg.horizontal_scale / K,
            border_size=self.cfg.border_size,
            static_friction=static_friction,
            dynamic_friction=dynamic_friction,
            restitution=restitution,
        )
