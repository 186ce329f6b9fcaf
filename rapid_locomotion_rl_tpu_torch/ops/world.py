"""The boxes of per-env static world obstacles (the walls of the HLP
corridor), as the physics step reads them: a layer below the env, so that
``ops/`` imports nothing of ``envs/``. :mod:`..envs.world` re-exports
both names beside the batched box force."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class WorldBoxes(NamedTuple):
    """Axis-aligned boxes, positions relative to the env origin (float32,
    on the CPU: the physics step reads them as constants)."""
    centers: torch.Tensor        # [nbox, 3]
    half_extents: torch.Tensor   # [nbox, 3]


def default_corridor(length: float = 3.5, width: float = 1.6,
                     wall_height: float = 1.0,
                     wall_thickness: float = 0.2) -> WorldBoxes:
    """The reference 4-wall corridor: two length x t x h side walls at
    y = +-width/2, two end walls at x = +-(length + t)/2."""
    hy = width / 2.0
    hz = wall_height / 2.0
    t = wall_thickness / 2.0
    ex = (length + wall_thickness) / 2.0
    centers = np.array([
        [0.0, -hy, hz],
        [0.0, hy, hz],
        [ex, 0.0, hz],
        [-ex, 0.0, hz],
    ])
    half = np.array([
        [length / 2.0, t, hz],
        [length / 2.0, t, hz],
        [t, hy + t, hz],
        [t, hy + t, hz],
    ])
    return WorldBoxes(centers=torch.tensor(centers, dtype=torch.float32),
                      half_extents=torch.tensor(half, dtype=torch.float32))
