"""Terrain height grid and the lookups that feed the physics step (port of
the JAX package's ``ops/contact.py``, terrain part).

A :class:`TerrainGrid` holds the heights as a float32 [rows, cols] tensor
on the env's device; world x, y map to grid indices through
``(x + border_size) / horizontal_scale`` (axis 0 is x, axis 1 is y).

Every lookup here is a plain gather of the four cell corners. The JAX
package reads the same corners through a per-env patch: a P x P square
(``sample_patch``) or a 32 x 128 column block (``sample_patch_blocked``),
evaluated by one-hot einsums on the TPU's matrix unit. The port does not
materialise the patch; it reproduces what the patch does to the result,
which is to clamp the cell index into the window (``rx = clip(ix - ix0, 0,
Pr - 2)``, ``ry = clip(iy - iy0, 0, Pc - 2)``). A :class:`Window` carries
the window's corner and size; :func:`square_window` and
:func:`blocked_window` place it as the JAX functions do. The einsum form
agrees with the 4-corner formula up to float reassociation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class TerrainGrid(NamedTuple):
    height: torch.Tensor         # [rows, cols] float32 meters
    horizontal_scale: float
    border_size: float           # world offset of the grid origin
    static_friction: float
    dynamic_friction: float
    restitution: float


class Window(NamedTuple):
    """Per-env cell window [ix0, ix0 + rows) x [iy0, iy0 + cols) that the
    JAX package's patch covers; lookups clamp their cell into it."""
    ix0: torch.Tensor            # [N] int64
    iy0: torch.Tensor            # [N] int64
    rows: int
    cols: int


def _cells(grid: TerrainGrid, x, y, window: Optional[Window]):
    """Lower cell corner (ix, iy) and in-cell fractions (tx, ty) of world
    points; the corner clamped into ``window`` when given."""
    H, W = grid.height.shape
    s = grid.horizontal_scale
    fx = (x + grid.border_size) / s
    fy = (y + grid.border_size) / s
    ix = torch.clamp(torch.floor(fx).long(), 0, H - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, W - 2)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    if window is not None:
        ix0 = window.ix0.reshape(window.ix0.shape + (1,) * (x.dim() - 1))
        iy0 = window.iy0.reshape(window.iy0.shape + (1,) * (x.dim() - 1))
        ix = ix0 + torch.clamp(ix - ix0, 0, window.rows - 2)
        iy = iy0 + torch.clamp(iy - iy0, 0, window.cols - 2)
    return ix, iy, tx, ty


def _corners(grid: TerrainGrid, ix, iy):
    h = grid.height.reshape(-1)
    W = grid.height.shape[1]
    base = ix * W + iy
    return h[base], h[base + W], h[base + 1], h[base + W + 1]


def terrain_height_bilinear(grid: TerrainGrid, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """Bilinearly interpolated terrain height at world (x, y)."""
    ix, iy, tx, ty = _cells(grid, x, y, None)
    h00, h10, h01, h11 = _corners(grid, ix, iy)
    return ((1 - tx) * (1 - ty) * h00 + tx * (1 - ty) * h10
            + (1 - tx) * ty * h01 + tx * ty * h11)


def terrain_height_and_normal(grid: TerrainGrid, x: torch.Tensor,
                              y: torch.Tensor,
                              window: Optional[Window] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear height and the unit normal of the bilinear patch (its
    analytic gradient) from one 4-corner lookup. ``x``/``y`` are [N, ...];
    with ``window`` the corner is clamped into env n's window as the JAX
    package's patch lookups clamp it. Returns (height [N, ...], normal
    [N, ..., 3])."""
    ix, iy, tx, ty = _cells(grid, x, y, window)
    h00, h10, h01, h11 = _corners(grid, ix, iy)
    s = grid.horizontal_scale
    height = ((1 - tx) * (1 - ty) * h00 + tx * (1 - ty) * h10
              + (1 - tx) * ty * h01 + tx * ty * h11)
    dhdx = ((1 - ty) * (h10 - h00) + ty * (h11 - h01)) / s
    dhdy = ((1 - tx) * (h01 - h00) + tx * (h11 - h10)) / s
    n = torch.stack((-dhdx, -dhdy, torch.ones_like(x)), dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    return height, n


def square_window(grid: TerrainGrid, base_x: torch.Tensor,
                  base_y: torch.Tensor, P: int) -> Window:
    """The P x P window centered on the base (JAX ``sample_patch``)."""
    H, W = grid.height.shape
    s = grid.horizontal_scale
    fx = (base_x + grid.border_size) / s
    fy = (base_y + grid.border_size) / s
    ix0 = torch.clamp(torch.floor(fx).long() - P // 2, 0, H - P)
    iy0 = torch.clamp(torch.floor(fy).long() - P // 2, 0, W - P)
    return Window(ix0, iy0, P, P)


def blocked_window(grid: TerrainGrid, base_x: torch.Tensor,
                   base_y: torch.Tensor, rows: int = 32, block: int = 128,
                   stride: int = 64) -> Window:
    """The rows x block window of the overlapped column blocks that centers
    the base (JAX ``make_col_blocks`` + ``sample_patch_blocked``)."""
    H, W = grid.height.shape
    nb = (W - block) // stride + 1
    s = grid.horizontal_scale
    fx = (base_x + grid.border_size) / s
    fy = (base_y + grid.border_size) / s
    ix0 = torch.clamp(torch.floor(fx).long() - rows // 2, 0, H - rows)
    k = torch.clamp(torch.div(torch.floor(fy).long() - stride // 2, stride,
                              rounding_mode="floor"), 0, nb - 1)
    return Window(ix0, k * stride, rows, block)
