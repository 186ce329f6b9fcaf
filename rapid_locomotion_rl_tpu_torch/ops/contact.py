"""Terrain height grid, the lookups that feed the physics step and the
height sensor, and the sphere contact models of the general (AoS) step:
port of the JAX package's ``ops/contact.py``.

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

import numpy as np
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


def _scale(grid: TerrainGrid, like: torch.Tensor) -> torch.Tensor:
    """The grid's cell size as a 0-d tensor on ``like``'s device (a fill,
    no host copy). Dividing by it is a true quotient, as the JAX package
    divides: on the card PyTorch divides by a python float as a product
    with its reciprocal, one rounding off, which moves a point on a cell
    edge into the next cell."""
    return like.new_full((), grid.horizontal_scale)


def _grid_coord(grid: TerrainGrid, v: torch.Tensor) -> torch.Tensor:
    """(v + border) / scale: a world coordinate in grid cells."""
    return (v + grid.border_size) / _scale(grid, v)


def _cells(grid: TerrainGrid, x, y, window: Optional[Window]):
    """Lower cell corner (ix, iy) and in-cell fractions (tx, ty) of world
    points; the corner clamped into ``window`` when given."""
    H, W = grid.height.shape
    fx = _grid_coord(grid, x)
    fy = _grid_coord(grid, y)
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
    s = _scale(grid, x)
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
    fx = _grid_coord(grid, base_x)
    fy = _grid_coord(grid, base_y)
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
    fx = _grid_coord(grid, base_x)
    fy = _grid_coord(grid, base_y)
    ix0 = torch.clamp(torch.floor(fx).long() - rows // 2, 0, H - rows)
    k = torch.clamp(torch.div(torch.floor(fy).long() - stride // 2, stride,
                              rounding_mode="floor"), 0, nb - 1)
    return Window(ix0, k * stride, rows, block)


# ---------------------------------------------------------------------------
# height sensing
# ---------------------------------------------------------------------------
def _sense_cells(grid: TerrainGrid, x, y):
    """Grid cell of world points as the height sensor takes it: the index
    truncated toward zero (``astype(int32)``), clamped into the grid."""
    H, W = grid.height.shape
    ix = torch.clamp(_grid_coord(grid, x).long(), 0, H - 2)
    iy = torch.clamp(_grid_coord(grid, y).long(), 0, W - 2)
    return ix, iy


def _min3(grid: TerrainGrid, ix, iy):
    h00, h10, h01, _ = _corners(grid, ix, iy)
    return torch.minimum(torch.minimum(h00, h10), h01)


def terrain_height_min3(grid: TerrainGrid, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """The min of the 3 nearest samples: the reference's conservative
    height-sensing rule."""
    return _min3(grid, *_sense_cells(grid, x, y))


def sample_patch(grid: TerrainGrid, base_x: torch.Tensor,
                 base_y: torch.Tensor, P: int = 16
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One P x P height patch per env, centered on the base (the
    JAX package's ``sample_patch``). Returns (patch [N, P, P], ix0 [N],
    iy0 [N])."""
    w = square_window(grid, base_x, base_y, P)
    ar = torch.arange(P, device=grid.height.device)
    rows = (w.ix0[:, None] + ar)[:, :, None]
    cols = (w.iy0[:, None] + ar)[:, None, :]
    return grid.height[rows, cols], w.ix0, w.iy0


def terrain_height_min3_patch(grid: TerrainGrid, base_x: torch.Tensor,
                              base_y: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor, P: int = 32) -> torch.Tensor:
    """:func:`terrain_height_min3` read through each env's P x P window
    centered on its base (the JAX package's patch form, whose one-hot
    contractions pick the same samples): x, y [N, npts]. A point whose
    cell leaves the window takes the cell clamped into it
    (``clip(ix - ix0, 0, P - 2)``), so it differs from the direct rule
    there and agrees with it everywhere else."""
    w = square_window(grid, base_x, base_y, P)
    ix, iy = _sense_cells(grid, x, y)
    ix = w.ix0[:, None] + torch.clamp(ix - w.ix0[:, None], 0, P - 2)
    iy = w.iy0[:, None] + torch.clamp(iy - w.iy0[:, None], 0, P - 2)
    return _min3(grid, ix, iy)


# ---------------------------------------------------------------------------
# contact of the general step
# ---------------------------------------------------------------------------
def sample_terrain(model, terrain: Optional[TerrainGrid],
                   geom_pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-geom terrain height [N, ng] and normal [N, ng, 3] on the full
    grid (no window), or the plane z = 0."""
    x, y = geom_pos[..., 0], geom_pos[..., 1]
    if terrain is None:
        n = torch.zeros_like(geom_pos)
        n[..., 2] = 1.0
        return torch.zeros_like(x), n
    return terrain_height_and_normal(terrain, x, y)


def _onehot(rows: int, idx, device) -> torch.Tensor:
    oh = np.zeros((rows, len(idx)), np.float32)
    oh[np.asarray(idx), np.arange(len(idx))] = 1.0
    return torch.as_tensor(oh, device=device)


def _report_onehot(model, device="cpu") -> torch.Tensor:
    """[nr, ng] one-hot of each geom's report body."""
    return _onehot(model.nr, model.geom_report_body, device)


def _body_onehot(model, device="cpu") -> torch.Tensor:
    """[nb, ng] one-hot of each geom's dynamics body."""
    return _onehot(model.nb, model.geom_body, device)


def report_forces(model, forces: torch.Tensor) -> torch.Tensor:
    """Net force per report body [N, nr, 3] of per-geom forces [N, ng, 3]
    (the one-hot contraction of the JAX package)."""
    return torch.einsum("rg,ngc->nrc",
                        _report_onehot(model, forces.device), forces)


def _f32(model_array, device):
    return torch.as_tensor(np.asarray(model_array, np.float32),
                           device=device)


def contact_forces(model, geom_pos: torch.Tensor, geom_vel: torch.Tensor,
                   friction: torch.Tensor, restitution: torch.Tensor,
                   terrain_hn, *, stiffness: float, damping: float,
                   friction_vel_eps: float, dt: float,
                   terrain_friction: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The legacy contact model: a fully implicit penalty spring-damper on
    every sphere against its body's mass, and regularised Coulomb friction
    (the PhysX average of the robot's and the terrain's coefficients).
    geom_pos, geom_vel [N, ng, 3]; friction, restitution [N].

    Returns (forces [N, ng, 3] world, report [N, nr, 3])."""
    dev = geom_pos.device
    z = geom_pos[..., 2]
    h, n = terrain_hn
    r = _f32(model.geom_radius, dev)
    m_eff = _f32(np.asarray(model.mass)[model.geom_body], dev)
    gap = z - r - h
    depth = torch.clamp_min(-gap, 0.0)
    in_contact = (gap < 0.0).to(z.dtype)

    v_n = torch.sum(geom_vel * n, dim=-1)
    v_t = geom_vel - n * v_n[..., None]
    zeta = torch.clamp(1.0 - restitution, 0.08, 1.0)[:, None]
    c_n = zeta * damping + stiffness * dt
    f_n = torch.clamp_min((stiffness * depth - c_n * v_n)
                          / (1.0 + c_n * dt / m_eff), 0.0) * in_contact
    mu = (0.5 * (friction + terrain_friction))[:, None]
    vt_norm = torch.linalg.norm(v_t, dim=-1)
    c_t = mu * f_n / (vt_norm + friction_vel_eps)
    f_t = -(c_t / (1.0 + c_t * dt / m_eff))[..., None] * v_t
    forces = n * f_n[..., None] + f_t
    return forces, report_forces(model, forces)


def solve33(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by cofactor expansion, the JAX package's closed
    form (M is the mass-split world inverse apparent inertia, symmetric
    positive definite by construction)."""
    a00, a01, a02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    a10, a11, a12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    a20, a21, a22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    inv_det = 1.0 / det
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack((x0, x1, x2), dim=-1)


def contact_forces_implicit(
        model, geom_pos: torch.Tensor, geom_vel: torch.Tensor,
        geom_acc_free: torch.Tensor, lam_inv: torch.Tensor,
        friction: torch.Tensor, restitution: torch.Tensor, terrain_hn, *,
        erp: float, max_depenetration_velocity: float,
        bounce_threshold_velocity: float, dt: float,
        terrain_friction: float = 1.0,
        geom_omega: Optional[torch.Tensor] = None,
        ang_inv: Optional[torch.Tensor] = None,
        torsional_patch_radius: float = 0.0, iterations: int = 1,
        lam_inv_true: Optional[torch.Tensor] = None,
        phi0_w: Optional[torch.Tensor] = None,
        arm_base: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Velocity-level constraint contact against the articulated response:
    per sphere, the impulse that drives v' = v + dt (a_free + Lam^-1 f) to
    the target (Baumgarte depenetration, restitution above the bounce
    threshold), projected onto the friction cone, with Jacobi mass
    splitting over the active contacts of one body. With ``iterations`` > 1
    and ``phi0_w``/``arm_base`` given, an under-relaxed Jacobi iteration
    that feeds the other contacts' impulses back through the floating base.
    With ``torsional_patch_radius`` > 0 (and ``geom_omega``, ``ang_inv``),
    the spin-stiction torque about the normal of a finite contact patch.

    Tensors are [N, ng, ...] (``phi0_w`` [N, 6, 6]; friction, restitution
    [N]). Returns (forces [N, ng, 3] world, report [N, nr, 3], torques
    [N, ng, 3] world pure torques on the owning bodies)."""
    dev = geom_pos.device
    z = geom_pos[..., 2]
    h, n = terrain_hn
    r = _f32(model.geom_radius, dev)
    gap = z - r - h
    depth = torch.clamp_min(-gap, 0.0)
    in_contact = (gap < 0.0).to(z.dtype)
    restitution = restitution[:, None]

    v_pred = geom_vel + dt * geom_acc_free
    v_n_now = torch.sum(geom_vel * n, dim=-1)

    bias = torch.clamp_max(erp / dt * depth, max_depenetration_velocity)
    bounce = torch.where(v_n_now < -bounce_threshold_velocity,
                         -restitution * v_n_now, 0.0)
    v_tgt_n = torch.maximum(bias, bounce)

    # Jacobi mass splitting over the active contacts of one body
    gb = torch.as_tensor(np.asarray(model.geom_body, np.int64), device=dev)
    n_active = in_contact @ _body_onehot(model, dev).T          # [N, nb]
    split = torch.clamp_min(n_active[:, gb], 1.0)               # [N, ng]
    mu = (0.5 * (friction + terrain_friction))[:, None]

    if iterations > 1 and phi0_w is not None and arm_base is not None:
        def _project(fc):
            f_n = torch.sum(fc * n, dim=-1)
            f_t = fc - n * f_n[..., None]
            f_n = torch.clamp_min(f_n, 0.0) * in_contact
            ft_norm = torch.linalg.norm(f_t, dim=-1)
            sc = (torch.clamp_max(mu * f_n / (ft_norm + 1e-9), 1.0)
                  * in_contact)
            return n * f_n[..., None] + f_t * sc[..., None], f_n

        loc = lam_inv_true if lam_inv_true is not None else lam_inv
        rb = arm_base
        dv0 = n * v_tgt_n[..., None] - v_pred
        omega = 0.7
        f = torch.zeros_like(v_pred)
        for _ in range(int(iterations)):
            rf = torch.linalg.cross(rb, f, dim=-1)
            F_tot = torch.cat((torch.sum(rf, dim=-2),
                               torch.sum(f, dim=-2)), -1)       # [N, 6]
            self6 = torch.cat((rf, f), dim=-1)                  # [N, ng, 6]
            y = (F_tot[:, None, :] - self6) @ phi0_w.transpose(-1, -2)
            v_cross = y[..., 3:] - torch.linalg.cross(rb, y[..., :3],
                                                      dim=-1)
            f_new = solve33(loc, (dv0 - dt * v_cross) / dt)
            f_new, _ = _project(f_new)
            f = (1.0 - omega) * f + omega * f_new
        forces, f_n = _project(f)
    else:
        lam_inv = lam_inv * split[..., None, None]
        dv = n * v_tgt_n[..., None] - v_pred
        f = solve33(lam_inv, dv / dt)
        f_n = torch.sum(f * n, dim=-1)
        f_t = f - n * f_n[..., None]
        f_n = torch.clamp_min(f_n, 0.0) * in_contact
        ft_norm = torch.linalg.norm(f_t, dim=-1)
        scale = (torch.clamp_max(mu * f_n / (ft_norm + 1e-9), 1.0)
                 * in_contact)
        forces = n * f_n[..., None] + f_t * scale[..., None]

    if torsional_patch_radius > 0.0 and geom_omega is not None \
            and ang_inv is not None:
        ang_inv = ang_inv * split[..., None, None]
        w_n = torch.sum(geom_omega * n, dim=-1)
        r_ang = torch.clamp_min(torch.sum(
            n * (ang_inv @ n[..., None])[..., 0], dim=-1), 1e-6)
        tau_max = mu * f_n * torsional_patch_radius
        tau_n = torch.minimum(torch.maximum(-w_n / (dt * r_ang), -tau_max),
                              tau_max)
        torques = n * tau_n[..., None]
    else:
        torques = torch.zeros_like(forces)
    return forces, report_forces(model, forces), torques


def spatial_forces_on_bodies(model, frames, geom_pos: torch.Tensor,
                             forces: torch.Tensor,
                             torques_w: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """World-frame sphere forces at ``geom_pos`` (plus optional pure
    torques) [N, ng, 3] as spatial forces [N, nb, 6] on the dynamics
    bodies, each in its own frame ([torque about the origin; force])."""
    dev = geom_pos.device
    gb = torch.as_tensor(np.asarray(model.geom_body, np.int64), device=dev)
    Rb = frames.R[:, gb]
    arm = geom_pos - frames.p[:, gb]
    torque_w = torch.linalg.cross(arm, forces, dim=-1)
    if torques_w is not None:
        torque_w = torque_w + torques_w
    Rt = Rb.transpose(-1, -2)
    n_b = (Rt @ torque_w[..., None])[..., 0]
    f_b = (Rt @ forces[..., None])[..., 0]
    f6 = torch.cat((n_b, f_b), dim=-1)
    return torch.einsum("bg,ngc->nbc", _body_onehot(model, dev), f6)
