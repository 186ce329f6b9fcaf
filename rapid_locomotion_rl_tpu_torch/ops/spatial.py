"""6-D spatial vector algebra (Featherstone convention: [angular; linear]).

Port of the JAX package's ``ops/spatial.py``: the building blocks of the
general articulated-body dynamics in :mod:`.dynamics`. Every function
broadcasts over leading batch axes (the env axis first, then e.g. a geom
or limb axis). Motion vectors are ``[w; v]``, force vectors ``[n; f]``;
a spatial transform is a rotation ``E`` with an origin offset ``r``, or an
explicit 6x6 matrix where matrix products are needed.
"""

from __future__ import annotations

import torch


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product M @ v over leading axes."""
    return (M @ v[..., None])[..., 0]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix: skew(a) @ b = a x b."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack((zero, -z, y, z, zero, -x, -y, x, zero), dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body-frame origin, from the mass
    [...], the CoM [..., 3] in the body frame and the rotational inertia
    [..., 3, 3] about the CoM."""
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(c.shape)
    top = torch.cat((inertia_com + m * (c @ ct), m * c), dim=-1)
    bot = torch.cat((m * ct, m * eye), dim=-1)
    return torch.cat((top, bot), dim=-2)


def xmat_motion(E: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """6x6 motion transform B<-A for a frame with rotation E (x_B = E x_A)
    and origin at r (in A): X = [[E, 0], [-E r^, E]]."""
    Er = -E @ skew(r)
    E = E.expand_as(Er)
    zero = torch.zeros_like(Er)
    top = torch.cat((E, zero), dim=-1)
    bot = torch.cat((Er, E), dim=-1)
    return torch.cat((top, bot), dim=-2)


def xform_motion(E: torch.Tensor, r: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Apply the motion transform B<-A to motion vector v (in A coords)."""
    w, vl = v[..., :3], v[..., 3:]
    wn = _mv(E, w)
    vn = _mv(E, vl + cross(w, r.expand_as(w)))
    return torch.cat((wn, vn), dim=-1)


def xform_motion_inv(E: torch.Tensor, r: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Apply the inverse transform A<-B to motion vector v (in B coords)."""
    w, vl = v[..., :3], v[..., 3:]
    Et = E.transpose(-1, -2)
    wn = _mv(Et, w)
    vn = _mv(Et, vl) - cross(wn, r.expand_as(wn))
    return torch.cat((wn, vn), dim=-1)


def xform_force_to_parent(E: torch.Tensor, r: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """Transform force vector f from child (B) coords back to parent (A):
    f_A = X_{B<-A}^T f_B (the power-invariant dual of xform_motion)."""
    n, fl = f[..., :3], f[..., 3:]
    Et = E.transpose(-1, -2)
    fA = _mv(Et, fl)
    nA = _mv(Et, n) + cross(r.expand_as(fA), fA)
    return torch.cat((nA, fA), dim=-1)


def crm(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x_m m."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat((cross(w, mw), cross(vl, mw) + cross(w, ml)), dim=-1)


def crf(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    n, fl = f[..., :3], f[..., 3:]
    w, vl = v[..., :3], v[..., 3:]
    return torch.cat((cross(w, n) + cross(vl, fl), cross(w, fl)), dim=-1)


def solve_psd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite 6x6 A by the JAX
    package's unrolled Cholesky, entry by entry in its order (every
    operation elementwise over the batch axes; no pivoting, no library
    solver, so no host synchronisation on the card)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward substitution: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
