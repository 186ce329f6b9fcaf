"""Structure-of-arrays (SoA) math: 3-vectors, 3x3 matrices, quaternions and
6-D spatial quantities as python tuples of same-shaped [N] tensors.

Port of the JAX package's ``ops/soa.py``. Each operation is elementwise
over the env axis, so :mod:`.soa_physics` written in this algebra is the
plain version of the CUDA kernel (``csrc/substep_chain.cuh`` holds the same
functions for one env). Components may also be python floats (model
constants); the helpers below keep a python float a python float.

Conventions: v3 = (x, y, z); m3 = ((a00,a01,a02),(a10,...),...) row-major;
quat = (x, y, z, w); spatial motion/force = (angular v3, linear v3);
6x6 = ((m3, m3), (m3, m3)) block form.
"""

from __future__ import annotations

import math

import torch


def _is_t(x):
    return isinstance(x, torch.Tensor)


def sqrt(x):
    return torch.sqrt(x) if _is_t(x) else math.sqrt(x)


def sin(x):
    return torch.sin(x) if _is_t(x) else math.sin(x)


def cos(x):
    return torch.cos(x) if _is_t(x) else math.cos(x)


def maximum(a, b):
    """Elementwise max of a tensor or float with a tensor or float. Two
    floats give a 0-d float32 tensor, as ``jnp.maximum`` of two python
    floats gives a float32 array."""
    if _is_t(a) and _is_t(b):
        return torch.maximum(a, b)
    if _is_t(a):
        return torch.clamp_min(a, b)
    if _is_t(b):
        return torch.clamp_min(b, a)
    return torch.tensor(max(a, b), dtype=torch.float32)


def minimum(a, b):
    if _is_t(a) and _is_t(b):
        return torch.minimum(a, b)
    if _is_t(a):
        return torch.clamp_max(a, b)
    if _is_t(b):
        return torch.clamp_max(b, a)
    return torch.tensor(min(a, b), dtype=torch.float32)


def clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


# ---------------------------------------------------------------------------
# v3
# ---------------------------------------------------------------------------

def v3_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def v3_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v3_scale(a, s):
    return tuple(x * s for x in a)


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def v3_norm(a, eps=0.0):
    return sqrt(v3_dot(a, a) + eps)


def v3_zeros_like(x):
    z = x * 0.0
    return (z, z, z)


# ---------------------------------------------------------------------------
# m3 (row-major tuple-of-tuples)
# ---------------------------------------------------------------------------

def m3_identity_like(x):
    o = x * 0.0 + 1.0
    z = x * 0.0
    return ((o, z, z), (z, o, z), (z, z, o))


def m3_t(m):
    return tuple(tuple(m[j][i] for j in range(3)) for i in range(3))


def m3_mul(a, b):
    return tuple(
        tuple(sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3))
        for i in range(3))


def m3_vec(m, v):
    return tuple(sum(m[i][k] * v[k] for k in range(3)) for i in range(3))


def m3_tvec(m, v):
    """mᵀ v"""
    return tuple(sum(m[k][i] * v[k] for k in range(3)) for i in range(3))


def m3_add(a, b):
    return tuple(tuple(a[i][j] + b[i][j] for j in range(3)) for i in range(3))


def m3_scale(a, s):
    return tuple(tuple(a[i][j] * s for j in range(3)) for i in range(3))


def m3_outer(a, b):
    return tuple(tuple(a[i] * b[j] for j in range(3)) for i in range(3))


def m3_skew(v):
    z = v[0] * 0.0
    return ((z, -v[2], v[1]), (v[2], z, -v[0]), (-v[1], v[0], z))


def m3_solve(M, b):
    """Cofactor solve of a 3x3 (tuple form) against v3 — elementwise."""
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = M
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
    inv_det = 1.0 / det
    return ((c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det,
            (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det,
            (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det)


def m3_from_array(arr):
    """Constant numpy 3x3 -> m3 of python floats (broadcast later)."""
    return tuple(tuple(float(arr[i, j]) for j in range(3)) for i in range(3))


def m3_axis_angle(axis, angle):
    """Rodrigues for a per-env angle; axis = v3 (possibly constants)."""
    s, c = sin(angle), cos(angle)
    K = m3_skew(axis)
    KK = m3_mul(K, K)
    I = m3_identity_like(angle)
    return tuple(tuple(I[i][j] + s * K[i][j] + (1.0 - c) * KK[i][j]
                       for j in range(3)) for i in range(3))


# ---------------------------------------------------------------------------
# quaternions (xyzw)
# ---------------------------------------------------------------------------

def quat_rotate(q, v):
    x, y, z, w = q
    t = v3_scale(v3_cross((x, y, z), v), 2.0)
    return v3_add(v3_add(v, v3_scale(t, w)), v3_cross((x, y, z), t))


def quat_rotate_inv(q, v):
    x, y, z, w = q
    return quat_rotate((-x, -y, -z, w), v)


def quat_to_m3(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def quat_normalize(q, eps=1e-9):
    n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + eps
    return tuple(c / n for c in q)


def quat_integrate(q, omega, dt):
    """q' = normalize(q + 0.5 dt (ω ⊗ q)) with ω a world v3."""
    oq = (omega[0], omega[1], omega[2], omega[0] * 0.0)
    dq = quat_mul(oq, q)
    return quat_normalize(tuple(qc + 0.5 * dt * dc
                                for qc, dc in zip(q, dq)))


# ---------------------------------------------------------------------------
# 6-D spatial (Featherstone [angular; linear]) as (v3, v3); 6x6 as 2x2 of m3
# ---------------------------------------------------------------------------

def sv_add(a, b):
    return (v3_add(a[0], b[0]), v3_add(a[1], b[1]))


def sv_sub(a, b):
    return (v3_sub(a[0], b[0]), v3_sub(a[1], b[1]))


def sv_scale(a, s):
    return (v3_scale(a[0], s), v3_scale(a[1], s))


def sv_dot(a, b):
    return v3_dot(a[0], b[0]) + v3_dot(a[1], b[1])


def sm_vec(M, v):
    """6x6 block matrix times spatial vector."""
    (A, B), (C, D) = M
    return (v3_add(m3_vec(A, v[0]), m3_vec(B, v[1])),
            v3_add(m3_vec(C, v[0]), m3_vec(D, v[1])))


def sm_add(M, N):
    return tuple(tuple(m3_add(M[i][j], N[i][j]) for j in range(2))
                 for i in range(2))


def sm_scale(M, s):
    return tuple(tuple(m3_scale(M[i][j], s) for j in range(2))
                 for i in range(2))


def sm_outer(u, v):
    """u vᵀ for spatial vectors (6x6 blocks)."""
    return ((m3_outer(u[0], v[0]), m3_outer(u[0], v[1])),
            (m3_outer(u[1], v[0]), m3_outer(u[1], v[1])))


def spatial_inertia(mass, com, inertia_m3):
    """6x6 spatial inertia about the body origin (mass/com may be per-env)."""
    c = m3_skew(com)
    ct = m3_t(c)
    A = m3_add(inertia_m3, m3_scale(m3_mul(c, ct), mass))
    B = m3_scale(c, mass)
    C = m3_scale(ct, mass)
    o = com[0] * 0.0 + 1.0
    z = com[0] * 0.0
    D = ((mass * o, z, z), (z, mass * o, z), (z, z, mass * o))
    return ((A, B), (C, D))


def crm(v, m):
    """spatial motion cross product v ×ₘ m."""
    w, vl = v
    return (v3_cross(w, m[0]),
            v3_add(v3_cross(vl, m[0]), v3_cross(w, m[1])))


def crf(v, f):
    """spatial force cross product v ×* f."""
    w, vl = v
    return (v3_add(v3_cross(w, f[0]), v3_cross(vl, f[1])),
            v3_cross(w, f[1]))


def xform_motion(E, r, v):
    """motion transform child<-parent with rotation E (x_c = E x_p) and
    child origin at r in parent frame."""
    w, vl = v
    return (m3_vec(E, w), m3_vec(E, v3_add(vl, v3_cross(w, r))))


def xform_force_to_parent(E, r, f):
    n, fl = f
    fA = m3_tvec(E, fl)
    nA = v3_add(m3_tvec(E, n), v3_cross(r, fA))
    return (nA, fA)


def m3_sub(a, b):
    return tuple(tuple(a[i][j] - b[i][j] for j in range(3)) for i in range(3))


def xform_inertia_to_parent(E, r, M):
    """Xᵀ M X for the motion transform X(E, r) = [[E, 0], [-E rx, E]]:
    transform an articulated 6x6 inertia from child to parent coords."""
    (A, B), (C, D) = M
    Et = m3_t(E)
    rx = m3_skew(r)
    Erx = m3_mul(E, rx)
    # Y = M X:  Y00 = A E - B E rx ; Y01 = B E ; Y10 = C E - D E rx ; Y11 = D E
    Y00 = m3_sub(m3_mul(A, E), m3_mul(B, Erx))
    Y01 = m3_mul(B, E)
    Y10 = m3_sub(m3_mul(C, E), m3_mul(D, Erx))
    Y11 = m3_mul(D, E)
    # Xᵀ = [[Eᵀ, (-E rx)ᵀ], [0, Eᵀ]]; (-E rx)ᵀ = -rxᵀEᵀ = rx Eᵀ
    rxEt = m3_mul(rx, Et)
    Z00 = m3_add(m3_mul(Et, Y00), m3_mul(rxEt, Y10))
    Z01 = m3_add(m3_mul(Et, Y01), m3_mul(rxEt, Y11))
    Z10 = m3_mul(Et, Y10)
    Z11 = m3_mul(Et, Y11)
    return ((Z00, Z01), (Z10, Z11))


def chol6(M):
    """Unrolled Cholesky factor of a 2x2-block 6x6 SPD matrix; returns the
    lower triangle as a 6x6 list-of-lists of scalars."""
    A = [[None] * 6 for _ in range(6)]
    for bi in range(2):
        for bj in range(2):
            blk = M[bi][bj]
            for i in range(3):
                for j in range(3):
                    A[bi * 3 + i][bj * 3 + j] = blk[i][j]
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = sqrt(maximum(s, 1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol6_solve(L, rhs):
    n = 6
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def solve_psd6(M, b):
    """Unrolled Cholesky solve for the 2x2-block 6x6 SPD matrix."""
    L = chol6(M)
    x = _chol6_solve(L, [b[0][0], b[0][1], b[0][2], b[1][0], b[1][1], b[1][2]])
    return ((x[0], x[1], x[2]), (x[3], x[4], x[5]))


def inv_psd6(M):
    """Inverse of the 2x2-block 6x6 SPD matrix (block form out)."""
    L = chol6(M)
    one = M[0][0][0][0] * 0.0 + 1.0
    zero = M[0][0][0][0] * 0.0
    cols = []
    for k in range(6):
        rhs = [one if i == k else zero for i in range(6)]
        cols.append(_chol6_solve(L, rhs))
    # cols[k][i] = (M^-1)[i,k]
    blk = lambda bi, bj: tuple(tuple(cols[bj * 3 + j][bi * 3 + i]  # noqa: E731
                                     for j in range(3)) for i in range(3))
    return ((blk(0, 0), blk(0, 1)), (blk(1, 0), blk(1, 1)))


def xform_phi_to_child(E, r, Phi):
    """X Phi Xᵀ for the motion transform X(E, r) = [[E, 0], [-E rx, E]]:
    transform an INVERSE inertia (force->motion) from parent to child
    coords (the dual direction of :func:`xform_inertia_to_parent`)."""
    (A, B), (C, D) = Phi
    Et = m3_t(E)
    Sm = m3_scale(m3_skew(r), -1.0)      # -rx
    St = m3_t(Sm)
    # block rows of X Phi: [E A, E B] ; [E(Sm A + C), E(Sm B + D)]
    # then right-multiply by Xᵀ = [[Eᵀ, (E Sm)ᵀ], [0, Eᵀ]]
    SmA = m3_mul(Sm, A)
    Z00 = m3_mul(m3_mul(E, A), Et)
    Z01 = m3_mul(m3_mul(E, m3_add(m3_mul(A, St), B)), Et)
    Z10 = m3_mul(m3_mul(E, m3_add(SmA, C)), Et)
    Z11 = m3_mul(m3_mul(E, m3_add(m3_add(m3_mul(m3_add(SmA, C), St),
                                         m3_mul(Sm, B)), D)), Et)
    return ((Z00, Z01), (Z10, Z11))
