// Per-env body of the physics step: num_substeps substeps of FK, geom
// kinematics, joint torques, the limb-ABA articulated inertias, the per-geom
// inverse apparent inertia (once per call), the TGS-style contact solve with
// friction cone and torsional stiction, the bias sweep, the 6x6 Cholesky base
// acceleration and semi-implicit Euler, on the plane z=0 or on terrain: with
// TER the input holds each geom's terrain height and unit normal, sampled
// outside the kernel once per call (ops/soa_physics.py::sample_geom_terrain).
// With WLD every substep also adds the penalty force of every collision
// sphere against every world box (the walls of the HLP corridor, placed at
// the env origin that the input holds): ops/soa_physics.py::box_forces_soa.
// With LEG the ground contact is the legacy penalty model instead of the
// apparent-inertia solve (ops/soa_physics.py::legacy_contact_force: a
// spring-damper per sphere with regularised Coulomb friction against the
// body mass, at the sphere centers; no inverse apparent inertia, no free
// dynamics pass, no torsion). With FIX the base is fixed: no base
// acceleration (the 6x6 solve is skipped), a zero base mobility, the base
// velocities zeroed and the base pose not integrated. FIX comes only with
// LEG: under the apparent model a fixed base has a zero base mobility, a
// singular inverse apparent inertia and NaN in the reference (the JAX
// package's SoA step), so that pair is refused
// (ops/soa_physics.py::check_supported) and not compiled.
//
// It computes what ops/soa_physics.py::substep_chain computes, operation for
// operation and in the same order, for ONE env. The same source builds under
// nvcc (physics_step.cu, one thread per env) and under g++
// (physics_step_host.cpp, a loop over envs), where RL_HD is empty.
//
// Data layout: inputs x and outputs y are [C, n] float32, channel-major, so
// that neighbouring threads (envs) read neighbouring addresses. The robot
// model is a flat float32 table `cst` packed once per model by
// ops/cuda_physics.py::pack_constants; its layout is the RL_* offsets below.
// Only the limb layout (D levels x K limbs) and the implicit-PD, terrain,
// world, legacy-contact and fixed-base switches are compile-time constants;
// loops over bodies, geoms and boxes run at run time.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RL_HD __host__ __device__ __forceinline__
#else
#define RL_HD
#endif

#define RL_MAX_NG 64
#define RL_MAX_NR 32

// ---- constant table layout (mirrored in ops/cuda_physics.py) --------------
#define RL_H_NSUB 0
#define RL_H_DT 1
#define RL_H_INV_DT 2
#define RL_H_HALF_DT 3
#define RL_H_GZ 4
#define RL_H_ERP_DT 5
#define RL_H_MAX_DEPEN 6
#define RL_H_BOUNCE 7
#define RL_H_JFRIC 8
#define RL_H_PATCH 9
#define RL_H_SPLIT 10
#define RL_H_MASS0 11
#define RL_H_NG 12
#define RL_H_NR 13
#define RL_H_K 14     // contact stiffness (legacy model)
#define RL_H_DAMP 15  // contact damping (legacy model)
#define RL_H_KDT 16   // stiffness dt, in float64 then rounded
#define RL_H_VEPS 17  // friction_vel_eps (legacy model)
#define RL_HDR 24
// base block: com0[3], inertia0[9]
#define RL_BASE RL_HDR
#define RL_BASE_SIZE 12
// per limb slot l = d*K + k
#define RL_S_E 0      // E_tree [9]
#define RL_S_P 9      // p_tree [3]
#define RL_S_AX 12    // axis [3]
#define RL_S_KK 15    // skew(axis)^2 [9], in float64 then rounded
#define RL_S_M6 24    // spatial inertia [36] row-major
#define RL_S_ARM 60
#define RL_S_DAMP 61
#define RL_S_LO 62
#define RL_S_HI 63
#define RL_S_VLIM 64
#define RL_S_J 65     // joint index of the slot
#define RL_SLOT 66
// per geom g
#define RL_G_SLOT 0   // body slot: 0 = base, 1 + l = limb slot l
#define RL_G_REP 1    // report body
#define RL_G_OFF 2    // offset [3]
#define RL_G_RAD 5
#define RL_G_MEFF 6   // mass of the geom's body (the world force's m_eff)
#define RL_G_WDEN 7   // 1 + c_n dt / m_eff, in float64 then rounded
#define RL_GEOM 8
// world block, after the geoms: constants, then 6 floats per box
#define RL_W_NBOX 0
#define RL_W_K 1      // contact stiffness
#define RL_W_CN 2     // c_n = damping + stiffness dt, in float64 then rounded
#define RL_W_MU 3     // world friction
#define RL_W_EPS 4    // friction_vel_eps
#define RL_W_HDR 8
#define RL_W_BOX 6    // center [3], half extents [3]

namespace rl {

struct V3 { float v[3]; };
struct M3 { float m[3][3]; };
struct SV { V3 w, l; };            // spatial (angular, linear)
struct SM { M3 b[2][2]; };         // 6x6 as 2x2 blocks

// ---- v3 -------------------------------------------------------------------
RL_HD V3 v3(float a, float b, float c) { V3 r; r.v[0] = a; r.v[1] = b; r.v[2] = c; return r; }
RL_HD V3 v3_zero() { return v3(0.f, 0.f, 0.f); }
RL_HD V3 v3_load(const float* p) { return v3(p[0], p[1], p[2]); }
RL_HD V3 v3_add(V3 a, V3 b) { return v3(a.v[0] + b.v[0], a.v[1] + b.v[1], a.v[2] + b.v[2]); }
RL_HD V3 v3_sub(V3 a, V3 b) { return v3(a.v[0] - b.v[0], a.v[1] - b.v[1], a.v[2] - b.v[2]); }
RL_HD V3 v3_scale(V3 a, float s) { return v3(a.v[0] * s, a.v[1] * s, a.v[2] * s); }
RL_HD float v3_dot(V3 a, V3 b) { return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2]; }
RL_HD V3 v3_cross(V3 a, V3 b) {
  return v3(a.v[1] * b.v[2] - a.v[2] * b.v[1],
            a.v[2] * b.v[0] - a.v[0] * b.v[2],
            a.v[0] * b.v[1] - a.v[1] * b.v[0]);
}
RL_HD float v3_norm(V3 a, float eps) { return sqrtf(v3_dot(a, a) + eps); }

// ---- m3 (row-major) -------------------------------------------------------
RL_HD M3 m3_load(const float* p) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = p[i * 3 + j];
  return r;
}
RL_HD M3 m3_t(const M3& a) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
  return r;
}
RL_HD M3 m3_mul(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
  return r;
}
RL_HD V3 m3_vec(const M3& m, V3 v) {
  V3 r;
  for (int i = 0; i < 3; ++i)
    r.v[i] = m.m[i][0] * v.v[0] + m.m[i][1] * v.v[1] + m.m[i][2] * v.v[2];
  return r;
}
RL_HD V3 m3_tvec(const M3& m, V3 v) {  // m^T v
  V3 r;
  for (int i = 0; i < 3; ++i)
    r.v[i] = m.m[0][i] * v.v[0] + m.m[1][i] * v.v[1] + m.m[2][i] * v.v[2];
  return r;
}
RL_HD M3 m3_add(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[i][j] + b.m[i][j];
  return r;
}
RL_HD M3 m3_sub(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[i][j] - b.m[i][j];
  return r;
}
RL_HD M3 m3_scale(const M3& a, float s) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[i][j] * s;
  return r;
}
RL_HD M3 m3_outer(V3 a, V3 b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.v[i] * b.v[j];
  return r;
}
RL_HD M3 m3_skew(V3 v) {
  M3 r;
  r.m[0][0] = 0.f;     r.m[0][1] = -v.v[2]; r.m[0][2] = v.v[1];
  r.m[1][0] = v.v[2];  r.m[1][1] = 0.f;     r.m[1][2] = -v.v[0];
  r.m[2][0] = -v.v[1]; r.m[2][1] = v.v[0];  r.m[2][2] = 0.f;
  return r;
}
RL_HD V3 m3_solve(const M3& M, V3 b) {  // cofactor solve
  const float a00 = M.m[0][0], a01 = M.m[0][1], a02 = M.m[0][2];
  const float a10 = M.m[1][0], a11 = M.m[1][1], a12 = M.m[1][2];
  const float a20 = M.m[2][0], a21 = M.m[2][1], a22 = M.m[2][2];
  const float c00 = a11 * a22 - a12 * a21;
  const float c01 = a12 * a20 - a10 * a22;
  const float c02 = a10 * a21 - a11 * a20;
  const float det = a00 * c00 + a01 * c01 + a02 * c02;
  const float c10 = a02 * a21 - a01 * a22;
  const float c11 = a00 * a22 - a02 * a20;
  const float c12 = a01 * a20 - a00 * a21;
  const float c20 = a01 * a12 - a02 * a11;
  const float c21 = a02 * a10 - a00 * a12;
  const float c22 = a00 * a11 - a01 * a10;
  const float inv_det = 1.0f / det;
  return v3((c00 * b.v[0] + c10 * b.v[1] + c20 * b.v[2]) * inv_det,
            (c01 * b.v[0] + c11 * b.v[1] + c21 * b.v[2]) * inv_det,
            (c02 * b.v[0] + c12 * b.v[1] + c22 * b.v[2]) * inv_det);
}
// Rodrigues: I + s K + (1 - c) KK with K = skew(axis), KK from the table
RL_HD M3 m3_axis_angle(V3 axis, const M3& KK, float angle) {
  const float s = sinf(angle), c = cosf(angle);
  const M3 K = m3_skew(axis);
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = (i == j ? 1.0f : 0.0f) + s * K.m[i][j] + (1.0f - c) * KK.m[i][j];
  return r;
}

// ---- quaternions (xyzw) ---------------------------------------------------
RL_HD M3 quat_to_m3(const float* q) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  M3 r;
  r.m[0][0] = 1 - 2 * (yy + zz); r.m[0][1] = 2 * (xy - wz);     r.m[0][2] = 2 * (xz + wy);
  r.m[1][0] = 2 * (xy + wz);     r.m[1][1] = 1 - 2 * (xx + zz); r.m[1][2] = 2 * (yz - wx);
  r.m[2][0] = 2 * (xz - wy);     r.m[2][1] = 2 * (yz + wx);     r.m[2][2] = 1 - 2 * (xx + yy);
  return r;
}
// q' = normalize(q + (0.5 dt) (w ⊗ q)) for a world-frame w
RL_HD void quat_integrate(float* q, V3 w, float half_dt) {
  const float ax = w.v[0], ay = w.v[1], az = w.v[2], aw = 0.0f;
  const float bx = q[0], by = q[1], bz = q[2], bw = q[3];
  const float d0 = aw * bx + ax * bw + ay * bz - az * by;
  const float d1 = aw * by - ax * bz + ay * bw + az * bx;
  const float d2 = aw * bz + ax * by - ay * bx + az * bw;
  const float d3 = aw * bw - ax * bx - ay * by - az * bz;
  float n0 = bx + half_dt * d0, n1 = by + half_dt * d1;
  float n2 = bz + half_dt * d2, n3 = bw + half_dt * d3;
  const float nrm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3) + 1e-9f;
  q[0] = n0 / nrm; q[1] = n1 / nrm; q[2] = n2 / nrm; q[3] = n3 / nrm;
}

// ---- spatial --------------------------------------------------------------
RL_HD SV sv(V3 w, V3 l) { SV r; r.w = w; r.l = l; return r; }
RL_HD SV sv_add(const SV& a, const SV& b) { return sv(v3_add(a.w, b.w), v3_add(a.l, b.l)); }
RL_HD SV sv_sub(const SV& a, const SV& b) { return sv(v3_sub(a.w, b.w), v3_sub(a.l, b.l)); }
RL_HD SV sv_scale(const SV& a, float s) { return sv(v3_scale(a.w, s), v3_scale(a.l, s)); }
RL_HD float sv_dot(const SV& a, const SV& b) { return v3_dot(a.w, b.w) + v3_dot(a.l, b.l); }
RL_HD SV sm_vec(const SM& M, const SV& v) {
  return sv(v3_add(m3_vec(M.b[0][0], v.w), m3_vec(M.b[0][1], v.l)),
            v3_add(m3_vec(M.b[1][0], v.w), m3_vec(M.b[1][1], v.l)));
}
RL_HD SM sm_add(const SM& A, const SM& B) {
  SM r;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) r.b[i][j] = m3_add(A.b[i][j], B.b[i][j]);
  return r;
}
RL_HD SM sm_scale(const SM& A, float s) {
  SM r;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) r.b[i][j] = m3_scale(A.b[i][j], s);
  return r;
}
RL_HD SM sm_outer(const SV& u, const SV& v) {
  SM r;
  r.b[0][0] = m3_outer(u.w, v.w); r.b[0][1] = m3_outer(u.w, v.l);
  r.b[1][0] = m3_outer(u.l, v.w); r.b[1][1] = m3_outer(u.l, v.l);
  return r;
}
RL_HD SM sm_load(const float* p) {  // row-major 6x6
  SM r;
  for (int bi = 0; bi < 2; ++bi)
    for (int bj = 0; bj < 2; ++bj)
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) r.b[bi][bj].m[i][j] = p[(bi * 3 + i) * 6 + bj * 3 + j];
  return r;
}
RL_HD SM spatial_inertia(float mass, V3 com, const M3& I) {
  const M3 c = m3_skew(com);
  const M3 ct = m3_t(c);
  SM r;
  r.b[0][0] = m3_add(I, m3_scale(m3_mul(c, ct), mass));
  r.b[0][1] = m3_scale(c, mass);
  r.b[1][0] = m3_scale(ct, mass);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.b[1][1].m[i][j] = (i == j) ? mass * 1.0f : 0.0f;
  return r;
}
RL_HD SV crm(const SV& v, const SV& m) {
  return sv(v3_cross(v.w, m.w), v3_add(v3_cross(v.l, m.w), v3_cross(v.w, m.l)));
}
RL_HD SV crf(const SV& v, const SV& f) {
  return sv(v3_add(v3_cross(v.w, f.w), v3_cross(v.l, f.l)), v3_cross(v.w, f.l));
}
RL_HD SV xform_motion(const M3& E, V3 r, const SV& v) {
  return sv(m3_vec(E, v.w), m3_vec(E, v3_add(v.l, v3_cross(v.w, r))));
}
RL_HD SV xform_force_to_parent(const M3& E, V3 r, const SV& f) {
  const V3 fA = m3_tvec(E, f.l);
  const V3 nA = v3_add(m3_tvec(E, f.w), v3_cross(r, fA));
  return sv(nA, fA);
}
// X^T M X for X(E, r) = [[E, 0], [-E rx, E]]
RL_HD SM xform_inertia_to_parent(const M3& E, V3 r, const SM& M) {
  const M3 Et = m3_t(E);
  const M3 rx = m3_skew(r);
  const M3 Erx = m3_mul(E, rx);
  const M3 Y00 = m3_sub(m3_mul(M.b[0][0], E), m3_mul(M.b[0][1], Erx));
  const M3 Y01 = m3_mul(M.b[0][1], E);
  const M3 Y10 = m3_sub(m3_mul(M.b[1][0], E), m3_mul(M.b[1][1], Erx));
  const M3 Y11 = m3_mul(M.b[1][1], E);
  const M3 rxEt = m3_mul(rx, Et);
  SM Z;
  Z.b[0][0] = m3_add(m3_mul(Et, Y00), m3_mul(rxEt, Y10));
  Z.b[0][1] = m3_add(m3_mul(Et, Y01), m3_mul(rxEt, Y11));
  Z.b[1][0] = m3_mul(Et, Y10);
  Z.b[1][1] = m3_mul(Et, Y11);
  return Z;
}
// X Phi X^T: an inverse inertia from parent to child coordinates
RL_HD SM xform_phi_to_child(const M3& E, V3 r, const SM& Phi) {
  const M3& A = Phi.b[0][0];
  const M3& B = Phi.b[0][1];
  const M3& C = Phi.b[1][0];
  const M3& D = Phi.b[1][1];
  const M3 Et = m3_t(E);
  const M3 Sm = m3_scale(m3_skew(r), -1.0f);
  const M3 St = m3_t(Sm);
  const M3 SmA = m3_mul(Sm, A);
  const M3 SmAC = m3_add(SmA, C);
  SM Z;
  Z.b[0][0] = m3_mul(m3_mul(E, A), Et);
  Z.b[0][1] = m3_mul(m3_mul(E, m3_add(m3_mul(A, St), B)), Et);
  Z.b[1][0] = m3_mul(m3_mul(E, SmAC), Et);
  Z.b[1][1] = m3_mul(m3_mul(E, m3_add(m3_add(m3_mul(SmAC, St), m3_mul(Sm, B)), D)), Et);
  return Z;
}

// ---- 6x6 SPD: Cholesky factor and solves ----------------------------------
RL_HD void chol6(const SM& M, float L[6][6]) {
  float A[6][6];
  for (int bi = 0; bi < 2; ++bi)
    for (int bj = 0; bj < 2; ++bj)
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) A[bi * 3 + i][bj * 3 + j] = M.b[bi][bj].m[i][j];
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv_d = 1.0f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
}
RL_HD void chol6_solve(const float L[6][6], const float rhs[6], float x[6]) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}
RL_HD SV solve_psd6(const SM& M, const SV& b) {
  float L[6][6], rhs[6], x[6];
  chol6(M, L);
  for (int i = 0; i < 3; ++i) { rhs[i] = b.w.v[i]; rhs[3 + i] = b.l.v[i]; }
  chol6_solve(L, rhs, x);
  return sv(v3(x[0], x[1], x[2]), v3(x[3], x[4], x[5]));
}
// ---- world boxes -------------------------------------------------------------
RL_HD float sign_of(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// Penalty force on one sphere (center pg, velocity vg) against every box of
// the world block w placed at origin, summed over the boxes in box order.
// A center inside a box is pushed out through the nearest face: the first
// axis of least distance to the surface, by the <= chain of the plain version.
RL_HD V3 world_force(const float* w, V3 origin, V3 pg, V3 vg, float rad,
                     float m_eff, float den_n, float dt) {
  const int nbox = (int)w[RL_W_NBOX];
  const float k = w[RL_W_K], c_n = w[RL_W_CN], wmu = w[RL_W_MU];
  const float eps = w[RL_W_EPS];
  V3 total = v3_zero();
#pragma unroll 1
  for (int i = 0; i < nbox; ++i) {
    const float* bx = w + RL_W_HDR + RL_W_BOX * i;
    float rel[3], delta[3], fd[3];
    for (int a = 0; a < 3; ++a) {
      const float h = bx[3 + a];
      rel[a] = pg.v[a] - (origin.v[a] + bx[a]);
      const float cl = fminf(fmaxf(rel[a], -h), h);
      delta[a] = rel[a] - cl;
      fd[a] = h - fabsf(rel[a]);
    }
    const V3 dl = v3(delta[0], delta[1], delta[2]);
    const float dist = v3_norm(dl, 1e-18f);
    const bool inside = dist < 1e-6f;
    const float min_fd = fminf(fd[0], fminf(fd[1], fd[2]));
    const bool a0 = (fd[0] <= fd[1]) && (fd[0] <= fd[2]);
    const bool a1 = !a0 && (fd[1] <= fd[2]);
    const bool a2 = !a0 && !a1;
    const float inv_d = 1.0f / fmaxf(dist, 1e-6f);
    const V3 n = inside ? v3(sign_of(rel[0]) * (a0 ? 1.0f : 0.0f),
                             sign_of(rel[1]) * (a1 ? 1.0f : 0.0f),
                             sign_of(rel[2]) * (a2 ? 1.0f : 0.0f))
                        : v3(delta[0] * inv_d, delta[1] * inv_d, delta[2] * inv_d);
    const float depth = fmaxf(rad - dist, 0.0f) * (inside ? 0.0f : 1.0f)
                        + (min_fd + rad) * (inside ? 1.0f : 0.0f);
    const float in_c = depth > 0.0f ? 1.0f : 0.0f;
    const float v_n = v3_dot(vg, n);
    const V3 v_t = v3_sub(vg, v3_scale(n, v_n));
    const float f_n = fmaxf((k * depth - c_n * v_n) / den_n, 0.0f) * in_c;
    const float vt_norm = v3_norm(v_t, 1e-18f);
    const float c_t = wmu * f_n / (vt_norm + eps);
    const float ft_scale = -(c_t / (1.0f + c_t * dt / m_eff));
    total = v3_add(total, v3_add(v3_scale(n, f_n), v3_scale(v_t, ft_scale)));
  }
  return total;
}

// ---- legacy ground contact ----------------------------------------------------
// Penalty force on one sphere (center pg, velocity vg) against the ground of
// height h and unit normal n under it: the spring-damper along n, its
// damping scaled by the env's zeta, and regularised Coulomb friction, each
// solved implicitly against m_eff (the mass of the geom's body).
RL_HD V3 legacy_force(V3 pg, V3 vg, float h, V3 n, float rad, float m_eff,
                      float zeta, float mu, const float* hdr, float dt) {
  const float depth = fmaxf(h + rad - pg.v[2], 0.0f);
  const float in_c = depth > 0.0f ? 1.0f : 0.0f;
  const float v_n = v3_dot(vg, n);
  const V3 v_t = v3_sub(vg, v3_scale(n, v_n));
  const float c_n = zeta * hdr[RL_H_DAMP] + hdr[RL_H_KDT];
  const float f_n = fmaxf((hdr[RL_H_K] * depth - c_n * v_n) / (1.0f + c_n * dt / m_eff), 0.0f) * in_c;
  const float vt_norm = v3_norm(v_t, 1e-12f);
  const float c_t = mu * f_n / (vt_norm + hdr[RL_H_VEPS]);
  const float ft_scale = -(c_t / (1.0f + c_t * dt / m_eff));
  return v3_add(v3_scale(n, f_n), v3_scale(v_t, ft_scale));
}

RL_HD SM inv_psd6(const SM& M) {
  float L[6][6], cols[6][6];
  chol6(M, L);
  for (int k = 0; k < 6; ++k) {
    float rhs[6];
    for (int i = 0; i < 6; ++i) rhs[i] = (i == k) ? 1.0f : 0.0f;
    chol6_solve(L, rhs, cols[k]);
  }
  SM r;  // cols[k][i] = (M^-1)[i][k]
  for (int bi = 0; bi < 2; ++bi)
    for (int bj = 0; bj < 2; ++bj)
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) r.b[bi][bj].m[i][j] = cols[bj * 3 + j][bi * 3 + i];
  return r;
}

// ---- the per-env chain ----------------------------------------------------
template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
struct Chain {
  static_assert(LEG || !FIX, "a fixed base needs the legacy contact model");
  static constexpr int NL = D * K;       // limb bodies = joints
  static constexpr int NB = NL + 1;      // + base
  static constexpr int TNG = TER ? RL_MAX_NG : 1;  // terrain geom slots
  static constexpr int NPHI = LEG ? 1 : NB;        // apparent-inertia slots
  static constexpr int NLAM = LEG ? 1 : RL_MAX_NG;

  // slot of the parent of limb slot l (chains hang off the base)
  static RL_HD int parent_slot(int l) { return l < K ? 0 : 1 + (l - K); }

  // Bias sweep + base acceleration + forward sweep for one external-force
  // set (f_ext == nullptr: none); writes the body accelerations a_sp and qdd
  // (by slot). Mirrors soa_physics.substep_chain.bias_and_accels; a fixed
  // base accelerates at -g_b (gravity in base coordinates), no solve.
  static RL_HD void bias_and_accels(
      const SV* pA_vel, const SV* f_ext, const float* tau_t, const SM* Ia_s,
      const SV* c_sp, const SV* U, const float* dinv, const M3* E_up,
      const SM& IA0, V3 g_b, const float* cst, SV* a_sp, float* qdd) {
    SV pA[NB];
#pragma unroll 1
    for (int b = 0; b < NB; ++b) pA[b] = f_ext ? sv_sub(pA_vel[b], f_ext[b]) : pA_vel[b];
    float u[NB];
#pragma unroll 1
    for (int d = D - 1; d >= 0; --d)
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int s = d * K + k;
      const float* c = cst + RL_HDR + RL_BASE_SIZE + s * RL_SLOT;
      const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
      const int b = 1 + s;
      const float ub = tau_t[s] - sv_dot(Si, pA[b]);
      u[b] = ub;
      const SV pa = sv_add(sv_add(pA[b], sm_vec(Ia_s[b], c_sp[b])), sv_scale(U[b], ub * dinv[b]));
      const int par = parent_slot(s);
      pA[par] = sv_add(pA[par], xform_force_to_parent(E_up[b], v3_load(c + RL_S_P), pa));
    }
    if constexpr (FIX) {
      a_sp[0] = sv(v3_zero(), v3_scale(g_b, -1.0f));
    } else {
      const SV sol = solve_psd6(IA0, pA[0]);
      a_sp[0] = sv(v3_scale(sol.w, -1.0f), v3_scale(sol.l, -1.0f));
    }
#pragma unroll 1
    for (int s = 0; s < NL; ++s) {
      const float* c = cst + RL_HDR + RL_BASE_SIZE + s * RL_SLOT;
      const int b = 1 + s;
      const SV ap = sv_add(xform_motion(E_up[b], v3_load(c + RL_S_P), a_sp[parent_slot(s)]), c_sp[b]);
      qdd[s] = (u[b] - sv_dot(U[b], ap)) * dinv[b];
      const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
      a_sp[b] = sv_add(ap, sv_scale(Si, qdd[s]));
    }
  }

  static RL_HD void run(const float* __restrict__ x, float* __restrict__ y,
                        const float* __restrict__ cst, int n, int i) {
    const float* h = cst;
    const int nsub = (int)h[RL_H_NSUB];
    const float dt = h[RL_H_DT];
    const float inv_dt = h[RL_H_INV_DT];
    const float half_dt = h[RL_H_HALF_DT];
    const float gz = h[RL_H_GZ];
    const float erp_dt = h[RL_H_ERP_DT];
    const float max_depen = h[RL_H_MAX_DEPEN];
    const float bounce_thr = h[RL_H_BOUNCE];
    const float jfric = h[RL_H_JFRIC];
    const float a_patch = h[RL_H_PATCH];
    const float base_split = h[RL_H_SPLIT];
    const float mass0 = h[RL_H_MASS0];
    const int ng = (int)h[RL_H_NG];
    const int nr = (int)h[RL_H_NR];
    const float* cbase = cst + RL_BASE;
    const float* cslot = cst + RL_HDR + RL_BASE_SIZE;
    const float* cgeom = cslot + NL * RL_SLOT;
    const float* cworld = cgeom + ng * RL_GEOM;
    const size_t N = (size_t)n;
#define RL_X(ch) x[(size_t)(ch) * N + i]
#define RL_Y(ch) y[(size_t)(ch) * N + i]

    // ---- inputs -----------------------------------------------------------
    V3 base_pos = v3(RL_X(0), RL_X(1), RL_X(2));
    float base_quat[4] = {RL_X(3), RL_X(4), RL_X(5), RL_X(6)};
    V3 base_v = v3(RL_X(7), RL_X(8), RL_X(9));
    V3 base_w = v3(RL_X(10), RL_X(11), RL_X(12));
    float q[NL], qd[NL], tau[NL], imp[NL];  // by slot
#pragma unroll 1
    for (int s = 0; s < NL; ++s) {
      const int j = (int)cslot[s * RL_SLOT + RL_S_J];
      q[s] = RL_X(13 + j);
      qd[s] = RL_X(13 + NL + j);
      tau[s] = RL_X(13 + 2 * NL + j);
      imp[s] = IMP ? RL_X(13 + 3 * NL + 6 + j) : 0.0f;
    }
    const int cp = 13 + 3 * NL;
    const float payload = RL_X(cp);
    const V3 com_disp = v3(RL_X(cp + 1), RL_X(cp + 2), RL_X(cp + 3));
    const float restitution = RL_X(cp + 4);
    const float mu = RL_X(cp + 5);
    const float zeta = fminf(fmaxf(1.0f - restitution, 0.08f), 1.0f);  // legacy

    // terrain under each geom, in the channel order of the TPU kernel: ng
    // heights, then ng normals (x, y, z per geom); read once per call
    float g_h[TNG];
    V3 g_n[TNG];
    if constexpr (TER) {
      const int ct = cp + 6 + (IMP ? NL : 0);
#pragma unroll 1
      for (int g = 0; g < ng; ++g) {
        g_h[g] = RL_X(ct + g);
        g_n[g] = v3(RL_X(ct + ng + 3 * g), RL_X(ct + ng + 3 * g + 1),
                    RL_X(ct + ng + 3 * g + 2));
      }
    } else {
      g_h[0] = 0.0f;
      g_n[0] = v3(0.0f, 0.0f, 1.0f);  // the plane z=0
    }
    // the env origin, after the terrain rows (the TPU kernel's order)
    V3 origin = v3_zero();
    if constexpr (WLD) {
      const int co = cp + 6 + (IMP ? NL : 0) + (TER ? 4 * ng : 0);
      origin = v3(RL_X(co), RL_X(co + 1), RL_X(co + 2));
    }

    // ---- per-body scratch ---------------------------------------------------
    M3 R_b[NB], E_up[NB];
    V3 p_b[NB], w_b[NB], v_b[NB];
    SM IA[NB], Ia_s[NB];
    SV v_sp[NB], c_sp[NB], pA_vel[NB], U[NB], a_sp[NB], f_ext[NB];
    float dinv[NB], tau_t[NL], qdd[NL];
    M3 phiA[NPHI], phiB[NPHI], phiD[NPHI];  // world-frame Phi blocks (substep 0)
    M3 lam_w[NLAM];                         // per-geom inverse apparent inertia
    V3 rep[RL_MAX_NR];
    const int off_rep = 13 + 2 * NL;
    const int off_gpos = off_rep + 3 * nr;

#pragma unroll 1
    for (int sub = 0; sub < nsub; ++sub) {
      // ---- FK ---------------------------------------------------------------
      const M3 R0 = quat_to_m3(base_quat);
      R_b[0] = R0; p_b[0] = base_pos; w_b[0] = base_w; v_b[0] = base_v;
#pragma unroll 1
      for (int s = 0; s < NL; ++s) {
        const float* c = cslot + s * RL_SLOT;
        const int b = 1 + s, par = parent_slot(s);
        const V3 ax = v3_load(c + RL_S_AX);
        const M3 Rj = m3_axis_angle(ax, m3_load(c + RL_S_KK), q[s]);
        const M3 Rpc = m3_mul(m3_load(c + RL_S_E), Rj);
        E_up[b] = m3_t(Rpc);
        R_b[b] = m3_mul(R_b[par], Rpc);
        p_b[b] = v3_add(m3_vec(R_b[par], v3_load(c + RL_S_P)), p_b[par]);
        w_b[b] = v3_add(w_b[par], m3_vec(R_b[b], v3_scale(ax, qd[s])));
        v_b[b] = v3_add(v_b[par], v3_cross(w_b[par], v3_sub(p_b[b], p_b[par])));
      }

      // ---- joint torques (PD input + passive) ---------------------------------
#pragma unroll 1
      for (int s = 0; s < NL; ++s) {
        const float* c = cslot + s * RL_SLOT;
        const float lo = c[RL_S_LO], hi = c[RL_S_HI];
        const float below = fminf(q[s] - lo, 0.0f);
        const float above = fmaxf(q[s] - hi, 0.0f);
        const float viol = ((q[s] < lo) || (q[s] > hi)) ? 1.0f : 0.0f;
        tau_t[s] = tau[s] - c[RL_S_DAMP] * qd[s] - jfric * tanhf(qd[s] / 0.1f)
                   - 300.0f * (below + above) - 2.0f * qd[s] * viol;
      }

      // ---- ABA: inertias, velocities, bias ------------------------------------
      const float base_mass = mass0 + payload;
      const V3 base_com = v3(com_disp.v[0] + cbase[0], com_disp.v[1] + cbase[1],
                             com_disp.v[2] + cbase[2]);
      const float scale = base_mass / mass0;
      M3 I0s;
      for (int a = 0; a < 3; ++a)
        for (int bb = 0; bb < 3; ++bb) I0s.m[a][bb] = cbase[3 + a * 3 + bb] * scale;
      IA[0] = spatial_inertia(base_mass, base_com, I0s);
#pragma unroll 1
      for (int s = 0; s < NL; ++s) IA[1 + s] = sm_load(cslot + s * RL_SLOT + RL_S_M6);

      v_sp[0] = sv(m3_tvec(R0, base_w), m3_tvec(R0, base_v));
#pragma unroll 1
      for (int s = 0; s < NL; ++s) {
        const float* c = cslot + s * RL_SLOT;
        const int b = 1 + s;
        const SV Sqd = sv(v3_scale(v3_load(c + RL_S_AX), qd[s]), v3_zero());
        const SV vi = sv_add(xform_motion(E_up[b], v3_load(c + RL_S_P), v_sp[parent_slot(s)]), Sqd);
        v_sp[b] = vi;
        c_sp[b] = crm(vi, Sqd);
      }
#pragma unroll 1
      for (int b = 0; b < NB; ++b) pA_vel[b] = crf(v_sp[b], sm_vec(IA[b], v_sp[b]));

      // backward articulated-inertia sweep: U, 1/d, Ia
#pragma unroll 1
      for (int d = D - 1; d >= 0; --d)
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const int s = d * K + k;
        const float* c = cslot + s * RL_SLOT;
        const int b = 1 + s, par = parent_slot(s);
        const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
        const SV Ub = sm_vec(IA[b], Si);
        const float db = fmaxf(sv_dot(Si, Ub) + c[RL_S_ARM] + (IMP ? dt * imp[s] : 0.0f), 1e-9f);
        U[b] = Ub;
        dinv[b] = 1.0f / db;
        const SM Ia = sm_add(IA[b], sm_scale(sm_outer(Ub, Ub), -1.0f / db));
        Ia_s[b] = Ia;
        IA[par] = sm_add(IA[par], xform_inertia_to_parent(E_up[b], v3_load(c + RL_S_P), Ia));
      }
      const V3 gvec = v3(0.0f, 0.0f, gz);
      const V3 g_b = m3_tvec(R0, gvec);

      // ---- inverse apparent inertia per body, world frame (substep 0) ---------
      if constexpr (!LEG) {
        if (sub == 0) {
          SM Phi[NB];
          Phi[0] = sm_scale(inv_psd6(IA[0]), base_split);
#pragma unroll 1
          for (int s = 0; s < NL; ++s) {
            const float* c = cslot + s * RL_SLOT;
            const int b = 1 + s;
            const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
            const SM Phi_x = xform_phi_to_child(E_up[b], v3_load(c + RL_S_P), Phi[parent_slot(s)]);
            const SV MU = sm_vec(Phi_x, U[b]);
            const float uMu = sv_dot(U[b], MU);
            SM Phi_b = sm_add(Phi_x, sm_scale(sm_outer(Si, MU), -dinv[b]));
            Phi_b = sm_add(Phi_b, sm_scale(sm_outer(MU, Si), -dinv[b]));
            Phi_b = sm_add(Phi_b, sm_scale(sm_outer(Si, Si), dinv[b] + uMu * dinv[b] * dinv[b]));
            Phi[b] = Phi_b;
          }
#pragma unroll 1
          for (int b = 0; b < NB; ++b) {
            const M3 Rt = m3_t(R_b[b]);
            phiA[b] = m3_mul(m3_mul(R_b[b], Phi[b].b[0][0]), Rt);
            phiB[b] = m3_mul(m3_mul(R_b[b], Phi[b].b[0][1]), Rt);
            phiD[b] = m3_mul(m3_mul(R_b[b], Phi[b].b[1][1]), Rt);
          }
        }
      }

      // ---- free dynamics -> free point accelerations (apparent model) ---------
      float n_active[NB];
#pragma unroll 1
      for (int b = 0; b < NB; ++b) { n_active[b] = 0.0f; f_ext[b] = sv(v3_zero(), v3_zero()); }
      if constexpr (!LEG) {
        bias_and_accels(pA_vel, nullptr, tau_t, Ia_s, c_sp, U, dinv, E_up, IA[0], g_b, cst, a_sp, qdd);
        // per-body active-contact counts for the Jacobi mass split
#pragma unroll 1
        for (int g = 0; g < ng; ++g) {
          const float* cg = cgeom + g * RL_GEOM;
          const int b = (int)cg[RL_G_SLOT];
          const V3 pg = v3_add(m3_vec(R_b[b], v3_load(cg + RL_G_OFF)), p_b[b]);
          const float h = TER ? g_h[g] : g_h[0];
          n_active[b] += (h + cg[RL_G_RAD] - pg.v[2] > 0.0f) ? 1.0f : 0.0f;
        }
      }
      if (sub == 0) {
#pragma unroll 1
        for (int r = 0; r < nr; ++r) rep[r] = v3_zero();
      }

      // ---- per-geom contact forces; gathered per body in geom order -----------
      // (the world forces in their own sums, added to the ground's after)
      V3 Fw[NB], Nw[NB], WFw[WLD ? NB : 1], WNw[WLD ? NB : 1];
#pragma unroll 1
      for (int b = 0; b < NB; ++b) { Fw[b] = v3_zero(); Nw[b] = v3_zero(); }
      if constexpr (WLD) {
#pragma unroll 1
        for (int b = 0; b < NB; ++b) { WFw[b] = v3_zero(); WNw[b] = v3_zero(); }
      }
#pragma unroll 1
      for (int g = 0; g < ng; ++g) {
        const float* cg = cgeom + g * RL_GEOM;
        const int b = (int)cg[RL_G_SLOT];
        const float rad = cg[RL_G_RAD];
        const float h = TER ? g_h[g] : g_h[0];
        const V3 nrm = TER ? g_n[g] : g_n[0];
        const V3 pg = v3_add(m3_vec(R_b[b], v3_load(cg + RL_G_OFF)), p_b[b]);
        const V3 vg = v3_add(v_b[b], v3_cross(w_b[b], v3_sub(pg, p_b[b])));
        if (sub == 0) {
          RL_Y(off_gpos + 3 * g + 0) = pg.v[0];
          RL_Y(off_gpos + 3 * g + 1) = pg.v[1];
          RL_Y(off_gpos + 3 * g + 2) = pg.v[2];
        }
        V3 gf, tq;
        if constexpr (LEG) {
          // the penalty force acts at the sphere center
          gf = legacy_force(pg, vg, h, nrm, rad, cg[RL_G_MEFF], zeta, mu, cst, dt);
          tq = v3_cross(v3_sub(pg, p_b[b]), gf);
        } else {
          const float in_c = (h + rad - pg.v[2] > 0.0f) ? 1.0f : 0.0f;
          // contact point on the sphere surface
          const V3 p_c = v3_sub(pg, v3_scale(nrm, rad));
          const V3 r_w = v3_sub(p_c, p_b[b]);
          const V3 v_c = v3_add(vg, v3_cross(w_b[b], v3_sub(p_c, pg)));
          if (sub == 0) {
            const M3 Sm = m3_scale(m3_skew(r_w), -1.0f);
            const M3 Smt = m3_t(Sm);
            const M3 SmB = m3_mul(Sm, phiB[b]);
            lam_w[g] = m3_add(m3_add(m3_mul(m3_mul(Sm, phiA[b]), Smt), m3_add(SmB, m3_t(SmB))), phiD[b]);
          }
          const V3 a_lin_true = v3_add(a_sp[b].l, m3_tvec(R_b[b], gvec));
          const V3 wdot_w = m3_vec(R_b[b], a_sp[b].w);
          const V3 a_org_w = v3_add(m3_vec(R_b[b], a_lin_true), v3_cross(w_b[b], v_b[b]));
          const V3 a_pt = v3_add(v3_add(a_org_w, v3_cross(wdot_w, r_w)),
                                 v3_cross(w_b[b], v3_cross(w_b[b], r_w)));

          // TGS-style velocity constraint solve against lam_w[g]
          const float depth = fmaxf(h + rad - pg.v[2], 0.0f);
          const V3 v_pred = v3_add(v_c, v3_scale(a_pt, dt));
          const float v_n_now = v3_dot(v_c, nrm);
          const float bias = fminf(erp_dt * depth, max_depen);
          const float bounce = (v_n_now < -bounce_thr) ? -restitution * v_n_now : 0.0f;
          const float v_tgt_n = fmaxf(bias, bounce);
          const V3 dv = v3_sub(v3_scale(nrm, v_tgt_n), v_pred);
          const float split = fmaxf(n_active[b], 1.0f);
          const M3 lam_g = m3_scale(lam_w[g], split);
          const V3 f = m3_solve(lam_g, v3_scale(dv, inv_dt));
          float f_n = v3_dot(f, nrm);
          const V3 f_t = v3_sub(f, v3_scale(nrm, f_n));
          f_n = fmaxf(f_n, 0.0f) * in_c;
          const float ft_norm = v3_norm(f_t, 1e-18f);
          const float fscale = fminf(1.0f, mu * f_n / (ft_norm + 1e-9f)) * in_c;
          gf = v3_add(v3_scale(nrm, f_n), v3_scale(f_t, fscale));

          tq = v3_cross(v3_sub(p_c, p_b[b]), gf);
          if (a_patch > 0.0f) {
            // torsional friction, clamped to the cone mu * f_n * patch radius
            const float w_n = v3_dot(w_b[b], nrm);
            const float r_ang = fmaxf(v3_dot(nrm, m3_vec(phiA[b], nrm)) * split, 1e-6f);
            const float tau_max = mu * f_n * a_patch;
            const float tau_n = fminf(fmaxf(-w_n / (dt * r_ang), -tau_max), tau_max);
            tq = v3_add(tq, v3_scale(nrm, tau_n));
          }
        }
        Fw[b] = v3_add(Fw[b], gf);
        Nw[b] = v3_add(Nw[b], tq);
        V3 f_tot = gf;
        if constexpr (WLD) {
          // the walls push at the sphere center
          const V3 wf = world_force(cworld, origin, pg, vg, rad, cg[RL_G_MEFF],
                                    cg[RL_G_WDEN], dt);
          WFw[b] = v3_add(WFw[b], wf);
          WNw[b] = v3_add(WNw[b], v3_cross(v3_sub(pg, p_b[b]), wf));
          f_tot = v3_add(gf, wf);
        }
        if (sub == 0) {
          const int rb = (int)cg[RL_G_REP];
          rep[rb] = v3_add(rep[rb], f_tot);
        }
      }
#pragma unroll 1
      for (int b = 0; b < NB; ++b) {
        f_ext[b] = sv(m3_tvec(R_b[b], Nw[b]), m3_tvec(R_b[b], Fw[b]));
        if constexpr (WLD)
          f_ext[b] = sv_add(f_ext[b], sv(m3_tvec(R_b[b], WNw[b]), m3_tvec(R_b[b], WFw[b])));
      }
      if (sub == 0) {
#pragma unroll 1
        for (int r = 0; r < nr; ++r) {
          RL_Y(off_rep + 3 * r + 0) = rep[r].v[0];
          RL_Y(off_rep + 3 * r + 1) = rep[r].v[1];
          RL_Y(off_rep + 3 * r + 2) = rep[r].v[2];
        }
      }

      bias_and_accels(pA_vel, f_ext, tau_t, Ia_s, c_sp, U, dinv, E_up, IA[0], g_b, cst, a_sp, qdd);

      // ---- integrate (semi-implicit; a fixed base stays where it is) ----------
      if constexpr (FIX) {
        base_w = v3_zero();
        base_v = v3_zero();
      } else {
        const V3 a0w = a_sp[0].w;
        const V3 a0l = v3_add(a_sp[0].l, g_b);
        const V3 wdot_w = m3_vec(R0, a0w);
        const V3 acc_w = v3_add(m3_vec(R0, a0l), v3_cross(base_w, base_v));
        base_w = v3_add(base_w, v3_scale(wdot_w, dt));
        base_v = v3_add(base_v, v3_scale(acc_w, dt));
        base_pos = v3_add(base_pos, v3_scale(base_v, dt));
        quat_integrate(base_quat, base_w, half_dt);
      }
#pragma unroll 1
      for (int s = 0; s < NL; ++s) {
        const float vl = cslot[s * RL_SLOT + RL_S_VLIM];
        qd[s] = fminf(fmaxf(qd[s] + dt * qdd[s], -vl), vl);
        q[s] = q[s] + dt * qd[s];
      }
    }

    // ---- outputs ----------------------------------------------------------------
    for (int a = 0; a < 3; ++a) RL_Y(a) = base_pos.v[a];
    for (int a = 0; a < 4; ++a) RL_Y(3 + a) = base_quat[a];
    for (int a = 0; a < 3; ++a) RL_Y(7 + a) = base_v.v[a];
    for (int a = 0; a < 3; ++a) RL_Y(10 + a) = base_w.v[a];
#pragma unroll 1
    for (int s = 0; s < NL; ++s) {
      const int j = (int)cslot[s * RL_SLOT + RL_S_J];
      RL_Y(13 + j) = q[s];
      RL_Y(13 + NL + j) = qd[s];
    }
#undef RL_X
#undef RL_Y
  }
};

}  // namespace rl
