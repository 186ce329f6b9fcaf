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
// operation and in the same order, for ONE env, run by a team of lanes in
// phases (Chain::run, below): the limb chains, geoms, bodies and slots are
// split over the lanes, and every sum keeps the plain version's order. The
// same source builds under nvcc (physics_step.cu, a warp per env) and under
// g++ (physics_step_host.cpp, a loop over envs, each phase's lanes in turn),
// where RL_HD is empty.
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
#include <stddef.h>

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
// 6x6 as 2x2 blocks; 16-byte aligned (144 B) so that the 6x6 blocks of the
// shared scratch can load and store 4 floats an instruction
struct alignas(16) SM { M3 b[2][2]; };

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
RL_HD float& sm_at(SM& M, int e) {  // element e of the 36, block by block
  return M.b[e / 18][(e / 9) % 2].m[(e % 9) / 3][e % 3];
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


// ---- the team ---------------------------------------------------------------
// One env is run by a team of RL_TEAM lanes, in phases. Within a phase each
// lane works on its own items (a limb chain, a body, a slot, a geom) and no
// lane reads what another lane of the same phase writes. RL_PHASE(lane) { ... }
// is a phase, and the team's sync after it is part of the construct (the
// loop's step), so no phase can end without one; a phase body holds no
// `break` or `return` of its own loop. On the card a team is a warp and the
// sync is __syncwarp(). Under g++ a phase runs its lanes one after another
// (last to first with RL_HOST_LANES_REVERSED, a test hook: both orders give
// the same bits unless a phase has a race) and the sync is empty.
#define RL_TEAM 32
#if defined(__CUDACC__) && defined(RL_PHASE_CLOCKS)
// a timing build (PhysicsStepKernel(phase_clocks=True)): the first warp of
// block 0 notes clock64() at its start and at the end of every phase
__device__ long long rl_phase_clock[512];
__device__ int rl_phase_count;
#endif
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void rl_team_sync() {
  __syncwarp();
#ifdef RL_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0 && rl_phase_count < 512)
    rl_phase_clock[rl_phase_count++] = clock64();
#endif
}
#define RL_PHASE(l)                                                          \
  for (int l = (int)(threadIdx.x & (RL_TEAM - 1)), l##_once = 1; l##_once; \
       l##_once = 0, rl_team_sync())
#else
#ifdef RL_HOST_LANES_REVERSED
#define RL_LANE_AT(j) (RL_TEAM - 1 - (j))
#else
#define RL_LANE_AT(j) (j)
#endif
#define RL_PHASE(l) \
  for (int l##_j = 0, l = RL_LANE_AT(0); l##_j < RL_TEAM; ++l##_j, l = RL_LANE_AT(l##_j))
#endif

// ---- the per-env chain ----------------------------------------------------
template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
struct Chain {
  static_assert(LEG || !FIX, "a fixed base needs the legacy contact model");
  static constexpr int NL = D * K;       // limb bodies = joints
  static constexpr int NB = NL + 1;      // + base
  static constexpr int TNG = TER ? RL_MAX_NG : 1;  // terrain geom slots
  static constexpr int NPHI = LEG ? 1 : NB;        // apparent-inertia slots
  static constexpr int NLAM = LEG ? 1 : RL_MAX_NG;
  static constexpr int NW = WLD ? RL_MAX_NG : 1;
  static constexpr int BASE = RL_TEAM - 1;         // the lane of the base's work
  static_assert(K < BASE && NL < BASE && 4 * K <= RL_TEAM,
                "the team is too small for the layout");

  // The per-window arrays that share the scratch's union. Each is live in one
  // window of a substep only: v_sp in FK, Sweep from the joint rotations to
  // the base's sum, PhiW from the apparent-inertia pass to the contact flags
  // (substep 0), Bias inside a bias sweep, Geom from the contact flags to the
  // per-body sums.
  // the inertia sweep: a level's Ia and Y = Ia X by limb, E rx and rx E^T by
  // slot (formed with the joint rotations), and the level-0 inertias pushed
  // to the base, by limb
  struct Sweep { SM IA_k[K], Ia[K], Y[K]; M3 Erx[NL], rxEt[NL]; };
  // substep 0: Phi, then the world-frame blocks B and D that the contact
  // flags read
  struct PhiW { SM Phi[NPHI]; M3 wB[NPHI], wD[NPHI]; };
  struct Bias { SV pA[NB]; SV pA_k[K]; float u[NB]; };
  struct Geom { float in_c[NLAM]; V3 F[RL_MAX_NG], T[RL_MAX_NG], WF[NW], WT[NW]; };
  // Where two windows meet inside one phase, or a window outlives a phase
  // that writes another, the layout keeps them apart (an overlap would be a
  // race on the card that the g++ build sees only in the layout it builds):
  // E rx and rx E^T are formed beside v_sp[0] and read after FK writes v_sp;
  static_assert(offsetof(Sweep, Erx) >= sizeof(SV) * NB, "Sweep::Erx overlaps v_sp");
  // B and D wait through the free bias sweep, which writes Bias;
  static_assert(LEG || sizeof(Bias) <= offsetof(PhiW, wB), "Bias overlaps PhiW::wB");
  // and the contact flags write in_c while other lanes read B and D.
  static_assert(LEG || offsetof(Geom, in_c) + sizeof(float) * NLAM <= offsetof(PhiW, wB),
                "Geom::in_c overlaps PhiW::wB");

  // Per-env scratch: shared memory on the card, the stack under g++.
  struct Scratch {
    V3 base_pos, base_v, base_w, com_disp, origin, g_b;
    float base_quat[4];
    float payload, restitution, mu, zeta;
    float q[NL], qd[NL], tau[NL], imp[NL];   // by slot
    float tau_t[NL], qdd[NL];
    float g_h[TNG];
    V3 g_n[TNG];
    // per body: 0 = base, 1 + s = limb slot s
    M3 R_b[NB], E_up[NB];
    V3 p_b[NB], w_b[NB], v_b[NB];
    SM IA[NB];          // articulated inertias; after the sweep IA[b > 0] is Ia_s
    SV c_sp[NB], pA_vel[NB], U[NB], a_sp[NB], f_ext[NB];
    SV Ic[NB];          // Ia_s c_sp, the same in both bias sweeps of a substep
    float dinv[NB], n_active[NB];
    float L[6][6];      // Cholesky factor of IA[0], once per substep
    M3 phiA[NPHI];      // world-frame Phi block A (torsion, every substep)
    M3 lam_w[NLAM];     // per-geom inverse apparent inertia
    union { SV v_sp[NB]; Sweep sw; PhiW phi; Bias bias; Geom geom; };
  };

  // Each body's and each report body's geoms, linked in geom order: the
  // same for every env, built once per block (per call under g++).
  struct GeomLists {
    signed char head[NB], next[RL_MAX_NG];         // by body
    signed char rhead[RL_MAX_NR], rnext[RL_MAX_NG];  // by report body
  };

  // One phase: lane b scans the geoms last to first and pushes those of
  // body b (and of report body b) to the front of its list.
  static RL_HD void build_lists(const float* cst, GeomLists& gl) {
    const int ng = (int)cst[RL_H_NG], nr = (int)cst[RL_H_NR];
    const float* cgeom = cst + RL_HDR + RL_BASE_SIZE + NL * RL_SLOT;
    RL_PHASE(lane) {
      for (int b = lane; b < NB; b += RL_TEAM) {
        int h = -1;
        for (int g = ng - 1; g >= 0; --g)
          if ((int)cgeom[g * RL_GEOM + RL_G_SLOT] == b) { gl.next[g] = (signed char)h; h = g; }
        gl.head[b] = (signed char)h;
      }
      for (int r = lane; r < nr; r += RL_TEAM) {
        int h = -1;
        for (int g = ng - 1; g >= 0; --g)
          if ((int)cgeom[g * RL_GEOM + RL_G_REP] == r) { gl.rnext[g] = (signed char)h; h = g; }
        gl.rhead[r] = (signed char)h;
      }
    }
  }

  // slot of the parent of limb slot l (chains hang off the base)
  static RL_HD int parent_slot(int l) { return l < K ? 0 : 1 + (l - K); }
  static RL_HD const float* slot_c(const float* cst, int s) {
    return cst + RL_HDR + RL_BASE_SIZE + s * RL_SLOT;
  }

  // The Cholesky factor of the base's articulated inertia, on one lane.
  static RL_HD void factor_base(Scratch& s) {
    float L[6][6];
    chol6(s.IA[0], L);
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c <= r; ++c) s.L[r][c] = L[r][c];
  }

  // Bias sweep + base acceleration + forward sweep for one external-force
  // set (with_f: s.f_ext, else none); writes s.a_sp and s.qdd (by slot).
  // Mirrors soa_physics.substep_chain.bias_and_accels: the limbs in
  // parallel, their level-0 forces added to the base's in limb order; a
  // fixed base accelerates at -g_b (gravity in base coordinates), no solve.
  // With factor, the base lane factors IA[0] while the limbs sweep.
  static RL_HD void bias_and_accels(Scratch& s, const float* cst, bool with_f,
                                    bool factor) {
    RL_PHASE(lane) {
      if (lane < K) {
        for (int d = 0; d < D; ++d) {
          const int b = 1 + d * K + lane;
          s.bias.pA[b] = with_f ? sv_sub(s.pA_vel[b], s.f_ext[b]) : s.pA_vel[b];
        }
#pragma unroll 1
        for (int d = D - 1; d >= 0; --d) {
          const int sl = d * K + lane;
          const float* c = slot_c(cst, sl);
          const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
          const int b = 1 + sl;
          const float ub = s.tau_t[sl] - sv_dot(Si, s.bias.pA[b]);
          s.bias.u[b] = ub;
          const SV pa = sv_add(sv_add(s.bias.pA[b], s.Ic[b]),
                               sv_scale(s.U[b], ub * s.dinv[b]));
          const SV up = xform_force_to_parent(s.E_up[b], v3_load(c + RL_S_P), pa);
          if (d > 0) {
            const int par = parent_slot(sl);
            s.bias.pA[par] = sv_add(s.bias.pA[par], up);
          } else {
            s.bias.pA_k[lane] = up;
          }
        }
      }
      if (lane == BASE) {
        s.bias.pA[0] = with_f ? sv_sub(s.pA_vel[0], s.f_ext[0]) : s.pA_vel[0];
        if constexpr (!FIX) {
          if (factor) factor_base(s);
        }
      }
    }
    RL_PHASE(lane) {
      if (lane == BASE) {
        if constexpr (FIX) {
          s.a_sp[0] = sv(v3_zero(), v3_scale(s.g_b, -1.0f));
        } else {
          SV p0 = s.bias.pA[0];
          for (int k = 0; k < K; ++k) p0 = sv_add(p0, s.bias.pA_k[k]);
          float rhs[6], x6[6];
          for (int a = 0; a < 3; ++a) { rhs[a] = p0.w.v[a]; rhs[3 + a] = p0.l.v[a]; }
          chol6_solve(s.L, rhs, x6);
          s.a_sp[0] = sv(v3_scale(v3(x6[0], x6[1], x6[2]), -1.0f),
                         v3_scale(v3(x6[3], x6[4], x6[5]), -1.0f));
        }
      }
    }
    RL_PHASE(lane) {
      if (lane < K) {
#pragma unroll 1
        for (int d = 0; d < D; ++d) {
          const int sl = d * K + lane;
          const float* c = slot_c(cst, sl);
          const int b = 1 + sl;
          const SV ap = sv_add(xform_motion(s.E_up[b], v3_load(c + RL_S_P),
                                            s.a_sp[parent_slot(sl)]), s.c_sp[b]);
          const float qdd = (s.bias.u[b] - sv_dot(s.U[b], ap)) * s.dinv[b];
          s.qdd[sl] = qdd;
          const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
          s.a_sp[b] = sv_add(ap, sv_scale(Si, qdd));
        }
      }
    }
  }

  static RL_HD void run(const float* __restrict__ x, float* __restrict__ y,
                        const float* __restrict__ cst, int n, int i,
                        const GeomLists& gl, Scratch& s) {
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
    const V3 gvec = v3(0.0f, 0.0f, gz);
    const int off_rep = 13 + 2 * NL;
    const int off_gpos = off_rep + 3 * nr;
    const int cp = 13 + 3 * NL;
    const int ct = cp + 6 + (IMP ? NL : 0);        // terrain rows
    const int co = ct + (TER ? 4 * ng : 0);        // env origin rows
#define RL_X(ch) x[(size_t)(ch) * N + i]
#define RL_Y(ch) y[(size_t)(ch) * N + i]

    // ---- inputs: each channel row read once ----------------------------------
    RL_PHASE(lane) {
      if (lane == BASE) {
        s.base_pos = v3(RL_X(0), RL_X(1), RL_X(2));
        for (int a = 0; a < 4; ++a) s.base_quat[a] = RL_X(3 + a);
        s.base_v = v3(RL_X(7), RL_X(8), RL_X(9));
        s.base_w = v3(RL_X(10), RL_X(11), RL_X(12));
        s.payload = RL_X(cp);
        s.com_disp = v3(RL_X(cp + 1), RL_X(cp + 2), RL_X(cp + 3));
        s.restitution = RL_X(cp + 4);
        s.mu = RL_X(cp + 5);
        s.zeta = fminf(fmaxf(1.0f - s.restitution, 0.08f), 1.0f);  // legacy
        s.origin = WLD ? v3(RL_X(co), RL_X(co + 1), RL_X(co + 2)) : v3_zero();
      }
      for (int sl = lane; sl < NL; sl += RL_TEAM) {
        const int j = (int)slot_c(cst, sl)[RL_S_J];
        s.q[sl] = RL_X(13 + j);
        s.qd[sl] = RL_X(13 + NL + j);
        s.tau[sl] = RL_X(13 + 2 * NL + j);
        s.imp[sl] = IMP ? RL_X(13 + 3 * NL + 6 + j) : 0.0f;
      }
      // terrain under each geom, in the channel order of the TPU kernel: ng
      // heights, then ng normals (x, y, z per geom)
      if constexpr (TER) {
        for (int g = lane; g < ng; g += RL_TEAM) {
          s.g_h[g] = RL_X(ct + g);
          s.g_n[g] = v3(RL_X(ct + ng + 3 * g), RL_X(ct + ng + 3 * g + 1),
                        RL_X(ct + ng + 3 * g + 2));
        }
      }
    }

#pragma unroll 1
    for (int sub = 0; sub < nsub; ++sub) {
      // ---- the base's kinematics and inertia; per slot the joint torque, the
      // limb inertia and the joint rotation ------------------------------------
      RL_PHASE(lane) {
        if (lane == BASE) {
          const M3 R0 = quat_to_m3(s.base_quat);
          s.R_b[0] = R0; s.p_b[0] = s.base_pos; s.w_b[0] = s.base_w; s.v_b[0] = s.base_v;
          const float base_mass = mass0 + s.payload;
          const V3 base_com = v3(s.com_disp.v[0] + cbase[0], s.com_disp.v[1] + cbase[1],
                                 s.com_disp.v[2] + cbase[2]);
          const float scale = base_mass / mass0;
          M3 I0s;
          for (int a = 0; a < 3; ++a)
            for (int bb = 0; bb < 3; ++bb) I0s.m[a][bb] = cbase[3 + a * 3 + bb] * scale;
          const SM IA0 = spatial_inertia(base_mass, base_com, I0s);
          s.IA[0] = IA0;
          const SV v0 = sv(m3_tvec(R0, s.base_w), m3_tvec(R0, s.base_v));
          s.v_sp[0] = v0;
          s.pA_vel[0] = crf(v0, sm_vec(IA0, v0));
          s.g_b = m3_tvec(R0, gvec);
        }
        for (int sl = lane; sl < NL; sl += RL_TEAM) {
          const float* c = slot_c(cst, sl);
          const float q = s.q[sl], qd = s.qd[sl];
          const float lo = c[RL_S_LO], hi = c[RL_S_HI];
          const float below = fminf(q - lo, 0.0f);
          const float above = fmaxf(q - hi, 0.0f);
          const float viol = ((q < lo) || (q > hi)) ? 1.0f : 0.0f;
          s.tau_t[sl] = s.tau[sl] - c[RL_S_DAMP] * qd - jfric * tanhf(qd / 0.1f)
                        - 300.0f * (below + above) - 2.0f * qd * viol;
          s.IA[1 + sl] = sm_load(c + RL_S_M6);
          // the joint's rotation needs no parent: E_up = (E_tree Rj)^T, and
          // with it E rx and rx E^T of the inertia sweep's X^T M X
          const M3 Rj = m3_axis_angle(v3_load(c + RL_S_AX), m3_load(c + RL_S_KK), q);
          const M3 E = m3_t(m3_mul(m3_load(c + RL_S_E), Rj));
          s.E_up[1 + sl] = E;
          const M3 rx = m3_skew(v3_load(c + RL_S_P));
          s.sw.Erx[sl] = m3_mul(E, rx);
          s.sw.rxEt[sl] = m3_mul(rx, m3_t(E));
        }
      }

      // ---- FK, velocities and velocity bias, limb by limb -------------------
      RL_PHASE(lane) {
        if (lane < K) {
#pragma unroll 1
          for (int d = 0; d < D; ++d) {
            const int sl = d * K + lane;
            const float* c = slot_c(cst, sl);
            const int b = 1 + sl, par = parent_slot(sl);
            const V3 ax = v3_load(c + RL_S_AX);
            const V3 pt = v3_load(c + RL_S_P);
            const float qd = s.qd[sl];
            const M3 E = s.E_up[b];
            const M3 Rb = m3_mul(s.R_b[par], m3_t(E));
            s.R_b[b] = Rb;
            const V3 pb = v3_add(m3_vec(s.R_b[par], pt), s.p_b[par]);
            s.p_b[b] = pb;
            const V3 wb = v3_add(s.w_b[par], m3_vec(Rb, v3_scale(ax, qd)));
            s.w_b[b] = wb;
            s.v_b[b] = v3_add(s.v_b[par], v3_cross(s.w_b[par], v3_sub(pb, s.p_b[par])));
            const SV Sqd = sv(v3_scale(ax, qd), v3_zero());
            const SV vi = sv_add(xform_motion(E, pt, s.v_sp[par]), Sqd);
            s.v_sp[b] = vi;
            s.c_sp[b] = crm(vi, Sqd);
          }
        }
      }
      RL_PHASE(lane) {  // the limbs' velocity bias, a body a lane
        for (int b = 1 + lane; b < NB; b += RL_TEAM)
          s.pA_vel[b] = crf(s.v_sp[b], sm_vec(s.IA[b], s.v_sp[b]));
      }

      // ---- backward articulated-inertia sweep: U, 1/d, Ia, X^T Ia X --------
      // A level at a time, 4 lanes a limb, each on one 3x3 block (bi, bj) of
      // the 6x6: Ia's row of blocks bi (two lanes form each), Y = Ia X, then
      // X^T Y into the parent, for X(E, r) = [[E, 0], [-E rx, E]]
      // (soa.py's xform_inertia_to_parent, in its order of sums).
#pragma unroll 1
      for (int d = D - 1; d >= 0; --d) {
        RL_PHASE(lane) {
          const int k = lane / 4, bi = (lane % 4) / 2, bj = lane % 2;
          if (k < K) {
            const int sl = d * K + k, b = 1 + sl;
            const float* c = slot_c(cst, sl);
            const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
            const SV Ub = sm_vec(s.IA[b], Si);
            const float db = fmaxf(sv_dot(Si, Ub) + c[RL_S_ARM] + (IMP ? dt * s.imp[sl] : 0.0f), 1e-9f);
            if (bi == 0 && bj == 0) {
              s.U[b] = Ub;
              s.dinv[b] = 1.0f / db;
            }
            const float m = -1.0f / db;
            const V3 ui = bi ? Ub.l : Ub.w;
            const M3 Ia0 = m3_add(s.IA[b].b[bi][0], m3_scale(m3_outer(ui, Ub.w), m));
            const M3 Ia1 = m3_add(s.IA[b].b[bi][1], m3_scale(m3_outer(ui, Ub.l), m));
            const M3& E = s.E_up[b];
            s.sw.Y[k].b[bi][bj] = bj == 0 ? m3_sub(m3_mul(Ia0, E), m3_mul(Ia1, s.sw.Erx[sl]))
                                          : m3_mul(Ia1, E);
            s.sw.Ia[k].b[bi][bj] = bj == 0 ? Ia0 : Ia1;
          }
        }
        RL_PHASE(lane) {
          const int k = lane / 4, bi = (lane % 4) / 2, bj = lane % 2;
          if (k < K) {
            const int sl = d * K + k, b = 1 + sl;
            const SM& Y = s.sw.Y[k];
            const M3 Et = m3_t(s.E_up[b]);
            const M3 z = bi == 0
                ? m3_add(m3_mul(Et, Y.b[0][bj]), m3_mul(s.sw.rxEt[sl], Y.b[1][bj]))
                : m3_mul(Et, Y.b[1][bj]);
            s.IA[b].b[bi][bj] = s.sw.Ia[k].b[bi][bj];  // Ia_s from here on
            if (d > 0) {
              M3& a = s.IA[parent_slot(sl)].b[bi][bj];
              a = m3_add(a, z);
            } else {
              s.sw.IA_k[k].b[bi][bj] = z;
            }
          }
        }
      }
      // the base's articulated inertia, its limbs added in limb order, an
      // element a lane; Ia_s c_sp a body a lane
      RL_PHASE(lane) {
        for (int e = lane; e < 36; e += RL_TEAM) {
          float a = sm_at(s.IA[0], e);
          for (int k = 0; k < K; ++k) a = a + sm_at(s.sw.IA_k[k], e);
          sm_at(s.IA[0], e) = a;
        }
        for (int b = 1 + lane; b < NB; b += RL_TEAM) s.Ic[b] = sm_vec(s.IA[b], s.c_sp[b]);
      }
      // IA[0]'s Cholesky factor (both solves of the substep use it): here
      // when the inverse apparent inertia needs it first, else beside the
      // first bias sweep's limbs
      const bool factor_now = !LEG && sub == 0;
      if (factor_now) {
        RL_PHASE(lane) {
          if (lane == BASE) factor_base(s);
        }
      }

      // ---- inverse apparent inertia per body, world frame (substep 0) ---------
      if constexpr (!LEG) {
        if (sub == 0) {
          // Phi[0] = IA[0]^-1 base_split, a column per lane
          RL_PHASE(lane) {
            if (lane < 6) {
              float rhs[6], col[6];
              for (int r = 0; r < 6; ++r) rhs[r] = (r == lane) ? 1.0f : 0.0f;
              chol6_solve(s.L, rhs, col);
              for (int r = 0; r < 6; ++r)
                s.phi.Phi[0].b[r / 3][lane / 3].m[r % 3][lane % 3] = col[r] * base_split;
            }
          }
          RL_PHASE(lane) {
            if (lane < K) {
#pragma unroll 1
              for (int d = 0; d < D; ++d) {
                const int sl = d * K + lane;
                const float* c = slot_c(cst, sl);
                const int b = 1 + sl;
                const float di = s.dinv[b];
                const SV Si = sv(v3_load(c + RL_S_AX), v3_zero());
                const SM Phi_x = xform_phi_to_child(s.E_up[b], v3_load(c + RL_S_P),
                                                    s.phi.Phi[parent_slot(sl)]);
                const SV MU = sm_vec(Phi_x, s.U[b]);
                const float uMu = sv_dot(s.U[b], MU);
                SM Phi_b = sm_add(Phi_x, sm_scale(sm_outer(Si, MU), -di));
                Phi_b = sm_add(Phi_b, sm_scale(sm_outer(MU, Si), -di));
                Phi_b = sm_add(Phi_b, sm_scale(sm_outer(Si, Si), di + uMu * di * di));
                s.phi.Phi[b] = Phi_b;
              }
            }
          }
          RL_PHASE(lane) {
            for (int t = lane; t < 3 * NB; t += RL_TEAM) {
              const int b = t / 3, blk = t % 3;
              const M3& Rb = s.R_b[b];
              const M3 Rt = m3_t(Rb);
              const SM& Phi = s.phi.Phi[b];
              if (blk == 0) s.phiA[b] = m3_mul(m3_mul(Rb, Phi.b[0][0]), Rt);
              else if (blk == 1) s.phi.wB[b] = m3_mul(m3_mul(Rb, Phi.b[0][1]), Rt);
              else s.phi.wD[b] = m3_mul(m3_mul(Rb, Phi.b[1][1]), Rt);
            }
          }
        }
      }

      // ---- free dynamics -> free point accelerations (apparent model) ---------
      if constexpr (!LEG) {
        bias_and_accels(s, cst, false, !factor_now);
        // per-geom contact flags; per-geom inverse apparent inertia (substep 0)
        RL_PHASE(lane) {
          for (int g = lane; g < ng; g += RL_TEAM) {
            const float* cg = cgeom + g * RL_GEOM;
            const int b = (int)cg[RL_G_SLOT];
            const float rad = cg[RL_G_RAD];
            const V3 pg = v3_add(m3_vec(s.R_b[b], v3_load(cg + RL_G_OFF)), s.p_b[b]);
            const float hg = TER ? s.g_h[g] : 0.0f;
            s.geom.in_c[g] = (hg + rad - pg.v[2] > 0.0f) ? 1.0f : 0.0f;
            if (sub == 0) {
              const V3 nrm = TER ? s.g_n[g] : v3(0.0f, 0.0f, 1.0f);
              const V3 r_w = v3_sub(v3_sub(pg, v3_scale(nrm, rad)), s.p_b[b]);
              const M3 Sm = m3_scale(m3_skew(r_w), -1.0f);
              const M3 Smt = m3_t(Sm);
              const M3 SmB = m3_mul(Sm, s.phi.wB[b]);
              s.lam_w[g] = m3_add(m3_add(m3_mul(m3_mul(Sm, s.phiA[b]), Smt),
                                         m3_add(SmB, m3_t(SmB))), s.phi.wD[b]);
            }
          }
        }
        // per-body active-contact counts for the Jacobi mass split, in geom order
        RL_PHASE(lane) {
          for (int b = lane; b < NB; b += RL_TEAM) {
            float na = 0.0f;
            for (int g = gl.head[b]; g >= 0; g = gl.next[g]) na += s.geom.in_c[g];
            s.n_active[b] = na;
          }
        }
      }

      // ---- per-geom contact forces, a geom per lane ----------------------------
      RL_PHASE(lane) {
        for (int g = lane; g < ng; g += RL_TEAM) {
          const float* cg = cgeom + g * RL_GEOM;
          const int b = (int)cg[RL_G_SLOT];
          const float rad = cg[RL_G_RAD];
          const float hg = TER ? s.g_h[g] : 0.0f;
          const V3 nrm = TER ? s.g_n[g] : v3(0.0f, 0.0f, 1.0f);  // the plane z=0
          const M3& Rb = s.R_b[b];
          const V3 pb = s.p_b[b], wb = s.w_b[b];
          const V3 pg = v3_add(m3_vec(Rb, v3_load(cg + RL_G_OFF)), pb);
          const V3 vg = v3_add(s.v_b[b], v3_cross(wb, v3_sub(pg, pb)));
          if (sub == 0) {
            RL_Y(off_gpos + 3 * g + 0) = pg.v[0];
            RL_Y(off_gpos + 3 * g + 1) = pg.v[1];
            RL_Y(off_gpos + 3 * g + 2) = pg.v[2];
          }
          V3 gf, tq;
          if constexpr (LEG) {
            // the penalty force acts at the sphere center
            gf = legacy_force(pg, vg, hg, nrm, rad, cg[RL_G_MEFF], s.zeta, s.mu, cst, dt);
            tq = v3_cross(v3_sub(pg, pb), gf);
          } else {
            const float in_c = (hg + rad - pg.v[2] > 0.0f) ? 1.0f : 0.0f;
            // contact point on the sphere surface
            const V3 p_c = v3_sub(pg, v3_scale(nrm, rad));
            const V3 r_w = v3_sub(p_c, pb);
            const V3 v_c = v3_add(vg, v3_cross(wb, v3_sub(p_c, pg)));
            const SV ab = s.a_sp[b];
            const V3 a_lin_true = v3_add(ab.l, m3_tvec(Rb, gvec));
            const V3 wdot_w = m3_vec(Rb, ab.w);
            const V3 a_org_w = v3_add(m3_vec(Rb, a_lin_true), v3_cross(wb, s.v_b[b]));
            const V3 a_pt = v3_add(v3_add(a_org_w, v3_cross(wdot_w, r_w)),
                                   v3_cross(wb, v3_cross(wb, r_w)));

            // TGS-style velocity constraint solve against lam_w[g]
            const float depth = fmaxf(hg + rad - pg.v[2], 0.0f);
            const V3 v_pred = v3_add(v_c, v3_scale(a_pt, dt));
            const float v_n_now = v3_dot(v_c, nrm);
            const float bias = fminf(erp_dt * depth, max_depen);
            const float bounce = (v_n_now < -bounce_thr) ? -s.restitution * v_n_now : 0.0f;
            const float v_tgt_n = fmaxf(bias, bounce);
            const V3 dv = v3_sub(v3_scale(nrm, v_tgt_n), v_pred);
            const float split = fmaxf(s.n_active[b], 1.0f);
            const M3 lam_g = m3_scale(s.lam_w[g], split);
            const V3 f = m3_solve(lam_g, v3_scale(dv, inv_dt));
            float f_n = v3_dot(f, nrm);
            const V3 f_t = v3_sub(f, v3_scale(nrm, f_n));
            f_n = fmaxf(f_n, 0.0f) * in_c;
            const float ft_norm = v3_norm(f_t, 1e-18f);
            const float fscale = fminf(1.0f, s.mu * f_n / (ft_norm + 1e-9f)) * in_c;
            gf = v3_add(v3_scale(nrm, f_n), v3_scale(f_t, fscale));

            tq = v3_cross(v3_sub(p_c, pb), gf);
            if (a_patch > 0.0f) {
              // torsional friction, clamped to the cone mu * f_n * patch radius
              const float w_n = v3_dot(wb, nrm);
              const float r_ang = fmaxf(v3_dot(nrm, m3_vec(s.phiA[b], nrm)) * split, 1e-6f);
              const float tau_max = s.mu * f_n * a_patch;
              const float tau_n = fminf(fmaxf(-w_n / (dt * r_ang), -tau_max), tau_max);
              tq = v3_add(tq, v3_scale(nrm, tau_n));
            }
          }
          s.geom.F[g] = gf;
          s.geom.T[g] = tq;
          if constexpr (WLD) {
            // the walls push at the sphere center
            const V3 wf = world_force(cworld, s.origin, pg, vg, rad, cg[RL_G_MEFF],
                                      cg[RL_G_WDEN], dt);
            s.geom.WF[g] = wf;
            s.geom.WT[g] = v3_cross(v3_sub(pg, pb), wf);
          }
        }
      }

      // ---- per-body sums in geom order (the world forces in their own sums,
      // added to the ground's after); the report sums at substep 0 -------------
      RL_PHASE(lane) {
        for (int t = lane; t < NB + nr; t += RL_TEAM) {
          if (t < NB) {
            const int b = t;
            V3 Fw = v3_zero(), Nw = v3_zero(), WFw = v3_zero(), WNw = v3_zero();
            for (int g = gl.head[b]; g >= 0; g = gl.next[g]) {
              Fw = v3_add(Fw, s.geom.F[g]);
              Nw = v3_add(Nw, s.geom.T[g]);
              if constexpr (WLD) {
                WFw = v3_add(WFw, s.geom.WF[g]);
                WNw = v3_add(WNw, s.geom.WT[g]);
              }
            }
            const M3& Rb = s.R_b[b];
            SV fe = sv(m3_tvec(Rb, Nw), m3_tvec(Rb, Fw));
            if constexpr (WLD) fe = sv_add(fe, sv(m3_tvec(Rb, WNw), m3_tvec(Rb, WFw)));
            s.f_ext[b] = fe;
          } else if (sub == 0) {
            const int r = t - NB;
            V3 rep = v3_zero();
            for (int g = gl.rhead[r]; g >= 0; g = gl.rnext[g]) {
              rep = v3_add(rep, WLD ? v3_add(s.geom.F[g], s.geom.WF[g]) : s.geom.F[g]);
            }
            RL_Y(off_rep + 3 * r + 0) = rep.v[0];
            RL_Y(off_rep + 3 * r + 1) = rep.v[1];
            RL_Y(off_rep + 3 * r + 2) = rep.v[2];
          }
        }
      }

      bias_and_accels(s, cst, true, LEG);

      // ---- integrate (semi-implicit; a fixed base stays where it is) ----------
      RL_PHASE(lane) {
        if (lane == BASE) {
          if constexpr (FIX) {
            s.base_w = v3_zero();
            s.base_v = v3_zero();
          } else {
            const M3& R0 = s.R_b[0];
            const V3 a0w = s.a_sp[0].w;
            const V3 a0l = v3_add(s.a_sp[0].l, s.g_b);
            const V3 wdot_w = m3_vec(R0, a0w);
            const V3 acc_w = v3_add(m3_vec(R0, a0l), v3_cross(s.base_w, s.base_v));
            s.base_w = v3_add(s.base_w, v3_scale(wdot_w, dt));
            s.base_v = v3_add(s.base_v, v3_scale(acc_w, dt));
            s.base_pos = v3_add(s.base_pos, v3_scale(s.base_v, dt));
            quat_integrate(s.base_quat, s.base_w, half_dt);
          }
        }
        for (int sl = lane; sl < NL; sl += RL_TEAM) {
          const float vl = slot_c(cst, sl)[RL_S_VLIM];
          const float qd = fminf(fmaxf(s.qd[sl] + dt * s.qdd[sl], -vl), vl);
          s.qd[sl] = qd;
          s.q[sl] = s.q[sl] + dt * qd;
        }
      }
    }

    // ---- outputs ----------------------------------------------------------------
    RL_PHASE(lane) {
      if (lane == BASE) {
        for (int a = 0; a < 3; ++a) RL_Y(a) = s.base_pos.v[a];
        for (int a = 0; a < 4; ++a) RL_Y(3 + a) = s.base_quat[a];
        for (int a = 0; a < 3; ++a) RL_Y(7 + a) = s.base_v.v[a];
        for (int a = 0; a < 3; ++a) RL_Y(10 + a) = s.base_w.v[a];
      }
      for (int sl = lane; sl < NL; sl += RL_TEAM) {
        const int j = (int)slot_c(cst, sl)[RL_S_J];
        RL_Y(13 + j) = s.q[sl];
        RL_Y(13 + NL + j) = s.qd[sl];
      }
    }
#undef RL_X
#undef RL_Y
  }
};

}  // namespace rl
