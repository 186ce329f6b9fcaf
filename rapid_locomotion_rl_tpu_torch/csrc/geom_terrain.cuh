// Per-(env, geom) body of the terrain lookup that feeds the physics step:
// the world (x, y) of one collision geom at the call's entry state, and the
// bilinear terrain height and unit normal under it. It computes what
// ops/soa_physics.py::sample_geom_terrain computes (fk_geom_xy, then
// ops/contact.py::terrain_height_and_normal), operation for operation and in
// the same order, for ONE (env, geom) pair. The same source builds under nvcc
// (geom_terrain.cu, a thread per pair) and under g++ (geom_terrain_host.cpp,
// a loop over pairs), where RL_HD is empty.
//
// The two halves are separate functions so that each can be held alone:
// geom_xy walks the geom's limb chain (at most D joints) from the base, and
// lookup maps a point to its cell and reads the four corners.
//
// Inputs: the state comes from the physics kernel's packed input x [C, n]
// (channel-major: base position rows 0-2, quaternion 3-6 (xyzw), joint j's
// angle row 13 + j), the robot model from its constant table cst
// (ops/cuda_physics.py::pack_constants; the RL_* offsets of
// substep_chain.cuh). The grid is float32 [H, W], row-major, indexed with
// 64-bit offsets (the flagship's collision grid has millions of cells).
#pragma once

#include "substep_chain.cuh"

namespace rl {

// What one lookup needs besides the point: the grid, its placement, and the
// env's window [ix0, ix0 + rows) x [iy0, iy0 + cols) (no window: the window
// (0, 0, H, W), which picks the same cells).
struct GridRef {
  const float* h;
  long long H, W;
  float border, scale;
  int rows, cols;
};

struct Lookup {
  float height;
  V3 normal;
  long long ix, iy;  // the cell's lower corner, after the window's clamp
};

// World (x, y) of geom g of env i: the base rotation from the quaternion,
// then per joint of the geom's limb chain R_b = R_parent (E_tree Rodrigues)
// and p_b = R_parent p_tree + p_parent, then the geom's offset in its body's
// frame (soa_physics.py::fk_geom_xy).
RL_HD void geom_xy(const float* x, size_t n, size_t i, const float* cst,
                   int D, int K, int g, float* gx, float* gy) {
  const float* cslot = cst + RL_HDR + RL_BASE_SIZE;
  const float* cg = cslot + D * K * RL_SLOT + g * RL_GEOM;
  float quat[4];
  for (int a = 0; a < 4; ++a) quat[a] = x[(size_t)(3 + a) * n + i];
  M3 R = quat_to_m3(quat);
  V3 p = v3(x[i], x[n + i], x[2 * n + i]);
  const int b = (int)cg[RL_G_SLOT];  // 0 = base, 1 + l = limb slot l
  if (b > 0) {
    const int k = (b - 1) % K, depth = (b - 1) / K;
    for (int d = 0; d <= depth; ++d) {
      const float* c = cslot + (d * K + k) * RL_SLOT;
      const float q = x[(size_t)(13 + (int)c[RL_S_J]) * n + i];
      const M3 Rj = m3_axis_angle(v3_load(c + RL_S_AX), m3_load(c + RL_S_KK), q);
      const M3 Rpc = m3_mul(m3_load(c + RL_S_E), Rj);
      p = v3_add(m3_vec(R, v3_load(c + RL_S_P)), p);
      R = m3_mul(R, Rpc);
    }
  }
  const V3 pg = v3_add(m3_vec(R, v3_load(cg + RL_G_OFF)), p);
  *gx = pg.v[0];
  *gy = pg.v[1];
}

// The cell of world (px, py) and the bilinear height and normal there
// (contact.py::_cells and terrain_height_and_normal): the grid coordinate
// (v + border) / scale is a true quotient (IEEE division: a product with the
// reciprocal moves a point on a cell edge into the next cell), its floor
// clamped to [0, H-2] x [0, W-2], the fractions to [0, 1] (taken before the
// window's clamp, as the plain version takes them), and the corner clamped
// into the env's window.
RL_HD Lookup lookup(const GridRef& G, long long ix0, long long iy0,
                    float px, float py) {
  const float fx = (px + G.border) / G.scale;
  const float fy = (py + G.border) / G.scale;
  long long ix = (long long)floorf(fx), iy = (long long)floorf(fy);
  ix = ix < 0 ? 0 : (ix > G.H - 2 ? G.H - 2 : ix);
  iy = iy < 0 ? 0 : (iy > G.W - 2 ? G.W - 2 : iy);
  const float tx = fminf(fmaxf(fx - (float)ix, 0.0f), 1.0f);
  const float ty = fminf(fmaxf(fy - (float)iy, 0.0f), 1.0f);
  long long rx = ix - ix0, ry = iy - iy0;
  rx = rx < 0 ? 0 : (rx > G.rows - 2 ? G.rows - 2 : rx);
  ry = ry < 0 ? 0 : (ry > G.cols - 2 ? G.cols - 2 : ry);
  ix = ix0 + rx;
  iy = iy0 + ry;
  const size_t base = (size_t)ix * (size_t)G.W + (size_t)iy;
  const float h00 = G.h[base], h10 = G.h[base + G.W];
  const float h01 = G.h[base + 1], h11 = G.h[base + G.W + 1];
  Lookup r;
  r.height = (1 - tx) * (1 - ty) * h00 + tx * (1 - ty) * h10
             + (1 - tx) * ty * h01 + tx * ty * h11;
  const float dhdx = ((1 - ty) * (h10 - h00) + ty * (h11 - h01)) / G.scale;
  const float dhdy = ((1 - tx) * (h01 - h00) + tx * (h11 - h10)) / G.scale;
  const float nx = -dhdx, ny = -dhdy, nz = 1.0f;
  const float nrm = sqrtf(nx * nx + ny * ny + nz * nz);
  r.normal = v3(nx / nrm, ny / nrm, nz / nrm);
  r.ix = ix;
  r.iy = iy;
  return r;
}

// The whole body for pair (i, g): into x's terrain rows at ct, in the packed
// layout of the physics kernel (ng height rows, then 3 normal rows per geom),
// and, when xy is not null, the geom's (x, y) into xy [2 ng, n].
RL_HD void geom_terrain_one(float* x, size_t n, size_t i, int g, int ng,
                            int ct, const float* cst, int D, int K,
                            const GridRef& G, const long long* ix0,
                            const long long* iy0, float* xy) {
  float px, py;
  geom_xy(x, n, i, cst, D, K, g, &px, &py);
  const Lookup r = lookup(G, ix0 ? ix0[i] : 0, iy0 ? iy0[i] : 0, px, py);
  x[(size_t)(ct + g) * n + i] = r.height;
  for (int a = 0; a < 3; ++a)
    x[(size_t)(ct + ng + 3 * g + a) * n + i] = r.normal.v[a];
  if (xy) {
    xy[(size_t)(2 * g) * n + i] = px;
    xy[(size_t)(2 * g + 1) * n + i] = py;
  }
}

}  // namespace rl
