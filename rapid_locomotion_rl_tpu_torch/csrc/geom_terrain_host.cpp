// CPU build of the terrain lookup's per-(env, geom) body
// (csrc/geom_terrain.cuh): a loop over the pairs, and each half of the body
// on its own, so that the kernel's arithmetic can be tested on a machine
// without a GPU (g++ -O2 -shared -fPIC -ffp-contract=off).
#include "geom_terrain.cuh"

// The whole body, as geom_terrain.cu's rl_geom_terrain without the stream.
extern "C" int rl_geom_terrain_host(float* x, const float* cst, int n, int D,
                                    int K, int ng, int ct, const float* grid,
                                    long long H, long long W, float border,
                                    float scale, const long long* ix0,
                                    const long long* iy0, int rows, int cols,
                                    float* xy) {
  if (n <= 0 || ng <= 0 || ng > RL_MAX_NG || D <= 0 || K <= 0 || H < 2
      || W < 2 || rows < 2 || cols < 2 || (ix0 == nullptr) != (iy0 == nullptr))
    return 1;
  const rl::GridRef G{grid, H, W, border, scale, rows, cols};
  for (int g = 0; g < ng; ++g)
    for (int i = 0; i < n; ++i)
      rl::geom_terrain_one(x, (size_t)n, (size_t)i, g, ng, ct, cst, D, K, G,
                           ix0, iy0, xy);
  return 0;
}

// The FK half: every geom's (x, y) into xy [2 ng, n].
extern "C" int rl_geom_xy_host(const float* x, const float* cst, int n, int D,
                               int K, int ng, float* xy) {
  if (n <= 0 || ng <= 0 || ng > RL_MAX_NG || D <= 0 || K <= 0) return 1;
  for (int g = 0; g < ng; ++g)
    for (int i = 0; i < n; ++i)
      rl::geom_xy(x, (size_t)n, (size_t)i, cst, D, K, g,
                  &xy[(size_t)(2 * g) * n + i], &xy[(size_t)(2 * g + 1) * n + i]);
  return 0;
}

// The lookup half on points px/py [n, m] (row i in env i's window): heights
// [n, m], normals [n, m, 3] and the cells ix/iy [n, m].
extern "C" int rl_geom_lookup_host(const float* px, const float* py, int n,
                                   int m, const float* grid, long long H,
                                   long long W, float border, float scale,
                                   const long long* ix0, const long long* iy0,
                                   int rows, int cols, float* height,
                                   float* normal, long long* cix,
                                   long long* ciy) {
  if (n <= 0 || m <= 0 || H < 2 || W < 2 || rows < 2 || cols < 2
      || (ix0 == nullptr) != (iy0 == nullptr))
    return 1;
  const rl::GridRef G{grid, H, W, border, scale, rows, cols};
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      const size_t e = (size_t)i * m + j;
      const rl::Lookup r = rl::lookup(G, ix0 ? ix0[i] : 0, iy0 ? iy0[i] : 0,
                                      px[e], py[e]);
      height[e] = r.height;
      for (int a = 0; a < 3; ++a) normal[3 * e + a] = r.normal.v[a];
      cix[e] = r.ix;
      ciy[e] = r.iy;
    }
  return 0;
}
