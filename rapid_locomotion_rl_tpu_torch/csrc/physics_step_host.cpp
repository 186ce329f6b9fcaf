// CPU build of the physics step's per-env body (csrc/substep_chain.cuh): a
// loop over envs, each env's team phases run lane after lane, in every
// variant of the compile-time switches (a fixed base with the legacy contact
// model only, as the chain takes it). It lets the kernel's arithmetic be
// tested on a machine without a GPU (g++ -O2 -shared -fPIC
// -ffp-contract=off); with -DRL_HOST_LANES_REVERSED each phase runs its
// lanes last to first, which changes the result only where a phase has a
// race between its lanes.
#include <string.h>

#include "substep_chain.cuh"

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static void run_all(const float* x, float* y, const float* cst, int n) {
  using C = rl::Chain<D, K, IMP, TER, WLD, LEG, FIX>;
  typename C::GeomLists gl;
  memset(&gl, 0x7f, sizeof(gl));  // an unbuilt entry would walk out of range
  C::build_lists(cst, gl);
  typename C::Scratch s;
  for (int i = 0; i < n; ++i) {
    // NaN in every scratch word: a read before a write shows in the output
    memset(&s, 0xff, sizeof(s));
    C::run(x, y, cst, n, i, gl, s);
  }
}

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG>
static void run_fixed(const float* x, float* y, const float* cst, int n,
                      int fixed_base) {
  if constexpr (LEG) {
    if (fixed_base) {
      run_all<D, K, IMP, TER, WLD, LEG, true>(x, y, cst, n);
      return;
    }
  }
  run_all<D, K, IMP, TER, WLD, LEG, false>(x, y, cst, n);
}

template <int D, int K, bool IMP, bool TER, bool WLD>
static void run_legacy(const float* x, float* y, const float* cst, int n,
                       int legacy, int fixed_base) {
  if (legacy) run_fixed<D, K, IMP, TER, WLD, true>(x, y, cst, n, fixed_base);
  else run_fixed<D, K, IMP, TER, WLD, false>(x, y, cst, n, fixed_base);
}

template <int D, int K, bool IMP, bool TER>
static void run_world(const float* x, float* y, const float* cst, int n,
                      int has_world, int legacy, int fixed_base) {
  if (has_world) run_legacy<D, K, IMP, TER, true>(x, y, cst, n, legacy, fixed_base);
  else run_legacy<D, K, IMP, TER, false>(x, y, cst, n, legacy, fixed_base);
}

template <int D, int K>
static void run_layout(const float* x, float* y, const float* cst, int n,
                       int has_imp, int has_terrain, int has_world,
                       int legacy, int fixed_base) {
  if (has_imp && has_terrain)
    run_world<D, K, true, true>(x, y, cst, n, has_world, legacy, fixed_base);
  else if (has_imp)
    run_world<D, K, true, false>(x, y, cst, n, has_world, legacy, fixed_base);
  else if (has_terrain)
    run_world<D, K, false, true>(x, y, cst, n, has_world, legacy, fixed_base);
  else
    run_world<D, K, false, false>(x, y, cst, n, has_world, legacy, fixed_base);
}

// Returns 0, or 1 for a limb layout that is not compiled or a fixed base
// without the legacy contact model.
extern "C" int rl_physics_step_host(const float* x, float* y,
                                    const float* cst, int n, int D, int K,
                                    int has_imp, int has_terrain,
                                    int has_world, int legacy,
                                    int fixed_base) {
  if (fixed_base && !legacy) return 1;
  if (D == 3 && K == 4) {
    run_layout<3, 4>(x, y, cst, n, has_imp, has_terrain, has_world, legacy,
                     fixed_base);
    return 0;
  }
  if (D == 1 && K == 2) {
    run_layout<1, 2>(x, y, cst, n, has_imp, has_terrain, has_world, legacy,
                     fixed_base);
    return 0;
  }
  return 1;
}
