// CPU build of the physics step's per-env body (csrc/substep_chain.cuh): a
// loop over envs. It lets the kernel's arithmetic be tested on a machine
// without a GPU (g++ -O2 -shared -fPIC -ffp-contract=off).
#include "substep_chain.cuh"

template <int D, int K, bool IMP>
static void run_all(const float* x, float* y, const float* cst, int n) {
  for (int i = 0; i < n; ++i) rl::Chain<D, K, IMP>::run(x, y, cst, n, i);
}

// Returns 0, or 1 for a limb layout that is not compiled.
extern "C" int rl_physics_step_host(const float* x, float* y,
                                    const float* cst, int n, int D, int K,
                                    int has_imp) {
  if (D == 3 && K == 4) {
    if (has_imp) run_all<3, 4, true>(x, y, cst, n);
    else run_all<3, 4, false>(x, y, cst, n);
    return 0;
  }
  if (D == 1 && K == 2) {
    if (has_imp) run_all<1, 2, true>(x, y, cst, n);
    else run_all<1, 2, false>(x, y, cst, n);
    return 0;
  }
  return 1;
}
