// Fused physics step on Hopper: one thread per env runs a whole control-step
// physics call (num_substeps substeps of csrc/substep_chain.cuh).
//
// Replaces the TPU kernel rapid_locomotion_rl_tpu/ops/pallas_physics.py::
// _kernel (launched by physics_step_pallas), which traced
// soa_physics.substep_chain unrolled over every body and geom with the robot
// model baked in as literals. Here the body is written by hand with loops
// that run at run time, and the model comes from a packed constant table.
//
// What bounds it on this card: per env it reads C_in and writes C_out float
// channels (Go1, implicit PD on: 67 in, 259 out, 5.3 MB at 4096 envs, about
// 1.6 us at 3.35 TB/s; Mini Cheetah on terrain: 235 in, 202 out, 7.0 MB at
// 4000 envs; with the corridor's walls 3 more input channels and a constant
// block of 4 boxes; the legacy-contact and fixed-base variants read and
// write what the terrain variant does), against some 10^5 float operations
// per env (fewer with the legacy contact, which skips the inverse apparent
// inertia and the free-dynamics pass), so the
// arithmetic bounds it (about 0.3 GFLOP per call at 4096 envs, a few us at
// the 67 TFLOP/s fp32 peak). The first version keeps the per-body 6x6
// inertias and per-geom 3x3 inverse inertias of one env in local memory
// (they do not fit in registers), so in practice it is bound by local-memory
// traffic through L1/L2 and by occupancy: 4096 threads fill only 32 blocks
// of 128 on 132 SMs. Channel-major [C, n] arrays make every global load and
// store coalesced across a warp. Making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC --fmad=false (no fused multiply-add, so that the kernel
// rounds like its plain PyTorch version). No PyTorch header is included:
// the library has a plain C interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "substep_chain.cuh"

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
__global__ void __launch_bounds__(128) physics_step_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ cst, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rl::Chain<D, K, IMP, TER, WLD, LEG, FIX>::run(x, y, cst, n, i);
}

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static cudaError_t launch(const float* x, float* y, const float* cst, int n,
                          cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  physics_step_kernel<D, K, IMP, TER, WLD, LEG, FIX><<<blocks, threads, 0, stream>>>(x, y, cst, n);
  return cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched). Only the variants the
// env runs are built for the card: the quadruped limb layout D x K = 3 x 4
// with the implicit-PD input (zeros when implicit PD is off), on the plane
// (Go1), on terrain (Mini Cheetah, trimesh), on terrain with the world boxes
// (the HLP corridor), on terrain with the legacy contact model, and on
// terrain with the legacy contact model and a fixed base (a fixed base comes
// only with the legacy model: see substep_chain.cuh). Any other variant is
// refused with cudaErrorInvalidValue; physics_step_host.cpp builds every
// variant for the CPU tests.
extern "C" int rl_physics_step(const float* x, float* y, const float* cst,
                               int n, int D, int K, int has_imp,
                               int has_terrain, int has_world, int legacy,
                               int fixed_base, void* stream) {
  if (n <= 0 || D != 3 || K != 4 || !has_imp || (has_world && !has_terrain)
      || ((legacy || fixed_base) && (!has_terrain || has_world))
      || (fixed_base && !legacy))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_base) return (int)launch<3, 4, true, true, false, true, true>(x, y, cst, n, s);
  if (legacy) return (int)launch<3, 4, true, true, false, true, false>(x, y, cst, n, s);
  if (has_world) return (int)launch<3, 4, true, true, true, false, false>(x, y, cst, n, s);
  return has_terrain ? (int)launch<3, 4, true, true, false, false, false>(x, y, cst, n, s)
                     : (int)launch<3, 4, true, false, false, false, false>(x, y, cst, n, s);
}
