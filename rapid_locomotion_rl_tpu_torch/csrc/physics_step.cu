// Fused physics step on Hopper: a warp per env runs a whole control-step
// physics call (num_substeps substeps of csrc/substep_chain.cuh), its lanes
// splitting the work where the plain version's work is independent.
//
// Replaces the TPU kernel rapid_locomotion_rl_tpu/ops/pallas_physics.py:61
// _kernel (launched by physics_step_pallas), which traced
// soa_physics.substep_chain unrolled over every body and geom with the robot
// model baked in as literals and put 512 envs on the vector lanes of a grid
// step. Here the body is written by hand with loops that run at run time,
// and the model comes from a packed constant table.
//
// What bounds it on this card: per env it reads C_in and writes C_out float
// channels (Go1, implicit PD on: 67 in, 259 out, 5.3 MB at 4096 envs, 1.6 us
// at 3.35 TB/s; Mini Cheetah on terrain: 235 in, 202 out, 7.0 MB at 4000
// envs; with the corridor's walls 3 more input channels and a block of 4
// boxes in the table), against 50-140k float operations per env
// (chip_smoke.py::count_ops_per_env), each one FP32 instruction under
// --fmad=false: 0.42 G instructions a call for the terrain variant at 4000
// envs, 12.5 us at the card's 33.5 T a second. So the arithmetic bounds it.
//
// Why one thread per env fell far short of that (H100 SXM, 700 W): the time
// was one env's dependent chain of ~10^5 operations, ~9 cycles each (0.48
// ms for the terrain variant at 4000 envs), its 9-15 KB of scratch (6x6
// inertias, Phi blocks, per-geom inverse inertias) in local memory, and
// 4000 threads in 32 blocks of 128 on 32 of the 132 SMs, 4 warps each:
// 3.9x the envs cost 1.24x the time.
//
// The team design: one env per warp. Its lanes run the K limb chains in
// parallel (FK, the velocity pass, both bias sweeps, the Phi propagation),
// four lanes a limb on the 3x3 blocks of the articulated-inertia sweep, a
// slot each (joint torques and rotations, limb inertias), a geom each
// (contact point, the inverse apparent inertia, the TGS solve or the legacy
// force, the walls), and a body or report body each for the sums, which walk
// each body's geoms in geom order (lists built once per block); the base's
// 6x6 work (its sum of the limbs in limb order, an element a lane; one
// Cholesky factor per substep; the solves) runs on one lane. Every sum keeps
// the plain version's order, so the result does not depend on the team: no
// atomics, the bits of the one-thread kernel, the same on every launch. The
// per-env scratch (11.4 KB plane, 12.4 KB terrain, 12.9 KB with the walls,
// 9.5 KB legacy) is a struct in shared memory, the constant table (4.7-5.2
// KB) is copied into shared memory once per block, and a block holds 8 envs:
// two blocks, 16 warps, an SM (shared memory is the limit; 79-106
// registers); 4000 envs make 500 blocks over all 132 SMs, and the time now
// grows with the envs (0.043 ms at 1024 terrain envs, 0.120 at 4000, 4x
// faster than one thread per env). rl_physics_step_occupancy reports the
// instance's figures; chip_smoke.py's build phase prints them.
//
// Build (one library per variant, see RL_CARD_VARIANTS): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// --fmad=false -DRL_D=3 -DRL_K=4 -DRL_TER=1 -DRL_WLD=0 -DRL_LEG=0 -DRL_FIX=0
// (no fused multiply-add, so that the kernel rounds like its plain PyTorch
// version). No PyTorch header is included:
// the library has a plain C interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "substep_chain.cuh"

// 8 envs a block, 2 blocks an SM: 128 registers at most (65536 / (2 x 256))
// and 16 resident warps an SM with every variant's scratch; of the launch
// shapes timed on the H100, the fastest at the main paths' widths.
#define RL_ENVS_PER_BLOCK 8
#define RL_MIN_BLOCKS 2
#define RL_THREADS (RL_TEAM * RL_ENVS_PER_BLOCK)

// Shared memory of a block: the table's floats, the geom lists, the envs'
// scratch, each rounded up to 16 bytes.
static __host__ __device__ int table_floats(int cst_len) { return (cst_len + 3) & ~3; }
template <class C>
static __host__ __device__ int lists_floats() {
  return (int)((sizeof(typename C::GeomLists) + 15) / 16 * 4);
}

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
__global__ void __launch_bounds__(RL_THREADS, RL_MIN_BLOCKS) physics_step_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ cst, int cst_len, int n) {
  using C = rl::Chain<D, K, IMP, TER, WLD, LEG, FIX>;
#ifdef RL_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0 && rl::rl_phase_count < 512)
    rl::rl_phase_clock[rl::rl_phase_count++] = clock64();
#endif
  extern __shared__ __align__(16) float smem[];
  for (int t = threadIdx.x; t < cst_len; t += blockDim.x) smem[t] = cst[t];
  __syncthreads();
  typename C::GeomLists* gl =
      reinterpret_cast<typename C::GeomLists*>(smem + table_floats(cst_len));
  if (threadIdx.x < RL_TEAM) C::build_lists(smem, *gl);
  __syncthreads();
  const int w = threadIdx.x / RL_TEAM;
  const int i = blockIdx.x * RL_ENVS_PER_BLOCK + w;
  if (i >= n) return;  // the whole warp: one env per warp
  typename C::Scratch* s = reinterpret_cast<typename C::Scratch*>(
      smem + table_floats(cst_len) + lists_floats<C>()) + w;
  C::run(x, y, smem, n, i, *gl, *s);
}

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static size_t smem_bytes(int cst_len) {
  using C = rl::Chain<D, K, IMP, TER, WLD, LEG, FIX>;
  return (table_floats(cst_len) + lists_floats<C>()) * sizeof(float)
         + RL_ENVS_PER_BLOCK * sizeof(typename C::Scratch);
}

// Raises the instance's dynamic shared-memory limit when a launch needs more
// than it was last set to (once per instance and table size in practice).
template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static cudaError_t set_smem(size_t bytes) {
  static size_t set = 0;
  if (bytes <= set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      physics_step_kernel<D, K, IMP, TER, WLD, LEG, FIX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static cudaError_t launch(const float* x, float* y, const float* cst,
                          int cst_len, int n, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D, K, IMP, TER, WLD, LEG, FIX>(cst_len);
  const cudaError_t e = set_smem<D, K, IMP, TER, WLD, LEG, FIX>(bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (n + RL_ENVS_PER_BLOCK - 1) / RL_ENVS_PER_BLOCK;
  physics_step_kernel<D, K, IMP, TER, WLD, LEG, FIX>
      <<<blocks, RL_THREADS, bytes, stream>>>(x, y, cst, cst_len, n);
  return cudaGetLastError();
}

// out: [scratch bytes per env, dynamic shared bytes per block, envs per
// block, resident blocks per SM, registers per thread, local (stack) bytes
// per thread]
template <int D, int K, bool IMP, bool TER, bool WLD, bool LEG, bool FIX>
static cudaError_t occupancy(int cst_len, int* out) {
  using C = rl::Chain<D, K, IMP, TER, WLD, LEG, FIX>;
  const size_t bytes = smem_bytes<D, K, IMP, TER, WLD, LEG, FIX>(cst_len);
  cudaError_t e = set_smem<D, K, IMP, TER, WLD, LEG, FIX>(bytes);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, physics_step_kernel<D, K, IMP, TER, WLD, LEG, FIX>, RL_THREADS, bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, physics_step_kernel<D, K, IMP, TER, WLD, LEG, FIX>);
  if (e != cudaSuccess) return e;
  out[0] = (int)sizeof(typename C::Scratch);
  out[1] = (int)bytes;
  out[2] = RL_ENVS_PER_BLOCK;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// Every variant of JAX's kernel is built for the card, for both limb layouts
// in the repo (the quadruped's D x K = 3 x 4 and the test hopper's 1 x 2):
// on the plane or terrain, with or without the world boxes, with the
// apparent or the legacy contact model, and with the legacy model also a
// fixed base (a fixed base under the apparent model is NaN in the plain
// version and refused by it). Every instance takes the implicit-damping
// input: a caller without one packs zeros, which give the bits of the
// instance without it (tests/test_torch_kernel_host.py holds that on the g++
// build). One library is built per variant, each from this file with
// -DRL_D -DRL_K -DRL_TER -DRL_WLD -DRL_LEG -DRL_FIX, so that the builds run in
// parallel and a run builds only what it launches; a library refuses any
// other variant with cudaErrorInvalidValue. RL_CARD_VARIANTS is the table of
// them (ops/cuda_physics.py::CUDA_VARIANTS holds the same, in this order):
// X(D, K, TER, WLD, LEG, FIX).
#define RL_CARD_VARIANTS(X)                                                    \
  X(3, 4, 0, 0, 0, 0) X(3, 4, 0, 0, 1, 0) X(3, 4, 0, 0, 1, 1)                  \
  X(3, 4, 0, 1, 0, 0) X(3, 4, 0, 1, 1, 0) X(3, 4, 0, 1, 1, 1)                  \
  X(3, 4, 1, 0, 0, 0) X(3, 4, 1, 0, 1, 0) X(3, 4, 1, 0, 1, 1)                  \
  X(3, 4, 1, 1, 0, 0) X(3, 4, 1, 1, 1, 0) X(3, 4, 1, 1, 1, 1)                  \
  X(1, 2, 0, 0, 0, 0) X(1, 2, 0, 0, 1, 0) X(1, 2, 0, 0, 1, 1)                  \
  X(1, 2, 0, 1, 0, 0) X(1, 2, 0, 1, 1, 0) X(1, 2, 0, 1, 1, 1)                  \
  X(1, 2, 1, 0, 0, 0) X(1, 2, 1, 0, 1, 0) X(1, 2, 1, 0, 1, 1)                  \
  X(1, 2, 1, 1, 0, 0) X(1, 2, 1, 1, 1, 0) X(1, 2, 1, 1, 1, 1)

#if !defined(RL_D) || !defined(RL_K) || !defined(RL_TER) || !defined(RL_WLD) \
    || !defined(RL_LEG) || !defined(RL_FIX)
#error "build one variant: -DRL_D= -DRL_K= -DRL_TER= -DRL_WLD= -DRL_LEG= -DRL_FIX="
#endif
#define RL_IS_BUILT(D, K, TER, WLD, LEG, FIX)                                  \
  || (D == RL_D && K == RL_K && TER == RL_TER && WLD == RL_WLD                 \
      && LEG == RL_LEG && FIX == RL_FIX)
static_assert(false RL_CARD_VARIANTS(RL_IS_BUILT),
              "not a variant of RL_CARD_VARIANTS");

// OP is launch or occupancy, with its trailing arguments.
#define RL_DISPATCH(OP, ...)                                                   \
  if (D != RL_D || K != RL_K || has_terrain != RL_TER || has_world != RL_WLD   \
      || legacy != RL_LEG || fixed_base != RL_FIX)                             \
    return (int)cudaErrorInvalidValue;                                         \
  return (int)OP<RL_D, RL_K, true, (bool)RL_TER, (bool)RL_WLD, (bool)RL_LEG,   \
                 (bool)RL_FIX>(__VA_ARGS__);

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rl_physics_step(const float* x, float* y, const float* cst,
                               int cst_len, int n, int D, int K,
                               int has_terrain, int has_world, int legacy,
                               int fixed_base, void* stream) {
  if (n <= 0 || cst_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RL_DISPATCH(launch, x, y, cst, cst_len, n, s)
}

#ifdef RL_PHASE_CLOCKS
// The clocks noted since the last call (at most 512; returns how many), then
// the count is reset.
extern "C" int rl_phase_clocks(long long* out) {
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, rl::rl_phase_count, sizeof(int)) != cudaSuccess) return -1;
  if (n > 512) n = 512;
  if (cudaMemcpyFromSymbol(out, rl::rl_phase_clock, n * sizeof(long long)) != cudaSuccess) return -1;
  const int zero = 0;
  if (cudaMemcpyToSymbol(rl::rl_phase_count, &zero, sizeof(int)) != cudaSuccess) return -1;
  return n;
}
#endif

// Fills out[6] (see occupancy) for a variant and a table of cst_len floats.
extern "C" int rl_physics_step_occupancy(int cst_len, int D, int K,
                                         int has_terrain, int has_world,
                                         int legacy, int fixed_base,
                                         int* out) {
  if (cst_len <= 0) return (int)cudaErrorInvalidValue;
  RL_DISPATCH(occupancy, cst_len, out)
}
