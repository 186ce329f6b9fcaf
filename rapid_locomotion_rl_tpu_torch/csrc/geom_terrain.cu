// The terrain lookup under every collision geom on Hopper: a thread per
// (env, geom) pair runs csrc/geom_terrain.cuh's body and writes the height
// and unit normal straight into the terrain rows of the physics kernel's
// packed input, which physics_step.cu then reads.
//
// Replaces the JAX package's rapid_locomotion_rl_tpu/ops/soa_physics.py:606
// _sample_geom_terrain, which runs inside physics_step_pallas
// (ops/pallas_physics.py:174-183) before its pallas_call: XLA code in one
// jitted program with the kernel on the TPU, where the port ran it as ~3,100
// eager PyTorch launches a physics call.
//
// What bounds it on this card: per pair it reads the env's state (7 + nv
// floats, shared by the env's geoms) and four corner heights, and writes 4
// floats; at 4000 Mini Cheetah envs (ng = 42) ~0.3 MB of state, 2.7 MB of
// corners and 2.7 MB out, ~2 us at 3.35 TB/s, against a few hundred float
// operations a pair (the geom's chain of at most D Rodrigues rotations and
// 3x3 products, and the bilinear lookup). So bytes bound it, and at these
// sizes the launch itself takes longer. Threads run pair t = g n + i, so
// that neighbouring threads read and write neighbouring envs of one row;
// each thread recomputes its geom's chain from the base (no shared memory,
// no cross-thread sum), so the result does not depend on the launch shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC --fmad=false (no fused multiply-add and IEEE division,
// so that it rounds like its plain PyTorch version). No PyTorch header is
// included: the library has a plain C interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "geom_terrain.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
geom_terrain_kernel(float* x, const float* cst, int n, int D, int K, int ng,
                    int ct, rl::GridRef G, const long long* ix0,
                    const long long* iy0, float* xy) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * ng) return;
  const int g = (int)(t / n);
  const size_t i = (size_t)(t % n);
  rl::geom_terrain_one(x, (size_t)n, i, g, ng, ct, cst, D, K, G, ix0, iy0, xy);
}

}  // namespace

// x: [C, n] float32, the physics kernel's packed input (state rows read,
// terrain rows ct .. ct + 4 ng written); cst: its constant table; grid:
// [H, W] float32; ix0/iy0: [n] int64 window corners (both null: no window,
// and rows/cols are then H/W); xy: null, or [2 ng, n] float32 for each
// geom's (x, y). Returns the cudaError_t of the launch (0 = launched).
extern "C" int rl_geom_terrain(float* x, const float* cst, int n, int D,
                               int K, int ng, int ct, const float* grid,
                               long long H, long long W, float border,
                               float scale, const long long* ix0,
                               const long long* iy0, int rows, int cols,
                               float* xy, void* stream) {
  if (n <= 0 || ng <= 0 || ng > RL_MAX_NG || D <= 0 || K <= 0 || H < 2
      || W < 2 || rows < 2 || cols < 2 || (ix0 == nullptr) != (iy0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const rl::GridRef G{grid, H, W, border, scale, rows, cols};
  const long long pairs = (long long)n * ng;
  const unsigned blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
  geom_terrain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cst, n, D, K, ng, ct, G, ix0, iy0, xy);
  return (int)cudaGetLastError();
}
