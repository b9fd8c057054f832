// A CPU emulation of the CUDA subset that gpitch_tpu_torch/csrc/fused_whiten.cu
// uses, so that the tests can run its kernels' own code on the CPU (a CUDA
// kernel has no interpret mode): g++ -std=c++20 -I tests/cuda_emulation.
// Each CUDA thread is an OS thread and the blocks of a launch run one after
// another; __syncthreads is a barrier of the block's threads and a warp
// shuffle an exchange through memory between two barriers of the warp's
// 32 threads.  Dynamic shared memory starts as NaN at every block.  Only
// what the kernels compute is emulated: not their speed, their occupancy
// or the card's SM count (the split plan sees 132 SMs, one block each).
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_index {
  unsigned x, y, z;
};
inline thread_local emu_index threadIdx, blockIdx, blockDim;

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline void sincosf(float x, float* s, float* c) {
  *s = std::sin(x);
  *c = std::cos(x);
}
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidDevice = 101,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132;
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, const void*, int, int) {
  *v = 1;
  return cudaSuccess;
}

namespace emu {

constexpr int kSharedFloats = 232448 / 4;   // one block's dynamic shared memory
alignas(16) inline float shared[kSharedFloats];
inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline std::vector<float> lanes;

// Runs fn once per thread of each block of the grid, the blocks in order.
inline void run(dim3 grid, dim3 block, const std::function<void()>& fn) {
  const int nt = static_cast<int>(block.x);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(nt);
      block_barrier = &bar;
      warp_barriers.clear();
      for (int w = 0; w < (nt + 31) / 32; ++w)
        warp_barriers.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
      lanes.assign(static_cast<size_t>(32) * warp_barriers.size(), 0.f);
      std::memset(shared, 0xff, sizeof(shared));
      std::vector<std::thread> threads;
      threads.reserve(nt);
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          blockIdx = {bx, by, 0};
          blockDim = {block.x, 1, 1};
          fn();
        });
      for (auto& th : threads) th.join();
    }
}

template <class K>
struct Launch {
  dim3 grid, block;
  K kernel;
  template <class... A>
  void operator()(A... args) const {
    run(grid, block, [&] { kernel(args...); });
  }
};

template <class K>
Launch<K> launch(dim3 grid, dim3 block, K kernel) {
  return {grid, block, kernel};
}

}  // namespace emu

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = static_cast<int>(threadIdx.x), w = t / 32, lane = t % 32;
  float* slot = emu::lanes.data() + 32 * w;
  slot[lane] = v;
  emu::warp_barriers[w]->arrive_and_wait();
  const float r = slot[lane ^ off];
  emu::warp_barriers[w]->arrive_and_wait();
  return r;
}

#define GPITCH_LAUNCH(kernel, grid, block, smem, stream) \
  emu::launch(dim3(grid), dim3(block), [](auto... args) { kernel(args...); })
#define GPITCH_DYNAMIC_SHARED(name) float* name = emu::shared
