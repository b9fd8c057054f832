// A CPU emulation of the CUDA subset that gpitch_tpu_torch/csrc/fused_whiten.cu
// uses, so that the tests can run its kernels' own code on the CPU (a CUDA
// kernel has no interpret mode): g++ -std=c++20 -I tests/cuda_emulation.
// Each CUDA thread is an OS thread and the blocks of a launch run one after
// another; __syncthreads is a barrier of the block's threads, a named
// barrier (bar.sync / bar.arrive with an id and a thread count) a counter
// that releases its waiting threads when the count has arrived, and a warp
// shuffle an exchange through memory between two barriers of the warp's
// 32 threads; atomics and fences act on host memory, so a block that
// waits on a counter finds what the blocks before it counted, and cp.async
// copies are plain copies, done when issued.  Dynamic
// shared memory starts as NaN at every block.  Only
// what the kernels compute is emulated: not their speed, their occupancy
// or the card's SM count (the split plan sees 132 SMs, one block each).
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
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
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaMemset2DAsync(void* p, size_t pitch, int v, size_t width, size_t height,
                                     cudaStream_t) {
  for (size_t r = 0; r < height; ++r) std::memset(static_cast<char*>(p) + r * pitch, v, width);
  return cudaSuccess;
}
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

// A named barrier of the running block: `count` threads arrive, those that
// sync wait for the last of them.
struct Named {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned phase = 0;
};
inline Named named[16];

inline void named_barrier(int id, int count, bool wait) {
  Named& b = named[id];
  std::unique_lock<std::mutex> lock(b.m);
  const unsigned phase = b.phase;
  if (++b.arrived == count) {
    b.arrived = 0;
    ++b.phase;
    b.cv.notify_all();
  } else if (wait) {
    b.cv.wait(lock, [&] { return b.phase != phase; });
  }
}

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
      for (Named& b : named) b.arrived = 0;
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
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
#define GPITCH_ASYNC_COPY
inline void copy16_async(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void copy4_async(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
inline void copy_async_wait() {}

#define GPITCH_WARP_ROLES
inline void named_sync(int id, int count) { emu::named_barrier(id, count, true); }
inline void named_arrive(int id, int count) { emu::named_barrier(id, count, false); }

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
