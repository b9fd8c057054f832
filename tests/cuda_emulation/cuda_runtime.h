// A CPU emulation of the CUDA subset that gpitch_tpu_torch/csrc/fused_whiten.cu
// uses, so that the tests can run its kernels' own code on the CPU (a CUDA
// kernel has no interpret mode): g++ -std=c++20 -I tests/cuda_emulation.
// The blocks of a launch run one after another on the calling thread, and a
// block's CUDA threads are fibers on it (ucontext), each run until it waits
// or ends.  Every wait point yields to the scheduler: __syncthreads (the
// block's barrier), a named barrier (bar.sync / bar.arrive with an id and a
// thread count: a counter that releases its waiting threads when the count
// has arrived; bar.arrive counts and goes on), a warp shuffle (an exchange
// through memory between two barriers of the warp's 32 threads) and
// __nanosleep (a spin's turn).  A fiber that waits on a barrier is not
// resumed until the barrier's generation moves.
//
// The schedule is fixed: the scheduler resumes the runnable fibers in order
// of threadIdx.x and starts again from thread 0 whenever a barrier releases
// its waiters, so after each __syncthreads the warps run in order from
// warp 0, each thread up to its next wait.  Between two barriers a read of
// shared memory that a later thread writes finds what was there before,
// every time: NaN where the block has not written, as dynamic shared memory
// starts as NaN at every block.  The reverse race, a read of what an
// earlier thread writes with no barrier between, always finds the write
// and goes unseen.  A whole round of the scheduler in which
// every live fiber waits and none arrives or ends is a deadlock (a barrier
// that some threads of the block never reach, or a spin that nothing
// ends): the launch is abandoned there, the block and each thread's wait
// are printed to stderr, and the next cudaGetLastError returns
// cudaErrorLaunchFailure.
//
// Atomics and fences act on host memory, so a block that waits on a counter
// finds what the blocks before it counted, and cp.async copies are plain
// copies, done when issued.  Only what the kernels compute is emulated: not
// their speed, their occupancy or the card's SM count (the split plan sees
// 132 SMs, one block each).  Each fiber has a 256 KiB stack above a guard
// page: fused_whiten.cu's kernels, built at -O1, reach 3,048 bytes deep at
// most over the shapes of its emulated tests.
#pragma once

#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
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
// The running fiber's: the scheduler sets them before it resumes a fiber.
inline emu_index threadIdx, blockIdx, blockDim;

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
  cudaErrorLaunchFailure = 719,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};

namespace emu {

inline cudaError_t last_error = cudaSuccess;

constexpr int kSharedFloats = 232448 / 4;   // one block's dynamic shared memory
alignas(16) inline float shared[kSharedFloats];
constexpr size_t kStack = 256 << 10;        // one fiber's stack

// A barrier of the running block: `count` arrivals release its waiters and
// move its generation.
struct Barrier {
  int arrived = 0;
  unsigned generation = 0;
};
inline Barrier block_barrier, named[16];
inline std::vector<Barrier> warp_barriers;
inline std::vector<float> lanes;

enum Wait { kRunning, kSync, kNamed, kShuffle, kSleep, kEnded };

struct Fiber {
  ucontext_t context;
  Wait wait = kRunning;
  const unsigned* generation = nullptr;   // of the barrier it waits on
  unsigned seen = 0;                      // ... when it arrived
  int id = 0, count = 0;                  // a named barrier's, for the report
  bool runnable() const {
    return wait == kRunning || wait == kSleep || (wait != kEnded && *generation != seen);
  }
};

inline ucontext_t scheduler;
inline std::vector<Fiber> fibers;
inline bool progress = false;              // an arrival or an end since the round began
inline bool released = false;              // a barrier released its waiters
inline const std::function<void()>* body = nullptr;

inline Fiber& me() { return fibers[threadIdx.x]; }

inline void yield() { swapcontext(&me().context, &scheduler); }

inline void fiber_main() {
  (*body)();
  me().wait = kEnded;
  progress = true;
}   // returns to the scheduler through uc_link

// The calling fiber arrives at `b`, which `count` arrivals release; with
// `wait` it yields until they have, else it goes on.
inline void arrive(Barrier& b, int count, bool wait, Wait kind, int id = 0) {
  Fiber& f = me();
  const unsigned generation = b.generation;
  progress = true;
  if (++b.arrived == count) {
    b.arrived = 0;
    ++b.generation;
    released = true;
  }
  if (!wait) return;
  f.wait = kind;
  f.generation = &b.generation;
  f.seen = generation;
  f.id = id;
  f.count = count;
  yield();
  f.wait = kRunning;
}

inline void sleep_turn() {
  me().wait = kSleep;
  yield();
  me().wait = kRunning;
}

inline std::string describe(const Fiber& f) {
  switch (f.wait) {
    case kSync: return "__syncthreads";
    case kNamed: return "named_sync(" + std::to_string(f.id) + ", " + std::to_string(f.count) + ")";
    case kShuffle: return "__shfl_xor_sync";
    case kSleep: return "__nanosleep";
    case kEnded: return "ended";
    default: return "running";
  }
}

// Prints the deadlocked block and the wait of each run of its threads.
inline void report_deadlock() {
  std::string msg = "cuda emulation: deadlock in block (" + std::to_string(blockIdx.x) + ", " +
                    std::to_string(blockIdx.y) + "):";
  const int nt = static_cast<int>(fibers.size());
  for (int t = 0; t < nt;) {
    const std::string what = describe(fibers[t]);
    int u = t + 1;
    while (u < nt && describe(fibers[u]) == what) ++u;
    msg += " threads " + std::to_string(t) + "-" + std::to_string(u - 1) + " " + what + ";";
    t = u;
  }
  std::fprintf(stderr, "%s\n", msg.c_str());
}

// Runs the block's fibers until all have ended; false on a deadlock.
inline bool run_block() {
  const int nt = static_cast<int>(fibers.size());
  for (;;) {
    progress = false;
    released = false;
    int live = 0;
    for (int t = 0; t < nt && !released; ++t) {
      if (fibers[t].wait == kEnded) continue;
      ++live;
      if (!fibers[t].runnable()) continue;
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      swapcontext(&scheduler, &fibers[t].context);
    }
    if (live == 0) return true;
    if (!progress) return false;
  }
}

// Runs fn once per thread of each block of the grid, the blocks in order,
// the threads of a block as fibers on the calling thread.
inline void run(dim3 grid, dim3 block, const std::function<void()>& fn) {
  const int nt = static_cast<int>(block.x);
  const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  const size_t span = kStack + page;    // a guard page below each stack
  char* stacks = static_cast<char*>(mmap(nullptr, span * nt, PROT_READ | PROT_WRITE,
                                         MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
  if (stacks == MAP_FAILED) {
    last_error = cudaErrorLaunchFailure;
    return;
  }
  for (int t = 0; t < nt; ++t) mprotect(stacks + span * t, page, PROT_NONE);
  body = &fn;
  fibers.resize(nt);
  blockDim = {block.x, 1, 1};
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    blockIdx = {b % grid.x, b / grid.x, 0};
    block_barrier.arrived = 0;
    for (Barrier& n : named) n.arrived = 0;
    warp_barriers.assign((nt + 31) / 32, Barrier{});
    lanes.assign(static_cast<size_t>(32) * warp_barriers.size(), 0.f);
    std::memset(shared, 0xff, sizeof(shared));
    for (int t = 0; t < nt; ++t) {
      Fiber& f = fibers[t];
      f = Fiber{};
      getcontext(&f.context);
      f.context.uc_stack.ss_sp = stacks + span * t + page;
      f.context.uc_stack.ss_size = kStack;
      f.context.uc_link = &scheduler;
      makecontext(&f.context, fiber_main, 0);
    }
    if (!run_block()) {
      report_deadlock();
      last_error = cudaErrorLaunchFailure;
      break;    // the card would hang here: no later block runs
    }
  }
  munmap(stacks, span * nt);
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

inline cudaError_t cudaGetLastError() { return std::exchange(emu::last_error, cudaSuccess); }
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

inline void __syncthreads() {
  emu::arrive(emu::block_barrier, static_cast<int>(emu::fibers.size()), true, emu::kSync);
}
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { emu::sleep_turn(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
#define GPITCH_ASYNC_COPY
inline void copy16_async(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void copy4_async(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
inline void copy_async_wait() {}

#define GPITCH_WARP_ROLES
inline void named_sync(int id, int count) {
  emu::arrive(emu::named[id], count, true, emu::kNamed, id);
}
inline void named_arrive(int id, int count) {
  emu::arrive(emu::named[id], count, false, emu::kNamed, id);
}

inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = static_cast<int>(threadIdx.x), w = t / 32, lane = t % 32;
  const int warp = std::min(32, static_cast<int>(emu::fibers.size()) - 32 * w);
  float* slot = emu::lanes.data() + 32 * w;
  slot[lane] = v;
  emu::arrive(emu::warp_barriers[w], warp, true, emu::kShuffle);
  const float r = slot[lane ^ off];
  emu::arrive(emu::warp_barriers[w], warp, true, emu::kShuffle);
  return r;
}

#define GPITCH_LAUNCH(kernel, grid, block, smem, stream) \
  emu::launch(dim3(grid), dim3(block), [](auto... args) { kernel(args...); })
#define GPITCH_DYNAMIC_SHARED(name) float* name = emu::shared
