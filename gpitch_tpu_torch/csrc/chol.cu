// Batched Cholesky factorization of many small SPD matrices.
//
// Replaces the TPU kernel gpitch_tpu/linalg/pallas/chol.py::cholesky_batched
// (_chol_kernel / _chol_kernel_panel): L with L L^T = K for every matrix of a
// (B, M, M) batch, M <= 256.  The SGPR bound calls it twice per evaluation
// (Kuu and I + A A^T / sigma^2), at B = windows (62-222) and M = 112-160.
//
// What bounds it on the H100: not bytes (the lower triangle of K read and
// all of L written, B (M (M + 1) / 2 + M^2) 4 bytes, 16.8 MB at B = 222,
// M = 112, about 5 us at 3.35 TB/s) and not operations (B M^3 / 3 FMAs,
// 0.2 GFLOP there), but the M-long chain of dependent pivot steps:
// each column needs the previous column's trailing update.  The design keeps
// that chain inside one thread block per matrix, in shared memory, with one
// block barrier per step and no trip to device memory:
//   * the lower triangle is held packed by columns (column j holds rows
//     j..M-1 contiguously), so f32 fits shared memory up to M = 256
//     (129 KB) and f64 up to M = 239; beyond that the wrapper passes a
//     scratch buffer in device memory and the same code runs on it;
//   * step j leaves column j unscaled and applies the rank-1 update
//     A[i][k] -= A[i][j] (A[k][j] / d_j) to the columns k > j.  The block
//     has up to 1024 threads: thread t owns row i = t mod M and every C-th
//     column (C = threads / M), so a step's trailing triangle is spread
//     over the whole block and no thread runs a long serial loop (C is cut
//     when the batch alone fills the SMs, where idle threads cost); threads
//     of one column group touch consecutive rows of one column (contiguous
//     shared memory) and read A[k][j] as a broadcast.  FMA in the working
//     type on CUDA cores (never TF32).  Column j is final when step j
//     starts, so nothing is written that another thread of the step reads;
//   * the output pass scales column k by 1/sqrt(d_k) and writes L row by
//     row (coalesced), with the upper triangle set to zero, because
//     chol_inv's backward reads L as a full matrix;
//   * a non-positive pivot makes d_j NaN, so the factor comes out NaN as
//     jnp.linalg.cholesky's does; it is never clamped.
// At B = 62-222 one block per matrix covers the 132 SMs once or more.
// Later work: several matrices per block for small M, a blocked panel form.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float nan_of(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

// offset of column j in the column-packed lower triangle (rows j..M-1):
// j M - j (j - 1) / 2, in 32 bits (M <= 256)
__device__ __forceinline__ int col_start(int j, int M) {
  return (j * (2 * M - j + 1)) >> 1;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
chol_kernel(const T* __restrict__ K, T* __restrict__ L, T* __restrict__ scratch,
            int M, int C) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int64_t b = blockIdx.x;
  const int64_t tri = static_cast<int64_t>(M) * (M + 1) / 2;
  T* pivot = smem;                                  // d_j of every step, M
  T* A = scratch != nullptr ? scratch + b * tri : smem + M;
  const T* Kb = K + b * M * M;
  T* Lb = L + b * M * M;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row = tid % M;                          // this thread's row
  const int group = tid / M;                        // its column group

  // lower triangle of K (read row by row, coalesced) into the column packing
  for (int i = warp; i < M; i += nwarps)
    for (int k = lane; k <= i; k += 32)
      A[col_start(k, M) + (i - k)] = Kb[static_cast<int64_t>(i) * M + k];
  __syncthreads();

  for (int j = 0; j < M; ++j) {
    const T* colj = A + col_start(j, M);            // rows j..M-1, final now
    T d = colj[0];
    if (!(d > T(0))) d = nan_of(d);                 // not positive definite
    if (tid == 0) pivot[j] = d;
    const T inv_d = T(1) / d;
    if (row > j && group < C) {
      const T a = colj[row - j];
      int k = j + 1 + group;
      // four columns a round, every load issued before any store: the
      // compiler cannot prove that the stores miss the next loads
      for (; k + 3 * C <= row; k += 4 * C) {
        T* p0 = A + col_start(k, M) + (row - k);
        T* p1 = A + col_start(k + C, M) + (row - k - C);
        T* p2 = A + col_start(k + 2 * C, M) + (row - k - 2 * C);
        T* p3 = A + col_start(k + 3 * C, M) + (row - k - 3 * C);
        const T f0 = colj[k - j], f1 = colj[k + C - j];
        const T f2 = colj[k + 2 * C - j], f3 = colj[k + 3 * C - j];
        const T v0 = *p0, v1 = *p1, v2 = *p2, v3 = *p3;
        *p0 = v0 - a * (f0 * inv_d);
        *p1 = v1 - a * (f1 * inv_d);
        *p2 = v2 - a * (f2 * inv_d);
        *p3 = v3 - a * (f3 * inv_d);
      }
      for (; k <= row; k += C) A[col_start(k, M) + (row - k)] -= a * (colj[k - j] * inv_d);
    }
    __syncthreads();
  }

  for (int i = warp; i < M; i += nwarps)
    for (int k = lane; k < M; k += 32)
      Lb[static_cast<int64_t>(i) * M + k] =
          k <= i ? A[col_start(k, M) + (i - k)] / sqrt_of(pivot[k]) : T(0);
}

constexpr int kMaxDevices = 64;

// Per device, cached on first use (they never change within a process):
// the SM count, and the dynamic shared memory chol_kernel<T> has been
// allowed so far.  Races between host threads only repeat the same calls.
std::atomic<int> g_sms[kMaxDevices];

template <typename T>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T>
int launch(const void* K, void* L, void* scratch, int64_t B, int M, void* stream) {
  if (B == 0 || M == 0) return 0;
  const size_t tri = static_cast<size_t>(M) * (M + 1) / 2;
  const int smem = static_cast<int>(sizeof(T) * (M + (scratch != nullptr ? 0 : tri)));
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device].store(sms, std::memory_order_relaxed);
  }
  if (smem > g_smem_allowed<T>[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_allowed<T>[device].store(smem, std::memory_order_relaxed);
  }
  // Column groups per row: as many as a 1024-thread block holds, but no
  // more than keep about one such block's worth of threads per SM when the
  // batch is large (the blocks then share SMs, and idle threads cost).
  const int64_t fill = static_cast<int64_t>(sms) * kMaxThreads / (B * M);
  const int groups = static_cast<int>(
      fill < 1 ? 1 : (fill < kMaxThreads / M ? fill : kMaxThreads / M));
  const int threads = (groups * M + 31) / 32 * 32;
  chol_kernel<T><<<static_cast<unsigned>(B), threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(scratch), M, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K, L: (B, M, M) contiguous; scratch: nullptr, or (B, M(M+1)/2) when the
// packed triangle does not fit a block's shared memory.  Returns cudaError_t.
int gpitch_chol_f32(const void* K, void* L, void* scratch, int64_t B, int M, void* stream) {
  return launch<float>(K, L, scratch, B, M, stream);
}

int gpitch_chol_f64(const void* K, void* L, void* scratch, int64_t B, int M, void* stream) {
  return launch<double>(K, L, scratch, B, M, stream);
}

}  // extern "C"
