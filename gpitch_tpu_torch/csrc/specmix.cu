// Spectral-mixture covariance build, batched over matrices and sources.
//
// Replaces the TPU kernel gpitch_tpu/linalg/pallas/specmix.py::specmix_matrix
// (_kernel):
//   K[b,s,i,j] = var[b,s] * env(|x[b,i] - x2[b,j]| / l[b,s])
//                * sum_p e[b,s,p] cos(2 pi f[b,s,p] (x[b,i] - x2[b,j]))
// with env(r) = exp(-r) (Matern-1/2) or (1 + r) exp(-r) (m32), forward only.
// m32 mirrors the TPU kernel's option; no kernel of the port passes it yet.
// With sum_sources the kernel writes sum_s K[b,s] instead of each source.
// The prediction path of separation builds the per-source (S, N, N) Grams of
// every window with it (N = 2001, S = 3, P = 5).
//
// What bounds it on the H100: the output.  It reads N + M + 4 S P floats per
// matrix and writes N M per source (384 MB for 24 Grams of 2001^2 in f32,
// at least 115 us at 3.35 TB/s), while each element costs P + 1
// transcendentals.  The design is one pass with nothing but the output in
// device memory:
//   * a 32 x 8 thread block covers a 32 x 32 tile; each thread computes four
//     rows of one column, so a warp writes 32 consecutive floats of a row
//     (coalesced along M);
//   * the block's source parameters (e, 2 pi f, var, 1/l) sit in shared
//     memory and the partial loop runs over them;
//   * cos and exp are the full-precision cosf/expf, not the __cosf
//     intrinsics: |x - x2| <= 0.125 s times f <= 8 kHz gives arguments up to
//     ~6e3 rad, where the intrinsics lose digits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kTile / kRowsPerThread;  // 8

__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <typename T, bool M32>
__global__ void specmix_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                               const T* __restrict__ energy, const T* __restrict__ freq,
                               const T* __restrict__ var, const T* __restrict__ ls,
                               T* __restrict__ out, int S, int N, int M, int P,
                               int sum_sources) {
  const int64_t z = blockIdx.z;                     // matrix (and source)
  const int64_t b = sum_sources ? z : z / S;
  const int s0 = sum_sources ? 0 : static_cast<int>(z % S);
  const int ns = sum_sources ? S : 1;               // sources this block sums

  extern __shared__ unsigned char smem_raw[];
  T* se = reinterpret_cast<T*>(smem_raw);          // (ns, P) energies
  T* sw = se + ns * P;                              // (ns, P) 2 pi f
  T* sv = sw + ns * P;                              // (ns,) variances
  T* sil = sv + ns;                                 // (ns,) 1 / lengthscale
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kBlockRows;
  const T two_pi = T(6.283185307179586);

  for (int t = tid; t < ns * P; t += nthreads) {
    const int64_t src = (b * S + s0 + t / P) * P + t % P;
    se[t] = energy[src];
    sw[t] = two_pi * freq[src];
  }
  for (int t = tid; t < ns; t += nthreads) {
    sv[t] = var[b * S + s0 + t];
    sil[t] = T(1) / ls[b * S + s0 + t];
  }
  __syncthreads();

  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= M) return;
  const T xj = x2[b * M + j];
  T* outz = out + z * static_cast<int64_t>(N) * M;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = blockIdx.y * kTile + threadIdx.y + r * kBlockRows;
    if (i >= N) break;
    const T d = x[b * N + i] - xj;
    const T rr = abs_of(d);
    T total = T(0);
    for (int s = 0; s < ns; ++s) {
      T mix = T(0);
#pragma unroll 5
      for (int p = 0; p < P; ++p) mix += se[s * P + p] * cos_of(sw[s * P + p] * d);
      const T r1 = rr * sil[s];
      T env = exp_of(-r1);
      if (M32) env = (T(1) + r1) * env;
      total += sv[s] * env * mix;
    }
    outz[static_cast<int64_t>(i) * M + j] = total;
  }
}

template <typename T>
int launch(const void* x, const void* x2, const void* energy, const void* freq,
           const void* var, const void* ls, void* out, int64_t B, int S, int N, int M,
           int P, int m32, int sum_sources, void* stream) {
  if (B == 0 || S == 0 || N == 0 || M == 0) return 0;
  const int64_t nz = sum_sources ? B : B * S;
  const int ns = sum_sources ? S : 1;
  const size_t smem = sizeof(T) * (2 * static_cast<size_t>(ns) * P + 2 * ns);
  const dim3 block(kTile, kBlockRows);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile,
                  static_cast<unsigned>(nz));
  if (nz > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* fn = m32 ? &specmix_kernel<T, true> : &specmix_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2), static_cast<const T*>(energy),
      static_cast<const T*>(freq), static_cast<const T*>(var), static_cast<const T*>(ls),
      static_cast<T*>(out), S, N, M, P, sum_sources);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, N); x2: (B, M); energy, freq: (B, S, P); var, ls: (B, S); all
// contiguous.  out: (B, S, N, M), or (B, N, M) with sum_sources.
// Returns cudaError_t.
int gpitch_specmix_f32(const void* x, const void* x2, const void* energy, const void* freq,
                       const void* var, const void* ls, void* out, int64_t B, int S, int N,
                       int M, int P, int m32, int sum_sources, void* stream) {
  return launch<float>(x, x2, energy, freq, var, ls, out, B, S, N, M, P, m32, sum_sources,
                       stream);
}

int gpitch_specmix_f64(const void* x, const void* x2, const void* energy, const void* freq,
                       const void* var, const void* ls, void* out, int64_t B, int S, int N,
                       int M, int P, int m32, int sum_sources, void* stream) {
  return launch<double>(x, x2, energy, freq, var, ls, out, B, S, N, M, P, m32, sum_sources,
                        stream);
}

}  // extern "C"
