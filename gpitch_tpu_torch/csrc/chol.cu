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
// 0.2 GFLOP there), but the chain of dependent steps inside one matrix, each
// ending in a block barrier.  A column-by-column form has M such steps; this
// kernel is blocked right-looking with panels of NB = 16 or 32 columns
// (the wrapper takes 16 up to M = 128, 32 above, the faster of the two on
// the H100), so the chain is ceil(M / NB) panels, each of two
// barrier-separated phases:
//   1. sub-diagonal panel (L21 = A21 L11^-T): one thread per row, the row in
//      registers, L11^T read from shared memory as 16-byte broadcasts;
//   2. trailing update (A22 -= L21 L21^T, lower 32 x 32 blocks only) by
//      all warps but warp 0: 64 threads per block, a 4 x 4 register tile
//      each (rows ty + 8q, columns tx + 8q'), L21 read as 16-byte vectors
//      along the panel.  The first group updates block 0, which holds the
//      next panel's diagonal block, first and then releases warp 0 (a
//      named barrier), which factors that block while the rest of the
//      update runs: one warp, the block in registers (lane r holds row r;
//      each column of L11 is broadcast through shared memory; the pivots'
//      chain runs through each lane's own diagonal entry and, in f32,
//      rsqrtf), no block barrier inside.
// That is 2 barriers per panel (14 in all at M = 112, NB = 16) instead of
// one per column.  The matrix, padded to a multiple of 4 with an identity tail,
// lives in shared memory packed by panels: panel q holds rows q NB..Mp-1 of
// its columns, row-major with a stride of NB + 4, so the 16-byte loads of
// eight consecutive rows hit 32 distinct banks.  f32 fits up to M = 256
// (170 KB at NB = 32); when the packing does not fit a block (f64 above
// M ~ 224) the wrapper passes a scratch buffer in device memory and the same
// code runs on it.  K's lower triangle is copied in by cp.async, and L
// written out row by row (coalesced, 16-byte pieces where the rows are
// 16-byte aligned) with the upper triangle set to zero, because chol_inv's
// backward reads L as a full matrix.  FMA in the working type on CUDA cores
// (never TF32).  A non-positive pivot makes d_j NaN, so the factor comes
// out NaN from that pivot on, as jnp.linalg.cholesky's does; it is never
// clamped.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLoads = 8;         // loads of K in flight per thread (scratch path)
constexpr int kBlk = 32;          // trailing-update block (64 threads, 4 x 4 each)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_of(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
// 1 / sqrt(d): the hardware reciprocal square root in f32 (within 2 ulp,
// a short latency on the chain of pivots), the correctly rounded pair in f64
__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return 1.0 / sqrt(x); }

// 16 bytes of values from 16-byte-aligned memory, and back
template <typename T>
__device__ __forceinline__ void ld16(const T* p, T* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  memcpy(v, &q, 16);
}
template <typename T>
__device__ __forceinline__ void st16(T* p, const T* v) {
  uint4 q;
  memcpy(&q, v, 16);
  *reinterpret_cast<uint4*>(p) = q;
}

// four consecutive values from 16-byte-aligned memory, and back
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// The panel packing of the padded order mp: panel q holds rows q NB..mp-1
// of columns q NB..q NB + NB - 1, row-major with stride NB + 4.
template <int NB>
struct Packing {
  static constexpr int kLd = NB + 4;
  int mp;
  __host__ __device__ int base(int q) const { return kLd * (q * mp - NB * q * (q - 1) / 2); }
  __device__ int at(int i, int j) const {
    const int q = j / NB;
    return base(q) + (i - q * NB) * kLd + (j - q * NB);
  }
  __host__ __device__ int panels() const { return (mp + NB - 1) / NB; }
  __host__ __device__ int elems() const { return base(panels()); }
};

// One warp factors a diagonal block held in registers: lane r holds row r
// (a[c], c <= r, zeros above; an identity row for r >= w).  Column j of L11
// goes through shared memory: lane r writes l_rj to lt[j][r] (so lt ends as
// L11^T, strictly lower part used) and reads the column back as 16-byte
// broadcasts.  The pivots' chain runs through each lane's own diagonal
// entry dg, which the lane updates with its own l.  Writes L11's rows r < w
// into the panel at P (stride NB + 4) and each pivot's 1 / sqrt into dinv.
template <typename T, int NB>
__device__ __forceinline__ void factor_diagonal(T (&a)[NB], int r, int w, T* P, T* lt,
                                                T* dinv) {
  T dg = T(0);
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c == r) dg = a[c];
  T my_inv = T(0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    T d = __shfl_sync(kFull, dg, j);
    if (!(d > T(0))) d = nan_of(d);                 // not positive definite
    const T inv = rsqrt_of(d);
    if (r == j) my_inv = inv;
    const T l = r >= j ? a[j] * inv : T(0);
    a[j] = l;
    if (r > j) dg -= l * l;
    if (r < NB) lt[j * NB + r] = l;
    __syncwarp();
#pragma unroll
    for (int g = (j + 1) / 4 * 4; g < NB; g += 4) {
      T v[4];
      ld4(lt + j * NB + g, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e > j) a[g + e] -= l * v[e];
    }
  }
  if (r < NB) {
    dinv[r] = my_inv;
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c <= r && r < w) P[r * (NB + 4) + c] = a[c];
  }
}

// Warp 0 and the trailing update's first group (threads 0-95) meet here
// once block 0 of the trailing matrix is updated (named barrier 1).
__device__ __forceinline__ void first_block_done() {
  asm volatile("bar.sync 1, 96;" ::: "memory");
}

// Lane r's row of the diagonal block at P (stride NB + 4): a[c] for c <= r,
// zeros above; an identity row for r >= w.
template <typename T, int NB>
__device__ __forceinline__ void load_diagonal(const T* P, int r, int w, T (&a)[NB]) {
#pragma unroll
  for (int c = 0; c < NB; c += 4) {
    T v[4];
    if (r < w) ld4(P + r * (NB + 4) + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[c + e] = r < w ? (c + e <= r ? v[e] : T(0)) : T(c + e == r ? 1 : 0);
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kMaxThreads)
chol_kernel(const T* __restrict__ K, T* __restrict__ L, T* __restrict__ scratch, int M) {
  constexpr int kLd = Packing<NB>::kLd;
  constexpr int kVec = 16 / sizeof(T);             // values per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lt = reinterpret_cast<T*>(smem_raw);           // L11^T of the current panel, NB x NB
  T* dinv = lt + NB * NB;                           // 1 / sqrt(pivot), NB
  const Packing<NB> pk{(M + 3) & ~3};
  const int mp = pk.mp;
  const int64_t b = blockIdx.x;
  T* A = scratch != nullptr ? scratch + b * pk.elems() : dinv + NB;
  const T* Kb = K + b * M * M;
  T* Lb = L + b * M * M;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  // the lower triangle of K, rows in order (coalesced), and the identity
  // tail below M; into shared memory by cp.async, 16 bytes a piece when K's
  // rows are 16-byte aligned (a piece never crosses a panel)
  if (scratch == nullptr) {
    const int vec = M % kVec == 0 ? kVec : 1;
    const int pieces = (M + vec - 1) / vec;
    for (int idx = tid; idx < M * pieces; idx += nthreads) {
      const int i = idx / pieces, j = (idx - i * pieces) * vec;
      if (j <= i)
        __pipeline_memcpy_async(A + pk.at(i, j), Kb + static_cast<int64_t>(i) * M + j,
                                vec * sizeof(T));
    }
    __pipeline_commit();
    for (int idx = tid; idx < (mp - M) * mp; idx += nthreads) {
      const int i = M + idx / mp, j = idx % mp;
      if (j <= i) A[pk.at(i, j)] = T(i == j ? 1 : 0);
    }
    __pipeline_wait_prior(0);
  } else {
    // into device memory: kLoads loads in flight per thread before their stores
    for (int base = tid; base < mp * mp; base += kLoads * nthreads) {
      T v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * nthreads, i = idx / mp, j = idx - i * mp;
        v[u] = T(i == j ? 1 : 0);
        if (i < M && j <= i) v[u] = Kb[static_cast<int64_t>(i) * M + j];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * nthreads, i = idx / mp, j = idx - i * mp;
        if (i < mp && j <= i) A[pk.at(i, j)] = v[u];
      }
    }
  }
  __syncthreads();

  // panel 0's diagonal block from shared memory
  if (warp == 0) {
    T a[NB];
    load_diagonal<T, NB>(A, lane, min(NB, mp), a);
    factor_diagonal<T, NB>(a, lane, min(NB, mp), A, lt, dinv);
  }
  __syncthreads();

  for (int k = 0;; ++k) {
    const int k0 = k * NB, t0 = k0 + NB;
    if (t0 >= mp) break;                            // panel k was the last
    T* P = A + pk.base(k);                          // row r of the panel at (r - k0) kLd

    // 1. rows below the block: x L11^T = a, forward substitution in registers
    for (int i = t0 + tid; i < mp; i += nthreads) {
      T* row = P + (i - k0) * kLd;
      T a[NB];
#pragma unroll
      for (int c = 0; c < NB; c += 4) {
        T v[4];
        ld4(row + c, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[c + e] = v[e];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        a[c] *= dinv[c];
#pragma unroll
        for (int g = (c + 1) / 4 * 4; g < NB; g += 4) {
          T v[4];
          ld4(lt + c * NB + g, v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (g + e > c) a[g + e] -= a[c] * v[e];
        }
      }
#pragma unroll
      for (int c = 0; c < NB; c += 4) st4(row + c, a + c);
    }
    __syncthreads();

    if (warp == 0) {
      // 2, warp 0: as soon as the first trailing block (panel k + 1's
      // diagonal block) is updated, factor it, while the other warps update
      // the rest of the trailing matrix
      const int w = min(NB, mp - t0);
      T* P1 = A + pk.base(k + 1);
      T a[NB];
      first_block_done();
      load_diagonal<T, NB>(P1, lane, w, a);
      factor_diagonal<T, NB>(a, lane, w, P1, lt, dinv);
    } else {
      // 2, the other warps: the lower 32 x 32 blocks from row t0 on; the
      // first group takes block 0, which holds panel k + 1's diagonal block,
      // first, and then lets warp 0 go on
      const int gt = tid - 32;
      const int nbk = (mp - t0 + kBlk - 1) / kBlk;
      const int tx = gt & 7, ty = (gt >> 3) & 7;
      for (int blk = gt >> 6; blk < nbk * (nbk + 1) / 2; blk += (nthreads - 32) >> 6) {
        int bi = static_cast<int>((sqrtf(8.0f * blk + 1.0f) - 1.0f) * 0.5f);
        while ((bi + 1) * (bi + 2) / 2 <= blk) ++bi;
        while (bi * (bi + 1) / 2 > blk) --bi;
        const int bj = blk - bi * (bi + 1) / 2;
        const int i0 = t0 + kBlk * bi + ty;
        const int j0 = t0 + kBlk * bj + tx;
        T acc[4][4] = {};
#pragma unroll 2
        for (int c = 0; c < NB; c += 4) {
          T xi[4][4], xj[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + 8 * q, j = j0 + 8 * q;
            if (i < mp) ld4(P + (i - k0) * kLd + c, xi[q]);
            else xi[q][0] = xi[q][1] = xi[q][2] = xi[q][3] = T(0);
            if (j < mp) ld4(P + (j - k0) * kLd + c, xj[q]);
            else xj[q][0] = xj[q][1] = xj[q][2] = xj[q][3] = T(0);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int q2 = 0; q2 < 4; ++q2)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[q][q2] += xi[q][e] * xj[q2][e];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            const int i = i0 + 8 * q, j = j0 + 8 * q2;
            if (i < mp && j <= i) A[pk.at(i, j)] -= acc[q][q2];
          }
        if (blk == 0) first_block_done();
      }
    }
    __syncthreads();
  }

  if (M % kVec == 0) {                              // 16-byte pieces of L's rows
    const int pieces = M / kVec;
    for (int idx = tid; idx < M * pieces; idx += nthreads) {
      const int i = idx / pieces, j = (idx - i * pieces) * kVec;
      T v[kVec];
      if (j <= i) {
        ld16(A + pk.at(i, j), v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = j + e <= i ? v[e] : T(0);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = T(0);
      }
      st16(Lb + static_cast<int64_t>(i) * M + j, v);
    }
  } else {
    for (int i = warp; i < M; i += nwarps)
      for (int j = lane; j < M; j += 32)
        Lb[static_cast<int64_t>(i) * M + j] = j <= i ? A[pk.at(i, j)] : T(0);
  }
}

constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

template <int NB>
int scratch_elems(int M, int elem) {
  const Packing<NB> pk{(M + 3) & ~3};
  const size_t smem = static_cast<size_t>(elem) * (NB * NB + NB + pk.elems());
  return smem > static_cast<size_t>(kMaxSmem) ? pk.elems() : 0;
}

// Per device, cached on first use (they never change within a process):
// the SM count, and the dynamic shared memory each kernel has been allowed
// so far.  Races between host threads only repeat the same calls.
std::atomic<int> g_sms[kMaxDevices];

template <typename T, int NB>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T, int NB>
int launch(const void* K, void* L, void* scratch, int64_t B, int M, void* stream) {
  if (B == 0 || M == 0) return 0;
  if ((scratch_elems<NB>(M, sizeof(T)) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Packing<NB> pk{(M + 3) & ~3};
  const int smem = static_cast<int>(
      sizeof(T) * (NB * NB + NB + (scratch != nullptr ? 0 : pk.elems())));
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
  if (smem > g_smem_allowed<T, NB>[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(chol_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_allowed<T, NB>[device].store(smem, std::memory_order_relaxed);
  }
  // the look-ahead warp, then 64 threads per 32 x 32 block of the first
  // trailing update, at most 7 blocks at a time; 3 when the batch alone
  // fills the SMs, where blocks share them
  const int nbk = (pk.mp - NB + kBlk - 1) / kBlk;
  int groups = nbk * (nbk + 1) / 2;
  const int most = B > sms ? 3 : (kMaxThreads - 32) / 64;
  groups = groups < 1 ? 1 : (groups > most ? most : groups);
  const int threads = 32 + 64 * groups;
  chol_kernel<T, NB><<<static_cast<unsigned>(B), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(scratch), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* K, void* L, void* scratch, int64_t B, int M, int nb, void* stream) {
  if (nb == 16) return launch<T, 16>(K, L, scratch, B, M, stream);
  if (nb == 32) return launch<T, 32>(K, L, scratch, B, M, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Elements of the per-matrix scratch buffer that a (M, M) factorization
// with panels of nb (16 or 32) needs when its packing does not fit a block's
// shared memory, else 0; elem is sizeof(T).  -1 for an nb the kernel lacks.
int gpitch_chol_scratch(int M, int nb, int elem) {
  if (nb == 16) return scratch_elems<16>(M, elem);
  if (nb == 32) return scratch_elems<32>(M, elem);
  return -1;
}

// K, L: (B, M, M) contiguous; scratch: nullptr, or (B, gpitch_chol_scratch)
// when that is not 0.  Returns cudaError_t.
int gpitch_chol_f32(const void* K, void* L, void* scratch, int64_t B, int M, int nb,
                    void* stream) {
  return dispatch<float>(K, L, scratch, B, M, nb, stream);
}

int gpitch_chol_f64(const void* K, void* L, void* scratch, int64_t B, int M, int nb,
                    void* stream) {
  return dispatch<double>(K, L, scratch, B, M, nb, stream);
}

}  // extern "C"
