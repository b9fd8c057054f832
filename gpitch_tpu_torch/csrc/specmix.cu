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
// at least 115 us at 3.35 TB/s).  Evaluated directly, each output costs
// P cosines of arguments up to ~3e3 rad and one exponential, which makes the
// kernel bound by instructions, and the f32 rounding of 2 pi f (x - x2) at
// such arguments is its largest error.  So the kernel uses the feature form
//   sum_p e_p cos(w_p (x - x2)) = sum_p phi_p(x) . phi_p(x2),
//   phi_p(x) = sqrt(e_p) (cos(w_p x), sin(w_p x)),
// 2P FMAs and one exponential per output and source.  Two launches:
//   * a feature pass writes, per matrix and source, the features of every
//     row and column point and the points themselves into a workspace the
//     wrapper allocates (4.3 MB at the SoSp shape).  The angle w_p x is
//     formed in f64 from the inputs (which convert exactly), reduced mod
//     2 pi in f64, rounded to the working type and passed to sincosf
//     (sincos in f64): ~3e-7 of max|K| against f64, where the direct form
//     loses ~1e-4.  Computing them per tile instead cost a third of the
//     build's instructions;
//   * the build: persistent blocks of 32 x 8 threads walk 64 x 128 output
//     tiles, each with its sources in chunks whose features fit 48 KB (one
//     source of P = 20 takes 32 KB).  A tile's features are fixed, aligned
//     spans of the workspace, copied by cp.async into one of two stages
//     while the block computes the previous tile.  Each thread holds an
//     8 x 4 register tile: rows i0 + ty + 8 v (features read as 16-byte
//     broadcasts), columns jt + 32 u, where jt shifts the tile left by the
//     thread's rows' offset within a 32-byte sector (the rows share it), so
//     every warp store of 32 floats (128 bytes, __stcs: the output is far
//     beyond the 50 MB L2) fills whole sectors although the 2001-float row
//     pitch is not aligned.  The f32 envelope is one ex2.approx.
// On the H100 (PERF.md, chip_smoke.py's specmix phase) it takes ~1.7x the
// byte bound at the SoSp shape, where filling the same output with a
// constant (fill_ms) takes ~1.05x.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRows = 8;                          // per thread
constexpr int kCols = 4;                          // per thread
constexpr int kBlocks = 2;                        // resident blocks per SM (register cap)
constexpr int kTileN = kThreadsY * kRows;         // 64
constexpr int kTileM = kThreadsX * kCols;         // 128
constexpr int kTileY = kTileM + 8;                // column features: the tile and 8 to its left
constexpr int kPoints = kTileN + kTileY;          // a tile's row and column points
constexpr int kChunkBytes = 48 * 1024;            // features of a chunk of sources
constexpr int kMaxSmem = 232448;                 // a block's shared memory on the H100
constexpr size_t kSmemPerSm = 233472;             // an SM's
constexpr int kMaxDevices = 64;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;

// The envelope exp(-r), r = |x - x2| / l.  In f32 the kernel scales 1 / l
// by log2(e) once per source and takes one ex2.approx per output (relative
// error below 2^-22, against ~10 instructions for expf); f64 calls exp.
__device__ __forceinline__ float env_scale(float il) { return il * 1.44269504088896341f; }
__device__ __forceinline__ double env_scale(double il) { return il; }
__device__ __forceinline__ float exp_neg(float rs) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-rs));
  return y;
}
__device__ __forceinline__ double exp_neg(double rs) { return exp(-rs); }
__device__ __forceinline__ float unscale(float rs) { return rs * 0.693147180559945309f; }
__device__ __forceinline__ double unscale(double rs) { return rs; }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
__device__ __forceinline__ void sincos_of(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_of(double x, double* s, double* c) { sincos(x, s, c); }

// the output, far beyond the 50 MB L2, is written with a streaming hint
__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store(double* p, double v) { __stcs(p, v); }

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// a thread's 8 x 4 outputs: rows i + 8 v, columns j + 32 u
template <typename T, int R, int C>
__device__ __forceinline__ void store_tile(T* outz, const T (&val)[R][C], int i, int j, int N,
                                           int M) {
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const int iv = i + kThreadsY * v;
    if (iv >= N) break;
    T* row = outz + static_cast<int64_t>(iv) * M;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int ju = j + kThreadsX * u;
      if (ju >= 0 && ju < M) store(row + ju, val[v][u]);
    }
  }
}

// Sources per chunk, and one stage of the pipeline in elements: the chunk's
// features of the tile's rows and columns, then the points themselves, then
// the sources' variances and lengthscales (rounded up to 4 elements).
template <typename T>
void plan(int ns, int P, int* chunk, int* stage) {
  const int per_source = 2 * P * kPoints + 2;
  const int fit = kChunkBytes / static_cast<int>(sizeof(T) * per_source);
  *chunk = fit < 1 ? 1 : (fit < ns ? fit : ns);
  *stage = (*chunk * per_source + kPoints + 3) / 4 * 4;
}

// The workspace of one (matrix, source): 2P + 1 rows of np elements, the
// cos features sqrt(e_p) cos(w_p t) of the P partials, their sin features,
// then the points t themselves.  A row holds the row points x in blocks of
// 64, each block permuted so that point i0 + ty + 8 v sits at ty 8 + v (a
// thread's rows, contiguous), then the column points x2 from column -8 to
// the last tile's end; zeros outside the matrix.  Every tile then copies
// fixed, aligned spans with no bounds checks.
struct Workspace {
  int nr;                                           // row part: N rounded up to 64
  int np;                                           // elements per row
  __host__ __device__ Workspace(int N, int M)
      : nr((N + kTileN - 1) / kTileN * kTileN),
        np(nr + 8 + (M + 7 + kTileM - 1) / kTileM * kTileM) {}
};

// The angle is formed in f64 from the inputs (which convert exactly),
// reduced to [-pi, pi] in f64, and rounded to the working type.
template <typename T>
__global__ void features_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                                const T* __restrict__ energy, const T* __restrict__ freq,
                                T* __restrict__ feat, int S, int N, int M, int P) {
  const Workspace ws(N, M);
  const int64_t bsp = blockIdx.x;                  // (b, s, p), p == P: the points
  const int64_t bs = bsp / (P + 1), b = bs / S;
  const int p = static_cast<int>(bsp % (P + 1));
  const int pos = blockIdx.y * blockDim.x + threadIdx.x;
  if (pos >= ws.np) return;
  bool in;
  T xv = T(0);
  if (pos < ws.nr) {
    const int w = pos % kTileN;
    const int i = pos - w + (w % kRows) * kThreadsY + w / kRows;
    in = i < N;
    if (in) xv = x[b * N + i];
  } else {
    const int j = pos - ws.nr - 8;
    in = j >= 0 && j < M;
    if (in) xv = x2[b * M + j];
  }
  T* f = feat + bs * (2 * P + 1) * static_cast<int64_t>(ws.np) + pos;
  if (p == P) {
    f[2 * static_cast<int64_t>(P) * ws.np] = xv;
    return;
  }
  T sn = T(0), cn = T(0);
  if (in) {
    const int64_t e = bs * P + p;
    const double th = kTwoPi * static_cast<double>(freq[e]) * static_cast<double>(xv);
    const double red = fma(-rint(th * kInvTwoPi), kTwoPi, th);
    sincos_of(static_cast<T>(red), &sn, &cn);
    const T se = sqrt_of(energy[e]);
    sn *= se;
    cn *= se;
  }
  f[static_cast<int64_t>(p) * ws.np] = cn;
  f[static_cast<int64_t>(P + p) * ws.np] = sn;
}

// One work item: a 64 x 128 output tile and a chunk of its sources.
struct Item {
  int64_t z;                                        // matrix (and source)
  int i0, j0, c0;                                   // first row, column, source
};

// A block takes the tiles blockIdx.x + G t (G blocks), each with all its
// chunks in order, so a tile's source sum stays in one block's registers:
// its local item k is chunk k % nchunks of its tile k / nchunks.
__device__ __forceinline__ Item item_of(int64_t k, int nchunks, int ntn, int ntm, int chunk) {
  const int64_t tile = blockIdx.x + k / nchunks * gridDim.x;
  const int64_t per_z = static_cast<int64_t>(ntn) * ntm;
  const int64_t rem = tile % per_z;
  return {tile / per_z, static_cast<int>(rem / ntm) * kTileN,
          static_cast<int>(rem % ntm) * kTileM, static_cast<int>(k % nchunks) * chunk};
}

__device__ __forceinline__ void copy_async(void* dst, const void* src, size_t bytes) {
  __pipeline_memcpy_async(dst, src, bytes);
}

// Start the copies of one item's stage into shared memory, in 16-byte
// pieces: each (source, feature) row's 64 row and 136 column elements, the
// points' row, then the variances and lengthscales.
template <typename T, bool SUM>
__device__ __forceinline__ void prefetch(T* st, const Item& it, const T* __restrict__ feat,
                                         const T* __restrict__ var, const T* __restrict__ ls,
                                         int S, const Workspace& ws, int P, int chunk, int tid) {
  constexpr int kE = 16 / sizeof(T);                // elements per piece
  constexpr int kPx = kTileN / kE, kPiece = kPoints / kE;
  const int64_t b = SUM ? it.z : it.z / S;
  const int s = (SUM ? 0 : static_cast<int>(it.z % S)) + it.c0;
  const int nc = min(chunk, (SUM ? S : 1) - it.c0);
  const int q2 = 2 * P;
  const T* src0 = feat + (b * S + s) * (q2 + 1) * static_cast<int64_t>(ws.np);
  T* fx = st;
  T* fy = fx + chunk * q2 * kTileN;
  T* pts = fy + chunk * q2 * kTileY;
  const int nthreads = kThreadsX * kThreadsY;
  for (int t = tid; t < (nc * q2 + 1) * kPiece; t += nthreads) {
    const int r = t / kPiece, c = t % kPiece;       // r == nc q2: the points
    const bool feature = r < nc * q2;
    const int64_t row = feature ? r / q2 * (q2 + 1) + r % q2 : q2;
    const T* src = src0 + row * ws.np + (c < kPx ? it.i0 + c * kE : ws.nr + it.j0 + (c - kPx) * kE);
    T* dst = feature ? (c < kPx ? fx + r * kTileN + c * kE : fy + r * kTileY + (c - kPx) * kE)
                     : pts + c * kE;
    copy_async(dst, src, 16);
  }
  for (int t = tid; t < 2 * nc; t += nthreads)
    copy_async(pts + kPoints + t, (t < nc ? var : ls) + b * S + s + t % nc, sizeof(T));
  __pipeline_commit();
}

template <typename T, bool M32, bool SUM>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, kBlocks)
specmix_kernel(const T* __restrict__ feat, const T* __restrict__ var, const T* __restrict__ ls,
               T* __restrict__ out, int64_t nz, int S, int N, int M, int P, int chunk,
               int stage) {
  constexpr int kSector = 32 / sizeof(T);           // elements per 32-byte sector
  const int ns = SUM ? S : 1;                       // sources a tile sums
  const int nchunks = (ns + chunk - 1) / chunk;
  const int q2 = 2 * P;
  const int ntn = (N + kTileN - 1) / kTileN;
  // a row's tiles start up to 7 columns left of 128 k, so one more may end it
  const int ntm = (M + 7 + kTileM - 1) / kTileM;
  const int64_t ntiles = nz * ntn * ntm;
  const Workspace ws(N, M);
  // this block's items: chunks of the tiles blockIdx.x, blockIdx.x + G, ...
  const int64_t nitems = ((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * nchunks;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);      // two stages, used in turn
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  T total[SUM ? kRows : 1][SUM ? kCols : 1];
  int64_t k = 0;
  if (k < nitems)
    prefetch<T, SUM>(stages, item_of(k, nchunks, ntn, ntm, chunk), feat, var, ls, S, ws, P,
                     chunk, tid);
  for (int buf = 0; k < nitems; ++k, buf ^= 1) {
    const Item it = item_of(k, nchunks, ntn, ntm, chunk);
    const int64_t next = k + 1;
    if (next < nitems)       // the next item's copies run while this one computes
      prefetch<T, SUM>(stages + (buf ^ 1) * stage, item_of(next, nchunks, ntn, ntm, chunk),
                       feat, var, ls, S, ws, P, chunk, tid);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    const T* fx = stages + buf * stage;
    const T* fy = fx + chunk * q2 * kTileN;
    const T* pts = fy + chunk * q2 * kTileY;
    const int nc = min(chunk, ns - it.c0);
    // This thread's rows are i0 + ty + 8 v, which all start at the same
    // offset within a sector; its columns are shifted left by that offset
    // (jt + 32 u), so each warp store of 32 values fills whole sectors.
    T* outz = out + it.z * static_cast<int64_t>(N) * M;
    const int sh = static_cast<int>(
        (it.z * static_cast<int64_t>(N) * M + static_cast<int64_t>(it.i0 + ty) * M) % kSector);
    const int jt = it.j0 - sh + tx;
    T xi[kRows], xj[kCols];
#pragma unroll
    for (int v = 0; v < kRows; ++v) xi[v] = pts[ty * kRows + v];
#pragma unroll
    for (int u = 0; u < kCols; ++u) xj[u] = pts[kTileN + 8 - sh + tx + kThreadsX * u];
    if (SUM && it.c0 == 0) {
#pragma unroll
      for (int v = 0; v < kRows; ++v)
#pragma unroll
        for (int u = 0; u < kCols; ++u) total[SUM ? v : 0][SUM ? u : 0] = T(0);
    }

    for (int cs = 0; cs < nc; ++cs) {
      T mix[kRows][kCols] = {};
      const T* fxs = fx + cs * q2 * kTileN + ty * kRows;
      const T* fys = fy + cs * q2 * kTileY + 8 - sh + tx;
#pragma unroll 2
      for (int q = 0; q < q2; ++q) {
        T a[kRows], c[kCols];
        ld4(fxs + q * kTileN, a);
        ld4(fxs + q * kTileN + 4, a + 4);
#pragma unroll
        for (int u = 0; u < kCols; ++u) c[u] = fys[q * kTileY + kThreadsX * u];
#pragma unroll
        for (int v = 0; v < kRows; ++v)
#pragma unroll
          for (int u = 0; u < kCols; ++u) mix[v][u] += a[v] * c[u];
      }
      const T vs = pts[kPoints + cs], ils = env_scale(T(1) / pts[kPoints + nc + cs]);
#pragma unroll
      for (int v = 0; v < kRows; ++v)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const T rs = abs_of(xi[v] - xj[u]) * ils;
          T env = exp_neg(rs);
          if (M32) env = (T(1) + unscale(rs)) * env;
          if (SUM) total[SUM ? v : 0][SUM ? u : 0] += vs * env * mix[v][u];
          else mix[v][u] *= vs * env;
        }
      if (!SUM) store_tile(outz, mix, it.i0 + ty, jt, N, M);
    }
    if constexpr (SUM) {
      if (it.c0 + nc == ns) store_tile(outz, total, it.i0 + ty, jt, N, M);
    }
    __syncthreads();                                // this stage is consumed
  }
}

template <typename T, bool M32>
cudaError_t build(const T* x, const T* x2, const T* feat, const T* var, const T* ls, T* out,
                  int64_t nz, int S, int N, int M, int P, int sum_sources, cudaStream_t stream) {
  int chunk = 0, stage = 0;
  plan<T>(sum_sources ? S : 1, P, &chunk, &stage);
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(stage);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto* fn = sum_sources ? &specmix_kernel<T, M32, true> : &specmix_kernel<T, M32, false>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  // once per device and kernel: the SM count, and all of a block's shared memory
  static std::atomic<int> sms_of[kMaxDevices][2];
  int sms = sms_of[device][sum_sources != 0].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms_of[device][sum_sources != 0].store(sms, std::memory_order_relaxed);
  }
  // persistent blocks: as many as the SMs hold at once (the register cap of
  // __launch_bounds__, and 228 KB of shared memory per SM, 1 KB of it
  // reserved per block), each walking its tiles
  const int by_smem = static_cast<int>(kSmemPerSm / (smem + 1024));
  const int per_sm = by_smem < kBlocks ? by_smem : kBlocks;
  const int64_t ntiles = nz * ((N + kTileN - 1) / kTileN) * ((M + 7 + kTileM - 1) / kTileM);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(ntiles < resident ? ntiles : resident);
  fn<<<blocks, dim3(kThreadsX, kThreadsY), smem, stream>>>(feat, var, ls, out, nz, S, N,
                                                           M, P, chunk, stage);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* x2, const void* energy, const void* freq,
           const void* var, const void* ls, void* feat, void* out, int64_t B, int S, int N,
           int M, int P, int m32, int sum_sources, void* stream) {
  if (B == 0 || S == 0 || N == 0 || M == 0) return 0;
  const int64_t nz = sum_sources ? B : B * S;
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 fgrid(static_cast<unsigned>(B * S * (P + 1)), (Workspace(N, M).np + 255) / 256);
  features_kernel<T><<<fgrid, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2), static_cast<const T*>(energy),
      static_cast<const T*>(freq), static_cast<T*>(feat), S, N, M, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* run = m32 ? &build<T, true> : &build<T, false>;
  err = run(static_cast<const T*>(x), static_cast<const T*>(x2), static_cast<const T*>(feat),
            static_cast<const T*>(var), static_cast<const T*>(ls), static_cast<T*>(out), nz, S,
            N, M, P, sum_sources, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Elements of the workspace that one (matrix, source) needs: pass
// (B, S, gpitch_specmix_workspace(N, M, P)) as feat.
int gpitch_specmix_workspace(int N, int M, int P) {
  return (2 * P + 1) * Workspace(N, M).np;
}

// x: (B, N); x2: (B, M); energy, freq: (B, S, P); var, ls: (B, S); all
// contiguous.  feat: the workspace.  out: (B, S, N, M), or
// (B, N, M) with sum_sources.
// Returns cudaError_t.
int gpitch_specmix_f32(const void* x, const void* x2, const void* energy, const void* freq,
                       const void* var, const void* ls, void* feat, void* out, int64_t B,
                       int S, int N, int M, int P, int m32, int sum_sources, void* stream) {
  return launch<float>(x, x2, energy, freq, var, ls, feat, out, B, S, N, M, P, m32,
                       sum_sources, stream);
}

int gpitch_specmix_f64(const void* x, const void* x2, const void* energy, const void* freq,
                       const void* var, const void* ls, void* feat, void* out, int64_t B,
                       int S, int N, int M, int P, int m32, int sum_sources, void* stream) {
  return launch<double>(x, x2, energy, freq, var, ls, feat, out, B, S, N, M, P, m32,
                        sum_sources, stream);
}

}  // extern "C"
