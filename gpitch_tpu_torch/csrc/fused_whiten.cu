// The fused build -> whiten -> accumulate chain of the SGPR bound, forward
// (kernel A) and backward (kernel B), per window of a bank.
//
// Replaces the TPU kernels of scripts/proto_fused_whiten.py, make_fused_mxu
// (_kernel_mxu) and make_fused (_kernel), with kernel A, and of
// scripts/proto_fused_whiten_bwd.py, make_fused_bwd (_kernel_bwd), with
// kernel B.  Per window, z (M), x and err (N), Linv (M, M):
//   Kuf[m,t] = sum_s var_s exp(-|z_m - x_t| il_s) sum_p e_sp cos(2 pi f_sp (z_m - x_t))
//   A = Linv Kuf,  U = A A^T,  v = A err                          (kernel A)
//   given (dU, dv): dA = (dU + dU^T) A + dv err^T, dLinv = dA Kuf^T,
//   dK = Linv^T dA, and per source, with E = exp(-|z - x| il),
//   C_p, S_p = cos, sin(2 pi f_p (z - x)), mix = sum_p e_p C_p, dM = var E dK:
//   dvar = <dK, E mix>, dinvl = -var <dK, E mix |z - x|>,
//   de_p = <dM, C_p>, df_p = -2 pi e_p <dM, (z - x) S_p>             (kernel B)
// The two TPU forward kernels differ only in where the TPU forms the cosine
// mixture (its vector unit, or a K = 2P contraction on its matrix unit); a
// 2P = 10 contraction is far below what the tensor cores take, and the bound
// may not use TF32, so one kernel serves both.
//
// What bounds it on the H100: operations.  Linv is lower triangular in
// every caller (the bank's chol_inv, the prototypes' recipe) and U is
// symmetric, so per window the function needs M (M + 1) N flops for
// A = Linv Kuf, M (M + 1) N for U, 2 M N for v and (4P + 4) S M N for the
// build; kernel B needs A again, 2 M^2 N each for dA and the dense dLinv
// (the contract returns every entry, as make_fused_bwd does), M (M + 1) N
// for dK = Linv^T dA and 8P S M N for the per-source sums.  The kernels
// take Linv dense, as the prototypes do, and form A, dK and U as full
// products: up to twice those counts.  The bytes are x, err, Linv (and dU,
// dv) in and U, v (or the gradients) out.  The design keeps Kuf, A, dA and
// dK out of device memory:
//   * grid (splits, windows): a block walks tiles of 32 samples of one
//     window; when the windows alone do not fill the card's resident
//     blocks, a window's tiles are split over several blocks (`plan`), each
//     writing a partial record that a second kernel adds in a fixed order
//     (no atomics: a run is bit-for-bit reproducible);
//   * 256 threads as 16 x 16; M is padded to MP = 16 RU (RU in 1, 2, 4, 7,
//     10: M <= 160) with zeros.  A thread owns an RU x 2 piece of every
//     (MP, 32) tile (rows ty + 16 r, columns 2 tx + c) and an RU x RU piece
//     of U or dLinv (rows ty + 16 r, columns tx + 16 c), kept in registers
//     across the tiles;
//   * shared memory holds Linv (MP x (MP + 1)), the Kuf and A tiles (and dA
//     in kernel B), z, and the cos/sin features of z and of the tile's x for
//     a chunk of at most 16 (source, partial) pairs; when every pair fits one
//     chunk the z features are computed once per block.  Kernel B reads
//     dU + dU^T from device memory (L2) 16 columns at a time;
//   * per-source sums of kernel B: each thread sums its elements, a warp
//     adds its lanes with a butterfly, and one thread per output adds the 8
//     warps in order into the block's record in device memory;
//   * every product is an f32 FMA on the CUDA cores, never TF32; cos, sin
//     and exp are the full-precision sincosf/expf (arguments reach ~6e3 rad),
//     and an angle is formed as (2 pi z) f like the plain version;
//   * ragged N: samples past the end get Kuf = 0 and err = 0, so they add
//     nothing; no padding of the inputs.
// Later work: tensor-core 3xTF32 or wgmma products, a symmetric U, a
// triangular Linv.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kTile = 32;          // samples per tile (linalg/fused_whiten.py TILE_T)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kTile + 1;     // pitch of the (MP, kTile) tiles
constexpr int kPairCap = 16;       // (source, partial) pairs per feature chunk
constexpr int kStage = 16;         // columns of dU + dU^T staged per step
constexpr int kMaxDevices = 64;
constexpr double kSetupTiles = 0.5;  // a block's set-up, in tiles (splits plan)
constexpr float kTwoPi = 6.283185307179586f;

struct Args {
  const float* zc;      // (nw, M)
  const float* xc;      // (nw, N)
  const float* err;     // (nw, N)
  const float* linv;    // (nw, M, M)
  const float* energy;  // (S, P) or (nw, S, P)
  const float* freq;
  const float* var;     // (S,) or (nw, S)
  const float* inv_l;
  const float* du;      // (nw, M, M), kernel B
  const float* dv;      // (nw, M), kernel B
  float* part;          // (nw, splits, rec)
  int e_stride, v_stride, M, N, S, P, splits, rec, chunk_sources;
};

// Offsets (floats) of the shared-memory arrays; the host sizes the launch
// with the same function.
struct Layout {
  int linv, k, a, da, stage, z, x, err, fzc, fzs, fxc, fxs, pe, pf, pv, pil, red, total;
};

__host__ __device__ inline Layout make_layout(int mp, bool bwd, int sc, int P) {
  const int pairs = sc * P;
  Layout l;
  int o = 0;
  l.linv = o; o += mp * (mp + 1);
  l.k = o;    o += mp * kLd;
  l.a = o;    o += mp * kLd;
  l.da = o;   o += bwd ? mp * kLd : 0;
  l.stage = o; o += bwd ? mp * (kStage + 1) : 0;
  l.z = o;    o += mp;
  l.x = o;    o += kTile;
  l.err = o;  o += kTile;
  l.fzc = o;  o += pairs * mp;
  l.fzs = o;  o += pairs * mp;
  l.fxc = o;  o += pairs * kTile;
  l.fxs = o;  o += pairs * kTile;
  l.pe = o;   o += pairs;
  l.pf = o;   o += pairs;
  l.pv = o;   o += sc;
  l.pil = o;  o += sc;
  l.red = o;  o += bwd ? kWarps * sc * (2 * P + 2) : 0;
  l.total = o;
  return l;
}

// The parameters of sources s0 .. s0 + ns - 1 of window w.
__device__ void chunk_params(const Args& a, float* sm, const Layout& l, int w, int s0,
                             int ns) {
  const float* e = a.energy + static_cast<int64_t>(w) * a.e_stride + s0 * a.P;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride + s0 * a.P;
  for (int q = threadIdx.x; q < ns * a.P; q += kThreads) {
    sm[l.pe + q] = e[q];
    sm[l.pf + q] = f[q];
  }
  const int64_t vb = static_cast<int64_t>(w) * a.v_stride + s0;
  for (int q = threadIdx.x; q < ns; q += kThreads) {
    sm[l.pv + q] = a.var[vb + q];
    sm[l.pil + q] = a.inv_l[vb + q];
  }
}

// cos/sin(2 pi f_q u_i) of n points u (z, or the tile's x) for the chunk's
// pairs q, into c[q n + i], s[q n + i].
__device__ void features(const float* sm_u, const float* pf, float* c, float* s, int n,
                         int pairs) {
  for (int idx = threadIdx.x; idx < pairs * n; idx += kThreads) {
    const int q = idx / n, i = idx - q * n;
    float sn, cs;
    sincosf((kTwoPi * sm_u[i]) * pf[q], &sn, &cs);
    c[idx] = cs;
    s[idx] = sn;
  }
}

// sum_p e_p (cz cx + sz sx) for the thread's RU x 2 elements, source sl of
// the chunk.
template <int RU>
__device__ __forceinline__ void mixture(const float* sm, const Layout& l, int sl, int P,
                                        int ty, int tx, float (&mix)[RU][2]) {
  constexpr int MP = 16 * RU;
#pragma unroll
  for (int r = 0; r < RU; ++r) mix[r][0] = mix[r][1] = 0.f;
  for (int p = 0; p < P; ++p) {
    const int q = sl * P + p;
    const float e = sm[l.pe + q];
    const float xc0 = sm[l.fxc + q * kTile + 2 * tx], xc1 = sm[l.fxc + q * kTile + 2 * tx + 1];
    const float xs0 = sm[l.fxs + q * kTile + 2 * tx], xs1 = sm[l.fxs + q * kTile + 2 * tx + 1];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const float zc = sm[l.fzc + q * MP + ty + 16 * r], zs = sm[l.fzs + q * MP + ty + 16 * r];
      mix[r][0] += e * (zc * xc0 + zs * xs0);
      mix[r][1] += e * (zc * xc1 + zs * xs1);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block set-up: z and Linv (zero-padded to MP) into shared memory.
template <int RU>
__device__ void load_window(const Args& a, float* sm, const Layout& l, int w) {
  constexpr int MP = 16 * RU;
  const int M = a.M;
  for (int i = threadIdx.x; i < MP; i += kThreads)
    sm[l.z + i] = i < M ? a.zc[static_cast<int64_t>(w) * M + i] : 0.f;
  const float* L = a.linv + static_cast<int64_t>(w) * M * M;
  for (int idx = threadIdx.x; idx < MP * MP; idx += kThreads) {
    const int i = idx / MP, k = idx - i * MP;
    sm[l.linv + i * (MP + 1) + k] = (i < M && k < M) ? L[i * M + k] : 0.f;
  }
}

// One tile: x and err, then Kuf's (MP, kTile) tile into sm[l.k], masked to
// the window's M rows and N samples.  When the sources fit one chunk, its
// parameters and z features are already in shared memory.
template <int RU>
__device__ void build_tile(const Args& a, float* sm, const Layout& l, int w, int t0,
                           int nchunks) {
  constexpr int MP = 16 * RU;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid < kTile) {
    const int t = t0 + tid;
    const int64_t g = static_cast<int64_t>(w) * a.N + t;
    sm[l.x + tid] = t < a.N ? a.xc[g] : 0.f;
    sm[l.err + tid] = t < a.N ? a.err[g] : 0.f;
  }
  __syncthreads();
  float zr[RU], xt[2];
#pragma unroll
  for (int r = 0; r < RU; ++r) zr[r] = sm[l.z + ty + 16 * r];
  xt[0] = sm[l.x + 2 * tx];
  xt[1] = sm[l.x + 2 * tx + 1];
  float kacc[RU][2];
#pragma unroll
  for (int r = 0; r < RU; ++r) kacc[r][0] = kacc[r][1] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * a.chunk_sources;
    const int ns = min(a.chunk_sources, a.S - s0);
    if (nchunks > 1) {
      chunk_params(a, sm, l, w, s0, ns);
      __syncthreads();
      features(sm + l.z, sm + l.pf, sm + l.fzc, sm + l.fzs, MP, ns * a.P);
    }
    features(sm + l.x, sm + l.pf, sm + l.fxc, sm + l.fxs, kTile, ns * a.P);
    __syncthreads();
    for (int sl = 0; sl < ns; ++sl) {
      float mix[RU][2];
      mixture<RU>(sm, l, sl, a.P, ty, tx, mix);
      const float vs = sm[l.pv + sl], il = sm[l.pil + sl];
#pragma unroll
      for (int r = 0; r < RU; ++r)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          kacc[r][cc] += vs * expf(-fabsf(zr[r] - xt[cc]) * il) * mix[r][cc];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int i = ty + 16 * r, t = 2 * tx + cc;
      sm[l.k + i * kLd + t] = (i < a.M && t0 + t < a.N) ? kacc[r][cc] : 0.f;
    }
}

// out (MP, kTile) = Linv (or Linv^T) times in (MP, kTile), rows < M summed.
template <int RU, bool TRANSPOSE>
__device__ void linv_times(const float* sm, const Layout& l, int M, const float* in,
                           float* out) {
  constexpr int MP = 16 * RU;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[RU][2];
#pragma unroll
  for (int r = 0; r < RU; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int k = 0; k < M; ++k) {
    const float b0 = in[k * kLd + 2 * tx], b1 = in[k * kLd + 2 * tx + 1];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int i = ty + 16 * r;
      const float lv = TRANSPOSE ? sm[l.linv + k * (MP + 1) + i] : sm[l.linv + i * (MP + 1) + k];
      acc[r][0] += lv * b0;
      acc[r][1] += lv * b1;
    }
  }
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    out[(ty + 16 * r) * kLd + 2 * tx] = acc[r][0];
    out[(ty + 16 * r) * kLd + 2 * tx + 1] = acc[r][1];
  }
}

// acc[r][c] += sum_t p[ty + 16 r][t] q[tx + 16 c][t] over one tile.
template <int RU>
__device__ __forceinline__ void gram_tile(const float* p, const float* q,
                                          float (&acc)[RU][RU]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float pr[RU], qc[RU];
#pragma unroll
    for (int r = 0; r < RU; ++r) pr[r] = p[(ty + 16 * r) * kLd + t];
#pragma unroll
    for (int c = 0; c < RU; ++c) qc[c] = q[(tx + 16 * c) * kLd + t];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < RU; ++c) acc[r][c] += pr[r] * qc[c];
  }
}

template <int RU>
__device__ void store_square(const float (&acc)[RU][RU], int M, float* rec) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int c = 0; c < RU; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      if (i < M && j < M) rec[i * M + j] = acc[r][c];
    }
}

__device__ __forceinline__ void tile_range(const Args& a, int* begin, int* end) {
  const int tiles = (a.N + kTile - 1) / kTile;
  const int per = (tiles + a.splits - 1) / a.splits;
  *begin = blockIdx.x * per;
  *end = min(tiles, *begin + per);
}

// ------------------------------------------------------------- kernel A
template <int RU>
__global__ void __launch_bounds__(kThreads, 1) fused_whiten_fwd_kernel(Args a) {
  constexpr int MP = 16 * RU;
  extern __shared__ float sm[];
  const Layout l = make_layout(MP, false, a.chunk_sources, a.P);
  const int w = blockIdx.y, tid = threadIdx.x;
  const int nchunks = (a.S + a.chunk_sources - 1) / a.chunk_sources;
  load_window<RU>(a, sm, l, w);
  if (nchunks == 1) {
    chunk_params(a, sm, l, w, 0, a.S);
    __syncthreads();
    features(sm + l.z, sm + l.pf, sm + l.fzc, sm + l.fzs, MP, a.S * a.P);
  }
  __syncthreads();
  float u[RU][RU];
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int c = 0; c < RU; ++c) u[r][c] = 0.f;
  float vacc = 0.f;
  int begin, end;
  tile_range(a, &begin, &end);
  for (int tile = begin; tile < end; ++tile) {
    build_tile<RU>(a, sm, l, w, tile * kTile, nchunks);
    __syncthreads();
    linv_times<RU, false>(sm, l, a.M, sm + l.k, sm + l.a);
    __syncthreads();
    gram_tile<RU>(sm + l.a, sm + l.a, u);
    if (tid < MP)
      for (int t = 0; t < kTile; ++t) vacc += sm[l.a + tid * kLd + t] * sm[l.err + t];
    __syncthreads();
  }
  float* rec = a.part + (static_cast<int64_t>(w) * a.splits + blockIdx.x) * a.rec;
  store_square<RU>(u, a.M, rec);
  if (tid < a.M) rec[a.M * a.M + tid] = vacc;
}

// ------------------------------------------------------------- kernel B
template <int RU>
__global__ void __launch_bounds__(kThreads, 1) fused_whiten_bwd_kernel(Args a) {
  constexpr int MP = 16 * RU;
  extern __shared__ float sm[];
  const int P = a.P, S = a.S, M = a.M;
  const Layout l = make_layout(MP, true, a.chunk_sources, P);
  const int w = blockIdx.y, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int nchunks = (S + a.chunk_sources - 1) / a.chunk_sources;
  const int per_source = 2 * P + 2;   // dvar, dinvl, de_1..P, df_1..P
  float* rec = a.part + (static_cast<int64_t>(w) * a.splits + blockIdx.x) * a.rec;
  float* rvar = rec + M * M;
  float* rinvl = rvar + S;
  float* rde = rinvl + S;
  float* rdf = rde + S * P;
  for (int q = tid; q < 2 * S + 2 * S * P; q += kThreads) rvar[q] = 0.f;
  load_window<RU>(a, sm, l, w);
  if (nchunks == 1) {
    chunk_params(a, sm, l, w, 0, S);
    __syncthreads();
    features(sm + l.z, sm + l.pf, sm + l.fzc, sm + l.fzs, MP, S * P);
  }
  __syncthreads();
  const float* du = a.du + static_cast<int64_t>(w) * M * M;
  const float* dv = a.dv + static_cast<int64_t>(w) * M;
  float g[RU][RU];
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int c = 0; c < RU; ++c) g[r][c] = 0.f;
  int begin, end;
  tile_range(a, &begin, &end);
  for (int tile = begin; tile < end; ++tile) {
    const int t0 = tile * kTile;
    build_tile<RU>(a, sm, l, w, t0, nchunks);
    __syncthreads();
    linv_times<RU, false>(sm, l, M, sm + l.k, sm + l.a);
    __syncthreads();
    // dA = (dU + dU^T) A + dv err^T, (dU + dU^T) staged kStage columns at a time
    float da[RU][2];
#pragma unroll
    for (int r = 0; r < RU; ++r) da[r][0] = da[r][1] = 0.f;
    for (int k0 = 0; k0 < M; k0 += kStage) {
      for (int idx = tid; idx < MP * kStage; idx += kThreads) {
        const int kk = idx / MP, i = idx - kk * MP, k = k0 + kk;
        sm[l.stage + i * (kStage + 1) + kk] =
            (i < M && k < M) ? du[i * M + k] + du[k * M + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kStage; ++kk) {
        const float a0 = sm[l.a + (k0 + kk) * kLd + 2 * tx];
        const float a1 = sm[l.a + (k0 + kk) * kLd + 2 * tx + 1];
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          const float sv = sm[l.stage + (ty + 16 * r) * (kStage + 1) + kk];
          da[r][0] += sv * a0;
          da[r][1] += sv * a1;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int i = ty + 16 * r;
      const float dvi = i < M ? dv[i] : 0.f;
      sm[l.da + i * kLd + 2 * tx] = da[r][0] + dvi * sm[l.err + 2 * tx];
      sm[l.da + i * kLd + 2 * tx + 1] = da[r][1] + dvi * sm[l.err + 2 * tx + 1];
    }
    __syncthreads();
    // dLinv += dA Kuf^T; dK = Linv^T dA over A's tile
    gram_tile<RU>(sm + l.da, sm + l.k, g);
    linv_times<RU, true>(sm, l, M, sm + l.da, sm + l.a);
    __syncthreads();
    // per-source sums over the tile
    float zr[RU], xt[2];
#pragma unroll
    for (int r = 0; r < RU; ++r) zr[r] = sm[l.z + ty + 16 * r];
    xt[0] = sm[l.x + 2 * tx];
    xt[1] = sm[l.x + 2 * tx + 1];
    for (int c = 0; c < nchunks; ++c) {
      const int s0 = c * a.chunk_sources;
      const int ns = min(a.chunk_sources, S - s0);
      const int slots = ns * per_source;
      if (nchunks > 1) {
        chunk_params(a, sm, l, w, s0, ns);
        __syncthreads();
        features(sm + l.z, sm + l.pf, sm + l.fzc, sm + l.fzs, MP, ns * P);
        features(sm + l.x, sm + l.pf, sm + l.fxc, sm + l.fxs, kTile, ns * P);
        __syncthreads();
      }
      float* red = sm + l.red + warp * slots;
      for (int sl = 0; sl < ns; ++sl) {
        float mix[RU][2], dm[RU][2];
        mixture<RU>(sm, l, sl, P, ty, tx, mix);
        const float vs = sm[l.pv + sl], il = sm[l.pil + sl];
        float pvar = 0.f, pinvl = 0.f;
#pragma unroll
        for (int r = 0; r < RU; ++r)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float ad = fabsf(zr[r] - xt[cc]);
            const float env = expf(-ad * il);
            const float dk = sm[l.a + (ty + 16 * r) * kLd + 2 * tx + cc];
            const float pm = dk * env * mix[r][cc];
            pvar += pm;
            pinvl += pm * ad;
            dm[r][cc] = vs * env * dk;
          }
        pvar = warp_sum(pvar);
        pinvl = warp_sum(pinvl);
        if (lane == 0) {
          red[sl * per_source] = pvar;
          red[sl * per_source + 1] = pinvl;
        }
        for (int p = 0; p < P; ++p) {
          const int q = sl * P + p;
          const float xc0 = sm[l.fxc + q * kTile + 2 * tx], xc1 = sm[l.fxc + q * kTile + 2 * tx + 1];
          const float xs0 = sm[l.fxs + q * kTile + 2 * tx], xs1 = sm[l.fxs + q * kTile + 2 * tx + 1];
          float pde = 0.f, pdf = 0.f;
#pragma unroll
          for (int r = 0; r < RU; ++r) {
            const float zc = sm[l.fzc + q * MP + ty + 16 * r];
            const float zs = sm[l.fzs + q * MP + ty + 16 * r];
            pde += dm[r][0] * (zc * xc0 + zs * xs0) + dm[r][1] * (zc * xc1 + zs * xs1);
            pdf += dm[r][0] * (zr[r] - xt[0]) * (zs * xc0 - zc * xs0)
                 + dm[r][1] * (zr[r] - xt[1]) * (zs * xc1 - zc * xs1);
          }
          pde = warp_sum(pde);
          pdf = warp_sum(pdf);
          if (lane == 0) {
            red[sl * per_source + 2 + p] = pde;
            red[sl * per_source + 2 + P + p] = pdf;
          }
        }
      }
      __syncthreads();
      // one thread per output adds the warps in order into the record
      for (int j = tid; j < slots; j += kThreads) {
        float s = 0.f;
        for (int v = 0; v < kWarps; ++v) s += sm[l.red + v * slots + j];
        const int sl = j / per_source, kind = j - sl * per_source, src = s0 + sl;
        if (kind == 0) {
          rvar[src] += s;
        } else if (kind == 1) {
          rinvl[src] += -sm[l.pv + sl] * s;
        } else if (kind < 2 + P) {
          rde[src * P + kind - 2] += s;
        } else {
          const int p = kind - 2 - P;
          rdf[src * P + p] += -kTwoPi * sm[l.pe + sl * P + p] * s;
        }
      }
      __syncthreads();
    }
  }
  store_square<RU>(g, M, rec);
}

// out[w][e] = sum over splits of part[w][split][e], splits in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int64_t total, int rec, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t w = idx / rec, e = idx - w * rec;
  const float* p = part + w * splits * rec + e;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[static_cast<int64_t>(k) * rec];
  out[idx] = s;
}

template <int RU, bool BWD>
auto kernel_of() {
  return BWD ? &fused_whiten_bwd_kernel<RU> : &fused_whiten_fwd_kernel<RU>;
}

// The launch's dynamic shared memory; raises the kernel's limit to it once
// per device.
template <int RU, bool BWD>
cudaError_t shared_bytes(const Args& a, int* smem) {
  static std::atomic<int> allowed[kMaxDevices];
  const Layout l = make_layout(16 * RU, BWD, a.chunk_sources, a.P);
  *smem = static_cast<int>(sizeof(float) * l.total);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (*smem > allowed[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel_of<RU, BWD>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
    allowed[device].store(*smem, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Blocks per window.  Blocks of equal work run in waves of (SMs x resident
// blocks per SM); a window's tiles are split over the number of blocks that
// minimises waves x (tiles per block + kSetupTiles), where the set-up is a
// block's loads of Linv and z features and its record's write.  Splits that
// would leave a block without a tile are skipped.
template <int RU, bool BWD>
cudaError_t plan(const Args& a, int nw, int* splits) {
  int smem = 0, device = 0, sms = 0, resident = 0;
  cudaError_t err = shared_bytes<RU, BWD>(a, &smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel_of<RU, BWD>(),
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t slots = static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int tiles = (a.N + kTile - 1) / kTile;
  double best_cost = 0.0;
  *splits = 1;
  for (int s = 1; s <= tiles; ++s) {
    const int per = (tiles + s - 1) / s;
    if ((tiles + per - 1) / per != s) continue;
    const int64_t waves = (static_cast<int64_t>(nw) * s + slots - 1) / slots;
    const double cost = static_cast<double>(waves) * (per + kSetupTiles);
    if (s == 1 || cost < best_cost) {
      best_cost = cost;
      *splits = s;
    }
  }
  return cudaSuccess;
}

template <int RU, bool BWD>
cudaError_t launch(Args a, int nw, float* out, cudaStream_t stream) {
  int smem = 0;
  cudaError_t err = shared_bytes<RU, BWD>(a, &smem);
  if (err != cudaSuccess) return err;
  kernel_of<RU, BWD>()<<<dim3(a.splits, nw), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int64_t total = static_cast<int64_t>(nw) * a.rec;
  reduce_splits_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      a.part, out, total, a.rec, a.splits);
  return cudaGetLastError();
}

// Launches the kernel, or, with `splits_out`, only writes the split that
// `plan` picks.
template <int RU, bool BWD>
cudaError_t run(const Args& a, int nw, float* out, cudaStream_t stream, int* splits_out) {
  return splits_out ? plan<RU, BWD>(a, nw, splits_out) : launch<RU, BWD>(a, nw, out, stream);
}

template <bool BWD>
int dispatch(Args a, int nw, void* out, void* stream, int* splits_out = nullptr) {
  if (splits_out) *splits_out = 1;
  if (nw == 0 || a.M == 0) return 0;
  a.chunk_sources = a.P >= kPairCap ? 1 : kPairCap / a.P;
  if (a.chunk_sources > a.S) a.chunk_sources = a.S;
  a.rec = BWD ? a.M * a.M + 2 * a.S + 2 * a.S * a.P : a.M * a.M + a.M;
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  const int ru = (a.M + 15) / 16;
  cudaError_t err = cudaErrorInvalidValue;
  if (ru <= 1) err = run<1, BWD>(a, nw, o, s, splits_out);
  else if (ru <= 2) err = run<2, BWD>(a, nw, o, s, splits_out);
  else if (ru <= 4) err = run<4, BWD>(a, nw, o, s, splits_out);
  else if (ru <= 7) err = run<7, BWD>(a, nw, o, s, splits_out);
  else if (ru <= 10) err = run<10, BWD>(a, nw, o, s, splits_out);
  return static_cast<int>(err);
}

Args make_args(const void* zc, const void* xc, const void* err, const void* linv,
               const void* energy, const void* freq, const void* var, const void* inv_l,
               const void* du, const void* dv, void* part, int e_stride, int v_stride, int M,
               int N, int S, int P, int splits) {
  Args a{};
  a.zc = static_cast<const float*>(zc);
  a.xc = static_cast<const float*>(xc);
  a.err = static_cast<const float*>(err);
  a.linv = static_cast<const float*>(linv);
  a.energy = static_cast<const float*>(energy);
  a.freq = static_cast<const float*>(freq);
  a.var = static_cast<const float*>(var);
  a.inv_l = static_cast<const float*>(inv_l);
  a.du = static_cast<const float*>(du);
  a.dv = static_cast<const float*>(dv);
  a.part = static_cast<float*>(part);
  a.e_stride = e_stride;
  a.v_stride = v_stride;
  a.M = M;
  a.N = N;
  a.S = S;
  a.P = P;
  a.splits = splits;
  return a;
}

}  // namespace

extern "C" {

// Kernel A.  zc (nw, M, 1), xc, err (nw, 1, N), linv (nw, M, M); energy,
// freq (S, P) with e_stride 0 or (nw, S, P) with e_stride S P; var, inv_l
// (S,) or (nw, S) with v_stride 0 or S; all float32 and contiguous.  part
// (nw, splits, M M + M) receives each block's [U, v]; when splits > 1 the
// second kernel writes their sum to out (nw, M M + M).  M <= 160.
// Returns cudaError_t.
int gpitch_fused_whiten_fwd(const void* zc, const void* xc, const void* err, const void* linv,
                            const void* energy, const void* freq, const void* var,
                            const void* inv_l, void* part, void* out, int e_stride,
                            int v_stride, int nw, int M, int N, int S, int P, int splits,
                            void* stream) {
  return dispatch<false>(make_args(zc, xc, err, linv, energy, freq, var, inv_l, nullptr,
                                   nullptr, part, e_stride, v_stride, M, N, S, P, splits),
                         nw, out, stream);
}

// Kernel B.  As kernel A, plus du (nw, M, M) and dv (nw, M, 1); the record
// is [dLinv (M M), dvar (S), dinvl (S), de (S P), df (S P)].
int gpitch_fused_whiten_bwd(const void* zc, const void* xc, const void* err, const void* linv,
                            const void* energy, const void* freq, const void* var,
                            const void* inv_l, const void* du, const void* dv, void* part,
                            void* out, int e_stride, int v_stride, int nw, int M, int N,
                            int S, int P, int splits, void* stream) {
  return dispatch<true>(make_args(zc, xc, err, linv, energy, freq, var, inv_l, du, dv, part,
                                  e_stride, v_stride, M, N, S, P, splits),
                        nw, out, stream);
}

// The split `splits` that the launches of kernel A (bwd 0) or B (bwd 1) take
// at these sizes by default, on the current device.
int gpitch_fused_whiten_splits(int bwd, int nw, int M, int N, int S, int P, int* splits) {
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 0, 0, M, N, S, P, 1);
  return bwd ? dispatch<true>(a, nw, nullptr, nullptr, splits)
             : dispatch<false>(a, nw, nullptr, nullptr, splits);
}

}  // extern "C"
