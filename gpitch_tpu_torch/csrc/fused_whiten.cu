// The fused build -> whiten -> accumulate chain of the SGPR bound, forward
// (kernel A) and backward (kernel B), per window of a bank.
//
// Replaces the TPU kernels of scripts/proto_fused_whiten.py, make_fused_mxu
// (_kernel_mxu) and make_fused (_kernel), with kernel A, and of
// scripts/proto_fused_whiten_bwd.py, make_fused_bwd (_kernel_bwd), with
// kernel B.  Per window, z (M), x and err (N), Linv (M, M):
//   Kuf[m,t] = sum_s var_s exp(-|z_m - x_t| il_s) sum_p e_sp cos(2 pi f_sp (z_m - x_t))
//   A = Linv Kuf,  U = A A^T,  v = A err                          (kernel A)
//   given (dU, dv), with G = dU + dU^T: dA = G A + dv err^T, dLinv = dA Kuf^T,
//   dK = Linv^T dA, and per source, with E = exp(-|z - x| il),
//   C_p, S_p = cos, sin(2 pi f_p (z - x)), mix = sum_p e_p C_p, dM = var E dK:
//   dvar = <dK, E mix>, dinvl = -var <dK, E mix |z - x|>,
//   de_p = <dM, C_p>, df_p = -2 pi e_p <dM, (z - x) S_p>             (kernel B)
// The two TPU forward kernels differ only in where the TPU forms the cosine
// mixture (its vector unit, or a K = 2P contraction on its matrix unit), so
// one kernel serves both.
//
// What bounds them on the H100: operations.  Read two ways (chip_smoke.py,
// _whiten_bound): every operation in f32 on the CUDA cores (67 TFLOP/s), or
// the products (Linv Kuf, A A^T, A err, the mixture's K = 2P contraction) on
// the tensor cores in 3xTF32 (495 / 3 = 165 TFLOP/s) beside the rest
// (envelope, variance, source sum) on the CUDA cores.  The bytes are x, err,
// Linv's lower triangle (and dU, dv) in and U, v (or the gradients) out.
// Both kernels keep Kuf, A, dA and dK out of device memory.
//
// Kernel A (redesigned for Hopper).  Its first form ran at 16-17% of its
// FP32 bound: dense products where half the work is zero (a dense Linv, all
// of the symmetric U), about one shared load per FMA (RU x 2 register tiles
// over a Linv of pitch MP + 1), the z features formed again every tile when
// the pairs took several chunks (the AMT width: 12,800 sincosf a tile), one
// 8-warp block per SM (a dense Linv and two tiles in shared memory), and
// every operation in f32 on the CUDA cores.  The new design, by the same
// items:
//   * Linv's triangle.  The kernel reads Linv's lower triangle only, as
//     torch.linalg.solve_triangular reads one triangle: its strict upper
//     triangle may hold anything.  Shared memory holds it by 16-row block
//     rows, block row r with columns [0, 16 (r + 1)) at a 16-byte-aligned
//     pitch (59 KB instead of 105 at M 160), and A = Linv Kuf visits the
//     nonzero 16 x 16 blocks only: half the FMAs;
//   * symmetric U: only U's lower 16 x 16 blocks are accumulated, RU (RU +
//     1) / 2 registers a thread instead of RU^2, and mirrored on the
//     record's store; v = A err is summed in registers from the thread's own
//     A elements and added over the 16 lanes of a row once per block;
//   * loads per FMA: A = Linv Kuf takes, per 16-block of k, 16 8-byte pairs of
//     Kuf into registers and 16-byte rows of Linv for every block row below
//     (16 + 4 n loads for 32 n FMAs over n block rows); U reads 8-byte pairs
//     of A from a tile of pitch 34, whose column reads are free of bank
//     conflicts (2 RU loads for RU (RU + 1) FMAs); the mixture reads its
//     features two partials to a vector, 8-byte pairs of z features and
//     16-byte quads of x features (2 RU + 2 loads for 8 RU FMAs);
//   * features once: the z features of every (source, partial) pair, with
//     var_s e_sp folded in, are formed once per window (`fwd_zfeat_kernel`)
//     into a workspace and copied, not recomputed, per block (per chunk and
//     tile when the sources take several chunks); the tile's x features
//     once per tile and chunk; the partials of a source are padded to an
//     even count with zero features;
//   * blocks per SM: the triangle, one (MP, 34) tile that holds Kuf and then
//     A, and the features: 67 KB at the SoSp width (M 112, 3 x 5), two blocks
//     per SM; at the AMT width (M 160, 8 x 10) 205 KB with every source's
//     features, one block of 8 warps (the features of all 80 pairs are what
//     keeps them from being formed again);
//   * FP32 on the CUDA cores: every product stays an f32 FMA.  A form with
//     A = tril(Linv) Kuf and U += A A^T on the tensor cores in 3xTF32
//     (mma.sync m16n8k8, hi/lo splits of each operand, three products per
//     product) passed every check but ran slower at both bank widths: at
//     three TF32 products per product the mma.sync path gives little more
//     than the f32 FMA rate, and the fragments' loads and splits cost more
//     than that, most at M 160, where Linv's TF32 parts do not fit beside
//     every source's features and are formed at every load.  Clock
//     counters per phase (phase_clocks.py: build, A, U) and a count of the
//     loads put the time in shared-memory loads of broadcast operands: the
//     thin RU x 2 register tiles of a 32-sample tile make about one load
//     wavefront per two FMAs in all three phases.
//   * the envelope is exp2f with log2 e folded into il per source (one
//     MUFU.EX2 in place of expf's reduction), held to the f64 check.
// Later work for A: wider register tiles (64-sample tiles, 4 columns a
// thread) to halve the loads per FMA; the tensor cores through wgmma.
//
// Kernel B (redesigned for Hopper, put back in the prototype's association,
// then given wider register tiles).  Its first form ran at 14-16% of its
// bound: one 8-warp block per SM (a dense Linv, three (MP, 33) tiles and a
// staging buffer in shared memory), four dense M x M x 32 products per tile
// in RU x 2 register tiles that issued a shared load per FMA, G restaged
// from device memory at every tile, and the envelope, the mixture and the z
// and x features computed again in the per-source pass.  The design, by the
// same items:
//   * association: the prototype's, per tile A = tril(Linv) Kuf, dA = G A +
//     dv err^T, dLinv += dA Kuf^T and dK = tril(Linv)^T dA.  A form with
//     C = Linv^T G Linv formed once per window (dK = C Kuf + h err^T, Q +=
//     Kuf Kuf^T, dLinv = G (Linv Q) + dv r^T after the splits' sum) took
//     two products a tile instead of four but lost the f32 gradient at
//     states that L-BFGS reaches: there |G| ~ 4e7 and |Linv| ~ 1e2, C
//     carries |Linv|^2 |G| and cancels when applied to Kuf, and the
//     gradient of the bound came 1e-3 from f64 against 1.7e-4 in this
//     association (tests/test_torch_fused_whiten_trained.py).  A is
//     bounded, so nothing that large is summed.  G = dU + dU^T is formed
//     once per block; no per-window product is left outside the kernel;
//   * shared memory holds Linv's lower triangle as kernel A does (block
//     rows of 16, 16-byte rows), G (MP x MP), and one space that is either
//     the Kuf and A / dA tiles (MP x 36 each: 16-byte rows, and the
//     16-byte column quads of dLinv's product free of bank conflicts) or
//     the features of a chunk of sources, which serve the build before
//     Kuf's tile is stored and the per-source sums after dA's tile is last
//     read (so they are copied again every tile): 112 KB at the SoSp width
//     (M 112, 3 x 5), so two blocks share an SM; at M 160 one block, with 4
//     of 8 sources a chunk at the AMT width;
//   * register tiles: thread (ty, tx) = (tid / TX, tid % TX) owns RU x C
//     elements (rows 16 r + ty, columns C tx + c) of the build, of A, dA
//     and dK and of the per-source sums, so dK never leaves registers, and
//     dLinv's RU x RU C / 2 entries (16 a + ty, TX b + tx) across the
//     tiles.  C is 4 up to M 112 (128 threads, 16 x 8: up to 255 registers
//     a thread with two blocks an SM, so dLinv's 98 accumulators at RU 7
//     do not spill), 2 at M 160 (256 threads: dLinv's RU^2 = 100).  At C
//     4 the per-source pass forms dK E |z - x| from dK E (z - x) with dK
//     E's sign instead of holding it (RU 7 spilled 20 bytes with it).  Each
//     product takes 4 values of k at a time: A = tril(Linv) Kuf reads a
//     16-byte row quad of the triangle per block row against 4 rows of
//     Kuf (RU + 4 quads per 16 RU FMAs at C 4, against RU + 4 loads per 8
//     RU FMAs in RU x 2 tiles), G A 16-byte quads of G against 4 rows of
//     A, dLinv 16-byte sample quads of dA and Kuf (RU + RU C / 2 quads per
//     2 RU^2 C FMAs), and tril(Linv)^T dA the triangle's columns one float
//     at a time, each float feeding C products;
//   * features once: the z features of every pair are formed once per
//     window (`bwd_zfeat_kernel`) and copied, not recomputed, per chunk and
//     tile; the tile's x features once per tile and chunk in each pass (the
//     build's with e_q folded in); the per-source pass needs E once per
//     element and source, and takes the mixture's sums per partial (Sa =
//     <dK E, C_p>) instead of forming the mixture again: dvar = sum_p e_p
//     Sa_p;
//   * per-source sums: each thread sums its elements, a warp adds its lanes
//     with a butterfly, the 12 sums of four partials three butterflies of
//     four (warp_sum4) so that their shuffles overlap, lane 0 adds into its
//     warp's slots in shared memory, and the warps are added in order into
//     the block's record (one thread per pair, then one per source) once
//     per block, or per chunk and tile when the sources take several
//     chunks;
//   * the tensor cores: not used; built and measured, they lost.  dLinv +=
//     dA Kuf^T in 3xTF32 wgmma (m64nNk8.tf32, A = dA from registers, loaded
//     from its tile and split into hi and lo there; B = Kuf in K-major core
//     matrices without swizzle, whose tf32 part the tensor cores read from
//     the f32 tile that the FP32 products also read, beside its lo part;
//     dLinv in the accumulators, 2 x 56 registers at M 112 and 3 x 40 on
//     two warpgroups at M 160, rows past MP padding) matched the f64 plain
//     version as FP32 does and cut that phase from ~7000 to ~1840 cycles a
//     tile at M 112 (9144 to 3222 at M 160), but the lo part (+14 KB)
//     leaves one block per SM at M 112: 3.31 ms against 2.13 (3.55 with 256
//     threads, C 2); at M 160 the 20 more accumulators spill (255
//     registers, 124 bytes) and the sums phase slows: 1.65-1.67 ms against
//     1.51-1.52 (PERF.md section 6).  With A from registers no split
//     part of G or Linv needs shared memory (their fragments are loaded and
//     split per tile), but each other product needs its per-tile B operand
//     transposed for K-major (A = tril(Linv) Kuf: Kuf^T; dA = G A: A^T; dK
//     = tril(Linv)^T dA: dA^T), hi and lo: 28 KB at M 112, 40 KB at M 160,
//     one space in turn.  At M 112 that is again one block per SM, where
//     the four products are ~55% of a tile's cycles: free products would
//     leave ~29,000 cycles a tile at half the blocks, against ~67,000 for
//     two tiles now.  At M 160 the 40 KB do not fit beside G, the triangle
//     and a chunk of 4 sources' features.
// Both kernels: every product is an f32 FMA on the CUDA cores, never TF32;
// cos and sin are the full-precision sincosf (arguments reach ~6e3 rad), exp
// is expf in kernel B and exp2f in A, an angle is formed as (2 pi z) f like
// the plain version; ragged N:
// samples past the end get Kuf = 0 and err = 0, so they add nothing.  Both
// split a window's tiles over several blocks when the windows alone do not
// fill the card's resident blocks (`plan_splits`), each writing a partial
// record that a second kernel adds in a fixed order (no atomics: a run is
// bit-for-bit reproducible); M is padded to MP = 16 RU (RU in 1, 2, 4, 7,
// 10: M <= 160) with zeros.  Kernel A takes 256 threads as 16 x 16.
// The present body's build and sums took ~43% of a tile's cycles at M 112
// and ~70% at M 160 (the z features copied twice a tile, the x features'
// sincosf, the butterflies), and between its phases every warp waited for
// every other with 8 warps an SM to hide it.
//
// Kernel B's role-split body, which serves M <= 112 (RU <= 7) where every
// pair's features fit: one persistent block of 12 warps on each SM in place
// of two 4-warp blocks.  Warps 0-7 (the consumers, 256 threads) run a tile's
// four products, then the per-source sums of dK's first cons_rows(RU) block
// rows from their registers; warps 8-11 (the producers, 128 threads) run
// the rest of the sums of the tile before it and then build the tile after
// it, into a two-slot ring in shared memory.  The roles meet only at their
// handoffs, named barriers of all 384 threads: Kuf stored (the producers
// arrive, the consumers wait) and dK stored over Kuf in the same slot (the
// consumers arrive, the producers wait); within a role, named barriers of
// its own warps.  What a window's tiles share stays resident while the
// block works on the window: the triangle, G, both sets of z features
// (formed in shared memory when the window starts: no workspace, no
// z-feature launch), the parameters.  A tile is 64 samples, its x features
// formed once for the build and the sums.  The plan, byte by byte, is
// beside make_role_layout.  A block walks a contiguous range of the bank's
// (window, tile) pairs, an even share over the SMs; a window spans at most
// `splits` blocks, each writing its own record slot, and
// reduce_splits_kernel adds them in a fixed order.  The arithmetic is the
// present body's: every product an f32 FMA in PR 11's association, sincosf
// and expf, the ragged zeros; the build's z features carry var_s e_q.
// Clocks (phase_clocks.py --bwd, H100 at 700 W, 222 windows, M 112, N 2001,
// 3 x 5): the present body takes 67,432 cycles a 32-sample tile in each of
// the two blocks on an SM (build 10,902, A 8,990, G A 10,835, dLinv 8,920,
// dK 10,132, sums 17,653); the role-split body ~61,600 a 64-sample tile
// alone on its SM.  Consumers: A 11,259, G A 11,258, dLinv 10,692, dK with
// their share of the sums, the store and the handoff 15,567, and 11,555
// waiting for Kuf.  Producers: sums 46,575, build 12,534, and 2,479 waiting
// for dK.  The producers bound it: with the consumers idle their sums of
// all rows take 20,632 cycles, and with two of seven rows given to the
// consumers they take as long as with none, so they run on what the
// consumers leave of each scheduler's issue.
// Built and measured, slower (kernel B ms at the same sizes, against
// 1.71-1.73 with the producers summing every row): 16 warps, 8 producers at
// 2 columns a thread, with or without setmaxnreg moving registers to the
// consumers (1.80-1.98); the build moved to the consumers (1.90); dLinv in
// 3xTF32 mma.sync, its operands split every tile (1.81); the sums summed
// over rows first (1.78), one pair at a time (1.74), or dinvl's through the
// mixture (2.05, spills); A unrolled over its block pairs (1.75); the
// producers as the scheduler's elder warps 0-3 (1.73-1.76); one block row
// to the consumers (1.99, spills).  By the SASS's instruction counts each
// scheduler issues ~0.63 instructions a cycle whichever way the work is
// split.  At RU 10 (M 160, the AMT width) G (102 KB) and the triangle (59
// KB) leave no room for the slots; the two-phase body serves it.
// Later work for B: fewer producer instructions (the sums' butterflies, the
// envelope that the build and the sums both form); the products on the
// tensor cores only where their operands need no split every tile.
//
// Kernel B's two-phase body, which serves M 160 (RU 10) where the present
// body's plan walks 3 source chunks or more (the transcription cell, 63 x
// 20: 32 chunks of 2 sources) and P <= 40.  There the present body
// held the features of 2 sources at a time, so every 32-sample tile copied
// every source's z features twice (build and sums), ran bwd_flush 32 times
// and kept dLinv's 100 accumulators in registers through the sums, at ~0.4
// instructions a cycle a scheduler.  One launch, one persistent block an
// SM, takes items from a queue in a fixed order (the section's head):
//   * phase 1, a share of a window's tiles: the build and the four
//     products (the prototype's association) as the present body runs
//     them, dK's tile stored to the window's workspace (nw, tiles, MP, 32)
//     instead of the sums.  Its
//     build walks the sources one at a time through a ring of two slots of
//     the chunk's space: while the block builds source s, source s + 1's z
//     features arrive (cp.async, a row's cosine and sine side by side in
//     the workspace) and its x features are formed from e and f loaded a
//     step ahead; a thread holds 5 rows x 4 columns, so a pair takes 7
//     shared loads for 40 FMAs (the present body: 12 for 40), and the
//     mixture is a chain of FMAs as kernel A's.  dLinv lives in the item's
//     record between tiles (read while G A runs, written after dA Kuf^T),
//     so that the build has the registers dLinv held: with dLinv in
//     registers nvcc fed every z load through one register pair;
//   * phase 2, a range of a window's tiles for as many sources as give each
//     of the 8 warps a group of 5 partials (2 sources of 20): the per-source
//     sums as products over the samples (bwd_sums), 6 FMAs an element and
//     partial, in 150 register accumulators a thread; the z features enter
//     once per item.  Ranges split a window's tiles where windows x sources
//     give the blocks too few items, each its own record slot.
// Bounds on this card (phase_clocks.py --bwd, PERF.md section 6): phase 1's
// build is bound by shared-memory wavefronts (a pair's 7 loads are 18
// wavefronts a warp, against 40 FMAs a thread) and by the 1.6 MB of z
// features a tile copies from L2; phase 2's products issue at ~0.85 a cycle
// a scheduler, 85% of them FMAs, with 2 warps a scheduler (150 accumulators
// a thread leave no room for more).
// Built and measured, slower or lost (kernel B ms at (87, 160, 2001, 63, 20),
// parent 32.5-32.8): the present build and chunk copies before phase 1
// (25.0); that build re-tiled 5 x 4 with its chunks copied as they were
// (the build 472k cycles a tile against 514k); the ring with the mixture as
// (cz cx + sz sx) + mix, 3 instructions a pair and element (24.9, against
// 21.7-21.9 as FMAs); dLinv in registers through the build (21.7-21.9,
// against 20.2-20.6; but 1.44 ms at 8 x 10 against 1.52-1.55);
// -|z - x| held across the sources (22.2); the build or phase 2 not inlined
// (20.8-22.0); phase 2's products on the tensor cores in 3xTF32 mma.sync
// m16n8k8 (22.9: 184 bytes of spills, and its outputs 1.3e-5 of max|ref|
// from f64 against ~7e-7; the sums over a window's samples add up in the
// tensor cores' accumulator, the cause not isolated).  A warp of the build over 32 rows and one column
// quad, so that its x loads are uniform, read 20.49 against 20.58: not kept.
// Two builds stay at M 160, each on the side of kPhaseChunks where it wins
// (kernel B alone, ms, one card in turns): phase 1's ring build served the
// present body too (dLinv in registers) and lost at 1 and 2 chunks, 0.780-
// 0.785 against 0.730-0.731 at (43, 160, 2001, 3, 5), 1.005-1.024 against
// 0.973-1.001 at 4 x 10 and 1.541-1.572 against 1.471-1.493 at 8 x 10 (the
// two phases there: 1.558); from 3 chunks the two phases win over the
// present body with either build: 1.952-1.963 against 2.014-2.015 (the
// parent's chunks) and 2.053-2.062 (ring) at 12 x 10, 2.311-2.356 against
// 2.511-2.514 and 2.550-2.552 at 16 x 10.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

// A launch and the dynamic shared memory of a kernel.  The tests' CPU
// emulation of this file (tests/cuda_emulation/cuda_runtime.h) defines its
// own.
#ifndef GPITCH_LAUNCH
#define GPITCH_LAUNCH(kernel, grid, block, smem, stream) kernel<<<grid, block, smem, stream>>>
#define GPITCH_DYNAMIC_SHARED(name) extern __shared__ __align__(16) float name[]
#endif

// Warp roles.  Named barriers: `count` threads (whole warps) meet at
// barrier `id` (1-15; 0 is __syncthreads); named_arrive counts the calling
// warp in and goes on.  The emulation defines its own.
#ifndef GPITCH_WARP_ROLES
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
#endif

// Copies from device to shared memory that run on while the thread goes on
// (cp.async): 16 bytes, or 4 bytes that are zeros where `valid` is false;
// copy_async_wait waits for all of the thread's.  The emulation defines
// its own.
#ifndef GPITCH_ASYNC_COPY
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
#endif

namespace {

constexpr int kTile = 32;          // samples per tile (linalg/fused_whiten.py TILE_T)
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 232448;    // dynamic shared memory of one block
constexpr int kHalfSm = 113 * 1024;   // two blocks on one SM (228 KB, 1 KB each reserved)
constexpr double kSetupTiles = 0.5;  // a block's set-up, in tiles (splits plan)
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The padded M of both kernels: 16 RU with RU in 1, 2, 4, 7, 10 (M <= 160).
__host__ __device__ inline int padded_m(int M) {
  const int ru = (M + 15) / 16;
  return 16 * (ru <= 1 ? 1 : ru <= 2 ? 2 : ru <= 4 ? 4 : ru <= 7 ? 7 : 10);
}

// Sums of v0 .. v3 over the warp's lanes with 6 shuffles in place of 20 (a
// transposing butterfly): a lane gets the sum of v[2 b4 + b3], b4 and b3
// being bits 4 and 3 of its lane index (lanes 0, 8, 16, 24: v0 .. v3).
__device__ __forceinline__ float warp_sum4(float v0, float v1, float v2, float v3, int lane) {
  const bool b4 = lane & 16, b3 = lane & 8;
  const float k0 = (b4 ? v2 : v0) + __shfl_xor_sync(0xffffffffu, b4 ? v0 : v2, 16);
  const float k1 = (b4 ? v3 : v1) + __shfl_xor_sync(0xffffffffu, b4 ? v1 : v3, 16);
  float m = (b3 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, b3 ? k0 : k1, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
  return m;
}

// The tiles [begin, end) of share `split` of a window's N samples.
__device__ __forceinline__ void tile_range(int N, int splits, int split, int* begin, int* end) {
  const int tiles = (N + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  *begin = split * per;
  *end = min(tiles, *begin + per);
}

// ------------------------------------------------------------- kernel A
constexpr int kAP = kTile + 2;     // pitch of kernel A's (MP, kTile) tile

struct Args {
  const float* zc;      // (nw, M)
  const float* xc;      // (nw, N)
  const float* err;     // (nw, N)
  const float* linv;    // (nw, M, M), read below the diagonal and on it only
  const float* energy;  // (S, P) or (nw, S, P)
  const float* freq;
  const float* var;     // (S,) or (nw, S)
  const float* inv_l;
  float* ws;            // (nw, wsz): the z features
  float* part;          // (nw, splits, rec)
  int e_stride, v_stride, M, N, S, P, splits, rec, wsz, mp, p2, chunk_sources;
};

// Linv's lower triangle in shared memory: block row r (rows 16 r .. 16 r +
// 15) holds columns [0, 16 (r + 1)), at a pitch of 16 (r + 1) + 4 floats.
__host__ __device__ constexpr int tri_pitch(int r) { return 16 * (r + 1) + 4; }
__host__ __device__ constexpr int tri_offset(int r) { return 128 * r * (r + 1) + 64 * r; }

// Floats per window of kernel A's workspace: the z features of every pair,
// the P partials of a source padded to P2 (even).  Pair q = s P2 + p of
// group g = q / 2 has its cosines at [2 g MP, 2 g MP + 2 MP), two
// partials to a row (2 i + q % 2), and its sines the 2 MP floats after.
__host__ __device__ inline int fwd_workspace(int M, int S, int P) {
  return S * ((P + 1) & ~1) * 2 * padded_m(M);
}

struct FwdLayout {
  int linv, tile, zf, xf, z, err, pf, pil, total;
};

// Shared memory of kernel A (floats; every array starts 16-byte aligned):
// Linv's triangle, the (MP, kAP) tile (Kuf, then A), the z and x features
// of a chunk of sc sources (x: per pair group, [cos | sin] of 32 samples,
// two partials to a sample), z, the tile's err, the chunk's frequencies and
// inverse lengthscales.
__host__ __device__ inline FwdLayout make_fwd_layout(int ru, int sc, int p2) {
  const int mp = 16 * ru, pairs = sc * p2;
  FwdLayout l;
  int o = 0;
  l.linv = o; o += tri_offset(ru);
  l.tile = o; o += mp * kAP;
  l.zf = o;   o += pairs * 2 * mp;
  l.xf = o;   o += pairs * 2 * kTile;
  l.z = o;    o += mp;
  l.err = o;  o += kTile;
  l.pf = o;   o += round4(pairs);
  l.pil = o;  o += round4(sc);
  l.total = o;
  return l;
}

// Sources per feature chunk of either kernel, from the shared-memory bytes
// `bytes(sc)` of a block with sc sources a chunk: every source when the
// block still fits two to an SM, else as many as one block may hold (0:
// not even one).
template <class Bytes>
int chunk_sources(int S, Bytes bytes) {
  if (bytes(S) <= kHalfSm) return S;
  for (int sc = S; sc >= 1; --sc)
    if (bytes(sc) <= kSmemLimit) return sc;
  return 0;
}

// Kernel A's sources a chunk at RU, S sources of P2 (even) partials.
inline int fwd_chunk_sources(int ru, int S, int p2) {
  return chunk_sources(S, [&](int sc) { return 4 * make_fwd_layout(ru, sc, p2).total; });
}

// The z features of every pair of window w, var_s e_sp cos and sin(2 pi
// f_sp z_i), once per window into the workspace (0 for padded partials and
// rows past M).
__global__ void fwd_zfeat_kernel(Args a) {
  const int w = blockIdx.y, mp = a.mp, p2 = a.p2, n = a.S * p2 * mp;
  const float* z = a.zc + static_cast<int64_t>(w) * a.M;
  const float* e = a.energy + static_cast<int64_t>(w) * a.e_stride;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride;
  const float* v = a.var + static_cast<int64_t>(w) * a.v_stride;
  float* zf = a.ws + static_cast<int64_t>(w) * a.wsz;
  const int first = static_cast<int>(blockIdx.x) * 1024, stop = min(n, first + 1024);
  for (int idx = first + static_cast<int>(threadIdx.x); idx < stop; idx += kThreads) {
    const int q = idx / mp, i = idx - q * mp, s = q / p2, p = q - s * p2;
    float sn = 0.f, cs = 0.f;
    if (i < a.M && p < a.P) {
      sincosf((kTwoPi * z[i]) * f[s * a.P + p], &sn, &cs);
      const float ev = v[s] * e[s * a.P + p];
      cs *= ev;
      sn *= ev;
    }
    float* o = zf + (q / 2) * 4 * mp + 2 * i + (q & 1);
    o[0] = cs;
    o[2 * mp] = sn;
  }
}

// Sources s0 .. s0 + ns - 1 of window w: frequencies (0 for padded
// partials), inverse lengthscales times log2 e (the envelope is an exp2),
// and their z features copied from the workspace.
__device__ void fwd_chunk(const Args& a, float* sm, const FwdLayout& l, int w, int s0, int ns) {
  const int P = a.P, p2 = a.p2;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride;
  for (int q = threadIdx.x; q < ns * p2; q += kThreads) {
    const int s = q / p2, p = q - s * p2;
    sm[l.pf + q] = p < P ? f[(s0 + s) * P + p] : 0.f;
  }
  const int64_t vb = static_cast<int64_t>(w) * a.v_stride + s0;
  for (int q = threadIdx.x; q < ns; q += kThreads) sm[l.pil + q] = a.inv_l[vb + q] * kLog2e;
  const float4* src = reinterpret_cast<const float4*>(
      a.ws + static_cast<int64_t>(w) * a.wsz + static_cast<int64_t>(s0) * p2 * 2 * a.mp);
  float4* dst = reinterpret_cast<float4*>(sm + l.zf);
  for (int q = threadIdx.x; q < ns * p2 * a.mp / 2; q += kThreads) dst[q] = src[q];
}

// The tile's x features cos, sin(2 pi f_q x_t) of the chunk's np pairs
// (padded), x read from device memory; 0 past the window's N samples.
__device__ void fwd_xfeat(const Args& a, float* sm, const FwdLayout& l, int w, int t0, int np) {
  const float* x = a.xc + static_cast<int64_t>(w) * a.N;
  for (int idx = threadIdx.x; idx < np * kTile; idx += kThreads) {
    const int q = idx / kTile, c = idx - q * kTile, t = t0 + c;
    float sn = 0.f, cs = 0.f;
    if (t < a.N) sincosf((kTwoPi * x[t]) * sm[l.pf + q], &sn, &cs);
    float* o = sm + l.xf + (q / 2) * 4 * kTile + 2 * c + (q & 1);
    o[0] = cs;
    o[2 * kTile] = sn;
  }
}

// Per tile of 32 samples: Kuf's tile (each thread its RU x 2 elements, rows
// 16 r + ty, columns 2 tx + c) into shared memory, A = tril(Linv) Kuf into
// registers and v += A err, A over Kuf's tile, then U += A A^T on U's lower
// 16 x 16 blocks: thread (ty, tx) = (tid / 16, tid % 16) holds U's entries
// (16 a + ty, 16 b + tx), b <= a, in registers across the tiles.
template <int RU>
__global__ void __launch_bounds__(kThreads, RU >= 10 ? 1 : 2) fused_whiten_fwd_kernel(Args a) {
  constexpr int MP = 16 * RU, NQ = RU * (RU + 1) / 2;
  GPITCH_DYNAMIC_SHARED(sm);
  const int M = a.M, N = a.N, S = a.S, sc = a.chunk_sources, G = a.p2 / 2;
  const FwdLayout l = make_fwd_layout(RU, sc, a.p2);
  const int w = blockIdx.y, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nchunks = (S + sc - 1) / sc;
  const float* L = a.linv + static_cast<int64_t>(w) * M * M;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int cols = 16 * (r + 1);
    float* dst = sm + l.linv + tri_offset(r);
    for (int idx = tid; idx < 16 * cols; idx += kThreads) {
      const int ii = idx / cols, k = idx - ii * cols, i = 16 * r + ii;
      dst[ii * tri_pitch(r) + k] = (k <= i && i < M) ? L[static_cast<int64_t>(i) * M + k] : 0.f;
    }
  }
  for (int i = tid; i < MP; i += kThreads)
    sm[l.z + i] = i < M ? a.zc[static_cast<int64_t>(w) * M + i] : 0.f;
  if (nchunks == 1) fwd_chunk(a, sm, l, w, 0, S);
  __syncthreads();
  float zr[RU];
#pragma unroll
  for (int r = 0; r < RU; ++r) zr[r] = sm[l.z + ty + 16 * r];
  float qacc[NQ], vacc[RU];
#pragma unroll
  for (int q = 0; q < NQ; ++q) qacc[q] = 0.f;
#pragma unroll
  for (int r = 0; r < RU; ++r) vacc[r] = 0.f;
  float* tile = sm + l.tile;
  int begin, end;
  tile_range(N, a.splits, blockIdx.x, &begin, &end);
  // Every write below comes after a barrier that the last tile's readers of
  // the same array have passed, so the tile loop needs no barrier at its top.
  for (int tn = begin; tn < end; ++tn) {
    const int t0 = tn * kTile;
    if (tid < kTile) {
      const int t = t0 + tid;
      sm[l.err + tid] = t < N ? a.err[static_cast<int64_t>(w) * N + t] : 0.f;
    }
    float xt[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = t0 + 2 * tx + c;
      xt[c] = t < N ? a.xc[static_cast<int64_t>(w) * N + t] : 0.f;
    }
    // ---- the build: Kuf = sum_s E_s sum_p (var e cos z) cos x + (var e sin z) sin x
    float kacc[RU][2];
#pragma unroll
    for (int r = 0; r < RU; ++r) kacc[r][0] = kacc[r][1] = 0.f;
    for (int ck = 0; ck < nchunks; ++ck) {
      const int s0 = ck * sc, ns = min(sc, S - s0);
      if (nchunks > 1) {
        if (ck > 0) __syncthreads();
        fwd_chunk(a, sm, l, w, s0, ns);
        __syncthreads();
      }
      fwd_xfeat(a, sm, l, w, t0, ns * a.p2);
      __syncthreads();
      for (int sl = 0; sl < ns; ++sl) {
        float mix[RU][2];
#pragma unroll
        for (int r = 0; r < RU; ++r) mix[r][0] = mix[r][1] = 0.f;
        for (int g = sl * G; g < (sl + 1) * G; ++g) {
          const float4 cx = *reinterpret_cast<const float4*>(sm + l.xf + g * 4 * kTile + 4 * tx);
          const float4 sx =
              *reinterpret_cast<const float4*>(sm + l.xf + g * 4 * kTile + 2 * kTile + 4 * tx);
          const float* zg = sm + l.zf + g * 4 * MP;
#pragma unroll
          for (int r = 0; r < RU; ++r) {
            const float2 cz = *reinterpret_cast<const float2*>(zg + 2 * (ty + 16 * r));
            const float2 sz = *reinterpret_cast<const float2*>(zg + 2 * MP + 2 * (ty + 16 * r));
            mix[r][0] += cz.x * cx.x;
            mix[r][0] += cz.y * cx.y;
            mix[r][0] += sz.x * sx.x;
            mix[r][0] += sz.y * sx.y;
            mix[r][1] += cz.x * cx.z;
            mix[r][1] += cz.y * cx.w;
            mix[r][1] += sz.x * sx.z;
            mix[r][1] += sz.y * sx.w;
          }
        }
        const float il = sm[l.pil + sl];
#pragma unroll
        for (int r = 0; r < RU; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) kacc[r][c] += exp2f(-fabsf(zr[r] - xt[c]) * il) * mix[r][c];
      }
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int i = ty + 16 * r, t = t0 + 2 * tx;
      float2 v;
      v.x = (i < M && t < N) ? kacc[r][0] : 0.f;
      v.y = (i < M && t + 1 < N) ? kacc[r][1] : 0.f;
      *reinterpret_cast<float2*>(tile + i * kAP + 2 * tx) = v;
    }
    __syncthreads();
    // ---- A = tril(Linv) Kuf: for each 16-block kb of k, the block rows r >= kb
    float acc[RU][2];
#pragma unroll
    for (int r = 0; r < RU; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < RU; ++kb) {
      float2 kv[16];
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        kv[kk] = *reinterpret_cast<const float2*>(tile + (16 * kb + kk) * kAP + 2 * tx);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        if (r < kb) continue;
        const float* row = sm + l.linv + tri_offset(r) + ty * tri_pitch(r) + 16 * kb;
#pragma unroll
        for (int k4 = 0; k4 < 16; k4 += 4) {
          const float4 lv = *reinterpret_cast<const float4*>(row + k4);
          const float lk[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[r][0] += lk[kk] * kv[k4 + kk].x;
            acc[r][1] += lk[kk] * kv[k4 + kk].y;
          }
        }
      }
    }
    {
      const float e0 = sm[l.err + 2 * tx], e1 = sm[l.err + 2 * tx + 1];
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        vacc[r] += acc[r][0] * e0;
        vacc[r] += acc[r][1] * e1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RU; ++r)
      *reinterpret_cast<float2*>(tile + (ty + 16 * r) * kAP + 2 * tx) =
          make_float2(acc[r][0], acc[r][1]);
    __syncthreads();
    // ---- U += A A^T, lower blocks
#pragma unroll 2
    for (int t = 0; t < kTile; t += 2) {
      float2 rv[RU], cv[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        rv[u] = *reinterpret_cast<const float2*>(tile + (16 * u + ty) * kAP + t);
        cv[u] = *reinterpret_cast<const float2*>(tile + (16 * u + tx) * kAP + t);
      }
      int q = 0;
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int b = 0; b <= u; ++b, ++q) {
          qacc[q] += rv[u].x * cv[b].x;
          qacc[q] += rv[u].y * cv[b].y;
        }
    }
  }
  float* rec = a.part + (static_cast<int64_t>(w) * a.splits + blockIdx.x) * a.rec;
  int q = 0;
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int b = 0; b <= u; ++b, ++q) {
      const int i = 16 * u + ty, j = 16 * b + tx;
      if (i < M && j < M) {
        rec[i * M + j] = qacc[q];
        if (b != u) rec[j * M + i] = qacc[q];
      }
    }
  // v: the 16 lanes of a row (bits 0-3 of the lane index are tx) add theirs
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    float v = vacc[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tx == 0 && ty + 16 * r < M) rec[M * M + ty + 16 * r] = v;
  }
}

// ------------------------------------------------------------- kernel B
constexpr int kBP = kTile + 4;        // pitch of kernel B's Kuf and A / dA tiles

// Columns of a tile that a thread of kernel B owns, C: 4 up to M 112 (128
// threads, 16 x 8), 2 at M 160 (256 threads, 16 x 16: dLinv's RU C / 2
// accumulators a row fit a thread's registers only so).
__host__ __device__ constexpr int bwd_cols(int ru) { return ru >= 10 ? 2 : 4; }
__host__ __device__ constexpr int bwd_threads(int ru) { return 16 * kTile / bwd_cols(ru); }

struct BwdArgs {
  const float* zc;      // as in Args
  const float* xc;
  const float* err;
  const float* linv;    // read below the diagonal and on it only, as in kernel A
  const float* energy;
  const float* freq;
  const float* var;
  const float* inv_l;
  const float* du;      // (nw, M, M)
  const float* dv;      // (nw, M)
  float* ws;            // (nw, wsz): the z features (and the two-phase body's dK, counters)
  float* part;          // (nw, splits, rec): [dLinv (M M), dvar (S), dinvl (S), de, df]
  float* sums;          // (nw, rec): the splits' sum (part itself when splits == 1)
  int e_stride, v_stride, M, N, S, P, splits, rec, wsz, mp, chunk_sources, nw;
  int64_t per;          // the role-split body's tiles per block
  int dk_off, ctr_off;  // the two-phase body: dK's tiles and the counters in a window's ws
  int sum_sources;      // the two-phase body: sources a phase-2 item holds
  int sum_ranges;       // the two-phase body: ranges of a window's tiles in phase 2
};

// Floats per window of the z features in kernel B's workspace: cos, sin(2
// pi f_q z_i) side by side, (S P, MP, 2).
__host__ __device__ inline int bwd_zfeat_floats(int M, int S, int P) {
  return S * P * 2 * padded_m(M);
}

struct BwdLayout {
  int tri, g, kt, at, xf, zf, z, dv, x, err, pe, pf, pv, pil, red, total;
};

// Shared memory of the main kernel (floats; every array starts 16-byte
// aligned): Linv's triangle (as kernel A holds it), G = dU + dU^T (MP x
// MP), then one space that holds either the Kuf tile and the A / dA tile
// (MP x kBP each) or the x and z features of a chunk of sc sources ([cos |
// sin] rows per pair): the features serve the build, before Kuf's tile is
// stored, and the per-source sums, after dA's tile is last read.  Then z,
// dv, the tile's x and err, the chunk's parameters, and each warp's
// partial sums (3 per pair).
__host__ __device__ inline BwdLayout make_bwd_layout(int ru, int sc, int P) {
  const int mp = 16 * ru, pairs = sc * P, warps = bwd_threads(ru) / 32;
  const int tiles = 2 * mp * kBP, feats = pairs * 2 * (kTile + mp);
  BwdLayout l;
  int o = 0;
  l.tri = o; o += tri_offset(ru);
  l.g = o;   o += mp * mp;
  l.kt = o;  l.at = o + mp * kBP;
  l.xf = o;  l.zf = o + pairs * 2 * kTile;
  o += tiles > feats ? tiles : feats;
  l.z = o;   o += mp;
  l.dv = o;  o += mp;
  l.x = o;   o += kTile;
  l.err = o; o += kTile;
  l.pe = o;  o += round4(pairs);
  l.pf = o;  o += round4(pairs);
  l.pv = o;  o += round4(sc);
  l.pil = o; o += round4(sc);
  l.red = o; o += round4(warps * pairs * 3);
  l.total = o;
  return l;
}

// Kernel B's present body: sources a chunk at RU, S sources of P partials.
inline int bwd_chunk_sources(int ru, int S, int P) {
  return chunk_sources(S, [&](int sc) { return 4 * make_bwd_layout(ru, sc, P).total; });
}

// The z features cos, sin(2 pi f_q z_i) of every pair q of window w, once
// per window, into the workspace, a row's two side by side (rows past M
// are 0).
__global__ void bwd_zfeat_kernel(BwdArgs a) {
  const int w = blockIdx.y, mp = a.mp, n = a.S * a.P * mp;
  const float* z = a.zc + static_cast<int64_t>(w) * a.M;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride;
  float* zf = a.ws + static_cast<int64_t>(w) * a.wsz;
  const int first = static_cast<int>(blockIdx.x) * 1024, stop = min(n, first + 1024);
  for (int idx = first + static_cast<int>(threadIdx.x); idx < stop; idx += kThreads) {
    const int q = idx / mp, i = idx - q * mp;
    float sn = 0.f, cs = 0.f;
    if (i < a.M) sincosf((kTwoPi * z[i]) * f[q], &sn, &cs);
    zf[2 * (q * mp + i)] = cs;
    zf[2 * (q * mp + i) + 1] = sn;
  }
}

// Sources s0 .. s0 + ns - 1 of window w: parameters, and their z features
// copied from the workspace.
template <int NT>
__device__ void bwd_chunk(const BwdArgs& a, float* sm, const BwdLayout& l, int w, int s0,
                          int ns) {
  const int P = a.P, np = ns * P, mp = a.mp;
  const float* e = a.energy + static_cast<int64_t>(w) * a.e_stride + s0 * P;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride + s0 * P;
  for (int q = threadIdx.x; q < np; q += NT) {
    sm[l.pe + q] = e[q];
    sm[l.pf + q] = f[q];
  }
  const int64_t vb = static_cast<int64_t>(w) * a.v_stride + s0;
  for (int q = threadIdx.x; q < ns; q += NT) {
    sm[l.pv + q] = a.var[vb + q];
    sm[l.pil + q] = a.inv_l[vb + q];
  }
  const float4* src = reinterpret_cast<const float4*>(
      a.ws + static_cast<int64_t>(w) * a.wsz + static_cast<int64_t>(s0) * P * 2 * mp);
  float4* dst = reinterpret_cast<float4*>(sm + l.zf);
  for (int q = threadIdx.x; q < np * mp / 2; q += NT) dst[q] = src[q];
}

// The tile's x features cos, sin(2 pi f_q x_t) of the chunk's np pairs,
// times e_q where ``energy`` says so (the build's pass).
template <int NT>
__device__ void bwd_xfeat(float* sm, const BwdLayout& l, int np, bool energy) {
  for (int idx = threadIdx.x; idx < np * kTile; idx += NT) {
    const int q = idx / kTile, t = idx - q * kTile;
    float sn, cs;
    sincosf((kTwoPi * sm[l.x + t]) * sm[l.pf + q], &sn, &cs);
    const float e = energy ? sm[l.pe + q] : 1.f;
    sm[l.xf + 2 * q * kTile + t] = e * cs;
    sm[l.xf + (2 * q + 1) * kTile + t] = e * sn;
  }
}

// Adds the warps' partial sums of sources s0 .. s0 + ns - 1 into the
// block's record, in a fixed order, and zeroes them:
//   dvar = sum_p e_p Sa_p,  dinvl = -var sum_p e_p Sd_p,
//   de_p = var Sa_p,        df_p = -2 pi e_p var Sf_p,
// with Sa = <dK E, C_p>, Sd = <dK E |z - x|, C_p>, Sf = <dK E (z - x), S_p>.
// First one thread per pair adds the warps' slots (de, df, and e_p Sa_p,
// e_p Sd_p into warp 0's), then one thread per source adds its pairs.
template <int NT>
__device__ void bwd_flush(const BwdArgs& a, float* sm, const BwdLayout& l, float* rsrc,
                          int s0, int ns, int cpairs) {
  constexpr int NW = NT / 32;
  const int P = a.P, S = a.S;
  float* red = sm + l.red;
  float* rde = rsrc + 2 * S;
  float* rdf = rde + S * P;
  __syncthreads();
  for (int q = threadIdx.x; q < ns * P; q += NT) {
    float sa = 0.f, sd = 0.f, sf = 0.f;
    for (int v = 0; v < NW; ++v) {
      float* r = red + (v * cpairs + q) * 3;
      sa += r[0];
      sd += r[1];
      sf += r[2];
      r[0] = r[1] = r[2] = 0.f;
    }
    const int sl = q / P, p = q - sl * P;
    const float e = sm[l.pe + q], vs = sm[l.pv + sl];
    rde[(s0 + sl) * P + p] += vs * sa;
    rdf[(s0 + sl) * P + p] += -kTwoPi * e * vs * sf;
    red[q * 3] = e * sa;
    red[q * 3 + 1] = e * sd;
  }
  __syncthreads();
  for (int sl = threadIdx.x; sl < ns; sl += NT) {
    float sv = 0.f, si = 0.f;
    for (int p = 0; p < P; ++p) {
      float* r = red + (sl * P + p) * 3;
      sv += r[0];
      si += r[1];
      r[0] = r[1] = 0.f;
    }
    rsrc[s0 + sl] += sv;
    rsrc[S + s0 + sl] += -sm[l.pv + sl] * si;
  }
  __syncthreads();
}

// C consecutive floats of shared memory (8- or 16-byte aligned) into v.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

constexpr int kPhaseMaxP = 40;   // the two-phase body's partials a source, at most

// Phase 1's build of Kuf's tile t0 .. t0 + 31 of window w into Kuf's tile,
// as the present body forms it, but for the mixture, a chain of FMAs as
// kernel A's, over the sources in a ring of two slots of the chunk's space (the plan's chunk holds two
// sources or more; one slot where it holds one): while the block computes
// source s from its slot, source s + 1's z features are on their way to
// the other (copied from the workspace as they lie, cp.async, issued a step
// ahead) and its x features are formed after it, from e and f the threads
// loaded a step ahead into registers.  Thread (ry, cx), ry = lane % 8 + 8
// (warp % 4), cx = lane / 8 + 4 (warp / 4), holds rows ry + 32 k, k < MP /
// 32, and columns 4 cx + c, c < 4, so that a pair's features take MP / 32
// 8-byte loads of z features (a row's cosine and sine) and two 16-byte
// loads of x features for 8 MP / 32 FMAs (the present body's RU x 2 tile:
// RU + 2 loads for 4 RU FMAs); a warp's 8 rows and 4 column quads load
// without bank conflicts.  Leaves the barrier after the store to the caller.
template <int RU>
__device__ __forceinline__ void phase1_build(const BwdArgs& a, float* sm, const BwdLayout& l,
                                             int w, int t0) {
  constexpr int MP = 16 * RU, RB = MP / 32, NT = bwd_threads(RU);
  constexpr int XQ = (kPhaseMaxP * kTile + NT - 1) / NT;   // x features a thread forms
  const int M = a.M, N = a.N, P = a.P, S = a.S, ring = a.chunk_sources >= 2 ? 2 : 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ry = lane % 8 + 8 * (warp % 4), col = 4 * (lane / 8 + 4 * (warp / 4));
  const float* zw = a.ws + static_cast<int64_t>(w) * a.wsz;
  const float* ew = a.energy + static_cast<int64_t>(w) * a.e_stride;
  const float* fw = a.freq + static_cast<int64_t>(w) * a.e_stride;
  const float* vw = a.var + static_cast<int64_t>(w) * a.v_stride;
  const float* iw = a.inv_l + static_cast<int64_t>(w) * a.v_stride;
  // source s's z features into slot `slot`, as they lie in the workspace
  auto copy_z = [&](int s, int slot) {
    const float* src = zw + static_cast<int64_t>(s) * P * 2 * MP;
    float* dst = sm + l.zf + slot * P * 2 * MP;
    for (int k = tid; k < P * MP / 2; k += NT) copy16_async(dst + 4 * k, src + 4 * k);
  };
  // e and f of the x features this thread forms for source s (P x 32 of them)
  float en[XQ], fn[XQ];
  auto load_ef = [&](int s) {
#pragma unroll
    for (int k = 0; k < XQ; ++k) {
      const int q = (tid + k * NT) / kTile;
      en[k] = q < P ? ew[s * P + q] : 0.f;
      fn[k] = q < P ? fw[s * P + q] : 0.f;
    }
  };
  // source s's x features, e_q cos and e_q sin(2 pi f_q x_t), into slot `slot`
  auto xfeat = [&](int slot) {
    float* xf = sm + l.xf + slot * P * 2 * kTile;
#pragma unroll
    for (int k = 0; k < XQ; ++k) {
      const int idx = tid + k * NT, q = idx / kTile, t = idx - q * kTile;
      if (q >= P) continue;
      float sn, cs;
      sincosf((kTwoPi * sm[l.x + t]) * fn[k], &sn, &cs);
      xf[2 * q * kTile + t] = en[k] * cs;
      xf[(2 * q + 1) * kTile + t] = en[k] * sn;
    }
  };
  float zb[RB], xb[4], kacc[RB][4];
#pragma unroll
  for (int k = 0; k < RB; ++k) zb[k] = sm[l.z + ry + 32 * k];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int t = t0 + col + c;
    xb[c] = t < N ? a.xc[static_cast<int64_t>(w) * N + t] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < RB; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) kacc[k][c] = 0.f;
  __syncthreads();    // the tile's x is stored; the last readers of the chunk's space are done
  copy_z(0, 0);
  load_ef(0);
  xfeat(0);
  float vs = vw[0], il = iw[0];
  copy_async_wait();
  __syncthreads();
  if (ring == 2 && S > 1) copy_z(1, 1);
  for (int s = 0; s < S; ++s) {
    const int slot = s % ring;
    float vn = 0.f, ln = 0.f;
    if (s + 1 < S) {
      load_ef(s + 1);
      vn = vw[s + 1];
      ln = iw[s + 1];
    }
    float mix[RB][4];
#pragma unroll
    for (int k = 0; k < RB; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) mix[k][c] = 0.f;
    const float* xf = sm + l.xf + slot * P * 2 * kTile;
    const float* zf = sm + l.zf + slot * P * 2 * MP;
#pragma unroll 2
    for (int p = 0; p < P; ++p) {
      float cx[4], sx[4];      // e_q cos, e_q sin of the tile's x
      load_cols<4>(xf + 2 * p * kTile + col, cx);
      load_cols<4>(xf + (2 * p + 1) * kTile + col, sx);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const float2 z2 = *reinterpret_cast<const float2*>(zf + 2 * (p * MP + ry + 32 * k));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mix[k][c] += z2.x * cx[c];
          mix[k][c] += z2.y * sx[c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) kacc[k][c] += vs * expf(-fabsf(zb[k] - xb[c]) * il) * mix[k][c];
    if (s + 1 == S) break;
    __syncthreads();    // every reader of source s's slot is done
    if (ring == 1) copy_z(s + 1, 0);
    xfeat((s + 1) % ring);
    copy_async_wait();
    __syncthreads();    // source s + 1's features are in its slot
    if (ring == 2 && s + 2 < S) copy_z(s + 2, slot);
    vs = vn;
    il = ln;
  }
  __syncthreads();    // every reader of the features is done: Kuf's tile takes their place
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int i = ry + 32 * k;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (i < M && t0 + col + c < N) ? kacc[k][c] : 0.f;
    store_cols<4>(sm + l.kt + i * kBP + col, v);
  }
}

// The tiles of share `split` of window w: per tile of 32 samples, Kuf's
// tile, A = tril(Linv) Kuf, dA = G A + dv err^T, dLinv += dA Kuf^T, dK =
// tril(Linv)^T dA, then (Sums, the present body) the per-source sums of dK
// E against the features, or (phase 1 of the two-phase body) dK's tile
// stored to the window's workspace.  Thread (ty, tx) = (tid / TX, tid %
// TX), TX = 32 / C, owns the elements (ty + 16 r, C tx + c) of the build,
// of A, dA and dK and of the sums, and dLinv's entries (16 a + ty, tx + TX
// b) across the tiles, in registers (phase 1: in its record between
// tiles).  M is padded to MP = 16 RU.  Record
// slot `split` of window w receives dLinv; phase 1 leaves the per-source
// part of the first sum_ranges slots to phase 2 and zeroes that of the
// others.
template <int RU, bool Sums>
__device__ __forceinline__ void bwd_tiles(const BwdArgs& a, float* sm, int w, int split) {
  constexpr int MP = 16 * RU, C = bwd_cols(RU), TX = kTile / C, NT = bwd_threads(RU);
  constexpr int NB = MP / TX;           // dLinv's columns a thread owns
  constexpr int KC = C == 2 ? 16 : 8;   // rows of Kuf or dA a product holds at once
  const int M = a.M, N = a.N, P = a.P, S = a.S, sc = a.chunk_sources, cpairs = sc * P;
  const BwdLayout l = make_bwd_layout(RU, sc, P);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / TX, tx = tid % TX;
  const int nchunks = (S + sc - 1) / sc;
  const int64_t mm = static_cast<int64_t>(w) * M * M;
  float* rec = a.part + (static_cast<int64_t>(w) * a.splits + split) * a.rec;
  float* rsrc = rec + M * M;
  if (Sums || split >= a.sum_ranges)
    for (int q = tid; q < 2 * S + 2 * S * P; q += NT) rsrc[q] = 0.f;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int cols = 16 * (r + 1);
    float* dst = sm + l.tri + tri_offset(r);
    for (int idx = tid; idx < 16 * cols; idx += NT) {
      const int ii = idx / cols, k = idx - ii * cols, i = 16 * r + ii;
      dst[ii * tri_pitch(r) + k] = (k <= i && i < M) ? a.linv[mm + i * M + k] : 0.f;
    }
  }
  for (int idx = tid; idx < MP * MP; idx += NT) {
    const int i = idx / MP, k = idx - i * MP;
    sm[l.g + idx] = (i < M && k < M) ? a.du[mm + i * M + k] + a.du[mm + k * M + i] : 0.f;
  }
  for (int i = tid; i < MP; i += NT) {
    sm[l.z + i] = i < M ? a.zc[static_cast<int64_t>(w) * M + i] : 0.f;
    sm[l.dv + i] = i < M ? a.dv[static_cast<int64_t>(w) * M + i] : 0.f;
  }
  for (int q = tid; q < (NT / 32) * cpairs * 3; q += NT) sm[l.red + q] = 0.f;
  __syncthreads();
  float zr[RU];
#pragma unroll
  for (int r = 0; r < RU; ++r) zr[r] = sm[l.z + ty + 16 * r];
  float dl[RU][NB];
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int b = 0; b < NB; ++b) dl[u][b] = 0.f;
  float* kt = sm + l.kt;
  float* at = sm + l.at;
  int begin, end;
  tile_range(N, a.splits, split, &begin, &end);
  for (int tile = begin; tile < end; ++tile) {
    const int t0 = tile * kTile;
    __syncthreads();    // the last tile's readers of x, err and the features are done
    if (tid < kTile) {
      const int t = t0 + tid;
      const int64_t g = static_cast<int64_t>(w) * N + t;
      sm[l.x + tid] = t < N ? a.xc[g] : 0.f;
      sm[l.err + tid] = t < N ? a.err[g] : 0.f;
    }
    float xt[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + C * tx + c;
      xt[c] = t < N ? a.xc[static_cast<int64_t>(w) * N + t] : 0.f;
    }
    // ---- the build: Kuf = sum_s var_s E_s mix_s
    if constexpr (!Sums) {
      phase1_build<RU>(a, sm, l, w, t0);
    } else {
      float kacc[RU][C];
#pragma unroll
      for (int r = 0; r < RU; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) kacc[r][c] = 0.f;
      for (int ck = 0; ck < nchunks; ++ck) {
        const int s0 = ck * sc, ns = min(sc, S - s0);
        if (ck > 0) __syncthreads();
        bwd_chunk<NT>(a, sm, l, w, s0, ns);
        __syncthreads();
        bwd_xfeat<NT>(sm, l, ns * P, true);
        __syncthreads();
        for (int sl = 0; sl < ns; ++sl) {
          float mix[RU][C];
#pragma unroll
          for (int r = 0; r < RU; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) mix[r][c] = 0.f;
          for (int p = 0; p < P; ++p) {
            const int q = sl * P + p;
            float cx[C], sx[C];      // e_q cos, e_q sin of the tile's x
            load_cols<C>(sm + l.xf + 2 * q * kTile + C * tx, cx);
            load_cols<C>(sm + l.xf + (2 * q + 1) * kTile + C * tx, sx);
#pragma unroll
            for (int r = 0; r < RU; ++r) {
              const float2 z2 =
                  *reinterpret_cast<const float2*>(sm + l.zf + 2 * (q * MP + ty + 16 * r));
              const float cz = z2.x, sz = z2.y;
#pragma unroll
              for (int c = 0; c < C; ++c) mix[r][c] += cz * cx[c] + sz * sx[c];
            }
          }
          const float vs = sm[l.pv + sl], il = sm[l.pil + sl];
#pragma unroll
          for (int r = 0; r < RU; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c)
              kacc[r][c] += vs * expf(-fabsf(zr[r] - xt[c]) * il) * mix[r][c];
        }
      }
      __syncthreads();    // every reader of the features is done: Kuf's tile takes their place
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const int i = ty + 16 * r, t = t0 + C * tx;
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = (i < M && t + c < N) ? kacc[r][c] : 0.f;
        store_cols<C>(kt + i * kBP + C * tx, v);
      }
    }
    __syncthreads();
    // ---- A = tril(Linv) Kuf (kernel A's product): for each 16-block kb of
    // k, KC rows of Kuf at a time in registers against the block rows r >= kb
    float acc[RU][C];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < RU; ++kb) {
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += KC) {
        float kv[KC][C];
#pragma unroll
        for (int j = 0; j < KC; ++j) load_cols<C>(kt + (16 * kb + k0 + j) * kBP + C * tx, kv[j]);
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          if (r < kb) continue;
          const float* row = sm + l.tri + tri_offset(r) + ty * tri_pitch(r) + 16 * kb + k0;
#pragma unroll
          for (int k4 = 0; k4 < KC; k4 += 4) {
            const float4 lv = *reinterpret_cast<const float4*>(row + k4);
            const float lk[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < C; ++c) acc[r][c] += lk[j] * kv[k4 + j][c];
          }
        }
      }
    }
    // A's tile lies over the features, whose readers passed the last barrier
#pragma unroll
    for (int r = 0; r < RU; ++r) store_cols<C>(at + (ty + 16 * r) * kBP + C * tx, acc[r]);
    __syncthreads();
    // Phase 1 keeps dLinv in its record between tiles (its padded entries
    // are 0), so that its accumulators hold no registers through the build;
    // their loads are on their way while G A runs
    if constexpr (!Sums) {
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int i = 16 * u + ty, j = TX * b + tx;
          dl[u][b] = tile > begin && i < M && j < M ? rec[i * M + j] : 0.f;
        }
    }
    // ---- dA = G A + dv err^T (registers; acc holds it)
    {
      float e[C];
      load_cols<C>(sm + l.err + C * tx, e);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const float dvr = sm[l.dv + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = dvr * e[c];
      }
    }
#pragma unroll 2
    for (int k = 0; k < MP; k += 4) {
      float av[4][C];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_cols<C>(at + (k + j) * kBP + C * tx, av[j]);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const float4 gv = *reinterpret_cast<const float4*>(sm + l.g + (ty + 16 * r) * MP + k);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] += gr[j] * av[j][c];
      }
    }
    __syncthreads();    // every reader of A is done: dA takes its place
#pragma unroll
    for (int r = 0; r < RU; ++r) store_cols<C>(at + (ty + 16 * r) * kBP + C * tx, acc[r]);
    __syncthreads();
    // ---- dLinv += dA Kuf^T (dense: every entry is an output), 4 samples at
    // a time: rows of dA by 16-byte quads, one quad of Kuf per column
#pragma unroll 1
    for (int t = 0; t < kTile; t += 4) {
      float4 rv[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u)
        rv[u] = *reinterpret_cast<const float4*>(at + (16 * u + ty) * kBP + t);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 cv = *reinterpret_cast<const float4*>(kt + (TX * b + tx) * kBP + t);
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          dl[u][b] += rv[u].x * cv.x;
          dl[u][b] += rv[u].y * cv.y;
          dl[u][b] += rv[u].z * cv.z;
          dl[u][b] += rv[u].w * cv.w;
        }
      }
    }
    if constexpr (!Sums) {
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int i = 16 * u + ty, j = TX * b + tx;
          if (i < M && j < M) rec[i * M + j] = dl[u][b];
        }
    }
    // ---- dK = tril(Linv)^T dA: for each 16-block kb of k, KC rows of dA
    // at a time against the block rows r <= kb, Linv's columns read down the
    // triangle's block row kb (each float feeds C products)
    float dk[RU][C];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) dk[r][c] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < RU; ++kb) {
      const float* blk = sm + l.tri + tri_offset(kb) + ty;
      const int pitch = tri_pitch(kb);
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += KC) {
        float dak[KC][C];
#pragma unroll
        for (int j = 0; j < KC; ++j) load_cols<C>(at + (16 * kb + k0 + j) * kBP + C * tx, dak[j]);
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          if (r > kb) continue;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const float lv = blk[(k0 + j) * pitch + 16 * r];
#pragma unroll
            for (int c = 0; c < C; ++c) dk[r][c] += lv * dak[j][c];
          }
        }
      }
    }
    // ---- per-source sums (the present body; the features take the tiles'
    // place again), or dK's tile to the workspace (phase 1)
    if constexpr (!Sums) {
      float* dkt = a.ws + static_cast<int64_t>(w) * a.wsz + a.dk_off +
                   static_cast<int64_t>(tile) * MP * kTile;
#pragma unroll
      for (int r = 0; r < RU; ++r) store_cols<C>(dkt + (ty + 16 * r) * kTile + C * tx, dk[r]);
      continue;
    }
    for (int ck = 0; ck < nchunks; ++ck) {
      const int s0 = ck * sc, ns = min(sc, S - s0);
      __syncthreads();    // the tiles' readers (or the last flush) are done
      bwd_chunk<NT>(a, sm, l, w, s0, ns);
      __syncthreads();
      bwd_xfeat<NT>(sm, l, ns * P, false);
      __syncthreads();
      for (int sl = 0; sl < ns; ++sl) {
        const float il = sm[l.pil + sl];
        // dK E, dK E (z - x) and, at C 2, dK E |z - x| of the thread's
        // elements; at C 4 (registers full) the third is the second with the
        // first's sign (exact: rounding is symmetric)
        float av[RU][C], ad[RU][C], aad[C == 2 ? RU : 1][C];
#pragma unroll
        for (int r = 0; r < RU; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float d = zr[r] - xt[c];
            av[r][c] = dk[r][c] * expf(-fabsf(d) * il);
            ad[r][c] = av[r][c] * d;
            if constexpr (C == 2) aad[r][c] = av[r][c] * fabsf(d);
          }
        // four partials at a time, so that their warp sums overlap
        for (int p0 = 0; p0 < P; p0 += 4) {
          float part[4][3];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part[j][0] = part[j][1] = part[j][2] = 0.f;
            const int q = sl * P + p0 + j;
            if (p0 + j >= P) continue;
            float cx[C], sx[C];
            load_cols<C>(sm + l.xf + 2 * q * kTile + C * tx, cx);
            load_cols<C>(sm + l.xf + (2 * q + 1) * kTile + C * tx, sx);
#pragma unroll
            for (int r = 0; r < RU; ++r) {
              const float2 z2 =
                  *reinterpret_cast<const float2*>(sm + l.zf + 2 * (q * MP + ty + 16 * r));
              const float cz = z2.x, sz = z2.y;
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const float c0 = cz * cx[c] + sz * sx[c];
                part[j][0] += av[r][c] * c0;
                if constexpr (C == 2) part[j][1] += aad[r][c] * c0;
                else part[j][1] += copysignf(ad[r][c], av[r][c]) * c0;
                part[j][2] += ad[r][c] * (sz * cx[c] - cz * sx[c]);
              }
            }
          }
          // the 12 sums, (j, k) in order, four to a butterfly
          const float* pv = &part[0][0];
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const float sum = warp_sum4(pv[4 * m], pv[4 * m + 1], pv[4 * m + 2], pv[4 * m + 3], lane);
            const int f = 4 * m + lane / 8;
            if (lane % 8 == 0 && p0 + f / 3 < P)
              sm[l.red + (warp * cpairs + sl * P + p0) * 3 + f] += sum;
          }
        }
      }
      if (nchunks > 1) bwd_flush<NT>(a, sm, l, rsrc, s0, ns, cpairs);
    }
  }
  // (a block without a tile has no chunk's parameters loaded, and nothing to add)
  if (Sums && nchunks == 1 && begin < end) bwd_flush<NT>(a, sm, l, rsrc, 0, S, cpairs);
  // (phase 1's record holds dLinv already, unless the share has no tile)
  if (Sums || begin >= end) {
#pragma unroll
    for (int u = 0; u < RU; ++u)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int i = 16 * u + ty, j = TX * b + tx;
        if (i < M && j < M) rec[i * M + j] = dl[u][b];
      }
  }
}

// The present body: one block per (split, window).
template <int RU>
__global__ void __launch_bounds__(bwd_threads(RU), RU >= 10 ? 1 : 2)
    fused_whiten_bwd_kernel(BwdArgs a) {
  GPITCH_DYNAMIC_SHARED(sm);
  bwd_tiles<RU, true>(a, sm, blockIdx.y, blockIdx.x);
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

cudaError_t reduce_splits(const float* part, float* out, int nw, int rec, int splits,
                          cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(nw) * rec;
  GPITCH_LAUNCH(reduce_splits_kernel, static_cast<unsigned>((total + 255) / 256), 256, 0,
                stream)(part, out, total, rec, splits);
  return cudaGetLastError();
}

// ------------------------------------------- kernel B, the two-phase body
// One persistent block an SM takes work items from a queue in device
// memory, in a fixed order: first phase 1, the `splits` shares of each
// window's tiles (bwd_tiles without the sums: the build and the four
// products, dK's tiles to the window's workspace), then phase 2, each
// window's sources in items of `sum_sources` (bwd_sums).  A phase-2 item
// waits until every phase-1 item of its window has counted itself done;
// those were taken before it, by blocks that are running, so no block
// waits on one that has not started.  Plan and bounds: the header.
constexpr int kSumCols = 5;                    // partials of a pair group: a warp's columns
constexpr int kSumGroups = bwd_threads(10) / 32;  // pair groups of an item: one a warp
constexpr int kWP = kTile + 1;                 // pitch of the dK E tiles
constexpr int kXP = 12;                        // a group's floats a sample: cos 5, sin 5, x, 0
constexpr int kPhaseItems = 4;                 // items a block, at least (the plan)
constexpr int kPhaseChunks = 3;                // build chunks a tile, at least (2 lose: the header)
struct Phases {};                              // selects the body at a launch

struct SumLayout {
  int w, xf, stage, xs, z, pe, pf, pv, pil, red, total;
};

// Shared memory of a phase-2 item (floats; every array 16-byte aligned):
// dK E of each of its si sources (MP rows at a pitch of kWP), the tile's
// x features per sample and pair group (cos of the group's 5 partials, sin
// of them, x), the next tile's dK and x as they arrive, z, the groups' e
// and f, the sources' var and il, and each pair's (e Sa, e Sd).
__host__ __device__ inline SumLayout make_sum_layout(int mp, int si) {
  SumLayout l;
  int o = 0;
  l.w = o;   o += round4(si * mp * kWP);
  l.xf = o;  o += kTile * kSumGroups * kXP;
  l.stage = o; o += mp * kTile;
  l.xs = o;  o += kTile;
  l.z = o;   o += mp;
  l.pe = o;  o += round4(kSumGroups * kSumCols);
  l.pf = o;  o += round4(kSumGroups * kSumCols);
  l.pv = o;  o += round4(si);
  l.pil = o; o += round4(si);
  l.red = o; o += 2 * kSumGroups * kSumCols;
  l.total = o;
  return l;
}

// Sources a phase-2 item holds: as many as give each warp one pair group of
// a source, ceil(P / 5) groups a source.
__host__ __device__ inline int sum_sources(int P) {
  return kSumGroups / ((P + kSumCols - 1) / kSumCols);
}

// The sources a phase-2 item holds where kernel B takes its two-phase body,
// else 0: at M 160 (RU 10) where the present body's plan walks more than
// one source chunk, and P <= 40 (a source's pair groups fit the warps).
inline int bwd_phase_sources(int M, int S, int P) {
  static_assert(kSumGroups * kSumCols == kPhaseMaxP, "a source's pair groups fit the warps");
  if (M < 1 || M > 160 || S < 1 || P < 1 || P > kPhaseMaxP) return 0;
  const int ru = padded_m(M) / 16, sc = bwd_chunk_sources(ru, S, P);
  if (ru != 10 || sc == 0 || (S + sc - 1) / sc < kPhaseChunks) return 0;
  const int si = sum_sources(P);
  return 4 * (make_sum_layout(16 * ru, si).total + 4) <= kSmemLimit ? si : 0;
}

// Floats per window of kernel B's workspace: the z features, and for the
// two-phase body dK's tiles (tiles, MP, kTile) and 4 floats that hold the
// queue's counters (phase_counters).
inline int bwd_workspace(int M, int N, int S, int P) {
  const int z = bwd_zfeat_floats(M, S, P);
  if (!bwd_phase_sources(M, S, P)) return z;
  return z + (N + kTile - 1) / kTile * padded_m(M) * kTile + 4;
}

// Window w's two counters in its workspace: [0] its phase-1 items done;
// window 0's [1] is the queue's next item.
__device__ __forceinline__ int* phase_counters(const BwdArgs& a, int w) {
  return reinterpret_cast<int*>(a.ws + static_cast<int64_t>(w) * a.wsz + a.ctr_off);
}

// Phase 2, one item: sources s0 .. s0 + ns - 1 of window w over its tiles
// [tb, te), into record slot `slot`.  Warp v takes
// pair group v: source v / gps (gps = ceil(P / 5)), partials 5 (v % gps) +
// j, j < 5.  Lane l holds rows l + 32 k of three products over the window's
// samples, 2 x 5 columns each (cos and sin of the group's partials),
//   Y[m][p] = sum_t W[m][t] (cos, sin)(2 pi f_p x_t),
// for W = dK E, dK E |z - x| and dK E (z - x), E = exp(-|z - x| il_s) of
// the warp's source, per 32-sample tile: dK's tile read from the workspace,
// W formed once into shared memory.  Then, once per item, the z features:
//   Sa_p = sum_m cos(2 pi f_p z_m) Ya[m][cos p] + sin(2 pi f_p z_m) Ya[m][sin p],
//   Sd_p the same of Yd, Sf_p = sum_m sin(..) Yf[m][cos p] - cos(..) Yf[m][sin p],
// summed over the lanes, and bwd_flush's formulas into the record (the
// slots' sum adds a window's ranges in a fixed order).
template <int RU>
__device__ void bwd_sums(const BwdArgs& a, float* sm, const SumLayout& l, int w, int s0, int tb,
                         int te, int slot) {
  constexpr int MP = 16 * RU, RM = MP / 32, NT = bwd_threads(RU);
  constexpr int G = kSumGroups, J = kSumCols;
  static_assert(MP % 32 == 0 && NT == 32 * G && MP * kTile / 4 % NT == 0 &&
                kTile * G * J % NT == 0, "a phase-2 item's shape");
  const int M = a.M, N = a.N, S = a.S, P = a.P;
  const int tid = threadIdx.x, lane = tid % 32, v = tid / 32;
  const int gps = (P + J - 1) / J, ns = min(a.sum_sources, S - s0);
  const int sl = v / gps, g = v - sl * gps;
  const bool active = sl < ns;
  const float* e = a.energy + static_cast<int64_t>(w) * a.e_stride;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride;
  for (int q = tid; q < G * J; q += NT) {
    const int s = q / J / gps, p = (q / J) % gps * J + q % J;
    const bool on = s < ns && p < P;
    sm[l.pe + q] = on ? e[(s0 + s) * P + p] : 0.f;
    sm[l.pf + q] = on ? f[(s0 + s) * P + p] : 0.f;
  }
  const int64_t vb = static_cast<int64_t>(w) * a.v_stride + s0;
  for (int s = tid; s < ns; s += NT) {
    sm[l.pv + s] = a.var[vb + s];
    sm[l.pil + s] = a.inv_l[vb + s];
  }
  const float* zw = a.zc + static_cast<int64_t>(w) * M;
  const float* xw = a.xc + static_cast<int64_t>(w) * N;
  for (int i = tid; i < MP; i += NT) sm[l.z + i] = i < M ? zw[i] : 0.f;
  __syncthreads();
  float zr[RM];
#pragma unroll
  for (int k = 0; k < RM; ++k) zr[k] = sm[l.z + lane + 32 * k];
  float y[3][RM][2][J];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int k = 0; k < RM; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) y[u][k][0][j] = y[u][k][1][j] = 0.f;
  const float* dkw = a.ws + static_cast<int64_t>(w) * a.wsz + a.dk_off;
  // a tile's dK and x to the stage, while the last tile's products run
  auto stage = [&](int tile) {
    const float* src = dkw + static_cast<int64_t>(tile) * MP * kTile;
#pragma unroll
    for (int r = 0; r < MP * kTile / 4 / NT; ++r)
      copy16_async(sm + l.stage + 4 * (tid + r * NT), src + 4 * (tid + r * NT));
    const int t = tile * kTile + tid;
    if (tid < kTile) copy4_async(sm + l.xs + tid, xw + (t < N ? t : 0), t < N);
  };
  if (tb < te) stage(tb);
  for (int tile = tb; tile < te; ++tile) {
    copy_async_wait();
    __syncthreads();    // the tile is staged; the last tile's readers of W and the features are done
    // ---- W = dK E of each source of the item (E as the present body forms it)
#pragma unroll
    for (int r = 0; r < MP * kTile / 4 / NT; ++r) {
      const int q = tid + r * NT, m = q / (kTile / 4), c = 4 * (q % (kTile / 4));
      const float4 d4 = *reinterpret_cast<const float4*>(sm + l.stage + 4 * q);
      const float4 x4 = *reinterpret_cast<const float4*>(sm + l.xs + c);
      const float dk[4] = {d4.x, d4.y, d4.z, d4.w};
      const float zm = sm[l.z + m];
      const float d[4] = {fabsf(zm - x4.x), fabsf(zm - x4.y), fabsf(zm - x4.z), fabsf(zm - x4.w)};
      for (int s = 0; s < ns; ++s) {
        const float il = sm[l.pil + s];
        float* o = sm + l.w + (s * MP + m) * kWP + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = dk[j] * expf(-d[j] * il);
      }
    }
    // ---- the tile's x features of each pair group (as the present body forms them)
#pragma unroll
    for (int r = 0; r < kTile * G * J / NT; ++r) {
      const int q = tid + r * NT, t = q / (G * J), k = q - t * (G * J), gv = k / J, j = k - gv * J;
      const float x = sm[l.xs + t];
      float sn, cs;
      sincosf((kTwoPi * x) * sm[l.pf + k], &sn, &cs);
      float* o = sm + l.xf + (t * G + gv) * kXP;
      o[j] = cs;
      o[J + j] = sn;
      if (j == 0) {
        o[2 * J] = x;
        o[2 * J + 1] = 0.f;
      }
    }
    __syncthreads();
    if (tile + 1 < te) stage(tile + 1);
    // ---- the three products, 6 FMAs an element and partial
    if (active) {
      const float* wr = sm + l.w + (sl * MP + lane) * kWP;
      const float* xr = sm + l.xf + v * kXP;
#pragma unroll 2
      for (int t = 0; t < kTile; ++t) {
        const float4 q0 = *reinterpret_cast<const float4*>(xr + t * G * kXP);
        const float4 q1 = *reinterpret_cast<const float4*>(xr + t * G * kXP + 4);
        const float4 q2 = *reinterpret_cast<const float4*>(xr + t * G * kXP + 8);
        const float cx[J] = {q0.x, q0.y, q0.z, q0.w, q1.x};
        const float sx[J] = {q1.y, q1.z, q1.w, q2.x, q2.y};
#pragma unroll
        for (int k = 0; k < RM; ++k) {
          const float wv = wr[32 * k * kWP + t], d = zr[k] - q2.z;
          const float wk[3] = {wv, wv * fabsf(d), wv * d};
#pragma unroll
          for (int u = 0; u < 3; ++u)
#pragma unroll
            for (int j = 0; j < J; ++j) {
              y[u][k][0][j] += wk[u] * cx[j];
              y[u][k][1][j] += wk[u] * sx[j];
            }
        }
      }
    }
  }
  // ---- the z features once, the lanes' sum, and the record
  float* rsrc = a.part + (static_cast<int64_t>(w) * a.splits + slot) * a.rec + M * M;
  float* rde = rsrc + 2 * S;
  float* rdf = rde + S * P;
  float* red = sm + l.red;
  if (active) {
    const float* zf = a.ws + static_cast<int64_t>(w) * a.wsz;   // cos, sin of a row side by side
    float sa[J], sd[J], sf[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sa[j] = sd[j] = sf[j] = 0.f;
      const int p = g * J + j;
      if (p >= P) continue;
      const float* zq = zf + 2 * static_cast<int64_t>((s0 + sl) * P + p) * MP;
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const float2 z2 = *reinterpret_cast<const float2*>(zq + 2 * (lane + 32 * k));
        const float cz = z2.x, sz = z2.y;
        sa[j] += cz * y[0][k][0][j] + sz * y[0][k][1][j];
        sd[j] += cz * y[1][k][0][j] + sz * y[1][k][1][j];
        sf[j] += sz * y[2][k][0][j] - cz * y[2][k][1][j];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], off);
        sd[j] += __shfl_xor_sync(0xffffffffu, sd[j], off);
        sf[j] += __shfl_xor_sync(0xffffffffu, sf[j], off);
      }
    if (lane == 0) {
      const float vs = sm[l.pv + sl];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = g * J + j, q = (s0 + sl) * P + p;
        if (p >= P) continue;
        const float ep = sm[l.pe + v * J + j];
        rde[q] = vs * sa[j];
        rdf[q] = -kTwoPi * ep * vs * sf[j];
        red[2 * (v * J + j)] = ep * sa[j];
        red[2 * (v * J + j) + 1] = ep * sd[j];
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < ns; s += NT) {
    float sv = 0.f, si = 0.f;
    for (int p = 0; p < P; ++p) {
      const int r = 2 * ((s * gps + p / J) * J + p % J);
      sv += red[r];
      si += red[r + 1];
    }
    rsrc[s0 + s] = sv;
    rsrc[S + s0 + s] = -sm[l.pv + s] * si;
  }
}

// The two-phase body.  Item i < nw splits: phase 1 of window i / splits,
// share i % splits; then phase 2: with ipw = ceil(S / sum_sources) source
// groups and R = sum_ranges ranges of tiles a window, item n1 + (w ipw + j)
// R + k takes window w's sources from sum_sources j over its k-th range.
template <int RU>
__global__ void __launch_bounds__(bwd_threads(RU), 1) fused_whiten_bwd_kernel(BwdArgs a, Phases) {
  GPITCH_DYNAMIC_SHARED(sm);
  const int si = a.sum_sources, ipw = (a.S + si - 1) / si, R = a.sum_ranges;
  const int tiles = (a.N + kTile - 1) / kTile, per = (tiles + R - 1) / R;
  const int n1 = a.nw * a.splits, items = n1 + a.nw * ipw * R;
  const SumLayout l = make_sum_layout(16 * RU, si);
  int* taken = reinterpret_cast<int*>(
      sm + max(make_bwd_layout(RU, a.chunk_sources, a.P).total, l.total));
  int* head = phase_counters(a, 0) + 1;
  for (;;) {
    __syncthreads();    // the last item's readers of shared memory (and of `taken`) are done
    if (threadIdx.x == 0) *taken = atomicAdd(head, 1);
    __syncthreads();
    const int item = *taken;
    if (item >= items) break;
    if (item < n1) {
      const int w = item / a.splits;
      bwd_tiles<RU, false>(a, sm, w, item - w * a.splits);
      __threadfence();    // dK's tiles, before the count that hands them on
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(phase_counters(a, w), 1);
    } else {
      const int w = (item - n1) / (ipw * R), j = (item - n1) / R - w * ipw;
      const int k = item - n1 - (w * ipw + j) * R;
      if (threadIdx.x == 0) {
        const volatile int* done = phase_counters(a, w);
        while (*done < a.splits) __nanosleep(128);
        __threadfence();
      }
      __syncthreads();
      bwd_sums<RU>(a, sm, l, w, j * si, min(tiles, k * per), min(tiles, (k + 1) * per), k);
    }
  }
}

// ------------------------------------------- kernel B, the role-split body
// One block of 12 warps per SM walks a contiguous range of the bank's
// (window, 64-sample tile) pairs; warps 0-7 (consumers) run the four
// products of tile t and the per-source sums of dK's first block rows,
// while warps 8-11 (producers) run the rest of the sums of tile t - 1 and
// then build tile t + 1.  Plan and handoffs: the header.
constexpr int kRTile = 64;                 // samples per tile
constexpr int kRP = kRTile + 4;            // pitch of the (MP, kRTile) tiles
constexpr int kCons = 256;                 // consumer threads
constexpr int kProd = 128;                 // producer threads
constexpr int kRoleThreads = kCons + kProd;
constexpr int kBarKuf = 1;                 // + slot: Kuf's tile and its x stored
constexpr int kBarDk = 3;                  // + slot: dK's tile stored over Kuf's
constexpr int kBarCons = 5;                // the consumers among themselves
constexpr int kBarProd = 6;                // the producers among themselves
constexpr int kRedSlots = kRoleThreads / 32;  // each warp's sums in `red`
struct RoleSplit {};                       // selects the body at a launch

// The widths that have the role-split body: RU 10's G and triangle leave
// no room for the two slots (header).
__host__ __device__ constexpr bool role_split(int ru) { return ru <= 7; }

// The block rows of dK whose per-source sums the consumers take, from their
// registers, so that the roles' work a tile balances (header).
__host__ __device__ constexpr int cons_rows(int ru) { return (ru + 1) / 4; }

struct RoleLayout {
  int tri, g, gp, at, zf, zfe, z, dv, pe, pf, pv, pil, red, slot, slot_size;
  int kt, xf, x, err;   // offsets inside a slot
  int total;
};

// Shared memory of the role-split body (floats; every array 16-byte
// aligned), the sizes at RU 7 and 3 x 5 in bytes:
//   tri   Linv's lower triangle by block rows, as kernel A          30,464
//   g     G = dU + dU^T, MP rows at a pitch of MP + 4               51,968
//   at    A, then dA (MP x kRP), the consumers' own                 30,464
//   zf    cos, sin(2 pi f_q z_i) of every pair q, interleaved       13,440
//   zfe   the same times var_s e_q (the build's)                    13,440
//   z, dv, e_q, f_q, var_s, il_s                                     1,056
//   red   each warp's sums, 3 per pair                               2,160
//   slot  x 2: Kuf's tile, then dK's (MP x kRP)                 2 x 30,464
//              cos, sin(2 pi f_q x_t) of the tile, per pair      2 x  7,680
//              x and err of the tile                             2 x    512
// 220,304 of the 232,448 a block may have; 19 pairs fit at RU 7.
__host__ __device__ inline RoleLayout make_role_layout(int ru, int S, int P) {
  const int mp = 16 * ru, pairs = S * P;
  RoleLayout l;
  int o = 0;
  l.tri = o;  o += tri_offset(ru);
  l.gp = mp + 4;
  l.g = o;    o += mp * l.gp;
  l.at = o;   o += mp * kRP;
  l.zf = o;   o += pairs * mp * 2;
  l.zfe = o;  o += pairs * mp * 2;
  l.z = o;    o += mp;
  l.dv = o;   o += mp;
  l.pe = o;   o += round4(pairs);
  l.pf = o;   o += round4(pairs);
  l.pv = o;   o += round4(S);
  l.pil = o;  o += round4(S);
  l.red = o;  o += round4(kRedSlots * pairs * 3);
  l.kt = 0;
  l.xf = mp * kRP;
  l.x = l.xf + pairs * 2 * kRTile;
  l.err = l.x + kRTile;
  l.slot_size = l.err + kRTile;
  l.slot = o; o += 2 * l.slot_size;
  l.total = o;
  return l;
}

// Whether kernel B takes the role-split body at these sizes: RU allows it
// and every pair's features fit beside the slots.
inline bool bwd_roles(int M, int S, int P) {
  const int ru = padded_m(M) / 16;
  return role_split(ru) && 4 * make_role_layout(ru, S, P).total <= kSmemLimit;
}

// Blocks covering window w's tiles [w tpw, (w + 1) tpw) at `per` tiles a
// block, and the most of any window.
__host__ __device__ inline int role_blocks(int w, int tpw, int64_t per) {
  const int64_t a = static_cast<int64_t>(w) * tpw;
  return static_cast<int>((a + tpw - 1) / per - a / per + 1);
}

inline int role_records(int nw, int tpw, int64_t per) {
  int most = 1;
  for (int w = 0; w < nw; ++w) {
    const int b = role_blocks(w, tpw, per);
    most = b > most ? b : most;
  }
  return most;
}

// Window w's operands, the same for every tile: the triangle, G, z, dv,
// the parameters and the z features (all threads); the producers' sums
// zeroed.
template <int RU>
__device__ void role_window(const BwdArgs& a, float* sm, const RoleLayout& l, int w) {
  constexpr int MP = 16 * RU;
  const int M = a.M, P = a.P, pairs = a.S * P, tid = threadIdx.x;
  const int64_t mm = static_cast<int64_t>(w) * M * M;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int cols = 16 * (r + 1);
    float* dst = sm + l.tri + tri_offset(r);
    for (int idx = tid; idx < 16 * cols; idx += kRoleThreads) {
      const int ii = idx / cols, k = idx - ii * cols, i = 16 * r + ii;
      dst[ii * tri_pitch(r) + k] = (k <= i && i < M) ? a.linv[mm + i * M + k] : 0.f;
    }
  }
  for (int idx = tid; idx < MP * MP; idx += kRoleThreads) {
    const int i = idx / MP, k = idx - i * MP;
    sm[l.g + i * l.gp + k] =
        (i < M && k < M) ? a.du[mm + i * M + k] + a.du[mm + k * M + i] : 0.f;
  }
  const float* z = a.zc + static_cast<int64_t>(w) * M;
  for (int i = tid; i < MP; i += kRoleThreads) {
    sm[l.z + i] = i < M ? z[i] : 0.f;
    sm[l.dv + i] = i < M ? a.dv[static_cast<int64_t>(w) * M + i] : 0.f;
  }
  const float* e = a.energy + static_cast<int64_t>(w) * a.e_stride;
  const float* f = a.freq + static_cast<int64_t>(w) * a.e_stride;
  const float* v = a.var + static_cast<int64_t>(w) * a.v_stride;
  const float* il = a.inv_l + static_cast<int64_t>(w) * a.v_stride;
  for (int q = tid; q < pairs; q += kRoleThreads) {
    sm[l.pe + q] = e[q];
    sm[l.pf + q] = f[q];
  }
  for (int s = tid; s < a.S; s += kRoleThreads) {
    sm[l.pv + s] = v[s];
    sm[l.pil + s] = il[s];
  }
  for (int idx = tid; idx < pairs * MP; idx += kRoleThreads) {
    const int q = idx / MP, i = idx - q * MP;
    float sn = 0.f, cs = 0.f;
    if (i < M) sincosf((kTwoPi * z[i]) * f[q], &sn, &cs);
    const float ev = v[q / P] * e[q];
    sm[l.zf + 2 * idx] = cs;
    sm[l.zf + 2 * idx + 1] = sn;
    sm[l.zfe + 2 * idx] = ev * cs;
    sm[l.zfe + 2 * idx + 1] = ev * sn;
  }
  for (int q = tid; q < kRedSlots * pairs * 3; q += kRoleThreads) sm[l.red + q] = 0.f;
}

// The per-source sums of dK's elements (rb + 16 r, col + c), R0 <= r < R1,
// c < 4, of the tile in `slot`, into slot `rs` of `red`, as the present body
// forms them: dK E, dK E (z - x) and, by the latter's sign, dK E |z - x|
// against each pair's cos and sin, summed over the warp.
template <int RU, int R0, int R1>
__device__ __forceinline__ void tile_sums(const BwdArgs& a, float* sm, const RoleLayout& l,
                                          const float* slot, const float (&dk)[RU][4], int rb,
                                          int col, int rs) {
  constexpr int MP = 16 * RU;
  const int lane = threadIdx.x % 32, P = a.P, pairs = a.S * P;
  float zr[RU], xt[4];
#pragma unroll
  for (int r = R0; r < R1; ++r) zr[r] = sm[l.z + rb + 16 * r];
  load_cols<4>(slot + l.x + col, xt);
  for (int sl = 0; sl < a.S; ++sl) {
    const float il = sm[l.pil + sl];
    float av[RU][4], ad[RU][4];
#pragma unroll
    for (int r = R0; r < R1; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d = zr[r] - xt[c];
        av[r][c] = dk[r][c] * expf(-fabsf(d) * il);
        ad[r][c] = av[r][c] * d;
      }
    for (int p0 = 0; p0 < P; p0 += 4) {
      float part[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[j][0] = part[j][1] = part[j][2] = 0.f;
        const int q = sl * P + p0 + j;
        if (p0 + j >= P) continue;
        float cx[4], sx[4];
        load_cols<4>(slot + l.xf + 2 * q * kRTile + col, cx);
        load_cols<4>(slot + l.xf + (2 * q + 1) * kRTile + col, sx);
        const float* zq = sm + l.zf + 2 * (q * MP + rb);
#pragma unroll
        for (int r = R0; r < R1; ++r) {
          const float2 z2 = *reinterpret_cast<const float2*>(zq + 32 * r);
          const float cz = z2.x, sz = z2.y;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float c0 = cz * cx[c] + sz * sx[c];
            part[j][0] += av[r][c] * c0;
            part[j][1] += copysignf(ad[r][c], av[r][c]) * c0;
            part[j][2] += ad[r][c] * (sz * cx[c] - cz * sx[c]);
          }
        }
      }
      // the 12 sums, (j, k) in order, four to a butterfly
      const float* pv = &part[0][0];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float sum = warp_sum4(pv[4 * m], pv[4 * m + 1], pv[4 * m + 2], pv[4 * m + 3], lane);
        const int f = 4 * m + lane / 8;
        if (lane % 8 == 0 && p0 + f / 3 < P) sm[l.red + (rs * pairs + sl * P + p0) * 3 + f] += sum;
      }
    }
  }
}

// The consumers: per tile, A = tril(Linv) Kuf, dA = G A + dv err^T, dLinv
// += dA Kuf^T and dK = tril(Linv)^T dA, dK stored over Kuf in its slot.
// Thread (ty, tx), a warp 8 ty x 4 tx, owns the elements (ty + 16 r, 4 tx
// + c) of A, dA and dK, and dLinv's (16 a + ty, 16 b + tx) across the
// tiles; the loads and their bank-conflict-free pitches are those of the
// present body at C 4 (header).
template <int RU>
__device__ void role_consumer(const BwdArgs& a, float* sm, const RoleLayout& l, int tb, int te,
                              float* rec) {
  constexpr int MP = 16 * RU, KC = 8;
  const int cid = threadIdx.x, lane = cid % 32, cw = cid / 32;
  const int ty = (lane & 7) + 8 * (cw & 1), tx = (lane >> 3) + 4 * (cw >> 1), col = 4 * tx;
  float dl[RU][RU];
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int b = 0; b < RU; ++b) dl[u][b] = 0.f;
  float* at = sm + l.at;
  for (int t = tb; t < te; ++t) {
    const int s = (t - tb) & 1;
    float* kt = sm + l.slot + s * l.slot_size + l.kt;
    // ---- consumers wait for Kuf
    named_sync(kBarKuf + s, kRoleThreads);
    // ---- A = tril(Linv) Kuf: for each 16-block kb of k, KC rows of Kuf at
    // a time against the block rows r >= kb
    float acc[RU][4];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < RU; ++kb) {
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += KC) {
        float kv[KC][4];
#pragma unroll
        for (int j = 0; j < KC; ++j) load_cols<4>(kt + (16 * kb + k0 + j) * kRP + col, kv[j]);
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          if (r < kb) continue;
          const float* row = sm + l.tri + tri_offset(r) + ty * tri_pitch(r) + 16 * kb + k0;
#pragma unroll
          for (int k4 = 0; k4 < KC; k4 += 4) {
            const float4 lv = *reinterpret_cast<const float4*>(row + k4);
            const float lk[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] += lk[j] * kv[k4 + j][c];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) store_cols<4>(at + (ty + 16 * r) * kRP + col, acc[r]);
    named_sync(kBarCons, kCons);
    // ---- dA = G A + dv err^T
    {
      float e[4];
      load_cols<4>(sm + l.slot + s * l.slot_size + l.err + col, e);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const float dvr = sm[l.dv + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = dvr * e[c];
      }
    }
#pragma unroll 2
    for (int k = 0; k < MP; k += 4) {
      float av[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_cols<4>(at + (k + j) * kRP + col, av[j]);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const float4 gv = *reinterpret_cast<const float4*>(sm + l.g + (ty + 16 * r) * l.gp + k);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += gr[j] * av[j][c];
      }
    }
    named_sync(kBarCons, kCons);    // every reader of A is done: dA takes its place
#pragma unroll
    for (int r = 0; r < RU; ++r) store_cols<4>(at + (ty + 16 * r) * kRP + col, acc[r]);
    named_sync(kBarCons, kCons);
    // ---- dLinv += dA Kuf^T, 4 samples at a time
#pragma unroll 1
    for (int t4 = 0; t4 < kRTile; t4 += 4) {
      float4 rv[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u)
        rv[u] = *reinterpret_cast<const float4*>(at + (16 * u + ty) * kRP + t4);
#pragma unroll
      for (int b = 0; b < RU; ++b) {
        const float4 cv = *reinterpret_cast<const float4*>(kt + (16 * b + tx) * kRP + t4);
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          dl[u][b] += rv[u].x * cv.x;
          dl[u][b] += rv[u].y * cv.y;
          dl[u][b] += rv[u].z * cv.z;
          dl[u][b] += rv[u].w * cv.w;
        }
      }
    }
    // ---- dK = tril(Linv)^T dA: for each 16-block kb of k, KC rows of dA
    // at a time against the block rows r <= kb (Linv's columns read down
    // the triangle's block row kb), unrolled over the block pairs so that
    // no branch stands between a load and its use
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int kb = 0; kb < RU; ++kb) {
      const float* blk = sm + l.tri + tri_offset(kb) + ty;
      const int pitch = tri_pitch(kb);
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += KC) {
        float dak[KC][4];
#pragma unroll
        for (int j = 0; j < KC; ++j) load_cols<4>(at + (16 * kb + k0 + j) * kRP + col, dak[j]);
#pragma unroll
        for (int r = 0; r <= kb; ++r) {
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const float lv = blk[(k0 + j) * pitch + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += lv * dak[j][c];
          }
        }
      }
    }
    // ---- consumers' share of the sums: dK's first cons_rows(RU) block rows
    if constexpr (cons_rows(RU) > 0)
      tile_sums<RU, 0, cons_rows(RU)>(a, sm, l, sm + l.slot + s * l.slot_size, acc, ty, col,
                                      kProd / 32 + cw);
    named_sync(kBarCons, kCons);    // Kuf's last readers are done: dK takes its place
#pragma unroll
    for (int r = 0; r < RU; ++r) store_cols<4>(kt + (ty + 16 * r) * kRP + col, acc[r]);
    __threadfence_block();
    named_arrive(kBarDk + s, kRoleThreads);
  }
  // ---- consumers' record
  const int M = a.M;
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int b = 0; b < RU; ++b) {
      const int i = 16 * u + ty, j = 16 * b + tx;
      if (i < M && j < M) rec[i * M + j] = dl[u][b];
    }
}

// A producer's rows and columns: thread (py, px) = (pid / 8, pid % 8) owns
// (py + 16 r, 32 h + 4 px + c) of each half h of a tile, a warp 4 py x 8 px.
// The build of tile t into slot `s`: the tile's x, err and x features, then
// Kuf = sum_s E_s sum_q (var_s e_q cos, sin z_q) . (cos, sin x_q).
template <int RU>
__device__ void role_build(const BwdArgs& a, float* sm, const RoleLayout& l, int w, int t,
                           int s) {
  constexpr int MP = 16 * RU;
  const int pid = threadIdx.x - kCons, py = pid / 8, px = pid % 8;
  const int M = a.M, N = a.N, P = a.P, pairs = a.S * P, t0 = t * kRTile;
  float* slot = sm + l.slot + s * l.slot_size;
  const float* xg = a.xc + static_cast<int64_t>(w) * N;
  named_sync(kBarProd, kProd);    // the slot's last readers (tile t - 2's sums) are done
  for (int idx = pid; idx < pairs * kRTile; idx += kProd) {
    const int q = idx / kRTile, c = idx - q * kRTile, tt = t0 + c;
    float sn, cs;
    sincosf((kTwoPi * (tt < N ? xg[tt] : 0.f)) * sm[l.pf + q], &sn, &cs);
    slot[l.xf + 2 * q * kRTile + c] = cs;
    slot[l.xf + (2 * q + 1) * kRTile + c] = sn;
  }
  if (pid < kRTile) {
    const int tt = t0 + pid;
    slot[l.x + pid] = tt < N ? xg[tt] : 0.f;
    slot[l.err + pid] = tt < N ? a.err[static_cast<int64_t>(w) * N + tt] : 0.f;
  }
  named_sync(kBarProd, kProd);
  float zr[RU];
#pragma unroll
  for (int r = 0; r < RU; ++r) zr[r] = sm[l.z + py + 16 * r];
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int col = 32 * h + 4 * px;
    float xt[4];
    load_cols<4>(slot + l.x + col, xt);
    float kacc[RU][4];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) kacc[r][c] = 0.f;
    for (int sl = 0; sl < a.S; ++sl) {
      float mix[RU][4];
#pragma unroll
      for (int r = 0; r < RU; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mix[r][c] = 0.f;
      for (int p = 0; p < P; ++p) {
        const int q = sl * P + p;
        float cx[4], sx[4];
        load_cols<4>(slot + l.xf + 2 * q * kRTile + col, cx);
        load_cols<4>(slot + l.xf + (2 * q + 1) * kRTile + col, sx);
        const float* zq = sm + l.zfe + 2 * (q * MP + py);
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          const float2 z2 = *reinterpret_cast<const float2*>(zq + 32 * r);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            mix[r][c] += z2.x * cx[c];
            mix[r][c] += z2.y * sx[c];
          }
        }
      }
      const float il = sm[l.pil + sl];
#pragma unroll
      for (int r = 0; r < RU; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) kacc[r][c] += expf(-fabsf(zr[r] - xt[c]) * il) * mix[r][c];
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int i = py + 16 * r;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = (i < M && t0 + col + c < N) ? kacc[r][c] : 0.f;
      store_cols<4>(slot + l.kt + i * kRP + col, v);
    }
  }
  __threadfence_block();
  named_arrive(kBarKuf + s, kRoleThreads);
}

// The producers' share of the sums of the tile in slot `s`: dK's block rows
// from cons_rows(RU) on.  Thread (py, px) = (pid / 8, pid % 8) owns (py +
// 16 r, 32 h + 4 px + c) of each half h of the tile, a warp 4 py x 8 px.
template <int RU>
__device__ void role_sums(const BwdArgs& a, float* sm, const RoleLayout& l, int s) {
  constexpr int R0 = cons_rows(RU);
  const int pid = threadIdx.x - kCons, py = pid / 8, px = pid % 8;
  const float* slot = sm + l.slot + s * l.slot_size;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int col = 32 * h + 4 * px;
    float dk[RU][4];
#pragma unroll
    for (int r = R0; r < RU; ++r) load_cols<4>(slot + l.kt + (py + 16 * r) * kRP + col, dk[r]);
    tile_sums<RU, R0, RU>(a, sm, l, slot, dk, py, col, pid / 32);
  }
}

// The producers: tiles tb and tb + 1 built, then per tile t the sums of
// its dK and the build of tile t + 2 into the slot they free; last the
// record's dvar, dinvl, de, df from the warps' sums (bwd_flush's formulas).
template <int RU>
__device__ void role_producer(const BwdArgs& a, float* sm, const RoleLayout& l, int w, int tb,
                              int te, float* rec) {
  for (int t = tb; t < te && t < tb + 2; ++t) role_build<RU>(a, sm, l, w, t, t - tb);
  for (int t = tb; t < te; ++t) {
    const int s = (t - tb) & 1;
    // ---- producers wait for dK
    named_sync(kBarDk + s, kRoleThreads);
    // ---- per-source sums of dK
    role_sums<RU>(a, sm, l, s);
    // ---- the build of tile t + 2
    if (t + 2 < te) role_build<RU>(a, sm, l, w, t + 2, s);
  }
  // ---- producers' record
  const int pid = threadIdx.x - kCons, S = a.S, P = a.P, pairs = S * P;
  float* red = sm + l.red;
  float* rsrc = rec + a.M * a.M;
  float* rde = rsrc + 2 * S;
  float* rdf = rde + pairs;
  named_sync(kBarProd, kProd);
  for (int q = pid; q < pairs; q += kProd) {
    float sa = 0.f, sd = 0.f, sf = 0.f;
    for (int v = 0; v < kRedSlots; ++v) {
      const float* r = red + (v * pairs + q) * 3;
      sa += r[0];
      sd += r[1];
      sf += r[2];
    }
    const float e = sm[l.pe + q], vs = sm[l.pv + q / P];
    rde[q] = vs * sa;
    rdf[q] = -kTwoPi * e * vs * sf;
    red[q * 3] = e * sa;
    red[q * 3 + 1] = e * sd;
  }
  named_sync(kBarProd, kProd);
  for (int sl = pid; sl < S; sl += kProd) {
    float sv = 0.f, si = 0.f;
    for (int p = 0; p < P; ++p) {
      sv += red[(sl * P + p) * 3];
      si += red[(sl * P + p) * 3 + 1];
    }
    rsrc[sl] = sv;
    rsrc[S + sl] = -sm[l.pv + sl] * si;
  }
}

// Block b takes the tiles [b per, (b + 1) per) of the bank's nw tpw
// (window, tile) pairs, window by window (an item); its record of window w
// is slot b - (the first block of w) of w's `splits`, and the first block
// of w zeroes the slots that no block covers.  An item loads the window's
// operands, then the roles run it to its end.
template <int RU>
__global__ void __launch_bounds__(kRoleThreads, 1) fused_whiten_bwd_kernel(BwdArgs a, RoleSplit) {
  GPITCH_DYNAMIC_SHARED(sm);
  const RoleLayout l = make_role_layout(RU, a.S, a.P);
  const int tpw = (a.N + kRTile - 1) / kRTile;
  const int64_t total = static_cast<int64_t>(a.nw) * tpw, per = a.per;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t g1 = g0 + per < total ? g0 + per : total;
  for (int64_t g = g0; g < g1;) {
    const int w = static_cast<int>(g / tpw);
    const int tb = static_cast<int>(g - static_cast<int64_t>(w) * tpw);
    const int te = g1 - g < tpw - tb ? tb + static_cast<int>(g1 - g) : tpw;
    g += te - tb;
    const int first = static_cast<int>(static_cast<int64_t>(w) * tpw / per);
    const int slot = static_cast<int>(blockIdx.x) - first;
    float* rec = a.part + (static_cast<int64_t>(w) * a.splits + slot) * a.rec;
    __syncthreads();    // the last item's readers of the window's operands are done
    role_window<RU>(a, sm, l, w);
    if (slot == 0) {
      float* unused = a.part + (static_cast<int64_t>(w) * a.splits + role_blocks(w, tpw, per)) * a.rec;
      const int64_t n = static_cast<int64_t>(a.splits - role_blocks(w, tpw, per)) * a.rec;
      for (int64_t k = threadIdx.x; k < n; k += kRoleThreads) unused[k] = 0.f;
    }
    __syncthreads();
    if (threadIdx.x < kCons) role_consumer<RU>(a, sm, l, tb, te, rec);
    else role_producer<RU>(a, sm, l, w, tb, te, rec);
  }
}

// Raises `fn`'s dynamic shared-memory limit to `smem` bytes, once per device.
cudaError_t allow_shared(const void* fn, int smem, std::atomic<int>* allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > allowed[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[device].store(smem, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Blocks per window.  Blocks of equal work run in waves of (SMs x resident
// blocks per SM); a window's tiles are split over the number of blocks that
// minimises waves x (tiles per block + kSetupTiles), where the set-up is a
// block's loads (Linv or C, the z features) and its record's write.  Splits
// that would leave a block without a tile are skipped.
cudaError_t plan_splits(const void* fn, int threads, int smem, int N, int nw, int* splits) {
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t slots = static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int tiles = (N + kTile - 1) / kTile;
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

// Kernel A: the z features per window, the main kernel and the splits'
// sum; or, with `splits_out`, only the split that `plan_splits` picks.
template <int RU>
cudaError_t fwd_run(Args a, int nw, float* out, cudaStream_t stream, int* splits_out) {
  static std::atomic<int> allowed[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(&fused_whiten_fwd_kernel<RU>);
  const int smem = static_cast<int>(sizeof(float) * make_fwd_layout(RU, a.chunk_sources, a.p2).total);
  cudaError_t err = allow_shared(fn, smem, allowed);
  if (err != cudaSuccess) return err;
  if (splits_out) return plan_splits(fn, kThreads, smem, a.N, nw, splits_out);
  const int zblocks = (a.S * a.p2 * a.mp + 1023) / 1024;
  GPITCH_LAUNCH(fwd_zfeat_kernel, dim3(zblocks, nw), kThreads, 0, stream)(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GPITCH_LAUNCH(fused_whiten_fwd_kernel<RU>, dim3(a.splits, nw), kThreads, smem, stream)(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce_splits(a.part, out, nw, a.rec, a.splits, stream);
}

int fwd_dispatch(Args a, int nw, void* out, void* stream, int* splits_out = nullptr) {
  if (splits_out) *splits_out = 1;
  if (nw == 0 || a.M == 0) return 0;
  a.mp = padded_m(a.M);
  a.p2 = (a.P + 1) & ~1;
  a.chunk_sources = fwd_chunk_sources(a.mp / 16, a.S, a.p2);
  if (a.chunk_sources == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.rec = a.M * a.M + a.M;
  a.wsz = fwd_workspace(a.M, a.S, a.P);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (a.mp == 16) err = fwd_run<1>(a, nw, o, s, splits_out);
  else if (a.mp == 32) err = fwd_run<2>(a, nw, o, s, splits_out);
  else if (a.mp == 64) err = fwd_run<4>(a, nw, o, s, splits_out);
  else if (a.mp == 112) err = fwd_run<7>(a, nw, o, s, splits_out);
  else if (a.mp == 160) err = fwd_run<10>(a, nw, o, s, splits_out);
  return static_cast<int>(err);
}

// Kernel B's role-split body: one block an SM over the bank's tiles, then
// the records' sum; or, with `splits_out`, the records a window takes when
// the tiles are shared evenly.  Given `splits` records a window, a block
// takes the even share, or, where a window would span more blocks than
// that, the fewest tiles that keep every window within `splits` blocks
// (window-aligned at 1).
template <int RU>
cudaError_t bwd_roles_run(BwdArgs a, int nw, cudaStream_t stream, int* splits_out) {
  static std::atomic<int> allowed[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(
      static_cast<void (*)(BwdArgs, RoleSplit)>(&fused_whiten_bwd_kernel<RU>));
  const int smem = static_cast<int>(sizeof(float) * make_role_layout(RU, a.S, a.P).total);
  cudaError_t err = allow_shared(fn, smem, allowed);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tpw = (a.N + kRTile - 1) / kRTile;
  const int64_t total = static_cast<int64_t>(nw) * tpw, even = (total + sms - 1) / sms;
  if (splits_out) {
    *splits_out = tpw > 0 ? role_records(nw, tpw, even) : 1;
    return cudaSuccess;
  }
  if (tpw == 0) {   // no samples: every gradient is 0
    err = cudaMemsetAsync(a.sums, 0, sizeof(float) * nw * a.rec, stream);
    return err;
  }
  int64_t per = even;
  if (role_records(nw, tpw, per) > a.splits) {
    if (a.splits == 1) per = tpw * ((even + tpw - 1) / tpw);
    else per = std::max<int64_t>(even, (tpw - 1 + a.splits - 2) / (a.splits - 1));
  }
  a.per = per;
  a.nw = nw;
  const unsigned blocks = static_cast<unsigned>((total + per - 1) / per);
  GPITCH_LAUNCH(fused_whiten_bwd_kernel<RU>, blocks, kRoleThreads, smem, stream)(a, RoleSplit{});
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce_splits(a.part, a.sums, nw, a.rec, a.splits, stream);
}

// Phase-1 items a window of the two-phase body: the fewest valid splits of
// its tiles that give `blocks` resident blocks kPhaseItems items each, so
// that a window's phase 1 ends early and its phase-2 items do not wait.
inline int phase_splits(int nw, int tiles, int blocks) {
  int splits = 1;
  for (int s = 1; s <= tiles; ++s) {
    const int per = (tiles + s - 1) / s;
    if ((tiles + per - 1) / per != s) continue;
    splits = s;
    if (static_cast<int64_t>(nw) * s >= static_cast<int64_t>(kPhaseItems) * blocks) break;
  }
  return splits;
}

// Kernel B's two-phase body: the z features per window, the queue's
// counters zeroed, one persistent block a resident slot (or one an item,
// where there are fewer items), then the records' sum; or, with
// `splits_out`, the phase-1 items a window (phase_splits).
template <int RU>
cudaError_t bwd_phases_run(BwdArgs a, int nw, cudaStream_t stream, int* splits_out) {
  static std::atomic<int> allowed[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(
      static_cast<void (*)(BwdArgs, Phases)>(&fused_whiten_bwd_kernel<RU>));
  const int floats = std::max(make_bwd_layout(RU, a.chunk_sources, a.P).total,
                              make_sum_layout(16 * RU, a.sum_sources).total) + 4;
  const int smem = static_cast<int>(sizeof(float)) * floats;
  cudaError_t err = allow_shared(fn, smem, allowed);
  int device = 0, sms = 0, resident = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, bwd_threads(RU), smem);
  if (err != cudaSuccess) return err;
  const int slots = sms * (resident > 0 ? resident : 1), tiles = (a.N + kTile - 1) / kTile;
  if (splits_out) {
    *splits_out = phase_splits(nw, tiles, slots);
    return cudaSuccess;
  }
  a.nw = nw;
  a.dk_off = bwd_zfeat_floats(a.M, a.S, a.P);
  a.ctr_off = a.dk_off + tiles * a.mp * kTile;
  const int zblocks = (a.S * a.P * a.mp + 1023) / 1024;
  GPITCH_LAUNCH(bwd_zfeat_kernel, dim3(zblocks, nw), kThreads, 0, stream)(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemset2DAsync(a.ws + a.ctr_off, sizeof(float) * a.wsz, 0, 2 * sizeof(int), nw,
                          stream);
  if (err != cudaSuccess) return err;
  // phase 2's ranges of a window's tiles: enough items for every block as
  // phase 1 has them, each range a record slot
  const int ipw = (a.S + a.sum_sources - 1) / a.sum_sources;
  a.sum_ranges = 1;
  while (a.sum_ranges < std::min(a.splits, tiles) &&
         static_cast<int64_t>(nw) * ipw * a.sum_ranges < static_cast<int64_t>(kPhaseItems) * slots)
    ++a.sum_ranges;
  const int items = nw * (a.splits + ipw * a.sum_ranges);
  GPITCH_LAUNCH(fused_whiten_bwd_kernel<RU>, std::min(slots, items), bwd_threads(RU), smem,
                stream)(a, Phases{});
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce_splits(a.part, a.sums, nw, a.rec, a.splits, stream);
}

// Kernel B: the role-split body where it serves the sizes (bwd_roles), the
// two-phase body where it does (bwd_phase_sources); else the z features
// per window, the present body and the splits' sum; or, with `splits_out`,
// only the plan of the body it takes.
template <int RU>
cudaError_t bwd_run(BwdArgs a, int nw, cudaStream_t stream, int* splits_out) {
  if constexpr (role_split(RU)) {
    if (bwd_roles(a.M, a.S, a.P)) return bwd_roles_run<RU>(a, nw, stream, splits_out);
  }
  a.chunk_sources = bwd_chunk_sources(RU, a.S, a.P);
  if (a.chunk_sources == 0) return cudaErrorInvalidValue;
  if constexpr (RU == 10) {
    a.sum_sources = bwd_phase_sources(a.M, a.S, a.P);
    if (a.sum_sources > 0) return bwd_phases_run<RU>(a, nw, stream, splits_out);
  }
  static std::atomic<int> allowed[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(
      static_cast<void (*)(BwdArgs)>(&fused_whiten_bwd_kernel<RU>));
  const int smem = static_cast<int>(sizeof(float) * make_bwd_layout(RU, a.chunk_sources, a.P).total);
  cudaError_t err = allow_shared(fn, smem, allowed);
  if (err != cudaSuccess) return err;
  if (splits_out) return plan_splits(fn, bwd_threads(RU), smem, a.N, nw, splits_out);
  const int zblocks = (a.S * a.P * a.mp + 1023) / 1024;
  GPITCH_LAUNCH(bwd_zfeat_kernel, dim3(zblocks, nw), kThreads, 0, stream)(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GPITCH_LAUNCH(fused_whiten_bwd_kernel<RU>, dim3(a.splits, nw), bwd_threads(RU), smem,
                stream)(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce_splits(a.part, a.sums, nw, a.rec, a.splits, stream);
}

int bwd_dispatch(BwdArgs a, int nw, void* stream, int* splits_out = nullptr) {
  if (splits_out) *splits_out = 1;
  if (nw == 0 || a.M == 0) return 0;
  a.mp = padded_m(a.M);
  a.rec = a.M * a.M + 2 * a.S + 2 * a.S * a.P;
  a.wsz = bwd_workspace(a.M, a.N, a.S, a.P);
  if (a.splits == 1) a.sums = a.part;
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (a.mp == 16) err = bwd_run<1>(a, nw, s, splits_out);
  else if (a.mp == 32) err = bwd_run<2>(a, nw, s, splits_out);
  else if (a.mp == 64) err = bwd_run<4>(a, nw, s, splits_out);
  else if (a.mp == 112) err = bwd_run<7>(a, nw, s, splits_out);
  else if (a.mp == 160) err = bwd_run<10>(a, nw, s, splits_out);
  return static_cast<int>(err);
}

Args make_args(const void* zc, const void* xc, const void* err, const void* linv,
               const void* energy, const void* freq, const void* var, const void* inv_l,
               void* ws, void* part, int e_stride, int v_stride, int M, int N, int S,
               int P, int splits) {
  Args a{};
  a.zc = static_cast<const float*>(zc);
  a.xc = static_cast<const float*>(xc);
  a.err = static_cast<const float*>(err);
  a.linv = static_cast<const float*>(linv);
  a.energy = static_cast<const float*>(energy);
  a.freq = static_cast<const float*>(freq);
  a.var = static_cast<const float*>(var);
  a.inv_l = static_cast<const float*>(inv_l);
  a.ws = static_cast<float*>(ws);
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

BwdArgs make_bwd_args(const void* zc, const void* xc, const void* err, const void* linv,
                      const void* energy, const void* freq, const void* var,
                      const void* inv_l, const void* du, const void* dv, void* part,
                      void* sums, void* ws, int e_stride, int v_stride, int M, int N, int S,
                      int P, int splits) {
  BwdArgs a{};
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
  a.sums = static_cast<float*>(sums);
  a.ws = static_cast<float*>(ws);
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

// Kernel A.  zc (nw, M, 1), xc, err (nw, 1, N), linv (nw, M, M), of
// which only the lower triangle is read; energy, freq (S, P) with e_stride
// 0 or (nw, S, P) with e_stride S P; var, inv_l (S,) or (nw, S) with
// v_stride 0 or S; all float32 and contiguous.  part (nw, splits, M M + M)
// receives each block's [U, v]; when splits > 1 the second kernel writes
// their sum to out (nw, M M + M); ws (nw,
// gpitch_fused_whiten_fwd_workspace(M, S, P)) is scratch.  M <= 160.
// Returns cudaError_t.
int gpitch_fused_whiten_fwd(const void* zc, const void* xc, const void* err, const void* linv,
                            const void* energy, const void* freq, const void* var,
                            const void* inv_l, void* part, void* out, void* ws, int e_stride,
                            int v_stride, int nw, int M, int N, int S, int P, int splits,
                            void* stream) {
  return fwd_dispatch(make_args(zc, xc, err, linv, energy, freq, var, inv_l, ws, part, e_stride,
                                v_stride, M, N, S, P, splits),
                      nw, out, stream);
}

// Floats per window of kernel A's scratch `ws`.
int gpitch_fused_whiten_fwd_workspace(int M, int S, int P) { return fwd_workspace(M, S, P); }

// Kernel B.  As kernel A (Linv's lower triangle only), plus du (nw, M, M)
// and dv (nw, M, 1).  part (nw, splits, rec) receives each block's
// [dLinv (M M), dvar (S), dinvl (S), de (S P), df (S P)] and sums (nw, rec)
// their sum (unused when splits == 1); ws (nw,
// gpitch_fused_whiten_bwd_workspace(M, N, S, P)) is scratch.
int gpitch_fused_whiten_bwd(const void* zc, const void* xc, const void* err, const void* linv,
                            const void* energy, const void* freq, const void* var,
                            const void* inv_l, const void* du, const void* dv, void* part,
                            void* sums, void* ws, int e_stride, int v_stride, int nw, int M,
                            int N, int S, int P, int splits, void* stream) {
  return bwd_dispatch(make_bwd_args(zc, xc, err, linv, energy, freq, var, inv_l, du, dv, part,
                                    sums, ws, e_stride, v_stride, M, N, S, P, splits),
                      nw, stream);
}

// Floats per window of kernel B's scratch `ws` at N samples (none for the
// role-split body, which forms its z features in shared memory).
int gpitch_fused_whiten_bwd_workspace(int M, int N, int S, int P) {
  return bwd_roles(M, S, P) ? 0 : bwd_workspace(M, N, S, P);
}

// 1 where kernel B takes its role-split body at these sizes, else 0.
int gpitch_fused_whiten_bwd_roles(int M, int S, int P) { return bwd_roles(M, S, P) ? 1 : 0; }

// The sources that one phase-2 item of kernel B's two-phase body holds at
// these sizes, or 0 where kernel B does not take that body.
int gpitch_fused_whiten_bwd_phases(int M, int S, int P) { return bwd_phase_sources(M, S, P); }

// The source chunks that one launch of kernel A (bwd 0) or B (bwd 1) walks
// at these sizes: S over the sources a chunk its shared-memory plan holds,
// rounded up (1 for kernel B's role-split body, which holds every source);
// 0 where the kernel cannot take the sizes.
int gpitch_fused_whiten_source_chunks(int bwd, int M, int S, int P) {
  if (M < 1 || M > 160 || S < 1 || P < 1) return 0;
  const int ru = padded_m(M) / 16;
  int sc = 0;
  if (!bwd) sc = fwd_chunk_sources(ru, S, (P + 1) & ~1);
  else if (bwd_roles(M, S, P)) sc = S;
  else sc = bwd_chunk_sources(ru, S, P);
  return sc > 0 ? (S + sc - 1) / sc : 0;
}

// The split `splits` that the launches of kernel A (bwd 0) or B (bwd 1) take
// at these sizes by default, on the current device.
int gpitch_fused_whiten_splits(int bwd, int nw, int M, int N, int S, int P, int* splits) {
  if (bwd)
    return bwd_dispatch(make_bwd_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, 0, 0, M, N, S, P, 1),
                        nw, nullptr, splits);
  return fwd_dispatch(make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, 0, 0, M, N, S, P, 1),
                      nw, nullptr, nullptr, splits);
}

}  // extern "C"
