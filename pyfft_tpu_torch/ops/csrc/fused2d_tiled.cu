// Batched (ny, nx) complex64 2D DFT over the last two axes in one launch,
// for planes of up to 2^20 points: the "fused2d_tiled" kernel (K9) of
// pyfft_tpu_torch.
//
// Replaces the JAX package's tiled fused 2D kernel (pyfft_tpu/ops/
// pallas_local.py: `_fused2d_tiled_kernel`, launched by `_fft2_fused_tiled`
// through `pl.pallas_call`), which walks 128-lane slices of a plane
// through a VMEM scratch plane: the y stages slice by slice into the
// scratch, then the x stages slice by slice out of it.  It computes
//
//   out[l, ky, kx] = postscale * sum_{y,x} x[l, y, x]
//                                 * exp(sign*2*pi*i*(y*ky/ny + x*kx/nx))
//
// for ny, nx powers of two and multiples of 128 with ny*nx <= 2^20
// (MAX_FUSED2D_TILED_ELEMS), the range past the fused 2D kernel's 2^18.
//
// What bounds it on an H100: bytes, 16 a point at the least.  The fused 2D
// kernel (fused2d.cu, K8) keeps a plane in a cluster's shared memory
// between its two axes, but a 2^20-point plane (8 MiB) is more than even a
// 16-block cluster holds (16 x 227 KB).  So this kernel keeps K8's frame
// and moves the exchange to device memory, the output planes serving as
// the scratch plane, held in the L2 where the planes in flight fit it:
//
//   * a persistent grid of min(L, cap) clusters of G blocks, G = ny*nx /
//     CHUNK capped at 16 (clusters above 8 blocks are Hopper's
//     non-portable sizes), launched with cudaLaunchKernelEx; cluster i
//     takes planes i, i + clusters, ...; cap = the card's L2
//     (cudaDevAttrL2CacheSize, read at launch) over a plane's 8 bytes a
//     point, at least 1, so that the planes in flight's intermediates fit
//     the L2 (6 planes of 2^20 points on an H100);
//   * phase 1: block b takes rows [b*ny/G, (b+1)*ny/G) in chunks of at
//     most CHUNK points (64 KB of shared memory), each chunk a Stockham
//     radix-16 chain along x (a radix-2, 4 or 8 stage first: 4 x 16 x 16
//     at 1024 points, two shared-memory round trips where radix 8 took
//     three), its rows padded in shared memory (chain_index) and its
//     fifteen twiddles a butterfly formed from five reads, whose first
//     stage reads the rows from the input (L2 evict_first: read once) and
//     whose last stage writes them to the output (evict_last: kept for
//     phase 2), threads running along x;
//   * a __threadfence() and a cluster barrier: every row of the plane is
//     in the output before any block reads a column;
//   * phase 2: the columns read back from the output (evict_first: their
//     last use), transformed along y (radix 16 too) and written back in
//     place, postscale folded (evict_first): block b takes columns
//     [b*nx/G, (b+1)*nx/G) in chunks of CC whole columns while CC reaches
//     RUN floats of each plane (up to ny = 1024 at 8 floats, 32 bytes), and
//     beyond that a group of G2 blocks splits y and exchanges through DSMEM
//     (cluster_cols.cuh), tiles of RUN columns.  Those loads read what
//     other blocks wrote during this launch, so they go through the L2
//     (.cg) and never the read-only path (__ldg, or a const __restrict__
//     pointer's ld.global.nc), which may hold stale lines.
//
// So a point crosses device memory twice where its plane's intermediate
// stays in the L2 and four times where it does not; on an H100 the
// blocks' own pace (shared-memory round trips, one 512-thread block an SM
// at 128 registers, seven 16-block clusters held) limits it before the
// bytes do (PERF.md).
//
// Twiddles come from two tables exp(sign*2*pi*i*k/n), k < n, for ny and nx,
// built on the host in float64 and rounded once (no device sinf/cosf); the
// stage code is chain.cuh's, shared with K8, and each chunk reads its
// twiddles afresh (stockham.cuh's `fresh`) rather than holding every
// stage's in registers across the chunk loop.
//
// In place: phase 1 reads only the block's own rows and writes them after
// reading them, and phase 2 touches only the block's (or its group's) own
// columns, each tile's loads all before the group's first barrier, so the
// output may alias the input exactly; the planes of one cluster follow
// one another, and no two clusters share a plane.  Each operand is a pair
// of float planes with three strides in floats (l, y, x): planar data has
// (ny*nx, nx, 1), the two planes of torch.view_as_real(complex64) twice
// those.  Offsets are 64-bit.
//
// K9 + K10 (precision="int8"), a kernel of its own (fused2d_tiled_i8_kernel,
// on the first version's frame, ShapeT: one cluster a plane, all at once,
// CHUNK points a chunk; its code and bits are what they were): in each
// chunk the chain is radix-2/4/8
// stages over n/f bits, then the f-point int8-split stage of
// int8_stage.cuh (f the last factor of the JAX package's column chain,
// `col_factors`, as `_fft2_fused_tiled` takes: 32 at 256), whose outputs go
// straight to device memory, where both of K9's phases store anyway: no
// second buffer, the 64 KB chunk unchanged.  The stage is int8_stage_tc,
// on wgmma (512 threads, f >= 32 at every shape): W's image sits after the
// chunk in shared memory, copied by cp.async.bulk from kernel entry on.
// At f <= 64 it stays there for every chunk of the axis, and for both axes
// where fy = fx: one copy a block.  At f = 128 its 48 KB slabs stream
// through the buffers again for each chunk, the last slabs of one chunk
// starting the copies of the next's first.  Where fy differs from fx, wy's
// copy starts after phase 1's last chunk, across the cluster barrier.
// The alignment group is the chunk: RC rows or CC columns of one plane, at
// most CHUNK / n <= 64 and aligned to their count, so inside one
// 128-wide slice, the width of the JAX kernel's groups (a 128-column slice
// for y, 128 ky-rows for x).  The JAX kernel runs y first, then x; this
// kernel keeps K9's x first, so each int8 stage quantises other data than
// JAX's and the kernel matches JAX's function within the stage's error
// (held at 2e-6), not bit for bit.  At n = f a chunk loads its data first.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry points `pyfft_fused2d_tiled` and
// `pyfft_fused2d_tiled_i8`, and K9's shape (`pyfft_fused2d_tiled_shape`),
// at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "cluster_cols.cuh"
#include "int8_stage.cuh"

namespace {

using namespace pyfft;
namespace cg = cooperative_groups;

constexpr int NT = 512;          // threads a block
constexpr int CHUNK = 8192;      // points a chunk, at most (64 KB)

// K9's shape knobs (the int8 kernel keeps CHUNK and clusters of at most
// 16), each default the fastest measured (PERF.md; probes/float_split.py
// builds the others): points a chunk, at most; blocks a cluster, at most;
// the planes in flight, 0 for the card's L2 over a plane's bytes (6 planes
// of 2^20 points on an H100).
#ifndef PYFFT_TILED_CHUNK
#define PYFFT_TILED_CHUNK 8192
#endif
#ifndef PYFFT_TILED_GMAX
#define PYFFT_TILED_GMAX 16
#endif
#ifndef PYFFT_TILED_PLANES
#define PYFFT_TILED_PLANES 0
#endif

// Phase 2's run in floats of each plane, reached by splitting y over a
// group of the cluster's blocks where whole columns of that many do not
// fit a chunk (8: 32 bytes, a split from ny = 2048; 32 floats, 128 bytes,
// split from ny = 512, lost to the DSMEM exchange's barriers).
constexpr int RUN = 8;

// A plane's frame at (log2 ny, log2 nx) with chunks of CHUNKF points and
// clusters of at most GMAX blocks: G blocks a plane, RB rows and CB columns
// a block, RC rows and CC whole columns a chunk, PC points the larger.
template <int LY, int LX, int CHUNKF_, int GMAX>
struct Frame {
  static constexpr int NY = 1 << LY, NX = 1 << LX, CHUNKF = CHUNKF_;
  static constexpr int G0 = NY * NX / CHUNKF;
  static constexpr int G = G0 < GMAX ? G0 : GMAX;   // blocks a cluster
  static constexpr int RB = NY / G;                 // rows a block
  static constexpr int CB = NX / G;                 // columns a block
  static constexpr int RC0 = CHUNKF / NX, CC0 = CHUNKF / NY;
  static constexpr int RC = RB < RC0 ? RB : RC0;    // rows a chunk
  static constexpr int CC = CB < CC0 ? CB : CC0;    // columns a chunk
  static constexpr int PC = RC * NX > CC * NY ? RC * NX : CC * NY;
};

// The int8 kernel's frame: CHUNK points a chunk, clusters of at most 16.
template <int LY, int LX>
struct ShapeT : Frame<LY, LX, CHUNK, 16> {
  using F = Frame<LY, LX, CHUNK, 16>;
  static_assert(F::G >= 2 && F::RB >= 1 && F::CB >= 1 && F::RC >= 1 &&
                    F::CC >= 1,
                "plane out of range");
  static_assert(F::RB % F::RC == 0 && F::CB % F::CC == 0,
                "chunks tile a block's share");
  static_assert(F::PC <= CHUNK && F::RC * F::NX >= 8 * NT &&
                    F::CC * F::NY >= 8 * NT,
                "a chunk fits the buffer and gives every thread a butterfly");
};

// K9's chunk at nx = 2^LX: the knob, or a whole row where that is more.
constexpr int tiled_chunk(int lx) {
  return PYFFT_TILED_CHUNK > (1 << lx) ? PYFFT_TILED_CHUNK : 1 << lx;
}

// K9's shape at (log2 ny, log2 nx): the frame on the knobs above, and
// phase 2's tiles.  Where a tile of RUN columns of the whole y axis is
// more than a chunk, it splits over a group of G2 blocks (G2 = ny*RUN /
// CHUNK, at most 8 and at most G), ny/G2 rows a block, exchanged through
// DSMEM (cluster_cols.cuh): CW = G2*CHUNK/ny columns a tile (RUN, or
// fewer where G2 is capped); G/G2 groups a cluster, each taking CG
// columns.  Else (G2 = 1) a block takes CC columns of the whole axis a
// chunk, as phase 1 takes rows.
template <int LY, int LX>
struct ShapeF : Frame<LY, LX, tiled_chunk(LX), PYFFT_TILED_GMAX> {
  using F = Frame<LY, LX, tiled_chunk(LX), PYFFT_TILED_GMAX>;
  static constexpr int G2W = F::NY * RUN / F::CHUNKF;
  static constexpr int G2C = F::G < 8 ? F::G : 8;
  static constexpr int G2 = G2W <= 1 ? 1 : (G2W < G2C ? G2W : G2C);
  static constexpr int CW =                             // columns a tile
      G2 == 1 ? F::CC : G2 * F::CHUNKF / F::NY;
  static constexpr int CG = F::NX / (F::G / G2);        // columns a group
  static constexpr int M2 = F::NY / G2;                 // rows a block
  using X = XTile<float, LY - ilog2c(G2), (G2 > 1 ? G2 : 2), CW, NT>;
  // phase 1's rows in chain_index's padded layout (against packed rows'
  // 16-way write conflicts); the chains' twiddles from five reads of
  // fifteen a radix-16 butterfly (four of seven at radix 8); the chains on
  // radix 16 (two shared-memory round trips a 1024-point chunk, three at
  // radix 8)
  static constexpr bool PAD = true, TWD = true, R16 = true;
  // phase 1's RC padded rows, the largest buffer (RC*NX = CHUNKF)
  static constexpr int SMEM =
      F::RC * (F::NX + (PAD ? F::NX / 16 : 0)) * (int)sizeof(float2);
  static_assert(F::CHUNKF <= (1 << 14) && F::CHUNKF >= 8 * NT,
                "a chunk fits the smallest plane and gives every thread a "
                "butterfly");
  static_assert(F::G >= 1 && F::RB % F::RC == 0 &&
                    F::RC * F::NX == F::CHUNKF,
                "chunks tile a block's rows");
  static_assert(G2 > 1 || (F::CC >= 1 && F::CB % F::CC == 0 &&
                           F::CC * F::NY <= F::CHUNKF &&
                           F::CC * F::NY >= 8 * NT),
                "chunks tile a block's columns");
  static_assert(G2 == 1 || (F::G % G2 == 0 && CG % CW == 0 &&
                            M2 * CW == F::CHUNKF),
                "tiles tile a group's columns");
};

// L2 eviction policies (createpolicy) and loads and stores that carry one.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ float ld_hint(const float* a, uint64_t pol) {
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(a), "l"(pol) : "memory");
  return v;
}

// through the L2 (.cg), for data other blocks wrote during the launch
__device__ __forceinline__ float ldcg_hint(const float* a, uint64_t pol) {
  float v;
  asm volatile("ld.global.cg.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(a), "l"(pol) : "memory");
  return v;
}

__device__ __forceinline__ void st_hint(float* a, float v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(a), "f"(v), "l"(pol) : "memory");
}

template <int LY, int LX>
__global__ void __launch_bounds__(NT)
    fused2d_tiled_kernel(Planes2D io, const float2* __restrict__ twy,
                         const float2* __restrict__ twx, float s) {
  using S = ShapeF<LY, LX>;
  using X = typename S::X;
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const uint64_t first = l2_evict_first(), last = l2_evict_last();
  const long long clusters = gridDim.x / S::G;

  // the clusters walk the planes: at most `clusters` planes in flight
  for (long long l = blockIdx.x / S::G; l < io.L; l += clusters) {
    const float* in_re = io.in_re + l * io.in_ls;
    const float* in_im = io.in_im + l * io.in_ls;
    float* out_re = io.out_re + l * io.out_ls;
    float* out_im = io.out_im + l * io.out_ls;

    // phase 1: the block's rows, chunk by chunk, transformed along x; the
    // input read once (evict first), the rows kept in the L2 for phase 2
    const auto load_row = [&](int r0, int c, int k) {  // row r0 + c, x = k
      const long long o = (r0 + c) * io.in_ys + k * io.in_xs;
      return make_float2(ld_hint(in_re + o, first),
                         ld_hint(in_im + o, first));
    };
    const auto store_row = [&](int r0, int c, int k, float2 v) {
      const long long o = (r0 + c) * io.out_ys + k * io.out_xs;
      st_hint(out_re + o, v.x, last);
      st_hint(out_im + o, v.y, last);
    };
    for (int r0 = rank * S::RB; r0 < (rank + 1) * S::RB; r0 += S::RC)
      chain<NT, LX, S::RC, true, 0, 1, true, true, S::PAD, S::TWD, S::R16>(
          sm, fresh(twx), s,
          [&](int c, int k) { return load_row(r0, c, k); },
          [&](int c, int k, float2 v) { store_row(r0, c, k, v); });

    // every row of the plane written before any block reads a column
    __threadfence();
    cluster.sync();

    // phase 2: the columns read back from the output through the L2 (last
    // use), transformed along y and written in place, postscale folded
    const auto load_col = [&](int c0, int c, int k) {  // column c0 + c, y = k
      const long long o = k * io.out_ys + (c0 + c) * io.out_xs;
      return make_float2(ldcg_hint(out_re + o, first),
                         ldcg_hint(out_im + o, first));
    };
    const auto store_col = [&](int c0, int c, int k, float2 v) {
      const long long o = k * io.out_ys + (c0 + c) * io.out_xs;
      st_hint(out_re + o, v.x * io.post, first);
      st_hint(out_im + o, v.y * io.post, first);
    };
    if constexpr (S::G2 == 1) {
      // the block's columns, CC a chunk, each chunk the whole y axis
      for (int c0 = rank * S::CB; c0 < (rank + 1) * S::CB; c0 += S::CC)
        chain<NT, LY, S::CC, false, 0, 1, true, true, false, S::TWD,
              S::R16>(
            sm, fresh(twy), s,
            [&](int c, int k) { return load_col(c0, c, k); },
            [&](int c, int k, float2 v) { store_col(c0, c, k, v); });
    } else {
      // the group's columns, CW a tile, each tile's y axis split over the
      // group's G2 blocks
      const int grp = rank / S::G2, gr = rank % S::G2;
      for (int c0 = grp * S::CG; c0 < (grp + 1) * S::CG; c0 += S::CW) {
        xt_load<X>(sm, gr,
                   [&](int c, int j) { return load_col(c0, c, j); });
        __syncthreads();
        xt_chain<X>(sm, fresh(twy), s);
        xt_exchange<X>(cluster, sm, fresh(twy), s, grp * S::G2, gr,
                       [&](int c, int kp, const float2* y) {
#pragma unroll
                         for (int k2 = 0; k2 < S::G2; ++k2)
                           store_col(c0, c, kp + S::M2 * k2, y[k2]);
                       });
      }
    }
  }
}

// ------------------------------------------------------ K9 + K10 (int8)

// The int8 kernel's plan at (log2 ny, log2 fy, log2 nx, log2 fx): each
// axis's wgmma stage and the shared memory, the chunk buffer (HOST bytes)
// and W's buffers after it, the larger of the two stages'.
template <int LY, int LFY, int LX, int LFX>
struct I8Plan {
  using S = ShapeT<LY, LX>;
  static constexpr int FY = 1 << LFY, FX = 1 << LFX;
  static constexpr int HOST = S::PC * (int)sizeof(float2);
  // units of at most 32 columns: 64 leave the kernel, whose chunk loop
  // holds more than K1's, too few registers (spills, serialised wgmma)
  static constexpr int NMAX = 32;
  using PlanX = TcPlan<FX, NT, S::RC * (S::NX >> LFX), HOST, false, NMAX>;
  using PlanY = TcPlan<FY, NT, S::CC * (S::NY >> LFY), HOST, false, NMAX>;
  static constexpr bool TC = tc_stage(FX, NT) && tc_stage(FY, NT);
  static constexpr int SMEM = HOST + cmax(PlanX::W_BYTES, PlanY::W_BYTES);
  static_assert(TC, "both stages on wgmma");
  static_assert(SMEM + 1024 <= 227 * 1024, "fits a block's shared memory");
};

// K9's function with the f-point int8 stage last on each axis (fy =
// 2^LFY, fx = 2^LFX); `wy`, `wx` the stages' tables, the (3, 2f, 2f) int8
// channels and then W's image (w_image_offset).
template <int LY, int LFY, int LX, int LFX>
__global__ void __launch_bounds__(NT)
    fused2d_tiled_i8_kernel(Planes2D io, const float2* __restrict__ twy,
                            const float2* __restrict__ twx, float s,
                            const int8_t* __restrict__ wy,
                            const int8_t* __restrict__ wx) {
  using S = ShapeT<LY, LX>;
  using K = I8Plan<LY, LFY, LX, LFX>;
  constexpr int NX = S::NX, NY = S::NY, RC = S::RC, CC = S::CC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[NT / 32];
  __shared__ uint64_t bars[W_BARS];
  float2* sm = reinterpret_cast<float2*>(smem_raw);
  const int8_t* wimx = wx + w_image_offset(K::FX);
  const int8_t* wimy = wy + w_image_offset(K::FY);
  WBufs w = tc_fetch_w<typename K::PlanX>(
      wimx, reinterpret_cast<int8_t*>(smem_raw + K::HOST), bars);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long l = blockIdx.x / S::G;

  const float* in_re = io.in_re + l * io.in_ls;
  const float* in_im = io.in_im + l * io.in_ls;
  float* out_re = io.out_re + l * io.out_ls;
  float* out_im = io.out_im + l * io.out_ls;

  // phase 1: the block's rows, chunk by chunk, transformed along x, the
  // int8 stage writing them to the output
  const int rend = (rank + 1) * S::RB;
  for (int r0 = rank * S::RB; r0 < rend; r0 += RC) {
    const auto load_row = [&](int c, int k) {        // row r0 + c, x = k
      const long long o = (r0 + c) * io.in_ys + k * io.in_xs;
      return make_float2(in_re[o], in_im[o]);
    };
    const auto put_row = [&](int c0, int k0, int c1, int k1, float2 re,
                             float2 im) {
      put_pair(out_re, out_im, (r0 + c0) * io.out_ys + k0 * io.out_xs,
               (r0 + c1) * io.out_ys + k1 * io.out_xs, re, im, 1.f);
    };
    if constexpr (LX == LFX) {
      for (int e = threadIdx.x; e < RC * NX; e += NT)
        sm[e] = load_row(e / NX, e % NX);
      __syncthreads();
    } else {
      lead<NT, LX, LFX, RC, true, 0, 1, true>(sm, fresh(twx), s, load_row);
    }
    using RowMap = ChainMap<NX, K::FX, RC, true, decltype(put_row)>;
    // the next call takes wx's image again: the next chunk's, or where fy
    // = fx phase 2's first
    const bool again = r0 + RC < rend || K::FX == K::FY;
    int8_stage_tc<K::FX, NT, K::HOST, K::NMAX, true>(RowMap{put_row}, sm,
                                               fresh(twx), wimx, w, red,
                                               again);
    __syncthreads();    // the stage's reads done before the next chunk
  }
  if constexpr (K::FX != K::FY) tc_issue_w<typename K::PlanY>(wimy, w);

  // every row of the plane written before any block reads a column
  __threadfence();
  cluster.sync();

  // phase 2: the block's columns, chunk by chunk, read back from the
  // output through the L2, transformed along y, the int8 stage writing
  // them in place
  const int cend = (rank + 1) * S::CB;
  for (int c0 = rank * S::CB; c0 < cend; c0 += CC) {
    const auto load_col = [&](int c, int k) {        // column c0 + c, y = k
      const long long o = k * io.out_ys + (c0 + c) * io.out_xs;
      return make_float2(__ldcg(out_re + o), __ldcg(out_im + o));
    };
    const auto put_col = [&](int ca, int ka, int cb, int kb, float2 re,
                             float2 im) {
      put_pair(out_re, out_im, ka * io.out_ys + (c0 + ca) * io.out_xs,
               kb * io.out_ys + (c0 + cb) * io.out_xs, re, im, io.post);
    };
    if constexpr (LY == LFY) {
      for (int e = threadIdx.x; e < CC * NY; e += NT)
        sm[e] = load_col(e % CC, e / CC);
      __syncthreads();
    } else {
      lead<NT, LY, LFY, CC, false, 0, 1, true>(sm, fresh(twy), s, load_col);
    }
    using ColMap = ChainMap<NY, K::FY, CC, false, decltype(put_col)>;
    int8_stage_tc<K::FY, NT, K::HOST, K::NMAX, true>(ColMap{put_col}, sm,
                                               fresh(twy), wimy, w, red,
                                               c0 + CC < cend);
    __syncthreads();
  }
}

// The planes K9 keeps in flight at (log2 ny, log2 nx): PYFFT_TILED_PLANES,
// or the current card's L2 (cudaDevAttrL2CacheSize) over a plane's bytes
// (its intermediate, 8 a point), at least 1; a negative cudaError_t where
// the query fails.
long long planes_cap(int ly, int lx) {
  if (PYFFT_TILED_PLANES > 0) return PYFFT_TILED_PLANES;
  int dev = 0, l2 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return -(long long)e;
  const long long cap = (long long)l2 / (8LL << (ly + lx));
  return cap > 1 ? cap : 1;
}

template <int LY, int LX>
cudaError_t launch(const Planes2D& io, const float2* twy, const float2* twx,
                   float s, cudaStream_t stream) {
  using S = ShapeF<LY, LX>;
  const long long cap = planes_cap(LY, LX);
  if (cap < 0) return static_cast<cudaError_t>(-cap);
  return launch_cluster<NT>(fused2d_tiled_kernel<LY, LX>,
                            io.L < cap ? io.L : cap, S::G, S::SMEM, stream,
                            io, twy, twx, s);
}

// (log2 ny, log2 nx) -> launch<LY, LX>, for 7 <= each <= 13 and a sum of
// at most 20: the 28 plane shapes.
#define PYFFT_TILED_CASES(X)                                               \
  X(7, 7) X(7, 8) X(7, 9) X(7, 10) X(7, 11) X(7, 12) X(7, 13) X(8, 7)      \
  X(8, 8) X(8, 9) X(8, 10) X(8, 11) X(8, 12) X(9, 7) X(9, 8) X(9, 9)       \
  X(9, 10) X(9, 11) X(10, 7) X(10, 8) X(10, 9) X(10, 10) X(11, 7) X(11, 8) \
  X(11, 9) X(12, 7) X(12, 8) X(13, 7)

cudaError_t dispatch(int ly, int lx, const Planes2D& io, const float2* twy,
                     const float2* twx, float s, cudaStream_t st) {
#define PYFFT_CASE(a, b) \
  if (ly == a && lx == b) return launch<a, b>(io, twy, twx, s, st);
  PYFFT_TILED_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return cudaErrorInvalidValue;
}

// (log2 ny, log2 fy, log2 nx, log2 fx) of the int8 kernel: each of K9's
// shapes with f the last factor of col_factors on each axis (128 at 128 and
// 512, 32 at 256, 64 at 1024 to 4096, 128 at 8192).
#define PYFFT_TILED_I8_CASES(X)                                              \
  X(7, 7, 7, 7) X(7, 7, 8, 5) X(7, 7, 9, 7) X(7, 7, 10, 6) X(7, 7, 11, 6)     \
  X(7, 7, 12, 6) X(7, 7, 13, 7) X(8, 5, 7, 7) X(8, 5, 8, 5) X(8, 5, 9, 7)     \
  X(8, 5, 10, 6) X(8, 5, 11, 6) X(8, 5, 12, 6) X(9, 7, 7, 7) X(9, 7, 8, 5)    \
  X(9, 7, 9, 7) X(9, 7, 10, 6) X(9, 7, 11, 6) X(10, 6, 7, 7) X(10, 6, 8, 5)   \
  X(10, 6, 9, 7) X(10, 6, 10, 6) X(11, 6, 7, 7) X(11, 6, 8, 5) X(11, 6, 9, 7) \
  X(12, 6, 7, 7) X(12, 6, 8, 5) X(13, 7, 7, 7)

cudaError_t dispatch_i8(int ly, int lfy, int lx, int lfx, const Planes2D& io,
                        const float2* twy, const float2* twx, float s,
                        const int8_t* wy, const int8_t* wx,
                        cudaStream_t st) {
#define PYFFT_CASE(a, fa, b, fb)                                           \
  if (ly == a && lfy == fa && lx == b && lfx == fb)                        \
    return launch_cluster<NT>(fused2d_tiled_i8_kernel<a, fa, b, fb>, io.L, \
                              ShapeT<a, b>::G, I8Plan<a, fa, b, fb>::SMEM, \
                              st, io, twy, twx, s, wy, wx);
  PYFFT_TILED_I8_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The stage the int8 kernel runs at (log2 ny, log2 nx): 1 the wgmma stage
// on both axes, 0 the mma.sync one, -1 where no int8 kernel is
// instantiated.
extern "C" int pyfft_fused2d_tiled_i8_stage(int log2ny, int log2nx) {
#define PYFFT_CASE(a, fa, b, fb) \
  if (log2ny == a && log2nx == b) return I8Plan<a, fa, b, fb>::TC ? 1 : 0;
  PYFFT_TILED_I8_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return -1;
}

// The cluster size (blocks a plane) at (log2 ny, log2 nx), 0 outside the
// kernel's range: for the wrapper's checks and the records.
extern "C" int pyfft_fused2d_tiled_cluster(int log2ny, int log2nx) {
#define PYFFT_CASE(a, b) \
  if (log2ny == a && log2nx == b) return ShapeF<a, b>::G;
  PYFFT_TILED_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return 0;
}

// K9's shape at (log2 ny, log2 nx) into out[0..6]: G (blocks a cluster),
// RC (rows a phase-1 chunk), G2 (blocks a phase-2 group, 1 where a block
// takes whole columns), CW (columns a phase-2 tile: the run of each plane
// it reads and writes, in floats), the planes in flight on the current
// card (planes_cap), the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) and the chunk's points.  Returns 0, or
// a cudaError_t.
extern "C" int pyfft_fused2d_tiled_shape(int log2ny, int log2nx,
                                         long long* out) {
#define PYFFT_CASE(a, b)                                                  \
  if (log2ny == a && log2nx == b) {                                       \
    using S = ShapeF<a, b>;                                               \
    const long long cap = planes_cap(a, b);                               \
    const int held = pyfft::max_clusters<NT>(fused2d_tiled_kernel<a, b>,  \
                                             S::G, S::SMEM);              \
    if (cap < 0) return (int)-cap;                                        \
    if (held < 0) return -held;                                           \
    const long long v[7] = {S::G, S::RC, S::G2, S::CW, cap, held,         \
                            S::CHUNKF};                                   \
    for (int i = 0; i < 7; ++i) out[i] = v[i];                            \
    return 0;                                                             \
  }
  PYFFT_TILED_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return (int)cudaErrorInvalidValue;
}

// Launches the 2D DFT on `stream` without synchronising.  `twy` and `twx`
// hold ny and nx (cos, sin) float pairs of sign*2*pi*k/n.  `dims` holds 7
// int64 values: L, the input strides (l, y, x) and the output strides
// (l, y, x), in floats.  Returns the launch's cudaError_t (0 on success).
extern "C" int pyfft_fused2d_tiled(const void* in_re, const void* in_im,
                                   void* out_re, void* out_im,
                                   const void* twy, const void* twx,
                                   const long long* dims, int log2ny,
                                   int log2nx, int sign, float postscale,
                                   void* stream) {
  const Planes2D io = planes_2d(in_re, in_im, out_re, out_im, dims, postscale);
  if (io.L <= 0) return (int)cudaErrorInvalidValue;
  const float s = sign < 0 ? -1.f : 1.f;
  return (int)dispatch(log2ny, log2nx, io, static_cast<const float2*>(twy),
                       static_cast<const float2*>(twx), s,
                       static_cast<cudaStream_t>(stream));
}

// K9 + K10: as pyfft_fused2d_tiled with the f-point int8 stage last on
// each axis, fy = 2^log2fy and fx = 2^log2fx (see PYFFT_TILED_I8_CASES);
// `wchy` and `wchx` hold the stages' channels, (3, 2f, 2f) int8
// C-contiguous each, followed by their shared-memory image (ops/int8.py
// `w_tables`).
extern "C" int pyfft_fused2d_tiled_i8(const void* in_re, const void* in_im,
                                      void* out_re, void* out_im,
                                      const void* twy, const void* twx,
                                      const void* wchy, const void* wchx,
                                      const long long* dims, int log2ny,
                                      int log2fy, int log2nx, int log2fx,
                                      int sign, float postscale,
                                      void* stream) {
  const Planes2D io = planes_2d(in_re, in_im, out_re, out_im, dims, postscale);
  if (io.L <= 0) return (int)cudaErrorInvalidValue;
  const float s = sign < 0 ? -1.f : 1.f;
  return (int)dispatch_i8(log2ny, log2fy, log2nx, log2fx, io,
                          static_cast<const float2*>(twy),
                          static_cast<const float2*>(twx), s,
                          static_cast<const int8_t*>(wchy),
                          static_cast<const int8_t*>(wchx),
                          static_cast<cudaStream_t>(stream));
}
