// K10: the int8-split DFT stage, complex64: a policy of the row kernels
// (K1 and the interleaved K2, local_rows.cu), of the column kernel (K5)
// and the digit-swapped row pass (K4, both local_cols.cu), and of the
// fused 2D kernels (K8, fused2d.cu, and K9, fused2d_tiled.cu).
//
// Replaces pyfft_tpu/ops/pallas_local.py `_int8_stage`, the matrix stage
// of the JAX package's tile FFT under precision="int8" (inside the Pallas
// kernels `_kernel`, `_col_kernel`, `_row_swap_kernel`, `_col_fold_kernel`,
// `_fused2d_kernel` and `_fused2d_tiled_kernel`).  It computes the last
// stage of a Stockham chain, an f-point DFT (f = 16, 32, 64 or 128) over
// the block's data in shared memory, as exact integer products on the
// int8 tensor cores:
//
//   1. the twiddle of the stage, x[j + r*NS] *= w_N^(j*r), in place, and
//      amax, the largest |re|, |im| of the twiddled block (warp shuffles,
//      then shared memory): the alignment exponent
//      m = clip(biased_exp(amax) - 126, -40, 120).  The alignment group is
//      the data of one call: RPB rows in K1, C columns (rows in K4) of one
//      l in K5, a block's rows or columns of one plane in K8, a chunk's in
//      K9, each a subset of one JAX block, so the scale is never coarser
//      than JAX's;
//   2. each column (a run j of one row, or of one column c) is the 2f-long
//      vector [xr; xi], split into 4 int8 channels by progressive
//      extraction at shifts 7, 14, 21, 28 below 2^m (round half even, clip
//      to +-127, every step exact in float), cut in registers right where
//      each B fragment is built, with no int8 copy of the block;
//   3. the stacked matrix [[Wr, -Wi], [Wi, Wr]] (2f x 2f) comes as 3 int8
//      channels at shifts 7, 14, 21, built on the host (ops/int8.py) and
//      read as A fragments from global memory: the table is common to all
//      blocks and stays in L2 (3 * 256 * 256 B at f = 128 would not fit in
//      shared memory beside K5's data);
//   4. the 9 channel pairs whose shifts sum to at most 35 run as
//      mma.sync.m16n8k32 s8 x s8 -> s32 (M = K = 2f, N = the block's
//      columns), one shift group at a time into one int32 accumulator
//      (each group's sum stays below 2^24, so its conversion is exact),
//      recombined in float as acc += float(group) * 2^(m - s) in ascending
//      s, the JAX package's order.
//
// The stage's outputs y[k] of column j land at j + k*NS, natural order, as
// the radix-8 stages' do.  A warp takes one 8-column tile at a time (and a
// share of the 16-row tiles of the output where the block has fewer tiles
// than warps): it builds the B fragments of all 4 channels for its columns
// once, then runs every (row tile, shift group, channel pair, k tile).
//
// What bounds it on an H100: at config 2 (4096 x 4096, f = 64) the stage
// is 72*f = 4608 int8 operations a complex point, 7.7e10 in all, 0.04 ms at
// the published 1979 TOPS, below the 0.09 ms of the copy: bytes, for a
// kernel that reaches the tensor cores' rate.  This first version does not:
// mma.sync with A from global memory and B cut from float in registers
// issues far more instructions than the products need.  It is the simple
// correct version; its time is in PERF.md.
//
// A Map gives the stage its block's addressing:
//   Map::Q                         the columns of the block
//   int index(int q, int r)        where element r of column q lies in sm
//   int jof(int q)                 the column's j, for the twiddle
//   void put(int q, int k, int part, float v)
//                                  write output row k of column q (part 0
//                                  the real, 1 the imaginary value)
//
// IN_PLACE: put writes the slots the stage reads (K8's rows, which stay in
// shared memory for the cluster's exchange and leave no room for a second
// buffer at 2^18 points a plane).  Output k of column q lands in the slot
// of its input k, so a unit's writes touch its own columns only; where
// several warps share an 8-column tile (MSPLIT > 1, one unit a warp at
// most) a block barrier parts the building of every B fragment from the
// first write.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

// The (log2 n, log2 f) pairs of the JAX row and column chains that hold a
// matrix stage: f = n up to 128, then f the chain's last factor (the row
// chain ends in 64 at n = 256, the column chain in 32).  X(LN, LF) for each.
// The hosts that take JAX's default chain (K4, K2) add its one other pair,
// (11, 7), in their entries.
#define PYFFT_I8_CHAINS(X)                                                 \
  X(4, 4) X(5, 5) X(6, 6) X(7, 7) X(8, 6) X(8, 5) X(9, 7) X(10, 6) X(11, 6) \
  X(12, 6) X(13, 7)

namespace pyfft {

// 2^e for e in float's normal range, exactly, from the bits.
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// The largest v over the block, in every thread.  `red` holds one float a
// warp; NT is a multiple of 32.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// d += a * b, one 16x8x32 int8 tile (a row-major, b column-major).
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The f-point int8-split stage over the block's data in `sm` (float2,
// written by the previous stage and visible to all threads), F = f, NT the
// block's threads, `tw` the n-point twiddle table, `wch` the 3 (2F x 2F)
// int8 channels of the stacked matrix, `red` NT/32 floats of scratch.
template <int F, int NT, class Map, bool IN_PLACE = false>
__device__ __forceinline__ void int8_stage(const Map& map, float2* sm,
                                           const float2* __restrict__ tw,
                                           const int8_t* __restrict__ wch,
                                           float* red) {
  constexpr int Q = Map::Q;             // columns
  constexpr int P = Q * F;              // points
  constexpr int K2 = 2 * F;             // stacked length
  constexpr int KT = K2 / 32;           // k tiles
  constexpr int MT = K2 / 16;           // output row tiles
  constexpr int NW = NT / 32;           // warps
  constexpr int NTILE = (Q + 7) / 8;    // 8-column tiles
  constexpr int MSPLIT = NTILE >= NW ? 1 : (MT < NW / NTILE ? MT : NW / NTILE);
  constexpr int MPU = MT / MSPLIT;      // row tiles a unit
  constexpr int UNITS = NTILE * MSPLIT;
  constexpr bool SYNC = IN_PLACE && MSPLIT > 1;   // warps share columns
  static_assert(NT % 32 == 0 && F % 16 == 0 && MT % MSPLIT == 0,
                "the stage tiles the block");
  static_assert(!SYNC || UNITS <= NW, "one unit a warp where warps share");

  // 1. twiddle in place, and the block's largest magnitude
  float amax = 0.f;
  for (int e = threadIdx.x; e < P; e += NT) {
    const int q = e % Q, r = e / Q;
    const int i = map.index(q, r);
    float2 v = sm[i];
    const int jr = map.jof(q) * r;
    if (jr) {
      v = cmul(v, __ldg(&tw[jr]));
      sm[i] = v;
    }
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  amax = block_max<NT>(amax, red);      // its barrier publishes the twiddle
  int m = ((__float_as_int(amax) >> 23) & 0xFF) - 126;
  m = m < -40 ? -40 : (m > 120 ? 120 : m);
  float inv[4], sh[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    inv[c] = exp2i(7 * (c + 1) - m);
    sh[c] = exp2i(m - 7 * (c + 1));
  }

  // 2-4. the products, a unit (8 columns, MPU row tiles) at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int u = warp; u < (SYNC ? NW : UNITS); u += NW) {
    const bool live = !SYNC || u < UNITS;   // every warp meets the barrier
    const int nt = u % NTILE, mt0 = (u / NTILE) * MPU;
    const int q = nt * 8 + g;           // this lane's column in B
    unsigned bf[KT][4][2];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = kt * 32 + h * 16 + t4 * 4 + i;   // stacked row
          float x = 0.f;
          if (live && q < Q) {
            const float2 v = sm[map.index(q, kk % F)];
            x = kk < F ? v.x : v.y;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float ch = fminf(fmaxf(rintf(x * inv[c]), -127.f), 127.f);
            x = x - ch * sh[c];
            packed[c] |= ((unsigned)(int)ch & 0xFFu) << (8 * i);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) bf[kt][c][h] = packed[c];
      }
    }
    if constexpr (SYNC) __syncthreads();
    else if constexpr (IN_PLACE) __syncwarp();
    if (!live) continue;
#pragma unroll 1
    for (int mt = mt0; mt < mt0 + MPU; ++mt) {
      float acc[4];
#pragma unroll
      for (int s = 2; s <= 5; ++s) {    // shift sum 7*s: 14, 21, 28, 35
        int d[4] = {0, 0, 0, 0};
#pragma unroll
        for (int wi = 0; wi < 3; ++wi) {
          const int xc = s - 2 - wi;    // W shift 7(wi+1) + x shift 7(xc+1)
          if (xc < 0 || xc > 3) continue;
          const int8_t* w = wch + wi * K2 * K2 + (mt * 16 + g) * K2 + t4 * 4;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            const int8_t* a = w + kt * 32;
            const int af[4] = {
                __ldg(reinterpret_cast<const int*>(a)),
                __ldg(reinterpret_cast<const int*>(a + 8 * K2)),
                __ldg(reinterpret_cast<const int*>(a + 16)),
                __ldg(reinterpret_cast<const int*>(a + 8 * K2 + 16))};
            mma_s8(d, af, bf[kt][xc]);
          }
        }
        const float sc = exp2i(m - 7 * s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = s == 2 ? (float)d[i] * sc : acc[i] + (float)d[i] * sc;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mt * 16 + g + (i >= 2 ? 8 : 0);
        const int qq = nt * 8 + t4 * 2 + (i & 1);
        if (qq < Q) map.put(qq, row % F, row / F, acc[i]);
      }
    }
  }
}

}  // namespace pyfft
