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
//      to +-127, every step exact in float);
//   3. the stacked matrix [[Wr, -Wi], [Wi, Wr]] (2f x 2f) comes as 3 int8
//      channels at shifts 7, 14, 21, built on the host (ops/int8.py);
//   4. the 9 channel pairs whose shifts sum to at most 35 run as s8 x s8 ->
//      s32 products (M = K = 2f, N = the block's columns), one shift group
//      at a time into one int32 accumulator (each group's sum stays below
//      2^24, so its conversion is exact), recombined in float as
//      acc += float(group) * 2^(m - s) in ascending s, the JAX package's
//      order.
//
// The stage's outputs y[k] of column j land at j + k*NS, natural order, as
// the radix-8 stages' do.  It comes in two versions, which compute the
// same bits (integer sums do not depend on the order of the products, and
// every float step is the same operation in the same order):
//
// int8_stage_tc, the stage on wgmma, wherever the block has a warpgroup
// (128 threads) and f >= 32 (tc_stage below): the row kernels at n >= 1024,
// the column kernel (K5, the fold, K4) at every f but 16, and the fused 2D
// kernels K8 and K9 (512 threads, f >= 32 at every shape).
//   * W's channels come as an image in shared memory, laid out by the host
//     (ops/int8.py `w_image`) in wgmma's K-major core matrices (8 rows of
//     16 bytes, no swizzle), in slabs of 64 output rows (3 channels each:
//     3 * 64 * 2f bytes), each slab the real and imaginary rows of 32
//     outputs (`w_rows`).  One bulk asynchronous copy a slab, issued at
//     kernel entry on an mbarrier, lands while the radix-2/4/8 lead stages
//     run.  At f <= 64 the whole image stays (48 KB at f = 64); at f = 128
//     (192 KB) the slabs stream through one or two buffers of 48 KB, two
//     where the second costs the SM no block (TcPlan::NBUF), each slab
//     applied to all the block's columns and all 4 x channels before the
//     next comes.  W is read from device memory once a call (once a block
//     where the image stays).  A host that calls the stage more than once
//     (K8's two axes, K9's chunks) carries the barriers' state from call to
//     call in a WBufs: a copy is waited for once, on the parity of its own
//     phase, and a resident image is not copied again.
//   * x is cut once: each thread reads 16 values of one column (two such
//     runs where the block has more than one a thread: K8's 2^18-point
//     planes), twiddles them in registers, and after the barrier that
//     gives the block's amax writes their 4 channels (real and imaginary
//     halves) into the float buffer's place, in the B operand's K-major
//     core matrices: 8 bytes a complex point, the float2's own size.
//   * The products are wgmma.mma_async m64nNk32 s8 with A (a W slab) and B
//     (one x channel) both from shared memory: a warpgroup takes one m64
//     tile and N = NCH of the block's columns (8 to 64; 32 for a streamed
//     slab), runs each shift group's pairs and k32 steps into one int32
//     accumulator, converts it and adds it in float.  Its fragments leave
//     through Map::put2, both parts of an output for two columns a store.
//     The row kernels, K4 + K10, K9 and K8's second axis write device
//     memory; the column kernel and K8's first axis hold their outputs in
//     registers and write them over x's channels after the last product
//     (Map::INTO_X), so they need no second buffer.
// int8_stage, the first version, on mma.sync.m16n8k32 s8 with W's A
// fragments read from global memory through L1 and x's B fragments cut in
// registers: kept where wgmma does not apply, by the hosts' compile-time
// choice (tc_stage): the row kernels at n <= 512 (64 threads a block) and f
// = 16 in every host.  A warp takes one 8-column tile at a time (and a
// share of the 16-row tiles of the output where the block has fewer tiles
// than warps): it builds the B fragments of all 4 channels for its columns
// once, then runs every (row tile, shift group, channel pair, k tile).
//
// What bounds it on an H100: at config 2 (4096 x 4096, f = 64) the stage
// is 72*f = 4608 int8 operations a complex point, 7.7e10 in all, 0.04 ms at
// the published 1979 TOPS, below the 0.09 ms of the copy: bytes, for a
// kernel that reaches the tensor cores' rate.  The mma.sync version reads
// W's channels again for every 8 columns, 4.5*f bytes of L2 traffic a
// point (288 B at f = 64), and is bound by that.  The wgmma version reads
// W from device memory once a block, 12*f/Q bytes a point (12-24 B at Q =
// 64); its products read both operands from shared memory, and a unit N
// columns wide reads the slab's A tile (2 KB a k32 step) for only those N,
// so units of 16 columns are bound by shared memory at about 2.5 times
// the tensor cores' time.  Times in PERF.md.
//
// A Map gives the stage its block's addressing:
//   Map::Q                         the columns of the block
//   int index(int q, int r)        where element r of column q lies in sm
//   int jof(int q)                 the column's j, for the twiddle
//   void put(int q, int k, int part, float v)
//                                  write output row k of column q (part 0
//                                  the real, 1 the imaginary value)
//   void put2(int q, int k, float2 re, float2 im)   (int8_stage_tc)
//                                  write output k of columns q and q + 1
//   Map::INTO_X                    (int8_stage_tc) put2 writes where x's
//                                  channels lie
//   Map::GROUPS                    the block holds several alignment
//                                  groups (K4 + K10, whose block of rows
//                                  may span several of JAX's `lanes`-row
//                                  groups): then
//   int group(int q)               the group of column q, below 128, and
//   unsigned* gmax                 one zeroed slot a group in shared
//                                  memory, where the stage takes each
//                                  group's amax (its bits: a float >= 0
//                                  orders as its bits do)

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

// The alignment exponent of a group whose largest magnitude is amax:
// clip(biased_exp(amax) - 126, -40, 120).
__device__ __forceinline__ int align_exp(float amax) {
  const int m = ((__float_as_int(amax) >> 23) & 0xFF) - 126;
  return m < -40 ? -40 : (m > 120 ? 120 : m);
}

// The exponent of column q's group, after the stage has taken every
// group's amax into map.gmax and a barrier has published it.
template <class Map>
__device__ __forceinline__ int group_exp(const Map& map, int q) {
  return align_exp(__uint_as_float(map.gmax[map.group(q)]));
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
template <int F, int NT, class Map>
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
  static_assert(NT % 32 == 0 && F % 16 == 0 && MT % MSPLIT == 0,
                "the stage tiles the block");

  // 1. twiddle in place, and the block's (each group's) largest magnitude
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
    const float a = fmaxf(fabsf(v.x), fabsf(v.y));
    if constexpr (Map::GROUPS)
      atomicMax(&map.gmax[map.group(q)], __float_as_uint(a));
    else
      amax = fmaxf(amax, a);
  }
  int m = 0;
  if constexpr (Map::GROUPS)
    __syncthreads();                    // publishes the twiddle and gmax
  else
    m = align_exp(block_max<NT>(amax, red));   // its barrier publishes them
  // column q's exponent
  const auto mof = [&](int q) {
    if constexpr (Map::GROUPS) return q < Q ? group_exp(map, q) : 0;
    else return m;
  };

  // 2-4. the products, a unit (8 columns, MPU row tiles) at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int u = warp; u < UNITS; u += NW) {
    const int nt = u % NTILE, mt0 = (u / NTILE) * MPU;
    const int q = nt * 8 + g;           // this lane's column in B
    float inv[4], sh[4];
    {
      const int mq = mof(q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        inv[c] = exp2i(7 * (c + 1) - mq);
        sh[c] = exp2i(mq - 7 * (c + 1));
      }
    }
    // the exponents of this lane's two output columns
    const int mo[2] = {mof(nt * 8 + t4 * 2), mof(nt * 8 + t4 * 2 + 1)};
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
          if (q < Q) {
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sc = exp2i(mo[i & 1] - 7 * s);
          acc[i] = s == 2 ? (float)d[i] * sc : acc[i] + (float)d[i] * sc;
        }
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

// ------------------------------------------------- the stage on wgmma

// Whether a host block of nt threads runs the f-point stage on wgmma: a
// warpgroup (128 threads) and M = 2f of at least one m64 tile.
__host__ __device__ constexpr bool tc_stage(int f, int nt) {
  return nt >= 128 && f >= 32;
}

// Where the shared-memory image of W (ops/int8.py `w_image`) starts in the
// table the hosts are handed: after the 3 (2f x 2f) channels that
// int8_stage reads.
__host__ __device__ constexpr int w_image_offset(int f) { return 12 * f * f; }

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Blocks of nt threads and `bytes` of shared memory an SM holds at once
// (228 KB a SM, 1 KB of it reserved a block).
constexpr int sm_blocks(int nt, int bytes) {
  return cmin(2048 / nt, 233472 / (bytes + 1024));
}

// The wgmma stage's shape in a block of NT threads whose Map has Q columns
// and whose host keeps HOST bytes of shared memory of its own (W's buffers
// follow them).  HOLD: the Map's outputs take x's place (Map::INTO_X), so
// a warpgroup holds them in registers until the last phase.  NMAX: the
// widest unit, 64 columns, or 32 where the host needs the registers (K9).
template <int F, int NT, int Q, int HOST, bool HOLD = false, int NMAX = 64>
struct TcPlan {
  static constexpr int K2 = 2 * F;                   // stacked length: M = K
  static constexpr int MT = cmax(K2 / 64, 1);        // m64 tiles, a slab each
  static constexpr int KT = K2 / 32;                 // k32 steps
  static constexpr int SLAB = 3 * 64 * K2;           // bytes of one slab
  static constexpr bool STREAM = MT > 2;             // f = 128
  // slab buffers: the whole image, or two where the second costs no block
  static constexpr int NBUF =
      !STREAM ? MT
              : (sm_blocks(NT, HOST + 2 * SLAB) >= sm_blocks(NT, HOST + SLAB)
                     ? 2 : 1);
  static constexpr int W_BYTES = NBUF * SLAB;
  static constexpr int NWG = cmax(NT / 128, 1);      // warpgroups
  static constexpr int MTP = STREAM ? 1 : MT;        // m64 tiles a phase
  static constexpr int PHASES = MT / MTP;
  // columns a unit (one warpgroup's m64 x NCH tile): the phase's tiles
  // shared out over the warpgroups, 8 to NMAX columns; a streamed slab that
  // holds nothing goes to units of 32, fewer and wider (each re-reads the
  // slab's A tile from shared memory: PERF.md)
  static constexpr int NCH = STREAM && !HOLD
                                 ? cmin(Q, 32)
                                 : cmin(cmin(cmax(Q * MTP / NWG, 8), NMAX), Q);
  static constexpr int UNITS = MTP * (Q / NCH);
  static constexpr int UPW = (UNITS + NWG - 1) / NWG;   // units a warpgroup
  static constexpr int XUNITS = Q * F / 16;          // 16-value runs to cut
  static constexpr int RUNS = (XUNITS + NT - 1) / NT;   // runs a thread
  static_assert(!tc_stage(F, NT) ||
                    (NT % 128 == 0 && Q % NCH == 0 && NCH % 8 == 0 &&
                     RUNS <= 2 && HOST % 16 == 0 &&
                     (!STREAM || UNITS <= NWG) &&
                     (!HOLD || UNITS % NWG == 0 || UNITS < NWG)),
                "the wgmma stage tiles the block");
};

// The barriers W's slab buffers complete on (one a buffer, at most two).
constexpr int W_BARS = 2;

// W's slab buffers in shared memory and the state of their barriers, the
// same in every thread: bit b of `pend` says a copy into buffer b has been
// issued and not yet waited for, bit b of `par` the parity of that copy's
// phase of bars[b] (each copy completes one phase).  A host that calls the
// stage more than once keeps one WBufs across the calls.
struct WBufs {
  int8_t* sm;
  uint64_t* bars;
  unsigned pend, par;
};

// Shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(1) : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`'s current phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// wgmma's shared-memory descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes), the two of a
// k32 step 128 bytes apart (LBO), the next 8 rows `sbo` bytes on.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keep the compiler from moving a register's uses across the asynchronous
// products that write it.
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// v, opaque to the compiler: what is derived from it is computed where it
// is used, not hoisted out of a host's calls of the stage (K9's chunk
// loop, K8's two axes) and held in registers across them, which spills.
template <typename T>
__device__ __forceinline__ T opaque(T v) {
  asm volatile("" : "+l"(v));
  return v;
}
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// d += a * b, one m64nNk32 s8 x s8 -> s32 product, both operands from
// shared memory (descriptors); d holds N/2 registers a thread.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Start the copies of W's first NBUF slabs from `wimg` (the image, 16-byte
// aligned) into the buffers: thread 0 issues them, every thread marks them
// pending.  The buffers' last readers must be past a block barrier.
template <class Plan>
__device__ __forceinline__ void tc_issue_w(const int8_t* wimg, WBufs& w) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < Plan::NBUF; ++b)
      bulk_load(w.sm + b * Plan::SLAB, wimg + b * Plan::SLAB, Plan::SLAB,
                &w.bars[b]);
  }
  w.pend |= (1u << Plan::NBUF) - 1u;
}

// At kernel entry: thread 0 sets up the W_BARS barriers at `bars` and
// starts the copies of W's first NBUF slabs into `wsm`.  The stage's first
// barrier (step 1's) makes the set-up visible to every thread before any
// waits on it.
template <class Plan>
__device__ __forceinline__ WBufs tc_fetch_w(const int8_t* wimg, int8_t* wsm,
                                            uint64_t* bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < W_BARS; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  WBufs w{wsm, bars, 0u, 0u};
  tc_issue_w<Plan>(wimg, w);
  return w;
}

// Wait for the copy into buffer b, if one is pending.
__device__ __forceinline__ void tc_wait_w(WBufs& w, int b) {
  if ((w.pend >> b) & 1u) {
    mbar_wait(&w.bars[b], (w.par >> b) & 1u);
    w.par ^= 1u << b;
    w.pend &= ~(1u << b);
  }
}

// Round, clamp and pack one channel value: with t = y + RND, RND =
// 1.5 * 2^23, t - RND is rintf(y) (round half even) wherever |y| < 2^22,
// and clamping t to RND +- 127 clamps it to +-127 for every y, as int8_stage's
// fminf(fmaxf(rintf(y), -127), 127) does; t's low byte is then the int8.
// Full-rate adds in place of a rounding and a float-to-int conversion.
constexpr float RND = 12582912.f;

// The f-point int8-split stage on wgmma over the block's data in `sm`
// (float2, written by the previous stage and visible to all threads).  F =
// f, NT the block's threads, HOST the host's own shared-memory bytes (see
// TcPlan), `tw` the n-point twiddle table, `wimg` W's image in device
// memory, `w` its buffers in shared memory (tc_fetch_w or tc_issue_w
// started the copies of its first slabs, or, at f <= 64, an earlier call
// left the same image there), `red` NT/32 floats of scratch.  `again`
// (f = 128): the next call takes the same image, so this one starts the
// copies of its first slabs as its own last ones are done.  The float
// buffer is overwritten with x's channels; the Map's put2 writes
// elsewhere, or (Map::INTO_X) into the float buffer's place once every
// product is done.  put2(q, k, re, im) writes output k of columns q and q +
// 1 (q even): re = (real of q, real of q+1), im likewise.  NMAX as
// TcPlan's.  FRESH: the host calls the stage more than once, so the thread
// index and the descriptors' bases are made opaque at each call.
template <int F, int NT, int HOST, int NMAX = 64, bool FRESH = false,
          class Map>
__device__ __forceinline__ void int8_stage_tc(const Map& map, float2* sm,
                                              const float2* __restrict__ tw,
                                              const int8_t* __restrict__ wimg,
                                              WBufs& w, float* red,
                                              bool again = false) {
  constexpr int Q = Map::Q;             // columns
  using Plan = TcPlan<F, NT, Q, HOST, Map::INTO_X, NMAX>;
  constexpr int K2 = Plan::K2;
  constexpr int SBO = 8 * K2;           // bytes between 8-row core groups
  constexpr int NCH = Plan::NCH;
  constexpr int RUNS = Plan::RUNS;
  static_assert(tc_stage(F, NT), "the wgmma stage needs a warpgroup, f>=32");

  // 1-2. x cut once.  Run u (u < XUNITS) is elements r0..r0+15 of column
  // q = u % Q, r0 = (u / Q) * 16; thread e takes runs e and, where RUNS =
  // 2, e + NT.  It twiddles a run in registers (x[j + r*NS] *= w_N^(j*r),
  // as int8_stage does in place), and the block's (each group's) largest
  // magnitude gives m.  After that barrier it writes the 16 bytes of each
  // channel of its real and of its imaginary half (stacked rows r0 + i and
  // F + r0 + i) over the float buffer, in B's core matrices: channel c of
  // column q, stacked row kk at c*K2*Q + (q/8)*SBO + (kk/16)*128 + (q%8)*16
  // + kk%16.  With two runs a thread the first pass only takes the amax;
  // the second reads and twiddles each run again (the same products of the
  // same values, so the same bits), cuts both, and a barrier ends every
  // read of the float buffer before the channels overwrite it.
  int8_t* xs = reinterpret_cast<int8_t*>(sm);
  const unsigned tid =
      FRESH ? static_cast<unsigned>(opaque(static_cast<int>(threadIdx.x)))
            : threadIdx.x;
  int m = 0;
  {
    const auto load_run = [&](int u, float2 (&v)[16]) {
      const int q = u % Q, r0 = (u / Q) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] = make_float2(0.f, 0.f);
        if (u < Plan::XUNITS) {
          v[i] = sm[map.index(q, r0 + i)];
          const int jr = map.jof(q) * (r0 + i);
          if (jr) v[i] = cmul(v[i], __ldg(&tw[jr]));
        }
      }
    };
    const auto run_max = [](const float2 (&v)[16]) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        a = fmaxf(a, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));
      return a;
    };
    // channel c of part `part` (real, imaginary), bytes 4i..4i+3 of 16
    using Cut = unsigned[2][4][4];
    const auto cut_run = [&](const float2 (&v)[16], int mq, Cut& wd) {
      float inv[4], sh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        inv[c] = exp2i(7 * (c + 1) - mq);
        sh[c] = exp2i(mq - 7 * (c + 1));
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wd[part][c][0] = wd[part][c][1] = wd[part][c][2] = wd[part][c][3] =
              0u;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float x = part ? v[i].y : v[i].x;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float t =
                fminf(fmaxf(x * inv[c] + RND, RND - 127.f), RND + 127.f);
            x = x - (t - RND) * sh[c];
            wd[part][c][i / 4] |= (__float_as_uint(t) & 0xFFu)
                                  << (8 * (i % 4));
          }
        }
      }
    };
    const auto store_run = [&](int u, const Cut& wd) {
      if (u >= Plan::XUNITS) return;
      const int q = u % Q, r0 = (u / Q) * 16;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int off = (q / 8) * SBO + ((part * F + r0) / 16) * 128 +
                        (q % 8) * 16;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint4*>(xs + c * K2 * Q + off) =
              make_uint4(wd[part][c][0], wd[part][c][1], wd[part][c][2],
                         wd[part][c][3]);
      }
    };
    // the amax of the thread's runs, then the block's (its barrier ends
    // every read of sm where RUNS = 1) or each group's
    const auto exps = [&](const float (&a)[RUNS], int (&mr)[RUNS]) {
      if constexpr (Map::GROUPS) {
#pragma unroll
        for (int r = 0; r < RUNS; ++r) {
          const int u = tid + r * NT;
          if (u < Plan::XUNITS)
            atomicMax(&map.gmax[map.group(u % Q)], __float_as_uint(a[r]));
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RUNS; ++r)
          mr[r] = group_exp(map, (tid + r * NT) % Q);
      } else {
        float am = a[0];
#pragma unroll
        for (int r = 1; r < RUNS; ++r) am = fmaxf(am, a[r]);
        m = align_exp(block_max<NT>(am, red));
#pragma unroll
        for (int r = 0; r < RUNS; ++r) mr[r] = m;
      }
    };
    float a[RUNS];
    int mr[RUNS];
    if constexpr (RUNS == 1) {
      float2 v[16];
      load_run(tid, v);
      a[0] = run_max(v);
      exps(a, mr);
      Cut wd;
      cut_run(v, mr[0], wd);
      store_run(tid, wd);
    } else {
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        float2 v[16];
        load_run(tid + r * NT, v);
        a[r] = run_max(v);
      }
      exps(a, mr);
      Cut wd[RUNS];
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        float2 v[16];
        load_run(tid + r * NT, v);
        cut_run(v, mr[r], wd[r]);
      }
      __syncthreads();                  // every read of sm is done
#pragma unroll
      for (int r = 0; r < RUNS; ++r) store_run(tid + r * NT, wd[r]);
    }
    // the products read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // 3. the products of one unit: slab sl (one m64 tile) x NCH columns from
  // n0, every shift group's pairs and k32 steps into one int32
  // accumulator, converted and added in float in ascending s.
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  // FRESH: the operands' descriptors are an opaque base for each, the
  // steps added to its address field (16-byte units; every address lies
  // below 2^18, so the field's 14 bits hold the sum).
  auto products = [&](int sl, int n0, float (&acc)[NCH / 2]) {
    const int8_t* a = w.sm + (sl % Plan::NBUF) * Plan::SLAB;
    const int8_t* b = xs + n0 * K2;     // (n0/8) core groups of SBO bytes
    uint64_t da = 0, db = 0;
    if constexpr (FRESH) {
      da = opaque(smem_desc(a, SBO));
      db = opaque(smem_desc(b, SBO));
    }
    const auto desc = [&](const int8_t* p, uint64_t base, int off) {
      if constexpr (FRESH) return base + (off >> 4);
      else return smem_desc(p + off, SBO);
    };
    // accumulator i's column is n0 + 8*(i/4) + 2*t4 + (i&1): its exponent
    int mc[Map::GROUPS ? NCH / 4 : 1];
    if constexpr (Map::GROUPS) {
#pragma unroll
      for (int j = 0; j < NCH / 4; ++j)
        mc[j] = group_exp(map, n0 + 8 * (j / 2) + 2 * t4 + (j & 1));
    }
#pragma unroll
    for (int s = 2; s <= 5; ++s) {      // shift sum 7*s: 14, 21, 28, 35
      int d[NCH / 2];
#pragma unroll
      for (int i = 0; i < NCH / 2; ++i) {
        d[i] = 0;
        fence_reg(d[i]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int wi = 0; wi < 3; ++wi) {
        const int xc = s - 2 - wi;      // W shift 7(wi+1) + x shift 7(xc+1)
        if (xc < 0 || xc > 3) continue;
#pragma unroll
        for (int kt = 0; kt < Plan::KT; ++kt)
          wgmma_s8<NCH>(d, desc(a, da, wi * 64 * K2 + kt * 256),
                        desc(b, db, xc * K2 * Q + kt * 256));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < NCH / 2; ++i) fence_reg(d[i]);
      const float sc = exp2i(m - 7 * s);
#pragma unroll
      for (int i = 0; i < NCH / 2; ++i) {
        float si = sc;
        if constexpr (Map::GROUPS)
          si = exp2i(mc[(i / 4) * 2 + (i & 1)] - 7 * s);
        acc[i] = s == 2 ? (float)d[i] * si : acc[i] + (float)d[i] * si;
      }
    }
  };
  // The unit's outputs.  Accumulator i of a thread is row 16*warp + g
  // (+8 for i&2) of the tile, column n0 + 8*(i/4) + 2*t4 + (i&1); w_image
  // orders each slab's rows so that rows r and r + 8 of a warp's 16 are the
  // real and the imaginary part of one output k = 32*sl + 8*warp + g.
  auto put = [&](int sl, int n0, const float (&acc)[NCH / 2]) {
    const int k = sl * 32 + warp * 8 + g;
#pragma unroll
    for (int j = 0; j < NCH / 8; ++j)
      map.put2(n0 + 8 * j + 2 * t4, k,
               make_float2(acc[4 * j], acc[4 * j + 1]),
               make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  };
  // unit u's slab and first column
  constexpr int NU = Q / NCH;           // units a slab
  const auto unit_sl = [&](int ph, int u) { return ph * Plan::MTP + u / NU; };
  const auto unit_n0 = [&](int u) { return (u % NU) * NCH; };

  // a phase of resident slabs at a time, UPW units a warpgroup (unit wg +
  // i*NWG).  Map::INTO_X: put writes the float buffer's place, so every
  // product must have read x's channels first; a warpgroup holds its
  // outputs until the barrier after the last phase.  A streamed slab has
  // one unit a warpgroup at most.
  constexpr bool HOLD = Map::INTO_X;
  constexpr int UPW = Plan::UPW;
  float held[HOLD ? Plan::PHASES : 1][HOLD ? UPW : 1][NCH / 2];
#pragma unroll 1
  for (int ph = 0; ph < Plan::PHASES; ++ph) {
#pragma unroll
    for (int t = 0; t < Plan::MTP; ++t)
      tc_wait_w(w, (ph * Plan::MTP + t) % Plan::NBUF);
    if constexpr (Plan::STREAM) {
      const bool mine = wg < Plan::UNITS;
      const int sl = unit_sl(ph, wg), n0 = unit_n0(wg);
      float acc[NCH / 2];
      if (mine) products(sl, n0, acc);
      if constexpr (HOLD) {
#pragma unroll
        for (int t = 0; t < Plan::PHASES; ++t)
          if (t == ph) {
#pragma unroll
            for (int i = 0; i < NCH / 2; ++i) held[t][0][i] = acc[i];
          }
      }
      // the next slab's copy (this call's, or where `again` the next
      // call's first) starts before this one's outputs are stored
      const int next = ph + Plan::NBUF;
      if (next < Plan::PHASES || again) {
        __syncthreads();                // every warpgroup is done with it
        if (threadIdx.x == 0)
          bulk_load(w.sm + (ph % Plan::NBUF) * Plan::SLAB,
                    wimg + (next % Plan::PHASES) * Plan::SLAB, Plan::SLAB,
                    &w.bars[ph % Plan::NBUF]);
        w.pend |= 1u << (ph % Plan::NBUF);
      }
      if constexpr (!HOLD) {
        if (mine) put(sl, n0, acc);
      }
    } else if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = wg + i * Plan::NWG;
        if (u < Plan::UNITS) {
          float acc[NCH / 2];
          products(unit_sl(ph, u), unit_n0(u), acc);
#pragma unroll
          for (int t = 0; t < Plan::PHASES; ++t)
            if (t == ph) {
#pragma unroll
              for (int j = 0; j < NCH / 2; ++j) held[t][i][j] = acc[j];
            }
        }
      }
    } else {
#pragma unroll 1
      for (int u = wg; u < Plan::UNITS; u += Plan::NWG) {
        float acc[NCH / 2];
        products(unit_sl(ph, u), unit_n0(u), acc);
        put(unit_sl(ph, u), unit_n0(u), acc);
      }
    }
  }
  if constexpr (HOLD) {
    __syncthreads();                    // x's channels are read: outputs
#pragma unroll
    for (int t = 0; t < Plan::PHASES; ++t)
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = wg + i * Plan::NWG;
        if (u < Plan::UNITS) put(unit_sl(t, u), unit_n0(u), held[t][i]);
      }
  }
}

// The hosts' stage: int8_stage_tc where TC (the host's compile-time
// choice, tc_stage), else int8_stage.  `wch` holds the 3 (2f x 2f)
// channels, then W's image (w_image_offset); `w` as int8_stage_tc's,
// unused by int8_stage.
template <int F, int NT, int HOST, bool TC, class Map>
__device__ __forceinline__ void host_stage(const Map& map, float2* sm,
                                           const float2* __restrict__ tw,
                                           const int8_t* __restrict__ wch,
                                           WBufs& w, float* red) {
  if constexpr (TC) {
    int8_stage_tc<F, NT, HOST>(map, sm, tw, wch + w_image_offset(F), w, red);
  } else {
    int8_stage<F, NT>(map, sm, tw, wch, red);
  }
}

}  // namespace pyfft
