// Batched length-n complex DFT along contiguous rows: the "local" row
// kernels of pyfft_tpu_torch, complex64 (K1) and complex128 (K11), and the
// interleaved complex64 row kernel (K2).
//
// Replaces the JAX package's Pallas row kernels: for complex64
// pyfft_tpu/ops/pallas_local.py `_kernel`, launched by `_row_call_inner`
// through `pl.pallas_call`; for complex128 pyfft_tpu/ops/pallas_df64.py
// `_row_kernel_df64`, launched by `_fft_rows_df64`.  The first transposes
// (128, n) blocks to (n, 128) and runs DFT-matrix stages on the TPU's
// matrix unit; the second emulates double precision with (hi, lo) float32
// pairs, since the TPU has no FP64 unit.  None of that carries over.  This
// kernel computes the same function with a design of its own, one template
// for both precisions (Real = float or double):
//
//   out[r, k] = postscale * sum_j x[r, j] * exp(sign * 2*pi*i * j*k / n)
//
// for n = 2^log2n, 8 <= n <= 8192 (float) or 4096 (double), in natural
// output order.
//
// What bounds it on an H100: bytes.  A row is read once and written once
// (8 B in and 8 B out per complex64 point, 16 B each way per complex128
// point), so a 4096 x 4096 complex64 batch is one 256 MiB device-memory
// round trip.  By the 5*n*log2(n) count that is under 4 flop per byte in
// float and under 2 in double, far below the ~20 FP32 (~10 FP64) flop per
// byte at which the card's arithmetic, not its memory, would be the limit.
// So the design keeps the data in device memory exactly once each way.
// K1, K2 and K11 run, wherever the input is one a bulk copy reads and the
// length is in its type's table, the row ring below
// (local_rows_ring_kernel: a persistent grid, a ring of slots fed by bulk
// copies, chain.cuh's padded radix-16 chain).  The first design, which
// they keep for every other input and length, is:
//
//   * one thread block per row (several rows per block for n < 512, so each
//     block has 512 points of work); the row is read straight from global
//     memory into registers by the first stage and written straight back by
//     the last, coalesced in both directions;
//   * a Stockham radix-8 chain (a radix-2 or radix-4 stage first when log2n
//     is not a multiple of 3): each stage reads its inputs at j + r*n/R and
//     writes its outputs at (j/Ns)*Ns*R + j%Ns + r*Ns, which leaves the
//     result in natural order with no bit-reversal pass;
//   * every stage between the first and the last goes through one buffer of
//     shared memory (n complex values per row: 8n bytes in float, 16n in
//     double).  A thread holds all its butterflies' values in registers
//     across a barrier before it writes, so one buffer is enough; float at
//     n = 8192 and double at n = 4096 need 64 KB, above the 48 KB default,
//     hence the cudaFuncSetAttribute opt-in;
//   * FMA arithmetic in the row's own precision (native FP64 for
//     complex128), with the in-register DFTs of stockham.cuh (shared with
//     the column kernel); twiddles come from one table exp(sign*2*pi*i*k/n),
//     k < n, built on the host in float64 (rounded once to float for
//     complex64; no device sin/cos);
//   * the postscale (1/N and the user scale) is folded into the last store.
//
// Every global read of a block happens in the first stage and every global
// write in the last, with a barrier between them, and blocks own disjoint
// rows: so the output may alias the input (in place).
//
// Each operand is a pair of real planes with an element stride and a row
// stride, both in elements: planar data has (1, n); the two planes of
// torch.view_as_real of a complex tensor have (2, 2n), with im = re + 1.
//
// K2, the interleaved I/O policy (IL = true).  It replaces the interleaved
// branch of the same JAX kernel (`_kernel` with interleaved=True, launched
// by `_fft_rows_interleaved`; its packed form `tile_fft_packed`, K3,
// computes the same function on the same memory).  On the TPU that branch
// transposes a (128, 2n) block and splits the pairs with sublane
// relayouts; here the operand is one array of float2 (re, im) pairs with a
// row stride in complex elements, and only the first and the last stage
// differ from K1: the first loads each point with one 8-byte __ldg, the
// last stores it, scaled, with one 8-byte store.  Threads with consecutive
// j touch consecutive k in both (k = j + r*N/R in the first stage and
// j + r*NS with NS = N/R in the last), so a warp moves 256 contiguous bytes
// an access, where two stride-2 planes move two half-used 256-byte spans.
// The block shape, the shared-memory buffer, the twiddle table and the
// in-place rule are K1's; the read-only path of __ldg holds in place too,
// since every address is read once, by the block that owns its row, before
// that block writes it.
//
// K1 + K10, the int8 policy (precision="int8", complex64 planes).  The
// chain's last stage is the f-point int8-split stage of int8_stage.cuh (f
// the last factor of the JAX row chain, 16 to 128) in place of the last
// radix-8 stages: the leading radix-2/4/8 stages cover log2(n/f) bits and
// write shared memory (at n = f a plain load fills it), then the stage
// reads the block's RPB rows there, takes its alignment exponent over
// them, and writes the output straight to device memory, postscale
// folded.  It is a kernel of its own (local_rows_i8_kernel), so K1's and
// K2's code is what it was.  In place as K1.  Which stage it runs is a
// compile-time choice (RowI8::TC, reported by pyfft_local_rows_i8_stage):
// the wgmma stage from n = 1024 up (128 threads a block and more), whose
// W slabs follow the float buffer in shared memory and start copying at
// kernel entry; the mma.sync stage at n <= 512 (64 threads).
//
// K2 + K10 (precision="int8", interleaved float2 pairs) is the same kernel
// with K2's I/O policy (IL = true): the first stage, or the n = f load,
// reads each point with one 8-byte __ldg, and the stage's output writes
// each part of a point into its pair with a 4-byte store.  f is the last
// factor of JAX's default chain, which K2 takes (128 at n = 2048, where
// the row chain has 64).  In place as K2.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry points `pyfft_local_rows` (float),
// `pyfft_local_rows_f64` (double), `pyfft_local_rows_il` (interleaved
// float2), `pyfft_local_rows_i8` (float, int8 stage),
// `pyfft_local_rows_il_i8` (interleaved, int8 stage),
// `pyfft_local_rows_i8_stage` (which stage an int8 instance runs),
// and `pyfft_local_rows_ring_shape` and `pyfft_local_rows_ring_shape_f64`
// (the row ring's shape at a length) at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chain.cuh"
#include "int8_stage.cuh"
#include "ring_cols.cuh"   // encode_tiled, mbar_expect, fence_async_smem,
                            // align128
#include "stockham.cuh"

namespace {

using namespace pyfft;

// The operands: two planes each (in_re, in_im, out_re, out_im, strides in
// reals) or, for the interleaved policy, one array of pairs each (in_c,
// out_c, row strides in pairs, element strides unused).
template <typename Real>
struct Io {
  using V = typename Complex<Real>::V;
  const Real* in_re;
  const Real* in_im;
  Real* out_re;
  Real* out_im;
  const V* in_c;
  V* out_c;
  int rows;
  int in_es, in_rs, out_es, out_rs;
  Real post;
};

template <int LOGN>
struct Shape {
  static constexpr int N = 1 << LOGN;
  static constexpr int RPB = N >= 512 ? 1 : 512 / N;    // rows per block
  static constexpr int P = RPB * N;                       // points per block
  static constexpr int T = P / 8 < 512 ? P / 8 : 512;     // threads per block
  static constexpr int REM = LOGN % 3;
  static constexpr int NSTAGES = LOGN / 3 + (REM ? 1 : 0);
};

// The first design's radix-8 stages in double (K11) form three of a
// butterfly's seven twiddles from the other four (chain.cuh's TWD); the
// float stages (K1, K2, the int8 kernels' lead stages) read all seven.
constexpr bool OLD_TWD_F64 = true;

// One radix-R Stockham stage over the block's RPB rows.  NS is the product
// of the radices of the stages before it.  FIRST reads global memory, LAST
// writes it; the stages between read and write shared memory.  IL selects
// the interleaved I/O policy of the global reads and writes.
template <typename Real, bool IL, int N, int T, int RPB, int R, int NS,
          bool FIRST, bool LAST>
__device__ __forceinline__ void stage(const Io<Real>& io,
                                      typename Complex<Real>::V* sm,
                                      const typename Complex<Real>::V*
                                          __restrict__ tw,
                                      int row0, Real s) {
  using V = typename Complex<Real>::V;
  constexpr int NR = N / R;          // butterflies per row
  constexpr int B = RPB * NR / T;    // butterflies per thread
  static_assert(B * R * T == RPB * N, "threads must tile the block exactly");
  V v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * T;
    const int rr = q / NR, j = q % NR;
    const int row = row0 + rr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      if (FIRST) {
        if (row >= io.rows) {
          v[b][r] = Complex<Real>::make(0, 0);
        } else if constexpr (IL) {
          v[b][r] = __ldg(&io.in_c[(long long)row * io.in_rs + k]);
        } else {
          const long long o =
              (long long)row * io.in_rs + (long long)k * io.in_es;
          v[b][r] = Complex<Real>::make(io.in_re[o], io.in_im[o]);
        }
      } else {
        v[b][r] = sm[rr * N + k];
      }
    }
    if (NS > 1) {
      const int jj = j % NS;
      if constexpr (OLD_TWD_F64 && sizeof(Real) == sizeof(double) &&
                    R == 8) {
        // K11: w^1, w^2, w^4, w^7 read, w^3, w^5, w^6 one product each
        // (chain.cuh's TWD), four table reads of seven
        const int e = jj * (N / (NS * R));      // w^r at tw[r*e]
        const V w1 = __ldg(&tw[e]), w2 = __ldg(&tw[2 * e]);
        const V w4 = __ldg(&tw[4 * e]);
        v[b][1] = cmul(v[b][1], w1);
        v[b][2] = cmul(v[b][2], w2);
        v[b][3] = cmul(v[b][3], cmul(w1, w2));
        v[b][4] = cmul(v[b][4], w4);
        v[b][5] = cmul(v[b][5], cmul(w1, w4));
        v[b][6] = cmul(v[b][6], cmul(w2, w4));
        v[b][7] = cmul(v[b][7], __ldg(&tw[7 * e]));
      } else {
#pragma unroll
        for (int r = 1; r < R; ++r)
          v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (N / (NS * R))]));
      }
    }
    dft<R>(v[b], s);
  }
  // a middle stage reads and writes the same buffer: all reads first
  if (!FIRST && !LAST) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * T;
    const int rr = q / NR, j = q % NR;
    const int row = row0 + rr;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = base + r * NS;
      if (LAST) {
        if (row < io.rows) {
          if constexpr (IL) {
            io.out_c[(long long)row * io.out_rs + k] = Complex<Real>::make(
                v[b][r].x * io.post, v[b][r].y * io.post);
          } else {
            const long long o =
                (long long)row * io.out_rs + (long long)k * io.out_es;
            io.out_re[o] = v[b][r].x * io.post;
            io.out_im[o] = v[b][r].y * io.post;
          }
        }
      } else {
        sm[rr * N + k] = v[b][r];
      }
    }
  }
  if (!LAST) __syncthreads();
}

template <typename Real, bool IL, int LOGN, int STAGE, int NS>
__device__ __forceinline__ void stages(const Io<Real>& io,
                                       typename Complex<Real>::V* sm,
                                       const typename Complex<Real>::V*
                                           __restrict__ tw,
                                       int row0, Real s) {
  using S = Shape<LOGN>;
  constexpr int R = (STAGE == 0 && S::REM) ? (1 << S::REM) : 8;
  stage<Real, IL, S::N, S::T, S::RPB, R, NS, STAGE == 0,
        STAGE == S::NSTAGES - 1>(io, sm, tw, row0, s);
  if constexpr (STAGE + 1 < S::NSTAGES)
    stages<Real, IL, LOGN, STAGE + 1, NS * R>(io, sm, tw, row0, s);
}

template <typename Real, bool IL, int LOGN>
__global__ void __launch_bounds__(Shape<LOGN>::T)
    local_rows_kernel(Io<Real> io,
                      const typename Complex<Real>::V* __restrict__ tw,
                      Real s) {
  using V = typename Complex<Real>::V;
  // one raw buffer for both precisions: extern __shared__ arrays of
  // different types in one translation unit must not share a name
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stages<Real, IL, LOGN, 0, 1>(io, reinterpret_cast<V*>(smem_raw), tw,
                               blockIdx.x * Shape<LOGN>::RPB, s);
}

template <typename Real, bool IL, int LOGN>
cudaError_t launch(const Io<Real>& io, const typename Complex<Real>::V* tw,
                   Real s, cudaStream_t stream) {
  using S = Shape<LOGN>;
  using V = typename Complex<Real>::V;
  const int smem = S::NSTAGES > 1 ? S::P * (int)sizeof(V) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_rows_kernel<Real, IL, LOGN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (io.rows + S::RPB - 1) / S::RPB;
  local_rows_kernel<Real, IL, LOGN><<<blocks, S::T, smem, stream>>>(io, tw,
                                                                     s);
  return cudaGetLastError();
}

// log2n -> launch<Real, IL, log2n>, for log2n in [3, MAXLOG].
template <typename Real, bool IL, int MAXLOG>
cudaError_t dispatch(int log2n, const Io<Real>& io, const void* tw, int sign,
                     void* stream) {
  using V = typename Complex<Real>::V;
  const V* t = static_cast<const V*>(tw);
  const Real s = sign < 0 ? Real(-1) : Real(1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io.rows <= 0 || log2n > MAXLOG) return cudaErrorInvalidValue;
  switch (log2n) {
    case 3: return launch<Real, IL, 3>(io, t, s, st);
    case 4: return launch<Real, IL, 4>(io, t, s, st);
    case 5: return launch<Real, IL, 5>(io, t, s, st);
    case 6: return launch<Real, IL, 6>(io, t, s, st);
    case 7: return launch<Real, IL, 7>(io, t, s, st);
    case 8: return launch<Real, IL, 8>(io, t, s, st);
    case 9: return launch<Real, IL, 9>(io, t, s, st);
    case 10: return launch<Real, IL, 10>(io, t, s, st);
    case 11: return launch<Real, IL, 11>(io, t, s, st);
    case 12: return launch<Real, IL, 12>(io, t, s, st);
    case 13:
      if constexpr (MAXLOG >= 13) return launch<Real, IL, 13>(io, t, s, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// -------------------- K1, K2 and K11: a persistent ring of row blocks
//
// The kernel behind K1's and K2's C entries (local_rows_ring_kernel) and,
// on double planes, K11's (a template on the real type, its tables
// PYFFT_ROWS_RING and PYFFT_ROWS_RING_F64 below).  A
// grid of at most one wave (the card's SMs times the blocks an SM holds)
// walks the row blocks of RPB rows: block b takes b, b + grid, ...  Its
// shared memory is a ring of S slots of one row block each, one mbarrier a
// slot.  Thread 0 issues the copies of the next row blocks while the block
// runs the chain and the stores of the current one, so S - 1 row blocks are
// in flight from device memory at any time:
//
//   * from n = 512 one 1D bulk copy (cp.async.bulk) a row of a plane, or
//     of the (re, im) pairs, several KB each; below 512 one tensor-map box
//     [RPB][n] a plane (n <= 256, the copy engine's box limit), rows past
//     the end filled with zeros.  One copy a row of 128 bytes would be
//     paced by the copy engine's issue rate (K6's first design); these are
//     2 KB and more;
//   * the chain is chain.cuh's, ROWS over the slot's RPB rows: radix 16
//     after a radix-2, 4 or 8 head (R16: 4096 = 16^3 is two shared-memory
//     round trips, not radix 8's three), chain_index's padded rows (PAD:
//     the strided stage writes meet no more than two wavefronts), five
//     twiddle reads of fifteen a radix-16 butterfly (TWD).  Its first stage
//     reads the slot's raw rows through a load functor and writes the
//     padded layout into the same slot after a barrier (SYNC0), so the slot
//     is the chain's buffer;
//   * the last stage stores from registers with threads along k (128-byte
//     runs a warp on each plane, 256 on pairs), the postscale folded (on
//     the H100 faster than writing the slot and a bulk copy a row out:
//     0.1078 against 0.1107 ms at 4096 x 4096, probes/float_split.py
//     rbulk); the barrier between its reads and its stores is the slot's
//     last, and the refill at the top of the next iteration follows it.
//     Up to n = 64, where a thread of the last stage holds fewer than 8
//     points of a row, the stores go in a pass along the rows instead (and
//     up to n = 16, where it holds one row, a pass along the rows fills
//     the chain).
//
// Operands: planar planes, or pairs ((re, im) adjacent: K2's float2 arrays
// and the complex form's stride-2 planes), read from anywhere a bulk copy
// reads (ring_rows_operands: 16-byte aligned, row stride a multiple of 16
// bytes); the output at any strides, pairs stored as float2 (double2).
// Any other input layout, and any length missing from the type's table,
// runs local_rows_kernel above (the first design of K1, K2 and K11), which
// reads any strides.  In place: every row is read whole, when its copy
// completes, by the block that owns it, before that block stores it.
//
// K11 (complex128) runs the same kernel on double planes at the lengths of
// PYFFT_ROWS_RING_F64: one bulk copy a row of a plane (32 KB at n = 4096)
// or of pairs, the same chain in FP64.  Its table may hold only lengths of
// bulk copies (n >= 512): a tensor map has no 16-byte element for the
// pairs of doubles.

// (log2 n, RPB, S): rows a slot and slots of the ring, by length.  A slot
// holds 4096 points (2048 at n = 8; 8192 at n = 32, 64 and 8192), a
// thread 16 points a stage.  n = 128 to 512 run the first design, which
// the H100 showed as fast or faster there, and at n = 8192 two slots beat
// three (one run of probes/float_split.py K1 over 2^24 points, ms: `old`
// 0.0994, 0.0973, 0.1024 against `rall` 0.1027, 0.1036, 0.1063 at n =
// 128, 256, 512; `rs2` 0.1243 against three slots' 0.1328 at 8192).
#ifndef PYFFT_ROWS_RING
#define PYFFT_ROWS_RING(X)                                               \
  X(3, 256, 3) X(4, 256, 3) X(5, 256, 3) X(6, 128, 3) X(10, 4, 3)        \
  X(11, 2, 3) X(12, 1, 3) X(13, 1, 2)
#endif
// The same for complex128 (K11), n >= 512 only: n = 4096.  At 1024 and
// 2048 the first design with TWD (OLD_TWD_F64) was as fast or faster on the
// H100, its loads and stores under the ring's copy floor (16384 x 1024:
// first design 0.1907 ms against the ring's 0.1969 at 2 rows a slot, copy
// 0.1836 against 0.1910; 8192 x 2048: 0.1964 against 0.1981; 4096 x 4096:
// 0.2418 against 0.2064; probes/float_split.py k11old, PERF.md section 6).
#ifndef PYFFT_ROWS_RING_F64
#define PYFFT_ROWS_RING_F64(X) X(12, 1, 2)
#endif
// the chains' options (chain.cuh); radix 16 where it takes a stage fewer
// than radix 8 (not at n = 8), in float and (RING_R16_F64) in double
constexpr bool RING_PAD = true, RING_TWD = true, RING_R16 = true;
constexpr bool RING_R16_F64 = true;
// The most rows or points a tensor copy's box takes (the copy engine's
// limit).
constexpr int RING_BOX = 256;

template <typename Real, int LOGN, int RPB_, int S_>
struct RowRing {
  using V = typename Complex<Real>::V;
  static constexpr int VB = (int)sizeof(V);            // bytes a value
  static constexpr int N = 1 << LOGN, RPB = RPB_, S = S_, P = RPB * N;
  static constexpr int NT = P / (N < 16 ? N : 16);    // threads a block
  static constexpr bool BOX = N < 512;                 // tensor-map boxes
  // short rows, where a thread of the first or the last stage takes fewer
  // than 8 consecutive points of a row: up to n = 16 (one row a thread)
  // the slot's raw rows go into the chain's layout in a pass along the
  // rows; up to n = 64 the outputs are stored in such a pass
  static constexpr bool PASS_IN = N <= 16, PASS_OUT = N <= 64;
  static constexpr bool R16 = (VB == 8 ? RING_R16 : RING_R16_F64) &&
                              (LOGN + 3) / 4 < (LOGN + 2) / 3;
  // a slot: the raw rows (P values) or the chain's padded rows, rounded to
  // 128 bytes (the box copies' alignment), in values
  static constexpr int RAW = P > RPB * (N + N / 16) ? P : RPB * (N + N / 16);
  static constexpr int SLOT = (RAW * VB + 127) / 128 * 128 / VB;
  static constexpr int SMEM = S * SLOT * VB + 128;     // + alignment
  // the blocks an SM's shared memory (228 KB, 1 KB a block reserved) and
  // threads allow: the registers are held to that many (launch bounds)
  static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);
  static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM : 2048 / NT;
  static_assert(S >= 2 && SMEM <= 227 * 1024,
                "the ring fits a block's shared memory");
  static_assert(NT <= 1024 && P % NT == 0, "whole butterflies a thread");
  static_assert(!BOX || (N <= RING_BOX && RPB <= RING_BOX && VB == 8),
                "a slot is one box a plane (of floats)");
  static_assert(BOX || RPB * N * VB < (1 << 20), "an mbarrier's byte count");
};

// The ring's operands: `in` the real plane (planar: `in_im` the imaginary
// one) or the (re, im) pairs; `out` likewise; strides in reals (pairs:
// twice the pairs' row stride).
template <typename Real>
struct RingIo {
  const Real* in;
  const Real* in_im;
  Real* out;
  Real* out_im;
  int rows;
  int in_pairs, out_pairs;
  long long in_es, in_rs, out_rs, out_es;
  Real post;
};

// Whether bulk copies read the ring's input where it lies: planar planes
// (unit stride) or pairs, 16-byte aligned, rows a multiple of 16 bytes
// apart (any stride for one row).
template <typename Real>
inline bool ring_rows_operands(const RingIo<Real>& io) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(io.in);
  const uintptr_t b = reinterpret_cast<uintptr_t>(io.in_im);
  return (io.in_pairs || (io.in_es == 1 && b % 16 == 0)) && a % 16 == 0 &&
         (io.rows == 1 || io.in_rs * (long long)sizeof(Real) % 16 == 0);
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`'s current phase (which the caller's
// mbar_expect counts).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy the box of the 2D tensor map `map` at (c0, c1) into shared `dst`,
// completing on `bar`'s current phase.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// A 2D tensor map over the ring's input plane (or pairs) at `base`: `n`
// elements a row, `rows` rows `row_bytes` apart, boxes of [rpb][n].
inline cudaError_t ring_rows_map(CUtensorMap* map, const float* base,
                                 bool pairs, int n, int rows,
                                 long long row_bytes, int rpb) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)n, (cuuint32_t)rpb};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = enc(
      map, pairs ? CU_TENSOR_MAP_DATA_TYPE_INT64 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<float*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The ring over `blocks` row blocks: row block first + i*every in slot
// i % S on barrier bars[i % S], filled by thread 0 (map_re, map_im: the
// boxes below n = 512; map_im unused on pairs).
template <typename Real, int LOGN, int RPB, int S>
__global__ void __launch_bounds__(RowRing<Real, LOGN, RPB, S>::NT,
                                  RowRing<Real, LOGN, RPB, S>::PER)
    local_rows_ring_kernel(RingIo<Real> io,
                           const typename Complex<Real>::V* __restrict__ tw,
                           Real s, long long blocks,
                           const __grid_constant__ CUtensorMap map_re,
                           const __grid_constant__ CUtensorMap map_im) {
  using K = RowRing<Real, LOGN, RPB, S>;
  using V = typename K::V;
  constexpr int N = K::N, P = K::P, NT = K::NT, SLOT = K::SLOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[S];
  V* slots = reinterpret_cast<V*>(align128(smem_raw));
  const long long first = blockIdx.x, every = gridDim.x;
  const int count =
      first < blocks ? static_cast<int>((blocks - first + every - 1) / every)
                     : 0;
  const bool pin = io.in_pairs, pout = io.out_pairs;
  // this block's row block i into slot i % S: its rows of each plane, or
  // of pairs (planar: the real rows, then the imaginary rows)
  const auto issue = [&](int i) {
    uint64_t* bar = &bars[i % S];
    Real* dst = reinterpret_cast<Real*>(slots + (i % S) * SLOT);
    const long long row0 = (first + (long long)i * every) * RPB;
    fence_async_smem();
    if constexpr (K::BOX) {
      mbar_expect(bar, P * (int)sizeof(float2));
      tma_load_2d(dst, &map_re, 0, static_cast<int>(row0), bar);
      if (!pin) tma_load_2d(dst + P, &map_im, 0, static_cast<int>(row0), bar);
    } else {
      const int nr = static_cast<int>(
          io.rows - row0 < RPB ? io.rows - row0 : RPB);
      mbar_expect(bar, nr * N * (int)sizeof(V));
      for (int r = 0; r < nr; ++r) {
        const long long o = (row0 + r) * io.in_rs;
        if (pin) {
          bulk_copy(dst + 2 * r * N, io.in + o, N * (int)sizeof(V), bar);
        } else {
          bulk_copy(dst + r * N, io.in + o, N * (int)sizeof(Real), bar);
          bulk_copy(dst + P + r * N, io.in_im + o, N * (int)sizeof(Real),
                    bar);
        }
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < S; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < S && j < count; ++j) issue(j);
  }
  __syncthreads();                  // the barriers are set up
  for (int i = 0; i < count; ++i) {
    // thread 0 fills the slot of row block i - 1, whose readers are past
    // its last stage's barrier, with row block i + S - 1
    if (threadIdx.x == 0 && i && i + S - 1 < count) issue(i + S - 1);
    V* sm = slots + (i % S) * SLOT;
    const Real* f = reinterpret_cast<const Real*>(sm);
    const long long row0 = (first + (long long)i * every) * RPB;
    const auto load = [&](int c, int k) {
      return pin ? sm[c * N + k]
                 : Complex<Real>::make(f[c * N + k], f[P + c * N + k]);
    };
    const auto store = [&](int c, int k, V v) {
      const V y = Complex<Real>::make(v.x * io.post, v.y * io.post);
      const long long row = row0 + c;
      if (row >= io.rows) return;
      if (pout) {
        reinterpret_cast<V*>(io.out + row * io.out_rs)[k] = y;
      } else {
        const long long o = row * io.out_rs + k * io.out_es;
        io.out[o] = y.x;
        io.out_im[o] = y.y;
      }
    };
    mbar_wait(&bars[i % S], (i / S) & 1);
    constexpr int E = P / NT;                 // points a thread a pass
    if constexpr (K::PASS_IN) {
      // the slot's raw rows into the chain's padded layout, along the rows
      V v[E];
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const int e = threadIdx.x + q * NT;
        v[q] = load(e / N, e % N);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const int e = threadIdx.x + q * NT;
        sm[chain_index<N, RPB, true, RING_PAD>(e / N, e % N)] = v[q];
      }
      __syncthreads();
    }
    // the first stage reads the slot's raw rows (SYNC0: a barrier before
    // it writes the slot) or, after the pass, the chain's layout; the last
    // stores, or leaves the result for the pass below
    chain<NT, LOGN, RPB, true, 0, 1, !K::PASS_IN, !K::PASS_OUT, RING_PAD,
          RING_TWD, K::R16, true>(sm, fresh(tw), s, load, store);
    if constexpr (K::PASS_OUT) {
      // the stores along the rows, then the slot's last barrier
#pragma unroll 4
      for (int q = 0; q < E; ++q) {
        const int e = threadIdx.x + q * NT;
        store(e / N, e % N,
              sm[chain_index<N, RPB, true, RING_PAD>(e / N, e % N)]);
      }
      __syncthreads();
    }
  }
}

// The card's SMs and the blocks of the ring's kernel an SM holds, into
// `sms` and `per`: asked of the card once a device, with the kernel's
// shared memory set there for its launches.
template <typename Real, int LOGN, int RPB, int S>
cudaError_t ring_rows_wave(int& sms, int& per) {
  using K = RowRing<Real, LOGN, RPB, S>;
  const auto kernel = local_rows_ring_kernel<Real, LOGN, RPB, S>;
  static std::atomic<long long> waves[64];     // by device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  long long got = waves[dev].load(std::memory_order_relaxed);
  if (!got) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, K::NT,
                                                        K::SMEM);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
    got = ((long long)sms << 8) | per;
    waves[dev].store(got, std::memory_order_relaxed);
  }
  sms = static_cast<int>(got >> 8);
  per = static_cast<int>(got & 255);
  return cudaSuccess;
}

template <typename Real, int LOGN, int RPB, int S>
cudaError_t launch_rows_ring(const RingIo<Real>& io,
                             const typename Complex<Real>::V* tw, Real s,
                             cudaStream_t stream) {
  using K = RowRing<Real, LOGN, RPB, S>;
  const auto kernel = local_rows_ring_kernel<Real, LOGN, RPB, S>;
  int sms = 0, per = 0;
  cudaError_t e = ring_rows_wave<Real, LOGN, RPB, S>(sms, per);
  if (e != cudaSuccess) return e;
  CUtensorMap mre{}, mim{};
  if constexpr (K::BOX) {
    // one row: any stride the map takes (16-byte units)
    const long long rb = io.rows > 1 ? io.in_rs * 4 : (long long)K::N * 8;
    e = ring_rows_map(&mre, (const float*)io.in, io.in_pairs, K::N, io.rows,
                      rb, RPB);
    if (e == cudaSuccess && !io.in_pairs)
      e = ring_rows_map(&mim, (const float*)io.in_im, false, K::N, io.rows,
                        rb, RPB);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (io.rows + RPB - 1) / RPB;
  const long long wave = (long long)sms * per;
  const long long grid = blocks < wave ? blocks : wave;
  kernel<<<(unsigned)grid, K::NT, K::SMEM, stream>>>(io, tw, s, blocks, mre,
                                                     mim);
  return cudaGetLastError();
}

// RPB of the ring at log2n, 0 where the type's table (PYFFT_ROWS_RING,
// PYFFT_ROWS_RING_F64) keeps the first design.
template <typename Real>
int ring_rows_rpb(int log2n) {
#define PYFFT_RING_RPB(LN, RPB, S) \
  if (log2n == LN) return RPB;
  if constexpr (sizeof(Real) == sizeof(float)) {
    PYFFT_ROWS_RING(PYFFT_RING_RPB)
  } else {
    PYFFT_ROWS_RING_F64(PYFFT_RING_RPB)
  }
#undef PYFFT_RING_RPB
  return 0;
}

// What the C entries of K1, K2 and K11 return where the row ring ran: 0
// where local_rows_kernel ran, else the launch's cudaError_t.  The wrappers
// count the ring's launches from it.
constexpr int RAN_RING = -1;

// K1 and K2 (complex64), K11 (complex128): the ring where it takes the
// length and the input layout (RAN_RING), else local_rows_kernel (`old`,
// IL its interleaved policy; 0), or a cudaError_t.
template <typename Real, bool IL>
int rows_ring(int log2n, const RingIo<Real>& ring, const Io<Real>& old,
              const void* tw, int sign, void* stream) {
  using V = typename Complex<Real>::V;
  if (ring.rows > 0 && ring_rows_rpb<Real>(log2n) &&
      ring_rows_operands(ring)) {
    const V* t = static_cast<const V*>(tw);
    const Real s = sign < 0 ? Real(-1) : Real(1);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PYFFT_RING_LAUNCH(LN, RPB, S)                                      \
  if (log2n == LN) {                                                      \
    const cudaError_t e =                                                 \
        launch_rows_ring<Real, LN, RPB, S>(ring, t, s, st);               \
    return e == cudaSuccess ? RAN_RING : (int)e;                          \
  }
    if constexpr (sizeof(Real) == sizeof(float)) {
      PYFFT_ROWS_RING(PYFFT_RING_LAUNCH)
    } else {
      PYFFT_ROWS_RING_F64(PYFFT_RING_LAUNCH)
    }
#undef PYFFT_RING_LAUNCH
  }
  return (int)dispatch<Real, IL, sizeof(Real) == sizeof(float) ? 13 : 12>(
      log2n, old, tw, sign, stream);
}

// ------------------------------------------------ K1 + K10 (int8 policy)

// The radix-2/4/8 stages in front of the int8 stage: log2(n/f) bits, the
// odd ones first, each writing shared memory.  IL selects the interleaved
// load of the first, as in `stage`.
template <int LOGN, int LOGF, int STAGE, int NS, bool IL>
__device__ __forceinline__ void lead_stages(const Io<float>& io, float2* sm,
                                            const float2* __restrict__ tw,
                                            int row0, float s) {
  using S = Shape<LOGN>;
  constexpr int LB = LOGN - LOGF, REM = LB % 3;
  constexpr int NL = LB / 3 + (REM ? 1 : 0);
  constexpr int R = (STAGE == 0 && REM) ? (1 << REM) : 8;
  stage<float, IL, S::N, S::T, S::RPB, R, NS, STAGE == 0, false>(
      io, sm, tw, row0, s);
  if constexpr (STAGE + 1 < NL)
    lead_stages<LOGN, LOGF, STAGE + 1, NS * R, IL>(io, sm, tw, row0, s);
}

// At n = f: the block's rows into shared memory, rows past the end as 0.
template <int LOGN, bool IL>
__device__ __forceinline__ void load_block(const Io<float>& io, float2* sm,
                                           int row0) {
  using S = Shape<LOGN>;
  for (int e = threadIdx.x; e < S::P; e += S::T) {
    const int row = row0 + e / S::N, k = e % S::N;
    float2 v = make_float2(0.f, 0.f);
    if (row < io.rows) {
      if constexpr (IL) {
        v = __ldg(&io.in_c[(long long)row * io.in_rs + k]);
      } else {
        const long long o =
            (long long)row * io.in_rs + (long long)k * io.in_es;
        v = make_float2(io.in_re[o], io.in_im[o]);
      }
    }
    sm[e] = v;
  }
  __syncthreads();
}

// The int8 stage's view of the block: column q = (row rr, run j) with
// rr = q / NS, element r at rr*N + j + r*NS; outputs to device memory.
// IL: out_re is the floats of the output's (re, im) pairs, out_im unused,
// strides in pairs, and part picks the pair's member.
template <int LOGN, int LOGF, bool IL>
struct RowMap {
  static constexpr int N = 1 << LOGN, NS = N >> LOGF;
  static constexpr int Q = Shape<LOGN>::RPB * NS;
  static constexpr bool INTO_X = false;        // outputs to device memory
  static constexpr bool GROUPS = false;
  float* out_re;
  float* out_im;
  int rows, out_es, out_rs, row0;
  float post;
  __device__ int index(int q, int r) const {
    return (q / NS) * N + q % NS + r * NS;
  }
  __device__ int jof(int q) const { return q % NS; }
  __device__ void put(int q, int k, int part, float v) const {
    const int row = row0 + q / NS;
    if (row >= rows) return;
    const long long o = (long long)row * out_rs +
                        (long long)(q % NS + k * NS) * out_es;
    if constexpr (IL) {
      out_re[2 * o + part] = v * post;
    } else {
      (part ? out_im : out_re)[o] = v * post;
    }
  }
  // Output k of columns q and q + 1 (q even, one row: NS is even), as
  // 16-byte (re, im, re, im) stores of the pairs or 8-byte stores of each
  // plane where the addresses allow.
  __device__ void put2(int q, int k, float2 re, float2 im) const {
    static_assert(NS % 2 == 0, "q and q + 1 share a row");
    const int row = row0 + q / NS;
    if (row >= rows) return;
    const long long o = (long long)row * out_rs +
                        (long long)(q % NS + k * NS) * out_es;
    re = make_float2(re.x * post, re.y * post);
    im = make_float2(im.x * post, im.y * post);
    if constexpr (IL) {
      float* p = out_re + 2 * o;
      if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(re.x, im.x, re.y, im.y);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(re.x, im.x);
        *reinterpret_cast<float2*>(p + 2) = make_float2(re.y, im.y);
      }
    } else {
      float* pr = out_re + o;
      float* pi = out_im + o;
      if (out_es == 1 && ((reinterpret_cast<uintptr_t>(pr) |
                           reinterpret_cast<uintptr_t>(pi)) & 7) == 0) {
        *reinterpret_cast<float2*>(pr) = re;
        *reinterpret_cast<float2*>(pi) = im;
      } else {
        pr[0] = re.x;
        pr[out_es] = re.y;
        pi[0] = im.x;
        pi[out_es] = im.y;
      }
    }
  }
};

// The int8 kernel's plan at (log2 n, log2 f): its stage (TC, the wgmma
// one, wherever the block has a warpgroup and f >= 32) and its shared
// memory, the float buffer (the stage's x channels take its place) and,
// for the wgmma stage, W's slab buffers after it.
template <int LOGN, int LOGF>
struct RowI8 {
  using S = Shape<LOGN>;
  static constexpr int F = 1 << LOGF;
  static constexpr int Q = S::RPB * (S::N >> LOGF);   // RowMap::Q
  static constexpr int DATA = S::P * (int)sizeof(float2);
  static constexpr bool TC = tc_stage(F, S::T);
  using Plan = TcPlan<F, S::T, Q, DATA>;
  static constexpr int SMEM = DATA + (TC ? Plan::W_BYTES : 0);
  // n = 8192, f = 128: 64 KB of data and one 48 KB slab
  static_assert(SMEM + 1024 <= 227 * 1024, "fits a block's shared memory");
};

// `wch` holds the 3 (2f x 2f) channels, then W's image (w_image_offset).
template <int LOGN, int LOGF, bool IL>
__global__ void __launch_bounds__(Shape<LOGN>::T)
    local_rows_i8_kernel(Io<float> io, const float2* __restrict__ tw,
                         float s, const int8_t* __restrict__ wch) {
  using S = Shape<LOGN>;
  using R = RowI8<LOGN, LOGF>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[S::T / 32];
  __shared__ uint64_t bars[W_BARS];
  float2* sm = reinterpret_cast<float2*>(smem_raw);
  WBufs w{reinterpret_cast<int8_t*>(smem_raw + R::DATA), bars, 0u, 0u};
  if constexpr (R::TC)
    w = tc_fetch_w<typename R::Plan>(wch + w_image_offset(R::F), w.sm, bars);
  const int row0 = blockIdx.x * S::RPB;
  if constexpr (LOGN == LOGF) {
    load_block<LOGN, IL>(io, sm, row0);
  } else {
    lead_stages<LOGN, LOGF, 0, 1, IL>(io, sm, tw, row0, s);
  }
  float* out_re = IL ? reinterpret_cast<float*>(io.out_c) : io.out_re;
  const RowMap<LOGN, LOGF, IL> map{out_re, io.out_im, io.rows, io.out_es,
                                   io.out_rs, row0, io.post};
  host_stage<R::F, S::T, R::DATA, R::TC>(map, sm, tw, wch, w, red);
}

template <int LOGN, int LOGF, bool IL>
cudaError_t launch_i8(const Io<float>& io, const float2* tw, float s,
                      const int8_t* wch, cudaStream_t stream) {
  using S = Shape<LOGN>;
  const int smem = RowI8<LOGN, LOGF>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_rows_i8_kernel<LOGN, LOGF, IL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (io.rows + S::RPB - 1) / S::RPB;
  local_rows_i8_kernel<LOGN, LOGF, IL><<<blocks, S::T, smem, stream>>>(
      io, tw, s, wch);
  return cudaGetLastError();
}

// (log2n, log2f) -> launch_i8<log2n, log2f, IL> over PYFFT_I8_CHAINS;
// the interleaved policy adds (11, 7), the f = 128 of JAX's default chain
// at n = 2048, which K2 + K10 takes.
template <bool IL>
cudaError_t dispatch_i8(int log2n, int log2f, const Io<float>& io,
                        const void* tw, const void* wch, int sign,
                        void* stream) {
  const float2* t = static_cast<const float2*>(tw);
  const int8_t* w = static_cast<const int8_t*>(wch);
  const float s = sign < 0 ? -1.f : 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io.rows <= 0) return cudaErrorInvalidValue;
#define PYFFT_I8_ROWS(LN, LF)     \
  if (log2n == LN && log2f == LF) \
    return launch_i8<LN, LF, IL>(io, t, s, w, st);
  PYFFT_I8_CHAINS(PYFFT_I8_ROWS)
#undef PYFFT_I8_ROWS
  if constexpr (IL) {
    if (log2n == 11 && log2f == 7)
      return launch_i8<11, 7, IL>(io, t, s, w, st);
  }
  return cudaErrorInvalidValue;
}

// The planar policy's operands.
template <typename Real>
Io<Real> planes(const void* in_re, const void* in_im, void* out_re,
                void* out_im, int rows, int in_es, int in_rs, int out_es,
                int out_rs, Real postscale) {
  return Io<Real>{static_cast<const Real*>(in_re),
                  static_cast<const Real*>(in_im),
                  static_cast<Real*>(out_re),
                  static_cast<Real*>(out_im),
                  nullptr, nullptr, rows, in_es, in_rs, out_es, out_rs,
                  postscale};
}

// K1's (K11's) planes as the ring's operands: pairs where the imaginary
// plane is the real one's next element (the complex form's stride-2
// planes; stored as float2 (double2) where they are aligned to a pair),
// else planar.
template <typename Real>
RingIo<Real> ring_planes(const Io<Real>& io) {
  const bool in_pairs = io.in_es == 2 && io.in_im == io.in_re + 1;
  const bool out_pairs =
      io.out_es == 2 && io.out_im == io.out_re + 1 &&
      reinterpret_cast<uintptr_t>(io.out_re) % (2 * sizeof(Real)) == 0 &&
      (io.rows == 1 || io.out_rs % 2 == 0);
  return RingIo<Real>{io.in_re, io.in_im, io.out_re, io.out_im, io.rows,
                      in_pairs, out_pairs, io.in_es, io.in_rs, io.out_rs,
                      io.out_es, io.post};
}

}  // namespace

// Launch the row DFT on `stream` without synchronising.  Strides are in
// elements of the planes' type; `tw` holds n (cos, sin) pairs of
// sign*2*pi*k/n in that type.  Return the launch's cudaError_t: 0 on
// success, or on a complex64 launch that ran the row ring RAN_RING (-1).
// complex64: float planes, 8 <= n <= 8192.
extern "C" int pyfft_local_rows(const void* in_re, const void* in_im,
                                void* out_re, void* out_im, const void* tw,
                                int rows, int log2n, int in_es, int in_rs,
                                int out_es, int out_rs, int sign,
                                float postscale, void* stream) {
  const Io<float> old = planes<float>(in_re, in_im, out_re, out_im, rows,
                                      in_es, in_rs, out_es, out_rs,
                                      postscale);
  return rows_ring<float, false>(log2n, ring_planes(old), old, tw, sign,
                                 stream);
}

// complex128: double planes, 8 <= n <= 4096, computed in native FP64;
// returns as pyfft_local_rows (RAN_RING where the ring ran).
extern "C" int pyfft_local_rows_f64(const void* in_re, const void* in_im,
                                    void* out_re, void* out_im,
                                    const void* tw, int rows, int log2n,
                                    int in_es, int in_rs, int out_es,
                                    int out_rs, int sign, double postscale,
                                    void* stream) {
  const Io<double> old = planes<double>(in_re, in_im, out_re, out_im, rows,
                                        in_es, in_rs, out_es, out_rs,
                                        postscale);
  return rows_ring<double, false>(log2n, ring_planes(old), old, tw, sign,
                                  stream);
}

// K2, complex64 interleaved: `in` and `out` are (rows, n) arrays of float2
// (re, im) pairs, each 8-byte aligned, with row strides in pairs; 8 <= n
// <= 8192.  `out` may be `in` (in place).  Returns as pyfft_local_rows.
extern "C" int pyfft_local_rows_il(const void* in, void* out, const void* tw,
                                   int rows, int log2n, int in_rs,
                                   int out_rs, int sign, float postscale,
                                   void* stream) {
  const Io<float> io{nullptr, nullptr, nullptr, nullptr,
                     static_cast<const float2*>(in), static_cast<float2*>(out),
                     rows, 1, in_rs, 1, out_rs, postscale};
  const RingIo<float> ring{static_cast<const float*>(in), nullptr,
                           static_cast<float*>(out), nullptr, rows, 1, 1, 2,
                           2LL * in_rs, 2LL * out_rs, 2, postscale};
  return rows_ring<float, true>(log2n, ring, io, tw, sign, stream);
}

// K1 + K10: the complex64 row DFT with the f-point int8 stage last (f =
// 2^log2f, the last factor of the JAX row or column chain at this n, see
// PYFFT_I8_CHAINS); `wch` holds the stage's 3 channels, (3, 2f, 2f) int8
// C-contiguous, followed (f >= 32) by their shared-memory image
// (ops/int8.py `w_tables`), 16-byte aligned.  Other arguments as
// pyfft_local_rows's; `out` may be the input (in place).
extern "C" int pyfft_local_rows_i8(const void* in_re, const void* in_im,
                                   void* out_re, void* out_im, const void* tw,
                                   const void* wch, int rows, int log2n,
                                   int log2f, int in_es, int in_rs,
                                   int out_es, int out_rs, int sign,
                                   float postscale, void* stream) {
  return (int)dispatch_i8<false>(
      log2n, log2f,
      planes<float>(in_re, in_im, out_re, out_im, rows, in_es, in_rs, out_es,
                    out_rs, postscale),
      tw, wch, sign, stream);
}

// K2 + K10: K2's interleaved operands (as pyfft_local_rows_il's) with the
// f-point int8 stage last, f = 2^log2f the last factor of JAX's default
// chain at this n (PYFFT_I8_CHAINS and (11, 7)); `wch` as
// pyfft_local_rows_i8's.  `out` may be `in` (in place).
extern "C" int pyfft_local_rows_il_i8(const void* in, void* out,
                                      const void* tw, const void* wch,
                                      int rows, int log2n, int log2f,
                                      int in_rs, int out_rs, int sign,
                                      float postscale, void* stream) {
  const Io<float> io{nullptr, nullptr, nullptr, nullptr,
                     static_cast<const float2*>(in), static_cast<float2*>(out),
                     rows, 1, in_rs, 1, out_rs, postscale};
  return (int)dispatch_i8<true>(log2n, log2f, io, tw, wch, sign, stream);
}

// The stage the int8 row kernels (K1 + K10, K2 + K10) run at (log2n,
// log2f): 1 the wgmma stage, 0 the mma.sync one, -1 where no kernel is
// instantiated.
extern "C" int pyfft_local_rows_i8_stage(int log2n, int log2f) {
#define PYFFT_I8_STAGE(LN, LF) \
  if (log2n == LN && log2f == LF) return RowI8<LN, LF>::TC ? 1 : 0;
  PYFFT_I8_CHAINS(PYFFT_I8_STAGE)
  PYFFT_I8_STAGE(11, 7)
#undef PYFFT_I8_STAGE
  return -1;
}

// The row ring at log2n (PYFFT_ROWS_RING) into out[0..4]: rows a slot,
// threads a block, slots, a block's shared memory in bytes and the blocks
// an SM holds on the current device (asked of the card, which sets the
// kernel's shared memory there).  Returns 1, 0 where the length runs
// local_rows_kernel, or minus a cudaError_t.
#define PYFFT_RING_SHAPE(LN, RPB, S)                                   \
  if (log2n == LN) {                                                   \
    using K = RowRing<Real, LN, RPB, S>;                               \
    int sms = 0, per = 0;                                              \
    const cudaError_t e = ring_rows_wave<Real, LN, RPB, S>(sms, per);  \
    if (e != cudaSuccess) return -(int)e;                              \
    out[0] = RPB;                                                      \
    out[1] = K::NT;                                                    \
    out[2] = S;                                                        \
    out[3] = K::SMEM;                                                  \
    out[4] = per;                                                      \
    return 1;                                                          \
  }
extern "C" int pyfft_local_rows_ring_shape(int log2n, int* out) {
  using Real = float;
  PYFFT_ROWS_RING(PYFFT_RING_SHAPE)
  return 0;
}

// The same for the complex128 ring (PYFFT_ROWS_RING_F64), K11's.
extern "C" int pyfft_local_rows_ring_shape_f64(int log2n, int* out) {
  using Real = double;
  PYFFT_ROWS_RING_F64(PYFFT_RING_SHAPE)
  return 0;
}
#undef PYFFT_RING_SHAPE

