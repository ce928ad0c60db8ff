// Batched length-n complex DFT along the middle axis of (L, n, T) planes:
// the "local" column kernels of pyfft_tpu_torch, complex64 (K5) and
// complex128 (K12).
//
// Replaces the JAX package's Pallas column kernels: for complex64
// pyfft_tpu/ops/pallas_local.py `_col_kernel`, launched by
// `_fft_cols_inner` through `pl.pallas_call`; for complex128
// pyfft_tpu/ops/pallas_df64.py `_col_kernel_df64`, launched by
// `_fft_cols_df64`.  The first takes (1, n, 128) blocks, whose transform
// axis already sits on the TPU's sublanes, through DFT-matrix stages on the
// matrix unit; the second emulates double precision with (hi, lo) float32
// pairs.  None of that carries over.  This kernel computes the same
// function with a design of its own, one template for both precisions
// (Real = float or double; native FP64 for complex128):
//
//   y[l, k, t] = postscale * tw(k, t) * sum_j x[l, j, t] * w_n^(sign*j*k)
//
// for n = 2^log2n, 8 <= n <= 8192 (float) or 4096 (double), where tw is
// one of
//
//   none        1
//   full        ta[k, t]                  = w_{tw_n}^(k*t)
//   strided     ta[t / period, k]         = w_{tw_n}^(k*(t / period))
//   factored    ta[t / 128, k] * tb[t % 128, k]
//                                         = w_{tw_n}^(k*t), from two tables
//
// (the four-step inter-pass twiddles), and the store is one of
//
//   plain       out[l, k, t]
//   swap_store  out[l, t, k]              (the four-step digit swap)
//   swap_mid    out[l, t / P, k, t % P]   (the six-step and mid-axis swap)
//
// which the output's four strides express: out offset = l*out_ls +
// k*out_ns + (t / P)*out_as + (t % P)*out_bs, with P past T when there is
// no mid swap.
//
// The plain store also computes the JAX package's fold-store column kernel
// (`_col_fold_kernel`, launched by `_fft_cols_fold` through
// `pl.pallas_call`), the 3D z pass: that kernel differs from `_col_kernel`
// only in storing the native (L, n, rows, x) layout instead of the folded
// (L, n, rows*x) one, two tilings of the TPU's memory.  On row-major memory
// the two layouts are the same bytes, so this kernel's plain store is that
// kernel's output.  Every table is built on the host in float64 (and
// rounded once to float for complex64; no device sin/cos), and passed with
// its own strides, so the wrapper lays each one out along the axis this
// kernel reads fastest.  In double the factored mode's product of its two
// tables is taken in FP64.
//
// What bounds it on an H100: bytes.  Each point is read once and written
// once (16 B a complex64 point, 32 B a complex128 one) and, in the
// twiddled modes, one table entry read (one point's size, or two small
// entries that stay in L2), against under 4 flop per byte (2 in double) by
// 5*n*log2(n).  So the design moves every point through device memory once
// each way:
//
//   * one thread block per (l, run of C consecutive t), C a power of two
//     that divides 128 (the table ColShape below: C*n complex values of
//     shared memory, at most 128 KB, and C at least one 32-byte sector of
//     each plane, 8 floats or 4 doubles, wherever that fits);
//   * except complex128 from n = 1024, where a block's 128 KB would hold
//     only 4 columns (32-byte runs, one block an SM: config 5's planar
//     plain store reached 0.29 of its bound): there a cluster of G blocks
//     takes a tile of C = 16 columns (8 on the complex form's stride-2
//     planes), 128-byte runs of each row, n/G rows a block (64 KB at n =
//     1024 and 2048, two blocks an SM), exchanging through DSMEM
//     (local_cols_x_kernel, csrc/cluster_cols.cuh; the tables
//     PYFFT_XCOLS_F64 and PYFFT_XCOLS_F64_S2 below), and at the lengths of
//     PYFFT_XRING_F64 (n = 2048) on planar planes a tensor map reads, a
//     persistent grid of such clusters walking the tiles through a ring of
//     slots fed by tensor-map copies (local_cols_xring_kernel);
//   * blocks are numbered with l fastest, so neighbouring blocks read the
//     same rows of a `full` twiddle table and share them in the L2;
//   * the first stage reads the tile straight from global memory, threads
//     running along t (coalesced); a Stockham radix-8 chain along n (a
//     radix-2 or radix-4 stage first when log2n is not a multiple of 3)
//     goes through one shared buffer laid out [k][c], leaving the result
//     in natural order with no bit-reversal pass; a thread holds all its
//     butterflies in registers across a barrier before it writes, so one
//     buffer is enough;
//   * the last stage leaves the result in shared memory, and a store pass
//     applies twiddle and postscale and writes it with threads running
//     along t (plain, swap_mid) or along k (swap_store, from a [c][k]
//     buffer padded by one element per column against bank conflicts), so
//     that every store is coalesced too.
//
// Every global read of a block happens in the first stage and every global
// write in the store pass, after a barrier, and blocks own disjoint (l, t)
// tiles: so a plain store may alias the input (in place).  A swapped store
// writes elsewhere than it reads and may not.  The cluster kernel keeps
// both rules: a cluster's loads all come before its first barrier.
//
// That first design is K5's only where the redesigns below do not take the
// pass.  complex64 from n = 1024 runs the cluster tile of K12 in float
// (local_cols_x_kernel<float, ...>, PYFFT_XCOLS_F32: 128-byte runs of each
// plane, every twiddle mode and store), but at the lengths of
// PYFFT_XRING_F32_S2 (n = 1024) on the complex form's stride-2 planes,
// with a plain store and no twiddle or the `full` one, K12's persistent
// cluster ring in float on (re, im) pairs (local_cols_xring_kernel<float,
// ...>); up to n = 512, a plain store with no twiddle or the `full` one on
// planes a tensor map reads runs a persistent ring of tiles fed by tensor
// copies (local_cols_pring_kernel, PYFFT_COLS_PRING, n = 16 to 256, below
// K4).  The C entry returns RAN_X, RAN_XRING or RAN_RING where they ran.
//
// Each operand is a pair of real planes with strides in elements: planar
// data has unit t stride, the two planes of torch.view_as_real of a
// complex tensor stride 2.  Offsets are 64-bit.  T and the block count
// must fit int32 (the wrapper checks).
//
// K4, the digit-swapped row pass.  It replaces
// pyfft_tpu/ops/pallas_local.py `_row_swap_kernel`, launched by
// `_fft_rows_swap` through `pl.pallas_call`: the DFT along the rows of
// (L, n1, n) planes, stored as (L, n, n1),
//
//   out[l, k, r] = postscale * sum_j x[l, r, j] * w_n^(sign*j*k),
//
// the second pass of the four-step "variant B".  With t = r that is the
// plain store above over the input read as x[l, j, t] (element stride
// in_ns, row stride in_ts).  Out of place only: rows and columns cross.
//
//   * Below n = 512 it is a policy of the column kernel (ROWS, a template
//     parameter that defaults to the column kernel's behaviour, so K5's
//     and K12's code is what it was without it): a block takes C
//     consecutive rows, and a first pass copies them into the [k][c]
//     buffer with threads running along j, in runs of KW points of one row
//     (load_rows below), and the chain starts from shared memory.
//   * From n = 512 (local_rows_swap_x_kernel, the table PYFFT_SWAP_X): a
//     cluster of G blocks takes a tile of R consecutive rows (32: each
//     output row k is one 128-byte run a plane), in decimation in
//     frequency, so that its loads stay contiguous along j.  With n = G*M,
//     j = j1*M + j2 and k = k1 + G*k2, block b loads j2 in [b*M/G,
//     (b+1)*M/G) for every j1 (G runs of M/G points a row: one box copy of
//     the tensor map a plane, rows past T as zeros), reads them into
//     registers, runs the G-point DFTs over j1, twiddles output k1 by
//     w_n^(j2*k1) and leaves it in its own buffer, from which block k1
//     reads it through DSMEM into its [j2][r] buffer; then each block runs
//     the M-point chain
//     over j2 and stores X[k1 + G*k2] with threads along r:
//       X[k1 + G*k2] = sum_j2 w_M^(j2*k2) w_n^(j2*k1)
//                      sum_j1 x[j1*M + j2] w_G^(j1*k1).
//     The decimation in time of the column tile would gather j = b +
//     G*j', one float in G of each sector.  The plain load and store of
//     the first design wrote C*4-byte runs per k (32 bytes at n = 2048).
//
// K6, the multi-tile column pass (local_cols_ring_kernel).  It replaces
// pyfft_tpu/ops/pallas_local.py `_fft_cols_ctile`'s `pl.pallas_call` (the
// body is `_col_kernel` over (1, n, c, 128) blocks): the column kernel's
// function, plain or `full` twiddle and plain store only, each of JAX's
// grid steps (l, c 128-column tiles, c*128 consecutive t) walked in runs
// of C columns.  Its first design walked them in one block a step through
// one buffer, a barrier between the runs, the next run's loads issued after
// the last one's stores: 64 blocks on 132 SMs at config 4's z pass (c = 8).
// Now:
//
//   * a ring of S slots a block (csrc/ring_cols.cuh): one thread keeps the
//     box copies (TMA) of the next S - 1 runs in flight while the block
//     runs the chain and the stores of the current one;
//   * up to n = 512 a step is `group` blocks that take alternate runs, no
//     exchange, as many as fill one wave of the card (runs of ColShape's C
//     columns, 128 bytes of each plane at n = 256);
//   * from n = 1024 (PYFFT_RING_X) a step is a cluster of G blocks that
//     takes tiles of C columns (128- or 64-byte runs), n/G rows a block,
//     through cluster_cols.cuh's exchange; the `full` twiddle of output k'
//     + M*k2 is read as w(k') * w(M*k2), both before the chain.  At n =
//     1024 a step whose blocks of whole runs (8 columns) would together
//     cover 128 bytes of a row takes those instead (launch_ring_at).
//
// Both read the planar planes or the complex form's stride-2 planes,
// 16-byte aligned (the tensor maps' rules; the wrappers copy an input of
// any other layout first).  Every run a block stores is one it loaded,
// and the runs of a step are disjoint, so the plain store may alias the
// input (in place), as the column kernel's.
//
// K5 + K10, the int8 policy (precision="int8", complex64 planes).  The
// chain's last stage is the f-point int8-split stage of int8_stage.cuh (f
// the last factor of the JAX column chain) in place of the last radix-8
// stages: the leading radix-2/4/8 stages cover log2(n/f) bits in the
// [k][c] buffer (at n = f a plain load fills it), then the stage takes its
// alignment exponent over the block's C columns of one l and writes its
// output in the store pass's layout, and K5's store pass (twiddle,
// postscale, plain or swapped store) follows unchanged.  The int8 kernel
// takes half K5's bytes a block (ColShape's I8: C = 128 up to n = 32, 64,
// 32, 16, then 8 at n = 512 and 1024, 4, 2 and 1 at n = 8192), the room
// the first version's second buffer took.  For the swapped store the stage
// writes the padded [c][k] layout itself.  The stage is int8_stage_tc, on
// wgmma, wherever f >= 32 (every shape has 128 threads a block or more;
// ColI8::TC): x's channels and then its outputs take the [k][c] buffer's
// place, W's slabs follow it, copied from kernel entry on, so a block
// holds one buffer and W (two blocks an SM at 1024 to 8192 points).  At f
// = 16 the mma.sync stage, which writes a second buffer.  A kernel of its
// own (local_cols_i8_kernel), so K5's, K12's, K4's and K6's code is what
// it was.  In place for the plain store, as K5.
//
// K4 + K10 (precision="int8" on the digit-swapped row pass) is that int8
// kernel with K4's row load (policy ROWS: load_rows on the int8 shape,
// then the lead stages from shared memory) and the stage's outputs
// written straight to device memory (SwapMap: no second buffer, no store
// pass), launched through pyfft_local_rows_swap_i8 on K4's strides: input
// (l, j, row), output (l, k, 0, row), no twiddle, f the last factor of the JAX
// package's default chain (`_fft_rows_swap` takes `default_factors`, so f
// = 128 at n = 2048, not 64 as in the column chain; the entry
// instantiates that one pair beside PYFFT_I8_CHAINS).  A block takes the
// int8 kernel's C rows, a divisor of 128, and takes one alignment exponent
// for each run of gcd(C, lanes) of them (the wrapper's `group`), so every
// group lies inside one of JAX's blocks of `lanes` rows, whatever `lanes`
// divides the row count.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry points `pyfft_local_cols` (float),
// `pyfft_local_cols_f64` (double), `pyfft_local_rows_swap` (K4),
// `pyfft_local_cols_ctile` (K6), `pyfft_local_cols_i8` (float, int8
// stage) and `pyfft_local_rows_swap_i8` (K4 + K10), the column widths,
// the cluster kernel's shape (`pyfft_local_cols_xshape_f64`,
// `pyfft_local_cols_xshape`), the persistent rings'
// (`pyfft_local_cols_pring_shape`, `pyfft_local_cols_xring_shape_f64`,
// `pyfft_local_cols_xring_shape`) and
// K4's and K6's
// (`pyfft_local_rows_swap_shape`, `pyfft_local_cols_ring_shape`), at the
// bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chain.cuh"
#include "cluster_cols.cuh"
#include "int8_stage.cuh"
#include "ring_cols.cuh"
#include "stockham.cuh"

namespace {

using namespace pyfft;
namespace cg = cooperative_groups;

enum TwMode { TW_NONE = 0, TW_TABLE = 1, TW_FACTORED = 2 };

// How a block finds its data: the column kernel's (K5, K12), K4's row load
// (below n = 1024), K6's ring (its own kernel).
enum Policy { COLS = 0, ROWS = 1, WALK = 2 };

template <typename Real>
struct Cols {
  using V = typename Complex<Real>::V;
  const Real* in_re;
  const Real* in_im;
  Real* out_re;
  Real* out_im;
  const V* ta;   // twiddle table, ta[k*ak + q*aq]
  const V* tb;   // factored mode's second table, tb[k*bk + (t%128)*bq]
  long long L, T;
  long long in_ls, in_ns, in_ts;
  long long out_ls, out_ns, out_as, out_bs, P;
  long long ak, aq, adiv;   // q = t when adiv == 1, else t / adiv
  long long bk, bq;
  int tw_mode;
  Real post;
};

// The columns a block takes at length n, in bytes of its complex type:
// C = max(min(128, WIDE / (n * size)), min(SECTOR / real size,
// DEEP / (n * size))), so WIDE bytes a block while that allows 128 columns
// or more than one 32-byte sector of each plane, and else at least a
// sector's columns (8 floats, 4 doubles) within DEEP bytes.  For complex64
// that is the rule of 8192 and 16384 points.
constexpr int WIDE = 64 * 1024;
constexpr int DEEP = 128 * 1024;
constexpr int SECTOR = 32;

// I8: the int8 kernel's shape, half the bytes (its stage writes a second
// buffer).
template <int LOGN, typename Real, bool I8 = false>
struct ColShape {
  static constexpr int N = 1 << LOGN;
  static constexpr int BYTES = N * 2 * (int)sizeof(Real);   // one column
  static constexpr int W = WIDE / (I8 ? 2 : 1) / BYTES;
  static constexpr int D = DEEP / (I8 ? 2 : 1) / BYTES;
  static constexpr int S = SECTOR / (int)sizeof(Real);
  static constexpr int C_WIDE = W < 128 ? W : 128;
  static constexpr int C_DEEP = D < S ? D : S;
  static constexpr int C = C_WIDE > C_DEEP ? C_WIDE : C_DEEP;  // columns
  static constexpr int P = N * C;                         // points per block
  static constexpr int NT = P / 8 < 512 ? P / 8 : 512;   // threads per block
  static constexpr int REM = LOGN % 3;
  static constexpr int NSTAGES = LOGN / 3 + (REM ? 1 : 0);
  static_assert(C >= 1 && 128 % C == 0, "a block's t-run must not cross 128");
};

// One radix-R Stockham stage over the block's C columns.  NS is the product
// of the radices of the stages before it.  FIRST reads global memory; every
// stage writes shared memory, LAST in the store pass's layout.
template <typename Real, int N, int C, int NT, int R, int NS, bool FIRST,
          bool LAST, bool SWAP>
__device__ __forceinline__ void stage(const Cols<Real>& io,
                                      typename Complex<Real>::V* sm,
                                      const typename Complex<Real>::V*
                                          __restrict__ tw,
                                      long long l, long long t0, Real s) {
  using V = typename Complex<Real>::V;
  constexpr int NR = N / R;          // butterflies per column
  constexpr int B = NR * C / NT;     // butterflies per thread
  static_assert(B * R * NT == N * C, "threads must tile the block exactly");
  V v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      if (FIRST) {
        const long long t = t0 + c;
        if (t < io.T) {
          const long long o = l * io.in_ls + k * io.in_ns + t * io.in_ts;
          v[b][r] = Complex<Real>::make(io.in_re[o], io.in_im[o]);
        } else {
          v[b][r] = Complex<Real>::make(0, 0);
        }
      } else {
        v[b][r] = sm[k * C + c];
      }
    }
    if (NS > 1) {
      const int jj = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (N / (NS * R))]));
    }
    dft<R>(v[b], s);
  }
  // a stage after the first reads and writes the same buffer: reads first
  if (!FIRST) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = base + r * NS;
      sm[(LAST && SWAP) ? c * (N + 1) + k : k * C + c] = v[b][r];
    }
  }
  __syncthreads();
}

// The chain from stage STAGE on.  LOADED: the block's data is already in
// the [k][c] buffer (K4), so stage 0 reads shared memory too.
template <typename Real, int LOGN, bool SWAP, int STAGE, int NS,
          bool LOADED = false>
__device__ __forceinline__ void stages(const Cols<Real>& io,
                                       typename Complex<Real>::V* sm,
                                       const typename Complex<Real>::V*
                                           __restrict__ tw,
                                       long long l, long long t0, Real s) {
  using S = ColShape<LOGN, Real>;
  constexpr int R = (STAGE == 0 && S::REM) ? (1 << S::REM) : 8;
  stage<Real, S::N, S::C, S::NT, R, NS, STAGE == 0 && !LOADED,
        STAGE == S::NSTAGES - 1, SWAP>(io, sm, tw, l, t0, s);
  if constexpr (STAGE + 1 < S::NSTAGES)
    stages<Real, LOGN, SWAP, STAGE + 1, NS * R, LOADED>(io, sm, tw, l, t0, s);
}

// K4's load: the block's C rows x[l, j, t0 + c] (j along a row, in_ns
// apart; rows in_ts apart) into the [k][c] buffer, element e of a thread
// at j = (e / (KW*C))*KW + e % KW of row c = (e / KW) % C.  A warp reads
// KW consecutive points of each of up to 32/KW rows: KW = 8 (a 32-byte
// sector of each plane) where C <= 8, else 4, so the buffer's stores (a
// half-warp's 8-byte stores k*C + c apart) meet at most four-way bank
// conflicts.  A thread issues all its loads before its first store, so
// they are all in flight at once (one block an SM at n >= 1024).  Rows
// past T read as 0.  I8: on the int8 kernel's shape (K4 + K10).
template <typename Real, int LOGN, bool I8 = false>
__device__ __forceinline__ void load_rows(const Cols<Real>& io,
                                          typename Complex<Real>::V* sm,
                                          long long l, long long t0) {
  using S = ColShape<LOGN, Real, I8>;
  using V = typename Complex<Real>::V;
  constexpr int C = S::C, E = S::P / S::NT;
  constexpr int KW = C <= 8 ? 8 : 4;
  static_assert(KW <= S::N && E * S::NT == S::P, "load runs tile the block");
  V v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + i * S::NT;
    const int c = (e / KW) % C;
    const int k = (e / (KW * C)) * KW + e % KW;
    const long long t = t0 + c;
    v[i] = Complex<Real>::make(0, 0);
    if (t < io.T) {
      const long long o = l * io.in_ls + k * io.in_ns + t * io.in_ts;
      v[i] = Complex<Real>::make(io.in_re[o], io.in_im[o]);
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + i * S::NT;
    sm[((e / (KW * C)) * KW + e % KW) * C + (e / KW) % C] = v[i];
  }
}

// The store pass: twiddle, postscale and the mode's store.  C divides 128,
// and P, the strided period and 128 are multiples of 128, so t / P,
// t / adiv and t / 128 are the same for the whole block.
template <typename Real, int LOGN, bool SWAP, bool I8 = false>
__device__ __forceinline__ void store(const Cols<Real>& io,
                                      const typename Complex<Real>::V* sm,
                                      long long l, long long t0) {
  using S = ColShape<LOGN, Real, I8>;
  using V = typename Complex<Real>::V;
  constexpr int N = S::N, C = S::C;
  const long long a0 = t0 / io.P, b0 = t0 - a0 * io.P;
  const long long q0 = io.adiv > 1 ? t0 / io.adiv : 0;
  const int r0 = static_cast<int>(t0 & 127);
#pragma unroll 4
  for (int i = 0; i < S::P / S::NT; ++i) {
    const int e = threadIdx.x + i * S::NT;
    const int k = SWAP ? e % N : e / C;
    const int c = SWAP ? e / N : e % C;
    const long long t = t0 + c;
    if (t >= io.T) continue;
    V v = sm[SWAP ? c * (N + 1) + k : k * C + c];
    if (io.tw_mode != TW_NONE) {
      const long long q = io.adiv > 1 ? q0 : t;
      V w = __ldg(&io.ta[k * io.ak + q * io.aq]);
      if (io.tw_mode == TW_FACTORED)
        w = cmul(w, __ldg(&io.tb[k * io.bk + (r0 + c) * io.bq]));
      v = cmul(v, w);
    }
    const long long o = l * io.out_ls + k * io.out_ns + a0 * io.out_as +
                        (b0 + c) * io.out_bs;
    io.out_re[o] = v.x * io.post;
    io.out_im[o] = v.y * io.post;
  }
}

// (NT is a template parameter so that no comma reaches the
// __launch_bounds__ macro)
template <typename Real, int LOGN, bool SWAP, int POLICY = COLS,
          int NT = ColShape<LOGN, Real>::NT>
__global__ void __launch_bounds__(NT)
    local_cols_kernel(Cols<Real> io,
                      const typename Complex<Real>::V* __restrict__ tw,
                      Real s) {
  using V = typename Complex<Real>::V;
  constexpr int C = ColShape<LOGN, Real>::C;
  // one raw buffer for both precisions: extern __shared__ arrays of
  // different types in one translation unit must not share a name
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* sm = reinterpret_cast<V*>(smem_raw);
  // l fastest: neighbouring blocks work on the same t-run
  const long long l = blockIdx.x % io.L;
  const long long t0 = (blockIdx.x / io.L) * C;
  if constexpr (POLICY == ROWS) {
    load_rows<Real, LOGN>(io, sm, l, t0);
    __syncthreads();
    stages<Real, LOGN, SWAP, 0, 1, true>(io, sm, tw, l, t0, s);
  } else {
    stages<Real, LOGN, SWAP, 0, 1>(io, sm, tw, l, t0, s);
  }
  store<Real, LOGN, SWAP>(io, sm, l, t0);
}

template <typename Real, int LOGN, bool SWAP, int POLICY>
cudaError_t launch(const Cols<Real>& io, const typename Complex<Real>::V* tw,
                   Real s, cudaStream_t stream) {
  using S = ColShape<LOGN, Real>;
  const int smem = (SWAP ? (S::N + 1) * S::C : S::N * S::C) *
                   (int)sizeof(typename Complex<Real>::V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_cols_kernel<Real, LOGN, SWAP, POLICY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (io.T + S::C - 1) / S::C * io.L;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  local_cols_kernel<Real, LOGN, SWAP, POLICY>
      <<<(unsigned)blocks, S::NT, smem, stream>>>(io, tw, s);
  return cudaGetLastError();
}

// log2n -> launch<Real, log2n, SWAP, POLICY>, for log2n in [3, MAXLOG].
template <typename Real, int MAXLOG, bool SWAP, int POLICY = COLS>
cudaError_t dispatch(int log2n, const Cols<Real>& io,
                     const typename Complex<Real>::V* tw, Real s,
                     cudaStream_t st) {
  if (log2n > MAXLOG) return cudaErrorInvalidValue;
  switch (log2n) {
    case 3: return launch<Real, 3, SWAP, POLICY>(io, tw, s, st);
    case 4: return launch<Real, 4, SWAP, POLICY>(io, tw, s, st);
    case 5: return launch<Real, 5, SWAP, POLICY>(io, tw, s, st);
    case 6: return launch<Real, 6, SWAP, POLICY>(io, tw, s, st);
    case 7: return launch<Real, 7, SWAP, POLICY>(io, tw, s, st);
    case 8: return launch<Real, 8, SWAP, POLICY>(io, tw, s, st);
    case 9: return launch<Real, 9, SWAP, POLICY>(io, tw, s, st);
    case 10: return launch<Real, 10, SWAP, POLICY>(io, tw, s, st);
    case 11: return launch<Real, 11, SWAP, POLICY>(io, tw, s, st);
    case 12: return launch<Real, 12, SWAP, POLICY>(io, tw, s, st);
    case 13:
      if constexpr (MAXLOG >= 13)
        return launch<Real, 13, SWAP, POLICY>(io, tw, s, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename Real, int MAXLOG, bool I8 = false>
int width(int log2n) {
  if (log2n > MAXLOG) return 0;
  switch (log2n) {
    case 3: return ColShape<3, Real, I8>::C;
    case 4: return ColShape<4, Real, I8>::C;
    case 5: return ColShape<5, Real, I8>::C;
    case 6: return ColShape<6, Real, I8>::C;
    case 7: return ColShape<7, Real, I8>::C;
    case 8: return ColShape<8, Real, I8>::C;
    case 9: return ColShape<9, Real, I8>::C;
    case 10: return ColShape<10, Real, I8>::C;
    case 11: return ColShape<11, Real, I8>::C;
    case 12: return ColShape<12, Real, I8>::C;
    case 13: return ColShape<13, Real, I8>::C;
    default: return 0;
  }
}

// The operands and `dims` (see pyfft_local_cols) as a Cols.
template <typename Real>
Cols<Real> cols_io(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* ta, const void* tb,
                   const long long* dims, Real postscale) {
  using V = typename Complex<Real>::V;
  Cols<Real> io;
  io.in_re = static_cast<const Real*>(in_re);
  io.in_im = static_cast<const Real*>(in_im);
  io.out_re = static_cast<Real*>(out_re);
  io.out_im = static_cast<Real*>(out_im);
  io.ta = static_cast<const V*>(ta);
  io.tb = static_cast<const V*>(tb);
  io.L = dims[0];
  io.T = dims[1];
  io.in_ls = dims[2];
  io.in_ns = dims[3];
  io.in_ts = dims[4];
  io.out_ls = dims[5];
  io.out_ns = dims[6];
  io.out_as = dims[7];
  io.out_bs = dims[8];
  io.P = dims[9];
  io.ak = dims[10];
  io.aq = dims[11];
  io.adiv = dims[12];
  io.bk = dims[13];
  io.bq = dims[14];
  io.tw_mode = static_cast<int>(dims[15]);
  io.post = postscale;
  return io;
}

// ------------------------------------------------ K5 + K10 (int8 policy)

// The radix-2/4/8 stages in front of the int8 stage: log2(n/f) bits, the
// odd ones first, each writing the [k][c] buffer.  LOADED: the block's
// data is already in it (K4's row load), so the first reads it there.
template <int LOGN, int LOGF, int STAGE, int NS, bool LOADED = false>
__device__ __forceinline__ void lead_stages(const Cols<float>& io, float2* sm,
                                            const float2* __restrict__ tw,
                                            long long l, long long t0,
                                            float s) {
  using S = ColShape<LOGN, float, true>;
  constexpr int LB = LOGN - LOGF, REM = LB % 3;
  constexpr int NL = LB / 3 + (REM ? 1 : 0);
  constexpr int R = (STAGE == 0 && REM) ? (1 << REM) : 8;
  stage<float, S::N, S::C, S::NT, R, NS, STAGE == 0 && !LOADED, false,
        false>(io, sm, tw, l, t0, s);
  if constexpr (STAGE + 1 < NL)
    lead_stages<LOGN, LOGF, STAGE + 1, NS * R, LOADED>(io, sm, tw, l, t0, s);
}

// At n = f: the block's columns into the [k][c] buffer, t past T as 0.
template <int LOGN>
__device__ __forceinline__ void load_block(const Cols<float>& io, float2* sm,
                                           long long l, long long t0) {
  using S = ColShape<LOGN, float, true>;
  for (int e = threadIdx.x; e < S::P; e += S::NT) {
    const int c = e % S::C, k = e / S::C;
    const long long t = t0 + c;
    float2 v = make_float2(0.f, 0.f);
    if (t < io.T) {
      const long long o = l * io.in_ls + k * io.in_ns + t * io.in_ts;
      v = make_float2(io.in_re[o], io.in_im[o]);
    }
    sm[e] = v;
  }
  __syncthreads();
}

// The int8 stage's view of the block: column q = (run j, column c) with
// c = q % C, element r at (j + r*NS)*C + c; outputs into `out` in the store
// pass's layout ([c][k] padded for the swapped store): the second buffer
// for int8_stage, the float buffer's place for int8_stage_tc (INTO_X).
template <int LOGN, int LOGF, bool SWAP>
struct ColMap {
  using S = ColShape<LOGN, float, true>;
  static constexpr int N = S::N, C = S::C, NS = N >> LOGF, Q = C * NS;
  static constexpr bool INTO_X = true, GROUPS = false;
  float* out;
  __device__ int index(int q, int r) const {
    return (q / C + r * NS) * C + q % C;
  }
  __device__ int jof(int q) const { return q / C; }
  // the second buffer's slot of output k of column q
  __device__ int slot(int q, int k) const {
    const int kk = q / C + k * NS, c = q % C;
    return SWAP ? c * (N + 1) + kk : kk * C + c;
  }
  __device__ void put(int q, int k, int part, float v) const {
    out[2 * slot(q, k) + part] = v;
  }
  // Output k of columns q and q + 1 (q even): in the plain layout their
  // slots are q + k*Q and the next, one 16-byte store.
  __device__ void put2(int q, int k, float2 re, float2 im) const {
    float2* y = reinterpret_cast<float2*>(out);
    if constexpr (SWAP) {
      y[slot(q, k)] = make_float2(re.x, im.x);
      y[slot(q + 1, k)] = make_float2(re.y, im.y);
    } else {
      *reinterpret_cast<float4*>(y + slot(q, k)) =
          make_float4(re.x, im.x, re.y, im.y);
    }
  }
};

// K4 + K10's view of the block: ColMap's columns (run j, row c of the
// block's C), its outputs straight to device memory as the store pass's
// plain store without twiddle would write them, out[l, kk, t0 + c] *
// postscale, kk = j + k*NS.  Its alignment groups are the runs of `grp`
// rows (a power of two dividing C, and JAX's `lanes`: gcd(C, lanes)), each
// inside one of JAX's groups of `lanes` rows; their amax in `gmax`.
template <int LOGN, int LOGF>
struct SwapMap {
  using S = ColShape<LOGN, float, true>;
  static constexpr int N = S::N, C = S::C, NS = N >> LOGF, Q = C * NS;
  static constexpr bool INTO_X = false, GROUPS = true;
  float* out_re;
  float* out_im;
  long long base, out_ns, out_bs, rows;   // base: l*out_ls + t0*out_bs
  float post;
  int grp;
  unsigned* gmax;
  __device__ int group(int q) const { return (q % C) / grp; }
  __device__ int index(int q, int r) const {
    return (q / C + r * NS) * C + q % C;
  }
  __device__ int jof(int q) const { return q / C; }
  __device__ long long offset(int q, int k) const {
    return base + (long long)(q / C + k * NS) * out_ns +
           (long long)(q % C) * out_bs;
  }
  __device__ void put(int q, int k, int part, float v) const {
    if (q % C >= rows) return;
    (part ? out_im : out_re)[offset(q, k)] = v * post;
  }
  // Output k of columns q and q + 1 (q even): rows c, c + 1 of one run
  // where C >= 2 (8-byte stores of each plane where the rows are adjacent
  // and aligned), else the next run.
  __device__ void put2(int q, int k, float2 re, float2 im) const {
    const long long o = offset(q, k);
    if (C >= 2 && out_bs == 1 && q % C + 1 < rows &&
        ((reinterpret_cast<uintptr_t>(out_re + o) |
          reinterpret_cast<uintptr_t>(out_im + o)) & 7) == 0) {
      *reinterpret_cast<float2*>(out_re + o) =
          make_float2(re.x * post, re.y * post);
      *reinterpret_cast<float2*>(out_im + o) =
          make_float2(im.x * post, im.y * post);
    } else {
      put(q, k, 0, re.x);
      put(q, k, 1, im.x);
      put(q + 1, k, 0, re.y);
      put(q + 1, k, 1, im.y);
    }
  }
};

// The int8 kernel's plan: its stage (TC, the wgmma one wherever f >= 32)
// and its shared memory.  Under COLS the mma.sync stage reads the [k][c]
// buffer and writes a second one in the store pass's layout (padded
// [c][k] for the swapped store); the wgmma stage cuts x's channels into
// the [k][c] buffer's place and, once its products are done, writes its
// outputs there too (ColMap::INTO_X), so one buffer of the larger layout.
// Under ROWS (K4 + K10) either stage writes device memory (SwapMap), so
// the [k][c] buffer alone.  W's slab buffers follow.
template <int LOGN, int LOGF, bool SWAP, int POLICY>
struct ColI8 {
  using S = ColShape<LOGN, float, true>;
  static constexpr int F = 1 << LOGF;
  static constexpr int Q = S::C * (S::N >> LOGF);     // the Maps' Q
  static constexpr int DATA = S::P * (int)sizeof(float2);
  static constexpr int Y = POLICY == ROWS ? 0
                           : (SWAP ? (S::N + 1) * S::C : S::P) *
                                 (int)sizeof(float2);
  static constexpr bool TC = tc_stage(F, S::NT);
  static constexpr int HOST = TC ? (cmax(DATA, Y) + 127) / 128 * 128 : 0;
  using Plan = TcPlan<F, S::NT, Q, HOST, POLICY != ROWS>;
  static constexpr int SMEM = TC ? HOST + Plan::W_BYTES : DATA + Y;
  // n = 8192 (C = 1, f = 128), swapped: 64 KB + 8 bytes of buffer and two
  // 48 KB slabs
  static_assert(SMEM + 1024 <= 227 * 1024, "fits a block's shared memory");
};

// `wch` holds the 3 (2f x 2f) channels, then W's image (w_image_offset).
// POLICY: COLS, or ROWS for K4 + K10 (K4's row load, alignment groups of
// `grp` rows).
template <int LOGN, int LOGF, bool SWAP, int POLICY = COLS,
          int NT = ColShape<LOGN, float, true>::NT>
__global__ void __launch_bounds__(NT)
    local_cols_i8_kernel(Cols<float> io, const float2* __restrict__ tw,
                         float s, const int8_t* __restrict__ wch, int grp) {
  using S = ColShape<LOGN, float, true>;
  using K = ColI8<LOGN, LOGF, SWAP, POLICY>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[NT / 32];
  __shared__ uint64_t bars[W_BARS];
  __shared__ unsigned gmax[POLICY == ROWS ? 128 : 1];   // a group's amax
  float2* sm = reinterpret_cast<float2*>(smem_raw);
  float2* y = K::TC ? sm : sm + S::P;   // where the stage's outputs go
  WBufs w{reinterpret_cast<int8_t*>(smem_raw + K::HOST), bars, 0u, 0u};
  if constexpr (K::TC)
    w = tc_fetch_w<typename K::Plan>(wch + w_image_offset(K::F), w.sm, bars);
  if constexpr (POLICY == ROWS) {       // zeroed before load_rows' barrier
    for (int i = threadIdx.x; i < 128; i += NT) gmax[i] = 0u;
  }
  const long long l = blockIdx.x % io.L;
  const long long t0 = (blockIdx.x / io.L) * S::C;
  if constexpr (POLICY == ROWS) {
    load_rows<float, LOGN, true>(io, sm, l, t0);
    __syncthreads();
    if constexpr (LOGN != LOGF)
      lead_stages<LOGN, LOGF, 0, 1, true>(io, sm, tw, l, t0, s);
  } else if constexpr (LOGN == LOGF) {
    load_block<LOGN>(io, sm, l, t0);
  } else {
    lead_stages<LOGN, LOGF, 0, 1>(io, sm, tw, l, t0, s);
  }
  if constexpr (POLICY == ROWS) {
    // rows: those of the block's C that lie before T
    const SwapMap<LOGN, LOGF> map{io.out_re, io.out_im,
                                  l * io.out_ls + t0 * io.out_bs, io.out_ns,
                                  io.out_bs, io.T - t0, io.post, grp, gmax};
    host_stage<K::F, NT, K::HOST, K::TC>(map, sm, tw, wch, w, red);
  } else {
    const ColMap<LOGN, LOGF, SWAP> map{reinterpret_cast<float*>(y)};
    host_stage<K::F, NT, K::HOST, K::TC>(map, sm, tw, wch, w, red);
    __syncthreads();
    store<float, LOGN, SWAP, true>(io, y, l, t0);
  }
}

template <int LOGN, int LOGF, bool SWAP, int POLICY = COLS>
cudaError_t launch_i8(const Cols<float>& io, const float2* tw, float s,
                      const int8_t* wch, cudaStream_t stream, int grp = 1) {
  using S = ColShape<LOGN, float, true>;
  const int smem = ColI8<LOGN, LOGF, SWAP, POLICY>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_cols_i8_kernel<LOGN, LOGF, SWAP, POLICY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (io.T + S::C - 1) / S::C * io.L;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  local_cols_i8_kernel<LOGN, LOGF, SWAP, POLICY>
      <<<(unsigned)blocks, S::NT, smem, stream>>>(io, tw, s, wch, grp);
  return cudaGetLastError();
}

// ------------------- K12 and K5 from n = 1024: cluster column tiles

// (log2 n, G, C, B) of the complex128 cluster column kernel: at these
// lengths a tile of C columns (C doubles a row of each plane) is split over
// a cluster of G blocks, n/G rows a block (cluster_cols.cuh), with
// registers for B blocks an SM (its launch bounds).  Every other length
// runs local_cols_kernel.
#ifndef PYFFT_XCOLS_F64
#define PYFFT_XCOLS_F64(X) X(10, 4, 16, 2) X(11, 8, 16, 2) X(12, 8, 16, 1)
#endif
// The same for planes whose t stride is not 1 (the complex form's stride-2
// planes of interleaved pairs), where 8 columns already span 128 bytes.
#ifndef PYFFT_XCOLS_F64_S2
#define PYFFT_XCOLS_F64_S2(X) X(10, 2, 8, 2) X(11, 4, 8, 2) X(12, 8, 8, 2)
#endif
// The complex64 tables (K5 from n = 1024, every twiddle mode and store):
// 32 floats, 128 bytes of each plane a row, planar, 256 rows a block (64
// KB of shared memory); 16 pairs on the stride-2 planes, 256 rows a block
// (32 KB) up to n = 2048, then 512; registers for two blocks an SM.  At
// n = 8192 a cluster of 16 blocks (the largest) takes 16 columns, 64
// bytes a row of each plane planar.
#ifndef PYFFT_XCOLS_F32
#define PYFFT_XCOLS_F32(X) \
  X(10, 4, 32, 2) X(11, 8, 32, 2) X(12, 16, 32, 2) X(13, 16, 16, 2)
#endif
#ifndef PYFFT_XCOLS_F32_S2
#define PYFFT_XCOLS_F32_S2(X) \
  X(10, 4, 16, 2) X(11, 8, 16, 2) X(12, 8, 16, 2) X(13, 16, 16, 2)
#endif

// Whether planes of t stride `in_ts` take the _S2 table.
inline bool xcols_strided(long long in_ts) { return in_ts != 1; }

template <typename Real, int LOGN, int G, int C>
struct XCols {
  using V = typename Complex<Real>::V;
  static constexpr int M = (1 << LOGN) / G;                  // rows a block
  static constexpr int NT = M * C / 8 < 512 ? M * C / 8 : 512;
  using X = XTile<Real, LOGN - ilog2c(G), G, C, NT>;
  static constexpr int SMEM_PLAIN = X::P * (int)sizeof(V);
  // the swapped store's [c][k] buffer, padded by one element a column
  static constexpr int SMEM_SWAP = (M + 1) * C * (int)sizeof(V);
  static_assert(128 % C == 0, "a tile's t-run must not cross 128");
  static_assert(SMEM_SWAP <= 227 * 1024, "fits a block's shared memory");
};

// The column function on one (l, run of C consecutive t) tile a cluster
// (K12, and K5 in float): the tile's loads, the n/G-point chain and the
// exchange of cluster_cols.cuh, then the store pass's twiddle, postscale
// and store for each value, from registers.  The plain store (and
// swap_mid) runs threads along t; the swapped store has the chain leave
// [c][k] buffers and runs threads along k (the exchange's KMAJOR), M/G
// consecutive k of a column.
template <typename Real, int LOGN, int G, int C, int MINB, bool SWAP,
          int NT = XCols<Real, LOGN, G, C>::NT>
__global__ void __launch_bounds__(NT, MINB)
    local_cols_x_kernel(Cols<Real> io,
                        const typename Complex<Real>::V* __restrict__ tw,
                        Real s) {
  using X = typename XCols<Real, LOGN, G, C>::X;
  using V = typename Complex<Real>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* sm = reinterpret_cast<V*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // l fastest: neighbouring clusters work on the same t-run
  const long long tile = blockIdx.x / G;
  const long long l = tile % io.L, t0 = (tile / io.L) * C;
  xt_load<X>(sm, rank, [&](int c, int j) {
    const long long t = t0 + c;
    if (t >= io.T) return Complex<Real>::make(0, 0);
    const long long o = l * io.in_ls + j * io.in_ns + t * io.in_ts;
    return Complex<Real>::make(io.in_re[o], io.in_im[o]);
  });
  __syncthreads();
  xt_chain<X, SWAP>(sm, tw, s);
  // as `store`: t / P, t / adiv and t / 128 are the same for the tile
  const long long a0 = t0 / io.P, b0 = t0 - a0 * io.P;
  const long long q0 = io.adiv > 1 ? t0 / io.adiv : 0;
  const int r0 = static_cast<int>(t0 & 127);
  // the store pass's twiddle of output k of column c (t = t0 + c)
  const auto twiddle = [&](int c, long long t, int k) {
    const long long q = io.adiv > 1 ? q0 : t;
    V w = __ldg(&io.ta[k * io.ak + q * io.aq]);
    if (io.tw_mode == TW_FACTORED)
      w = cmul(w, __ldg(&io.tb[k * io.bk + (r0 + c) * io.bq]));
    return w;
  };
  // outputs k = k' + M*k2 of column c: at a fixed t every mode's twiddle
  // is w^(k*q) for one root w, so w(k' + M*k2) = w(k') * w(M)^k2, two
  // table reads for the G outputs
  const auto out = [&](int c, int kp, const V* y) {
    const long long t = t0 + c;
    if (t >= io.T) return;
    V w = Complex<Real>::make(1, 0), step = w;
    if (io.tw_mode != TW_NONE) {
      w = twiddle(c, t, kp);
      step = twiddle(c, t, X::M);
    }
    const long long o = l * io.out_ls + a0 * io.out_as + (b0 + c) * io.out_bs;
#pragma unroll
    for (int k2 = 0; k2 < G; ++k2) {
      V v = y[k2];
      if (io.tw_mode != TW_NONE) {
        v = cmul(v, w);
        w = cmul(w, step);
      }
      const long long ok = o + (kp + X::M * k2) * io.out_ns;
      io.out_re[ok] = v.x * io.post;
      io.out_im[ok] = v.y * io.post;
    }
  };
  xt_exchange<X, SWAP>(cluster, sm, tw, s, 0, rank, out);
}

template <typename Real, int LOGN, int G, int C, int MINB, bool SWAP>
cudaError_t launch_x(const Cols<Real>& io,
                     const typename Complex<Real>::V* tw, Real s,
                     cudaStream_t stream) {
  using K = XCols<Real, LOGN, G, C>;
  const long long tiles = (io.T + C - 1) / C * io.L;
  return launch_cluster<K::NT>(
      local_cols_x_kernel<Real, LOGN, G, C, MINB, SWAP>, tiles, G,
      SWAP ? K::SMEM_SWAP : K::SMEM_PLAIN, stream, io, tw, s);
}

// ------------------------------------------- K6: a ring of runs a block

// The slots of K6's ring: the runs of a block in shared memory at once,
// S - 1 of them loading while one is transformed.
constexpr int RING_SLOTS = 3;
// (log2 n, G, C) where a cluster of G blocks takes each tile of C columns
// of a K6 step, n/G rows a block, exchanging through DSMEM
// (cluster_cols.cuh).  Up to n = 1024 a length missing here runs a step as
// `group` blocks of whole runs of ColShape's C columns; from n = 2048 every
// length must be here.
#ifndef PYFFT_RING_X
#define PYFFT_RING_X(X) X(10, 4, 32) X(11, 16, 32) X(12, 8, 16) X(13, 16, 16)
#endif
// The most rows a box of a tensor copy takes (the copy engine's limit).
constexpr int BOX = 256;

template <int LOGN, int G, int C>
struct Ring {
  static constexpr int S = RING_SLOTS;
  static constexpr int M = (1 << LOGN) / G;                  // rows a block
  static constexpr int MB = M < BOX ? M : BOX;               // rows a box
  // at most 512, one butterfly of every stage and one (k', c) of the
  // exchange a thread
  static constexpr int NT = cmin(cmin(M * C / 8, M / G * C), 512);
  using X = XTile<float, LOGN - ilog2c(G), G, C, NT>;
  static constexpr int SLOT = X::P * (int)sizeof(float2);
  static constexpr int SMEM = S * SLOT + 128;                // + alignment
  static_assert(S >= 2 && SMEM <= 227 * 1024,
                "the ring fits a block's shared memory");
  static_assert(C % 4 == 0 && 128 % C == 0 && M % MB == 0,
                "a run's row of a plane is whole 16-byte units of one tile");
};

// K6's operands: planar planes (t stride 1) or the complex form's stride-2
// planes (the imaginary plane one float after the real one), 16-byte
// aligned, their (l, n) strides multiples of 16 bytes (the tensor maps').
inline bool ring_operands(const Cols<float>& io) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(io.in_re);
  const uintptr_t b = reinterpret_cast<uintptr_t>(io.in_im);
  const bool planar = io.in_ts == 1 && b % 16 == 0;
  const bool pairs = io.in_ts == 2 && b == a + sizeof(float);
  return (planar || pairs) && a % 16 == 0 && io.in_ns % 4 == 0 &&
         (io.L == 1 || io.in_ls % 4 == 0);
}

// K6's tensor map of the plane (or the pairs) at `base`: {T, G, n/G, L},
// its box the C columns of MB rows rank + G*j'.
template <int LOGN, int G, int C>
cudaError_t ring_map(CUtensorMap* map, const float* base,
                     const Cols<float>& io) {
  using K = Ring<LOGN, G, C>;
  const cuuint64_t row = (cuuint64_t)io.in_ns * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)io.T, (cuuint64_t)G,
                              (cuuint64_t)K::M, (cuuint64_t)io.L};
  const cuuint64_t strides[3] = {
      row, row * G, io.L > 1 ? (cuuint64_t)io.in_ls * 4 : row * (1 << LOGN)};
  const cuuint32_t box[4] = {(cuuint32_t)C, 1, (cuuint32_t)K::MB, 1};
  return tensor_map_4d(map, base, io.in_ts == 2, dims, strides, box);
}

// K6: `ctile` 128-column tiles of one l a step, walked in runs of C
// columns.  G > 1: a cluster of G blocks a step that splits each run (rows
// rank + G*j' a block) and exchanges through DSMEM; G = 1: `group` blocks
// a step, block `rank` taking runs rank, rank + group, ...  A block walks
// its runs through the ring: run i in slot i % S, on barrier bars[i % S],
// copied by thread 0 in boxes of the tensor maps (map_im unused on pairs).
template <int LOGN, int G, int C, int NT = Ring<LOGN, G, C>::NT>
__global__ void __launch_bounds__(NT)
    local_cols_ring_kernel(Cols<float> io, const float2* __restrict__ tw,
                           float s, int ctile, int group,
                           const __grid_constant__ CUtensorMap map_re,
                           const __grid_constant__ CUtensorMap map_im) {
  using K = Ring<LOGN, G, C>;
  using X = typename K::X;
  constexpr int S = K::S, P = X::P, M = X::M, MB = K::MB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[S];
  float2* slots = align128(smem_raw);
  const int g = G > 1 ? G : group;
  const int rank = static_cast<int>(blockIdx.x % g);
  const long long step = blockIdx.x / g;
  // l fastest: neighbouring steps read the same rows of a `full` table
  const long long l = step % io.L;
  const long long base = (step / io.L) * 128LL * ctile;
  const int runs = ctile * (128 / C);
  const int first = G > 1 ? 0 : rank, every = G > 1 ? 1 : g;
  const int count = first < runs ? (runs - first + every - 1) / every : 0;
  const bool split = io.in_ts == 1;     // planar, else stride-2 pairs
  // this block's run i into slot i % S: M rows, of each plane or of pairs
  const auto issue = [&](int i) {
    uint64_t* bar = &bars[i % S];
    float* dst = reinterpret_cast<float*>(slots + (i % S) * P);
    const int t0 = static_cast<int>(base + (long long)(first + i * every) * C);
    fence_async_smem();
    mbar_expect(bar, P * (int)sizeof(float2));
    for (int part = 0; part < (split ? 2 : 1); ++part)
      for (int h = 0; h < M / MB; ++h)
        tma_load_4d(dst + (split ? part * P + h * MB * C : 2 * h * MB * C),
                    part ? &map_im : &map_re, t0, G > 1 ? rank : 0, h * MB,
                    static_cast<int>(l), bar);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < S; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < S && j < count; ++j) issue(j);
  }
  __syncthreads();                  // the barriers are set up
  for (int i = 0; i < count; ++i) {
    // thread 0 fills the slot of run i - 1, whose readers are past a
    // barrier, with run i + S - 1
    if (threadIdx.x == 0 && i && i + S - 1 < count) issue(i + S - 1);
    float2* sm = slots + (i % S) * P;
    const float* f = reinterpret_cast<const float*>(sm);
    const long long t0 = base + (long long)(first + i * every) * C;
    const float2* t = fresh(tw);
    const bool twd = io.tw_mode != TW_NONE;
    // G > 1: the `full` twiddles of this run's outputs, read before its
    // chain so that their latency hides behind it: w(k') of each pair (k',
    // c) of the thread and w(M*k2) of its column (the same c for every
    // pair, NT being a multiple of C).  At a fixed t the twiddle is a
    // character in k: w(k' + M*k2) = w(k') * w(M*k2).
    float2 wk[G > 1 ? X::PAIRS : 1], wm[G];
    if (G > 1 && twd) {
      const long long tc = t0 + threadIdx.x % C;
#pragma unroll
      for (int q = 0; q < X::PAIRS; ++q) {
        const int kp = rank * X::KR + (threadIdx.x + q * NT) / C;
        wk[q] = __ldg(&io.ta[kp * io.ak + tc * io.aq]);
      }
#pragma unroll
      for (int k2 = 0; k2 < G; ++k2)
        wm[k2] = __ldg(&io.ta[(long long)(M * k2) * io.ak + tc * io.aq]);
    }
    mbar_wait(&bars[i % S], (i / S) & 1);
    xt_chain_from<X>(sm, t, s, [&](int k, int c) {
      return split ? make_float2(f[k * C + c], f[P + k * C + c])
                   : sm[k * C + c];
    });
    if constexpr (G > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      // outputs k' + M*k2 of column c, pair q of the thread
      const auto put = [&](int c, int kp, const float2* y, int q) {
        const long long tc = t0 + c;
        const long long o = l * io.out_ls + tc * io.out_bs;
#pragma unroll
        for (int k2 = 0; k2 < G; ++k2) {
          float2 v = y[k2];
          if (twd) v = cmul(v, k2 ? cmul(wk[q], wm[k2]) : wk[q]);
          const long long ok = o + (long long)(kp + M * k2) * io.out_ns;
          io.out_re[ok] = v.x * io.post;
          io.out_im[ok] = v.y * io.post;
        }
      };
      // ends past a cluster barrier after every block's reads of this slot
      xt_exchange<X>(cluster, sm, t, s, 0, rank, put);
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < P; e += NT) {
        const int k = e / C, c = e % C;
        const long long tc = t0 + c;
        float2 v = sm[e];
        if (twd) v = cmul(v, __ldg(&io.ta[k * io.ak + tc * io.aq]));
        const long long o = l * io.out_ls + k * io.out_ns + tc * io.out_bs;
        io.out_re[o] = v.x * io.post;
        io.out_im[o] = v.y * io.post;
      }
      __syncthreads();            // the store pass is done with the slot
    }
  }
}

// The blocks of a K6 step in whole runs of ColShape's C columns at LOGN
// (up to n = 1024), over `steps` steps of `runs` runs, into `g`: the
// largest power of two, at most `runs`, with which the grid fills at most
// one wave of the card (its SMs times the blocks an SM holds).  The wave
// is asked of the card once a device, with the kernel's shared memory set
// there for its launches.
template <int LOGN>
cudaError_t ring_group(long long steps, int runs, int& g) {
  constexpr int C = ColShape<LOGN, float>::C;
  using K = Ring<LOGN, 1, C>;
  static std::atomic<long long> waves[64];     // by device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  long long wave = waves[dev].load(std::memory_order_relaxed);
  if (!wave) {
    const auto kernel = local_cols_ring_kernel<LOGN, 1, C>;
    int sms = 0, per = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, K::NT,
                                                        K::SMEM);
    if (e != cudaSuccess) return e;
    wave = (long long)sms * (per > 1 ? per : 1);
    waves[dev].store(wave, std::memory_order_relaxed);
  }
  g = 1;
  while (2 * g <= runs && steps * 2 * g <= wave) g *= 2;
  return cudaSuccess;
}

// K6 at `ctile` tiles a step over `io`: `g` blocks a step (G = 1, whole
// runs; the kernel's shared memory set by ring_group) or a cluster of G.
template <int LOGN, int G, int C>
cudaError_t launch_ring(const Cols<float>& io, const float2* tw, float s,
                        int ctile, int g, cudaStream_t stream) {
  using K = Ring<LOGN, G, C>;
  const auto kernel = local_cols_ring_kernel<LOGN, G, C>;
  if (!ring_operands(io)) return cudaErrorInvalidValue;
  CUtensorMap mre, mim;
  cudaError_t e = ring_map<LOGN, G, C>(&mre, io.in_re, io);
  if (e != cudaSuccess) return e;
  mim = mre;
  if (io.in_ts == 1) e = ring_map<LOGN, G, C>(&mim, io.in_im, io);
  if (e != cudaSuccess) return e;
  const long long steps = io.T / (128LL * ctile) * io.L;
  if constexpr (G > 1) {
    return launch_cluster<K::NT>(kernel, steps, G, K::SMEM, stream, io, tw,
                                 s, ctile, G, mre, mim);
  } else {
    const long long blocks = steps * g;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, K::NT, K::SMEM, stream>>>(io, tw, s, ctile, g,
                                                          mre, mim);
    return cudaGetLastError();
  }
}

// K6 at LOGN: whole runs up to n = 1024, `ring_group` blocks a step, or
// the cluster tile (GX, CX) of PYFFT_RING_X.  Where both take the length
// (n = 1024): whole runs when the blocks of a step together cover 128
// bytes of each row (g * C >= 32 columns), else the cluster tile.  Over
// 2^24 points at n = 1024, c = 8 (16 steps, 8 blocks a step) runs took
// 0.135 ms and the cluster 0.233; c = 1 (128 steps, a block a step) 0.353
// and 0.181 (PERF.md section 6).
template <int LOGN, int GX = 0, int CX = 0>
cudaError_t launch_ring_at(const Cols<float>& io, const float2* tw, float s,
                           int ctile, cudaStream_t st) {
  if constexpr (LOGN <= 10) {
    constexpr int C = ColShape<LOGN, float>::C;
    int g = 0;
    const cudaError_t e =
        ring_group<LOGN>(io.T / (128LL * ctile) * io.L, 128 * ctile / C, g);
    if (e != cudaSuccess) return e;
    if (GX == 0 || g * C >= 32)
      return launch_ring<LOGN, 1, C>(io, tw, s, ctile, g, st);
  }
  if constexpr (GX > 0)
    return launch_ring<LOGN, GX, CX>(io, tw, s, ctile, GX, st);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_ring(int log2n, const Cols<float>& io,
                          const float2* tw, float s, int ctile,
                          cudaStream_t st) {
  if (ctile <= 0 || io.T % (128LL * ctile)) return cudaErrorInvalidValue;
#define PYFFT_RING(LN, GX, CX) \
  if (log2n == LN) return launch_ring_at<LN, GX, CX>(io, tw, s, ctile, st);
  PYFFT_RING_X(PYFFT_RING)
#undef PYFFT_RING
  switch (log2n) {
    case 3: return launch_ring_at<3>(io, tw, s, ctile, st);
    case 4: return launch_ring_at<4>(io, tw, s, ctile, st);
    case 5: return launch_ring_at<5>(io, tw, s, ctile, st);
    case 6: return launch_ring_at<6>(io, tw, s, ctile, st);
    case 7: return launch_ring_at<7>(io, tw, s, ctile, st);
    case 8: return launch_ring_at<8>(io, tw, s, ctile, st);
    case 9: return launch_ring_at<9>(io, tw, s, ctile, st);
    case 10: return launch_ring_at<10>(io, tw, s, ctile, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------- K12 from n = 2048 and K5 at n = 1024: a persistent cluster
// ring of tiles
//
// The column pass at the lengths of a ring table, on operands a tensor map
// reads where they lie: complex128 on planar planes (PYFFT_XRING_F64,
// xring_operands: t stride 1, both planes and their (l, n) strides in
// whole 16-byte units), complex64 on the complex form's stride-2 planes of
// (re, im) pairs (PYFFT_XRING_F32_S2, xring_takes: K5's persistent ring's
// rule, ring_operands' pairs, a plain store, no twiddle or the `full`
// one).  Every other K12 and K5 pass from n = 1024 runs
// local_cols_x_kernel.  The x tile's function and its tile, (l, run of C
// consecutive t) split over a cluster of G blocks, n/G rows a block, but a
// persistent grid: as many clusters as the card holds at once (asked of it
// once a device) walk every tile of the pass, cluster c taking tiles c, c +
// clusters, ... (l fastest, so that the clusters in flight read the same
// rows of a `full` table; the grid cut to whole rounds).  A block's shared
// memory is a ring of S slots of one tile each, one mbarrier a slot, a
// receive buffer and a twiddle table:
//
//   * loads: thread 0 fills each slot with tensor-map boxes of rows rank +
//     G*j' (C values, MB <= 256 rows a box; a box a plane, or on the pairs
//     (IL) one box of 8-byte (re, im) values, a 128-byte run a row at C =
//     16), tile i + S into tile i's slot once its chunks have left (below),
//     so the next tiles are in flight while the block computes;
//   * the chain: its first stage reads the slot's two planes (or its
//     pairs, already in the [k][c] layout of complex values) and writes the
//     [k][c] values into the same slot (xt_first); its last stage writes
//     its outputs into the slot by owner, the block that takes them
//     (ring_cols.cuh, xt_chain_from_chunks);
//   * the exchange in whole chunks, as K8's plane ring does (fused2d.cu):
//     thread 0 hands each owner's chunk to the copy engine, into the
//     owner's receive buffer, completing on the owner's mbarrier; the
//     pull of the x tile (a remote load a value, behind cluster barriers
//     whose release waits for the last tile's stores to device memory)
//     cost this design a tenth of a pass on the H100 (PERF.md section 6);
//   * twiddles: those of the chain after its first stage and of the
//     exchange depend on the thread and the block's rank alone, the same
//     for every tile of the walk, so each block reads them once a launch,
//     before its first chain, into a table after the receive buffer
//     (ring_cols.cuh's xt_fill_table: 246 values, 3936 bytes at n =
//     2048), each entry one value of `tw`, and the stages and the
//     exchange read them there: reading `tw` itself every tile (21 reads
//     a thread of a 32 KB table at n = 2048) put a round trip to the L2
//     into each of the tile's three rounds (PERF.md section 6);
//   * pipelined: tile i + 1's chain runs while tile i's chunks fly, then
//     tile i's pairs are read from the receive buffer, twiddled, the
//     G-point DFTs run and both stores go out from registers as the x
//     tile's (on the pairs one 8-byte (re, im) store a point where the
//     output is pairs too); a relaxed cluster barrier (K8's rule: every
//     read of the receive buffer retired, every block past its wait for
//     the chunks) frees tile i's slot and every receive buffer, and tile
//     i + 1's chunks go out.
//
// Each tile's store twiddles are read before its chain, w(k') and w(M)
// of each (k', c) pair of the thread, and the store takes w(k' + M*k2) =
// w(k') * w(M)^k2 as the x tile does, in every twiddle mode.  Every
// load of a tile comes before that tile's stores and tiles are disjoint,
// so a plain store may alias the input (in place).

// (log2 n, G, C, S, B): the ring's cluster of G blocks, its tile of C
// columns (128-byte runs), the slots of a block's ring and the blocks an
// SM its launch bounds leave registers for, by length.  At n = 2048 the
// H100 ran config 5's passes on (16, 16, 2, 2) in 3.73 and 3.70 ms (3.97
// and 3.93 with the twiddles read from `tw` every tile), the x tile in
// 4.34 and 4.13, the ring on a cluster of 8 blocks, one an SM, in 4.51 and
// 4.44 (probes/float_split.py K12, PERF.md section 6).
#ifndef PYFFT_XRING_F64
#define PYFFT_XRING_F64(X) X(11, 16, 16, 2, 2)
#endif
// The complex64 ring on the complex form's stride-2 planes: C pairs, a
// 128-byte run of (re, im) a row at C = 16.  At n = 1024 the H100 ran
// config 3's column pass (16 x 1024 x 1024) on (4, 16, 4, 1) in 0.1205 ms
// with the host ahead, on 3 slots in 0.1224, 5 in 0.1205, 2 slots and two
// blocks an SM in 0.1260, 2 slots and one block in 0.1633; the x tile in
// 0.1611 (probes/float_split.py K5, PERF.md section 6).  Tile i + S's load is
// issued past tile i's exchange and waited for by the chain of iteration
// i + S - 1: with 2 slots it flies while the block does nothing but send
// tile i + 1's chunks, with 3 or more across a whole tile's chain and
// exchange; one block an SM leaves no other block to fill that wait.
#ifndef PYFFT_XRING_F32_S2
#define PYFFT_XRING_F32_S2(X) X(10, 4, 16, 4, 1)
#endif

template <typename Real, int LOGN, int G, int C, int S_, int B = 1>
struct XRing {
  using V = typename Complex<Real>::V;
  static constexpr int S = S_;
  static constexpr int M = (1 << LOGN) / G;                  // rows a block
  static constexpr int MB = M < BOX ? M : BOX;               // rows a box
  // at most 512, one butterfly of every stage and one (k', c) of the
  // exchange a thread
  static constexpr int NT = cmin(cmin(M * C / 8, M / G * C), 512);
  using X = XTile<Real, LOGN - ilog2c(G), G, C, NT>;
  static constexpr int VB = (int)sizeof(V);                  // a value's bytes
  // a slot in bytes: the tile as copied (P complex values: two planes or
  // the pairs), then its [k][c] values, then its outputs by owner (the
  // swapped store's chunks padded); whole 128-byte units, where the
  // copies write.  The receive buffer after the S slots is one more, then
  // the twiddle table
  static constexpr int SLOT =
      (cmax(X::P, X::G_ * xt_chunk<X, true>()) * VB + 127) / 128 * 128;
  static constexpr int SMEM =
      (S + 1) * SLOT + xt_table<X>() * VB + 128;             // + alignment
  static_assert(S >= 2 && SMEM <= 227 * 1024 && B >= 1 && B * NT <= 2048 &&
                    B * (SMEM + 1024) <= 228 * 1024,
                "the ring fits a block's shared memory, B blocks an SM");
  static_assert(C * (int)sizeof(Real) % 16 == 0 && 128 % C == 0 &&
                    M % MB == 0 && X::P * VB < (1 << 20),
                "a box's row is whole 16-byte units of one tile; an "
                "mbarrier's count");
};

// K12's ring's operands: planar double planes (t stride 1), 16-byte
// aligned, their (l, n) strides multiples of 16 bytes (the tensor maps').
inline bool xring_operands(const Cols<double>& io) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(io.in_re);
  const uintptr_t b = reinterpret_cast<uintptr_t>(io.in_im);
  return io.in_ts == 1 && a % 16 == 0 && b % 16 == 0 && io.in_ns % 2 == 0 &&
         (io.L == 1 || io.in_ls % 2 == 0);
}

// The ring's tensor map of the plane (or, IL, the pairs) at `base`: {T, G,
// n/G, L}, its box the C columns of MB rows rank + G*j', 8-byte elements
// (a double, or a float's (re, im) pair).
template <typename Real, int LOGN, int G, int C, int S, int B, bool IL>
cudaError_t xring_map(CUtensorMap* map, const Real* base,
                      const Cols<Real>& io) {
  using K = XRing<Real, LOGN, G, C, S, B>;
  static_assert(sizeof(Real) * (IL ? 2 : 1) == 8, "8-byte elements");
  constexpr cuuint64_t E = sizeof(Real);
  const cuuint64_t row = (cuuint64_t)io.in_ns * E;
  const cuuint64_t dims[4] = {(cuuint64_t)io.T, (cuuint64_t)G,
                              (cuuint64_t)K::M, (cuuint64_t)io.L};
  const cuuint64_t strides[3] = {
      row, row * G, io.L > 1 ? (cuuint64_t)io.in_ls * E : row * (1 << LOGN)};
  const cuuint32_t box[4] = {(cuuint32_t)C, 1, (cuuint32_t)K::MB, 1};
  return tensor_map_4d(map, base, true, dims, strides, box);
}

// The ring over `tiles` tiles: this cluster's tile i in slot i % S on
// barrier filled[i % S], filled by thread 0 of each block with its rows.
// IL: the operands are the complex form's pairs (map_im unused).
template <typename Real, int LOGN, int G, int C, int S, int B, bool SWAP,
          bool IL, int NT = XRing<Real, LOGN, G, C, S, B>::NT>
__global__ void __launch_bounds__(NT, B)
    local_cols_xring_kernel(Cols<Real> io,
                            const typename Complex<Real>::V* __restrict__ tw,
                            Real s, long long tiles,
                            const __grid_constant__ CUtensorMap map_re,
                            const __grid_constant__ CUtensorMap map_im) {
  using K = XRing<Real, LOGN, G, C, S, B>;
  using X = typename K::X;
  using V = typename Complex<Real>::V;
  constexpr int P = X::P, M = X::M, MB = K::MB, KR = X::KR;
  constexpr int SV = K::SLOT / K::VB;   // a slot's complex values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t filled[S];
  __shared__ uint64_t landed;       // the chunks into this block, a tile
  V* slots = reinterpret_cast<V*>(align128(smem_raw));
  V* recv = slots + S * SV;
  V* tab = recv + SV;               // the chain's and exchange's twiddles
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long first = blockIdx.x / G, every = gridDim.x / G;
  const int count =
      first < tiles ? static_cast<int>((tiles - first + every - 1) / every)
                    : 0;
  // this block's rows of the cluster's tile i into slot i % S: the real
  // rows, then the imaginary rows (IL: the pairs' rows)
  const auto fill = [&](int i) {
    const long long tile = first + (long long)i * every;
    uint64_t* bar = &filled[i % S];
    Real* dst = reinterpret_cast<Real*>(slots + (i % S) * SV);
    const int l = static_cast<int>(tile % io.L);
    const int t0 = static_cast<int>((tile / io.L) * C);
    fence_async_smem();
    mbar_expect(bar, P * (int)sizeof(V));
    for (int part = 0; part < (IL ? 1 : 2); ++part)
      for (int h = 0; h < M / MB; ++h)
        tma_load_4d(dst + (IL ? 2 : 1) * (part * P + h * MB * C),
                    part ? &map_im : &map_re, t0, rank, h * MB, l, bar);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < S; ++b) mbar_init(&filled[b]);
    mbar_init(&landed);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < S && j < count; ++j) fill(j);
  }
  xt_fill_table<X>(tab, tw, rank);
  cluster_arrive();                 // every block's barriers are set up
  cluster_wait();                   // (and its table)
  const bool twiddled = io.tw_mode != TW_NONE;
  // IL: one 8-byte (re, im) store a point where the output is pairs too
  const bool pout =
      IL && io.out_im == io.out_re + 1 && io.out_bs == 2 &&
      ((io.out_ls | io.out_ns | io.out_as) & 1) == 0 &&
      reinterpret_cast<uintptr_t>(io.out_re) % sizeof(V) == 0;
  // the twiddle w^(k*q) of output k of tile i's column c, read before the
  // tile's chain so that its latency hides behind it: w(k') and w(M) of
  // each pair (k', c) of the thread, in the exchange's order
  const auto twiddles = [&](int i, V (&wk)[X::PAIRS], V (&wm)[X::PAIRS]) {
    if (!twiddled) return;
    const long long tile = first + (long long)i * every;
    const long long t0 = (tile / io.L) * C;
    const long long q0 = io.adiv > 1 ? t0 / io.adiv : 0;
    const int r0 = static_cast<int>(t0 & 127);
#pragma unroll
    for (int q = 0; q < X::PAIRS; ++q) {
      const int p = threadIdx.x + q * NT;
      const int c = SWAP ? p / KR : p % C;
      const int kp = rank * KR + (SWAP ? p % KR : p / C);
      const long long t = t0 + c;
      const long long at = (io.adiv > 1 ? q0 : t) * io.aq;
      const bool in = t < io.T;
      const V one = Complex<Real>::make(1, 0);
      wk[q] = in ? __ldg(&io.ta[kp * io.ak + at]) : one;
      wm[q] = in ? __ldg(&io.ta[M * io.ak + at]) : one;
      if (io.tw_mode == TW_FACTORED && in) {
        const long long bt = (r0 + c) * io.bq;
        wk[q] = cmul(wk[q], __ldg(&io.tb[kp * io.bk + bt]));
        wm[q] = cmul(wm[q], __ldg(&io.tb[M * io.bk + bt]));
      }
    }
  };
  // tile i's chain in its slot, its outputs by owner
  const auto chain = [&](int i) {
    V* sm = slots + (i % S) * SV;
    const Real* f = reinterpret_cast<const Real*>(sm);
    mbar_wait(&filled[i % S], (i / S) & 1);
    xt_chain_from_chunks<X, SWAP>(sm, tab, s, [&](int k, int c) {
      if constexpr (IL)
        return sm[k * C + c];
      else
        return Complex<Real>::make(f[k * C + c], f[P + k * C + c]);
    });
  };
  V wk[X::PAIRS], wm[X::PAIRS], wk1[X::PAIRS], wm1[X::PAIRS];
  twiddles(0, wk, wm);
  chain(0);
  xt_send_chunks<X, SWAP>(slots, recv, &landed, rank);
  for (int i = 0; i < count; ++i) {
    // the next tile's chain while tile i's chunks fly
    if (i + 1 < count) {
      twiddles(i + 1, wk1, wm1);
      chain(i + 1);
    }
    const long long tile = first + (long long)i * every;
    const long long l = tile % io.L, t0 = (tile / io.L) * C;
    // as the x tile: t / P is the same for the tile
    const long long a0 = t0 / io.P, b0 = t0 - a0 * io.P;
    // outputs k' + M*k2 of column c, pair q of the thread
    const auto put = [&](int c, int kp, const V* y, int q) {
      const long long t = t0 + c;
      if (t >= io.T) return;
      V w = wk[q];
      const long long o = l * io.out_ls + a0 * io.out_as + (b0 + c) * io.out_bs;
#pragma unroll
      for (int k2 = 0; k2 < G; ++k2) {
        V v = y[k2];
        if (twiddled) {
          v = cmul(v, w);
          w = cmul(w, wm[q]);
        }
        const long long ok = o + (kp + M * k2) * io.out_ns;
        if (IL && pout) {
          *reinterpret_cast<V*>(io.out_re + ok) =
              Complex<Real>::make(v.x * io.post, v.y * io.post);
          continue;
        }
        io.out_re[ok] = v.x * io.post;
        io.out_im[ok] = v.y * io.post;
      }
    };
    xt_receive_chunks<X, SWAP>(recv, &landed, i & 1, tab, s, rank, put);
    // past the receive's barrier every copy out of tile i's slot has
    // landed and every block has read its receive buffer: refill the slot
    // with tile i + S, send tile i + 1's chunks
    if (threadIdx.x == 0 && i + S < count) fill(i + S);
    if (i + 1 < count) {
      xt_send_chunks<X, SWAP>(slots + ((i + 1) % S) * SV, recv, &landed,
                              rank);
#pragma unroll
      for (int q = 0; q < X::PAIRS; ++q) {
        wk[q] = wk1[q];
        wm[q] = wm1[q];
      }
    }
  }
}

// The clusters of the ring the card holds at once, into `held`: asked of
// the card once a device (cudaOccupancyMaxActiveClusters, which sets the
// kernel's shared memory there for its launches).
template <typename Real, int LOGN, int G, int C, int S, int B, bool SWAP,
          bool IL>
cudaError_t xring_held(int& held) {
  using K = XRing<Real, LOGN, G, C, S, B>;
  static std::atomic<int> got[64];             // by device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  held = got[dev].load(std::memory_order_relaxed);
  if (!held) {
    held = max_clusters<K::NT>(
        local_cols_xring_kernel<Real, LOGN, G, C, S, B, SWAP, IL>, G,
        K::SMEM);
    if (held < 0) return static_cast<cudaError_t>(-held);
    if (held == 0) return cudaErrorInvalidConfiguration;
    got[dev].store(held, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <typename Real, int LOGN, int G, int C, int S, int B, bool SWAP,
          bool IL>
cudaError_t launch_xring(const Cols<Real>& io,
                         const typename Complex<Real>::V* tw, Real s,
                         cudaStream_t stream) {
  using K = XRing<Real, LOGN, G, C, S, B>;
  int held = 0;
  cudaError_t e = xring_held<Real, LOGN, G, C, S, B, SWAP, IL>(held);
  if (e != cudaSuccess) return e;
  CUtensorMap mre, mim;
  e = xring_map<Real, LOGN, G, C, S, B, IL>(&mre, io.in_re, io);
  mim = mre;
  if (e == cudaSuccess && !IL)
    e = xring_map<Real, LOGN, G, C, S, B, IL>(&mim, io.in_im, io);
  if (e != cudaSuccess) return e;
  const long long tiles = (io.T + C - 1) / C * io.L;
  // whole rounds: the fewest clusters that take the tiles a cluster the
  // held ones need
  const long long each = (tiles + held - 1) / held;
  const long long clusters = (tiles + each - 1) / each;
  return launch_cluster<K::NT>(
      local_cols_xring_kernel<Real, LOGN, G, C, S, B, SWAP, IL>, clusters, G,
      K::SMEM, stream, io, tw, s, tiles, mre, mim);
}

// ------------------------------------- K4 from n = 512: a cluster's tile

// (log2 n, G, R) of K4's cluster tile: R consecutive rows split over a
// cluster of G blocks in decimation in frequency, M = n/G points of each
// row a block (64 KB, three blocks an SM).  Every other length runs the
// ROWS policy of local_cols_kernel.
#ifndef PYFFT_SWAP_X
#define PYFFT_SWAP_X(X) \
  X(9, 4, 32) X(10, 4, 32) X(11, 8, 32) X(12, 16, 32) X(13, 16, 16)
#endif
// K4's 256-point chains (n = 1024 to 4096) as two radix-16 stages, one
// shared-memory round trip fewer than radix 4, 8, 8 (where the tile's
// rows give every thread a 16-point butterfly).
constexpr bool SWAP_R16 = true;
// K4's threads a block and the blocks an SM its registers leave room for
// (three 64 KB blocks of 256 threads beat two of 512).
constexpr int SWAP_THREADS = 256, SWAP_BLOCKS = 3;

template <int LOGN, int G, int R>
struct SwapX {
  static constexpr int N = 1 << LOGN, M = N / G;
  static constexpr int MG = M / G;             // j2 a block loads
  static constexpr int NT = SWAP_THREADS;
  using X = XTile<float, LOGN - ilog2c(G), G, R, NT>;
  static constexpr int PAIRS = MG * R / NT;    // (j2, r) a thread
  static constexpr int SMEM = X::P * (int)sizeof(float2) + 128;
  static_assert(PAIRS >= 1 && PAIRS * NT == MG * R, "threads tile the loads");
  static_assert(MG <= BOX && 128 % R == 0, "one box a plane");
  static_assert(SWAP_BLOCKS * (SMEM + 1024) <= 228 * 1024,
                "the blocks an SM fit its shared memory");
};

// K4's operands from n = 512: planar planes (j stride 1) or the complex
// form's stride-2 planes (the imaginary plane one float after the real
// one), 16-byte aligned, their (l, row) strides multiples of 16 bytes.
inline bool swap_operands(const Cols<float>& io) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(io.in_re);
  const uintptr_t b = reinterpret_cast<uintptr_t>(io.in_im);
  const bool planar = io.in_ns == 1 && b % 16 == 0;
  const bool pairs = io.in_ns == 2 && b == a + sizeof(float);
  return (planar || pairs) && a % 16 == 0 && io.in_ts % 4 == 0 &&
         (io.L == 1 || io.in_ls % 4 == 0);
}

// K4's tensor map of the plane (or the pairs) at `base`: {M (j2), G (j1),
// T (rows), L}, its box the j2 of one block for every j1 of R rows.
template <int LOGN, int G, int R>
cudaError_t swap_map(CUtensorMap* map, const float* base,
                     const Cols<float>& io) {
  using K = SwapX<LOGN, G, R>;
  const cuuint64_t row = (cuuint64_t)io.in_ts * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)K::M, (cuuint64_t)G,
                              (cuuint64_t)io.T, (cuuint64_t)io.L};
  const cuuint64_t strides[3] = {
      (cuuint64_t)K::M * io.in_ns * 4, row,
      io.L > 1 ? (cuuint64_t)io.in_ls * 4 : row * (cuuint64_t)io.T};
  const cuuint32_t box[4] = {(cuuint32_t)K::MG, (cuuint32_t)G, (cuuint32_t)R,
                             1};
  return tensor_map_4d(map, base, io.in_ns == 2, dims, strides, box);
}

// K4 on one (l, R consecutive rows) tile a cluster, block `rank` = k1:
// one box a plane (map_im unused on pairs), rows past T read as zeros.
// The exchange pulls, as K12's: each block leaves its G outputs in chunks
// of its own buffer, chunk k1 = [j2][r] over its j2 (r XOR j2's low bits,
// against bank conflicts as threads run along j2), and the first stage of
// block k1's chain reads chunk k1 of every block through DSMEM, threads
// running along r.
template <int LOGN, int G, int R, int NT = SwapX<LOGN, G, R>::NT>
__global__ void __launch_bounds__(NT, SWAP_BLOCKS)
    local_rows_swap_x_kernel(Cols<float> io, const float2* __restrict__ tw,
                             float s,
                             const __grid_constant__ CUtensorMap map_re,
                             const __grid_constant__ CUtensorMap map_im) {
  using K = SwapX<LOGN, G, R>;
  using X = typename K::X;
  constexpr int MG = K::MG, P = X::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  float2* sm = align128(smem_raw);
  const float* f = reinterpret_cast<const float*>(sm);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long tile = blockIdx.x / G;
  // l fastest, as the column kernel's blocks
  const long long l = tile % io.L, r0 = (tile / io.L) * R;
  const bool split = io.in_ns == 1;
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar, P * (int)sizeof(float2));
    tma_load_4d(sm, &map_re, rank * MG, 0, static_cast<int>(r0),
                static_cast<int>(l), &bar);
    if (split)
      tma_load_4d(reinterpret_cast<float*>(sm) + P, &map_im, rank * MG, 0,
                  static_cast<int>(r0), static_cast<int>(l), &bar);
  }
  __syncthreads();                  // the barrier is set up
  mbar_wait(&bar, 0);
  // x[j1*M + j2] for j1 < G of each (j2, r) of the thread (box element (r,
  // j1, j2 - rank*MG)), the G-point DFT over j1, output k1 twiddled by
  // w_n^(j2*k1)
  float2 x[K::PAIRS][G];
#pragma unroll
  for (int i = 0; i < K::PAIRS; ++i) {
    const int p = threadIdx.x + i * NT, jl = p % MG, r = p / MG;
#pragma unroll
    for (int j1 = 0; j1 < G; ++j1) {
      const int e = (r * G + j1) * MG + jl;
      x[i][j1] = split ? make_float2(f[e], f[P + e]) : sm[e];
    }
    dft<G>(x[i], s);
#pragma unroll
    for (int k1 = 1; k1 < G; ++k1)
      x[i][k1] = cmul(x[i][k1], __ldg(&tw[(rank * MG + jl) * k1]));
  }
  __syncthreads();                  // the box is read
#pragma unroll
  for (int i = 0; i < K::PAIRS; ++i) {
    const int p = threadIdx.x + i * NT, jl = p % MG, r = p / MG;
#pragma unroll
    for (int k1 = 0; k1 < G; ++k1)
      sm[(k1 * MG + jl) * R + (r ^ (jl & (R - 1)))] = x[i][k1];
  }
  cluster_arrive();        // this block's chunks are written
  cluster_wait();
  // the M-point chain over j2 = b*MG + jl in this block's [j2][r] buffer:
  // its first stage reads chunk `rank` of every block b through DSMEM, and
  // waits for the cluster's reads of this buffer before it writes it; its
  // last stage stores X[rank + G*k2] of row r0 + r, threads along r
  constexpr bool R16 =
      SWAP_R16 && X::M == 256 && X::M / 16 * R % NT == 0;
  constexpr int R0 = R16 ? 16 : X::REM ? (1 << X::REM) : 8;
  xt_first<X, R0>(
      sm, s,
      [&](int k, int c) {
        const int jl = k % MG;
        const float2* src = cluster.map_shared_rank(sm, k / MG);
        return src[(rank * MG + jl) * R + (c ^ (jl & (R - 1)))];
      },
      [] {
        cluster_arrive();  // this block's reads of the cluster are done
        cluster_wait();    // and every block's of this one
      });
  const auto put = [&](int k2, int r, float2 v) {
    const long long row = r0 + r;
    if (row >= io.T) return;
    const long long o = l * io.out_ls + (long long)(rank + G * k2) * io.out_ns +
                        row * io.out_bs;
    io.out_re[o] = v.x * io.post;
    io.out_im[o] = v.y * io.post;
  };
  if constexpr (R16)
    xt_stage_out<X, 16, 16>(sm, tw, s, put);
  else
    xt_chain_out<X, 1, R0>(sm, tw, s, put);
}

template <int LOGN, int G, int R>
cudaError_t launch_swap_x(const Cols<float>& io, const float2* tw, float s,
                          cudaStream_t stream) {
  using K = SwapX<LOGN, G, R>;
  if (!swap_operands(io)) return cudaErrorInvalidValue;
  CUtensorMap mre, mim;
  cudaError_t e = swap_map<LOGN, G, R>(&mre, io.in_re, io);
  if (e != cudaSuccess) return e;
  mim = mre;
  if (io.in_ns == 1) e = swap_map<LOGN, G, R>(&mim, io.in_im, io);
  if (e != cudaSuccess) return e;
  const long long tiles = (io.T + R - 1) / R * io.L;
  return launch_cluster<K::NT>(local_rows_swap_x_kernel<LOGN, G, R>, tiles,
                               G, K::SMEM, stream, io, tw, s, mre, mim);
}

// ---------------------------- K5 up to n = 512: a persistent column ring
//
// The complex64 column pass with a plain store and no twiddle or the `full`
// one (config 4's z pass, the fold's K7), at the lengths of its table (n =
// 16 to 256), on planes a tensor map reads
// (ring_operands: planar or the complex form's stride-2 planes, 16-byte
// aligned; any other input runs local_cols_kernel).  K6's ring without
// JAX's grid steps: a grid of one wave (the card's SMs times the blocks an
// SM holds, asked of the card once a device) walks every (l, run of C
// columns) tile of the pass, block b taking tiles b, b + grid, ... (l
// fastest, so that neighbouring blocks read the same rows of a `full`
// table); the grid is cut to whole rounds, every block taking the same
// count of tiles but the last ones.  A block's shared memory is a ring of
// S slots of one tile each, one mbarrier a slot; thread 0 keeps the next
// S - 1 tiles in flight as tensor-map boxes [n][C] of each plane (or of
// the pairs), in boxes of 256 rows at n = 512 (the copy engine's limit).
// The chain is chain.cuh's over the slot's C columns ([k][c], threads
// along c, so its shared-memory accesses meet no bank conflict and need no
// padding): radix 16 where it takes a stage fewer than radix 8 (256 = 16 x
// 16: one shared-memory round trip, not two), five twiddle reads of
// fifteen a radix-16 butterfly (TWD).  Its first stage reads the slot's
// raw planes and writes the [k][c] layout into the same slot after a
// barrier; its last stage applies the `full` twiddle and the postscale and
// stores from registers, threads along t: 128-byte runs of each plane at
// n = 256.  Every tile a block stores is one it loaded, whole, before, and
// tiles are disjoint, so the output may alias the input (in place).

// (log2 n, C, S): the columns of a tile and the slots of the ring, by
// length; C is local_cols_kernel's (ColShape), so that both designs take
// the same tiles; a slot of 16 KB (n = 16) to 64 KB (n >= 64).  n = 8 (4
// KB boxes, paced by the copy engine's issue rate) and n = 512 (two boxes
// a plane) run the first design, which the H100 showed as fast or faster
// there (2^24 points at n = 8: 0.0996-0.1089 ms against the ring's
// 0.1072-0.1077, probes/ab_parent.py; the huge route's plain pass, 2^27
// points at n = 512: 0.9133 ms against the ring's 0.9421 at C = 16,
// 1.6399 at C = 8, probes/float_split.py c5old, c5ring512, c5n512;
// PERF.md section 6).
#ifndef PYFFT_COLS_PRING
#define PYFFT_COLS_PRING(X)                                              \
  X(4, 128, 3) X(5, 128, 3) X(6, 128, 3) X(7, 64, 3) X(8, 32, 3)
#endif
// the chain's options: radix 16 where it takes a stage fewer, TWD
constexpr bool PRING_R16 = true, PRING_TWD = true;

template <int LOGN, int C_, int S_>
struct PRing {
  static constexpr int N = 1 << LOGN, C = C_, S = S_, P = N * C;
  static constexpr int NT = P / 16;                   // 16 points a thread
  static constexpr int MB = N < BOX ? N : BOX;        // rows a box
  static constexpr bool R16 = PRING_R16 && (LOGN + 3) / 4 < (LOGN + 2) / 3;
  static constexpr int SLOT = P * (int)sizeof(float2);
  static constexpr int SMEM = S * SLOT + 128;         // + alignment
  static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);
  static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM : 2048 / NT;
  static_assert(S >= 2 && SMEM <= 227 * 1024,
                "the ring fits a block's shared memory");
  static_assert(NT >= 32 && NT <= 1024 && NT % 32 == 0 && N % MB == 0,
                "whole warps, whole boxes");
  static_assert(C % 4 == 0 && C <= BOX && P * 8 < (1 << 20),
                "a box's row is whole 16-byte units; an mbarrier's count");
};

// The persistent ring's tensor map of the plane (or the pairs) at `base`:
// {T, MB, n/MB, L}, its box the C columns of MB rows.
template <int LOGN, int C, int S>
cudaError_t pring_map(CUtensorMap* map, const float* base,
                      const Cols<float>& io) {
  using K = PRing<LOGN, C, S>;
  const cuuint64_t row = (cuuint64_t)io.in_ns * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)io.T, (cuuint64_t)K::MB,
                              (cuuint64_t)(K::N / K::MB), (cuuint64_t)io.L};
  const cuuint64_t strides[3] = {
      row, row * K::MB,
      io.L > 1 ? (cuuint64_t)io.in_ls * 4 : row * (cuuint64_t)K::N};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)K::MB, 1, 1};
  return tensor_map_4d(map, base, io.in_ts == 2, dims, strides, box);
}

// The ring over `tiles` tiles: tile first + i*every in slot i % S on
// barrier full[i % S], filled by thread 0 (map_im unused on pairs).
template <int LOGN, int C, int S>
__global__ void __launch_bounds__(PRing<LOGN, C, S>::NT,
                                  PRing<LOGN, C, S>::PER)
    local_cols_pring_kernel(Cols<float> io, const float2* __restrict__ tw,
                            float s, long long tiles,
                            const __grid_constant__ CUtensorMap map_re,
                            const __grid_constant__ CUtensorMap map_im) {
  using K = PRing<LOGN, C, S>;
  constexpr int N = K::N, P = K::P, NT = K::NT, MB = K::MB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[S];
  float2* slots = align128(smem_raw);
  const long long first = blockIdx.x, every = gridDim.x;
  const int count =
      first < tiles ? static_cast<int>((tiles - first + every - 1) / every)
                    : 0;
  const bool split = io.in_ts == 1;     // planar, else stride-2 pairs
  // this block's tile i into slot i % S: its n rows of C columns, of each
  // plane (the real rows, then the imaginary rows) or of pairs
  const auto fill = [&](int i) {
    const long long tile = first + (long long)i * every;
    uint64_t* bar = &full[i % S];
    float* dst = reinterpret_cast<float*>(slots + (i % S) * P);
    const int l = static_cast<int>(tile % io.L);
    const int t0 = static_cast<int>((tile / io.L) * C);
    fence_async_smem();
    mbar_expect(bar, P * (int)sizeof(float2));
    for (int part = 0; part < (split ? 2 : 1); ++part)
      for (int h = 0; h < N / MB; ++h)
        tma_load_4d(dst + (split ? part * P + h * MB * C : 2 * h * MB * C),
                    part ? &map_im : &map_re, t0, 0, h, l, bar);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < S; ++b) mbar_init(&full[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < S && j < count; ++j) fill(j);
  }
  __syncthreads();                  // the barriers are set up
  const bool twd = io.tw_mode != TW_NONE;
  for (int i = 0; i < count; ++i) {
    // thread 0 fills the slot of tile i - 1, whose readers are past its
    // last stage's barrier, with tile i + S - 1
    if (threadIdx.x == 0 && i && i + S - 1 < count) fill(i + S - 1);
    const long long tile = first + (long long)i * every;
    const long long l = tile % io.L, t0 = (tile / io.L) * C;
    float2* sm = slots + (i % S) * P;
    const float* f = reinterpret_cast<const float*>(sm);
    const auto load = [&](int c, int k) {
      return split ? make_float2(f[k * C + c], f[P + k * C + c])
                   : sm[k * C + c];
    };
    const auto store = [&](int c, int k, float2 v) {
      const long long t = t0 + c;
      if (t >= io.T) return;
      if (twd) v = cmul(v, __ldg(&io.ta[k * io.ak + t * io.aq]));
      const long long o = l * io.out_ls + k * io.out_ns + t * io.out_bs;
      io.out_re[o] = v.x * io.post;
      io.out_im[o] = v.y * io.post;
    };
    mbar_wait(&full[i % S], (i / S) & 1);
    // the first stage reads the slot's raw planes (SYNC0: a barrier before
    // it writes the slot), the last stores from registers after its
    // barrier, the slot's last
    chain<NT, LOGN, C, false, 0, 1, true, true, false, PRING_TWD, K::R16,
          true>(sm, fresh(tw), s, load, store);
  }
}

// The card's SMs and the blocks of the persistent ring an SM holds, into
// `sms` and `per`: asked of the card once a device, with the kernel's
// shared memory set there for its launches.
template <int LOGN, int C, int S>
cudaError_t pring_wave(int& sms, int& per) {
  using K = PRing<LOGN, C, S>;
  const auto kernel = local_cols_pring_kernel<LOGN, C, S>;
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

template <int LOGN, int C, int S>
cudaError_t launch_pring(const Cols<float>& io, const float2* tw, float s,
                         cudaStream_t stream) {
  using K = PRing<LOGN, C, S>;
  int sms = 0, per = 0;
  cudaError_t e = pring_wave<LOGN, C, S>(sms, per);
  if (e != cudaSuccess) return e;
  CUtensorMap mre, mim;
  e = pring_map<LOGN, C, S>(&mre, io.in_re, io);
  if (e != cudaSuccess) return e;
  mim = mre;
  if (io.in_ts == 1) e = pring_map<LOGN, C, S>(&mim, io.in_im, io);
  if (e != cudaSuccess) return e;
  const long long tiles = (io.T + C - 1) / C * io.L;
  const long long wave = (long long)sms * per;
  // whole rounds: the fewest blocks that take the rounds one wave needs
  const long long rounds = (tiles + wave - 1) / wave;
  const long long grid = (tiles + rounds - 1) / rounds;
  local_cols_pring_kernel<LOGN, C, S>
      <<<(unsigned)grid, K::NT, K::SMEM, stream>>>(io, tw, s, tiles, mre,
                                                   mim);
  return cudaGetLastError();
}

// What a column entry returns where a persistent ring (RAN_RING: K5's
// column ring, K12's cluster ring), the cluster tile (RAN_X, complex64
// and complex128) or K5's persistent cluster ring (RAN_XRING) ran: 0 where
// local_cols_kernel ran, else the launch's cudaError_t.  The wrapper
// counts each design's launches from it.
constexpr int RAN_RING = -1, RAN_X = -2, RAN_XRING = -3;

// Whether the persistent ring takes the pass: a plain store (no swap, no
// mid swap), no twiddle or the `full` one, planes a tensor map reads.
inline bool pring_takes(const Cols<float>& io, int swap_store) {
  return !swap_store && io.P >= io.T &&
         (io.tw_mode == TW_NONE ||
          (io.tw_mode == TW_TABLE && io.adiv == 1)) &&
         ring_operands(io);
}

// Whether K5's persistent cluster ring takes the pass where its table has
// n: the persistent ring's rule on the complex form's pairs.
inline bool xring_takes(const Cols<float>& io, int swap_store) {
  return pring_takes(io, swap_store) && io.in_ts == 2;
}

// The launch of the entry points below.  `policy` COLS runs the column
// kernel with its `swap_store`; ROWS (K4) and WALK (K6, c = `ctile`) run
// the plain store, complex64 only.
template <typename Real, int MAXLOG>
int launch_cols(const void* in_re, const void* in_im, void* out_re,
                void* out_im, const void* tw, const void* ta, const void* tb,
                const long long* dims, int log2n, int sign, Real postscale,
                int swap_store, void* stream, int policy = COLS,
                int ctile = 1) {
  using V = typename Complex<Real>::V;
  const Cols<Real> io = cols_io<Real>(in_re, in_im, out_re, out_im, ta, tb,
                                      dims, postscale);
  if (io.L <= 0 || io.T <= 0 || io.P <= 0 || io.adiv <= 0)
    return (int)cudaErrorInvalidValue;
  const V* t = static_cast<const V*>(tw);
  const Real s = sign < 0 ? Real(-1) : Real(1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (policy != COLS) {
    if constexpr (sizeof(Real) == sizeof(float)) {
      if (swap_store) return (int)cudaErrorInvalidValue;
      if (policy == ROWS) {
        if (io.tw_mode != TW_NONE) return (int)cudaErrorInvalidValue;
#define PYFFT_SWAPX(LN, G, R) \
  if (log2n == LN) return (int)launch_swap_x<LN, G, R>(io, t, s, st);
        PYFFT_SWAP_X(PYFFT_SWAPX)
#undef PYFFT_SWAPX
        return (int)dispatch<Real, MAXLOG, false, ROWS>(log2n, io, t, s, st);
      }
      if (io.tw_mode == TW_FACTORED || io.adiv != 1)
        return (int)cudaErrorInvalidValue;
      return (int)dispatch_ring(log2n, io, t, s, ctile, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  // the cluster tile where its table has n (RAN_X)
#define PYFFT_XCOL(LN, G, C, B)                                             \
  if (log2n == LN) {                                                        \
    const int e =                                                           \
        swap_store ? (int)launch_x<Real, LN, G, C, B, true>(io, t, s, st)  \
                   : (int)launch_x<Real, LN, G, C, B, false>(io, t, s, st); \
    return e == 0 ? RAN_X : e;                                              \
  }
  if constexpr (sizeof(Real) == sizeof(double)) {
    // K12's persistent cluster ring where its table has n, on planar planes
    // its tensor maps read (RAN_RING)
    if (xring_operands(io)) {
#define PYFFT_XRING(LN, G, C, S, B)                                       \
  if (log2n == LN) {                                                      \
    const auto go = swap_store                                            \
                        ? launch_xring<Real, LN, G, C, S, B, true, false> \
                        : launch_xring<Real, LN, G, C, S, B, false, false>; \
    const cudaError_t e = go(io, t, s, st);                               \
    if (e != cudaSuccess) return (int)e;                                  \
    return RAN_RING;                                                      \
  }
      PYFFT_XRING_F64(PYFFT_XRING)
#undef PYFFT_XRING
    }
    // K12: the cluster tile from n = 1024
    if (xcols_strided(io.in_ts)) {
      PYFFT_XCOLS_F64_S2(PYFFT_XCOL)
    }
    PYFFT_XCOLS_F64(PYFFT_XCOL)
  } else {
    // K5: the persistent cluster ring where its table has n, on the complex
    // form's pairs (RAN_XRING)
    if (xring_takes(io, swap_store)) {
#define PYFFT_XRING(LN, G, C, S, B)                                       \
  if (log2n == LN) {                                                      \
    const cudaError_t e =                                                 \
        launch_xring<Real, LN, G, C, S, B, false, true>(io, t, s, st);    \
    return e == cudaSuccess ? RAN_XRING : (int)e;                         \
  }
      PYFFT_XRING_F32_S2(PYFFT_XRING)
#undef PYFFT_XRING
    }
    // K5: the cluster tile from n = 1024 (RAN_X), the persistent ring up to
    // 512 where it takes the pass (RAN_RING)
    if (xcols_strided(io.in_ts)) {
      PYFFT_XCOLS_F32_S2(PYFFT_XCOL)
    }
    PYFFT_XCOLS_F32(PYFFT_XCOL)
    if (pring_takes(io, swap_store)) {
#define PYFFT_PRING(LN, C, S)                                          \
  if (log2n == LN) {                                                   \
    const cudaError_t e = launch_pring<LN, C, S>(io, t, s, st);        \
    return e == cudaSuccess ? RAN_RING : (int)e;                       \
  }
      PYFFT_COLS_PRING(PYFFT_PRING)
#undef PYFFT_PRING
    }
  }
#undef PYFFT_XCOL
  return swap_store ? (int)dispatch<Real, MAXLOG, true>(log2n, io, t, s, st)
                    : (int)dispatch<Real, MAXLOG, false>(log2n, io, t, s, st);
}

}  // namespace

// The columns of a tile the complex64 column pass takes at log2n on
// planar planes with a plain store (0 outside 3..13), for the wrapper's
// limit checks and the records: C of the cluster tile where it runs
// (PYFFT_XCOLS_F32), else of the persistent ring (PYFFT_COLS_PRING), else
// local_cols_kernel's.
extern "C" int pyfft_local_cols_width(int log2n) {
#define PYFFT_XCOL(LN, G, C, B) \
  if (log2n == LN) return C;
  PYFFT_XCOLS_F32(PYFFT_XCOL)
#undef PYFFT_XCOL
#define PYFFT_PRING(LN, C, S) \
  if (log2n == LN) return C;
  PYFFT_COLS_PRING(PYFFT_PRING)
#undef PYFFT_PRING
  return width<float, 13>(log2n);
}

// The same for the complex128 kernels (0 outside 3..12): C of the cluster
// kernel's tile where it runs (PYFFT_XCOLS_F64).
extern "C" int pyfft_local_cols_width_f64(int log2n) {
#define PYFFT_XCOL(LN, G, C, B) \
  if (log2n == LN) return C;
  PYFFT_XCOLS_F64(PYFFT_XCOL)
#undef PYFFT_XCOL
  return width<double, 12>(log2n);
}

// The cluster column kernel's tile at log2n on planes of t stride `in_ts`,
// as the launch takes it: G and C into out[0..1], and 1; 0 where another
// design takes the length.  No CUDA call.  complex128 (K12), and complex64
// (K5) below.
#define PYFFT_XCOL(LN, G, C, B) \
  if (log2n == LN) {            \
    out[0] = G;                 \
    out[1] = C;                 \
    return 1;                   \
  }
extern "C" int pyfft_local_cols_xtile_f64(int log2n, long long in_ts,
                                          int* out) {
  if (xcols_strided(in_ts)) {
    PYFFT_XCOLS_F64_S2(PYFFT_XCOL)
  }
  PYFFT_XCOLS_F64(PYFFT_XCOL)
  return 0;
}

extern "C" int pyfft_local_cols_xtile(int log2n, long long in_ts, int* out) {
  if (xcols_strided(in_ts)) {
    PYFFT_XCOLS_F32_S2(PYFFT_XCOL)
  }
  PYFFT_XCOLS_F32(PYFFT_XCOL)
  return 0;
}
#undef PYFFT_XCOL

// The cluster column kernel's shape at log2n into out[0..4]: G, C, B (the
// table's, or the _S2 table's where `strided`: planes whose t stride is
// not 1) and the clusters of it the card holds at once
// (cudaOccupancyMaxActiveClusters) with the plain and with the swapped
// store.  Returns 0, -1000 where another design takes the length, or a
// cudaError_t.  complex128 (K12), and complex64 (K5) below.
#define PYFFT_XCOL(LN, G, C, B)                                           \
  if (log2n == LN) {                                                      \
    using K = XCols<Real, LN, G, C>;                                      \
    const int plain = pyfft::max_clusters<K::NT>(                         \
        local_cols_x_kernel<Real, LN, G, C, B, false>, G, K::SMEM_PLAIN); \
    const int swap = pyfft::max_clusters<K::NT>(                          \
        local_cols_x_kernel<Real, LN, G, C, B, true>, G, K::SMEM_SWAP);   \
    if (plain < 0) return -plain;                                         \
    if (swap < 0) return -swap;                                           \
    const long long v[5] = {G, C, B, plain, swap};                        \
    for (int i = 0; i < 5; ++i) out[i] = v[i];                            \
    return 0;                                                             \
  }
extern "C" int pyfft_local_cols_xshape_f64(int log2n, int strided,
                                           long long* out) {
  using Real = double;
  if (strided) {
    PYFFT_XCOLS_F64_S2(PYFFT_XCOL)
  }
  PYFFT_XCOLS_F64(PYFFT_XCOL)
  return -1000;
}

extern "C" int pyfft_local_cols_xshape(int log2n, int strided,
                                       long long* out) {
  using Real = float;
  if (strided) {
    PYFFT_XCOLS_F32_S2(PYFFT_XCOL)
  }
  PYFFT_XCOLS_F32(PYFFT_XCOL)
  return -1000;
}
#undef PYFFT_XCOL

// K12's persistent cluster ring at log2n (PYFFT_XRING_F64) into out[0..6]:
// G, C, S, B, its threads, a block's bytes of shared memory and the
// clusters the card holds at once (asked of the card, which sets the
// kernel's shared memory there).  Returns 1, 0 where the ring takes no
// such length, or minus a cudaError_t.  K5's on the complex form's pairs
// (PYFFT_XRING_F32_S2, its one instance: the plain store) below.
#define PYFFT_XRING(LN, G, C, S, B)                                       \
  if (log2n == LN) {                                                      \
    using K = XRing<Real, LN, G, C, S, B>;                                \
    int held = 0;                                                         \
    const cudaError_t e =                                                 \
        xring_held<Real, LN, G, C, S, B, !IL, IL>(held);                  \
    if (e != cudaSuccess) return -(int)e;                                 \
    const int v[7] = {G, C, S, B, K::NT, K::SMEM, held};                  \
    for (int i = 0; i < 7; ++i) out[i] = v[i];                            \
    return 1;                                                             \
  }
extern "C" int pyfft_local_cols_xring_shape_f64(int log2n, int* out) {
  using Real = double;
  constexpr bool IL = false;
  PYFFT_XRING_F64(PYFFT_XRING)
  return 0;
}

extern "C" int pyfft_local_cols_xring_shape(int log2n, int* out) {
  using Real = float;
  constexpr bool IL = true;
  PYFFT_XRING_F32_S2(PYFFT_XRING)
  return 0;
}
#undef PYFFT_XRING

// The persistent column ring's shape at log2n (PYFFT_COLS_PRING) into
// out[0..4]: the columns of a tile, its threads, slots, a block's shared
// memory in bytes and the blocks an SM holds on the current device (asked
// of the card, which sets the kernel's shared memory there).  Returns 1, 0
// where the ring takes no such length, or minus a cudaError_t.
extern "C" int pyfft_local_cols_pring_shape(int log2n, int* out) {
#define PYFFT_PRING(LN, C, S)                                      \
  if (log2n == LN) {                                               \
    using K = PRing<LN, C, S>;                                     \
    int sms = 0, per = 0;                                          \
    const cudaError_t e = pring_wave<LN, C, S>(sms, per);          \
    if (e != cudaSuccess) return -(int)e;                          \
    const int v[5] = {C, K::NT, S, K::SMEM, per};                  \
    for (int i = 0; i < 5; ++i) out[i] = v[i];                     \
    return 1;                                                      \
  }
  PYFFT_COLS_PRING(PYFFT_PRING)
#undef PYFFT_PRING
  return 0;
}

// K4's cluster tile at log2n (PYFFT_SWAP_X): G and R (rows a tile) into
// out[0..1], and 1; 0 where the ROWS policy of the column kernel takes the
// length.  No CUDA call.
extern "C" int pyfft_local_rows_swap_shape(int log2n, int* out) {
#define PYFFT_SWAPX(LN, G, R) \
  if (log2n == LN) {          \
    out[0] = G;               \
    out[1] = R;               \
    return 1;                 \
  }
  PYFFT_SWAP_X(PYFFT_SWAPX)
#undef PYFFT_SWAPX
  return 0;
}

// K6's shape at log2n into out[0..3]: G (the blocks of a cluster that
// split each run, PYFFT_RING_X; 1 where a step's blocks take whole runs),
// C (the columns of a run), S (the ring's slots) and a block's bytes of
// shared memory; returns 1, or 0 where K6 takes no such length.  No CUDA
// call.
extern "C" int pyfft_local_cols_ring_shape(int log2n, int* out) {
#define PYFFT_RING(LN, G, C)                                     \
  if (log2n == LN) {                                             \
    const int v[4] = {G, C, Ring<LN, G, C>::S, Ring<LN, G, C>::SMEM}; \
    for (int i = 0; i < 4; ++i) out[i] = v[i];                   \
    return 1;                                                    \
  }
  PYFFT_RING_X(PYFFT_RING)
#define PYFFT_RUNS(LN) PYFFT_RING(LN, 1, (ColShape<LN, float>::C))
  PYFFT_RUNS(3) PYFFT_RUNS(4) PYFFT_RUNS(5) PYFFT_RUNS(6) PYFFT_RUNS(7)
  PYFFT_RUNS(8) PYFFT_RUNS(9) PYFFT_RUNS(10)
#undef PYFFT_RUNS
#undef PYFFT_RING
  return 0;
}

// Launch the column DFT on `stream` without synchronising.  `tw` holds n
// (cos, sin) pairs of sign*2*pi*k/n in the planes' type; `ta` and `tb` are
// the twiddle tables, pairs of that type (null when unused).  `dims` holds
// 16 int64 values: L, T, the input strides (l, n, t), the output strides
// (l, k, t / P, t % P), P, the table strides ak, aq, adiv, bk, bq, and the
// twiddle mode (0 none, 1 table, 2 factored).  Strides are in elements
// (table strides in pairs).  Return the launch's cudaError_t (0 on
// success; RAN_X (-2) where the cluster tile ran; RAN_RING (-1) where a
// persistent ring ran, K5's column ring or K12's cluster ring; RAN_XRING
// (-3) where K5's persistent cluster ring ran).
// complex64: float planes, 8 <= n <= 8192.
extern "C" int pyfft_local_cols(const void* in_re, const void* in_im,
                                void* out_re, void* out_im, const void* tw,
                                const void* ta, const void* tb,
                                const long long* dims, int log2n, int sign,
                                float postscale, int swap_store,
                                void* stream) {
  return launch_cols<float, 13>(in_re, in_im, out_re, out_im, tw, ta, tb,
                                dims, log2n, sign, postscale, swap_store,
                                stream);
}

// complex128: double planes, 8 <= n <= 4096, computed in native FP64.
extern "C" int pyfft_local_cols_f64(const void* in_re, const void* in_im,
                                    void* out_re, void* out_im,
                                    const void* tw, const void* ta,
                                    const void* tb, const long long* dims,
                                    int log2n, int sign, double postscale,
                                    int swap_store, void* stream) {
  return launch_cols<double, 12>(in_re, in_im, out_re, out_im, tw, ta, tb,
                                 dims, log2n, sign, postscale, swap_store,
                                 stream);
}

// K4: the DFT along the rows of (L, T, n) float planes into (L, n, T),
// postscale folded.  `dims` as above with the input strides given as (l,
// j, row) and the output's as (l, k, 0, row); no twiddle (mode 0), no
// table.  The output must not overlap the input.
extern "C" int pyfft_local_rows_swap(const void* in_re, const void* in_im,
                                     void* out_re, void* out_im,
                                     const void* tw, const long long* dims,
                                     int log2n, int sign, float postscale,
                                     void* stream) {
  return launch_cols<float, 13>(in_re, in_im, out_re, out_im, tw, nullptr,
                                nullptr, dims, log2n, sign, postscale, 0,
                                stream, ROWS);
}

// K6: the complex64 column DFT with a plain store and no twiddle or the
// `full` one (mode 0 or 1), a block taking `ctile` 128-column tiles; T must
// be a multiple of 128*ctile.  Arguments as pyfft_local_cols's.
extern "C" int pyfft_local_cols_ctile(const void* in_re, const void* in_im,
                                      void* out_re, void* out_im,
                                      const void* tw, const void* ta,
                                      const void* tb, const long long* dims,
                                      int log2n, int sign, float postscale,
                                      int ctile, void* stream) {
  return launch_cols<float, 13>(in_re, in_im, out_re, out_im, tw, ta, tb,
                                dims, log2n, sign, postscale, 0, stream, WALK,
                                ctile);
}

// The columns per block the int8 column kernel uses at log2n (0 outside
// 3..13).
extern "C" int pyfft_local_cols_width_i8(int log2n) {
  return width<float, 13, true>(log2n);
}

// K5 + K10: the complex64 column DFT with the f-point int8 stage last (f =
// 2^log2f, see PYFFT_I8_CHAINS); `wch` holds the stage's 3 channels, (3,
// 2f, 2f) int8 C-contiguous, followed (f >= 32) by their shared-memory
// image (ops/int8.py `w_tables`), 16-byte aligned.  Other arguments as
// pyfft_local_cols's; a plain store may write in place.
extern "C" int pyfft_local_cols_i8(const void* in_re, const void* in_im,
                                   void* out_re, void* out_im, const void* tw,
                                   const void* ta, const void* tb,
                                   const void* wch, const long long* dims,
                                   int log2n, int log2f, int sign,
                                   float postscale, int swap_store,
                                   void* stream) {
  const Cols<float> io = cols_io<float>(in_re, in_im, out_re, out_im, ta, tb,
                                        dims, postscale);
  if (io.L <= 0 || io.T <= 0 || io.P <= 0 || io.adiv <= 0)
    return (int)cudaErrorInvalidValue;
  const float2* t = static_cast<const float2*>(tw);
  const int8_t* w = static_cast<const int8_t*>(wch);
  const float s = sign < 0 ? -1.f : 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PYFFT_I8_COLS(LN, LF)                                      \
  if (log2n == LN && log2f == LF)                                  \
    return swap_store ? (int)launch_i8<LN, LF, true>(io, t, s, w, st) \
                      : (int)launch_i8<LN, LF, false>(io, t, s, w, st);
  PYFFT_I8_CHAINS(PYFFT_I8_COLS)
#undef PYFFT_I8_COLS
  return (int)cudaErrorInvalidValue;
}

// K4 + K10: K4's DFT along the rows of (L, T, n) float planes into (L, n,
// T) with the f-point int8 stage last (f = 2^log2f, the last factor of the
// JAX default chain: PYFFT_I8_CHAINS and (11, 7)).  Arguments as
// pyfft_local_cols_i8's, with K4's dims (as pyfft_local_rows_swap's), no
// table (mode 0) and no swapped store, and `group`, the rows of an
// alignment group: a power of two dividing the block's rows
// (pyfft_local_cols_width_i8), gcd(that, JAX's lanes).  The output must not
// overlap the input.
extern "C" int pyfft_local_rows_swap_i8(const void* in_re, const void* in_im,
                                        void* out_re, void* out_im,
                                        const void* tw, const void* ta,
                                        const void* tb, const void* wch,
                                        const long long* dims, int log2n,
                                        int log2f, int sign, float postscale,
                                        int swap_store, int group,
                                        void* stream) {
  const Cols<float> io = cols_io<float>(in_re, in_im, out_re, out_im, ta, tb,
                                        dims, postscale);
  const int c = width<float, 13, true>(log2n);
  if (io.L <= 0 || io.T <= 0 || io.P <= 0 || io.adiv <= 0 || swap_store ||
      io.tw_mode != TW_NONE || group < 1 || c % group ||
      (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const float2* t = static_cast<const float2*>(tw);
  const int8_t* w = static_cast<const int8_t*>(wch);
  const float s = sign < 0 ? -1.f : 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PYFFT_I8_SWAP(LN, LF)     \
  if (log2n == LN && log2f == LF) \
    return (int)launch_i8<LN, LF, false, ROWS>(io, t, s, w, st, group);
  PYFFT_I8_CHAINS(PYFFT_I8_SWAP)
#undef PYFFT_I8_SWAP
  // n = 2048: the default chain's f = 128
  if (log2n == 11 && log2f == 7)
    return (int)launch_i8<11, 7, false, ROWS>(io, t, s, w, st, group);
  return (int)cudaErrorInvalidValue;
}
