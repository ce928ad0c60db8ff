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
// So the design keeps the data in device memory exactly once each way:
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
// `pyfft_local_rows_il_i8` (interleaved, int8 stage) and
// `pyfft_local_rows_i8_stage` (which stage an int8 instance runs) at the
// bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_stage.cuh"
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
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (N / (NS * R))]));
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

}  // namespace

// Launch the row DFT on `stream` without synchronising.  Strides are in
// elements of the planes' type; `tw` holds n (cos, sin) pairs of
// sign*2*pi*k/n in that type.  Return the launch's cudaError_t (0 on
// success).  complex64: float planes, 8 <= n <= 8192.
extern "C" int pyfft_local_rows(const void* in_re, const void* in_im,
                                void* out_re, void* out_im, const void* tw,
                                int rows, int log2n, int in_es, int in_rs,
                                int out_es, int out_rs, int sign,
                                float postscale, void* stream) {
  return (int)dispatch<float, false, 13>(
      log2n,
      planes<float>(in_re, in_im, out_re, out_im, rows, in_es, in_rs, out_es,
                    out_rs, postscale),
      tw, sign, stream);
}

// complex128: double planes, 8 <= n <= 4096, computed in native FP64.
extern "C" int pyfft_local_rows_f64(const void* in_re, const void* in_im,
                                    void* out_re, void* out_im,
                                    const void* tw, int rows, int log2n,
                                    int in_es, int in_rs, int out_es,
                                    int out_rs, int sign, double postscale,
                                    void* stream) {
  return (int)dispatch<double, false, 12>(
      log2n,
      planes<double>(in_re, in_im, out_re, out_im, rows, in_es, in_rs,
                     out_es, out_rs, postscale),
      tw, sign, stream);
}

// K2, complex64 interleaved: `in` and `out` are (rows, n) arrays of float2
// (re, im) pairs, each 8-byte aligned, with row strides in pairs; 8 <= n
// <= 8192.  `out` may be `in` (in place).
extern "C" int pyfft_local_rows_il(const void* in, void* out, const void* tw,
                                   int rows, int log2n, int in_rs,
                                   int out_rs, int sign, float postscale,
                                   void* stream) {
  const Io<float> io{nullptr, nullptr, nullptr, nullptr,
                     static_cast<const float2*>(in), static_cast<float2*>(out),
                     rows, 1, in_rs, 1, out_rs, postscale};
  return (int)dispatch<float, true, 13>(log2n, io, tw, sign, stream);
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
