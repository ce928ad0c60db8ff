// Batched length-n complex64 DFT along contiguous rows: the "local" row
// kernel of pyfft_tpu_torch.
//
// Replaces the JAX package's Pallas row kernel (pyfft_tpu/ops/pallas_local.py:
// `_kernel`, launched by `_row_call_inner` through `pl.pallas_call`).  That
// kernel transposes (128, n) blocks to (n, 128) and runs DFT-matrix stages on
// the TPU's matrix unit; none of that layout carries over.  This one computes
// the same function with a design of its own:
//
//   out[r, k] = postscale * sum_j x[r, j] * exp(sign * 2*pi*i * j*k / n)
//
// for n = 2^log2n, 8 <= n <= 8192, in natural output order.
//
// What bounds it on an H100: bytes.  A row is read once and written once
// (8 B in and 8 B out per point), so a 4096 x 4096 batch is one 256 MiB
// device-memory round trip.  By the 5*n*log2(n) count that is under 4 flop
// per byte, far below the ~20 FP32 flop per byte at which the card's
// arithmetic, not its memory, would be the limit.  So the design keeps the
// data in device memory exactly once each way:
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
//     shared memory (8n bytes per row).  A thread holds all its butterflies'
//     values in registers across a barrier before it writes, so one buffer
//     is enough; n = 8192 needs 64 KB, above the 48 KB default, hence the
//     cudaFuncSetAttribute opt-in;
//   * FP32 FMA arithmetic; twiddles come from one table exp(sign*2*pi*i*k/n),
//     k < n, built on the host in float64 and rounded once (no device sinf);
//   * the postscale (1/N and the user scale) is folded into the last store.
//
// Every global read of a block happens in the first stage and every global
// write in the last, with a barrier between them, and blocks own disjoint
// rows: so the output may alias the input (in place).
//
// Each operand is a pair of float planes with an element stride and a row
// stride, both in floats: planar data has (1, n); the two planes of
// torch.view_as_real(complex64) have (2, 2n), with im = re + 1.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry point `pyfft_local_rows` at the bottom.

#include <cuda_runtime.h>

namespace {

struct Io {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  int rows;
  int in_es, in_rs, out_es, out_rs;
  float post;
};

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * (s*i), s = +-1
__device__ __forceinline__ float2 mul_si(float2 a, float s) {
  return make_float2(-s * a.y, s * a.x);
}

// In-register R-point DFT, y[k] = sum_r v[r] * exp(s*2*pi*i*r*k/R).
template <int R>
__device__ __forceinline__ void dft(float2* v, float s);

template <>
__device__ __forceinline__ void dft<2>(float2* v, float s) {
  const float2 a = v[0], b = v[1];
  v[0] = a + b;
  v[1] = a - b;
}

template <>
__device__ __forceinline__ void dft<4>(float2* v, float s) {
  const float2 a = v[0] + v[2], b = v[0] - v[2];
  const float2 c = v[1] + v[3], d = mul_si(v[1] - v[3], s);
  v[0] = a + c;
  v[1] = b + d;
  v[2] = a - c;
  v[3] = b - d;
}

// 8 = 2 x 4: a radix-2 step over the high input digit, the w8^j twiddles
// as constants (w8 = c(1 + s*i), c = sqrt(1/2)), then two 4-point DFTs
// whose outputs interleave as k = 2*k2 + k1.
template <>
__device__ __forceinline__ void dft<8>(float2* v, float s) {
  const float c = 0.70710678118654752440f;
  float2 e[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = v[j] + v[j + 4];
    o[j] = v[j] - v[j + 4];
  }
  o[1] = make_float2(c * (o[1].x - s * o[1].y), c * (o[1].y + s * o[1].x));
  o[2] = mul_si(o[2], s);
  o[3] = make_float2(-c * (o[3].x + s * o[3].y), c * (s * o[3].x - o[3].y));
  dft<4>(e, s);
  dft<4>(o, s);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = e[k];
    v[2 * k + 1] = o[k];
  }
}

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
// writes it; the stages between read and write shared memory.
template <int N, int T, int RPB, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void stage(const Io& io, float2* sm,
                                      const float2* __restrict__ tw, int row0,
                                      float s) {
  constexpr int NR = N / R;          // butterflies per row
  constexpr int B = RPB * NR / T;    // butterflies per thread
  static_assert(B * R * T == RPB * N, "threads must tile the block exactly");
  float2 v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * T;
    const int rr = q / NR, j = q % NR;
    const int row = row0 + rr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      if (FIRST) {
        if (row < io.rows) {
          const long long o =
              (long long)row * io.in_rs + (long long)k * io.in_es;
          v[b][r] = make_float2(io.in_re[o], io.in_im[o]);
        } else {
          v[b][r] = make_float2(0.f, 0.f);
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
          const long long o =
              (long long)row * io.out_rs + (long long)k * io.out_es;
          io.out_re[o] = v[b][r].x * io.post;
          io.out_im[o] = v[b][r].y * io.post;
        }
      } else {
        sm[rr * N + k] = v[b][r];
      }
    }
  }
  if (!LAST) __syncthreads();
}

template <int LOGN, int STAGE, int NS>
__device__ __forceinline__ void stages(const Io& io, float2* sm,
                                       const float2* __restrict__ tw,
                                       int row0, float s) {
  using S = Shape<LOGN>;
  constexpr int R = (STAGE == 0 && S::REM) ? (1 << S::REM) : 8;
  stage<S::N, S::T, S::RPB, R, NS, STAGE == 0, STAGE == S::NSTAGES - 1>(
      io, sm, tw, row0, s);
  if constexpr (STAGE + 1 < S::NSTAGES)
    stages<LOGN, STAGE + 1, NS * R>(io, sm, tw, row0, s);
}

template <int LOGN>
__global__ void __launch_bounds__(Shape<LOGN>::T)
    local_rows_kernel(Io io, const float2* __restrict__ tw, float s) {
  extern __shared__ float2 sm[];
  stages<LOGN, 0, 1>(io, sm, tw, blockIdx.x * Shape<LOGN>::RPB, s);
}

template <int LOGN>
cudaError_t launch(const Io& io, const float2* tw, float s,
                   cudaStream_t stream) {
  using S = Shape<LOGN>;
  const int smem = S::NSTAGES > 1 ? S::P * (int)sizeof(float2) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_rows_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (io.rows + S::RPB - 1) / S::RPB;
  local_rows_kernel<LOGN><<<blocks, S::T, smem, stream>>>(io, tw, s);
  return cudaGetLastError();
}

}  // namespace

// Launches the row DFT on `stream` without synchronising.  Strides are in
// floats; `tw` holds n (cos, sin) float pairs of sign*2*pi*k/n.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int pyfft_local_rows(const void* in_re, const void* in_im,
                                void* out_re, void* out_im, const void* tw,
                                int rows, int log2n, int in_es, int in_rs,
                                int out_es, int out_rs, int sign,
                                float postscale, void* stream) {
  const Io io{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
              static_cast<float*>(out_re), static_cast<float*>(out_im),
              rows, in_es, in_rs, out_es, out_rs, postscale};
  const float2* t = static_cast<const float2*>(tw);
  const float s = sign < 0 ? -1.f : 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  switch (log2n) {
    case 3: return (int)launch<3>(io, t, s, st);
    case 4: return (int)launch<4>(io, t, s, st);
    case 5: return (int)launch<5>(io, t, s, st);
    case 6: return (int)launch<6>(io, t, s, st);
    case 7: return (int)launch<7>(io, t, s, st);
    case 8: return (int)launch<8>(io, t, s, st);
    case 9: return (int)launch<9>(io, t, s, st);
    case 10: return (int)launch<10>(io, t, s, st);
    case 11: return (int)launch<11>(io, t, s, st);
    case 12: return (int)launch<12>(io, t, s, st);
    case 13: return (int)launch<13>(io, t, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
