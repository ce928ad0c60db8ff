// De-interleave and interleave of float32 pairs: the streaming conversion
// kernels of pyfft_tpu_torch, K13 (interleaved -> planes) and K14 (planes
// -> interleaved).
//
// Replaces the JAX package's Pallas kernels in pyfft_tpu/ops/interleave.py:
// `_deint_kernel`, launched by `_deinterleave2`, and `_int_kernel`,
// launched by `_interleave2`.  Those contract 256-lane chunks against 0/1
// selection matrices on the TPU's matrix unit, because a TPU has no strided
// lane access and the pair split is otherwise a relayout; the 256-lane
// chunk rule of `interleave.supported` is that tile.  None of it carries
// over.  Here both are plain copies, bit-exact (no arithmetic touches a
// value):
//
//   deinterleave: re[r, p] = v[r, 2p],  im[r, p] = v[r, 2p + 1]
//   interleave:   v[r, 2p] = re[r, p],  v[r, 2p + 1] = im[r, p]
//
// for any n >= 1 pairs a row, with row strides in floats.
//
// What bounds them on an H100: bytes, one read and one write of the data
// (8 bytes in and 8 out a pair) and no operations.  So each thread moves two
// pairs: one 16-byte float4 of the interleaved side and one 8-byte float2 of
// each plane, consecutive threads on consecutive addresses, which keeps
// every warp access whole 32-byte sectors.  Where the rows or the pointers
// do not allow those vector accesses (odd n, or an offset that breaks their
// alignment), the same kernel moves one pair a thread with scalar accesses.
// The host collapses dense rows into one row, so the common case is one
// flat copy with no row arithmetic.  Rows go over the grid's y dimension (a
// loop past 65535), pairs over x with a grid-stride loop.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry points `pyfft_deinterleave` and
// `pyfft_interleave` at the bottom.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS_X = 1 << 20;
constexpr long long MAX_BLOCKS_Y = 65535;

// One work item a thread: with VEC, pairs 2c and 2c+1 (the last item of an
// odd row takes its one pair scalar); without, pair c.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    deinterleave_kernel(const float* __restrict__ v, float* __restrict__ re,
                        float* __restrict__ im, long long rows, long long n,
                        long long v_rs, long long p_rs) {
  const long long items = VEC ? (n + 1) / 2 : n;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* vr = v + row * v_rs;
    float* rr = re + row * p_rs;
    float* ir = im + row * p_rs;
    for (long long c = blockIdx.x * (long long)THREADS + threadIdx.x;
         c < items; c += (long long)gridDim.x * THREADS) {
      if (VEC && 2 * c + 1 < n) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(vr) + c);
        reinterpret_cast<float2*>(rr)[c] = make_float2(a.x, a.z);
        reinterpret_cast<float2*>(ir)[c] = make_float2(a.y, a.w);
      } else {
        const long long p = VEC ? 2 * c : c;
        rr[p] = __ldg(vr + 2 * p);
        ir[p] = __ldg(vr + 2 * p + 1);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    interleave_kernel(const float* __restrict__ re,
                      const float* __restrict__ im, float* __restrict__ v,
                      long long rows, long long n, long long v_rs,
                      long long p_rs) {
  const long long items = VEC ? (n + 1) / 2 : n;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    float* vr = v + row * v_rs;
    const float* rr = re + row * p_rs;
    const float* ir = im + row * p_rs;
    for (long long c = blockIdx.x * (long long)THREADS + threadIdx.x;
         c < items; c += (long long)gridDim.x * THREADS) {
      if (VEC && 2 * c + 1 < n) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(rr) + c);
        const float2 b = __ldg(reinterpret_cast<const float2*>(ir) + c);
        reinterpret_cast<float4*>(vr)[c] = make_float4(a.x, b.x, a.y, b.y);
      } else {
        const long long p = VEC ? 2 * c : c;
        vr[2 * p] = __ldg(rr + p);
        vr[2 * p + 1] = __ldg(ir + p);
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Whether every row of both sides allows the vector accesses: the
// interleaved rows start on 16 bytes and the planes' rows on 8.
bool vector_ok(const void* v, const void* re, const void* im, long long rows,
               long long v_rs, long long p_rs) {
  return aligned(v, 16) && aligned(re, 8) && aligned(im, 8) &&
         (rows == 1 || (v_rs % 4 == 0 && p_rs % 2 == 0));
}

dim3 grid(long long rows, long long items) {
  const long long x = (items + THREADS - 1) / THREADS;
  return dim3((unsigned)(x < MAX_BLOCKS_X ? x : MAX_BLOCKS_X),
              (unsigned)(rows < MAX_BLOCKS_Y ? rows : MAX_BLOCKS_Y));
}

}  // namespace

// Launch on `stream` without synchronising; return the launch's
// cudaError_t (0 on success).  `v` is (rows, 2n) floats with row stride
// v_rs, `re` and `im` (rows, n) floats with row stride p_rs; the two sides
// must not overlap.
extern "C" int pyfft_deinterleave(const void* v, void* re, void* im,
                                  long long rows, long long n, long long v_rs,
                                  long long p_rs, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(v);
  float* r = static_cast<float*>(re);
  float* i = static_cast<float*>(im);
  if (vector_ok(v, re, im, rows, v_rs, p_rs)) {
    deinterleave_kernel<true><<<grid(rows, (n + 1) / 2), THREADS, 0, st>>>(
        src, r, i, rows, n, v_rs, p_rs);
  } else {
    deinterleave_kernel<false><<<grid(rows, n), THREADS, 0, st>>>(
        src, r, i, rows, n, v_rs, p_rs);
  }
  return (int)cudaGetLastError();
}

extern "C" int pyfft_interleave(const void* re, const void* im, void* v,
                                long long rows, long long n, long long v_rs,
                                long long p_rs, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(re);
  const float* i = static_cast<const float*>(im);
  float* dst = static_cast<float*>(v);
  if (vector_ok(v, re, im, rows, v_rs, p_rs)) {
    interleave_kernel<true><<<grid(rows, (n + 1) / 2), THREADS, 0, st>>>(
        r, i, dst, rows, n, v_rs, p_rs);
  } else {
    interleave_kernel<false><<<grid(rows, n), THREADS, 0, st>>>(
        r, i, dst, rows, n, v_rs, p_rs);
  }
  return (int)cudaGetLastError();
}
