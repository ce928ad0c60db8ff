// The pieces that the multi-tile column kernel K6 (a ring of runs fed by
// tensor copies) and the digit-swapped row kernel K4 from n = 512 (a row
// tile split over a cluster, loaded by a tensor copy) add to the cluster
// column tile of cluster_cols.cuh; both kernels are in local_cols.cu.  The
// row ring of local_rows.cu (K1 and K2) takes the tensor-map encoder, the
// barrier and fence helpers and align128 from here.
//
//   * Tensor maps (TMA): a host helper that encodes a 4D map of a float
//     plane or of the complex form's pairs, and the box copy into shared
//     memory on an mbarrier.  One thread asks for a whole run or tile of a
//     plane in one instruction; the copy engine makes the addresses.
//   * The ring.  A block walks many runs of columns.  Its shared memory
//     holds S slots of one run each, and each slot has an mbarrier.  One
//     thread issues the box copies of the next runs while the block runs
//     the chain and the stores of the current one, so S - 1 runs are in
//     flight from device memory at any time.  A slot is filled again only
//     after a barrier that follows its last reader (its store pass, or the
//     cluster's exchange out of it).
//   * xt_chain_from: the tile's chain (cluster_cols.cuh's xt_chain) with a
//     first stage that reads the block's data through the caller's
//     function instead of the [k][c] buffer: K6 reads a slot's two planes
//     (or its pairs) there.  Like every stage it reads all its values
//     before a barrier and writes the [k][c] buffer after it, so the
//     buffer may be the one it reads.

#pragma once

#include <cuda.h>           // CUtensorMap (the encoder is found at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_cols.cuh"
#include "int8_stage.cuh"   // smem_u32, mbar_init, mbar_wait

namespace pyfft {

// ------------------------------------------------------- tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (the library links
// no libcuda), or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4D tensor map over `base`: elements of 4 bytes (a float plane) or of 8
// (`pairs`: the complex form's (re, im) pairs, copied as one 64-bit value),
// dims[0] contiguous, the other three `strides` bytes apart; boxes of
// `box` elements, zeros where a box reaches past the tensor.
inline cudaError_t tensor_map_4d(CUtensorMap* map, const void* base,
                                 bool pairs, const cuuint64_t (&dims)[4],
                                 const cuuint64_t (&strides)[3],
                                 const cuuint32_t (&box)[4]) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, pairs ? CU_TENSOR_MAP_DATA_TYPE_INT64 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------ device side

// `raw` rounded up to 128 bytes, where the box copies write.
__device__ __forceinline__ float2* align128(unsigned char* raw) {
  return reinterpret_cast<float2*>(raw + ((128u - (smem_u32(raw) & 127u)) &
                                          127u));
}

// Copy the box of `map` at (c0, c1, c2, c3) into shared `dst` (128-byte
// aligned), completing on `bar`'s current phase.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Arrive on `bar` (count 1) and expect `bytes` of asynchronous copies more
// on its current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Order the generic accesses to shared memory that this thread has seen
// (its own, and others' before a barrier) before its later copies into it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The first stage of X's M-point chain (radix R, no twiddles), reading
// value (k, c) of the block's data as load(k, c); then sync() (a block
// barrier, or a cluster barrier where the loads read other blocks); then
// its outputs into the [k][c] buffer `sm` and a block barrier.
template <class X, int R, class Load, class Sync>
__device__ __forceinline__ void xt_first(typename X::V* sm,
                                         typename X::Real_ s,
                                         const Load& load, const Sync& sync) {
  using V = typename X::V;
  constexpr int C = X::C_, NT = X::NT_, NR = X::M / R;
  constexpr int B = NR * C / NT;
  static_assert(B * R * NT == X::M * C, "threads must tile the block exactly");
  V v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = load(j + r * NR, c);
    dft<R>(v[b], s);
  }
  sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) sm[(j * R + r) * C + c] = v[b][r];
  }
  __syncthreads();
}

// X's whole M-point chain, its first stage reading load(k, c), its result
// in natural order in the [k][c] buffer `sm`.
template <class X, class Load>
__device__ __forceinline__ void xt_chain_from(
    typename X::V* sm, const typename X::V* __restrict__ tw,
    typename X::Real_ s, const Load& load) {
  constexpr int R = X::REM ? (1 << X::REM) : 8;
  xt_first<X, R>(sm, s, load, [] { __syncthreads(); });
  if constexpr (X::NSTAGES > 1) xt_chain<X, false, 1, R>(sm, tw, s);
}

// One radix-R stage of X's chain (cluster_cols.cuh's xt_stage) whose
// outputs go to put(k, c, v) instead of the buffer: the last stage of a
// chain that stores from registers.  No barrier after it.
template <class X, int R, int NS, class Put>
__device__ __forceinline__ void xt_stage_out(
    const typename X::V* sm, const typename X::V* __restrict__ tw,
    typename X::Real_ s, const Put& put) {
  using V = typename X::V;
  constexpr int M = X::M, C = X::C_, NT = X::NT_, NR = M / R;
  constexpr int B = NR * C / NT;
  static_assert(B * R * NT == M * C, "threads must tile the block exactly");
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
    V v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = sm[(j + r * NR) * C + c];
    if (NS > 1) {
      const int jj = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], __ldg(&tw[jj * r * (X::N / (NS * R))]));
    }
    dft<R>(v, s);
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) put(base + r * NS, c, v[r]);
  }
}

// X's chain from stage STAGE on (NS the product of the radices before it),
// its last stage's outputs to put(k, c, v).
template <class X, int STAGE, int NS, class Put>
__device__ __forceinline__ void xt_chain_out(
    typename X::V* sm, const typename X::V* __restrict__ tw,
    typename X::Real_ s, const Put& put) {
  constexpr int R = (STAGE == 0 && X::REM) ? (1 << X::REM) : 8;
  if constexpr (STAGE + 1 == X::NSTAGES) {
    xt_stage_out<X, R, NS>(sm, tw, s, put);
  } else {
    xt_stage<X, R, NS>(sm, tw, s);
    xt_chain_out<X, STAGE + 1, NS * R>(sm, tw, s, put);
  }
}

}  // namespace pyfft
