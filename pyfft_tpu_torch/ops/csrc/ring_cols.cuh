// The pieces that the multi-tile column kernel K6 (a ring of runs fed by
// tensor copies), the complex128 column kernel K12's persistent cluster
// ring and the digit-swapped row kernel K4 from n = 512 (a row tile split
// over a cluster, loaded by a tensor copy) add to the cluster column tile
// of cluster_cols.cuh; the kernels are in local_cols.cu.  The
// row ring of local_rows.cu (K1 and K2) takes the tensor-map encoder, the
// barrier and fence helpers and align128 from here, K8's plane ring
// (fused2d.cu) the tensor maps and the copies between shared memories.
//
//   * Tensor maps (TMA): a host helper that encodes a 4D map of a float
//     or double plane or of the complex form's pairs, and the box copy
//     into shared memory on an mbarrier.  One thread asks for a whole run
//     or tile of a plane in one instruction; the copy engine makes the
//     addresses.
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
//     (or its pairs) there, and K12's ring too (xt_chain_from_chunks,
//     below).  Like every stage it reads all its values before a barrier
//     and writes the [k][c] buffer after it, so the buffer may be the one
//     it reads.

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
// (`pairs`: the complex form's (re, im) pairs, copied as one 64-bit value,
// or a double plane), dims[0] contiguous, the other three `strides` bytes
// apart; boxes of `box` elements, zeros where a box reaches past the
// tensor.
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

// The address in cluster block `rank`'s shared memory of what lies at
// `local` in this block's (distributed shared memory: every block of the
// kernel lays its shared memory out alike).
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a) : "r"(smem_u32(local)), "r"(rank));
  return a;
}

// The cluster barrier's arrive without release semantics: it orders none
// of this thread's memory operations (cluster_cols.cuh's cluster_arrive
// releases them all, which waits for its stores to device memory too: in
// a block that walks many tiles, the stores of its last tile).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// Copy `bytes` (a multiple of 16) from this block's shared `src` to `dst`
// in cluster block `rank`'s shared memory, both 16-byte aligned, completing
// on that block's mbarrier at `bar` (cp.async.bulk between shared
// memories: the copy engine moves the run, no thread does).
__device__ __forceinline__ void bulk_to_block(void* dst, const void* src,
                                              int bytes, uint64_t* bar,
                                              int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n"
      :: "r"(cluster_addr(dst, rank)), "r"(smem_u32(src)), "r"(bytes),
         "r"(cluster_addr(bar, rank))
      : "memory");
}

// K12's ring exchanges in whole chunks, as K8's plane ring does: the last
// stage of each block's M-point chain writes its outputs into its buffer
// by owner (the block that takes them, k / KR), and one thread hands each
// owner's chunk to the copy engine (cp.async.bulk between shared
// memories) into the owner's receive buffer, at the place of this block,
// completing on the owner's mbarrier (bulk_to_block, above).  No thread
// loads across the cluster, and no release waits for the stores to device
// memory of the tile before.
// Where value k' = o*KR + kl of column c lies in a chunked buffer, o the
// owner (in the sender's buffer) or the sender (in the receive buffer):
// runs of c, or (KMAJOR, for the swapped store's pairs, which take
// neighbouring k' of one column) runs of k' padded by one element.
template <class X, bool KMAJOR>
__device__ __forceinline__ int xt_chunk_index(int o, int kl, int c) {
  constexpr int C = X::C_, KR = X::KR;
  return KMAJOR ? (o * C + c) * (KR + 1) + kl : (o * KR + kl) * C + c;
}

// The values of one chunk.
template <class X, bool KMAJOR>
__host__ __device__ constexpr int xt_chunk() {
  return KMAJOR ? X::C_ * (X::KR + 1) : X::KR * X::C_;
}

// K12's ring takes every twiddle of its chain after the first stage and
// of its exchange from a table in each block's shared memory, filled once
// a launch (xt_fill_table) from the caller's table of N entries w_N^x,
// each entry one value of it: every tile of the walk needs the same ones,
// since they depend only on the thread and the block's rank.  The radix-8
// stage after NS points (NS the product of the radices before it) reads
// w_N^(jj*r*N/(8*NS)), jj = j % NS, 0 < r < 8, at xt_table_stage(NS) +
// jj*7 + r - 1; the exchange w_N^(b*k'), k' = rank*KR + kl, 0 < b < G, at
// xt_table_exchange() + kl*(G - 1) + b - 1.  A warp's reads are
// broadcasts (C consecutive threads share j, and kl in the plain store's
// exchange) or fall on distinct 16-byte slots of a 128-byte row (the
// swapped store's exchange: eight consecutive kl, G - 1 values apart, G -
// 1 odd).
template <class X>
__host__ __device__ constexpr int xt_first_radix() {
  return X::REM ? (1 << X::REM) : 8;
}

// The stages before the one after NS points hold 7*NS' values each, NS' =
// R0, 8*R0, ..., NS/8: NS - R0 in all.
template <class X>
__host__ __device__ constexpr int xt_table_stage(int ns) {
  return ns - xt_first_radix<X>();
}

template <class X>
__host__ __device__ constexpr int xt_table_exchange() {
  return xt_table_stage<X>(X::M);
}

// The values of the table.
template <class X>
__host__ __device__ constexpr int xt_table() {
  return xt_table_exchange<X>() + X::KR * (X::G_ - 1);
}

// Cluster block `rank`'s table from `tw` (w_N^x, x < N); the caller
// synchronises the block before it is read.
template <class X>
__device__ __forceinline__ void xt_fill_table(
    typename X::V* tab, const typename X::V* __restrict__ tw, int rank) {
  constexpr int N = X::N, G = X::G_, KR = X::KR;
  constexpr int EX = xt_table_exchange<X>();
  for (int e = threadIdx.x; e < xt_table<X>(); e += X::NT_) {
    int x;
    if (e < EX) {                       // stage ns's [jj][r - 1]
      int ns = xt_first_radix<X>();
      while (xt_table_stage<X>(8 * ns) <= e) ns *= 8;
      const int i = e - xt_table_stage<X>(ns);
      x = (i / 7) * (i % 7 + 1) * (N / (8 * ns));
    } else {                            // the exchange's [kl][b - 1]
      const int i = e - EX;
      x = (rank * KR + i / (G - 1)) * (i % (G - 1) + 1);
    }
    tab[e] = __ldg(&tw[x % N]);
  }
}

// One radix-8 stage of X's M-point chain after the first (NS the product
// of the radices before it), as cluster_cols.cuh's xt_stage with its
// twiddles from the block's table `tab` (xt_fill_table): all reads, a
// barrier, all writes, a barrier; the last stage (LAST) writes by owner
// (xt_chunk_index).
template <class X, int R, int NS, bool LAST, bool KMAJOR>
__device__ __forceinline__ void xt_stage_ring(
    typename X::V* sm, const typename X::V* __restrict__ tab,
    typename X::Real_ s) {
  using V = typename X::V;
  constexpr int M = X::M, C = X::C_, NT = X::NT_, NR = M / R, KR = X::KR;
  constexpr int B = NR * C / NT;
  static_assert(B * R * NT == M * C, "threads must tile the block exactly");
  static_assert(R == 8 && NS > 1 && (!LAST || NS * R == M),
                "a radix-8 stage after the first; the last covers M");
  V y[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) y[b][r] = sm[(j + r * NR) * C + c];
    const V* w = tab + xt_table_stage<X>(NS) + (j % NS) * (R - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) y[b][r] = cmul(y[b][r], w[r - 1]);
    dft<R>(y[b], s);
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = base + r * NS;
      sm[LAST ? xt_chunk_index<X, KMAJOR>(k / KR, k % KR, c) : k * C + c] =
          y[b][r];
    }
  }
  __syncthreads();
}

// X's chain from stage STAGE on (STAGE >= 1), its last stage writing by
// owner.
template <class X, bool KMAJOR, int STAGE, int NS>
__device__ __forceinline__ void xt_chain_chunks(
    typename X::V* sm, const typename X::V* __restrict__ tab,
    typename X::Real_ s) {
  constexpr bool LAST = STAGE + 1 == X::NSTAGES;
  xt_stage_ring<X, 8, NS, LAST, KMAJOR>(sm, tab, s);
  if constexpr (!LAST)
    xt_chain_chunks<X, KMAJOR, STAGE + 1, NS * 8>(sm, tab, s);
}

// X's whole M-point chain, its first stage reading load(k, c)
// (xt_first), its later stages' twiddles from the block's table `tab`,
// its result in the buffer by owner.
template <class X, bool KMAJOR, class Load>
__device__ __forceinline__ void xt_chain_from_chunks(
    typename X::V* sm, const typename X::V* __restrict__ tab,
    typename X::Real_ s, const Load& load) {
  constexpr int R = xt_first_radix<X>();
  static_assert(X::NSTAGES > 1, "a stage after the first writes by owner");
  xt_first<X, R>(sm, s, load, [] { __syncthreads(); });
  xt_chain_chunks<X, KMAJOR, 1, R>(sm, tab, s);
}

// The exchange of a tile whose chain left `sm` by owner, in two halves so
// that the copies fly while the block runs the next tile's chain.  Send:
// thread 0 copies each owner's chunk into the owner's receive buffer
// `recv`, at this block's place, completing on the owner's `landed` (this
// block's takes G chunks a tile).  The caller sends only where every
// block has read its `recv` since the last send (the relaxed barrier of
// xt_receive_chunks).
template <class X, bool KMAJOR>
__device__ __forceinline__ void xt_send_chunks(const typename X::V* sm,
                                               typename X::V* recv,
                                               uint64_t* landed, int rank) {
  using V = typename X::V;
  constexpr int G = X::G_, CH = xt_chunk<X, KMAJOR>();
  if (threadIdx.x == 0) {
    fence_async_smem();           // the chain's writes, before the copies
    mbar_expect(landed, G * CH * (int)sizeof(V));
    for (int o = 0; o < G; ++o)
      bulk_to_block(recv + rank * CH, sm + o * CH, CH * (int)sizeof(V),
                    landed, o);
  }
}

// Receive: the wait for the G chunks into this block (phase `phase` of
// `landed`), each pair's G values read from `recv`, the twiddles w_N^(b*k')
// from the block's table `tab` (xt_fill_table), the G-point DFTs and
// put(c, k', y, i) as xt_exchange's;
// then a relaxed
// cluster barrier, past which every block has read its `recv` and passed
// its `landed` wait, so every copy out of the sent buffer has landed.  The
// arrive is relaxed: it orders no memory operation, and relies on the
// reads of `recv` having retired, their values consumed by put's stores
// before it (K8's rule, fused2d.cu; the memory model does not promise it).
// A release arrive would wait for those stores to reach device memory.
template <class X, bool KMAJOR, class Put>
__device__ __forceinline__ void xt_receive_chunks(
    const typename X::V* recv, uint64_t* landed, int phase,
    const typename X::V* __restrict__ tab, typename X::Real_ s, int rank,
    const Put& put) {
  using V = typename X::V;
  constexpr int G = X::G_, C = X::C_, NT = X::NT_, KR = X::KR;
  mbar_wait(landed, phase);
#pragma unroll
  for (int i = 0; i < X::PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int c = KMAJOR ? p / KR : p % C, kl = KMAJOR ? p % KR : p / C;
    const int kp = rank * KR + kl;
    V u[G];
#pragma unroll
    for (int b = 0; b < G; ++b)
      u[b] = recv[xt_chunk_index<X, KMAJOR>(b, kl, c)];
    const V* w = tab + xt_table_exchange<X>() + kl * (G - 1);
#pragma unroll
    for (int b = 1; b < G; ++b) u[b] = cmul(u[b], w[b - 1]);
    dft<G>(u, s);
    put(c, kp, u, i);
  }
  cluster_arrive_relaxed();       // this block's `recv` is read
  cluster_wait();                 // and every block's
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
