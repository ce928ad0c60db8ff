// The DFT of a tile of C columns split over a group of G blocks of one
// thread-block cluster, the blocks exchanging through distributed shared
// memory (DSMEM): the complex128 cluster column kernel of local_cols.cu
// (K12 from n = 1024 points) and phase 2 of the tiled 2D kernel
// fused2d_tiled.cu (K9), in double and in float.  At the bottom, the
// cluster launch the 2D kernels and K12 share.
//
// Why: a column tile of 128-byte runs of each plane (16 doubles, 32
// floats a row) at n >= 1024 is more than one block's shared memory, and
// the runs a block can hold alone (32 bytes, 8 floats or 4 doubles, at n =
// 2048) cost half of what the bytes should (PERF.md).  A group of G blocks
// holds it.  Decimation in time across the group, N = G*M:
//
//   1. block b (0 <= b < G) loads rows j = b + G*j', j' < M, of the tile's
//      C columns into a [j'][c] buffer, every load of a thread issued before
//      its first store to shared memory (xt_load);
//   2. a Stockham radix-8 chain over those M points (a radix-2 or radix-4
//      stage first where log2 M is not a multiple of 3), result in natural
//      order in the buffer (xt_chain): Y_b[k'], k' < M;
//   3. a cluster barrier; block r then reads through DSMEM the values at
//      k' in [r*M/G, (r+1)*M/G) of all G blocks, twiddles block b's by
//      w_N^(b*k'), and runs G-point DFTs in registers:
//      X[k' + M*k2] = sum_b w_G^(b*k2) w_N^(b*k') Y_b[k'] (xt_exchange);
//   4. a second barrier's arrive once its remote reads are done, the
//      outputs stored, and its wait before the buffer is written again (or
//      the block exits), so no block reads a buffer that is being
//      overwritten.
//
// Every load of the group's tile happens before the first barrier and
// every store after it, so a store may overwrite the tile's own input (in
// place).  w_N^x is read from the caller's table of N entries (the M-point
// chain takes every G-th).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "stockham.cuh"

namespace pyfft {

constexpr int ilog2c(int n) { return n <= 1 ? 0 : 1 + ilog2c(n / 2); }

// The cluster barrier in its two halves: arrive (release: this thread's
// memory operations so far are visible to the cluster) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The tile of one block: N = G*M points of C columns, M a block, NT
// threads.
template <typename Real, int LOGM, int G, int C, int NT>
struct XTile {
  using V = typename Complex<Real>::V;
  using Real_ = Real;
  static constexpr int G_ = G, C_ = C, NT_ = NT;
  static constexpr int M = 1 << LOGM;      // rows a block
  static constexpr int N = G * M;          // the transform's length
  static constexpr int KR = M / G;         // k' a block takes in step 3
  static constexpr int P = M * C;          // values a block
  static constexpr int E = P / NT;         // values a thread
  static constexpr int PAIRS = KR * C / NT;  // (k', c) a thread in step 3
  static constexpr int REM = LOGM % 3;
  static constexpr int NSTAGES = LOGM / 3 + (REM ? 1 : 0);
  // G = 1: one block holds the whole tile (no exchange; csrc/ring_cols.cuh)
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16,
                "G-point DFTs of radix 2, 4, 8 or 16");
  static_assert(E * NT == P && PAIRS * NT == KR * C && PAIRS >= 1,
                "threads tile the block and the exchange");
  static_assert(P / 8 >= NT, "every thread a butterfly of every stage");
};

// Step 1: rows rank + G*j' of the tile into the [j'][c] buffer;
// load(c, j) gives column c of the tile's row j.  The caller synchronises
// the block before the buffer is read.
template <class X, class Load>
__device__ __forceinline__ void xt_load(typename X::V* sm, int rank,
                                        const Load& load) {
  constexpr int NT = X::NT_;
  typename X::V v[X::E];
#pragma unroll
  for (int i = 0; i < X::E; ++i) {
    const int e = threadIdx.x + i * NT;
    v[i] = load(e % X::C_, rank + X::G_ * (e / X::C_));
  }
#pragma unroll
  for (int i = 0; i < X::E; ++i) sm[threadIdx.x + i * NT] = v[i];
}

// One radix-R Stockham stage over the block's M points of C columns in the
// [k][c] buffer: all reads, a barrier, all writes, a barrier.  NS is the
// product of the radices before it; `tw` holds w_N^x, x < N.  KMAJOR (the
// last stage only): the writes go to a [c][k] buffer padded by one element
// a column, so that step 3 reads runs of k.
template <class X, int R, int NS, bool KMAJOR = false>
__device__ __forceinline__ void xt_stage(typename X::V* sm,
                                         const typename X::V* __restrict__ tw,
                                         typename X::Real_ s) {
  using V = typename X::V;
  constexpr int M = X::M, C = X::C_, NT = X::NT_, NR = M / R;
  constexpr int B = NR * C / NT;
  static_assert(B * R * NT == M * C, "threads must tile the block exactly");
  V v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = sm[(j + r * NR) * C + c];
    if (NS > 1) {
      const int jj = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (X::N / (NS * R))]));
    }
    dft<R>(v[b], s);
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
      sm[KMAJOR ? c * (M + 1) + k : k * C + c] = v[b][r];
    }
  }
  __syncthreads();
}

// Step 2: the M-point chain from stage STAGE on; KMAJOR: its result in the
// padded [c][k] buffer.
template <class X, bool KMAJOR = false, int STAGE = 0, int NS = 1>
__device__ __forceinline__ void xt_chain(typename X::V* sm,
                                         const typename X::V* __restrict__ tw,
                                         typename X::Real_ s) {
  constexpr int R = (STAGE == 0 && X::REM) ? (1 << X::REM) : 8;
  constexpr bool LAST = STAGE + 1 == X::NSTAGES;
  xt_stage<X, R, NS, KMAJOR && LAST>(sm, tw, s);
  if constexpr (!LAST) xt_chain<X, KMAJOR, STAGE + 1, NS * R>(sm, tw, s);
}

// Steps 3 and 4 for block `rank` of the group at cluster ranks g0 .. g0 +
// G - 1: put(c, k', y) takes the G outputs y[k2] = X[k' + M*k2] of column
// c (to device memory: the second barrier's wait comes after every put).
// KMAJOR: the chain left [c][k] buffers (xt_chain<X, true>), and
// neighbouring threads take neighbouring k' of one column (else
// neighbouring columns of one k'), so that put's stores run along k.  On
// return every block of the cluster is done reading this block's buffer.
template <class X, bool KMAJOR = false, class Put>
__device__ __forceinline__ void xt_exchange(
    cooperative_groups::cluster_group& cluster, typename X::V* sm,
    const typename X::V* __restrict__ tw, typename X::Real_ s, int g0,
    int rank, const Put& put) {
  using V = typename X::V;
  constexpr int G = X::G_, C = X::C_, NT = X::NT_, KR = X::KR;
  cluster_arrive();               // this block's chain is in its buffer
  cluster_wait();
  V u[X::PAIRS][G];
#pragma unroll
  for (int b = 0; b < G; ++b) {
    const V* src = cluster.map_shared_rank(sm, g0 + b);
#pragma unroll
    for (int i = 0; i < X::PAIRS; ++i) {
      const int p = threadIdx.x + i * NT;
      u[i][b] = src[KMAJOR ? (p / KR) * (X::M + 1) + rank * KR + p % KR
                           : rank * KR * C + p];
    }
  }
  cluster_arrive();               // this block's remote reads are done
#pragma unroll
  for (int i = 0; i < X::PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int c = KMAJOR ? p / KR : p % C, kl = KMAJOR ? p % KR : p / C;
    const int kp = rank * KR + kl;
#pragma unroll
    for (int b = 1; b < G; ++b) u[i][b] = cmul(u[i][b], __ldg(&tw[b * kp]));
    dft<G>(u[i], s);
    // a put that takes the pair's index i may hold per-pair values
    if constexpr (std::is_invocable_v<const Put&, int, int, const V*, int>)
      put(c, kp, u[i], i);
    else
      put(c, kp, u[i]);
  }
  cluster_wait();
}

// `kernel` over L groups of G blocks (NT threads each), one cluster of G a
// group, `smem` bytes of shared memory a block.
template <int NT, class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), long long L, int G,
                           int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (G > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = L * G;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The clusters of G blocks of `kernel` (NT threads, `smem` bytes each)
// that the card holds at once (cudaOccupancyMaxActiveClusters), 0 where
// none places, a negative cudaError_t where the query fails.
template <int NT, class... Params>
int max_clusters(void (*kernel)(Params...), int G, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && G > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace pyfft
