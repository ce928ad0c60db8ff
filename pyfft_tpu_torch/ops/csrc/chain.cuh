// A Stockham radix-8 chain over C transforms held in one shared-memory
// buffer, with functors for the first stage's loads and the last stage's
// stores: the stage code of the 2D kernels (fused2d.cu, K8, and
// fused2d_tiled.cu, K9).  NT is the block's thread count.  Complex64.

#pragma once

#include "stockham.cuh"

namespace pyfft {

// One radix-R Stockham stage over C transforms of length N held in shared
// memory.  ROWS: transform (c, k) at sm[c*N + k], threads running along k;
// else at sm[k*C + c], threads running along c.  NS is the product of the
// radices of the stages before it.  FIRST takes its inputs from load(c, k)
// (device memory) instead of the buffer, LAST hands its outputs to
// store(c, k, v) instead.  A stage that reads and writes the buffer does
// all its reads, then a barrier, then all its writes: one buffer serves in
// and out.
template <int NT, int N, int C, bool ROWS, int R, int NS, bool FIRST,
          bool LAST, class Load, class Store>
__device__ __forceinline__ void stage(float2* sm,
                                      const float2* __restrict__ tw, float s,
                                      const Load& load, const Store& store) {
  constexpr int NR = N / R;          // butterflies per transform
  constexpr int B = NR * C / NT;     // butterflies per thread
  static_assert(B * R * NT == N * C, "threads must tile the block exactly");
  float2 v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = ROWS ? q / NR : q % C, j = ROWS ? q % NR : q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      v[b][r] = FIRST ? load(c, k) : sm[ROWS ? c * N + k : k * C + c];
    }
    if (NS > 1) {
      const int jj = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (N / (NS * R))]));
    }
    dft<R>(v[b], s);
  }
  if (!FIRST) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = ROWS ? q / NR : q % C, j = ROWS ? q % NR : q / C;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = base + r * NS;
      if (LAST)
        store(c, k, v[b][r]);
      else
        sm[ROWS ? c * N + k : k * C + c] = v[b][r];
    }
  }
  if (!LAST) __syncthreads();
}

// The chain along one axis from stage STAGE on: a radix-2 or radix-4 stage
// first when LOGN is not a multiple of 3, then radix 8; stage 0 takes its
// inputs from `load` when LOAD, the last stage hands its outputs to `store`
// when STORE, else the result stays in natural order in the buffer.
template <int NT, int LOGN, int C, bool ROWS, int STAGE, int NS, bool LOAD,
          bool STORE, class Load, class Store>
__device__ __forceinline__ void chain(float2* sm,
                                      const float2* __restrict__ tw, float s,
                                      const Load& load, const Store& store) {
  constexpr int REM = LOGN % 3;
  constexpr int NSTAGES = LOGN / 3 + (REM ? 1 : 0);
  constexpr int R = (STAGE == 0 && REM) ? (1 << REM) : 8;
  stage<NT, 1 << LOGN, C, ROWS, R, NS, LOAD && STAGE == 0,
        STORE && STAGE == NSTAGES - 1>(sm, tw, s, load, store);
  if constexpr (STAGE + 1 < NSTAGES)
    chain<NT, LOGN, C, ROWS, STAGE + 1, NS * R, LOAD, STORE>(sm, tw, s, load,
                                                            store);
}

}  // namespace pyfft
