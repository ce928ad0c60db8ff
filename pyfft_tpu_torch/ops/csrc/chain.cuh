// A Stockham radix-8 chain over C transforms held in one shared-memory
// buffer, with functors for the first stage's loads and the last stage's
// stores: the stage code of the 2D kernels (fused2d.cu, K8, and
// fused2d_tiled.cu, K9), of the row ring (local_rows.cu, K1, K2 and K11)
// and of the column ring (local_cols.cu, K5).  NT is the block's thread
// count.  `stage` and `chain` take complex64 (float2) or complex128
// (double2) values, their type deduced from the buffer; the rest is
// complex64.
// For their int8 kernels (precision="int8"), `lead` runs the stages in
// front of the f-point int8 stage, ChainMap gives that stage
// (int8_stage.cuh's int8_stage_tc) the buffer's layout and put_pair writes
// its outputs.  At the bottom, the host side the two sources share: their
// operands (Planes2D); the cluster launch is cluster_cols.cuh's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_cols.cuh"
#include "stockham.cuh"

namespace pyfft {

// Where element k of transform c of an N-point chain over C transforms
// lies in the buffer: ROWS c*N + k, and with PAD one float2 of padding
// after every 16 (a bank cycle), so that a stage's strided writes (runs of
// NS, NS*R apart) meet at most the two wavefronts of a warp's 8-byte
// accesses instead of up to sixteen-way conflicts; else k*C + c.  The
// buffer of C padded transforms holds C*(N + N/16) values.
template <int N, int C, bool ROWS, bool PAD = false>
__device__ __forceinline__ int chain_index(int c, int k) {
  if constexpr (!ROWS) return k * C + c;
  else if constexpr (PAD) return c * (N + N / 16) + k + k / 16;
  else return c * N + k;
}

// One radix-R Stockham stage over C transforms of length N held in shared
// memory.  ROWS: transform (c, k) at sm[c*N + k] (chain_index, PAD),
// threads running along k; else at sm[k*C + c], threads running along c.
// NS is the product of the radices of the stages before it.  FIRST takes
// its inputs from load(c, k) (device memory) instead of the buffer, LAST
// hands its outputs to store(c, k, v) instead.  A stage that reads and
// writes the buffer does all its reads, then a barrier, then all its
// writes: one buffer serves in and out.  TWD: a butterfly reads the
// twiddles w^1, w^2, w^4 (and w^7 at radix 8) and forms the others with
// one product each (w^3, w^5, w^6), four table reads instead of seven; at
// radix 16 it reads w^1, w^2, w^3, w^4, w^8 and forms the other ten with
// one or two products.  SYNC0: a first stage whose load reads the buffer
// it writes (a slot of the row ring in local_rows.cu) takes that barrier
// too.  `mid` runs after that barrier, before the writes (K8's ring waits
// there for its cluster before its last stage stores into other blocks).
struct NoMid {
  __device__ __forceinline__ void operator()() const {}
};

template <int NT, int N, int C, bool ROWS, int R, int NS, bool FIRST,
          bool LAST, bool PAD = false, bool TWD = false, bool SYNC0 = false,
          class V, class Load, class Store, class Mid = NoMid>
__device__ __forceinline__ void stage(V* sm, const V* __restrict__ tw,
                                      typename RealOf<V>::T s,
                                      const Load& load, const Store& store,
                                      const Mid& mid = Mid{}) {
  constexpr int NR = N / R;          // butterflies per transform
  constexpr int B = NR * C / NT;     // butterflies per thread
  static_assert(B * R * NT == N * C, "threads must tile the block exactly");
  V v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = ROWS ? q / NR : q % C, j = ROWS ? q % NR : q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      v[b][r] = FIRST ? load(c, k) : sm[chain_index<N, C, ROWS, PAD>(c, k)];
    }
    if (NS > 1) {
      const int jj = j % NS;
      if constexpr (TWD && R == 16) {
        // w^1, w^2, w^3, w^4, w^8 read; the others one or two products
        const int e = jj * (N / (NS * R));      // w^r at tw[r*e]
        V w[R];
        w[1] = __ldg(&tw[e]);
        w[2] = __ldg(&tw[2 * e]);
        w[3] = __ldg(&tw[3 * e]);
        w[4] = __ldg(&tw[4 * e]);
        w[8] = __ldg(&tw[8 * e]);
        w[5] = cmul(w[1], w[4]);
        w[6] = cmul(w[2], w[4]);
        w[7] = cmul(w[3], w[4]);
#pragma unroll
        for (int r = 9; r < R; ++r) w[r] = cmul(w[r - 8], w[8]);
#pragma unroll
        for (int r = 1; r < R; ++r) v[b][r] = cmul(v[b][r], w[r]);
      } else if constexpr (TWD && R >= 4) {
        const int e = jj * (N / (NS * R));      // w^r at tw[r*e]
        const V w1 = __ldg(&tw[e]), w2 = __ldg(&tw[2 * e]);
        v[b][1] = cmul(v[b][1], w1);
        v[b][2] = cmul(v[b][2], w2);
        v[b][3] = cmul(v[b][3], cmul(w1, w2));
        if constexpr (R == 8) {
          const V w4 = __ldg(&tw[4 * e]);
          v[b][4] = cmul(v[b][4], w4);
          v[b][5] = cmul(v[b][5], cmul(w1, w4));
          v[b][6] = cmul(v[b][6], cmul(w2, w4));
          v[b][7] = cmul(v[b][7], __ldg(&tw[7 * e]));
        }
      } else {
#pragma unroll
        for (int r = 1; r < R; ++r)
          v[b][r] = cmul(v[b][r], __ldg(&tw[jj * r * (N / (NS * R))]));
      }
    }
    dft<R>(v[b], s);
  }
  if (!FIRST || SYNC0) __syncthreads();
  mid();
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
        sm[chain_index<N, C, ROWS, PAD>(c, k)] = v[b][r];
    }
  }
  if (!LAST) __syncthreads();
}

// The chain along one axis from stage STAGE on: a radix-2 or radix-4 stage
// first when LOGN is not a multiple of 3, then radix 8 (R16: a radix-2, 4
// or 8 stage first when LOGN is not a multiple of 4, then radix 16, a
// shared-memory round trip fewer at most lengths); stage 0 takes its
// inputs from `load` when LOAD, the last stage hands its outputs to `store`
// when STORE, else the result stays in natural order in the buffer (PAD:
// chain_index's padded rows; TWD: stage's twiddles from fewer reads;
// SYNC0: stage 0's load reads the buffer).
template <int NT, int LOGN, int C, bool ROWS, int STAGE, int NS, bool LOAD,
          bool STORE, bool PAD = false, bool TWD = false, bool R16 = false,
          bool SYNC0 = false, class V, class Load, class Store>
__device__ __forceinline__ void chain(V* sm, const V* __restrict__ tw,
                                      typename RealOf<V>::T s,
                                      const Load& load, const Store& store) {
  constexpr int RB = R16 ? 4 : 3;                // log2 of the main radix
  constexpr int REM = LOGN % RB;
  constexpr int NSTAGES = LOGN / RB + (REM ? 1 : 0);
  constexpr int R = (STAGE == 0 && REM) ? (1 << REM) : (1 << RB);
  stage<NT, 1 << LOGN, C, ROWS, R, NS, LOAD && STAGE == 0,
        STORE && STAGE == NSTAGES - 1, PAD, TWD, SYNC0 && STAGE == 0>(
      sm, tw, s, load, store);
  if constexpr (STAGE + 1 < NSTAGES)
    chain<NT, LOGN, C, ROWS, STAGE + 1, NS * R, LOAD, STORE, PAD, TWD, R16>(
        sm, tw, s, load, store);
}

// The stages of an N-point chain (N = 2^LOGN) in front of its f-point
// int8 stage (f = 2^LOGF), from stage STAGE on: LOGN - LOGF bits, a
// radix-2 or radix-4 stage first when that is not a multiple of 3, then
// radix 8, every result left in the buffer; stage 0 takes its inputs from
// `load` when LOAD.  None at n = f.
template <int NT, int LOGN, int LOGF, int C, bool ROWS, int STAGE, int NS,
          bool LOAD, class Load>
__device__ __forceinline__ void lead(float2* sm, const float2* __restrict__ tw,
                                     float s, const Load& load) {
  constexpr int LB = LOGN - LOGF, REM = LB % 3;
  constexpr int NL = LB / 3 + (REM ? 1 : 0);
  if constexpr (STAGE < NL) {
    constexpr int R = (STAGE == 0 && REM) ? (1 << REM) : 8;
    const auto none = [](int, int, float2) {};
    stage<NT, 1 << LOGN, C, ROWS, R, NS, LOAD && STAGE == 0, false>(
        sm, tw, s, load, none);
    lead<NT, LOGN, LOGF, C, ROWS, STAGE + 1, NS * R, LOAD>(sm, tw, s, load);
  }
}

// The int8 stage's view of C transforms of length N in the buffer after
// `lead` (NS = N / F): column q = (transform c, run j), its element r at
// index(c, j + r*NS) of the chain's layout (ROWS: c*N + k, else k*C + c),
// the run j fastest in ROWS so that neighbouring lanes read neighbouring
// slots.  Output k of column q is element j + k*NS of transform c, natural
// order; int8_stage_tc hands it over for two columns at a time, q and q +
// 1, to out(c0, k0, c1, k1, re, im): element k0 of transform c0 is (re.x,
// im.x), element k1 of c1 is (re.y, im.y).  INTO_X: out writes where x's
// channels lie (the buffer), so the stage holds its outputs until its
// last product.
template <int N, int F, int C, bool ROWS, class Out, bool HOLD = false>
struct ChainMap {
  static constexpr int NS = N / F, Q = C * NS;
  static constexpr bool INTO_X = HOLD, GROUPS = false;
  Out out;
  __device__ int cof(int q) const { return ROWS ? q / NS : q % C; }
  __device__ int jof(int q) const { return ROWS ? q % NS : q / C; }
  __device__ int index(int q, int r) const {
    const int k = jof(q) + r * NS;
    return ROWS ? cof(q) * N + k : k * C + cof(q);
  }
  __device__ void put2(int q, int k, float2 re, float2 im) const {
    out(cof(q), jof(q) + k * NS, cof(q + 1), jof(q + 1) + k * NS, re, im);
  }
};

// Two outputs of an int8 stage to device memory, times `post`: (re.x,
// im.x) at offset o0 of the planes, (re.y, im.y) at o1; one 8-byte store
// of each plane where they are neighbours.
__device__ __forceinline__ void put_pair(float* out_re, float* out_im,
                                         long long o0, long long o1,
                                         float2 re, float2 im, float post) {
  re = make_float2(re.x * post, re.y * post);
  im = make_float2(im.x * post, im.y * post);
  if (o1 == o0 + 1 && ((reinterpret_cast<uintptr_t>(out_re + o0) |
                        reinterpret_cast<uintptr_t>(out_im + o0)) & 7) == 0) {
    *reinterpret_cast<float2*>(out_re + o0) = re;
    *reinterpret_cast<float2*>(out_im + o0) = im;
  } else {
    out_re[o0] = re.x;
    out_im[o0] = im.x;
    out_re[o1] = re.y;
    out_im[o1] = im.y;
  }
}

// The operands of a 2D kernel: L planes, strides (l, y, x) in floats.
struct Planes2D {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  long long L;
  long long in_ls, in_ys, in_xs;
  long long out_ls, out_ys, out_xs;
  float post;
};

// The operands and `dims` (L, the input strides (l, y, x), the output
// strides (l, y, x)) as a Planes2D.
inline Planes2D planes_2d(const void* in_re, const void* in_im, void* out_re,
                          void* out_im, const long long* dims,
                          float postscale) {
  Planes2D io;
  io.in_re = static_cast<const float*>(in_re);
  io.in_im = static_cast<const float*>(in_im);
  io.out_re = static_cast<float*>(out_re);
  io.out_im = static_cast<float*>(out_im);
  io.L = dims[0];
  io.in_ls = dims[1];
  io.in_ys = dims[2];
  io.in_xs = dims[3];
  io.out_ls = dims[4];
  io.out_ys = dims[5];
  io.out_xs = dims[6];
  io.post = postscale;
  return io;
}

}  // namespace pyfft
