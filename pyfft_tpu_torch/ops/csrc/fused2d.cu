// Batched (ny, nx) complex64 2D DFT over the last two axes, in one kernel:
// the "fused2d" kernel of pyfft_tpu_torch.
//
// Replaces the JAX package's Pallas fused 2D kernel (pyfft_tpu/ops/
// pallas_local.py: `_fused2d_kernel`, launched by `_fft2_fused_inner`
// through `pl.pallas_call`).  That kernel holds a whole (ny, nx) plane in
// the TPU's VMEM, runs the y stages, transposes in VMEM and runs the x
// stages, so the data crosses device memory once instead of twice.  A
// plane of up to 2^18 points (2 MiB) does not fit one Hopper SM's 227 KB of
// shared memory, so this kernel computes the same function with a design of
// its own:
//
//   out[l, ky, kx] = postscale * sum_{y,x} x[l, y, x]
//                                 * exp(sign*2*pi*i*(y*ky/ny + x*kx/nx))
//
// for ny, nx powers of two in [128, 2048] with ny*nx <= 2^18 (the JAX
// planner's fused2d rule: both axes multiples of 128, at most
// MAX_FUSED2D_ELEMS points).
//
//   * one thread-block cluster of G blocks per plane, G = ny*nx / 8192
//     capped at 16, so that the cluster's shared memory holds the whole
//     plane: 64 KB a block (128 KB at 2^18 points); clusters above 8
//     blocks are Hopper's non-portable sizes;
//   * phase 1: block b runs a Stockham radix-8 chain along x over rows
//     [b*ny/G, (b+1)*ny/G) in its shared memory; the first stage reads the
//     rows from device memory with threads running along x (coalesced);
//   * a cluster barrier, then phase 2: block b takes columns
//     [b*nx/G, (b+1)*nx/G).  The first stage of its chain along y reads
//     its inputs from the shared memory of every block of the cluster
//     (distributed shared memory), a second cluster barrier lets every
//     block finish those reads, and the stage writes into the block's own
//     buffer; the other stages run there, and the last one writes the
//     columns to device memory with threads running along x, postscale
//     folded;
//   * so each point is read from device memory once and written once: the
//     exchange between the row and the column transforms never leaves the
//     cluster.
//
// Twiddles come from two tables exp(sign*2*pi*i*k/n), k < n, for ny and nx,
// built on the host in float64 and rounded once (no device sinf/cosf).
// FP32 arithmetic with the in-register DFTs of stockham.cuh, through the
// stage and chain templates of chain.cuh (shared with fused2d_tiled.cu).
//
// In place: phase 1 reads only the block's own rows, and every block of the
// cluster has passed the first barrier before any writes, so the output may
// alias the input exactly.  Each operand is a pair of float planes with
// three strides in floats (l, y, x): planar data has (ny*nx, nx, 1), the
// two planes of torch.view_as_real(complex64) twice those.  Offsets are
// 64-bit.
//
// K8 + K10 (precision="int8"), a kernel of its own (fused2d_i8_kernel,
// so K8's code is what it was): each axis's chain is radix-2/4/8 stages
// over n/f bits, then the f-point int8-split stage of int8_stage.cuh (f
// the last factor of the JAX package's default chain, `default_factors`,
// as `_fft2_fused` takes), in K8's frame: one cluster a plane, x first,
// the exchange through distributed shared memory, y second.  Its alignment
// groups are a block's rows in phase 1 and a block's columns in phase 2,
// each a subset of the JAX kernel's group, the whole plane.  The JAX
// kernel runs y first, then x; in float the order changes nothing, under
// int8 each stage quantises other data, so the kernel matches JAX's
// function within the int8 stage's error (held at 2e-6), not bit for bit.
// Both stages are int8_stage_tc, on wgmma (512 threads and f >= 32 at
// every shape): W's image copied into shared memory after the block's
// share of the plane by cp.async.bulk, x cut once into the share's place,
// the products from shared memory.  Phase 1's output has to stay in shared
// memory for the gather, and at 2^18 points a plane a block's share is
// 128 KB, so a second buffer does not fit: phase 1's stage holds its
// outputs in registers and writes them over x's channels, in the row
// layout the gather reads, after its last product (Map::INTO_X).  Phase
// 2's stage writes its outputs straight to device memory, two columns a
// store, postscale folded.  wx's image is copied from kernel entry on, so
// it lands while phase 1's radix stages run; where fy = fx phase 2 reuses
// it (at f = 128 the last slabs of phase 1 start the copies of phase 2's
// first), else wy's copy starts once every warpgroup is done with phase
// 1's products, across the cluster barrier and the gather.  At 2^18 points
// a plane a block holds 128 KB of the plane and W's buffers (two 48 KB
// slabs at f = 128: 224 KB in all), and its stages cut two 16-value runs
// a thread.  At ny = f the gather stage only gathers (radix 1); at nx = f
// phase 1 loads the rows first.
//
// Built by pyfft_tpu_torch/ops/build.py with nvcc for sm_90a into a shared
// library with the plain C entry points `pyfft_fused2d`, `pyfft_fused2d_i8`
// and the int8 kernel's records at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "int8_stage.cuh"

namespace {

using namespace pyfft;
namespace cg = cooperative_groups;

constexpr int NT = 512;       // threads a block

template <int LY, int LX>
struct Shape2 {
  static constexpr int NY = 1 << LY, NX = 1 << LX;
  static constexpr int G0 = NY * NX / 8192;
  static constexpr int G = G0 < 16 ? G0 : 16;   // blocks a cluster
  static constexpr int RB = NY / G;             // rows a block
  static constexpr int CB = NX / G;             // columns a block
  static constexpr int PB = NY * NX / G;        // points a block
  static_assert(G >= 2 && RB >= 1 && CB >= 1, "plane out of range");
  static_assert(PB * 8 <= 128 * 1024, "a block's share must fit");
};

// The first stage of the column chain, radix R: each thread reads its
// butterflies' inputs, the points (k, column c) for k = j + r*NY/R, from
// the shared memory of the block that holds row k, then every block waits
// at the cluster barrier before the stage's results overwrite its buffer
// in the [k][c] layout.  R = 1 only gathers (the int8 kernel at ny = f).
template <int LY, int LX, int R>
__device__ __forceinline__ void column_gather_stage(cg::cluster_group& cluster,
                                                    float2* sm, int rank,
                                                    float s) {
  using S = Shape2<LY, LX>;
  constexpr int N = S::NY, C = S::CB, NR = N / R;
  constexpr int B = NR * C / NT;
  static_assert(B * R * NT == N * C, "threads must tile the block exactly");
  float2 v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j + r * NR;
      const float2* src = cluster.map_shared_rank(sm, k / S::RB);
      v[b][r] = src[(k % S::RB) * S::NX + rank * C + c];
    }
    if constexpr (R > 1) dft<R>(v[b], s);
  }
  cluster.sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = threadIdx.x + b * NT;
    const int c = q % C, j = q / C;
#pragma unroll
    for (int r = 0; r < R; ++r) sm[(j * R + r) * C + c] = v[b][r];
  }
  __syncthreads();
}

template <int LY, int LX>
__global__ void __launch_bounds__(NT)
    fused2d_kernel(Planes2D io, const float2* __restrict__ twy,
                   const float2* __restrict__ twx, float s) {
  using S = Shape2<LY, LX>;
  constexpr int RB = S::RB, CB = S::CB;
  constexpr int RY = (LY % 3) ? (1 << (LY % 3)) : 8;   // first radix along y
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long l = blockIdx.x / S::G;

  const float* in_re = io.in_re + l * io.in_ls;
  const float* in_im = io.in_im + l * io.in_ls;
  float* out_re = io.out_re + l * io.out_ls;
  float* out_im = io.out_im + l * io.out_ls;
  const auto load_row = [&](int c, int k) {       // row rank*RB + c, x = k
    const long long o = (rank * RB + c) * io.in_ys + k * io.in_xs;
    return make_float2(in_re[o], in_im[o]);
  };
  const auto store_col = [&](int c, int k, float2 v) {   // y = k
    const long long o = k * io.out_ys + (rank * CB + c) * io.out_xs;
    out_re[o] = v.x * io.post;
    out_im[o] = v.y * io.post;
  };
  const auto none_load = [](int, int) { return make_float2(0.f, 0.f); };
  const auto none_store = [](int, int, float2) {};

  // phase 1: the block's rows, read along x, transformed along x
  chain<NT, LX, RB, true, 0, 1, true, false>(sm, twx, s, load_row,
                                            none_store);

  // every block's rows transformed before any block gathers a column
  cluster.sync();

  // phase 2: the block's columns, gathered from the cluster, transformed
  // along y and written along x
  column_gather_stage<LY, LX, RY>(cluster, sm, rank, s);
  chain<NT, LY, CB, false, 1, RY, false, true>(sm, twy, s, none_load,
                                              store_col);
}

template <int LY, int LX>
cudaError_t launch(const Planes2D& io, const float2* twy, const float2* twx,
                   float s, cudaStream_t stream) {
  using S = Shape2<LY, LX>;
  return launch_cluster<NT>(fused2d_kernel<LY, LX>, io.L, S::G,
                            S::PB * (int)sizeof(float2), stream, io, twy,
                            twx, s);
}

// ------------------------------------------------------ K8 + K10 (int8)

// The int8 kernel's plan at (log2 ny, log2 fy, log2 nx, log2 fx): each
// axis's wgmma stage and the shared memory, the block's share of the plane
// (HOST bytes) and W's buffers after it, the larger of the two stages'.
template <int LY, int LFY, int LX, int LFX>
struct I8Plan {
  using S = Shape2<LY, LX>;
  static constexpr int FY = 1 << LFY, FX = 1 << LFX;
  static constexpr int HOST = S::PB * (int)sizeof(float2);
  using PlanX = TcPlan<FX, NT, S::RB * (S::NX >> LFX), HOST, true>;
  using PlanY = TcPlan<FY, NT, S::CB * (S::NY >> LFY), HOST>;
  static constexpr bool TC = tc_stage(FX, NT) && tc_stage(FY, NT);
  static constexpr int SMEM = HOST + cmax(PlanX::W_BYTES, PlanY::W_BYTES);
  static_assert(TC, "both stages on wgmma");
  // 2^18 points a plane, f = 128: 128 KB of the plane and two 48 KB slabs
  static_assert(SMEM + 1024 <= 227 * 1024, "fits a block's shared memory");
};

// K8's function with the f-point int8 stage last on each axis (fy =
// 2^LFY, fx = 2^LFX); `wy`, `wx` the stages' tables, the (3, 2f, 2f) int8
// channels and then W's image (w_image_offset).
template <int LY, int LFY, int LX, int LFX>
__global__ void __launch_bounds__(NT)
    fused2d_i8_kernel(Planes2D io, const float2* __restrict__ twy,
                      const float2* __restrict__ twx, float s,
                      const int8_t* __restrict__ wy,
                      const int8_t* __restrict__ wx) {
  using S = Shape2<LY, LX>;
  using K = I8Plan<LY, LFY, LX, LFX>;
  constexpr int RB = S::RB, CB = S::CB, NX = S::NX, NY = S::NY;
  constexpr int LBY = LY - LFY;     // bits of y's radix stages
  constexpr int RY = LBY == 0 ? 1 : ((LBY % 3) ? (1 << (LBY % 3)) : 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[NT / 32];
  __shared__ uint64_t bars[W_BARS];
  float2* sm = reinterpret_cast<float2*>(smem_raw);
  const int8_t* wimx = wx + w_image_offset(K::FX);
  const int8_t* wimy = wy + w_image_offset(K::FY);
  WBufs w = tc_fetch_w<typename K::PlanX>(
      wimx, reinterpret_cast<int8_t*>(smem_raw + K::HOST), bars);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long l = blockIdx.x / S::G;

  const float* in_re = io.in_re + l * io.in_ls;
  const float* in_im = io.in_im + l * io.in_ls;
  float* out_re = io.out_re + l * io.out_ls;
  float* out_im = io.out_im + l * io.out_ls;
  const auto load_row = [&](int c, int k) {       // row rank*RB + c, x = k
    const long long o = (rank * RB + c) * io.in_ys + k * io.in_xs;
    return make_float2(in_re[o], in_im[o]);
  };
  // phase 1's outputs, row c at x = k, into the row layout the gather
  // reads: one 16-byte store where the two are neighbours
  const auto put_row = [&](int c0, int k0, int c1, int k1, float2 re,
                           float2 im) {
    const int s0 = c0 * NX + k0, s1 = c1 * NX + k1;
    if (s1 == s0 + 1 && (s0 & 1) == 0) {
      *reinterpret_cast<float4*>(sm + s0) =
          make_float4(re.x, im.x, re.y, im.y);
    } else {
      sm[s0] = make_float2(re.x, im.x);
      sm[s1] = make_float2(re.y, im.y);
    }
  };
  // phase 2's outputs, column c at y = k, to device memory, postscale
  // folded: 8-byte stores of each plane where the two are neighbours
  const auto put_col = [&](int c0, int k0, int c1, int k1, float2 re,
                           float2 im) {
    put_pair(out_re, out_im, k0 * io.out_ys + (rank * CB + c0) * io.out_xs,
             k1 * io.out_ys + (rank * CB + c1) * io.out_xs, re, im, io.post);
  };
  const auto none_load = [](int, int) { return make_float2(0.f, 0.f); };

  // phase 1: the block's rows, read along x, transformed along x, the int8
  // stage's outputs held until its last product, then over its input
  if constexpr (LX == LFX) {
    for (int e = threadIdx.x; e < S::PB; e += NT)
      sm[e] = load_row(e / NX, e % NX);
    __syncthreads();
  } else {
    lead<NT, LX, LFX, RB, true, 0, 1, true>(sm, twx, s, load_row);
  }
  using RowMap = ChainMap<NX, K::FX, RB, true, decltype(put_row), true>;
  int8_stage_tc<K::FX, NT, K::HOST, 64, true>(RowMap{put_row}, sm, twx, wimx,
                                              w, red, K::FX == K::FY);
  // every warpgroup is done with wx's image: wy's copy, where it differs,
  // lands across the cluster barrier, the gather and y's radix stages
  if constexpr (K::FX != K::FY) tc_issue_w<typename K::PlanY>(wimy, w);

  // every block's rows transformed before any block gathers a column
  cluster.sync();

  // phase 2: the block's columns, gathered from the cluster, transformed
  // along y, the int8 stage writing them along x
  column_gather_stage<LY, LX, RY>(cluster, sm, rank, s);
  lead<NT, LY, LFY, CB, false, 1, RY, false>(sm, twy, s, none_load);
  using ColMap = ChainMap<NY, K::FY, CB, false, decltype(put_col)>;
  int8_stage_tc<K::FY, NT, K::HOST, 64, true>(ColMap{put_col}, sm, twy, wimy,
                                              w, red);
}

// (log2 ny, log2 nx) -> launch<LY, LX>, for 7 <= each <= 11 and a sum of
// at most 18.
#define PYFFT_FUSED2D_CASES(X)                                        \
  X(7, 7) X(7, 8) X(7, 9) X(7, 10) X(7, 11) X(8, 7) X(8, 8) X(8, 9)   \
  X(8, 10) X(9, 7) X(9, 8) X(9, 9) X(10, 7) X(10, 8) X(11, 7)

cudaError_t dispatch(int ly, int lx, const Planes2D& io, const float2* twy,
                     const float2* twx, float s, cudaStream_t st) {
#define PYFFT_CASE(a, b) \
  if (ly == a && lx == b) return launch<a, b>(io, twy, twx, s, st);
  PYFFT_FUSED2D_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return cudaErrorInvalidValue;
}

// (log2 ny, log2 fy, log2 nx, log2 fx) of the int8 kernel: each of K8's
// shapes with f the last factor of default_factors on each axis.
#define PYFFT_FUSED2D_I8_CASES(X)                                          \
  X(7, 7, 7, 7) X(7, 7, 8, 6) X(7, 7, 9, 7) X(7, 7, 10, 6) X(7, 7, 11, 7)   \
  X(8, 6, 7, 7) X(8, 6, 8, 6) X(8, 6, 9, 7) X(8, 6, 10, 6) X(9, 7, 7, 7)    \
  X(9, 7, 8, 6) X(9, 7, 9, 7) X(10, 6, 7, 7) X(10, 6, 8, 6) X(11, 7, 7, 7)

cudaError_t dispatch_i8(int ly, int lfy, int lx, int lfx, const Planes2D& io,
                        const float2* twy, const float2* twx, float s,
                        const int8_t* wy, const int8_t* wx,
                        cudaStream_t st) {
#define PYFFT_CASE(a, fa, b, fb)                                        \
  if (ly == a && lfy == fa && lx == b && lfx == fb)                     \
    return launch_cluster<NT>(fused2d_i8_kernel<a, fa, b, fb>, io.L,    \
                              Shape2<a, b>::G, I8Plan<a, fa, b, fb>::SMEM, \
                              st, io, twy, twx, s, wy, wx);
  PYFFT_FUSED2D_I8_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return cudaErrorInvalidValue;
}

// The clusters of the int8 kernel at (log2 ny, log2 nx) that the card can
// hold at once (cudaOccupancyMaxActiveClusters), 0 where none places, a
// negative cudaError_t where the query fails, -1000 outside the range.
int i8_clusters(int ly, int lx) {
#define PYFFT_CASE(a, fa, b, fb)                                       \
  if (ly == a && lx == b)                                              \
    return max_clusters<NT>(fused2d_i8_kernel<a, fa, b, fb>,           \
                            Shape2<a, b>::G, I8Plan<a, fa, b, fb>::SMEM);
  PYFFT_FUSED2D_I8_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return -1000;
}

}  // namespace

// The stage the int8 kernel runs at (log2 ny, log2 nx): 1 the wgmma stage
// on both axes, 0 the mma.sync one, -1 where no int8 kernel is
// instantiated.
extern "C" int pyfft_fused2d_i8_stage(int log2ny, int log2nx) {
#define PYFFT_CASE(a, fa, b, fb) \
  if (log2ny == a && log2nx == b) return I8Plan<a, fa, b, fb>::TC ? 1 : 0;
  PYFFT_FUSED2D_I8_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return -1;
}

// Its clusters that fit the card at once (see i8_clusters): at least 1
// wherever a 16-block cluster of 224 KB blocks places.
extern "C" int pyfft_fused2d_i8_clusters(int log2ny, int log2nx) {
  return i8_clusters(log2ny, log2nx);
}

// The cluster size (blocks a plane) at (log2 ny, log2 nx), 0 outside the
// kernel's range: for the wrapper's checks and the records.
extern "C" int pyfft_fused2d_cluster(int log2ny, int log2nx) {
#define PYFFT_CASE(a, b) \
  if (log2ny == a && log2nx == b) return Shape2<a, b>::G;
  PYFFT_FUSED2D_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return 0;
}

// Launches the 2D DFT on `stream` without synchronising.  `twy` and `twx`
// hold ny and nx (cos, sin) float pairs of sign*2*pi*k/n.  `dims` holds 7
// int64 values: L, the input strides (l, y, x) and the output strides
// (l, y, x), in floats.  Returns the launch's cudaError_t (0 on success).
extern "C" int pyfft_fused2d(const void* in_re, const void* in_im,
                             void* out_re, void* out_im, const void* twy,
                             const void* twx, const long long* dims,
                             int log2ny, int log2nx, int sign,
                             float postscale, void* stream) {
  const Planes2D io = planes_2d(in_re, in_im, out_re, out_im, dims, postscale);
  if (io.L <= 0) return (int)cudaErrorInvalidValue;
  const float s = sign < 0 ? -1.f : 1.f;
  return (int)dispatch(log2ny, log2nx, io, static_cast<const float2*>(twy),
                       static_cast<const float2*>(twx), s,
                       static_cast<cudaStream_t>(stream));
}

// K8 + K10: as pyfft_fused2d with the f-point int8 stage last on each axis,
// fy = 2^log2fy and fx = 2^log2fx (see PYFFT_FUSED2D_I8_CASES); `wchy` and
// `wchx` hold the stages' channels, (3, 2f, 2f) int8 C-contiguous each,
// followed by their shared-memory image (ops/int8.py `w_tables`).
extern "C" int pyfft_fused2d_i8(const void* in_re, const void* in_im,
                                void* out_re, void* out_im, const void* twy,
                                const void* twx, const void* wchy,
                                const void* wchx, const long long* dims,
                                int log2ny, int log2fy, int log2nx,
                                int log2fx, int sign, float postscale,
                                void* stream) {
  const Planes2D io = planes_2d(in_re, in_im, out_re, out_im, dims, postscale);
  if (io.L <= 0) return (int)cudaErrorInvalidValue;
  const float s = sign < 0 ? -1.f : 1.f;
  return (int)dispatch_i8(log2ny, log2fy, log2nx, log2fx, io,
                          static_cast<const float2*>(twy),
                          static_cast<const float2*>(twx), s,
                          static_cast<const int8_t*>(wchy),
                          static_cast<const int8_t*>(wchx),
                          static_cast<cudaStream_t>(stream));
}
