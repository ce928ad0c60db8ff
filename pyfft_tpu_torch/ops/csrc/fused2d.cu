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
// What bounds it on an H100: bytes, 16 a point (each point read once and
// written once), 0.0801 ms at 2^24 points at the published 3.35 TB/s.  Two
// designs, chosen in the C entry by the table at dispatch_design: the
// plane ring below (fused2d_ring_kernel: a persistent grid of clusters, the
// next plane's share copied in by TMA while the current one computes,
// chain.cuh's padded radix-16 chains, the exchange as one bulk copy a run
// into the owning block's shared memory) for the planes of up to 2^17
// points of its table, on inputs a tensor map reads, and the first design
// everywhere else:
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
// library with the plain C entry points `pyfft_fused2d`, `pyfft_fused2d_i8`,
// the ring's records (`pyfft_fused2d_clusters`, `pyfft_fused2d_ring_shape`)
// and the int8 kernel's records at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chain.cuh"
#include "int8_stage.cuh"
#include "ring_cols.cuh"   // tensor_map_4d, tma_load_4d, mbar_expect, ...

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

// ----------------------------------------------------- K8: the plane ring
//
// K8's design for the H100 (fused2d_ring_kernel), at the shapes of
// PYFFT_FUSED2D_RING on inputs a tensor map reads; the first design above
// runs everywhere else (pyfft_fused2d's dispatch, below).  A cluster of G
// blocks takes a plane, block b a share of RB rows and then of CB columns,
// as in the first design, but the clusters stay and the shares are smaller:
//
//   * a share of 4096 points (256 threads, two blocks an SM) wherever a
//     cluster of at most 16 blocks covers the plane, so up to 2^16 points;
//     8192 at 2^17 (512 threads, one block an SM).  More blocks an SM hid
//     more of each one's barriers and chains than a deeper ring did
//     (PERF.md section 6: probes/float_split.py K8);
//   * a persistent grid of one wave of clusters (the clusters the card
//     holds at once, cudaOccupancyMaxActiveClusters, asked once a device);
//     cluster q walks the planes q, q + clusters, ...;
//   * a ring of SLOTS slots a block, one mbarrier a slot: thread 0 copies
//     the block's share of a plane (RB rows of each plane, or of the
//     complex form's (re, im) pairs) into a slot with one 4D tensor-map box
//     (TMA) a plane, x split into runs of at most 256 so that the box lands
//     as [RB][NX], and refills the slot with the plane SLOTS on once the
//     slot's last reader is past its barrier, so the next plane's share is
//     in flight while this one computes;
//   * phase 1: chain.cuh's chain along x over the slot's RB rows, radix 16
//     where it takes a stage fewer than radix 8 (R16), the padded rows of
//     chain_index (PAD), five twiddle reads of fifteen a radix-16
//     butterfly (TWD); its first stage reads the slot's raw rows and, after
//     a barrier, writes the padded layout into the same slot;
//   * the exchange in whole runs: the last stage of phase 1 writes its
//     outputs into the block's `sent` buffer, by owner (the RB x CB run of
//     each block that owns their columns), and thread 0 hands each run to
//     the copy engine (cp.async.bulk between shared memories) into the
//     owner's slot, at the rows of this block, completing on the owner's
//     mbarrier `landed`; each block waits there for its G runs, so every
//     slot ends up [y][c] over its CB columns.  Before those writes one
//     cluster barrier holds every block until all have read their slots and
//     passed their last plane's `landed` wait (so `sent` is free); its
//     arrive is relaxed, because a release arrive waits for the thread's
//     stores to device memory, 0.04 ms at config 4 (probes/float_split.py
//     k8rel).  A relaxed arrive orders no memory operation: the PTX memory
//     model does not order this block's reads of its slot before the
//     peers' bulk copies into it, nor the copies out of `sent` before the
//     next plane's writes there.  The kernel relies on those reads having
//     retired: their values are in registers, consumed before the stage's
//     __syncthreads that precedes the arrive, and the bulk reads of `sent`
//     completed on the owners' `landed` waits, which every block has
//     passed before it arrives.  That holds on the H100; the memory model
//     does not promise it (k8rel builds the release arrive).  The first
//     design gathered the columns value by value with remote loads between
//     two barriers;
//   * phase 2: the chain along y over the block's CB columns in the slot's
//     [y][c] layout (R16, TWD), its last stage storing from registers with
//     threads along x, postscale folded (two floats, or on the complex
//     form's planes in and out, (re, im) pairs as one 8-byte store each:
//     the layouts are template parameters).
//
// Shared memory: SLOTS = 2 slots of the padded share and `sent`, 100 KB a
// block of 4096 points, 200 KB of 8192.  At 2^18 points a plane a share is
// 16384 points: two slots do not fit, so those five shapes keep the first
// design.  In place: a plane is stored only after every block of its
// cluster has copied its share in (the exchange's barrier comes between),
// and no two clusters share a plane.

// (log2 ny, log2 nx): the shapes the ring takes, every plane of at most
// 2^17 points but 256 x 512, where the H100 ran the first design faster
// (0.2114 against the ring's 0.2438 ms over 2^24 points, planar;
// probes/ab_parent.py, PERF.md section 6).  The five shapes of 2^18 points
// run the first design.
#define PYFFT_FUSED2D_RING(X)                                         \
  X(7, 7) X(7, 8) X(7, 9) X(7, 10) X(8, 7) X(8, 8) X(9, 7) X(9, 8)    \
  X(10, 7)
// points a block's share holds where the plane allows (a cluster of at
// most 16 blocks): 4096, 256 threads and two 100 KB blocks an SM; at 2^17
// points a plane 8192, 512 threads and one 200 KB block.  Slots a block;
// the chains' options (chain.cuh), radix 16 where it takes a stage fewer
// than radix 8; the most points a box takes along one axis
constexpr int RING2_SHARE = 4096;
constexpr int RING2_SLOTS = 2;
// points a thread takes a stage (16: radix-16 stages; 8: radix 8 and twice
// the threads, slower on the H100: probes/float_split.py k8t8)
constexpr int RING2_THREAD_POINTS = 16;
constexpr bool RING2_PAD = true, RING2_TWD = true, RING2_R16 = true;
constexpr int RING2_BOX = 256;

// What pyfft_fused2d returns where the ring ran: 0 where the first design
// ran, else the launch's cudaError_t.  The wrapper counts the ring's
// launches from it.
constexpr int RAN_RING = -1;

template <int LY, int LX>
struct Ring2 {
  static constexpr int NY = 1 << LY, NX = 1 << LX, SLOTS = RING2_SLOTS;
  static constexpr int PB = NY * NX / 16 > RING2_SHARE ? NY * NX / 16
                                                       : RING2_SHARE;
  static constexpr int G = NY * NX / PB;        // blocks a cluster
  static constexpr int RB = NY / G, CB = NX / G;  // rows, columns a block
  static constexpr int NT = PB / RING2_THREAD_POINTS;   // threads a block
  static constexpr int BX = NX < RING2_BOX ? NX : RING2_BOX;  // a box's run
  static constexpr bool R16 = RING2_R16 && RING2_THREAD_POINTS == 16;
  static constexpr bool R16X = R16 && (LX + 3) / 4 < (LX + 2) / 3;
  static constexpr bool R16Y = R16 && (LY + 3) / 4 < (LY + 2) / 3;
  // a slot: the raw share, the padded rows or the columns, rounded to 128
  // bytes (the box copies' alignment), in values
  static constexpr int PADDED = RING2_PAD ? RB * (NX + NX / 16) : PB;
  static constexpr int SLOT = ((PADDED > PB ? PADDED : PB) * 8 + 127) / 128 *
                              128 / 8;
  // the slots, then phase 1's outputs (PB values) + alignment
  static constexpr int SMEM = (SLOTS * SLOT + PB) * 8 + 128;
  // the blocks an SM's shared memory (228 KB, 1 KB a block reserved) and
  // threads allow: the registers are held to that many (launch bounds)
  static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);
  static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM : 2048 / NT;
  static_assert(G >= 2 && G <= 16 && NT % 32 == 0, "a cluster of 2 to 16");
  static_assert(SLOTS >= 2 && SMEM <= 227 * 1024 && PER >= 1,
                "the ring fits a block's shared memory");
  static_assert(RB <= RING2_BOX && NX / BX <= RING2_BOX, "one box a plane");
  static_assert(PB * 8 < (1 << 20), "an mbarrier's byte count");
};

// The radices of chain.cuh's chain over 2^LOGN points: a radix-2, 4 (or 8)
// head where LOGN is not a multiple of log2 of the main radix, then radix 8
// (16 with R16).
template <int LOGN, bool R16>
struct ChainPlan {
  static constexpr int RB = R16 ? 4 : 3, REM = LOGN % RB;
  static constexpr int NSTAGES = LOGN / RB + (REM ? 1 : 0);
  static constexpr int R_LAST = 1 << RB;     // the head is stage 0
  static constexpr int NS_LAST = (1 << LOGN) / R_LAST;
  static_assert(NSTAGES >= 2, "a head and a last stage");
};

// Every stage but the last of the chain over C padded rows of 2^LOGN
// points (ROWS, PAD, TWD), from stage STAGE on: stage 0 reads load(c, k)
// and takes a barrier before it writes the buffer (SYNC0: `load` reads the
// slot it writes); every result stays in the buffer.
template <int NT_, int LOGN, int C, bool R16, int STAGE = 0, int NS = 1,
          class Load>
__device__ __forceinline__ void rows_head(float2* sm,
                                          const float2* __restrict__ tw,
                                          float s, const Load& load) {
  using P = ChainPlan<LOGN, R16>;
  if constexpr (STAGE + 1 < P::NSTAGES) {
    constexpr int R = (STAGE == 0 && P::REM) ? (1 << P::REM) : (1 << P::RB);
    const auto none = [](int, int, float2) {};
    stage<NT_, 1 << LOGN, C, true, R, NS, STAGE == 0, false, RING2_PAD,
          RING2_TWD, STAGE == 0>(sm, tw, s, load, none);
    rows_head<NT_, LOGN, C, R16, STAGE + 1, NS * R>(sm, tw, s, load);
  }
}

// The ring over io.L planes: plane first + i*every in slot i % SLOTS on
// barrier bars[i % SLOTS], filled by thread 0 (map_re: the real plane, or
// the pairs where PIN; map_im the imaginary plane).  POUT (with PIN
// only): the output planes are (re, im) pairs, stored as float2.
template <int LY, int LX, bool PIN, bool POUT>
__global__ void __launch_bounds__(Ring2<LY, LX>::NT, Ring2<LY, LX>::PER)
    fused2d_ring_kernel(Planes2D io, const float2* __restrict__ twy,
                        const float2* __restrict__ twx, float s,
                        const __grid_constant__ CUtensorMap map_re,
                        const __grid_constant__ CUtensorMap map_im) {
  using K = Ring2<LY, LX>;
  static_assert(PIN || !POUT, "pairs out only from pairs in");
  constexpr int NX = K::NX, RB = K::RB, CB = K::CB, PB = K::PB, NT = K::NT;
  constexpr int SLOTS = K::SLOTS, SLOT = K::SLOT;
  using PX = ChainPlan<LX, K::R16X>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[SLOTS];
  __shared__ uint64_t landed;       // the exchange into this block, a plane
  float2* slots = align128(smem_raw);
  float2* sent = slots + SLOTS * SLOT;   // phase 1's outputs, [owner][c][x]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long first = blockIdx.x / K::G, every = gridDim.x / K::G;
  const int count =
      first < io.L ? static_cast<int>((io.L - first + every - 1) / every)
                   : 0;
  // this block's share of plane i into slot i % SLOTS: one box of each
  // plane, or of the pairs
  const auto issue = [&](int i) {
    uint64_t* bar = &bars[i % SLOTS];
    float* dst = reinterpret_cast<float*>(slots + (i % SLOTS) * SLOT);
    const int l = static_cast<int>(first + (long long)i * every);
    fence_async_smem();
    mbar_expect(bar, PB * (int)sizeof(float2));
    tma_load_4d(dst, &map_re, 0, 0, rank * RB, l, bar);
    if (!PIN) tma_load_4d(dst + PB, &map_im, 0, 0, rank * RB, l, bar);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < SLOTS; ++b) mbar_init(&bars[b]);
    mbar_init(&landed);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < SLOTS && j < count; ++j) issue(j);
  }
  cluster_arrive();                 // every block's barriers are set up
  cluster_wait();
  for (int i = 0; i < count; ++i) {
    const long long l = first + (long long)i * every;
    float2* sm = slots + (i % SLOTS) * SLOT;
    const float* f = reinterpret_cast<const float*>(sm);
    float* out_re = io.out_re + l * io.out_ls;
    float* out_im = io.out_im + l * io.out_ls;
    const auto load = [&](int c, int k) {        // row c of the share, x = k
      if constexpr (PIN) return sm[c * NX + k];
      else return make_float2(f[c * NX + k], f[PB + c * NX + k]);
    };
    // phase 1's outputs, row c at x = k, by the block that owns column x:
    // the run of RB rows x CB columns each owner takes, [c][x % CB]
    const auto put = [&](int c, int k, float2 v) {
      sent[(k / CB) * (RB * CB) + c * CB + k % CB] = v;
    };
    // between the last row stage's reads and its writes: every block of
    // the cluster is done reading its slot and past its last plane's wait
    // for the copies into it, so `sent` is free too.  The arrive is
    // relaxed: it relies on those reads having retired (their values are
    // in registers, used before the stage's __syncthreads), not on the
    // memory model, which orders nothing across a relaxed arrive
    const auto all_read = [] {
      if (threadIdx.x == 0) fence_async_smem();
      cluster_arrive_relaxed();
      cluster_wait();
    };
    const auto none_load = [](int, int) { return make_float2(0.f, 0.f); };
    // phase 2's outputs, column c at y = k, postscale folded
    const auto store = [&](int c, int k, float2 v) {
      const long long o = k * io.out_ys + (rank * CB + c) * io.out_xs;
      const float2 y = make_float2(v.x * io.post, v.y * io.post);
      if constexpr (POUT) {
        *reinterpret_cast<float2*>(out_re + o) = y;
      } else {
        out_re[o] = y.x;
        out_im[o] = y.y;
      }
    };
    mbar_wait(&bars[i % SLOTS], (i / SLOTS) & 1);
    // phase 1: the share's rows along x, the last stage's outputs by owner
    rows_head<NT, LX, RB, K::R16X>(sm, fresh(twx), s, load);
    stage<NT, NX, RB, true, PX::R_LAST, PX::NS_LAST, false, true, RING2_PAD,
          RING2_TWD>(sm, fresh(twx), s, load, put, all_read);
    __syncthreads();
    // the exchange: one copy to each owner's slot, at the rows of this
    // block, [y][c]; this block's slot takes one from each
    if (threadIdx.x == 0) {
      fence_async_smem();
      mbar_expect(&landed, PB * (int)sizeof(float2));
      for (int o = 0; o < K::G; ++o)
        bulk_to_block(sm + rank * RB * CB, sent + o * RB * CB,
                      RB * CB * (int)sizeof(float2), &landed, o);
    }
    mbar_wait(&landed, i & 1);
    // phase 2: the block's columns along y in the slot, stored along x
    chain<NT, LY, CB, false, 0, 1, false, true, false, RING2_TWD, K::R16Y>(
        sm, fresh(twy), s, none_load, store);
    // the slot's readers are past its last barrier: refill it
    if (threadIdx.x == 0 && i + SLOTS < count) issue(i + SLOTS);
  }
  cluster_arrive();                 // every copy out of this block landed
  cluster_wait();
}

// Whether the ring's tensor maps read the input where it lies (the rule
// of local._boxable): planar planes (x stride 1) or the complex form's
// stride-2 planes (the imaginary plane one float after the real one),
// 16-byte aligned, the y stride (and, for L > 1, the l stride) a multiple
// of 4 floats; `pairs` says which.
inline bool ring2_operands(const Planes2D& io, bool& pairs) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(io.in_re);
  const uintptr_t b = reinterpret_cast<uintptr_t>(io.in_im);
  const bool planar = io.in_xs == 1 && b % 16 == 0;
  pairs = io.in_xs == 2 && io.in_im == io.in_re + 1;
  return (planar || pairs) && a % 16 == 0 && io.in_ys % 4 == 0 &&
         (io.L == 1 || io.in_ls % 4 == 0);
}

// The clusters of the ring at (LY, LX) the card holds at once, asked once
// a device (max_clusters sets the kernel's shared memory there).
template <int LY, int LX, bool PIN = false, bool POUT = false>
cudaError_t ring2_held(int& held) {
  using K = Ring2<LY, LX>;
  static std::atomic<int> got[64];           // by device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int h = got[dev].load(std::memory_order_relaxed);
  if (!h) {
    h = max_clusters<K::NT>(fused2d_ring_kernel<LY, LX, PIN, POUT>, K::G,
                            K::SMEM);
    if (h < 0) return static_cast<cudaError_t>(-h);
    if (h == 0) return cudaErrorInvalidConfiguration;
    got[dev].store(h, std::memory_order_relaxed);
  }
  held = h;
  return cudaSuccess;
}

// The ring's tensor map over one input plane (or the pairs) at `base`:
// (x in runs of BX, the runs, y, l), boxes of [1][RB][NX / BX][BX].
template <int LY, int LX>
cudaError_t ring2_map(CUtensorMap* map, const float* base, bool pairs,
                      const Planes2D& io) {
  using K = Ring2<LY, LX>;
  const long long e = pairs ? 8 : 4;                  // bytes an element
  const long long ys = io.in_ys * 4;
  const long long ls = io.L > 1 ? io.in_ls * 4 : K::NY * ys;
  const cuuint64_t dims[4] = {(cuuint64_t)K::BX, (cuuint64_t)(K::NX / K::BX),
                              (cuuint64_t)K::NY, (cuuint64_t)io.L};
  const cuuint64_t strides[3] = {(cuuint64_t)(K::BX * e), (cuuint64_t)ys,
                                 (cuuint64_t)ls};
  const cuuint32_t box[4] = {(cuuint32_t)K::BX, (cuuint32_t)(K::NX / K::BX),
                             (cuuint32_t)K::RB, 1};
  return tensor_map_4d(map, base, pairs, dims, strides, box);
}

template <int LY, int LX, bool PIN, bool POUT>
cudaError_t launch_ring(const Planes2D& io, const float2* twy,
                        const float2* twx, float s, cudaStream_t stream) {
  using K = Ring2<LY, LX>;
  int held = 0;
  cudaError_t e = ring2_held<LY, LX, PIN, POUT>(held);
  if (e != cudaSuccess) return e;
  CUtensorMap mre{}, mim{};
  e = ring2_map<LY, LX>(&mre, io.in_re, PIN, io);
  if (e == cudaSuccess && !PIN)
    e = ring2_map<LY, LX>(&mim, io.in_im, false, io);
  if (e != cudaSuccess) return e;
  const long long clusters = io.L < held ? io.L : held;
  return launch_cluster<K::NT>(fused2d_ring_kernel<LY, LX, PIN, POUT>,
                               clusters, K::G, K::SMEM, stream, io, twy, twx,
                               s, mre, mim);
}

// The ring at (LY, LX) on the input's layout (planes or pairs).  Where the
// input is pairs and so is the output (the imaginary plane one float after
// the real one, 8-byte aligned at every point), each output is one 8-byte
// store: 0.1192 against 0.1232 ms at config 4's stride-2 planes
// (probes/float_split.py k8pout0, PERF.md section 6).  Every other output,
// a planar input's included, is stored as two floats.
template <int LY, int LX>
cudaError_t launch_ring(const Planes2D& io, bool pairs, const float2* twy,
                        const float2* twx, float s, cudaStream_t stream) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(io.out_re);
  const bool pout = pairs && io.out_xs == 2 && io.out_im == io.out_re + 1 &&
                    o % 8 == 0 && io.out_ys % 2 == 0 &&
                    (io.L == 1 || io.out_ls % 2 == 0);
  if (pout) return launch_ring<LY, LX, true, true>(io, twy, twx, s, stream);
  if (pairs) return launch_ring<LY, LX, true, false>(io, twy, twx, s, stream);
  return launch_ring<LY, LX, false, false>(io, twy, twx, s, stream);
}

// Whether the ring takes (log2 ny, log2 nx) (PYFFT_FUSED2D_RING).
inline bool ring2_takes(int ly, int lx) {
#define PYFFT_CASE(a, b) \
  if (ly == a && lx == b) return true;
  PYFFT_FUSED2D_RING(PYFFT_CASE)
#undef PYFFT_CASE
  return false;
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

// Which design runs where (pyfft_fused2d):
//
//   plane (ny, nx)             input                      design
//   at most 2^17 points, not   planar or pairs, 16-byte   the ring
//   256 x 512                  aligned, y and l strides   (RAN_RING)
//   (PYFFT_FUSED2D_RING)       multiples of 4 floats
//   the same                   any other layout           the first (0)
//   256 x 512; 2^18 points     any                        the first (0)
//
// The ring where it takes the shape and the input (RAN_RING), else the
// first design (0), or a launch's cudaError_t.
int dispatch_design(int ly, int lx, const Planes2D& io, const float2* twy,
                    const float2* twx, float s, cudaStream_t st) {
  bool pairs = false;
  if (ring2_takes(ly, lx) && ring2_operands(io, pairs)) {
#define PYFFT_CASE(a, b)                                                \
  if (ly == a && lx == b) {                                             \
    const cudaError_t e = launch_ring<a, b>(io, pairs, twy, twx, s, st); \
    return e == cudaSuccess ? RAN_RING : (int)e;                        \
  }
    PYFFT_FUSED2D_RING(PYFFT_CASE)
#undef PYFFT_CASE
  }
  return (int)dispatch(ly, lx, io, twy, twx, s, st);
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

// K8's clusters at (log2 ny, log2 nx) that the card holds at once
// (cudaOccupancyMaxActiveClusters): the ring's (`ring` 1) or the first
// design's (`ring` 0); 0 where none places, a negative cudaError_t where
// the query fails, -1000 where that design does not take the shape.
int ring_clusters(int log2ny, int log2nx, int ring) {
  if (ring) {
#define PYFFT_CASE(a, b)                                                \
  if (log2ny == a && log2nx == b)                                      \
    return max_clusters<Ring2<a, b>::NT>(                             \
        fused2d_ring_kernel<a, b, false, false>, Ring2<a, b>::G,      \
        Ring2<a, b>::SMEM);
    PYFFT_FUSED2D_RING(PYFFT_CASE)
#undef PYFFT_CASE
    return -1000;
  }
#define PYFFT_CASE(a, b)                                                 \
  if (log2ny == a && log2nx == b)                                       \
    return max_clusters<NT>(fused2d_kernel<a, b>, Shape2<a, b>::G,      \
                            Shape2<a, b>::PB * (int)sizeof(float2));
  PYFFT_FUSED2D_CASES(PYFFT_CASE)
#undef PYFFT_CASE
  return -1000;
}

// The ring's shape at (log2 ny, log2 nx) into out[0..7]: blocks a cluster,
// rows and columns a block, threads a block, slots, shared memory a block
// in bytes, the clusters the card holds at once and the planes' x runs a
// box takes (BX).
// Returns 1, 0 where the shape runs the first design (out untouched), or a
// negative cudaError_t where the card's query fails.
int ring_shape(int log2ny, int log2nx, long long* out) {
#define PYFFT_CASE(a, b)                                                 \
  if (log2ny == a && log2nx == b) {                                     \
    using K = Ring2<a, b>;                                              \
    int held = 0;                                                       \
    const cudaError_t e = ring2_held<a, b>(held);                       \
    if (e != cudaSuccess) return -(int)e;                               \
    const long long v[8] = {K::G,     K::RB,   K::CB, K::NT,            \
                            K::SLOTS, K::SMEM, held,  K::BX};           \
    for (int i = 0; i < 8; ++i) out[i] = v[i];                          \
    return 1;                                                           \
  }
  PYFFT_FUSED2D_RING(PYFFT_CASE)
#undef PYFFT_CASE
  return 0;
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

// K8's clusters that the card holds at once (see ring_clusters): the
// ring's (`ring` 1) or the first design's (`ring` 0).
extern "C" int pyfft_fused2d_clusters(int log2ny, int log2nx, int ring) {
  return ring_clusters(log2ny, log2nx, ring);
}

// The ring's shape at (log2 ny, log2 nx) (see ring_shape): 1, 0 where the
// shape runs the first design, or a negative cudaError_t.
extern "C" int pyfft_fused2d_ring_shape(int log2ny, int log2nx,
                                        long long* out) {
  return ring_shape(log2ny, log2nx, out);
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
// (l, y, x), in floats.  Returns RAN_RING (-1) where the ring ran, 0 where
// the first design ran (dispatch_design's table), else the launch's
// cudaError_t.
extern "C" int pyfft_fused2d(const void* in_re, const void* in_im,
                             void* out_re, void* out_im, const void* twy,
                             const void* twx, const long long* dims,
                             int log2ny, int log2nx, int sign,
                             float postscale, void* stream) {
  const Planes2D io = planes_2d(in_re, in_im, out_re, out_im, dims, postscale);
  if (io.L <= 0) return (int)cudaErrorInvalidValue;
  const float s = sign < 0 ? -1.f : 1.f;
  return dispatch_design(log2ny, log2nx, io, static_cast<const float2*>(twy),
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
