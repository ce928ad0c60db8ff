"""Where the time of the complex128 cluster column kernel (K12 from n =
1024, and its persistent cluster ring at n = 2048), the tiled 2D kernel
(K9), the multi-tile column kernel (K6), the
digit-swapped row kernel (K4), the complex64 row kernels (K1, K2), the
complex64 column kernel (K5) and the complex128 row kernel (K11) goes:
pieces removed and shape knobs changed, one build each, on one CUDA card.

    python3 probes/float_split.py [K12] [K9] [K6] [K4] [K1] [K2] [K5] [K11]
                                  [P5] [K8] [--only VARIANT,...]
                                  [--cases TEXT,...] [--queued]

(the kernels named, all by default; P5 is K5's ring without a load in
flight, the counterpart of the JAX probe ``_fft_cols_stream``; ``--only``
builds and times the variants named beside ``full``, not all; ``--cases``
times only the cases whose name holds one of the texts; ``--queued`` times
each by ``time_queued_ms``, the host held ahead of the device, in place of
``time_ms``, which reads the host's time wherever a call's launch takes
longer than its kernel).  Builds,
from copies of this checkout's ``csrc/`` patched in a temporary directory
(the checkout is not touched), ``local_cols.cu`` (K12, K6, K4, K5, P5),
``fused2d_tiled.cu`` (K9), ``local_rows.cu`` (K1, K2, K11) and
``fused2d.cu`` (K8) in these variants, one nvcc each, eight at a time:

  full      the sources as they are (with ``-Xptxas -v``: the new
            kernels' registers and spills are printed)
  notw      no twiddle multiplies (the chains', the exchange's w_n^(b*k')
            and K12's table in the store pass; in K12's and K5's cluster
            rings too)
  copy      nor the DFTs' arithmetic, nor K12's chain, and every exchange
            reads its own block's buffer instead of DSMEM: K12 is its
            loads, one shared-memory pass and its stores (the ring: its
            box copies, the first stage's pass over the slot, the chunks
            copied to the block's own receive buffer, its stores); K9
            keeps its stages' shared-memory shuffles
  xold      K12's x tile at every pass (the ring's table PYFFT_XRING_F64
            emptied: the design before the ring), P4's counterpart;
            xoldnotw and xoldcopy as notw and copy on it
  xrarith   K12's ring (and K5's on the complex form's pairs) without
            twiddles nor DFT arithmetic, its chain and its chunks' copies
            kept: their time
  xrlocal   xrarith with every chunk copied to the block's own receive
            buffer (no DSMEM): the copies' cost across the cluster
  xr8       K12's ring at n = 2048 on a cluster of 8 blocks, one an SM
            (66 KB slots; 16 blocks, two an SM, by default)
  xrtw      K12's ring reading its chain's and exchange's twiddles from
            the kernel's table every tile (four of seven, five of fifteen
            and their products), not from its block's shared-memory table
  g4        K12's first design, (G, C) = (2, 16), (4, 16), (8, 16) at n =
            1024, 2048, 4096 on every layout, 128 KB blocks, one an SM
  m1        K12's (G, C) with registers for one block an SM
  s2c16     K12 on stride-2 planes with the planar table (C = 16)
  r8        K9's chains on radix 8 (a shared-memory round trip more)
  twd0      K9's chains reading every twiddle of a butterfly (fifteen
            at radix 16)
  pad0      K9's phase 1 without chain_index's padding
  nohint    K9 without its L2 policies (evict_normal)
  p5, p7,   K9's planes in flight fixed at 5, 7 (the clusters the card
  p16       holds) or 16 (a grid of one cluster a plane)
  pct50     K9's planes cap at half the L2 (3 planes of 2^20 points)
  run32     K9's phase 2 in runs of 32 floats (128 bytes), y split over
            groups of 2 to 8 blocks from ny = 512
  k46notw   K6 and K4 without twiddle multiplies (the chains', the
            exchange's and K6's `full` table in its stores)
  k46copy   nor the DFTs' arithmetic, nor K6's chain, nor K4's but one
            stage, and every exchange reads its own block's shared memory
            instead of DSMEM: K6 is its ring of box copies and its stores,
            K4 its box copy, its exchange's shared-memory passes and its
            stores
  k46local  K6's and K4's exchanges read their own block, not DSMEM
  s2        K6's ring of 2 slots (3 by default)
  grp1,     K6's blocks a step where they take whole runs fixed at 1 or 4
  grp4      (by default as many as fill one wave)
  x8        K6 at n = 2048 on a cluster of 8 blocks (64 KB slots, one
            block an SM; 16 blocks of 32 KB slots by default)
  runs1024  K6 at n = 1024 in whole runs of 8 columns (a cluster of 4
            blocks a tile of 32 by default)
  x512      K6 at n = 512 on a cluster of 2 blocks a tile of 32 columns
            (whole runs of 16 by default)
  r16       K4's tiles of 16 rows at n = 1024 and 2048 (64-byte runs)
  k4old     K4's first design at every n (the column kernel's row policy,
            one block of C rows, at n = 512 too)
  k4r8      K4's 256-point chains on radix 4, 8, 8 (two radix-16 stages)
  k4t512    K4's blocks of 512 threads, two an SM (256, three)
  old       K1's and K2's first design at every n (local_rows_kernel, the
            kernel they ran before the row ring: the ring's table
            PYFFT_ROWS_RING empty)
  oldnotw   the first design without twiddle multiplies
  oldcopy   the first design as its first stage's loads and its last
            stage's stores (one stage, no DFT arithmetic, no chain): P1's
            counterpart, the floor under it
  rnotw     the row ring without twiddle multiplies
  rcopy     the ring's copies, one pass reading the slot and the stores
            (no chain)
  rr8       the ring's chains on radix 8 (R16 off; on, radix 16 where it
            takes a stage fewer, not at n = 8 and 512)
  rpad0     the ring's chains without chain_index's padding
  rtwd0     the ring's chains reading every twiddle of a butterfly
  rall      the ring at every n, slots of 4096 points (the source's table
            leaves n = 128 to 512 to the first design)
  rs2       the ring of 2 slots at every n (3 by default, 2 at n = 8192)
  rs3       the ring of 3 slots at every n
  r8k       slots of 8192 points at every n (one block of 512 threads an
            SM; 4096 points, 256 threads, by default from n = 1024)
  r2k       slots of 2048 points from n = 16 (128 threads, four blocks an
            SM; 4096 and 8192 stay one row)
  rbulk     the ring's last stage writing the slot and a bulk copy a row
            out from n = 1024 (cp.async.bulk, shared to global; thread 0
            waits for the copies' reads before it refills the slot), not
            stores from registers: the alternative the chip showed slower,
            kept here as a patch and not in the source
  c5old     K5's first design at every n (local_cols_kernel: the
            persistent ring's table PYFFT_COLS_PRING, the float cluster
            tables and the float cluster ring's emptied), P2's counterpart
  c5xold    K5's cluster tile on the complex form's pairs at n = 1024 (the
            float cluster ring's table PYFFT_XRING_F32_S2 emptied: the
            design before the ring); c5xoldnotw and c5xoldcopy as notw and
            copy on it
  c5xr8     K5's cluster ring at n = 1024 on a cluster of 8 blocks, 3
            slots, three blocks an SM (4 blocks, 4 slots, one an SM by
            default); c5xr8s2 the same with 2 slots, four blocks an SM
  c5xrs2    K5's cluster ring with 2 slots, two blocks an SM (its first
            table); c5xrb1 the same with registers for one block an SM
  c5xrs3,   K5's cluster ring with 3 or 5 slots, one block an SM
  c5xrs5
  c5oldnotw the first design without twiddle multiplies
  c5oldcopy the first design as its loads and its store pass (one stage,
            no DFT arithmetic, no chain)
  c5notw    the persistent ring and the float cluster tile without
            twiddle multiplies (the chains', the exchange's)
  c5copy    the ring's box copies and its stores alone (no chain: the
            slot's raw planes stored from registers)
  c5r8      the ring's chain on radix 8 (PRING_R16 off)
  c5twd0    the ring's chain reading every twiddle of a butterfly
  c5s2      the ring of 2 slots (3 by default)
  c5c16     the ring at n = 256 on tiles of 16 columns (64-byte runs,
            32 KB slots, two blocks an SM)
  c5c16s6   the same with 6 slots (one block an SM)
  c5wave    the ring's grid one whole wave (not cut to whole rounds)
  c5ring512 the ring at n = 512 too (C = 16, two boxes of 256 rows a
            plane; the source's table leaves 512 to the first design)
  c5n512    the same on tiles of 8 columns (32 KB slots)
  c5ring8   the ring at n = 8 too (the source's table leaves 8 to the first
            design)
  c5s1      P5: the ring of one slot, so that no load is in flight while
            a block runs its chain (the next tile's copy starts after the
            chain's last barrier), with the shared memory of three slots:
            one block an SM, the same registers, as the default
  c5s1p     the same with the blocks an SM that one slot's shared memory
            allows (three at n = 256, under a tighter register cap)
  c5s1w     c5s1 with a fence and a barrier after each chain, so that the
            next tile's copy starts only when the last tile's stores are
            done: nothing of the stream overlaps within a block
  k11old    K11's first design at every n (PYFFT_ROWS_RING_F64 emptied),
            P4's K11 half; k11oldnotw and k11oldcopy as oldnotw and oldcopy
  k11oldtwd0 the first design reading every twiddle of a radix-8
            butterfly (OLD_TWD_F64 off: the design before this split)
  k11ring   K11's ring at n = 1024, 2048 and 4096 (the source's table
            leaves 1024 and 2048 to the first design with TWD)
  k11r8     K11's ring on radix 8 (RING_R16_F64 off)
  k11rpb4   k11ring with 4 rows a slot at n = 1024 (one block an SM)
  k11rpb1   k11ring with 1 row a slot at n = 1024 (four blocks an SM)
  k11rs2    k11ring of 2 slots
  k8old     K8's first design at every shape (the plane ring's table
            PYFFT_FUSED2D_RING emptied: the design before the ring)
  k8copy    the ring's box copies and its stores alone: each block's share
            stored back as the output's rows from registers, no chain and
            no exchange (its cluster barrier kept)
  k8xonly   the ring's exchange alone: the share's raw rows copied to the
            owning blocks' slots and stored from there, no chain
  k8notw    the ring's chains without twiddle multiplies
  k8r8      the ring's chains on radix 8 (RING2_R16 off)
  k8pad0    the ring's row chain without chain_index's padding
  k8twd0    the ring's chains reading every twiddle of a butterfly
  k8p8k     the ring's shares of 8192 points at every shape (512 threads,
            one block an SM; 4096 points, 256 threads and two blocks an SM
            by default up to 2^16 points a plane)
  k8t8      the ring's chains on radix 8 with 8 points a thread a stage
            (twice the threads, 64 registers)
  k8nobar   the ring's copies without waiting for the owners' slots to
            be free: its time only, the results are wrong
  k8rel     the exchange's cluster barrier with release semantics (its
            arrive waits for the thread's stores to device memory)
  k8local   the exchange's copies all to the block's own slot, not the
            owners' (no DSMEM): its time only, the results are wrong
  k8pout0   the ring's stores to the complex form's stride-2 planes as two
            4-byte stores a point, not one 8-byte (re, im) store (POUT off)

and times each by CUDA events (``time_ms``, the full variant first and
last) on its kernel's shapes: K12 at config 5's two passes (2^22 x 64
complex128, split 2048 x 2048: pass 1 the full twiddle and the swapped
store, pass 2 the plain store), planar and on the complex form's stride-2
planes, and the complex128 2D column pass (16 x 1024 x 1024); K5 at
config 4's z pass (1 x 256 x 65536, planar and stride-2 planes), config
3's column pass (16 x 1024 x 1024, planar and stride-2 planes: the
cluster ring's), config 6+'s two passes and the plain
passes of the mid and huge routes (n = 128, 512); P5 (K5's ring of 3, 2
and 1 slots and its first design, c5old; the mean of two turns, the
second in reverse order) at config 4's z pass and at (1, 64, 262144); K11 at the complex128
2D row pass (16384 x 1024, planar and complex form) and at 2^24 points
with n = 2048 and 4096; K8 at config 4 (256 planes of 256 x 256,
planar and stride-2 planes) and at 2^24 points of 1024 x 128^2, 64 x 512^2
and 64 x 2048 x 128 (the last two run the first design in every variant
but the table's); K9 at config
3 (16 x 1024 x 1024) and 16 x 512 x 512; K6 at config 4's z pass (1 x 256
x 65536, c = 1, 2, 8), variant B's pass 1 (8 x 2048 x 2048, `full`
twiddle, c = 1, 8) and 2^24 points at n = 512 and 1024 (c = 1, 8); K4 at variant B's pass 2 (8 x 2048 x 2048) and at the
same 2^25 points with n = 512, 1024 and 4096; K1 at config 2 (4096 x
4096) planar and on the complex form's stride-2 planes and at 2^24 points
at every n from 8 to 8192 (planar), K2 at config 2i and at 2048 x 8192.
Every patch asserts that its text is in the sources, so an edited kernel
fails here instead of timing the wrong thing.  The last line is a JSON
record with the card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

import ab_parent  # noqa: E402
from pyfft_tpu_torch.ops import build, fused2d, local  # noqa: E402
from pyfft_tpu_torch.utils.profiling import (  # noqa: E402
    time_ms, time_queued_ms)

K12, K9, K1 = "local_cols", "fused2d_tiled", "local_rows"

XCOLS = ("#define PYFFT_XCOLS_F64(X) X(10, 4, 16, 2) X(11, 8, 16, 2) "
         "X(12, 8, 16, 1)")
XCOLS_S2 = ("#define PYFFT_XCOLS_F64_S2(X) X(10, 2, 8, 2) X(11, 4, 8, 2) "
            "X(12, 8, 8, 2)")

# K12's ring table (local_cols.cu)
XRING = re.search(r"#define PYFFT_XRING_F64\(X\)[^\n]*\n",
                  (build.CSRC / "local_cols.cu").read_text()).group(0)

# K9's constant chain options (fused2d_tiled.cu's ShapeF)
KNOBS = "static constexpr bool PAD = true, TWD = true, R16 = true;"

RING_X = ("#define PYFFT_RING_X(X) X(10, 4, 32) X(11, 16, 32) X(12, 8, 16) "
          "X(13, 16, 16)")
SWAP_X = ("#define PYFFT_SWAP_X(X) \\\n  X(9, 4, 32) X(10, 4, 32) X(11, 8, 32) "
          "X(12, 16, 32) X(13, 16, 16)")
# K6's and K4's constant shape options (local_cols.cu)
SLOTS = "constexpr int RING_SLOTS = 3;"
GROUP = "  while (2 * g <= runs && steps * 2 * g <= wave) g *= 2;\n"
SWAP_R16 = "constexpr bool SWAP_R16 = true;"
SWAP_NT = "constexpr int SWAP_THREADS = 256, SWAP_BLOCKS = 3;"
# the row ring's chain options and its store (local_rows.cu)
RING_KNOBS = ("constexpr bool RING_PAD = true, RING_TWD = true, "
              "RING_R16 = true;")
# K5's persistent ring: its table, its chain options and its grid; the
# float cluster tables; K11's ring table and radix
PRING = re.search(r"#define PYFFT_COLS_PRING\(X\)(?:[^\n]*\\\n)+[^\n]*\n",
                  (build.CSRC / "local_cols.cu").read_text()).group(0)
PRING_KNOBS = "constexpr bool PRING_R16 = true, PRING_TWD = true;"
PRING_GRID = "  const long long grid = (tiles + rounds - 1) / rounds;"
PRING_SMEM = ("  static constexpr int SMEM = S * SLOT + 128;         "
              "// + alignment\n"
              "  static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);\n"
              "  static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM "
              ": 2048 / NT;\n"
              "  static_assert(S >= 2 && SMEM")
XCOLS_F32 = re.search(r"#define PYFFT_XCOLS_F32\(X\)[^\n]*\\\n[^\n]*\n",
                      (build.CSRC / "local_cols.cu").read_text()).group(0)
XCOLS_F32_S2 = re.search(
    r"#define PYFFT_XCOLS_F32_S2\(X\)[^\n]*\\\n[^\n]*\n",
    (build.CSRC / "local_cols.cu").read_text()).group(0)
# K5's cluster ring table on the complex form's pairs
XRING_F32 = re.search(r"#define PYFFT_XRING_F32_S2\(X\)[^\n]*\n",
                      (build.CSRC / "local_cols.cu").read_text()).group(0)
XRING_F32_TO = "#define PYFFT_XRING_F32_S2(X) X(10, {}, 16, {}, {})\n"
ROWS_RING_F64 = "#define PYFFT_ROWS_RING_F64(X) X(12, 1, 2)"
# K11's ring at every length it may take (the table before the split sent
# n = 1024 and 2048 back to the first design)
K11_RING = ("#define PYFFT_ROWS_RING_F64(X) X(10, 2, 3) X(11, 1, 3) "
            "X(12, 1, 2)")
R16_F64 = "constexpr bool RING_R16_F64 = true;"
# the ring's chain call, which c5copy replaces by stores of the raw slot
PRING_CHAIN = ("    chain<NT, LOGN, C, false, 0, 1, true, true, false, "
               "PRING_TWD, K::R16,\n          true>(sm, fresh(tw), s, load, "
               "store);")

# the ring's table, (log2 n, rows a slot, slots), as the source states it
ROWS_RING = re.search(r"#define PYFFT_ROWS_RING\(X\)(?:[^\n]*\\\n)+[^\n]*\n",
                      (build.CSRC / "local_rows.cu").read_text()).group(0)


# K8: the plane ring's table, its knobs, its phases (fused2d.cu)
K8 = "fused2d"
K8_TABLE = re.search(r"#define PYFFT_FUSED2D_RING\(X\)(?:[^\n]*\\\n)+[^\n]*\n",
                     (build.CSRC / "fused2d.cu").read_text()).group(0)
K8_KNOBS = "constexpr bool RING2_PAD = true, RING2_TWD = true, RING2_R16 = true;"
K8_SLOTS = "constexpr int RING2_SLOTS = 2;"
K8_SHARE = "constexpr int RING2_SHARE = 4096;"
K8_THREADS = "constexpr int RING2_THREAD_POINTS = 16;"
# the dispatch's choice of the (re, im) pair store (k8pout0)
K8_POUT = ("  const bool pout = pairs && io.out_xs == 2 && "
           "io.out_im == io.out_re + 1 &&")
# the exchange's wait for the owners' slots (k8nobar) and its copies to
# other blocks (k8local): their time only, the results are wrong
K8_ALL_READ = ("      cluster_arrive_relaxed();\n      cluster_wait();\n")


K8_ROWS = ("    rows_head<NT, LX, RB, K::R16X>(sm, fresh(twx), s, load);\n"
           "    stage<NT, NX, RB, true, PX::R_LAST, PX::NS_LAST, false, true, "
           "RING2_PAD,\n          RING2_TWD>(sm, fresh(twx), s, load, put, "
           "all_read);\n")
K8_COLS = ("    chain<NT, LY, CB, false, 0, 1, false, true, false, RING2_TWD, "
           "K::R16Y>(\n        sm, fresh(twy), s, none_load, store);\n")
# the exchange's copies and their wait
K8_EXCH = ("    if (threadIdx.x == 0) {\n"
           "      fence_async_smem();\n"
           "      mbar_expect(&landed, PB * (int)sizeof(float2));\n"
           "      for (int o = 0; o < K::G; ++o)\n"
           "        bulk_to_block(sm + rank * RB * CB, sent + o * RB * CB,\n"
           "                      RB * CB * (int)sizeof(float2), &landed, o);\n"
           "    }\n"
           "    mbar_wait(&landed, i & 1);\n")
# k8copy: the share stored back as the output's rows, along x
K8_COPY_ROWS = (
    "    for (int e = threadIdx.x; e < PB; e += NT) {\n"
    "      const float2 v = load(e / NX, e % NX);\n"
    "      const long long o = (rank * RB + e / NX) * io.out_ys +\n"
    "                          (e % NX) * io.out_xs;\n"
    "      out_re[o] = v.x;\n"
    "      out_im[o] = v.y;\n"
    "    }\n"
    "    __syncthreads();\n"
    "    all_read();\n")
# k8xonly: the raw rows exchanged, the columns stored from the slot
K8_X_ROWS = (
    "    float2 v[PB / NT];\n"
    "#pragma unroll\n"
    "    for (int q = 0; q < PB / NT; ++q)\n"
    "      v[q] = load((threadIdx.x + q * NT) / NX, (threadIdx.x + q * NT) % NX);\n"
    "    __syncthreads();\n"
    "    all_read();\n"
    "#pragma unroll\n"
    "    for (int q = 0; q < PB / NT; ++q)\n"
    "      put((threadIdx.x + q * NT) / NX, (threadIdx.x + q * NT) % NX, v[q]);\n")
K8_X_COLS = (
    "    for (int e = threadIdx.x; e < PB; e += NT)\n"
    "      store(e % CB, e / CB, sm[e]);\n"
    "    __syncthreads();\n")

# rows a slot and slots by log2 n in the source's table
TABLE = re.findall(r"X\((\d+), (\d+), (\d+)\)", ROWS_RING)
RPB_AT = {int(k): int(r) for k, r, _ in TABLE}
SLOTS_AT = {int(k): int(v) for k, _, v in TABLE}


def rows_ring(rpb: dict, slots: int = 0) -> tuple:
    """The patch that sets the ring's table to ``rpb`` rows a slot by log2
    n (none: every length runs the first design) and ``slots`` (by default
    the source's slots at that length, else 3)."""
    table = " ".join(f"X({k}, {r}, {slots or SLOTS_AT.get(k, 3)})"
                     for k, r in sorted(rpb.items()))
    return ("local_rows.cu", ROWS_RING,
            f"#define PYFFT_ROWS_RING(X) {table}\n")


# rows a slot by log2 n: 4096 points (2048 at n = 8, 8192 at n = 8192) at
# every n (the source's table leaves n = 128 to 512 to the first design);
# 8192 points; 2048 points
RPB = {k: min(256, max(1, 4096 >> k)) for k in range(3, 14)}
RPB_8K = {k: min(256, max(1, 8192 >> k)) for k in range(3, 14)}
RPB_2K = {k: min(256, max(1, 2048 >> k)) for k in range(3, 14)}

# K12's ring: its stages' and its exchange's multiplies by the block's
# twiddle table (ring_cols.cuh), the comment its stage follows, and the
# reads of `tw` with products that the table replaced
XR_STAGE_TW = ("    const V* w = tab + xt_table_stage<X>(NS) + (j % NS) * "
               "(R - 1);\n#pragma unroll\n    for (int r = 1; r < R; ++r) "
               "y[b][r] = cmul(y[b][r], w[r - 1]);\n")
XR_EXCHANGE_TW = ("    const V* w = tab + xt_table_exchange<X>() + kl * "
                  "(G - 1);\n#pragma unroll\n    for (int b = 1; b < G; "
                  "++b) u[b] = cmul(u[b], w[b - 1]);\n")
XR_STAGE_DOC = "// One radix-8 stage of X's M-point chain after the first"
XR_TWIDDLE = """// v[r] *= w^r for 0 < r < R, w^r at tw[r*e], from fewer reads
template <int R, class V>
__device__ __forceinline__ void xt_twiddle(V* v, const V* __restrict__ tw,
                                           int e) {
  if constexpr (R == 8) {
    const V w1 = __ldg(&tw[e]), w2 = __ldg(&tw[2 * e]);
    const V w4 = __ldg(&tw[4 * e]);
    v[1] = cmul(v[1], w1);
    v[2] = cmul(v[2], w2);
    v[3] = cmul(v[3], cmul(w1, w2));
    v[4] = cmul(v[4], w4);
    v[5] = cmul(v[5], cmul(w1, w4));
    v[6] = cmul(v[6], cmul(w2, w4));
    v[7] = cmul(v[7], __ldg(&tw[7 * e]));
  } else {
    static_assert(R == 16, "radix 8 or 16");
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
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r]);
  }
}

"""

# (file, text, replacement) steps, by name
STEPS = {
    "notw": [
        ("cluster_cols.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("cluster_cols.cuh",
         "    for (int b = 1; b < G; ++b) u[i][b] = cmul(u[i][b], "
         "__ldg(&tw[b * kp]));\n", ""),
        ("chain.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("local_cols.cu",
         "\n    V w = __ldg(&io.ta[k * io.ak + q * io.aq]);",
         "\n    V w = Complex<Real>::make(1, 0);")],
    "noarith": [
        ("cluster_cols.cuh", "    dft<R>(v[b], s);\n", ""),
        ("cluster_cols.cuh", "    dft<G>(u[i], s);\n", ""),
        ("chain.cuh", "    dft<R>(v[b], s);\n", "")],
    "copy": [
        ("local_cols.cu", "  xt_chain<X, SWAP>(sm, tw, s);\n", ""),
        ("cluster_cols.cuh",
         "    const V* src = cluster.map_shared_rank(sm, g0 + b);",
         "    const V* src = sm;")],
    # K12's ring: no twiddles (its last stage's, its exchange's, its
    # store's), no DFT arithmetic, its chunks copied to the block's own
    # receive buffer, its chain cut to the first stage
    "xrnotw": [
        ("ring_cols.cuh", XR_STAGE_TW, ""),
        ("ring_cols.cuh", XR_EXCHANGE_TW, ""),
        ("local_cols.cu", "  const bool twiddled = io.tw_mode != TW_NONE;",
         "  const bool twiddled = false;")],
    "xrarith": [("ring_cols.cuh", "    dft<R>(v[b], s);\n", ""),
                ("ring_cols.cuh", "    dft<R>(y[b], s);\n", ""),
                ("ring_cols.cuh", "    dft<G>(u, s);\n", "")],
    "xrlocal": [("ring_cols.cuh",
                 "CH * (int)sizeof(V),\n                    landed, o);",
                 "CH * (int)sizeof(V),\n                    landed, "
                 "rank);")],
    "xrcopy": [("ring_cols.cuh",
                "  xt_chain_chunks<X, KMAJOR, 1, R>(sm, tab, s);\n", "")],
    # K12's ring reading its chain's and exchange's twiddles from `tw`
    # every tile, four of seven and five of fifteen and the rest their
    # products (the design before the shared-memory table)
    "xrtw": [
        ("ring_cols.cuh", XR_STAGE_DOC, XR_TWIDDLE + XR_STAGE_DOC),
        ("ring_cols.cuh", XR_STAGE_TW,
         "    xt_twiddle<R>(y[b], tab, (j % NS) * (X::N / (NS * R)));\n"),
        ("ring_cols.cuh", XR_EXCHANGE_TW, "    xt_twiddle<G>(u, tab, kp);\n"),
        ("local_cols.cu", "xt_chain_from_chunks<X, SWAP>(sm, tab, s,",
         "xt_chain_from_chunks<X, SWAP>(sm, fresh(tw), s,"),
        ("local_cols.cu", "(recv, &landed, i & 1, tab, s, rank, put);",
         "(recv, &landed, i & 1, fresh(tw), s, rank, put);")],
    "xold": [("local_cols.cu", XRING, "#define PYFFT_XRING_F64(X)\n")],
    "xr8": [("local_cols.cu", XRING,
             "#define PYFFT_XRING_F64(X) X(11, 8, 16, 2, 1)\n")],
    "g4": [("local_cols.cu", XCOLS, "#define PYFFT_XCOLS_F64(X) "
            "X(10, 2, 16, 1) X(11, 4, 16, 1) X(12, 8, 16, 1)"),
           ("local_cols.cu", XCOLS_S2, "#define PYFFT_XCOLS_F64_S2(X) "
            "X(10, 2, 16, 1) X(11, 4, 16, 1) X(12, 8, 16, 1)")],
    "m1": [("local_cols.cu", XCOLS, "#define PYFFT_XCOLS_F64(X) "
            "X(10, 4, 16, 1) X(11, 8, 16, 1) X(12, 8, 16, 1)")],
    "s2c16": [("local_cols.cu", XCOLS_S2, "#define PYFFT_XCOLS_F64_S2(X) "
               "X(10, 4, 16, 2) X(11, 8, 16, 2) X(12, 8, 16, 1)")],
    "nohint": [
        ("fused2d_tiled.cu", "createpolicy.fractional.L2::evict_first.b64",
         "createpolicy.fractional.L2::evict_normal.b64"),
        ("fused2d_tiled.cu", "createpolicy.fractional.L2::evict_last.b64",
         "createpolicy.fractional.L2::evict_normal.b64")],
    "r8": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("R16 = true",
                                                     "R16 = false"))],
    "twd0": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("TWD = true",
                                                       "TWD = false"))],
    "pad0": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("PAD = true",
                                                       "PAD = false"))],
    "pct50": [("fused2d_tiled.cu", "(long long)l2 / (8LL",
               "(long long)l2 / 2 / (8LL")],
    "run32": [("fused2d_tiled.cu", "constexpr int RUN = 8;",
               "constexpr int RUN = 32;")],
    "k46notw": [
        ("cluster_cols.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("ring_cols.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("cluster_cols.cuh",
         "    for (int b = 1; b < G; ++b) u[i][b] = cmul(u[i][b], "
         "__ldg(&tw[b * kp]));\n", ""),
        ("local_cols.cu", "    const bool twd = io.tw_mode != TW_NONE;",
         "    const bool twd = false;"),
        ("local_cols.cu",
         "      x[i][k1] = cmul(x[i][k1], __ldg(&tw[(rank * MG + jl) * k1]));",
         "      ;")],
    "k46arith": [
        ("cluster_cols.cuh", "    dft<R>(v[b], s);\n", ""),
        ("cluster_cols.cuh", "    dft<G>(u[i], s);\n", ""),
        ("ring_cols.cuh", "    dft<R>(v[b], s);\n", ""),
        ("ring_cols.cuh", "    dft<R>(v, s);\n", ""),
        ("local_cols.cu", "    dft<G>(x[i], s);\n", ""),
        ("local_cols.cu", "    xt_chain_from<X>(sm, t, s, [&](int k, int c) {",
         "    if (i < 0) xt_chain_from<X>(sm, t, s, [&](int k, int c) {"),
        ("local_cols.cu", "    xt_stage_out<X, 16, 16>(sm, tw, s, put);",
         "    xt_stage_out<X, 16, 1>(sm, tw, s, put);"),
        ("local_cols.cu", "    xt_chain_out<X, 1, R0>(sm, tw, s, put);",
         "    xt_stage_out<X, 8, 1>(sm, tw, s, put);")],
    "k46local": [
        ("cluster_cols.cuh",
         "    const V* src = cluster.map_shared_rank(sm, g0 + b);",
         "    const V* src = sm;"),
        ("local_cols.cu",
         "        const float2* src = cluster.map_shared_rank(sm, k / MG);",
         "        const float2* src = sm;")],
    "x8": [("local_cols.cu", RING_X, RING_X.replace("X(11, 16, 32)",
                                                    "X(11, 8, 32)"))],
    "runs1024": [("local_cols.cu", RING_X,
                  RING_X.replace("X(10, 4, 32) ", ""))],
    "x512": [("local_cols.cu", RING_X,
              RING_X.replace("X(10, 4, 32)", "X(9, 2, 32) X(10, 4, 32)"))],
    "r16": [("local_cols.cu", SWAP_X, SWAP_X.replace(
        "X(10, 4, 32) X(11, 8, 32)", "X(10, 4, 16) X(11, 8, 16)"))],
    "k4old": [("local_cols.cu", SWAP_X, "#define PYFFT_SWAP_X(X)")],
    "s2": [("local_cols.cu", SLOTS, SLOTS.replace("3", "2"))],
    "grp1": [("local_cols.cu", GROUP, "")],
    "grp4": [("local_cols.cu", GROUP, "  g = runs < 4 ? runs : 4;\n")],
    "k4r8": [("local_cols.cu", SWAP_R16, SWAP_R16.replace("true", "false"))],
    "k4t512": [("local_cols.cu", SWAP_NT,
                SWAP_NT.replace("256", "512").replace("3", "2"))],
    "old": [rows_ring({})],
    "oldnotw": [("local_rows.cu", "    if (NS > 1) {", "    if (NS < 0) {")],
    "oldcopy": [
        ("local_rows.cu", "    dft<R>(v[b], s);\n", ""),
        ("local_rows.cu",
         "  static constexpr int NSTAGES = LOGN / 3 + (REM ? 1 : 0);",
         "  static constexpr int NSTAGES = 1;"),
        ("local_rows.cu",
         "  const int smem = S::NSTAGES > 1 ? S::P * (int)sizeof(V) : 0;",
         "  const int smem = S::P * (int)sizeof(V);"),
        # the one stage stores as the last one does, threads along k
        ("local_rows.cu",
         "    const int base = (j / NS) * NS * R + j % NS;",
         "    const int base = j;"),
        ("local_rows.cu", "      const int k = base + r * NS;",
         "      const int k = base + r * NR;")],
    "rnotw": [("chain.cuh", "    if (NS > 1) {", "    if (NS < 0) {")],
    "rcopy": [("local_rows.cu",
               "    chain<NT, LOGN, RPB, true, 0, 1, !K::PASS_IN, !K::PASS_OUT, "
               "RING_PAD,\n          RING_TWD, K::R16, true>(sm, fresh(tw), s, "
               "load, store);",
               "    if constexpr (!K::PASS_OUT) {\n"
               "      for (int e = threadIdx.x; e < P; e += NT)\n"
               "        store(e / N, e % N, load(e / N, e % N));\n"
               "      __syncthreads();\n"
               "    }")],
    "rr8": [("local_rows.cu", RING_KNOBS,
             RING_KNOBS.replace("R16 = true", "R16 = false"))],
    "rpad0": [("local_rows.cu", RING_KNOBS,
               RING_KNOBS.replace("PAD = true", "PAD = false"))],
    "rtwd0": [("local_rows.cu", RING_KNOBS,
               RING_KNOBS.replace("TWD = true", "TWD = false"))],
    "rbulk": [
        ("local_rows.cu",
         "// Copy the box of the 2D tensor map `map` at (c0, c1) into shared "
         "`dst`,\n",
         "__device__ __forceinline__ void bulk_store(void* dst, const void* "
         "src,\n                                           int bytes) {\n"
         "  asm volatile(\"cp.async.bulk.global.shared::cta.bulk_group "
         "[%0], [%1], %2;\\n\"\n"
         "               :: \"l\"(dst), \"r\"(smem_u32(src)), \"r\"(bytes) "
         ": \"memory\");\n}\n\n"
         "template <bool ALL = false>\n"
         "__device__ __forceinline__ void bulk_wait() {\n"
         "  if constexpr (ALL)\n"
         "    asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: "
         "\"memory\");\n"
         "  else\n"
         "    asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: "
         "\"memory\");\n}\n\n"
         "template <typename Real>\n"
         "inline bool ring_rows_out_bulk(const RingIo<Real>& io) {\n"
         "  const uintptr_t a = reinterpret_cast<uintptr_t>(io.out);\n"
         "  const uintptr_t b = reinterpret_cast<uintptr_t>(io.out_im);\n"
         "  return (io.out_pairs || (io.out_es == 1 && b % 16 == 0)) && "
         "a % 16 == 0 &&\n"
         "         (io.rows == 1 || io.out_rs * (long long)sizeof(Real) % 16 "
         "== 0);\n}\n\n"
         "// Copy the box of the 2D tensor map `map` at (c0, c1) into shared "
         "`dst`,\n"),
        ("local_rows.cu",
         "  constexpr int N = K::N, P = K::P, NT = K::NT, SLOT = K::SLOT;\n",
         "  constexpr int N = K::N, P = K::P, NT = K::NT, SLOT = K::SLOT;\n"
         "  constexpr bool BULK = !K::BOX;\n"),
        ("local_rows.cu",
         "    if (threadIdx.x == 0 && i && i + S - 1 < count) "
         "issue(i + S - 1);\n",
         "    if (BULK && threadIdx.x == 0 && i) bulk_wait();\n"
         "    if (threadIdx.x == 0 && i && i + S - 1 < count) "
         "issue(i + S - 1);\n"),
        # the last stage writes the slot's raw rows, as they were read
        ("local_rows.cu",
         "      const V y = Complex<Real>::make(v.x * io.post, v.y * io.post);"
         "\n",
         "      const V y = Complex<Real>::make(v.x * io.post, v.y * io.post);"
         "\n"
         "      if constexpr (BULK) {\n"
         "        Real* g = reinterpret_cast<Real*>(sm);\n"
         "        if (pout) {\n"
         "          sm[c * N + k] = y;\n"
         "        } else {\n"
         "          g[c * N + k] = y.x;\n"
         "          g[P + c * N + k] = y.y;\n"
         "        }\n"
         "        return;\n"
         "      }\n"),
        # thread 0 copies the slot's rows out, one bulk copy a row a plane
        ("local_rows.cu",
         "      __syncthreads();\n    }\n  }\n}\n\n// The card's SMs",
         "      __syncthreads();\n    }\n"
         "    if constexpr (BULK) {\n"
         "      fence_async_smem();\n"
         "      __syncthreads();\n"
         "      if (threadIdx.x == 0) {\n"
         "        const int nr = static_cast<int>(\n"
         "            io.rows - row0 < RPB ? io.rows - row0 : RPB);\n"
         "        for (int r = 0; r < nr; ++r) {\n"
         "          const long long o = (row0 + r) * io.out_rs;\n"
         "          if (pout) {\n"
         "            bulk_store(io.out + o, sm + r * N, "
         "N * (int)sizeof(V));\n"
         "          } else {\n"
         "            bulk_store(io.out + o, f + r * N, "
         "N * (int)sizeof(Real));\n"
         "            bulk_store(io.out_im + o, f + P + r * N,\n"
         "                       N * (int)sizeof(Real));\n"
         "          }\n"
         "        }\n"
         "        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
         "\"memory\");\n"
         "      }\n"
         "    }\n"
         "  }\n"
         "  if (BULK && threadIdx.x == 0) bulk_wait<true>();\n"
         "}\n\n// The card's SMs"),
        # outputs the bulk store cannot write run the first design
        ("local_rows.cu",
         "  if (ring.rows > 0 && ring_rows_rpb<Real>(log2n) &&\n"
         "      ring_rows_operands(ring)) {\n",
         "  if (ring.rows > 0 && ring_rows_rpb<Real>(log2n) &&\n"
         "      ring_rows_operands(ring) &&\n"
         "      (log2n < 9 || ring_rows_out_bulk(ring))) {\n")],
    "c5old": [("local_cols.cu", PRING, "#define PYFFT_COLS_PRING(X)\n"),
              ("local_cols.cu", XCOLS_F32, "#define PYFFT_XCOLS_F32(X)\n"),
              ("local_cols.cu", XCOLS_F32_S2,
               "#define PYFFT_XCOLS_F32_S2(X)\n"),
              ("local_cols.cu", XRING_F32,
               "#define PYFFT_XRING_F32_S2(X)\n")],
    "c5xold": [("local_cols.cu", XRING_F32,
                "#define PYFFT_XRING_F32_S2(X)\n")],
    "c5xr8": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(8, 3, 3))],
    "c5xr8s2": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(8, 2, 4))],
    "c5xrs2": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(4, 2, 2))],
    "c5xrb1": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(4, 2, 1))],
    "c5xrs3": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(4, 3, 1))],
    "c5xrs5": [("local_cols.cu", XRING_F32, XRING_F32_TO.format(4, 5, 1))],
    "c5oldnotw": [("local_cols.cu", "    if (NS > 1) {\n      const int jj",
                   "    if (NS < 0) {\n      const int jj")],
    "c5oldcopy": [
        ("local_cols.cu", "    dft<R>(v[b], s);\n  }\n  // a stage after",
         "  }\n  // a stage after"),
        ("local_cols.cu",
         "  static constexpr int NSTAGES = LOGN / 3 + (REM ? 1 : 0);\n"
         "  static_assert(C >= 1 && 128 % C == 0",
         "  static constexpr int NSTAGES = 1;\n"
         "  static_assert(C >= 1 && 128 % C == 0")],
    "c5notw": [
        ("chain.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("cluster_cols.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("cluster_cols.cuh",
         "    for (int b = 1; b < G; ++b) u[i][b] = cmul(u[i][b], "
         "__ldg(&tw[b * kp]));\n", "")],
    "c5copy": [("local_cols.cu", PRING_CHAIN,
                "    __syncthreads();\n"
                "    for (int e = threadIdx.x; e < P; e += NT)\n"
                "      store(e % C, e / C, load(e % C, e / C));\n"
                "    __syncthreads();")],
    "c5r8": [("local_cols.cu", PRING_KNOBS,
              PRING_KNOBS.replace("R16 = true", "R16 = false"))],
    "c5twd0": [("local_cols.cu", PRING_KNOBS,
                PRING_KNOBS.replace("TWD = true", "TWD = false"))],
    "c5s2": [("local_cols.cu", PRING, PRING.replace(", 3)", ", 2)"))],
    "c5s1": [("local_cols.cu", PRING, PRING.replace(", 3)", ", 1)")),
             ("local_cols.cu", PRING_SMEM, PRING_SMEM.replace(
                 "S * SLOT", "3 * SLOT").replace("S >= 2", "S >= 1"))],
    "c5s1w": [("local_cols.cu", PRING_CHAIN,
               PRING_CHAIN + "\n    __threadfence();\n    __syncthreads();")],
    "c5s1p": [("local_cols.cu", PRING, PRING.replace(", 3)", ", 1)")),
              ("local_cols.cu", PRING_SMEM,
               PRING_SMEM.replace("S >= 2", "S >= 1"))],
    "c5c16": [("local_cols.cu", PRING, PRING.replace(
        "X(8, 32, 3)", "X(8, 16, 3)"))],
    "c5c16s6": [("local_cols.cu", PRING, PRING.replace(
        "X(8, 32, 3)", "X(8, 16, 6)"))],
    "c5ring512": [("local_cols.cu", PRING, PRING.replace(
        "X(8, 32, 3)", "X(8, 32, 3) X(9, 16, 3)"))],
    "c5ring8": [("local_cols.cu", PRING, PRING.replace(
        "X(4, 128, 3)", "X(3, 128, 3) X(4, 128, 3)"))],
    "c5wave": [("local_cols.cu", PRING_GRID,
                "  const long long grid = tiles < wave ? tiles : wave;")],
    "k11old": [("local_rows.cu", ROWS_RING_F64,
                "#define PYFFT_ROWS_RING_F64(X)")],
    "k11r8": [("local_rows.cu", R16_F64, R16_F64.replace("true", "false"))],
    "k11twd0": [("local_rows.cu", "constexpr bool OLD_TWD_F64 = true;",
                 "constexpr bool OLD_TWD_F64 = false;")],
    "c5n512": [("local_cols.cu", PRING, PRING.replace(
        "X(8, 32, 3)", "X(8, 32, 3) X(9, 8, 3)"))],
    "k11ring": [("local_rows.cu", ROWS_RING_F64, K11_RING)],
    "k11rpb4": [("local_rows.cu", ROWS_RING_F64,
                 K11_RING.replace("X(10, 2, 3)", "X(10, 4, 3)"))],
    "k11rpb1": [("local_rows.cu", ROWS_RING_F64,
                 K11_RING.replace("X(10, 2, 3)", "X(10, 1, 3)"))],
    "k11rs2": [("local_rows.cu", ROWS_RING_F64,
                K11_RING.replace(", 3)", ", 2)"))],
    "rall": [rows_ring(RPB)],
    "rs2": [rows_ring(RPB, 2)],
    "rs3": [rows_ring(RPB_AT, 3)],
    "r8k": [rows_ring(RPB_8K)],
    "r2k": [rows_ring(RPB_2K)],
    "k8old": [("fused2d.cu", K8_TABLE, "#define PYFFT_FUSED2D_RING(X)\n")],
    "k8copy": [("fused2d.cu", K8_ROWS, K8_COPY_ROWS),
               ("fused2d.cu", K8_EXCH, ""), ("fused2d.cu", K8_COLS, "")],
    "k8xonly": [("fused2d.cu", K8_ROWS, K8_X_ROWS),
                ("fused2d.cu", K8_COLS, K8_X_COLS)],
    "k8notw": [("chain.cuh", "    if (NS > 1) {", "    if (NS < 0) {")],
    "k8r8": [("fused2d.cu", K8_KNOBS, K8_KNOBS.replace("R16 = true",
                                                        "R16 = false"))],
    "k8pad0": [("fused2d.cu", K8_KNOBS, K8_KNOBS.replace("PAD = true",
                                                          "PAD = false"))],
    "k8twd0": [("fused2d.cu", K8_KNOBS, K8_KNOBS.replace("TWD = true",
                                                          "TWD = false"))],
    "k8p8k": [("fused2d.cu", K8_SHARE, K8_SHARE.replace("4096", "8192"))],
    "k8nobar": [("fused2d.cu", K8_ALL_READ, ""),
                ("fused2d.cu", "  cluster_arrive();                 "
                 "// every copy out of this block landed\n",
                 "  cluster_arrive_relaxed();\n")],
    "k8rel": [("fused2d.cu", K8_ALL_READ,
               "      cluster_arrive();\n      cluster_wait();\n")],
    "k8local": [("fused2d.cu", "RB * CB * (int)sizeof(float2), &landed, o);",
                 "RB * CB * (int)sizeof(float2), &landed, rank);")],
    "k8t8": [("fused2d.cu", K8_THREADS, K8_THREADS.replace("16", "8"))],
    "k8pout0": [("fused2d.cu", K8_POUT, K8_POUT.replace("= pairs &&",
                                                        "= false &&"))],
}

# name -> (kernels timed, steps taken in order, -D macros)
VARIANTS = {
    "full": (("K12", "K9", "K6", "K4", "K1", "K2", "K5", "K11",
             "P5"), [], {}),
    "notw": (("K12", "K9", "K5"), ["notw", "xrnotw"], {}),
    "copy": (("K12", "K9", "K5"),
             ["notw", "xrnotw", "noarith", "xrarith", "copy", "xrlocal",
              "xrcopy"], {}),
    "xold": (("K12",), ["xold"], {}),
    "xoldnotw": (("K12",), ["xold", "notw"], {}),
    "xoldcopy": (("K12",), ["xold", "notw", "noarith", "copy"], {}),
    "xrarith": (("K12", "K5"), ["notw", "xrnotw", "noarith", "xrarith"],
                {}),
    "xrlocal": (("K12", "K5"),
                ["notw", "xrnotw", "noarith", "xrarith", "xrlocal"], {}),
    "xr8": (("K12",), ["xr8"], {}),
    "xrtw": (("K12",), ["xrtw"], {}),
    "g4": (("K12",), ["g4"], {}),
    "m1": (("K12",), ["m1"], {}),
    "s2c16": (("K12",), ["s2c16"], {}),
    "r8": (("K9",), ["r8"], {}),
    "twd0": (("K9",), ["twd0"], {}),
    "pad0": (("K9",), ["pad0"], {}),
    "nohint": (("K9",), ["nohint"], {}),
    "p5": (("K9",), [], {"PYFFT_TILED_PLANES": 5}),
    "p7": (("K9",), [], {"PYFFT_TILED_PLANES": 7}),
    "p16": (("K9",), [], {"PYFFT_TILED_PLANES": 16}),
    "pct50": (("K9",), ["pct50"], {}),
    "run32": (("K9",), ["run32"], {}),
    "k46notw": (("K6", "K4"), ["k46notw"], {}),
    "k46copy": (("K6", "K4"), ["k46notw", "k46arith", "k46local"], {}),
    "k46local": (("K6", "K4"), ["k46local"], {}),
    "s2": (("K6",), ["s2"], {}),
    "grp1": (("K6",), ["grp1"], {}),
    "grp4": (("K6",), ["grp4"], {}),
    "x8": (("K6",), ["x8"], {}),
    "runs1024": (("K6",), ["runs1024"], {}),
    "x512": (("K6",), ["x512"], {}),
    "r16": (("K4",), ["r16"], {}),
    "k4old": (("K4",), ["k4old"], {}),
    "k4r8": (("K4",), ["k4r8"], {}),
    "k4t512": (("K4",), ["k4t512"], {}),
    "old": (("K1", "K2"), ["old"], {}),
    "oldnotw": (("K1", "K2"), ["old", "oldnotw"], {}),
    "oldcopy": (("K1", "K2"), ["old", "oldnotw", "oldcopy"], {}),
    "rnotw": (("K1", "K2"), ["rnotw"], {}),
    "rcopy": (("K1", "K2"), ["rcopy"], {}),
    "rr8": (("K1", "K2"), ["rr8"], {}),
    "rpad0": (("K1", "K2"), ["rpad0"], {}),
    "rtwd0": (("K1", "K2"), ["rtwd0"], {}),
    "rall": (("K1", "K2"), ["rall"], {}),
    "rs2": (("K1", "K2"), ["rs2"], {}),
    "rs3": (("K1", "K2"), ["rs3"], {}),
    "r8k": (("K1", "K2"), ["r8k"], {}),
    "r2k": (("K1", "K2"), ["r2k"], {}),
    "rbulk": (("K1", "K2"), ["rbulk"], {}),
    "c5old": (("K5", "P5"), ["c5old"], {}),
    "c5oldnotw": (("K5",), ["c5old", "c5oldnotw"], {}),
    "c5oldcopy": (("K5",), ["c5old", "c5oldnotw", "c5oldcopy"], {}),
    "c5notw": (("K5",), ["c5notw"], {}),
    "c5copy": (("K5",), ["c5copy"], {}),
    "c5r8": (("K5",), ["c5r8"], {}),
    "c5twd0": (("K5",), ["c5twd0"], {}),
    "c5s2": (("K5", "P5"), ["c5s2"], {}),
    "c5s1": (("P5",), ["c5s1"], {}),
    "c5s1p": (("P5",), ["c5s1p"], {}),
    "c5s1w": (("P5",), ["c5s1", "c5s1w"], {}),
    "c5xold": (("K5",), ["c5xold"], {}),
    "c5xoldnotw": (("K5",), ["c5xold", "notw"], {}),
    "c5xoldcopy": (("K5",), ["c5xold", "notw", "noarith", "copy"], {}),
    **{v: (("K5",), [v], {}) for v in ("c5xr8", "c5xr8s2", "c5xrs2",
                                        "c5xrb1", "c5xrs3", "c5xrs5")},
    "c5c16": (("K5",), ["c5c16"], {}),
    "c5c16s6": (("K5",), ["c5c16s6"], {}),
    "c5wave": (("K5",), ["c5wave"], {}),
    "k11old": (("K11",), ["k11old"], {}),
    "k11oldnotw": (("K11",), ["k11old", "oldnotw"], {}),
    "k11oldcopy": (("K11",), ["k11old", "oldnotw", "oldcopy"], {}),
    "k11oldtwd0": (("K11",), ["k11old", "k11twd0"], {}),
    "c5n512": (("K5",), ["c5n512"], {}),
    "c5ring512": (("K5",), ["c5ring512"], {}),
    "c5ring8": (("K5",), ["c5ring8"], {}),
    "k11ring": (("K11",), ["k11ring"], {}),
    "k11rnotw": (("K11",), ["rnotw"], {}),
    "k11rcopy": (("K11",), ["rcopy"], {}),
    "k11r8": (("K11",), ["k11r8"], {}),
    "k11rpb4": (("K11",), ["k11rpb4"], {}),
    "k11rpb1": (("K11",), ["k11rpb1"], {}),
    "k11rs2": (("K11",), ["k11rs2"], {}),
    **{v: (("K8",), [v], {}) for v in ("k8old", "k8copy", "k8xonly",
                                        "k8notw", "k8r8", "k8pad0", "k8twd0",
                                        "k8p8k", "k8t8", "k8nobar",
                                        "k8local", "k8rel", "k8pout0")},
}
VARIANTS["full"] = (VARIANTS["full"][0] + ("K8",), [], {})
ALL = ("K12", "K9", "K6", "K4", "K1", "K2", "K5", "K11", "P5", "K8")
# the source each kernel is built from
SOURCE = {"K12": K12, "K9": K9, "K6": K12, "K4": K12, "K1": K1, "K2": K1,
          "K5": K12, "K11": K1, "P5": K12, "K8": K8}


def patched(variant: str, tmp: Path) -> Path:
    """A copy of csrc/ with the variant's steps applied."""
    d = tmp / variant
    shutil.copytree(build.CSRC, d)
    for step in VARIANTS[variant][1]:
        for name, text, new in STEPS[step]:
            f = d / name
            src = f.read_text()
            if src.count(text) != 1:
                raise RuntimeError(f"{variant}: the patch text is not in "
                                   f"{name} once: {text!r}")
            f.write_text(src.replace(text, new))
    return d


def sources(variant: str, kernels) -> set:
    """The sources a variant builds for the kernels timed."""
    return {SOURCE[k] for k in VARIANTS[variant][0] if k in kernels}


def compile_all(tmp: Path, kernels) -> dict:
    """{(variant, source): CDLL} of every variant of the ``kernels`` timed,
    eight nvcc at a time; the full variant's ptxas report kept as
    (variant, source, "log")."""
    out, errors = {}, {}
    slots = threading.Semaphore(8)

    def one(v, name, d):
        with slots:
            flags = [*build.NVCC_FLAGS] + (
                ["-Xptxas", "-v"] if v == "full" or v.startswith(("k8",
                                                                  "c5xr"))
                else [])
            flags += [f"-D{k}={x}" for k, x in VARIANTS[v][2].items()]
            lib = d / f"lib{name}.so"
            res = subprocess.run([build._nvcc(), *flags, "-o", str(lib),
                                  str(d / f"{name}.cu")],
                                 capture_output=True, text=True)
            if res.returncode:
                errors[(v, name)] = res.stderr[-3000:]
                return
            out[(v, name)] = ctypes.CDLL(str(lib))
            out[(v, name, "log")] = res.stderr

    dirs = {v: patched(v, tmp) for v in VARIANTS if sources(v, kernels)}
    threads = [threading.Thread(target=one, args=(v, n, dirs[v]))
               for v in dirs for n in sorted(sources(v, kernels))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"nvcc failed: {errors}")
    return out


# a kernel's mangled name -> its name <template arguments>
KERNEL = re.compile(r"(local_cols_x_kernel|local_cols_xring_kernel|"
                    r"fused2d_tiled_kernel|"
                    r"local_cols_ring_kernel|local_rows_swap_x_kernel|"
                    r"local_rows_ring_kernel|local_cols_pring_kernel|"
                    r"fused2d_ring_kernel|fused2d_kernel)"
                    r"I(\w+?)E(?:EEv|Ev)")


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) of each new kernel in a
    ptxas -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        k = KERNEL.search(name or "")
        if k:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append([f"{k.group(1)}<{k.group(2)}>", int(m.group(1)),
                             spill])
                name = None
    return rows


def cases() -> list:
    """(kernel, name, make): ``make()`` makes the inputs from a seed and
    returns ``run``, which launches one kernel on them."""
    g = torch.Generator(device="cuda").manual_seed(7)
    f64 = torch.float64

    def planes(shape, real):
        return (torch.randn(shape, generator=g, device="cuda", dtype=real),
                torch.randn(shape, generator=g, device="cuda", dtype=real))

    def cols(shape, form, **kw):
        L, n, T = shape
        oshape = (L, T, n) if kw.get("swap_store") else shape
        if form == "planar":
            re, im = planes(shape, f64)
            o = (torch.empty(oshape, device="cuda", dtype=f64),
                 torch.empty(oshape, device="cuda", dtype=f64))
        else:
            v = torch.view_as_real(torch.complex(*planes(shape, f64)))
            re, im = v[..., 0], v[..., 1]
            w = torch.view_as_real(torch.empty(oshape, device="cuda",
                                               dtype=torch.complex128))
            o = (w[..., 0], w[..., 1])
        return lambda: local.fft_axis(re, im, -1, axis=1, out=o, **kw)

    def tiled(shape):
        re, im = planes(shape, torch.float32)
        o = (torch.empty_like(re), torch.empty_like(im))
        return lambda: fused2d.fft2_fused_tiled(re, im, -1, out=o)

    def ctile(shape, c, **kw):
        re, im = planes(shape, torch.float32)
        o = (torch.empty_like(re), torch.empty_like(im))
        return lambda: local.fft_axis(re, im, -1, axis=1, ctile=c, out=o,
                                      **kw)

    def swap(n):
        re, im = planes((8, (1 << 22) // n, n), torch.float32)
        o = (torch.empty((8, n, (1 << 22) // n), device="cuda"),
             torch.empty((8, n, (1 << 22) // n), device="cuda"))
        return lambda: local.fft_rows_swap(re, im, -1, out=o)

    def rows(shape, complex_form=False, real=torch.float32):
        if complex_form:
            v = torch.view_as_real(torch.complex(*planes(shape, real)))
            w = torch.view_as_real(torch.empty(
                shape, device="cuda", dtype=torch.complex128
                if real == f64 else torch.complex64))
            re, im, o = v[..., 0], v[..., 1], (w[..., 0], w[..., 1])
        else:
            re, im = planes(shape, real)
            o = (torch.empty_like(re), torch.empty_like(im))
        return lambda: local.fft_axis(re, im, -1, out=o)

    def cols32(shape, complex_form=False, **kw):
        L, n, T = shape
        oshape = (L, T, n) if kw.get("swap_store") else shape
        if complex_form:
            v = torch.view_as_real(torch.complex(*planes(shape,
                                                         torch.float32)))
            w = torch.view_as_real(torch.empty(oshape, device="cuda",
                                               dtype=torch.complex64))
            re, im, o = v[..., 0], v[..., 1], (w[..., 0], w[..., 1])
        else:
            re, im = planes(shape, torch.float32)
            o = (torch.empty(oshape, device="cuda"),
                 torch.empty(oshape, device="cuda"))
        return lambda: local.fft_axis(re, im, -1, axis=1, out=o, **kw)

    def rows_il(shape):
        v = torch.view_as_real(torch.complex(*planes(
            shape, torch.float32))).flatten(-2)
        vo = torch.empty_like(v)
        return lambda: local.fft_rows_interleaved(v, -1, out=vo)

    def fused(shape, complex_form=False):
        if complex_form:
            v = torch.view_as_real(torch.complex(*planes(shape,
                                                         torch.float32)))
            w = torch.view_as_real(torch.empty(shape, device="cuda",
                                               dtype=torch.complex64))
            re, im, o = v[..., 0], v[..., 1], (w[..., 0], w[..., 1])
        else:
            re, im = planes(shape, torch.float32)
            o = (torch.empty_like(re), torch.empty_like(im))
        return lambda: fused2d.fft2_fused(re, im, -1, out=o)

    full = dict(tw_n=1 << 22, swap_store=True)
    five = (64, 2048, 2048)
    return [
        ("K12", "K12 config 5 pass 1 planar",
         lambda: cols(five, "planar", **full)),
        ("K12", "K12 config 5 pass 2 planar",
         lambda: cols(five, "planar")),
        ("K12", "K12 config 5 pass 1 complex",
         lambda: cols(five, "complex", **full)),
        ("K12", "K12 config 5 pass 2 complex",
         lambda: cols(five, "complex")),
        ("K12", "K12 c128 2D column pass (16, 1024, 1024)",
         lambda: cols((16, 1024, 1024), "planar")),
        ("K9", "K9 config 3 (16 x 1024^2)",
         lambda: tiled((16, 1024, 1024))),
        ("K9", "K9 16 x 512^2",
         lambda: tiled((16, 512, 512))),
    ] + [("K6", f"K6 config 4 z pass (1, 256, 65536) c={c}",
          lambda c=c: ctile((1, 256, 65536), c)) for c in (8, 2, 1)] + [
        ("K6", f"K6 variant B pass 1 (8, 2048, 2048) full c={c}",
         lambda c=c: ctile((8, 2048, 2048), c, tw_n=1 << 22))
        for c in (8, 1)] + [
        ("K6", f"K6 (1, {n}, {(1 << 24) // n}) c={c}",
         lambda n=n, c=c: ctile((1, n, (1 << 24) // n), c))
        for n in (512, 1024) for c in (8, 1)] + [
        ("K4", f"K4 (8, {(1 << 22) // n}, {n})", lambda n=n: swap(n))
        for n in (2048, 1024, 4096, 512)] + [
        ("K1", "K1 config 2 (4096 x 4096)", lambda: rows((4096, 4096))),
        ("K1", "K1 config 2 stride-2 planes (complex form)",
         lambda: rows((4096, 4096), True)),
        ("K2", "K2 config 2i (4096 x 4096 interleaved)",
         lambda: rows_il((4096, 4096))),
        ("K2", "K2 2048 x 8192 interleaved", lambda: rows_il((2048, 8192)))
    ] + [("K1", f"K1 ({(1 << 24) >> k}, {1 << k})",
          lambda k=k: rows(((1 << 24) >> k, 1 << k)))
         for k in range(3, 14) if k != 12] + [
        ("K5", "K5 config 4 z pass (1, 256, 65536)",
         lambda: cols32((1, 256, 65536))),
        ("K5", "K5 config 4 z pass stride-2 planes",
         lambda: cols32((1, 256, 65536), True)),
        ("K5", "K5 config 3 column pass (16, 1024, 1024)",
         lambda: cols32((16, 1024, 1024))),
        ("K5", "K5 config 3 column pass stride-2 planes (complex form)",
         lambda: cols32((16, 1024, 1024), True)),
        ("K5", "K5 config 6+ pass 1 (8, 2048, 2048; full + swap_store)",
         lambda: cols32((8, 2048, 2048), tw_n=1 << 22, swap_store=True)),
        ("K5", "K5 config 6+ pass 2 (8, 2048, 2048)",
         lambda: cols32((8, 2048, 2048))),
        ("K5", "K5 mid pass 2 (2, 128, 131072)",
         lambda: cols32((2, 128, 131072))),
        ("K5", "K5 huge pass 3 (1, 512, 262144)",
         lambda: cols32((1, 512, 262144))),
        ("P5", "P5 K5 config 4 z pass (1, 256, 65536)",
         lambda: cols32((1, 256, 65536))),
        ("P5", "P5 K5 (1, 64, 262144)", lambda: cols32((1, 64, 262144))),
        ("K11", "K11 c128 2D row pass (16384, 1024)",
         lambda: rows((16384, 1024), real=f64)),
        ("K11", "K11 c128 2D row pass complex form",
         lambda: rows((16384, 1024), True, f64)),
        ("K11", "K11 (8192, 2048)", lambda: rows((8192, 2048), real=f64)),
        ("K11", "K11 (4096, 4096)", lambda: rows((4096, 4096), real=f64)),
        ("K8", "K8 config 4 (256 x 256^2)", lambda: fused((256, 256, 256))),
        ("K8", "K8 config 4 stride-2 planes",
         lambda: fused((256, 256, 256), True)),
        ("K8", "K8 1024 x 128^2", lambda: fused((1024, 128, 128))),
        ("K8", "K8 64 x 512^2", lambda: fused((64, 512, 512))),
        ("K8", "K8 64 x 2048 x 128", lambda: fused((64, 2048, 128)))]


# before any use() replaces them
COLS_BINDER = local._cols_lib.__wrapped__
CTILE_BINDER = local._ctile_fn.__wrapped__
SWAP_BINDER = local._rows_swap_fn.__wrapped__
ROWS_BINDER = local._rows_fn.__wrapped__
IL_BINDER = local._rows_il_fn.__wrapped__
FUSED_BINDER = fused2d._lib.__wrapped__
TILED_BINDER = fused2d._tiled_lib.__wrapped__


def use(lib, name: str) -> None:
    """Route the wrappers of source ``name`` to ``lib``."""
    if name == K12:
        typed = {d: ab_parent.bind(lib, COLS_BINDER, d)
                 for d in ab_parent.DTYPES}
        local._cols_lib = lambda d: typed[d]
        ctile = ab_parent.bind(lib, CTILE_BINDER)
        swap = ab_parent.bind(lib, SWAP_BINDER)
        local._ctile_fn = lambda: ctile
        local._rows_swap_fn = lambda: swap
    elif name == K1:
        rows = {d: ab_parent.bind(lib, ROWS_BINDER, d)
                for d in ab_parent.DTYPES}
        il = ab_parent.bind(lib, IL_BINDER)
        local._rows_fn = lambda d: rows[d]
        local._rows_il_fn = lambda: il
    elif name == K8:
        typed = ab_parent.bind(lib, FUSED_BINDER)
        fused2d._lib = lambda: typed
    else:
        typed = ab_parent.bind(lib, TILED_BINDER)
        fused2d._tiled_lib = lambda: typed


def shape_line(lib) -> str:
    """K9's shape at config 3 as the variant builds it."""
    fn = lib.pyfft_fused2d_tiled_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(fused2d.TILED_SHAPE_KEYS))()
    if fn(10, 10, out):
        return "shape query failed"
    return ", ".join(f"{k} {v}" for k, v in zip(fused2d.TILED_SHAPE_KEYS,
                                                out))


def ring_line(lib) -> str:
    """The row ring's shape at n = 4096 as the variant builds it."""
    fn = lib.pyfft_local_rows_ring_shape
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * len(local.ROWS_RING_KEYS))()
    got = fn(12, out)
    if got <= 0:
        return "first design" if got == 0 else f"query failed ({got})"
    return ", ".join(f"{k} {v}" for k, v in zip(local.ROWS_RING_KEYS, out))


def k8_line(lib) -> str:
    """K8's ring at config 4's planes as the variant builds it."""
    fn = lib.pyfft_fused2d_ring_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(fused2d.RING_SHAPE_KEYS))()
    got = fn(8, 8, out)
    if got <= 0:
        return "first design" if got == 0 else f"query failed ({got})"
    return ", ".join(f"{k} {v}" for k, v in zip(fused2d.RING_SHAPE_KEYS,
                                                out))


def main(kernels) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    saved = (local._cols_lib, fused2d._tiled_lib, local._ctile_fn,
             local._rows_swap_fn, local._rows_fn, local._rows_il_fn,
             fused2d._lib)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp), kernels)
        for name in sorted({SOURCE[k] for k in kernels}):
            for kern, regs, spill in ptxas_report(libs[("full", name,
                                                        "log")]):
                print(f"ptxas {kern}: {regs} registers, {spill} bytes "
                      "spilled")
        if ("full", K12) in libs:     # the wrappers' shape queries
            ab_parent.bind(libs[("full", K12)], lambda: [
                f(1 << k) for f in (local.swap_tile, local.ring_shape)
                for k in range(3, 14)])
        if "K9" in kernels:
            for v, (names, _, _) in VARIANTS.items():
                if "K9" in names:
                    print(f"K9 {v} at config 3: "
                          f"{shape_line(libs[(v, K9)])}")
        if "K5" in kernels:
            for v, (names, _, _) in VARIANTS.items():
                if v.startswith("c5xr"):
                    for kern, regs, spill in ptxas_report(
                            libs.get((v, K12, "log"), "")):
                        if kern.startswith("local_cols_xring_kernel<f"):
                            print(f"ptxas {v} {kern}: {regs} registers, "
                                  f"{spill} bytes spilled")
        if "K8" in kernels:
            for v, (names, _, _) in VARIANTS.items():
                if "K8" in names:
                    regs = [f"{r} registers, {sp} bytes spilled"
                            for k, r, sp in ptxas_report(
                                libs.get((v, K8, "log"), ""))
                            if k.startswith("fused2d_ring_kernel<Li8ELi8E")]
                    print(f"K8 {v} at config 4: {k8_line(libs[(v, K8)])}; "
                          f"{', '.join(regs) or 'no ring kernel'}")
        if {"K1", "K2"} & set(kernels):
            for v, (names, _, _) in VARIANTS.items():
                if "K1" in names:
                    print(f"K1 {v} at n = 4096: {ring_line(libs[(v, K1)])}")
        try:
            for kern, name, make in cases():
                if kern not in kernels or (CASES and not any(
                        c in name for c in CASES)):
                    continue
                run = make()
                src = SOURCE[kern]
                order = [v for v, (names, _, _) in VARIANTS.items()
                         if kern in names] + ["full"]
                if kern == "P5":        # two turns, the second reversed
                    order += order[::-1]
                t = {}
                for v in order:
                    use(libs[(v, src)], src)
                    t.setdefault(v, []).append(
                        time_queued_ms(run)[0] if QUEUED else time_ms(run))
                ms = {v: sum(x) / len(x) for v, x in t.items()}
                result[name] = ms
                print(f"{name}: " + ", ".join(f"{v} {x:.4f}"
                                              for v, x in ms.items())
                      + " ms", flush=True)
                torch.cuda.empty_cache()
        finally:
            (local._cols_lib, fused2d._tiled_lib, local._ctile_fn,
             local._rows_swap_fn, local._rows_fn, local._rows_il_fn,
             fused2d._lib) = saved
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "split": result}))
    return 0


# the texts of --cases (every case where empty); --queued
CASES: list = []
QUEUED = False

if __name__ == "__main__":
    args = sys.argv[1:]
    if "--queued" in args:
        QUEUED = True
        args.remove("--queued")
    if "--cases" in args:
        i = args.index("--cases")
        CASES = args[i + 1].split(",")
        del args[i:i + 2]
    if "--only" in args:
        i = args.index("--only")
        keep = {"full", *args[i + 1].split(",")}
        if keep - set(VARIANTS):
            raise SystemExit(f"unknown variants {sorted(keep - set(VARIANTS))}")
        VARIANTS = {v: x for v, x in VARIANTS.items() if v in keep}
        del args[i:i + 2]
    sys.exit(main(args or list(ALL)))
