"""Smoke run of pyfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the package's main paths through ``Plan`` and the functional API on
the card and holds every kernel against its plain torch version and
numpy.fft, in twenty-six phases, one or more lines each:

  1. device: requires CUDA (there is no CPU path) and prints the card's
     name and power limit as nvidia-smi reports them;
  2. build: compiles the row, column, fused 2D, tiled fused 2D and
     de/interleave kernels from this checkout's sources, one nvcc each, all
     at once (the row and column sources hold both precisions, the row
     source the interleaved kernel too, the column source K4 and K6, each
     source its kernels' int8 instantiations), while phases 3 and 4, which
     need the row kernel alone and time nothing, run; its lines follow
     phase 4's, and phase 5 starts when every build has ended;
  3. row kernel: against its plain torch version and numpy.fft for every
     n from 8 to 8192, 1 and 130 rows, forward and inverse with a
     postscale, planar, stride-2 and in-place operands, and on the row
     ring's edges (3 x grid x RPB + 1 rows; rows 16 bytes and one element
     apart, one element off alignment), each launch checked against the
     design it must run (row ring or first design) by the ring's count;
  4. config 2 (batched 1D, 4096 x 4096 complex64) through Plan.execute
     (complex and planar forms, inverse round trip) and fft/ifft, against
     numpy.fft, with each kernel's launch count read around the run (the
     complex form takes the route plan.py gives a single-pass plan);
  5. config 2 timings by CUDA events (median of 20 after warm-up): the row
     kernel, its plain version, the card's copy bandwidth, the bounds and
     cuFFT for context; before timing, the kernel is held against its
     plain version at this shape, planar and complex form;
  6. column kernel: against its plain torch version and numpy for every n
     from 8 to 8192, L = 3 (and L = 1 at n = 8192), T in {128, 384},
     forward and inverse
     with a postscale, in each mode a route uses: plain store (planar,
     stride-2, in place, and planes 4 bytes off 16-byte alignment), full
     twiddle with a plain store and with swap_store, strided twiddle +
     swap_mid, factored twiddle + swap_store; each launch checked against
     the design it must run (the persistent ring from n = 16 to 256 on a
     plain store of planes its tensor maps read, the persistent cluster
     ring at the lengths of PYFFT_XRING_F32_S2 on the complex form's pairs
     with the persistent ring's modes, the cluster tile from 1024, else
     the first design) by the designs' counts, and the rings' and the
     cluster tile's shapes printed; then the cluster ring at config 3's
     column pass (n = 1024 pairs, L = 1, 3 and 16 planes of 1024 columns
     and 16 of a ragged 200, both signs, postscale 0.3, in and out of
     place, no twiddle and the `full` one) against its plain version and
     numpy, and 32 seeds of config 3's pass in place against the plain
     version (its relaxed cluster barrier);
  7. fused 2D kernel: against its plain torch version and numpy for every
     (ny, nx) it takes (both 128 to 2048, at most 2^18 points), 1 and 3
     planes, forward and inverse with a postscale, planar, stride-2 and
     in-place operands;
  8. the multi-pass main paths at full size, each through Plan (complex
     and planar forms, inverse round trip) and the functional API, against
     numpy (complex128), with repr(plan) and an exact launch count per
     kernel: config 6+ (2^22 x 8, four-step), config 3 (1024^2 x 16; its
     four complex-form column passes on K5's cluster ring, the planar one
     on the cluster tile),
     config 4 (256^3: fused 2D, then a column pass), the mid-axis
     four-step (16384 x 1024, batch 2) and the six-step (2^27); then
     every kernel pass of each path is held against its plain version at
     the shape the plan gives it, each pass taking the previous pass's
     output;
  9. timings: the column passes of config 6+, config 3 and the mid route
     and config 4's z pass (each with the design it ran), and config 4's
     fused 2D pass beside the row and column
     passes it replaces: each with its plain version, its bounds and the
     one PyTorch call that computes the same function where there is one;
     each config's Plan.execute beside torch.fft on the same data;
 10. complex128 row kernel K11 (native FP64): as phase 3, for every n
     from 8 to 4096, forward and inverse with postscale 0.3, each launch
     checked against the design it must run (the row ring in FP64 from n
     = 1024, else the first design);
 11. complex128 column kernel K12: as phase 6, for every n from 8 to 4096,
     and where the cluster kernel takes n (1024 to 4096) the twiddled and
     swapped modes and the plain store in place on planar planes too, each
     launch checked against the design it must run (``local.col_design``:
     the persistent cluster ring at the lengths of PYFFT_XRING_F64 on
     planar planes its tensor maps read, in every mode, else the cluster
     tile from n = 1024, else the first design); the ring's shape and the
     clusters the card holds printed;
 12. the complex128 paths through Plan (complex and planar forms, inverse
     round trip) and the functional API, with an exact launch count per
     kernel: config 5 (2^22 x 64, four-step: 2 K12; against numpy on rows
     0, 21, 42 and 63, since each row is an independent transform and
     numpy on all 4 GiB would take the host minutes), config 3's shape in
     complex128 (1024^2 x 16: K11 + K12) and the six-step at 2^25 (3 K12,
     512 MiB); then every kernel pass of each path against its plain
     version at the plan's shapes, chained;
 13. complex128 timings: config 5's two passes with their plain versions,
     bounds (FP64 peak) and torch.fft.fft(dim=-2) for pass 2, the 2D
     path's K11 row pass (with the design it ran) beside torch.fft.fft
     and its K12 column pass, and
     each path's Plan.execute beside torch.fft;
 14. interleaved kernels: the row kernel K2 against its plain version and
     numpy.fft for every n from 8 to 8192, 1 and 130 rows, forward and
     inverse with postscale 0.3, out of place, in place and packed; the
     de/interleave kernels K13 and K14 against their plain versions,
     bit-exact (torch.equal), dense, odd-n and strided, and a round trip;
 15. config 2i (4096 x 4096 complex64, interleaved) through Plan.execute
     (inverse round trip) and fft/ifft under each route, "fused" (K2),
     "stream" (K13, K1, K14) and "planes" (K1), against numpy with an exact
     launch count per kernel; timings of K2, K13 and K14 alone with their
     plain versions, bounds and library calls; the three routes at every n
     from 8 to 8192 (2^24 points each; 64 rows spread over the batch
     against numpy) and "stream" against "planes" at configs 3, 4 and 6+
     (each against numpy); every K2, K13 and K14 call of those runs held
     against its plain version (K13, K14 bit-exact); each route timed in
     three rounds, per-call events beside device time with the host ahead
     and the host's time per call, a winner resolved only where its worst
     round beats every other route's best; the winners printed beside
     plan.py's routes;
 16. the real transforms at full size: rfft/irfft of (4096, 8192) float32
     (whose inner transform is config 2i), rfft2/irfft2 of (16, 1024,
     1024), rfftn/irfftn of 256^3, against numpy.fft.rfft* in float64 with
     exact launch counts and a round trip, and every K2 call of them
     against its plain version; each timed beside torch.fft.rfft* and its
     untangle alone;
 17. the kernels no Plan route takes, each against its plain torch
     version and numpy: K4 (the digit-swapped row pass, fft_rows_swap; a
     cluster a tile of rows from n = 512) for every n from 8 to 8192, n1
     in {128, 200 (lanes 8: ragged tiles), 384}, 3 planes (and 1 at n =
     8192), forward and inverse with postscale 0.3, planar and stride-2
     operands and (128 rows) planes 4 bytes off 16-byte alignment; K6 (the
     column pass over c 128-column tiles, fft_axis(ctile=c); a ring of
     runs, a cluster a step from n = 1024) for every n from 8 to 8192 with
     c in {1, 2, 8}, plain and full-twiddle, in place too, on stride-2 and
     on misaligned planes; K9 (the one-launch 2D DFT up to 2^20 points, fft2_fused_tiled)
     at each of its 28 plane shapes, 1 and 3 planes, both directions,
     planar, stride-2 and in place;
 18. their paths at full size, with exact launch counts and every kernel
     call held against its plain version: the four-step variant B at
     config 6+ (a column pass with the full twiddle, K5 or K6, then K4),
     against numpy on all eight rows, and its inverse, its pass 1 by K6
     timed beside K5's; K6 as config 4's z
     pass after K8, against numpy; K9 on config 3's planes, against numpy
     and Plan's result; each timed beside its plain version, its bound, the
     routed kernels that compute the same and the library call;
 19. K10, the int8-split stage (precision="int8"), inside K1 and K5: the
     stage each int8 row kernel runs (wgmma or mma.sync), as the kernel
     reports it, against local.rows_i8_stage for every (n, f) of the
     chains; K1+K10 at every n from 8 to 8192 (1, 130 and 384 rows, the 384
     spread 2^20 apart from one 128-row tile to the next; planar, stride-2,
     in place; both directions) and K5+K10 at every n (L = 3 with l and
     tiles spread 2^20 apart; T in {128, 384} with a plain store planar and
     in place and the full twiddle, a swapped store at T = 128, a ragged T
     = 200), each against its plain version and numpy per alignment tile,
     with exact launch counts (n = 8 has no matrix stage and runs K1 or
     K5); config 2 through K1+K10 and config 3 through K1+K10 then K5+K10,
     forward and inverse, with exact counts, against numpy and, call by
     call, the plain versions; K1+K10 at config 2 and at n = 8192 (f = 128)
     and K5+K10 at config 3's column pass timed beside the float kernels,
     the plain versions, the bounds and the library call;
 20. K10 inside its other hosts: K4+K10 (fft_rows_swap, f the last factor
     of default_factors: 128 at n = 2048) at every n from 8 to 8192, n1 in
     {128, 384} (the 384 rows spread 2^20 apart by 128-row group), planar
     and stride-2; K8+K10 (fft2_fused) at its 15 plane shapes and K9+K10
     (fft2_fused_tiled) at its 28, 1 and 3 planes 2^20 apart, planar,
     stride-2 and in place; fft_axis_fold (K5+K10 over the native layout)
     at (2, n, 8, x_ext) for every pair fft_axis_fold takes of n in {8,
     256, 1024} and x_ext in {128, 256, 384}, 128-column slices 2^20 apart;
     each in both directions with postscale 0.3, against its plain version
     (precision="int8", JAX's alignment groups) and numpy per group, with
     exact launch counts (n = 8 runs the float kernel); then config 4
     through K8+K10 with the z pass by K5+K10 and again by the fold, config
     3 through K9+K10 and config 6+ variant B through K5+K10 then K4+K10,
     forward and inverse with exact counts, against numpy and, call by
     call, the plain versions; K4+K10, K8+K10 and K9+K10 timed beside their
     float kernels, plain versions, bounds and library calls;
 21. K10 inside K2 (fft_rows_interleaved(precision="int8"), f the last
     factor of default_factors: 128 at n = 2048): K2+K10 at every n from 8
     to 8192, 1, 130 and 384 rows (the 384 spread 2^20 apart by 128-row
     tile), both directions with postscale 0.3, out of place, in place and
     on a view whose rows lie 2n + 16 floats apart, against its plain
     version and numpy per tile with exact launch counts (n = 8 runs K2),
     and the packed form refused; config 2i through K2+K10, forward and
     inverse with exact counts, against numpy and the plain version;
     K2+K10 timed at config 2i (f = 64) and at 2048 x 8192 (f = 128)
     beside K2, K1+K10 on the same view's stride-2 planes, the plain
     version, the bounds and torch.fft.fft;
 22. the distributed FFT (``pyfft_tpu_torch.parallel``): ``warmup`` of
     the shapes below, then one NCCL rank on card 0 and a (1, 1) ("dp",
     "sp") device mesh (a missing NCCL fails); make_dist_fft at config 2
     (K1 on the ring), make_dist_fft2 at config 3 (K1, then K5 on the
     cluster tile), make_dist_fft3 at config 4 (K8, then K5 on the ring)
     and make_dist_fft_df64 at 4096 x 4096 complex128 (K11 on the ring),
     each forward and normalized inverse with exact launch counts,
     against numpy and against the single-card Plan on the same data (at
     s = 1 bit-equal), its forward timed beside Plan.execute with the
     card's name and power limit; the long 1D case (2 x 2^16: the plain
     chain, no kernel) against numpy and timed.  The multi-rank exchange
     is checked on the CPU over gloo (tests/test_torch_dist.py): one card
     holds one NCCL rank;
 23. autotune (``pyfft_tpu_torch.autotune``) into a temporary record
     (``PYFFT_TPU_TORCH_TUNE_FILE``, which points at an empty temporary
     path from the start of the run, so that no other record steers the
     plans): the four-step split at 2^22 (config 6+, 2^25 points a call),
     the complex128 split at 2^22 (config 5, 2^28) and the single-pass
     complex route at 4096 (config 2i), each candidate's time and the
     winner printed; config 6+, config 5, config 2 and config 4 through
     Plans built under the record (each repr showing its split), planar
     and complex, against numpy with exact launch counts; then the record
     removed and reloaded, the splits and route the source's again, and
     each of the five libraries loaded the file its source names
     (``build.library_path``, printed);
 24. the HBM chunk sweep at config 5 (2^22 x 64 complex128): the default
     budget beside the card's memory; unswept, and with the budget pinned
     to give 8 chunks of 8 rows, planar and complex, against numpy on
     rows 0, 21, 42 and 63, the swept results bit-equal to the unswept
     ones with 8 x the two K12 launches, the peak memory above the input
     (``torch.cuda.max_memory_allocated``) within the bound of the plan's
     fudge, and device time with the host ahead both ways;
 25. ``utils/profiling.trace`` around a config 2 ``Plan.execute``: the
     trace file it writes holds K1's ring kernel
     (``local_rows_ring_kernel``) as a CUPTI kernel record, and the
     result holds numpy's.  Phases 23-25 each print their seconds;
 26. config 4's call record (``Plan``'s replay of its recorded launches):
     on two inputs of one layout, both directions, the replayed output
     equals the generic path's (a new plan's first call) bit for bit, on
     the default stream and on a side stream, with the same launches, and
     the registry counts the misses and hits; the host's milliseconds a
     waited call, generic against replayed, for context.

The complex64 checks gate at 2e-6 and the complex128 ones at 1e-11, the
max error over the reference's peak magnitude.  Any failure raises and the
script exits non-zero.  The line before the last is a JSON record of the
kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

TOL = 2e-6          # complex64 gate, max error over peak magnitude
TOL64 = 1e-11       # complex128 gate
N, BATCH = 4096, 4096

# Bounds from the published peaks of one H100 SXM (NVIDIA's data sheet, at
# its 700 W limit): device memory 3.35 TB/s, FP32 outside the tensor cores
# 67 TFLOP/s, FP64 outside the tensor cores 34 TFLOP/s, int8 on the tensor
# cores 1979 TOP/s dense.  The measured copy bandwidth gives a second,
# tighter bound.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP64_S = 34e12
PEAK_INT8_S = 1979e12

SOURCES = ("local_rows", "local_cols", "fused2d", "fused2d_tiled",
           "interleave")
# the kernels, by their C entry's name, and the key of the registry
# (utils/profiling) their launches count under
ENTRY_KERNELS = {"local_rows": "K1", "local_cols": "K5", "fused2d": "K8",
                 "local_rows_f64": "K11", "local_cols_f64": "K12",
                 "local_rows_il": "K2", "deinterleave": "K13",
                 "interleave": "K14", "local_rows_swap": "K4",
                 "local_cols_ctile": "K6", "fused2d_tiled": "K9",
                 "local_rows_i8": "K1+K10", "local_cols_i8": "K5+K10",
                 "local_rows_swap_i8": "K4+K10", "fused2d_i8": "K8+K10",
                 "fused2d_tiled_i8": "K9+K10", "local_rows_il_i8": "K2+K10"}
KERNELS = tuple(ENTRY_KERNELS)

# Launches of one complex-form execute of a 1D plan of one local pass, by
# its interleaved route; the stream route adds K13 and K14 around any plan.
ROUTE_COUNTS = {"fused": {"local_rows_il": 1},
                "stream": {"deinterleave": 1, "local_rows": 1,
                           "interleave": 1},
                "planes": {"local_rows": 1}}
STREAM_EXTRA = {"deinterleave": 1, "interleave": 1}
ROUTES = ("fused", "stream", "planes")


def rel_err(got, ref) -> float:
    """Max error over the reference's peak magnitude.  Tensors are
    compared on their device in complex128, numpy arrays on the host."""
    if isinstance(got, torch.Tensor) or isinstance(ref, torch.Tensor):
        dev = got.device if isinstance(got, torch.Tensor) else ref.device
        g = torch.as_tensor(got, device=dev).to(torch.complex128)
        r = torch.as_tensor(ref, device=dev).to(torch.complex128)
        return float((g - r).abs().max() / r.abs().max())
    got = np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(name: str, err: float, tol: float = TOL) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


def to_np(re, im=None):
    if im is None:
        return re.cpu().numpy()
    return re.cpu().numpy() + 1j * im.cpu().numpy()


def cplx(re, im):
    return torch.complex(re, im)


def count_of(*keys) -> int:
    """The launches the registry (``utils/profiling``) holds under
    ``keys`` since the last reset: ``launch.K1`` is every K1 launch,
    ``launch.K1.ring`` those whose C entry reported the ring."""
    from pyfft_tpu_torch.utils import profiling
    return sum(profiling.total(k) for k in keys)


def reset_counts():
    from pyfft_tpu_torch.utils import profiling
    profiling.reset()


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {entry: count_of(f"launch.{k}")
            for entry, k in ENTRY_KERNELS.items()}


def design_counts() -> dict:
    """Of the launches counted since the last reset, those that ran each
    redesign, as the C entries report it: the row ring (K1 and K2; K11 on
    double planes), K5's persistent column ring and cluster tile, K12's
    cluster tile and persistent cluster ring and K8's plane ring."""
    return {"row ring": count_of("launch.K1.ring", "launch.K2.ring"),
            "row ring f64": count_of("launch.K11.ring"),
            "column ring": count_of("launch.K5.pring"),
            "column cluster tile": count_of("launch.K5.x"),
            "column cluster ring": count_of("launch.K5.xring"),
            "column cluster tile f64": count_of("launch.K12.x"),
            "column cluster ring f64": count_of("launch.K12.ring"),
            "plane ring": count_of("launch.K8.ring")}


# Every float K8 launch of the run, by the design it ran, and those that
# ran another design than its table names (watch_k8_designs).
K8_DESIGNS = {"ring": 0, "first": 0, "wrong": []}


def watch_k8_designs() -> None:
    """Hold every float K8 launch of the run's generic path, whatever
    phase makes it (a plan's replay calls the same entry with the same
    arguments as the call it recorded), against the design its table
    names (``fused2d.design``: the plane ring
    on the shapes of PYFFT_FUSED2D_RING and planes its tensor maps read,
    else the first design), by the ring's launch count; main() fails at
    the end on any launch that ran the other."""
    from pyfft_tpu_torch.ops import fused2d
    launch = fused2d._launch

    def watched(re, im, out_re, out_im, sign, postscale, int8=False):
        if int8:
            return launch(re, im, out_re, out_im, sign, postscale, int8)
        want = fused2d.design(re, im)
        ring0, all0 = count_of("launch.K8.ring"), count_of("launch.K8")
        got = launch(re, im, out_re, out_im, sign, postscale, int8)
        if count_of("launch.K8") != all0:
            ran = "ring" if count_of("launch.K8.ring") != ring0 else "first"
            K8_DESIGNS[ran] += 1
            if ran != want:
                K8_DESIGNS["wrong"].append(
                    (tuple(re.shape), re.stride(), want, ran))
        return got

    fused2d._launch = watched


def expect(*parts) -> dict:
    """The launch counts of a run: the sum of its {kernel: count} parts,
    every other kernel 0."""
    want = dict.fromkeys(KERNELS, 0)
    for part in parts:
        for k, v in part.items():
            want[k] += v
    return want


def route_counts(plan) -> dict:
    """Launches of one complex-form execute of ``plan`` beyond its planar
    passes' (the 1D local plans: all of them)."""
    route = plan.il_route()
    passes = plan._exec_plan.passes
    if len(passes) == 1 and passes[0].executor == "local":
        return ROUTE_COUNTS[route]
    return STREAM_EXTRA if route == "stream" else {}


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_S,
          int8_ops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    with the operations at ``peak_flops`` (PEAK_FP64_S for complex128) and
    any int8 operations at PEAK_INT8_S, the larger of those two times."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = max(flops / peak_flops, int8_ops / PEAK_INT8_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fft_flops(n: int, count: int) -> float:
    return 5.0 * n * math.log2(n) * count


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run has no CPU path")
    print(card())
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


def phase_build():
    """Start one nvcc for each source, all at once, and return a function
    that waits for them all, raises if any failed and prints phase 2's
    lines.  Meanwhile the first phases run on the row kernel, whose
    source builds first: a phase that needs a library still building
    waits for it in ``build.load``."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch.ops import build
    here = Path(__file__).resolve().parent
    if Path(pyfft_tpu_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError("pyfft_tpu_torch was not imported from this "
                           "checkout")
    t0 = time.perf_counter()
    errors: dict = {}
    took: dict = {}

    def one(name):
        try:
            build.load(name)
            took[name] = time.perf_counter() - t0
        except Exception as e:          # reraised below, in this thread
            errors[name] = e

    threads = [threading.Thread(target=one, args=(k,)) for k in SOURCES]
    for t in threads:
        t.start()

    def finish():
        for t in threads:
            t.join()
        for name, e in errors.items():
            raise RuntimeError(f"building {name}.cu failed") from e
        for name in SOURCES:
            print(f"phase 2 build: {name}.cu built and loaded in "
                  f"{took[name]:.2f} s -> {build.library_path(name)}")

    return finish


# The two precisions' kernel checks: the complex dtype, the gate, the
# largest log2 n the kernels take, and the phase numbers of the row and
# column kernel checks.
PRECISIONS = {
    "complex64": dict(dtype=np.complex64, tol=TOL, max_log=13,
                      phases=(3, 6)),
    "complex128": dict(dtype=np.complex128, tol=TOL64, max_log=12,
                       phases=(10, 11)),
}


def posts(prec: str, n: int):
    """(sign, postscale) cases: complex64 forward by 0.5 and inverse by
    1/n; complex128 both directions by 0.3, a scale no float32 rounding
    keeps."""
    if prec == "complex128":
        return ((-1, 0.3), (+1, 0.3))
    return ((-1, 0.5), (+1, 1.0 / n))


def phase_kernel(prec: str = "complex64"):
    from pyfft_tpu_torch.ops import local
    spec = PRECISIONS[prec]
    tol, phase = spec["tol"], spec["phases"][0]
    rng = np.random.RandomState(1)
    for n in (1 << p for p in range(3, spec["max_log"] + 1)):
        worst_plain = worst_np = 0.0
        cases = 0
        for rows in (1, 130):
            x = (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n))).astype(spec["dtype"])
            for sign, post in posts(prec, n):
                ref = (np.fft.fft(x.astype(np.complex128)) if sign < 0
                       else np.fft.ifft(x.astype(np.complex128)) * n) * post
                xc = torch.from_numpy(x).cuda()
                plain = to_np(*local.fft_rows_plain(
                    xc.real.contiguous(), xc.imag.contiguous(), sign, post))
                for mode in ("planar", "stride2", "inplace"):
                    if mode == "planar":
                        re, im = xc.real.contiguous(), xc.imag.contiguous()
                        out = None
                    else:
                        v = torch.view_as_real(xc.clone())
                        re, im = v[..., 0], v[..., 1]
                        out = (re, im) if mode == "inplace" else None
                    rr, ii = local.fft_axis(re, im, sign, postscale=post,
                                            out=out)
                    torch.cuda.synchronize()
                    if mode == "inplace" and rr.data_ptr() != re.data_ptr():
                        raise AssertionError("in-place launch wrote elsewhere")
                    got = to_np(rr, ii)
                    e_plain, e_np = rel_err(got, plain), rel_err(got, ref)
                    tag = f"{prec} n={n} rows={rows} sign={sign} {mode}"
                    check(f"kernel vs plain {tag}", e_plain, tol)
                    check(f"kernel vs numpy {tag}", e_np, tol)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        print(f"phase {phase} {prec} row kernel n={n}: {cases} cases, max "
              f"rel err vs plain {worst_plain:.3e}, vs numpy "
              f"{worst_np:.3e} (gate {tol:.0e})")
        ring_rows_cases(n, rng, prec)


def ring_wave_rows(n: int, dtype=torch.float32) -> tuple[int, dict | None]:
    """3 x grid x RPB + 1 rows at length n: every block of the row ring's
    persistent grid walks three row blocks and one walks a fourth, ragged
    one (the first design: 3 x 132 blocks + 1), with the ring's shape."""
    from pyfft_tpu_torch.ops import local
    shape = local.rows_ring_shape(n, dtype)
    if shape is None:
        return 3 * 132 * max(1, 512 // n) + 1, None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 3 * sms * shape["blocks_per_sm"] * shape["rows"] + 1, shape


# the layouts of ring_rows_cases and ring_il_cases that the row ring's bulk
# copies read as they lie (16-byte aligned, rows 16 bytes apart); the
# others (rows 4 or 8 bytes apart, views off 16-byte alignment) run the
# first design
RING_MODES = ("planar", "stride2", "inplace", "out", "padded 16")


def ring_expected(n: int, mode: str, dtype=torch.float32) -> bool:
    """Whether K1 or K2 (K11 on float64) must run the row ring on
    ``mode``'s layout at length n: the length in the ring's table and a
    layout of RING_MODES.  The ring's launches are counted from what the C
    entry reports it ran."""
    from pyfft_tpu_torch.ops import local
    return (local.rows_ring_shape(n, dtype) is not None
            and mode in RING_MODES)


def padded_rows(x: torch.Tensor, pad: int, lead: int = 0) -> torch.Tensor:
    """x's (rows, m) values in a buffer with rows m + pad apart, starting
    ``lead`` elements in."""
    rows, m = x.shape
    buf = torch.zeros(rows * (m + pad) + lead, device=x.device,
                      dtype=x.dtype)
    view = buf[lead:].view(rows, m + pad)[:, :m]
    view.copy_(x)
    return view


def ring_rows_cases(n: int, rng, prec: str = "complex64"):
    """K1 (K11 for complex128) on the row ring's edges at length n: a row
    count that walks every persistent block three times and ends ragged,
    planar, on stride-2 planes, in place, with rows padded apart by 16
    bytes (the ring) and by one element, 4 or 8 bytes (the first design),
    and on planes one element off 16-byte alignment (the first design),
    against the plain version and numpy; each launch checked against the
    design it must run by the ring's count."""
    from pyfft_tpu_torch.ops import local
    spec = PRECISIONS[prec]
    f64 = prec == "complex128"
    real = torch.float64 if f64 else torch.float32
    rows, shape = ring_wave_rows(n, real)
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(spec["dtype"])
    xc = torch.from_numpy(x).cuda()
    worst_plain = worst_np = 0.0
    took = []
    elem = 8 if f64 else 4              # bytes of a real
    one = f"{elem}"
    count = (("launch.K11", "launch.K11.ring") if f64 else
             ("launch.K1", "launch.K1.ring"))
    for sign, post in posts(prec, n):
        ref = torch.from_numpy(
            (np.fft.fft(x.astype(np.complex128)) if sign < 0
             else np.fft.ifft(x.astype(np.complex128)) * n) * post).cuda()
        plain = cplx(*local.fft_rows_plain(xc.real.contiguous(),
                                           xc.imag.contiguous(), sign, post))
        for mode in ("planar", "stride2", "inplace", "padded 16",
                     "padded " + one, "offset " + one):
            out = None
            if mode == "planar":
                re, im = xc.real.contiguous(), xc.imag.contiguous()
            elif mode in ("stride2", "inplace"):
                v = torch.view_as_real(xc.clone())
                re, im = v[..., 0], v[..., 1]
                out = (re, im) if mode == "inplace" else None
            else:
                pad, lead = {"padded 16": (16 // elem, 0),
                             "padded " + one: (1, 0),
                             "offset " + one: (0, 1)}[mode]
                re, im = (padded_rows(t.contiguous(), pad, lead)
                          for t in (xc.real, xc.imag))
            takes = ring_expected(n, mode, real)
            before = tuple(count_of(c) for c in count)
            rr, ii = local.fft_axis(re, im, sign, postscale=post, out=out)
            torch.cuda.synchronize()
            got = tuple(count_of(c) - b for c, b in zip(count, before))
            if got != (1, int(takes)):
                raise AssertionError(f"{prec} n={n} {mode}: (kernel, ring) "
                                     f"launches {got}, expected "
                                     f"(1, {int(takes)})")
            if mode == "inplace" and rr.data_ptr() != re.data_ptr():
                raise AssertionError("in-place launch wrote elsewhere")
            got = cplx(rr, ii)
            e_plain, e_np = rel_err(got, plain), rel_err(got, ref)
            tag = f"{prec} n={n} rows={rows} sign={sign} {mode}"
            check(f"ring kernel vs plain {tag}", e_plain, spec["tol"])
            check(f"ring kernel vs numpy {tag}", e_np, spec["tol"])
            worst_plain = max(worst_plain, e_plain)
            worst_np = max(worst_np, e_np)
            if sign < 0:
                took.append(f"{mode} {'ring' if takes else 'first design'}")
    del xc, plain, ref
    torch.cuda.empty_cache()
    print(f"phase {spec['phases'][0]} {prec} row kernel n={n}, {rows} rows "
          f"({shape or 'the first design'}): {', '.join(took)}; max rel "
          f"err vs plain {worst_plain:.3e}, vs numpy {worst_np:.3e} (gate "
          f"{spec['tol']:.0e})")


def phase_main_path():
    import pyfft_tpu_torch
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((BATCH, N))
         + 1j * rng.standard_normal((BATCH, N))).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128))
    xt = torch.from_numpy(x).cuda()
    re, im = xt.real.contiguous(), xt.imag.contiguous()
    torch.cuda.synchronize()

    plan = pyfft_tpu_torch.Plan((N,), device="cuda")
    kinds = [p.executor for p in plan._exec_plan.passes]
    if kinds != ["local"]:
        raise AssertionError(f"config 2 plan is {plan!r}, not one local pass")

    reset_counts()
    y = plan.execute(xt)
    rr, ii = plan.execute(re, im)
    back = plan.execute(y, inverse=True)
    yf = pyfft_tpu_torch.fft(xt)
    yb = pyfft_tpu_torch.ifft(yf)
    counts = read_counts()
    ring = count_of("launch.K1.ring", "launch.K2.ring")

    errs = {"complex": rel_err(to_np(y), ref),
            "planar": rel_err(to_np(rr, ii), ref),
            "roundtrip": rel_err(to_np(back), x),
            "fft": rel_err(to_np(yf), ref),
            "ifft(fft)": rel_err(to_np(yb), x)}
    for k, e in errs.items():
        check(f"config 2 {k}", e)
    want = expect({"local_rows": 1}, *[route_counts(plan)] * 4)
    if counts != want:
        raise AssertionError(f"config 2 made launches {counts}, expected "
                             f"{want} (complex form: {plan.il_route()})")
    if ring != counts["local_rows"] + counts["local_rows_il"]:
        raise AssertionError(f"config 2: {ring} of its K1 and K2 launches "
                             "ran the row ring, expected all")
    print(f"phase 4 main path: {plan!r}, complex form by the "
          f"{plan.il_route()!r} route, launches "
          f"{ {k: v for k, v in counts.items() if v} } (all on the row "
          f"ring), "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (gate {TOL:.0e})")
    return xt, re, im, counts


def phase_timings(xt, re, im):
    from pyfft_tpu_torch.ops import local
    from pyfft_tpu_torch.utils.profiling import (copy_bandwidth_gbs,
                                                 effective_gflops, time_ms)
    out = (torch.empty_like(re), torch.empty_like(im))
    xv = torch.view_as_real(xt)
    yv = torch.view_as_real(torch.empty_like(xt))

    def kernel():
        local.fft_axis(re, im, -1, out=out)

    def kernel_complex():
        local.fft_axis(xv[..., 0], xv[..., 1], -1,
                       out=(yv[..., 0], yv[..., 1]))

    def plain():
        local.fft_rows_plain(re, im, -1)

    def cufft():
        torch.fft.fft(xt)

    # Gate the kernel against its plain version at the main path's shape
    # (4096 rows of 4096), in both operand layouts, before timing it.
    kernel()
    kernel_complex()
    pr, pi = local.fft_rows_plain(re, im, -1)
    torch.cuda.synchronize()
    plain_np = to_np(pr, pi)
    max_abs = float(torch.maximum((out[0] - pr).abs().max(),
                                  (out[1] - pi).abs().max()))
    err = rel_err(to_np(*out), plain_np)
    err_complex = rel_err(to_np(yv[..., 0], yv[..., 1]), plain_np)
    check("config 2 kernel vs plain, planar", err)
    check("config 2 kernel vs plain, complex form", err_complex)
    ms = time_ms(kernel)
    ms_complex = time_ms(kernel_complex)
    plain_ms = time_ms(plain)
    cufft_ms = time_ms(cufft)
    bw = copy_bandwidth_gbs(256)
    moved = 2 * BATCH * N * 8                 # one read and one write
    roof_ms = moved / (bw * 1e9) * 1e3
    bound_ms, bound_by = bound(moved, fft_flops(N, BATCH))
    gf = effective_gflops(N, BATCH, ms * 1e-3)
    ring = local.rows_ring_shape(N)
    print(f"phase 5 row ring at n={N}: {ring['slots']} slots of "
          f"{ring['rows']} row(s), {ring['threads']} threads, "
          f"{ring['blocks_per_sm']} blocks an SM, {ring['smem_bytes']} "
          "bytes of shared memory a block")
    print(f"phase 5 timings: kernel planar {ms:.4f} ms = {gf:.1f} GFLOP/s, "
          f"kernel complex form {ms_complex:.4f} ms = "
          f"{effective_gflops(N, BATCH, ms_complex * 1e-3):.1f} GFLOP/s, "
          f"plain torch {plain_ms:.4f} ms, "
          f"copy bandwidth {bw:.1f} GB/s -> single-pass roofline "
          f"{roof_ms:.4f} ms, kernel at {roof_ms / ms:.3f} of it; "
          f"bound at the published peaks {bound_ms:.4f} ms ({bound_by}); "
          f"library cuFFT (torch.fft.fft, context only) {cufft_ms:.4f} ms; "
          f"kernel vs plain max abs err {max_abs:.3e}, max rel err "
          f"{err:.3e} planar, {err_complex:.3e} complex form "
          f"(gate {TOL:.0e})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs,
            "max_rel_err": max(err, err_complex), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": cufft_ms,
            "copy_bound_ms": roof_ms, "copy_gbs": bw}


# ------------------------------------------------------ the column kernel

COL_MODES = ("plain planar", "plain stride2", "plain inplace",
             "plain offset", "full plain", "full swap_store",
             "strided swap_mid", "factored swap_store")
# the twiddled and swapped modes on planar planes too where the complex128
# cluster kernel takes n: its planar table is another instance than the
# stride-2 planes' one
COL_MODES_PLANAR = ("full swap_store planar", "strided swap_mid planar",
                    "factored swap_store planar", "full plain planar",
                    "plain inplace planar")


def col_reference(X, n, T, mode, sign, post):
    """numpy complex128: the spectra X (L, n, T) with the mode's twiddle,
    postscale and store."""
    k = np.arange(n, dtype=np.int64)[:, None]
    t = np.arange(T, dtype=np.int64)[None, :]
    L = X.shape[0]
    if mode.startswith("full") or mode.startswith("factored"):
        tw_n, g = n * T, t
    elif mode.startswith("strided"):
        tw_n, g = n * (T // 128), t // 128
    else:
        tw_n, g = 0, None
    if tw_n:
        X = X * np.exp(sign * 2j * np.pi * ((k * g) % tw_n) / tw_n)
    X = X * post
    if "swap_store" in mode:
        X = X.transpose(0, 2, 1)
    elif "swap_mid" in mode:
        X = X.reshape(L, n, T // 128, 128).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(X), tw_n


def col_kwargs(mode, tw_n):
    if mode.startswith("full"):
        return dict(tw_n=tw_n, swap_store="swap_store" in mode)
    if mode.startswith("strided"):
        return dict(tw_n=tw_n, tw_mode="strided", tw_period=128,
                    swap_mid=128)
    if mode.startswith("factored"):
        return dict(tw_n=tw_n, tw_mode="factored", swap_store=True)
    return {}


def offset_plane(t: torch.Tensor) -> torch.Tensor:
    """t's values in a plane one element off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# the column pass's designs, by the registry's keys of their launches
COL_DESIGN_COUNTS = {"ring": ("launch.K5.pring", "launch.K12.ring"),
                     "xring": ("launch.K5.xring",),
                     "x": ("launch.K5.x", "launch.K12.x")}


def phase_cols_kernel(prec: str = "complex64"):
    """The column kernel at every n and mode (COL_MODES: planar, stride-2,
    in place and one element off alignment with a plain store, the `full`
    twiddle with a plain and a swapped store, the mid and huge routes'
    modes) against its plain version and numpy; each launch checked
    against the design it must run (``local.col_design``: for complex64
    the persistent cluster ring at the lengths of PYFFT_XRING_F32_S2 on
    the complex form's pairs with the persistent ring's modes, the cluster
    tile from n = 1024, the persistent ring from 16 to 256 on a plain
    store of planes its tensor maps read, else the first design;
    for complex128 K12's persistent cluster ring at its table's lengths on
    planar planes its tensor maps read, else the cluster tile from n =
    1024, else the first design) by the designs' counts."""
    from pyfft_tpu_torch.ops import local
    spec = PRECISIONS[prec]
    tol, phase = spec["tol"], spec["phases"][1]
    rng = np.random.RandomState(6)
    for n in (1 << p for p in range(3, spec["max_log"] + 1)):
        worst_plain = worst_np = 0.0
        cases = 0
        designs = {}
        modes = COL_MODES
        if prec == "complex128" and local.col_xshape_f64(n):
            modes += COL_MODES_PLANAR
        # one plane only at the largest n; elsewhere l = 0 of three
        for L in ((1, 3) if n == 1 << spec["max_log"] else (3,)):
            for T in (128, 384):
                x = (rng.standard_normal((L, n, T))
                     + 1j * rng.standard_normal((L, n, T))
                     ).astype(spec["dtype"])
                xc = torch.from_numpy(x).cuda()
                for sign, post in posts(prec, n):
                    X = np.fft.fft(x.astype(np.complex128), axis=1)
                    if sign > 0:
                        X = np.fft.ifft(x.astype(np.complex128), axis=1) * n
                    for mode in modes:
                        ref, tw_n = col_reference(X, n, T, mode, sign, post)
                        kw = col_kwargs(mode, tw_n)
                        out = None
                        if mode.endswith("planar"):
                            re, im = (xc.real.contiguous(),
                                      xc.imag.contiguous())
                            if mode == "plain inplace planar":
                                out = (re, im)
                        elif mode == "plain offset":
                            re, im = (offset_plane(xc.real.contiguous()),
                                      offset_plane(xc.imag.contiguous()))
                        else:           # the complex form's planes
                            v = torch.view_as_real(xc.clone())
                            re, im = v[..., 0], v[..., 1]
                            if mode == "plain inplace":
                                out = (re, im)
                        want = local.col_design(
                            n, re.dtype, boxable=local._boxable(re, im),
                            in_ts=re.stride(2), T=T,
                            tw_mode=kw.get("tw_mode", "full"),
                            tw_n=kw.get("tw_n", 0),
                            swap_store=kw.get("swap_store", False),
                            swap_mid=kw.get("swap_mid", 0))
                        before = {d: count_of(*c)
                                  for d, c in COL_DESIGN_COUNTS.items()}
                        rr, ii = local.fft_axis(re, im, sign, axis=1,
                                                postscale=post, out=out,
                                                **kw)
                        torch.cuda.synchronize()
                        ran = [d for d, c in COL_DESIGN_COUNTS.items()
                               if count_of(*c) != before[d]]
                        ran = ran[0] if ran else "first"
                        if ran != want:
                            raise AssertionError(
                                f"column pass n={n} T={T} {mode}: ran the "
                                f"{ran} design, expected {want}")
                        designs[f"{mode}: {want}"] = None
                        if out is not None and rr.data_ptr() != re.data_ptr():
                            raise AssertionError("in-place column launch "
                                                 "wrote elsewhere")
                        pr, pi = local.fft_cols_plain(
                            xc.real.contiguous(), xc.imag.contiguous(), sign,
                            postscale=post, **kw)
                        got = cplx(rr, ii)
                        e_plain = rel_err(got, cplx(pr, pi))
                        e_np = rel_err(got, torch.from_numpy(ref).cuda())
                        tag = (f"{prec} n={n} L={L} T={T} sign={sign} "
                               f"{mode}")
                        check(f"column kernel vs plain {tag}", e_plain, tol)
                        check(f"column kernel vs numpy {tag}", e_np, tol)
                        worst_plain = max(worst_plain, e_plain)
                        worst_np = max(worst_np, e_np)
                        cases += 1
        width = local.col_width(n, xc.real.dtype)
        print(f"phase {phase} {prec} column kernel n={n} (C={width} columns "
              f"a tile on planar planes with a plain store): {cases} cases, "
              f"designs (by their counts): "
              f"{', '.join(designs)}; max rel err vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate {tol:.0e})")
        ring = (local.col_ring_shape(n) if prec == "complex64"
                and n in local.COL_RING_LENGTHS else None)
        if ring:
            print(f"phase {phase} complex64 persistent column ring n={n}: "
                  f"tiles of {ring['columns']} columns, {ring['threads']} "
                  f"threads, {ring['slots']} slots, {ring['smem_bytes']} "
                  f"bytes a block, {ring['blocks_per_sm']} blocks an SM")
        xring = (local.col_xring_shape_f64(n) if prec == "complex128"
                 and n in local.COL_XRING_F64_LENGTHS else
                 local.col_xring_shape(n) if prec == "complex64"
                 and n in local.COL_XRING_F32_S2_LENGTHS else None)
        if xring:
            print(f"phase {phase} {prec} persistent cluster ring n={n} on "
                  f"{'planar planes' if prec == 'complex128' else 'pairs'}"
                  f": a cluster of {xring['cluster']} "
                  f"blocks a tile of {xring['columns']} columns, "
                  f"{xring['slots']} slots, {xring['threads']} threads, "
                  f"{xring['smem_bytes']} bytes a block; clusters the card "
                  f"holds at once (the grid): {xring['clusters_held']}")
        for strided in (False, True):
            xs = local.col_xshape_f64(n, strided, xc.real.dtype)
            if xs:
                print(f"phase {phase} {prec} cluster column kernel n={n}"
                      f" on {'stride-2' if strided else 'planar'} planes: "
                      f"(G, C) = ({xs['cluster']}, {xs['columns']}), a tile "
                      f"of {xs['columns']} columns over a cluster of "
                      f"{xs['cluster']} blocks, registers for "
                      f"{xs['blocks_an_sm']} blocks an SM; clusters the card "
                      f"holds at once: {xs['clusters_plain']} (plain store),"
                      f" {xs['clusters_swap']} (swapped store)")


def phase_cols_xring():
    """Phase 6's last lines: K5's persistent cluster ring at config 3's
    column pass (n = 1024 on the complex form's pairs): L = 1, 3 and 16
    planes of T = 1024 columns and 16 of a ragged 200, both signs,
    postscale 0.3, out of place and in place, no twiddle and the `full`
    one, each launch on the ring (``launch.K5.xring``) and within the gate
    of its plain version and of numpy; then 32 seeds of config 3's pass
    in place, each against its plain version, over the ring's relaxed
    cluster barrier (the reads of a receive buffer retired before the
    arrive that lets its senders reuse it)."""
    from pyfft_tpu_torch.ops import local
    n = 1024
    rng = np.random.RandomState(61)
    worst_plain = worst_np = 0.0
    cases = 0
    for L, T in ((1, 1024), (3, 1024), (16, 1024), (16, 200)):
        x = (rng.standard_normal((L, n, T))
             + 1j * rng.standard_normal((L, n, T))).astype(np.complex64)
        xc = torch.from_numpy(x).cuda()
        for sign in (-1, 1):
            X = (np.fft.fft(x.astype(np.complex128), axis=1) if sign < 0
                 else np.fft.ifft(x.astype(np.complex128), axis=1) * n)
            for mode in ("plain stride2", "full plain"):
                ref, tw_n = col_reference(X, n, T, mode, sign, 0.3)
                kw = col_kwargs(mode, tw_n)
                pr, pi = local.fft_cols_plain(xc.real.contiguous(),
                                              xc.imag.contiguous(), sign,
                                              postscale=0.3, **kw)
                want = torch.from_numpy(ref).cuda()
                for inplace in (False, True):
                    v = torch.view_as_real(xc.clone())
                    re, im = v[..., 0], v[..., 1]
                    out = (re, im) if inplace else None
                    before = count_of("launch.K5.xring")
                    rr, ii = local.fft_axis(re, im, sign, axis=1,
                                            postscale=0.3, out=out, **kw)
                    torch.cuda.synchronize()
                    if count_of("launch.K5.xring") != before + 1:
                        raise AssertionError(
                            f"phase 6 cluster ring L={L} T={T} {mode}: "
                            "the pass ran another design")
                    got = cplx(rr, ii)
                    e_plain = rel_err(got, cplx(pr, pi))
                    e_np = rel_err(got, want)
                    tag = (f"L={L} T={T} sign={sign} {mode} "
                           f"{'in place' if inplace else 'out of place'}")
                    check(f"cluster ring vs plain {tag}", e_plain)
                    check(f"cluster ring vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
                del pr, pi, want
        del xc
    worst = 0.0
    for seed in range(32):
        x = make_data((16, n, n), 6100 + seed)
        pr, pi = local.fft_cols_plain(x.real.contiguous(),
                                      x.imag.contiguous(), -1)
        v = torch.view_as_real(x)
        before = count_of("launch.K5.xring")
        local.fft_axis(v[..., 0], v[..., 1], -1, axis=1,
                       out=(v[..., 0], v[..., 1]))
        torch.cuda.synchronize()
        if count_of("launch.K5.xring") != before + 1:
            raise AssertionError("phase 6 cluster ring stress: the pass ran "
                                 "another design")
        e = rel_err(x, cplx(pr, pi))
        check(f"cluster ring config 3 in place seed {seed} vs plain", e)
        worst = max(worst, e)
        del x, pr, pi, v
    torch.cuda.empty_cache()
    print(f"phase 6 complex64 persistent cluster ring at config 3's column "
          f"pass (n = 1024, the complex form's pairs): {cases} cases, max "
          f"rel err vs plain {worst_plain:.3e}, vs numpy {worst_np:.3e}; 32 "
          f"seeds of (16, 1024, 1024) in place vs plain: max rel err "
          f"{worst:.3e} (gate {TOL:.0e})")


# ------------------------------------------------- the fused 2D kernel

FUSED_SHAPES = [(1 << a, 1 << b) for a in range(7, 12) for b in range(7, 12)
                if a + b <= 18]


def phase_fused_kernel():
    """K8 at each of its 15 plane shapes, L = 1 and 3, both signs, on
    planar planes, the complex form's stride-2 planes, in place on them and
    on planes one float off 16-byte alignment, against its plain version
    and numpy; at the ring's shapes also L = 4 * clusters held + 1 (the
    first cluster walks five planes, the others four: every slot refilled,
    its barrier waited at both parities and back, `landed` reused at each
    plane) on planar and stride-2 planes and in place; each launch
    held against the design its table names (``fused2d.design``) by the
    ring's launch count, and each shape's clusters and the ring's shape
    printed."""
    from pyfft_tpu_torch.ops import fused2d
    rng = np.random.RandomState(7)
    for ny, nx in FUSED_SHAPES:
        worst_plain = worst_np = 0.0
        cases = 0
        ran = {"ring": 0, "first": 0}
        shape = fused2d.ring_shape(ny, nx)
        if (shape is None) != ((ny, nx) not in fused2d.RING_SHAPES):
            raise AssertionError(f"fused kernel {ny}x{nx}: ring shape "
                                 f"{shape} against the table")
        walk = () if shape is None else (4 * shape["clusters_held"] + 1,)
        for L in (1, 3) + walk:
            x = (rng.standard_normal((L, ny, nx))
                 + 1j * rng.standard_normal((L, ny, nx))).astype(np.complex64)
            xc = torch.from_numpy(x).cuda()
            x128 = x.astype(np.complex128)
            for sign, post in ((-1, 0.5), (+1, 1.0 / (ny * nx))):
                X = (np.fft.fft2(x128) if sign < 0
                     else np.fft.ifft2(x128) * (ny * nx))
                ref = torch.from_numpy(X * post).cuda()
                pr, pi = fused2d.fft2_plain(xc.real.contiguous(),
                                            xc.imag.contiguous(), sign, post)
                for mode in ("planar", "stride2", "inplace", "offset"):
                    if L > 3 and mode == "offset":
                        continue
                    out = None
                    if mode == "planar":
                        re, im = xc.real.contiguous(), xc.imag.contiguous()
                    elif mode == "offset":   # one float off 16 bytes
                        buf = torch.empty((2, L * ny * nx + 1),
                                          device="cuda")
                        re = buf[0, 1:].view(L, ny, nx)
                        im = buf[1, 1:].view(L, ny, nx)
                        re.copy_(xc.real)
                        im.copy_(xc.imag)
                    else:               # the complex form's planes
                        v = torch.view_as_real(xc.clone())
                        re, im = v[..., 0], v[..., 1]
                        if mode == "inplace":
                            out = (re, im)
                    want = fused2d.design(re, im)
                    ring0 = count_of("launch.K8.ring")
                    all0 = count_of("launch.K8")
                    rr, ii = fused2d.fft2_fused(re, im, sign, postscale=post,
                                                out=out)
                    torch.cuda.synchronize()
                    got = ("ring" if count_of("launch.K8.ring") - ring0 == 1
                           else "first")
                    if count_of("launch.K8") - all0 != 1 or got != want:
                        raise AssertionError(
                            f"fused kernel {ny}x{nx} L={L} {mode}: ran the "
                            f"{got} design, its table names {want}")
                    ran[got] += 1
                    if out is not None and rr.data_ptr() != re.data_ptr():
                        raise AssertionError("in-place fused launch wrote "
                                             "elsewhere")
                    got = cplx(rr, ii)
                    e_plain = rel_err(got, cplx(pr, pi))
                    e_np = rel_err(got, ref)
                    tag = f"{ny}x{nx} L={L} sign={sign} {mode}"
                    check(f"fused kernel vs plain {tag}", e_plain)
                    check(f"fused kernel vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        walk_txt = f", L = {walk[0]}" if walk else ""
        ring_txt = ("no ring (the first design's shape)" if shape is None
                    else f"ring: {shape['cluster']} blocks of "
                    f"{shape['rows']} rows and {shape['columns']} columns, "
                    f"{shape['threads']} threads, {shape['slots']} slots, "
                    f"{shape['smem_bytes']} bytes a block, boxes of "
                    f"{shape['box_run']} points along x, "
                    f"{shape['clusters_held']} clusters held")
        print(f"phase 7 fused 2D kernel {ny}x{nx} (L = 1, 3{walk_txt}): "
              f"{cases} cases, launches "
              f"{ran} by design, each the one its table names; {ring_txt}; "
              f"the first design's cluster of {fused2d.cluster_size(ny, nx)}"
              f" blocks, {fused2d.clusters(ny, nx, False)} clusters held; "
              f"max rel err vs plain {worst_plain:.3e}, vs numpy "
              f"{worst_np:.3e} (gate {TOL:.0e})")


# ----------------------------------------------- multi-pass main paths


class PathSpec(NamedTuple):
    shape: tuple            # transform shape
    batch: int
    kinds: list             # executors of the plan
    per: tuple              # launches per execute, in the order of KERNELS
    dtype: torch.dtype = torch.complex64
    rows: tuple | None = None   # batch rows held against numpy (None: all)


PATHS = {
    "config 6+": PathSpec((1 << 22,), 8, ["fourstep"], (0, 2, 0, 0, 0)),
    "config 3": PathSpec((1024, 1024), 16, ["local", "local"],
                         (1, 1, 0, 0, 0)),
    "config 4": PathSpec((256, 256, 256), 1, ["fused2d", "local"],
                         (0, 1, 1, 0, 0)),
    "mid": PathSpec((16384, 1024), 2, ["local", "fourstep"], (1, 2, 0, 0, 0)),
    "huge": PathSpec((1 << 27,), 1, ["huge"], (0, 3, 0, 0, 0)),
    # complex128: config 5 at full size, config 3's shape, and the six-step
    # at 2^25 (512 MiB: the route's three modes, at a size that keeps the
    # run short)
    "config 5": PathSpec((1 << 22,), 64, ["fourstep"], (0, 0, 0, 0, 2),
                         torch.complex128, (0, 21, 42, 63)),
    "c128 2D": PathSpec((1024, 1024), 16, ["local", "local"],
                        (0, 0, 0, 1, 1), torch.complex128),
    "c128 huge": PathSpec((1 << 25,), 1, ["huge"], (0, 0, 0, 0, 3),
                          torch.complex128),
}
C64_PATHS = ("config 6+", "config 3", "config 4", "mid", "huge")
# a path's launches on a column design over its five executes, where they
# are fixed: config 3's four complex-form column passes read the pairs
# (K5's persistent cluster ring), its planar one the cluster tile
PATH_DESIGNS = {"config 3": {"column cluster ring": 4,
                             "column cluster tile": 1}}
C128_PATHS = ("config 5", "c128 2D", "c128 huge")


def make_data(shape, seed, dtype=torch.complex64):
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.complex(torch.randn(shape, generator=g, device="cuda",
                                  dtype=real),
                      torch.randn(shape, generator=g, device="cuda",
                                  dtype=real))
    torch.cuda.synchronize()
    return x


def numpy_ref(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """numpy.fft in complex128 of the last ``ndim`` axes, back on the card."""
    a = x.cpu().numpy().astype(np.complex128)
    axes = tuple(range(-ndim, 0))
    return torch.from_numpy(np.fft.fftn(a, axes=axes)).cuda()


def run_path(name: str, seed: int, phase: int) -> dict:
    """One path's five executes (Plan complex, inverse, planar; fft and
    ifft) with the counts set to 0 just before and read just after."""
    import pyfft_tpu_torch
    spec = PATHS[name]
    tol = TOL64 if spec.dtype == torch.complex128 else TOL
    full = ((spec.batch,) if spec.batch > 1 else ()) + spec.shape
    x = make_data(full, seed, spec.dtype)
    rows = slice(None) if spec.rows is None else list(spec.rows)
    ref = numpy_ref(x[rows], len(spec.shape))
    plan = pyfft_tpu_torch.Plan(spec.shape, spec.dtype, device="cuda")
    got_kinds = [p.executor for p in plan._exec_plan.passes]
    if got_kinds != spec.kinds:
        raise AssertionError(f"{name}: plan {plan!r}, expected {spec.kinds}")
    fn, ifn = {1: ("fft", "ifft"), 2: ("fft2", "ifft2"),
               3: ("fftn", "ifftn")}[len(spec.shape)]
    re, im = x.real.contiguous(), x.imag.contiguous()
    reset_counts()
    t0 = time.perf_counter()
    y = plan.execute(x)
    back = plan.execute(y, inverse=True)
    rr, ii = plan.execute(re, im)
    yf = getattr(pyfft_tpu_torch, fn)(x)
    yb = getattr(pyfft_tpu_torch, ifn)(yf)
    counts = read_counts()
    designs = design_counts()
    wall = time.perf_counter() - t0
    errs = {"complex": rel_err(y[rows], ref), "roundtrip": rel_err(back, x),
            "planar": rel_err(cplx(rr[rows], ii[rows]), ref),
            fn: rel_err(yf[rows], ref), f"{ifn}({fn})": rel_err(yb, x)}
    for k, e in errs.items():
        check(f"{name} {k}", e, tol)    # a NaN fails the comparison too
    for k, v in (("complex", y), ("roundtrip", back), (fn, yf)):
        if tuple(v.shape) != full or v.dtype != spec.dtype:
            raise AssertionError(f"{name} {k}: {v.dtype} {tuple(v.shape)}")
    if rr.dtype != re.dtype:
        raise AssertionError(f"{name} planar: {rr.dtype}")
    want = expect({k: 5 * c for k, c in zip(KERNELS, spec.per)},
                  *[route_counts(plan)] * 4)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    for k, v in PATH_DESIGNS.get(name, {}).items():
        if designs[k] != v:
            raise AssertionError(f"{name}: launches on the designs "
                                 f"{designs}, expected {k} {v}")
    against = ("numpy" if spec.rows is None
               else f"numpy on rows {list(spec.rows)}")
    print(f"phase {phase} {name} {full}: {plan!r}, launches "
          f"{ {k: v for k, v in counts.items() if v} } over 5 executes, "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (against {against}; gate {tol:.0e}; {wall:.2f} s host wall)"
          + "; of those launches, on the redesigns: "
          + str({k: v for k, v in designs.items() if v}))
    return {"x": x, "plan": plan, "counts": counts, "errs": errs,
            "designs": designs}


def path_passes(name: str, plan) -> list:
    """The kernel passes of a path's forward plan at the shapes the plan
    gives them, as [(label, kernel name, kernel fn, plain fn)]; each fn
    takes and returns a pair of planes, the first pass the data's."""
    from pyfft_tpu_torch.ops import fused2d, local
    f64 = PATHS[name].dtype == torch.complex128
    suffix = "_f64" if f64 else ""

    def rows():
        return ("local_rows" + suffix,
                lambda r, i: local.fft_axis(r, i, -1),
                lambda r, i: local.fft_rows_plain(r, i, -1))

    def cols(shape3, **kw):
        return ("local_cols" + suffix,
                lambda r, i: local.fft_axis(r.reshape(shape3),
                                            i.reshape(shape3), -1, axis=1,
                                            **kw),
                lambda r, i: local.fft_cols_plain(r.reshape(shape3),
                                                  i.reshape(shape3), -1,
                                                  **kw))

    split = [p.split for p in plan._exec_plan.passes if p.split]
    batch = PATHS[name].batch
    if name in ("config 6+", "config 5"):
        n1, n2 = split[0]
        return [("pass 1, full twiddle + swap_store",
                 *cols((batch, n1, n2), tw_n=n1 * n2, swap_store=True)),
                ("pass 2, plain store", *cols((batch, n2, n1)))]
    if name in ("config 3", "c128 2D"):
        return [("row pass", *rows()),
                ("column pass", *cols((16, 1024, 1024)))]
    if name == "config 4":
        return [("fused 2D pass", "fused2d",
                 lambda r, i: fused2d.fft2_fused(r, i, -1),
                 lambda r, i: fused2d.fft2_plain(r, i, -1)),
                ("z pass", *cols((1, 256, 256 * 256)))]
    if name == "mid":
        n1, n2 = split[0]
        T = 1024
        return [("row pass", *rows()),
                ("pass 1, strided twiddle + swap_mid",
                 *cols((2, n1, n2 * T), tw_n=n1 * n2, tw_mode="strided",
                       tw_period=T, swap_mid=T)),
                ("pass 2, plain store", *cols((2, n2, n1 * T)))]
    n1, m1, m2 = split[0]                           # huge, c128 huge
    return [("pass 1, factored twiddle + swap_store",
             *cols((1, n1, m1 * m2), tw_n=n1 * m1 * m2, tw_mode="factored",
                   swap_store=True)),
            ("pass 2, strided twiddle + swap_mid",
             *cols((1, m1, m2 * n1), tw_n=m1 * m2, tw_mode="strided",
                   tw_period=n1, swap_mid=n1)),
            ("pass 3, plain store", *cols((1, m2, m1 * n1)))]


def pass_checks(name: str, x: torch.Tensor, plan, phase: int) -> list:
    """Hold each kernel pass of a path against its plain version on the
    pass's input, the previous kernel pass's output; returns
    [(pass, kernel, max abs err, max rel err)]."""
    tol = TOL64 if PATHS[name].dtype == torch.complex128 else TOL
    out = []
    r, i = x.real.contiguous(), x.imag.contiguous()
    for label, kernel, run, plain in path_passes(name, plan):
        kr, ki = run(r, i)
        pr, pi = plain(r, i)
        max_abs = float(torch.maximum((kr - pr).abs().max(),
                                      (ki - pi).abs().max()))
        e = rel_err(cplx(kr, ki), cplx(pr, pi))
        check(f"{name} {label} kernel vs plain", e, tol)
        out.append((label, kernel, max_abs, e))
        del pr, pi
        r, i = kr, ki
    print(f"phase {phase} {name} kernel passes vs plain: "
          + ", ".join(f"{lab} ({k}) max abs {a:.3e} rel {e:.3e}"
                      for lab, k, a, e in out) + f" (gate {tol:.0e})")
    return out


def phase_paths(names, phase: int, keep: tuple = ()):
    """Each path's run and pass checks; the data of the paths in ``keep``
    stays for the timings, the others' is let go."""
    results = {}
    for name in names:
        r = run_path(name, seed=10 + list(PATHS).index(name), phase=phase)
        r["pass_checks"] = pass_checks(name, r["x"], r["plan"], phase)
        if name not in keep:
            r.pop("x")
        results[name] = r
        torch.cuda.empty_cache()
    return results


def time_pass(path, label, re, im, kernel, plain, library, nbytes, flops,
              copy_gbs, extra_bytes=0, phase=9, peak_flops=PEAK_FP32_S,
              int8_ops=0.0):
    """One timed pass: kernel, plain version and library call by CUDA
    events, with its bounds; returns the record and prints its line."""
    from pyfft_tpu_torch.utils.profiling import time_ms
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    lib_ms = None if library is None else time_ms(library)
    b_ms, b_by = bound(nbytes, flops, peak_flops, int8_ops)
    copy_ms = nbytes / (copy_gbs * 1e9) * 1e3
    row = {"path": path, "pass": label, "shape": list(re.shape), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "copy_bound_ms": copy_ms, "bytes": nbytes,
           "table_bytes": extra_bytes}
    print(f"phase {phase} {path} {label} {tuple(re.shape)}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}, published peaks, data only), {copy_ms:.4f} ms at the "
          f"measured {copy_gbs:.1f} GB/s copy, kernel at {copy_ms / ms:.3f} "
          "of it"
          + (f"; the design also reads a {extra_bytes / 2**20:.0f} MiB "
             f"twiddle table" if extra_bytes else "")
          + "; library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
          + " (context only)")
    return row


def time_complex_form(row, xs, oshape, run):
    """Time a kernel pass again on the two stride-2 planes of the complex
    tensor ``xs`` (the complex form Plan.execute runs), into a complex
    output of ``oshape``; ``run(re, im, out)`` launches it."""
    from pyfft_tpu_torch.utils.profiling import time_ms
    xv = torch.view_as_real(xs)
    yv = torch.view_as_real(torch.empty(oshape, dtype=xs.dtype,
                                        device="cuda"))
    row["complex_ms"] = time_ms(lambda: run(xv[..., 0], xv[..., 1],
                                            (yv[..., 0], yv[..., 1])))
    print(f"    the same kernel pass on the complex form's stride-2 planes: "
          f"{row['complex_ms']:.4f} ms (planar {row['ms']:.4f} ms)")


def ran_design(run, f64: bool = False, rows: bool = False) -> str:
    """The design one launch of ``run`` ran, by what its C entry reports:
    the row ring or the first design (rows; K11 on float64), the
    persistent ring, the persistent cluster ring, the cluster tile or the
    first design (complex64 columns; complex128 columns, K12: the
    persistent cluster ring, the cluster tile or the first design)."""
    counts = ({"launch.K11.ring" if f64 else "launch.K1.ring": "row ring"}
              if rows else {"launch.K12.ring": "persistent cluster ring",
                            "launch.K12.x": "cluster tile"} if f64 else
              {"launch.K5.pring": "persistent ring",
               "launch.K5.xring": "persistent cluster ring",
               "launch.K5.x": "cluster tile"})
    before = {c: count_of(c) for c in counts}
    run()
    torch.cuda.synchronize()
    for c, b in before.items():
        if count_of(c) != b:
            return counts[c]
    return "first design"


def time_col_passes(results, copy_gbs, cases, phase, f64=False):
    """Time column passes [(path, (L, n, T), label, modes, table bytes)]
    on their path's data, planar and in the complex form, with the design
    each ran; a plain column pass's library call is torch.fft.fft over dim
    -2."""
    from pyfft_tpu_torch.ops import local
    rows = []
    point = 16 if f64 else 8                    # bytes of a complex point
    for path, shape3, label, kw, table_bytes in cases:
        xs = results[path]["x"].reshape(shape3)
        re, im = xs.real.contiguous(), xs.imag.contiguous()
        L, n, T = shape3
        oshape = local._col_out_shape(shape3, 1, kw.get("swap_store", False),
                                      kw.get("swap_mid", 0))
        out = (torch.empty(oshape, device="cuda", dtype=re.dtype),
               torch.empty(oshape, device="cuda", dtype=re.dtype))
        library = None
        if not kw:
            library = lambda xs=xs: torch.fft.fft(xs, dim=-2)  # noqa: E731
        design = ran_design(lambda: local.fft_axis(re, im, -1, axis=-2,
                                                   out=out, **kw), f64)
        print(f"phase {phase} {path} {label}: design {design}")
        rows.append(time_pass(
            path, label, re, im,
            lambda: local.fft_axis(re, im, -1, axis=-2, out=out, **kw),
            lambda: local.fft_cols_plain(re, im, -1, **kw), library,
            2 * L * n * T * point,
            fft_flops(n, L * T) + (6 * L * n * T if kw else 0), copy_gbs,
            table_bytes, phase, PEAK_FP64_S if f64 else PEAK_FP32_S))
        rows[-1]["kernel"] = "local_cols_f64" if f64 else "local_cols"
        rows[-1]["design"] = design
        del out, re, im
        time_complex_form(rows[-1], xs, oshape,
                          lambda r, i, o, kw=kw: local.fft_axis(
                              r, i, -1, axis=-2, out=o, **kw))
    return rows


def phase_pass_timings(results, copy_gbs):
    from pyfft_tpu_torch.ops import fused2d, local
    from pyfft_tpu_torch.utils.profiling import time_ms
    rows = time_col_passes(results, copy_gbs, [
        ("config 6+", (8, 2048, 2048), "pass 1 (full + swap_store)",
         dict(tw_n=1 << 22, swap_store=True), 2048 * 2048 * 8),
        ("config 6+", (8, 2048, 2048), "pass 2 (plain store)", {}, 0),
        ("config 3", (16, 1024, 1024), "column pass", {}, 0),
        ("config 4", (1, 256, 65536), "z pass", {}, 0),
        ("mid", (2, 128, 131072), "pass 1 (strided + swap_mid)",
         dict(tw_n=128 * 128, tw_mode="strided", tw_period=1024,
              swap_mid=1024), 128 * 128 * 8),
        ("mid", (2, 128, 131072), "pass 2 (plain store)", {}, 0),
    ], phase=9)
    # config 4's fused 2D pass, and the row and column passes it replaces
    x = results["config 4"]["x"]
    re, im = x.real.contiguous(), x.imag.contiguous()
    L, ny, nx = re.shape
    out = (torch.empty_like(re), torch.empty_like(im))
    tmp = (torch.empty_like(re), torch.empty_like(im))
    flops = fft_flops(nx, L * ny) + fft_flops(ny, L * nx)

    def two_pass():
        local.fft_axis(re, im, -1, out=tmp)
        local.fft_axis(tmp[0], tmp[1], -1, axis=-2, out=out)

    rows.append(time_pass(
        "config 4", "fused 2D pass", re, im,
        lambda: fused2d.fft2_fused(re, im, -1, out=out),
        lambda: fused2d.fft2_plain(re, im, -1),
        lambda: torch.fft.fft2(x), 2 * L * ny * nx * 8, flops, copy_gbs))
    rows[-1]["kernel"] = "fused2d"
    k8 = rows[-1]
    print(f"phase 9 config 4 fused 2D pass on the {fused2d.design(re, im)} "
          f"design: {k8['ms']:.4f} ms, {k8['bound_ms'] / k8['ms']:.3f} of "
          f"its bound at the published peaks ({k8['bound_ms']:.4f} ms), "
          f"{k8['copy_bound_ms'] / k8['ms']:.3f} of the measured copy's "
          f"({k8['copy_bound_ms']:.4f} ms)")
    two_ms = time_ms(two_pass)
    rows[-1]["two_pass_ms"] = two_ms
    print(f"phase 9 config 4 the same 2D transform as a row-kernel pass and "
          f"a column-kernel pass: {two_ms:.4f} ms (fused "
          f"{rows[-1]['ms']:.4f} ms)")
    del out, tmp
    return rows


def phase_f64_timings(results, copy_gbs):
    """Config 5's two K12 passes, the complex128 2D path's K11 row pass
    (beside torch.fft.fft along the last axis) and K12 column pass."""
    from pyfft_tpu_torch.ops import local
    rows = time_col_passes(results, copy_gbs, [
        ("config 5", (64, 2048, 2048), "pass 1 (full + swap_store)",
         dict(tw_n=1 << 22, swap_store=True), 2048 * 2048 * 16),
        ("config 5", (64, 2048, 2048), "pass 2 (plain store)", {}, 0),
        ("c128 2D", (16, 1024, 1024), "column pass", {}, 0),
    ], phase=13, f64=True)
    x = results["c128 2D"]["x"]
    re, im = x.real.contiguous(), x.imag.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    n = re.shape[-1]
    count = re.numel() // n
    design = ran_design(lambda: local.fft_axis(re, im, -1, out=out), True,
                        rows=True)
    print(f"phase 13 c128 2D row pass: design {design}")
    rows.append(time_pass(
        "c128 2D", "row pass", re, im,
        lambda: local.fft_axis(re, im, -1, out=out),
        lambda: local.fft_rows_plain(re, im, -1),
        lambda: torch.fft.fft(x, dim=-1), 2 * re.numel() * 16,
        fft_flops(n, count), copy_gbs, phase=13, peak_flops=PEAK_FP64_S))
    rows[-1]["kernel"] = "local_rows_f64"
    rows[-1]["design"] = design
    del out, re, im
    time_complex_form(rows[-1], x, tuple(x.shape),
                      lambda r, i, o: local.fft_axis(r, i, -1, out=o))
    return rows


LIB_FN = {"config 6+": torch.fft.fft, "config 3": torch.fft.fft2,
          "config 4": torch.fft.fftn, "mid": torch.fft.fft2,
          "huge": torch.fft.fft, "config 5": torch.fft.fft,
          "c128 2D": torch.fft.fft2, "c128 huge": torch.fft.fft}


def phase_end_to_end(results, phase: int = 9):
    from pyfft_tpu_torch.utils.profiling import time_ms
    e2e = {}
    for name, r in results.items():
        spec = PATHS[name]
        x = r.get("x")
        if x is None:            # this path's data was let go
            full = ((spec.batch,) if spec.batch > 1 else ()) + spec.shape
            x = make_data(full, seed=99, dtype=spec.dtype)
        plan = r["plan"]
        ms = time_ms(lambda: plan.execute(x, wait_for_finish=False),
                     iters=10)
        lib = time_ms(lambda: LIB_FN[name](x), iters=10)
        gf = sum(fft_flops(s, spec.batch * math.prod(spec.shape) // s)
                 for s in spec.shape) / (ms * 1e-3) / 1e9
        e2e[name] = {"ms": ms, "library_ms": lib, "gflops": gf}
        print(f"phase {phase} {name} Plan.execute end to end {ms:.4f} ms "
              f"({gf:.1f} GFLOP/s by 5 N log2 N), torch.fft "
              f"{lib:.4f} ms (library, context only)")
        del x
        r.pop("x", None)
        torch.cuda.empty_cache()
    return e2e


# ------------------------------------------- interleaved storage (K2, K13, K14)

IL_NS = tuple(1 << p for p in range(3, 14))


@contextlib.contextmanager
def routes(one=None, multi=None):
    """Set plan.py's routes for a ``with`` block, then restore them:
    ``one`` sets IL1D_ROUTE, ``multi`` IL_MULTI_ROUTE."""
    from pyfft_tpu_torch import plan as plan_mod
    saved = plan_mod.IL1D_ROUTE, plan_mod.IL_MULTI_ROUTE
    if one is not None:
        plan_mod.IL1D_ROUTE = one
    if multi is not None:
        plan_mod.IL_MULTI_ROUTE = multi
    try:
        yield
    finally:
        plan_mod.IL1D_ROUTE, plan_mod.IL_MULTI_ROUTE = saved


@contextlib.contextmanager
def held_against_plain(log: list):
    """For a ``with`` block, hold every call of K2, K13 and K14 on the
    card against its plain version on the same input: K2 at TOL, K13 and
    K14 bit-exact (torch.equal).  Each call appends (kernel, shape of its
    interleaved side, max abs err, max rel err) to ``log``.  The plain
    version runs first, so an in-place call is held against its input.
    The launches count as any other, so a counted run stays outside."""
    from pyfft_tpu_torch.ops import interleave, local
    k2, k13, k14 = (local.fft_rows_interleaved, interleave.deinterleave,
                    interleave.interleave)

    def rows_il(v, sign, *, postscale=1.0, factors=None, packed=None,
                precision="highest", out=None):
        want = local.fft_rows_interleaved_plain(v, sign, postscale, factors,
                                                bool(packed), precision)
        got = k2(v, sign, postscale=postscale, factors=factors,
                 packed=packed, precision=precision, out=out)
        e = rel_err(as_c64(got), as_c64(want))
        check(f"K2 {tuple(v.shape)} vs plain", e)
        log.append(("local_rows_il", tuple(v.shape),
                    float((got - want).abs().max()), e))
        return got

    def deinterleave(v, *, out=None):
        want = [t.clone() for t in interleave.deinterleave_plain(v)]
        got = k13(v, out=out)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K13 {tuple(v.shape)} not bit-exact")
        log.append(("deinterleave", tuple(v.shape), 0.0, 0.0))
        return got

    def interleave_(re, im, *, out=None):
        want = interleave.interleave_plain(re, im)
        got = k14(re, im, out=out)
        if not torch.equal(got, want):
            raise AssertionError(f"K14 {tuple(got.shape)} not bit-exact")
        log.append(("interleave", tuple(got.shape), 0.0, 0.0))
        return got

    local.fft_rows_interleaved = rows_il
    interleave.deinterleave, interleave.interleave = deinterleave, interleave_
    try:
        yield log
    finally:
        local.fft_rows_interleaved = k2
        interleave.deinterleave, interleave.interleave = k13, k14


def held_summary(log: list) -> str:
    """One line of a held_against_plain log: each kernel's calls, shapes
    and worst errors."""
    parts = []
    for kernel in ("local_rows_il", "deinterleave", "interleave"):
        mine = [c for c in log if c[0] == kernel]
        if mine:
            shapes = sorted({c[1] for c in mine})
            parts.append(f"{kernel} {len(mine)} calls at {shapes}, max abs "
                         f"{max(c[2] for c in mine):.3e} rel "
                         f"{max(c[3] for c in mine):.3e}")
    return "; ".join(parts)


def as_c64(v: torch.Tensor) -> torch.Tensor:
    """A (..., 2n) float32 interleaved view as complex64 (..., n)."""
    return v.contiguous().view(torch.complex64)


def phase_il_kernels():
    """K2 at every n against its plain version (packed or not) and numpy;
    K13 and K14 bit-exact against theirs."""
    from pyfft_tpu_torch.ops import interleave, local
    rng = np.random.RandomState(14)
    for n in IL_NS:
        worst_plain = worst_np = 0.0
        before = count_of("launch.K2")
        cases = 0
        for rows in (1, 130):
            x = (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            xc = torch.from_numpy(x).cuda()
            for sign in (-1, +1):
                post = 0.3
                ref = torch.from_numpy(
                    (np.fft.fft(x.astype(np.complex128)) if sign < 0
                     else np.fft.ifft(x.astype(np.complex128)) * n)
                    * post).cuda()
                xf = xc.view(torch.float32)
                plain = {packed: as_c64(local.fft_rows_interleaved_plain(
                    xf, sign, post, packed=packed))
                    for packed in (False, True)}
                for mode in ("out", "inplace", "packed"):
                    v = xc.clone().view(torch.float32)
                    out = v if mode == "inplace" else None
                    y = local.fft_rows_interleaved(
                        v, sign, postscale=post, out=out,
                        packed=mode == "packed")
                    torch.cuda.synchronize()
                    if mode == "inplace" and y.data_ptr() != v.data_ptr():
                        raise AssertionError("in-place K2 wrote elsewhere")
                    got = as_c64(y)
                    e_plain = rel_err(got, plain[mode == "packed"])
                    e_np = rel_err(got, ref)
                    tag = f"n={n} rows={rows} sign={sign} {mode}"
                    check(f"K2 vs plain {tag}", e_plain)
                    check(f"K2 vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        if count_of("launch.K2") - before != cases:
            raise AssertionError(f"K2 n={n}: {count_of('launch.K2') - before} "
                                 f"launches for {cases} calls")
        print(f"phase 14 K2 n={n}: {cases} cases (out of place, in place, "
              f"packed), max rel err vs plain {worst_plain:.3e}, vs numpy "
              f"{worst_np:.3e} (gate {TOL:.0e})")
        ring_il_cases(n, rng)

    def strided(t, pad, lead=0):
        """t's values in a wider buffer: a view with row stride
        width + pad starting ``lead`` floats in."""
        rows, width = t.shape
        buf = torch.zeros((rows, width + pad), device="cuda")
        view = buf[:, lead:lead + width]
        view.copy_(t)
        return view

    # (rows, n, layout, (pad, lead) of the interleaved rows and of the
    # planes' rows): dense takes the vector path with no row arithmetic;
    # rows padded to 16 and 8 bytes the vector path by rows; rows starting
    # off those alignments the scalar path
    cases = []
    for rows, n, layout, geo in (
            (130, 4096, "dense", None), (4096, 4096, "dense", None),
            (33, 1001, "dense, odd n", None),
            (64, 1000, "rows 16-byte aligned", ((4, 0), (2, 0))),
            (64, 1001, "unaligned rows", ((6, 2), (3, 1)))):
        v = torch.randn((rows, 2 * n), device="cuda")
        re_in, im_in = torch.randn((2, rows, n), device="cuda").unbind(0)
        out = None
        if geo:
            (vpad, vlead), (ppad, plead) = geo
            v = strided(v, vpad, vlead)
            re_in, im_in = (strided(t, ppad, plead) for t in (re_in, im_in))
            out = tuple(strided(torch.empty((rows, n), device="cuda"), ppad,
                                plead) for _ in range(2))
        pr, pi = interleave.deinterleave_plain(v)
        re, im = interleave.deinterleave(v, out=out)
        vi = interleave.interleave(re_in, im_in)
        back = interleave.interleave(re, im)
        torch.cuda.synchronize()
        ok = (torch.equal(re, pr) and torch.equal(im, pi)
              and torch.equal(vi, interleave.interleave_plain(re_in, im_in))
              and torch.equal(back, v))
        if not ok:
            raise AssertionError(f"K13/K14 not bit-exact at ({rows}, 2*{n}) "
                                 f"{layout}")
        cases.append(f"({rows}, 2*{n}) {layout}")
    print(f"phase 14 K13/K14 bit-exact against their plain versions and "
          f"in a round trip: {', '.join(cases)}")


def ring_il_cases(n: int, rng):
    """K2 on the row ring's edges at length n: a row count that walks every
    persistent block three times and ends ragged, out of place, in place,
    with rows padded apart by 16 bytes (the ring) and by 8 (the first
    design) and on a view 8 bytes off 16-byte alignment (the first
    design), against the plain version and numpy."""
    from pyfft_tpu_torch.ops import local
    rows, shape = ring_wave_rows(n)
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    xf = torch.from_numpy(x).cuda().view(torch.float32)
    worst_plain = worst_np = 0.0
    took = []
    for sign in (-1, +1):
        post = 0.3
        ref = torch.from_numpy(
            (np.fft.fft(x.astype(np.complex128)) if sign < 0
             else np.fft.ifft(x.astype(np.complex128)) * n) * post).cuda()
        plain = as_c64(local.fft_rows_interleaved_plain(xf, sign, post))
        for mode in ("out", "inplace", "padded 16", "padded 8", "offset 8"):
            out = None
            if mode in ("out", "inplace"):
                v = xf.clone()
                out = v if mode == "inplace" else None
            else:
                pad, lead = {"padded 16": (4, 0), "padded 8": (2, 0),
                             "offset 8": (0, 2)}[mode]
                v = padded_rows(xf, pad, lead)
            takes = ring_expected(n, mode)
            before = (count_of("launch.K2"),
                      count_of("launch.K1.ring", "launch.K2.ring"))
            y = local.fft_rows_interleaved(v, sign, postscale=post, out=out)
            torch.cuda.synchronize()
            got = (count_of("launch.K2") - before[0],
                   count_of("launch.K1.ring", "launch.K2.ring") - before[1])
            if got != (1, int(takes)):
                raise AssertionError(f"K2 n={n} {mode}: (K2, ring) launches "
                                     f"{got}, expected (1, {int(takes)})")
            if mode == "inplace" and y.data_ptr() != v.data_ptr():
                raise AssertionError("in-place K2 wrote elsewhere")
            got = as_c64(y)
            e_plain, e_np = rel_err(got, plain), rel_err(got, ref)
            tag = f"n={n} rows={rows} sign={sign} {mode}"
            check(f"K2 ring vs plain {tag}", e_plain)
            check(f"K2 ring vs numpy {tag}", e_np)
            worst_plain = max(worst_plain, e_plain)
            worst_np = max(worst_np, e_np)
            if sign < 0:
                took.append(f"{mode} {'ring' if takes else 'first design'}")
    del xf, plain, ref
    torch.cuda.empty_cache()
    print(f"phase 14 K2 n={n}, {rows} rows "
          f"({shape or 'the first design'}): {', '.join(took)}; max rel "
          f"err vs plain {worst_plain:.3e}, vs numpy {worst_np:.3e} (gate "
          f"{TOL:.0e})")


def route_run(plan, x, ref, label: str, phase: int = 15) -> dict:
    """Plan.execute and its inverse, fft and ifft on ``x`` under the route
    plan.py's routes give now, with exact launch counts; returns the
    counts."""
    import pyfft_tpu_torch
    route = plan.il_route()
    reset_counts()
    y = plan.execute(x)
    back = plan.execute(y, inverse=True)
    yf = pyfft_tpu_torch.fft(x)
    yb = pyfft_tpu_torch.ifft(yf)
    counts = read_counts()
    errs = {"complex": rel_err(y, ref), "roundtrip": rel_err(back, x),
            "fft": rel_err(yf, ref), "ifft(fft)": rel_err(yb, x)}
    for k, e in errs.items():
        check(f"{label} {route} {k}", e)
    want = expect(*[route_counts(plan)] * 4)
    if counts != want:
        raise AssertionError(f"{label} {route}: launches {counts}, expected "
                             f"{want}")
    print(f"phase {phase} {label} route {route!r}: launches "
          f"{ {k: v for k, v in counts.items() if v} } over 4 executes, "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (gate {TOL:.0e})")
    return counts


def time_routes(run, names=ROUTES, table: str = "one",
                rounds: int = 3) -> dict:
    """``run`` under each route of ``names`` (set through ``routes`` as
    ``table``), in ``rounds`` turns with the order reversed each turn, so
    that a drift of the card favours no route.  Per route, the lists of
    its rounds: "event", the median of per-call events (``time_ms``: where
    the host takes longer than the device, the host's time); "device"
    and "host", ms per call with the host ahead (``time_queued_ms``)."""
    from pyfft_tpu_torch.utils.profiling import time_ms, time_queued_ms
    out = {r: {"event": [], "device": [], "host": []} for r in names}
    for i in range(rounds):
        for route in (names if i % 2 == 0 else names[::-1]):
            with routes(**{table: route}):
                out[route]["event"].append(time_ms(run))
                dev, host = time_queued_ms(run)
                out[route]["device"].append(dev)
                out[route]["host"].append(host)
    return out


def verdict(t: dict) -> tuple[str, bool]:
    """(the route of least device time, best of its rounds; whether that
    is resolved: its worst round below every other route's best)."""
    best = {r: min(v["device"]) for r, v in t.items()}
    win = min(best, key=best.get)
    return win, all(max(t[win]["device"]) < best[r] for r in t if r != win)


def routes_line(t: dict) -> str:
    """Each route's device, event and host ms over its rounds."""
    def span(v):
        return f"{min(v):.4f}-{max(v):.4f}"
    return ", ".join(f"{r} device {span(v['device'])} event "
                     f"{span(v['event'])} host {span(v['host'])} ms"
                     for r, v in t.items())


def phase_config2i(copy_gbs):
    """Config 2i under each route; K2, K13 and K14 timed at its shape and
    held against their plain versions at every shape the routes give
    them; each route timed at every n and on the multi-pass plans, and
    the winners printed beside plan.py's routes."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch import plan as plan_mod
    from pyfft_tpu_torch.ops import interleave, local
    from pyfft_tpu_torch.utils.profiling import time_ms
    held = []
    x = make_data((BATCH, N), seed=15)
    ref = numpy_ref(x, 1)
    plan = pyfft_tpu_torch.Plan((N,), device="cuda")
    launches = dict.fromkeys(KERNELS, 0)
    for route in ROUTES:
        with routes(one=route):
            if plan.il_route() != route:
                raise AssertionError(f"route not read: {route}")
            for k, v in route_run(plan, x, ref, "config 2i").items():
                launches[k] += v
            with held_against_plain(held):
                plan.execute(plan.execute(x), inverse=True)
    del ref
    t2i = time_routes(lambda: plan.execute(x, wait_for_finish=False))
    win, resolved = verdict(t2i)
    lib_ms = time_ms(lambda: torch.fft.fft(x))
    print(f"phase 15 config 2i Plan.execute by route, 3 rounds: "
          + routes_line(t2i) + f" -> {win} "
          f"({'resolved' if resolved else 'unresolved'}); torch.fft.fft "
          f"{lib_ms:.4f} ms (library, context only)")

    # the three kernels alone at config 2i's shape
    xf = x.view(torch.float32)
    y = torch.empty_like(x)
    yf = y.view(torch.float32)
    re, im = interleave.deinterleave(xf)
    local.fft_rows_interleaved(xf, -1, out=yf)
    plain = local.fft_rows_interleaved_plain(xf, -1)
    pr, pi = interleave.deinterleave_plain(xf)
    vi = interleave.interleave(re, im)
    torch.cuda.synchronize()
    k2_abs = float((yf - plain).abs().max())
    k2_rel = rel_err(y, as_c64(plain))
    check("config 2i K2 vs plain", k2_rel)
    del plain
    k13_abs = float(max((re - pr).abs().max(), (im - pi).abs().max()))
    k14_abs = float((vi - xf).abs().max())
    if k13_abs or k14_abs:
        raise AssertionError(f"config 2i K13/K14 not bit-exact: "
                             f"{k13_abs}, {k14_abs}")
    del pr, pi, vi
    moved = 2 * BATCH * N * 8
    timed = {}
    for name, kernel, plain_fn, library, flops in (
            ("local_rows_il",
             lambda: local.fft_rows_interleaved(xf, -1, out=yf),
             lambda: local.fft_rows_interleaved_plain(xf, -1),
             lambda: torch.fft.fft(x), fft_flops(N, BATCH)),
            ("deinterleave",
             lambda: interleave.deinterleave(xf, out=(re, im)),
             lambda: interleave.deinterleave_plain(xf),
             lambda: xf.view(BATCH, N, 2).permute(2, 0, 1).contiguous(), 0),
            ("interleave",
             lambda: interleave.interleave(re, im, out=yf),
             lambda: interleave.interleave_plain(re, im),
             lambda: torch.stack([re, im], dim=-1), 0)):
        ms, plain_ms, lib = (time_ms(kernel), time_ms(plain_fn),
                             time_ms(library))
        b_ms, b_by = bound(moved, flops)
        copy_ms = moved / (copy_gbs * 1e9) * 1e3
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "copy_bound_ms": copy_ms,
                       "max_abs_err": {"local_rows_il": k2_abs,
                                       "deinterleave": k13_abs,
                                       "interleave": k14_abs}[name],
                       "max_rel_err": k2_rel if name == "local_rows_il"
                       else 0.0}
        print(f"phase 15 config 2i {name} ({BATCH}, 2*{N}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, published peaks), {copy_ms:.4f} ms at the measured "
              f"{copy_gbs:.1f} GB/s copy, kernel at {copy_ms / ms:.3f} of "
              f"it; library {lib:.4f} ms (context only)")
    # K3 (packed=True) runs K2's kernel; its plain version mirrors
    # tile_fft_packed
    k3_plain = timed["local_rows_il"]["packed_plain_ms"] = time_ms(
        lambda: local.fft_rows_interleaved_plain(xf, -1, packed=True))
    print(f"    K3's plain version (packed) on the same view: "
          f"{k3_plain:.4f} ms")
    del x, y, xf, yf, re, im
    torch.cuda.empty_cache()

    # single pass: the three routes at every n, 2^24 points each; 64 rows
    # spread over the batch against numpy, every row of each K2, K13 and
    # K14 call against its plain version
    winners, sweep = {}, {}
    for n in IL_NS:
        rows = (1 << 24) // n
        xs = make_data((rows, n), seed=150 + n.bit_length())
        pick = torch.linspace(0, rows - 1, 64, device="cuda").long()
        ref = numpy_ref(xs[pick], 1)
        p = pyfft_tpu_torch.Plan((n,), device="cuda")
        for route in ROUTES:
            with routes(one=route), held_against_plain(held):
                check(f"n={n} {route}", rel_err(p.execute(xs)[pick], ref))
        sweep[n] = time_routes(lambda: p.execute(xs, wait_for_finish=False))
        winners[n] = verdict(sweep[n])
        print(f"phase 15 single pass n={n} ({rows} rows): "
              + routes_line(sweep[n]) + f" -> {winners[n][0]} "
              f"({'resolved' if winners[n][1] else 'unresolved'})")
        del xs, ref
    torch.cuda.empty_cache()

    # multi-pass plans: stream against planes, each against numpy, the
    # stream route's K13 and K14 against their plain versions
    multi = {}
    for name in ("config 3", "config 4", "config 6+"):
        spec = PATHS[name]
        xs = make_data((spec.batch,) + spec.shape, seed=160)
        ref = numpy_ref(xs, len(spec.shape))
        p = pyfft_tpu_torch.Plan(spec.shape, device="cuda")
        errs = {}
        for route in ("stream", "planes"):
            with routes(multi=route):
                reset_counts()
                out = p.execute(xs)
                counts = read_counts()
                want = expect({k: c for k, c in zip(KERNELS, spec.per)},
                              route_counts(p))
                if counts != want:
                    raise AssertionError(f"{name} {route}: launches "
                                         f"{counts}, expected {want}")
                errs[route] = rel_err(out, ref)
                check(f"{name} {route} vs numpy", errs[route])
                del out
                if route == "stream":
                    with held_against_plain(held):
                        p.execute(xs)
        del ref
        multi[name] = time_routes(
            lambda: p.execute(xs, wait_for_finish=False),
            ("stream", "planes"), "multi")
        mwin, mres = verdict(multi[name])
        print(f"phase 15 {name} complex form, 3 rounds: "
              + routes_line(multi[name]) + f" -> {mwin} "
              f"({'resolved' if mres else 'unresolved'}); err vs numpy "
              f"stream {errs['stream']:.3e}, planes {errs['planes']:.3e}")
        del xs
        torch.cuda.empty_cache()
    print(f"phase 15 K2, K13 and K14 against their plain versions on every "
          f"route's shapes: {held_summary(held)} (K2 gate {TOL:.0e}, K13 and "
          f"K14 bit-exact)")
    one = {n: w for n, (w, res) in winners.items() if res}
    mwins = {name: verdict(t) for name, t in multi.items()}
    same = (all(w == plan_mod.IL1D_ROUTE for w in one.values())
            and all(w == plan_mod.IL_MULTI_ROUTE
                    for w, res in mwins.values() if res))
    print(f"phase 15 routes measured: single pass, resolved {one}, "
          f"unresolved at n = {[n for n in winners if n not in one]}; "
          f"multi-pass {mwins}; plan.py holds IL1D_ROUTE = "
          f"{plan_mod.IL1D_ROUTE!r}, IL_MULTI_ROUTE = "
          f"{plan_mod.IL_MULTI_ROUTE!r}, "
          f"{'as every resolved winner' if same else 'against a resolved winner'}")
    return {"counts": launches, "timed": timed, "held": held,
            "config_2i_routes": t2i, "library_ms": lib_ms,
            "winners": {n: {"route": w, "resolved": res}
                        for n, (w, res) in winners.items()},
            "single_pass": sweep, "multi_pass": multi}


# ------------------------------------------------------- real transforms

REAL_CASES = {
    "rfft": ((4096, 8192), 1),
    "rfft2": ((16, 1024, 1024), 2),
    "rfftn": ((256, 256, 256), 3),
}


def phase_real():
    """rfft, rfft2 and rfftn at full size with their inverses, against
    numpy in float64, with exact launch counts and timings; then each
    K2 call of those runs (the last axis's and the leading axes' views)
    against its plain version."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch import real
    from pyfft_tpu_torch.utils.profiling import time_ms
    launches = dict.fromkeys(KERNELS, 0)
    rows, held = {}, []
    for name, (shape, nd) in REAL_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(16 + nd)
        x = torch.randn(shape, generator=g, device="cuda")
        inv_name = "i" + name
        fwd = getattr(pyfft_tpu_torch, name)
        inv = getattr(pyfft_tpu_torch, inv_name)
        lib_fwd = getattr(torch.fft, name)
        lib_inv = getattr(torch.fft, inv_name)
        axes = tuple(range(-nd, 0))
        dims = axes[0] if nd == 1 else axes
        sizes = shape[-1] if nd == 1 else shape[len(shape) - nd:]
        # each inner complex execute: the last axis's n/2, then the others
        inner = [shape[-1] // 2] + list(shape[len(shape) - nd:-1])
        want = expect(*[route_counts(pyfft_tpu_torch.Plan((m,),
                                                          device="cuda"))
                        for m in inner * 2])
        reset_counts()
        X = fwd(x)
        back = inv(X)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{want}")
        for k, v in counts.items():
            launches[k] += v
        with held_against_plain(held):
            inv(fwd(x))
        xn = x.cpu().numpy().astype(np.float64)
        ref = np.fft.rfftn(xn, axes=axes)
        err = rel_err(X.cpu().numpy(), ref)
        del ref
        err_back = rel_err(back, x)
        check(f"{name} vs numpy", err)
        check(f"{inv_name}({name}) round trip", err_back)
        if tuple(X.shape) != (*shape[:-1], shape[-1] // 2 + 1) or (
                X.dtype != torch.complex64 or back.dtype != torch.float32):
            raise AssertionError(f"{name}: {X.dtype} {tuple(X.shape)}, "
                                 f"{back.dtype}")
        n = shape[-1]
        Z = pyfft_tpu_torch.get_plan((n // 2,), device="cuda").execute(
            torch.view_as_complex(x.view(*shape[:-1], n // 2, 2)))
        t = {"ms": time_ms(lambda: fwd(x)),
             "library_ms": time_ms(lambda: lib_fwd(x, None, dims)),
             "inverse_ms": time_ms(lambda: inv(X)),
             "library_inverse_ms": time_ms(lambda: lib_inv(X, sizes, dims)),
             "untangle_ms": time_ms(lambda: real._untangle(Z, n)),
             "tangle_ms": time_ms(lambda: real._tangle(X, n)),
             "err": err, "roundtrip_err": err_back}
        rows[name] = t
        print(f"phase 16 {name} {shape} float32: launches "
              f"{ {k: v for k, v in counts.items() if v} } (forward and "
              f"inverse), err vs numpy {err:.3e}, round trip "
              f"{err_back:.3e} (gate {TOL:.0e}); {name} {t['ms']:.4f} ms "
              f"(torch.fft.{name} {t['library_ms']:.4f} ms), {inv_name} "
              f"{t['inverse_ms']:.4f} ms (torch.fft.{inv_name} "
              f"{t['library_inverse_ms']:.4f} ms); untangle alone "
              f"{t['untangle_ms']:.4f} ms, inverse's "
              f"{t['tangle_ms']:.4f} ms")
        del x, X, back, Z
        torch.cuda.empty_cache()
    print(f"phase 16 K2 against its plain version on every view the real "
          f"family gave it: {held_summary(held)} (gate {TOL:.0e})")
    return {"counts": launches, "timings": rows, "held": held}


# ------------------------------------- the kernels no route takes (K4, K6, K9)

TILED_SHAPES = [(1 << a, 1 << b) for a in range(7, 14) for b in range(7, 14)
                if a + b <= 20]


def operands(xc, mode):
    """(re, im, out) of the complex tensor ``xc`` for a kernel check:
    planar copies, the stride-2 planes of a copy (``out`` those planes
    again in place), or (``offset``) planar planes of one buffer 4 bytes
    past a 16-byte boundary, which K4's and K6's box copies cannot read
    where they lie (``out`` those planes again)."""
    if mode == "planar":
        return xc.real.contiguous(), xc.imag.contiguous(), None
    if mode == "offset":
        m = xc.numel()
        flat = torch.empty(2 * m + 1, device=xc.device)
        re = flat[1:1 + m].view(xc.shape).copy_(xc.real)
        im = flat[1 + m:].view(xc.shape).copy_(xc.imag)
        return re, im, (re, im)
    v = torch.view_as_real(xc.clone())
    re, im = v[..., 0], v[..., 1]
    return re, im, ((re, im) if mode == "inplace" else None)


def held(name, got, want, tag, tol=TOL):
    """The error of a kernel's planes ``got`` against ``want`` (a pair of
    planes or a complex tensor), checked at ``tol``."""
    g = cplx(*got)
    w = want if isinstance(want, torch.Tensor) and want.is_complex() \
        else cplx(*want)
    if tuple(g.shape) != tuple(w.shape):
        raise AssertionError(f"{name} {tag}: shape {tuple(g.shape)}, "
                             f"expected {tuple(w.shape)}")
    e = rel_err(g, w)
    check(f"{name} {tag}", e, tol)
    return e


def phase_swap_kernel():
    """K4 at every n against fft_rows_swap_plain and numpy: row counts of
    whole and of ragged tiles (200 rows, lanes = 8), planar and stride-2
    planes, and (128 rows) planes off 16-byte alignment."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(17)
    for n in IL_NS:
        worst_plain = worst_np = 0.0
        before, cases = count_of("launch.K4"), 0
        # one plane only at the largest n; elsewhere l = 0 of three
        for L in ((1, 3) if n == IL_NS[-1] else (3,)):
            for n1 in (128, 200, 384):
                lanes = 8 if n1 == 200 else 128
                x = (rng.standard_normal((L, n1, n))
                     + 1j * rng.standard_normal((L, n1, n))
                     ).astype(np.complex64)
                xc = torch.from_numpy(x).cuda()
                for sign in (-1, +1):
                    post = 0.3
                    X = (np.fft.fft(x.astype(np.complex128)) if sign < 0
                         else np.fft.ifft(x.astype(np.complex128)) * n)
                    ref = torch.from_numpy(
                        np.ascontiguousarray((X * post).transpose(0, 2, 1))
                    ).cuda()
                    plain = local.fft_rows_swap_plain(
                        xc.real.contiguous(), xc.imag.contiguous(), sign,
                        post)
                    for mode in ("planar", "stride2") + (
                            ("offset",) if n1 == 128 else ()):
                        re, im, _ = operands(xc, mode)
                        got = local.fft_rows_swap(re, im, sign,
                                                  postscale=post,
                                                  lanes=lanes)
                        torch.cuda.synchronize()
                        tag = f"n={n} n1={n1} L={L} sign={sign} {mode}"
                        worst_plain = max(worst_plain, held(
                            "K4 vs plain", got, plain, tag))
                        worst_np = max(worst_np, held("K4 vs numpy", got,
                                                      ref, tag))
                        cases += 1
        if count_of("launch.K4") - before != cases:
            raise AssertionError(f"K4 n={n}: {count_of('launch.K4') - before} "
                                 f"launches for {cases} calls")
        tile = local.swap_tile(n)
        shape = (f"a cluster of {tile[0]} blocks a tile of {tile[1]} rows"
                 if tile else f"C={local.col_width(n)} rows a block")
        print(f"phase 17 K4 n={n} ({shape}): {cases} cases, max rel err vs "
              f"plain {worst_plain:.3e}, vs numpy {worst_np:.3e} (gate "
              f"{TOL:.0e})")


def phase_ctile_kernel():
    """K6 at every n, c in {1, 2, 8}, against fft_cols_plain and numpy:
    planar, stride-2 planes in place, the full twiddle, and planes off
    16-byte alignment in place."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(18)
    T = 1024                             # 8 tiles: c = 8 is not clamped
    for n in IL_NS:
        # at n = 1024 five planes: c = 1 (40 steps) takes the cluster tile,
        # c = 2 and 8 whole runs
        L = 5 if n == 1024 else 2 if n < 1024 else 1
        worst_plain = worst_np = 0.0
        before, cases = count_of("launch.K6"), 0
        x = (rng.standard_normal((L, n, T))
             + 1j * rng.standard_normal((L, n, T))).astype(np.complex64)
        xc = torch.from_numpy(x).cuda()
        for sign in (-1, +1):
            post = 0.3
            X = np.fft.fft(x.astype(np.complex128), axis=1)
            if sign > 0:
                X = np.fft.ifft(x.astype(np.complex128), axis=1) * n
            for mode in ("plain planar", "plain inplace", "full planar",
                         "plain offset"):
                ref, tw_n = col_reference(X, n, T, mode, sign, post)
                ref = torch.from_numpy(ref).cuda()
                kw = dict(tw_n=tw_n) if tw_n else {}
                plain = local.fft_cols_plain(xc.real.contiguous(),
                                             xc.imag.contiguous(), sign,
                                             postscale=post, **kw)
                for c in (1, 2, 8):
                    re, im, out = operands(xc, mode.split()[1])
                    got = local.fft_axis(re, im, sign, axis=1,
                                         postscale=post, ctile=c, out=out,
                                         **kw)
                    torch.cuda.synchronize()
                    if out is not None and got[0].data_ptr() != re.data_ptr():
                        raise AssertionError("in-place K6 wrote elsewhere")
                    tag = f"n={n} L={L} c={c} sign={sign} {mode}"
                    worst_plain = max(worst_plain, held("K6 vs plain", got,
                                                        plain, tag))
                    worst_np = max(worst_np, held("K6 vs numpy", got, ref,
                                                  tag))
                    cases += 1
        if count_of("launch.K6") - before != cases:
            raise AssertionError(f"K6 n={n}: {count_of('launch.K6') - before} "
                                 f"launches for {cases} calls")
        ring = local.ring_shape(n)
        print(f"phase 17 K6 n={n} ({L} x {n} x {T}, c in 1, 2, 8; runs of "
              f"{ring['columns']} columns"
              + (f" split over a cluster of {ring['cluster']} blocks"
                 if ring["cluster"] > 1 else "")
              + (", or whole runs where a step's blocks cover 128 bytes"
                 if n == 1024 else "")
              + f", a ring of {ring['slots']} slots): {cases} cases, max rel "
              f"err vs plain {worst_plain:.3e}, vs numpy {worst_np:.3e} "
              f"(gate {TOL:.0e})")


def phase_tiled_kernel():
    """K9 at each of its plane shapes against fft2_tiled_plain and
    numpy."""
    from pyfft_tpu_torch.ops import fused2d
    rng = np.random.RandomState(19)
    for ny, nx in TILED_SHAPES:
        worst_plain = worst_np = 0.0
        before, cases = count_of("launch.K9"), 0
        for L in (1, 3):
            x = (rng.standard_normal((L, ny, nx))
                 + 1j * rng.standard_normal((L, ny, nx))).astype(np.complex64)
            xc = torch.from_numpy(x).cuda()
            x128 = x.astype(np.complex128)
            for sign, post in ((-1, 0.5), (+1, 1.0 / (ny * nx))):
                X = (np.fft.fft2(x128) if sign < 0
                     else np.fft.ifft2(x128) * (ny * nx))
                ref = torch.from_numpy(X * post).cuda()
                plain = fused2d.fft2_tiled_plain(
                    xc.real.contiguous(), xc.imag.contiguous(), sign, post)
                for mode in ("planar", "stride2", "inplace"):
                    re, im, out = operands(xc, mode)
                    got = fused2d.fft2_fused_tiled(re, im, sign,
                                                   postscale=post, out=out)
                    torch.cuda.synchronize()
                    if out is not None and got[0].data_ptr() != re.data_ptr():
                        raise AssertionError("in-place K9 wrote elsewhere")
                    tag = f"{ny}x{nx} L={L} sign={sign} {mode}"
                    worst_plain = max(worst_plain, held("K9 vs plain", got,
                                                        plain, tag))
                    worst_np = max(worst_np, held("K9 vs numpy", got, ref,
                                                  tag))
                    cases += 1
        if count_of("launch.K9") - before != cases:
            raise AssertionError(f"K9 {ny}x{nx}: "
                                 f"{count_of('launch.K9') - before} launches "
                                 f"for {cases} calls")
        sh = fused2d.tiled_shape(ny, nx)
        print(f"phase 17 K9 {ny}x{nx} (a cluster of {sh['cluster']} blocks "
              f"a plane, phase 2 in tiles of {sh['run']} columns"
              + (f" split over groups of {sh['group']} blocks"
                 if sh["group"] > 1 else "")
              + f", planes cap {sh['planes']}, {sh['clusters_held']} "
              f"clusters held at once): {cases} cases, max rel err vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate "
              f"{TOL:.0e})")


def variant_b(re, im, sign, post, ctile=0):
    """The four-step variant B of (B, n1*n2) planes through the public
    entry points: a column pass with the full twiddle and a plain store
    (K5, or K6 with ``ctile``), then K4."""
    from pyfft_tpu_torch.ops import local
    B, N = re.shape
    n1 = n2 = int(math.isqrt(N))
    r, i = local.fft_axis(re.view(B, n1, n2), im.view(B, n1, n2), sign,
                          axis=-2, tw_n=N, ctile=ctile)
    r, i = local.fft_rows_swap(r, i, sign, postscale=post)
    return r.view(B, N), i.view(B, N)


def counted(want: dict, label: str, run):
    """``run()`` with the launch counts set to 0 just before and read just
    after; raise unless they are ``want`` (every other kernel 0)."""
    reset_counts()
    out = run()
    counts = read_counts()
    if counts != expect(want):
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{expect(want)}")
    return out, counts


def phase_offroute_paths(copy_gbs):
    """Phase 18: variant B at config 6+, K6 as config 4's z pass and K9 on
    config 3's planes at full size, with exact counts, every kernel call
    against its plain version, and timings."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch.ops import fused2d, local
    from pyfft_tpu_torch.utils.profiling import time_ms
    launches = dict.fromkeys(KERNELS, 0)
    checks = []          # (kernel, label, max abs err, max rel err)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def against_plain(kernel, label, got, want):
        a = float(torch.maximum((got[0] - want[0]).abs().max(),
                                (got[1] - want[1]).abs().max()))
        e = held(kernel, got, want, f"{label} vs plain")
        checks.append((kernel, label, a, e))

    # variant B at config 6+: K5 + K4, then K6 + K4, forward and inverse
    B, N = 8, 1 << 22
    x = make_data((B, N), seed=180)
    ref = numpy_ref(x, 1)
    re, im = x.real.contiguous(), x.imag.contiguous()
    errs = {}
    for c, first in ((0, "local_cols"), (8, "local_cols_ctile")):
        def round_trip(c=c):
            y = variant_b(re, im, -1, 1.0, c)
            return y, variant_b(*y, +1, 1.0 / N, c)

        (y, back), counts = counted({first: 2, "local_rows_swap": 2},
                                    f"variant B ctile={c}", round_trip)
        add(counts)
        tag = f"variant B ({'K6 c=8' if c else 'K5'} + K4)"
        errs[tag] = (rel_err(cplx(*y), ref), rel_err(cplx(*back), x))
        check(f"{tag} vs numpy", errs[tag][0])
        check(f"{tag} round trip", errs[tag][1])
        del y, back
    # each pass of variant B against its plain version, chained
    kw = dict(tw_n=N)
    r3, i3 = re.view(B, 2048, 2048), im.view(B, 2048, 2048)
    plain1 = local.fft_cols_plain(r3, i3, -1, **kw)
    p1 = local.fft_axis(r3, i3, -1, axis=-2, **kw)
    against_plain("local_cols", "variant B pass 1 (K5 full twiddle)", p1,
                  plain1)
    against_plain("local_cols_ctile", "variant B pass 1 (K6 c=8 full "
                  "twiddle)", local.fft_axis(r3, i3, -1, axis=-2, ctile=8,
                                             **kw), plain1)
    del plain1
    p2 = local.fft_rows_swap(*p1, -1)
    against_plain("local_rows_swap", "variant B pass 2 (K4)", p2,
                  local.fft_rows_swap_plain(*p1, -1))
    del p2
    print(f"phase 18 config 6+ variant B {tuple(x.shape)}: launches "
          f"{ {k: v for k, v in launches.items() if v} } over 2 forward and "
          f"2 inverse runs, "
          + ", ".join(f"{k} err {a:.3e}, round trip {b:.3e}"
                      for k, (a, b) in errs.items())
          + f" (against numpy on all {B} rows; gate {TOL:.0e})")

    # timings at config 6+: K4 alone beside K5's swapped store (the routed
    # pass 1, which K4 takes the transpose from); variant B beside the
    # routed plan.  K4's library call: torch.fft.fft over the transposed
    # complex form, out[l, k, r] = sum_j x[l, r, j] w^(jk), K4's function
    rows = []
    out = (torch.empty_like(p1[0]), torch.empty_like(p1[1]))
    moved = 2 * B * N * 8
    p1c = cplx(*p1)
    rows.append(time_pass(
        "config 6+", "variant B pass 2 (K4)", *p1,
        lambda: local.fft_rows_swap(*p1, -1, out=out),
        lambda: local.fft_rows_swap_plain(*p1, -1),
        lambda: torch.fft.fft(p1c.mT, dim=-2), moved,
        fft_flops(2048, B * 2048), copy_gbs, phase=18))
    del p1c
    rows[-1]["kernel"] = "local_rows_swap"
    rows[-1]["routed_ms"] = time_ms(lambda: local.fft_axis(
        r3, i3, -1, axis=-2, tw_n=N, swap_store=True, out=out))
    rows[-1]["pass1_ms"] = time_ms(lambda: local.fft_axis(
        r3, i3, -1, axis=-2, tw_n=N, out=out))
    print(f"    K5's swapped store (routed pass 1, full twiddle) on the same "
          f"data: {rows[-1]['routed_ms']:.4f} ms; K5's plain store (variant "
          f"B pass 1, full twiddle): {rows[-1]['pass1_ms']:.4f} ms")
    # variant B's pass 1 by K6 (c = 8: 16 steps), no library call for the
    # twiddled pass
    rows.append(time_pass(
        "config 6+", "variant B pass 1 (K6 c=8, full twiddle)", r3, i3,
        lambda: local.fft_axis(r3, i3, -1, axis=-2, tw_n=N, ctile=8,
                               out=out),
        lambda: local.fft_cols_plain(r3, i3, -1, tw_n=N), None, moved,
        fft_flops(2048, B * 2048) + 6 * B * N, copy_gbs,
        2048 * 2048 * 8, phase=18))
    rows[-1]["kernel"] = "local_cols_ctile"
    rows[-1]["k5_ms"] = rows[-2]["pass1_ms"]
    print(f"    K5's plain store on the same pass: {rows[-1]['k5_ms']:.4f} ms "
          f"({B * 2048 // (128 * 8)} K6 steps of c = 8, each a cluster of "
          f"{local.ring_shape(2048)['cluster']} blocks)")
    del p1, out
    plan = pyfft_tpu_torch.Plan((N,), device="cuda")
    vb = {"path": "config 6+", "pass": "variant B total",
          "k5_k4_ms": time_ms(lambda: variant_b(re, im, -1, 1.0)),
          "k6_k4_ms": time_ms(lambda: variant_b(re, im, -1, 1.0, 8)),
          "routed_ms": time_ms(lambda: plan.execute(re, im)),
          "library_ms": time_ms(lambda: torch.fft.fft(x)),
          "bound_ms": 2 * bound(moved, 0)[0],
          "copy_bound_ms": 2 * moved / (copy_gbs * 1e9) * 1e3}
    print(f"phase 18 config 6+ variant B total, planar: K5 + K4 "
          f"{vb['k5_k4_ms']:.4f} ms, K6 (c=8) + K4 {vb['k6_k4_ms']:.4f} ms; "
          f"the routed plan (2 K5, planar) {vb['routed_ms']:.4f} ms; two "
          f"passes' bound {vb['bound_ms']:.4f} ms at the published peaks, "
          f"{vb['copy_bound_ms']:.4f} ms at the measured copy; torch.fft.fft "
          f"{vb['library_ms']:.4f} ms (library, context only)")
    del x, ref, re, im, r3, i3
    torch.cuda.empty_cache()

    # K6 as config 4's z pass, after K8 over the last two axes
    x = make_data((256, 256, 256), seed=181)
    ref = numpy_ref(x, 3)
    re, im = x.real.contiguous(), x.imag.contiguous()

    def z_path(sign, post2, post1):
        r, i = fused2d.fft2_fused(re if sign < 0 else y[0],
                                  im if sign < 0 else y[1], sign,
                                  postscale=post2)
        return local.fft_axis(r, i, sign, axis=0, ctile=8, postscale=post1)

    y, counts = counted({"fused2d": 1, "local_cols_ctile": 1},
                        "config 4 K8 + K6", lambda: z_path(-1, 1.0, 1.0))
    add(counts)
    back, counts = counted({"fused2d": 1, "local_cols_ctile": 1},
                           "config 4 inverse", lambda: z_path(
                               +1, 1.0 / 65536, 1.0 / 256))
    add(counts)
    e4 = (rel_err(cplx(*y), ref), rel_err(cplx(*back), x))
    check("config 4 K8 + K6 vs numpy", e4[0])
    check("config 4 K8 + K6 round trip", e4[1])
    del y, back, ref
    f2 = fused2d.fft2_fused(re, im, -1)
    z3 = tuple(t.view(1, 256, 65536) for t in f2)
    zk = local.fft_axis(*z3, -1, axis=1, ctile=8)
    against_plain("local_cols_ctile", "config 4 z pass (K6 c=8)", zk,
                  local.fft_cols_plain(*z3, -1))
    del zk
    print(f"phase 18 config 4 (256^3) as K8 then K6 (c=8) over the z axis: "
          f"launches 2 fused2d, 2 local_cols_ctile over a forward and an "
          f"inverse run, err vs numpy {e4[0]:.3e}, round trip {e4[1]:.3e} "
          f"(gate {TOL:.0e})")
    out = (torch.empty_like(z3[0]), torch.empty_like(z3[1]))
    xs = cplx(*z3)
    rows.append(time_pass(
        "config 4", "z pass (K6 c=8)", *z3,
        lambda: local.fft_axis(*z3, -1, axis=1, ctile=8, out=out),
        lambda: local.fft_cols_plain(*z3, -1),
        lambda: torch.fft.fft(xs, dim=-2), 2 * 256 ** 3 * 8,
        fft_flops(256, 65536), copy_gbs, phase=18))
    rows[-1]["kernel"] = "local_cols_ctile"
    rows[-1]["routed_ms"] = time_ms(lambda: local.fft_axis(
        *z3, -1, axis=1, out=out))
    rows[-1]["ctile_ms"] = {c: time_ms(lambda c=c: local.fft_axis(
        *z3, -1, axis=1, ctile=c, out=out)) for c in (1, 2, 8)}
    print(f"    K5 (the routed z pass) on the same data: "
          f"{rows[-1]['routed_ms']:.4f} ms; K6 by c: "
          + ", ".join(f"c={c} {ms:.4f} ms"
                      for c, ms in rows[-1]["ctile_ms"].items())
          + f" ({65536 // 128 // 8} steps at c = 8, runs of "
          f"{local.ring_shape(256)['columns']} columns)")
    del x, re, im, f2, z3, out, xs
    torch.cuda.empty_cache()

    # K9 on config 3's planes, against numpy and Plan
    x = make_data((16, 1024, 1024), seed=182)
    ref = numpy_ref(x, 2)
    re, im = x.real.contiguous(), x.imag.contiguous()
    plan = pyfft_tpu_torch.Plan((1024, 1024), device="cuda")
    routed = plan.execute(x)

    def tiled_run():
        y = fused2d.fft2_fused_tiled(re, im, -1)
        return y, fused2d.fft2_fused_tiled(*y, +1,
                                           postscale=1.0 / (1 << 20))

    (y, back), counts = counted({"fused2d_tiled": 2}, "config 3 K9",
                                tiled_run)
    add(counts)
    e3 = (rel_err(cplx(*y), ref), rel_err(cplx(*y), routed),
          rel_err(cplx(*back), x))
    check("config 3 K9 vs numpy", e3[0])
    check("config 3 K9 vs Plan", e3[1])
    check("config 3 K9 round trip", e3[2])
    against_plain("fused2d_tiled", "config 3 (K9)", y,
                  fused2d.fft2_tiled_plain(re, im, -1))
    del y, back, ref, routed
    sh = fused2d.tiled_shape(1024, 1024)
    print(f"phase 18 config 3 (16 x 1024^2) through K9 (a cluster of "
          f"{sh['cluster']} blocks a plane, planes cap {sh['planes']} of "
          f"the card's L2, {sh['clusters_held']} clusters held at once): "
          f"launches 2 fused2d_tiled over a forward and an inverse run, err "
          f"vs numpy {e3[0]:.3e}, vs Plan {e3[1]:.3e}, round trip "
          f"{e3[2]:.3e} (gate {TOL:.0e})")
    out = (torch.empty_like(re), torch.empty_like(im))
    tmp = (torch.empty_like(re), torch.empty_like(im))

    def two_pass():
        local.fft_axis(re, im, -1, out=tmp)
        local.fft_axis(*tmp, -1, axis=-2, out=out)

    rows.append(time_pass(
        "config 3", "2D pass (K9)", re, im,
        lambda: fused2d.fft2_fused_tiled(re, im, -1, out=out),
        lambda: fused2d.fft2_tiled_plain(re, im, -1),
        lambda: torch.fft.fft2(x), 2 * re.numel() * 8,
        2 * fft_flops(1024, 16 * 1024), copy_gbs, phase=18))
    rows[-1]["kernel"] = "fused2d_tiled"
    rows[-1]["routed_ms"] = time_ms(two_pass)
    rows[-1]["plan_ms"] = time_ms(lambda: plan.execute(x))
    print(f"    the routed K1 + K5 on the same planes: "
          f"{rows[-1]['routed_ms']:.4f} ms; Plan.execute (complex form) "
          f"{rows[-1]['plan_ms']:.4f} ms")
    del x, re, im, out, tmp
    torch.cuda.empty_cache()
    print("phase 18 kernel calls vs plain: "
          + ", ".join(f"{lab} max abs {a:.3e} rel {e:.3e}"
                      for _, lab, a, e in checks) + f" (gate {TOL:.0e})")
    return {"counts": launches, "checks": checks, "timed": rows,
            "variant_b": vb}


# ------------------------------------------------- K10, the int8 stage


def tiles_err(got, ref, splits) -> float:
    """The worst error of any tile of ``got`` against its own peak in
    ``ref``: ``splits`` is [(dim, size)], the tiles that share one alignment
    exponent in the plain version (a kernel's group is a subset of one)."""
    parts = [(got, ref)]
    for dim, size in splits:
        parts = [(a, b) for g, r in parts
                 for a, b in zip(g.split(size, dim), r.split(size, dim))]
    return max(rel_err(a, b) for a, b in parts)


def i8_ops(n: int, f: int, points: int) -> tuple[float, float]:
    """(FP32 flops, int8 operations) of an int8 transform of length n over
    ``points`` complex points: the radix stages by 5 n log2(n/f) a
    transform, the f-point stage by 72 f a point (9 channel pairs of a
    2f x 2f matrix)."""
    if not f:
        return fft_flops(n, points // n), 0.0
    return 5.0 * points * math.log2(n // f), 72.0 * f * points


def spread_rows(x: np.ndarray) -> np.ndarray:
    """Magnitudes 2^20 apart from one 128-row tile to the next."""
    x = x.copy()
    x[128:256] *= 2.0 ** -20
    x[256:] *= 2.0 ** 10
    return x


def numpy_refs(x: torch.Tensor, ndim: int):
    """numpy's forward and inverse (normalised) transforms of the last
    ``ndim`` axes of ``x``, on the card; the inverse as conj(fft(conj x))
    / size."""
    size = math.prod(x.shape[-ndim:])
    return numpy_ref(x, ndim), numpy_ref(x.conj().resolve_conj(), ndim).conj() / size


def phase_int8_stages():
    """The stage each int8 row kernel runs, as the kernel reports it
    (pyfft_local_rows_i8_stage), against local.rows_i8_stage, for every
    (n, f) of the row, column and default chains: the pairs the row
    kernels are instantiated at."""
    from pyfft_tpu_torch.ops import local
    code = {"wgmma": 1, "mma": 0}
    seen = {}
    for n in IL_NS:
        for chain in (local.row_factors, local.col_factors,
                      local.default_factors):
            f = local.matrix_factor(chain(n))
            if not f:
                continue
            want = local.rows_i8_stage(n, f)
            got = local._rows_i8_stage_fn()(n.bit_length() - 1,
                                            f.bit_length() - 1)
            if got != code[want]:
                raise AssertionError(f"int8 row kernel n={n} f={f} reports "
                                     f"stage {got}, rows_i8_stage says "
                                     f"{want}")
            seen[(n, f)] = want
    print("phase 19 int8 row kernels' stage, as each reports it, agrees "
          "with rows_i8_stage: " + ", ".join(
              f"({n}, {f}) {w}" for (n, f), w in sorted(seen.items())))


def phase_int8_rows():
    """K10 in K1 at every n against fft_rows_plain(precision="int8") and
    numpy, per 128-row tile (the plain version's alignment group)."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(19)
    for n in IL_NS:
        f = local.matrix_factor(local.row_factors(n))
        worst_plain = worst_np = 0.0
        before = (count_of("launch.K1+K10"), count_of("launch.K1"))
        cases = 0
        for rows in (1, 130, 384):
            x = (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            if rows == 384:
                x = spread_rows(x)
            xc = torch.from_numpy(x).cuda()
            for sign, post in posts("complex64", n):
                X = (np.fft.fft(x.astype(np.complex128)) if sign < 0
                     else np.fft.ifft(x.astype(np.complex128)) * n)
                ref = torch.from_numpy(X * post).cuda()
                plain = cplx(*local.fft_rows_plain(
                    xc.real.contiguous(), xc.imag.contiguous(), sign, post,
                    precision="int8"))
                for mode in ("planar", "stride2", "inplace"):
                    re, im, out = operands(xc, mode)
                    got = local.fft_axis(re, im, sign, postscale=post,
                                         precision="int8", out=out)
                    torch.cuda.synchronize()
                    if out is not None and got[0].data_ptr() != re.data_ptr():
                        raise AssertionError("in-place int8 rows wrote "
                                             "elsewhere")
                    g = cplx(*got)
                    tag = f"n={n} rows={rows} sign={sign} {mode}"
                    e_plain = tiles_err(g, plain, [(0, 128)])
                    e_np = tiles_err(g, ref, [(0, 128)])
                    check(f"K1+K10 vs plain {tag}", e_plain)
                    check(f"K1+K10 vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        made = (count_of("launch.K1+K10") - before[0],
                count_of("launch.K1") - before[1])
        if made != ((cases, 0) if f else (0, cases)):
            raise AssertionError(f"int8 rows n={n}: launches (int8, float) "
                                 f"{made} for {cases} calls")
        stage = f" {local.rows_i8_stage(n, f)} stage" if f else ""
        print(f"phase 19 K1+K10 n={n} (f={f or 'none: K1 unchanged'}"
              f"{stage}): "
              f"{cases} cases incl. a 2^20 spread over 128-row tiles, max "
              f"rel err per tile vs plain {worst_plain:.3e}, vs numpy "
              f"{worst_np:.3e} (gate {TOL:.0e})")


I8_COL_MODES = ("plain planar", "plain inplace", "full planar",
                "full swap_store")


def phase_int8_cols():
    """K10 in K5 at every n, T in {128, 384} and a ragged 200, against
    fft_cols_plain(precision="int8") and numpy, per (l, 128-column tile)."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(20)
    for n in IL_NS:
        f = local.matrix_factor(local.col_factors(n))
        worst_plain = worst_np = 0.0
        before = (count_of("launch.K5+K10"), count_of("launch.K5"))
        cases = 0
        for T in (128, 384, 200):
            L = 3
            x = (rng.standard_normal((L, n, T))
                 + 1j * rng.standard_normal((L, n, T))).astype(np.complex64)
            x[1] *= 2.0 ** -20
            x[2, :, 128:256] *= 2.0 ** 10
            xc = torch.from_numpy(x).cuda()
            for sign, post in posts("complex64", n):
                X = np.fft.fft(x.astype(np.complex128), axis=1)
                if sign > 0:
                    X = np.fft.ifft(x.astype(np.complex128), axis=1) * n
                for mode in I8_COL_MODES:
                    if T % 128 and mode != "plain planar":
                        continue
                    if mode == "full swap_store" and T != 128:
                        continue
                    ref, tw_n = col_reference(X, n, T, mode, sign, post)
                    kw = col_kwargs(mode, tw_n)
                    if mode == "full planar":
                        kw = dict(tw_n=tw_n)
                    plain = cplx(*local.fft_cols_plain(
                        xc.real.contiguous(), xc.imag.contiguous(), sign,
                        postscale=post, precision="int8", **kw))
                    re, im, out = operands(xc, mode.split()[1])
                    got = local.fft_axis(re, im, sign, axis=1, postscale=post,
                                         precision="int8", out=out, **kw)
                    torch.cuda.synchronize()
                    if out is not None and got[0].data_ptr() != re.data_ptr():
                        raise AssertionError("in-place int8 columns wrote "
                                             "elsewhere")
                    g = cplx(*got)
                    tiles = [(0, 1), (1 if "swap" in mode else 2, 128)]
                    tag = f"n={n} L={L} T={T} sign={sign} {mode}"
                    e_plain = tiles_err(g, plain, tiles)
                    e_np = tiles_err(g, torch.from_numpy(ref).cuda(), tiles)
                    check(f"K5+K10 vs plain {tag}", e_plain)
                    check(f"K5+K10 vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        made = (count_of("launch.K5+K10") - before[0],
                count_of("launch.K5") - before[1])
        if made != ((cases, 0) if f else (0, cases)):
            raise AssertionError(f"int8 columns n={n}: launches (int8, "
                                 f"float) {made} for {cases} calls")
        width = local.col_width_i8(n) if f else local.col_width(n)
        print(f"phase 19 K5+K10 n={n} (f={f or 'none: K5 unchanged'}, "
              f"C={width} columns a block): {cases} cases, L=3 with a 2^20 "
              f"spread over l and tiles, max rel err per tile vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate {TOL:.0e})")


def phase_int8_paths(copy_gbs):
    """Phase 19's paths: config 2 through K1+K10 and config 3 through
    K1+K10 then K5+K10, forward and inverse, with exact counts, against
    numpy, every kernel call held against its plain version; timings
    beside the float kernels and the library."""
    from pyfft_tpu_torch.ops import local
    from pyfft_tpu_torch.utils.profiling import time_ms
    launches = dict.fromkeys(KERNELS, 0)
    checks = []          # (kernel, label, max abs err, max rel err)
    rows = []

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def against_plain(kernel, label, got, want):
        a = float(torch.maximum((got[0] - want[0]).abs().max(),
                                (got[1] - want[1]).abs().max()))
        e = held(kernel, got, want, f"{label} vs plain")
        checks.append((kernel, label, a, e))

    def fft2_i8(re, im, sign, post):
        r, i = local.fft_axis(re, im, sign, precision="int8")
        return local.fft_axis(r, i, sign, axis=-2, postscale=post,
                              precision="int8")

    # config 2: rows, forward and inverse of the same data (each one
    # transform's error; a round trip would add two)
    x = make_data((BATCH, N), seed=190)
    ref, ref_inv = numpy_refs(x, 1)
    re, im = x.real.contiguous(), x.imag.contiguous()

    def both_rows():
        return (local.fft_axis(re, im, -1, precision="int8"),
                local.fft_axis(re, im, +1, postscale=1.0 / N,
                               precision="int8"))

    (y, yi), counts = counted({"local_rows_i8": 2}, "config 2 int8",
                              both_rows)
    add(counts)
    e2 = (rel_err(cplx(*y), ref), rel_err(cplx(*yi), ref_inv))
    check("config 2 int8 forward vs numpy", e2[0])
    check("config 2 int8 inverse vs numpy", e2[1])
    against_plain("local_rows_i8", "config 2 (K1+K10)", y,
                  local.fft_rows_plain(re, im, -1, precision="int8"))
    del y, yi, ref, ref_inv
    print(f"phase 19 config 2 {tuple(x.shape)} through K1+K10 (f=64): "
          f"launches {counts['local_rows_i8']} local_rows_i8 over a forward "
          f"and an inverse run, err vs numpy {e2[0]:.3e} forward, "
          f"{e2[1]:.3e} inverse (gate {TOL:.0e})")
    out = (torch.empty_like(re), torch.empty_like(im))
    fl, ops = i8_ops(N, 64, BATCH * N)
    rows.append(time_pass(
        "config 2", "rows (K1+K10)", re, im,
        lambda: local.fft_axis(re, im, -1, precision="int8", out=out),
        lambda: local.fft_rows_plain(re, im, -1, precision="int8"),
        lambda: torch.fft.fft(x), 2 * BATCH * N * 8, fl, copy_gbs, phase=19,
        int8_ops=ops))
    rows[-1]["kernel"] = "local_rows_i8"
    rows[-1]["float_ms"] = time_ms(lambda: local.fft_axis(re, im, -1,
                                                          out=out))
    print(f"    K1 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    # the largest W: K1+K10 at n = 8192 (f = 128), 2^24 points
    xs = x.view(BATCH * N // 8192, 8192)
    r8, i8 = xs.real.contiguous(), xs.imag.contiguous()
    fl, ops = i8_ops(8192, 128, BATCH * N)
    rows.append(time_pass(
        "n = 8192", "rows (K1+K10, f=128)", r8, i8,
        lambda: local.fft_axis(r8, i8, -1, precision="int8",
                               out=(out[0].view(r8.shape),
                                    out[1].view(r8.shape))),
        lambda: local.fft_rows_plain(r8, i8, -1, precision="int8"),
        lambda: torch.fft.fft(xs), 2 * BATCH * N * 8, fl, copy_gbs, phase=19,
        int8_ops=ops))
    rows[-1]["kernel"] = "local_rows_i8"
    rows[-1]["float_ms"] = time_ms(lambda: local.fft_axis(
        r8, i8, -1, out=(out[0].view(r8.shape), out[1].view(r8.shape))))
    print(f"    K1 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    del x, re, im, out, xs, r8, i8
    torch.cuda.empty_cache()

    # config 3: K1+K10 then K5+K10, forward and inverse
    x = make_data((16, 1024, 1024), seed=191)
    ref, ref_inv = numpy_refs(x, 2)
    re, im = x.real.contiguous(), x.imag.contiguous()

    def both_2d():
        return (fft2_i8(re, im, -1, 1.0),
                fft2_i8(re, im, +1, 1.0 / (re.shape[-1] * re.shape[-2])))

    (y, yi), counts = counted({"local_rows_i8": 2, "local_cols_i8": 2},
                              "config 3 int8", both_2d)
    add(counts)
    e3 = (rel_err(cplx(*y), ref), rel_err(cplx(*yi), ref_inv))
    check("config 3 int8 forward vs numpy", e3[0])
    check("config 3 int8 inverse vs numpy", e3[1])
    del y, yi, ref, ref_inv
    p1 = local.fft_axis(re, im, -1, precision="int8")
    against_plain("local_rows_i8", "config 3 row pass (K1+K10)", p1,
                  local.fft_rows_plain(re, im, -1, precision="int8"))
    p2 = local.fft_axis(*p1, -1, axis=-2, precision="int8")
    against_plain("local_cols_i8", "config 3 column pass (K5+K10)", p2,
                  local.fft_cols_plain(*p1, -1, precision="int8"))
    del p2
    print(f"phase 19 config 3 {tuple(x.shape)} through K1+K10 then K5+K10 "
          f"(f=64 both): launches {counts['local_rows_i8']} local_rows_i8, "
          f"{counts['local_cols_i8']} local_cols_i8 over a forward and an "
          f"inverse run, err vs numpy {e3[0]:.3e} forward, {e3[1]:.3e} "
          f"inverse (gate {TOL:.0e})")
    pr, pi = p1
    out = (torch.empty_like(pr), torch.empty_like(pi))
    pc = cplx(pr, pi)
    fl, ops = i8_ops(1024, 64, pr.numel())
    rows.append(time_pass(
        "config 3", "column pass (K5+K10)", pr, pi,
        lambda: local.fft_axis(pr, pi, -1, axis=-2, precision="int8",
                               out=out),
        lambda: local.fft_cols_plain(pr, pi, -1, precision="int8"),
        lambda: torch.fft.fft(pc, dim=-2), 2 * pr.numel() * 8, fl, copy_gbs,
        phase=19, int8_ops=ops))
    rows[-1]["kernel"] = "local_cols_i8"
    rows[-1]["float_ms"] = time_ms(lambda: local.fft_axis(pr, pi, -1,
                                                          axis=-2, out=out))
    print(f"    K5 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    del x, re, im, p1, pr, pi, pc, out
    torch.cuda.empty_cache()

    print("phase 19 kernel calls vs plain: "
          + ", ".join(f"{lab} max abs {a:.3e} rel {e:.3e}"
                      for _, lab, a, e in checks) + f" (gate {TOL:.0e})")
    return {"counts": launches, "checks": checks, "timed": rows,
            "errs": {"config 2": e2, "config 3": e3}}


# --------------------------------- K10 in K4, K8, K9 and the fold (phase 20)


def spread_planes(x: np.ndarray) -> np.ndarray:
    """Three leading slices (planes, or l) 2^20 apart: the second 2^-20,
    the third 2^10 times the first; fewer are left as they are."""
    x = x.copy()
    if x.shape[0] == 3:
        x[1] *= 2.0 ** -20
        x[2] *= 2.0 ** 10
    return x


def rand_c64(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def phase_int8_swap():
    """K4+K10 at every n, n1 in {128, 384}, against
    fft_rows_swap_plain(precision="int8") and numpy per 128-row group."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(21)
    for n in IL_NS:
        f = local.matrix_factor(local.default_factors(n))
        worst_plain = worst_np = 0.0
        before = (count_of("launch.K4+K10"), count_of("launch.K4"))
        cases = 0
        for n1 in (128, 384):
            x = rand_c64(rng, (1, n1, n))
            if n1 == 384:
                x[0] = spread_rows(x[0])
            xc = torch.from_numpy(x).cuda()
            x128 = x.astype(np.complex128)
            for sign in (-1, +1):
                post = 0.3
                X = np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * n
                ref = torch.from_numpy(np.ascontiguousarray(
                    (X * post).transpose(0, 2, 1))).cuda()
                plain = cplx(*local.fft_rows_swap_plain(
                    xc.real.contiguous(), xc.imag.contiguous(), sign, post,
                    precision="int8"))
                for mode in ("planar", "stride2"):
                    re, im, _ = operands(xc, mode)
                    got = local.fft_rows_swap(re, im, sign, postscale=post,
                                              precision="int8")
                    torch.cuda.synchronize()
                    g = cplx(*got)
                    tiles = [(0, 1), (2, 128)]
                    tag = f"n={n} n1={n1} sign={sign} {mode}"
                    e_plain = tiles_err(g, plain, tiles)
                    e_np = tiles_err(g, ref, tiles)
                    check(f"K4+K10 vs plain {tag}", e_plain)
                    check(f"K4+K10 vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        made = (count_of("launch.K4+K10") - before[0],
                count_of("launch.K4") - before[1])
        if made != ((cases, 0) if f else (0, cases)):
            raise AssertionError(f"int8 K4 n={n}: launches (int8, float) "
                                 f"{made} for {cases} calls")
        width = local.col_width_i8(n) if f else local.col_width(n)
        print(f"phase 20 K4+K10 n={n} (f={f or 'none: K4 unchanged'}, "
              f"C={width} rows a block): {cases} cases incl. a 2^20 spread "
              f"over 128-row groups, max rel err per group vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate {TOL:.0e})")
    phase_int8_swap_lanes(rng)


def phase_int8_swap_lanes(rng):
    """K4+K10 with lanes = 64 at n = 16 and 32, where a block holds 128
    rows (two of JAX's groups): against fft_rows_swap_plain(lanes=64) and
    numpy per 64-row group, every other group 2^20 above the rest."""
    from pyfft_tpu_torch.ops import local
    lanes = 64
    for n in (16, 32):
        before = count_of("launch.K4+K10")
        worst_plain = worst_np = 0.0
        cases = 0
        x = rand_c64(rng, (2, 384, n))
        x[:, lanes:2 * lanes] *= 2.0 ** 20
        x[:, 3 * lanes:4 * lanes] *= 2.0 ** -20
        xc = torch.from_numpy(x).cuda()
        x128 = x.astype(np.complex128)
        for sign in (-1, +1):
            X = np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * n
            ref = torch.from_numpy(np.ascontiguousarray(
                X.transpose(0, 2, 1))).cuda()
            plain = cplx(*local.fft_rows_swap_plain(
                xc.real.contiguous(), xc.imag.contiguous(), sign,
                precision="int8", lanes=lanes))
            re, im, _ = operands(xc, "planar")
            g = cplx(*local.fft_rows_swap(re, im, sign, lanes=lanes,
                                          precision="int8"))
            torch.cuda.synchronize()
            tiles = [(0, 1), (2, lanes)]
            tag = f"n={n} lanes={lanes} sign={sign}"
            e_plain = tiles_err(g, plain, tiles)
            e_np = tiles_err(g, ref, tiles)
            check(f"K4+K10 vs plain {tag}", e_plain)
            check(f"K4+K10 vs numpy {tag}", e_np)
            worst_plain = max(worst_plain, e_plain)
            worst_np = max(worst_np, e_np)
            cases += 1
        if count_of("launch.K4+K10") - before != cases:
            raise AssertionError(f"K4+K10 lanes={lanes} n={n}: "
                                 f"{count_of('launch.K4+K10') - before} "
                                 f"launches for {cases} calls")
        print(f"phase 20 K4+K10 n={n} lanes={lanes} (C="
              f"{local.col_width_i8(n)} rows a block, groups of "
              f"{local.swap_i8_group(n, lanes)} rows): {cases} cases, a 2^20 "
              f"spread over {lanes}-row groups, max rel err per group vs "
              f"plain {worst_plain:.3e}, vs numpy {worst_np:.3e} (gate "
              f"{TOL:.0e})")


def phase_int8_2d(tiled: bool):
    """K8+K10 (or K9+K10) at each of its plane shapes, 1 and 3 planes
    2^20 apart, against the plain version (precision="int8") and numpy per
    plane."""
    from pyfft_tpu_torch.ops import fused2d
    if tiled:
        name, shapes, fn, plain_fn = ("K9+K10", TILED_SHAPES,
                                      fused2d.fft2_fused_tiled,
                                      fused2d.fft2_tiled_plain)
        count, cluster = (lambda: count_of("launch.K9+K10"),
                          fused2d.tiled_cluster_size)
    else:
        name, shapes, fn, plain_fn = ("K8+K10", FUSED_SHAPES,
                                      fused2d.fft2_fused, fused2d.fft2_plain)
        count, cluster = (lambda: count_of("launch.K8+K10"),
                          fused2d.cluster_size)
    rng = np.random.RandomState(23 if tiled else 22)
    stage_fn = fused2d._i8_stage_fn(tiled)
    for ny, nx in shapes:
        ly, lx = ny.bit_length() - 1, nx.bit_length() - 1
        stage = {1: "wgmma", 0: "mma"}.get(stage_fn(ly, lx), "none")
        if stage != fused2d.i8_stage(ny, nx, tiled) or stage != "wgmma":
            raise AssertionError(f"{name} {ny}x{nx} reports stage {stage}, "
                                 f"i8_stage says "
                                 f"{fused2d.i8_stage(ny, nx, tiled)}")
        placed = ""
        if not tiled:
            clusters = fused2d._i8_clusters_fn()(ly, lx)
            if clusters < 1:
                raise AssertionError(f"{name} {ny}x{nx}: no cluster places "
                                     f"({clusters})")
            placed = f", {clusters} clusters at once"
        worst_plain = worst_np = 0.0
        before, cases = count(), 0
        for L in (1, 3):
            x = spread_planes(rand_c64(rng, (L, ny, nx)))
            xc = torch.from_numpy(x).cuda()
            x128 = x.astype(np.complex128)
            for sign in (-1, +1):
                post = 0.3
                X = (np.fft.fft2(x128) if sign < 0
                     else np.fft.ifft2(x128) * (ny * nx))
                ref = torch.from_numpy(X * post).cuda()
                plain = cplx(*plain_fn(xc.real.contiguous(),
                                       xc.imag.contiguous(), sign, post,
                                       precision="int8"))
                for mode in ("planar", "stride2", "inplace"):
                    re, im, out = operands(xc, mode)
                    got = fn(re, im, sign, postscale=post, precision="int8",
                             out=out)
                    torch.cuda.synchronize()
                    if out is not None and got[0].data_ptr() != re.data_ptr():
                        raise AssertionError(f"in-place {name} wrote "
                                             "elsewhere")
                    g = cplx(*got)
                    tag = f"{ny}x{nx} L={L} sign={sign} {mode}"
                    e_plain = tiles_err(g, plain, [(0, 1)])
                    e_np = tiles_err(g, ref, [(0, 1)])
                    check(f"{name} vs plain {tag}", e_plain)
                    check(f"{name} vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        if count() - before != cases:
            raise AssertionError(f"{name} {ny}x{nx}: {count() - before} "
                                 f"launches for {cases} calls")
        print(f"phase 20 {name} {ny}x{nx} ({stage} stage, a cluster of "
              f"{cluster(ny, nx)} blocks a plane{placed}): {cases} cases "
              f"incl. 3 planes 2^20 apart, "
              f"max rel err per plane vs plain {worst_plain:.3e}, vs numpy "
              f"{worst_np:.3e} (gate {TOL:.0e})")


FOLD_SHAPES = [(2, n, 8, x) for n in (8, 256, 1024) for x in (128, 256, 384)
               if n * x <= 1 << 17]


def phase_int8_fold():
    """fft_axis_fold(precision="int8") (K5+K10 over the native layout) at
    (2, n, 8, x_ext), every other 128-column slice 2^20 above the rest,
    against fft_cols_plain with the fold's groups and numpy per group."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(24)
    for shape in FOLD_SHAPES:
        L, n, rows, x_ext = shape
        T = rows * x_ext
        if not local.supported_fold(torch.empty(shape), 1):
            raise AssertionError(f"fold does not take {shape}")
        f = local.matrix_factor(local.col_factors(n))
        lanes = local.fold_lanes(n, x_ext)
        x = rand_c64(rng, shape)
        x.reshape(L, n, -1, 128)[:, :, 1::2] *= 2.0 ** 20
        xc = torch.from_numpy(x).cuda()
        x128 = x.astype(np.complex128)
        worst_plain = worst_np = 0.0
        before = (count_of("launch.K5+K10"), count_of("launch.K5"))
        cases = 0
        for sign in (-1, +1):
            post = 0.3
            X = (np.fft.fft(x128, axis=1) if sign < 0
                 else np.fft.ifft(x128, axis=1) * n)
            ref = torch.from_numpy(X * post).cuda().view(L, n, T)
            plain = cplx(*local.fft_cols_plain(
                xc.real.contiguous().view(L, n, T),
                xc.imag.contiguous().view(L, n, T), sign, postscale=post,
                precision="int8", lanes=lanes))
            for mode in ("planar", "inplace"):
                re, im, out = operands(xc, mode)
                got = local.fft_axis_fold(re, im, sign, axis=1,
                                          postscale=post, precision="int8",
                                          out=out)
                torch.cuda.synchronize()
                if out is not None and got[0].data_ptr() != re.data_ptr():
                    raise AssertionError("in-place fold wrote elsewhere")
                g = cplx(*got).reshape(L, n, T)
                tiles = [(0, 1), (2, lanes)]
                tag = f"{shape} sign={sign} {mode}"
                e_plain = tiles_err(g, plain, tiles)
                e_np = tiles_err(g, ref, tiles)
                check(f"fold+K10 vs plain {tag}", e_plain)
                check(f"fold+K10 vs numpy {tag}", e_np)
                worst_plain = max(worst_plain, e_plain)
                worst_np = max(worst_np, e_np)
                cases += 1
        made = (count_of("launch.K5+K10") - before[0],
                count_of("launch.K5") - before[1])
        if made != ((cases, 0) if f else (0, cases)):
            raise AssertionError(f"int8 fold {shape}: launches (int8, "
                                 f"float) {made} for {cases} calls")
        print(f"phase 20 fold {shape} (f={f or 'none: K5 unchanged'}, JAX "
              f"slices of {lanes} columns): {cases} cases, 128-column "
              f"slices 2^20 apart, max rel err per slice vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate {TOL:.0e})")


def phase_int8_host_paths(copy_gbs):
    """Phase 20's paths at full size, forward and inverse with exact
    counts, against numpy and, call by call, the plain versions: config 4
    through K8+K10, then its z pass by K5+K10 and again by the fold; config
    3 through K9+K10; config 6+ variant B through K5+K10 (full twiddle)
    then K4+K10 (n = 2048, f = 128).  Timings of K4+K10, K8+K10 and K9+K10
    beside their float kernels, plain versions, bounds and library calls."""
    from pyfft_tpu_torch.ops import fused2d, local
    from pyfft_tpu_torch.utils.profiling import time_ms
    launches = dict.fromkeys(KERNELS, 0)
    checks = []          # (kernel, label, max abs err, max rel err)
    rows = []
    errs = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def against_plain(kernel, label, got, want):
        a = float(torch.maximum((got[0] - want[0]).abs().max(),
                                (got[1] - want[1]).abs().max()))
        e = held(kernel, got, want, f"{label} vs plain")
        checks.append((kernel, label, a, e))

    def both(label, want, run, ref, ref_inv, size):
        """run(sign, post) forward and inverse (post 1 / size) with exact
        counts, each against numpy."""
        (y, yi), counts = counted(want, label, lambda: (
            run(-1, 1.0), run(+1, 1.0 / size)))
        add(counts)
        e = (rel_err(cplx(*y), ref), rel_err(cplx(*yi), ref_inv))
        check(f"{label} forward vs numpy", e[0])
        check(f"{label} inverse vs numpy", e[1])
        errs[label] = e
        return counts

    # config 4: K8+K10 over the last two axes, then the z pass
    x = make_data((256, 256, 256), seed=200)
    ref, ref_inv = numpy_refs(x, 3)
    re, im = x.real.contiguous(), x.imag.contiguous()
    size = x.numel()

    def k8(sign, post):
        return fused2d.fft2_fused(re, im, sign, postscale=post,
                                  precision="int8")

    for z in ("K5+K10", "fold"):
        zfn = local.fft_axis_fold if z == "fold" else local.fft_axis

        def run(sign, post, zfn=zfn):
            return zfn(*k8(sign, post), sign, axis=0, precision="int8")

        both(f"config 4 K8+K10, {z}", {"fused2d_i8": 2, "local_cols_i8": 2},
             run, ref, ref_inv, size)
    del ref, ref_inv
    p1 = k8(-1, 1.0)
    against_plain("fused2d_i8", "config 4 (K8+K10)", p1, fused2d.fft2_plain(
        re, im, -1, precision="int8"))
    z3 = tuple(t.view(1, 256, 65536) for t in p1)
    against_plain("local_cols_i8", "config 4 z pass (K5+K10)",
                  local.fft_axis(*z3, -1, axis=1, precision="int8"),
                  local.fft_cols_plain(*z3, -1, precision="int8"))
    fold = local.fft_axis_fold(*p1, -1, axis=0, precision="int8")
    against_plain("local_cols_i8", "config 4 z pass (fold+K10, f=32)",
                  tuple(t.view(1, 256, 65536) for t in fold),
                  local.fft_cols_plain(*z3, -1, precision="int8",
                                       lanes=local.fold_lanes(256, 256)))
    del p1, z3, fold
    print(f"phase 20 config 4 (256^3) through K8+K10 (f=64 both axes), then "
          f"the z pass by K5+K10 and again by fft_axis_fold (f=32): "
          f"launches 2 fused2d_i8 and 2 local_cols_i8 each way, err vs "
          f"numpy "
          + ", ".join(f"{k.split(', ')[1]} {a:.3e} forward, {b:.3e} inverse"
                      for k, (a, b) in errs.items() if "config 4" in k)
          + f" (gate {TOL:.0e})")
    out = (torch.empty_like(re), torch.empty_like(im))
    fl, ops = i8_ops(256, 64, size)
    rows.append(time_pass(
        "config 4", "2D pass (K8+K10)", re, im,
        lambda: fused2d.fft2_fused(re, im, -1, precision="int8", out=out),
        lambda: fused2d.fft2_plain(re, im, -1, precision="int8"),
        lambda: torch.fft.fft2(x), 2 * size * 8, 2 * fl, copy_gbs,
        phase=20, int8_ops=2 * ops))
    rows[-1]["kernel"] = "fused2d_i8"
    rows[-1]["float_ms"] = time_ms(lambda: fused2d.fft2_fused(re, im, -1,
                                                              out=out))
    print(f"    K8 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    del x, re, im, out
    torch.cuda.empty_cache()

    # config 3: K9+K10
    x = make_data((16, 1024, 1024), seed=201)
    ref, ref_inv = numpy_refs(x, 2)
    re, im = x.real.contiguous(), x.imag.contiguous()
    both("config 3 K9+K10", {"fused2d_tiled_i8": 2},
         lambda sign, post: fused2d.fft2_fused_tiled(
             re, im, sign, postscale=post, precision="int8"), ref, ref_inv,
         1 << 20)
    del ref, ref_inv
    against_plain("fused2d_tiled_i8", "config 3 (K9+K10)",
                  fused2d.fft2_fused_tiled(re, im, -1, precision="int8"),
                  fused2d.fft2_tiled_plain(re, im, -1, precision="int8"))
    e = errs["config 3 K9+K10"]
    print(f"phase 20 config 3 {tuple(x.shape)} through K9+K10 (f=64 both "
          f"axes, a cluster of {fused2d.tiled_cluster_size(1024, 1024)} "
          f"blocks a plane): launches 2 fused2d_tiled_i8, err vs numpy "
          f"{e[0]:.3e} forward, {e[1]:.3e} inverse (gate {TOL:.0e})")
    out = (torch.empty_like(re), torch.empty_like(im))
    fl, ops = i8_ops(1024, 64, re.numel())
    rows.append(time_pass(
        "config 3", "2D pass (K9+K10)", re, im,
        lambda: fused2d.fft2_fused_tiled(re, im, -1, precision="int8",
                                         out=out),
        lambda: fused2d.fft2_tiled_plain(re, im, -1, precision="int8"),
        lambda: torch.fft.fft2(x), 2 * re.numel() * 8, 2 * fl, copy_gbs,
        phase=20, int8_ops=2 * ops))
    rows[-1]["kernel"] = "fused2d_tiled_i8"
    rows[-1]["float_ms"] = time_ms(lambda: fused2d.fft2_fused_tiled(
        re, im, -1, out=out))
    print(f"    K9 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    del x, re, im, out
    torch.cuda.empty_cache()

    # config 6+ variant B: K5+K10 with the full twiddle, then K4+K10
    B, N6 = 8, 1 << 22
    x = make_data((B, N6), seed=202)
    ref, ref_inv = numpy_refs(x, 1)
    re, im = x.real.contiguous(), x.imag.contiguous()

    def vb(sign, post):
        p, q = local.fft_axis(re.view(B, 2048, 2048), im.view(B, 2048, 2048),
                              sign, axis=-2, tw_n=N6, precision="int8")
        p, q = local.fft_rows_swap(p, q, sign, postscale=post,
                                   precision="int8")
        return p.view(B, N6), q.view(B, N6)

    both("config 6+ variant B int8", {"local_cols_i8": 2,
                                      "local_rows_swap_i8": 2}, vb, ref,
         ref_inv, N6)
    del ref, ref_inv
    r3, i3 = re.view(B, 2048, 2048), im.view(B, 2048, 2048)
    p1 = local.fft_axis(r3, i3, -1, axis=-2, tw_n=N6, precision="int8")
    against_plain("local_cols_i8", "variant B pass 1 (K5+K10, full "
                  "twiddle)", p1, local.fft_cols_plain(
                      r3, i3, -1, tw_n=N6, precision="int8"))
    against_plain("local_rows_swap_i8", "variant B pass 2 (K4+K10, f=128)",
                  local.fft_rows_swap(*p1, -1, precision="int8"),
                  local.fft_rows_swap_plain(*p1, -1, precision="int8"))
    e = errs["config 6+ variant B int8"]
    print(f"phase 20 config 6+ variant B {tuple(x.shape)} through K5+K10 "
          f"(f=64, full twiddle) then K4+K10 (n=2048, f=128): launches 2 "
          f"local_cols_i8, 2 local_rows_swap_i8, err vs numpy {e[0]:.3e} "
          f"forward, {e[1]:.3e} inverse, on all {B} rows (gate {TOL:.0e})")
    out = (torch.empty_like(p1[0]), torch.empty_like(p1[1]))
    p1c = cplx(*p1)
    fl, ops = i8_ops(2048, 128, B * N6)
    rows.append(time_pass(
        "config 6+", "variant B pass 2 (K4+K10)", *p1,
        lambda: local.fft_rows_swap(*p1, -1, precision="int8", out=out),
        lambda: local.fft_rows_swap_plain(*p1, -1, precision="int8"),
        lambda: torch.fft.fft(p1c.mT, dim=-2), 2 * B * N6 * 8, fl, copy_gbs,
        phase=20, int8_ops=ops))
    rows[-1]["kernel"] = "local_rows_swap_i8"
    rows[-1]["float_ms"] = time_ms(lambda: local.fft_rows_swap(*p1, -1,
                                                               out=out))
    print(f"    K4 (float) on the same data: {rows[-1]['float_ms']:.4f} ms")
    del x, re, im, r3, i3, p1, p1c, out
    torch.cuda.empty_cache()
    print("phase 20 kernel calls vs plain: "
          + ", ".join(f"{lab} max abs {a:.3e} rel {e:.3e}"
                      for _, lab, a, e in checks) + f" (gate {TOL:.0e})")
    return {"counts": launches, "checks": checks, "timed": rows,
            "errs": errs}


# ------------------------------------------ K10 inside K2 (phase 21)


def il_operand(xc: torch.Tensor, mode: str) -> tuple:
    """(v, out) of the complex (rows, n) tensor ``xc`` for a K2+K10 check:
    its interleaved float view out of place, the same view in place, or
    the view of a copy whose rows lie 2n + 16 floats apart."""
    if mode == "stride":
        rows, n = xc.shape
        big = torch.zeros((rows, n + 8), dtype=xc.dtype, device=xc.device)
        big[:, :n] = xc
        return torch.view_as_real(big[:, :n]).flatten(-2), None
    v = xc.clone().view(torch.float32)
    return v, (v if mode == "inplace" else None)


def phase_int8_il():
    """K10 in K2 at every n against fft_rows_interleaved_plain(precision=
    "int8") and numpy, per 128-row tile (the plain version's group)."""
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(21)
    for n in IL_NS:
        f = local.matrix_factor(local.default_factors(n))
        worst_plain = worst_np = 0.0
        before = (count_of("launch.K2+K10"), count_of("launch.K2"))
        cases = 0
        for rows in (1, 130, 384):
            x = (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            if rows == 384:
                x = spread_rows(x)
            xc = torch.from_numpy(x).cuda()
            for sign in (-1, +1):
                post = 0.3
                X = (np.fft.fft(x.astype(np.complex128)) if sign < 0
                     else np.fft.ifft(x.astype(np.complex128)) * n)
                ref = torch.from_numpy(X * post).cuda()
                plain = as_c64(local.fft_rows_interleaved_plain(
                    xc.view(torch.float32), sign, post, precision="int8"))
                for mode in ("out", "inplace", "stride"):
                    v, out = il_operand(xc, mode)
                    y = local.fft_rows_interleaved(v, sign, postscale=post,
                                                   precision="int8", out=out)
                    torch.cuda.synchronize()
                    if out is not None and y.data_ptr() != v.data_ptr():
                        raise AssertionError("in-place K2+K10 wrote "
                                             "elsewhere")
                    g = as_c64(y)
                    tag = f"n={n} rows={rows} sign={sign} {mode}"
                    e_plain = tiles_err(g, plain, [(0, 128)])
                    e_np = tiles_err(g, ref, [(0, 128)])
                    check(f"K2+K10 vs plain {tag}", e_plain)
                    check(f"K2+K10 vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        made = (count_of("launch.K2+K10") - before[0],
                count_of("launch.K2") - before[1])
        if made != ((cases, 0) if f else (0, cases)):
            raise AssertionError(f"int8 interleaved rows n={n}: launches "
                                 f"(int8, float) {made} for {cases} calls")
        print(f"phase 21 K2+K10 n={n} (f={f or 'none: K2 unchanged'}): "
              f"{cases} cases (out of place, in place, row stride 2n + 16) "
              f"incl. a 2^20 spread over 128-row tiles, max rel err per "
              f"tile vs plain {worst_plain:.3e}, vs numpy {worst_np:.3e} "
              f"(gate {TOL:.0e})")
    v = torch.zeros((128, 128), device="cuda")
    try:
        local.fft_rows_interleaved(v, -1, precision="int8", packed=True)
    except ValueError:
        pass
    else:
        raise AssertionError("K2+K10 took the packed form")


def phase_int8_il_paths(copy_gbs):
    """Phase 21's path: config 2i through K2+K10, forward and inverse with
    exact counts, against numpy and the plain version; K2+K10 timed at
    config 2i (f = 64) and at 2048 x 8192 (f = 128) beside K2, K1+K10 on
    the same view's stride-2 planes, the plain version, the bounds and
    torch.fft.fft."""
    from pyfft_tpu_torch.ops import local
    from pyfft_tpu_torch.utils.profiling import time_ms
    x = make_data((BATCH, N), seed=210)
    ref, ref_inv = numpy_refs(x, 1)
    v = torch.view_as_real(x).flatten(-2)

    def both():
        return (local.fft_rows_interleaved(v, -1, precision="int8"),
                local.fft_rows_interleaved(v, +1, postscale=1.0 / N,
                                           precision="int8"))

    (y, yi), counts = counted({"local_rows_il_i8": 2}, "config 2i int8",
                              both)
    e = (rel_err(as_c64(y), ref), rel_err(as_c64(yi), ref_inv))
    check("config 2i int8 forward vs numpy", e[0])
    check("config 2i int8 inverse vs numpy", e[1])
    want = local.fft_rows_interleaved_plain(v, -1, precision="int8")
    e_plain = tiles_err(as_c64(y), as_c64(want), [(0, 128)])
    check("config 2i K2+K10 vs plain", e_plain)
    checks = [("local_rows_il_i8", "config 2i (K2+K10)",
               float((y - want).abs().max()), e_plain)]
    del y, yi, want, ref, ref_inv
    print(f"phase 21 config 2i {tuple(x.shape)} through K2+K10 (f=64): "
          f"launches {counts['local_rows_il_i8']} local_rows_il_i8 over a "
          f"forward and an inverse run, err vs numpy {e[0]:.3e} forward, "
          f"{e[1]:.3e} inverse, vs plain {e_plain:.3e} per tile (gate "
          f"{TOL:.0e})")
    rows = []
    for label, n in (("config 2i", N), ("n = 8192", 8192)):
        xs = x.view(BATCH * N // n, n)
        vs = torch.view_as_real(xs).flatten(-2)
        out = torch.empty_like(vs)
        f = local.matrix_factor(local.default_factors(n))
        fl, ops = i8_ops(n, f, BATCH * N)
        rows.append(time_pass(
            label, f"rows (K2+K10, f={f})", vs, vs,
            lambda: local.fft_rows_interleaved(vs, -1, precision="int8",
                                               out=out),
            lambda: local.fft_rows_interleaved_plain(vs, -1,
                                                     precision="int8"),
            lambda: torch.fft.fft(xs), 2 * BATCH * N * 8, fl, copy_gbs,
            phase=21, int8_ops=ops))
        row = rows[-1]
        row["kernel"] = "local_rows_il_i8"
        row["float_ms"] = time_ms(lambda: local.fft_rows_interleaved(
            vs, -1, out=out))
        ov = out.view(xs.shape[0], n, 2)
        xv = vs.view(xs.shape[0], n, 2)
        row["rival_ms"] = time_ms(lambda: local.fft_axis(
            xv[..., 0], xv[..., 1], -1, precision="int8",
            out=(ov[..., 0], ov[..., 1])))
        print(f"    K2 (float) on the same view: {row['float_ms']:.4f} ms; "
              f"K1+K10 on its stride-2 planes (f="
              f"{local.matrix_factor(local.row_factors(n))}): "
              f"{row['rival_ms']:.4f} ms")
        del xs, vs, out, ov, xv
    del x, v
    torch.cuda.empty_cache()
    return {"counts": counts, "checks": checks, "timed": rows, "errs": e}


# ------------------------------------------ the distributed FFT (phase 22)


class DistPath(NamedTuple):
    make: str             # the parallel.dist function
    arg: object           # its n or shape
    shape: tuple          # the data, one rank's block at s = 1
    dtype: torch.dtype
    plan: tuple           # the single-card Plan's shape on the same data
    per: dict             # launches of one call
    designs: dict         # of those, on each redesign (design_counts)


DIST_PATHS = {
    "config 2": DistPath("make_dist_fft", N, (BATCH, N), torch.complex64,
                         (N,), {"local_rows": 1}, {"row ring": 1}),
    "config 3": DistPath("make_dist_fft2", (1024, 1024), (16, 1024, 1024),
                         torch.complex64, (1024, 1024),
                         {"local_rows": 1, "local_cols": 1},
                         {"row ring": 1, "column cluster tile": 1}),
    "config 4": DistPath("make_dist_fft3", (256, 256, 256),
                         (1, 256, 256, 256), torch.complex64,
                         (256, 256, 256), {"fused2d": 1, "local_cols": 1},
                         {"column ring": 1, "plane ring": 1}),
    "c128 4096 x 4096": DistPath("make_dist_fft_df64", N, (BATCH, N),
                                 torch.complex128, (N,),
                                 {"local_rows_f64": 1}, {"row ring f64": 1}),
}


def queued_ms(fn) -> tuple[float, str]:
    """Device ms a call with the host ahead (``time_queued_ms``), else,
    where the host cannot get ahead, per-call events (``time_ms``)."""
    from pyfft_tpu_torch.utils.profiling import time_ms, time_queued_ms
    try:
        return time_queued_ms(fn)[0], "host ahead"
    except RuntimeError:
        return time_ms(fn), "events"


def dist_path(mesh, name: str, spec: DistPath, seed: int) -> dict:
    """One distributed path at full width: forward and normalized inverse
    with exact launch counts, against numpy and the single-card Plan on
    the same data, and timed beside ``Plan.execute``."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch.parallel import dist as pdist
    tol = TOL64 if spec.dtype == torch.complex128 else TOL
    make = getattr(pdist, spec.make)
    fwd = make(mesh, spec.arg)
    inv = make(mesh, spec.arg, sign=+1, normalize=True)
    x = make_data(spec.shape, seed, spec.dtype)
    re, im = x.real.contiguous(), x.imag.contiguous()
    ref = numpy_ref(x, len(spec.plan))
    reset_counts()
    yr, yi = fwd(re, im)
    br, bi = inv(yr, yi)
    counts, designs = read_counts(), design_counts()
    want = expect({k: 2 * v for k, v in spec.per.items()})
    want_designs = {k: 2 * spec.designs.get(k, 0) for k in designs}
    if counts != want or designs != want_designs:
        raise AssertionError(f"dist {name}: launches {counts} on the "
                             f"designs {designs}, expected {want} on "
                             f"{want_designs}")
    errs = {"fwd": rel_err(cplx(yr, yi), ref),
            "roundtrip": rel_err(cplx(br, bi), x)}
    for k, e in errs.items():
        check(f"dist {name} {k}", e, tol)
    # the single-card Plan on the same data: at s = 1 the exchanges are
    # copies, the 1-point DFT and the twiddle multiply by exact ones and
    # zeros, and the normalization is a power of two, so the bits match
    plan = pyfft_tpu_torch.Plan(spec.plan, spec.dtype, device="cuda")
    pr, pi = plan.execute(re, im)
    qr, qi = plan.execute(yr, yi, inverse=True)
    bits = {"fwd": torch.equal(yr, pr) and torch.equal(yi, pi),
            "inv": torch.equal(br, qr) and torch.equal(bi, qi)}
    vs_plan = {"fwd": rel_err(cplx(yr, yi), cplx(pr, pi)),
               "inv": rel_err(cplx(br, bi), cplx(qr, qi))}
    for k, e in vs_plan.items():
        check(f"dist {name} {k} against Plan", e, tol)
    ms, how = queued_ms(lambda: fwd(re, im))
    plan_ms, plan_how = queued_ms(
        lambda: plan.execute(re, im, wait_for_finish=False))
    print(f"phase 22 dist {name} {spec.make} {tuple(spec.shape)} "
          f"{spec.dtype}: launches "
          f"{ {k: v for k, v in counts.items() if v} } over a forward and "
          f"an inverse, on the redesigns "
          f"{ {k: v for k, v in designs.items() if v} }; "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (numpy, gate {tol:.0e}); against Plan: "
          + ", ".join(f"{k} {'bit-equal' if bits[k] else f'{e:.3e}'}"
                      for k, e in vs_plan.items())
          + f"; forward {ms:.4f} ms ({how}) beside Plan.execute "
          f"{plan_ms:.4f} ms ({plan_how}): {ms / plan_ms:.3f} x")
    del x, re, im, yr, yi, br, bi, pr, pi, qr, qi
    torch.cuda.empty_cache()
    return {"counts": counts, "designs": designs, "errs": errs,
            "bit_equal": bits, "vs_plan": vs_plan,
            "timed": {"path": name, "make": spec.make, "ms": ms,
                      "timing": how, "plan_ms": plan_ms,
                      "plan_timing": plan_how, "ratio": ms / plan_ms}}


def phase_dist() -> dict:
    """Phase 22: ``warmup``, then one NCCL rank on card 0 and a (1, 1)
    ("dp", "sp") mesh; the four distributed paths at full width
    (DIST_PATHS) and the long 1D case (n = 2^16: the plain chain, no
    kernel)."""
    import tempfile

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    import pyfft_tpu_torch
    from pyfft_tpu_torch.parallel import dist as pdist
    print(f"phase 22 card: {card()}")
    t0 = time.perf_counter()
    count = pyfft_tpu_torch.warmup([(N,), (1024, 1024), (256, 256, 256)])
    count += pyfft_tpu_torch.warmup([(N,)], dtypes=("complex128",))
    print(f"phase 22 warmup: {count} plan executions (shape x dtype x "
          f"batch x direction) in {time.perf_counter() - t0:.2f} s")
    if not tdist.is_nccl_available():
        raise RuntimeError("phase 22 needs NCCL, and this torch has none")
    torch.cuda.set_device(0)
    out = {"counts": dict.fromkeys(KERNELS, 0), "paths": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                 world_size=1, rank=0)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("dp", "sp"))
            print(f"phase 22 NCCL rank and (1, 1) mesh up in "
                  f"{time.perf_counter() - t1:.2f} s")
            for seed, (name, spec) in enumerate(DIST_PATHS.items(), 220):
                r = dist_path(mesh, name, spec, seed)
                out["paths"][name] = r
                for k, v in r["counts"].items():
                    out["counts"][k] += v
            # n/S = 2^16 > 8192: the local factor is the plain chain
            fn = pdist.make_dist_fft(mesh, 1 << 16)
            x = make_data((2, 1 << 16), 229)
            re, im = x.real.contiguous(), x.imag.contiguous()
            reset_counts()
            yr, yi = fn(re, im)
            counts = read_counts()
            if any(counts.values()):
                raise AssertionError(f"dist long 1D: launches {counts}, "
                                     "expected none")
            err = rel_err(cplx(yr, yi), numpy_ref(x, 1))
            check("dist long 1D", err)
            ms, how = queued_ms(lambda: fn(re, im))
            out["long_1d"] = {"ms": ms, "timing": how, "err": err}
            print(f"phase 22 dist long 1D make_dist_fft (2, 65536): no "
                  f"kernel (n/S = 65536 > 8192: the plain chain, as JAX's "
                  f"rule gives), err {err:.3e}, {ms:.4f} ms ({how})")
        finally:
            tdist.destroy_process_group()
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return out


# Phase 23's autotune calls: (ns, kinds, volume), at config 6+ (split),
# config 5 (dsplit) and config 2i (il1d).
TUNE_RUNS = (([1 << 22], ("split",), 1 << 25),
             ([1 << 22], ("dsplit",), 1 << 28),
             ([N], ("il1d",), 1 << 24))
# The kernel libraries, one build of each a process.
LIBRARIES = ("local_rows", "local_cols", "fused2d", "fused2d_tiled",
             "interleave")
# The plans phase 23 runs under the record: (label, shape, batch, dtype,
# numpy rows, launches of a planar execute).
TUNED_PLANS = (
    ("config 6+", (1 << 22,), 8, torch.complex64, (0, 3, 7),
     {"local_cols": 2}),
    ("config 5", (1 << 22,), 64, torch.complex128, (0, 21, 42, 63),
     {"local_cols_f64": 2}),
    ("config 2", (N,), BATCH, torch.complex64, None, {"local_rows": 1}),
    ("config 4", (256, 256, 256), 1, torch.complex64, None,
     {"fused2d": 1, "local_cols": 1}))


def tuned_plan(label, shape, batch, dtype, rows, per, record, seed) -> dict:
    """One plan built under the autotune record: its repr, and a planar
    and a complex execute against numpy with exact launch counts."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch.utils.radix import ilog2
    tol = TOL64 if dtype == torch.complex128 else TOL
    full = ((batch,) if batch > 1 else ()) + shape
    x = make_data(full, seed, dtype)
    pick = slice(None) if rows is None else list(rows)
    ref = numpy_ref(x[pick], len(shape))
    plan = pyfft_tpu_torch.Plan(shape, dtype, device="cuda")
    passes = plan._exec_plan.passes
    kind = "dsplit" if dtype == torch.complex128 else "split"
    for p in passes:
        if (p.executor == "fourstep"
                and list(p.split) != record[f"{kind}:{p.n}"]):
            raise AssertionError(f"phase 23 {label}: {plan!r} does not take "
                                 f"the record's {kind}:{p.n}")
    re, im = x.real.contiguous(), x.imag.contiguous()
    reset_counts()
    rr, ii = plan.execute(re, im)
    y = plan.execute(x)
    counts, designs = read_counts(), design_counts()
    # a 1D plan of one local pass takes its route's kernels in place of
    # its planar ones (route_counts); any other adds them
    single = len(passes) == 1 and passes[0].executor == "local"
    want = expect(per, *([] if single else [per]), route_counts(plan))
    if counts != want:
        raise AssertionError(f"phase 23 {label}: launches {counts}, "
                             f"expected {want}")
    errs = {"planar": rel_err(cplx(rr[pick], ii[pick]), ref),
            "complex": rel_err(y[pick], ref)}
    for k, e in errs.items():
        check(f"phase 23 {label} {k}", e, tol)
    against = ("numpy" if rows is None else f"numpy on rows {list(rows)}")
    print(f"phase 23 {label} {full} under the record: {plan!r}, complex "
          f"route {plan.il_route()}, launches "
          f"{ {k: v for k, v in counts.items() if v} } on the designs "
          f"{ {k: v for k, v in designs.items() if v} }; "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (against {against}, gate {tol:.0e}); 2^{ilog2(x.numel())} "
          f"points")
    del x, re, im, rr, ii, y, ref
    torch.cuda.empty_cache()
    return {"counts": counts, "designs": designs, "errs": errs,
            "plan": repr(plan)}


def phase_autotune(tune_file: Path) -> dict:
    """Phase 23: ``autotune`` (TUNE_RUNS) into ``tune_file``, the record's
    temporary path (PYFFT_TPU_TORCH_TUNE_FILE); the plans of TUNED_PLANS
    under it against numpy; then the record removed.  The libraries are
    the sources' builds throughout: each one loaded is the file its
    source's ``build.library_path`` names, printed."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch import plan as planmod
    from pyfft_tpu_torch.ops import build, fourstep
    from pyfft_tpu_torch.utils import tune
    print(f"phase 23 card: {card()}")
    t0 = time.perf_counter()
    paths = {name: build.library_path(name) for name in LIBRARIES}
    if tune.tuned_path() != str(tune_file) or tune_file.exists():
        raise AssertionError(f"phase 23: the record is {tune.tuned_path()}")
    for ns, kinds, volume in TUNE_RUNS:
        t1 = time.perf_counter()
        print(f"phase 23 autotune({ns}, kinds={kinds}, volume=2^"
              f"{volume.bit_length() - 1}):", flush=True)
        pyfft_tpu_torch.autotune(ns, kinds=kinds, volume=volume)
        print(f"phase 23 autotune({ns}, {kinds}) took "
              f"{time.perf_counter() - t1:.1f} s")
    record = json.loads(tune_file.read_text())
    keys = {"device", f"split:{1 << 22}", f"dsplit:{1 << 22}", f"il1d:{N}"}
    if set(record) != keys or record["device"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"phase 23: record {record}")
    print(f"phase 23 record {record}")
    out = {"record": record, "counts": dict.fromkeys(KERNELS, 0),
           "plans": {}}
    for seed, (label, *spec) in enumerate(TUNED_PLANS, 230):
        r = tuned_plan(label, *spec, record, seed)
        out["plans"][label] = r
        for k, v in r["counts"].items():
            out["counts"][k] += v
    tune_file.unlink()
    tune.reload_tuned()
    if (planmod._il1d_route(N) != planmod.IL1D_ROUTE
            or fourstep.choose_split(1 << 22) != (2048, 2048)):
        raise AssertionError("phase 23: the record removed, the route or "
                             "the split stays")
    loaded = {name: Path(build.load(name)._name) for name in LIBRARIES}
    if loaded != paths:
        raise AssertionError(f"phase 23: the libraries loaded are {loaded}, "
                             f"not the sources' {paths}")
    out["libraries"] = {name: p.name for name, p in paths.items()}
    out["seconds"] = time.perf_counter() - t0
    print("phase 23 libraries (the sources' builds): " + ", ".join(
        f"{name} {p.name}" for name, p in paths.items()))
    print(f"phase 23 record removed: the source's splits and route again; "
          f"phase 23 took {out['seconds']:.1f} s")
    return out


def phase_sweep() -> dict:
    """Phase 24: config 5 (2^22 x 64 complex128) unswept and with the
    chunk budget pinned to give 8 chunks: bit-equal results, 8 x the two
    K12 launches, peak memory against the fudge's bound, device time with
    the host ahead; the default budget beside the card's memory."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch import plan as planmod
    print(f"phase 24 card: {card()}")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    total = torch.cuda.mem_get_info(0)[1]
    print(f"phase 24 default chunk budget {planmod._hbm_chunk_budget(dev)} "
          f"bytes: a quarter of the card's {total} bytes")
    n, batch, rows = 1 << 22, 64, [0, 21, 42, 63]
    plan = pyfft_tpu_torch.Plan((n,), torch.complex128, device="cuda")
    per_row, fudge = n * 8, plan._fudge()
    x = make_data((batch, n), 240, torch.complex128)
    ref = numpy_ref(x[rows], 1)
    re, im = x.real.contiguous(), x.imag.contiguous()
    runs = {}
    for label, pin, chunks in (("unswept", None, 1),
                               ("swept", 8 * per_row * fudge, 8)):
        planmod._HBM_CHUNK_BUDGET = pin
        try:
            chunk = plan._chunk(batch, dev)
            if batch // chunk != chunks:
                raise AssertionError(f"phase 24 {label}: chunk {chunk}")
            plan.execute(re, im)            # the tables, before the peak
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            yr, yi = plan.execute(re, im)
            peak = torch.cuda.max_memory_allocated() - base
            y = plan.execute(x)
            counts = read_counts()
            ms, how = queued_ms(
                lambda: plan.execute(re, im, wait_for_finish=False))
        finally:
            planmod._HBM_CHUNK_BUDGET = None
        want = expect({"local_cols_f64": 4 * chunks})
        if counts != want:
            raise AssertionError(f"phase 24 {label}: launches {counts}, "
                                 f"expected {want}")
        # the fudge's bound: everything but the input, with the
        # temporaries of one chunk
        bound_bytes = batch * per_row * 2 + chunk * per_row * (fudge - 4)
        if peak > 1.01 * bound_bytes:
            raise AssertionError(f"phase 24 {label}: peak {peak} bytes "
                                 f"over the fudge's {bound_bytes}")
        errs = {"planar": rel_err(cplx(yr[rows], yi[rows]), ref),
                "complex": rel_err(y[rows], ref)}
        for k, e in errs.items():
            check(f"phase 24 {label} {k}", e, TOL64)
        runs[label] = {"out": (yr, yi, y), "chunk": chunk, "peak": peak,
                       "bound": bound_bytes, "ms": ms, "timing": how,
                       "counts": counts, "errs": errs}
        print(f"phase 24 config 5 {label}: {batch // chunk} chunk(s) of "
              f"{chunk}, launches "
              f"{ {k: v for k, v in counts.items() if v} } over a planar "
              f"and a complex execute; peak {peak} bytes above the input "
              f"(fudge {fudge}: at most {bound_bytes}); planar execute "
              f"{ms:.4f} ms ({how}); "
              + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
              + f" (numpy on rows {rows}, gate {TOL64:.0e})")
    a, b = runs["unswept"]["out"], runs["swept"]["out"]
    bits = [torch.equal(u, v) for u, v in zip(a, b)]
    if not all(bits):
        raise AssertionError(f"phase 24: swept and unswept differ "
                             f"(planar re, im, complex: {bits})")
    out = {"counts": dict(runs["swept"]["counts"]), "seconds": 0.0}
    for k, v in runs["unswept"]["counts"].items():
        out["counts"][k] += v
    out.update({label: {k: r[k] for k in ("chunk", "peak", "bound", "ms",
                                           "timing")}
                for label, r in runs.items()})
    ratio = runs["swept"]["ms"] / runs["unswept"]["ms"]
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 24 swept bit-equal to unswept (planar and complex); "
          f"swept / unswept time {ratio:.3f}, peak "
          f"{runs['swept']['peak'] / runs['unswept']['peak']:.3f}; phase 24 "
          f"took {out['seconds']:.1f} s")
    del x, re, im, a, b, runs
    torch.cuda.empty_cache()
    return out


def phase_trace() -> dict:
    """Phase 25: a config 2 ``Plan.execute`` under
    ``utils/profiling.trace``: the trace file it writes names K1's ring
    kernel (a CUPTI kernel record: the kernels launch through ctypes) and
    holds the program's spans, each inside the one before: the execute,
    its pass, K1's C entry; the wait follows the pass."""
    import tempfile

    import pyfft_tpu_torch
    from pyfft_tpu_torch.utils.profiling import trace
    print(f"phase 25 card: {card()}")
    t0 = time.perf_counter()
    x = make_data((BATCH, N), 250)
    ref = numpy_ref(x, 1)
    re, im = x.real.contiguous(), x.imag.contiguous()
    plan = pyfft_tpu_torch.Plan((N,), device="cuda")
    plan.execute(re, im)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        with trace(tmp):
            yr, yi = plan.execute(re, im)
        counts, designs = read_counts(), design_counts()
        files = sorted(Path(tmp).glob("*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"phase 25: trace files {files}")
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())["traceEvents"]
    want = expect({"local_rows": 1})
    if counts != want or designs["row ring"] != 1:
        raise AssertionError(f"phase 25: launches {counts} on {designs}")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ring = [e for e in kernels if "local_rows_ring_kernel" in e["name"]]
    if len(ring) != 1:
        raise AssertionError(f"phase 25: the trace's kernels "
                             f"{[e['name'][:100] for e in kernels]}")
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("pyfft.")}
    nest = ("pyfft.execute", "pyfft.pass.local", "pyfft.entry.K1")
    if (set(spans) != {*nest, "pyfft.wait"}
            or any(not (spans[a][0] <= spans[b][0] <= spans[b][1]
                        <= spans[a][1]) for a, b in zip(nest, nest[1:]))
            or spans["pyfft.wait"][0] < spans["pyfft.pass.local"][1]):
        raise AssertionError(f"phase 25: the program's spans {spans}")
    err = rel_err(cplx(yr, yi), ref)
    check("phase 25 config 2 traced", err)
    out = {"counts": counts, "kernel": ring[0]["name"],
           "kernel_us": ring[0].get("dur"), "events": len(events),
           "bytes": size, "err": err,
           "seconds": time.perf_counter() - t0}
    print(f"phase 25 config 2 traced: a trace of {size} bytes, {len(events)} "
          f"events, {len(kernels)} kernel record(s); K1's is "
          f"{ring[0]['name'][:120]!r}, {ring[0].get('dur')} us; spans "
          f"{ {k: b - a for k, (a, b) in spans.items()} } us; err "
          f"{err:.3e}; phase 25 took {out['seconds']:.1f} s")
    del x, re, im, yr, yi, ref
    torch.cuda.empty_cache()
    return out


def phase_record() -> dict:
    """Phase 26: config 4's call record.  A plan's first call with a
    layout runs the generic path and records its launches; a later call
    with that layout replays them.  On two inputs, both directions, the
    replayed output equals a new plan's first call, the generic path, bit
    for bit, on the default stream and on a side stream; the launches are
    the generic path's, and the registry counts the records' misses and
    hits.  Also printed: the host time of a waited call, generic (a new
    plan each call) and replayed, the median of 20 each."""
    import pyfft_tpu_torch
    from pyfft_tpu_torch.utils import profiling
    print(f"phase 26 card: {card()}")
    t0 = time.perf_counter()
    shape = (256, 256, 256)
    xs = [make_data(shape, 260 + i) for i in range(2)]
    plan = pyfft_tpu_torch.Plan(shape, device="cuda")
    side = torch.cuda.Stream()
    reset_counts()
    plan.execute(plan.execute(xs[0]), inverse=True)     # the two misses
    errs = []
    for x in xs:
        for stream in (torch.cuda.current_stream(), side):
            with torch.cuda.stream(stream):
                y = plan.execute(x)
                back = plan.execute(y, inverse=True)
                fresh = pyfft_tpu_torch.Plan(shape, device="cuda")
                gy = fresh.execute(x)
                gb = fresh.execute(y, inverse=True)
            torch.cuda.synchronize()
            if not (torch.equal(y, gy) and torch.equal(back, gb)):
                raise AssertionError("phase 26: a replayed call differs "
                                     "from the generic path")
        errs.append(rel_err(back, x))
    check("phase 26 config 4 replayed roundtrip", max(errs))
    counts = read_counts()
    records = {k: v for k, v in profiling.counts().items()
               if k.startswith("record.")}
    # 2 misses, then on each input and stream 2 hits and a new plan's 2
    want = {"record.miss": 2 + 8, "record.hit": 8}
    if counts != expect({"fused2d": 18, "local_cols": 18}) or \
            records != want:
        raise AssertionError(f"phase 26: launches {counts}, records "
                             f"{records}, expected {want}")

    def host_ms(make):
        out = []
        for _ in range(20):
            p = make()
            torch.cuda.synchronize()
            t = time.perf_counter()
            p.execute(xs[0])
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    generic = host_ms(lambda: pyfft_tpu_torch.Plan(shape, device="cuda"))
    replayed = host_ms(lambda: plan)
    out = {"counts": counts, "records": records, "err": max(errs),
           "generic_ms": generic, "replayed_ms": replayed,
           "seconds": time.perf_counter() - t0}
    print(f"phase 26 config 4 call record: replayed == generic bit for bit "
          f"on 2 inputs x 2 directions x 2 streams; launches "
          f"{ {k: v for k, v in counts.items() if v} }, records {records}; "
          f"roundtrip err {max(errs):.3e}; a waited call {generic:.4f} ms "
          f"generic, {replayed:.4f} ms replayed (host clock, median of 20); "
          f"phase 26 took {out['seconds']:.1f} s")
    del xs, y, back, gy, gb
    torch.cuda.empty_cache()
    return out


def kernel_entry(name, source, replaces, timed, checks, launches, shape):
    """One kernel's record for the kernels line: its timed passes summed
    (they compute one function together), its errors over every pass check
    of the main paths."""
    mine = [c for c in checks if c[1] == name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max(c[2] for c in mine),
        "max_rel_err": max(c[3] for c in mine),
        "ms": sum(c["ms"] for c in timed),
        "plain_ms": sum(c["plain_ms"] for c in timed),
        "bound_ms": sum(c["bound_ms"] for c in timed),
        "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in timed)
                     else "operations"),
        "shape": shape}


def main() -> int:
    # the autotune record: a temporary path, empty until phase 23, so that
    # no record elsewhere steers the plans
    import tempfile
    tune_dir = tempfile.TemporaryDirectory()
    tune_file = Path(tune_dir.name) / "tuned.json"
    os.environ["PYFFT_TPU_TORCH_TUNE_FILE"] = str(tune_file)
    phase_device()
    watch_k8_designs()
    built = phase_build()
    phase_kernel()
    xt, re, im, counts2 = phase_main_path()
    built()             # nothing is timed while nvcc runs
    t = phase_timings(xt, re, im)
    del xt, re, im
    phase_cols_kernel()
    phase_cols_xring()
    phase_fused_kernel()
    results = phase_paths(C64_PATHS, 8,
                          keep=("config 6+", "config 3", "config 4", "mid"))
    timed = phase_pass_timings(results, t["copy_gbs"])
    e2e = phase_end_to_end(results)

    phase_kernel("complex128")
    phase_cols_kernel("complex128")
    results64 = phase_paths(C128_PATHS, 12, keep=("config 5", "c128 2D"))
    timed64 = phase_f64_timings(results64, t["copy_gbs"])
    e2e.update(phase_end_to_end(results64, 13))

    phase_il_kernels()
    il = phase_config2i(t["copy_gbs"])
    rl = phase_real()

    phase_swap_kernel()
    phase_ctile_kernel()
    phase_tiled_kernel()
    off = phase_offroute_paths(t["copy_gbs"])

    phase_int8_stages()
    phase_int8_rows()
    phase_int8_cols()
    i8 = phase_int8_paths(t["copy_gbs"])

    phase_int8_swap()
    phase_int8_2d(tiled=False)
    phase_int8_2d(tiled=True)
    phase_int8_fold()
    i8h = phase_int8_host_paths(t["copy_gbs"])

    phase_int8_il()
    i8il = phase_int8_il_paths(t["copy_gbs"])

    dist = phase_dist()

    auto = phase_autotune(tune_file)
    sweep = phase_sweep()
    traced = phase_trace()
    recorded = phase_record()
    tune_dir.cleanup()

    launches = dict(counts2)
    for r in (*results.values(), *results64.values(), il, rl, off, i8, i8h,
              i8il, dist, auto, sweep, traced, recorded):
        for k, v in r["counts"].items():
            launches[k] += v
    checks = [c for r in (*results.values(), *results64.values())
              for c in r["pass_checks"]]
    # the main paths' launches on each redesign (phases 8 and 12)
    designs = {k: sum(r["designs"][k] for r in (*results.values(),
                                                 *results64.values()))
               for k in design_counts()}
    rows_entry = {
        "name": "local_rows", "route": "cuda",
        "source": "pyfft_tpu_torch/ops/csrc/local_rows.cu",
        "replaces": "pyfft_tpu/ops/pallas_local.py:743",
        "launches": launches["local_rows"],
        "max_abs_err": max([t["max_abs_err"]] + [c[2] for c in checks
                                                 if c[1] == "local_rows"]),
        "max_rel_err": max([t["max_rel_err"]] + [c[3] for c in checks
                                                 if c[1] == "local_rows"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "config 2, 4096 x 4096"}
    # the two passes of config 6+ together compute one torch.fft.fft; the
    # column kernel's plain store also stands for the JAX fold-store
    # kernel (pallas_local.py:1265), whose native layout is that store's
    six = [c for c in timed if c["path"] == "config 6+"]
    cols_entry = kernel_entry(
        "local_cols", "pyfft_tpu_torch/ops/csrc/local_cols.cu",
        "pyfft_tpu/ops/pallas_local.py:1173", six, checks, launches,
        "config 6+, 2^22 x 8: both four-step passes")
    cols_entry["library_ms"] = e2e["config 6+"]["library_ms"]
    cols_entry["design_launches"] = {
        "persistent ring": designs["column ring"],
        "persistent cluster ring": designs["column cluster ring"],
        "cluster tile": designs["column cluster tile"]}
    fused = [c for c in timed if c["kernel"] == "fused2d"]
    fused_entry = kernel_entry(
        "fused2d", "pyfft_tpu_torch/ops/csrc/fused2d.cu",
        "pyfft_tpu/ops/pallas_local.py:1409", fused, checks, launches,
        "config 4, 256^3: the last two axes")
    fused_entry["library_ms"] = fused[0]["library_ms"]
    fused_entry["design_launches"] = {"plane ring": designs["plane ring"]}
    # complex128: K11 on the 2D path's row pass; K12's two config-5 passes
    # together compute one torch.fft.fft of config 5
    r64 = [c for c in timed64 if c["kernel"] == "local_rows_f64"]
    rows64_entry = kernel_entry(
        "local_rows_f64", "pyfft_tpu_torch/ops/csrc/local_rows.cu",
        "pyfft_tpu/ops/pallas_df64.py:656", r64, checks, launches,
        "complex128 1024^2 x 16: the row pass")
    rows64_entry["library_ms"] = r64[0]["library_ms"]
    rows64_entry["design_launches"] = {"row ring": designs["row ring f64"]}
    five = [c for c in timed64 if c["path"] == "config 5"]
    cols64_entry = kernel_entry(
        "local_cols_f64", "pyfft_tpu_torch/ops/csrc/local_cols.cu",
        "pyfft_tpu/ops/pallas_df64.py:761", five, checks, launches,
        "config 5, 2^22 x 64 complex128: both four-step passes")
    cols64_entry["library_ms"] = e2e["config 5"]["library_ms"]
    cols64_entry["design_launches"] = {
        "cluster tile": designs["column cluster tile f64"],
        "persistent cluster ring": designs["column cluster ring f64"]}
    # K2, K13 and K14 timed at config 2i's shape (4096 x 4096 complex64),
    # their errors over config 2i and every call held against the plain
    # version in phases 15 and 16
    held = il["held"] + rl["held"]
    il_entries = [
        {"name": name, "route": "cuda",
         "source": f"pyfft_tpu_torch/ops/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[name],
         **{k: il["timed"][name][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "max_abs_err": max([il["timed"][name]["max_abs_err"]]
                            + [c[2] for c in held if c[0] == name]),
         "max_rel_err": max([il["timed"][name]["max_rel_err"]]
                            + [c[3] for c in held if c[0] == name]),
         "shape": "config 2i, 4096 x 4096 complex64"}
        for name, src, replaces in (
            ("local_rows_il", "local_rows",
             "pyfft_tpu/ops/pallas_local.py:743"),
            ("deinterleave", "interleave", "pyfft_tpu/ops/interleave.py:92"),
            ("interleave", "interleave", "pyfft_tpu/ops/interleave.py:111"))]
    # K4, K6 and K9 timed at their phase-18 shapes, their errors over every
    # kernel call of phase 18 held against the plain version
    off_entries = []
    for name, src, replaces, shape, path in (
            ("local_rows_swap", "local_cols",
             "pyfft_tpu/ops/pallas_local.py:875",
             "config 6+ variant B pass 2, (8, 2048, 2048)", "config 6+"),
            ("local_cols_ctile", "local_cols",
             "pyfft_tpu/ops/pallas_local.py:1073",
             "config 4 z pass, (1, 256, 65536), c = 8", "config 4"),
            ("fused2d_tiled", "fused2d_tiled",
             "pyfft_tpu/ops/pallas_local.py:1502",
             "config 3, 16 x 1024 x 1024", "config 3")):
        row = next(r for r in off["timed"]
                   if r["kernel"] == name and r["path"] == path)
        mine = [c for c in off["checks"] if c[0] == name]
        off_entries.append({
            "name": name, "route": "cuda",
            "source": f"pyfft_tpu_torch/ops/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c[2] for c in mine),
            "max_rel_err": max(c[3] for c in mine),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "shape": shape})
    # K10 inside K1 (timed at config 2) and K5 (config 3's column pass), its
    # errors over every kernel call of phase 19's paths held against the
    # plain version; inside K4 (variant B's pass 2), K8 (config 4) and K9
    # (config 3), over phase 20's paths.  K5+K10's checks take in phase
    # 20's calls too (the fold and variant B's pass 1 run it)
    for name, src, label, host, res in (
            ("local_rows_i8", "local_rows", "config 2, 4096 x 4096, f = 64",
             "pallas_local.py:743", (i8,)),
            ("local_cols_i8", "local_cols",
             "config 3 column pass, (16, 1024, 1024), f = 64",
             "pallas_local.py:1173, :1265", (i8, i8h)),
            ("local_rows_swap_i8", "local_cols",
             "config 6+ variant B pass 2, (8, 2048, 2048), f = 128",
             "pallas_local.py:875", (i8h,)),
            ("fused2d_i8", "fused2d", "config 4, 256^3, f = 64 both axes",
             "pallas_local.py:1409", (i8h,)),
            ("fused2d_tiled_i8", "fused2d_tiled",
             "config 3, 16 x 1024 x 1024, f = 64 both axes",
             "pallas_local.py:1502", (i8h,)),
            ("local_rows_il_i8", "local_rows",
             "config 2i, 4096 x 4096 interleaved, f = 64",
             "pallas_local.py:743 (interleaved)", (i8il,))):
        row = next(r for r in res[0]["timed"] if r["kernel"] == name)
        mine = [c for r in res for c in r["checks"] if c[0] == name]
        off_entries.append({
            "name": name, "route": "cuda",
            "source": f"pyfft_tpu_torch/ops/csrc/{src}.cu",
            "replaces": "pyfft_tpu/ops/pallas_local.py:526",
            "host": host, "launches": launches[name],
            "max_abs_err": max(c[2] for c in mine),
            "max_rel_err": max(c[3] for c in mine),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "float_ms")},
            "shape": label})
    # every float K8 launch of the run ran the design its table names
    if K8_DESIGNS["wrong"]:
        raise AssertionError(f"K8 launches on another design than their "
                             f"table's: {K8_DESIGNS['wrong'][:5]}")
    print(f"K8 over the whole run: {K8_DESIGNS['ring']} launches on the "
          f"plane ring, {K8_DESIGNS['first']} on the first design, each the "
          "design its table names")
    print(json.dumps({"kernels": [rows_entry, cols_entry, fused_entry,
                                  rows64_entry, cols64_entry, *il_entries,
                                  *off_entries],
                      "passes": (timed + timed64 + off["timed"] + i8["timed"]
                                 + i8h["timed"] + i8il["timed"]),
                      "variant_b": off["variant_b"], "end_to_end": e2e,
                      "routes": {k: il[k] for k in
                                 ("config_2i_routes", "library_ms",
                                  "winners", "single_pass", "multi_pass")},
                      "real": rl["timings"],
                      "dist": {"paths": [p["timed"] for p in
                                         dist["paths"].values()],
                               "long_1d": dist["long_1d"]},
                      "autotune": {"record": auto["record"],
                                   "libraries": auto["libraries"],
                                   "seconds": auto["seconds"]},
                      "sweep": {k: sweep[k] for k in ("unswept", "swept",
                                                      "seconds")},
                      "trace": {k: traced[k] for k in
                                ("kernel", "kernel_us", "seconds")},
                      "record": {k: recorded[k] for k in
                                 ("generic_ms", "replayed_ms", "err",
                                  "seconds")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
