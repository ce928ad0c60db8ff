"""The work of one transform and the least time the card could take.

The benchmark's own arithmetic (the program's ``effective_gflops`` is the
pattern; it is not imported).  A transform is one ``execute`` call: every
transform of its batch, over all of its axes.

* FLOP: 5 N log2 N per transform of N points, times the batch, whatever
  the implementation (the FFT community's nominal count).
* Least bytes: each input point read once and each output point written
  once: 16 bytes a complex64 point, 32 a complex128 point, however many
  passes the program makes.
* Least time: the larger of FLOP over the peak FLOP rate of the dtype and
  least bytes over the peak memory bandwidth.

Peaks are NVIDIA's published figures for the H100 SXM (dense, no
sparsity): 3.35 TB/s of HBM3, 67 TFLOP/s FP32 and 34 TFLOP/s FP64 outside
the tensor cores.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"complex64": 67e12, "complex128": 34e12}
POINT_BYTES = {"complex64": 8, "complex128": 16}


def points(config: dict) -> int:
    """Points of one transform of the configuration (its batch excluded)."""
    return math.prod(config["shape"])


def flop(config: dict) -> float:
    """Nominal FLOP of one ``execute`` call: 5 N log2 N times the batch."""
    n = points(config)
    return 5.0 * n * math.log2(n) * config["batch"]


def least_bytes(config: dict) -> float:
    """Bytes one call must move: its input read once, its output written
    once."""
    return 2.0 * POINT_BYTES[config["dtype"]] * points(config) * config["batch"]


def least_s(config: dict) -> float:
    """The least seconds one call could take on the card at the published
    peaks: the larger of the FLOP bound and the bytes bound."""
    return max(flop(config) / PEAK_FLOP_S[config["dtype"]],
               least_bytes(config) / PEAK_BYTES_S)
