"""The work of one transform and the least time the card could take.

The benchmark's own arithmetic (the program's ``effective_gflops`` is the
pattern; it is not imported).  A transform is one ``execute`` call: every
transform of its batch, over all of its axes.

A configuration of a complex dtype transforms complex points to complex
points.  One of a real dtype (``float32``, ``float64``) is a real-input
transform: its forward takes real points to the half spectrum, the last
axis of n points cut to n/2 + 1 complex ones of the matching complex
dtype (``SPECTRUM``), and its inverse takes that half spectrum back.

* FLOP: 5 N log2 N per complex transform of N points, 2.5 N log2 N per
  real one, times the batch, whatever the implementation (the FFT
  community's nominal counts).
* Least bytes: each input point read once and each output point written
  once, however many passes the program makes: 16 bytes a complex64
  point, 32 a complex128 point; a real transform reads (or writes) its N
  real points at 4 or 8 bytes and writes (or reads) its N/n (n/2 + 1)
  complex ones at 8 or 16, in either direction.
* Least time: the larger of FLOP over the peak FLOP rate of the dtype and
  least bytes over the peak memory bandwidth.

Peaks are NVIDIA's published figures for the H100 SXM (dense, no
sparsity): 3.35 TB/s of HBM3, 67 TFLOP/s FP32 and 34 TFLOP/s FP64 outside
the tensor cores.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"complex64": 67e12, "complex128": 34e12,
               "float32": 67e12, "float64": 34e12}
POINT_BYTES = {"complex64": 8, "complex128": 16, "float32": 4, "float64": 8}
# a real dtype's half spectrum: its complex dtype
SPECTRUM = {"float32": "complex64", "float64": "complex128"}


def points(config: dict) -> int:
    """Points of one transform of the configuration (its batch excluded)."""
    return math.prod(config["shape"])


def half_points(config: dict) -> int:
    """Complex points of one real transform's half spectrum: the last axis
    of n points cut to n/2 + 1."""
    *lead, n = config["shape"]
    return math.prod(lead) * (n // 2 + 1)


def flop(config: dict) -> float:
    """Nominal FLOP of one ``execute`` call: 5 N log2 N (2.5 for real
    input) times the batch."""
    n = points(config)
    per = 2.5 if config["dtype"] in SPECTRUM else 5.0
    return per * n * math.log2(n) * config["batch"]


def least_bytes(config: dict) -> float:
    """Bytes one call must move: its input read once, its output written
    once."""
    dtype = config["dtype"]
    if dtype in SPECTRUM:
        return float((POINT_BYTES[dtype] * points(config)
                      + POINT_BYTES[SPECTRUM[dtype]] * half_points(config))
                     * config["batch"])
    return 2.0 * POINT_BYTES[dtype] * points(config) * config["batch"]


def least_s(config: dict) -> float:
    """The least seconds one call could take on the card at the published
    peaks: the larger of the FLOP bound and the bytes bound."""
    return max(flop(config) / PEAK_FLOP_S[config["dtype"]],
               least_bytes(config) / PEAK_BYTES_S)
