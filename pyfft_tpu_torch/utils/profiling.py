"""Timing on the CUDA device.

Counterpart of ``pyfft_tpu/utils/profiling.py``.  Device time comes from
CUDA events; the roofline's bandwidth is measured on the card by a
device-to-device copy, never taken from a data sheet.  There is no CPU
fallback: every function here raises without a CUDA device.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["time_ms", "copy_bandwidth_gbs", "effective_gflops"]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def time_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of one ``fn()`` call.

    After ``warmup`` calls, ``iters`` calls are enqueued back to back, each
    between two CUDA events, and the device is synchronised once, so the
    host's launch overhead hides behind the device's work once the queue
    is ahead.
    """
    _require_cuda()
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def copy_bandwidth_gbs(mib: int = 256, iters: int = 20) -> float:
    """Device-memory bandwidth (GB/s) of a ``mib``-MiB device-to-device
    copy, counting its read and its write."""
    _require_cuda()
    src = torch.ones(mib << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), iters=iters)
    return 2.0 * src.numel() / (ms * 1e-3) / 1e9


def effective_gflops(n: int, batch: int, seconds: float) -> float:
    """The FFT throughput metric: 5*N*log2(N)*batch / t."""
    return 5.0 * n * math.log2(n) * batch / seconds / 1e9
