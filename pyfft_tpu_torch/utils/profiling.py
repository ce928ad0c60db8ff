"""Timing, tracing and counting on the CUDA device.

Counterpart of ``pyfft_tpu/utils/profiling.py``.  Device time comes from
CUDA events; the roofline's bandwidth is measured on the card by a
device-to-device copy, never taken from a data sheet.  The timers raise
without a CUDA device; ``trace`` records the CPU alone there.  The JAX
package's ``force``, ``time_chained`` and ``time_scan_chain`` have no
counterpart: they work around JAX's asynchronous dispatch, and CUDA events
and ``time_queued_ms`` time the device directly.

The program's own spans and counts live here too.  ``span(name, fn,
*args)`` calls ``fn(*args)`` as a host interval of the program
(``pyfft.execute``, ``pyfft.pass.<executor>``, ``pyfft.entry.<kernel>``,
``pyfft.wait``) in whatever ``torch.profiler`` trace is recording, on the
clock of the card's kernel records, and costs one flag check otherwise.
``COUNTS`` is the one registry of counts, always on:
``launch.<kernel>.<design>`` a launch whose C entry reported that design
(``launch.<kernel>`` where the entry reports none; an int8 host is
``<kernel>+K10``), ``load_s.<library>`` the seconds ``ops/build.load``
took to load a library, ``nvcc``'s build included, and ``record.hit``,
``record.miss`` and ``record.generic`` the card's ``Plan.execute`` calls
that replayed a call record, recorded one, or took the generic path for
a key that keeps none (``plan.py``).
"""

from __future__ import annotations

import collections
import contextlib
import math
import statistics
import time

import torch
from torch.profiler import record_function

__all__ = ["trace", "span", "counts", "total", "reset", "COUNTS", "time_ms",
           "time_queued_ms", "copy_bandwidth_gbs", "effective_gflops"]

# The registry: every count and load time of the process since the last
# ``reset``.  A site adds to it in place (``COUNTS[key] += 1``), as cheap
# as a module global's increment.
COUNTS: collections.defaultdict = collections.defaultdict(int)

# Whether a torch profiler is recording: a C call, no Python state.
_recording = torch.autograd._profiler_enabled


def span(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside the program's span ``name``: a
    ``record_function`` while a torch profiler records, so that it lands as
    a ``user_annotation`` beside CUPTI's kernel records; else the bare
    call, with no context entered, no name formed and nothing
    allocated."""
    if _recording():
        with record_function(name):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


def counts() -> dict:
    """A copy of the registry: each key that was added to, with its
    value."""
    return dict(COUNTS)


def total(key: str):
    """The sum of the registry's values under ``key``: its own and those of
    the keys that extend it by a dot (``total("launch.K8")`` is
    ``launch.K8.ring`` plus ``launch.K8.first``, not ``launch.K8+K10``)."""
    below = key + "."
    return sum(v for k, v in list(COUNTS.items())
               if k == key or k.startswith(below))


def reset() -> None:
    """Empty the registry."""
    COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block: the CPU's activity,
    and the card's (CUPTI's kernel records) where one is present; on exit,
    write it into ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json``,
    which TensorBoard's profiler plugin and Perfetto open.  The kernels
    launch through ``ctypes``, not through a torch op, so they appear as
    the card's kernel records alone.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


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


def time_queued_ms(fn, *, calls: int = 20, warmup: int = 3,
                   hold_ms: float = 20.0) -> tuple[float, float]:
    """(device ms, host ms) per ``fn()`` call, with the host ahead.

    A spin kernel (``torch.cuda._sleep``) first holds the device for about
    ``hold_ms`` while the host enqueues ``calls`` calls between two CUDA
    events, so the events time the device's work with no gap for the host
    to fill; the host clock times the enqueueing.  Where the start event
    has already passed when the last call is enqueued, the host was not
    ahead: the hold doubles and the run repeats, three times at most, then
    raises.  ``time_ms`` reads the host's time wherever it exceeds the
    device's; this reads the device's alone.
    """
    _require_cuda()
    for _ in range(warmup):
        fn()
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * 2e6))     # cycles at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / calls
        ahead = not start.query()
        end.record()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / calls, host
        hold_ms *= 2
    raise RuntimeError(f"the host did not get ahead of the device in "
                       f"{hold_ms / 2:.0f} ms")


def copy_bandwidth_gbs(mib: int = 256, iters: int = 20) -> float:
    """Device-memory bandwidth (GB/s) of a ``mib``-MiB device-to-device
    copy, counting its read and its write."""
    _require_cuda()
    src = torch.ones(mib << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), iters=iters)
    return 2.0 * src.numel() / (ms * 1e-3) / 1e9


def effective_gflops(shape, batch: int, seconds: float) -> float:
    """The FFT throughput metric: 5*N*log2(N)*batch / t, N the transform's
    points (``shape`` a shape or an int)."""
    n = shape if isinstance(shape, int) else math.prod(shape)
    return 5.0 * n * math.log2(n) * batch / seconds / 1e9
