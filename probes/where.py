"""Where config 2's time goes, beyond the kernel alone, on one CUDA card.

    python3 probes/where.py

Measures, on the batched 1D complex64 FFT with N = 4096 and batch 4096
unless named otherwise:

  1. ``Plan.execute`` timed by CUDA events (median of 20 after warm-up),
     planar and complex form, without its sync: what the facade adds to
     the kernel's device time;
  2. ``Plan.execute`` with its sync on the host clock (median and p90 of
     30): what a caller waits;
  3. the host cost of one ``local.fft_axis`` call, from 200 calls on one
     4096-point row enqueued back to back (the device finishes each before
     the host issues the next, so the host time is the wrapper's);
  4. the device's idle share over 20 back-to-back asynchronous ``execute``
     calls: 1 - (20 x the kernel's median) / (the events' span), and the
     same under ``torch.profiler`` (its device time over its host window);
  5. three more row shapes at the same 128 MiB: the kernel, its plain
     version and cuFFT (``torch.fft.fft``, a library, for context).

Prints the card's name and power limit first and one JSON object of every
number last.  Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyfft_tpu_torch import Plan                      # noqa: E402
from pyfft_tpu_torch.ops import local                  # noqa: E402
from pyfft_tpu_torch.utils.profiling import (effective_gflops,  # noqa: E402
                                             time_ms)

N, BATCH = 4096, 4096


def host_ms(fn, iters: int = 30):
    """Median and p90 host milliseconds of ``fn()``, which synchronises."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return statistics.median(ts), ts[int(0.9 * (len(ts) - 1))]


def data(rows: int, n: int):
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    xt = torch.from_numpy(x).cuda()
    return xt, xt.real.contiguous(), xt.imag.contiguous()


def facade(out: dict) -> None:
    xt, re, im = data(BATCH, N)
    plan = Plan((N,), device="cuda", wait_for_finish=False)
    out["execute_event_ms"] = {
        "planar": time_ms(lambda: plan.execute(re, im)),
        "complex": time_ms(lambda: plan.execute(xt))}
    out["kernel_event_ms"] = time_ms(lambda: local.fft_axis(re, im, -1))
    sync = Plan((N,), device="cuda", wait_for_finish=True)
    med_p, p90_p = host_ms(lambda: sync.execute(re, im))
    med_c, p90_c = host_ms(lambda: sync.execute(xt))
    out["execute_sync_host_ms"] = {
        "planar": {"median": med_p, "p90": p90_p},
        "complex": {"median": med_c, "p90": p90_c}}

    # Idle share of an asynchronous execute loop, from events alone.
    k = 20
    for _ in range(3):
        plan.execute(re, im)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(k):
        plan.execute(re, im)
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    busy = k * out["kernel_event_ms"]
    out["loop_events"] = {"calls": k, "span_ms": span, "busy_ms": busy,
                          "idle_share": 1.0 - busy / span}

    # The same loop under torch.profiler.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            plan.execute(re, im)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us, names = 0.0, set()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            dev_us += t
            names.add(e.key)
    out["loop_profiler"] = {"calls": k, "wall_ms": wall,
                            "device_ms": dev_us / 1e3,
                            "idle_share": 1.0 - dev_us / 1e3 / wall,
                            "device_ops": sorted(names)}


def wrapper_host(out: dict) -> None:
    _, re, im = data(1, N)
    o = (torch.empty_like(re), torch.empty_like(im))
    calls = 200
    for _ in range(10):
        local.fft_axis(re, im, -1, out=o)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        local.fft_axis(re, im, -1, out=o)
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    out["fft_axis_host_us"] = host


def shapes(out: dict) -> None:
    rows_out = []
    for n, rows in ((8192, 2048), (1024, 16384), (256, 65536)):
        xt, re, im = data(rows, n)
        o = (torch.empty_like(re), torch.empty_like(im))
        ms = time_ms(lambda: local.fft_axis(re, im, -1, out=o))
        rows_out.append({
            "n": n, "rows": rows, "kernel_ms": ms,
            "gflops": effective_gflops(n, rows, ms * 1e-3),
            "plain_ms": time_ms(lambda: local.fft_rows_plain(re, im, -1)),
            "cufft_ms": time_ms(lambda: torch.fft.fft(xt))})
        del xt, re, im, o
    out["shapes"] = rows_out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    out = {"device": torch.cuda.get_device_name(0)}
    facade(out)
    wrapper_host(out)
    shapes(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
