"""The host time of ``Plan.execute`` split by layer on the host clock, with
no profiler running, on one CUDA card.

    python3 probes/host_split.py [--seconds S] [--shape 256,256,256]

``utils/profiling.span`` marks the program's layers (``pyfft.execute``,
``pyfft.pass.<executor>``, ``pyfft.entry.<kernel>``, ``pyfft.wait``), but
only a profiler's trace sees them, and the profiler slows the host and
records every aten op.  Here each span site's ``span`` is replaced by one
that reads ``time.perf_counter`` around the call and takes the time of its
children off its own, so that, per call:

  * facade   = ``pyfft.execute`` less its passes and its wait;
  * executor = the ``pyfft.pass.*`` spans less their entries;
  * entry    = the ``pyfft.entry.*`` spans (tensor maps and the launch);
  * wait     = ``pyfft.wait``,

the split the benchmark's ``*_ms_per_call`` metrics read from a trace.
The loops are the benchmark's roundtrips (a forward, then an inverse on
its output) over 4 standard normal complex64 inputs: ``sync`` waits in each
call, ``stream`` passes ``wait_for_finish=False`` with at most 4 steps in
flight.  Each loop runs with the clocked spans and with the program's own
in turn (3 windows each), so the clocked spans' own cost shows as the
difference in calls a second.

Also measured: one span site's cost with no profiler running (a 7-argument
function through ``span`` against the bare call) and with one recording;
and counted: the calls that replayed ``Plan``'s call record, recorded one
or ran the generic path (the registry's ``record.*``).

Prints the card's name and power limit first and one JSON object of every
number last.  Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyfft_tpu_torch import Plan, plan as plan_mod     # noqa: E402
from pyfft_tpu_torch.ops import launch                  # noqa: E402
from pyfft_tpu_torch.utils import profiling            # noqa: E402

SITES = (plan_mod, launch)
LAYERS = (("facade", "pyfft.execute"), ("executor", "pyfft.pass."),
          ("entry", "pyfft.entry."), ("wait", "pyfft.wait"))


class Clock:
    """A ``span`` that adds each call's own seconds (less its children's)
    to ``own[name]``."""

    def __init__(self):
        self.own = collections.defaultdict(float)
        self.stack = []

    def __call__(self, name, fn, *args, **kwargs):
        self.stack.append(0.0)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            self.own[name] += dt - self.stack.pop()
            if self.stack:
                self.stack[-1] += dt

    def split(self, calls: int) -> dict:
        """Milliseconds a call by layer."""
        return {layer: sum(v for k, v in self.own.items()
                           if k.startswith(prefix)) * 1e3 / calls
                for layer, prefix in LAYERS}


def use(span) -> None:
    for m in SITES:
        m.span = span


def loop(plan, inputs, mode: str, seconds: float) -> tuple[int, float]:
    """Roundtrips for ``seconds``: (calls, wall seconds)."""
    wait = mode == "sync"
    ring = [torch.cuda.Event() for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        if not wait and i >= 4:
            ring[i % 4].synchronize()
        y = plan.execute(inputs[i % 4], wait_for_finish=wait)
        plan.execute(y, inverse=True, wait_for_finish=wait)
        if not wait:
            ring[i % 4].record()
        i += 1
    torch.cuda.synchronize()
    return 2 * i, time.perf_counter() - t0


def site_cost_us(n: int = 20000) -> float:
    """Microseconds one span site adds to a 7-argument call, the least of
    five rounds."""
    def f(a, b, c, d, e, g, h):
        return 0

    def bare():
        for _ in range(n):
            f(1, 2, 3, 4, 5, 6, 7)

    def spanned():
        for _ in range(n):
            profiling.span("pyfft.entry.K8", f, 1, 2, 3, 4, 5, 6, 7)

    def best(fn):
        out = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
        return min(out) / n * 1e6

    return best(spanned) - best(bare)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--shape", default="256,256,256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("host_split needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shape = tuple(int(s) for s in args.shape.split(","))
    g = torch.Generator(device="cuda")
    g.manual_seed(2024)
    inputs = [torch.randn(shape, dtype=torch.complex64, device="cuda",
                          generator=g) for _ in range(4)]
    plan = Plan(shape, torch.complex64, device="cuda")
    own = profiling.span
    out = {"shape": shape, "plan": repr(plan)}
    for mode in ("sync", "stream"):
        loop(plan, inputs, mode, 1.0)                  # warm-up
        rows = {"clocked": [], "plain": []}
        for _ in range(3):
            clock = Clock()
            use(clock)
            calls, wall = loop(plan, inputs, mode, args.seconds)
            rows["clocked"].append({"calls_per_s": calls / wall,
                                    **clock.split(calls)})
            use(own)
            calls, wall = loop(plan, inputs, mode, args.seconds)
            rows["plain"].append({"calls_per_s": calls / wall})
        out[mode] = rows
        med = {k: statistics.median(r[k] for r in rows["clocked"])
               for k in rows["clocked"][0]}
        print(mode, "clocked, median of 3:", {k: round(v, 5)
                                              for k, v in med.items()},
              "plain calls/s:", [round(r["calls_per_s"], 1)
                                 for r in rows["plain"]], flush=True)
    # the calls that replayed a call record, recorded one or ran generic
    out["records"] = {k: v for k, v in profiling.counts().items()
                      if k.startswith("record.")}
    out["site_off_us"] = [site_cost_us() for _ in range(3)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["site_on_us"] = [site_cost_us(2000) for _ in range(3)]
    print("span site:", {k: [round(v, 3) for v in out[k]]
                         for k in ("site_off_us", "site_on_us")}, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
