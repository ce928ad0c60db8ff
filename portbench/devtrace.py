"""The traced slice: ``torch.profiler`` over a bounded run of steps, and
its reduction to device records and host spans.

The benchmark names its own host spans (``record_function``): ``step``
around each step, ``execute.fwd`` and ``execute.inv`` around the calls
into the program, ``wait.in_flight`` around a wait of its own.  The
device records are CUPTI's kernel, copy and set records, under the names
CUPTI prints.  Times are in seconds from here on.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPANS = ("execute.fwd", "execute.inv")


@dataclass
class Slice:
    """Device records and host spans of the traced steps, each a
    (name, start, end) in seconds on the trace's clock."""
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    @property
    def calls(self) -> list:
        return [s for s in self.spans if s[0] in CALL_SPANS]


def from_chrome(events: list) -> Slice:
    """The slice held by a Chrome trace's ``traceEvents``."""
    out = Slice()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"]) * 1e-6
        rec = (e.get("name", ""), start, start + float(e["dur"]) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            out.device.append(rec)
        elif e.get("cat") == "user_annotation":
            out.spans.append(rec)
    out.device.sort(key=lambda r: r[1])
    out.spans.sort(key=lambda r: r[1])
    return out


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_s(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def busy_s(sl: Slice) -> float:
    """Seconds in which some device record ran."""
    return union_s((r[1], r[2]) for r in sl.device)


def span_s(sl: Slice) -> float:
    """From the first device record's start to the last one's end."""
    if not sl.device:
        return 0.0
    return max(r[2] for r in sl.device) - sl.device[0][1]


def idle_share(sl: Slice) -> float | None:
    span = span_s(sl)
    if span <= 0:
        return None
    return 1.0 - busy_s(sl) / span


def gaps(sl: Slice) -> list:
    """The device's idle gaps, (start, end), between its records."""
    m = merged((r[1], r[2]) for r in sl.device)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]


def host_span_at(sl: Slice, t: float) -> str:
    """The innermost benchmark span the host was in at ``t``."""
    inside = [s for s in sl.spans if s[1] <= t < s[2]]
    if not inside:
        return "outside spans"
    return max(inside, key=lambda s: (s[1], s[1] - s[2]))[0]


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each under the host span it fell in."""
    by_name: dict = {}
    for name, a, b in sl.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(sl), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_span_at(sl, a), b - a] for a, b in idle]}


def roofline_pct(sl: Slice, least_s: float) -> float | None:
    """The least time of the slice's calls (``least_s`` each) over their
    device time, the summed duration of every record, in %."""
    if not sl.device or not sl.calls:
        return None
    return 100.0 * least_s * len(sl.calls) / sum(b - a for _, a, b in
                                                  sl.device)


def records_per_call(sl: Slice) -> float | None:
    """Device records (kernels, copies, sets) per call."""
    if not sl.device or not sl.calls:
        return None
    return len(sl.device) / len(sl.calls)


def host_s_per_call(sl: Slice) -> float | None:
    """Mean over the slice's calls of the call's span less the part of it
    in which the device ran."""
    calls = sl.calls
    if not calls or not sl.device:
        return None
    dev = merged((r[1], r[2]) for r in sl.device)
    total = 0.0
    for _, a, b in calls:
        covered = sum(max(0.0, min(b, d1) - max(a, d0)) for d0, d1 in dev
                      if d0 < b and d1 > a)
        total += (b - a) - covered
    return total / len(calls)


def profiler_cost(sl: Slice, calls: int, seconds: float, traced_s: float,
                  overhead_s: float = 0.0) -> str:
    """How far the profiler slows the host, read in one window of
    ``calls`` calls in ``seconds``: ``traced_s`` in the traced steps and
    ``overhead_s`` in the profiler's own start and stop.  The wall time a
    call and the idle share by the rate (1 - the slice's device time a
    call x calls / wall time), inside the slice and outside it."""
    n_in = len(sl.calls)
    n_out, out_s = calls - n_in, seconds - traced_s - overhead_s
    if not n_in or not sl.device or traced_s <= 0 or n_out <= 0 or out_s <= 0:
        return "profiler's cost: nothing to read"
    dev = sum(b - a for _, a, b in sl.device) / n_in
    return (f"profiler's cost: inside the slice {traced_s / n_in * 1e3:.6f}"
            f" ms a call, idle by the rate {1 - dev * n_in / traced_s:.4f}"
            f" (by the union {idle_share(sl):.4f}); outside it "
            f"{out_s / n_out * 1e3:.6f} ms a call, idle by the rate "
            f"{1 - dev * n_out / out_s:.4f}; device {dev * 1e3:.6f} ms a "
            f"call; the profiler's start and stop {overhead_s:.6f} s")


class Tracer:
    """Profiles steps [skip, skip + steps) of a window and reduces them to
    a ``Slice``.  ``span(name)`` is a ``record_function`` while the
    profiler runs and does nothing otherwise."""

    def __init__(self, skip: int, steps: int, sync, cuda: bool):
        self.skip, self.steps, self._sync, self._cuda = skip, steps, sync, cuda
        self.active = False
        self.done = False
        self._prof = None
        self.slice: Slice | None = None
        self.host_s = 0.0           # the traced steps, on the host clock
        self.overhead_s = 0.0       # the profiler's own start and stop

    def before(self, step: int) -> None:
        import torch.profiler as tp
        if step == self.skip:
            acts = [tp.ProfilerActivity.CPU]
            if self._cuda:
                acts.append(tp.ProfilerActivity.CUDA)
            self._prof = tp.profile(activities=acts)
            t = time.perf_counter()
            self._prof.start()
            self.active = True
            self.host_s = -time.perf_counter()
            self.overhead_s = -self.host_s - t
        elif step == self.skip + self.steps and self.active:
            self._sync()
            t = time.perf_counter()
            self.host_s += t
            self._prof.stop()
            self.overhead_s += time.perf_counter() - t
            self.active = False
            self.done = True

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch.profiler as tp
        return tp.record_function(name)

    def read(self) -> Slice:
        """The slice, from the profiler's Chrome trace (written to a
        temporary file in ``TMPDIR`` and removed)."""
        if self.slice is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "slice.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            self.slice = from_chrome(events)
            self._prof = None
        return self.slice
