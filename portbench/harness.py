"""One run of one cell: set-up, the measured window, the traced slice,
the check, and the result line.

``run`` is device-agnostic so that the tests can drive it on the CPU with
a small configuration; ``run.py`` is the entry that sets the environment
up, requires the card and prints.
"""

from __future__ import annotations

import gc
import sys
from dataclasses import dataclass

import torch

from portbench import check, devtrace, registry, system as sut, traffic, work

FORBIDDEN = ("jax", "jaxlib", "flax", "pyfft_tpu")


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    setup_s: float
    window_s: float
    calls: int
    flop: float
    call_s: list
    peak_bytes: int
    least_s: float
    slice: devtrace.Slice | None = None


class Dev:
    """The few device operations the harness needs, on a card or (for the
    tests) on the CPU."""

    class _Ready:
        def record(self):
            pass

        def synchronize(self):
            pass

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        return torch.cuda.Event() if self.cuda else self._Ready()

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must never
    load (the JAX package and JAX), compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(name: str, cell: dict, config: dict, mix: dict, *, seed: int,
        seconds: float, traced: bool, device, metrics: list,
        started: float, clock, system=None, log=print) -> dict:
    """Run ``cell`` once and return its result line (a dict), with the
    check's numbers last under ``checks``.  ``metrics`` lists (name, unit)
    of what to report; ``started`` is the process's start on ``clock``.
    ``system`` replaces the port (a control or a fault)."""
    dev = Dev(device)
    form = sut.form(config)
    gen = registry.generator(mix["generator"])
    system = system or form.Port(config, dev.device)
    inputs = form.make_inputs(config, mix["inputs"], seed, dev.device)
    keep = check.sample(seed, cell["check"]["steps"], cell["check"]["within"])
    log(f"cell {name}: {system.describe()}; keeps steps {keep}")

    # warm-up: the cell's own calls, as many steps as may be in flight,
    # and one copy into a kept step's buffers; the window's kept steps
    # take buffers of the forms its outputs showed
    bufs = {i: gen.buffers(inputs) for i in keep}
    warm = gen.drive(system, inputs, mix, dev, 0.0, keep={0: bufs[keep[0]]},
                     min_steps=mix.get("in_flight_steps", 1) + 1)
    outs = [out for _, _, out in warm.kept[0]]
    bufs = {i: traffic.fit(b, outs) for i, b in bufs.items()}
    del warm, outs
    dev.sync()
    gc.collect()
    gc.freeze()             # set-up's objects: out of every later collection

    tracer = None
    if traced:
        t = cell["trace"]
        tracer = devtrace.Tracer(t["skip"], t["steps"], dev.sync, dev.cuda)
    dev.reset_peak()
    setup_s = clock() - started
    w = gen.drive(system, inputs, mix, dev, seconds, keep=bufs,
                  tracer=tracer)
    peak = dev.peak_bytes()
    log(f"window: {w.steps} steps, {w.calls} calls in {w.seconds:.6f} s; "
        f"host in untraced calls {sum(w.call_s):.6f} s, in waits "
        f"{w.wait_s:.6f} s; peak {peak} bytes")

    rec = Run(setup_s=setup_s, window_s=w.seconds, calls=w.calls,
              flop=w.calls * work.flop(config), call_s=w.call_s,
              peak_bytes=peak, least_s=work.least_s(config),
              slice=tracer.read() if tracer else None)
    if tracer is not None:
        log(devtrace.profiler_cost(rec.slice, w.calls, w.seconds,
                                   tracer.host_s, tracer.overhead_s))
    values = {}
    for mname, unit in metrics:
        v = registry.metric(mname)(rec)
        if v is not None:
            values[mname] = {"value": v, "unit": unit}

    del system                  # the program's state, before the reference
    checks = check.judge(form, config, w.kept)
    ok = check.passed(checks)
    result = {"correct": len(ok) == len(checks),
              "attempted": w.calls,
              "failed": len(checks) - len(ok),
              "metrics": values,
              "device": {"count": 1, "memory_peak_bytes": peak}}
    if tracer is not None:
        sl = rec.slice
        result["device"].update(busy_s=devtrace.busy_s(sl),
                                window_s=devtrace.span_s(sl))
        result["breakdown"] = devtrace.breakdown(sl)
    result["checks"] = checks
    return result
