"""A closed loop of roundtrip steps.

A step is a forward call on the next of the mix's distinct inputs, then
an inverse call on the forward's output.  Parameters:

* ``inputs``: distinct inputs, taken in turn;
* ``wait``: ``"default"`` calls ``execute`` as a user does by default,
  which returns once the result is ready; ``"none"`` passes
  ``wait_for_finish=False``;
* ``in_flight_steps`` (with ``"none"``): at most this many steps are
  outstanding, each tracked by a CUDA event recorded after it (a ring of
  events made once); a step waits for the oldest before it is issued.

A kept step has its two outputs copied into buffers made before the
window, so that the allocator cycles the same blocks whichever steps the
seed picks.  A buffer of another form than its call's output (a real
input's transform changes it) is replaced by one of the output's.
"""

from __future__ import annotations

import time

from portbench.traffic import WAITS, Window, copy_into, fit, like, no_span


def buffers(inputs: list) -> tuple:
    """A kept step's two outputs: the forward's and the inverse's."""
    return like(inputs[0]), like(inputs[0])


def drive(system, inputs: list, mix: dict, dev, seconds: float,
          keep=None, tracer=None, min_steps: int = 0) -> Window:
    wait = WAITS[mix["wait"]]
    limit = mix.get("in_flight_steps") if wait is False else None
    keep = keep or {}
    last_kept = max(keep, default=-1)
    ring = [dev.event() for _ in range(limit or 0)]
    w = Window()
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while (i <= last_kept or i < min_steps or clock() - t0 < seconds
           or (tracer is not None and not tracer.done)):
        span = no_span
        if tracer is not None:
            tracer.before(i)
            span = tracer.span
        traced = tracer is not None and tracer.active
        k = i % len(inputs)
        with span("step"):
            a = clock()
            if limit and i >= limit:
                with span("wait.in_flight"):
                    ring[i % limit].synchronize()
            w.wait_s += clock() - a
            a = clock()
            with span("execute.fwd"):
                y = system(inputs[k], False, wait)
            b = clock()
            with span("execute.inv"):
                z = system(y, True, wait)
            c = clock()
            if i in keep:
                ybuf, zbuf = keep[i] = fit(keep[i], (y, z))
                copy_into(ybuf, y)
                copy_into(zbuf, z)
                w.kept[i] = [(inputs[k], False, ybuf), (ybuf, True, zbuf)]
            if limit:
                ring[i % limit].record()
        if not traced:
            w.call_s += (b - a, c - b)
        del y, z
        i += 1
    dev.sync()
    w.seconds = clock() - t0
    w.steps, w.calls = i, 2 * i
    return w
