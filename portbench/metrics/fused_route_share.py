"""The share of the traced slice's ``Plan.execute`` calls that took the
complex form's "fused" route (one row-kernel launch on the interleaved
view), from the program's own spans: the ``pyfft.execute`` spans that
hold a ``pyfft.pass.fused`` span, over every ``pyfft.execute`` span.
None where the slice holds no call, no ``pyfft.execute`` or no
``pyfft.pass.fused`` (a program that names no such pass, or a run whose
calls all took another route).  Reads ``fused_route_share.<cell>``."""

import bisect


def value(run):
    sl = run.slice
    if sl is None or not sl.calls:
        return None
    outer = [(a, b) for n, a, b in sl.spans if n == "pyfft.execute"]
    fused = sorted(a for n, a, _ in sl.spans if n == "pyfft.pass.fused")
    if not outer or not fused:
        return None

    def holds(a, b):
        i = bisect.bisect_left(fused, a)
        return i < len(fused) and fused[i] < b

    return sum(holds(a, b) for a, b in outer) / len(outer)
