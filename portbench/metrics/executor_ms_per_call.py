"""Mean milliseconds of a call in the executors, from the program's own
spans in the traced slice: each ``pyfft.pass.*`` less the part of it that
its ``pyfft.entry.*`` spans cover (the executors' checks, views, tables,
device and stream lookups), summed and divided by the slice's calls (the
benchmark's ``execute.fwd`` and ``execute.inv``).  None where the slice
holds no ``pyfft.pass.*``, as with a program that records no spans.
Reads ``executor_ms_per_call.<mix>`` and
``executor_ms_per_call.<config>.<mix>``."""

from portbench import devtrace


def value(run):
    sl = run.slice
    if sl is None or not sl.calls:
        return None
    outer = [(a, b) for n, a, b in sl.spans if n.startswith("pyfft.pass.")]
    if not outer:
        return None
    inner = [(a, b) for n, a, b in sl.spans if n.startswith("pyfft.entry.")]
    s = sum((b - a) - devtrace.union_s(
        (max(a, c), min(b, d)) for c, d in inner if c < b and d > a)
        for a, b in outer)
    return s * 1e3 / len(sl.calls)
