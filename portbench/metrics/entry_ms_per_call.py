"""Mean milliseconds of a call in the kernels' C entries, from the
program's own spans in the traced slice: the ``pyfft.entry.*`` spans (the
``ctypes`` call, the tensor maps encoded and the launch), summed and
divided by the slice's calls (the benchmark's ``execute.fwd`` and
``execute.inv``).  None where the slice holds no ``pyfft.entry.*``, as
with a program that records no spans.  Reads ``entry_ms_per_call.<mix>``
and ``entry_ms_per_call.<config>.<mix>``."""


def value(run):
    sl = run.slice
    if sl is None or not sl.calls:
        return None
    spans = [b - a for n, a, b in sl.spans if n.startswith("pyfft.entry.")]
    if not spans:
        return None
    return sum(spans) * 1e3 / len(sl.calls)
