"""The transform's share of its roofline in the traced slice, in %: the
least time one call could take at the published peaks (``work.least_s``)
over the device time per call, the summed duration of every kernel, copy
and set record over the calls.  Reads ``fft_roofline.<config>.<mix>``."""

from portbench import devtrace


def value(run):
    return None if run.slice is None else devtrace.roofline_pct(
        run.slice, run.least_s)
