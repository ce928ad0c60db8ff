"""Mean milliseconds of a waited call's span in which the device ran
nothing: the host's own part of the call.  Reads
``host_ms_per_call.<mix>``."""

from portbench import devtrace


def value(run):
    s = None if run.slice is None else devtrace.host_s_per_call(run.slice)
    return None if s is None else s * 1e3
