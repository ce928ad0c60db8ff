"""Device records (kernels, copies, sets) per call in the traced slice.
Reads ``launches_per_call.<config>.<mix>``."""

from portbench import devtrace


def value(run):
    return None if run.slice is None else devtrace.records_per_call(run.slice)
