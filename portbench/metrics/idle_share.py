"""Share of the traced slice's span in which no device record ran.
Reads ``idle_share.<config>.<mix>`` and ``idle_share.<mix>``."""

from portbench import devtrace


def value(run):
    return None if run.slice is None else devtrace.idle_share(run.slice)
