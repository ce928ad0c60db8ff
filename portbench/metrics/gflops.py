"""Nominal GFLOP/s over the window: the FLOP of every call it completed
(``work.flop``) over the wall time from its first dispatch to the
synchronise that ends it.  Reads ``gflops.<config>``, one name (and
bound) a configuration."""


def value(run):
    return run.flop / run.window_s / 1e9
