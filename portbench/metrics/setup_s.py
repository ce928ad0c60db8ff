"""Seconds from the start of ``run.py`` to the window's start: imports,
the card's context, loading (and on a cold checkout building) the
kernels, the inputs, the plan and its warm-up."""


def value(run):
    return run.setup_s
