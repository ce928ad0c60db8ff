"""Mean milliseconds of a waited call: the window's wall time over the
calls it made, each of which returned only once its result was ready."""


def value(run):
    return run.window_s * 1e3 / run.calls
