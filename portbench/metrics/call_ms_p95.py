"""The 95th percentile (nearest rank) of the host milliseconds of each
call outside the traced slice, from entering ``execute`` to its return:
the whole call as its caller sees it (the facade, the kernels and, in a
waited call, the wait).  Reads ``call_ms_p95.<mix>``."""

import math


def value(run):
    if not run.call_s:
        return None
    s = sorted(run.call_s)
    return s[math.ceil(0.95 * len(s)) - 1] * 1e3
