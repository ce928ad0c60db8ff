"""The column pass's share of its roofline in the traced slice, in %: the
least time one call's column pass could take at the published peaks over
the device time per call of the slice's records whose name holds
``local_cols`` (K5's kernels), "per call" as ``devtrace.roofline_pct``
counts it.  Reads ``k5_roofline.<cell>``.  None where the run has no
slice, or the slice no call or no such record.

The pass's least time (``pass_least_s``) is the larger of its FLOP bound,
5 N log2 n over the batch of transforms of N points along one axis of n
(``pass_flop``), and its bytes bound, each point read and written once
(``work.least_bytes``).  The run's record carries no configuration, so
``value`` takes the call's least time, ``run.least_s``: the pass moves the
call's least bytes, and its FLOP bound lies below the call's, which lies
below the bytes bound at the published peaks for any transform of fewer
than 2^64 points, so the two are equal (the tests hold ``pass_least_s``
to ``work.least_s`` on the benchmark's configurations)."""

import math

from portbench import work


def pass_flop(config: dict, axis: int = -2) -> float:
    """Nominal FLOP of one call's pass along ``axis``: 5 N log2 n times
    the batch, n the axis's length."""
    return (5.0 * work.points(config) * config["batch"]
            * math.log2(config["shape"][axis]))


def pass_least_s(config: dict, axis: int = -2) -> float:
    """The least seconds of one call's pass along ``axis`` at the
    published peaks."""
    return max(pass_flop(config, axis) / work.PEAK_FLOP_S[config["dtype"]],
               work.least_bytes(config) / work.PEAK_BYTES_S)


def value(run):
    sl = run.slice
    if sl is None or not sl.calls:
        return None
    busy = sum(b - a for name, a, b in sl.device if "local_cols" in name)
    if busy <= 0:
        return None
    return 100.0 * run.least_s * len(sl.calls) / busy
