"""Four-step and six-step FFTs for axes beyond one column tile.

Counterpart of ``pyfft_tpu/ops/fourstep.py``: a length-N axis above
MAX_LOCAL_N is viewed as (..., N1, N2), N = N1*N2, and transformed by
column passes of the local column kernel (``local.fft_axis`` with an axis
other than the last), each one device-memory round trip, with the
inter-pass twiddle fused into the pass and the digit transpose absorbed
into its store:

* ``fft_axis_large`` (last axis, N <= MAX_LOCAL_N**2): N1-point columns
  with the ``full`` twiddle w_N^(k1*j2) and a swapped store, then N2-point
  columns with the postscale: two passes;
* ``fft_axis_mid`` (another axis): the same with the ``strided`` twiddle
  and a mid swap, which leave the trailing axes in place: two passes;
* ``fft_axis_huge`` (last axis, N > MAX_LOCAL_N**2): N = n1*m1*m2 with
  the ``factored`` twiddle, then a ``strided`` one: three passes.

The executors take float32 planes (complex64: the column kernel K5) or
float64 planes (complex128: its FP64 instantiation K12, whose axes stop at
MAX_LOCAL_N_DF64; ``ops/fp64.py`` holds the complex128 entry points and
split).  The mid axis stays complex64-only, as in the JAX package.  On a
CUDA tensor every pass launches the column kernel; on a CPU tensor its
plain torch version.  Only the last pass writes ``out``; the earlier ones
write temporaries, since a swapped store cannot run in place.

An autotune record for this card (``split:{n}``, ``split3:{n}``:
``utils/tune``) decides a split where it holds one that meets the
caller's constraints, as in the JAX package.  Not carried over: the TPU
v5e cost model of the splits (``_COL_UNIT_COST``).  Without a record
``choose_split`` takes the balanced split and ``choose_split3`` the most
balanced one, under the JAX package's constraints.  For 2^22 that is
(2048, 2048), the JAX package's own choice.
"""

from __future__ import annotations

import math

import torch

from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.planner import MAX_LOCAL_N, MIN_TRAIL, max_local_n
from pyfft_tpu_torch.utils import tune
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["fft_axis_large", "fft_axis_huge", "fft_axis_mid",
           "choose_split", "choose_split3", "supported", "supported_huge",
           "supported_mid", "mid_split", "MAX_MID_TW_BYTES"]

# The JAX package's cap on the mid axis's level twiddle (two f32 planes of
# n elements), a TPU VMEM budget.  The column kernel reads that table from
# device memory and needs no cap; it is kept so that both planners build
# the same plans (ROADMAP lists it as a constant to re-derive).
MAX_MID_TW_BYTES = 16 * 1024 * 1024


def choose_split(n: int, max_local: int | None = None) -> tuple[int, int]:
    """(n1, n2) with n1*n2 = n, both in [MIN_TRAIL, max_local]: the
    autotune record's ``split:{n}`` where it meets those constraints, else
    as equal as they can be (n1 the smaller for odd log2 n).  Raises
    ValueError where no such split exists."""
    max_local = max_local or MAX_LOCAL_N
    t = tune.tuned_split("split", n, 2, max_local)
    if t is not None:
        return t
    p = ilog2(n)
    best = None
    for p1 in range(1, p):
        n1, n2 = 1 << p1, 1 << (p - p1)
        if not (MIN_TRAIL <= n1 <= max_local and MIN_TRAIL <= n2 <= max_local):
            continue
        key = abs(2 * p1 - p)
        if best is None or key < best[0]:
            best = (key, (n1, n2))
    if best is None:
        raise ValueError(
            f"n={n} exceeds the single-level four-step range "
            f"(max {max_local}^2={max_local * max_local})")
    return best[1]


def choose_split3(n: int, max_local: int | None = None
                  ) -> tuple[int, int, int]:
    """(n1, m1, m2) for the two-level decomposition n = n1*m1*m2: every
    factor in [MIN_TRAIL, max_local] (fourstep.choose_split3's
    constraints); the autotune record's ``split3:{n}`` where it meets
    them, else the spread of the three exponents as small as it can be.
    Raises ValueError where none exists."""
    max_local = max_local or MAX_LOCAL_N
    t = tune.tuned_split("split3", n, 3, max_local)
    if t is not None:
        return t
    p = ilog2(n)
    lo = ilog2(MIN_TRAIL)
    best = None
    for p1 in range(lo, p):
        if (1 << p1) > max_local:
            break
        for q1 in range(lo, p - p1):
            q2 = p - p1 - q1
            if (1 << q1) > max_local or (1 << q2) > max_local or q2 < lo:
                continue
            key = (max(p1, q1, q2) - min(p1, q1, q2), abs(q1 - q2),
                   abs(2 * p1 - p))
            if best is None or key < best[0]:
                best = (key, (1 << p1, 1 << q1, 1 << q2))
    if best is None:
        raise ValueError(f"n={n} has no two-level decomposition "
                         f"(max_local={max_local})")
    return best[1]


def _last_axis_ok(re: torch.Tensor, axis: int) -> bool:
    return (re.dtype in (torch.float32, torch.float64)
            and axis % re.ndim == re.ndim - 1)


def supported(re: torch.Tensor, axis: int,
              max_local: int | None = None) -> bool:
    """Whether ``fft_axis_large`` covers this tensor/axis (``max_local``
    by default the local kernels' ceiling for the planes' dtype)."""
    if not _last_axis_ok(re, axis):
        return False
    max_local = max_local or max_local_n(re.dtype)
    n = re.shape[-1]
    if not (is_power_of_two(n) and max_local < n <= max_local * max_local):
        return False
    try:
        choose_split(n, max_local)
    except ValueError:
        return False
    return True


def supported_huge(re: torch.Tensor, axis: int,
                   max_local: int | None = None) -> bool:
    """Whether ``fft_axis_huge`` covers this tensor/axis (``max_local`` as
    in ``supported``)."""
    if not _last_axis_ok(re, axis):
        return False
    max_local = max_local or max_local_n(re.dtype)
    n = re.shape[-1]
    if not (is_power_of_two(n) and n > max_local * max_local):
        return False
    try:
        choose_split3(n, max_local)
    except ValueError:
        return False
    return True


def mid_split(n: int, trail: int,
              max_local: int | None = None) -> tuple[int, int] | None:
    """The split ``fft_axis_mid`` takes for an axis of length n with the
    given trail (the product of the later axes), or None where it does not
    cover the axis: n in (max_local, max_local**2], a trail that is a whole
    number of MIN_TRAIL runs and a level twiddle within MAX_MID_TW_BYTES.
    The planner and ``supported_mid`` both decide by it."""
    max_local = max_local or MAX_LOCAL_N
    if not (is_power_of_two(n) and max_local < n <= max_local * max_local):
        return None
    if trail % MIN_TRAIL or n * 8 > MAX_MID_TW_BYTES:
        return None
    try:
        return choose_split(n, max_local)
    except ValueError:
        return None


def supported_mid(re: torch.Tensor, axis: int,
                  max_local: int | None = None) -> bool:
    """Whether ``fft_axis_mid`` covers this tensor/axis (``mid_split``;
    float32 only, as in the JAX package)."""
    if re.dtype != torch.float32:
        return False
    axis = axis % re.ndim
    if axis == re.ndim - 1:
        return False
    return mid_split(re.shape[axis], math.prod(re.shape[axis + 1:]),
                     max_local) is not None


def _factors(fast_math: bool, *ns):
    """The plain version's chains: the default ones, or the all-butterfly
    ones for fast_math=False (the kernel ignores both)."""
    if fast_math:
        return (None,) * len(ns)
    return tuple(local.precise_factors(m) for m in ns)


def _out_view(out, shape):
    """The last pass's output: views of ``out``'s planes, or None."""
    if out is None:
        return None
    return tuple(local._view(t, shape, "out") for t in out)


def _finish(r, i, shape, out):
    if out is not None:
        return out
    return r.reshape(shape), i.reshape(shape)


def fft_axis_large(re, im, sign, *, axis, postscale: float = 1.0,
                   max_local: int | None = None, fast_math: bool = True,
                   split: tuple[int, int] | None = None, out=None):
    """Four-step DFT along the last axis of planar float32 or float64
    tensors.

    With the axis viewed as (n1, n2):

      1. n1-point columns with the twiddle w_n^(k1*j2), stored swapped
         -> (..., j2, k1);
      2. n2-point columns, postscale folded -> (..., k2, k1), the
         flattened DFT order.

    ``split`` forces the decomposition; ``out=(re, im)`` names the planes
    the last pass writes (they may be the inputs).
    """
    axis = axis % re.ndim
    if axis != re.ndim - 1:
        raise ValueError("fft_axis_large covers the last axis")
    shape = tuple(re.shape)
    n = shape[-1]
    n1, n2 = split or choose_split(n, max_local or max_local_n(re.dtype))
    if n1 * n2 != n:
        raise ValueError(f"split {n1}x{n2} does not factor n={n}")
    lead = shape[:-1]
    f1, f2 = _factors(fast_math, n1, n2)
    r, i = local.fft_axis(re.reshape(*lead, n1, n2),
                          im.reshape(*lead, n1, n2), sign, axis=-2,
                          tw_n=n, swap_store=True, factors=f1)
    r, i = local.fft_axis(r, i, sign, axis=-2, factors=f2,
                          postscale=postscale,
                          out=_out_view(out, (*lead, n2, n1)))
    return _finish(r, i, shape, out)


def fft_axis_mid(re, im, sign, *, axis, postscale: float = 1.0,
                 max_local: int | None = None, fast_math: bool = True,
                 split: tuple[int, int] | None = None, out=None):
    """Four-step DFT over an axis other than the last.

    With the data viewed as (..., n1, n2, T), T the trailing extent:

      1. n1-point columns with the twiddle w_n^(k1*j2), constant across
         each run of T (``strided``), stored with the mid swap of period T
         -> (..., j2, k1, T);
      2. n2-point columns over trail n1*T, postscale folded
         -> (..., k2, k1, T), the DFT order along the merged axis.
    """
    axis = axis % re.ndim
    if axis == re.ndim - 1:
        raise ValueError("fft_axis_mid covers an axis other than the last; "
                         "use fft_axis_large")
    shape = tuple(re.shape)
    n = shape[axis]
    T = math.prod(shape[axis + 1:])
    n1, n2 = split or choose_split(n, max_local)
    if n1 * n2 != n:
        raise ValueError(f"split {n1}x{n2} does not factor n={n}")
    lead = shape[:axis]
    f1, f2 = _factors(fast_math, n1, n2)
    r, i = local.fft_axis(re.reshape(*lead, n1, n2 * T),
                          im.reshape(*lead, n1, n2 * T), sign, axis=-2,
                          tw_n=n, tw_mode="strided", tw_period=T,
                          swap_mid=T, factors=f1)
    # (*lead, n2, n1, T): digits (j2, k1)
    r, i = local.fft_axis(r.reshape(*lead, n2, n1 * T),
                          i.reshape(*lead, n2, n1 * T), sign, axis=-2,
                          postscale=postscale, factors=f2,
                          out=_out_view(out, (*lead, n2, n1 * T)))
    return _finish(r, i, shape, out)


def fft_axis_huge(re, im, sign, *, axis, postscale: float = 1.0,
                  max_local: int | None = None, fast_math: bool = True,
                  split3: tuple[int, int, int] | None = None, out=None):
    """Two-level (six-step) DFT along the last axis, n = n1*m1*m2.

    With the axis viewed as (n1, m1*m2):

      1. n1-point columns with the twiddle w_n^(k1*j2), ``factored`` into
         a (m1*m2/128, n1) and a (128, n1) table, stored swapped
         -> (..., m1, m2, k1);
      2. m1-point columns over trail m2*n1 with the twiddle
         w_{m1*m2}^(q1*i2) (``strided``, period n1), mid swap of period n1
         -> (..., m2, q1, k1);
      3. m2-point columns over trail m1*n1, postscale folded
         -> (..., q2, q1, k1), the flattened DFT order.
    """
    axis = axis % re.ndim
    if axis != re.ndim - 1:
        raise ValueError("fft_axis_huge covers the last axis")
    shape = tuple(re.shape)
    n = shape[-1]
    n1, m1, m2 = split3 or choose_split3(n, max_local
                                         or max_local_n(re.dtype))
    if n1 * m1 * m2 != n:
        raise ValueError(f"split3 {n1}x{m1}x{m2} does not factor n={n}")
    n2 = m1 * m2
    lead = shape[:-1]
    f1, f2, f3 = _factors(fast_math, n1, m1, m2)
    r, i = local.fft_axis(re.reshape(*lead, n1, n2),
                          im.reshape(*lead, n1, n2), sign, axis=-2,
                          tw_n=n, tw_mode="factored", swap_store=True,
                          factors=f1)
    r, i = local.fft_axis(r.reshape(*lead, m1, m2 * n1),
                          i.reshape(*lead, m1, m2 * n1), sign, axis=-2,
                          tw_n=n2, tw_mode="strided", tw_period=n1,
                          swap_mid=n1, factors=f2)
    r, i = local.fft_axis(r.reshape(*lead, m2, m1 * n1),
                          i.reshape(*lead, m2, m1 * n1), sign, axis=-2,
                          postscale=postscale, factors=f3,
                          out=_out_view(out, (*lead, m2, m1 * n1)))
    return _finish(r, i, shape, out)
