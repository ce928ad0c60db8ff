"""The complex128 path: native-FP64 row and column kernels.

Counterpart of ``pyfft_tpu/ops/pallas_df64.py``.  The JAX package has no
FP64 unit on its TPU, so it computes complex128 in double-float arithmetic:
each float64 plane a (hi, lo) pair of float32 planes, each complex value a
planar quad, with its own Pallas row and column kernels (``_row_kernel_df64``
and ``_col_kernel_df64``).  An H100 computes FP64 natively, so this package
keeps complex128 data as two float64 planes and runs the same kernels as
complex64, instantiated on ``double``: the row kernel K11 in
``csrc/local_rows.cu`` and the column kernel K12 in ``csrc/local_cols.cu``,
with every twiddle mode and store of the float32 column kernel.  Their
plain torch versions (``local.fft_rows_plain`` and ``local.fft_cols_plain``
on float64 planes) take ``reference.fft_planar`` in float64 as the DFT step.

This module holds what is particular to complex128: the JAX package's
ceilings (re-exported from the planner, which plans by them), its balanced
four-step split ``choose_split_df64``, its gates ``supported`` and
``supported_huge``, and its entry points ``fft_axis_df64``,
``fft_axis_large_df64`` and ``fft_axis_huge_df64``, thin wrappers over the
dtype-generic ``local.fft_axis`` and ``fourstep`` executors.  Not carried
over: the (hi, lo) quads and ``ops/df64.py``, the int8-split matrix-unit
tail, and the three-pass four-step form
(``SWAP_MAX_DF64``): the column kernel's swapped store fits shared memory at
every n <= MAX_LOCAL_N_DF64, so every split runs the two-pass form.
"""

from __future__ import annotations

import math

import torch

from pyfft_tpu_torch.ops import fourstep, local
from pyfft_tpu_torch.planner import (HUGE_MAX_F_DF64, MAX_LOCAL_N_DF64,
                                     MIN_LOCAL_N, MIN_TRAIL)
from pyfft_tpu_torch.utils import tune
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["MAX_LOCAL_N_DF64", "HUGE_MAX_F_DF64", "choose_split_df64",
           "supported", "supported_huge", "fft_axis_df64",
           "fft_axis_large_df64", "fft_axis_huge_df64"]


def choose_split_df64(n: int, max_local: int = MAX_LOCAL_N_DF64
                      ) -> tuple[int, int]:
    """pallas_df64._choose_split_df64: the autotune record's
    ``dsplit:{n}`` (``utils/tune``) where both its factors lie in
    [MIN_TRAIL, max_local], else the balanced (n1, n2), n1 the larger
    factor for odd log2 n, whose factors the callers check."""
    t = tune.tuned_split("dsplit", n, 2, max_local)
    if t is not None:
        return t
    p = ilog2(n)
    p1 = (p + 1) // 2
    return 1 << p1, 1 << (p - p1)


def supported(re: torch.Tensor, axis: int,
              max_local: int | None = None) -> bool:
    """Whether the complex128 kernels cover this float64 plane and axis
    (pallas_df64.supported): a local pass for n in [MIN_LOCAL_N,
    max_local] on the last axis or with a trail of at least MIN_TRAIL, a
    four-step on the last axis up to max_local**2 where both factors of the
    split lie in [MIN_TRAIL, max_local], the six-step beyond."""
    if re.dtype != torch.float64 or re.ndim == 0:
        return False
    axis = axis % re.ndim
    n = re.shape[axis]
    max_local = max_local or MAX_LOCAL_N_DF64
    last = axis == re.ndim - 1
    if not is_power_of_two(n):
        return False
    if MIN_LOCAL_N <= n <= max_local:
        return last or math.prod(re.shape[axis + 1:]) >= MIN_TRAIL
    if last and max_local < n <= max_local * max_local:
        return all(MIN_TRAIL <= f <= max_local
                   for f in choose_split_df64(n, max_local))
    if last and n > max_local * max_local:
        return supported_huge(re, axis)
    return False


def supported_huge(re: torch.Tensor, axis: int,
                   max_f: int | None = None) -> bool:
    """Whether the six-step covers this float64 plane and axis
    (pallas_df64.supported_huge): the last axis, beyond
    MAX_LOCAL_N_DF64**2, with a ``choose_split3`` of factors up to
    ``max_f`` (HUGE_MAX_F_DF64)."""
    if re.dtype != torch.float64 or re.ndim == 0:
        return False
    if axis % re.ndim != re.ndim - 1:
        return False
    n = re.shape[-1]
    if not (is_power_of_two(n)
            and n > MAX_LOCAL_N_DF64 * MAX_LOCAL_N_DF64):
        return False
    try:
        fourstep.choose_split3(n, max_f or HUGE_MAX_F_DF64)
    except ValueError:
        return False
    return True


def _float64(re, im) -> None:
    if re.dtype != torch.float64 or im.dtype != torch.float64:
        raise ValueError(f"the complex128 path takes float64 planes, got "
                         f"{re.dtype} and {im.dtype}")


def fft_axis_df64(re, im, sign, *, axis, postscale: float = 1.0, **kw):
    """DFT along ``axis`` of float64 planes (pallas_df64.fft_axis_df64):
    K11 on the last axis, K12 on another, with ``local.fft_axis``'s column
    modes and ``out=``."""
    _float64(re, im)
    return local.fft_axis(re, im, sign, axis=axis, postscale=postscale, **kw)


def fft_axis_large_df64(re, im, sign, *, axis, postscale: float = 1.0,
                        max_local: int | None = None,
                        split: tuple[int, int] | None = None, out=None):
    """Four-step DFT over the last axis of float64 planes
    (pallas_df64.fft_axis_large_df64): two K12 passes on
    ``choose_split_df64``'s split (or ``split``), always the two-pass
    form."""
    _float64(re, im)
    n = re.shape[axis]
    split = split or choose_split_df64(n, max_local or MAX_LOCAL_N_DF64)
    return fourstep.fft_axis_large(re, im, sign, axis=axis,
                                   postscale=postscale, split=split, out=out)


def fft_axis_huge_df64(re, im, sign, *, axis, postscale: float = 1.0,
                       max_f: int | None = None, out=None):
    """Six-step DFT over the last axis of float64 planes
    (pallas_df64.fft_axis_huge_df64): three K12 passes on
    ``choose_split3(n, max_f or HUGE_MAX_F_DF64)``."""
    _float64(re, im)
    split3 = fourstep.choose_split3(re.shape[axis], max_f or HUGE_MAX_F_DF64)
    return fourstep.fft_axis_huge(re, im, sign, axis=axis,
                                  postscale=postscale, split3=split3, out=out)
