"""Pass scheduler: shape/dtype -> executable pass IR.

Counterpart of ``pyfft_tpu/planner.py`` (``AxisPass``, ``ExecPlan``,
``build_plan``, with the same validation errors).  For complex64:

* ``fused2d``: the last two axes together, when both are multiples of
  MIN_TRAIL and a plane holds at most MAX_FUSED2D_ELEMS points
  (``ops/fused2d.py``), as the JAX planner does;
* ``local``: the axis fits one thread block's shared memory; the row
  kernel on the last axis, the column kernel on another axis with a trail
  of at least MIN_TRAIL (``ops/local.py``);
* ``fourstep``: an axis above MAX_LOCAL_N, as two column passes
  (``ops/fourstep.py``: ``fft_axis_large`` on the last axis,
  ``fft_axis_mid`` on another);
* ``huge``: a last axis above MAX_LOCAL_N**2, as three column passes
  (``fft_axis_huge``);
* ``plain``: everything else, through the plain torch matmul chain
  (``reference.py``): n < MIN_LOCAL_N, a column pass with a short trail, a
  mid axis the four-step gates refuse.

For complex128 the routes of the JAX package's double-float kernels
(``ops/fp64.py``; the kernels compute in native FP64): ``local`` up to
MAX_LOCAL_N_DF64 under the same trail rule, ``fourstep`` on the last axis
up to MAX_LOCAL_N_DF64**2 with ``choose_split_df64``'s split (``plain``
where a factor falls below MIN_TRAIL), ``huge`` beyond it with
``choose_split3(n, HUGE_MAX_F_DF64)``, ``plain`` on any other axis; no
``fused2d`` and no mid-axis four-step, as in the JAX package.

The JAX planner writes ``local`` for a short axis or trail and lets its
Plan take XLA at run time; this one decides when it plans, so
``repr(plan)`` shows the route and no CUDA tensor meets a kernel that
cannot take it.  Kernel executors are scheduled whatever the device: the
device decides only inside ``ops.local.fft_axis`` (CUDA tensor -> the
kernel, CPU tensor -> its plain torch version), so the CPU tests walk the
same route as the card.

Everything in this module is pure and cheap; it runs once per Plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np

from pyfft_tpu_torch.utils.radix import is_power_of_two

__all__ = ["AxisPass", "ExecPlan", "build_plan", "SMEM_BYTES_PER_BLOCK",
           "MAX_LOCAL_N", "MIN_LOCAL_N", "MIN_TRAIL", "MAX_FUSED2D_ELEMS",
           "MAX_LOCAL_N_DF64", "HUGE_MAX_F_DF64", "max_local_n"]

# Shared memory one thread block can use on Hopper (227 KB of the SM's
# 256 KB; above 48 KB only as opt-in dynamic shared memory).  It replaces
# the JAX package's VMEM budget as the local kernel's capacity bound.
SMEM_BYTES_PER_BLOCK = 232448

# Largest axis the local row kernel takes: one complex64 row (8n bytes)
# must fit one block's shared memory.  Kept at the JAX package's value so
# that both packages build plans with the same pass structure; a
# 16384-point row (128 KB) would also fit, and raising the cap is a later,
# measured decision.
MAX_LOCAL_N = 8192
assert 8 * MAX_LOCAL_N <= SMEM_BYTES_PER_BLOCK

MIN_LOCAL_N = 8

# The complex128 kernels' ceilings: the JAX package's MAX_LOCAL_N_DF64
# (largest axis of its double-float row and column kernels) and
# HUGE_MAX_F_DF64 (largest factor of its double-float six-step), both
# Mosaic compile ceilings measured on a TPU v5e.  Kept so that both
# planners build the same complex128 plans (ROADMAP lists them as constants
# to re-derive): a complex128 row of 4096 points is 64 KB of shared memory,
# and 8192 points (128 KB) would also fit.  ``ops/fp64.py`` re-exports
# them beside the JAX names.
MAX_LOCAL_N_DF64 = 4096
HUGE_MAX_F_DF64 = 2048
assert 16 * MAX_LOCAL_N_DF64 <= SMEM_BYTES_PER_BLOCK

# Smallest trail (product of the later axes) a column pass takes, and the
# granule of the four-step splits, swap periods and twiddle periods: the
# JAX package's 128-lane tile.  The column kernel takes any trail; the
# rule is kept so that both planners build the same plans, and the kernel
# relies on the granule (its block's run of columns divides 128).
MIN_TRAIL = 128

# Largest plane (ny * nx points) the fused 2D kernel takes: the JAX
# package's MAX_FUSED2D_ELEMS (a TPU compile limit), kept so that both
# planners build the same plans.  The Hopper kernel walks a plane in chunks
# and has no size limit of its own (ROADMAP lists it as a constant to
# re-derive).
MAX_FUSED2D_ELEMS = 1 << 18


def max_local_n(dtype) -> int:
    """The largest axis the local kernels take for a plane or complex
    dtype (numpy or torch): MAX_LOCAL_N for 32-bit parts, MAX_LOCAL_N_DF64
    for 64-bit ones."""
    name = str(dtype).rsplit(".", 1)[-1]
    return MAX_LOCAL_N_DF64 if name in ("float64", "complex128") else MAX_LOCAL_N


# "plain" is the JAX package's "xla" executor: the einsum chain of
# reference.py.
Executor = Literal["plain", "local", "fused2d", "fourstep", "huge"]


@dataclasses.dataclass(frozen=True)
class AxisPass:
    """One scheduled pass over one transform axis.

    ``split`` is the decomposition its executor runs: (n1, n2) for
    ``fourstep``, (n1, m1, m2) for ``huge``, (ny, nx) for ``fused2d``,
    whose pass covers the last two axes (``axis`` is the first of them).
    """

    axis: int                 # axis index within the *transform* shape
    n: int                    # transform length along this axis
    executor: Executor
    split: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    shape: tuple[int, ...]          # transform shape, e.g. (1024, 1024)
    dtype: np.dtype                 # complex dtype of the user data
    passes: tuple[AxisPass, ...]    # one per axis, innermost (last) axis first

    @property
    def total_n(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def build_plan(shape: tuple[int, ...], dtype, *,
               kernels: bool = True) -> ExecPlan:
    """Schedule one pass per transform axis, innermost (contiguous) first.

    ``kernels=False`` schedules every pass as ``plain`` (the Plan's
    ``force_xla``).
    """
    shape = tuple(int(s) for s in shape)
    if not (1 <= len(shape) <= 3):
        raise ValueError(f"FFT rank must be 1..3, got shape {shape}")
    for s in shape:
        if not is_power_of_two(s):
            raise ValueError(f"transform size {s} is not a power of two")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.complex64), np.dtype(np.complex128)):
        raise ValueError(f"dtype must be complex64 or complex128, got {dtype}")

    passes = []
    ndim = len(shape)
    double = dtype == np.dtype(np.complex128)
    max_local = max_local_n(dtype)
    axes = list(reversed(range(ndim)))
    if kernels and not double and ndim >= 2:
        ny, nx = shape[-2], shape[-1]
        if (ny % MIN_TRAIL == 0 and nx % MIN_TRAIL == 0
                and ny * nx <= MAX_FUSED2D_ELEMS):
            passes.append(AxisPass(axis=ndim - 2, n=ny * nx,
                                   executor="fused2d", split=(ny, nx)))
            axes = axes[2:]
    for axis in axes:
        n = shape[axis]
        last = axis == ndim - 1
        trail = math.prod(shape[axis + 1:])
        executor, split = "plain", None
        if not kernels:
            pass
        elif n <= max_local:
            if n >= MIN_LOCAL_N and (last or trail >= MIN_TRAIL):
                executor = "local"
        elif double:
            executor, split = _large_axis_df64(n, last)
        else:
            executor, split = _large_axis(n, last, trail)
        passes.append(AxisPass(axis=axis, n=n, executor=executor,
                               split=split))
    return ExecPlan(shape=shape, dtype=dtype, passes=tuple(passes))


def _large_axis(n: int, last: bool, trail: int):
    """(executor, split) of an axis above MAX_LOCAL_N, under the JAX
    planner's gates: on the last axis the six-step ``huge`` beyond
    MAX_LOCAL_N**2, else the four-step ``fft_axis_large``; on another axis
    the four-step ``fft_axis_mid`` where ``fourstep.mid_split`` allows it;
    ``plain`` where no decomposition applies."""
    from pyfft_tpu_torch.ops import fourstep
    if not last:
        split = fourstep.mid_split(n, trail)
        return ("fourstep", split) if split else ("plain", None)
    try:
        if n > MAX_LOCAL_N * MAX_LOCAL_N:
            return "huge", fourstep.choose_split3(n)
        return "fourstep", fourstep.choose_split(n)
    except ValueError:
        return "plain", None


def _large_axis_df64(n: int, last: bool):
    """(executor, split) of a complex128 axis above MAX_LOCAL_N_DF64, under
    the JAX planner's double-float gates: ``huge`` beyond
    MAX_LOCAL_N_DF64**2, else ``fourstep`` with ``choose_split_df64``'s
    split where both factors are at least MIN_TRAIL; ``plain`` otherwise
    and on every axis but the last."""
    from pyfft_tpu_torch.ops import fourstep, fp64
    if not last:
        return "plain", None
    if n > MAX_LOCAL_N_DF64 * MAX_LOCAL_N_DF64:
        try:
            return "huge", fourstep.choose_split3(n, HUGE_MAX_F_DF64)
        except ValueError:
            return "plain", None
    split = fp64.choose_split_df64(n, MAX_LOCAL_N_DF64)
    if min(split) < MIN_TRAIL:
        return "plain", None
    return "fourstep", split
