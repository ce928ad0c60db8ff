"""Pass scheduler: shape/dtype -> executable pass IR.

Counterpart of ``pyfft_tpu/planner.py`` (``AxisPass``, ``ExecPlan``,
``build_plan``, with the same validation errors).  An axis either fits
the single-pass row kernel (``local``: the whole row lives in one thread
block's shared memory, ``ops/local.py``) or runs through the plain torch
matmul chain (``plain``, ``reference.py``).

``local`` is scheduled whatever the device: the device decides only inside
``ops.local.fft_axis`` (CUDA tensor -> the kernel, CPU tensor -> its plain
torch version), so the CPU tests walk the same route as the card.

Everything in this module is pure and cheap; it runs once per Plan.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from pyfft_tpu_torch.utils.radix import is_power_of_two

__all__ = ["AxisPass", "ExecPlan", "build_plan", "SMEM_BYTES_PER_BLOCK",
           "MAX_LOCAL_N"]

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

# "plain" is the JAX package's "xla" executor: the einsum chain of
# reference.py.
Executor = Literal["plain", "local"]


@dataclasses.dataclass(frozen=True)
class AxisPass:
    """One scheduled pass over one transform axis."""

    axis: int                 # axis index within the *transform* shape
    n: int                    # transform length along this axis
    executor: Executor


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
    # The JAX planner's "fused2d" branch (both last axes in one kernel) is
    # ROADMAP Slice D; until it lands, those axes take one pass each below.
    for axis in reversed(range(ndim)):
        n = shape[axis]
        if (kernels and dtype == np.dtype(np.complex64) and axis == ndim - 1
                and MIN_LOCAL_N <= n <= MAX_LOCAL_N):
            passes.append(AxisPass(axis=axis, n=n, executor="local"))
        else:
            # Everything else is "plain" in this slice:
            # - a non-last axis: the column kernels, ROADMAP Slice D;
            # - n > MAX_LOCAL_N: the JAX "fourstep" and "huge" executors,
            #   ROADMAP Slice C;
            # - complex128: the FP64 kernels, ROADMAP Slice E.
            passes.append(AxisPass(axis=axis, n=n, executor="plain"))
    return ExecPlan(shape=shape, dtype=dtype, passes=tuple(passes))
