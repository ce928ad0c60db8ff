"""The ``Plan`` facade, the package's public API.

Counterpart of ``pyfft_tpu/plan.py`` (``Plan``), with the same constructor
keywords and call forms:

    plan = Plan((4096,), device="cuda")      # schedule once
    y    = plan.execute(x)                   # complex tensor -> complex
    r, i = plan.execute(re, im)              # planar (split) form
    back = plan.execute(y, inverse=True)     # 1/N folded into the last pass

A CUDA tensor's ``local`` pass runs the Hopper row kernel; a CPU tensor's
runs its plain torch version (``ops/local.py``).  Not in this slice, and
listed in ROADMAP.md: the JAX package's host-view path
(``_view_kernel_ok``), ``run_df64``, its compile cache and its HBM chunk
sweep.  The kernel path allocates only its output.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.planner import AxisPass, ExecPlan, build_plan
from pyfft_tpu_torch.reference import fft_planar

__all__ = ["Plan"]

_TORCH_DTYPE = {np.dtype(np.complex64): torch.complex64,
                np.dtype(np.complex128): torch.complex128,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
_NP_DTYPE = {v: k for k, v in _TORCH_DTYPE.items()}


def np_dtype(dtype) -> np.dtype:
    """A numpy dtype from a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_DTYPE:
            raise ValueError(f"dtype must be complex64 or complex128, "
                             f"got {dtype}")
        return _NP_DTYPE[dtype]
    return np.dtype(dtype)


class Plan:
    """Batched power-of-two complex FFT plan for 1D/2D/3D transforms.

    Parameters (as in the JAX package):
      shape: int or tuple of 1-3 ints, each a power of two.
      dtype: numpy.complex64 (default) or numpy.complex128 (torch dtypes
        are accepted too).
      normalize: inverse transform scales by 1/(x*y*z) (default True).
      scale: extra user scale folded into both directions' output.
      fast_math: True (default) = the plain version runs the calibrated
        chains (``row_factors``); False = the all-butterfly chains of
        ``precise_factors``, which, as in the JAX package, exist only up to
        n = 2048 and silently keep the default chain above it.  The CUDA
        kernel runs butterflies only, so ``fast_math`` changes nothing on
        the kernel path.
      wait_for_finish: default sync behaviour of execute(); if None it is
        inferred: async when a stream/queue was supplied, sync otherwise.
        The sync is ``torch.cuda.synchronize``.
      context/stream/queue: accepted for API familiarity; they only set the
        async default.
      force_xla: schedule every pass on the plain torch chain (the name is
        the JAX package's).
      donate: write the result into the input's memory (in place) where
        the input is already a tensor of the plan's dtype and device.
      device: where the plan runs (default "cuda").  Numpy input is moved
        there; a tensor on another device raises.
    """

    def __init__(self, shape, dtype=np.complex64, *, normalize: bool = True,
                 scale: float = 1.0, fast_math: bool = True,
                 wait_for_finish: bool | None = None,
                 context: Any = None, stream: Any = None, queue: Any = None,
                 force_xla: bool = False, donate: bool = False,
                 device="cuda"):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        self.shape = tuple(int(s) for s in shape)
        self._exec_plan: ExecPlan = build_plan(self.shape, np_dtype(dtype),
                                               kernels=not force_xla)
        self.dtype = self._exec_plan.dtype
        self._complex = _TORCH_DTYPE[self.dtype]
        self._real = (torch.float32 if self.dtype == np.complex64
                      else torch.float64)
        self.normalize = bool(normalize)
        self.scale = float(scale)
        self.fast_math = bool(fast_math)
        if wait_for_finish is None:
            wait_for_finish = stream is None and queue is None
        self.wait_for_finish = bool(wait_for_finish)
        self._force_xla = bool(force_xla)
        self.donate = bool(donate)
        self.device = torch.device(device)

    # ------------------------------------------------------------- executors

    def _run_axis_pass(self, re, im, p: AxisPass, sign: int, ndim: int,
                       postscale: float, out):
        """Dispatch one axis pass to its executor.

        Returns (re, im, scaled): ``scaled`` reports whether the executor
        folded ``postscale`` into its write (free in the row kernel; a
        separate multiply would cost another device-memory round trip).
        """
        axis = re.ndim - ndim + p.axis
        if p.executor == "local":
            factors = (None if self.fast_math
                       else local.precise_factors(p.n))
            rr, ii = local.fft_axis(re, im, sign, axis=axis,
                                    postscale=postscale, factors=factors,
                                    out=out)
            return rr, ii, True
        rr, ii = fft_planar(re, im, sign, axis=axis)
        return rr, ii, False

    def _run(self, re, im, inverse: bool, out):
        """All passes over planar (batch..., *shape) planes.  With ``out``
        the result lands in those planes (the kernel writes there
        directly); without, in new ones."""
        ndim = len(self.shape)
        sign = +1 if inverse else -1
        norm = 1.0
        if inverse and self.normalize:
            norm /= self._exec_plan.total_n
        norm *= self.scale
        scale_left = norm
        passes = self._exec_plan.passes
        for idx, p in enumerate(passes):
            is_final = idx == len(passes) - 1
            post = scale_left if is_final else 1.0
            re, im, scaled = self._run_axis_pass(re, im, p, sign, ndim, post,
                                                 out)
            # Only the final pass is handed the real scale; a non-final
            # pass reporting scaled=True merely folded postscale=1.0, so
            # clearing scale_left there would drop the 1/N normalization
            # (and user scale) on every multi-pass plan.
            if scaled and is_final:
                scale_left = 1.0
        if scale_left != 1.0:
            re, im = re * scale_left, im * scale_left
        if out is None:
            return re, im
        if re is not out[0]:
            out[0].copy_(re)
            out[1].copy_(im)
        return out

    # ------------------------------------------------------------ data prep

    def _canonicalize(self, data, batch, planar: bool):
        """User data -> a contiguous (batch?, *shape) tensor of the plan's
        dtype on the plan's device; returns (tensor, original shape)."""
        want = self._real if planar else self._complex
        if isinstance(data, torch.Tensor):
            dev = data.device
            if dev.type != self.device.type or (
                    self.device.index is not None
                    and dev.index != self.device.index):
                raise ValueError(f"input is on {dev} but the plan runs on "
                                 f"{self.device}; move it first")
            x = data
        else:
            x = torch.as_tensor(np.ascontiguousarray(data),
                                device=self.device)
        if x.dtype != want:
            x = x.to(want)
        orig_shape = tuple(x.shape)
        ndim = len(self.shape)
        if not (x.ndim >= ndim and orig_shape[-ndim:] == self.shape):
            # flat buffer + batch, reference-style: execute(buf, batch=k)
            b = int(batch) if batch else 1
            if x.numel() != b * math.prod(self.shape):
                raise ValueError(
                    f"data of shape {orig_shape} does not match transform "
                    f"shape {self.shape} with batch={b}")
            x = x.reshape((b,) + self.shape if b > 1 else self.shape)
        return x.contiguous(), orig_shape

    # -------------------------------------------------------------- execute

    def execute(self, data, data_imag=None, *, inverse: bool = False,
                batch: int | None = None, wait_for_finish: bool | None = None):
        """Run the transform.

        Complex form: ``execute(x)`` with complex ``x`` -> complex tensor;
        the kernel reads and writes the two strided planes of
        ``torch.view_as_real``, with no de-interleave copies.
        Split form: ``execute(re, im)`` -> ``(re, im)`` (dispatch by arity).
        ``batch=k`` accepts a flat buffer holding k contiguous transforms.
        """
        if data_imag is not None:
            re, re_shape = self._canonicalize(data, batch, planar=True)
            im, _ = self._canonicalize(data_imag, batch, planar=True)
            if re.shape != im.shape:
                raise ValueError("real/imag planes must have the same shape")
            rr, ii = self._run(re, im, inverse,
                               (re, im) if self.donate else None)
            out = (rr.reshape(re_shape), ii.reshape(re_shape))
        else:
            x, x_shape = self._canonicalize(data, batch, planar=False)
            y = x if self.donate else torch.empty_like(x)
            xv, yv = torch.view_as_real(x), torch.view_as_real(y)
            self._run(xv[..., 0], xv[..., 1], inverse,
                      (yv[..., 0], yv[..., 1]))
            out = y.reshape(x_shape)
        wait = (self.wait_for_finish if wait_for_finish is None
                else wait_for_finish)
        if wait and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    # ------------------------------------------------------------- niceties

    def __repr__(self):
        kinds = ",".join(p.executor for p in self._exec_plan.passes)
        return (f"Plan(shape={self.shape}, dtype={self.dtype.name}, "
                f"device={self.device}, passes=[{kinds}])")
