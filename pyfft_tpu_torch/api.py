"""Functional convenience API over cached Plans.

Counterpart of ``pyfft_tpu/api.py``: ``fft``/``ifft``/``fft2``/``ifft2``/
``fftn``/``ifftn`` over a plan cache, plus the numpy-style shifts and
frequency helpers.  A tensor runs on its own device; numpy input runs on
the ``device=`` keyword's device (default "cuda").
"""

from __future__ import annotations

import numpy as np
import torch

from pyfft_tpu_torch.plan import Plan, np_dtype

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "get_plan",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]

_PLAN_CACHE: dict = {}


def get_plan(shape, dtype=np.complex64, **kwargs) -> Plan:
    """Memoized ``Plan``, keyed on shape, dtype, device and keywords.

    Unbounded by design, as in the JAX package: FFT workloads reuse a small
    set of shapes.  Clear ``pyfft_tpu_torch.api._PLAN_CACHE`` or build
    ``Plan`` directly to manage lifetimes.
    """
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    kwargs["device"] = torch.device(kwargs.get("device", "cuda"))
    key = (tuple(shape), np_dtype(dtype).name,
           tuple(sorted((k, str(v)) for k, v in kwargs.items())))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _PLAN_CACHE[key] = Plan(tuple(shape), dtype, **kwargs)
    return plan


def _movedim(x, src, dst):
    if isinstance(x, np.ndarray):
        return np.moveaxis(x, src, dst)
    return torch.movedim(x, src, dst)


def _transform(x, ndim, inverse, axes=None, **kwargs):
    if not isinstance(x, torch.Tensor):
        x = np.asanyarray(x)
    moved = None
    if axes is not None:
        axes = (axes,) if isinstance(axes, int) else tuple(axes)
        for a in axes:
            if not -x.ndim <= a < x.ndim:
                raise ValueError(
                    f"axis {a} is out of bounds for array of dimension "
                    f"{x.ndim}")
        axes = tuple(a % x.ndim for a in axes)
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axes {axes}")
        if ndim is not None and len(axes) != ndim:
            raise ValueError(f"axes should be of length {ndim}, "
                             f"got {axes}")
        ndim = len(axes)
        if not 1 <= ndim <= 3:
            raise ValueError(f"FFT rank must be 1..3, got axes {axes}")
        trailing = tuple(range(x.ndim - ndim, x.ndim))
        if axes != trailing:
            x = _movedim(x, axes, trailing)
            moved = (trailing, axes)
    shape = tuple(x.shape[-ndim:])
    xdt = np_dtype(x.dtype)
    if xdt.kind == "c":
        dtype = xdt
    elif xdt == np.float64:
        # real f64 input keeps full precision through a complex128 plan
        dtype = np.complex128
    else:
        dtype = np.complex64
    if isinstance(x, torch.Tensor):
        kwargs.setdefault("device", x.device)
    plan = get_plan(shape, dtype, **kwargs)
    out = plan.execute(x, inverse=inverse)
    if moved is not None:
        trailing, axes = moved
        out = _movedim(out, trailing, axes)
    return out


def fft(x, axis: int = -1, **kw):
    """1D FFT over ``axis`` (power-of-two length; default last)."""
    return _transform(x, 1, False, axes=(axis,), **kw)


def ifft(x, axis: int = -1, **kw):
    return _transform(x, 1, True, axes=(axis,), **kw)


def fft2(x, axes=(-2, -1), **kw):
    """2D FFT over ``axes`` (default last two)."""
    return _transform(x, 2, False, axes=axes, **kw)


def ifft2(x, axes=(-2, -1), **kw):
    return _transform(x, 2, True, axes=axes, **kw)


def fftn(x, ndim=None, axes=None, **kw):
    """N-D FFT over ``axes`` (or the last ``ndim`` axes; default all, up
    to 3)."""
    if axes is None:
        nd = ndim if ndim is not None else min(x.ndim, 3)
        return _transform(x, nd, False, **kw)
    return _transform(x, ndim, False, axes=axes, **kw)


def ifftn(x, ndim=None, axes=None, **kw):
    if axes is None:
        nd = ndim if ndim is not None else min(x.ndim, 3)
        return _transform(x, nd, True, **kw)
    return _transform(x, ndim, True, axes=axes, **kw)


def fftshift(x, axes=None):
    """Shift the zero-frequency component to the center (numpy-compatible;
    a tensor stays on its device)."""
    if isinstance(x, torch.Tensor):
        return torch.fft.fftshift(x, dim=axes)
    return np.fft.fftshift(x, axes=axes)


def ifftshift(x, axes=None):
    if isinstance(x, torch.Tensor):
        return torch.fft.ifftshift(x, dim=axes)
    return np.fft.ifftshift(x, axes=axes)


def fftfreq(n, d=1.0):
    """Sample frequencies for a length-n transform (numpy layout), as a
    tensor."""
    return torch.fft.fftfreq(n, d)


def rfftfreq(n, d=1.0):
    """Sample frequencies for a length-n real transform, as a tensor."""
    return torch.fft.rfftfreq(n, d)
