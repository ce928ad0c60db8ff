"""De-interleave and interleave of complex64 storage (the stream route's
first and last pass).

Counterpart of ``pyfft_tpu/ops/interleave.py``, with its names:
``deinterleave`` turns a (..., 2n) float32 view of interleaved complex
values into two (..., n) planes, ``interleave`` the reverse, and
``supported`` is the JAX package's gate of the stream route.  Two
implementations of each conversion live here:

* the Hopper kernels of ``csrc/interleave.cu`` (K13 and K14: bit-exact
  copies, one 16-byte access of the interleaved side and one 8-byte access
  of each plane a thread), launched for every CUDA tensor;
* their plain torch versions, ``deinterleave_plain`` and
  ``interleave_plain`` (slicing and stacking), taken for every CPU tensor.

For a CUDA tensor a conversion launches its kernel or raises; nothing
falls back to the plain version.  The JAX kernels are 0/1 selection
contractions over 256-lane chunks, a TPU tile; the kernels here take any
n >= 1, and ``supported`` keeps the 256-lane rule only as the route's gate,
so that both packages route alike.  A launch's C call is the span
``pyfft.entry.K13`` or ``pyfft.entry.K14`` and adds one to ``launch.K13``
or ``launch.K14`` of the registry (``utils/profiling``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pyfft_tpu_torch.ops import build
from pyfft_tpu_torch.ops.launch import Launch, run

__all__ = ["deinterleave", "interleave", "supported", "deinterleave_plain",
           "interleave_plain"]

_PACK = 256            # the JAX kernel's lanes a selection chunk


def supported(shape: tuple, dtype=torch.float32) -> bool:
    """The JAX package's gate (``interleave.supported``): a (..., 2n)
    float32 view whose last axis is whole 256-lane chunks.  float64 views
    (complex128) are refused, as in JAX."""
    if isinstance(dtype, torch.dtype):
        f32 = dtype == torch.float32
    else:
        f32 = np.dtype(dtype) == np.float32
    return bool(shape) and shape[-1] % _PACK == 0 and f32


def deinterleave_plain(v: torch.Tensor):
    """(..., 2n) -> ((..., n), (..., n)) by slicing, on any device."""
    return v[..., 0::2].contiguous(), v[..., 1::2].contiguous()


def interleave_plain(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """((..., n), (..., n)) -> (..., 2n) by stacking, on any device."""
    return torch.stack([re, im], dim=-1).reshape(*re.shape[:-1],
                                                 2 * re.shape[-1])


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """The C entry point ``name`` of csrc/interleave.cu, built at first
    use."""
    return build.entry("interleave", name, [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the byte spans of two tensors meet."""
    def span(t):
        last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
        return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()

    (a0, a1), (b0, b1) = span(a), span(b)
    return a.numel() > 0 and b.numel() > 0 and a0 < b1 and b0 < a1


def _rows(t: torch.Tensor, width: int, what: str) -> torch.Tensor:
    """(..., width) -> a (rows, width) view with a unit element stride, or
    raise."""
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: the interleave kernels take float32, got "
                         f"{t.dtype}")
    try:
        t2 = t.view(-1, width)
    except RuntimeError as e:
        raise ValueError(f"{what}: leading dims do not collapse to one row "
                         f"stride (strides {t.stride()})") from e
    if width > 1 and t2.stride(1) != 1:
        raise ValueError(f"{what}: the last axis must be contiguous, got "
                         f"stride {t2.stride(1)}")
    return t2


def _prepare(name: str, v: torch.Tensor, re: torch.Tensor, im: torch.Tensor):
    """The launch of K13 (``pyfft_deinterleave``) or K14
    (``pyfft_interleave``) between a (..., 2n) view and two (..., n)
    planes; None where they are empty."""
    n = re.shape[-1]
    if (tuple(im.shape) != tuple(re.shape)
            or tuple(v.shape) != (*re.shape[:-1], 2 * n)):
        raise ValueError(f"interleave shapes differ: {tuple(v.shape)} and "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    v2 = _rows(v, 2 * n, "interleaved")
    r2, i2 = _rows(re, n, "re"), _rows(im, n, "im")
    if r2.stride(0) != i2.stride(0):
        raise ValueError("interleave kernels need equal row strides for re "
                         "and im")
    if _overlaps(v, re) or _overlaps(v, im) or _overlaps(re, im):
        raise ValueError("interleave operands overlap: the kernels neither "
                         "run in place nor write one plane over the other")
    if not v.is_cuda or len({t.device for t in (v, re, im)}) != 1:
        raise ValueError(f"interleave kernels take tensors on one CUDA "
                         f"device, got {v.device}, {re.device}, {im.device}")
    rows = v2.shape[0]
    if rows * n == 0:
        return None
    v_rs, p_rs = v2.stride(0), r2.stride(0)
    if rows == 1 or (v_rs == 2 * n and p_rs == n):
        rows, n, v_rs, p_rs = 1, rows * n, 2 * rows * n, rows * n
    if name == "pyfft_deinterleave":
        return Launch(_fn(name), (v2.data_ptr(), r2.data_ptr(),
                                  i2.data_ptr(), rows, n, v_rs, p_rs),
                      (0, 1, 2), "pyfft.entry.K13", {0: "launch.K13"}, name)
    return Launch(_fn(name), (r2.data_ptr(), i2.data_ptr(), v2.data_ptr(),
                              rows, n, v_rs, p_rs),
                  (0, 1, 2), "pyfft.entry.K14", {0: "launch.K14"}, name)


def _launch(name: str, v: torch.Tensor, re: torch.Tensor, im: torch.Tensor):
    """Launch ``_prepare``'s kernel; no synchronise."""
    run(_prepare(name, v, re, im), v.device)


def deinterleave(v: torch.Tensor, *, out=None):
    """(..., 2n) float32 interleaved view -> ((..., n), (..., n)) planes.

    Bit-exact: one device-memory round trip through K13 for a CUDA tensor,
    the plain version for a CPU tensor.  ``out=(re, im)`` names the planes
    to write, which must not overlap ``v``.
    """
    if v.shape[-1] % 2:
        raise ValueError(f"an interleaved view has an even last axis, got "
                         f"{tuple(v.shape)}")
    shape = (*v.shape[:-1], v.shape[-1] // 2)
    if not v.is_cuda:
        re, im = deinterleave_plain(v)
        if out is None:
            return re, im
        out[0].copy_(re)
        out[1].copy_(im)
        return out
    if out is None:
        out = (torch.empty(shape, dtype=v.dtype, device=v.device),
               torch.empty(shape, dtype=v.dtype, device=v.device))
    _launch("pyfft_deinterleave", v, *out)
    return out


def interleave(re: torch.Tensor, im: torch.Tensor, *, out=None):
    """((..., n), (..., n)) float32 planes -> (..., 2n) interleaved view.

    Bit-exact: K14 for CUDA tensors, the plain version for CPU tensors.
    ``out`` names the (..., 2n) tensor to write, which must not overlap the
    planes.
    """
    if not re.is_cuda:
        v = interleave_plain(re, im)
        if out is None:
            return v
        out.copy_(v)
        return out
    if out is None:
        out = torch.empty((*re.shape[:-1], 2 * re.shape[-1]), dtype=re.dtype,
                          device=re.device)
    _launch("pyfft_interleave", out, re, im)
    return out
