"""Planar (split re/im) matmul-form FFT in plain torch.

Counterpart of ``pyfft_tpu/reference.py`` (``fft_planar``,
``fftn_planar``): the same mixed-radix einsum chain with the same factor
split and the same DFT digit order, in float32 or float64 on any device.
It is the executor of every pass that has no ported kernel yet (the
planner's ``plain`` passes: non-last axes, n > MAX_LOCAL_N, complex128)
and the in-package oracle of the tests.

With the axis reshaped to factors (f_1, ..., f_m), stage i contracts
factor i against the f_i-point DFT matrix, moves the new spectral digit
to the front of the factor block and multiplies by the inter-stage
twiddle, so after m stages the block reads (k_m, ..., k_1): natural DFT
order with no bit-reversal pass.
"""

from __future__ import annotations

import functools
import string

import numpy as np
import torch

from pyfft_tpu_torch.ops.twiddle import dft_matrix, twiddle_table
from pyfft_tpu_torch.utils.radix import is_power_of_two

__all__ = ["fft_planar", "fftn_planar", "DEFAULT_BASE"]

# A float32 matmul in TF32 keeps about 10 mantissa bits, which puts a
# 4096-point chain near 1e-3 relative error, far outside the 2e-6 gate.
# Both switches are set here, explicitly, because cuDNN's defaults to TF32
# and a host application may have turned the matmul one on.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Largest DFT factor contracted in one einsum (the JAX package's value, so
# that both packages run the same chain).
DEFAULT_BASE = 128

_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def _factorize(n: int, base: int) -> tuple[int, ...]:
    """Split n into balanced power-of-two factors, each <= base."""
    if n <= base:
        return (n,)
    p = n.bit_length() - 1
    pb = base.bit_length() - 1
    m = -(-p // pb)
    q, r = divmod(p, m)
    return tuple(1 << (q + (1 if i < r else 0)) for i in range(m))


@functools.lru_cache(maxsize=None)
def _consts(kind: str, dtype: torch.dtype, device: torch.device, *args):
    """DFT matrix or twiddle table as a (real, imag) pair of tensors."""
    fn = dft_matrix if kind == "dft" else twiddle_table
    re, im = fn(*args, dtype=_REAL[dtype])
    return (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))


def _fft_factors(re, im, lead: int, factors: tuple[int, ...], trail: int,
                 sign: int):
    """DFT over the factor block of (lead..., f_1, ..., f_m, trail...)."""
    m = len(factors)
    letters = string.ascii_lowercase
    for i, f in enumerate(factors):
        # axes: [lead] + [k_{i-1}..k_1] (i of them) + [j_i] + rest + [trail]
        ndim = re.ndim
        pos = lead + i
        spec = letters[:ndim]
        j = spec[pos]
        out = spec[:lead] + "z" + spec[lead:pos] + spec[pos + 1:]
        eq = f"z{j},{spec}->{out}"
        wr, wi = _consts("dft", re.dtype, re.device, f, sign)
        re, im = (torch.einsum(eq, wr, re) - torch.einsum(eq, wi, im),
                  torch.einsum(eq, wr, im) + torch.einsum(eq, wi, re))
        if i < m - 1:
            rest = factors[i + 1:]
            r = 1
            for g in rest:
                r *= g
            tr, ti = _consts("tw", re.dtype, re.device, f, r, f * r, sign)
            shape = (f,) + (1,) * i + tuple(rest) + (1,) * trail
            tr, ti = tr.reshape(shape), ti.reshape(shape)
            re, im = re * tr - im * ti, re * ti + im * tr
    return re, im


def fft_planar(re: torch.Tensor, im: torch.Tensor, sign: int, axis: int = -1,
               base: int = DEFAULT_BASE):
    """Unnormalized DFT of a planar complex tensor along ``axis``.

    sign=-1 is the forward transform, sign=+1 the inverse kernel (the
    caller applies any 1/N normalization).
    """
    n = re.shape[axis]
    if not is_power_of_two(n):
        raise ValueError(f"transform length {n} is not a power of two")
    if re.shape != im.shape:
        raise ValueError("re/im shape mismatch")
    if re.dtype not in _REAL or im.dtype != re.dtype:
        raise ValueError(f"planes must be float32 or float64, got "
                         f"{re.dtype}/{im.dtype}")
    if n == 1:
        return re, im
    axis = axis % re.ndim
    factors = _factorize(n, base)
    lead_shape = tuple(re.shape[:axis])
    trail_shape = tuple(re.shape[axis + 1:])
    new_shape = lead_shape + factors + trail_shape
    re, im = _fft_factors(re.reshape(new_shape), im.reshape(new_shape),
                          len(lead_shape), factors, len(trail_shape), sign)
    out_shape = lead_shape + (n,) + trail_shape
    return re.reshape(out_shape), im.reshape(out_shape)


def fftn_planar(re: torch.Tensor, im: torch.Tensor, sign: int,
                axes: tuple[int, ...], base: int = DEFAULT_BASE):
    """Unnormalized multi-axis DFT (separable: one pass per axis)."""
    for ax in axes:
        re, im = fft_planar(re, im, sign, axis=ax, base=base)
    return re, im
