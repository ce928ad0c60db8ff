"""Twiddle-factor and DFT-matrix tables (numpy only).

Counterpart of ``pyfft_tpu/ops/twiddle.py``, copied so that this package
never imports jax; the tests hold both to bit-identical output.

All tables are computed on the host in float64 with exact integer phase
reduction (j*k mod n is exact in int64 for every n this library accepts),
then rounded *once* to the target dtype.  That single rounding is what
keeps deep multi-stage chains inside the 2e-6 (c64) / 1e-11 (c128) gates,
and it is why the CUDA row kernel reads its twiddles from a table built
here instead of calling ``sinf``/``cosf`` on the device.

Everything returns *planar* (real, imag) float pairs.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["dft_matrix", "twiddle_table", "twiddle_table_strided",
           "FORWARD", "INVERSE"]

FORWARD = -1
INVERSE = +1


@functools.lru_cache(maxsize=None)
def _phase_table(rows: int, cols: int, n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of sign*2*pi*(r*c mod n)/n as float64 (rows, cols) arrays."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = np.arange(cols, dtype=np.int64)[None, :]
    k = (r * c) % n  # exact: rows*cols <= 2**44 << 2**53
    theta = (2.0 * np.pi / n) * k.astype(np.float64)
    if sign < 0:
        theta = -theta
    return np.cos(theta), np.sin(theta)


def dft_matrix(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Planar DFT matrix W[j, k] = exp(sign * 2*pi*i * j*k / n).

    Contracting an (..., n) planar signal against this matrix along its first
    axis computes the length-n DFT:  X[k] = sum_j x[j] * W[j, k].
    """
    wr, wi = _phase_table(n, n, n, sign)
    return wr.astype(dtype), wi.astype(dtype)


def twiddle_table(rows: int, cols: int, n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Planar twiddle table T[a, b] = exp(sign * 2*pi*i * a*b / n)."""
    tr, ti = _phase_table(rows, cols, n, sign)
    return tr.astype(dtype), ti.astype(dtype)


def twiddle_table_strided(rows: int, cols: int, n: int, sign: int,
                          col_stride: int, dtype=np.float32):
    """T[a, b] = exp(sign * 2*pi*i * a*(b*col_stride) / n), phases reduced
    exactly in int64.  The column stream of a factored huge-N twiddle:
    T_full[a, q*col_stride + r] = T_strided[a, q] * T_full[a, r]."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = (np.arange(cols, dtype=np.int64) * col_stride) % n
    k = (r * c[None, :]) % n
    theta = (2.0 * np.pi / n) * k.astype(np.float64)
    if sign < 0:
        theta = -theta
    return np.cos(theta).astype(dtype), np.sin(theta).astype(dtype)
