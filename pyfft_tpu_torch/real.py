"""Real-input transforms: the rfft family.

Counterpart of ``pyfft_tpu/real.py``, with its names and semantics: a
length-n real FFT runs as one length-n/2 complex FFT plus an elementwise
untangle,

    X[k] = E[k] + w_n^k * O[k],            k = 0..n/2
    E[k] = (Z[k] + conj(Z[-k])) / 2        (FFT of the even samples)
    O[k] = (Z[k] - conj(Z[-k])) / (2i)     (FFT of the odd samples)

with Z the n/2-point FFT of z[t] = x[2t] + i*x[2t+1].  That z is, byte for
byte, the real input viewed as interleaved complex64
(``torch.view_as_complex`` of its (..., n/2, 2) view), so the inner
transform is a complex-form ``Plan.execute`` of that view and takes the
plan's interleaved route (``plan.py``): no copy splits the samples.  The
inverse writes a complex (..., n/2) tensor whose ``view_as_real`` is the
real output, so nothing interleaves at the end either.  The untangle is
plain torch complex arithmetic on whole tensors, as the JAX package's is
XLA elementwise code.

The computation is complex64, as in JAX: float64 input is cast to float32.
``rfft2``/``rfftn`` run the real trick over the last axis and complex FFTs
over the leading transform axes, each moved last through a cached 1D plan
(numpy.fft.rfftn's layout).  A tensor runs on its own device; numpy input
on the ``device=`` keyword's (default "cuda").  The ``*_planar`` forms take
and return (re, im) planes; the planes they return are the two stride-2
views of one complex tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyfft_tpu_torch.utils.radix import is_power_of_two

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "rfft_planar", "irfft_planar", "rfftn_planar", "irfftn_planar"]

# Plan keywords forwarded to the inner complex plans.  normalize=False or a
# scale would break the untangle's algebra (irfft relies on the inverse's
# exact 1/m), so they are refused, as in JAX; ``device`` is the port's own.
_ALLOWED_KW = frozenset({"force_xla", "fast_math", "device"})


def _check_kw(kw: dict) -> dict:
    bad = sorted(set(kw) - _ALLOWED_KW)
    if bad:
        raise ValueError(
            f"rfft/irfft do not accept plan kwargs {bad}: only "
            f"{sorted(_ALLOWED_KW)} are forwarded (normalize/scale would "
            f"break the half-size untangle algebra)")
    # inner plans never synchronise: the caller syncs on the final output
    return dict(kw, wait_for_finish=False)


@functools.lru_cache(maxsize=None)
def _half_twiddle(n: int, sign: int):
    """(wr, wi) of w_n^(sign*k) for k = 0..n/2: computed in float64, then
    rounded once to float32."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    theta = sign * 2.0 * np.pi * k / n
    return (np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _untangle_tables(n: int, sign: int, device: torch.device):
    """(A, B), complex64 (n/2 + 1,): the untangle as two products,
    X[k] = A[k] * Z[k] + B[k] * conj(Z[-k]), with A = (1 - s*i*w) / 2 and
    B = (1 + s*i*w) / 2 for w = _half_twiddle(n, sign) and s = -sign (the
    forward's -i/2 on O, the inverse's +i on O).  0.5 and the float32 w
    make every entry exact but the one rounding of 0.5 * (1 -+ s*wi)."""
    wr, wi = (t.astype(np.float64) for t in _half_twiddle(n, sign))
    s = -sign
    a = 0.5 * (1 + s * wi) - 0.5j * s * wr
    b = 0.5 * (1 - s * wi) + 0.5j * s * wr
    return tuple(torch.from_numpy(t.astype(np.complex64)).to(device)
                 for t in (a, b))


def _get_plan(m: int, **kw):
    from pyfft_tpu_torch.api import get_plan
    return get_plan((m,), np.complex64, **kw)


def _as_tensor(x, dtype: torch.dtype, kw: dict) -> torch.Tensor:
    """User data -> a tensor of ``dtype``; sets kw["device"] to its device
    (a tensor's own, else the keyword's, else "cuda")."""
    if isinstance(x, torch.Tensor):
        kw.setdefault("device", x.device)
    else:
        x = torch.as_tensor(np.asarray(x), device=kw.setdefault("device",
                                                                "cuda"))
    return x.to(dtype)


def _fft_axis(X: torch.Tensor, axis: int, inverse: bool, kw: dict):
    """Complex FFT of complex64 ``X`` over one axis via a cached 1D plan,
    the axis moved last (JAX's ``_fft_axis_planar``)."""
    axis = axis % X.ndim
    plan = _get_plan(X.shape[axis], **kw)
    if axis == X.ndim - 1:
        return plan.execute(X, inverse=inverse)
    y = plan.execute(X.movedim(axis, -1), inverse=inverse)
    return y.movedim(-1, axis)


def _rank(ndim, nd_data: int, what: str) -> int:
    nd = ndim if ndim is not None else min(nd_data, 3)
    if not 1 <= nd <= min(nd_data, 3):
        raise ValueError(f"{what} rank must be 1..3 within the array rank, "
                         f"got ndim={nd} for rank {nd_data}")
    return nd


# --------------------------------------------------------------------- 1D


def _untangle(Z: torch.Tensor, n: int) -> torch.Tensor:
    """The spectrum Z (..., n/2) of the interleaved view -> the real
    input's half-spectrum X (..., n/2 + 1), complex64."""
    m = n // 2
    a, b = _untangle_tables(n, -1, Z.device)
    X = torch.empty((*Z.shape[:-1], m + 1), dtype=torch.complex64,
                    device=Z.device)
    # k = 1..m-1: A*Z[k] + B*conj(Z[m-k]); Z[0] gives k = 0 and k = m, real
    torch.mul(Z[..., 1:], a[1:m], out=X[..., 1:m])
    X[..., 1:m].addcmul_(Z[..., 1:].flip(-1).conj(), b[1:m])
    Xv, z0 = torch.view_as_real(X), torch.view_as_real(Z[..., 0])
    torch.add(z0[..., 0], z0[..., 1], out=Xv[..., 0, 0])
    torch.sub(z0[..., 0], z0[..., 1], out=Xv[..., m, 0])
    Xv[..., 0, 1] = 0
    Xv[..., m, 1] = 0
    return X


def _tangle(X: torch.Tensor, n: int) -> torch.Tensor:
    """A half-spectrum X (..., n/2 + 1) -> the spectrum Z (..., n/2) whose
    inverse is the real signal's interleaved view: Z[k] = E[k] + i*O[k],
    E = (X[k] + conj(X[m-k])) / 2, O = w_n^k (X[k] - conj(X[m-k])) / 2."""
    m = n // 2
    c, d = _untangle_tables(n, +1, X.device)
    Z = torch.mul(X[..., :m], c[:m])
    Z.addcmul_(X[..., 1:].flip(-1).conj(), d[:m])
    return Z


def _rfft(x, kw: dict) -> torch.Tensor:
    """Real (..., n) -> complex64 half-spectrum (..., n/2 + 1)."""
    x = _as_tensor(x, torch.float32, kw)
    n = x.shape[-1] if x.ndim else 0
    if not (is_power_of_two(n) and n >= 4):
        raise ValueError(f"rfft length must be a power of two >= 4, got {n}")
    m = n // 2
    x = x.contiguous()
    if x.storage_offset() % 2:          # view_as_complex needs pairs aligned
        x = x.clone()
    z = torch.view_as_complex(x.view(*x.shape[:-1], m, 2))
    return _untangle(_get_plan(m, **kw).execute(z), n)


def _irfft(X, n, kw: dict) -> torch.Tensor:
    """Complex half-spectrum (..., n/2 + 1) -> real float32 (..., n)."""
    X = _as_tensor(X, torch.complex64, kw)
    if n is None:
        n = 2 * (X.shape[-1] - 1)
    if not (is_power_of_two(n) and n >= 4) or X.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"irfft needs a (..., n//2+1) half-spectrum with n a power of "
            f"two >= 4; got {X.shape[-1]} columns for n={n}")
    y = _get_plan(n // 2, **kw).execute(_tangle(X, n), inverse=True)
    return torch.view_as_real(y).reshape(*y.shape[:-1], n)   # 1/m applied


def rfft_planar(x, **kw):
    """Planar rfft: real (..., n) -> ((..., n//2+1) re, im) planes."""
    X = _rfft(x, _check_kw(kw))
    v = torch.view_as_real(X)
    return v[..., 0], v[..., 1]


def irfft_planar(xr, xi, n: int | None = None, **kw):
    """Planar irfft: half-spectrum planes (..., n//2+1) -> real (..., n)."""
    kw = _check_kw(kw)
    xr = _as_tensor(xr, torch.float32, kw)
    xi = _as_tensor(xi, torch.float32, kw)
    return _irfft(torch.complex(xr, xi), n, kw)


def rfft(x, **kw):
    """FFT of a real array over its last axis (power-of-two length >= 4):
    the complex64 half-spectrum of length n//2 + 1 (numpy.fft.rfft's
    layout), on the input's device."""
    return _rfft(x, _check_kw(kw))


def irfft(X, n: int | None = None, **kw):
    """Inverse of :func:`rfft`: half-spectrum (..., n//2+1) -> real
    float32 (..., n)."""
    return _irfft(X, n, _check_kw(kw))


# --------------------------------------------------------------------- N-D


def _rfftn(x, ndim, kw: dict) -> torch.Tensor:
    x = _as_tensor(x, torch.float32, kw)
    nd = _rank(ndim, x.ndim, "rfftn")
    X = _rfft(x, kw)
    for ax in range(x.ndim - nd, x.ndim - 1):
        X = _fft_axis(X, ax, False, kw)
    return X


def _irfftn(X, ndim, n, kw: dict) -> torch.Tensor:
    X = _as_tensor(X, torch.complex64, kw)
    nd = _rank(ndim, X.ndim, "irfftn")
    for ax in range(X.ndim - nd, X.ndim - 1):
        X = _fft_axis(X, ax, True, kw)                 # 1/n per axis
    return _irfft(X, n, kw)


def rfftn_planar(x, ndim: int | None = None, **kw):
    """Planar N-D real FFT over the last ``ndim`` axes (default: all, up
    to 3).  Real trick on the last axis, complex FFTs over the rest."""
    v = torch.view_as_real(_rfftn(x, ndim, _check_kw(kw)))
    return v[..., 0], v[..., 1]


def irfftn_planar(xr, xi, ndim: int | None = None, n: int | None = None,
                  **kw):
    """Planar inverse of :func:`rfftn_planar` (real output)."""
    kw = _check_kw(kw)
    xr = _as_tensor(xr, torch.float32, kw)
    xi = _as_tensor(xi, torch.float32, kw)
    return _irfftn(torch.complex(xr, xi), ndim, n, kw)


def rfftn(x, ndim: int | None = None, **kw):
    """N-D FFT of a real array (numpy.fft.rfftn's layout over the last
    ``ndim`` axes; every transform length a power of two)."""
    return _rfftn(x, ndim, _check_kw(kw))


def irfftn(X, ndim: int | None = None, n: int | None = None, **kw):
    """Inverse of :func:`rfftn`: half-spectrum -> real float32 array."""
    return _irfftn(X, ndim, n, _check_kw(kw))


def rfft2(x, **kw):
    """2D FFT of a real array over its last two axes (rfftn, ndim=2)."""
    return rfftn(x, 2, **kw)


def irfft2(X, n: int | None = None, **kw):
    """Inverse of :func:`rfft2`."""
    return irfftn(X, 2, n, **kw)
