"""The plain reference: a DFT by matrix products in plain PyTorch.

Independent of the program: it imports nothing of ``pyfft_tpu_torch`` and
takes nothing the program made.  Each axis of n points is a product with
the n x n DFT matrix (n up to ``DIRECT``), or a four-step of two such
products and a twiddle for a longer axis.  The matrices' phases are taken
from (j k mod n) in integers, so no phase loses precision however long
the axis.  Complex numbers are kept as (re, im) planes and multiplied by
four real products, so that ``precision`` acts on real matrix products:

* ``"float64"``: the reference the benchmark judges by;
* ``"float32"``: the control of a complex128 configuration;
* ``"tf32"``: float32 with every product's operands rounded to TF32's
  10-bit mantissa (what a tensor-core product in TF32 reads), the control
  of a complex64 configuration.  The rounding is explicit, so the control
  is the same on the CPU and the card.

A real input's transform (``rdft``) is the complex DFT of (x, 0) with the
last axis cut to its n/2 + 1 first points (numpy.fft.rfftn's half
spectrum); its inverse (``irdft``) extends a half spectrum to the full
one by Hermitian symmetry, X[-k] = conj(X[k]) over every axis, and takes
the real part of the complex inverse.
"""

from __future__ import annotations

import math

import torch

DIRECT = 4096
_REAL = {"float64": torch.float64, "float32": torch.float32,
         "tf32": torch.float32}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest value of TF32's 10-bit
    mantissa (ties away from zero), as float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _phase(j: torch.Tensor, k: torch.Tensor, n: int, sign: int, real):
    """(cos, sin) of sign * 2 pi (j k mod n) / n, as ``real`` matrices."""
    jk = torch.remainder(j[:, None] * k[None, :], n).to(torch.float64)
    ang = (2.0 * math.pi / n) * jk
    return torch.cos(ang).to(real), (sign * torch.sin(ang)).to(real)


def _cmatmul(ar, ai, br, bi, precision: str):
    """(ar + i ai) @ (br + i bi) by four real products."""
    if precision == "tf32":
        ar, ai, br, bi = map(tf32_round, (ar, ai, br, bi))
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _dft_last(re, im, sign: int, precision: str):
    """DFT along the last axis of (re, im)."""
    n = re.shape[-1]
    real = _REAL[precision]
    idx = torch.arange(n, device=re.device, dtype=torch.int64)
    if n <= DIRECT:
        wr, wi = _phase(idx, idx, n, sign, real)
        return _cmatmul(re, im, wr, wi, precision)
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n + 1) // 2                    # n1 >= n2, both powers of 2
    n2 = n // n1
    lead = re.shape[:-1]
    # x[n2 j1 + j2] as [j1, j2]; DFT along j1 (the product on the left)
    re, im = re.reshape(*lead, n1, n2), im.reshape(*lead, n1, n2)
    i1 = torch.arange(n1, device=re.device, dtype=torch.int64)
    w1r, w1i = _phase(i1, i1, n1, sign, real)
    re, im = _cmatmul(w1r, w1i, re, im, precision)        # [k1, j2]
    tr, ti = _phase(i1, torch.arange(n2, device=re.device,
                                     dtype=torch.int64), n, sign, real)
    re, im = re * tr - im * ti, re * ti + im * tr
    re, im = _dft_last(re, im, sign, precision)           # [k1, k2]
    # X[k1 + n1 k2] = [k1, k2]: k2 outer
    return (re.transpose(-1, -2).reshape(*lead, n),
            im.transpose(-1, -2).reshape(*lead, n))


def dft(re: torch.Tensor, im: torch.Tensor, ndim: int, *, inverse: bool,
        scale: float = 1.0, precision: str = "float64"):
    """The DFT over the last ``ndim`` axes of (re, im) planes, computed in
    ``precision`` and returned in it; ``inverse`` takes the + sign.  The
    output is multiplied by ``scale``."""
    real = _REAL[precision]
    re, im = re.to(real), im.to(real)
    sign = +1 if inverse else -1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for axis in range(re.ndim - ndim, re.ndim):
            re, im = re.movedim(axis, -1), im.movedim(axis, -1)
            re, im = _dft_last(re, im, sign, precision)
            re, im = re.movedim(-1, axis), im.movedim(-1, axis)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if scale != 1.0:
        re, im = re * scale, im * scale
    return re.contiguous(), im.contiguous()


def rdft(x: torch.Tensor, ndim: int, *, precision: str = "float64"):
    """The DFT of real ``x`` over its last ``ndim`` axes as (re, im)
    planes of the half spectrum, the last axis cut to n/2 + 1, computed in
    ``precision`` and returned in it."""
    re, im = dft(x, torch.zeros_like(x), ndim, inverse=False,
                 precision=precision)
    h = x.shape[-1] // 2 + 1
    return re[..., :h].contiguous(), im[..., :h].contiguous()


def _mirror(t: torch.Tensor, ndim: int, n: int) -> torch.Tensor:
    """The points n/2 + 1 .. n - 1 of the last axis of a half spectrum's
    plane ``t`` (last axis n/2 + 1) before conjugation: t at (-j mod m)
    on each other transform axis and at n - k on the last."""
    t = t[..., 1:n - n // 2].flip(-1)
    for d in range(t.ndim - ndim, t.ndim - 1):
        t = t.flip(d).roll(1, d)
    return t


def irdft(re: torch.Tensor, im: torch.Tensor, ndim: int, n: int, *,
          scale: float = 1.0, precision: str = "float64") -> torch.Tensor:
    """The real signal over the last ``ndim`` axes, the last of ``n``
    points, whose half spectrum is (re, im): the inverse DFT of its
    Hermitian extension, real part, times ``scale``, computed in
    ``precision`` and returned in it."""
    full_re = torch.cat([re, _mirror(re, ndim, n)], -1)
    full_im = torch.cat([im, -_mirror(im, ndim, n)], -1)
    out, _ = dft(full_re, full_im, ndim, inverse=True, scale=scale,
                 precision=precision)
    return out
