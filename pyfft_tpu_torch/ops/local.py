"""The single-pass row FFT (the "local" executor).

Counterpart of the row path of ``pyfft_tpu/ops/pallas_local.py``:
``fft_axis(axis=-1)`` -> ``_fft_rows`` -> ``_row_call_inner`` -> the Pallas
kernel ``_kernel``.  Two implementations of the same function live here:

* the Hopper kernel ``csrc/local_rows.cu`` (a Stockham radix-8 chain in
  shared memory, one device-memory round trip), launched by
  ``_launch_rows`` for every CUDA tensor;
* its plain torch version, ``tile_fft`` with ``needed_tables`` and
  ``_butterfly``: a line-for-line mirror of the JAX package's tile math
  (the same factor chains, radix-8 constants, stacked DFT matrices and
  folded last twiddle), taken for every CPU tensor.  The tests hold it
  against JAX's ``tile_fft`` on the very same tables.

``fft_axis`` decides by the tensor's device alone.  For a CUDA tensor it
launches the kernel or raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pyfft_tpu_torch.ops.twiddle import dft_matrix, twiddle_table
from pyfft_tpu_torch.planner import MAX_LOCAL_N, MIN_LOCAL_N
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["supported", "fft_axis", "fft_rows_plain", "tile_fft",
           "needed_tables", "tables_from_numpy", "default_factors",
           "row_factors", "butterfly_factors", "precise_factors",
           "MAX_LOCAL_N", "LAUNCHES"]

# Kernel launches made by _launch_rows since the last reset (a caller sets
# it to 0): the proof that a run went through the CUDA kernel.
LAUNCHES = 0

# Row-chain overrides of the JAX package (pallas_local.ROW_FACTORS), kept so
# that the plain version runs the JAX chains exactly.  The CUDA kernel has
# its own fixed radix-8 schedule and ignores factors.
ROW_FACTORS = {2048: (4, 4, 2, 64), 4096: (8, 8, 64), 1024: (8, 2, 64)}

# Factors run as add/sub butterflies instead of DFT-matrix contractions.
VPU_RADICES = (2, 4, 8)

# Fold the twiddle between the last butterfly stage and the final matrix
# stage into per-digit DFT matrices (pallas_local.FOLD_LAST_TW).
FOLD_LAST_TW = True

# Largest axis for the butterfly-only (fast_math=False) chains
# (pallas_local.MAX_BUTTERFLY_N).
MAX_BUTTERFLY_N = 2048


@functools.lru_cache(maxsize=None)
def default_factors(n: int) -> tuple[int, ...]:
    """pallas_local.default_factors: radix-4 butterflies in front of one
    64- or 128-point matrix stage."""
    if n <= MIN_LOCAL_N:
        return (n,)
    p = n.bit_length() - 1
    if p < 6:
        return (n,)
    mxu = 64 if (p - 6) % 2 == 0 else 128
    r = p - (mxu.bit_length() - 1)
    return (4,) * (r // 2) + (mxu,)


def row_factors(n: int) -> tuple[int, ...]:
    """pallas_local.row_factors from the static table only (the JAX
    package's per-machine autotune record is not ported)."""
    return ROW_FACTORS.get(n) or default_factors(n)


def butterfly_factors(n: int) -> tuple[int, ...]:
    """All-butterfly chain: radix-4 with one leading 2 for odd log2."""
    p = n.bit_length() - 1
    if p % 2:
        return (2,) + (4,) * (p // 2)
    return (4,) * (p // 2)


def precise_factors(n: int) -> tuple[int, ...] | None:
    """Chain for fast_math=False, or None above MAX_BUTTERFLY_N, where the
    JAX package silently keeps the default chain; mirrored here."""
    if MIN_LOCAL_N <= n <= MAX_BUTTERFLY_N and is_power_of_two(n):
        return butterfly_factors(n)
    return None


def _fold_applies(factors, stacked: bool) -> bool:
    """Whether the last inter-stage twiddle folds into the final matrix
    stage: the final factor is a stacked contraction, at least one stage
    precedes it, and the per-digit table count is small."""
    return (FOLD_LAST_TW and stacked and len(factors) >= 2
            and factors[-1] not in VPU_RADICES and factors[-2] <= 8)


def needed_tables(n: int, sign: int, dtype=np.float32, factors=None,
                  stacked: bool = True) -> dict:
    """Ordered {key: (ndarray, ...)} tables for a length-n tile FFT.

    pallas_local.needed_tables without the int8 precision mode: stacked
    [[Wr, -Wi], [Wi, Wr]] DFT matrices (or (Wr, Wi) pairs), inter-stage
    twiddles shaped for an (n, lanes) tile, and, where the fold applies,
    the last twiddle pre-multiplied in float64 into per-digit matrices.
    """
    factors = tuple(factors or default_factors(n))
    assert math.prod(factors) == n
    m = len(factors)
    fold = _fold_applies(factors, stacked)
    tables: dict = {}
    for i, f in enumerate(factors):
        if fold and i == m - 1:
            wr, wi = dft_matrix(f, sign, np.float64)
            f_prev = factors[m - 2]
            tr, ti = twiddle_table(f_prev, f, f_prev * f, sign, np.float64)
            mats = []
            for j in range(f_prev):
                # W_j[k, i] = W[k, i] * T[j, i]: scale W's columns
                wjr = wr * tr[j][None, :] - wi * ti[j][None, :]
                wji = wr * ti[j][None, :] + wi * tr[j][None, :]
                mats.append(np.block([[wjr, -wji],
                                      [wji, wjr]]).astype(dtype))
            tables[("dftsfold", factors)] = tuple(mats)
            continue
        if f not in VPU_RADICES:
            wr, wi = dft_matrix(f, sign, np.float64)
            if stacked:
                ws = np.block([[wr, -wi], [wi, wr]]).astype(dtype)
                tables.setdefault(("dfts", f), (ws,))
            else:
                tables.setdefault(("dft", f),
                                  (wr.astype(dtype), wi.astype(dtype)))
        if i < m - 1 and not (fold and i == m - 2):
            rest = factors[i + 1:]
            r = math.prod(rest)
            tr, ti = twiddle_table(f, r, f * r, sign, dtype)
            shape = (f,) + (1,) * i + rest + (1,)
            tables[("tw", i, factors)] = (tr.reshape(shape), ti.reshape(shape))
    return tables


def tables_from_numpy(tables: dict, device) -> dict:
    """{key: (ndarray, ...)} -> {key: (Tensor, ...)} on ``device``.

    Takes the dict of either package's ``needed_tables``, so that tests can
    run the JAX and torch tile math on the very same tables.
    """
    return {k: tuple(torch.as_tensor(np.asarray(a), device=device) for a in v)
            for k, v in tables.items()}


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, sign: int, factors: tuple,
                   device: torch.device) -> dict:
    return tables_from_numpy(needed_tables(n, sign, factors=factors), device)


def _fft4_lists(rs, ms, sign):
    """4-point DFT of 4 (re, im) slice pairs; returns output lists."""
    ar, ai = rs[0] + rs[2], ms[0] + ms[2]
    br, bi = rs[0] - rs[2], ms[0] - ms[2]
    cr, ci = rs[1] + rs[3], ms[1] + ms[3]
    dr, di = rs[1] - rs[3], ms[1] - ms[3]
    if sign < 0:     # forward: y1 = b - i*d, y3 = b + i*d
        yr = [ar + cr, br + di, ar - cr, br - di]
        yi = [ai + ci, bi - dr, ai - ci, bi + dr]
    else:
        yr = [ar + cr, br - di, ar - cr, br + di]
        yi = [ai + ci, bi + dr, ai - ci, bi - dr]
    return yr, yi


_SQRT1_2 = float(np.float32(np.sqrt(0.5)))


def _butterfly(f, xr, xi, axis, sign):
    """f-point DFT over ``axis`` as add/sub chains (f in 2, 4, 8); the
    output digit is prepended at axis 0 with ``axis`` consumed, as in
    pallas_local._butterfly."""
    rs = [xr.select(axis, j) for j in range(f)]
    ms = [xi.select(axis, j) for j in range(f)]
    if f == 2:
        yr = [rs[0] + rs[1], rs[0] - rs[1]]
        yi = [ms[0] + ms[1], ms[0] - ms[1]]
    elif f == 4:
        yr, yi = _fft4_lists(rs, ms, sign)
    elif f == 8:
        # 8 = 2 x 4: radix-2 over the high input digit, w8^j2 inlined as
        # constants (1, c(1∓i), ∓i, -c(1±i) with c = sqrt(1/2)), then two
        # 4-point DFTs; outputs interleave as k = k2*2 + k1.
        er = [rs[j] + rs[4 + j] for j in range(4)]
        ei = [ms[j] + ms[4 + j] for j in range(4)]
        or_ = [rs[j] - rs[4 + j] for j in range(4)]
        oi_ = [ms[j] - ms[4 + j] for j in range(4)]
        c = _SQRT1_2
        if sign < 0:
            # w8^1 = c(1-i): (r+i*m)*(c-ic) = c(r+m) + i c(m-r)
            or_[1], oi_[1] = c * (or_[1] + oi_[1]), c * (oi_[1] - or_[1])
            or_[2], oi_[2] = oi_[2], -or_[2]                  # * -i
            or_[3], oi_[3] = c * (oi_[3] - or_[3]), -c * (or_[3] + oi_[3])
        else:
            or_[1], oi_[1] = c * (or_[1] - oi_[1]), c * (oi_[1] + or_[1])
            or_[2], oi_[2] = -oi_[2], or_[2]                  # * +i
            or_[3], oi_[3] = -c * (or_[3] + oi_[3]), c * (or_[3] - oi_[3])
        ar, ai = _fft4_lists(er, ei, sign)    # k1 = 0
        br, bi = _fft4_lists(or_, oi_, sign)  # k1 = 1
        yr = [p for pair in zip(ar, br) for p in pair]
        yi = [p for pair in zip(ai, bi) for p in pair]
    else:
        raise ValueError(f"unsupported butterfly radix {f}")
    return torch.stack(yr, dim=0), torch.stack(yi, dim=0)


def _dg(w, x, axis):
    """dot_general(w, x) contracting w's axis 1 with x's ``axis``; the
    contracted-out index of w lands at axis 0."""
    return torch.tensordot(w, x, dims=([1], [axis]))


def _cdot(wr, wi, xr, xi, axis):
    """Complex (w @ x) contracting x's ``axis``, as 4 real contractions."""
    rr = _dg(wr, xr, axis)
    ii = _dg(wi, xi, axis)
    ri = _dg(wr, xi, axis)
    ir = _dg(wi, xr, axis)
    return rr - ii, ri + ir


def tile_fft(re, im, tables: dict, n: int, factors=None, stacked: bool = True,
             sign: int = -1):
    """Length-n DFT over axis 0 of an (n, lanes) planar tile.

    pallas_local.tile_fft in torch: with x viewed as (f_1, ..., f_m, lanes),
    stage i applies a small-radix butterfly or contracts axis i against the
    f_i-point DFT matrix; both prepend the new spectral digit, so the rows
    flatten to natural DFT order.  Matrix stages carry the direction in
    their tables; ``sign`` matters only for butterflies.
    """
    trail = tuple(re.shape[1:])
    assert re.shape[0] == n, (tuple(re.shape), n)
    factors = tuple(factors or default_factors(n))
    m = len(factors)
    fold = ("dftsfold", factors) in tables
    xr = re.reshape(*factors, *trail)
    xi = im.reshape(*factors, *trail)
    for i, f in enumerate(factors):
        if fold and i == m - 1:
            # folded final stage: the last twiddle round is baked into
            # per-digit matrices W_j (j = the previous stage's digit, at
            # axis 0)
            mats = tables[("dftsfold", factors)]
            yr, yi = [], []
            for j in range(len(mats)):
                xs = torch.cat([xr.select(0, j), xi.select(0, j)], dim=i - 1)
                y = _dg(mats[j], xs, i - 1)
                yr.append(y[:f])
                yi.append(y[f:])
            xr = torch.stack(yr, dim=1)
            xi = torch.stack(yi, dim=1)
            break
        if f in VPU_RADICES:
            xr, xi = _butterfly(f, xr, xi, i, sign)
        elif stacked:
            xs = torch.cat([xr, xi], dim=i)
            (ws,) = tables[("dfts", f)]
            y = _dg(ws, xs, i)
            xr, xi = y[:f], y[f:]
        else:
            wr, wi = tables[("dft", f)]
            xr, xi = _cdot(wr, wi, xr, xi, i)
        if i < m - 1 and not (fold and i == m - 2):
            twr, twi = tables[("tw", i, factors)]
            xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
    return xr.reshape(n, *trail), xi.reshape(n, *trail)


def supported(re: torch.Tensor, axis: int) -> bool:
    """Whether the row kernel covers this tensor/axis: float32, the last
    axis, a power of two in [MIN_LOCAL_N, MAX_LOCAL_N]."""
    if re.dtype != torch.float32 or re.ndim == 0:
        return False
    if axis % re.ndim != re.ndim - 1:
        return False
    n = re.shape[-1]
    return is_power_of_two(n) and MIN_LOCAL_N <= n <= MAX_LOCAL_N


def fft_rows_plain(re, im, sign, postscale: float = 1.0, factors=None):
    """The plain torch version of the row kernel, on any device: the DFT
    along the last axis of (..., n) float32 planes through ``tile_fft``
    (default chain ``row_factors(n)``), times ``postscale``."""
    n = re.shape[-1]
    factors = tuple(factors or row_factors(n))
    tables = _device_tables(n, sign, factors, re.device)
    xr, xi = tile_fft(re.reshape(-1, n).T, im.reshape(-1, n).T, tables, n,
                      factors, sign=sign)
    if postscale != 1.0:
        xr, xi = xr * postscale, xi * postscale
    return xr.T.reshape(re.shape), xi.T.reshape(re.shape)


@functools.lru_cache(maxsize=None)
def _kernel_twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 table of exp(sign*2*pi*i*k/n): float64 on the host,
    rounded once."""
    tr, ti = twiddle_table(2, n, n, sign, np.float64)     # row 1: a = 1
    tw = np.stack([tr[1], ti[1]], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _rows_view(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """(..., n) -> a (rows, n) view of the same memory, or raise."""
    try:
        return t.view(-1, n)
    except RuntimeError as e:
        raise ValueError(f"{what}: leading dims do not collapse to one row "
                         f"stride (strides {t.stride()})") from e


@functools.lru_cache(maxsize=None)
def _rows_fn():
    """The C entry point of csrc/local_rows.cu, built at first use."""
    from pyfft_tpu_torch.ops.build import load
    fn = load("local_rows").pyfft_local_rows
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_rows(re, im, out_re, out_im, sign: int, postscale: float):
    """Launch csrc/local_rows.cu over (..., n) planes; no synchronise.
    The range of n is ``supported``'s check, made by ``fft_axis``."""
    global LAUNCHES
    n = re.shape[-1]
    planes = (re, im, out_re, out_im)
    for t in planes:
        if (not t.is_cuda or t.device != re.device
                or t.dtype != torch.float32):
            raise ValueError("row kernel takes float32 planes on one CUDA "
                             f"device, got {t.dtype} on {t.device}")
        if t.shape != re.shape:
            raise ValueError("row kernel planes differ in shape")
        if t.stride(-1) not in (1, 2):
            raise ValueError("row kernel needs the transform axis contiguous "
                             f"(element stride 1 or 2), got {t.stride(-1)}")
    rows = re.numel() // n
    if rows == 0:
        return out_re, out_im
    r2, i2, or2, oi2 = (_rows_view(t, n, w) for t, w in
                        zip(planes, ("re", "im", "out_re", "out_im")))
    if r2.stride() != i2.stride() or or2.stride() != oi2.stride():
        raise ValueError("row kernel needs equal strides for re and im")
    if max(rows, *r2.stride(), *or2.stride()) >= 2 ** 31:
        raise ValueError("row kernel strides and row count must fit int32")
    fn = _rows_fn()
    tw = _kernel_twiddles(n, sign, re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = fn(r2.data_ptr(), i2.data_ptr(), or2.data_ptr(), oi2.data_ptr(),
                 tw.data_ptr(), rows, ilog2(n), r2.stride(1), r2.stride(0),
                 or2.stride(1), or2.stride(0), int(sign), float(postscale),
                 stream)
    if err != 0:
        raise RuntimeError(f"local_rows launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_re, out_im


def fft_axis(re, im, sign, *, axis=-1, postscale: float = 1.0, factors=None,
             out=None):
    """DFT along the last axis of planar float32 tensors.

    A CUDA tensor goes to the row kernel, which runs its own radix-8 chain
    and ignores ``factors``; a CPU tensor goes to the plain torch version,
    which runs ``factors`` (default: ``row_factors(n)``).  ``out=(re, im)``
    names the planes to write; they may be the inputs themselves (in
    place).  Without it, new planes are allocated with the input's layout.
    Raises where the kernel does not apply; nothing falls back.
    """
    if not supported(re, axis):
        raise ValueError(f"local row FFT does not cover axis {axis} of a "
                         f"{re.dtype} tensor of shape {tuple(re.shape)}")
    if re.is_cuda:
        if out is None:
            out = _empty_like_planes(re, im)
        return _launch_rows(re, im, out[0], out[1], sign, postscale)
    if re.device.type != "cpu":
        raise ValueError(f"no row FFT for device {re.device}")
    rr, ii = fft_rows_plain(re, im, sign, postscale, factors)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out


def _empty_like_planes(re, im):
    """Output planes in the input's layout: interleaved pairs when the
    inputs are the two planes of one complex tensor, planar otherwise."""
    if (re.stride(-1) == 2 and im.stride() == re.stride()
            and im.data_ptr() == re.data_ptr() + 4):
        v = torch.view_as_real(torch.empty(re.shape, dtype=torch.complex64,
                                           device=re.device))
        return v[..., 0], v[..., 1]
    return (torch.empty(re.shape, dtype=re.dtype, device=re.device),
            torch.empty(re.shape, dtype=re.dtype, device=re.device))
