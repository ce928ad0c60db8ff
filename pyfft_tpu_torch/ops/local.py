"""The single-pass row and column FFTs (the "local" executor).

Counterpart of ``pyfft_tpu/ops/pallas_local.py``'s ``fft_axis``: the row
path (``axis=-1`` -> ``_fft_rows`` -> ``_row_call_inner`` -> the Pallas
kernel ``_kernel``) and the column path (``axis != -1`` -> ``_fft_cols``
-> ``_fft_cols_inner`` -> the Pallas kernel ``_col_kernel``, with its
fused four-step twiddles and swapped stores); of its
``fft_rows_interleaved``, the row DFT of interleaved complex64 storage
(the same ``_kernel`` with ``interleaved=True``, packed or not); and of the
kernels no ``Plan`` route reaches: ``fft_rows_swap`` (``_fft_rows_swap``
-> ``_row_swap_kernel``, the four-step "variant B" second pass),
``fft_axis(..., ctile=c)`` (``_fft_cols_ctile``, c lane tiles a block) and
``fft_axis_fold`` (``_fft_cols_fold`` -> ``_col_fold_kernel``, the column
pass stored in the native layout, which on row-major memory is the column
kernel's plain store).
Two implementations of each function live here:

* the Hopper kernels ``csrc/local_rows.cu`` and ``csrc/local_cols.cu``
  (Stockham radix-8 chains in shared memory, one device-memory round trip
  each), launched by ``_launch_rows``, ``_launch_rows_il`` and
  ``_launch_cols`` for every CUDA tensor: on float32 planes K1 and K5, on
  float64 planes (complex128) their native-FP64 instantiations K11 and
  K12, the counterparts of ``pyfft_tpu/ops/pallas_df64.py``'s kernels (see
  ``ops/fp64.py``; K12 from n = 1024 a cluster kernel of its own, a column
  tile split over a thread-block cluster, ``col_xshape_f64``; K5 runs the
  same cluster tile in float from n = 1024, ``col_xshape``, and from n =
  16 to 256, on a plain store with no twiddle or the ``full`` one, a
  persistent ring of tiles fed by tensor copies, ``col_ring_shape``; K12
  at n = 2048 on planar planes a tensor map reads a persistent grid of
  clusters walking the tiles through such a ring,
  ``col_xring_shape_f64``, and K5 the same ring in float at n = 1024 on
  the complex form's (re, im) pairs, on K5's persistent ring's modes,
  ``col_xring_shape``; K1,
  K2 and K11 run a persistent row ring where their table takes n,
  ``rows_ring_shape``), and on
  interleaved complex64 K1's interleaved I/O
  policy, K2, which serves the packed form K3 too; K4 (``_launch_rows_swap``)
  and K6 (``_launch_cols`` with ``ctile``) are two policies of K5's source;
  under ``precision="int8"`` K1, K2, K5 and K4 run kernels of their own
  whose last stage is the int8-split stage K10 (``ops/int8.py``);
* their plain torch versions, ``fft_rows_plain``, ``fft_cols_plain``,
  ``fft_rows_interleaved_plain`` and ``fft_rows_swap_plain`` (K6's is
  ``fft_cols_plain``), taken for every CPU tensor.  On float32 planes they are built on
  ``tile_fft`` with ``needed_tables`` and ``_butterfly``: a line-for-line
  mirror of the JAX package's tile math (the same factor chains, radix-8
  constants, stacked DFT matrices and folded last twiddle), which the tests
  hold against JAX's ``tile_fft`` on the very same tables.  On float64
  planes the DFT step is ``reference.fft_planar`` in float64 (the JAX
  package's double-float chains are TPU workarounds), followed by the same
  twiddle, postscale and stores.

``fft_axis`` decides by the tensor's device alone.  For a CUDA tensor it
launches a kernel or raises; nothing falls back to the plain version.
Each launch's C call is the span ``pyfft.entry.<kernel>`` and adds one to
``launch.<kernel>.<design>`` of the registry (``utils/profiling``), the
design as the entry returned it: ``ring`` (RAN_RING; K12's cluster
ring), ``x`` (RAN_X, the cluster tile), ``pring`` (K5's persistent ring),
``xring`` (RAN_XRING, K5's persistent cluster ring) or ``first``; an
entry that reports none counts under
``launch.<kernel>``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pyfft_tpu_torch.ops.int8 import (PRECISIONS, int8_stage,
                                      stacked_channels, w_tables)
from pyfft_tpu_torch.ops.twiddle import (dft_matrix, twiddle_table,
                                         twiddle_table_strided)
from pyfft_tpu_torch.planner import (MAX_LOCAL_N, MIN_LOCAL_N, MIN_TRAIL,
                                     max_local_n)
from pyfft_tpu_torch.reference import fft_planar
from pyfft_tpu_torch.ops import build
from pyfft_tpu_torch.ops.launch import (RAN_RING, RAN_X, RAN_XRING,
                                        Launch, run)
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["supported", "fft_axis", "fft_rows_plain", "fft_cols_plain",
           "fft_rows_interleaved", "fft_rows_interleaved_plain",
           "fft_rows_swap", "fft_rows_swap_plain", "clamp_ctile",
           "tile_fft", "tile_fft_packed", "needed_tables",
           "needed_tables_packed", "tables_from_numpy",
           "default_factors", "row_factors", "col_factors",
           "butterfly_factors", "precise_factors", "MAX_LOCAL_N",
           "PACKED_INTERLEAVED", "matrix_factor",
           "col_width_i8", "col_xshape_f64", "rows_i8_stage",
           "supported_fold", "swap_tile", "ring_shape", "rows_ring_shape",
           "col_ring_shape", "col_xshape", "col_xring_shape_f64",
           "col_xring_shape", "fft_axis_fold", "fold_lanes"]

# fft_rows_interleaved's default form, as in the JAX package: its packed
# form was a TPU compile hazard there.  Both forms run K2 on the card, and
# the flag picks only the plain version's chain.
PACKED_INTERLEAVED = False

# The plane types the kernels take, with the numpy type of their tables.
_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}
_REALS = tuple(_NP_REAL)

# Row-chain overrides of the JAX package (pallas_local.ROW_FACTORS), kept so
# that the plain version runs the JAX chains exactly.  The CUDA kernel has
# its own fixed radix-8 schedule and ignores factors.
ROW_FACTORS = {2048: (4, 4, 2, 64), 4096: (8, 8, 64), 1024: (8, 2, 64)}

# Column-chain overrides of the JAX package (pallas_local.COL_FACTORS), for
# the plain version likewise; the column kernel ignores factors too.
COL_FACTORS = {2048: (8, 4, 64), 1024: (8, 2, 64), 4096: (8, 8, 64),
               256: (8, 32)}

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
    """pallas_local.row_factors from the static table only: the JAX
    package's ``row:{n}`` record tunes these chains, which drive only the
    plain versions here; the port's record has no such entry (the CUDA
    kernels take their tables from their sources, ``utils/tune.py``)."""
    return ROW_FACTORS.get(n) or default_factors(n)


def col_factors(n: int) -> tuple[int, ...]:
    """pallas_local.col_factors from the static table only."""
    return COL_FACTORS.get(n) or default_factors(n)


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


def _fold_applies(factors, stacked: bool,
                  precision: str = "highest") -> bool:
    """Whether the last inter-stage twiddle folds into the final matrix
    stage: the final factor is a stacked float contraction (not the int8
    stage), at least one stage precedes it, and the per-digit table count
    is small."""
    return (FOLD_LAST_TW and stacked and precision != "int8"
            and len(factors) >= 2 and factors[-1] not in VPU_RADICES
            and factors[-2] <= 8)


def needed_tables(n: int, sign: int, dtype=np.float32, factors=None,
                  stacked: bool = True, precision: str = "highest",
                  trail_ndim: int = 1) -> dict:
    """Ordered {key: (ndarray, ...)} tables for a length-n tile FFT.

    pallas_local.needed_tables: stacked [[Wr, -Wi], [Wi, Wr]] DFT matrices
    (or (Wr, Wi) pairs), or under ``precision="int8"`` their 3 int8
    channels ("wi8", f); inter-stage twiddles shaped for a tile with
    ``trail_ndim`` trailing axes; and, where the fold applies, the last
    twiddle pre-multiplied in float64 into per-digit matrices.
    """
    factors = tuple(factors or default_factors(n))
    assert math.prod(factors) == n
    m = len(factors)
    fold = _fold_applies(factors, stacked, precision)
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
            if precision == "int8":
                tables.setdefault(("wi8", f), stacked_channels(f, sign))
            elif stacked:
                ws = np.block([[wr, -wi], [wi, wr]]).astype(dtype)
                tables.setdefault(("dfts", f), (ws,))
            else:
                tables.setdefault(("dft", f),
                                  (wr.astype(dtype), wi.astype(dtype)))
        if i < m - 1 and not (fold and i == m - 2):
            rest = factors[i + 1:]
            r = math.prod(rest)
            tr, ti = twiddle_table(f, r, f * r, sign, dtype)
            shape = (f,) + (1,) * i + rest + (1,) * trail_ndim
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
def _device_tables(n: int, sign: int, factors: tuple, device: torch.device,
                   precision: str = "highest", trail_ndim: int = 1) -> dict:
    return tables_from_numpy(needed_tables(n, sign, factors=factors,
                                           precision=precision,
                                           trail_ndim=trail_ndim), device)


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
             sign: int = -1, precision: str = "highest",
             group_axis: int | None = None):
    """Length-n DFT over axis 0 of an (n, lanes) planar tile.

    pallas_local.tile_fft in torch: with x viewed as (f_1, ..., f_m, lanes),
    stage i applies a small-radix butterfly or contracts axis i against the
    f_i-point DFT matrix; both prepend the new spectral digit, so the rows
    flatten to natural DFT order.  Matrix stages carry the direction in
    their tables; ``sign`` matters only for butterflies.  Under
    ``precision="int8"`` a matrix stage is the int8-split stage
    (``int8.int8_stage``), whose alignment group is the whole tile or, with
    ``group_axis`` (a negative axis of the trail), each index along it.
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
        elif precision == "int8":
            xr, xi = int8_stage(xr, xi, f, i, tables[("wi8", f)], group_axis)
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


def _pair_swap(x):
    """(re, im) -> (im, re) over the pair axis at -2."""
    return x.flip(-2)


def _pair_i(x, sign):
    """(sign * i) * z on a packed tensor (pair axis at -2):
    i*z = (-im, re), -i*z = (im, -re)."""
    lo, hi = (-1.0, 1.0) if sign >= 0 else (1.0, -1.0)
    m = torch.tensor([[lo], [hi]], dtype=x.dtype, device=x.device)
    return _pair_swap(x) * m


def _fft4_packed(xs, sign):
    """4-point DFT of 4 packed slices; mirrors _fft4_lists."""
    a, b = xs[0] + xs[2], xs[0] - xs[2]
    c, d = xs[1] + xs[3], xs[1] - xs[3]
    idd = _pair_i(d, sign)
    return [a + c, b + idd, a - c, b - idd]


def _butterfly_packed(f, x, axis, sign):
    """pallas_local._butterfly_packed: the packed-complex analog of
    _butterfly (f in 2, 4, 8); the output digit is prepended at axis 0."""
    xs = [x.select(axis, j) for j in range(f)]
    if f == 2:
        ys = [xs[0] + xs[1], xs[0] - xs[1]]
    elif f == 4:
        ys = _fft4_packed(xs, sign)
    elif f == 8:
        ev = [xs[j] + xs[4 + j] for j in range(4)]
        od = [xs[j] - xs[4 + j] for j in range(4)]
        c = _SQRT1_2
        if sign < 0:   # w8^1 = c(1-i), w8^2 = -i, w8^3 = -c(1+i)
            od[1] = c * (od[1] - _pair_i(od[1], 1))
            od[2] = _pair_i(od[2], -1)
            od[3] = -c * (od[3] + _pair_i(od[3], 1))
        else:          # w8^-1 = c(1+i), w8^-2 = i, w8^-3 = c(-1+i)
            od[1] = c * (od[1] + _pair_i(od[1], 1))
            od[2] = _pair_i(od[2], 1)
            od[3] = -c * (od[3] - _pair_i(od[3], 1))
        a = _fft4_packed(ev, sign)
        b = _fft4_packed(od, sign)
        ys = [q for pair in zip(a, b) for q in pair]
    else:
        raise ValueError(f"unsupported butterfly radix {f}")
    return torch.stack(ys, dim=0)


def needed_tables_packed(n: int, sign: int, factors=None,
                         dtype=np.float32) -> dict:
    """pallas_local.needed_tables_packed: ("dftp", f) = one (f, 2f)
    [Wr | Wi] matrix, contracted against [x ; i*x], and ("twp", i, chain)
    twiddles broadcast over the pair axis, the sine table carrying the pair
    signs (-ti at re, +ti at im)."""
    factors = tuple(factors or default_factors(n))
    assert math.prod(factors) == n
    tables: dict = {}
    for i, f in enumerate(factors):
        if f not in VPU_RADICES:
            wr, wi = dft_matrix(f, sign, np.float64)
            tables.setdefault(("dftp", f),
                              (np.concatenate([wr, wi], 1).astype(dtype),))
        if i < len(factors) - 1:
            rest = factors[i + 1:]
            r = math.prod(rest)
            tr, ti = twiddle_table(f, r, f * r, sign, dtype)
            shape = (f,) + (1,) * i + rest + (1, 1)
            tip = (ti.reshape(shape)
                   * np.asarray([-1.0, 1.0], dtype).reshape(2, 1))
            tables[("twp", i, factors)] = (tr.reshape(shape), tip)
    return tables


@functools.lru_cache(maxsize=None)
def _device_tables_packed(n: int, sign: int, factors: tuple,
                          device: torch.device) -> dict:
    return tables_from_numpy(needed_tables_packed(n, sign, factors=factors),
                             device)


def tile_fft_packed(x, tables: dict, n: int, factors=None, sign: int = -1):
    """Length-n DFT over the packed rows of a (2n, lanes) tile whose rows
    alternate (re, im): pallas_local.tile_fft_packed in torch, the same
    digit-prepend chain as ``tile_fft`` with the pair axis kept in place."""
    lanes = x.shape[-1]
    assert tuple(x.shape) == (2 * n, lanes), (tuple(x.shape), n)
    factors = tuple(factors or default_factors(n))
    m = len(factors)
    x = x.reshape(*factors, 2, lanes)
    for i, f in enumerate(factors):
        if f in VPU_RADICES:
            x = _butterfly_packed(f, x, i, sign)
        else:
            (wcat,) = tables[("dftp", f)]
            xcat = torch.cat([x, _pair_i(x, 1)], dim=i)
            x = _dg(wcat, xcat, i)
        if i < m - 1:
            tr, tip = tables[("twp", i, factors)]
            x = tr * x + tip * _pair_swap(x)
    return x.reshape(2 * n, lanes)


def supported(re: torch.Tensor, axis: int) -> bool:
    """Whether a local kernel covers this tensor/axis (pallas_local.
    supported, and pallas_df64.supported's local range): a power of two in
    [MIN_LOCAL_N, MAX_LOCAL_N] for float32, [MIN_LOCAL_N, MAX_LOCAL_N_DF64]
    for float64, and for an axis other than the last a trail (the product
    of the later axes) of at least MIN_TRAIL."""
    if re.dtype not in _REALS or re.ndim == 0:
        return False
    axis = axis % re.ndim
    n = re.shape[axis]
    if not (is_power_of_two(n) and MIN_LOCAL_N <= n <= max_local_n(re.dtype)):
        return False
    return (axis == re.ndim - 1
            or math.prod(re.shape[axis + 1:]) >= MIN_TRAIL)


def _tiles_int8(xr, xi, n: int, sign: int, factors: tuple):
    """``tile_fft`` under int8 over (n, G, lanes) planes: G tiles, each its
    own alignment group, as G blocks of the JAX kernel."""
    tables = _device_tables(n, sign, factors, xr.device, "int8", 2)
    return tile_fft(xr, xi, tables, n, factors, sign=sign, precision="int8",
                    group_axis=-2)


def fft_rows_plain(re, im, sign, postscale: float = 1.0, factors=None,
                   precision: str = "highest", lanes: int = MIN_TRAIL):
    """The plain torch version of the row kernel, on any device: the DFT
    along the last axis of (..., n) planes, times ``postscale``.  Float32
    planes go through ``tile_fft`` (default chain ``row_factors(n)``),
    float64 planes through ``fft_planar`` in float64 (``factors`` unused).

    Under ``precision="int8"`` (float32 only) the rows are zero-padded to
    whole tiles of ``lanes`` rows and each tile is one alignment group of
    the int8 stage, as the JAX kernel's blocks (pallas_local.fft_axis pads
    to 128-row tiles; _fft_rows_swap's blocks are ``lanes`` rows)."""
    _check_precision(precision, re.dtype)
    if re.dtype == torch.float64:
        xr, xi = fft_planar(re, im, sign, axis=-1)
        if postscale != 1.0:
            xr, xi = xr * postscale, xi * postscale
        return xr, xi
    n = re.shape[-1]
    factors = tuple(factors or row_factors(n))
    r2, i2 = re.reshape(-1, n), im.reshape(-1, n)
    if precision == "int8":
        rows = r2.shape[0]
        pad = (-rows) % lanes
        g = (rows + pad) // lanes
        tiles = [torch.nn.functional.pad(t, (0, 0, 0, pad))
                 .reshape(g, lanes, n).permute(2, 0, 1) for t in (r2, i2)]
        xr, xi = (t.permute(1, 2, 0).reshape(g * lanes, n)[:rows].T
                  for t in _tiles_int8(*tiles, n, sign, factors))
    else:
        tables = _device_tables(n, sign, factors, re.device)
        xr, xi = tile_fft(r2.T, i2.T, tables, n, factors, sign=sign)
    if postscale != 1.0:
        xr, xi = xr * postscale, xi * postscale
    return xr.T.reshape(re.shape), xi.T.reshape(re.shape)


@functools.lru_cache(maxsize=None)
def _kernel_twiddles(n: int, sign: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, 2) table of exp(sign*2*pi*i*k/n) in ``dtype``: float64 on the
    host, rounded once to float32 for the float32 kernels."""
    tr, ti = twiddle_table(2, n, n, sign, np.float64)     # row 1: a = 1
    return _pairs(tr[1], ti[1], device, dtype)


def _rows_view(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """(..., n) -> a (rows, n) view of the same memory, or raise."""
    try:
        return t.view(-1, n)
    except RuntimeError as e:
        raise ValueError(f"{what}: leading dims do not collapse to one row "
                         f"stride (strides {t.stride()})") from e


def _c_real(dtype: torch.dtype):
    """The C type of a postscale for planes of ``dtype``."""
    return ctypes.c_double if dtype == torch.float64 else ctypes.c_float


# The argument types of the C entries, by kind: data pointers, ints, the
# int64 ``dims`` array of the column and 2D entries.
_P, _I = ctypes.c_void_p, ctypes.c_int
_DIMS = ctypes.POINTER(ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _rows_fn(dtype: torch.dtype):
    """The C entry point of csrc/local_rows.cu for planes of ``dtype``
    (``pyfft_local_rows`` for float32, ``pyfft_local_rows_f64`` for
    float64), built at first use."""
    name = ("pyfft_local_rows_f64" if dtype == torch.float64
            else "pyfft_local_rows")
    return build.entry("local_rows", name,
                       [_P] * 5 + [_I] * 7 + [_c_real(dtype), _P])


def _check_planes(kind: str, re, planes) -> None:
    """All planes float32, or all float64, on re's CUDA device."""
    for t in planes:
        if (not t.is_cuda or t.device != re.device or t.dtype not in _REALS
                or t.dtype != re.dtype):
            raise ValueError(f"{kind} kernel takes float32 or float64 planes "
                             f"of one type on one CUDA device, got {t.dtype} "
                             f"on {t.device}")


@functools.lru_cache(maxsize=None)
def _rows_i8_fn():
    """The C entry point ``pyfft_local_rows_i8`` of csrc/local_rows.cu (K1
    with the int8 stage K10), built at first use."""
    return build.entry("local_rows", "pyfft_local_rows_i8",
                       [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P])


def rows_i8_stage(n: int, f: int) -> str:
    """Which K10 stage the int8 row kernels (K1 + K10, K2 + K10) run at
    length n with matrix factor f: "wgmma" where the block has a warpgroup
    (128 threads: n >= 1024, since a block takes max(n, 512) points at 8 a
    thread, at most 512 threads) and f >= 32, else "mma" (mma.sync).  The
    kernels make the same choice at compile time; ``_rows_i8_stage_fn``
    reports it."""
    threads = min(max(n, 512) // 8, 512)
    return "wgmma" if threads >= 128 and f >= 32 else "mma"


@functools.lru_cache(maxsize=None)
def _rows_i8_stage_fn():
    """The C entry point ``pyfft_local_rows_i8_stage`` of csrc/local_rows.cu:
    (log2 n, log2 f) -> 1 for the wgmma stage, 0 for the mma.sync one, -1
    where no int8 row kernel is instantiated."""
    return build.entry("local_rows", "pyfft_local_rows_i8_stage", [_I] * 2)


def matrix_factor(factors) -> int:
    """The f of a chain's matrix stage, the one the int8 stage replaces:
    its last factor where that is not a radix 2, 4 or 8, else 0 (no
    matrix stage, as at n = 8).  The row and column chains hold at most
    one matrix factor, last."""
    assert all(f in VPU_RADICES for f in factors[:-1]), factors
    return 0 if factors[-1] in VPU_RADICES else factors[-1]


def _prepare_rows(re, im, out_re, out_im, sign: int, postscale: float,
                  i8_f: int = 0):
    """The launch of csrc/local_rows.cu over (..., n) planes: K1 (K11 on
    float64 planes), or with ``i8_f`` K1 whose last stage is the f-point
    int8 stage K10; None where there are no rows.  It counts
    ``launch.K1.ring`` (``K11``) where the entry returns RAN_RING, else
    ``.first``, or ``launch.K1+K10``.  The range of n is ``supported``'s
    check, made by ``fft_axis``."""
    n = re.shape[-1]
    planes = (re, im, out_re, out_im)
    _check_planes("row", re, planes)
    for t in planes:
        if t.shape != re.shape:
            raise ValueError("row kernel planes differ in shape")
        if t.stride(-1) not in (1, 2):
            raise ValueError("row kernel needs the transform axis contiguous "
                             f"(element stride 1 or 2), got {t.stride(-1)}")
    rows = re.numel() // n
    if rows == 0:
        return None
    r2, i2, or2, oi2 = (_rows_view(t, n, w) for t, w in
                        zip(planes, ("re", "im", "out_re", "out_im")))
    if r2.stride() != i2.stride() or or2.stride() != oi2.stride():
        raise ValueError("row kernel needs equal strides for re and im")
    if max(rows, *r2.stride(), *or2.stride()) >= 2 ** 31:
        raise ValueError("row kernel strides and row count must fit int32")
    if i8_f and re.dtype != torch.float32:
        raise ValueError("the int8 stage takes float32 planes")
    tw = _kernel_twiddles(n, sign, re.device, re.dtype)
    ptrs = (r2.data_ptr(), i2.data_ptr(), or2.data_ptr(), oi2.data_ptr(),
            tw.data_ptr())
    args = (rows, ilog2(n), r2.stride(1), r2.stride(0), or2.stride(1),
            or2.stride(0), int(sign), float(postscale))
    if i8_f:
        w = w_tables(i8_f, sign, re.device)
        return Launch(_rows_i8_fn(), (*ptrs, w.data_ptr(), *args[:2],
                                      ilog2(i8_f), *args[2:]),
                      (0, 1, 2, 3), "pyfft.entry.K1+K10",
                      {0: "launch.K1+K10"}, "local_rows_i8", (tw, w))
    k = "K11" if re.dtype == torch.float64 else "K1"
    return Launch(_rows_fn(re.dtype), (*ptrs, *args), (0, 1, 2, 3),
                  f"pyfft.entry.{k}", {RAN_RING: f"launch.{k}.ring",
                                       0: f"launch.{k}.first"},
                  "local_rows", (tw,))


def _launch_rows(re, im, out_re, out_im, sign: int, postscale: float,
                 i8_f: int = 0):
    """Launch ``_prepare_rows``'s kernel; no synchronise."""
    run(_prepare_rows(re, im, out_re, out_im, sign, postscale, i8_f),
        re.device)
    return out_re, out_im


ROWS_RING_KEYS = ("rows", "threads", "slots", "smem_bytes", "blocks_per_sm")


@functools.lru_cache(maxsize=None)
def rows_ring_shape(n: int,
                    dtype: torch.dtype = torch.float32) -> dict | None:
    """The row ring's shape at length n for planes of ``dtype``
    (csrc/local_rows.cu ``PYFFT_ROWS_RING``, ``PYFFT_ROWS_RING_F64``),
    which K1 and K2 (K11 on float64) run on inputs a bulk copy reads
    (``ring_rows_operands`` there): ``rows`` a slot, ``threads`` a block,
    ``slots`` of the ring, a block's ``smem_bytes`` and the
    ``blocks_per_sm`` the current card holds (asked of it); None where the
    length runs the first design (local_rows_kernel).  Builds the library on first use."""
    return build.query("local_rows", "pyfft_local_rows_ring_shape"
                       + ("_f64" if dtype == torch.float64 else ""),
                       ROWS_RING_KEYS, ilog2(n))


# ------------------------------------------------- interleaved row path


def fft_rows_interleaved_plain(v, sign, postscale: float = 1.0,
                               factors=None, packed: bool = False,
                               precision: str = "highest"):
    """The plain torch version of K2 on any device: the DFT of the complex
    rows of a (..., 2n) float32 interleaved view, times ``postscale``.

    Not packed: the two stride-2 planes through ``fft_rows_plain``, then
    stacked back into pairs.  Packed: ``tile_fft_packed`` on the (2n, rows)
    transposed view, as the JAX kernel's packed branch.  The chain defaults
    to ``default_factors(n)``, as JAX's ``fft_rows_interleaved`` does.

    ``precision="int8"`` (K2 + K10's plain version) runs the chain's matrix
    stage as the int8-split stage, the rows zero-padded to 128-row tiles,
    each tile one alignment group, as the JAX kernel's blocks.  The packed
    form takes no int8 (JAX's ``tile_fft_packed`` has no int8 path) and
    raises.
    """
    _il_int8(precision, v.dtype, packed)
    n = v.shape[-1] // 2
    factors = tuple(factors or default_factors(n))
    v2 = v.reshape(-1, 2 * n)
    if packed:
        tables = _device_tables_packed(n, sign, factors, v.device)
        x = tile_fft_packed(v2.T, tables, n, factors, sign)
        if postscale != 1.0:
            x = x * postscale
        return x.T.contiguous().reshape(v.shape)
    xr, xi = fft_rows_plain(v2[:, 0::2], v2[:, 1::2], sign, postscale,
                            factors, precision)
    return torch.stack([xr, xi], dim=-1).reshape(v.shape)


@functools.lru_cache(maxsize=None)
def _rows_il_fn():
    """The C entry point ``pyfft_local_rows_il`` of csrc/local_rows.cu,
    built at first use."""
    return build.entry("local_rows", "pyfft_local_rows_il",
                       [_P] * 3 + [_I] * 5 + [ctypes.c_float, _P])


@functools.lru_cache(maxsize=None)
def _rows_il_i8_fn():
    """The C entry point ``pyfft_local_rows_il_i8`` of csrc/local_rows.cu
    (K2 with the int8 stage K10), built at first use."""
    return build.entry("local_rows", "pyfft_local_rows_il_i8",
                       [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P])


def _il_rows(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A (..., 2n) float32 view -> its (rows, 2n) view, checked for K2:
    unit element stride, even row stride and an 8-byte aligned start, so
    that every point is one aligned float2."""
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: K2 takes float32 interleaved views of "
                         f"complex64, got {t.dtype}")
    if tuple(t.shape[-1:]) != (2 * n,):
        raise ValueError(f"{what}: last axis {tuple(t.shape)}, expected "
                         f"{2 * n}")
    t2 = _rows_view(t, 2 * n, what)
    if t2.stride(1) != 1 or (t2.shape[0] > 1 and t2.stride(0) % 2):
        raise ValueError(f"{what}: K2 needs contiguous pairs and an even row "
                         f"stride, got strides {t2.stride()}")
    if t2.data_ptr() % 8:
        raise ValueError(f"{what}: K2 needs an 8-byte aligned view (a float "
                         f"view at an odd offset is not), got address "
                         f"{t2.data_ptr():#x}")
    return t2


def _il_n(v) -> int:
    """The complex points a row of the (..., 2n) view ``v``, or raise where
    K2 does not take them."""
    n = v.shape[-1] // 2
    if not (v.shape[-1] % 2 == 0 and is_power_of_two(n)
            and MIN_LOCAL_N <= n <= MAX_LOCAL_N):
        raise ValueError(f"K2 takes n = 2^k in [{MIN_LOCAL_N}, "
                         f"{MAX_LOCAL_N}] complex points a row, got a last "
                         f"axis of {v.shape[-1]}")
    return n


def _il_int8(precision: str, dtype: torch.dtype, packed: bool) -> bool:
    """Whether K2 runs the int8 stage; raise where it does not take
    ``precision``.  The packed form has none, as in JAX, whose
    ``tile_fft_packed`` looks ``precision`` up in a map without "int8"."""
    int8 = _check_precision(precision, dtype)
    if int8 and packed:
        raise ValueError("precision='int8' does not run the packed form, as "
                         "in the JAX package")
    return int8


def _prepare_rows_il(v, out, sign: int, postscale: float, i8_f: int = 0):
    """The launch of K2 (``pyfft_local_rows_il``) from the (..., 2n) view
    ``v`` into ``out``, or with ``i8_f`` of K2 whose last stage is the
    f-point int8 stage K10 (``pyfft_local_rows_il_i8``); None where there
    are no rows.  Every check raises here, before the launch."""
    n = _il_n(v)
    if tuple(out.shape) != tuple(v.shape):
        raise ValueError(f"K2 output of shape {tuple(out.shape)}, expected "
                         f"{tuple(v.shape)}")
    v2, o2 = _il_rows(v, n, "input"), _il_rows(out, n, "out")
    rows = v2.shape[0]
    if max(rows, v2.stride(0) // 2, o2.stride(0) // 2) >= 2 ** 31:
        raise ValueError("K2 row count and row strides must fit int32")
    if _shares_memory(v, out) and (o2.data_ptr() != v2.data_ptr()
                                   or o2.stride() != v2.stride()):
        raise ValueError("K2 output overlaps its input; only the very same "
                         "view may be written in place")
    if not v.is_cuda or out.device != v.device:
        raise ValueError(f"K2 takes views on one CUDA device, got {v.device} "
                         f"and {out.device}")
    if rows == 0:
        return None
    tw = _kernel_twiddles(n, sign, v.device)
    args = (rows, ilog2(n), v2.stride(0) // 2, o2.stride(0) // 2, int(sign),
            float(postscale))
    if i8_f:
        w = w_tables(i8_f, sign, v.device)
        return Launch(_rows_il_i8_fn(), (v2.data_ptr(), o2.data_ptr(),
                                         tw.data_ptr(), w.data_ptr(),
                                         *args[:2], ilog2(i8_f), *args[2:]),
                      (0, 1), "pyfft.entry.K2+K10", {0: "launch.K2+K10"},
                      "local_rows_il_i8", (tw, w))
    return Launch(_rows_il_fn(), (v2.data_ptr(), o2.data_ptr(),
                                  tw.data_ptr(), *args),
                  (0, 1), "pyfft.entry.K2", {RAN_RING: "launch.K2.ring",
                                             0: "launch.K2.first"},
                  "local_rows_il", (tw,))


def _launch_rows_il(v, out, sign: int, postscale: float, i8_f: int = 0):
    """Launch ``_prepare_rows_il``'s kernel; no synchronise."""
    run(_prepare_rows_il(v, out, sign, postscale, i8_f), v.device)
    return out


def fft_rows_interleaved(v, sign, *, postscale: float = 1.0, factors=None,
                         packed: bool | None = None,
                         precision: str = "highest", out=None):
    """DFT of the complex rows of ``v``, a (..., 2n) float32 view of
    interleaved complex64: pallas_local.fft_rows_interleaved, and with
    ``precision`` its private ``_fft_rows_interleaved(precision=)``, which
    the public function stands for too.

    A CUDA tensor runs K2, one device-memory round trip with ``postscale``
    folded into the store; ``packed`` and ``factors`` change nothing
    there (K3 is the same function on the same memory).  A CPU tensor runs
    the plain version with ``factors`` (default ``default_factors(n)``) and
    ``packed`` (default ``PACKED_INTERLEAVED``).  ``out`` names the
    (..., 2n) tensor to write; ``out=v`` runs in place (JAX's
    ``alias_io``).  Raises where K2 does not apply; nothing falls back.

    ``precision="int8"`` runs the chain's matrix stage as the int8-split
    stage K10, f the last factor of ``default_factors(n)`` (128 at n =
    2048): on the card K2 + K10, whose alignment group is its thread
    block's rows, inside one of JAX's 128-row tiles; on the CPU those
    tiles.  At n = 8 the chain has no matrix stage and K2 runs unchanged.
    The packed form takes no int8 and raises, as in JAX.
    """
    if packed is None:
        packed = PACKED_INTERLEAVED
    int8 = _il_int8(precision, v.dtype, packed)
    if v.is_cuda:
        n = _il_n(v)
        i8_f = matrix_factor(default_factors(n)) if int8 else 0
        if out is None:
            out = torch.empty_like(v, memory_format=torch.contiguous_format)
        return _launch_rows_il(v, out, sign, postscale, i8_f)
    if v.device.type != "cpu":
        raise ValueError(f"no interleaved FFT for device {v.device}")
    _il_n(v)
    y = fft_rows_interleaved_plain(v, sign, postscale, factors, packed,
                                   precision)
    if out is None:
        return y
    out.copy_(y)
    return out


# ------------------------------------------------- digit-swapped row pass


def _swap_n(re, lanes: int) -> tuple[int, int]:
    """(n1, n) of the (..., n1, n) float32 planes K4 takes, or raise: n a
    power of two in [MIN_LOCAL_N, MAX_LOCAL_N], n1 a multiple of
    ``lanes`` (pallas_local._fft_rows_swap's assertion)."""
    if re.dtype != torch.float32 or re.ndim < 2:
        raise ValueError(f"fft_rows_swap takes float32 planes of at least "
                         f"two axes, got {re.dtype} of shape "
                         f"{tuple(re.shape)}")
    n1, n = re.shape[-2:]
    if not (is_power_of_two(n) and MIN_LOCAL_N <= n <= MAX_LOCAL_N):
        raise ValueError(f"fft_rows_swap takes rows of n = 2^k in "
                         f"[{MIN_LOCAL_N}, {MAX_LOCAL_N}] points, got {n}")
    if lanes < 1 or n1 % lanes:
        raise ValueError(f"fft_rows_swap needs a row count that is a "
                         f"multiple of lanes={lanes}, got {n1}")
    return n1, n


def fft_rows_swap_plain(re, im, sign, postscale: float = 1.0, factors=None,
                        precision: str = "highest", lanes: int = MIN_TRAIL):
    """The plain torch version of K4, on any device: the DFT along the
    last axis of (..., n1, n) float32 planes, times ``postscale``, stored
    with the last two axes exchanged, (..., n, n1).  As
    pallas_local._fft_rows_swap: ``tile_fft`` with ``default_factors(n)``
    (not ``row_factors``), then the postscale, then the swap.  Under
    ``precision="int8"`` each block of ``lanes`` consecutive rows (of the
    flattened leading axes and n1) is one alignment group, as JAX's row
    blocks."""
    n = re.shape[-1]
    factors = tuple(factors or default_factors(n))
    xr, xi = fft_rows_plain(re, im, sign, postscale, factors, precision,
                            lanes)
    return (xr.transpose(-1, -2).contiguous(),
            xi.transpose(-1, -2).contiguous())


@functools.lru_cache(maxsize=None)
def _rows_swap_fn():
    """The C entry point ``pyfft_local_rows_swap`` of csrc/local_cols.cu
    (K4 is a load policy of the column kernel), built at first use."""
    return build.entry("local_cols", "pyfft_local_rows_swap",
                       [_P] * 5 + [_DIMS] + [_I] * 2 + [ctypes.c_float, _P])


@functools.lru_cache(maxsize=None)
def swap_tile(n: int) -> tuple[int, int] | None:
    """(G, R) of K4's cluster tile at length n (csrc/local_cols.cu
    ``PYFFT_SWAP_X``): R consecutive rows split over a cluster of G blocks,
    n/G points of each row a block; None where one block of the column
    kernel's row policy takes ``col_width(n)`` rows (n < 512).  Builds
    the library on first use (no CUDA call)."""
    got = build.query("local_cols", "pyfft_local_rows_swap_shape",
                      ("G", "R"), ilog2(n))
    return None if got is None else tuple(got.values())


@functools.lru_cache(maxsize=None)
def _rows_swap_i8_fn():
    """The C entry point ``pyfft_local_rows_swap_i8`` of csrc/local_cols.cu
    (K4 with the int8 stage K10: the int8 column kernel with K4's row
    load), built at first use; its arguments are ``pyfft_local_cols_i8``'s."""
    return build.entry("local_cols", "pyfft_local_rows_swap_i8",
                       [_P] * 8 + [_DIMS] + [_I] * 3
                       + [ctypes.c_float, _I, _I, _P])


def swap_i8_group(n: int, lanes: int) -> int:
    """The rows of one alignment group of K4 + K10 at length n: the block's
    ``col_width_i8(n)`` rows where they divide ``lanes``, else
    gcd(block, lanes), so that every group lies inside one of JAX's groups
    of ``lanes`` rows."""
    return math.gcd(col_width_i8(n), lanes)


def _prepare_rows_swap(re, im, out_re, out_im, sign: int, postscale: float,
                       i8_f: int = 0, lanes: int = MIN_TRAIL):
    """The launch of K4 from the (L, n1, n) view of the planes into the
    (L, n, n1) view of the outputs, or with ``i8_f`` of K4 whose last
    stage is the f-point int8 stage K10, its alignment groups of
    ``swap_i8_group(n, lanes)`` rows; None where there are no rows.  From
    n = 512 the input planes are ``_box_operands``'s, a contiguous copy of
    a layout the tensor maps do not read.  The caller (``fft_rows_swap``)
    has checked n and n1."""
    shape = tuple(re.shape)
    n1, n = shape[-2:]
    L = math.prod(shape[:-2])
    oshape = shape[:-2] + (n, n1)
    for t, want in ((re, shape), (im, shape), (out_re, oshape),
                    (out_im, oshape)):
        if (not t.is_cuda or t.device != re.device
                or t.dtype != torch.float32):
            raise ValueError(f"K4 takes float32 planes on one CUDA device, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != want:
            raise ValueError(f"K4 plane of shape {tuple(t.shape)}, expected "
                             f"{want}")
    for src in (re, im):
        for dst in (out_re, out_im):
            if _shares_memory(src, dst):
                raise ValueError("K4 runs out of place only: its output "
                                 "shares memory with its input")
    if L * n1 == 0:
        return None
    r3, i3 = _view(re, (L, n1, n), "re"), _view(im, (L, n1, n), "im")
    o3 = [_view(t, (L, n, n1), w) for t, w in ((out_re, "out_re"),
                                               (out_im, "out_im"))]
    if r3.stride() != i3.stride() or o3[0].stride() != o3[1].stride():
        raise ValueError("K4 needs equal strides for re and im")
    xtile = None if i8_f else swap_tile(n)
    copies = ()
    if xtile:                       # a cluster of G blocks a tile of R rows
        boxed = _box_operands(r3, i3)
        copies = () if boxed[0] is r3 else boxed
        r3, i3 = boxed
        blocks = -(-n1 // xtile[1]) * L * xtile[0]
    else:
        blocks = -(-n1 // (col_width_i8(n) if i8_f else col_width(n))) * L
    if max(n1, blocks) >= 2 ** 31:
        raise ValueError("K4 row count and block count must fit int32")
    ls, rs, js = r3.stride()
    ols, oks, ors = o3[0].stride()
    # the column kernel's dims with t = the row: input strides (l, j, row),
    # output strides (l, k, 0, row), no mid swap, no twiddle
    dims = (ctypes.c_longlong * 16)(L, n1, ls, js, rs, ols, oks, 0, ors,
                                    1 << 62, 0, 0, 1, 0, 0, 0)
    tw = _kernel_twiddles(n, sign, re.device)
    ptrs = (r3.data_ptr(), i3.data_ptr(), o3[0].data_ptr(), o3[1].data_ptr(),
            tw.data_ptr())
    if i8_f:
        # K4 + K10: the int8 column kernel with K4's row load
        w = w_tables(i8_f, sign, re.device)
        return Launch(_rows_swap_i8_fn(), (*ptrs, None, None, w.data_ptr(),
                                           dims, ilog2(n), ilog2(i8_f),
                                           int(sign), float(postscale), 0,
                                           swap_i8_group(n, lanes)),
                      (0, 1, 2, 3), "pyfft.entry.K4+K10",
                      {0: "launch.K4+K10"}, "local_rows_swap_i8", (tw, w))
    return Launch(_rows_swap_fn(), (*ptrs, dims, ilog2(n), int(sign),
                                    float(postscale)),
                  (0, 1, 2, 3), "pyfft.entry.K4", {0: "launch.K4"},
                  "local_rows_swap", (tw, *copies))


def _launch_rows_swap(re, im, out_re, out_im, sign: int, postscale: float,
                      i8_f: int = 0, lanes: int = MIN_TRAIL):
    """Launch ``_prepare_rows_swap``'s kernel; no synchronise."""
    run(_prepare_rows_swap(re, im, out_re, out_im, sign, postscale, i8_f,
                           lanes), re.device)
    return out_re, out_im


def fft_rows_swap(re, im, sign, *, postscale: float = 1.0, factors=None,
                  lanes: int = MIN_TRAIL, precision: str = "highest",
                  out=None):
    """Row DFT with a digit-swapped store (pallas_local.fft_rows_swap):
    (..., n1, n) float32 planes -> (..., n, n1), ``out[..., k, r] =
    postscale * sum_j x[..., r, j] * w_n^(sign*j*k)``, the second pass of
    the four-step "variant B" (a column pass with the ``full`` twiddle and
    a plain store, then this).

    A CUDA tensor runs K4 (``csrc/local_cols.cu``: below n = 512 the
    column kernel's row-load policy, from n = 512 a cluster a tile of
    rows, ``swap_tile``, whose box copies read planar planes or the complex
    form's stride-2 planes, 16-byte aligned, and take a contiguous copy of
    input planes of any other layout), which ignores ``factors``; a CPU
    tensor runs ``fft_rows_swap_plain`` with ``factors`` (default
    ``default_factors(n)``).  ``n1`` must be a
    multiple of ``lanes`` (JAX's row block; on the card it is only this
    check).  ``out=(re, im)`` names the (..., n, n1) planes to write, which
    may not overlap the input: K4 runs out of place only, as in JAX.
    Without it, new planes are allocated with the input's layout.  Raises
    where K4 does not apply; nothing falls back.

    ``precision="int8"`` runs the chain's matrix stage as the int8-split
    stage K10, f the last factor of ``default_factors(n)`` (128 at n =
    2048): on the card K4 + K10, a block of ``col_width_i8(n)`` rows whose
    alignment groups are runs of ``swap_i8_group(n, lanes)`` rows, each
    inside one of JAX's ``lanes``-row groups (the same groups wherever
    ``lanes`` divides the block's rows or the block divides ``lanes``); on
    the CPU JAX's groups of ``lanes`` rows.  At n = 8 the chain has no
    matrix stage and K4 runs unchanged.
    """
    int8 = _check_precision(precision, re.dtype)
    n1, n = _swap_n(re, lanes)
    oshape = tuple(re.shape[:-2]) + (n, n1)
    if out is not None and any(_shares_memory(a, b) for a in (re, im)
                               for b in out):
        raise ValueError("fft_rows_swap runs out of place only: out shares "
                         "memory with the input")
    if re.is_cuda:
        i8_f = matrix_factor(default_factors(n)) if int8 else 0
        if out is None:
            out = _empty_like_planes(re, im, oshape)
        return _launch_rows_swap(re, im, out[0], out[1], sign, postscale,
                                 i8_f, lanes)
    if re.device.type != "cpu":
        raise ValueError(f"no fft_rows_swap for device {re.device}")
    rr, ii = fft_rows_swap_plain(re, im, sign, postscale, factors, precision,
                                 lanes)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out


# ------------------------------------------------------------- column path

def _check_col_modes(T: int, tw_n: int, tw_mode: str, tw_period: int,
                     swap_store: bool, swap_mid: int) -> None:
    """The twiddle and store modes a column pass over a trail of T takes
    (the assertions of pallas_local._fft_cols_inner, as ValueErrors)."""
    if swap_store and swap_mid:
        raise ValueError("swap_store and swap_mid exclude each other")
    if swap_mid and (swap_mid % MIN_TRAIL or T % swap_mid):
        raise ValueError(f"swap_mid={swap_mid} must be a multiple of "
                         f"{MIN_TRAIL} dividing the trail {T}")
    if not tw_n:
        return
    if tw_mode == "strided":
        if not tw_period or tw_period % MIN_TRAIL or T % tw_period:
            raise ValueError(f"tw_period={tw_period} must be a multiple of "
                             f"{MIN_TRAIL} dividing the trail {T}")
    elif tw_mode == "factored":
        if T % MIN_TRAIL:
            raise ValueError(f"factored twiddle needs a trail that is a "
                             f"multiple of {MIN_TRAIL}, got {T}")
    elif tw_mode != "full":
        raise ValueError(f"unknown tw_mode {tw_mode!r}")


def clamp_ctile(T: int, ctile: int, *, tw_n: int = 0, tw_mode: str = "full",
                swap_store: bool = False, swap_mid: int = 0) -> int:
    """The tiles a K6 step takes over a trail of T, or raise: ``ctile``
    halved until it divides T // MIN_TRAIL (pallas_local._fft_cols_ctile),
    with JAX's assertions as ValueErrors: a plain store only, no twiddle or
    the ``full`` one, T a multiple of MIN_TRAIL."""
    if ctile < 1:
        raise ValueError(f"ctile must be a positive tile count, got {ctile}")
    if swap_store or swap_mid:
        raise ValueError("ctile runs the plain store only, not swap_store "
                         "or swap_mid")
    if tw_n and tw_mode != "full":
        raise ValueError(f"ctile takes no twiddle or the full one, not "
                         f"{tw_mode!r}")
    if T % MIN_TRAIL:
        raise ValueError(f"ctile needs a trail that is a multiple of "
                         f"{MIN_TRAIL}, got {T}")
    tiles = T // MIN_TRAIL
    while ctile > 1 and tiles % ctile:
        ctile //= 2
    return ctile


def _col_out_shape(shape: tuple, axis: int, swap_store: bool,
                   swap_mid: int) -> tuple:
    """pallas_local.fft_axis's column output shapes."""
    n = shape[axis]
    if swap_store:
        return shape[:axis] + shape[axis + 1:] + (n,)
    if swap_mid:
        trail = math.prod(shape[axis + 1:])
        return shape[:axis] + (trail // swap_mid, n, swap_mid)
    return shape


@functools.lru_cache(maxsize=64)
def _plain_twiddle(n: int, T: int, tw_n: int, tw_mode: str, tw_period: int,
                   sign: int, device: torch.device,
                   dtype: torch.dtype = torch.float32):
    """The (n, T) twiddle planes of a column pass in ``dtype``, computed as
    the JAX kernel computes them: from the same tables, the factored
    product taken in float32 (float64 for the complex128 pass, whose JAX
    kernel takes it in double-float)."""
    np_dtype = _NP_REAL[dtype]
    if tw_mode == "full":
        tr, ti = twiddle_table(n, T, tw_n, sign, np_dtype)
    elif tw_mode == "strided":
        ar, ai = twiddle_table_strided(n, T // tw_period, tw_n, sign, 1,
                                       np_dtype)
        q = np.arange(T) // tw_period
        tr, ti = ar[:, q], ai[:, q]
    else:
        ar, ai = twiddle_table_strided(n, T // MIN_TRAIL, tw_n, sign,
                                       MIN_TRAIL, np_dtype)
        br, bi = twiddle_table(n, MIN_TRAIL, tw_n, sign, np_dtype)
        q = np.arange(T) // MIN_TRAIL
        r = np.arange(T) % MIN_TRAIL
        ar, ai, br, bi = ar[:, q], ai[:, q], br[:, r], bi[:, r]
        tr, ti = ar * br - ai * bi, ar * bi + ai * br
    return (torch.from_numpy(np.ascontiguousarray(tr)).to(device),
            torch.from_numpy(np.ascontiguousarray(ti)).to(device))


def fft_cols_plain(re, im, sign, *, postscale: float = 1.0, factors=None,
                   tw_n: int = 0, tw_mode: str = "full", tw_period: int = 0,
                   swap_store: bool = False, swap_mid: int = 0,
                   precision: str = "highest", lanes: int = 0):
    """The plain torch version of the column kernel, on any device.

    The DFT over axis 1 of (L, n, T) planes, then the mode's twiddle,
    ``postscale`` and store, as pallas_local._col_kernel (float32) and
    pallas_df64._col_kernel_df64 (float64) apply them.  The DFT step is
    ``tile_fft`` over axis 0 of the (n, L*T) view for float32 planes
    (default chain ``col_factors(n)``), ``fft_planar`` along axis 1 in
    float64 for float64 planes (``factors`` unused).  Returns (L, n, T)
    planes, (L, T, n) with ``swap_store``, or (L, T // P, n, P) with
    ``swap_mid=P``.

    Under ``precision="int8"`` (float32 only) each l's trail is cut into
    the JAX kernel's blocks, each one alignment group of the int8 stage:
    tiles of ``lanes`` columns where given (the fold kernel's slices,
    ``fold_lanes``), else 256-column tiles where n <= 512, T % 256 == 0 and
    there is no twiddle or swapped store (pallas_local.fft_axis widens its
    lane tile so), else 128-column tiles, the trail zero-padded to whole
    tiles.
    """
    L, n, T = re.shape
    _check_col_modes(T, tw_n, tw_mode, tw_period, swap_store, swap_mid)
    _check_precision(precision, re.dtype)
    if re.dtype == torch.float64:
        xr, xi = fft_planar(re, im, sign, axis=1)
    elif precision == "int8":
        factors = tuple(factors or col_factors(n))
        if not lanes:
            lanes = MIN_TRAIL
            if (n <= 512 and T % 256 == 0 and not tw_n and not swap_store
                    and not swap_mid):
                lanes = 256
        pad = (-T) % lanes
        g = (T + pad) // lanes
        tiles = [torch.nn.functional.pad(t, (0, pad))
                 .reshape(L, n, g, lanes).transpose(0, 1)
                 .reshape(n, L * g, lanes) for t in (re, im)]
        xr, xi = (t.reshape(n, L, g * lanes)[..., :T].transpose(0, 1)
                  for t in _tiles_int8(*tiles, n, sign, factors))
    else:
        factors = tuple(factors or col_factors(n))
        tables = _device_tables(n, sign, factors, re.device)
        xr, xi = tile_fft(re.transpose(0, 1).reshape(n, L * T),
                          im.transpose(0, 1).reshape(n, L * T), tables, n,
                          factors, sign=sign)
        xr = xr.reshape(n, L, T).transpose(0, 1)
        xi = xi.reshape(n, L, T).transpose(0, 1)
    if tw_n:
        twr, twi = _plain_twiddle(n, T, tw_n, tw_mode, tw_period, sign,
                                  re.device, re.dtype)
        xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
    if postscale != 1.0:
        xr, xi = xr * postscale, xi * postscale
    if swap_store:
        xr, xi = xr.transpose(1, 2), xi.transpose(1, 2)
    elif swap_mid:
        xr = xr.reshape(L, n, T // swap_mid, swap_mid).transpose(1, 2)
        xi = xi.reshape(L, n, T // swap_mid, swap_mid).transpose(1, 2)
    return xr.contiguous(), xi.contiguous()


def _pairs(tr: np.ndarray, ti: np.ndarray, device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """float64 (re, im) planes -> one contiguous (..., 2) tensor of
    ``dtype``, rounded once for float32: the kernel reads each entry as a
    float2 (double2) at a flat offset.  (Stacking transposed planes keeps
    their memory order, which ``from_numpy`` and ``to`` would carry over,
    hence the explicit C-order copy.)"""
    pairs = np.ascontiguousarray(np.stack([tr, ti], axis=-1),
                                 dtype=_NP_REAL[dtype])
    return torch.from_numpy(pairs).to(device)


@functools.lru_cache(maxsize=16)
def _kernel_col_tables(n: int, T: int, tw_n: int, tw_mode: str,
                       tw_period: int, sign: int, k_fast: bool,
                       device: torch.device,
                       dtype: torch.dtype = torch.float32):
    """The column kernel's twiddle tables in ``dtype`` and their strides in
    (re, im) pairs: (ta, tb, ak, aq, adiv, bk, bq).  Each is laid out along
    the axis the store pass reads fastest (k with ``k_fast``, else t); the
    strided and factored column streams are read once per block, so they
    are always k-major."""
    f64 = np.float64

    def pairs(tr, ti):
        return _pairs(tr, ti, device, dtype)

    if tw_mode == "full":
        if k_fast:      # (T, n): the same values, w^(t*k)
            ta = pairs(*twiddle_table(T, n, tw_n, sign, f64))
            return ta, None, 1, n, 1, 0, 0
        ta = pairs(*twiddle_table(n, T, tw_n, sign, f64))
        return ta, None, T, 1, 1, 0, 0
    if tw_mode == "strided":
        q = T // tw_period
        ta = pairs(*twiddle_table(q, n, tw_n, sign, f64))
        return ta, None, 1, n, tw_period, 0, 0
    ar, ai = twiddle_table_strided(n, T // MIN_TRAIL, tw_n, sign, MIN_TRAIL,
                                   f64)
    ta = pairs(ar.T, ai.T)                          # (T / 128, n)
    if k_fast:
        tb = pairs(*twiddle_table(MIN_TRAIL, n, tw_n, sign, f64))
        return ta, tb, 1, n, MIN_TRAIL, 1, n
    tb = pairs(*twiddle_table(n, MIN_TRAIL, tw_n, sign, f64))
    return ta, tb, 1, n, MIN_TRAIL, MIN_TRAIL, 1


@functools.lru_cache(maxsize=None)
def _ctile_fn():
    """The C entry point ``pyfft_local_cols_ctile`` of csrc/local_cols.cu
    (K6, the ring of runs over c tiles a step), built at first use."""
    return build.entry("local_cols", "pyfft_local_cols_ctile",
                       [_P] * 7 + [_DIMS] + [_I] * 2
                       + [ctypes.c_float, _I, _P])


RING_SHAPE_KEYS = ("cluster", "columns", "slots", "smem_bytes")


@functools.lru_cache(maxsize=None)
def ring_shape(n: int) -> dict:
    """K6's shape at length n (csrc/local_cols.cu): ``cluster``, the
    blocks of a cluster that split each run of a step (``PYFFT_RING_X``;
    1 where a step's blocks take whole runs), ``columns`` of a run,
    ``slots`` of a block's ring and its ``smem_bytes``.  At n = 1024 a
    grid whose blocks of whole runs would together cover 128 bytes of a
    row takes those instead of the cluster tile.  Builds the library on
    first use (no CUDA call)."""
    got = build.query("local_cols", "pyfft_local_cols_ring_shape",
                      RING_SHAPE_KEYS, ilog2(n))
    if got is None:
        raise ValueError(f"K6 takes no length {n}")
    return got


# The registry's key of a K5 or K12 launch by what its C entry returned:
# K5's persistent ring or K12's persistent cluster ring (RAN_RING), the
# cluster tile (RAN_X), K5's persistent cluster ring (RAN_XRING), the first
# design (0).
_K5_KEYS = {RAN_RING: "launch.K5.pring", RAN_X: "launch.K5.x",
            RAN_XRING: "launch.K5.xring", 0: "launch.K5.first"}
_K12_KEYS = {RAN_RING: "launch.K12.ring", RAN_X: "launch.K12.x",
             0: "launch.K12.first"}
# The lengths K5's persistent ring takes (csrc/local_cols.cu
# PYFFT_COLS_PRING); a test holds them to the source's table.
COL_RING_LENGTHS = (16, 32, 64, 128, 256)
# The lengths K12's persistent cluster ring takes (PYFFT_XRING_F64); a
# test holds them to the source's table.
COL_XRING_F64_LENGTHS = (2048,)
# The lengths K5's persistent cluster ring takes on the complex form's
# pairs (PYFFT_XRING_F32_S2); a test holds them to the source's table.
COL_XRING_F32_S2_LENGTHS = (1024,)


def _boxable(r3: torch.Tensor, i3: torch.Tensor) -> bool:
    """Whether the kernel's tensor maps copy boxes of the (L, m, f) planes
    where they lie: planar (f stride 1) or the complex form's stride-2
    float planes (the imaginary plane one float after the real one),
    16-byte aligned, the m stride (and, for L > 1, the l stride) whole
    16-byte units: a multiple of 4 floats or 2 doubles (csrc/local_cols.cu
    ``ring_operands``, ``swap_operands``, ``xring_operands``)."""
    L = r3.shape[0]
    ls, ms, fs = r3.stride()
    a, b = r3.data_ptr(), i3.data_ptr()
    unit = 16 // r3.element_size()
    planar = fs == 1 and b % 16 == 0
    pairs = fs == 2 and b == a + 4
    return ((planar or pairs) and a % 16 == 0 and ms % unit == 0
            and (L == 1 or ls % unit == 0))


def _box_operands(r3: torch.Tensor, i3: torch.Tensor):
    """The (L, m, f) planes K4 (from n = 512) and K6 read: the planes
    themselves where the tensor maps take them (``_boxable``), else one
    contiguous copy of each, on the device's current stream, where the
    kernel then runs (m is a power of two from 512 for K4, f a multiple of
    128 for K6, so the copies are boxable)."""
    if _boxable(r3, i3):
        return r3, i3
    return (r3.clone(memory_format=torch.contiguous_format),
            i3.clone(memory_format=torch.contiguous_format))


@functools.lru_cache(maxsize=None)
def _cols_lib(dtype: torch.dtype):
    """(launch, width): the typed C entry points of csrc/local_cols.cu for
    planes of ``dtype`` (``pyfft_local_cols[_width]`` for float32, the
    ``_f64`` ones for float64), built at first use."""
    suffix = "_f64" if dtype == torch.float64 else ""
    return (build.entry("local_cols", "pyfft_local_cols" + suffix,
                        [_P] * 7 + [_DIMS] + [_I] * 2
                        + [_c_real(dtype), _I, _P]),
            build.entry("local_cols", "pyfft_local_cols_width" + suffix, [_I]))


def col_width(n: int, dtype: torch.dtype = torch.float32) -> int:
    """The columns (consecutive t) of the tile a block (or a cluster) of
    the column pass for planes of ``dtype`` takes at length n, on planar
    planes with a plain store: the cluster tile's where it takes n, the
    persistent ring's (complex64, n = 16 to 256), else the first
    design's; builds the kernel on first use."""
    return _cols_lib(dtype)[1](ilog2(n))


@functools.lru_cache(maxsize=None)
def _col_xtile(log2n: int, in_ts: int,
               dtype: torch.dtype = torch.float64) -> tuple[int, int] | None:
    """(G, C) of the cluster column kernel's tile for planes of ``dtype``
    at length 2^log2n and t stride ``in_ts``, as its launch takes it
    (``pyfft_local_cols_xtile_f64``, ``pyfft_local_cols_xtile``: no CUDA
    call); None where another design takes the length."""
    got = build.query("local_cols", "pyfft_local_cols_xtile"
                      + ("_f64" if dtype == torch.float64 else ""),
                      ("G", "C"), log2n, in_ts,
                      argtypes=[_I, ctypes.c_longlong])
    return None if got is None else tuple(got.values())


COL_XSHAPE_KEYS = ("cluster", "columns", "blocks_an_sm", "clusters_plain",
                   "clusters_swap")


def col_xshape_f64(n: int, strided: bool = False,
                   dtype: torch.dtype = torch.float64) -> dict | None:
    """The cluster column kernel's shape for planes of ``dtype`` (K12 by
    default, K5 on float32) at length n on planar data (or, with
    ``strided``, on planes whose t stride is not 1, as the complex
    form's): the blocks G of a cluster, the columns C of its tile, the
    blocks an SM its registers leave room for, and the clusters the card
    holds at once with the plain and with the swapped store; None where
    another design takes the length (n <= 512).  Builds the kernel on first
    use."""
    return build.query("local_cols", "pyfft_local_cols_xshape"
                       + ("_f64" if dtype == torch.float64 else ""),
                       COL_XSHAPE_KEYS, ilog2(n), int(bool(strided)),
                       out=ctypes.c_longlong, status=True)


COL_XRING_KEYS = ("cluster", "columns", "slots", "blocks_an_sm", "threads",
                  "smem_bytes", "clusters_held")


@functools.lru_cache(maxsize=None)
def col_xring_shape_f64(n: int) -> dict | None:
    """K12's persistent cluster ring at length n (csrc/local_cols.cu
    ``PYFFT_XRING_F64``), which complex128 column passes run on planar
    planes its tensor maps read (``_boxable``): the blocks of its
    ``cluster``, the ``columns`` of a tile, the ``slots`` of a block's
    ring, the ``blocks_an_sm`` its launch bounds leave registers for,
    ``threads`` and ``smem_bytes`` a block and the clusters the current
    card holds at once (asked of it), the ring's grid; None where the
    ring takes no such length.  Builds the library on first use."""
    return build.query("local_cols", "pyfft_local_cols_xring_shape_f64",
                       COL_XRING_KEYS, ilog2(n))


@functools.lru_cache(maxsize=None)
def col_xring_shape(n: int) -> dict | None:
    """K5's persistent cluster ring at length n (csrc/local_cols.cu
    ``PYFFT_XRING_F32_S2``), which complex64 column passes on the complex
    form's pairs run with K5's persistent ring's modes (``col_design``), as
    ``col_xring_shape_f64`` gives K12's; the clusters held are those of
    its plain store."""
    return build.query("local_cols", "pyfft_local_cols_xring_shape",
                       COL_XRING_KEYS, ilog2(n))


def col_xshape(n: int, strided: bool = False) -> dict | None:
    """K5's cluster tile from n = 1024 (csrc/local_cols.cu
    ``PYFFT_XCOLS_F32``, ``_S2``), as ``col_xshape_f64`` gives K12's."""
    return col_xshape_f64(n, strided, torch.float32)


COL_RING_KEYS = ("columns", "threads", "slots", "smem_bytes",
                 "blocks_per_sm")


@functools.lru_cache(maxsize=None)
def col_ring_shape(n: int) -> dict | None:
    """K5's persistent column ring at length n (csrc/local_cols.cu
    ``PYFFT_COLS_PRING``), which complex64 column passes with a plain
    store and no twiddle or the ``full`` one run on planes its tensor maps
    read (``_boxable``): the ``columns`` of a tile, ``threads`` a block,
    ``slots`` of the ring, a block's ``smem_bytes`` and the
    ``blocks_per_sm`` the current card holds (asked of it); None where the
    ring takes no such length.  Builds the library on first use."""
    return build.query("local_cols", "pyfft_local_cols_pring_shape",
                       COL_RING_KEYS, ilog2(n))


def col_design(n: int, dtype: torch.dtype, *, boxable: bool, in_ts: int,
               tw_mode: str = "", tw_n: int = 0, swap_store: bool = False,
               swap_mid: int = 0, T: int = 0) -> str:
    """Which design the column pass runs (csrc/local_cols.cu
    ``launch_cols``): "ring", K12's persistent cluster ring (float64, the
    lengths of ``COL_XRING_F64_LENGTHS``) on planar planes its tensor maps
    read (``boxable``, t stride ``in_ts`` 1), in every twiddle and store
    mode; "xring", K5's persistent cluster ring (float32, the lengths of
    ``COL_XRING_F32_S2_LENGTHS``) on the complex form's pairs its tensor
    map reads (``boxable``, ``in_ts`` 2) with K5's persistent ring's modes;
    "x", the cluster tile, where its table takes n (K12 from n = 1024 in
    float64, K5 from n = 1024 in float32); "ring", K5's persistent ring
    (float32, n = 16 to 256), on a plain store (no swap, no mid swap
    shorter than the trail ``T``) with no twiddle or the ``full`` one, on
    planes its tensor maps read (``boxable``); else "first", the first
    design (local_cols_kernel).  No CUDA call."""
    if (dtype == torch.float64 and n in COL_XRING_F64_LENGTHS
            and in_ts == 1 and boxable):
        return "ring"
    plain = not swap_store and (not swap_mid or swap_mid >= T)
    ring_modes = plain and (not tw_n or tw_mode == "full") and boxable
    if (dtype == torch.float32 and n in COL_XRING_F32_S2_LENGTHS
            and in_ts == 2 and ring_modes):
        return "xring"
    if _col_xtile(ilog2(n), in_ts, dtype):
        return "x"
    if dtype == torch.float32 and n in COL_RING_LENGTHS and ring_modes:
        return "ring"
    return "first"


@functools.lru_cache(maxsize=None)
def _cols_i8_lib():
    """(launch, width): the C entry points ``pyfft_local_cols_i8`` and
    ``pyfft_local_cols_width_i8`` of csrc/local_cols.cu (K5 with the int8
    stage K10), built at first use."""
    return (build.entry("local_cols", "pyfft_local_cols_i8",
                        [_P] * 8 + [_DIMS] + [_I] * 3
                        + [ctypes.c_float, _I, _P]),
            build.entry("local_cols", "pyfft_local_cols_width_i8", [_I]))


def col_width_i8(n: int) -> int:
    """The columns one block of the int8 column kernel takes at length n
    (half K5's bytes a block: the stage writes a second buffer)."""
    return _cols_i8_lib()[1](ilog2(n))


def _view(t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    try:
        return t.view(shape)
    except RuntimeError as e:
        raise ValueError(f"{what}: cannot view {tuple(t.shape)} with strides "
                         f"{t.stride()} as {shape} without a copy") from e


def _shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


def _col_operands(re, im, out_re, out_im, sign: int, *, axis: int,
                  tw_n: int, tw_mode: str, tw_period: int, swap_store: bool,
                  swap_mid: int):
    """The column kernel's operands over the (L, n, T) view of the planes,
    after the checks of shapes, strides and overlap, on any device: the
    input views (L, n, T), the output views, the 16 ``dims`` of its C entry
    point (see ``pyfft_local_cols``) and the twiddle tables (None where
    unused); None where there is nothing to launch."""
    shape = tuple(re.shape)
    n = shape[axis]
    L = math.prod(shape[:axis])
    T = math.prod(shape[axis + 1:])
    oshape = _col_out_shape(shape, axis, swap_store, swap_mid)
    for t, want in ((re, shape), (im, shape), (out_re, oshape),
                    (out_im, oshape)):
        if tuple(t.shape) != want:
            raise ValueError(f"column kernel plane of shape "
                             f"{tuple(t.shape)}, expected {want}")
    if L * T == 0:
        return None
    r3, i3 = _view(re, (L, n, T), "re"), _view(im, (L, n, T), "im")
    if swap_store:
        o = [_view(t, (L, T, n), w) for t, w in ((out_re, "out_re"),
                                                 (out_im, "out_im"))]
        ostr = [(s[0], s[2], 0, s[1]) for s in (x.stride() for x in o)]
        period = 1 << 62
    elif swap_mid:
        P = swap_mid
        o = [_view(t, (L, T // P, n, P), w) for t, w in ((out_re, "out_re"),
                                                         (out_im, "out_im"))]
        ostr = [(s[0], s[2], s[1], s[3]) for s in (x.stride() for x in o)]
        period = P
    else:
        o = [_view(t, (L, n, T), w) for t, w in ((out_re, "out_re"),
                                                 (out_im, "out_im"))]
        ostr = [(s[0], s[1], 0, s[2]) for s in (x.stride() for x in o)]
        period = 1 << 62
    if r3.stride() != i3.stride() or ostr[0] != ostr[1]:
        raise ValueError("column kernel needs equal strides for re and im")
    for src in (re, im):
        for dst, d3 in zip((out_re, out_im), o):
            if not _shares_memory(src, dst):
                continue
            # in place: only a plain store onto the very same elements
            if (swap_store or swap_mid or d3.data_ptr() not in
                    (r3.data_ptr(), i3.data_ptr())
                    or d3.stride() != r3.stride()):
                raise ValueError("column kernel output overlaps its input; "
                                 "only a plain store may run in place")
    ta = tb = None
    ak = aq = adiv = bk = bq = 0
    mode = 0
    if tw_n:
        ta, tb, ak, aq, adiv, bk, bq = _kernel_col_tables(
            n, T, tw_n, tw_mode, tw_period, sign, bool(swap_store),
            re.device, re.dtype)
        mode = 2 if tw_mode == "factored" else 1
        assert all(t is None or t.is_contiguous() for t in (ta, tb))
    dims = (L, T, *r3.stride(), *ostr[0], period, ak, aq, max(adiv, 1), bk,
            bq, mode)
    return r3, i3, o, dims, ta, tb


def _prepare_cols(re, im, out_re, out_im, sign: int, *, axis: int,
                  postscale: float, tw_n: int, tw_mode: str, tw_period: int,
                  swap_store: bool, swap_mid: int, ctile: int = 0,
                  i8_f: int = 0):
    """The launch of csrc/local_cols.cu over the (L, n, T) view of the
    planes: the column kernel, K6 with ``ctile`` tiles a step (already
    clamped, its inputs ``_box_operands``'s), or with ``i8_f`` the column
    kernel whose last stage is the f-point int8 stage K10; None where
    there is nothing to launch.  It counts ``_K5_KEYS``'s or
    ``_K12_KEYS``'s key of the entry's return, ``launch.K6`` or
    ``launch.K5+K10``.  The caller (``fft_axis``) has checked
    ``supported`` and the modes."""
    _check_planes("column", re, (re, im, out_re, out_im))
    ops = _col_operands(re, im, out_re, out_im, sign, axis=axis, tw_n=tw_n,
                        tw_mode=tw_mode, tw_period=tw_period,
                        swap_store=swap_store, swap_mid=swap_mid)
    if ops is None:
        return None
    r3, i3, o, dims, ta, tb = ops
    L, T = dims[:2]
    n = r3.shape[1]
    if i8_f and (re.dtype != torch.float32 or ctile):
        raise ValueError("the int8 stage takes float32 planes and no ctile")
    fn, width = _cols_i8_lib() if i8_f else _cols_lib(re.dtype)
    blocks = -(-T // width(ilog2(n))) * L
    xtile = (None if i8_f or ctile
             else _col_xtile(ilog2(n), dims[4], re.dtype))
    if xtile:                   # a cluster of G blocks a tile of C columns
        blocks = -(-T // xtile[1]) * L * xtile[0]
    if ctile:
        if re.dtype != torch.float32:
            raise ValueError("K6 (ctile) takes float32 planes")
        if T % (MIN_TRAIL * ctile):
            raise ValueError(f"K6 needs a trail that is a multiple of "
                             f"{MIN_TRAIL * ctile}, got {T}")
        boxed = _box_operands(r3, i3)
        copies = () if boxed[0] is r3 else boxed
        r3, i3 = boxed
        dims = (L, T, *r3.stride(), *dims[5:])
        blocks = -(-T // 4) * L     # at most a block a run of 4 columns
    if max(T, blocks) >= 2 ** 31:
        raise ValueError("column kernel trail and block count must fit int32")
    dims = (ctypes.c_longlong * 16)(*dims)
    tw = _kernel_twiddles(n, sign, re.device, re.dtype)
    ptrs = (r3.data_ptr(), i3.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
            tw.data_ptr(), None if ta is None else ta.data_ptr(),
            None if tb is None else tb.data_ptr(), dims, ilog2(n), int(sign),
            float(postscale))
    tables = tuple(t for t in (tw, ta, tb) if t is not None)
    if ctile:
        return Launch(_ctile_fn(), (*ptrs, int(ctile)), (0, 1, 2, 3),
                      "pyfft.entry.K6", {0: "launch.K6"}, "local_cols_ctile",
                      tables + copies)
    if i8_f:
        w = w_tables(i8_f, sign, re.device)
        return Launch(fn, (*ptrs[:7], w.data_ptr(), *ptrs[7:9], ilog2(i8_f),
                           *ptrs[9:], int(bool(swap_store))),
                      (0, 1, 2, 3), "pyfft.entry.K5+K10",
                      {0: "launch.K5+K10"}, "local_cols_i8", tables + (w,))
    f64 = re.dtype == torch.float64
    return Launch(fn, (*ptrs, int(bool(swap_store))), (0, 1, 2, 3),
                  "pyfft.entry.K12" if f64 else "pyfft.entry.K5",
                  _K12_KEYS if f64 else _K5_KEYS, "local_cols", tables)


def _launch_cols(re, im, out_re, out_im, sign: int, *, axis: int,
                 postscale: float, tw_n: int, tw_mode: str, tw_period: int,
                 swap_store: bool, swap_mid: int, ctile: int = 0,
                 i8_f: int = 0):
    """Launch ``_prepare_cols``'s kernel; no synchronise."""
    run(_prepare_cols(re, im, out_re, out_im, sign, axis=axis,
                      postscale=postscale, tw_n=tw_n, tw_mode=tw_mode,
                      tw_period=tw_period, swap_store=swap_store,
                      swap_mid=swap_mid, ctile=ctile, i8_f=i8_f), re.device)
    return out_re, out_im


def fft_axis(re, im, sign, *, axis=-1, postscale: float = 1.0, factors=None,
             tw_n: int = 0, tw_mode: str = "full", tw_period: int = 0,
             swap_store: bool = False, swap_mid: int = 0, ctile: int = 0,
             precision: str = "highest", out=None):
    """DFT along ``axis`` of planar float32 or float64 tensors.

    The last axis goes to the row kernel, any other axis to the column
    kernel on the (lead, n, trail) view (pallas_local.fft_axis).  Column
    passes only: ``tw_n`` fuses a four-step twiddle (``tw_mode`` "full",
    "strided" with ``tw_period``, or "factored"), ``swap_store`` returns
    shape ``(*shape[:axis], *shape[axis+1:], n)`` and ``swap_mid=P``
    returns ``(*shape[:axis], trail // P, n, P)``.  ``ctile=c`` (float32
    column passes with a plain store and no twiddle or the ``full`` one, a
    trail of whole 128-column tiles) runs K6, each of JAX's grid steps of c
    tiles walked by a group or a cluster of blocks through a ring of runs
    (``ring_shape``; its box copies read planar planes or the complex
    form's stride-2 planes, 16-byte aligned, and take a contiguous copy of
    input planes of any other layout, in place too), c clamped to a divisor
    of the tile count
    (``clamp_ctile``); its function is the column kernel's, so a CPU
    tensor takes ``fft_cols_plain``.  (JAX
    also lets ``ctile`` turn off its 256-lane tile for small n; the port
    has no such tile.)

    ``precision="int8"`` (float32 planes, no ``ctile``) runs the chain's
    matrix stage as the int8-split stage K10 (``ops/int8.py``), with JAX's
    alignment groups on the CPU (``fft_rows_plain``, ``fft_cols_plain``)
    and the kernel's thread block as the group on the card: K1 or K5 with
    the stage in place of their last radix-8 stages, f the last factor of
    ``row_factors(n)`` or ``col_factors(n)``.  At n = 8 the chain has no
    matrix stage and int8 changes nothing.  A swapped store with int8
    needs a trail of whole 128-column tiles, as in JAX.  JAX's
    ``"default"`` (one bf16 pass of the TPU's matrix unit) does not carry
    over.

    A CUDA tensor goes to a kernel, which runs its own chain and ignores
    ``factors`` (rows: the row ring, ``rows_ring_shape``, on inputs its
    bulk copies read, else the first design; both read any layout the
    checks take; complex64 columns: the design ``col_design`` names); a
    CPU tensor goes to the plain torch version,
    which runs ``factors`` (default: ``row_factors(n)`` or
    ``col_factors(n)``).  ``out=(re, im)`` names the planes to write, of
    the output's shape; with a plain store they may be the inputs
    themselves (in place).  Without it, new planes are allocated with the
    input's layout.  Raises where the kernel does not apply; nothing falls
    back.
    """
    if not supported(re, axis):
        raise ValueError(f"local FFT does not cover axis {axis} of a "
                         f"{re.dtype} tensor of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no local FFT for device {re.device}")
    int8 = _check_precision(precision, re.dtype, ctile)
    axis = axis % re.ndim
    shape = tuple(re.shape)
    if axis == re.ndim - 1:
        if tw_n or swap_store or swap_mid or ctile:
            raise ValueError("twiddles, swapped stores and ctile are "
                             "column-pass features")
        if re.is_cuda:
            if out is None:
                out = _empty_like_planes(re, im, shape)
            i8_f = matrix_factor(row_factors(shape[-1])) if int8 else 0
            return _launch_rows(re, im, out[0], out[1], sign, postscale,
                                i8_f)
        rr, ii = fft_rows_plain(re, im, sign, postscale, factors, precision)
    else:
        n = shape[axis]
        L, T = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
        _check_col_modes(T, tw_n, tw_mode, tw_period, swap_store, swap_mid)
        if int8 and (swap_store or swap_mid) and T % MIN_TRAIL:
            raise ValueError("int8 precision with swap stores needs a trail "
                             f"of whole {MIN_TRAIL}-column tiles, got {T}")
        oshape = _col_out_shape(shape, axis, swap_store, swap_mid)
        modes = dict(tw_n=tw_n, tw_mode=tw_mode, tw_period=tw_period,
                     swap_store=swap_store, swap_mid=swap_mid)
        if ctile:
            if re.dtype != torch.float32:
                raise ValueError("ctile is a float32 column-pass feature")
            ctile = clamp_ctile(T, ctile, tw_n=tw_n, tw_mode=tw_mode,
                                swap_store=swap_store, swap_mid=swap_mid)
        if re.is_cuda:
            if out is None:
                out = _empty_like_planes(re, im, oshape)
            i8_f = matrix_factor(col_factors(n)) if int8 else 0
            return _launch_cols(re, im, out[0], out[1], sign, axis=axis,
                                postscale=postscale, ctile=ctile, i8_f=i8_f,
                                **modes)
        rr, ii = fft_cols_plain(re.reshape(L, n, T), im.reshape(L, n, T),
                                sign, postscale=postscale, factors=factors,
                                precision=precision, **modes)
        rr, ii = rr.reshape(oshape), ii.reshape(oshape)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out


# ------------------------------------------------ native-layout column pass


def supported_fold(re: torch.Tensor, axis: int) -> bool:
    """Whether the fold-store column pass covers this tensor/axis: the JAX
    package's rule (pallas_local.supported_fold), its TPU caps included,
    so that both packages take the same arrays: float32, n a power of two
    in [MIN_LOCAL_N, MAX_LOCAL_N], at least two trailing axes, the last
    (x_ext) a multiple of MIN_TRAIL of at most 4 * MIN_TRAIL points,
    n * x_ext <= 2^17 (a VMEM cap of the TPU), the other trailing axes a
    multiple of 8 rows, and a trail of at least MIN_TRAIL."""
    if re.dtype != torch.float32 or re.ndim == 0:
        return False
    axis = axis % re.ndim
    n = re.shape[axis]
    if not (is_power_of_two(n) and MIN_LOCAL_N <= n <= MAX_LOCAL_N):
        return False
    trail = tuple(re.shape[axis + 1:])
    if len(trail) < 2:
        return False
    x_ext = trail[-1]
    rows = math.prod(trail[:-1])
    if n * x_ext > 1 << 17:
        return False
    return (x_ext % MIN_TRAIL == 0 and x_ext <= 4 * MIN_TRAIL
            and rows % 8 == 0 and math.prod(trail) >= MIN_TRAIL)


def fold_lanes(n: int, x_ext: int) -> int:
    """The lane slice of the JAX fold kernel, each one alignment group of
    the int8 stage: 256 where n <= 512 and x_ext is a multiple of 256,
    else 128 (pallas_local._fft_cols_fold's xc)."""
    if n <= 512 and x_ext % (2 * MIN_TRAIL) == 0:
        return 2 * MIN_TRAIL
    return min(x_ext, MIN_TRAIL)


def fft_axis_fold(re, im, sign, *, axis, postscale: float = 1.0,
                  factors=None, precision: str = "highest", by: int = 8,
                  out=None):
    """DFT along a non-minor ``axis`` with the output in the input's
    native layout (pallas_local.fft_axis_fold): ``out[..., k, *trail] =
    postscale * sum_j x[..., j, *trail] * w_n^(sign*j*k)``, for the arrays
    ``supported_fold`` takes.

    The JAX kernel reads the folded (lead, n, trail) view and stores the
    native (lead, n, rows, x_ext) one, two tilings of the TPU's memory; on
    row-major memory they are the same bytes.  So a CUDA tensor runs the
    column kernel's plain store over the (L, n, T) view: K5, or under
    ``precision="int8"`` K5 + K10 (f the last factor of ``col_factors(n)``),
    whose alignment group, C <= 128 columns of one l, lies inside one of
    JAX's slices.  A CPU tensor runs ``fft_cols_plain``, under int8 with
    JAX's groups: per l, slices of ``fold_lanes(n, x_ext)`` columns, which
    differ from ``fft_axis``'s where x_ext is 128 or 384 and n <= 512.
    ``by`` (JAX's rows a grid step) must divide the rows and changes
    nothing else.  ``out=(re, im)`` names the planes to write, of the
    input's shape, the inputs themselves allowed (in place).  Raises where
    the pass does not apply; nothing falls back.
    """
    if not supported_fold(re, axis):
        raise ValueError(f"fft_axis_fold does not cover axis {axis} of a "
                         f"{re.dtype} tensor of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fft_axis_fold for device {re.device}")
    int8 = _check_precision(precision, re.dtype)
    axis = axis % re.ndim
    shape = tuple(re.shape)
    n, x_ext = shape[axis], shape[-1]
    L, T = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    if by < 1 or (T // x_ext) % by:
        raise ValueError(f"by={by} must divide the {T // x_ext} rows of the "
                         f"trail")
    if re.is_cuda:
        if out is None:
            out = _empty_like_planes(re, im, shape)
        i8_f = matrix_factor(col_factors(n)) if int8 else 0
        return _launch_cols(re, im, out[0], out[1], sign, axis=axis,
                            postscale=postscale, tw_n=0, tw_mode="full",
                            tw_period=0, swap_store=False, swap_mid=0,
                            i8_f=i8_f)
    rr, ii = fft_cols_plain(re.reshape(L, n, T), im.reshape(L, n, T), sign,
                            postscale=postscale, factors=factors,
                            precision=precision,
                            lanes=fold_lanes(n, x_ext))
    rr, ii = rr.reshape(shape), ii.reshape(shape)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out


def _check_precision(precision: str, dtype: torch.dtype,
                     ctile: int = 0) -> bool:
    """Whether ``precision`` asks for the int8 stage; raise where a local
    FFT does not take it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'highest' or 'int8', got "
                         f"{precision!r}")
    if precision != "int8":
        return False
    if dtype != torch.float32:
        raise ValueError(f"precision='int8' takes float32 planes "
                         f"(complex64), got {dtype}")
    if ctile:
        raise ValueError("precision='int8' does not run with ctile (K6), as "
                         "in the JAX package")
    return True


def _empty_like_planes(re, im, shape):
    """Output planes of ``shape`` in the input's layout: interleaved pairs
    (complex64 for float32 planes, complex128 for float64) when the inputs
    are the two planes of one complex tensor, planar otherwise."""
    if (re.stride(-1) == 2 and im.stride() == re.stride()
            and im.data_ptr() == re.data_ptr() + re.element_size()):
        cplx = (torch.complex128 if re.dtype == torch.float64
                else torch.complex64)
        v = torch.view_as_real(torch.empty(shape, dtype=cplx,
                                           device=re.device))
        return v[..., 0], v[..., 1]
    return (torch.empty(shape, dtype=re.dtype, device=re.device),
            torch.empty(shape, dtype=re.dtype, device=re.device))
