"""The int8-split DFT stage (K10), ``precision="int8"``.

Counterpart of ``pyfft_tpu/ops/pallas_local.py``'s ``_int8_stage``, the
matrix stage of the tile FFT under ``precision="int8"``: one f-point stage
(f the chain's factor that is not a radix 2, 4 or 8) computed as exact
integer products.  For a stage input x = (xr, xi):

1. the alignment exponent ``m = clip(biased_exp(amax) - 126, -40, 120)``,
   ``amax`` the largest |xr|, |xi| of the alignment group (the JAX kernel's
   whole Pallas block);
2. the stacked input [xr; xi] split into 4 int8 channels by progressive
   extraction at shifts ``X_SHIFTS`` (every step exact in float32);
3. the stacked matrix [[Wr, -Wi], [Wi, Wr]] split on the host into 3 int8
   channels at shifts ``W_SHIFTS`` (``int8_chunks_np``);
4. the 9 channel pairs whose shifts sum to at most ``KEEP`` contracted
   exactly, summed by shift (each group's sum stays below 2^24), and the
   groups recombined in float32 in ascending order of shift.

Here live the port's copies of the constants and of ``_int8_chunks_np``,
the plain torch version ``int8_stage``, the shared-memory image of the
channels that the wgmma stage copies (``w_image``) and the device cache of
what the kernels read (``w_tables``: the channels, then the image).  The kernels themselves are ``csrc/int8_stage.cuh``,
a stage inside the row kernels (K1, K2), the column kernel (K5, K4) and the
fused 2D kernels (K8, K9); ``ops/local.py`` and ``ops/fused2d.py`` launch
them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyfft_tpu_torch.ops.twiddle import dft_matrix

__all__ = ["B", "W_SHIFTS", "X_SHIFTS", "KEEP", "int8_chunks_np",
           "stacked_channels", "int8_stage", "w_rows", "w_image",
           "w_tables", "SLAB_ROWS", "PRECISIONS"]

B = 7
W_SHIFTS = tuple(B * (i + 1) for i in range(3))
X_SHIFTS = tuple(B * (i + 1) for i in range(4))
KEEP = 35

# The precisions the local FFTs take: the float path, and the int8 stage.
PRECISIONS = ("highest", "int8")

# Output rows of one slab of W's shared-memory image: one m64 tile of wgmma.
SLAB_ROWS = 64


def int8_chunks_np(x: np.ndarray, shifts) -> tuple[np.ndarray, ...]:
    """Split ``x`` (|x| <= 1) into int8 channels c_i with x ~= sum_i c_i *
    2^-shifts[i], by progressive extraction in float64 (round half even)."""
    out = []
    r = np.asarray(x, np.float64)
    for s in shifts:
        c = np.clip(np.rint(r * 2.0 ** s), -127, 127)
        r = r - c * 2.0 ** (-s)
        out.append(c.astype(np.int8))
    return tuple(out)


def stacked_channels(f: int, sign: int) -> tuple[np.ndarray, ...]:
    """The 3 int8 channels of the stacked f-point DFT matrix
    [[Wr, -Wi], [Wi, Wr]] (2f x 2f): the table ("wi8", f)."""
    wr, wi = dft_matrix(f, sign, np.float64)
    return int8_chunks_np(np.block([[wr, -wi], [wi, wr]]), W_SHIFTS)


def w_rows(f: int) -> np.ndarray:
    """The stacked rows of the matrix in the order of ``w_image``'s slabs:
    row r of slab t is output k = 32t + 8(r // 16) + r % 8, its real part
    (stacked row k) where (r // 8) is even, else its imaginary part
    (stacked row f + k).  So the rows r and r + 8 of each warp's 16 rows of
    a wgmma tile hold both parts of one output."""
    r = np.arange(2 * f)
    t, r = r // SLAB_ROWS, r % SLAB_ROWS
    return ((r >> 3) & 1) * f + 32 * t + (r >> 4) * 8 + (r & 7)


def w_image(f: int, sign: int) -> np.ndarray:
    """The channels of ``stacked_channels(f, sign)`` (f >= 32) as the wgmma
    stage reads them from shared memory: flat int8 bytes in slabs of
    ``SLAB_ROWS`` output rows (the stacked rows ``w_rows(f)``), each slab the
    3 channels of those rows, each channel's rows in wgmma's K-major core
    matrices without swizzle (8 rows of 16 bytes, 128 contiguous bytes),
    the core matrices of 8 rows in order along k, then the next 8 rows.
    Channel c's element (row w_rows(f)[i], column k) lies at byte

        (i // 64) * 3*64*2f + c * 64*2f + ((i % 64) // 8) * 8*2f
            + (k // 16) * 128 + (i % 8) * 16 + k % 16,

    so a slab is 3 * 64 * 2f bytes (48 KB at f = 128) and the image
    3 * (2f)^2, as the channels."""
    k2 = 2 * f
    if k2 % SLAB_ROWS:
        raise ValueError(f"the wgmma stage takes f >= {SLAB_ROWS // 2}, "
                         f"got {f}")
    w = np.stack(stacked_channels(f, sign))[:, w_rows(f)]   # (c, i, k)
    img = w.reshape(3, k2 // SLAB_ROWS, SLAB_ROWS // 8, 8, k2 // 16, 16)
    # (c, slab, i-group, i % 8, k-group, k % 16)
    #   -> (slab, c, i-group, k-group, i % 8, k % 16)
    return np.ascontiguousarray(img.transpose(1, 0, 2, 4, 3, 5)).reshape(-1)


@functools.lru_cache(maxsize=None)
def w_tables(f: int, sign: int, device: torch.device) -> torch.Tensor:
    """What the kernels' int8 stage is handed, on ``device``: the (3, 2f,
    2f) channels of ``stacked_channels(f, sign)`` flat and C-contiguous
    (row k, column r of channel c at byte (c * 2f + k) * 2f + r), followed
    for f >= 32 by ``w_image``, which starts 16-byte aligned (at 12 f^2
    bytes) for the bulk copy.  The mma.sync stage reads the first part, the
    wgmma stage the second."""
    parts = [np.stack(stacked_channels(f, sign)).reshape(-1)]
    if 2 * f >= SLAB_ROWS:
        parts.append(w_image(f, sign))
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _exp2(e: torch.Tensor) -> torch.Tensor:
    """2^e, exactly, for int32 exponents in the normal range."""
    return ((e + 127) << 23).view(torch.float32)


def int8_stage(xr, xi, f: int, axis: int, wch, group_axis: int | None = None):
    """pallas_local._int8_stage in torch: the f-point DFT over ``axis`` of
    float32 planes by exact int8-split products; the output digit lands at
    axis 0, as in ``tile_fft``.

    ``wch`` holds the 3 channels of the stacked matrix (numpy arrays or
    tensors).  The alignment group is the whole tensor (the JAX kernel's
    block), or, with ``group_axis``, each index along that axis: the plain
    versions stack the JAX blocks there.  The channel products are exact
    integers below 2^24 and are taken in float64, which every device
    multiplies (an int8 product in int8 would wrap, and CUDA has no integer
    matrix product), then rounded to float32 without error.
    """
    a = torch.maximum(xr.abs(), xi.abs())
    if group_axis is None:
        amax = a.max()
    else:
        g = group_axis % a.ndim
        amax = a.movedim(g, 0).reshape(a.shape[g], -1).max(dim=1).values
        amax = amax.reshape([-1 if d == g else 1 for d in range(a.ndim)])
    eb = (amax.contiguous().view(torch.int32) >> 23) & 0xFF
    m = torch.clamp(eb - 126, -40, 120)
    xs = torch.cat([xr, xi], dim=axis)
    chans = []
    r = xs
    for s in X_SHIFTS:
        c = torch.clamp(torch.round(r * _exp2(s - m)), -127.0, 127.0)
        r = r - c * _exp2(m - s)
        chans.append((c.to(torch.float64), s))
    ws = [torch.as_tensor(w, device=xr.device).to(torch.float64)
          for w in wch]
    groups: dict = {}
    for wi, wsh in enumerate(W_SHIFTS):
        for cx, sx in chans:
            if wsh + sx <= KEEP:
                groups.setdefault(wsh + sx, []).append((wi, cx))
    acc = None
    for s in sorted(groups):
        g = None
        for wi, cx in groups[s]:
            y = torch.tensordot(ws[wi], cx, dims=([1], [axis]))
            g = y if g is None else g + y
        t = g.to(torch.float32) * _group_scale(m, s, axis, group_axis)
        acc = t if acc is None else acc + t
    return acc[:f], acc[f:]


def _group_scale(m: torch.Tensor, s: int, axis: int, group_axis):
    """2^(m - s) shaped to broadcast against a contraction's output: ``m``
    is a scalar, or keeps the input's dims, of which the contraction drops
    ``axis`` and prepends one."""
    e = _exp2(m - s)
    if group_axis is None:
        return e
    return e.squeeze(axis).unsqueeze(0)
