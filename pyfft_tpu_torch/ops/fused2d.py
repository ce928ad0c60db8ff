"""The fused 2D FFT over the last two axes (the "fused2d" executor).

Counterpart of ``pyfft_tpu/ops/pallas_local.py``'s ``fft2_fused`` and
``supported_2d`` (the Pallas kernel ``_fused2d_kernel``, launched by
``_fft2_fused_inner``): both last axes of (..., ny, nx) planes in one
pass over device memory.  Two implementations:

* the Hopper kernel ``csrc/fused2d.cu`` (one thread-block cluster a plane,
  rows then columns, the plane held in the cluster's distributed shared
  memory between the two), launched by ``_launch`` for every CUDA tensor;
* its plain torch version ``fft2_plain``: the JAX kernel's two
  ``tile_fft`` calls, y then x, with ``default_factors`` chains, taken for
  every CPU tensor.

It is also the counterpart of ``fft2_fused_tiled`` and its Pallas kernel
``_fused2d_tiled_kernel`` (launched by ``_fft2_fused_tiled``), the same
function in one launch for planes of up to ``MAX_FUSED2D_TILED_ELEMS``
points, which no ``Plan`` route takes: the Hopper kernel
``csrc/fused2d_tiled.cu`` (K9: one cluster a plane, the rows into the
output, a cluster barrier, the columns in place; ``_launch_tiled``) and its
plain version ``fft2_tiled_plain`` (``col_factors`` chains).

``fft2_fused`` and ``fft2_fused_tiled`` decide by the tensor's device alone.
For a CUDA tensor they launch the kernel or raise; nothing falls back to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.planner import MAX_FUSED2D_ELEMS, MIN_TRAIL
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["supported_2d", "fft2_fused", "fft2_plain", "cluster_size",
           "supported_2d_tiled", "fft2_fused_tiled", "fft2_tiled_plain",
           "tiled_cluster_size", "MAX_FUSED2D_TILED_ELEMS", "LAUNCHES",
           "TILED_LAUNCHES"]

# Kernel launches made by _launch since the last reset (a caller sets it
# to 0): the proof that a run went through the CUDA kernel.
LAUNCHES = 0
# The same for _launch_tiled (K9).
TILED_LAUNCHES = 0

# The tiled kernel's largest plane (pallas_local.MAX_FUSED2D_TILED_ELEMS).
MAX_FUSED2D_TILED_ELEMS = 1 << 20


def _supported_2d(re: torch.Tensor, max_elems: int) -> bool:
    """float32, both last axes powers of two and multiples of MIN_TRAIL, at
    most ``max_elems`` points a plane."""
    if re.dtype != torch.float32 or re.ndim < 2:
        return False
    ny, nx = re.shape[-2], re.shape[-1]
    if not (is_power_of_two(ny) and is_power_of_two(nx)):
        return False
    if ny % MIN_TRAIL or nx % MIN_TRAIL:
        return False
    return ny * nx <= max_elems


def supported_2d(re: torch.Tensor) -> bool:
    """Whether the fused kernel covers the last two axes of this tensor
    (pallas_local.supported_2d): float32, both axes powers of two and
    multiples of MIN_TRAIL, at most MAX_FUSED2D_ELEMS points a plane."""
    return _supported_2d(re, MAX_FUSED2D_ELEMS)


def supported_2d_tiled(re: torch.Tensor) -> bool:
    """Whether the tiled kernel K9 covers the last two axes of this
    tensor: ``supported_2d``'s rule up to MAX_FUSED2D_TILED_ELEMS points a
    plane."""
    return _supported_2d(re, MAX_FUSED2D_TILED_ELEMS)


def fft2_plain(re, im, sign, postscale: float = 1.0, factors_y=None,
               factors_x=None):
    """The plain torch version of the fused kernel, on any device: the DFT
    over the last two axes of (..., ny, nx) float32 planes, as
    pallas_local._fused2d_kernel computes it: ``tile_fft`` along y (chain
    ``default_factors(ny)``), then along x, then ``postscale``."""
    shape = tuple(re.shape)
    ny, nx = shape[-2:]
    L = re.numel() // (ny * nx)
    fy = tuple(factors_y or local.default_factors(ny))
    fx = tuple(factors_x or local.default_factors(nx))
    ty = local._device_tables(ny, sign, fy, re.device)
    tx = local._device_tables(nx, sign, fx, re.device)

    def y_major(t):                      # (L, ny, nx) -> (ny, L*nx)
        return t.reshape(L, ny, nx).transpose(0, 1).reshape(ny, L * nx)

    xr, xi = local.tile_fft(y_major(re), y_major(im), ty, ny, fy, sign=sign)

    def x_major(t):                      # (ny, L*nx) -> (nx, L*ny)
        return t.reshape(ny, L, nx).permute(2, 1, 0).reshape(nx, L * ny)

    xr, xi = local.tile_fft(x_major(xr), x_major(xi), tx, nx, fx, sign=sign)
    xr = xr.reshape(nx, L, ny).permute(1, 2, 0)
    xi = xi.reshape(nx, L, ny).permute(1, 2, 0)
    if postscale != 1.0:
        xr, xi = xr * postscale, xi * postscale
    return xr.contiguous().reshape(shape), xi.contiguous().reshape(shape)


def fft2_tiled_plain(re, im, sign, postscale: float = 1.0, factors_y=None,
                     factors_x=None):
    """The plain torch version of K9, on any device: ``fft2_plain`` with
    the chains pallas_local._fft2_fused_tiled takes by default,
    ``col_factors(ny)`` and ``col_factors(nx)``."""
    ny, nx = re.shape[-2:]
    return fft2_plain(re, im, sign, postscale,
                      factors_y or local.col_factors(ny),
                      factors_x or local.col_factors(nx))


@functools.lru_cache(maxsize=None)
def _lib():
    """(launch, cluster): the typed C entry points of csrc/fused2d.cu,
    built at first use."""
    from pyfft_tpu_torch.ops.build import load
    lib = load("fused2d")
    fn = lib.pyfft_fused2d
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cluster = lib.pyfft_fused2d_cluster
    cluster.argtypes = [ctypes.c_int, ctypes.c_int]
    cluster.restype = ctypes.c_int
    return fn, cluster


def cluster_size(ny: int, nx: int) -> int:
    """The blocks of the cluster that takes one (ny, nx) plane; builds the
    kernel on first use."""
    return _lib()[1](ilog2(ny), ilog2(nx))


@functools.lru_cache(maxsize=None)
def _tiled_lib():
    """(launch, cluster): the typed C entry points of
    csrc/fused2d_tiled.cu, built at first use."""
    from pyfft_tpu_torch.ops.build import load
    lib = load("fused2d_tiled")
    fn = lib.pyfft_fused2d_tiled
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cluster = lib.pyfft_fused2d_tiled_cluster
    cluster.argtypes = [ctypes.c_int, ctypes.c_int]
    cluster.restype = ctypes.c_int
    return fn, cluster


def tiled_cluster_size(ny: int, nx: int) -> int:
    """The blocks of the cluster that takes one (ny, nx) plane in K9;
    builds the kernel on first use."""
    return _tiled_lib()[1](ilog2(ny), ilog2(nx))


def _launch_with(libs, name: str, re, im, out_re, out_im, sign: int,
                 postscale: float) -> bool:
    """Launch the kernel of library ``name`` over the (L, ny, nx) view of
    the planes, after the checks; ``libs()`` gives its typed (launch,
    cluster) entry points.  K8 and K9 share this C interface, the checks
    and the tables.  No synchronise; False when there is nothing to
    launch."""
    shape = tuple(re.shape)
    ny, nx = shape[-2:]
    L = math.prod(shape[:-2])
    for t in (re, im, out_re, out_im):
        if (not t.is_cuda or t.device != re.device
                or t.dtype != torch.float32):
            raise ValueError("fused 2D kernel takes float32 planes on one "
                             f"CUDA device, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError("fused 2D kernel planes differ in shape")
    if L == 0:
        return False
    r3, i3, o_r, o_i = (local._view(t, (L, ny, nx), w) for t, w in
                        ((re, "re"), (im, "im"), (out_re, "out_re"),
                         (out_im, "out_im")))
    if r3.stride() != i3.stride() or o_r.stride() != o_i.stride():
        raise ValueError("fused 2D kernel needs equal strides for re and im")
    for src in (re, im):
        for dst in (o_r, o_i):
            if not local._shares_memory(src, dst):
                continue
            # in place: only onto the very same elements
            if (dst.data_ptr() not in (r3.data_ptr(), i3.data_ptr())
                    or dst.stride() != r3.stride()):
                raise ValueError("fused 2D kernel output overlaps its input "
                                 "other than exactly")
    fn, cluster = libs()
    if L * cluster(ilog2(ny), ilog2(nx)) >= 2 ** 31:
        raise ValueError("fused 2D kernel block count must fit int32")
    dims = (ctypes.c_longlong * 7)(L, *r3.stride(), *o_r.stride())
    twy = local._kernel_twiddles(ny, sign, re.device)
    twx = local._kernel_twiddles(nx, sign, re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = fn(r3.data_ptr(), i3.data_ptr(), o_r.data_ptr(),
                 o_i.data_ptr(), twy.data_ptr(), twx.data_ptr(), dims,
                 ilog2(ny), ilog2(nx), int(sign), float(postscale), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return True


def _launch(re, im, out_re, out_im, sign: int, postscale: float):
    """Launch csrc/fused2d.cu (K8); the caller (``fft2_fused``) has
    checked ``supported_2d``."""
    global LAUNCHES
    if _launch_with(_lib, "fused2d", re, im, out_re, out_im, sign,
                    postscale):
        LAUNCHES += 1
    return out_re, out_im


def _launch_tiled(re, im, out_re, out_im, sign: int, postscale: float):
    """Launch csrc/fused2d_tiled.cu (K9); the caller
    (``fft2_fused_tiled``) has checked ``supported_2d_tiled``."""
    global TILED_LAUNCHES
    if _launch_with(_tiled_lib, "fused2d_tiled", re, im, out_re, out_im,
                    sign, postscale):
        TILED_LAUNCHES += 1
    return out_re, out_im


def fft2_fused(re, im, sign, *, postscale: float = 1.0, factors_y=None,
               factors_x=None, precision: str = "highest", out=None):
    """2D DFT over the last two axes of planar float32 tensors.

    A CUDA tensor goes to the kernel, which runs its own radix-8 chains and
    ignores the factors; a CPU tensor goes to ``fft2_plain``, which runs
    them.  ``out=(re, im)`` names the planes to write, of the input's
    shape; they may be the inputs themselves (in place).  Without it, new
    planes are allocated with the input's layout.  Raises where the kernel
    does not apply; nothing falls back.  ``precision="int8"`` raises
    NotImplementedError on every device: the int8 stage inside K8 is not
    ported yet.
    """
    local.refuse_int8(precision, "K8 (fft2_fused)")
    if not supported_2d(re):
        raise ValueError(f"fused 2D FFT does not cover a {re.dtype} tensor "
                         f"of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused 2D FFT for device {re.device}")
    if re.is_cuda:
        if out is None:
            out = local._empty_like_planes(re, im, tuple(re.shape))
        return _launch(re, im, out[0], out[1], sign, postscale)
    rr, ii = fft2_plain(re, im, sign, postscale, factors_y, factors_x)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out


def fft2_fused_tiled(re, im, sign, *, postscale: float = 1.0,
                     factors_y=None, factors_x=None,
                     precision: str = "highest", out=None):
    """2D DFT over the last two axes of planar float32 tensors in one
    launch, for planes of up to MAX_FUSED2D_TILED_ELEMS points
    (pallas_local.fft2_fused_tiled, which no route takes).

    A CUDA tensor goes to K9, which runs its own radix-8 chains and ignores
    the factors; a CPU tensor goes to ``fft2_tiled_plain``, which runs them
    (default ``col_factors``).  ``out=(re, im)`` names the planes to write,
    of the input's shape; they may be the inputs themselves (JAX's
    ``alias_io``).  Without it, new planes are allocated with the input's
    layout.  Raises where K9 does not apply; nothing falls back.
    ``precision="int8"`` raises NotImplementedError on every device: the
    int8 stage inside K9 is not ported yet.
    """
    local.refuse_int8(precision, "K9 (fft2_fused_tiled)")
    if not supported_2d_tiled(re):
        raise ValueError(f"tiled fused 2D FFT does not cover a {re.dtype} "
                         f"tensor of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tiled fused 2D FFT for device {re.device}")
    if re.is_cuda:
        if out is None:
            out = local._empty_like_planes(re, im, tuple(re.shape))
        return _launch_tiled(re, im, out[0], out[1], sign, postscale)
    rr, ii = fft2_tiled_plain(re, im, sign, postscale, factors_y, factors_x)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out
