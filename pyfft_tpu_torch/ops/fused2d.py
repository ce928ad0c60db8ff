"""The fused 2D FFT over the last two axes (the "fused2d" executor).

Counterpart of ``pyfft_tpu/ops/pallas_local.py``'s ``fft2_fused`` and
``supported_2d`` (the Pallas kernel ``_fused2d_kernel``, launched by
``_fft2_fused_inner``): both last axes of (..., ny, nx) planes in one
pass over device memory.  Two implementations:

* the Hopper kernel ``csrc/fused2d.cu`` (a thread-block cluster a plane,
  rows then columns, the plane held in the cluster's distributed shared
  memory between the two), launched by ``_launch`` for every CUDA tensor.
  Its C entry runs one of two designs by its table (``design``): the plane
  ring (a persistent grid of clusters walking the planes, each block's
  share of the next plane copied in by a tensor-map box while the current
  one computes, padded radix-16 chains, the exchange as one bulk copy a
  run into the owning block's shared memory) on the planes of up to 2^17
  points its table takes (``RING_SHAPES``: all but 256 x 512) where its
  tensor maps read them, else the first design (one cluster a plane, the
  exchange gathered value by value);
* its plain torch version ``fft2_plain``: the JAX kernel's two
  ``tile_fft`` calls, y then x, with ``default_factors`` chains, taken for
  every CPU tensor.

It is also the counterpart of ``fft2_fused_tiled`` and its Pallas kernel
``_fused2d_tiled_kernel`` (launched by ``_fft2_fused_tiled``), the same
function in one launch for planes of up to ``MAX_FUSED2D_TILED_ELEMS``
points, which no ``Plan`` route takes: the Hopper kernel
``csrc/fused2d_tiled.cu`` (K9: a persistent grid of clusters walking the
planes, as many in flight as the card's L2 holds, each plane's rows into
the output, a cluster barrier, the columns in place; ``_launch_tiled``,
``tiled_shape``) and its plain version ``fft2_tiled_plain``
(``col_factors`` chains).

Under ``precision="int8"`` both run each axis's matrix stage as the
int8-split stage K10 (``ops/int8.py``): on the card the kernels
``fused2d_i8_kernel`` (K8 + K10) and ``fused2d_tiled_i8_kernel`` (K9 + K10)
beside the float ones, x first as the float kernels, each block's or
chunk's data one alignment group, the stage on ``wgmma`` at every shape
(``i8_stage``); on the CPU the plain versions, y first with JAX's groups
(K8: the whole plane on each axis; K9: 128-column slices for y, 128-row
slices for x, per plane).

``fft2_fused`` and ``fft2_fused_tiled`` decide by the tensor's device alone.
For a CUDA tensor they launch the kernel or raise; nothing falls back to
the plain version.  Each launch's C call is the span
``pyfft.entry.<kernel>`` and adds one to the registry
(``utils/profiling``): ``launch.K8.ring`` or ``launch.K8.first`` by what
K8's entry returned, ``launch.K9``, ``launch.K8+K10``, ``launch.K9+K10``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pyfft_tpu_torch.ops import build, local
from pyfft_tpu_torch.ops.launch import RAN_RING, Launch, run
from pyfft_tpu_torch.ops.int8 import w_tables
from pyfft_tpu_torch.planner import MAX_FUSED2D_ELEMS, MIN_TRAIL
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["supported_2d", "fft2_fused", "fft2_plain", "cluster_size",
           "supported_2d_tiled", "fft2_fused_tiled", "fft2_tiled_plain",
           "tiled_cluster_size", "tiled_shape", "i8_stage", "design",
           "ring_shape", "clusters", "MAX_FUSED2D_TILED_ELEMS",
           "RING_SHAPES"]

# The (ny, nx) planes the ring takes (csrc/fused2d.cu PYFFT_FUSED2D_RING):
# at most 2^17 points, but 256 x 512, where the first design ran faster; a
# test holds them to the source's table.
RING_SHAPES = ((128, 128), (128, 256), (128, 512), (128, 1024), (256, 128),
               (256, 256), (512, 128), (512, 256), (1024, 128))

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
               factors_x=None, precision: str = "highest"):
    """The plain torch version of the fused kernel, on any device: the DFT
    over the last two axes of (..., ny, nx) float32 planes, as
    pallas_local._fused2d_kernel computes it: ``tile_fft`` along y (chain
    ``default_factors(ny)``), then along x, then ``postscale``.  Under
    ``precision="int8"`` each plane is one alignment group of each axis's
    int8 stage, as the JAX kernel's whole-plane tiles."""
    ny, nx = re.shape[-2:]
    return _fft2_plain(re, im, sign, postscale,
                       factors_y or local.default_factors(ny),
                       factors_x or local.default_factors(nx), precision,
                       nx, ny)


def _fft2_plain(re, im, sign, postscale, fy, fx, precision, lanes_y,
                lanes_x):
    """``tile_fft`` along y, then along x, then ``postscale``; under int8
    the alignment groups are, per plane, slices of ``lanes_y`` columns for
    the y stage and of ``lanes_x`` (ky) rows for the x stage."""
    local._check_precision(precision, re.dtype)
    shape = tuple(re.shape)
    ny, nx = shape[-2:]
    L = re.numel() // (ny * nx)
    fy, fx = tuple(fy), tuple(fx)
    if precision == "int8":       # (groups, lanes) trails, a group each
        trail_y = (L * nx // lanes_y, lanes_y)
        trail_x = (L * ny // lanes_x, lanes_x)
        ty = local._device_tables(ny, sign, fy, re.device, "int8", 2)
        tx = local._device_tables(nx, sign, fx, re.device, "int8", 2)
        kw = dict(sign=sign, precision="int8", group_axis=-2)
    else:
        trail_y, trail_x = (L * nx,), (L * ny,)
        ty = local._device_tables(ny, sign, fy, re.device)
        tx = local._device_tables(nx, sign, fx, re.device)
        kw = dict(sign=sign)

    def y_major(t):                # (L, ny, nx) -> (ny, *trail_y)
        return t.reshape(L, ny, nx).transpose(0, 1).reshape(ny, *trail_y)

    xr, xi = local.tile_fft(y_major(re), y_major(im), ty, ny, fy, **kw)

    def x_major(t):                # (ny, L*nx) -> (nx, *trail_x)
        return t.reshape(ny, L, nx).permute(2, 1, 0).reshape(nx, *trail_x)

    xr, xi = local.tile_fft(x_major(xr), x_major(xi), tx, nx, fx, **kw)
    xr = xr.reshape(nx, L, ny).permute(1, 2, 0)
    xi = xi.reshape(nx, L, ny).permute(1, 2, 0)
    if postscale != 1.0:
        xr, xi = xr * postscale, xi * postscale
    return xr.contiguous().reshape(shape), xi.contiguous().reshape(shape)


def fft2_tiled_plain(re, im, sign, postscale: float = 1.0, factors_y=None,
                     factors_x=None, precision: str = "highest"):
    """The plain torch version of K9, on any device: ``fft2_plain`` with
    the chains pallas_local._fft2_fused_tiled takes by default,
    ``col_factors(ny)`` and ``col_factors(nx)``.  Under
    ``precision="int8"`` the alignment groups are JAX's slices: per plane,
    each 128-column slice for the y stage and each 128-row slice of the
    y-transformed plane for the x stage."""
    ny, nx = re.shape[-2:]
    return _fft2_plain(re, im, sign, postscale,
                       factors_y or local.col_factors(ny),
                       factors_x or local.col_factors(nx), precision,
                       MIN_TRAIL, MIN_TRAIL)


def _typed(name: str):
    """(launch, launch_i8, cluster): the typed C entry points
    ``pyfft_<name>``, ``pyfft_<name>_i8`` and ``pyfft_<name>_cluster`` of
    ``csrc/<name>.cu`` (K8's and K9's share their C interface)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = ctypes.POINTER(ctypes.c_longlong)
    return (build.entry(name, f"pyfft_{name}",
                        [p] * 6 + [dims] + [i] * 3 + [ctypes.c_float, p]),
            build.entry(name, f"pyfft_{name}_i8",
                        [p] * 8 + [dims] + [i] * 5 + [ctypes.c_float, p]),
            build.entry(name, f"pyfft_{name}_cluster", [i] * 2))


@functools.lru_cache(maxsize=None)
def _lib():
    """(launch, launch_i8, cluster): the typed C entry points of
    csrc/fused2d.cu, built at first use."""
    return _typed("fused2d")


def cluster_size(ny: int, nx: int) -> int:
    """The blocks of the cluster that takes one (ny, nx) plane; builds the
    kernel on first use."""
    return _lib()[2](ilog2(ny), ilog2(nx))


@functools.lru_cache(maxsize=None)
def _tiled_lib():
    """(launch, launch_i8, cluster): the typed C entry points of
    csrc/fused2d_tiled.cu, built at first use."""
    return _typed("fused2d_tiled")


def tiled_cluster_size(ny: int, nx: int) -> int:
    """The blocks of the cluster that takes one (ny, nx) plane in K9;
    builds the kernel on first use."""
    return _tiled_lib()[2](ilog2(ny), ilog2(nx))


TILED_SHAPE_KEYS = ("cluster", "rows_a_chunk", "group", "run", "planes",
                    "clusters_held", "chunk")


def tiled_shape(ny: int, nx: int) -> dict:
    """K9's shape on (ny, nx) planes on the current card: blocks a cluster,
    rows a phase-1 chunk, blocks a phase-2 group (1 where a block takes
    whole columns), the columns of a phase-2 tile (the run of each plane it
    reads and writes, in floats), the planes in flight (its share of the
    card's L2), the clusters the card holds at once and the chunk's
    points; builds the kernel on first use."""
    return build.query("fused2d_tiled", "pyfft_fused2d_tiled_shape",
                       TILED_SHAPE_KEYS, ilog2(ny), ilog2(nx),
                       out=ctypes.c_longlong, status=True)


@functools.lru_cache(maxsize=None)
def _clusters_fn():
    """The C entry point ``pyfft_fused2d_clusters`` of csrc/fused2d.cu,
    built at first use."""
    return build.entry("fused2d", "pyfft_fused2d_clusters", [ctypes.c_int] * 3)


def clusters(ny: int, nx: int, ring: bool) -> int:
    """K8's clusters on (ny, nx) planes that the card holds at once
    (cudaOccupancyMaxActiveClusters), of the ring's kernel or the first
    design's; raises where the query fails or the design does not take
    the shape."""
    got = _clusters_fn()(ilog2(ny), ilog2(nx), int(ring))
    if got < 0:
        raise RuntimeError(f"fused 2D cluster query at {ny}x{nx} "
                           f"(ring={ring}) failed: {got}")
    return got


RING_SHAPE_KEYS = ("cluster", "rows", "columns", "threads", "slots",
                   "smem_bytes", "clusters_held", "box_run")


def ring_shape(ny: int, nx: int):
    """The ring's shape on (ny, nx) planes on the current card: blocks a
    cluster, rows and columns a block, threads and slots a block, shared
    memory a block in bytes, the clusters the card holds at once (the
    grid) and the run of x a box takes; None where the shape runs the
    first design.  Builds the kernel on first use."""
    return build.query("fused2d", "pyfft_fused2d_ring_shape",
                       RING_SHAPE_KEYS, ilog2(ny), ilog2(nx),
                       out=ctypes.c_longlong)


def i8_stage(ny: int, nx: int, tiled: bool = False) -> str:
    """Which K10 stage the int8 kernel K8 + K10 (or, with ``tiled``, K9 +
    K10) runs on (ny, nx) planes: "wgmma" where both axes' f (the matrix
    factor of ``default_factors``, or ``col_factors`` for K9) is at least
    32 (a block is 512 threads, four warpgroups), else "mma" (mma.sync).
    The kernels make the same choice at compile time; ``_i8_stage_fn``
    reports it."""
    chain = local.col_factors if tiled else local.default_factors
    fs = [local.matrix_factor(chain(n)) for n in (ny, nx)]
    return "wgmma" if min(fs) >= 32 else "mma"


@functools.lru_cache(maxsize=None)
def _i8_stage_fn(tiled: bool = False):
    """The C entry point ``pyfft_fused2d_i8_stage`` of csrc/fused2d.cu (or
    ``pyfft_fused2d_tiled_i8_stage`` of csrc/fused2d_tiled.cu): (log2 ny,
    log2 nx) -> 1 for the wgmma stage, 0 for the mma.sync one, -1 where no
    int8 kernel is instantiated."""
    name = "fused2d_tiled" if tiled else "fused2d"
    return build.entry(name, f"pyfft_{name}_i8_stage", [ctypes.c_int] * 2)


@functools.lru_cache(maxsize=None)
def _i8_clusters_fn():
    """The C entry point ``pyfft_fused2d_i8_clusters`` of csrc/fused2d.cu:
    (log2 ny, log2 nx) -> the K8 + K10 clusters the card holds at once
    (cudaOccupancyMaxActiveClusters), 0 where none places."""
    return build.entry("fused2d", "pyfft_fused2d_i8_clusters",
                       [ctypes.c_int] * 2)


def _check_devices(re, im, out_re, out_im) -> None:
    """The 2D kernels take float32 planes on one CUDA device."""
    for t in (re, im, out_re, out_im):
        if (not t.is_cuda or t.device != re.device
                or t.dtype != torch.float32):
            raise ValueError("fused 2D kernel takes float32 planes on one "
                             f"CUDA device, got {t.dtype} on {t.device}")


def design(re, im) -> str:
    """Which design K8 runs on these (..., ny, nx) planes (csrc/fused2d.cu
    ``dispatch_design``): "ring" where the ring's table takes (ny, nx)
    (``RING_SHAPES``) and its tensor maps read the planes where they lie
    (``local._boxable``: planar or the complex form's stride-2 planes,
    16-byte aligned, the y and l strides multiples of 4 floats), else
    "first".  No CUDA call."""
    ny, nx = re.shape[-2:]
    L = math.prod(re.shape[:-2])
    if (ny, nx) not in RING_SHAPES or L == 0:
        return "first"
    r3 = local._view(re, (L, ny, nx), "re")
    i3 = local._view(im, (L, ny, nx), "im")
    return "ring" if local._boxable(r3, i3) else "first"


def _prepare(libs, name: str, re, im, out_re, out_im, sign: int,
             postscale: float, factors=None, ring: bool = False):
    """The launch of library ``name``'s kernel over the (L, ny, nx) view of
    the planes, after the checks; ``libs()`` gives its typed (launch,
    launch_i8, cluster) entry points.  With ``factors`` (the chains of y
    and x) the int8 kernel runs, its stages' f the chains' matrix factors.
    K8 and K9 share this C interface, the checks and the tables.  The
    launch counts ``launch.K8.ring`` where the entry returns RAN_RING (only
    K8's float entry, ``ring``, may), else ``launch.K8.first``,
    ``launch.K9``, ``launch.K8+K10`` or ``launch.K9+K10``; any other
    non-zero return raises.  None when there is nothing to launch."""
    shape = tuple(re.shape)
    ny, nx = shape[-2:]
    L = math.prod(shape[:-2])
    _check_devices(re, im, out_re, out_im)
    for t in (re, im, out_re, out_im):
        if tuple(t.shape) != shape:
            raise ValueError("fused 2D kernel planes differ in shape")
    if L == 0:
        return None
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
    fn, fn_i8, cluster = libs()
    if L * cluster(ilog2(ny), ilog2(nx)) >= 2 ** 31:
        raise ValueError("fused 2D kernel block count must fit int32")
    dims = (ctypes.c_longlong * 7)(L, *r3.stride(), *o_r.stride())
    twy = local._kernel_twiddles(ny, sign, re.device)
    twx = local._kernel_twiddles(nx, sign, re.device)
    ptrs = (r3.data_ptr(), i3.data_ptr(), o_r.data_ptr(), o_i.data_ptr(),
            twy.data_ptr(), twx.data_ptr())
    kernel = "K8" if name == "fused2d" else "K9"
    if factors:
        fy, fx = (local.matrix_factor(f) for f in factors)
        wy = w_tables(fy, sign, re.device)
        wx = w_tables(fx, sign, re.device)
        return Launch(fn_i8, (*ptrs, wy.data_ptr(), wx.data_ptr(), dims,
                              ilog2(ny), ilog2(fy), ilog2(nx), ilog2(fx),
                              int(sign), float(postscale)),
                      (0, 1, 2, 3), f"pyfft.entry.{kernel}+K10",
                      {0: f"launch.{kernel}+K10"}, name + "_i8",
                      (twy, twx, wy, wx))
    keys = ({RAN_RING: "launch.K8.ring", 0: "launch.K8.first"} if ring
            else {0: f"launch.{kernel}"})
    return Launch(fn, (*ptrs, dims, ilog2(ny), ilog2(nx), int(sign),
                       float(postscale)),
                  (0, 1, 2, 3), f"pyfft.entry.{kernel}", keys, name,
                  (twy, twx))


def _launch(re, im, out_re, out_im, sign: int, postscale: float,
            int8: bool = False):
    """Launch csrc/fused2d.cu: K8, or with ``int8`` K8 + K10 (f from
    ``default_factors``); the caller (``fft2_fused``) has checked
    ``supported_2d``.  No synchronise."""
    ny, nx = re.shape[-2:]
    factors = ((local.default_factors(ny), local.default_factors(nx))
               if int8 else None)
    run(_prepare(_lib, "fused2d", re, im, out_re, out_im, sign, postscale,
                 factors, ring=True), re.device)
    return out_re, out_im


def _launch_tiled(re, im, out_re, out_im, sign: int, postscale: float,
                  int8: bool = False):
    """Launch csrc/fused2d_tiled.cu: K9, or with ``int8`` K9 + K10 (f
    from ``col_factors``); the caller (``fft2_fused_tiled``) has checked
    ``supported_2d_tiled``.  No synchronise."""
    ny, nx = re.shape[-2:]
    factors = ((local.col_factors(ny), local.col_factors(nx))
               if int8 else None)
    run(_prepare(_tiled_lib, "fused2d_tiled", re, im, out_re, out_im, sign,
                 postscale, factors), re.device)
    return out_re, out_im


def fft2_fused(re, im, sign, *, postscale: float = 1.0, factors_y=None,
               factors_x=None, precision: str = "highest", out=None):
    """2D DFT over the last two axes of planar float32 tensors.

    A CUDA tensor goes to the kernel, which runs its own chains (the
    design ``design`` names) and ignores the factors; a CPU tensor goes
    to ``fft2_plain``, which runs them.  ``out=(re, im)`` names the planes
    to write, of the input's shape; they may be the inputs themselves (in
    place).  Without it, new
    planes are allocated with the input's layout.  Raises where the kernel
    does not apply; nothing falls back.  ``precision="int8"`` runs K8 + K10
    on the card and ``fft2_plain(precision="int8")`` on the CPU (see the
    module's docstring).
    """
    int8 = local._check_precision(precision, re.dtype)
    if not supported_2d(re):
        raise ValueError(f"fused 2D FFT does not cover a {re.dtype} tensor "
                         f"of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused 2D FFT for device {re.device}")
    if re.is_cuda:
        if out is None:
            out = local._empty_like_planes(re, im, tuple(re.shape))
        return _launch(re, im, out[0], out[1], sign, postscale, int8)
    rr, ii = fft2_plain(re, im, sign, postscale, factors_y, factors_x,
                        precision)
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
    ``precision="int8"`` runs K9 + K10 on the card and
    ``fft2_tiled_plain(precision="int8")`` on the CPU (see the module's
    docstring).
    """
    int8 = local._check_precision(precision, re.dtype)
    if not supported_2d_tiled(re):
        raise ValueError(f"tiled fused 2D FFT does not cover a {re.dtype} "
                         f"tensor of shape {tuple(re.shape)}")
    if re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tiled fused 2D FFT for device {re.device}")
    if re.is_cuda:
        if out is None:
            out = local._empty_like_planes(re, im, tuple(re.shape))
        return _launch_tiled(re, im, out[0], out[1], sign, postscale, int8)
    rr, ii = fft2_tiled_plain(re, im, sign, postscale, factors_y, factors_x,
                              precision)
    if out is None:
        return rr, ii
    out[0].copy_(rr)
    out[1].copy_(ii)
    return out
