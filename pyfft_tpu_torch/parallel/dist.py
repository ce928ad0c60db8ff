"""Distributed FFT over a ``torch.distributed`` device mesh.

Counterpart of ``pyfft_tpu/parallel/dist.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with two named dimensions
(names are parameters, ``("dp", "sp")`` by default), built row-major over
(dp, sp) with sp minor, as JAX's ``Mesh``:

  * ``dp`` -- batch parallelism: transforms are independent, no
    communication.
  * ``sp`` -- sequence parallelism: the transform axis is sharded; a
    length-n FFT on S ranks runs as

      1. all_to_all      j-chunks -> all outer digits j1 for a j2-slice
      2. local S-point DFT over j1 (the cross-rank factor)   [matmul]
      3. twiddle w_n^(j1_out * j2_global)
      4. all_to_all      -> full j2 range for this rank's k1
      5. local length-L FFT over j2 (the heavy factor, L = n/S: the row
         kernel where ``local.supported`` holds, as single-card plans)
      6. all_to_all      strided spectral index -> contiguous shards

JAX's ``make_dist_*`` return a jitted ``shard_map``; here each returns its
body: a function of this rank's planar (re, im) blocks -- (B/dp, n/S) for
1D, (B/dp, ny/S, nx) for 2D, (B/dp, nz/S, ny, nx) for 3D -- that returns
this rank's output blocks in the same layout.  Every rank of the mesh
calls it together.  Each ``all_to_all`` is ``all_to_all_single`` over the
mesh's ``sp`` group (``exchange``).

A mesh on ``"cuda"`` runs every block on this rank's current CUDA device
(``init_device_mesh`` sets it) through the kernels: K1 (rows), K5
(columns), K8 (fused planes) and K11 (complex128 rows).  A ``"cpu"`` mesh
(gloo) runs their plain versions.  A block on another device raises; it
is never moved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyfft_tpu_torch.ops import fp64, fused2d, local
from pyfft_tpu_torch.ops.twiddle import dft_matrix
from pyfft_tpu_torch.planner import MAX_LOCAL_N_DF64, MIN_LOCAL_N
# the reference module turns TF32 off: the S-point DFT's einsum must run
# in full float32
from pyfft_tpu_torch.reference import fft_planar
from pyfft_tpu_torch.utils.radix import is_power_of_two

__all__ = ["dist_fft_1d", "make_dist_fft", "make_dist_fft2",
           "make_dist_fft3", "make_dist_fft_df64", "exchange"]

_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def exchange(x: torch.Tensor, split: int, concat: int, s: int, group):
    """JAX's tiled ``all_to_all(x, split_axis, concat_axis)`` over the s
    ranks of ``group``: ``x`` cut into s chunks along ``split``, chunk r
    sent to the group's rank r, and the chunks received concatenated along
    ``concat`` in the order of the ranks that sent them."""
    split %= x.ndim
    concat %= x.ndim
    d = x.shape[split]
    chunks = (x.reshape(x.shape[:split] + (s, d // s) + x.shape[split + 1:])
              .movedim(split, 0).contiguous())
    got = torch.empty_like(chunks)
    torch.distributed.all_to_all_single(got, chunks, group=group)
    return torch.cat(got.unbind(0), dim=concat)


def _dim(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the mesh has no dimension {name!r} (its "
                         f"dimensions: {names})")
    return names.index(name)


def _size(mesh, name: str) -> int:
    return mesh.shape[_dim(mesh, name)]


def _device(mesh) -> torch.device:
    """Where this rank's blocks live: its current CUDA device on a
    ``"cuda"`` mesh, the host on a ``"cpu"`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"no distributed FFT on a {mesh.device_type} mesh")


class _Seq:
    """This rank's view of the mesh's sequence dimension: its size s, the
    rank's coordinate on it, its process group and the blocks' device."""

    def __init__(self, mesh, batch_axis: str, seq_axis: str):
        _dim(mesh, batch_axis)
        self.s = _size(mesh, seq_axis)
        self.me = mesh.get_local_rank(seq_axis)
        self.group = mesh.get_group(seq_axis)
        self.device = _device(mesh)

    def a2a(self, x, split: int, concat: int):
        return exchange(x, split, concat, self.s, self.group)

    def check(self, re, im, tail: tuple) -> None:
        """Both blocks (b, *tail) planes of one real dtype on the mesh's
        device, or raise."""
        for t in (re, im):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"blocks are torch tensors, got {type(t)}")
            if t.device != self.device:
                raise ValueError(f"a block on {t.device}, but the mesh runs "
                                 f"on {self.device}; move it first")
        if re.shape != im.shape or re.dtype != im.dtype:
            raise ValueError("re/im blocks differ in shape or dtype")
        if re.dtype not in _NP_REAL:
            raise ValueError(f"blocks are float32 or float64, got {re.dtype}")
        if re.ndim != len(tail) + 1 or tuple(re.shape[1:]) != tail:
            raise ValueError(f"this rank's block is (b, *{tail}), got "
                             f"{tuple(re.shape)}")


def _axis_fft(re, im, sign: int, axis: int = -1, post: float = 1.0):
    """One local axis pass (JAX's ``_local_fft`` and ``local_axis_fft``):
    the row (last axis) or column kernel where ``local.supported`` holds,
    else the plain chain, times ``post``."""
    if local.supported(re, axis):
        return local.fft_axis(re.contiguous(), im.contiguous(), sign,
                              axis=axis, postscale=post)
    rr, ii = fft_planar(re, im, sign, axis=axis)
    if post != 1.0:
        rr, ii = rr * post, ii * post
    return rr, ii


def _planes_fft(re, im, sign: int):
    """The (ny, nx) planes of the 3D body: the fused 2D kernel where
    ``supported_2d`` holds, else the plain chain on both axes."""
    if fused2d.supported_2d(re):
        return fused2d.fft2_fused(re.contiguous(), im.contiguous(), sign)
    re, im = fft_planar(re, im, sign, axis=re.ndim - 1)
    return fft_planar(re, im, sign, axis=re.ndim - 2)


def _six_step(seq: _Seq, n: int, sign: int, norm: float, factor):
    """The 1D body over ``seq`` with ``factor(re, im, sign)`` as the local
    length-n/S factor."""
    s, L = seq.s, n // seq.s
    tables = {}

    def consts(dtype):
        """The S-point DFT matrix and this rank's (S, L/S) twiddle tile
        w_n^(k1 * j2), j2 = me*(L/S) + local: in float64 on the host, the
        phase index reduced mod n in int64, rounded once to ``dtype``."""
        if dtype not in tables:
            k1 = np.arange(s, dtype=np.int64)[:, None]
            j2 = np.arange(L // s, dtype=np.int64)[None, :] + seq.me * (L // s)
            ang = (sign * 2.0 * np.pi / n) * ((k1 * j2) % n).astype(np.float64)
            arrays = (*dft_matrix(s, sign, np.float64), np.cos(ang),
                      np.sin(ang))
            tables[dtype] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, _NP_REAL[dtype]))
                .to(seq.device) for a in arrays)
        return tables[dtype]

    def body(re, im):
        seq.check(re, im, (L,))
        wr, wi, tr, ti = consts(re.dtype)
        lead = re.shape[:-1]
        # step 1: every outer digit j1 for this rank's slice of j2
        xr = seq.a2a(re[..., None, :], -1, -2)        # (..., S(j1), L/S)
        xi = seq.a2a(im[..., None, :], -1, -2)
        # step 2: the S-point DFT over j1
        eq = "kj,...jl->...kl"
        cr = torch.einsum(eq, wr, xr) - torch.einsum(eq, wi, xi)
        ci = torch.einsum(eq, wr, xi) + torch.einsum(eq, wi, xr)
        # step 3: the twiddle
        dr, di = cr * tr - ci * ti, cr * ti + ci * tr
        # step 4: the full j2 range for this rank's k1
        er = seq.a2a(dr, -2, -1).reshape(*lead, L)
        ei = seq.a2a(di, -2, -1).reshape(*lead, L)
        # step 5: the heavy factor
        fr, fi = factor(er, ei, sign)
        # step 6: strided k = k2*S + k1 -> contiguous shards, then the
        # local interleave out[m*S + u] = g[u, m]
        out = []
        for f in (fr, fi):
            g = seq.a2a(f.reshape(*lead, s, L // s), -2, -1)
            g = g.reshape(*lead, s, L // s).transpose(-1, -2).reshape(*lead,
                                                                       L)
            out.append(g * norm if norm != 1.0 else g)
        return tuple(out)

    return body


def _check_1d(mesh, n: int, seq_axis: str) -> int:
    if not is_power_of_two(n):
        raise ValueError(f"n={n} is not a power of two")
    s = _size(mesh, seq_axis)
    if n % (s * s) != 0:
        raise ValueError(f"n={n} must be divisible by seq_parallel^2={s*s}")
    return s


def make_dist_fft(mesh, n: int, *, batch_axis: str = "dp",
                  seq_axis: str = "sp", sign: int = -1,
                  normalize: bool = False):
    """A distributed 1D FFT of length ``n`` over ``mesh``.

    Returns ``fn(re, im)`` of this rank's planar (B/dp, n/S) blocks of
    float32 (or float64) planes, batch over ``batch_axis``, the transform
    axis over ``seq_axis``; it returns this rank's output blocks.  The
    local factor runs the row kernel K1 (``local.fft_axis``) where
    ``local.supported`` holds (n/S up to 8192), else the plain chain.
    """
    _check_1d(mesh, n, seq_axis)
    norm = (1.0 / n) if (normalize and sign > 0) else 1.0
    seq = _Seq(mesh, batch_axis, seq_axis)
    return _six_step(seq, n, sign, norm, _axis_fft)


def make_dist_fft2(mesh, shape: tuple[int, int], *, batch_axis: str = "dp",
                   seq_axis: str = "sp", sign: int = -1,
                   normalize: bool = False):
    """A distributed 2D FFT over ``mesh``.

    Returns ``fn(re, im)`` of this rank's (B/dp, ny/S, nx) blocks: the rows
    (K1) run local, one exchange each way moves nx onto the ranks and ny
    off them, and the columns (K5, with the normalization) run local on
    the (B/dp, ny, nx/S) block; each pass takes the plain chain where
    ``local.supported`` fails.
    """
    ny, nx = shape
    if not (is_power_of_two(ny) and is_power_of_two(nx)):
        raise ValueError(f"shape {shape} must be powers of two")
    s = _size(mesh, seq_axis)
    if ny % s or nx % s:
        raise ValueError(f"both axes of {shape} must be divisible by "
                         f"seq parallelism {s}")
    norm = (1.0 / (ny * nx)) if (normalize and sign > 0) else 1.0
    seq = _Seq(mesh, batch_axis, seq_axis)

    def body(re, im):
        seq.check(re, im, (ny // s, nx))
        re, im = _axis_fft(re, im, sign, re.ndim - 1)           # rows
        re, im = seq.a2a(re, -1, -2), seq.a2a(im, -1, -2)       # (b, ny, nx/S)
        re, im = _axis_fft(re, im, sign, re.ndim - 2, norm)     # columns
        return seq.a2a(re, -2, -1), seq.a2a(im, -2, -1)         # (b, ny/S, nx)

    return body


def make_dist_fft3(mesh, shape: tuple[int, int, int], *,
                   batch_axis: str = "dp", seq_axis: str = "sp",
                   sign: int = -1, normalize: bool = False):
    """A distributed 3D FFT over ``mesh``.

    Returns ``fn(re, im)`` of this rank's (B/dp, nz/S, ny, nx) blocks: the
    (ny, nx) planes run local (the fused 2D kernel K8 where
    ``fused2d.supported_2d`` holds, else the plain chain on both axes), one
    exchange each way moves nx onto the ranks and nz off them, and the z
    axis runs local (the column kernel K5, with the normalization, where
    ``local.supported`` holds, else the plain chain).
    """
    nz, ny, nx = shape
    for d in shape:
        if not is_power_of_two(d):
            raise ValueError(f"shape {shape} must be powers of two")
    s = _size(mesh, seq_axis)
    if nz % s or nx % s:
        raise ValueError(f"nz and nx of {shape} must be divisible by "
                         f"seq parallelism {s}")
    norm = (1.0 / math.prod(shape)) if (normalize and sign > 0) else 1.0
    seq = _Seq(mesh, batch_axis, seq_axis)

    def body(re, im):
        seq.check(re, im, (nz // s, ny, nx))
        re, im = _planes_fft(re, im, sign)
        re, im = seq.a2a(re, -1, -3), seq.a2a(im, -1, -3)   # (b, nz, ny, nx/S)
        re, im = _axis_fft(re, im, sign, re.ndim - 3, norm)
        return seq.a2a(re, -3, -1), seq.a2a(im, -3, -1)     # (b, nz/S, ny, nx)

    return body


def _fft_df64(re, im, sign: int):
    """The complex128 local factor: K11 (``fp64.fft_axis_df64``), which
    takes float64 planes only."""
    return fp64.fft_axis_df64(re.contiguous(), im.contiguous(), sign,
                              axis=-1)


def make_dist_fft_df64(mesh, n: int, *, batch_axis: str = "dp",
                       seq_axis: str = "sp", sign: int = -1,
                       normalize: bool = False):
    """A distributed complex128 1D FFT over ``mesh``.

    Returns ``fn(re, im)`` of this rank's (B/dp, n/S) float64 blocks: the
    six steps of ``make_dist_fft`` in FP64, the twiddle tile from the host
    in float64, the local factor the complex128 row kernel K11
    (``fp64.fft_axis_df64``).  JAX computes complex128 in double-float
    (hi, lo) quads; the card computes FP64 natively, so the planes stay
    float64.  The local factor n/S must lie in K11's range [MIN_LOCAL_N,
    MAX_LOCAL_N_DF64] = [8, 4096]: another n/S raises here, where JAX's
    kernel fails.
    """
    s = _check_1d(mesh, n, seq_axis)
    L = n // s
    if not MIN_LOCAL_N <= L <= MAX_LOCAL_N_DF64:
        raise ValueError(f"the local factor n/S = {L} is outside the "
                         f"complex128 row kernel's range [{MIN_LOCAL_N}, "
                         f"{MAX_LOCAL_N_DF64}]")
    norm = (1.0 / n) if (normalize and sign > 0) else 1.0
    seq = _Seq(mesh, batch_axis, seq_axis)
    return _six_step(seq, n, sign, norm, _fft_df64)


def _block(x, mesh, batch_axis: str, seq_axis: str) -> torch.Tensor:
    """This rank's (B/dp, n/S) block of the whole (B, n) plane ``x``
    (numpy, or a tensor on the mesh's device), on the mesh's device."""
    device = _device(mesh)
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"planes on {x.device}, but the mesh runs on "
                             f"{device}; move them first")
    else:
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.ndim != 2:
        raise ValueError(f"dist_fft_1d takes (B, n) planes, got "
                         f"{tuple(x.shape)}")
    (b, n), dp, sp = x.shape, _size(mesh, batch_axis), _size(mesh, seq_axis)
    if b % dp or n % sp:
        raise ValueError(f"planes of shape {(b, n)} do not divide over a "
                         f"({dp}, {sp}) mesh")
    i, j = mesh.get_local_rank(batch_axis), mesh.get_local_rank(seq_axis)
    return x[i * (b // dp):(i + 1) * (b // dp),
             j * (n // sp):(j + 1) * (n // sp)].to(device).contiguous()


def dist_fft_1d(re, im, mesh, *, sign: int = -1, batch_axis: str = "dp",
                seq_axis: str = "sp", normalize: bool = False):
    """One-shot distributed FFT of whole planar (B, n) planes, as every
    rank holds them (numpy, or tensors on the mesh's device): cuts this
    rank's block, puts it on the mesh's device, and returns this rank's
    (B/dp, n/S) output blocks."""
    n = re.shape[-1]
    fn = make_dist_fft(mesh, n, batch_axis=batch_axis, seq_axis=seq_axis,
                       sign=sign, normalize=normalize)
    return fn(_block(re, mesh, batch_axis, seq_axis),
              _block(im, mesh, batch_axis, seq_axis))
