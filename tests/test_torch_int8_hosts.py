"""The int8-split stage K10 (``precision="int8"``) in its other hosts,
against the JAX package on the CPU: the digit-swapped row pass K4
(``local.fft_rows_swap``), the fused 2D kernels K8 and K9
(``fused2d.fft2_fused``, ``fused2d.fft2_fused_tiled``) and the native-layout
column pass (``local.fft_axis_fold``, the JAX fold kernel K7).

A CPU tensor takes each host's plain torch version, which groups the int8
stage's alignment exponent as the JAX kernel does: K4 by blocks of
``lanes`` rows, K8 by plane, K9 by 128-column slices (y) and 128-row slices
(x) of each plane, the fold by slices of ``fold_lanes`` columns of each l.
Gates: within 1e-6 of the JAX function in interpret mode relative to the
peak (of each alignment group where the groups hold data 2^20 apart), and
within 2e-6 (tests/helpers.py TOL) of numpy.  The JAX calls are kept small
(under about a second each): the fold runs with ``by=1``, which changes
nothing but JAX's grid.  The CUDA kernels are checked on the card by
chip_smoke.py (phase 20).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import fused2d, local
from pyfft_tpu_torch.utils import profiling

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]
PARITY = 1e-6


def planar(x):
    return (np.ascontiguousarray(np.real(x)).astype(np.float32),
            np.ascontiguousarray(np.imag(x)).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def torch_planes(x):
    return tuple(torch.from_numpy(a) for a in planar(x))


def ref_fft(x, axes, sign):
    """numpy's unnormalised DFT over ``axes`` in the direction ``sign``."""
    x = x.astype(np.complex128)
    if sign < 0:
        return np.fft.fftn(x, axes=axes)
    return np.fft.ifftn(x, axes=axes) * np.prod([x.shape[a] for a in axes])


def groups_err(got, want, splits):
    """The worst error of any group of ``got`` against its own peak in
    ``want``; ``splits`` is [(axis, size)]."""
    parts = [(np.asarray(got), np.asarray(want))]
    for axis, size in splits:
        parts = [(g[(slice(None),) * axis + (slice(i, i + size),)],
                  w[(slice(None),) * axis + (slice(i, i + size),)])
                 for g, w in parts for i in range(0, g.shape[axis], size)]
    return max(rel_err(g, w) for g, w in parts)


# ------------------------------------------------------------- K4 + K10


@pytest.mark.parametrize("n", [16, 256, 2048])
@pytest.mark.parametrize("n1", [128, 256])
@pytest.mark.parametrize("lanes", [128, 64])
def test_swap_int8_matches_jax(n, n1, lanes):
    L = 1 if n == 2048 else 2
    sign = -1 if lanes == 128 else 1
    x = rand_complex((L, n1, n), seed=n + n1 + lanes)
    got = cplx(local.fft_rows_swap(*torch_planes(x), sign, postscale=0.3,
                                   lanes=lanes, precision="int8"))
    jgot = cplx(jax_local._fft_rows_swap(
        *(jnp.asarray(a) for a in planar(x)), sign=sign, postscale=0.3,
        interpret=True, precision="int8", lanes=lanes))
    ref = (ref_fft(x, (-1,), sign) * 0.3).transpose(0, 2, 1)
    assert got.shape == jgot.shape == ref.shape == (L, n, n1)
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_swap_int8_groups_as_jax_blocks():
    """Row blocks 2^20 apart: each block of ``lanes`` rows matches JAX at
    1e-6 against its own peak; one exponent over all rows misses it."""
    n, n1 = 256, 256
    x = rand_complex((1, n1, n), seed=40)
    x[:, 128:] *= 2.0 ** -20
    got = cplx(local.fft_rows_swap(*torch_planes(x), -1, precision="int8"))
    jgot = cplx(jax_local._fft_rows_swap(
        *(jnp.asarray(a) for a in planar(x)), sign=-1, postscale=1.0,
        interpret=True, precision="int8"))
    ref = ref_fft(x, (-1,), -1).transpose(0, 2, 1)
    assert groups_err(got, jgot, [(2, 128)]) < PARITY
    assert groups_err(got, ref, [(2, 128)]) < C64
    whole = cplx(local.fft_rows_swap_plain(*torch_planes(x), -1,
                                           precision="int8", lanes=n1))
    assert rel_err(whole, jgot) < PARITY          # invisible at the peak
    assert groups_err(whole, jgot, [(2, 128)]) > 100 * PARITY


def test_swap_int8_at_n8_changes_nothing():
    """n = 8 has no matrix stage: int8 is the float path, bit for bit."""
    x = torch_planes(rand_complex((2, 128, 8), seed=41))
    a = local.fft_rows_swap(*x, -1, precision="int8")
    b = local.fft_rows_swap(*x, -1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------------------------------- K8, K9 + K10


@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 256, 128)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fused2d_int8_matches_jax(shape, sign):
    x = rand_complex(shape, seed=sum(shape) + sign)
    got = cplx(fused2d.fft2_fused(*torch_planes(x), sign, postscale=0.5,
                                  precision="int8"))
    jgot = cplx(jax_local.fft2_fused(*planar(x), sign, postscale=0.5,
                                     precision="int8", interpret=True))
    ref = ref_fft(x, (-2, -1), sign) * 0.5
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


@pytest.mark.parametrize("shape", [(1, 256, 128), (2, 128, 256)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_tiled_int8_matches_jax(shape, sign):
    x = rand_complex(shape, seed=sum(shape) - sign)
    got = cplx(fused2d.fft2_fused_tiled(*torch_planes(x), sign,
                                        postscale=0.5, precision="int8"))
    jgot = cplx(jax_local.fft2_fused_tiled(*planar(x), sign, postscale=0.5,
                                           precision="int8", interpret=True))
    ref = ref_fft(x, (-2, -1), sign) * 0.5
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


@pytest.mark.parametrize("kernel", ["K8", "K9"])
def test_fused_int8_groups_per_plane(kernel):
    """Planes 2^20 apart: each plane matches JAX at 1e-6 against its own
    peak; one exponent over all planes (the plain version with every
    plane in one group) misses it."""
    L, ny, nx = 3, 128, 128
    x = rand_complex((L, ny, nx), seed=42)
    x[1] *= 2.0 ** -20
    x[2] *= 2.0 ** 10
    if kernel == "K8":
        fn, jfn = fused2d.fft2_fused, jax_local.fft2_fused
        fy, fx = local.default_factors(ny), local.default_factors(nx)
    else:
        fn, jfn = fused2d.fft2_fused_tiled, jax_local.fft2_fused_tiled
        fy, fx = local.col_factors(ny), local.col_factors(nx)
    got = cplx(fn(*torch_planes(x), -1, precision="int8"))
    jgot = cplx(jfn(*planar(x), -1, precision="int8", interpret=True))
    ref = ref_fft(x, (-2, -1), -1)
    assert groups_err(got, jgot, [(0, 1)]) < PARITY
    assert groups_err(got, ref, [(0, 1)]) < C64
    whole = cplx(fused2d._fft2_plain(*torch_planes(x), -1, 1.0, fy, fx,
                                     "int8", L * nx, L * ny))
    assert rel_err(whole, jgot) < PARITY
    assert groups_err(whole, jgot, [(0, 1)]) > 100 * PARITY


# ----------------------------------------------------- the fold (K7 + K10)


@pytest.mark.parametrize("shape", [(1, 256, 8, 384), (1, 256, 8, 256),
                                   (1, 1024, 8, 128)])
def test_fold_int8_matches_jax(shape):
    x = rand_complex(shape, seed=shape[1] + shape[3])
    got = cplx(local.fft_axis_fold(*torch_planes(x), -1, axis=1,
                                   postscale=0.3, precision="int8"))
    jgot = cplx(jax_local.fft_axis_fold(*planar(x), -1, axis=1,
                                        postscale=0.3, precision="int8",
                                        interpret=True, by=1))
    ref = ref_fft(x, (1,), -1) * 0.3
    assert got.shape == jgot.shape == shape
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_fold_float_matches_jax():
    x = rand_complex((2, 64, 8, 256), seed=44)
    got = cplx(local.fft_axis_fold(*torch_planes(x), 1, axis=1))
    jgot = cplx(jax_local.fft_axis_fold(*planar(x), 1, axis=1,
                                        interpret=True, by=1))
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref_fft(x, (1,), 1)) < C64


@pytest.mark.parametrize("shape", [(1, 256, 8, 384), (1, 256, 8, 128)])
def test_fold_int8_groups_are_its_slices(shape):
    """Every other 128-column slice of the trail 2^20 above the rest: the
    fold's groups are its 128-lane slices, so each slice matches JAX's fold
    and numpy; fft_axis groups 256 columns of the flattened trail here,
    across two slices, and misses numpy on the small ones, as JAX's
    fft_axis does (the two agree per 256 columns)."""
    x = rand_complex(shape, seed=45)
    L, n = shape[:2]
    x.reshape(L, n, -1, 128)[:, :, 1::2] *= 2.0 ** 20
    assert local.fold_lanes(n, shape[-1]) == 128

    def flat(a):                       # (L, n, trail) -> (L, n, T)
        return np.asarray(a).reshape(L, n, -1)

    got = flat(cplx(local.fft_axis_fold(*torch_planes(x), -1, axis=1,
                                        precision="int8")))
    jgot = flat(cplx(jax_local.fft_axis_fold(*planar(x), -1, axis=1,
                                             precision="int8",
                                             interpret=True, by=1)))
    ref = flat(ref_fft(x, (1,), -1))
    assert groups_err(got, jgot, [(0, 1), (2, 128)]) < PARITY
    assert groups_err(got, ref, [(0, 1), (2, 128)]) < C64
    axis = flat(cplx(local.fft_axis(*torch_planes(x), -1, axis=1,
                                    precision="int8")))
    jaxis = flat(cplx(jax_local.fft_axis(
        *planar(x), -1, axis=1, precision="int8", interpret=True,
        factors=local.col_factors(n))))
    assert groups_err(axis, jaxis, [(0, 1), (2, 256)]) < PARITY
    assert groups_err(axis, ref, [(0, 1), (2, 128)]) > 100 * C64


@pytest.mark.parametrize("n", [4, 8, 96, 256, 512, 1024, 8192, 16384])
def test_supported_fold_is_jax_rule(n):
    """supported_fold against pallas_local.supported_fold over a grid of
    trails (shapes only: zero-stride views, no memory)."""
    trails = [(8,), (128,), (8, 128), (8, 256), (8, 384), (8, 512),
              (8, 640), (8, 96), (4, 128), (16, 128), (12, 256), (2, 8, 128),
              (1, 8, 128), (3, 8, 256), (8, 64), (1, 8, 8)]
    for lead in ((), (2,)):
        for trail in trails:
            shape = lead + (n,) + trail
            axis = len(lead)
            for dtype, np_dtype in ((torch.float32, np.float32),
                                    (torch.float64, np.float64)):
                t = torch.zeros((), dtype=dtype).expand(shape)
                a = np.broadcast_to(np_dtype(0), shape)
                want = jax_local.supported_fold(a, axis)
                assert local.supported_fold(t, axis) == want, (shape, dtype)
                assert local.supported_fold(t, axis - len(shape)) == want


def test_fold_refusals():
    z = torch.zeros(1, 256, 8, 1024)          # n * x_ext above 2^17
    with pytest.raises(ValueError, match="does not cover"):
        local.fft_axis_fold(z, z, -1, axis=1)
    z = torch.zeros(1, 64, 8, 128)
    with pytest.raises(ValueError, match="does not cover"):
        local.fft_axis_fold(z, z, -1, axis=2)    # one trailing axis
    with pytest.raises(ValueError, match="by="):
        local.fft_axis_fold(z, z, -1, axis=1, by=3)
    with pytest.raises(ValueError, match="'highest' or 'int8'"):
        local.fft_axis_fold(z, z, -1, axis=1, precision="default")
    d = z.double()
    with pytest.raises(ValueError, match="does not cover"):
        local.fft_axis_fold(d, d, -1, axis=1, precision="int8")
    out = (torch.empty_like(z), torch.empty_like(z))
    got = local.fft_axis_fold(z + 1, z, -1, axis=1, by=2, out=out)
    assert got[0] is out[0] and float(got[0][0, 0].max()) == 64.0


# ------------------------------------------------------- launch wrappers


def test_int8_host_launch_checks_raise_before_any_launch():
    """The new int8 launch wrappers refuse CPU planes before the library
    is touched."""
    before = profiling.counts()
    z = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        local._launch_rows_swap(z, z, z.clone(), z.clone(), -1, 1.0,
                                i8_f=128)
    with pytest.raises(ValueError, match="CUDA"):
        fused2d._launch(z, z, z, z, -1, 1.0, int8=True)
    with pytest.raises(ValueError, match="CUDA"):
        fused2d._launch_tiled(z, z, z, z, -1, 1.0, int8=True)
    assert profiling.counts() == before


@pytest.mark.cuda
def test_int8_hosts_on_the_card():
    """K4, K8 and K9 with the int8 stage and the fold against their plain
    versions on a CUDA card (chip_smoke.py phase 20 does the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = rand_complex((2, 128, 256), seed=46)
    re, im = (t.cuda() for t in torch_planes(x))
    for fn, plain, key in (
            (local.fft_rows_swap, local.fft_rows_swap_plain,
             "launch.K4+K10"),
            (fused2d.fft2_fused, fused2d.fft2_plain, "launch.K8+K10"),
            (fused2d.fft2_fused_tiled, fused2d.fft2_tiled_plain,
             "launch.K9+K10")):
        before = profiling.total(key)
        got = fn(re, im, -1, precision="int8")
        torch.cuda.synchronize()
        assert profiling.total(key) == before + 1
        want = plain(re, im, -1, precision="int8")
        assert rel_err(cplx([t.cpu() for t in got]),
                       cplx([t.cpu() for t in want])) < C64
    x = rand_complex((2, 128, 8, 128), seed=47)
    re, im = (t.cuda() for t in torch_planes(x))
    before = profiling.total("launch.K5+K10")
    got = local.fft_axis_fold(re, im, -1, axis=1, precision="int8", by=2)
    torch.cuda.synchronize()
    assert profiling.total("launch.K5+K10") == before + 1
    want = local.fft_cols_plain(re.view(2, 128, 1024), im.view(2, 128, 1024),
                                -1, precision="int8", lanes=128)
    assert rel_err(cplx([t.cpu().reshape(2, 128, 1024) for t in got]),
                   cplx([t.cpu() for t in want])) < C64


# ------------------------------------------- K4 + K10's groups and lanes


def i8_width(n: int) -> int:
    """ColShape<log2 n, float, true>::C of csrc/local_cols.cu: the rows a
    K4 + K10 block takes (32 KB, at most 128 rows, at least a sector's 8
    within 64 KB)."""
    point = 8
    return max(min(32768 // (n * point), 128), min(65536 // (n * point), 8))


@pytest.fixture
def stub_widths(monkeypatch):
    """The int8 column library's width entry without nvcc: the source's
    rule, so col_width_i8 and swap_i8_group run on the CPU."""
    width = lambda log2n: i8_width(1 << log2n)
    monkeypatch.setattr(local, "_cols_i8_lib", lambda: (None, width))


@pytest.mark.parametrize("n,lanes,want", [
    (16, 64, 64), (16, 128, 128), (32, 64, 64), (32, 128, 128),
    (64, 32, 32), (64, 128, 64), (2048, 96, 4), (16, 384, 128),
    (16, 3, 1)])
def test_swap_i8_group_lies_inside_a_jax_group(stub_widths, n, lanes, want):
    """A K4 + K10 group is gcd(block rows, lanes) rows: it divides the
    block (so blocks hold whole groups) and ``lanes`` (so it lies inside
    one of JAX's groups); where one of the two divides the other it is
    the smaller, JAX's own group where lanes divides the block."""
    c = local.col_width_i8(n)
    assert c == i8_width(n)
    g = local.swap_i8_group(n, lanes)
    assert g == want and c % g == 0 and lanes % g == 0
    if c % lanes == 0 or lanes % c == 0:
        assert g == min(c, lanes)


def test_width_rule_matches_the_source():
    """i8_width mirrors ColShape's I8 rule as the source states it."""
    src = (Path(local.__file__).parent / "csrc" / "local_cols.cu").read_text()
    assert "constexpr int WIDE = 64 * 1024;" in src
    assert "constexpr int DEEP = 128 * 1024;" in src
    assert "static constexpr int W = WIDE / (I8 ? 2 : 1) / BYTES;" in src
    assert [i8_width(1 << k) for k in range(3, 14)] == [
        128, 128, 128, 64, 32, 16, 8, 8, 4, 2, 1]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, to walk the card branch
    of a wrapper up to its launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("lanes", [64, 128])
def test_swap_int8_card_branch_reaches_the_launch(stub_widths, monkeypatch,
                                                  n, lanes):
    """lanes = 64 at n = 16 and 32, where the block holds 128 rows, once
    refused on the card: fft_rows_swap now hands it to K4 + K10's launch,
    with the matrix factor and lanes, whose group is then lanes rows."""
    seen = []

    def launch(re, im, out_re, out_im, sign, postscale, i8_f=0,
               lanes=local.MIN_TRAIL):
        seen.append((i8_f, lanes, local.swap_i8_group(n, lanes)))
        return out_re, out_im

    monkeypatch.setattr(local, "_launch_rows_swap", launch)
    z = torch.zeros(2, 256, n).as_subclass(_OnCard)
    out = (torch.empty(2, n, 256), torch.empty(2, n, 256))
    got = local.fft_rows_swap(z, z, -1, lanes=lanes, precision="int8",
                              out=out)
    assert got[0] is out[0]
    assert seen == [(n, lanes, lanes)]
