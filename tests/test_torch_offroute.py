"""The kernels no ``Plan`` route takes, against the JAX package on the CPU:
the digit-swapped row pass K4 (``local.fft_rows_swap``), the multi-tile
column pass K6 (``local.fft_axis(..., ctile=c)``) and the tiled one-launch
2D DFT K9 (``fused2d.fft2_fused_tiled``), each beside its JAX function in
interpret mode (``pallas_local.fft_rows_swap``, ``fft_axis(ctile=)``,
``fft2_fused_tiled``).

A CPU tensor takes the plain torch versions.  Gates: within 1e-6 of the
JAX function relative to the peak, and within 2e-6 (tests/helpers.py TOL)
of numpy.  Column chains are passed to JAX explicitly, since its
``col_factors`` can read a per-machine autotune record.  The CUDA kernels
themselves are checked on the card by chip_smoke.py (phases 17 and 18).
"""

import numpy as np
import pytest
import torch

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


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("sign,postscale", [(-1, 1.0), (+1, 1.0 / 512)])
def test_rows_swap_matches_jax(sign, postscale):
    x = rand_complex((2, 256, 512), seed=77 + sign)
    got = cplx(local.fft_rows_swap(*torch_planes(x), sign,
                                   postscale=postscale))
    jgot = cplx(jax_local.fft_rows_swap(*planar(x), sign,
                                        postscale=postscale, interpret=True))
    x128 = x.astype(np.complex128)
    X = np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * 512
    ref = (X * postscale).transpose(0, 2, 1)
    assert got.shape == jgot.shape == (2, 512, 256)
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_rows_swap_plain_runs_the_default_chain():
    """The plain version is ``tile_fft`` with ``default_factors(n)`` (not
    ``row_factors``), then the postscale, then the swap, as JAX's kernel."""
    x = rand_complex((3, 128, 2048), seed=5)
    re, im = torch_planes(x)
    n = 2048
    assert local.row_factors(n) != local.default_factors(n)
    got = local.fft_rows_swap_plain(re, im, -1, 0.5)
    want = local.fft_rows_plain(re, im, -1, 0.5, local.default_factors(n))
    assert torch.equal(got[0], want[0].transpose(-1, -2))
    assert torch.equal(got[1], want[1].transpose(-1, -2))
    assert got[0].is_contiguous()


def test_fourstep_variant_b_matches_jax():
    """A column pass with the full twiddle, then K4: the whole DFT in
    order (tests/test_pallas_local.py's variant B), in both packages."""
    n1, n2 = 256, 512
    n = n1 * n2
    x = rand_complex((2, n), seed=78)
    re, im = planar(x)
    f1 = local.col_factors(n1)
    r, i = local.fft_axis(*(torch.from_numpy(a.reshape(2, n1, n2))
                            for a in (re, im)), -1, axis=-2, tw_n=n,
                          factors=f1)
    got = cplx(local.fft_rows_swap(r, i, -1, postscale=2.0)).reshape(2, n)
    jr, ji = jax_local.fft_axis(re.reshape(2, n1, n2), im.reshape(2, n1, n2),
                                -1, axis=-2, tw_n=n, factors=f1,
                                interpret=True)
    jgot = cplx(jax_local.fft_rows_swap(jr, ji, -1, postscale=2.0,
                                        interpret=True)).reshape(2, n)
    ref = 2.0 * np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_rows_swap_out_and_layouts():
    """``out=`` names the (..., n, n1) planes; the stride-2 planes of a
    complex tensor give a complex-layout output; leading axes fold."""
    x = rand_complex((2, 3, 128, 64), seed=9)
    ref = np.fft.fft(x.astype(np.complex128)).swapaxes(-1, -2) * 0.5
    out = (torch.empty(2, 3, 64, 128), torch.empty(2, 3, 64, 128))
    rr, ii = local.fft_rows_swap(*torch_planes(x), -1, postscale=0.5,
                                 out=out)
    assert rr is out[0] and ii is out[1]
    assert rel_err(cplx((rr, ii)), ref) < C64
    v = torch.view_as_real(torch.from_numpy(x.copy()))
    rr, ii = local.fft_rows_swap(v[..., 0], v[..., 1], -1, postscale=0.5)
    assert tuple(rr.shape) == (2, 3, 64, 128)
    assert rel_err(cplx((rr, ii)), ref) < C64


@pytest.mark.parametrize("shape,kw", [
    ((2, 96, 64), {}),                         # n1 not a multiple of 128
    ((2, 256, 64), dict(lanes=512)),           # n1 not a multiple of lanes
    ((2, 128, 48), {}),                        # n not a power of two
    ((2, 128, 4), {}),                         # n below 8
    ((128, 16384), {}),                        # n above 8192
    ((64,), {}),                               # one axis
])
def test_rows_swap_refuses_shapes(shape, kw):
    z = torch.zeros(shape)
    with pytest.raises(ValueError):
        local.fft_rows_swap(z, z, -1, **kw)


def test_rows_swap_refuses_float64_and_in_place():
    z = torch.zeros(2, 128, 64, dtype=torch.float64)
    with pytest.raises(ValueError):
        local.fft_rows_swap(z, z, -1)
    sq = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="out of place"):
        local.fft_rows_swap(sq, sq.clone(), -1, out=(sq, torch.zeros(
            128, 128)))


def test_rows_swap_launch_checks_raise_before_any_launch():
    """K4's wrapper refuses CPU planes before the library is touched."""
    before = profiling.counts()
    z, o = torch.zeros(2, 128, 64), torch.zeros(2, 64, 128)
    with pytest.raises(ValueError):
        local._launch_rows_swap(z, z, o, o, -1, 1.0)
    assert profiling.counts() == before


# ------------------------------------------------------------------ K6


@pytest.mark.parametrize("tw_n", [0, 256 * 16])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cols_ctile_matches_jax(tw_n, sign):
    """tests/test_pallas_local.py's ctile case in both packages."""
    shape = (2, 256, 1024)
    x = rand_complex(shape, seed=7 + sign)
    f = local.col_factors(256)
    got = cplx(local.fft_axis(*torch_planes(x), sign, axis=1, tw_n=tw_n,
                              ctile=8, postscale=0.5, factors=f))
    jgot = cplx(jax_local.fft_axis(*planar(x), sign, axis=1, tw_n=tw_n,
                                   ctile=8, postscale=0.5, factors=f,
                                   interpret=True))
    x128 = x.astype(np.complex128)
    ref = (np.fft.fft(x128, axis=1) if sign < 0
           else np.fft.ifft(x128, axis=1) * 256)
    if tw_n:
        k = np.arange(256)[:, None]
        j = np.arange(1024)[None, :]
        ref = ref * np.exp(sign * 2j * np.pi * k * j / tw_n)[None]
    ref = ref * 0.5
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_cols_ctile_is_the_column_function():
    """On the CPU ``ctile`` changes no number: K6's plain version is the
    column kernel's, with ``col_factors(n)``."""
    x = rand_complex((3, 64, 512), seed=8)
    re, im = torch_planes(x)
    a = local.fft_axis(re, im, -1, axis=1, ctile=4, tw_n=64 * 512)
    b = local.fft_cols_plain(re, im, -1, tw_n=64 * 512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("T,ctile,want", [
    (1024, 8, 8), (1024, 16, 8), (384, 8, 1), (384, 3, 3), (768, 8, 2),
    (128, 8, 1), (2048, 5, 2), (512, 1, 1)])
def test_ctile_clamps_like_jax(T, ctile, want):
    """c halves until it divides the tile count T // 128, as
    pallas_local._fft_cols_ctile's loop."""
    assert local.clamp_ctile(T, ctile) == want
    tiles, c = T // 128, ctile
    while c > 1 and tiles % c:
        c //= 2
    assert c == want


@pytest.mark.parametrize("kw", [
    dict(swap_store=True),
    dict(swap_mid=128),
    dict(tw_n=64 * 2, tw_mode="strided", tw_period=128),
    dict(tw_n=64 * 256, tw_mode="factored"),
    dict(ctile=-1),
])
def test_cols_ctile_refuses_modes(kw):
    kw = dict(kw)
    ctile = kw.pop("ctile", 8)
    z = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError):
        local.fft_axis(z, z, -1, axis=1, ctile=ctile, **kw)


@pytest.mark.parametrize("shape,axis,dtype", [
    ((2, 64, 192), 1, torch.float32),       # trail not whole 128-tiles
    ((2, 64, 256), -1, torch.float32),      # the row axis
    ((2, 64, 256), 1, torch.float64),       # complex128 planes
])
def test_cols_ctile_refuses_operands(shape, axis, dtype):
    z = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        local.fft_axis(z, z, -1, axis=axis, ctile=2)


def test_ctile_launch_checks_raise_before_any_launch():
    before = profiling.counts()
    z = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError):
        local._launch_cols(z, z, z, z, -1, axis=1, postscale=1.0, tw_n=0,
                           tw_mode="full", tw_period=0, swap_store=False,
                           swap_mid=0, ctile=2)
    assert profiling.counts() == before


# ------------------------------------------------------------------ K9


def fft2_ref(x, sign, postscale=1.0):
    x = x.astype(np.complex128)
    ny, nx = x.shape[-2:]
    X = np.fft.fft2(x) if sign < 0 else np.fft.ifft2(x) * (ny * nx)
    return X * postscale


@pytest.mark.parametrize("shape", [(256, 128), (2, 128, 256)])
@pytest.mark.parametrize("sign,postscale", [(-1, 1.0), (+1, 0.25)])
def test_fused2d_tiled_matches_jax(shape, sign, postscale):
    x = rand_complex(shape, seed=sum(shape) + sign)
    ny, nx = shape[-2:]
    fy, fx = local.col_factors(ny), local.col_factors(nx)
    got = cplx(fused2d.fft2_fused_tiled(*torch_planes(x), sign,
                                        postscale=postscale))
    jgot = cplx(jax_local.fft2_fused_tiled(*planar(x), sign,
                                           postscale=postscale, factors_y=fy,
                                           factors_x=fx, interpret=True))
    ref = fft2_ref(x, sign, postscale)
    assert got.shape == jgot.shape == shape
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_fused2d_tiled_round_trip():
    """Forward, then inverse with postscale 1/size, on (128, 128); in place
    through ``out`` the second time."""
    x = rand_complex((128, 128), seed=14)
    re, im = torch_planes(x)
    fr, fi = fused2d.fft2_fused_tiled(re, im, -1)
    assert rel_err(cplx((fr, fi)), fft2_ref(x, -1)) < C64
    br, bi = fused2d.fft2_fused_tiled(fr, fi, +1, postscale=1.0 / 128 ** 2,
                                      out=(fr, fi))
    assert br is fr and bi is fi
    assert rel_err(cplx((br, bi)), x) < C64


def test_fused2d_tiled_plain_runs_the_col_chains():
    """K9's plain version is ``fft2_plain`` with ``col_factors`` on both
    axes (pallas_local._fft2_fused_tiled's defaults), where K8's takes
    ``default_factors``."""
    x = rand_complex((2, 256, 1024), seed=15)
    re, im = torch_planes(x)
    assert local.col_factors(1024) != local.default_factors(1024)
    got = fused2d.fft2_tiled_plain(re, im, +1, 0.5)
    want = fused2d.fft2_plain(re, im, +1, 0.5, local.col_factors(256),
                              local.col_factors(1024))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape,want", [
    ((1024, 1024), True), ((3, 128, 8192), True), ((8192, 128), True),
    ((512, 2048), True), ((2048, 1024), False), ((96, 128), False),
    ((128, 96), False), ((64, 128), False), ((128,), False)])
def test_supported_2d_tiled(shape, want):
    assert fused2d.supported_2d_tiled(torch.zeros(shape)) is want
    assert not fused2d.supported_2d_tiled(
        torch.zeros(shape, dtype=torch.float64))
    assert fused2d.MAX_FUSED2D_TILED_ELEMS == \
        jax_local.MAX_FUSED2D_TILED_ELEMS


def test_fused2d_tiled_refuses_and_checks_before_launch():
    with pytest.raises(ValueError):
        fused2d.fft2_fused_tiled(torch.zeros(2048, 1024),
                                 torch.zeros(2048, 1024), -1)
    with pytest.raises(ValueError):
        fused2d.fft2_fused_tiled(torch.zeros(128, 128, device="meta"),
                                 torch.zeros(128, 128, device="meta"), -1)
    before = profiling.counts()
    z = torch.zeros(128, 128)
    with pytest.raises(ValueError):
        fused2d._launch_tiled(z, z, z, z, -1, 1.0)
    assert profiling.counts() == before
