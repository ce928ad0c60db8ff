"""The port's row path (``pyfft_tpu_torch.ops.local``) against the JAX
package's (``pyfft_tpu.ops.pallas_local``) on the CPU.

The plain ``tile_fft`` runs on the very tables JAX's ``tile_fft`` runs on;
``fft_axis`` on a CPU tensor is held against JAX's ``fft_axis`` with the
Pallas kernel in interpret mode, as tests/test_pallas_local.py runs it.
Factors are passed to both packages explicitly: JAX's ``row_factors`` can
read a per-machine autotune record.  Gate: 2e-6 (tests/helpers.py TOL),
against numpy.fft and between the packages.  The CUDA kernel itself is
checked on the card by chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.utils import profiling

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]


def planar(x):
    return (np.ascontiguousarray(np.real(x)).astype(np.float32),
            np.ascontiguousarray(np.imag(x)).astype(np.float32))


def both_tile_ffts(x, n, factors, stacked, sign):
    """(torch result, JAX result) of tile_fft over axis 0 of x, on the
    tables JAX's needed_tables builds."""
    tables = jax_local.needed_tables(n, sign, factors=factors,
                                     stacked=stacked)
    re, im = planar(x)
    tr, ti = local.tile_fft(torch.from_numpy(re), torch.from_numpy(im),
                            local.tables_from_numpy(tables, "cpu"), n,
                            factors, stacked=stacked, sign=sign)
    jt = {k: tuple(jnp.asarray(a) for a in v) for k, v in tables.items()}
    jr, ji = jax_local.tile_fft(jnp.asarray(re), jnp.asarray(im), jt, n,
                                factors, stacked=stacked, sign=sign)
    return (tr.numpy() + 1j * ti.numpy(),
            np.asarray(jr) + 1j * np.asarray(ji))


def dft_ref(x, sign, axis):
    x = x.astype(np.complex128)
    if sign < 0:
        return np.fft.fft(x, axis=axis)
    return np.fft.ifft(x, axis=axis) * x.shape[axis]


@pytest.mark.parametrize("n", [8, 16, 64, 128, 256, 1024, 4096])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("sign", [-1, 1])
def test_tile_fft_matches_jax(n, stacked, sign):
    """Default chains, stacked and non-stacked (_cdot) matrix stages."""
    x = rand_complex((n, 16), seed=n)
    factors = local.default_factors(n)
    got, jgot = both_tile_ffts(x, n, factors, stacked, sign)
    ref = dft_ref(x, sign, 0)
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("factors", [
    (8, 8, 64),            # config 2's chain: radix-8 and the folded stage
    (8, 2, 64),            # folded after a radix-2
    (4, 4, 2, 64),         # ROW_FACTORS[2048]
    (4, 4, 4, 128),        # default 8192 chain, folded
    (16, 16, 16),
    (4, 32, 32),
    (2, 2, 2, 2),
    (8, 8, 8),             # butterflies only
])
@pytest.mark.parametrize("sign", [-1, 1])
def test_tile_fft_chains_match_jax(factors, sign):
    n = math.prod(factors)
    x = rand_complex((n, 8), seed=n + 1)
    got, jgot = both_tile_ffts(x, n, factors, True, sign)
    ref = dft_ref(x, sign, 0)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("n", [8, 32, 256, 2048])
def test_tile_fft_precise_chain_matches_jax(n):
    """fast_math=False chains (all butterflies)."""
    factors = local.precise_factors(n)
    assert factors == jax_local.precise_factors(n)
    x = rand_complex((n, 8), seed=n + 2)
    got, jgot = both_tile_ffts(x, n, factors, True, -1)
    assert rel_err(got, dft_ref(x, -1, 0)) < C64
    assert rel_err(got, jgot) < C64


def both_fft_axis(x, sign, postscale=1.0):
    n = x.shape[-1]
    factors = local.row_factors(n)
    re, im = planar(x)
    tr, ti = local.fft_axis(torch.from_numpy(re), torch.from_numpy(im), sign,
                            axis=-1, postscale=postscale, factors=factors)
    jr, ji = jax_local.fft_axis(re, im, sign, axis=-1, postscale=postscale,
                                factors=factors)
    assert tuple(tr.shape) == x.shape
    return (tr.numpy() + 1j * ti.numpy(),
            np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("n", [8, 128, 1024, 4096])
@pytest.mark.parametrize("rows", [1, 8, 40, 130])
def test_fft_axis_matches_jax_kernel(n, rows):
    x = rand_complex((rows, n), seed=rows * 7 + n)
    got, jgot = both_fft_axis(x, -1)
    ref = dft_ref(x, -1, -1)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("n", [512, 4096])
def test_fft_axis_inverse_postscale_matches_jax(n):
    x = rand_complex((16, n), seed=5)
    got, jgot = both_fft_axis(x, +1, postscale=1.0 / n)
    assert rel_err(got, np.fft.ifft(x.astype(np.complex128))) < C64
    assert rel_err(got, jgot) < C64


def test_fft_axis_leading_dims_matches_jax():
    x = rand_complex((3, 5, 256), seed=8)
    got, jgot = both_fft_axis(x, -1)
    assert rel_err(got, dft_ref(x, -1, -1)) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("inplace", [False, True])
def test_fft_axis_out_strided_planes(inplace):
    """The complex form's operands: the two stride-2 planes of
    view_as_real, written into given planes (in place when they are the
    inputs)."""
    x = rand_complex((6, 256), seed=11)
    xt = torch.from_numpy(x.copy())
    v = torch.view_as_real(xt)
    if inplace:
        out = (v[..., 0], v[..., 1])
        y = xt
    else:
        y = torch.empty_like(xt)
        yv = torch.view_as_real(y)
        out = (yv[..., 0], yv[..., 1])
    rr, ii = local.fft_axis(v[..., 0], v[..., 1], -1, postscale=0.5, out=out)
    assert rr is out[0] and ii is out[1]
    assert rel_err(y.numpy(), 0.5 * dft_ref(x, -1, -1)) < C64


def test_supported():
    a = torch.zeros(4, 1024)
    assert local.supported(a, 1)
    assert local.supported(a, -1)
    assert not local.supported(a, 0)
    assert not local.supported(torch.zeros(4, 24), 1)
    assert not local.supported(torch.zeros(4, 4), 1)
    # float64 (complex128) up to MAX_LOCAL_N_DF64 = 4096
    assert local.supported(torch.zeros(4, 1024, dtype=torch.float64), 1)
    assert local.supported(torch.zeros(4, 4096, dtype=torch.float64), 1)
    assert not local.supported(torch.zeros(4, 8192, dtype=torch.float64), 1)
    assert not local.supported(torch.zeros(4, 2 * local.MAX_LOCAL_N), 1)


@pytest.mark.parametrize("shape,axis,dtype", [
    ((4, 1024), 0, torch.float32),              # not the last axis
    ((4, 24), -1, torch.float32),               # not a power of two
    ((4, 4), -1, torch.float32),                # below 8
    ((2, 16384), -1, torch.float32),            # above MAX_LOCAL_N
    ((4, 8192), -1, torch.float64),             # above MAX_LOCAL_N_DF64
])
def test_fft_axis_raises_outside_kernel(shape, axis, dtype):
    z = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        local.fft_axis(z, z, -1, axis=axis)


def test_launch_checks_raise_before_any_launch():
    """The kernel wrapper validates its operands in Python; a CPU tensor
    handed to it directly is refused before the library is touched."""
    before = profiling.counts()
    for dtype in (torch.float32, torch.float64):
        z = torch.zeros(2, 64, dtype=dtype)
        with pytest.raises(ValueError):
            local._launch_rows(z, z, z, z, -1, 1.0)
    assert profiling.counts() == before
