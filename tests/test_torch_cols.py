"""The port's column path (``pyfft_tpu_torch.ops.local.fft_axis`` on an
axis other than the last) against the JAX package's
(``pyfft_tpu.ops.pallas_local.fft_axis`` with the Pallas column kernel in
interpret mode) on the CPU, in every twiddle and store mode.

Factors are passed to both packages explicitly: JAX's ``col_factors`` can
read a per-machine autotune record.  Gate: 2e-6 (tests/helpers.py TOL),
against numpy and between the packages.  The CUDA kernel itself is checked
on the card by chip_smoke.py.
"""

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


def col_reference(x, sign, postscale=1.0, tw_n=0, tw_mode="full",
                  tw_period=0, swap_store=False, swap_mid=0):
    """numpy complex128 of the column pass over axis 1 of (L, n, T)."""
    L, n, T = x.shape
    x = x.astype(np.complex128)
    X = np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * n
    if tw_n:
        k = np.arange(n, dtype=np.int64)[:, None]
        t = np.arange(T, dtype=np.int64)[None, :]
        g = t // tw_period if tw_mode == "strided" else t
        X = X * np.exp(sign * 2j * np.pi * ((k * g) % tw_n) / tw_n)
    X = X * postscale
    if swap_store:
        return X.transpose(0, 2, 1)
    if swap_mid:
        return X.reshape(L, n, T // swap_mid, swap_mid).transpose(0, 2, 1, 3)
    return X


def both_cols(x, sign, factors=None, **kw):
    """(torch, JAX) results of the column pass over axis 1 of x."""
    n = x.shape[1]
    factors = factors or local.col_factors(n)
    re, im = planar(x)
    tr, ti = local.fft_axis(torch.from_numpy(re), torch.from_numpy(im), sign,
                            axis=1, factors=factors, **kw)
    jr, ji = jax_local.fft_axis(re, im, sign, axis=1, factors=factors,
                                interpret=True, **kw)
    assert tuple(tr.shape) == tuple(jr.shape)
    return (tr.numpy() + 1j * ti.numpy(),
            np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("n", [8, 64, 256, 1024])
@pytest.mark.parametrize("L,T", [(1, 128), (3, 256)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cols_plain_store_matches_jax(n, L, T, sign):
    x = rand_complex((L, n, T), seed=n + L + T)
    post = 0.5 if sign < 0 else 1.0 / n
    got, jgot = both_cols(x, sign, postscale=post)
    ref = col_reference(x, sign, post)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


MODES = {
    "full": dict(tw_n=1, tw_mode="full"),
    "full swap_store": dict(tw_n=1, tw_mode="full", swap_store=True),
    "strided": dict(tw_n=1, tw_mode="strided", tw_period=128),
    "strided swap_mid": dict(tw_n=1, tw_mode="strided", tw_period=128,
                             swap_mid=128),
    "factored": dict(tw_n=1, tw_mode="factored"),
    "factored swap_store": dict(tw_n=1, tw_mode="factored",
                                swap_store=True),
    "swap_store": dict(swap_store=True),
    "swap_mid": dict(swap_mid=256),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,L,T", [(64, 3, 256), (256, 1, 256)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cols_modes_match_jax(mode, n, L, T, sign):
    kw = dict(MODES[mode])
    if kw.get("tw_n"):
        # the four-step sizes: tw_n = n * (number of twiddle columns)
        q = T // kw["tw_period"] if kw["tw_mode"] == "strided" else T
        kw["tw_n"] = n * q
    x = rand_complex((L, n, T), seed=len(mode) + n)
    got, jgot = both_cols(x, sign, postscale=0.25, **kw)
    ref = col_reference(x, sign, 0.25, **kw)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("n", [8, 256, 1024])
def test_cols_precise_chain_matches_jax(n):
    """fast_math=False chains (all butterflies) on the column path."""
    factors = local.precise_factors(n)
    x = rand_complex((2, n, 128), seed=n + 3)
    got, jgot = both_cols(x, -1, factors=factors)
    assert rel_err(got, col_reference(x, -1)) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("n", [8, 64, 256, 1024, 2048, 4096])
def test_col_chain_tile_fft_matches_jax(n):
    """The plain column math: tile_fft on JAX's own needed_tables for the
    column chain, in both packages."""
    factors = local.col_factors(n)
    assert factors == (jax_local.COL_FACTORS.get(n)
                       or jax_local.default_factors(n))
    tables = jax_local.needed_tables(n, -1, factors=factors)
    x = rand_complex((n, 16), seed=n + 5)
    re, im = planar(x)
    tr, ti = local.tile_fft(torch.from_numpy(re), torch.from_numpy(im),
                            local.tables_from_numpy(tables, "cpu"), n,
                            factors, sign=-1)
    jt = {k: tuple(jnp.asarray(a) for a in v) for k, v in tables.items()}
    jr, ji = jax_local.tile_fft(jnp.asarray(re), jnp.asarray(im), jt, n,
                                factors, sign=-1)
    got = tr.numpy() + 1j * ti.numpy()
    ref = np.fft.fft(x.astype(np.complex128), axis=0)
    assert rel_err(got, ref) < C64
    assert rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < C64


def test_cols_leading_and_trailing_dims():
    """A column pass over axis 1 of a 4-D tensor: lead 2, trail 4 x 64."""
    x = rand_complex((2, 32, 4, 64), seed=21)
    re, im = planar(x)
    tr, ti = local.fft_axis(torch.from_numpy(re), torch.from_numpy(im), -1,
                            axis=1)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert tr.shape == x.shape
    assert rel_err(tr.numpy() + 1j * ti.numpy(), ref) < C64


@pytest.mark.parametrize("mode", ["plain", "swap_store", "swap_mid"])
def test_cols_out_planes(mode):
    """``out=`` names the planes to write, of the output's shape; a plain
    store may write into its own input."""
    x = rand_complex((2, 64, 256), seed=22)
    kw = {"plain": {}, "swap_store": dict(swap_store=True),
          "swap_mid": dict(swap_mid=128)}[mode]
    ref = col_reference(x, -1, 0.5, **kw)
    xt = torch.from_numpy(x.copy())
    v = torch.view_as_real(xt)
    if mode == "plain":
        out = (v[..., 0], v[..., 1])            # in place, stride-2 planes
    else:
        out = (torch.empty(ref.shape), torch.empty(ref.shape))
    rr, ii = local.fft_axis(v[..., 0], v[..., 1], -1, axis=1, postscale=0.5,
                            out=out, **kw)
    assert rr is out[0] and ii is out[1]
    assert rel_err(rr.numpy() + 1j * ii.numpy(), ref) < C64


def test_supported_column_rule():
    assert local.supported(torch.zeros(64, 128), 0)
    assert local.supported(torch.zeros(3, 64, 2, 64), 1)
    assert not local.supported(torch.zeros(64, 64), 0)        # trail < 128
    assert not local.supported(torch.zeros(4, 128), 0)        # n < 8
    assert not local.supported(torch.zeros(24, 128), 0)       # not 2^k
    assert not local.supported(torch.zeros(16384, 128), 0)    # n > 8192
    assert local.supported(torch.zeros(64, 128, dtype=torch.float64), 0)
    assert not local.supported(                                # > 4096 f64
        torch.zeros(8192, 128, dtype=torch.float64), 0)


@pytest.mark.parametrize("kw", [
    dict(tw_n=64, tw_mode="strided", tw_period=0),            # no period
    dict(tw_n=64, tw_mode="strided", tw_period=96),           # not 128k
    dict(tw_n=64, tw_mode="strided", tw_period=512),          # > trail
    dict(tw_n=64, tw_mode="diagonal"),                        # no such mode
    dict(swap_mid=64),
    dict(swap_mid=128, swap_store=True),
])
def test_cols_mode_errors(kw):
    z = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError):
        local.fft_axis(z, z, -1, axis=1, **kw)


def test_cols_factored_needs_whole_runs():
    z = torch.zeros(1, 64, 192)
    with pytest.raises(ValueError):
        local.fft_axis(z, z, -1, axis=1, tw_n=64 * 192, tw_mode="factored")


def test_row_axis_refuses_column_modes():
    z = torch.zeros(4, 64)
    for kw in (dict(tw_n=64), dict(swap_store=True), dict(swap_mid=128)):
        with pytest.raises(ValueError):
            local.fft_axis(z, z, -1, axis=-1, **kw)


def test_col_launch_checks_raise_before_any_launch():
    """The column kernel's wrapper validates its operands in Python; CPU
    planes handed to it directly are refused before the library is
    touched."""
    before = profiling.counts()
    z = torch.zeros(2, 64, 128)
    for dtype in (torch.float32, torch.float64):
        zz = z.to(dtype)
        with pytest.raises(ValueError):
            local._launch_cols(zz, zz, zz, zz, -1, axis=1, postscale=1.0,
                               tw_n=0, tw_mode="full", tw_period=0,
                               swap_store=False, swap_mid=0)
    assert profiling.counts() == before
