"""The port's interleaved-storage kernels' plain versions against the JAX
package's kernels on the CPU.

``ops/interleave.py`` (K13, K14) against ``pyfft_tpu.ops.interleave``
run in interpret mode, bit-exact; ``ops/local.fft_rows_interleaved`` (K2,
and its packed form K3) against ``pallas_local.fft_rows_interleaved`` in
interpret mode.  Gates: 2e-6 over the peak against numpy.fft
(tests/helpers.py TOL); between the packages 1e-6 for the non-packed
mirror (the same chain and tables; only the order of a contraction's sums
differs) and 2e-6 for the packed one.  The launch wrappers' checks are run
on CPU tensors, which they refuse before any launch.  The CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfft_tpu.ops import interleave as jax_il
from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import interleave, local
from pyfft_tpu_torch.utils import profiling

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]


def pairs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("shape", [(8, 256), (4, 1024), (2, 8, 512),
                                   (128, 256), (1, 4096)])
def test_deinterleave_matches_jax_bit_exact(shape):
    v = pairs(shape)
    re, im = interleave.deinterleave(torch.from_numpy(v))
    jre, jim = jax_il.deinterleave(jnp.asarray(v), interpret=True)
    assert tuple(re.shape) == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    np.testing.assert_array_equal(re.numpy(), v[..., 0::2])


@pytest.mark.parametrize("shape", [(8, 128), (4, 512), (2, 8, 256)])
def test_interleave_matches_jax_bit_exact(shape):
    re, im = pairs(shape, 1), pairs(shape, 2)
    v = interleave.interleave(torch.from_numpy(re), torch.from_numpy(im))
    jv = jax_il.interleave(jnp.asarray(re), jnp.asarray(im), interpret=True)
    assert tuple(v.shape) == shape[:-1] + (2 * shape[-1],)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape", [(16, 512), (3, 2002), (5, 7, 6)])
def test_roundtrip_and_out(shape):
    """Any n (odd too: the 256-lane chunk is only the route's gate), with
    ``out`` planes and an ``out`` view."""
    v = torch.from_numpy(pairs(shape, 3))
    half = shape[:-1] + (shape[-1] // 2,)
    out = (torch.empty(half), torch.empty(half))
    re, im = interleave.deinterleave(v, out=out)
    assert re is out[0] and im is out[1]
    back = torch.empty(shape)
    assert interleave.interleave(re, im, out=back) is back
    assert torch.equal(back, v)


@pytest.mark.parametrize("shape", [(8, 256), (3, 512), (8, 128), (8, 255),
                                   ()])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_supported_matches_jax(shape, dtype):
    want = jax_il.supported(shape, getattr(jnp, dtype))
    assert interleave.supported(shape, getattr(torch, dtype)) == want
    assert interleave.supported(shape, np.dtype(dtype)) == want


def test_deinterleave_rejects_odd_axis():
    with pytest.raises(ValueError):
        interleave.deinterleave(torch.zeros(4, 7))


@pytest.mark.parametrize("case", ["overlap", "plane overlap", "row strides",
                                  "last stride", "float64", "cpu"])
def test_interleave_launch_checks_raise(case):
    """The K13/K14 wrapper validates its operands before any launch; the
    layout checks come before the device check, so a CPU tensor reaches
    each of them."""
    v = torch.zeros(4, 512)
    re, im = torch.zeros(4, 256), torch.zeros(4, 256)
    if case == "overlap":
        re = v[:, :256]
    elif case == "plane overlap":
        im = re
    elif case == "row strides":
        im = torch.zeros(4, 300)[:, :256]
    elif case == "last stride":
        re = torch.zeros(4, 512)[:, ::2]
    elif case == "float64":
        v = v.double()
    before = profiling.counts()
    for name in ("pyfft_deinterleave", "pyfft_interleave"):
        with pytest.raises(ValueError):
            interleave._launch(name, v, re, im)
    assert profiling.counts() == before


# ------------------------------------------------------------------- K2


ROWS = {8: 130, 64: 130, 512: 40, 4096: 8}


def both_interleaved(x, sign, postscale, packed):
    n = x.shape[-1]
    v = np.ascontiguousarray(x).view(np.float32)          # (rows, 2n)
    got = local.fft_rows_interleaved(torch.from_numpy(v.copy()), sign,
                                     postscale=postscale, packed=packed)
    jgot = jax_local.fft_rows_interleaved(jnp.asarray(v), sign,
                                          postscale=postscale,
                                          packed=packed, interpret=True)
    assert tuple(got.shape) == v.shape
    got = np.ascontiguousarray(got.numpy()).view(np.complex64)
    jgot = np.ascontiguousarray(np.asarray(jgot)).view(np.complex64)
    assert got.shape == (x.shape[0], n)
    return got, jgot


@pytest.mark.parametrize("n", sorted(ROWS))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_rows_interleaved_matches_jax(n, packed, sign):
    x = rand_complex((ROWS[n], n), seed=n + (sign > 0))
    post = 0.3
    got, jgot = both_interleaved(x, sign, post, packed)
    x128 = x.astype(np.complex128)
    ref = post * (np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * n)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < (C64 if packed else 1e-6)


def test_fft_rows_interleaved_out_and_in_place():
    x = rand_complex((6, 256), seed=21)
    ref = 0.5 * np.fft.fft(x.astype(np.complex128))
    v = torch.from_numpy(x.copy()).view(torch.float32)
    out = torch.empty_like(v)
    assert local.fft_rows_interleaved(v, -1, postscale=0.5, out=out) is out
    assert rel_err(out.view(torch.complex64).numpy(), ref) < C64
    y = local.fft_rows_interleaved(v, -1, postscale=0.5, out=v)
    assert y is v
    assert rel_err(v.view(torch.complex64).numpy(), ref) < C64


def test_packed_default_follows_flag(monkeypatch):
    """``packed=None`` takes PACKED_INTERLEAVED, False as in JAX."""
    assert local.PACKED_INTERLEAVED is jax_local.PACKED_INTERLEAVED is False
    calls = []
    real = local.fft_rows_interleaved_plain
    monkeypatch.setattr(local, "fft_rows_interleaved_plain",
                        lambda *a: calls.append(a[4]) or real(*a))
    v = torch.from_numpy(pairs((2, 128), 4))
    local.fft_rows_interleaved(v, -1)
    monkeypatch.setattr(local, "PACKED_INTERLEAVED", True)
    local.fft_rows_interleaved(v, -1)
    assert calls == [False, True]


@pytest.mark.parametrize("factors", [(8, 8, 64), (8, 2, 64), (4, 4, 2, 64),
                                     (2, 128), (8, 32), (64, 4)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_tile_fft_packed_matches_jax(factors, sign):
    """The packed mirror through every stage kind on JAX's own tables."""
    n = math.prod(factors)
    x = rand_complex((8, n), seed=n + 3)
    tile = np.ascontiguousarray(x.view(np.float32).T)      # (2n, 8)
    tables = jax_local.needed_tables_packed(n, sign, factors=factors)
    mine = local.needed_tables_packed(n, sign, factors=factors)
    assert list(mine) == list(tables)
    for k in tables:
        for a, b in zip(mine[k], tables[k]):
            np.testing.assert_array_equal(a, b)
    got = local.tile_fft_packed(torch.from_numpy(tile),
                                local.tables_from_numpy(tables, "cpu"), n,
                                factors, sign)
    jt = {k: tuple(jnp.asarray(a) for a in v) for k, v in tables.items()}
    jgot = jax_local.tile_fft_packed(jnp.asarray(tile), jt, n, factors,
                                     sign=sign)
    got = np.ascontiguousarray(got.numpy().T).view(np.complex64)
    jgot = np.ascontiguousarray(np.asarray(jgot).T).view(np.complex64)
    x128 = x.astype(np.complex128)
    ref = np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * n
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("last", [8, 20, 32768])
def test_fft_rows_interleaved_raises_outside_kernel(last):
    """n = 4, a non-power of two and n = 16384 are no K2 row."""
    with pytest.raises(ValueError):
        local.fft_rows_interleaved(torch.zeros(2, last), -1)


@pytest.mark.parametrize("case", ["misaligned", "n too small", "n too large",
                                  "odd row stride", "out shape", "overlap",
                                  "float64", "cpu"])
def test_il_launch_checks_raise_before_any_launch(case):
    """K2's wrapper refuses, before the library is touched: a float view at
    an odd offset (not 8-byte aligned), n outside [8, 8192], an odd row
    stride, an output of another shape or overlapping the input, float64,
    and (last) a tensor off the card."""
    v = torch.zeros(4, 128)
    out = torch.zeros(4, 128)
    if case == "misaligned":
        v = torch.zeros(4 * 128 + 1)[1:].view(4, 128)
    elif case == "n too small":
        v, out = torch.zeros(4, 8), torch.zeros(4, 8)
    elif case == "n too large":
        v, out = torch.zeros(1, 32768), torch.zeros(1, 32768)
    elif case == "odd row stride":
        v = torch.zeros(4, 129)[:, :128]
    elif case == "out shape":
        out = torch.zeros(4, 256)
    elif case == "overlap":
        buf = torch.zeros(5, 128)
        v, out = buf[:4], buf[1:]
    elif case == "float64":
        v, out = v.double(), out.double()
    before = profiling.counts()
    with pytest.raises(ValueError) as err:
        local._launch_rows_il(v, out, -1, 1.0)
    if case == "misaligned":
        assert "aligned" in str(err.value)
    elif case.startswith("n too"):
        assert "K2 takes n" in str(err.value)
    elif case == "cpu":
        assert "CUDA" in str(err.value)
    assert profiling.counts() == before
