"""The torch port's tables against the JAX package's: radix math, twiddle
and DFT tables, the row path's factor chains and ``needed_tables`` must be
bit-identical, since both packages' tile math runs on them."""

import math

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu.ops import twiddle as jax_twiddle
from pyfft_tpu.utils import radix as jax_radix
from pyfft_tpu_torch.ops import local, twiddle
from pyfft_tpu_torch.utils import radix

torch.set_num_threads(2)

POW2 = [1 << p for p in range(3, 14)]          # 8 .. 8192


def assert_tables_identical(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert len(got[k]) == len(ref[k]), k
        for a, b in zip(got[k], ref[k]):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("fn,args", [
    ("is_power_of_two", [(n,) for n in range(-2, 70)]),
    ("ilog2", [(1 << p,) for p in range(40)]),
    ("balanced_split", [(1 << p,) for p in range(1, 30)]),
    ("radix_decompose", [(1 << p, r) for p in range(1, 24)
                         for r in (2, 4, 8, 16, 128)]),
    ("fourstep_split", [(1 << p, 128) for p in range(8, 28)]),
])
def test_radix_identical(fn, args):
    for a in args:
        assert getattr(radix, fn)(*a) == getattr(jax_radix, fn)(*a), a


@pytest.mark.parametrize("fn", ["ilog2", "radix_decompose", "fourstep_split"])
def test_radix_errors_identical(fn):
    bad = {"ilog2": (12,), "radix_decompose": (16, 3),
           "fourstep_split": (64, 128)}[fn]
    with pytest.raises(ValueError):
        getattr(jax_radix, fn)(*bad)
    with pytest.raises(ValueError):
        getattr(radix, fn)(*bad)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sign", [-1, 1])
def test_twiddle_identical(dtype, sign):
    for n in (1, 2, 8, 64, 128, 512):
        for a, b in zip(twiddle.dft_matrix(n, sign, dtype),
                        jax_twiddle.dft_matrix(n, sign, dtype)):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
    for rows, cols, n in ((8, 512, 4096), (64, 64, 4096), (2, 8192, 8192),
                          (1024, 16, 1 << 22)):
        for a, b in zip(twiddle.twiddle_table(rows, cols, n, sign, dtype),
                        jax_twiddle.twiddle_table(rows, cols, n, sign,
                                                  dtype)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (rows, cols)
        for stride in (1, 3, 128):
            got = twiddle.twiddle_table_strided(rows, cols, n, sign, stride,
                                                dtype)
            ref = jax_twiddle.twiddle_table_strided(rows, cols, n, sign,
                                                    stride, dtype)
            for a, b in zip(got, ref):
                assert np.array_equal(a, b), (rows, cols, stride)


@pytest.mark.parametrize("n", POW2)
def test_factor_chains_identical(n):
    assert local.default_factors(n) == jax_local.default_factors(n)
    # JAX's row_factors may read a per-machine autotune record first; the
    # port carries only the static table
    assert local.row_factors(n) == (jax_local.ROW_FACTORS.get(n)
                                    or jax_local.default_factors(n))
    assert local.butterfly_factors(n) == jax_local.butterfly_factors(n)
    assert local.precise_factors(n) == jax_local.precise_factors(n)


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("chain", ["default", "row"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_needed_tables_identical(n, chain, sign):
    factors = (jax_local.default_factors(n) if chain == "default"
               else local.row_factors(n))
    assert_tables_identical(local.needed_tables(n, sign, factors=factors),
                            jax_local.needed_tables(n, sign, factors=factors))


@pytest.mark.parametrize("factors", [(16, 16, 16), (4, 32, 32), (2, 2, 2, 2)])
@pytest.mark.parametrize("stacked", [True, False])
def test_needed_tables_identical_multi(factors, stacked):
    n = math.prod(factors)
    for sign in (-1, 1):
        assert_tables_identical(
            local.needed_tables(n, sign, factors=factors, stacked=stacked),
            jax_local.needed_tables(n, sign, factors=factors,
                                    stacked=stacked))


def test_tables_from_numpy_round_trip():
    ref = jax_local.needed_tables(4096, -1, factors=(8, 8, 64))
    got = local.tables_from_numpy(ref, "cpu")
    assert list(got) == list(ref)
    for k in ref:
        for t, a in zip(got[k], ref[k]):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            back = t.numpy()
            assert back.dtype == a.dtype and np.array_equal(back, a), k


@pytest.mark.parametrize("n", [8, 64, 4096, 8192])
@pytest.mark.parametrize("sign", [-1, 1])
def test_kernel_twiddles(n, sign):
    """The row kernel's table is exp(sign*2*pi*i*k/n), k < n, rounded once
    from float64: equal to float32(cos), float32(sin) of the exact phase."""
    tw = local._kernel_twiddles(n, sign, torch.device("cpu")).numpy()
    theta = sign * 2.0 * np.pi * np.arange(n) / n
    assert tw.shape == (n, 2) and tw.dtype == np.float32
    # one float32 rounding of a float64 value: within half an ulp of 1
    assert np.abs(tw[:, 0] - np.cos(theta)).max() <= 2 ** -24
    assert np.abs(tw[:, 1] - np.sin(theta)).max() <= 2 ** -24
    assert tw[0, 0] == 1.0 and tw[0, 1] == 0.0
