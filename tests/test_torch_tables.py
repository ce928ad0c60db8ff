"""The torch port's tables against the JAX package's: radix math, twiddle
and DFT tables, the row path's factor chains and ``needed_tables`` must be
bit-identical, since both packages' tile math runs on them; the complex128
kernels' float64 tables hold the JAX df64 kernels' phases to one ulp."""

import math

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_df64 as jax_df64
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


@pytest.mark.parametrize("n", POW2)
def test_col_factor_chains_identical(n):
    # JAX's col_factors may read a per-machine autotune record first; the
    # port carries only the static table
    assert local.col_factors(n) == (jax_local.COL_FACTORS.get(n)
                                    or jax_local.default_factors(n))
    assert_tables_identical(
        local.needed_tables(n, -1, factors=local.col_factors(n)),
        jax_local.needed_tables(n, -1, factors=local.col_factors(n)))


# (n, T, tw_n, tw_period): the four-step shapes at test size and config
# 6+'s first pass (2048 x 2048 of 2^22)
COL_TW_CASES = [(64, 256, 64 * 256, 128), (128, 384, 128 * 3, 128),
                (2048, 2048, 1 << 22, 256)]


@pytest.mark.parametrize("n,T,tw_n,period", COL_TW_CASES)
@pytest.mark.parametrize("sign", [-1, 1])
def test_col_plain_twiddles_identical(n, T, tw_n, period, sign):
    """The plain column pass's twiddle planes are built from the same
    float32 tables as pallas_local._fft_cols_inner's, bit for bit."""
    cpu = torch.device("cpu")
    tr, ti = local._plain_twiddle(n, T, tw_n, "full", 0, sign, cpu)
    ref = jax_twiddle.twiddle_table(n, T, tw_n, sign)
    assert np.array_equal(tr.numpy(), ref[0])
    assert np.array_equal(ti.numpy(), ref[1])
    # strided: column t // period of JAX's (n, T / period) table
    tr, ti = local._plain_twiddle(n, T, tw_n, "strided", period, sign, cpu)
    ar, ai = jax_twiddle.twiddle_table_strided(n, T // period, tw_n, sign, 1)
    q = np.arange(T) // period
    assert np.array_equal(tr.numpy(), ar[:, q])
    assert np.array_equal(ti.numpy(), ai[:, q])
    # factored: JAX's A[k, t // 128] * B[k, t % 128] in float32
    tr, ti = local._plain_twiddle(n, T, tw_n, "factored", 0, sign, cpu)
    ar, ai = jax_twiddle.twiddle_table_strided(n, T // 128, tw_n, sign, 128)
    br, bi = jax_twiddle.twiddle_table(n, 128, tw_n, sign)
    q, r = np.arange(T) // 128, np.arange(T) % 128
    ar, ai, br, bi = ar[:, q], ai[:, q], br[:, r], bi[:, r]
    assert np.array_equal(tr.numpy(), ar * br - ai * bi)
    assert np.array_equal(ti.numpy(), ar * bi + ai * br)


def flat_pairs(t):
    """A kernel table as the kernel reads it: flat float2 memory."""
    assert t.is_contiguous()
    a = t.reshape(-1, 2).numpy()
    return a[:, 0], a[:, 1]


@pytest.mark.parametrize("n,T,tw_n,period", COL_TW_CASES)
@pytest.mark.parametrize("k_fast", [True, False])
def test_col_kernel_tables_identical(n, T, tw_n, period, k_fast):
    """The column kernel's tables, read at its flat offsets
    (ta[k*ak + q*aq], tb[k*bk + (t % 128)*bq]), hold JAX's float32
    twiddle_table / twiddle_table_strided entries bit for bit, in either
    layout."""
    cpu = torch.device("cpu")
    k = np.arange(n)[:, None]
    t = np.arange(T)[None, :]
    for mode in ("full", "strided", "factored"):
        per = period if mode == "strided" else 0
        ta, tb, ak, aq, adiv, bk, bq = local._kernel_col_tables(
            n, T, tw_n, mode, per, -1, k_fast, cpu)
        qa = t if adiv == 1 else t // adiv
        ar, ai = flat_pairs(ta)
        if mode == "full":
            ref = jax_twiddle.twiddle_table(n, T, tw_n, -1)
        elif mode == "strided":
            rr, ri = jax_twiddle.twiddle_table_strided(n, T // period, tw_n,
                                                       -1, 1)
            ref = (rr[:, t // period][:, 0], ri[:, t // period][:, 0])
        else:
            rr, ri = jax_twiddle.twiddle_table_strided(n, T // 128, tw_n,
                                                       -1, 128)
            ref = (rr[:, t // 128][:, 0], ri[:, t // 128][:, 0])
            br, bi = flat_pairs(tb)
            b = jax_twiddle.twiddle_table(n, 128, tw_n, -1)
            at = k * bk + (t % 128) * bq
            assert np.array_equal(br[at], b[0][:, t % 128][:, 0])
            assert np.array_equal(bi[at], b[1][:, t % 128][:, 0])
        assert np.array_equal(ar[k * ak + qa * aq], ref[0]), mode
        assert np.array_equal(ai[k * ak + qa * aq], ref[1]), mode


def assert_within_ulp(got, ref, tw_n=None):
    """Float64 cos or sin values within one ulp of the phase of the
    reference's: the port takes the angle as (2*pi/tw_n)*k, JAX's _phases
    as 2*pi*k/tw_n, which agree bit for bit when tw_n is a power of two and
    within one ulp of the angle (at most spacing(2*pi)) otherwise."""
    assert got.dtype == np.float64
    if tw_n is None or tw_n & (tw_n - 1) == 0:
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= np.spacing(2 * np.pi)


@pytest.mark.parametrize("n", [8, 64, 4096])
@pytest.mark.parametrize("sign", [-1, 1])
def test_kernel_twiddles_f64(n, sign):
    """K11's and K12's stage table in float64: exp(sign*2*pi*i*k/n) as
    the JAX package's df64 kernels take it (pallas_df64._phases), to one
    ulp."""
    tw = local._kernel_twiddles(n, sign, torch.device("cpu"),
                                torch.float64).numpy()
    assert tw.shape == (n, 2)
    # row 1 of the phase table: exp(sign*2*pi*i*k/n)
    cos, sin = jax_df64._phases(2, n, n, sign)
    assert_within_ulp(tw[:, 0], cos[1])
    assert_within_ulp(tw[:, 1], sin[1])


@pytest.mark.parametrize("n,T,tw_n,period", COL_TW_CASES)
@pytest.mark.parametrize("k_fast", [True, False])
def test_col_kernel_tables_f64_match_jax_phases(n, T, tw_n, period, k_fast):
    """K12's float64 tables, read at the kernel's flat offsets
    (ta[k*ak + q*aq], tb[k*bk + (t % 128)*bq]), hold the phases JAX's df64
    column kernel takes (pallas_df64._phases: the full (n, T) table, the
    strided (n, T / period) one, the factored A (n, T / 128, stride 128)
    and B (n, 128)) to one ulp, in either layout."""
    cpu = torch.device("cpu")
    k = np.arange(n)[:, None]
    t = np.arange(T)[None, :]
    for mode in ("full", "strided", "factored"):
        per = period if mode == "strided" else 0
        ta, tb, ak, aq, adiv, bk, bq = local._kernel_col_tables(
            n, T, tw_n, mode, per, -1, k_fast, cpu, torch.float64)
        qa = t if adiv == 1 else t // adiv
        ar, ai = flat_pairs(ta)
        if mode == "full":
            ref = jax_df64._phases(n, T, tw_n, -1)
        elif mode == "strided":
            rr, ri = jax_df64._phases(n, T // period, tw_n, -1)
            ref = (rr[:, t // period][:, 0], ri[:, t // period][:, 0])
        else:
            rr, ri = jax_df64._phases(n, T // 128, tw_n, -1, 128)
            ref = (rr[:, t // 128][:, 0], ri[:, t // 128][:, 0])
            br, bi = flat_pairs(tb)
            b = jax_df64._phases(n, 128, tw_n, -1)
            at = k * bk + (t % 128) * bq
            assert_within_ulp(br[at], b[0][:, t % 128][:, 0], tw_n)
            assert_within_ulp(bi[at], b[1][:, t % 128][:, 0], tw_n)
        assert_within_ulp(ar[k * ak + qa * aq], ref[0], tw_n)
        assert_within_ulp(ai[k * ak + qa * aq], ref[1], tw_n)


@pytest.mark.parametrize("n,T,tw_n,period", COL_TW_CASES)
def test_col_plain_twiddles_f64(n, T, tw_n, period):
    """K12's plain version takes the same float64 phases; its factored
    product, taken in float64, lies within 8 ulps of 1 of the phase's
    cos and sin (JAX's df64 product: about 2^-48, 16 times coarser)."""
    cpu = torch.device("cpu")
    for mode in ("full", "strided", "factored"):
        per = period if mode == "strided" else 0
        tr, ti = local._plain_twiddle(n, T, tw_n, mode, per, -1, cpu,
                                      torch.float64)
        assert tr.dtype == torch.float64 and tuple(tr.shape) == (n, T)
        t = np.arange(T)
        cos, sin = jax_df64._phases(n, T, tw_n, -1, col_stride=1)
        if mode == "strided":
            cos, sin = jax_df64._phases(n, T // period, tw_n, -1)
            cos, sin = cos[:, t // period], sin[:, t // period]
        if mode == "factored":
            assert np.abs(tr.numpy() - cos).max() <= 8 * 2 ** -52
            assert np.abs(ti.numpy() - sin).max() <= 8 * 2 ** -52
        else:
            assert_within_ulp(tr.numpy(), cos, tw_n)
            assert_within_ulp(ti.numpy(), sin, tw_n)
