"""The port's four-step and six-step executors
(``pyfft_tpu_torch.ops.fourstep``) against the JAX package's
(``pyfft_tpu.ops.fourstep``, Pallas column kernels in interpret mode) on
the CPU, case for case with tests/test_fourstep.py, at forced small splits
so that the multi-pass machinery runs at CPU sizes.

The splits are passed to both packages.  JAX's column chains and its mid
axis's split come from its static tables only because the autotune record
is pointed at an empty file for this module.  Gate: 2e-6
(tests/helpers.py TOL), against numpy and between the packages.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pyfft_tpu.ops import fourstep as jax_fourstep
from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import fourstep

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]


@pytest.fixture(autouse=True)
def static_jax_tables(tmp_path, monkeypatch):
    """Point the JAX package's autotune record at an empty file."""
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({}))
    monkeypatch.setenv("PYFFT_TPU_TUNE_FILE", str(path))
    jax_local.reload_tuned()
    yield
    jax_local._TUNED = None


def planar(x):
    return (np.ascontiguousarray(np.real(x)).astype(np.float32),
            np.ascontiguousarray(np.imag(x)).astype(np.float32))


def to_c(r, i):
    if isinstance(r, torch.Tensor):
        return r.numpy() + 1j * i.numpy()
    return np.asarray(r) + 1j * np.asarray(i)


def both(fn, x, sign, jax_kw, **kw):
    """(torch, JAX) results of executor ``fn`` on the same planes."""
    re, im = planar(x)
    tr, ti = getattr(fourstep, fn)(torch.from_numpy(re), torch.from_numpy(im),
                                   sign, **kw)
    jr, ji = getattr(jax_fourstep, fn)(re, im, sign, interpret=True,
                                       **jax_kw, **kw)
    assert tuple(tr.shape) == x.shape
    return to_c(tr, ti), to_c(jr, ji)


@pytest.mark.parametrize("n,split", [
    (16384, (128, 128)),     # the smallest two-column-pass split
    (32768, (256, 128)),     # unbalanced
    (65536, (256, 256)),     # both factors 256
])
def test_large_matches_jax(n, split):
    x = rand_complex((4, n), seed=n % 1000)
    got, jgot = both("fft_axis_large", x, -1, {}, axis=-1, split=split)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


def test_large_inverse_postscale_matches_jax():
    n, split = 16384, (128, 128)
    x = rand_complex((2, n), seed=9)
    fr, fi = fourstep.fft_axis_large(*map(torch.from_numpy, planar(x)), -1,
                                     axis=-1, split=split)
    fwd = to_c(fr, fi)
    got, jgot = both("fft_axis_large", fwd, +1, {}, axis=-1, split=split,
                     postscale=1.0 / n)
    assert rel_err(got, x) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("shape,axis,max_local", [
    ((16384, 128), 0, 128),      # 2D row axis, smallest split
    ((2, 32768, 128), 1, 256),   # 3D middle axis with a lead dim
])
def test_mid_matches_jax(shape, axis, max_local):
    x = rand_complex(shape, seed=sum(shape) % 997)
    n = shape[axis]
    split = jax_fourstep.choose_split(n, max_local)
    assert fourstep.supported_mid(torch.zeros(shape), axis, max_local)
    got, jgot = both("fft_axis_mid", x, -1, {"max_local": max_local},
                     axis=axis)
    # the port runs JAX's split, passed explicitly
    re, im = map(torch.from_numpy, planar(x))
    pr, pi = fourstep.fft_axis_mid(re, im, -1, axis=axis, split=split)
    ref = np.fft.fft(x.astype(np.complex128), axis=axis)
    assert rel_err(got, ref) < C64
    assert rel_err(to_c(pr, pi), ref) < C64
    assert rel_err(to_c(pr, pi), jgot) < C64


def test_mid_inverse_postscale_matches_jax():
    shape, axis, n = (16384, 128), 0, 16384
    x = rand_complex(shape, seed=77)
    fr, fi = fourstep.fft_axis_mid(*map(torch.from_numpy, planar(x)), -1,
                                   axis=axis, split=(128, 128))
    got, jgot = both("fft_axis_mid", to_c(fr, fi), +1, {"max_local": 128},
                     axis=axis, postscale=1.0 / n)
    assert rel_err(got, x) < C64
    assert rel_err(got, jgot) < C64


def test_huge_matches_jax():
    """Two-level (six-step) decomposition at 2^21 = 128^3, forward with a
    postscale and the inverse round trip."""
    n, split3 = 1 << 21, (128, 128, 128)
    x = rand_complex((2, n), seed=90)
    got, jgot = both("fft_axis_huge", x, -1, {}, axis=-1, split3=split3,
                     postscale=0.5)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(got * 2.0, ref) < C64
    assert rel_err(got, jgot) < C64
    back, jback = both("fft_axis_huge", got, +1, {}, axis=-1, split3=split3,
                       postscale=1.0 / n)
    assert rel_err(back * 2.0, x) < C64
    assert rel_err(back, jback) < C64


@pytest.mark.parametrize("fn,kw", [
    ("fft_axis_large", dict(axis=-1, split=(128, 128))),
    ("fft_axis_mid", dict(axis=0, split=(128, 128))),
])
def test_precise_chains_match_jax(fn, kw):
    """fast_math=False: the all-butterfly chains on every pass."""
    shape = (2, 16384) if fn == "fft_axis_large" else (16384, 128)
    x = rand_complex(shape, seed=31)
    jax_kw = {"max_local": 128} if fn == "fft_axis_mid" else {}
    if fn == "fft_axis_mid":
        re, im = planar(x)
        jr, ji = jax_fourstep.fft_axis_mid(re, im, -1, axis=0,
                                           interpret=True, fast_math=False,
                                           **jax_kw)
        tr, ti = fourstep.fft_axis_mid(*map(torch.from_numpy, (re, im)), -1,
                                       fast_math=False, **kw)
        got, jgot = to_c(tr, ti), to_c(jr, ji)
    else:
        got, jgot = both(fn, x, -1, {}, fast_math=False, **kw)
    ref = np.fft.fft(x.astype(np.complex128), axis=kw["axis"])
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("fn,shape,kw", [
    ("fft_axis_large", (2, 16384), dict(axis=-1, split=(128, 128))),
    ("fft_axis_mid", (16384, 128), dict(axis=0, split=(128, 128))),
    ("fft_axis_huge", (1 << 21,), dict(axis=-1, split3=(128, 128, 128))),
])
def test_out_planes(fn, shape, kw):
    """``out=`` receives the last pass's store, in place on the input's
    stride-2 planes here; the earlier passes write temporaries."""
    x = rand_complex(shape, seed=41)
    xt = torch.from_numpy(x.copy())
    v = torch.view_as_real(xt)
    out = (v[..., 0], v[..., 1])
    rr, ii = getattr(fourstep, fn)(v[..., 0], v[..., 1], -1, out=out, **kw)
    assert rr is out[0] and ii is out[1]
    ref = np.fft.fft(x.astype(np.complex128), axis=kw["axis"])
    assert rel_err(xt.numpy(), ref) < C64


def test_choose_split():
    for p in (14, 20, 22, 24, 26):
        n1, n2 = fourstep.choose_split(1 << p)
        assert n1 * n2 == 1 << p
        assert 128 <= n1 <= 8192 and 128 <= n2 <= 8192
        assert n1 <= n2 <= 2 * n1                       # balanced
    assert fourstep.choose_split(1 << 14) == (128, 128)
    assert fourstep.choose_split(1 << 15) == (128, 256)
    # the JAX package's own choice at config 6+
    assert fourstep.choose_split(1 << 22) == (2048, 2048)
    assert jax_fourstep.choose_split(1 << 22) == (2048, 2048)
    assert fourstep.choose_split(32768, 256) == jax_fourstep.choose_split(
        32768, 256)


@pytest.mark.parametrize("n,max_local", [
    (1 << 25, 256),          # beyond 256^2
    (1 << 13, None),         # a factor would fall below 128
    (1 << 27, None),         # beyond 8192^2: the six-step's range
])
def test_choose_split_errors_match_jax(n, max_local):
    with pytest.raises(ValueError):
        fourstep.choose_split(n, max_local)
    with pytest.raises(ValueError):
        jax_fourstep.choose_split(n, max_local)


def test_choose_split3():
    assert fourstep.choose_split3(1 << 21, 128) == (128, 128, 128)
    assert jax_fourstep.choose_split3(1 << 21, 128) == (128, 128, 128)
    assert fourstep.choose_split3(1 << 27) == (512, 512, 512)
    for p in (22, 27, 28, 33):
        f = fourstep.choose_split3(1 << p)
        assert f[0] * f[1] * f[2] == 1 << p
        assert all(128 <= v <= 8192 for v in f)
        assert max(f) <= 2 * min(f)                      # balanced


@pytest.mark.parametrize("n,max_local", [
    (1 << 20, None),          # three factors of at least 128 need 2^21
    (1 << 22, 128),           # beyond 128^3
])
def test_choose_split3_errors_match_jax(n, max_local):
    with pytest.raises(ValueError):
        fourstep.choose_split3(n, max_local)
    with pytest.raises(ValueError):
        jax_fourstep.choose_split3(n, max_local)


@pytest.mark.parametrize("fn,shape,axis,max_local", [
    ("supported", (2, 16384), -1, None),
    ("supported", (2, 16384), 0, None),            # not the last axis
    ("supported", (2, 4096), -1, None),            # within the local range
    ("supported", (1, 1 << 25), -1, 256),          # no split
    ("supported_mid", (16384, 128), 0, 128),
    ("supported_mid", (16384, 128), 1, 128),       # the last axis
    ("supported_mid", (16384, 64), 0, 128),        # trail not 128k
    ("supported_mid", (1024, 128), 0, 8192),       # within the local range
    ("supported_mid", (1 << 24, 128), 0, 8192),    # level twiddle too big
    ("supported_huge", (1, 1 << 21), -1, 128),
    ("supported_huge", (1, 1 << 16), -1, 128),     # one four-step level
])
def test_supported_gates_match_jax(fn, shape, axis, max_local):
    """The gates read only shape and dtype: zero-memory stand-ins.  Float64
    planes (complex128) take the last-axis executors with the same answer
    at these shapes (a default ceiling of 4096 instead of 8192 changes
    none of them) and never the mid axis, as in the JAX package."""
    want = getattr(jax_fourstep, fn)(jax.ShapeDtypeStruct(shape, np.float32),
                                     axis, max_local=max_local)
    got = getattr(fourstep, fn)(torch.zeros(1).expand(shape), axis,
                                max_local=max_local)
    assert got == want
    f64 = torch.zeros(1, dtype=torch.float64).expand(shape)
    want64 = want and fn != "supported_mid"
    assert getattr(fourstep, fn)(f64, axis, max_local=max_local) == want64


@pytest.mark.parametrize("fn,kw", [
    ("fft_axis_large", dict(axis=-1, split=(128, 64))),      # 8192 != n
    ("fft_axis_large", dict(axis=0, split=(128, 128))),      # not last
    ("fft_axis_mid", dict(axis=-1, split=(128, 128))),       # last
    ("fft_axis_huge", dict(axis=-1, split3=(128, 128, 64))),
])
def test_executor_errors(fn, kw):
    z = torch.zeros(2, 16384)
    with pytest.raises(ValueError):
        getattr(fourstep, fn)(z, z, -1, **kw)
