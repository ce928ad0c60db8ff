"""The port's real transforms (``pyfft_tpu_torch.real``) against the JAX
package's (``pyfft_tpu.real``) and numpy.fft on the CPU, on the same
seeded inputs, with the shapes tests/test_real.py uses.

The inner complex FFT runs the plain versions of the port's kernels on a
CPU tensor, by whichever interleaved route ``plan.py``'s table gives;
``test_rfft_each_route_matches_jax`` drives every route.  Gate: 2e-6 over
the peak (tests/helpers.py TOL), against numpy.fft and between the
packages.
"""

import numpy as np
import pytest
import torch

import pyfft_tpu
import pyfft_tpu_torch
from pyfft_tpu import real as jax_real
from pyfft_tpu_torch import plan as plan_mod
from pyfft_tpu_torch import real

from helpers import TOL, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jnp_np(out):
    if isinstance(out, tuple):
        return np.asarray(out[0]) + 1j * np.asarray(out[1])
    return np.asarray(out)


def rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape)


@pytest.mark.parametrize("shape", [(4,), (256,), (8, 1024), (3, 2, 512)])
def test_rfft_matches_jax_and_numpy(shape):
    x = rand(shape, sum(shape))
    got = real.rfft(t(x), device="cpu")
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    assert tuple(got.shape) == shape[:-1] + (shape[-1] // 2 + 1,)
    ref = np.fft.rfft(x, axis=-1)
    assert rel_err(got.numpy(), ref) < C64
    assert rel_err(got.numpy(), jnp_np(jax_real.rfft(x))) < C64


@pytest.mark.parametrize("n", [8, 512])
def test_irfft_roundtrip(n):
    x = rand((5, n), n)
    back = real.irfft(real.rfft(t(x)))
    assert back.dtype == torch.float32 and tuple(back.shape) == x.shape
    assert rel_err(back.numpy(), x) < C64


def test_irfft_matches_jax_and_numpy():
    X = np.fft.rfft(rand((2, 256), 7), axis=-1).astype(np.complex64)
    got = real.irfft(t(X)).numpy()
    assert rel_err(got, np.fft.irfft(X.astype(np.complex128))) < C64
    assert rel_err(got, np.asarray(jax_real.irfft(X))) < C64


@pytest.mark.parametrize("call", [
    lambda m, kw: m.rfft(np.zeros(24), **kw),                 # not 2^k
    lambda m, kw: m.rfft(np.zeros(2), **kw),                  # n < 4
    lambda m, kw: m.irfft(np.zeros(100, np.complex64), **kw),  # n = 198
    lambda m, kw: m.irfft(np.zeros(33, np.complex64), 128, **kw),  # width
    lambda m, kw: m.irfft(np.zeros(3, np.complex64), 2, **kw),     # n < 4
    lambda m, kw: m.rfftn(np.zeros((8, 64)), 3, **kw),        # rank > ndim
    lambda m, kw: m.rfftn(np.zeros((8, 64)), 0, **kw),
    lambda m, kw: m.irfftn(np.zeros((2, 8, 33), np.complex64), 4, **kw),
    lambda m, kw: m.rfft_planar(np.zeros(12), **kw),
    lambda m, kw: m.irfft_planar(np.zeros(5), np.zeros(5), 16, **kw),
])
def test_errors_match_jax(call):
    with pytest.raises(ValueError):
        call(jax_real, {})
    with pytest.raises(ValueError):
        call(real, {"device": "cpu"})


@pytest.mark.parametrize("call", [
    lambda m, kw: m.rfft(np.zeros(64), normalize=False, **kw),
    lambda m, kw: m.irfft(np.zeros(33, np.complex64), scale=2.0, **kw),
    lambda m, kw: m.rfftn(np.zeros((8, 64)), scale=0.5, **kw),
    lambda m, kw: m.irfftn_planar(np.zeros((8, 33)), np.zeros((8, 33)),
                                  donate=True, **kw),
])
def test_check_kw_rejects_plan_kwargs(call):
    with pytest.raises(ValueError):
        call(jax_real, {})
    with pytest.raises(ValueError):
        call(real, {"device": "cpu"})


def test_check_kw_forwards_allowed():
    assert real._check_kw({"fast_math": False, "device": "cpu"}) == {
        "fast_math": False, "device": "cpu", "wait_for_finish": False}
    x = rand((3, 128), 5)
    for kw in ({"force_xla": True}, {"fast_math": False}):
        got = real.rfft(x, device="cpu", **kw)      # numpy in, on "cpu"
        assert got.device.type == "cpu"
        assert rel_err(got.numpy(), np.fft.rfft(x)) < C64


@pytest.mark.parametrize("n", [4, 64, 4096])
@pytest.mark.parametrize("sign", [-1, 1])
def test_half_twiddle_matches_jax(n, sign):
    for a, b in zip(real._half_twiddle(n, sign),
                    jax_real._half_twiddle(n, sign)):
        np.testing.assert_array_equal(a, b)


def test_float64_input_and_odd_offset():
    """float64 input is cast to float32 (complex64 output, as in JAX), and
    a view at an odd storage offset is copied before its complex view."""
    x = rand((4 * 64 + 1,), 11)
    xt = t(x)[1:].view(4, 64)
    assert xt.storage_offset() == 1
    got = real.rfft(xt)
    assert got.dtype == torch.complex64
    assert rel_err(got.numpy(), np.fft.rfft(x[1:].reshape(4, 64))) < C64


@pytest.mark.parametrize("shape", [(64, 128), (4, 32, 64)])
def test_rfft2_matches_jax(shape):
    x = rand(shape, sum(shape))
    got = real.rfft2(t(x))
    assert tuple(got.shape) == shape[:-1] + (shape[-1] // 2 + 1,)
    assert rel_err(got.numpy(), np.fft.rfftn(x, axes=(-2, -1))) < C64
    assert rel_err(got.numpy(), jnp_np(jax_real.rfft2(x))) < C64


def test_rfftn_3d_matches_jax():
    x = rand((16, 32, 64), 3)
    got = real.rfftn(t(x)).numpy()
    assert rel_err(got, np.fft.rfftn(x)) < C64
    assert rel_err(got, jnp_np(jax_real.rfftn(x))) < C64


def test_rfftn_default_rank_caps_at_3():
    x = rand((2, 8, 16, 32), 4)
    got = real.rfftn(t(x)).numpy()
    assert rel_err(got, np.fft.rfftn(x, axes=(1, 2, 3))) < C64


@pytest.mark.parametrize("shape", [(32, 64), (4, 16, 128)])
def test_irfftn_roundtrip_matches_jax(shape):
    x = rand(shape, len(shape))
    X = real.rfftn(t(x), len(shape))
    back = real.irfftn(X, len(shape)).numpy()
    assert back.shape == x.shape
    assert rel_err(back, x) < C64
    jback = np.asarray(jax_real.irfftn(X.numpy(), len(shape)))
    assert rel_err(back, jback) < C64


def test_irfft2_matches_jax_and_numpy():
    X = np.fft.rfftn(rand((64, 32), 9), axes=(0, 1)).astype(np.complex64)
    got = real.irfft2(t(X)).numpy()
    assert rel_err(got, np.fft.irfftn(X.astype(np.complex128),
                                      axes=(0, 1))) < C64
    assert rel_err(got, np.asarray(jax_real.irfft2(X))) < C64


def test_rfft_irfft_planar_match_jax():
    x = rand((8, 256), 11).astype(np.float32)
    xr, xi = real.rfft_planar(t(x))
    jr, ji = jax_real.rfft_planar(x)
    assert rel_err(xr.numpy() + 1j * xi.numpy(), np.asarray(jr)
                   + 1j * np.asarray(ji)) < C64
    back = real.irfft_planar(2.0 * xr, 2.0 * xi)
    jback = jax_real.irfft_planar(2.0 * jr, 2.0 * ji)
    assert rel_err(back.numpy(), 2.0 * x) < C64
    assert rel_err(back.numpy(), np.asarray(jback)) < C64


def test_rfftn_irfftn_planar_match_jax():
    x = rand((32, 64), 12).astype(np.float32)
    xr, xi = real.rfftn_planar(t(x), 2)
    jr, ji = jax_real.rfftn_planar(x, 2)
    got = xr.numpy() + 1j * xi.numpy()
    assert rel_err(got, np.fft.rfftn(x, axes=(0, 1))) < C64
    assert rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < C64
    back = real.irfftn_planar(xr, xi, 2)
    assert rel_err(back.numpy(), x) < C64
    assert rel_err(back.numpy(), np.asarray(
        jax_real.irfftn_planar(jr, ji, 2))) < C64


@pytest.mark.parametrize("route", ["fused", "stream", "planes"])
@pytest.mark.parametrize("shape", [(4, 512), (2, 16, 1024)])
def test_rfft_each_route_matches_jax(route, shape, monkeypatch):
    """The inner n/2-point transforms (n/2 = 256 and 512, both through the
    stream route's gate) under each route; rfft2's leading axis too."""
    monkeypatch.setattr(plan_mod, "IL1D_ROUTE", route)
    x = rand(shape, 13)
    got = real.rfftn(t(x), 2 if len(shape) == 3 else 1)
    jgot = jax_real.rfftn(x, 2 if len(shape) == 3 else 1)
    assert rel_err(got.numpy(), jnp_np(jgot)) < C64
    back = real.irfftn(got, 2 if len(shape) == 3 else 1).numpy()
    assert rel_err(back, x) < C64


def test_package_exports_real_family():
    for name in real.__all__:
        assert getattr(pyfft_tpu_torch, name) is getattr(real, name)
        assert name in pyfft_tpu_torch.__all__
        assert hasattr(pyfft_tpu, name)
