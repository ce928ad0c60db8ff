"""The slice as a whole: the port's ``Plan`` and functional API on the CPU
against the JAX package's, on identical seeded inputs.

Config 2's plan (N = 4096) is run at batch 8.  Its ``local`` pass takes
the plain torch version of the row kernel on a CPU tensor.  Gates
(tests/helpers.py TOL): 2e-6 for complex64, 1e-11 for complex128, against
numpy.fft and between the packages.
"""

import numpy as np
import pytest
import torch

import pyfft_tpu
import pyfft_tpu_torch
from pyfft_tpu_torch import Plan

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

N = 4096
BATCH = 8
C64 = TOL[np.complex64]


def jax_np(out):
    if isinstance(out, tuple):
        return np.asarray(out[0]) + 1j * np.asarray(out[1])
    return np.asarray(out)


def torch_np(out):
    if isinstance(out, tuple):
        return out[0].numpy() + 1j * out[1].numpy()
    return out.numpy()


@pytest.mark.parametrize("form", ["complex", "planar"])
@pytest.mark.parametrize("inverse", [False, True])
def test_config2_plan_matches_jax(form, inverse):
    x = rand_complex((BATCH, N), seed=2)
    plan = Plan((N,), device="cpu")
    jplan = pyfft_tpu.Plan((N,))
    if form == "complex":
        got = plan.execute(torch.from_numpy(x), inverse=inverse)
        jgot = jplan.execute(x, inverse=inverse)
    else:
        re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
        got = plan.execute(torch.from_numpy(re), torch.from_numpy(im),
                           inverse=inverse)
        jgot = jplan.execute(re, im, inverse=inverse)
    x128 = x.astype(np.complex128)
    ref = np.fft.ifft(x128) if inverse else np.fft.fft(x128)
    got, jgot = torch_np(got), jax_np(jgot)
    assert got.shape == x.shape
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_flat_batch_buffer_matches_jax(form):
    x = rand_complex((BATCH * N,), seed=3)
    plan = Plan((N,), device="cpu")
    jplan = pyfft_tpu.Plan((N,))
    if form == "complex":
        got = torch_np(plan.execute(torch.from_numpy(x), batch=BATCH))
        jgot = jax_np(jplan.execute(x, batch=BATCH))
    else:
        re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
        got = torch_np(plan.execute(torch.from_numpy(re),
                                    torch.from_numpy(im), batch=BATCH))
        jgot = jax_np(jplan.execute(re, im, batch=BATCH))
    ref = np.fft.fft(x.astype(np.complex128).reshape(BATCH, N)).ravel()
    assert got.shape == x.shape
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("kw", [{"scale": 2.5}, {"normalize": False},
                                {"scale": 0.25, "normalize": False}])
@pytest.mark.parametrize("inverse", [False, True])
def test_scale_and_normalize_match_jax(kw, inverse):
    x = rand_complex((BATCH, N), seed=4)
    got = torch_np(Plan((N,), device="cpu", **kw).execute(
        torch.from_numpy(x), inverse=inverse))
    jgot = jax_np(pyfft_tpu.Plan((N,), **kw).execute(x, inverse=inverse))
    x128 = x.astype(np.complex128)
    ref = np.fft.fft(x128) if not inverse else np.fft.ifft(x128)
    if inverse and not kw.get("normalize", True):
        ref = ref * N
    ref = ref * kw.get("scale", 1.0)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("shape", [(16, 64), (8, 16, 32)])
def test_multi_axis_plan_matches_jax(shape):
    """Last axis through local, the others through plain; the inverse's
    1/N lands once, in the final pass."""
    x = rand_complex((2,) + shape, seed=len(shape))
    plan = Plan(shape, device="cpu")
    jplan = pyfft_tpu.Plan(shape)
    axes = tuple(range(-len(shape), 0))
    fwd = plan.execute(torch.from_numpy(x))
    assert rel_err(torch_np(fwd), np.fft.fftn(x.astype(np.complex128),
                                              axes=axes)) < C64
    assert rel_err(torch_np(fwd), jax_np(jplan.execute(x))) < C64
    back = torch_np(plan.execute(fwd, inverse=True))
    assert rel_err(back, x) < C64


@pytest.mark.parametrize("shape", [(4096,), (64, 32)])
def test_complex128_plain_matches_jax(shape):
    x = rand_complex((3,) + shape, np.complex128, seed=6)
    plan = Plan(shape, np.complex128, device="cpu")
    assert all(p.executor == "plain" for p in plan._exec_plan.passes)
    got = torch_np(plan.execute(torch.from_numpy(x)))
    jgot = jax_np(pyfft_tpu.Plan(shape, np.complex128).execute(x))
    ref = np.fft.fftn(x, axes=tuple(range(-len(shape), 0)))
    tol = TOL[np.complex128]
    assert rel_err(got, ref) < tol
    assert rel_err(got, jgot) < tol
    back = torch_np(plan.execute(torch.from_numpy(got), inverse=True))
    assert rel_err(back, x) < tol


@pytest.mark.parametrize("fn,kw,shape", [
    ("fft", {}, (4, 256)),
    ("fft", {"axis": 0}, (64, 8)),
    ("ifft", {}, (4, 256)),
    ("fft2", {}, (2, 16, 32)),
    ("ifft2", {}, (2, 16, 32)),
    ("fftn", {}, (8, 16, 32)),
    ("ifftn", {}, (8, 16, 32)),
])
def test_api_matches_jax(fn, kw, shape):
    x = rand_complex(shape, seed=sum(shape))
    got = getattr(pyfft_tpu_torch, fn)(torch.from_numpy(x), **kw)
    assert got.device.type == "cpu" and got.dtype == torch.complex64
    jgot = getattr(pyfft_tpu, fn)(x, **kw)
    assert rel_err(torch_np(got), jax_np(jgot)) < C64
    ref = getattr(np.fft, fn)(x.astype(np.complex128), **kw)
    assert rel_err(torch_np(got), ref) < C64


def test_api_real_input_and_helpers():
    x = np.random.RandomState(7).standard_normal((3, 64))
    got = pyfft_tpu_torch.fft(torch.from_numpy(x))       # f64 -> c128
    assert got.dtype == torch.complex128
    assert rel_err(got.numpy(), np.fft.fft(x)) < TOL[np.complex128]
    got32 = pyfft_tpu_torch.fft(torch.from_numpy(x.astype(np.float32)))
    assert got32.dtype == torch.complex64
    y = torch.arange(8.0)
    assert np.array_equal(pyfft_tpu_torch.fftshift(y).numpy(),
                          np.fft.fftshift(np.arange(8.0)))
    assert np.array_equal(pyfft_tpu_torch.ifftshift(y).numpy(),
                          np.fft.ifftshift(np.arange(8.0)))
    assert np.allclose(pyfft_tpu_torch.fftfreq(8, 0.5).numpy(),
                       np.fft.fftfreq(8, 0.5))
    assert np.allclose(pyfft_tpu_torch.rfftfreq(8).numpy(),
                       np.fft.rfftfreq(8))


def test_get_plan_keys_on_device():
    a = pyfft_tpu_torch.get_plan((64,), device="cpu")
    assert pyfft_tpu_torch.get_plan((64,), device="cpu") is a
    assert pyfft_tpu_torch.get_plan((64,), device="meta") is not a
    assert pyfft_tpu_torch.get_plan((64,), device="cpu", scale=2.0) is not a


@pytest.mark.parametrize("args", [
    ((100,),), ((),), ((2, 2, 2, 2),), ((12, 8),),
    ((64,), np.float32), ((64,), np.int32),
])
def test_errors_match_jax(args):
    with pytest.raises(ValueError):
        pyfft_tpu.Plan(*args)
    with pytest.raises(ValueError):
        Plan(*args, device="cpu")


def test_execute_errors():
    plan = Plan((64,), device="cpu")
    with pytest.raises(ValueError):                  # wrong size
        plan.execute(torch.zeros(100, dtype=torch.complex64))
    with pytest.raises(ValueError):                  # planes differ
        plan.execute(torch.zeros(2, 64), torch.zeros(3, 64))
    with pytest.raises(ValueError):                  # other device
        plan.execute(torch.zeros(64, dtype=torch.complex64, device="meta"))


@pytest.mark.parametrize("shape,dtype,kw,passes", [
    ((4096,), np.complex64, {}, "local"),
    ((8192,), np.complex64, {}, "local"),
    ((4,), np.complex64, {}, "plain"),
    ((16384,), np.complex64, {}, "plain"),
    ((16, 64), np.complex64, {}, "local,plain"),
    ((4, 8, 16), np.complex64, {}, "local,plain,plain"),
    ((4096,), np.complex128, {}, "plain"),
    ((4096,), np.complex64, {"force_xla": True}, "plain"),
])
def test_repr_names_executors(shape, dtype, kw, passes):
    r = repr(Plan(shape, dtype, device="cpu", **kw))
    assert f"passes=[{passes}]" in r and "device=cpu" in r


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_donate_writes_in_place(form):
    x = rand_complex((4, 256), seed=9)
    ref = np.fft.fft(x.astype(np.complex128))
    plan = Plan((256,), device="cpu", donate=True)
    if form == "complex":
        xt = torch.from_numpy(x.copy())
        out = plan.execute(xt)
        assert out.data_ptr() == xt.data_ptr()
        assert rel_err(xt.numpy(), ref) < C64
    else:
        re = torch.from_numpy(np.ascontiguousarray(x.real))
        im = torch.from_numpy(np.ascontiguousarray(x.imag))
        rr, ii = plan.execute(re, im)
        assert rr.data_ptr() == re.data_ptr()
        assert rel_err(re.numpy() + 1j * im.numpy(), ref) < C64


def test_fast_math_false_and_numpy_input():
    x = rand_complex((3, 256), seed=10)
    plan = Plan((256,), device="cpu", fast_math=False)
    got = plan.execute(x)                   # numpy moves to plan.device
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert rel_err(got.numpy(), np.fft.fft(x.astype(np.complex128))) < C64
    jgot = pyfft_tpu.Plan((256,), fast_math=False).execute(x)
    assert rel_err(got.numpy(), jax_np(jgot)) < C64


def test_wait_for_finish_default():
    assert Plan((64,), device="cpu").wait_for_finish
    assert not Plan((64,), device="cpu", stream=object()).wait_for_finish
    assert not Plan((64,), device="cpu", queue=object()).wait_for_finish
    assert Plan((64,), device="cpu", stream=object(),
                wait_for_finish=True).wait_for_finish
