"""The torch port's plain matmul chain (``pyfft_tpu_torch.reference``)
against the JAX package's ``reference.fft_planar`` on identical inputs.

Gates (tests/helpers.py TOL): 2e-6 in float32, 1e-11 in float64, each
against numpy.fft and between the two packages."""

import numpy as np
import pytest
import torch

from pyfft_tpu import reference as jax_reference
from pyfft_tpu_torch import reference

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

SHAPES = [(64,), (256,), (8, 32), (16, 256), (4, 8, 16)]


def cases():
    for shape in SHAPES:
        for axis in range(len(shape)):
            yield shape, axis


@pytest.mark.parametrize("shape,axis", list(cases()))
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_planar_matches_jax(shape, axis, dtype, sign):
    x = rand_complex((3,) + shape, dtype, seed=sum(shape) + axis)
    ax = axis + 1
    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    tr, ti = reference.fft_planar(torch.from_numpy(re), torch.from_numpy(im),
                                  sign, axis=ax)
    jr, ji = jax_reference.fft_planar(re, im, sign, axis=ax)
    got = tr.numpy() + 1j * ti.numpy()
    jgot = np.asarray(jr) + 1j * np.asarray(ji)
    x128 = x.astype(np.complex128)
    ref = (np.fft.fft(x128, axis=ax) if sign < 0
           else np.fft.ifft(x128, axis=ax) * x.shape[ax])
    tol = TOL[dtype]
    assert tr.dtype == (torch.float32 if dtype == np.complex64
                        else torch.float64)
    assert rel_err(got, ref) < tol
    assert rel_err(jgot, ref) < tol
    assert rel_err(got, jgot) < tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fftn_planar_matches_jax(dtype):
    x = rand_complex((2, 8, 16, 32), dtype, seed=3)
    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    axes = (3, 2, 1)
    tr, ti = reference.fftn_planar(torch.from_numpy(re),
                                   torch.from_numpy(im), -1, axes)
    jr, ji = jax_reference.fftn_planar(re, im, -1, axes)
    got = tr.numpy() + 1j * ti.numpy()
    ref = np.fft.fftn(x.astype(np.complex128), axes=axes)
    assert rel_err(got, ref) < TOL[dtype]
    assert rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < TOL[dtype]


def test_fft_planar_errors():
    z = torch.zeros(4, 24)
    with pytest.raises(ValueError):
        reference.fft_planar(z, z, -1)                   # not a power of 2
    with pytest.raises(ValueError):
        reference.fft_planar(torch.zeros(4, 8), torch.zeros(4, 16), -1)
    with pytest.raises(ValueError):
        reference.fft_planar(torch.zeros(8, dtype=torch.float16),
                             torch.zeros(8, dtype=torch.float16), -1)


def test_factorize_matches_jax():
    for p in range(0, 24):
        n = 1 << p
        assert reference._factorize(n, 128) == jax_reference._factorize(n, 128)
