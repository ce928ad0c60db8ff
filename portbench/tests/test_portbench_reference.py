"""The plain reference against numpy.fft at small sizes."""

import numpy as np
import pytest
import torch

from portbench import reference

CASES = [((3, 64), 1), ((2, 16, 32), 2), ((8, 8, 16), 3), ((2, 4096), 1),
         ((2, 8192), 1), ((1, 2**15), 1)]


@pytest.mark.parametrize("shape, ndim", CASES)
@pytest.mark.parametrize("inverse", [False, True])
def test_reference_matches_numpy(shape, ndim, inverse):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    axes = tuple(range(-ndim, 0))
    n = int(np.prod(shape[-ndim:]))
    want = np.fft.ifftn(x, axes=axes) if inverse else np.fft.fftn(x, axes=axes)
    re, im = reference.dft(torch.tensor(x.real), torch.tensor(x.imag), ndim,
                           inverse=inverse, scale=1 / n if inverse else 1.0)
    got = re.numpy() + 1j * im.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


@pytest.mark.parametrize("precision, lo, hi", [("float32", 1e-8, 2e-6),
                                               ("tf32", 5e-5, 5e-3)])
def test_lower_precisions_read_as_they_should(precision, lo, hi):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8192)) + 1j * rng.standard_normal((2, 8192))
    want = np.fft.fft(x)
    re, im = reference.dft(torch.tensor(x.real), torch.tensor(x.imag), 1,
                           inverse=False, precision=precision)
    assert re.dtype == torch.float32
    err = (np.abs(re.double().numpy() + 1j * im.double().numpy() - want).max()
           / np.abs(want).max())
    assert lo < err < hi


def test_tf32_round_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-12, 1 + 2**-12,
                      -1 - 2**-10, 3.0e38])
    r = reference.tf32_round(t)
    assert r.tolist()[:5] == [1.0, 1 + 2**-10, 1 + 2**-10, 1.0, -1 - 2**-10]
    bits = r.view(torch.int32)
    assert torch.all((bits & 0x1FFF) == 0)
