"""The int8-split stage K10 (``precision="int8"``) inside the interleaved
row kernel K2, against the JAX package on the CPU:
``local.fft_rows_interleaved(v, sign, precision="int8")`` beside
``pallas_local._fft_rows_interleaved(..., precision="int8",
interpret=True)``, the private entry through which JAX's ``_kernel`` runs
the stage on interleaved rows.

A CPU tensor takes the plain version, the two stride-2 planes through
``fft_rows_plain(precision="int8")`` with JAX's default chain (not the row
chain: f = 128 at n = 2048), the rows zero-padded to 128-row tiles, each
tile one alignment group as a JAX block.  JAX's private entry does not pad:
it fills a ragged edge block with unspecified values, which the stage's
max |x| reads, so ragged row counts are held against numpy only.  Gates:
within 1e-6 of the JAX function relative to each tile's peak, and within
2e-6 (tests/helpers.py TOL) of numpy.  The CUDA kernel (K2 + K10) is
checked on the card by chip_smoke.py (phase 21).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.utils import profiling

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]
PARITY = 1e-6
NS = [1 << p for p in range(3, 14)]


def pairs(x: np.ndarray) -> np.ndarray:
    """complex64 (rows, n) -> its (rows, 2n) float32 interleaved view."""
    return np.ascontiguousarray(x).view(np.float32)


def port(x, sign, postscale=1.0, **kw):
    v = torch.from_numpy(pairs(x).copy())
    return local.fft_rows_interleaved(v, sign, postscale=postscale,
                                      **kw).numpy().view(np.complex64)


def jax_il(x, sign, postscale=1.0, **kw):
    n = x.shape[-1]
    return np.asarray(jax_local._fft_rows_interleaved(
        jnp.asarray(pairs(x)), n=n, sign=sign, postscale=postscale,
        interpret=True, **kw)).view(np.complex64)


def ref_fft(x, sign, postscale=1.0):
    x = x.astype(np.complex128)
    y = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * x.shape[-1]
    return y * postscale


def tiles_err(got, want, size=128):
    """The worst error of any ``size``-row tile against its own peak."""
    return max(rel_err(got[i:i + size], want[i:i + size])
               for i in range(0, got.shape[0], size))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("sign", [-1, 1])
def test_il_int8_matches_jax(n, sign):
    x = rand_complex((128, n), seed=n + (sign > 0))
    got = port(x, sign, 0.3, precision="int8")
    jgot = jax_il(x, sign, 0.3, precision="int8")
    ref = ref_fft(x, sign, 0.3)
    assert got.shape == jgot.shape == ref.shape == (128, n)
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_il_int8_groups_as_jax_tiles():
    """Two 128-row tiles 2^20 apart: each matches JAX at 1e-6 against its
    own peak; one exponent over both misses the small tile."""
    n = 256
    x = rand_complex((256, n), seed=50)
    x[128:] *= 2.0 ** -20
    got = port(x, -1, precision="int8")
    jgot = jax_il(x, -1, precision="int8")
    ref = ref_fft(x, -1)
    assert tiles_err(got, jgot) < PARITY
    assert tiles_err(got, ref) < C64
    xt = torch.from_numpy(x)
    whole = local.fft_rows_plain(xt.real.contiguous(), xt.imag.contiguous(),
                                 -1, factors=local.default_factors(n),
                                 precision="int8", lanes=256)
    whole = whole[0].numpy() + 1j * whole[1].numpy()
    assert rel_err(whole, jgot) < PARITY          # invisible at the peak
    assert tiles_err(whole, jgot) > 100 * PARITY


def test_il_int8_ragged_rows_pad_with_zeros():
    """200 rows: within the gate of numpy per tile, and the first 200 rows
    of the same input zero-padded to 256, bit for bit."""
    n = 256
    x = rand_complex((200, n), seed=51)
    got = port(x, 1, 0.3, precision="int8")
    assert tiles_err(got, ref_fft(x, 1, 0.3)) < C64
    padded = np.concatenate([x, np.zeros((56, n), np.complex64)])
    assert np.array_equal(got, port(padded, 1, 0.3, precision="int8")[:200])


def test_il_int8_out_and_leading_axes():
    """``out=`` (in place included) and leading axes take the same
    function on the CPU; no kernel launch is counted there."""
    n = 512
    x = rand_complex((2, 64, n), seed=52)
    want = port(x.reshape(128, n), -1, 0.3, precision="int8")
    before = profiling.counts()
    v = torch.from_numpy(pairs(x).copy())
    got = local.fft_rows_interleaved(v, -1, postscale=0.3, precision="int8",
                                     out=v)
    assert got is v and tuple(v.shape) == (2, 64, 2 * n)
    assert np.array_equal(v.numpy().view(np.complex64).reshape(128, n), want)
    assert profiling.counts() == before


def test_il_int8_packed_refused_by_both():
    """The packed form has no int8 path: JAX raises KeyError (its
    precision map has no "int8"), the port ValueError."""
    x = rand_complex((128, 64), seed=53)
    with pytest.raises(KeyError):
        jax_il(x, -1, precision="int8", packed=True)
    v = torch.from_numpy(pairs(x).copy())
    with pytest.raises(ValueError, match="packed"):
        local.fft_rows_interleaved(v, -1, precision="int8", packed=True)
    with pytest.raises(ValueError, match="packed"):
        local.fft_rows_interleaved_plain(v, -1, packed=True, precision="int8")


@pytest.mark.parametrize("precision,dtype,match", [
    ("int8", torch.float64, "float32"),
    ("default", torch.float32, "precision"),
    ("bf16", torch.float32, "precision")])
def test_il_int8_refusals(precision, dtype, match):
    v = torch.zeros((4, 2 * 64), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        local.fft_rows_interleaved(v, -1, precision=precision)
    with pytest.raises(ValueError, match=match):
        local.fft_rows_interleaved_plain(v, -1, precision=precision)


def test_il_int8_at_n8_changes_nothing():
    """n = 8 has no matrix stage (matrix_factor 0): int8 is the float path,
    bit for bit, in both packages."""
    assert local.matrix_factor(local.default_factors(8)) == 0
    x = rand_complex((128, 8), seed=54)
    assert np.array_equal(port(x, -1, 0.3, precision="int8"),
                          port(x, -1, 0.3))
    assert np.array_equal(jax_il(x, -1, 0.3, precision="int8"),
                          jax_il(x, -1, 0.3))


@pytest.mark.cuda
def test_il_int8_kernel_on_the_card():
    """K2 + K10 against its plain version on a CUDA card, one launch a
    call (chip_smoke.py phase 21 does the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = rand_complex((384, 2048), seed=55)
    v = torch.from_numpy(pairs(x)).cuda()
    before = profiling.total("launch.K2+K10")
    got = local.fft_rows_interleaved(v, -1, postscale=0.3, precision="int8")
    torch.cuda.synchronize()
    assert profiling.total("launch.K2+K10") == before + 1
    want = local.fft_rows_interleaved_plain(v, -1, 0.3, precision="int8")
    g, w = (t.cpu().numpy().view(np.complex64) for t in (got, want))
    assert tiles_err(g, w) < C64
