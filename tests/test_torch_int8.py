"""The int8-split DFT stage K10 (``precision="int8"``) against the JAX
package on the CPU: the channel tables, the stage itself, and
``local.fft_axis(..., precision="int8")`` for rows and columns, beside
``pallas_local.fft_axis(..., precision="int8", interpret=True)``.

A CPU tensor takes the plain torch versions, which group the int8 stage's
alignment exponent as the JAX kernel's blocks do (128-row tiles; per l,
128- or 256-column tiles).  Gates: within 1e-6 of the JAX function relative
to the peak, and within 2e-6 (tests/helpers.py TOL) of numpy.  Chains are
passed to JAX explicitly, since its ``row_factors``/``col_factors`` can read
a per-machine autotune record.  The CUDA kernels (K1 and K5 with the stage)
are checked on the card by chip_smoke.py (phase 19).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import fused2d, int8, local
from pyfft_tpu_torch.utils import profiling

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C64 = TOL[np.complex64]
PARITY = 1e-6
NS = [1 << p for p in range(3, 14)]


def planar(x):
    return (np.ascontiguousarray(np.real(x)).astype(np.float32),
            np.ascontiguousarray(np.imag(x)).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def torch_planes(x):
    return tuple(torch.from_numpy(a) for a in planar(x))


# ------------------------------------------------------------ the tables


def test_constants_are_the_jax_packages():
    assert int8.B == jax_local._I8_B
    assert int8.W_SHIFTS == jax_local._I8_W_SHIFTS
    assert int8.X_SHIFTS == jax_local._I8_X_SHIFTS
    assert int8.KEEP == jax_local._I8_KEEP


@pytest.mark.parametrize("f", [16, 32, 64, 128])
@pytest.mark.parametrize("sign", [-1, 1])
def test_int8_chunks_bit_equal(f, sign):
    wr, wi = jax_local.dft_matrix(f, sign, np.float64)
    ws = np.block([[wr, -wi], [wi, wr]])
    want = jax_local._int8_chunks_np(ws, jax_local._I8_W_SHIFTS)
    got = int8.int8_chunks_np(ws, int8.W_SHIFTS)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int8 and np.array_equal(a, b)
    for a, b in zip(int8.stacked_channels(f, sign), want):
        assert np.array_equal(a, b)
    w = int8.w_tables(f, sign, torch.device("cpu"))
    assert w.dtype == torch.int8 and w.is_contiguous()
    w = w[:12 * f * f].reshape(3, 2 * f, 2 * f)
    assert np.array_equal(w.numpy(), np.stack(want))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("chain", ["row", "col"])
def test_needed_tables_int8_equal(n, chain):
    f = local.row_factors(n) if chain == "row" else local.col_factors(n)
    for sign in (-1, 1):
        want = jax_local.needed_tables(n, sign, factors=f, precision="int8")
        got = local.needed_tables(n, sign, factors=f, precision="int8")
        assert list(got) == list(want)
        for k in want:
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a, b)
    assert not any(k[0] == "dftsfold" for k in got)
    assert (("wi8", f[-1]) in got) == (n > 8)


# ------------------------------------------------------------ the stage


@pytest.mark.parametrize("f,shape,axis", [
    (16, (16, 128), 0), (32, (8, 32, 128), 1), (64, (4, 64, 128), 1),
    (128, (128, 8, 128), 0)])
def test_int8_stage_bit_equal_to_jax(f, shape, axis):
    """One identical tile through both stages: bit-equal (the products are
    exact integers in both, and the float steps are the same operations in
    the same order)."""
    rng = np.random.RandomState(f)
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    for sign in (-1, 1):
        wch = jax_local.needed_tables(f, sign, precision="int8")[("wi8", f)]
        jr, ji = jax_local._int8_stage(jnp.asarray(xr), jnp.asarray(xi), f,
                                       axis, tuple(jnp.asarray(w) for w in wch))
        tr, ti = int8.int8_stage(torch.from_numpy(xr), torch.from_numpy(xi),
                                 f, axis, int8.stacked_channels(f, sign))
        assert np.array_equal(np.asarray(jr), tr.numpy())
        assert np.array_equal(np.asarray(ji), ti.numpy())


def test_int8_stage_groups_take_their_own_exponent():
    """With ``group_axis`` each group is the stage of that group alone."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    x[:, :, 1] *= 2.0 ** -20
    re, im = torch.from_numpy(x[0]), torch.from_numpy(x[1])
    wch = int8.stacked_channels(16, -1)
    yr, yi = int8.int8_stage(re, im, 16, 0, wch, group_axis=-2)
    for g in range(3):
        gr, gi = int8.int8_stage(re[:, g], im[:, g], 16, 0, wch)
        assert torch.equal(yr[:, g], gr) and torch.equal(yi[:, g], gi)


# ------------------------------------------------------- fft_axis, int8


def ref_fft(x, axis, sign):
    x = x.astype(np.complex128)
    n = x.shape[axis]
    return (np.fft.fft(x, axis=axis) if sign < 0
            else np.fft.ifft(x, axis=axis) * n)


@pytest.mark.parametrize("shape", [(200, 256), (64, 2048)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_rows_int8_matches_jax(shape, sign):
    x = rand_complex(shape, seed=shape[0] + sign)
    n = shape[-1]
    f = local.row_factors(n)
    got = cplx(local.fft_axis(*torch_planes(x), sign, precision="int8",
                              postscale=0.5))
    jgot = cplx(jax_local.fft_axis(*planar(x), sign, axis=-1,
                                   precision="int8", factors=f, postscale=0.5,
                                   interpret=True))
    ref = ref_fft(x, -1, sign) * 0.5
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


@pytest.mark.parametrize("shape,kw", [
    ((2, 256, 512), {}),                                  # 256-lane tiles
    ((2, 512, 200), {}),                                  # ragged pad
    ((2, 64, 256), dict(tw_n=64 * 256, swap_store=True)),
    ((3, 128, 384), dict(tw_n=128 * 384)),
])
def test_cols_int8_matches_jax(shape, kw):
    x = rand_complex(shape, seed=sum(shape))
    n = shape[1]
    f = local.col_factors(n)
    got = cplx(local.fft_axis(*torch_planes(x), -1, axis=1, precision="int8",
                              **kw))
    jgot = cplx(jax_local.fft_axis(*planar(x), -1, axis=1, precision="int8",
                                   factors=f, interpret=True, **kw))
    ref = ref_fft(x, 1, -1)
    if kw:
        T = shape[2]
        k = np.arange(n)[:, None]
        t = np.arange(T)[None, :]
        ref = ref * np.exp(-2j * np.pi * k * t / kw["tw_n"])[None]
        if kw.get("swap_store"):
            ref = ref.transpose(0, 2, 1)
    assert got.shape == jgot.shape == ref.shape
    assert rel_err(got, jgot) < PARITY
    assert rel_err(got, ref) < C64
    assert rel_err(jgot, ref) < C64


def test_int8_at_n8_changes_nothing():
    """n = 8 has no matrix stage: int8 is the float path, bit for bit."""
    x = torch_planes(rand_complex((130, 8), seed=1))
    a = local.fft_axis(*x, -1, precision="int8")
    b = local.fft_axis(*x, -1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    z = torch_planes(rand_complex((2, 8, 200), seed=2))
    a = local.fft_axis(*z, +1, axis=1, precision="int8")
    b = local.fft_axis(*z, +1, axis=1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def tiles_err(got, want, tile):
    """The worst error of any 128-row tile against its own peak."""
    return max(rel_err(got[i:i + tile], want[i:i + tile])
               for i in range(0, got.shape[0], tile))


def test_int8_groups_as_jax_blocks():
    """Rows whose magnitudes differ by 2^20 from one 128-row tile to the
    next: each tile matches JAX at 1e-6 against its own peak, as the
    alignment exponent is taken per tile.  One exponent over the whole
    batch fails that gate on the small tiles."""
    n = 256
    x = rand_complex((384, n), seed=20)
    x[128:256] *= 2.0 ** -20
    x[256:] *= 2.0 ** 10
    f = local.row_factors(n)
    got = cplx(local.fft_axis(*torch_planes(x), -1, precision="int8"))
    jgot = cplx(jax_local.fft_axis(*planar(x), -1, axis=-1, precision="int8",
                                   factors=f, interpret=True))
    ref = ref_fft(x, -1, -1)
    assert tiles_err(got, jgot, 128) < PARITY
    assert tiles_err(got, ref, 128) < C64
    # the whole batch as one alignment group
    re, im = torch_planes(x)
    tables = local.needed_tables(n, -1, factors=f, precision="int8")
    wr, wi = local.tile_fft(re.T, im.T, local.tables_from_numpy(
        tables, torch.device("cpu")), n, f, sign=-1, precision="int8")
    whole = cplx((wr.T, wi.T))
    assert rel_err(whole, jgot) < PARITY          # invisible at the peak
    assert tiles_err(whole, jgot, 128) > 100 * PARITY


def test_int8_column_groups_per_tile():
    """Columns: each l and each 128-column tile has its own exponent."""
    x = rand_complex((2, 64, 384), seed=21)
    x[0, :, 128:256] *= 2.0 ** -20
    x[1] *= 2.0 ** -12
    f = local.col_factors(64)
    got = cplx(local.fft_axis(*torch_planes(x), -1, axis=1,
                              precision="int8"))
    jgot = cplx(jax_local.fft_axis(*planar(x), -1, axis=1, precision="int8",
                                   factors=f, interpret=True))
    for l in range(2):
        for t in range(0, 384, 128):
            assert rel_err(got[l, :, t:t + 128], jgot[l, :, t:t + 128]) \
                < PARITY


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("precision", ["default", "float32", "", "INT8"])
def test_unknown_precision_raises(precision):
    z = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="'highest' or 'int8'"):
        local.fft_axis(z, z, -1, precision=precision)
    with pytest.raises(ValueError, match="'highest' or 'int8'"):
        local.fft_axis(torch.zeros(2, 64, 128), torch.zeros(2, 64, 128), -1,
                       axis=1, precision=precision)


def test_int8_refuses_float64_and_ctile():
    z = torch.zeros(4, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        local.fft_axis(z, z, -1, precision="int8")
    c = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError, match="ctile"):
        local.fft_axis(c, c, -1, axis=1, ctile=2, precision="int8")


@pytest.mark.parametrize("plain", ["rows", "cols"])
def test_plain_versions_check_precision(plain):
    """The plain versions take the same precisions as fft_axis."""
    fn = local.fft_rows_plain if plain == "rows" else local.fft_cols_plain
    z = torch.zeros(2, 64, 128)
    with pytest.raises(ValueError, match="float32"):
        fn(z.double(), z.double(), -1, precision="int8")
    with pytest.raises(ValueError, match="'highest' or 'int8'"):
        fn(z, z, -1, precision="default")


@pytest.mark.parametrize("kw", [dict(swap_store=True),
                                dict(swap_store=True, tw_n=64 * 200)])
def test_int8_ragged_swap_raises(kw):
    z = torch.zeros(2, 64, 200)
    with pytest.raises(ValueError, match="whole"):
        local.fft_axis(z, z, -1, axis=1, precision="int8", **kw)


def test_every_host_takes_int8():
    """K4, K8, K9 and the fold take "int8" on the CPU (their plain versions)
    and still refuse an unknown precision such as JAX's "default"."""
    z = torch.ones(2, 128, 128)
    f = torch.ones(1, 128, 8, 128)
    calls = ((local.fft_rows_swap, (z, z, -1), {}),
             (fused2d.fft2_fused, (z, z, -1), {}),
             (fused2d.fft2_fused_tiled, (z, z, -1), {}),
             (local.fft_axis_fold, (f, f, -1), dict(axis=1)))
    for fn, args, kw in calls:
        got = fn(*args, precision="int8", **kw)
        want = fn(*args, precision="highest", **kw)
        assert got[0].shape == want[0].shape
        assert rel_err(cplx(got), cplx(want)) < C64
        with pytest.raises(ValueError, match="'highest' or 'int8'"):
            fn(*args, precision="default", **kw)


def test_int8_launch_checks_raise_before_any_launch():
    """The int8 launch wrappers refuse CPU planes before the library is
    touched."""
    before = profiling.counts()
    z = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError):
        local._launch_rows(z, z, z, z, -1, 1.0, i8_f=64)
    with pytest.raises(ValueError):
        local._launch_cols(z, z, z, z, -1, axis=1, postscale=1.0, tw_n=0,
                           tw_mode="full", tw_period=0, swap_store=False,
                           swap_mid=0, i8_f=64)
    assert profiling.counts() == before


@pytest.mark.parametrize("n,chain,f", [
    (8, "row", 0), (16, "row", 16), (256, "row", 64), (256, "col", 32),
    (512, "col", 128), (2048, "row", 64), (8192, "col", 128)])
def test_matrix_factor(n, chain, f):
    factors = local.row_factors(n) if chain == "row" else local.col_factors(n)
    assert local.matrix_factor(factors) == f


def macro_cases(source: str, macro: str, arity: int) -> list:
    """The X(...) tuples of ``#define macro(X)`` in csrc/``source``."""
    import re
    from pathlib import Path
    src = (Path(local.__file__).parent / "csrc" / source).read_text()
    body = src.split(f"#define {macro}(X)")[1].split("\n\n")[0]
    pat = r"X\(" + ", ".join([r"(\d+)"] * arity) + r"\)"
    return [tuple(map(int, t)) for t in re.findall(pat, body)]


def log2f(n: int, factors) -> int:
    return local.matrix_factor(factors(n)).bit_length() - 1


@pytest.mark.parametrize("chain", ["row", "col", "default",
                                   "default_il"])
def test_kernel_instantiations_cover_every_chain(chain):
    """csrc/int8_stage.cuh instantiates the kernels for the (log2 n,
    log2 f) pairs of PYFFT_I8_CHAINS (K1, K5: the row and column chains);
    the K4 + K10 entry and the interleaved row entry add the pairs they name
    outside the list (K4 + K10 and K2 + K10: JAX's default chain, f = 128
    at n = 2048).  Every n's matrix factor must be among them, or the
    launch returns an error."""
    import re
    from pathlib import Path
    pairs = macro_cases("int8_stage.cuh", "PYFFT_I8_CHAINS", 2)
    if chain.startswith("default"):
        # K4 + K10: its entry in the column source; K2 + K10: the row
        # kernels' dispatch under `if constexpr (IL)`
        source, entry = (("local_cols.cu", "int pyfft_local_rows_swap_i8(")
                         if chain == "default" else
                         ("local_rows.cu", "cudaError_t dispatch_i8("))
        src = (Path(local.__file__).parent / "csrc" / source)
        body = src.read_text().split(entry)[1].split("\n}\n")[0]
        if chain == "default_il":
            body = body.split("if constexpr (IL)")[1]
        pairs += [tuple(map(int, t)) for t in re.findall(
            r"log2n == (\d+) && log2f == (\d+)", body)]
        factors = local.default_factors
    else:
        factors = local.row_factors if chain == "row" else local.col_factors
    for p in range(4, 14):
        f = local.matrix_factor(factors(1 << p))
        assert f and (p, f.bit_length() - 1) in pairs


@pytest.mark.parametrize("source,float_cases,i8_cases,factors", [
    ("fused2d.cu", "PYFFT_FUSED2D_CASES", "PYFFT_FUSED2D_I8_CASES",
     local.default_factors),
    ("fused2d_tiled.cu", "PYFFT_TILED_CASES", "PYFFT_TILED_I8_CASES",
     local.col_factors)])
def test_2d_int8_instantiations_cover_every_shape(source, float_cases,
                                                  i8_cases, factors):
    """K8's and K9's int8 kernels are instantiated at every plane shape of
    the float kernels, each axis with the matrix factor of the chain the
    JAX kernel takes (K8 default_factors, K9 col_factors)."""
    shapes = macro_cases(source, float_cases, 2)
    cases = macro_cases(source, i8_cases, 4)
    assert len(shapes) == {"fused2d.cu": 15, "fused2d_tiled.cu": 28}[source]
    assert cases == [(a, log2f(1 << a, factors), b, log2f(1 << b, factors))
                     for a, b in shapes]


@pytest.mark.cuda
def test_int8_kernels_on_the_card():
    """K1 and K5 with the int8 stage against their plain versions on a
    CUDA card (chip_smoke.py phase 19 does the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = rand_complex((3, 256, 384), seed=30)
    re, im = (t.cuda() for t in torch_planes(x))
    for axis in (-1, 1):
        key = "launch.K1+K10" if axis == -1 else "launch.K5+K10"
        b = profiling.total(key)
        got = local.fft_axis(re, im, -1, axis=axis, precision="int8")
        torch.cuda.synchronize()
        assert profiling.total(key) == b + 1
        if axis == -1:
            want = local.fft_rows_plain(re, im, -1, precision="int8")
        else:
            want = local.fft_cols_plain(re, im, -1, precision="int8")
        assert rel_err(cplx([t.cpu() for t in got]),
                       cplx([t.cpu() for t in want])) < C64
