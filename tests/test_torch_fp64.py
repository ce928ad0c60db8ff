"""The port's complex128 path (``pyfft_tpu_torch.ops.fp64`` over the float64
plain versions of the row and column kernels, and the planner's complex128
routes) against the JAX package's double-float path
(``pyfft_tpu.ops.pallas_df64``, its Pallas kernels in interpret mode) on
identical seeded inputs on the CPU.

JAX takes each float64 plane as a (hi, lo) float32 pair from
``df64.split_f64`` and its result is recombined as hi + lo, as
tests/test_df64.py does; the cases are sized as that file sizes them.  Its
autotune record is pointed at an empty file, so that its splits come from
its static rules.  Gate: 1e-11 (tests/helpers.py TOL), against numpy and
between the packages.  The CUDA kernels K11 and K12 themselves are checked
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfft_tpu
import pyfft_tpu_torch
from pyfft_tpu import planner as jax_planner
from pyfft_tpu.ops import df64 as jax_df64
from pyfft_tpu.ops import fourstep as jax_fourstep
from pyfft_tpu.ops import pallas_df64
from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch import Plan, planner
from pyfft_tpu_torch.ops import fp64, local

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

C128 = TOL[np.complex128]


@pytest.fixture(autouse=True)
def static_jax_tables(tmp_path, monkeypatch):
    """Point the JAX package's autotune record at an empty file."""
    path = tmp_path / "tuned.json"
    path.write_text("{}")
    monkeypatch.setenv("PYFFT_TPU_TUNE_FILE", str(path))
    jax_local.reload_tuned()
    yield
    jax_local._TUNED = None


def quad(x):
    """complex128 -> JAX's (rh, rl, ih, il) float32 planes."""
    out = []
    for plane in (np.real(x), np.imag(x)):
        hi, lo = jax_df64.split_f64(np.ascontiguousarray(plane))
        out += [jnp.asarray(hi), jnp.asarray(lo)]
    return tuple(out)


def unquad(planes):
    rh, rl, ih, il = (np.asarray(p) for p in planes)
    return (jax_df64.combine_f64(rh, rl)
            + 1j * jax_df64.combine_f64(ih, il))


def planes(x):
    """complex128 -> the port's (re, im) float64 CPU planes."""
    return (torch.from_numpy(np.ascontiguousarray(np.real(x))),
            torch.from_numpy(np.ascontiguousarray(np.imag(x))))


def to_c(r, i):
    return r.numpy() + 1j * i.numpy()


def dft_ref(x, sign, axis):
    if sign < 0:
        return np.fft.fft(x, axis=axis)
    return np.fft.ifft(x, axis=axis) * x.shape[axis]


@pytest.mark.parametrize("n", [8, 64, 256, 1024])
@pytest.mark.parametrize("sign", [-1, 1])
def test_rows_match_jax(n, sign):
    """K11's plain version against JAX's row kernel, postscale 0.3."""
    x = rand_complex((16, n), np.complex128, seed=n + sign)
    got = to_c(*fp64.fft_axis_df64(*planes(x), sign, axis=-1,
                                   postscale=0.3))
    jgot = unquad(pallas_df64.fft_axis_df64(quad(x), sign, axis=-1,
                                            postscale=0.3, interpret=True))
    ref = 0.3 * dft_ref(x, sign, -1)
    assert rel_err(got, ref) < C128
    assert rel_err(jgot, ref) < C128
    assert rel_err(got, jgot) < C128


def col_reference(x, sign, postscale=1.0, tw_n=0, tw_mode="full",
                  tw_period=0, swap_store=False, swap_mid=0):
    """numpy complex128 of the column pass over axis 1 of (L, n, T)."""
    L, n, T = x.shape
    X = dft_ref(x, sign, 1)
    if tw_n:
        k = np.arange(n, dtype=np.int64)[:, None]
        t = np.arange(T, dtype=np.int64)[None, :]
        g = t // tw_period if tw_mode == "strided" else t
        X = X * np.exp(sign * 2j * np.pi * ((k * g) % tw_n) / tw_n)
    X = X * postscale
    if swap_store:
        return X.transpose(0, 2, 1)
    if swap_mid:
        return X.reshape(L, n, T // swap_mid, swap_mid).transpose(0, 2, 1, 3)
    return X


def both_cols(x, sign, **kw):
    """(port, JAX, numpy) results of the column pass over axis 1 of x."""
    got = to_c(*fp64.fft_axis_df64(*planes(x), sign, axis=1, **kw))
    jgot = unquad(pallas_df64.fft_axis_df64(quad(x), sign, axis=1,
                                            interpret=True, **kw))
    ref = col_reference(x, sign, **kw)
    assert got.shape == jgot.shape == ref.shape
    return got, jgot, ref


@pytest.mark.parametrize("n", [16, 256])
def test_cols_plain_store_matches_jax(n):
    """K12's plain version against JAX's column kernel, plain store (the
    local column pass and the last four-step and six-step pass), at
    (2, n, 128) with postscale 0.3."""
    x = rand_complex((2, n, 128), np.complex128, seed=n)
    got, jgot, ref = both_cols(x, -1, postscale=0.3)
    assert rel_err(got, ref) < C128
    assert rel_err(jgot, ref) < C128
    assert rel_err(got, jgot) < C128


# the twiddle/store pairs of the complex128 routes: the four-step's first
# pass, and the six-step's first and second
COL_MODES = {
    "full swap_store": dict(tw_mode="full", swap_store=True),
    "strided swap_mid": dict(tw_mode="strided", tw_period=128, swap_mid=128),
    "factored swap_store": dict(tw_mode="factored", swap_store=True),
}


@pytest.mark.parametrize("mode", list(COL_MODES))
@pytest.mark.parametrize("n", [16, 64])
def test_cols_modes_match_jax(mode, n):
    """The twiddled modes at (2, n, 256), so that the strided and factored
    tables have two column runs, with postscale 0.3."""
    kw = dict(COL_MODES[mode])
    q = 256 // kw["tw_period"] if kw["tw_mode"] == "strided" else 256
    x = rand_complex((2, n, 256), np.complex128, seed=n + len(mode))
    got, jgot, ref = both_cols(x, -1, postscale=0.3, tw_n=n * q, **kw)
    assert rel_err(got, ref) < C128
    assert rel_err(jgot, ref) < C128
    assert rel_err(got, jgot) < C128


def test_cols_inverse_matches_jax():
    x = rand_complex((2, 64, 128), np.complex128, seed=5)
    got = to_c(*fp64.fft_axis_df64(*planes(x), +1, axis=1,
                                   postscale=1.0 / 64))
    jgot = unquad(pallas_df64.fft_axis_df64(quad(x), +1, axis=1,
                                            postscale=1.0 / 64,
                                            interpret=True))
    ref = np.fft.ifft(x, axis=1)
    assert rel_err(got, ref) < C128
    assert rel_err(got, jgot) < C128


def test_large_matches_jax():
    """The four-step at 2^16 with a local ceiling of 256: the split
    (256, 256), two K12 passes (full twiddle + swapped store, then the
    plain store with the postscale), and the inverse round trip."""
    n = 1 << 16
    x = rand_complex((2, n), np.complex128, seed=13)
    got = to_c(*fp64.fft_axis_large_df64(*planes(x), -1, axis=-1,
                                         max_local=256, postscale=0.5))
    jgot = unquad(pallas_df64.fft_axis_large_df64(
        quad(x), -1, axis=-1, max_local=256, postscale=0.5, interpret=True))
    ref = 0.5 * np.fft.fft(x)
    assert rel_err(got, ref) < C128
    assert rel_err(got, jgot) < C128
    back = to_c(*fp64.fft_axis_large_df64(*planes(got), +1, axis=-1,
                                          max_local=256, postscale=2.0 / n))
    assert rel_err(back, x) < C128


def test_huge_matches_jax():
    """The six-step at 2^21 with a factor cap of 128: split (128, 128,
    128), the factored twiddle + swapped store, the strided twiddle + mid
    swap, then the plain store; and the inverse round trip."""
    n = 1 << 21
    x = rand_complex((n,), np.complex128, seed=23)
    got = to_c(*fp64.fft_axis_huge_df64(*planes(x), -1, axis=-1, max_f=128,
                                        postscale=0.5))
    jgot = unquad(pallas_df64.fft_axis_huge_df64(
        quad(x), -1, axis=-1, max_f=128, postscale=0.5, interpret=True))
    ref = 0.5 * np.fft.fft(x)
    assert rel_err(got, ref) < C128
    assert rel_err(got, jgot) < C128
    back = to_c(*fp64.fft_axis_huge_df64(*planes(got), +1, axis=-1,
                                         max_f=128, postscale=2.0 / n))
    assert rel_err(back, x) < C128


@pytest.mark.parametrize("shape", [
    (1 << 22,), (4096,), (1024, 1024), (256, 256, 256), (16384, 1024),
] + [(1 << p,) for p in range(13, 26)])
def test_build_plan_matches_jax(shape):
    """Both planners give each complex128 axis the same executor, with
    JAX's ``xla`` read as ``plain``, and the same four-step split; the
    six-step split is JAX's ``choose_split3`` up to 2^25."""
    want = jax_planner.build_plan(shape, np.complex128, on_tpu=True)
    got = planner.build_plan(shape, np.complex128)
    assert [(p.axis, p.n, p.executor) for p in got.passes] == \
        [(p.axis, p.n, "plain" if p.executor == "xla" else p.executor)
         for p in want.passes]
    for g, w in zip(got.passes, want.passes):
        if g.executor == "fourstep":
            assert g.split == w.split
        if g.executor == "huge":
            assert g.split == jax_fourstep.choose_split3(
                g.n, pallas_df64.HUGE_MAX_F_DF64)


@pytest.mark.parametrize("p,port,jax_split", [
    (26, (256, 512, 512), (1024, 256, 256)),
    (27, (512, 512, 512), (2048, 256, 256)),
])
def test_huge_splits_differ_from_jax_beyond_2_25(p, port, jax_split):
    """From 2^26 up the port keeps its most balanced split; the JAX
    package's v5e cost model picks a larger first factor.  Both pinned."""
    n = 1 << p
    (got,) = planner.build_plan((n,), np.complex128).passes
    assert (got.executor, got.split) == ("huge", port)
    assert jax_fourstep.choose_split3(n, pallas_df64.HUGE_MAX_F_DF64) == \
        jax_split
    (want,) = jax_planner.build_plan((n,), np.complex128,
                                     on_tpu=True).passes
    assert want.executor == "huge"


def test_choose_split_df64_matches_jax():
    for p in range(13, 25):
        n = 1 << p
        assert fp64.choose_split_df64(n) == \
            pallas_df64._choose_split_df64(n, pallas_df64.MAX_LOCAL_N_DF64)
    assert fp64.choose_split_df64(1 << 22) == (2048, 2048)       # config 5
    assert fp64.choose_split_df64(1 << 23) == (4096, 2048)       # n1 larger
    assert (fp64.MAX_LOCAL_N_DF64, fp64.HUGE_MAX_F_DF64) == \
        (pallas_df64.MAX_LOCAL_N_DF64, pallas_df64.HUGE_MAX_F_DF64)


@pytest.mark.parametrize("fn,shape,axis", [
    ("supported", (2, 4096), -1),
    ("supported", (2, 8192), -1),          # split (128, 64): no
    ("supported", (2, 16384), -1),
    ("supported", (4096, 128), 0),
    ("supported", (4096, 64), 0),          # trail < 128
    ("supported", (16384, 128), 0),        # above 4096, not the last axis
    ("supported", (2, 4), -1),             # below 8
    ("supported", (1, 1 << 25), -1),       # the six-step's range
    ("supported_huge", (1, 1 << 25), -1),
    ("supported_huge", (1, 1 << 24), -1),  # one four-step level
    ("supported_huge", (1 << 25, 1), 0),
])
def test_supported_gates_match_jax(fn, shape, axis):
    """The complex128 gates on zero-memory stand-ins: a float64 plane in
    the port, JAX's float32 hi plane; a float32 plane is refused."""
    want = getattr(pallas_df64, fn)(jax.ShapeDtypeStruct(shape, np.float32),
                                    axis)
    got = getattr(fp64, fn)(torch.zeros(1, dtype=torch.float64).expand(shape),
                            axis)
    assert got == want
    assert not getattr(fp64, fn)(torch.zeros(1).expand(shape), axis)


def test_entry_points_refuse_float32():
    z = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        fp64.fft_axis_df64(z, z, -1, axis=-1)
    with pytest.raises(ValueError):
        fp64.fft_axis_large_df64(torch.zeros(2, 16384), torch.zeros(2, 16384),
                                 -1, axis=-1)


@pytest.fixture
def small_df64_ceilings(monkeypatch):
    """The complex128 ceilings at 128, so that the six-step route plans at
    2^21 (128^3) and runs at CPU size."""
    monkeypatch.setattr(planner, "MAX_LOCAL_N_DF64", 128)
    monkeypatch.setattr(planner, "HUGE_MAX_F_DF64", 128)


@pytest.mark.parametrize("shape,batch,passes", [
    ((4096,), 3, ["local"]),
    ((16, 128), 2, ["local", "local"]),
    ((16384,), 2, ["fourstep"]),
    ((64, 8), 2, ["local", "plain"]),          # trail 8 < 128
    ((1 << 21,), 1, ["huge"]),
])
def test_plan_routes_match_jax(shape, batch, passes, request):
    """A Plan on each complex128 route against ``pyfft_tpu.Plan(...,
    np.complex128)``: complex form forward, planar form, inverse round
    trip; the result stays complex128."""
    if passes == ["huge"]:
        request.getfixturevalue("small_df64_ceilings")
    x = rand_complex((batch,) + shape, np.complex128, seed=sum(shape))
    plan = Plan(shape, np.complex128, device="cpu")
    assert [p.executor for p in plan._exec_plan.passes] == passes
    axes = tuple(range(-len(shape), 0))
    ref = np.fft.fftn(x, axes=axes)
    jgot = np.asarray(pyfft_tpu.Plan(shape, np.complex128).execute(x))
    y = plan.execute(torch.from_numpy(x))
    assert y.dtype == torch.complex128 and tuple(y.shape) == x.shape
    assert rel_err(y.numpy(), ref) < C128
    assert rel_err(y.numpy(), jgot) < C128
    rr, ii = plan.execute(*planes(x))
    assert rr.dtype == torch.float64
    assert rel_err(to_c(rr, ii), ref) < C128
    back = plan.execute(y, inverse=True)
    assert back.dtype == torch.complex128
    assert rel_err(back.numpy(), x) < C128


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_plan_donate_complex128(form):
    """``donate`` on the four-step route writes complex128 in place."""
    x = rand_complex((2, 16384), np.complex128, seed=14)
    ref = np.fft.fft(x)
    plan = Plan((16384,), np.complex128, device="cpu", donate=True)
    if form == "complex":
        xt = torch.from_numpy(x.copy())
        out = plan.execute(xt)
        assert out.data_ptr() == xt.data_ptr()
        assert out.dtype == torch.complex128
        assert rel_err(xt.numpy(), ref) < C128
    else:
        re, im = planes(x.copy())
        rr, ii = plan.execute(re, im)
        assert rr.data_ptr() == re.data_ptr()
        assert rel_err(to_c(re, im), ref) < C128


@pytest.mark.parametrize("fn,shape,route", [
    ("fft", (3, 4096), ["local"]),
    ("ifft", (2, 16384), ["fourstep"]),
    ("fft2", (2, 16, 128), ["local", "local"]),
    ("fftn", (4, 8, 128), ["local", "local", "plain"]),
])
@pytest.mark.parametrize("real", [False, True])
def test_api_complex128_reaches_kernel_routes(fn, shape, route, real):
    """The functional API on complex128 and on float64 input (a complex128
    plan) takes the kernel routes, against the JAX API and numpy."""
    x = rand_complex(shape, np.complex128, seed=len(shape) + real)
    if real:
        x = np.ascontiguousarray(x.real)
    got = getattr(pyfft_tpu_torch, fn)(torch.from_numpy(x))
    assert got.dtype == torch.complex128
    ndim = len(route)
    plan = pyfft_tpu_torch.get_plan(shape[-ndim:], np.complex128,
                                    device="cpu")
    assert [p.executor for p in plan._exec_plan.passes] == route
    ref = getattr(np.fft, fn)(x)
    assert rel_err(got.numpy(), ref) < C128
    jgot = np.asarray(getattr(pyfft_tpu, fn)(x))
    assert rel_err(got.numpy(), jgot) < C128


def test_empty_like_planes_keeps_complex128():
    """A complex128 tensor's stride-2 planes get complex128 output planes,
    so a complex-form result stays complex."""
    xt = torch.zeros(2, 64, dtype=torch.complex128)
    v = torch.view_as_real(xt)
    r, i = local._empty_like_planes(v[..., 0], v[..., 1], (2, 64))
    assert r.dtype == torch.float64 and r.stride() == (128, 2)
    assert i.data_ptr() == r.data_ptr() + 8
    # planar float64 planes stay planar
    r, i = local._empty_like_planes(torch.zeros(2, 64, dtype=torch.float64),
                                    torch.zeros(2, 64, dtype=torch.float64),
                                    (2, 64))
    assert r.stride() == (64, 1)
