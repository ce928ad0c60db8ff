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
    """Last axis through local, a column axis with a trail of 128 or more
    (axis 0 of (8, 16, 32)) through local too, the others through plain;
    the inverse's 1/N lands once, in the final pass."""
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
    """Complex128 on its kernel route (the row kernel's float64 plain
    version on the last axis; axis 0 of (64, 32) has a trail of 32 and
    stays plain) and, with ``force_xla``, all plain, both against the JAX
    Plan in complex128."""
    x = rand_complex((3,) + shape, np.complex128, seed=6)
    jgot = jax_np(pyfft_tpu.Plan(shape, np.complex128).execute(x))
    ref = np.fft.fftn(x, axes=tuple(range(-len(shape), 0)))
    tol = TOL[np.complex128]
    routes = {False: ["local"] + ["plain"] * (len(shape) - 1),
              True: ["plain"] * len(shape)}
    for force_xla, kinds in routes.items():
        plan = Plan(shape, np.complex128, device="cpu", force_xla=force_xla)
        assert [p.executor for p in plan._exec_plan.passes] == kinds
        got = plan.execute(torch.from_numpy(x))
        assert got.dtype == torch.complex128
        got = torch_np(got)
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
    ((16384,), np.complex64, {}, "fourstep"),
    ((16, 64), np.complex64, {}, "local,plain"),
    ((4, 8, 16), np.complex64, {}, "local,plain,plain"),
    ((1024, 1024), np.complex64, {}, "local,local"),
    ((8, 16, 32), np.complex64, {}, "local,plain,local"),
    ((1 << 27,), np.complex64, {}, "huge"),
    ((256, 256), np.complex64, {}, "fused2d"),
    ((256, 256, 256), np.complex64, {}, "fused2d,local"),
    ((256, 256), np.complex128, {}, "local,local"),
    ((4096,), np.complex128, {}, "local"),
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


@pytest.fixture
def static_jax_tables(tmp_path, monkeypatch):
    """Point the JAX package's autotune record at an empty file, so that
    its splits and chains come from its static tables."""
    from pyfft_tpu.ops import pallas_local as jax_local
    path = tmp_path / "tuned.json"
    path.write_text("{}")
    monkeypatch.setenv("PYFFT_TPU_TUNE_FILE", str(path))
    jax_local.reload_tuned()
    yield
    jax_local._TUNED = None


@pytest.mark.parametrize("shape", [(16384,), (1 << 22,), (1 << 27,),
                                   (1024, 1024), (16384, 1024), (256, 256),
                                   (256, 256, 256), (128, 2048),
                                   (8, 128, 128), (1024, 512)])
def test_build_plan_matches_jax_on_tpu(shape, static_jax_tables):
    """Both planners give each axis the same executor (split sizes aside;
    a fused2d pass's split is its plane's shape in both)."""
    from pyfft_tpu import planner as jax_planner
    from pyfft_tpu_torch import planner
    want = jax_planner.build_plan(shape, np.complex64, on_tpu=True)
    got = planner.build_plan(shape, np.complex64)
    assert [(p.axis, p.n, p.executor) for p in got.passes] == \
        [(p.axis, p.n, p.executor) for p in want.passes]
    for p in got.passes:
        if p.executor in ("fourstep", "huge"):
            assert p.split is not None and np.prod(p.split) == p.n
    assert [p.split for p in got.passes if p.executor == "fused2d"] == \
        [p.split for p in want.passes if p.executor == "fused2d"]


@pytest.mark.parametrize("shape,passes", [
    ((16, 64), ["local", "plain"]),                # trail 64 < 128
    ((4, 8, 16), ["local", "plain", "plain"]),     # trail 16; n = 4 < 8
    ((4,), ["plain"]),                             # n < 8
    ((16384, 64), ["local", "plain"]),             # mid trail not 128k
    ((1 << 22, 128), ["local", "plain"]),          # mid twiddle > 16 MiB
])
def test_short_axes_plan_plain(shape, passes):
    """The JAX planner writes ``local`` for such axes and its Plan takes
    XLA at run time; the port plans ``plain`` up front."""
    from pyfft_tpu_torch import planner
    got = planner.build_plan(shape, np.complex64)
    assert [p.executor for p in got.passes] == passes


@pytest.mark.parametrize("shape,batch", [((64, 512), 2), ((16384,), 3),
                                         ((16384, 128), 1)])
@pytest.mark.parametrize("inverse", [False, True])
def test_column_and_fourstep_plans_match_jax(shape, batch, inverse):
    """A 2D plan (row, then column kernel: 64 rows are no fused2d plane)
    and the four-step plans (last axis and mid axis) against the JAX Plan
    on the same data."""
    x = rand_complex((batch,) + shape, seed=sum(shape) + batch)
    plan = Plan(shape, device="cpu")
    assert all(p.executor != "plain" for p in plan._exec_plan.passes)
    got = torch_np(plan.execute(torch.from_numpy(x), inverse=inverse))
    jgot = jax_np(pyfft_tpu.Plan(shape).execute(x, inverse=inverse))
    axes = tuple(range(-len(shape), 0))
    x128 = x.astype(np.complex128)
    ref = (np.fft.ifftn(x128, axes=axes) if inverse
           else np.fft.fftn(x128, axes=axes))
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_fourstep_plan_donate_and_forms(form):
    """The four-step route in both call forms, writing in place."""
    x = rand_complex((2, 16384), seed=12)
    ref = np.fft.fft(x.astype(np.complex128))
    plan = Plan((16384,), device="cpu", donate=True)
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


@pytest.mark.parametrize("shape,batch,passes", [
    ((256, 256), 2, ["fused2d"]),
    ((128, 512), 1, ["fused2d"]),
    ((8, 128, 128), 1, ["fused2d", "local"]),
])
@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused2d_plans_match_jax(shape, batch, passes, fast_math, inverse):
    """The fused 2D route (alone, and before a column pass over the first
    axis of a 3D plan) against the JAX Plan on the same data."""
    x = rand_complex((batch,) + shape, seed=sum(shape) + batch)
    plan = Plan(shape, device="cpu", fast_math=fast_math)
    assert [p.executor for p in plan._exec_plan.passes] == passes
    got = torch_np(plan.execute(torch.from_numpy(x), inverse=inverse))
    jgot = jax_np(pyfft_tpu.Plan(shape, fast_math=fast_math).execute(
        x, inverse=inverse))
    axes = tuple(range(-len(shape), 0))
    x128 = x.astype(np.complex128)
    ref = (np.fft.ifftn(x128, axes=axes) if inverse
           else np.fft.fftn(x128, axes=axes))
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_fused2d_plan_donate_and_forms(form):
    """The fused 2D route in both call forms, writing in place."""
    x = rand_complex((2, 128, 256), seed=14)
    ref = np.fft.fft2(x.astype(np.complex128))
    plan = Plan((128, 256), device="cpu", donate=True)
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


@pytest.fixture
def route_tables(monkeypatch):
    """Set plan.py's interleaved routes for one test."""
    from pyfft_tpu_torch import plan as plan_mod

    def set_routes(one=None, multi=None):
        if one is not None:
            monkeypatch.setattr(plan_mod, "IL1D_ROUTE", one)
        if multi is not None:
            monkeypatch.setattr(plan_mod, "IL_MULTI_ROUTE", multi)
    return set_routes


@pytest.mark.parametrize("route", ["fused", "stream", "planes"])
@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_complex_form_routes_match_jax(route, n, inverse, route_tables):
    """Config 2i's single-pass plan on each interleaved route (the plain
    versions of K2; K13, K1, K14; K1 on stride-2 planes) against the JAX
    Plan on the same data."""
    route_tables(one=route)
    x = rand_complex((BATCH, n), seed=n + inverse)
    plan = Plan((n,), device="cpu")
    assert plan.il_route() == route
    got = torch_np(plan.execute(torch.from_numpy(x), inverse=inverse))
    jgot = jax_np(pyfft_tpu.Plan((n,)).execute(x, inverse=inverse))
    x128 = x.astype(np.complex128)
    ref = np.fft.ifft(x128) if inverse else np.fft.fft(x128)
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("route", ["stream", "planes"])
@pytest.mark.parametrize("shape,batch", [((64, 512), 2), ((16384,), 2),
                                         ((128, 256), 1)])
def test_multi_pass_routes_match_jax(route, shape, batch, route_tables):
    """A 2D plan, a four-step plan and a fused2d plan on the stream and
    planes routes against the JAX Plan."""
    route_tables(multi=route)
    x = rand_complex((batch,) + shape, seed=sum(shape))
    plan = Plan(shape, device="cpu")
    assert plan.il_route() == route
    got = torch_np(plan.execute(torch.from_numpy(x)))
    jgot = jax_np(pyfft_tpu.Plan(shape).execute(x))
    ref = np.fft.fftn(x.astype(np.complex128),
                      axes=tuple(range(-len(shape), 0)))
    assert rel_err(got, ref) < C64
    assert rel_err(got, jgot) < C64


@pytest.mark.parametrize("route", ["fused", "stream"])
def test_routes_donate_and_scale(route, route_tables):
    """In place and with a user scale and no normalization, on the two
    routes that do not run the stride-2 planes."""
    route_tables(one=route)
    x = rand_complex((3, 512), seed=31)
    xt = torch.from_numpy(x.copy())
    plan = Plan((512,), device="cpu", donate=True, scale=0.5,
                normalize=False)
    out = plan.execute(xt, inverse=True)
    assert out.data_ptr() == xt.data_ptr()
    ref = np.fft.ifft(x.astype(np.complex128)) * 512 * 0.5
    assert rel_err(xt.numpy(), ref) < C64


@pytest.mark.parametrize("shape,dtype,kw,one,multi,want", [
    ((4096,), np.complex64, {}, "fused", "planes", "fused"),
    ((4096,), np.complex64, {}, "stream", "planes", "stream"),
    ((64,), np.complex64, {}, "stream", "planes", "planes"),  # 128 lanes
    ((4096,), np.complex128, {}, "fused", "stream", "planes"),
    ((4096,), np.complex64, {"force_xla": True}, "fused", "stream",
     "planes"),
    ((1024, 1024), np.complex64, {}, "fused", "stream", "stream"),
    ((16384,), np.complex64, {}, "fused", "planes", "planes"),
])
def test_il_route_rules(shape, dtype, kw, one, multi, want, route_tables):
    route_tables(one=one, multi=multi)
    assert Plan(shape, dtype, device="cpu", **kw).il_route() == want


def test_il_route_rejects_bad_tables(route_tables):
    route_tables(one="bogus", multi="fused")
    with pytest.raises(ValueError):
        Plan((256,), device="cpu").il_route()
    with pytest.raises(ValueError):
        Plan((256, 256), device="cpu").il_route()


def test_route_tables_hold_the_measured_winners():
    """plan.py's routes: a known route for single-pass plans and no fused
    route for multi-pass plans, so no plan raises on its default route."""
    from pyfft_tpu_torch import plan as plan_mod
    assert plan_mod.IL1D_ROUTE in ("fused", "stream", "planes")
    assert plan_mod.IL_MULTI_ROUTE in ("stream", "planes")
    for shape in ((8,), (4096,), (8192,), (64, 512), (16384,)):
        assert Plan(shape, device="cpu").il_route() in ("fused", "stream",
                                                         "planes")
