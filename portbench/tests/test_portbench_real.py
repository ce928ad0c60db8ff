"""Real-input transforms in the yardstick, on the CPU at small sizes.

The work of a real configuration and the bit-for-bit unchanged work of
the four complex ones; the real reference against ``torch.fft`` in
float64; and a whole run of the harness with a real form that lives
here, ``torch.fft.rfftn``/``irfftn`` in the program's place: it comes out
correct, and the control and every planted fault come out not correct.
A real configuration needs only a configuration, a form and a cell."""

import math
import time

import pytest
import torch

from portbench import (check, harness, reference, registry, system,
                       traffic, work)

CELL = {"check": {"steps": 2, "within": 6}, "trace": {"skip": 2, "steps": 3}}
SEED = 2**31 + 8193
LIMITS = {"fwd_rel_err": 2e-6, "inv_rel_err": 2e-6}
STUBS = {"r1d": {"shape": [256], "batch": 8},
         "r2d": {"shape": [16, 32], "batch": 4}}


def stub(name):
    return dict(STUBS[name], name=name, dtype="float32", form="stub_real",
                reduced=[], limits=LIMITS)


class RealForm:
    """A real-input form (``system.py``'s interface), with
    ``torch.fft.rfftn``/``irfftn`` over the configuration's axes in the
    program's place."""

    @staticmethod
    def make_inputs(config, count, seed, device):
        _, real = system.DTYPES[config["dtype"]]
        buf = torch.randn((count, *system.dims(config)),
                          generator=system.generator(seed, device),
                          dtype=real, device=device)
        return [buf[i] for i in range(count)]

    @staticmethod
    def planes(config, t):
        return (t.real, t.imag) if t.is_complex() else (t,)

    @classmethod
    def rel_err(cls, config, got, src, inverse):
        return check.rdft_rel_err(config, cls.planes(config, got),
                                  cls.planes(config, src), inverse)

    @classmethod
    def reference_call(cls, config, x, inverse, precision):
        out = check.rdft(config, cls.planes(config, x), inverse, precision)
        cplx, real = system.DTYPES[config["dtype"]]
        if inverse:
            return out[0].to(real)
        return torch.complex(out[0].to(real), out[1].to(real)).to(cplx)

    class Port:
        def __init__(self, config, device):
            self.shape = config["shape"]
            self.dim = tuple(range(-len(self.shape), 0))

        def __call__(self, x, inverse, wait):
            if inverse:
                return torch.fft.irfftn(x, s=self.shape, dim=self.dim)
            return torch.fft.rfftn(x, dim=self.dim)

        def describe(self):
            return "torch.fft.rfftn/irfftn in the program's place"


@pytest.fixture(autouse=True)
def stub_form(monkeypatch):
    """``stub_real`` names ``RealForm``, as ``forms/<form>.py`` would."""
    found = registry.form
    monkeypatch.setattr(registry, "form", lambda name: (
        RealForm if name == "stub_real" else found(name)))


def run(cfg, sut=None, seconds=0.0, traced=False, metrics=()):
    return harness.run("small", CELL, cfg, registry.mix("stream"), seed=SEED,
                       seconds=seconds, traced=traced, device="cpu",
                       metrics=list(metrics), started=time.monotonic(),
                       clock=time.monotonic, system=sut, log=lambda s: None)


# the parent's work, to the bit: (FLOP, least bytes, least seconds)
COMPLEX_WORK = {"c64_3d_256": (2013265920, 268435456, 8.012998686567164e-05),
                "c128_1d_4m_b64": (29527900160, 8589934592,
                                   0.0025641595797014924),
                "c64_1d_4096_b4096": (1006632960, 268435456,
                                      8.012998686567164e-05),
                "c64_2d_1024_b16": (1677721600, 268435456,
                                    8.012998686567164e-05)}


@pytest.mark.parametrize("name", sorted(COMPLEX_WORK))
def test_complex_work_is_unchanged(name):
    cfg = registry.config(name)
    got = (work.flop(cfg), work.least_bytes(cfg), work.least_s(cfg))
    assert got == COMPLEX_WORK[name]


@pytest.mark.parametrize("dtype, flop, nbytes, least_s", [
    ("float32", 1090519040, 268468224, 8.014e-05),
    ("float64", 1090519040, 536936448, 1.6028e-04)])
def test_real_work(dtype, flop, nbytes, least_s):
    """rfft of (4096, 8192): 2.5 N log2 N a row; N real points read and
    4096 x 4097 complex ones written; bound by bytes at 3.35 TB/s."""
    cfg = {"shape": [8192], "batch": 4096, "dtype": dtype}
    assert work.flop(cfg) == flop
    assert work.least_bytes(cfg) == nbytes
    assert work.least_s(cfg) == pytest.approx(least_s, rel=1e-4)
    assert work.least_s(cfg) == work.least_bytes(cfg) / work.PEAK_BYTES_S


def test_real_work_over_axes():
    """A 2D real transform cuts only the last axis: 16 x (32/2 + 1)."""
    cfg = {"shape": [16, 32], "batch": 4, "dtype": "float32"}
    assert work.half_points(cfg) == 16 * 17
    assert work.least_bytes(cfg) == 4 * (4 * 512 + 8 * 272)
    assert work.flop(cfg) == 2.5 * 512 * 9 * 4


@pytest.mark.parametrize("shape, ndim", [((3, 64), 1), ((2, 16, 32), 2),
                                         ((4, 8, 16), 3), ((2, 8192), 1),
                                         ((8, 2), 1), ((4, 8, 8), 2)])
def test_real_reference_matches_torch_fft(shape, ndim):
    """The half spectrum and its inverse against ``torch.fft.rfftn`` and
    ``irfftn`` in float64; the inverse takes only the half spectrum's
    Hermitian part (the imaginary parts at k = 0 and n/2 are dropped)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    dim = tuple(range(-ndim, 0))
    want = torch.fft.rfftn(x, dim=dim)
    re, im = reference.rdft(x, ndim)
    got = torch.complex(re, im)
    assert ((got - want).abs().max() / want.abs().max()) < 1e-13
    spec = want + 0.25j
    n = shape[-1]
    inv = torch.fft.irfftn(spec, s=shape[-ndim:], dim=dim)
    back = reference.irdft(spec.real, spec.imag, ndim, n,
                           scale=1 / math.prod(shape[-ndim:]))
    assert back.dtype == torch.float64 and back.shape == x.shape
    assert ((back - inv).abs().max() / inv.abs().max()) < 1e-13


@pytest.mark.parametrize("precision, lo, hi", [("float32", 1e-8, 2e-6),
                                               ("tf32", 5e-5, 5e-3)])
def test_real_reference_in_lower_precisions(precision, lo, hi):
    x = torch.randn((2, 8192), generator=torch.Generator().manual_seed(8),
                    dtype=torch.float64)
    want = torch.fft.rfft(x)
    re, im = reference.rdft(x, 1, precision=precision)
    assert re.dtype == torch.float32 and re.shape == (2, 4097)
    err = (torch.complex(re.double(), im.double()) - want).abs().max()
    assert lo < err / want.abs().max() < hi


def test_real_comparison_takes_only_the_due_form():
    """A forward answer that is no half spectrum, or an inverse given
    none, reads inf; the reference's own answer reads about 0."""
    cfg = stub("r1d")
    x = RealForm.make_inputs(cfg, 1, SEED, "cpu")[0]
    y = RealForm.reference_call(cfg, x, False, "float64")
    z = RealForm.reference_call(cfg, y, True, "float64")
    assert y.shape == (8, 129) and z.shape == (8, 256)
    assert RealForm.rel_err(cfg, y, x, False) < 1e-7
    assert RealForm.rel_err(cfg, z, y, True) < 1e-7
    assert RealForm.rel_err(cfg, x, x, False) == float("inf")
    assert RealForm.rel_err(cfg, y[:, :128], x, False) == float("inf")
    assert RealForm.rel_err(cfg, x, x, True) == float("inf")
    assert RealForm.rel_err(cfg, y, y, True) == float("inf")
    y[3, 5] = float("nan")
    assert RealForm.rel_err(cfg, y, x, False) == float("inf")


def test_kept_buffers_take_the_outputs_form():
    """A buffer of its output's form is kept as it is; one of another
    form is replaced by one like the output."""
    x = torch.zeros(4, 16)
    y = torch.zeros(4, 9, dtype=torch.complex64)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    ybuf, zbuf = traffic.fit(bufs, (y, x))
    assert (ybuf.shape, ybuf.dtype) == (y.shape, y.dtype)
    assert zbuf is bufs[1]
    planes = (torch.zeros(4, 16), torch.zeros(4, 16))
    assert traffic.fit((planes, x), (planes, x))[0] is planes


@pytest.mark.parametrize("name", sorted(STUBS))
@pytest.mark.parametrize("traced", [False, True])
def test_sound_real_run_is_correct(name, traced):
    """Correct in both directions; its rate counts 2.5 N log2 N a row."""
    cfg = stub(name)
    r = run(cfg, seconds=0.05, traced=traced,
            metrics=[("gflops", "GFLOP/s"), ("setup_s", "s")])
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"fwd_rel_err", "inv_rel_err"}
    assert r["attempted"] >= 2 * 2
    assert r["metrics"]["gflops"]["value"] > 0


@pytest.mark.parametrize("name", sorted(STUBS))
def test_real_control_is_not_correct(name):
    cfg = stub(name)
    r = run(cfg, system.Control(cfg, "cpu"))
    assert not r["correct"]
    for k, c in r["checks"].items():
        assert c["value"] > 10 * LIMITS[k], (k, c)


@pytest.mark.parametrize("name", sorted(STUBS))
@pytest.mark.parametrize("fault", system.Faulty.FAULTS)
def test_every_real_fault_is_not_correct(name, fault):
    cfg = stub(name)
    r = run(cfg, system.Faulty(cfg, "cpu", fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_real_control_computes_one_precision_below():
    cfg = stub("r1d")
    x = RealForm.make_inputs(cfg, 1, SEED, "cpu")[0]
    y = system.Control(cfg, "cpu")(x, False, None)
    re, im = reference.rdft(x, 1, precision="tf32")
    assert y.dtype == torch.complex64
    assert torch.equal(y, torch.complex(re, im))
    assert system.CONTROL["float32"] == "tf32"
