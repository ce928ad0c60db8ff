"""A whole run of the harness on the CPU at small sizes, the card's look
skipped: sound runs come out correct, and the control and every fault a
cell can have come out not correct."""

import time

import pytest
import torch

from portbench import harness, registry, system
from portbench.reference import dft

SMALL = {"c64_3d_256": {"shape": [16, 16, 16]},
         "c128_1d_4m_b64": {"shape": [8192], "batch": 4}}
CELL = {"check": {"steps": 2, "within": 6}, "trace": {"skip": 2, "steps": 3}}
SEED = 2**31 + 12345


def small(name):
    return dict(registry.config(name), **SMALL[name])


def run(cfg, mix, sut=None, seconds=0.0, traced=False, metrics=()):
    return harness.run("small", CELL, cfg, registry.mix(mix), seed=SEED,
                       seconds=seconds, traced=traced, device="cpu",
                       metrics=list(metrics), started=time.monotonic(),
                       clock=time.monotonic, system=sut, log=lambda s: None)


@pytest.mark.parametrize("name, mix", [("c64_3d_256", "stream"),
                                       ("c64_3d_256", "sync"),
                                       ("c128_1d_4m_b64", "stream")])
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(name, mix, traced):
    cell = f"{name}.{mix}"
    metrics = registry.metrics_for(cell, traced)
    r = run(small(name), mix, seconds=0.05, traced=traced, metrics=metrics)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 2 * 2
    if not traced:
        assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    cfg = small(name)
    r = run(cfg, "stream", system.Control(cfg, "cpu"))
    assert not r["correct"]
    lim = cfg["limits"]
    for k, c in r["checks"].items():
        assert c["value"] > 10 * lim[k], (k, c)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", system.Faulty.FAULTS)
def test_every_fault_is_not_correct(name, fault):
    cfg = small(name)
    r = run(cfg, "stream", system.Faulty(cfg, "cpu", fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_nan_output_is_not_correct():
    cfg = small("c64_3d_256")

    class NaN(registry.form(cfg["form"]).Port):
        def __call__(self, x, inverse, wait):
            y = super().__call__(x, inverse, wait)
            y[0, 0, 0] = float("nan")
            return y

    assert not run(cfg, "sync", NaN(cfg, "cpu"))["correct"]


def test_kept_steps_come_from_the_seed():
    from portbench import check
    a = check.sample(SEED, 2, 64)
    assert a == check.sample(SEED, 2, 64) and len(set(a)) == 2
    assert any(check.sample(SEED + k, 2, 64) != a for k in range(1, 5))


def test_inputs_come_from_the_seed():
    cfg = small("c128_1d_4m_b64")
    make = registry.form(cfg["form"]).make_inputs
    a = make(cfg, 2, SEED, "cpu")
    b = make(cfg, 2, SEED, "cpu")
    c = make(cfg, 2, SEED + 1, "cpu")
    assert torch.equal(a[1][0], b[1][0]) and not torch.equal(a[1][0], c[1][0])
    assert a[0][0].shape == (4, 8192) and a[0][0].dtype == torch.float64


def test_control_computes_one_precision_below():
    """The control's answers are the reference's in TF32 (complex64,
    float32) or float32 (complex128, float64), returned in the
    configuration's form."""
    cfg = small("c64_3d_256")
    x = registry.form(cfg["form"]).make_inputs(cfg, 1, SEED, "cpu")[0]
    y = system.Control(cfg, "cpu")(x, False, None)
    re, im = dft(x.real, x.imag, 3, inverse=False, precision="tf32")
    assert y.dtype == torch.complex64
    assert torch.equal(y, torch.complex(re, im))
    assert system.CONTROL == {"complex64": "tf32", "complex128": "float32",
                              "float32": "tf32", "float64": "float32"}


def test_every_kept_call_is_judged():
    """The check judges each kept call by its direction, the largest over
    the calls; a direction no call was kept for is not reported, and no
    kept call at all is not correct."""
    from portbench import check
    cfg = small("c64_3d_256")
    form = registry.form(cfg["form"])
    x = form.make_inputs(cfg, 1, SEED, "cpu")[0]
    y = form.reference_call(cfg, x, False, "float64")
    bad = y.clone()
    bad[1, 2, 3] += 1.0
    r = check.judge(form, cfg, {3: [(x, False, y)], 5: [(x, False, bad)]})
    assert list(r) == ["fwd_rel_err"]
    assert r["fwd_rel_err"]["value"] > cfg["limits"]["fwd_rel_err"]
    assert check.judge(form, cfg, {3: [(x, False, y)]})["fwd_rel_err"][
        "value"] < 1e-6
    assert check.passed(check.judge(form, cfg, {})) == []
