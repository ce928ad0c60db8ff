"""The cell ``c64_1d_4096_b4096.stream`` on the CPU at a small size
(4096 rows cut to 8 rows of 512 points): sound runs, traced and
untraced, are correct and report the cell's metrics; the control and
every planted fault are not correct; ``fused_route_share`` reads the
program's ``pyfft.execute`` and ``pyfft.pass.fused`` spans."""

import time

import pytest

from portbench import devtrace, harness, registry, system
from portbench.harness import Run

CELL_NAME = "c64_1d_4096_b4096.stream"
CONFIG = "c64_1d_4096_b4096"
SMALL = {"shape": [512], "batch": 8}
CELL = {"check": {"steps": 2, "within": 6}, "trace": {"skip": 2, "steps": 3}}
SEED = 2**31 + 40961


def small():
    return dict(registry.config(CONFIG), **SMALL)


def run(sut=None, seconds=0.0, traced=False, metrics=()):
    mix = registry.resolve(CELL_NAME)[2]
    return harness.run("small", CELL, small(), mix, seed=SEED,
                       seconds=seconds, traced=traced, device="cpu",
                       metrics=list(metrics), started=time.monotonic(),
                       clock=time.monotonic, system=sut, log=lambda s: None)


def test_the_cell_runs_the_published_size():
    """One chip, the ``stream`` mix with 4 inputs and 4 steps in flight,
    at the published size, on the complex form's "fused" route."""
    cell, cfg, mix = registry.resolve(CELL_NAME)
    assert cell["config"] == CONFIG and cell["traffic"] == "stream"
    assert mix["inputs"] == 4 and mix["in_flight_steps"] == 4
    assert mix["wait"] == "none" and mix["generator"] == "roundtrip"
    assert (cfg["shape"], cfg["batch"], cfg["dtype"], cfg["form"]) == (
        [4096], 4096, "complex64", "complex")
    assert cfg["reduced"] == []
    (w,) = [w for w in registry.benchmark()["workloads"]
            if w["name"] == CELL_NAME]
    assert w["chips"] == 1
    port = system.port(small(), "cpu")
    assert port.plan.il_route() == "fused"


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    """Correct, with the cell's end-to-end metrics untraced (its rate is
    ``gflops.c64_3d_256``, whose ``workloads`` list the cell); traced, the
    per-layer metrics a CPU run can read (the program's spans: the device
    records and the kernel loads are the card's), ``fused_route_share``
    1.0 since every call took the "fused" route."""
    metrics = registry.metrics_for(CELL_NAME, traced)
    r = run(seconds=0.05, traced=traced, metrics=metrics)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 2 * 2
    got = set(r["metrics"])
    if traced:
        assert {f"executor_ms_per_call.{CELL_NAME}",
                f"facade_ms_per_call.{CELL_NAME}",
                f"fused_route_share.{CELL_NAME}"} <= got
        assert r["metrics"][f"fused_route_share.{CELL_NAME}"][
            "value"] == 1.0
        assert {n for n, _ in metrics} == {
            f"{m}.{CELL_NAME}" for m in (
                "fft_roofline", "launches_per_call", "record_hit_share",
                "executor_ms_per_call", "fused_route_share", "load_s",
                "facade_ms_per_call", "entry_ms_per_call")}
    else:
        assert got == {"gflops.c64_3d_256", "peak_mem_gib", "setup_s"}


def test_control_is_not_correct():
    cfg = small()
    r = run(system.Control(cfg, "cpu"))
    assert not r["correct"]
    for k, c in r["checks"].items():
        assert c["value"] > 10 * cfg["limits"][k], (k, c)


@pytest.mark.parametrize("fault", system.Faulty.FAULTS)
def test_every_fault_is_not_correct(fault):
    r = run(system.Faulty(small(), "cpu", fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


US = 1e-6


def share(sl):
    """``fused_route_share`` of a run whose traced slice is ``sl``."""
    rec = Run(setup_s=1.0, window_s=1.0, calls=2, flop=1.0, call_s=[],
              peak_bytes=0, least_s=1e-4, slice=sl)
    return registry.metric(f"fused_route_share.{CELL_NAME}")(rec)


def calls(*routes, execute=True):
    """A traced slice of one call a route: ``execute.fwd`` holding
    ``pyfft.execute`` (unless not ``execute``) and the route's passes."""
    spans = []
    for i, route in enumerate(routes):
        t = 10 * i * US
        spans.append(("execute.fwd", t, t + 9 * US))
        if execute:
            spans.append(("pyfft.execute", t + US, t + 8 * US))
        spans += [(f"pyfft.pass.{p}", t + 2 * US, t + 3 * US)
                  for p in route]
    return devtrace.Slice(spans=spans)


def test_fused_route_share_of_the_spans():
    """The calls whose ``pyfft.execute`` holds a ``pyfft.pass.fused``, over
    every call; another call's passes do not count."""
    assert share(calls(["fused"], ["fused"])) == 1.0
    assert share(calls(["fused"], ["fused2d", "local"], ["fused"],
                       ["local"])) == 0.5


def test_fused_route_share_none_without_the_span():
    """No ``pyfft.pass.fused`` (a program that names the route's pass
    ``pyfft.pass.local``), no ``pyfft.execute``, or no traced slice with
    calls (an untraced run): None."""
    assert share(calls(["local"], ["local"])) is None
    assert share(calls(["fused"], execute=False)) is None
    assert share(calls()) is None and share(None) is None
