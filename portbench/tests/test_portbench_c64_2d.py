"""The cell ``c64_2d_1024_b16.stream`` on the CPU at a small size (16
planes of 1024 x 1024 cut to 4 planes of 64 x 128, which the planner
also gives two ``local`` passes): sound runs, traced and untraced, are
correct and report the cell's metrics; the control and every planted
fault are not correct; ``k5_roofline`` reads the ``local_cols`` device
records."""

import time

import pytest

from portbench import devtrace, harness, registry, system, work
from portbench.harness import Run

CELL_NAME = "c64_2d_1024_b16.stream"
CONFIG = "c64_2d_1024_b16"
SMALL = {"shape": [64, 128], "batch": 4}
CELL = {"check": {"steps": 2, "within": 6}, "trace": {"skip": 2, "steps": 3}}
SEED = 2**31 + 10241
METRICS = ("fft_roofline", "launches_per_call", "record_hit_share",
           "executor_ms_per_call", "facade_ms_per_call", "entry_ms_per_call",
           "k5_roofline", "k5_xring_share")


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
    at the published size, on the complex form's "planes" route of two
    ``local`` passes; the small size takes the same route."""
    cell, cfg, mix = registry.resolve(CELL_NAME)
    assert cell["config"] == CONFIG and cell["traffic"] == "stream"
    assert mix["inputs"] == 4 and mix["in_flight_steps"] == 4
    assert mix["wait"] == "none" and mix["generator"] == "roundtrip"
    assert (cfg["shape"], cfg["batch"], cfg["dtype"], cfg["form"]) == (
        [1024, 1024], 16, "complex64", "complex")
    assert cfg["reduced"] == []
    assert cfg["limits"] == {"fwd_rel_err": 2e-6, "inv_rel_err": 2e-6}
    (w,) = [w for w in registry.benchmark()["workloads"]
            if w["name"] == CELL_NAME]
    assert w["chips"] == 1
    for c in (cfg, small()):
        port = system.port(c, "cpu")
        assert port.plan.il_route() == "planes"
        assert [p.executor for p in port.plan._exec_plan.passes] == [
            "local", "local"]
    assert work.least_s(cfg) * 1e3 == pytest.approx(0.0801, rel=1e-3)
    assert work.flop(cfg) / 1e9 == pytest.approx(1.678, rel=1e-3)


def test_the_cell_reports_its_metrics():
    """Its rate is ``gflops.c64_3d_256``, whose ``workloads`` list it; its
    per-layer metrics are the eight this cell declares, each moving that
    rate."""
    assert {n for n, _ in registry.metrics_for(CELL_NAME, False)} == {
        "gflops.c64_3d_256", "peak_mem_gib", "setup_s"}
    assert {n for n, _ in registry.metrics_for(CELL_NAME, True)} == {
        f"{m}.{CELL_NAME}" for m in METRICS}


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    """Correct, with the cell's end-to-end metrics untraced; traced, the
    per-layer metrics a CPU run can read (the program's spans: the device
    records, the C entries and the launch counts are the card's)."""
    metrics = registry.metrics_for(CELL_NAME, traced)
    r = run(seconds=0.05, traced=traced, metrics=metrics)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 2 * 2
    got = set(r["metrics"])
    if traced:
        assert {f"executor_ms_per_call.{CELL_NAME}",
                f"facade_ms_per_call.{CELL_NAME}"} <= got
        assert f"k5_roofline.{CELL_NAME}" not in got
        assert f"fft_roofline.{CELL_NAME}" not in got
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


def record(sl=None, least_s=1e-4):
    return Run(setup_s=1.0, window_s=1.0, calls=2, flop=1.0, call_s=[],
               peak_bytes=0, least_s=least_s, slice=sl)


US = 1e-6
K1 = "void (anonymous namespace)::local_rows_ring_kernel<float, 10, 1, 3>"
K5 = "void (anonymous namespace)::local_cols_x_kernel<float, 10, 4, 16, 2>"


def traced(device, calls=2):
    """A slice of ``calls`` calls, 100 us apart, with ``device``'s
    records."""
    spans = [("execute.fwd" if i % 2 == 0 else "execute.inv", 100 * i * US,
              100 * (i + 1) * US) for i in range(calls)]
    return devtrace.Slice(device=device, spans=spans)


def k5_roofline(sl, least_s=1e-4):
    return registry.metric(f"k5_roofline.{CELL_NAME}")(record(sl, least_s))


def test_k5_roofline_reads_only_the_column_kernel():
    """The least time of two calls over the ``local_cols`` records alone:
    K1's records and a copy do not count."""
    sl = traced([(K1, 0, 150 * US), (K5, 150 * US, 250 * US),
                 (K5, 300 * US, 400 * US), ("Memcpy DtoD", 0, 500 * US)])
    assert k5_roofline(sl) == pytest.approx(100.0)
    assert k5_roofline(sl, 0.5e-4) == pytest.approx(50.0)
    assert devtrace.roofline_pct(sl, 1e-4) == pytest.approx(
        100.0 * 2e-4 / 850e-6)


def test_k5_roofline_none_without_its_records():
    """No slice, no call, no ``local_cols`` record or only empty ones:
    None, never 0."""
    assert k5_roofline(None) is None
    assert k5_roofline(traced([(K5, 0, US)], calls=0)) is None
    assert k5_roofline(traced([(K1, 0, 150 * US)])) is None
    assert k5_roofline(traced([(K5, 5 * US, 5 * US)])) is None
    assert k5_roofline(traced([])) is None


@pytest.mark.parametrize("config", ["c64_2d_1024_b16", "c64_3d_256",
                                    "c64_1d_4096_b4096", "c128_1d_4m_b64"])
def test_k5_roofline_pass_least_time(config):
    """The column pass's least time (its FLOP over one axis, the call's
    least bytes) equals the call's, which the reader takes: 0.0801 ms at
    the cell's configuration, bound by bytes."""
    k5 = registry._module("metrics", "k5_roofline", None)
    cfg = registry.config(config)
    axis = -2 if len(cfg["shape"]) > 1 else -1
    assert k5.pass_flop(cfg, axis) <= work.flop(cfg)
    assert k5.pass_least_s(cfg, axis) == work.least_s(cfg)
    if config == CONFIG:
        assert k5.pass_flop(cfg) == 5 * 2**20 * 16 * 10
        assert k5.pass_least_s(cfg) * 1e3 == pytest.approx(0.0801,
                                                           rel=1e-3)
