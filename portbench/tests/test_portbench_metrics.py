"""The metric arithmetic on synthetic records."""

import math

import pytest

from portbench import devtrace, registry, work
from portbench.harness import Run


def run(**kw):
    base = dict(setup_s=12.5, window_s=10.0, calls=4000, flop=4000 * 2e9,
                call_s=[], peak_bytes=3 * 2**30, least_s=1e-4, slice=None)
    base.update(kw)
    return Run(**base)


def metric(name, r):
    return registry.metric(name)(r)


@pytest.mark.parametrize("name", ["gflops.c64_3d_256",
                                  "gflops.c128_1d_4m_b64"])
def test_gflops_is_all_the_work_over_all_the_window(name):
    assert metric(name, run()) == pytest.approx(800.0)


def test_call_ms_mean_and_p95():
    r = run(window_s=2.0, calls=8000, call_s=[i * 1e-3 for i in range(1, 101)])
    assert metric("call_ms_mean", r) == pytest.approx(0.25)
    # nearest rank over all 100 calls: the 95th smallest
    assert metric("call_ms_p95.sync", r) == pytest.approx(95.0)
    assert metric("call_ms_p95.sync", run(call_s=[])) is None


def test_peak_and_setup():
    assert metric("peak_mem_gib", run()) == 3.0
    assert metric("setup_s", run()) == 12.5


@pytest.mark.parametrize("name, least_ms, gflop", [
    ("c64_3d_256", 0.0801, 2.013),
    ("c128_1d_4m_b64", 2.564, 29.53),
])
def test_least_time_of_each_config(name, least_ms, gflop):
    cfg = registry.config(name)
    assert work.least_s(cfg) * 1e3 == pytest.approx(least_ms, rel=1e-3)
    assert work.flop(cfg) / 1e9 == pytest.approx(gflop, rel=1e-3)
    # both bytes-bound at the published peaks
    assert work.least_s(cfg) == work.least_bytes(cfg) / work.PEAK_BYTES_S


def sliced():
    """Two calls: [0, 10) and [10, 30) us of host span; device records
    k1 [2, 6), k2 [5, 8) (overlapping), k3 [12, 20), memcpy [25, 26)."""
    us = 1e-6
    sl = devtrace.Slice(
        device=[("k1", 2 * us, 6 * us), ("k2", 5 * us, 8 * us),
                ("k3", 12 * us, 20 * us), ("memcpy", 25 * us, 26 * us)],
        spans=[("step", 0, 30 * us), ("execute.fwd", 0, 10 * us),
               ("execute.inv", 10 * us, 30 * us),
               ("wait.in_flight", 20 * us, 24 * us)])
    return sl


def test_union_and_idle_share():
    sl = sliced()
    assert devtrace.busy_s(sl) == pytest.approx(15e-6)   # 6 + 8 + 1
    assert devtrace.span_s(sl) == pytest.approx(24e-6)   # 2 .. 26
    for name in ("idle_share.c64_3d_256.stream",
                 "idle_share.c128_1d_4m_b64.stream", "idle_share.sync"):
        assert metric(name, run(slice=sl)) == pytest.approx(1 - 15 / 24)


def test_host_ms_per_call_roofline_launches():
    sl = sliced()
    # fwd: 10 - 6 busy = 4 us; inv: 20 - (8 + 1) = 11 us
    assert metric("host_ms_per_call.sync", run(slice=sl)) == pytest.approx(
        7.5e-3)
    # 4 records, 2 calls; device time summed, not unioned: 4 + 3 + 8 + 1
    for cfg in ("c64_3d_256", "c128_1d_4m_b64"):
        assert metric(f"launches_per_call.{cfg}.stream", run(slice=sl)) == 2
        assert metric(f"fft_roofline.{cfg}.stream",
                      run(slice=sl, least_s=4e-6)) == pytest.approx(
            100 * 4e-6 * 2 / 16e-6)


def test_readers_return_nothing_without_a_slice():
    for name in registry.benchmark()["per_layer"]:
        name = name["name"]
        if name == "call_ms_p95.sync":
            continue
        assert metric(name, run()) is None
        assert metric(name, run(slice=devtrace.Slice())) is None


def test_breakdown_names_gaps_by_host_span():
    b = devtrace.breakdown(sliced())
    assert b["device_ops"][0] == ["k3", pytest.approx(8e-6)]
    # gaps: [8, 12) in execute.fwd/inv boundary -> at 8 us: execute.fwd;
    # [20, 25) at 20 us: the wait inside execute.inv
    gaps = {n: s for n, s in b["idle_gaps"]}
    assert gaps["wait.in_flight"] == pytest.approx(5e-6)
    assert gaps["execute.fwd"] == pytest.approx(4e-6)


def test_chrome_events_reduce():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 2.5},
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 1.0, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "execute.fwd",
         "ts": 0.0, "dur": 20},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "execute.fwd",
         "ts": 0.0, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 1,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    sl = devtrace.from_chrome(events)
    assert [r[0] for r in sl.device] == ["set", "k"]
    assert sl.device[1][2] == pytest.approx(12.5e-6)
    assert [s[0] for s in sl.calls] == ["execute.fwd"]
    assert math.isclose(devtrace.span_s(sl), 11.5e-6)


def test_profiler_cost_compares_inside_and_outside_the_slice():
    # 2 calls in the 30-us slice, 16 us of device records; 8 more calls in
    # the 100 us outside it: 12.5 us a call, idle 1 - 8 x 8 / 100 = 0.36
    text = devtrace.profiler_cost(sliced(), 10, 1.00013, 30e-6, 1.0)
    assert "outside it 0.012500 ms a call, idle by the rate 0.3600" in text
    assert "inside the slice 0.015000 ms a call" in text
    assert devtrace.profiler_cost(devtrace.Slice(), 10, 1.0, 0.5).endswith(
        "nothing to read")
