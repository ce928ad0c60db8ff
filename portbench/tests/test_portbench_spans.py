"""The readers of the program's own spans and registry, on synthetic
slices: the facade, the executors and the C entries per call, each a
span less the spans nested in it, and the seconds of the kernel loads."""

import sys
import types

import pytest

from portbench import devtrace, registry
from portbench.harness import Run

US = 1e-6
SPAN_METRICS = ("facade_ms_per_call", "executor_ms_per_call",
                "entry_ms_per_call")


def run(sl):
    return Run(setup_s=1.0, window_s=1.0, calls=2, flop=1.0, call_s=[],
               peak_bytes=0, least_s=1e-4, slice=sl)


def metric(name, sl):
    return registry.metric(name)(run(sl))


def call(t0, passes, wait=None, name="execute.fwd"):
    """One call at ``t0`` us: the benchmark's span, ``pyfft.execute`` 1 us
    inside it, and each pass (executor, start, end, entries as (kernel,
    start, end)), offsets in us from t0; the wait (start, end) last."""
    end = max([p[2] for p in passes] + [wait[1] if wait else 0]) + 1
    spans = [(name, t0 * US, (t0 + end + 1) * US),
             ("pyfft.execute", (t0 + 1) * US, (t0 + end) * US)]
    for ex, a, b, entries in passes:
        spans.append((f"pyfft.pass.{ex}", (t0 + a) * US, (t0 + b) * US))
        spans += [(f"pyfft.entry.{k}", (t0 + c) * US, (t0 + d) * US)
                  for k, c, d in entries]
    if wait:
        spans.append(("pyfft.wait", (t0 + wait[0]) * US,
                      (t0 + wait[1]) * US))
    return spans


def sliced(*calls):
    spans = sorted((s for c in calls for s in c), key=lambda s: s[1])
    return devtrace.Slice(device=[("k", 0.0, 1 * US)], spans=spans)


def test_one_call_split_by_layer():
    """execute [1, 20): passes [3, 8) and [9, 15), their entries 2 and 1
    us, the wait [16, 19): facade 19 - 11 - 3 = 5 us, executors 11 - 3 =
    8, entries 3."""
    sl = sliced(call(0, [("fused2d", 3, 8, [("K8", 5, 7)]),
                         ("local", 9, 15, [("K5", 13, 14)])],
                     wait=(16, 19)))
    assert metric("facade_ms_per_call.sync", sl) == pytest.approx(5e-3)
    assert metric("executor_ms_per_call.sync", sl) == pytest.approx(8e-3)
    assert metric("entry_ms_per_call.sync", sl) == pytest.approx(3e-3)


def test_two_calls_mean_and_the_split_adds_up():
    """Two calls in a slice (forward and inverse): each reading is the sum
    over both, over the two calls; facade + executors + entries + waits
    make up the execute spans."""
    a = call(0, [("fused2d", 3, 8, [("K8", 5, 7)])], wait=(9, 12))
    b = call(40, [("fused2d", 2, 10, [("K8", 4, 9)]),
                  ("local", 11, 13, [("K5", 12, 13)])],
             name="execute.inv")
    sl = sliced(a, b)
    assert len(sl.calls) == 2
    got = {m: metric(f"{m}.c64_3d_256.stream", sl) for m in SPAN_METRICS}
    # execute: [1, 13) and [41, 54); passes 5 + 8 + 2; entries 2 + 5 + 1
    assert got["entry_ms_per_call"] == pytest.approx(8e-3 / 2)
    assert got["executor_ms_per_call"] == pytest.approx((15 - 8) * 1e-3 / 2)
    assert got["facade_ms_per_call"] == pytest.approx(
        (12 + 13 - 15 - 3) * 1e-3 / 2)
    waits = 3e-3 / 2
    assert sum(got.values()) + waits == pytest.approx((12 + 13) * 1e-3 / 2)


def test_chunked_sweep_of_several_passes():
    """A call whose batch runs in chunks: four passes (two executors over
    two chunks) in one execute, each with its entry; the facade is what
    lies between and around them."""
    passes = [("fused2d", 2, 5, [("K8", 3, 4)]),
              ("local", 5, 8, [("K5", 6, 8)]),
              ("fused2d", 9, 12, [("K8", 10, 11)]),
              ("local", 12, 16, [("K5", 13, 15)])]
    sl = sliced(call(0, passes))
    # execute [1, 17): 16 us, passes 13 us, entries 6 us
    assert metric("facade_ms_per_call.sync", sl) == pytest.approx(3e-3)
    assert metric("executor_ms_per_call.sync", sl) == pytest.approx(7e-3)
    assert metric("entry_ms_per_call.sync", sl) == pytest.approx(6e-3)


def test_a_span_outside_the_execute_is_not_subtracted():
    """Only the part of a child inside its parent counts against it."""
    spans = [("execute.fwd", 0, 30 * US),
             ("pyfft.execute", 1 * US, 11 * US),
             ("pyfft.pass.local", 8 * US, 14 * US),
             ("pyfft.entry.K1", 9 * US, 13 * US)]
    sl = devtrace.Slice(device=[], spans=spans)
    assert metric("facade_ms_per_call.sync", sl) == pytest.approx(7e-3)
    assert metric("executor_ms_per_call.sync", sl) == pytest.approx(2e-3)
    assert metric("entry_ms_per_call.sync", sl) == pytest.approx(4e-3)


@pytest.mark.parametrize("name", SPAN_METRICS)
@pytest.mark.parametrize("case", ["no program spans", "no calls", "untraced"])
def test_none_without_program_spans(name, case):
    """A slice with the benchmark's spans only (a program that records
    none), a slice with no calls, and an untraced run read None, never
    0."""
    if case == "untraced":
        sl = None
    elif case == "no program spans":
        sl = devtrace.Slice(device=[("k", 0, 1 * US)],
                            spans=[("step", 0, 9 * US),
                                   ("execute.fwd", 0, 4 * US),
                                   ("execute.inv", 4 * US, 8 * US)])
    else:
        sl = devtrace.Slice(device=[], spans=[
            ("pyfft.execute", 0, 4 * US), ("pyfft.pass.local", 1 * US,
                                           3 * US),
            ("pyfft.entry.K1", 2 * US, 3 * US)])
    assert metric(f"{name}.sync", sl) is None


def test_breakdown_puts_a_gap_down_to_the_innermost_program_span():
    """The harness's breakdown names the program's innermost span in which
    an idle gap began, with no change to its code."""
    spans = call(0, [("local", 3, 8, [("K5", 4, 5)])], wait=(9, 19))
    sl = devtrace.Slice(device=[("k", 4.5 * US, 10 * US),
                                ("k", 18 * US, 19 * US)], spans=sorted(
                                    spans, key=lambda s: s[1]))
    assert devtrace.breakdown(sl)["idle_gaps"] == [
        ["pyfft.wait", pytest.approx(8 * US)]]


@pytest.fixture
def program_registry(monkeypatch):
    """A stand-in for the program's profiling module in ``sys.modules``,
    its registry filled by hand."""
    counts = {}
    module = types.SimpleNamespace(counts=lambda: dict(counts))
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        module)
    return counts


def test_load_s_sums_the_load_seconds(program_registry):
    program_registry.update({"load_s.fused2d": 0.25,
                             "load_s.local_cols": 1.5,
                             "launch.K8.ring": 400, "launch.K5.pring": 400})
    assert metric("load_s", None) == pytest.approx(1.75)


def test_load_s_none_without_loads(program_registry):
    program_registry["launch.K8.ring"] = 3
    assert metric("load_s", None) is None


def test_load_s_none_without_a_registry(monkeypatch):
    """The program's module not loaded, or one with no registry (a program
    that keeps none): None."""
    monkeypatch.delitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        raising=False)
    assert metric("load_s", None) is None
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        types.SimpleNamespace(trace=None))
    assert metric("load_s", None) is None
