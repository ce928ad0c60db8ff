"""``pyfft_tpu_torch.utils.profiling`` on the CPU: ``trace`` (over
``torch.profiler``) writes a trace file that holds a CPU ``Plan.execute``
(its plain versions' torch ops; the card's kernel records are checked by
``chip_smoke.py`` phase 25), and ``effective_gflops`` equals the JAX
package's for a shape or an int.  The timers need a card and raise here.

The program's spans and counts: with no profiler running ``span`` is the
bare call and never reaches ``record_function`` nor forms a name; under
``torch.profiler`` ``pyfft.execute`` holds its ``pyfft.pass.*`` spans as ``user_annotation``
events, and, with the C entries replaced and the planes saying they lie on
the card, each ``pyfft.entry.<kernel>`` lies inside its pass while the
registry counts ``launch.<kernel>.<design>`` from what the entry returned;
``build.load`` times its loads and builds (``nvcc`` stubbed).
"""

import contextlib
import json
import time
import types

import numpy as np
import pytest
import torch

from pyfft_tpu.utils import profiling as jax_profiling
import pyfft_tpu_torch
from pyfft_tpu_torch import plan as plan_mod
from pyfft_tpu_torch.ops import build, fused2d, interleave, local
from pyfft_tpu_torch.utils import profiling

from helpers import rand_complex

torch.set_num_threads(2)


def trace_events(logdir):
    files = sorted(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


@pytest.mark.parametrize("shape", [(4096,), (16384,), (64, 128)])
def test_trace_holds_a_cpu_execute(tmp_path, shape):
    """The trace file of one execute exists in a directory ``trace``
    creates, opens as JSON, and holds the execute's torch ops."""
    x = torch.from_numpy(rand_complex((4,) + shape, seed=1))
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    logdir = tmp_path / "new" / "logs"
    with profiling.trace(str(logdir)) as prof:
        y = plan.execute(x)
    assert prof is not None
    ops = {e.get("name") for e in trace_events(logdir)
           if e.get("cat") == "cpu_op"}
    assert any(op.startswith("aten::") for op in ops), ops
    # the plain versions' products
    assert ops & {"aten::mm", "aten::bmm", "aten::matmul", "aten::einsum"}
    ref = np.fft.fftn(x.numpy().astype(np.complex128),
                      axes=tuple(range(-len(shape), 0)))
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 2e-6


def test_trace_writes_on_error(tmp_path):
    """The trace is written when the block raises, as JAX's stop_trace
    runs in a finally."""
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path)):
            pyfft_tpu_torch.Plan((6,), device="cpu")
    assert trace_events(tmp_path)


@pytest.mark.parametrize("shape,batch,seconds", [
    ((1024,), 1, 1e-3), ((4096,), 4096, 1.075e-4), ((1024, 1024), 16, 3e-4),
    ((256, 256, 256), 1, 2.8e-4), ((1 << 22,), 64, 7.9e-3)])
def test_effective_gflops_matches_jax(shape, batch, seconds):
    want = jax_profiling.effective_gflops(shape, batch, seconds)
    assert profiling.effective_gflops(shape, batch, seconds) == want
    assert profiling.effective_gflops(list(shape), batch, seconds) == want
    if len(shape) == 1:
        assert profiling.effective_gflops(shape[0], batch, seconds) == want


@pytest.mark.parametrize("fn", [
    lambda: profiling.time_ms(lambda: None),
    lambda: profiling.time_queued_ms(lambda: None),
    lambda: profiling.copy_bandwidth_gbs(1)])
def test_timers_need_a_card(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fn()


# ------------------------------------------------------- spans and counts


def span_events(tmp_path, fn):
    """The ``pyfft.*`` spans of ``fn()`` under ``torch.profiler``, read
    from its Chrome trace as the benchmark reads them: (name, start,
    end) of each ``user_annotation`` event, in order of start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("pyfft.")),
                  key=lambda s: s[1])


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_one_shared_no_op(monkeypatch):
    """With no profiler running a span calls its function with its
    arguments and returns what it returned, and enters nothing."""

    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", boom)
    got = profiling.span("pyfft.execute", lambda a, *, b: (a, b), 1, b=2)
    assert got == (1, 2)


def test_span_on_is_a_user_annotation(tmp_path):
    """Under ``torch.profiler`` a span is a ``user_annotation`` of its
    name around the call, which still returns its value."""
    got = []
    spans = span_events(tmp_path, lambda: got.append(
        profiling.span("pyfft.wait", lambda x: x + 1, 41)))
    assert got == [42] and [s[0] for s in spans] == ["pyfft.wait"]


@pytest.mark.parametrize("shape", [(64, 128), (16, 128, 128), (2048,)])
def test_no_record_function_without_a_profiler(monkeypatch, shape):
    """A CPU ``Plan.execute`` with no profiler running never calls
    ``record_function``: every span site is one flag check."""

    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    x = torch.from_numpy(rand_complex((2,) + shape, seed=3))
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    y = plan.execute(plan.execute(x), inverse=True)
    assert torch.allclose(y, x, atol=1e-5)
    re, im = plan.execute(x.real.contiguous(), x.imag.contiguous())
    assert re.shape == x.shape


@pytest.mark.parametrize("shape,passes", [
    ((128, 128), ["fused2d"]), ((64, 128), ["local", "local"]),
    ((16, 128, 128), ["fused2d", "local"]),
    ((64, 64, 64), ["local", "plain", "local"]), ((4096,), ["fused"])])
def test_execute_spans_nest(tmp_path, shape, passes):
    """Under ``torch.profiler`` a CPU ``Plan.execute`` of a 2D and a 3D
    plan yields ``pyfft.execute`` with one ``pyfft.pass.<executor>`` a
    pass nested inside, in order; the "fused" route of a 1D one, its K2
    call as ``pyfft.pass.fused``."""
    x = torch.from_numpy(rand_complex((2,) + shape, seed=4))
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    spans = span_events(tmp_path, lambda: plan.execute(x))
    (execute,) = [s for s in spans if s[0] == "pyfft.execute"]
    got = [s for s in spans if s[0].startswith("pyfft.pass.")]
    assert [s[0] for s in got] == [f"pyfft.pass.{p}" for p in passes]
    assert all(inside(s, execute) for s in got)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    assert {s[0] for s in spans} == {"pyfft.execute"} | {s[0] for s in got}


def test_fused_and_planar_passes_of_one_plan(tmp_path):
    """One 1D plan: the complex form's "fused" route runs its K2 call as
    ``pyfft.pass.fused``, the split form its row pass as
    ``pyfft.pass.local``."""
    x = torch.from_numpy(rand_complex((4, 512), seed=9))
    plan = pyfft_tpu_torch.Plan((512,), device="cpu")
    re, im = x.real.contiguous(), x.imag.contiguous()
    for fn, name in ((lambda: plan.execute(x), "pyfft.pass.fused"),
                     (lambda: plan.execute(re, im), "pyfft.pass.local")):
        spans = span_events(tmp_path, fn)
        assert [s[0] for s in spans] == ["pyfft.execute", name]
        assert inside(spans[1], spans[0])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, to walk the kernel path
    of ``Plan.execute`` up to the (replaced) C entries."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def entries(monkeypatch):
    """Every C entry a plan reaches replaced by one returning the design
    its kernel reports (``returns``, by kernel; 0 by default), the device
    checks, tables and stream lookups stubbed, the registry emptied."""
    returns = {}

    def entry(kernel):
        return lambda *args: returns.get(kernel, 0)

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fused2d, "_lib", lambda: (
        entry("K8"), entry("K8+K10"), lambda ly, lx: 16))
    monkeypatch.setattr(fused2d, "_check_devices", lambda *a: None)
    monkeypatch.setattr(local, "_cols_lib", lambda d: (
        entry("K12" if d == torch.float64 else "K5"), lambda log2n: 32))
    monkeypatch.setattr(local, "_rows_fn", lambda d: entry(
        "K11" if d == torch.float64 else "K1"))
    monkeypatch.setattr(local, "_rows_il_fn", lambda: entry("K2"))
    monkeypatch.setattr(local, "_col_xtile", lambda *a: None)
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(local, "_kernel_twiddles",
                        lambda *a: torch.zeros(2))
    monkeypatch.setattr(interleave, "_fn", lambda name: entry(name))
    profiling.reset()
    yield returns
    profiling.reset()


@pytest.mark.parametrize("shape,dtype,route,returns,want", [
    ((16, 128, 128), torch.complex64, "planes",
     {"K8": local.RAN_RING, "K5": local.RAN_RING},
     [("fused2d", "K8", "launch.K8.ring"),
      ("local", "K5", "launch.K5.pring")]),
    ((16, 128, 128), torch.complex64, "planes", {"K5": local.RAN_X},
     [("fused2d", "K8", "launch.K8.first"), ("local", "K5", "launch.K5.x")]),
    ((64, 128), torch.complex128, "planes",
     {"K11": local.RAN_RING, "K12": local.RAN_X},
     [("local", "K11", "launch.K11.ring"), ("local", "K12", "launch.K12.x")]),
    ((64, 128), torch.complex128, "planes", {},
     [("local", "K11", "launch.K11.first"),
      ("local", "K12", "launch.K12.first")]),
    ((4096,), torch.complex64, "fused", {"K2": local.RAN_RING},
     [("fused", "K2", "launch.K2.ring")]),
    ((16, 128, 128), torch.complex64, "stream", {},
     [("deinterleave", "K13", "launch.K13"),
      ("fused2d", "K8", "launch.K8.first"),
      ("local", "K5", "launch.K5.first"),
      ("interleave", "K14", "launch.K14")])])
def test_entry_spans_nest_and_launches_count(tmp_path, monkeypatch, entries,
                                             shape, dtype, route, returns,
                                             want):
    """With the C entries replaced, each ``pyfft.entry.<kernel>`` lies in
    its ``pyfft.pass.<executor>`` inside ``pyfft.execute``, and the
    registry counts ``launch.<kernel>.<design>`` from what the entry
    returned: K8's ring, K5's persistent ring and cluster tile, K11's and
    K2's ring, K12's cluster tile (RAN_X), else the first design; K13 and
    K14 report none.  The call is the plan's first: ``record.miss``."""
    entries.update(returns)
    entries.update(pyfft_deinterleave=0, pyfft_interleave=0)
    monkeypatch.setattr(plan_mod, "IL_MULTI_ROUTE",
                        "stream" if route == "stream" else "planes")
    # K13's planes are new tensors: keep them on the "card" too
    deint = interleave.deinterleave
    monkeypatch.setattr(interleave, "deinterleave", lambda v: tuple(
        t.as_subclass(_OnCard) for t in deint(v)))
    plan = pyfft_tpu_torch.Plan(shape, dtype, device="cpu")
    assert plan.il_route() == route
    x = torch.zeros((2,) + shape, dtype=dtype).as_subclass(_OnCard)
    spans = span_events(tmp_path, lambda: plan.execute(x))
    (execute,) = [s for s in spans if s[0] == "pyfft.execute"]
    passes = [s for s in spans if s[0].startswith("pyfft.pass.")]
    got = [s for s in spans if s[0].startswith("pyfft.entry.")]
    assert [s[0] for s in passes] == [f"pyfft.pass.{p}" for p, _, _ in want]
    assert [s[0] for s in got] == [f"pyfft.entry.{k}" for _, k, _ in want]
    for p, e in zip(passes, got):
        assert inside(e, p) and inside(p, execute)
    keys = [key for _, _, key in want]
    # the plan's first call with this layout: a miss of its call record
    assert profiling.counts() == {"record.miss": 1,
                                  **{k: keys.count(k) for k in keys}}


@pytest.mark.parametrize("err,key", [(0, "launch.K12.first"),
                                     (local.RAN_X, "launch.K12.x")])
def test_k12_reports_its_cluster_tile(entries, err, key):
    """K12's C entry returns RAN_X where the cluster tile ran, as the
    complex64 entry does; the wrapper counts it under ``launch.K12.x``."""
    entries["K12"] = err
    z = torch.zeros(3, 1024, 64, dtype=torch.float64)
    local._launch_cols(z, z, z.clone(), z.clone(), -1, axis=1,
                       postscale=1.0, tw_n=0, tw_mode="full", tw_period=0,
                       swap_store=False, swap_mid=0)
    assert profiling.counts() == {key: 1}
    assert profiling.total("launch.K12") == 1


def test_registry_reads_and_resets():
    """``counts`` is a copy; ``total`` sums a key and the keys that extend
    it by a dot, not another kernel's; ``reset`` empties it."""
    profiling.reset()
    profiling.COUNTS["launch.K8.ring"] += 2
    profiling.COUNTS["launch.K8.first"] += 1
    profiling.COUNTS["launch.K8+K10"] += 5
    profiling.COUNTS["load_s.fused2d"] += 0.25
    got = profiling.counts()
    got["launch.K8.ring"] = 9
    assert profiling.counts()["launch.K8.ring"] == 2
    assert profiling.total("launch.K8") == 3
    assert profiling.total("launch.K8+K10") == 5
    assert profiling.total("launch.K8.ring") == 2
    assert profiling.total("launch.K5") == 0
    assert profiling.total("load_s") == 0.25
    profiling.reset()
    assert profiling.counts() == {}


def test_load_counts_and_times_a_build(tmp_path, monkeypatch):
    """``build.load`` adds its seconds to ``load_s.<name>`` for every
    library it loads, ``nvcc``'s build included; a library already loaded
    adds nothing; one already built loads without a build."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// a kernel\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_LOADED", {})
    builds = []

    def run(cmd, **kw):
        builds.append(cmd)
        time.sleep(0.01)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return types.SimpleNamespace(returncode=0, stderr="")

    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    profiling.reset()
    lib = build.load("a")
    c = profiling.counts()
    assert len(builds) == 1 and lib[1] == str(build.library_path("a"))
    assert list(c) == ["load_s.a"] and c["load_s.a"] >= 0.01
    assert build.load("a") is lib and profiling.counts() == c
    monkeypatch.setattr(build, "_LOADED", {})
    build.load("a")
    c2 = profiling.counts()
    assert len(builds) == 1 and list(c2) == ["load_s.a"]
    assert c["load_s.a"] < c2["load_s.a"] < 2 * c["load_s.a"]
    profiling.reset()
