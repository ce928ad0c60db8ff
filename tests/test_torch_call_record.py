"""``Plan``'s call record (``plan.py``, ``ops/launch.py``) on the CPU.

The C entries are replaced by recorders and the tensors say they lie on
the card (``_OnCard``), so that ``Plan.execute`` walks the kernel path to
the entries.  A call whose key the plan has recorded replays the launches:
the same entries get the same arguments as the generic path would give
them on the same buffers (data pointers compared as offsets into the
call's input and output), under the same spans, with the same counts and
errors.  The key misses on another layout, alignment, ``donate``,
direction or route; a chain that writes a temporary, or a batch the chunk
sweep splits, stays on the generic path.
"""

import contextlib
import ctypes
import gc
import json
import types
import weakref

import pytest
import torch

import pyfft_tpu_torch
from pyfft_tpu_torch import plan as plan_mod
from pyfft_tpu_torch.ops import fused2d, interleave, local
from pyfft_tpu_torch.utils import profiling, tune

from test_torch_profiling import _OnCard, inside, span_events

C64 = torch.complex64


@pytest.fixture
def entries(monkeypatch):
    """Every C entry a plan reaches replaced by a recorder that returns
    ``returns[kernel]`` (0 by default) and appends (kernel, args) to
    ``calls``; device checks and stream lookups stubbed; tables the same
    tensor for the same arguments, as the caches keep them; the registry
    emptied."""
    calls, returns, tables = [], {}, {}

    def entry(kernel):
        def fn(*args):
            calls.append((kernel, args))
            return returns.get(kernel, 0)
        return fn

    def twiddles(*key):
        return tables.setdefault(key, torch.zeros(2))

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
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
    monkeypatch.setattr(local, "_kernel_twiddles", twiddles)
    monkeypatch.setattr(interleave, "_fn", lambda name: entry(name))
    profiling.reset()
    yield types.SimpleNamespace(calls=calls, returns=returns)
    profiling.reset()


def on_card(t):
    return t.as_subclass(_OnCard)


def cplx(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return on_card(torch.randn(shape, dtype=C64, generator=g))


def planes(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(on_card(torch.randn(shape, generator=g)) for _ in range(2))


def normal(calls, tensors):
    """Each (kernel, args) with ctypes arrays as lists and each address
    inside one of ``tensors`` as (its index, the byte offset)."""
    spans = [(t.data_ptr(), t.numel() * t.element_size()) for t in tensors]

    def arg(a):
        if isinstance(a, ctypes.Array):
            return list(a)
        for k, (s, n) in enumerate(spans):
            if isinstance(a, int) and s <= a < s + n:
                return ("operand", k, a - s)
        return a
    return [(k, tuple(arg(a) for a in args)) for k, args in calls]


def execute(plan, data, entries, **kw):
    """``plan.execute`` of ``data`` (a tensor or a planar pair): (its
    entry calls normalised to the call's operands, its result)."""
    del entries.calls[:]
    args = data if isinstance(data, tuple) else (data,)
    out = plan.execute(*args, **kw)
    got = out if isinstance(out, tuple) else (out,)
    return normal(entries.calls, args + got), out


def counts(prefix):
    return {k: v for k, v in profiling.counts().items()
            if k.startswith(prefix)}


# (shape, inputs, kernels): config 4's "planes" route at a small
# size (K8 then K5), a planar 2D fused2d chain (K8), a planar 1D row pass
# (K1) and the "fused" route (K2).
CHAINS = {
    "planes": ((8, 128, 128), lambda s: cplx((2,) + s, s[0]), ["K8", "K5"]),
    "planar2d": ((128, 128), lambda s: planes((3,) + s, 1), ["K8"]),
    "rows": ((256,), lambda s: planes((4,) + s, 2), ["K1"]),
    "fused": ((256,), lambda s: cplx((4,) + s, 3), ["K2"]),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("inverse", [False, True])
def test_replay_passes_the_generic_arguments(entries, chain, inverse):
    """A replay calls the generic path's entries with its arguments: on
    the recorded buffers, and on new buffers of the same layout (against
    a fresh plan's generic call on them)."""
    shape, make, kernels = CHAINS[chain]
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    a, b = make(shape), make(shape)
    generic, _ = execute(plan, a, entries, inverse=inverse)
    assert [k for k, _ in generic] == kernels
    replay, _ = execute(plan, a, entries, inverse=inverse)
    assert replay == generic
    replay, _ = execute(plan, b, entries, inverse=inverse)
    fresh, _ = execute(pyfft_tpu_torch.Plan(shape, device="cpu"), b,
                       entries, inverse=inverse)
    assert replay == fresh
    assert counts("record.") == {"record.miss": 2, "record.hit": 2}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_replay_counts_the_generic_launches(entries, chain):
    """``launch.*`` counts alike on the generic path and on a replay, the
    designs as the entries report them."""
    entries.returns.update(K8=local.RAN_RING, K5=local.RAN_RING,
                           K1=local.RAN_RING, K2=local.RAN_RING)
    shape, make, _ = CHAINS[chain]
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    x = make(shape)
    plan.execute(*(x if isinstance(x, tuple) else (x,)))
    generic = counts("launch.")
    profiling.reset()
    plan.execute(*(x if isinstance(x, tuple) else (x,)))
    assert counts("launch.") == generic and generic
    assert counts("record.") == {"record.hit": 1}


def test_replay_keeps_the_spans(tmp_path, entries):
    """A replay emits the generic path's spans: each ``pyfft.entry.*`` in
    its ``pyfft.pass.*`` inside ``pyfft.execute``, then the rest as
    before."""
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = cplx((2, 8, 128, 128))
    first = span_events(tmp_path, lambda: plan.execute(x))
    again = span_events(tmp_path, lambda: plan.execute(x))
    assert counts("record.") == {"record.miss": 1, "record.hit": 1}
    names = [s[0] for s in again]
    assert names == [s[0] for s in first] == [
        "pyfft.execute", "pyfft.pass.fused2d", "pyfft.entry.K8",
        "pyfft.pass.local", "pyfft.entry.K5"]
    execute_, p8, k8, p5, k5 = again
    assert inside(k8, p8) and inside(k5, p5)
    assert inside(p8, execute_) and inside(p5, execute_)


def test_replay_keeps_the_fused_span(tmp_path, entries):
    """The "fused" route's replay emits ``pyfft.pass.fused`` around K2's
    entry, as its generic path did."""
    plan = pyfft_tpu_torch.Plan((256,), device="cpu")
    x = cplx((4, 256))
    first = span_events(tmp_path, lambda: plan.execute(x))
    again = span_events(tmp_path, lambda: plan.execute(x))
    assert counts("record.") == {"record.miss": 1, "record.hit": 1}
    assert [s[0] for s in again] == [s[0] for s in first] == [
        "pyfft.execute", "pyfft.pass.fused", "pyfft.entry.K2"]
    execute_, fused, k2 = again
    assert inside(k2, fused) and inside(fused, execute_)


def test_replay_raises_the_generic_error(entries):
    """A failed entry raises on a replay what it raises on the generic
    path, and counts no launch."""
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = cplx((1, 8, 128, 128))
    plan.execute(x)
    entries.returns["K5"] = 700
    profiling.reset()
    with pytest.raises(RuntimeError) as replay:
        plan.execute(x)
    assert counts("record.") == {"record.hit": 1}
    fresh = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    with pytest.raises(RuntimeError) as generic:
        fresh.execute(x)
    assert str(replay.value) == str(generic.value) == (
        "local_cols launch failed: cudaError 700")
    assert counts("launch.") == {"launch.K8.first": 2}


def strided_one(shape):
    """A contiguous complex tensor of (1, *shape) whose leading stride is
    1, not the plane's size: the same shape, other strides."""
    base = cplx((1,) + shape)
    return base.as_strided(base.shape, (1,) + base.stride()[1:])


@pytest.mark.parametrize("change", ["strides", "alignment", "donate",
                                    "direction", "route"])
def test_key_misses(monkeypatch, entries, change):
    """Another layout, alignment class, ``donate``, direction or route
    misses the record and runs the generic path."""
    shape = (8, 128, 128)
    if change == "alignment":
        shape = (128, 128)
        buf = on_card(torch.randn(2 * 128 * 128 + 1))
        first = (buf[:128 * 128].view(shape), buf[-128 * 128:].view(shape))
        # one float on: 4 bytes off the first call's 16-byte class
        other = (buf[1:1 + 128 * 128].view(shape), first[1])
    elif change == "strides":
        first = cplx((1,) + shape)
        other = strided_one(shape)
        assert other.is_contiguous() and other.stride() != first.stride()
    else:
        first = other = cplx((1,) + shape)
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    args = first if isinstance(first, tuple) else (first,)
    plan.execute(*args)
    plan.execute(*args)
    assert counts("record.") == {"record.miss": 1, "record.hit": 1}
    kw = {}
    if change == "donate":
        plan.donate = True
    elif change == "direction":
        kw["inverse"] = True
    elif change == "route":
        monkeypatch.setattr(plan_mod, "IL_MULTI_ROUTE", "stream")
        monkeypatch.setattr(interleave, "deinterleave", lambda v: tuple(
            on_card(t) for t in interleave.deinterleave_plain(v)))
    del entries.calls[:]
    plan.execute(*(other if isinstance(other, tuple) else (other,)), **kw)
    assert counts("record.") == {"record.miss": 2, "record.hit": 1}
    assert entries.calls


def test_route_is_read_at_call_time(monkeypatch, entries):
    """The route is part of the key, read on every call: switching
    ``IL_MULTI_ROUTE`` back finds the first record again."""
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = cplx((1, 8, 128, 128))
    monkeypatch.setattr(interleave, "deinterleave", lambda v: tuple(
        on_card(t) for t in interleave.deinterleave_plain(v)))
    plan.execute(x)
    monkeypatch.setattr(plan_mod, "IL_MULTI_ROUTE", "stream")
    plan.execute(x)
    plan.execute(x)
    monkeypatch.setattr(plan_mod, "IL_MULTI_ROUTE", "planes")
    plan.execute(x)
    assert counts("record.") == {"record.miss": 2, "record.generic": 1,
                                 "record.hit": 1}


def test_fourstep_runs_generic(entries):
    """A "fourstep" chain writes a temporary, which lies in neither the
    input nor the output: its key is marked generic."""
    plan = pyfft_tpu_torch.Plan((16384,), device="cpu")
    assert [p.executor for p in plan._exec_plan.passes] == ["fourstep"]
    x = cplx((1, 16384))
    plan.execute(x)
    plan.execute(x)
    assert counts("record.") == {"record.miss": 1, "record.generic": 1}
    assert profiling.total("launch.K5") >= 2


def test_chunked_batch_runs_generic(monkeypatch, entries):
    """A batch the chunk sweep splits runs generic; the budget's override
    is part of the key, so the unswept batch has its own record."""
    plan = pyfft_tpu_torch.Plan((128, 128), device="cpu")
    x = planes((4, 128, 128))
    monkeypatch.setattr(plan_mod, "_HBM_CHUNK_BUDGET", 128 * 128 * 4 * 6)
    assert plan._chunk(4, torch.device("cpu")) == 1
    del entries.calls[:]
    plan.execute(*x)
    plan.execute(*x)
    assert len(entries.calls) == 8
    assert counts("record.") == {"record.miss": 1, "record.generic": 1}
    monkeypatch.setattr(plan_mod, "_HBM_CHUNK_BUDGET", None)
    plan.execute(*x)
    plan.execute(*x)
    assert counts("record.") == {"record.miss": 2, "record.generic": 1,
                                 "record.hit": 1}


def test_records_are_bounded_per_plan(entries):
    """A plan keeps its 8 newest keys; the oldest is dropped and misses
    again."""
    plan = pyfft_tpu_torch.Plan((128, 128), device="cpu")
    xs = [cplx((b, 128, 128)) for b in range(1, 10)]
    for x in xs:
        plan.execute(x)
    assert len(plan._records) == plan_mod._RECORDS_PER_PLAN == 8
    plan.execute(xs[-1])
    plan.execute(xs[0])
    assert counts("record.") == {"record.miss": 10, "record.hit": 1}


def test_record_holds_no_call_tensor(entries):
    """A record keeps no tensor of a call alive: only ints, the launches
    and the tables."""
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = cplx((1, 8, 128, 128))
    y = plan.execute(x)
    refs = [weakref.ref(t) for t in (x, y)]
    del x, y
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert len(plan._records) == 1


@pytest.mark.parametrize("entry,records", [
    (None, {"record.miss": 1, "record.hit": 1}),
    (["planes"], {"record.miss": 2})])
def test_records_outlive_reload_tuned(tmp_path, monkeypatch, entries, entry,
                                      records):
    """A record made before ``reload_tuned()`` still hits after it (the
    libraries are the same); an ``il1d`` entry that changes the plan's
    route misses, through the form in its key."""
    monkeypatch.setenv("PYFFT_TPU_TORCH_TUNE_FILE",
                       str(tmp_path / "tuned.json"))
    monkeypatch.setattr(tune, "device_name", lambda: "card")
    tune.reload_tuned()
    shape, make, _ = CHAINS["rows" if entry is None else "fused"]
    plan = pyfft_tpu_torch.Plan(shape, device="cpu")
    x = make(shape)
    args = x if isinstance(x, tuple) else (x,)
    plan.execute(*args)
    if entry is not None:
        (tmp_path / "tuned.json").write_text(json.dumps(
            {"device": "card", f"il1d:{shape[0]}": entry}))
    tune.reload_tuned()
    try:
        assert plan.il_route() == (entry or [plan_mod.IL1D_ROUTE])[0]
        plan.execute(*args)
    finally:
        tune.reload_tuned()         # read again once the patches are gone
    assert counts("record.") == records


def test_cpu_tensors_keep_no_record():
    """A CPU tensor runs the plain versions and counts no ``record.*``."""
    profiling.reset()
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = torch.randn(1, 8, 128, 128, dtype=C64)
    plan.execute(x)
    plan.execute(x)
    assert counts("record.") == {} and plan._records == {}


def test_planar_fourstep_counts_generic(entries):
    """A planar "fourstep" call allocates its output in the generic path:
    one miss, then generic calls, as the c128 cell runs."""
    plan = pyfft_tpu_torch.Plan((16384,), device="cpu")
    x = planes((2, 16384))
    for _ in range(3):
        re, im = plan.execute(*x)
        assert re.shape == x[0].shape
    assert counts("record.") == {"record.miss": 1, "record.generic": 2}


def test_empty_batch_keeps_no_record(entries):
    """A call that launches nothing keeps no record: its key runs
    generic."""
    plan = pyfft_tpu_torch.Plan((8, 128, 128), device="cpu")
    x = cplx((0, 8, 128, 128))
    plan.execute(x)
    y = plan.execute(x)
    assert y.shape == x.shape and not entries.calls
    assert counts("record.") == {"record.miss": 1, "record.generic": 1}


def test_records_from_threads(entries):
    """A plan executed from several threads at once, with more layouts
    than it keeps: every call returns its input's shape and the bound
    holds while threads add and drop records."""
    import sys
    import threading
    plan = pyfft_tpu_torch.Plan((128, 128), device="cpu")
    xs = [cplx((b, 128, 128)) for b in range(1, 13)]
    errors = []

    def work(k):
        try:
            for i in range(24):
                x = xs[(i * 5 + k) % len(xs)]
                assert plan.execute(x).shape == x.shape
        except Exception as e:          # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(plan._records) <= plan_mod._RECORDS_PER_PLAN
