"""The HBM chunk sweep of the port's ``Plan`` (``plan._run``,
``_hbm_chunk_budget``, ``Plan._fudge``, ``Plan._chunk``) on the CPU: the
budget's sources (the card's memory stubbed), the chunk count by the JAX
package's rule, swept against unswept runs of its chunks bit for bit on
the plain versions (a four-step, a 2D and a complex128 plan, planar and
complex forms, with and without ``donate``, the "stream" and "planes"
routes; "fused" not swept), and against the JAX package's ``Plan`` with its budget pinned too
(as tests/test_plan.py's chunked-batch tests).  A CPU plan is swept only
under the module override ``_HBM_CHUNK_BUDGET``.
"""

import jax
import numpy as np
import pytest
import torch

import pyfft_tpu
import pyfft_tpu.plan as jax_planmod
from pyfft_tpu_torch import Plan
from pyfft_tpu_torch import plan as planmod

from helpers import TOL, rand_complex, rel_err

torch.set_num_threads(2)

# (shape, dtype): a four-step plan, a 2D plan (fused2d), a complex128 plan
PLANS = [((16384,), np.complex64), ((128, 256), np.complex64),
         ((16384,), np.complex128)]


@pytest.fixture(autouse=True)
def no_budget(monkeypatch):
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET", None)
    monkeypatch.setattr(planmod, "_HBM_BUDGET_CACHE", {})


def counted(plan):
    """Record the batch of every ``_run_once`` call of ``plan``."""
    calls = []
    once = plan._run_once

    def run(re, im, inverse, out):
        calls.append(re.shape[0] if re.ndim > len(plan.shape) else 1)
        return once(re, im, inverse, out)

    plan._run_once = run
    return calls


def per_row(shape, dtype) -> int:
    return int(np.prod(shape)) * (4 if dtype == np.complex64 else 8)


def execute(plan, x, form, inverse=False):
    """``plan.execute`` on a fresh tensor copy of ``x``; numpy out."""
    if form == "planar":
        re = torch.from_numpy(np.ascontiguousarray(x.real))
        im = torch.from_numpy(np.ascontiguousarray(x.imag))
        rr, ii = plan.execute(re, im, inverse=inverse)
        if plan.donate:
            assert rr.data_ptr() == re.data_ptr()
        return rr.numpy() + 1j * ii.numpy()
    t = torch.from_numpy(x.copy())
    y = plan.execute(t, inverse=inverse)
    if plan.donate:
        assert y.data_ptr() == t.data_ptr()
    return y.numpy()


# ---------------------------------------------------------- the budget


def test_budget_sources(monkeypatch):
    """As tests/test_plan.py::test_hbm_chunk_budget_sources: the override
    wins; on a card a quarter of its memory, asked once a card; the CPU
    has none."""
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET", 123)
    assert planmod._hbm_chunk_budget(torch.device("cpu")) == 123
    assert planmod._hbm_chunk_budget(torch.device("cuda", 0)) == 123
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET", None)
    assert planmod._hbm_chunk_budget(torch.device("cpu")) is None
    asked = []

    def mem_get_info(index):
        asked.append(index)
        return (1 << 30, (80 << 30) + index)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert planmod._hbm_chunk_budget(torch.device("cuda", 0)) == 20 << 30
    assert planmod._hbm_chunk_budget(torch.device("cuda", 0)) == 20 << 30
    assert planmod._hbm_chunk_budget(torch.device("cuda")) == \
        ((80 << 30) + 1) // 4
    assert asked == [0, 1]


@pytest.mark.parametrize("shape,dtype,fudge", [
    ((4096,), np.complex64, 4),          # local
    ((256, 256), np.complex64, 4),       # fused2d
    ((16384,), np.complex64, 6),         # fourstep: one temporary
    ((1 << 27,), np.complex64, 8),       # huge: two temporaries
    ((4,), np.complex64, 10),            # plain: the chain's products
    ((16, 64), np.complex64, 10),        # local, plain
    ((1 << 22,), np.complex128, 6),      # config 5
])
def test_fudge_by_executor(shape, dtype, fudge):
    assert Plan(shape, dtype, device="cpu")._fudge() == fudge


@pytest.mark.parametrize("batch,rows_fit,chunk", [
    (12, 5, 4), (12, 12, 12), (12, 100, 12), (12, 1, 1), (12, 0, 1),
    (7, 3, 1), (64, 8, 8), (64, 63, 32), (1, 0, 1)])
def test_chunk_by_jax_rule(monkeypatch, batch, rows_fit, chunk):
    """The largest divisor of the batch whose rows fit the budget, at
    least 1 (JAX's ``run_planar``), with this plan's fudge."""
    plan = Plan((16384,), device="cpu")
    cost = per_row((16384,), np.complex64) * plan._fudge()
    budget = rows_fit * cost + cost // 2
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET", budget)
    # JAX's rule, as plan.py:339-346 of the JAX package writes it
    want = batch
    if batch > 1 and batch * cost > budget:
        want = max(1, budget // cost)
        while batch % want:
            want -= 1
    assert want == chunk
    assert plan._chunk(batch, torch.device("cpu")) == chunk
    calls = counted(plan)
    execute(plan, rand_complex((batch, 16384), seed=batch), "planar")
    assert calls == [chunk] * (batch // chunk)


# ------------------------------------------------ swept against unswept


@pytest.mark.parametrize("shape,dtype", PLANS)
@pytest.mark.parametrize("form", ["planar", "complex"])
@pytest.mark.parametrize("donate", [False, True])
def test_swept_equals_unswept(monkeypatch, shape, dtype, form, donate):
    """A batch of 8 swept in four chunks of 2 gives the bits of four
    unswept runs of those chunks, each chunk writing its slice of the
    output (in place under ``donate``).  The whole batch in one run is not
    compared bit for bit: the plain versions' matrix products may round by
    the batch (the host's BLAS), which the sweep does not promise."""
    x = rand_complex((8,) + shape, dtype=dtype, seed=sum(shape) % 101)
    plan = Plan(shape, dtype, device="cpu", donate=donate)
    calls = counted(plan)
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET",
                        2 * per_row(shape, dtype) * plan._fudge())
    swept = execute(plan, x, form)
    assert calls == [2, 2, 2, 2]
    calls.clear()
    chunks = [execute(plan, x[i:i + 2], form) for i in range(0, 8, 2)]
    assert calls == [2, 2, 2, 2]
    assert np.array_equal(swept, np.concatenate(chunks))
    ref = np.fft.fftn(x.astype(np.complex128),
                      axes=tuple(range(-len(shape), 0)))
    assert rel_err(swept, ref) < TOL[dtype]


@pytest.mark.parametrize("inverse", [False, True])
def test_swept_leading_batch_dims(monkeypatch, inverse):
    """A (2, 3, n) batch sweeps over its flattened 6 transforms and keeps
    its shape; the inverse's 1/N lands in every chunk."""
    shape = (16384,)
    x = rand_complex((2, 3) + shape, seed=5)
    plan = Plan(shape, device="cpu")
    whole = execute(plan, x, "planar", inverse)
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET",
                        3 * per_row(shape, np.complex64) * plan._fudge())
    calls = counted(plan)
    swept = execute(plan, x, "planar", inverse)
    assert calls == [3, 3] and swept.shape == x.shape
    assert np.array_equal(swept, whole)


def test_stream_route_is_swept(monkeypatch):
    shape = (16384,)
    x = rand_complex((4,) + shape, seed=6)
    monkeypatch.setattr(planmod, "IL_MULTI_ROUTE", "stream")
    plan = Plan(shape, device="cpu")
    assert plan.il_route() == "stream"
    whole = execute(plan, x, "complex")
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET",
                        per_row(shape, np.complex64) * plan._fudge())
    calls = counted(plan)
    swept = execute(plan, x, "complex")
    assert calls == [1, 1, 1, 1]
    assert np.array_equal(swept, whole)


def test_fused_route_is_not_swept(monkeypatch):
    """"fused" is one kernel with no temporaries and no ``_run``, as JAX's
    fused 1D interleaved route bypasses ``run_planar``."""
    x = rand_complex((4, 4096), seed=7)
    plan = Plan((4096,), device="cpu")
    assert plan.il_route() == "fused"
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET", 1)
    calls = counted(plan)
    got = execute(plan, x, "complex")
    assert calls == []
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < \
        TOL[np.complex64]


def test_cpu_plan_unswept_without_override():
    plan = Plan((16384,), device="cpu")
    assert plan._chunk(1 << 20, torch.device("cpu")) == 1 << 20


# --------------------------------------------------- against JAX's Plan


@pytest.mark.parametrize("shape,dtype", PLANS)
@pytest.mark.parametrize("form", ["planar", "complex"])
def test_swept_matches_jax_swept(monkeypatch, shape, dtype, form):
    """Both packages with their budgets pinned so that each sweeps the
    batch of 8 (JAX by ``lax.map``, in chunks its own fudge gives)."""
    x = rand_complex((8,) + shape, dtype=dtype, seed=11)
    plan = Plan(shape, dtype, device="cpu")
    monkeypatch.setattr(planmod, "_HBM_CHUNK_BUDGET",
                        2 * per_row(shape, dtype) * plan._fudge())
    # JAX's fudge off the TPU: 8 for complex64, 128 for complex128
    jax_fudge = 8 if dtype == np.complex64 else 128
    monkeypatch.setattr(jax_planmod, "_HBM_CHUNK_BUDGET",
                        2 * per_row(shape, dtype) * jax_fudge)
    maps = []
    lax_map = jax.lax.map

    def counted_map(f, xs):
        maps.append(jax.tree_util.tree_leaves(xs)[0].shape[:2])
        return lax_map(f, xs)

    monkeypatch.setattr(jax.lax, "map", counted_map)
    got = execute(plan, x, form)
    jplan = pyfft_tpu.Plan(shape, dtype)
    if form == "planar":
        jr, ji = jplan.execute(np.ascontiguousarray(x.real),
                               np.ascontiguousarray(x.imag))
        jgot = np.asarray(jr) + 1j * np.asarray(ji)
    else:
        jgot = np.asarray(jplan.execute(x))
    assert maps == [(4, 2)]             # JAX swept 4 chunks of 2 too
    ref = np.fft.fftn(x.astype(np.complex128),
                      axes=tuple(range(-len(shape), 0)))
    tol = TOL[dtype]
    assert rel_err(got, ref) < tol
    assert rel_err(jgot, ref) < tol
    assert rel_err(got, jgot) < tol
