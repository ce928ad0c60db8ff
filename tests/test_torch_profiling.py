"""``pyfft_tpu_torch.utils.profiling`` on the CPU: ``trace`` (over
``torch.profiler``) writes a trace file that holds a CPU ``Plan.execute``
(its plain versions' torch ops; the card's kernel records are checked by
``chip_smoke.py`` phase 25), and ``effective_gflops`` equals the JAX
package's for a shape or an int.  The timers need a card and raise here.
"""

import json

import numpy as np
import pytest
import torch

from pyfft_tpu.utils import profiling as jax_profiling
import pyfft_tpu_torch
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
