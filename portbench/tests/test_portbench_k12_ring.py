"""The reader of the program's K12 launch counts: ``k12_ring_share``, the
launches of the persistent cluster ring over every K12 launch, from the
program's registry."""

import sys
import types

import pytest

from portbench import registry
from portbench.harness import Run

NAME = "k12_ring_share.c128_1d_4m_b64.stream"


def metric(name=NAME):
    run = Run(setup_s=1.0, window_s=1.0, calls=2, flop=1.0, call_s=[],
              peak_bytes=0, least_s=1e-4, slice=None)
    return registry.metric(name)(run)


@pytest.fixture
def program_registry(monkeypatch):
    """A stand-in for the program's profiling module in ``sys.modules``,
    its registry filled by hand."""
    counts = {}
    module = types.SimpleNamespace(counts=lambda: dict(counts))
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        module)
    return counts


def test_k12_ring_share_of_the_counts(program_registry):
    """Ring launches over every K12 launch, ring, x tile and first design;
    other kernels' launches are not K12's."""
    program_registry.update({"launch.K12.ring": 96, "launch.K12.x": 3,
                             "launch.K12.first": 1, "launch.K5.x": 40,
                             "record.generic": 50})
    assert metric() == pytest.approx(0.96)
    program_registry.update({"launch.K12.ring": 0})
    assert metric() == 0.0
    program_registry.update({"launch.K12.ring": 8, "launch.K12.x": 0,
                             "launch.K12.first": 0})
    assert metric() == 1.0


def test_k12_ring_share_on_a_program_without_the_ring(program_registry):
    """A program whose K12 runs the x tile alone (no ``launch.K12.ring``
    key) reads 0.0, not None."""
    program_registry.update({"launch.K12.x": 80, "launch.K11.ring": 2})
    assert metric() == 0.0


def test_k12_ring_share_none_without_k12(monkeypatch, program_registry):
    """No ``launch.K12.*`` key counted, or no registry: None."""
    program_registry["launch.K8.ring"] = 3
    assert metric() is None
    monkeypatch.delitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        raising=False)
    assert metric() is None
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        types.SimpleNamespace(trace=None))
    assert metric() is None


def test_k12_ring_share_is_declared_for_its_cell():
    """The benchmark reports it in the config-5 cell alone, as a kernels
    metric read from the registry that moves that cell's rate."""
    got = [m for m in registry.benchmark()["per_layer"]
           if m["name"] == NAME]
    assert got == [{"name": NAME, "unit": "fraction", "better": "higher",
                    "source": "program_counter", "layer": "kernels",
                    "moves": "gflops.c128_1d_4m_b64",
                    "workloads": ["c128_1d_4m_b64.stream"]}]
    assert (NAME, "fraction") in registry.metrics_for(
        "c128_1d_4m_b64.stream", traced=True)
    for cell in ("c64_3d_256.stream", "c64_3d_256.sync",
                 "c64_1d_4096_b4096.stream"):
        assert NAME not in dict(registry.metrics_for(cell, traced=True))
