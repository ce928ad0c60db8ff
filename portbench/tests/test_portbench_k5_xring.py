"""The reader of the program's K5 launch counts: ``k5_xring_share``, the
launches of the persistent cluster ring on the complex form's pairs over
every K5 launch, from the program's registry."""

import sys
import types

import pytest

from portbench import registry
from portbench.harness import Run

NAME = "k5_xring_share.c64_2d_1024_b16.stream"


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


def test_k5_xring_share_of_the_counts(program_registry):
    """Ring launches over every K5 launch, cluster ring, x tile,
    persistent ring and first design; other kernels' launches are not
    K5's."""
    program_registry.update({"launch.K5.xring": 36, "launch.K5.x": 2,
                             "launch.K5.pring": 1, "launch.K5.first": 1,
                             "launch.K1.ring": 40, "launch.K12.ring": 3,
                             "record.hit": 38})
    assert metric() == pytest.approx(0.9)
    program_registry.update({"launch.K5.xring": 0})
    assert metric() == 0.0
    program_registry.update({"launch.K5.xring": 8, "launch.K5.x": 0,
                             "launch.K5.pring": 0, "launch.K5.first": 0})
    assert metric() == 1.0


def test_k5_xring_share_on_a_program_without_the_ring(program_registry):
    """A program whose K5 runs the cluster tile alone (no
    ``launch.K5.xring`` key) reads 0.0, not None."""
    program_registry.update({"launch.K5.x": 80, "launch.K1.ring": 80})
    assert metric() == 0.0


def test_k5_xring_share_none_without_k5(monkeypatch, program_registry):
    """No ``launch.K5.*`` key counted, or no registry: None."""
    program_registry["launch.K1.ring"] = 3
    assert metric() is None
    monkeypatch.delitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        raising=False)
    assert metric() is None
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        types.SimpleNamespace(trace=None))
    assert metric() is None


def test_k5_xring_share_is_declared_for_its_cell():
    """The benchmark reports it in the config-3 cell alone, as a kernels
    metric read from the registry that moves that cell's rate, after
    every metric the benchmark had."""
    per_layer = registry.benchmark()["per_layer"]
    got = [m for m in per_layer if m["name"] == NAME]
    assert got == [{"name": NAME, "unit": "fraction", "better": "higher",
                    "source": "program_counter", "layer": "kernels",
                    "moves": "gflops.c64_3d_256",
                    "workloads": ["c64_2d_1024_b16.stream"]}]
    assert per_layer[-1]["name"] == NAME
    assert (NAME, "fraction") in registry.metrics_for(
        "c64_2d_1024_b16.stream", traced=True)
    for cell in ("c64_3d_256.stream", "c64_3d_256.sync",
                 "c64_1d_4096_b4096.stream", "c128_1d_4m_b64.stream"):
        assert NAME not in dict(registry.metrics_for(cell, traced=True))
