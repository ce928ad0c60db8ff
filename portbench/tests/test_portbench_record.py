"""The reader of the program's call-record counts: ``record_hit_share``,
hits over every call the record saw, from the program's registry."""

import sys
import types

import pytest

from portbench import registry
from portbench.harness import Run

RECORD_SHARES = ["record_hit_share.sync",
                 "record_hit_share.c64_3d_256.stream",
                 "record_hit_share.c128_1d_4m_b64.stream"]


def metric(name):
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


@pytest.mark.parametrize("name", RECORD_SHARES)
def test_record_hit_share_of_the_counts(program_registry, name):
    """Hits over every call the record saw: hits, misses and generic
    calls; other keys are not calls."""
    program_registry.update({"record.hit": 997, "record.miss": 2,
                             "record.generic": 1, "launch.K8.ring": 1000})
    assert metric(name) == pytest.approx(0.997)
    program_registry.update({"record.hit": 0, "record.generic": 998})
    assert metric(name) == 0.0


@pytest.mark.parametrize("name", RECORD_SHARES)
def test_record_hit_share_none_without_records(monkeypatch,
                                               program_registry, name):
    """No ``record.*`` key counted (a program without call records), or no
    registry: None."""
    program_registry["launch.K8.ring"] = 3
    assert metric(name) is None
    monkeypatch.delitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        raising=False)
    assert metric(name) is None
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch.utils.profiling",
                        types.SimpleNamespace(trace=None))
    assert metric(name) is None
