"""Whole runs of `run.py`: on the card (marked
``cuda``, skipped where there is none) and the ways a run must fail
without printing a result."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, registry, system

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_py(cwd, workload, seconds=1, trace=0, seed=2**31 + 77):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=cwd, capture_output=True, text=True, timeout=1500)


def no_result(res):
    return res.returncode != 0 and not any(
        line.startswith("{") for line in res.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace):
    res = run_py(ROOT, workload, trace=trace)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {n for n, _ in registry.metrics_for(workload, bool(trace))}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["c64_3d_256.stream",
                                      "c128_1d_4m_b64.stream"])
def test_control_is_not_correct_at_cell_size(card, workload):
    cell, config, mix = registry.resolve(workload)
    r = harness.run(workload, cell, config, mix, seed=2**31 + 99,
                    seconds=0.0, traced=False, device="cuda:0", metrics=[],
                    started=time.monotonic(), clock=time.monotonic,
                    system=system.Control(config, "cuda:0"),
                    log=lambda s: None)
    assert not r["correct"], r["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert no_result(run_py(ROOT, WORKLOADS[0]))


def test_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert no_result(run_py(tmp_path, WORKLOADS[0]))


def test_unknown_workload_gives_no_result():
    assert no_result(run_py(ROOT, "no_such.cell"))
