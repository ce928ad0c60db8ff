"""The harness finds every piece that BENCHMARK.json names, by name, and
refuses a name outside [A-Za-z0-9_.-]."""

import json
import re

import pytest

from portbench import registry

BENCH = registry.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell, config, mix = registry.resolve(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell["config"] == entry["config"] == config["name"]
    assert cell["traffic"] == entry["traffic"]
    assert mix["wait"] in ("default", "none")
    assert 0 < cell["check"]["steps"] <= cell["check"]["within"]
    gen = registry.generator(mix["generator"])
    assert callable(gen.drive) and callable(gen.buffers)


FORM_API = ("make_inputs", "Port", "planes", "rel_err", "reference_call")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_names_a_form(config):
    form = registry.form(registry.config(config["name"])["form"])
    assert all(callable(getattr(form, a)) for a in FORM_API)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(config):
    data = json.loads((registry.ROOT / config["file"]).read_text())
    assert data == registry.config(config["name"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert len(data["source"]) <= 200
    assert set(data["limits"]) == {"fwd_rel_err", "inv_rel_err"}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(registry.metric(name))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_setup_and_per_layer(workload):
    e2e = [n for n, _ in registry.metrics_for(workload, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_for(workload, True)


@pytest.mark.parametrize("name", ["", "a b", "a/b", "../x", "x,y", ".x",
                                  "-x", "µs", "a" * 65, "cells/x"])
def test_bad_names_refused(name):
    for find in (registry.cell, registry.config, registry.mix,
                 registry.metric, registry.generator, registry.form):
        with pytest.raises(ValueError):
            find(name)


@pytest.mark.parametrize("find", [registry.cell, registry.config,
                                  registry.mix, registry.metric,
                                  registry.generator, registry.form])
def test_missing_name_is_a_key_error(find):
    with pytest.raises(KeyError):
        find("no_such_piece")


def test_metric_falls_back_to_its_longest_prefix():
    """One reader a definition: a split name reads the file of its longest
    dotted prefix that has one."""
    assert registry.metric("gflops.c64_3d_256") is registry.metric("gflops")
    assert (registry.metric("idle_share.c64_3d_256.stream")
            is registry.metric("idle_share"))
    with pytest.raises(KeyError):
        registry.metric("no_reader.gflops")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = WORKLOADS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(registry.NAME.fullmatch(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024
