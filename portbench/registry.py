"""Find the benchmark's pieces by name.

Every piece lives in a file of its own, named after the piece:

* a cell, ``cells/<cell>.json``: its configuration, its traffic mix and
  the mix's parameters, the sample of steps it checks and its traced slice;
* a configuration, ``configs/<config>.json``: the transform, its storage
  form, its source, and the limits of the comparison with the reference;
* a traffic mix, ``mixes/<mix>.json``: the parameters of the traffic,
  and the ``generator`` that reads them;
* a traffic generator, ``generators/<generator>.py``: ``drive(...)``,
  which issues the calls of a window, and ``buffers(inputs)``, which
  makes the buffers one kept step's outputs are copied into (see
  ``traffic.py``);
* a storage form, ``forms/<form>.py``, named by a configuration's
  ``form``: how the program is built and called, its inputs made, and its
  answers compared with the reference (see ``system.py``);
* a metric, ``metrics/<metric>.py``: a function ``value(run)`` of the
  run's record, which returns None where it finds nothing to read.  A
  metric whose file is not there is read by the file of its longest
  dotted prefix that is (``gflops.c64_3d_256`` by ``metrics/gflops.py``):
  one reader a definition, while each name keeps a bound of its own.

``BENCHMARK.json`` at the root of the checkout says which metrics each
cell reports.  A name outside ``[A-Za-z0-9_.-]``, or one that does not
start with a letter, a digit or ``_``, is refused before any file is read.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str) -> str:
    """``name`` if it is a valid piece name, else ValueError."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    return _json("cells", name)


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("mixes", name)


@functools.cache
def _load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module(kind: str, name: str, attr: str | None):
    """``attr`` of the module in ``<kind>/<name>.py`` (loaded once), or
    the module itself."""
    path = HERE / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    module = _load(kind, name)
    return getattr(module, attr) if attr else module


def metric(name: str):
    """The ``value`` function of ``metrics/<name>.py``, or of the file of
    the longest dotted prefix of ``name`` that has one."""
    parts = check_name(name).split(".")
    for k in range(len(parts), 0, -1):
        prefix = ".".join(parts[:k])
        if (HERE / "metrics" / f"{prefix}.py").is_file():
            return _module("metrics", prefix, "value")
    raise KeyError(f"no metric named {name!r} nor a reader of a prefix")


def generator(name: str):
    """The module ``generators/<name>.py``."""
    return _module("generators", name, None)


def form(name: str):
    """The module ``forms/<name>.py``."""
    return _module("forms", name, None)


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics_for(workload: str, traced: bool,
                bench: dict | None = None) -> list[tuple[str, str]]:
    """(name, unit) of each metric that ``workload`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced.  A metric
    with a ``workloads`` list is reported in those cells; one without, in
    every cell that reports the end-to-end metric it ``moves`` (a
    per-layer metric) or in every cell (an end-to-end one)."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return [(m["name"], m["unit"]) for m in e2e]
    reported = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in reported]


def resolve(workload: str) -> tuple[dict, dict, dict]:
    """(cell, config, mix) of the cell named ``workload``, the cell's mix
    parameters laid over the mix file's."""
    c = cell(workload)
    m = dict(mix(c["traffic"]))
    m.update(c.get("params", {}))
    return c, config(c["config"]), m
