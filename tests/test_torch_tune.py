"""The port's autotune record (``pyfft_tpu_torch.utils.tune``) against the
JAX package's (``pyfft_tpu.utils.tune``) on the CPU: the record's file,
the split candidates, the readers of each kind (``choose_split``,
``choose_split3``, ``choose_split_df64``, ``plan._il1d_route``) and their
validation, the kernels' tables a ``row``/``col`` record sets
(``tune.defines``) and the library names they give, every split
candidate's transform against JAX's at the forced split (interpret mode,
1e-6), and ``autotune``'s refusal without a card.

The record is put in ``tmp_path`` through ``PYFFT_TPU_TORCH_TUNE_FILE``,
and the card it names is stubbed (``tune.device_name``): a CPU host has
none, and a record applies only on the card it names.  The JAX package's
record is pointed at an empty file.
"""

import ast
import inspect
import json
import math

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import fourstep as jax_fourstep
from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu.utils import tune as jax_tune
import pyfft_tpu_torch
from pyfft_tpu_torch import plan as planmod
from pyfft_tpu_torch.ops import build, fourstep, fp64, local
from pyfft_tpu_torch.utils import tune

from helpers import rand_complex, rel_err

torch.set_num_threads(2)

CARD = "NVIDIA H100 80GB HBM3"
LIBS = ("local_rows", "local_cols")


@pytest.fixture(autouse=True)
def record_file(tmp_path, monkeypatch):
    """The port's record at tmp_path/tuned.json (absent until a test writes
    it), read as on the card CARD; the JAX package's record empty."""
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("PYFFT_TPU_TORCH_TUNE_FILE", str(path))
    monkeypatch.setattr(tune, "device_name", lambda: CARD)
    empty = tmp_path / "jax_tuned.json"
    empty.write_text(json.dumps({}))
    monkeypatch.setenv("PYFFT_TPU_TUNE_FILE", str(empty))
    jax_local.reload_tuned()
    tune.reload_tuned()
    yield path
    tune.reload_tuned()
    jax_local._TUNED = None


def write(path, record, device=CARD):
    """Write ``record`` (naming ``device``, none if None) and reload it."""
    full = dict(record) if device is None else {"device": device, **record}
    path.write_text(json.dumps(full))
    tune.reload_tuned()


# ------------------------------------------------------------ the record


def test_tuned_path_default_and_env(monkeypatch, record_file):
    assert tune.tuned_path() == str(record_file)
    monkeypatch.delenv("PYFFT_TPU_TORCH_TUNE_FILE")
    path = tune.tuned_path()
    assert path.endswith("/.cache/pyfft_tpu_torch/tuned.json")
    assert path != jax_tune.tuned_path()


@pytest.mark.parametrize("content", [None, "", "{not json", "[1, 2]", "7"])
def test_load_tuned_missing_or_malformed(record_file, content):
    if content is not None:
        record_file.write_text(content)
    assert tune.load_tuned() == {}
    tune.reload_tuned()
    assert tune.tuned("split", 1 << 22) is None
    assert fourstep.choose_split(1 << 22) == (2048, 2048)


def test_load_tuned_reads_the_file(record_file):
    write(record_file, {"split:4194304": [1024, 4096]})
    assert tune.load_tuned() == {"device": CARD,
                                 "split:4194304": [1024, 4096]}
    assert tune.tuned("split", 1 << 22) == (1024, 4096)


@pytest.mark.parametrize("n", [1 << p for p in range(14, 28)])
@pytest.mark.parametrize("max_local", [None, 4096, 1024])
def test_split_candidates_match_jax(n, max_local):
    assert tune._split_candidates(n, max_local) == \
        jax_tune._split_candidates(n, max_local)
    assert tune._split3_candidates(n, max_local) == \
        jax_tune._split3_candidates(n, max_local)


# ------------------------------------------------- the splits' readers


def test_split_records_steer_the_splits(record_file):
    """As tests/test_fourstep.py::test_autotuned_split_override: valid
    records win, one with the wrong product or a factor over the ceiling
    is ignored, and none leaks past a caller's tighter ceiling."""
    write(record_file, {
        "split:4194304": [512, 8192],          # valid, not balanced
        "split:1048576": [512, 512],           # product != n: ignored
        "split:16777216": [16384, 1024],       # factor > max_local
        "split3:134217728": [512, 1024, 256],  # valid three-level
        "dsplit:4194304": [1024, 4096],        # valid, not balanced
        "dsplit:1048576": [256, 256],          # product != n: ignored
    })
    assert fourstep.choose_split(1 << 22) == (512, 8192)
    assert fourstep.choose_split(1 << 20) == (1024, 1024)
    assert fourstep.choose_split(1 << 24) == (4096, 4096)
    assert fourstep.choose_split3(1 << 27) == (512, 1024, 256)
    assert fourstep.choose_split(1 << 22, max_local=4096) == (2048, 2048)
    assert fp64.choose_split_df64(1 << 22, 4096) == (1024, 4096)
    assert fp64.choose_split_df64(1 << 20, 4096) == (1024, 1024)
    assert fp64.choose_split_df64(1 << 22, 2048) == (2048, 2048)
    # the planner plans by them
    plan = pyfft_tpu_torch.Plan((1 << 22,), device="cpu")
    assert plan._exec_plan.passes[0].split == (512, 8192)
    assert "splits=[512x8192]" in repr(plan)
    plan = pyfft_tpu_torch.Plan((1 << 22,), np.complex128, device="cpu")
    assert plan._exec_plan.passes[0].split == (1024, 4096)
    plan = pyfft_tpu_torch.Plan((1 << 27,), device="cpu")
    assert plan._exec_plan.passes[0].split == (512, 1024, 256)


@pytest.mark.parametrize("device", ["NVIDIA A100-SXM4-80GB", None])
def test_foreign_record_is_ignored(record_file, device):
    """A record of another card, or naming none, sets nothing."""
    write(record_file, {"split:4194304": [512, 8192],
                        "dsplit:4194304": [1024, 4096],
                        "il1d:4096": ["planes"], "row:4096": [2, 3],
                        "col:256": [16, 3]}, device=device)
    assert fourstep.choose_split(1 << 22) == (2048, 2048)
    assert fp64.choose_split_df64(1 << 22) == (2048, 2048)
    assert planmod._il1d_route(4096) == planmod.IL1D_ROUTE
    assert all(tune.defines(name) == () for name in LIBS)


def test_record_ignored_without_a_card(record_file, monkeypatch):
    monkeypatch.setattr(tune, "device_name", lambda: None)
    write(record_file, {"split:4194304": [512, 8192]}, device=None)
    assert fourstep.choose_split(1 << 22) == (2048, 2048)


@pytest.mark.parametrize("bad", [[512, 8192.0], ["512", "8192"],
                                 [True, 8192], [8192], [512, 8192, 1],
                                 [1000, 4194], [64, 65536]])
def test_malformed_split_entries_are_ignored(record_file, bad):
    write(record_file, {"split:4194304": bad})
    assert fourstep.choose_split(1 << 22) == (2048, 2048)


# ------------------------------ every split candidate against JAX's


def planes(x):
    return (np.ascontiguousarray(x.real).astype(np.float32),
            np.ascontiguousarray(x.imag).astype(np.float32))


@pytest.mark.parametrize("n,split", [
    (n, s) for n in (1 << 15, 1 << 16) for s in tune._split_candidates(n)])
def test_split_candidate_matches_jax(n, split):
    """The transform ``autotune`` times at each split (the plain versions
    here) against JAX's ``fft_axis_large(split=)`` in interpret mode."""
    x = rand_complex((2, n), seed=n % 997 + split[0])
    re, im = planes(x)
    tr, ti = fourstep.fft_axis_large(torch.from_numpy(re),
                                     torch.from_numpy(im), -1, axis=-1,
                                     split=split)
    jr, ji = jax_fourstep.fft_axis_large(re, im, -1, axis=-1, split=split,
                                         interpret=True)
    got = tr.numpy() + 1j * ti.numpy()
    assert rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-6
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


@pytest.mark.parametrize("split3", tune._split3_candidates(1 << 22, 1024))
def test_split3_candidate_matches_jax(split3):
    """As above for ``fft_axis_huge(split3=)`` at every six-step
    candidate of 2^22 with factors up to 1024."""
    n = 1 << 22
    x = rand_complex((1, n), seed=sum(split3) % 997)
    re, im = planes(x)
    tr, ti = fourstep.fft_axis_huge(torch.from_numpy(re),
                                    torch.from_numpy(im), -1, axis=-1,
                                    split3=split3)
    jr, ji = jax_fourstep.fft_axis_huge(re, im, -1, axis=-1,
                                        max_local=1024, split3=split3,
                                        interpret=True)
    got = tr.numpy() + 1j * ti.numpy()
    assert rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-6
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_split3_candidates_cover_choose_split3():
    for n in (1 << 22, 1 << 27):
        cands = tune._split3_candidates(n)
        assert fourstep.choose_split3(n) in cands
        assert all(math.prod(c) == n for c in cands)


# ------------------------------------------------------- the il1d route


def test_il1d_record_steers_the_route(record_file):
    """As tests/test_plan.py::test_il1d_route_record: the record's route,
    else IL1D_ROUTE on anything unrecognised; Plan.il_route follows."""
    assert planmod._il1d_route(4096) == planmod.IL1D_ROUTE      # no record
    plan = pyfft_tpu_torch.Plan((4096,), device="cpu")
    for route in ("planes", "stream", "fused"):
        write(record_file, {"il1d:4096": [route]})
        assert planmod._il1d_route(4096) == route
        assert plan.il_route() == route
        assert planmod._il1d_route(2048) == planmod.IL1D_ROUTE
    for bad in (["garbage"], "planes", [], [3]):
        write(record_file, {"il1d:4096": bad})
        assert planmod._il1d_route(4096) == planmod.IL1D_ROUTE


def test_il1d_record_leaves_multi_pass_plans(record_file):
    write(record_file, {"il1d:16384": ["fused"]})
    plan = pyfft_tpu_torch.Plan((16384,), device="cpu")
    assert plan.il_route() == planmod.IL_MULTI_ROUTE


# ------------------------------------------------ the kernels' tables


@pytest.mark.parametrize("name,macro", [
    ("local_rows", "PYFFT_ROWS_RING"), ("local_cols", "PYFFT_COLS_PRING"),
    ("local_cols", "PYFFT_XCOLS_F32")])
def test_source_tables_fit_their_rules(name, macro):
    """Every entry the sources hold passes ``_fits``, the rules the
    candidates and records are held to."""
    table = tune.source_table(name, macro)
    assert len(table) >= 4
    for entry in table:
        assert tune._fits(macro, entry[0], entry[1:]), entry


def test_source_tables_are_the_sources():
    assert tune.source_table("local_rows", "PYFFT_ROWS_RING") == [
        (3, 256, 3), (4, 256, 3), (5, 256, 3), (6, 128, 3), (10, 4, 3),
        (11, 2, 3), (12, 1, 3), (13, 1, 2)]
    assert [e[0] for e in tune.source_table(
        "local_cols", "PYFFT_COLS_PRING")] == [
            4, 5, 6, 7, 8]
    assert tuple(1 << e[0] for e in tune.source_table(
        "local_cols", "PYFFT_COLS_PRING")) == local.COL_RING_LENGTHS


@pytest.mark.parametrize("kind,n,want", [
    ("row", 4096, [(1, 3), (2, 3), (1, 2)]),
    ("row", 8192, [(1, 2), (1, 3)]),
    ("row", 1024, [(4, 3), (2, 3), (8, 3), (4, 2)]),
    ("row", 256, []),                   # the first design's length
    ("col", 256, [(32, 3), (16, 3), (32, 2)]),
    ("col", 16, [(128, 3), (64, 3), (256, 3), (128, 2)]),
    ("col", 512, []),
    ("col", 8, []),
    ("col", 1024, [(4, 32, 2), (4, 16, 1), (4, 16, 2), (4, 32, 1)]),
    ("col", 4096, [(16, 32, 2), (16, 32, 1)]),
    ("col", 3000, []),
])
def test_table_candidates(kind, n, want):
    """The source's entry first, then the halved, doubled and other-slot
    variants (16 or 32 columns, 1 or 2 blocks an SM for the cluster tile)
    that fit: the H100's 227 KB a block, whole warps, the boxes."""
    assert tune.table_candidates(kind, n) == want


def test_row_record_defines_and_library_name(record_file):
    today = {name: build.library_path(name) for name in LIBS}
    write(record_file, {"row:4096": [2, 3]})
    d = tune.defines("local_rows")
    assert d == ("PYFFT_ROWS_RING(X)=X(3, 256, 3) X(4, 256, 3) "
                 "X(5, 256, 3) X(6, 128, 3) X(10, 4, 3) X(11, 2, 3) "
                 "X(12, 2, 3) X(13, 1, 2)",)
    assert tune.defines("local_cols") == ()
    path = build.library_path("local_rows", defines=d)
    assert path != today["local_rows"]
    assert path.name.startswith("liblocal_rows_")
    assert path.parent == today["local_rows"].parent
    assert build.library_path("local_rows", defines=d) == path   # stable
    assert build._header(d) == (
        "#define PYFFT_ROWS_RING(X) X(3, 256, 3) X(4, 256, 3) X(5, 256, 3) "
        "X(6, 128, 3) X(10, 4, 3) X(11, 2, 3) X(12, 2, 3) X(13, 1, 2)\n")


def test_col_record_defines_both_tables(record_file):
    write(record_file, {"col:256": [16, 3], "col:2048": [8, 16, 1],
                        "col:64": [128, 2]})
    d = tune.defines("local_cols")
    assert d == ("PYFFT_COLS_PRING(X)=X(4, 128, 3) X(5, 128, 3) "
                 "X(6, 128, 2) X(7, 64, 3) X(8, 16, 3)",
                 "PYFFT_XCOLS_F32(X)=X(10, 4, 32, 2) X(11, 8, 16, 1) "
                 "X(12, 16, 32, 2) X(13, 16, 16, 2)")
    assert tune.defines("local_rows") == ()
    assert (build.library_path("local_cols", defines=d)
            != build.library_path("local_cols"))
    assert (build.library_path("local_cols", defines=d[:1])
            != build.library_path("local_cols", defines=d))


@pytest.mark.parametrize("entry", [
    {"row:4096": [1, 3]},               # the source's own entry
    {"row:4096": [8, 3]},               # over 227 KB of shared memory
    {"row:4096": [1, 1]},               # one slot
    {"row:4096": [1, 3, 1]},            # the wrong arity
    {"row:4096": [1.0, 3]},             # not integers
    {"row:256": [4, 3]},                # a length the ring does not take
    {"col:256": [64, 3]},               # over 227 KB
    {"col:256": [6, 3]},                # not whole 16-byte units
    {"col:1024": [3, 32, 2]},           # no G-point DFT of radix 3
    {"col:1024": [4, 48, 2]},           # a run that does not divide 128
    {"col:512": [32, 3]},               # the first design's length
])
def test_records_that_change_no_table(record_file, entry):
    """An entry equal to the source's, or one that fails the kernel's
    rules, gives no definitions: the libraries keep today's names."""
    write(record_file, entry)
    for name in LIBS:
        assert tune.defines(name) == ()
        assert (build.library_path(name, defines=tune.defines(name))
                == build.library_path(name))


def test_no_record_gives_todays_libraries(record_file):
    assert not record_file.exists()
    for name in LIBS:
        assert tune.defines(name) == ()
        assert (build.library_path(name, defines=tune.defines(name))
                == build.library_path(name))
    assert tune.defines("fused2d") == ()


def test_library_path_without_defines_is_unchanged():
    """``defines=()`` hashes nothing more: the name is the one the source,
    headers and flags give, as before the argument existed."""
    import hashlib
    h = hashlib.sha256((build.CSRC / "local_rows.cu").read_bytes())
    for header in sorted(build.CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    assert build.library_path("local_rows", defines=()).name == \
        f"liblocal_rows_{h.hexdigest()[:16]}.so"


def test_load_with_defines_includes_their_header(tmp_path, monkeypatch):
    """``load(name, defines=...)`` passes the definitions to nvcc as a
    header it includes first (``-D`` would split them at commas) and
    caches the library by name and definitions."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_LOADED", {})
    seen = []

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        header = (open(cmd[cmd.index("-include") + 1]).read()
                  if "-include" in cmd else None)
        seen.append((cmd, header))
        open(out, "w").close()
        return type("Done", (), {"returncode": 0, "stderr": ""})()

    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    d = ("PYFFT_ROWS_RING(X)=X(12, 2, 3)",)
    lib = build.load("local_rows", defines=d)
    plain = build.load("local_rows")
    assert build.load("local_rows", defines=d) is lib
    assert lib != plain and len(seen) == 2
    (cmd, header), (cmd0, header0) = seen
    assert header == "#define PYFFT_ROWS_RING(X) X(12, 2, 3)\n"
    assert cmd[-1].endswith("local_rows.cu") and header0 is None
    assert lib[1] == str(build.library_path("local_rows", defines=d))
    assert not list((tmp_path / "out").glob("*.h"))       # header removed


def test_library_caches_cover_every_library_query():
    """Every memoised function of ops/local.py that calls ``_library`` is
    cleared by ``clear_library_caches`` (``reload_tuned``), so no shape
    query answers for a library the record no longer sets."""
    src = inspect.getsource(local)
    tree = ast.parse(src)
    cached = set()
    for node in tree.body:
        if (isinstance(node, ast.FunctionDef) and node.name != "_library"
                and "_library(" in ast.get_source_segment(src, node)):
            assert any("lru_cache" in ast.get_source_segment(src, d)
                       for d in node.decorator_list), node.name
            cached.add(node.name)
    assert cached == {f.__name__ for f in local._LIBRARY_CACHES}
    local.clear_library_caches()


# ------------------------------------------------------------- autotune


def test_autotune_raises_without_a_card(record_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pyfft_tpu_torch.autotune([4096])
    assert not record_file.exists()


def test_autotune_signature_matches_jax():
    assert (inspect.signature(pyfft_tpu_torch.autotune)
            == inspect.signature(jax_tune.autotune))
    assert tune.autotune is pyfft_tpu_torch.autotune


def test_root_all_holds_jax():
    import pyfft_tpu
    assert set(pyfft_tpu.__all__) <= set(pyfft_tpu_torch.__all__)
    for name in pyfft_tpu_torch.__all__:
        assert hasattr(pyfft_tpu_torch, name), name
