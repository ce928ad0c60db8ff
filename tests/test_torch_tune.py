"""The port's autotune record (``pyfft_tpu_torch.utils.tune``) against the
JAX package's (``pyfft_tpu.utils.tune``) on the CPU: the record's file,
the split candidates, the readers of each kind (``choose_split``,
``choose_split3``, ``choose_split_df64``, ``plan._il1d_route``) and their
validation, the libraries the package asks for under any record (by name
alone: the source's tables), every split candidate's transform against
JAX's at the forced split (interpret mode, 1e-6), ``autotune``'s refusal
without a card and its ``row`` and ``col`` kinds, which time nothing.

The record is put in ``tmp_path`` through ``PYFFT_TPU_TORCH_TUNE_FILE``,
and the card it names is stubbed (``tune.device_name``): a CPU host has
none, and a record applies only on the card it names.  The JAX package's
record is pointed at an empty file.
"""

import hashlib
import inspect
import json
import math
import types

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


def source_path(name):
    """Where ``csrc/<name>.cu`` builds to, hashed here as ``build`` names
    it: the source, every header by name and content, the flags."""
    h = hashlib.sha256((build.CSRC / f"{name}.cu").read_bytes())
    for header in sorted(build.CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    return build.BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@pytest.mark.parametrize("entry", [
    None,                               # no record
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
    {"row:4096": [2, 3]},               # a table entry that fits
    {"col:256": [16, 3]},               # likewise
])
def test_table_entries_change_nothing(record_file, monkeypatch, entry):
    """A ``row``/``col`` entry, fitting its table or not, changes nothing:
    the package asks for the row and column libraries by name alone, at
    the path the source gives, and the splits and routes are as without
    the entry."""
    want = (fourstep.choose_split(1 << 22), fourstep.choose_split3(1 << 27),
            fp64.choose_split_df64(1 << 22), planmod._il1d_route(4096))
    if entry is not None:
        write(record_file, entry)
    asked = []

    def load(*args, **kw):
        asked.append((args, kw))
        return types.SimpleNamespace(
            **{s: types.SimpleNamespace() for s in (
                "pyfft_local_rows", "pyfft_local_cols",
                "pyfft_local_cols_width")})

    monkeypatch.setattr(build, "load", load)
    local._rows_fn.__wrapped__(torch.float32)
    local._cols_lib.__wrapped__(torch.float32)
    assert [a for a, _ in asked] == [("local_rows",), ("local_cols",),
                                    ("local_cols",)]
    assert all(kw == {} for _, kw in asked)
    for name in LIBS:
        assert build.library_path(name) == source_path(name)
    got = (fourstep.choose_split(1 << 22), fourstep.choose_split3(1 << 27),
           fp64.choose_split_df64(1 << 22), planmod._il1d_route(4096))
    assert got == want
    assert pyfft_tpu_torch.Plan((4096,), device="cpu").il_route() == want[3]


# ------------------------------------------------------------- autotune


def test_autotune_raises_without_a_card(record_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pyfft_tpu_torch.autotune([4096])
    assert not record_file.exists()


@pytest.mark.parametrize("kinds", [("row",), ("col",), ("row", "col")])
def test_autotune_row_col_time_nothing(record_file, monkeypatch, kinds):
    """JAX's ``row`` and ``col`` kinds time nothing here: the record
    written names the card alone, and no library is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def load(*args, **kw):
        raise AssertionError(f"build.load{args} called")

    monkeypatch.setattr(build, "load", load)
    got = pyfft_tpu_torch.autotune([256, 1024, 4096], kinds=kinds,
                                   verbose=False)
    assert got == {"device": CARD}
    assert json.loads(record_file.read_text()) == {"device": CARD}


def test_autotune_signature_matches_jax():
    assert (inspect.signature(pyfft_tpu_torch.autotune)
            == inspect.signature(jax_tune.autotune))
    assert tune.autotune is pyfft_tpu_torch.autotune


def test_root_all_holds_jax():
    import pyfft_tpu
    assert set(pyfft_tpu.__all__) <= set(pyfft_tpu_torch.__all__)
    for name in pyfft_tpu_torch.__all__:
        assert hasattr(pyfft_tpu_torch, name), name
