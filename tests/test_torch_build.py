"""The port's kernel build (``pyfft_tpu_torch.ops.build``) on a host
without nvcc: a library is named by its source, every shared header and
the flags, so an edited header rebuilds."""

import pytest

from pyfft_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\n')
    (src / "b.cu").write_text("// another kernel\n")
    (src / "shared.cuh").write_text("// stage code v1\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return src


def test_edited_header_changes_library_path(csrc):
    first = build.library_path("a")
    assert first.parent == build.BUILD_DIR and first.name.startswith("liba_")
    assert build.library_path("a") == first                 # stable
    (csrc / "shared.cuh").write_text("// stage code v2\n")
    second = build.library_path("a")
    assert second != first
    (csrc / "shared.cuh").write_text("// stage code v1\n")
    assert build.library_path("a") == first                 # content, not time


@pytest.mark.parametrize("edit", ["source", "new header", "renamed header"])
def test_library_path_follows_sources(csrc, edit):
    before = build.library_path("a")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    elif edit == "new header":
        (csrc / "more.cuh").write_text("// new\n")
    else:
        (csrc / "shared.cuh").rename(csrc / "other.cuh")
    assert build.library_path("a") != before


def test_kernels_are_named_apart(csrc):
    assert build.library_path("a") != build.library_path("b")
    assert build.library_path("b").name.startswith("libb_")


def test_load_without_nvcc_raises(csrc, monkeypatch):
    """No nvcc on PATH or under CUDA_HOME: a clear error, and nothing is
    left in the build directory."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(csrc / "no-cuda"))
    cached = dict(build._LOADED)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("a")
    assert not build.library_path("a").exists()
    assert build._LOADED == cached


def test_every_source_is_named_by_its_hash():
    """The repository's own sources, interleave.cu among them: each builds
    to a library of its own, named by the hash of its source and the
    headers, and chip_smoke.py builds every one of them."""
    import chip_smoke
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert "interleave" in names and "local_rows" in names
    paths = {build.library_path(n) for n in names}
    assert len(paths) == len(names)
    for n in names:
        path = build.library_path(n)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{n}_") and path.suffix == ".so"
    assert sorted(chip_smoke.SOURCES) == names
    assert "fused2d_tiled" in names


@pytest.mark.parametrize("header", ["chain.cuh", "stockham.cuh",
                                    "int8_stage.cuh", "ring_cols.cuh",
                                    "cluster_cols.cuh"])
def test_every_source_follows_each_shared_header(tmp_path, monkeypatch,
                                                 header):
    """An edit to a shared header renames every library, fused2d_tiled.cu's
    included: a copy of the repository's csrc/ with one header edited
    names each source anew."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", src)
    names = sorted(p.stem for p in src.glob("*.cu"))
    before = {n: build.library_path(n) for n in names}
    (src / header).write_text((src / header).read_text() + "// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)
    assert "fused2d_tiled" in names


def test_build_dir_in_a_checkout_and_installed(tmp_path, monkeypatch):
    """A checkout (pyproject.toml beside the package) builds into its own
    build/pyfft_tpu_torch; an installed package, whose site-packages may
    not be writable, into the user's cache."""
    checkout = tmp_path / "repo"
    (checkout / "pyfft_tpu_torch" / "ops").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("[project]\n")
    assert (build._build_dir(checkout / "pyfft_tpu_torch")
            == checkout / "build" / "pyfft_tpu_torch")
    site = tmp_path / "site-packages"
    (site / "pyfft_tpu_torch" / "ops").mkdir(parents=True)
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    assert (build._build_dir(site / "pyfft_tpu_torch")
            == home / ".cache" / "pyfft_tpu_torch" / "build")


def test_build_dir_of_this_checkout():
    from pathlib import Path
    root = Path(build.__file__).resolve().parents[2]
    assert (root / "pyproject.toml").is_file()
    assert build.BUILD_DIR == root / "build" / "pyfft_tpu_torch"
