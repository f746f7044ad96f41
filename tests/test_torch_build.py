"""The kernel build key of ``elasticdl_tpu_torch/ops/build.py``: a library
is rebuilt when its source or a shared header changes, and only then,
and keeps its ptxas report beside it. Nothing here runs nvcc."""

import os
import shutil

import pytest

from elasticdl_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", str(copy))
    return copy


def test_the_sources_include_the_shared_header(csrc):
    assert "hopper_tiles.cuh" in build.headers()
    assert '#include "hopper_tiles.cuh"' in (csrc / "flash_bwd.cu").read_text()


def test_an_edited_header_changes_the_library_path(csrc):
    before = build._library_path("flash_bwd.cu")
    with open(csrc / "hopper_tiles.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build._library_path("flash_bwd.cu") != before


def test_the_forward_includes_the_shared_header(csrc):
    assert '#include "hopper_tiles.cuh"' in (csrc / "flash_fwd.cu").read_text()


def test_an_edited_header_changes_the_forward_library_path(csrc):
    before = build._library_path("flash_fwd.cu")
    with open(csrc / "hopper_tiles.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build._library_path("flash_fwd.cu") != before


def test_a_new_header_changes_the_library_path(csrc):
    before = build._library_path("flash_bwd.cu")
    (csrc / "more_tiles.cuh").write_text("#pragma once\n")
    assert build._library_path("flash_bwd.cu") != before


def test_an_edited_source_changes_only_its_own_library_path(csrc):
    bwd = build._library_path("flash_bwd.cu")
    fwd = build._library_path("flash_fwd.cu")
    with open(csrc / "flash_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    assert build._library_path("flash_fwd.cu") != fwd
    assert build._library_path("flash_bwd.cu") == bwd


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """An empty ``_build/`` and no nvcc: a build attempt raises."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    return tmp_path / "_build"


def test_a_cached_library_answers_with_its_ptxas_report(build_dir):
    lib = build._library_path("flash_bwd.cu")
    build_dir.mkdir()
    (build_dir / os.path.basename(lib)).write_bytes(b"")
    (build_dir / (os.path.basename(lib) + ".ptxas")).write_text("report\n")
    assert build.compile_source("flash_bwd.cu") == lib
    assert build.ptxas_report("flash_bwd.cu") == "report\n"


def test_a_library_without_its_ptxas_report_is_rebuilt(build_dir):
    lib = build._library_path("flash_bwd.cu")
    build_dir.mkdir()
    (build_dir / os.path.basename(lib)).write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        build.ptxas_report("flash_bwd.cu")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.compile_source("flash_bwd.cu")
