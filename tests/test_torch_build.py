"""The kernel build's cache key (``repro_torch.kernels.build``): a library
is named by a hash of its ``.cu`` and of every shared ``.cuh`` header, so
an edit to either rebuilds.  Runs without ``nvcc``: nothing is compiled."""
from __future__ import annotations

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint k;\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nint shared;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_editing_a_shared_header_renames_the_library(csrc):
    before = build.library_path("k")
    (csrc / "common.cuh").write_text("#pragma once\nint shared_v2;\n")
    assert build.library_path("k") != before


def test_adding_a_header_renames_the_library(csrc):
    before = build.library_path("k")
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert build.library_path("k") != before


def test_editing_the_source_renames_the_library_and_nothing_else_does(csrc):
    before = build.library_path("k")
    (csrc / "notes.txt").write_text("not part of any build")
    assert build.library_path("k") == before
    (csrc / "k.cu").write_text('#include "common.cuh"\nint k2;\n')
    after = build.library_path("k")
    assert after != before
    assert after.parent == build.build_dir()
    assert after.name.startswith("libk_") and after.suffix == ".so"


def test_the_package_headers_are_hashed():
    """``hopper.cuh`` (mbarrier / TMA / wgmma helpers) is one of the
    headers the two wgmma kernels include."""
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for name in ("flash_attention", "moe_gmm"):
        assert '#include "hopper.cuh"' in (
            build.CSRC / f"{name}.cu").read_text()


def test_tensor_map_errors_are_told_apart_from_cuda_errors():
    assert build.describe_error(1) == "CUDA error 1"
    assert "CUresult 700" in build.describe_error(build.TMAP_ERROR + 700)
    src = (build.CSRC / "hopper.cuh").read_text()
    assert f"constexpr int TMAP_ERROR = {build.TMAP_ERROR};" in src
