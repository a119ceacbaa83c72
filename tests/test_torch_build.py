"""The port's kernel build (dycon_paper_replication_tpu_torch/ops/_build.py)
names each library by a hash of what compiles into it: the source, the
headers beside it and the flags. K1, K1-dW and K2 share `tf32_mma.cuh`, so
an edit to that header must give each a new library path, or a stale
library would load. No nvcc is needed: the path is computed, nothing is
built."""

import shutil

import pytest

from dycon_paper_replication_tpu_torch.ops import _build

SOURCES = ("folded_conv3.cu", "folded_conv3_dw.cu", "fecl_fused.cu")


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def test_sources_include_the_shared_header():
    for name in SOURCES:
        assert '#include "tf32_mma.cuh"' in (_build.CSRC / name).read_text(), name


def test_library_path_follows_the_shared_header(csrc):
    before = {name: _build.library_path(csrc / name) for name in SOURCES}
    assert before == {name: _build.library_path(_build.CSRC / name) for name in SOURCES}
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(csrc / name) for name in SOURCES}
    for name in SOURCES:
        assert after[name] != before[name], name
        assert after[name].name.startswith(name.removesuffix(".cu") + "-")


def test_library_path_follows_its_own_source_only(csrc):
    before = {name: _build.library_path(csrc / name) for name in SOURCES}
    src = csrc / "folded_conv3.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(src) != before["folded_conv3.cu"]
    assert _build.library_path(csrc / "folded_conv3_dw.cu") == before["folded_conv3_dw.cu"]
