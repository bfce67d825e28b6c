"""The kernel library's build key (``fastoptsolver_tpu_torch.kernels._build``):
the cached build is named by a hash of the flags and of every file under
``csrc/``, so an edited source or an edited header it includes rebuilds.
Nothing here needs nvcc or a card."""
import shutil

import pytest

from fastoptsolver_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_digest_of_a_copy_is_the_trees(csrc):
    assert _build._digest(csrc) == _build._digest()


@pytest.mark.parametrize("name", ["tri_matvec.cuh", "resident.cu", "gram_build.cu"])
def test_digest_follows_an_edited_file(csrc, name):
    before = _build._digest(csrc)
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._digest(csrc) != before


def test_digest_follows_a_new_header(csrc):
    before = _build._digest(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest(csrc) != before


def test_every_source_is_hashed_and_compiled():
    """Each compiled source lies under csrc/, and the headers beside them
    are hashed though not compiled on their own."""
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) <= names
    assert "tri_matvec.cuh" in names and "tri_matvec.cuh" not in _build.SOURCES
