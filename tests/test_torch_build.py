"""The port's kernel build (``ops/_build.py``): what it compiles and what
its library digest covers.  No ``nvcc`` is needed: these read the
sources and the build tables only."""

import os
import re
import shutil

import pytest

from cst_captioning_torch.ops import _build

INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
CSRC_FILES = sorted(f for f in os.listdir(_build.CSRC)
                    if f.endswith((".cu", ".cuh")))
LISTED = set(_build.SOURCES.values()) | set(_build.HEADERS)


def test_csrc_has_sources():
    assert any(f.endswith(".cu") for f in CSRC_FILES)


@pytest.mark.parametrize("name", CSRC_FILES)
def test_local_includes_are_listed(name):
    """Every ``#include "..."`` names a listed source or header, so the
    digest (sources + HEADERS) covers it and an edit rebuilds."""
    with open(os.path.join(_build.CSRC, name)) as fh:
        for inc in INCLUDE.findall(fh.read()):
            assert inc in LISTED, f"{name} includes unlisted {inc}"


@pytest.mark.parametrize("name", CSRC_FILES)
def test_every_csrc_file_is_listed(name):
    assert name in LISTED, f"{name} is in csrc/ but not in SOURCES/HEADERS"


@pytest.mark.parametrize("kernel,src", sorted(_build.SOURCES.items()))
def test_sources_exist(kernel, src):
    assert os.path.isfile(os.path.join(_build.CSRC, src)), kernel


@pytest.mark.parametrize("header", _build.HEADERS)
def test_headers_exist(header):
    assert os.path.isfile(os.path.join(_build.CSRC, header))


def test_nvcc_targets_sm90a():
    flags = list(_build.NVCC_FLAGS)
    i = flags.index("-gencode")
    assert flags[i + 1] == "arch=compute_90a,code=sm_90a"


@pytest.mark.parametrize("header", _build.HEADERS)
def test_header_edit_changes_every_digest(header, tmp_path, monkeypatch):
    """Editing any listed header renames every library, so a stale one
    is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {k: _build.library_path(k) for k in _build.SOURCES}
    with open(csrc / header, "a") as fh:
        fh.write("\n// edited\n")
    after = {k: _build.library_path(k) for k in _build.SOURCES}
    assert all(before[k] != after[k] for k in _build.SOURCES)
