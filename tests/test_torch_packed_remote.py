"""Remote packed stores: ``cst_captioning_torch.data.packed`` over an
fsspec URL against the local directory it was copied from and against
the JAX package's reader on the same store.

fsspec's ``memory://`` filesystem stands in for a bucket, as the JAX
package's own test (``tests/test_packed.py::TestRemotePackedSource``)
has it: the same code path (``url_to_fs``, the header parsed once, one
ranged read a row, one ``cat_ranges`` call a batch) with no network.
Every comparison is exact: bitwise arrays of the same dtype, equal
lists.  Without fsspec a URL raises an ``ImportError`` naming it.
"""

import os
import sys

import numpy as np
import pytest

from cst_captioning_tpu.data import datasets as jdatasets
from cst_captioning_tpu.data import packed as jpacked
from cst_captioning_torch.data import packed as tpacked

fsspec = pytest.importorskip("fsspec")

DIMS = {"resnet": 32, "c3d": 16}
FRAMES = 6
N_VIDEOS = 20
IDXS = [np.asarray([5, 0, 19, 5]), np.arange(N_VIDEOS)[::-1],
        np.asarray([7])]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One local pack per dtype, each copied to ``memory://``."""
    ds, _ = jdatasets.make_synthetic_dataset(
        num_videos=N_VIDEOS, feature_dims=DIMS, max_frames=FRAMES, seed=9)
    root = tmp_path_factory.mktemp("packed_remote")
    fs = fsspec.filesystem("memory")
    out = {}
    for dtype in ("float32", "float16"):
        local = str(root / dtype)
        tpacked.pack_dataset(ds, local, max_frames=FRAMES, dtype=dtype)
        for name in os.listdir(local):
            with open(os.path.join(local, name), "rb") as f:
                fs.pipe(f"/torch_packtest_{dtype}/{name}", f.read())
        out[dtype] = (local, f"memory://torch_packtest_{dtype}")
    yield out
    for dtype in out:
        fs.rm(f"/torch_packtest_{dtype}", recursive=True)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("modality", sorted(DIMS))
def test_remote_rows_bitwise_local_and_jax(stores, dtype, modality):
    local, url = stores[dtype]
    got = tpacked.PackedSource(url, modality)
    ref_local = tpacked.PackedSource(local, modality)
    ref_jax = jpacked.PackedSource(url, modality)
    assert got.meta == ref_local.meta == ref_jax.meta
    assert got.video_ids == ref_local.video_ids
    assert (got.frames, got.dim) == (FRAMES, DIMS[modality])
    for i in range(N_VIDEOS):
        row = got.get(i)
        assert row.dtype == np.float32
        np.testing.assert_array_equal(row, ref_local.get(i))
        np.testing.assert_array_equal(row, ref_jax.get(i))
    for idxs in IDXS:
        f, m = got.get_batch(idxs, FRAMES)
        for other in (ref_local, ref_jax):
            fo, mo = other.get_batch(idxs, FRAMES)
            assert f.dtype == np.asarray(fo).dtype == np.dtype(dtype)
            np.testing.assert_array_equal(f, np.asarray(fo))
            np.testing.assert_array_equal(m, mo)


def test_remote_rows_without_cat_ranges(stores, monkeypatch):
    """A filesystem without ``cat_ranges`` gathers row by row, bitwise
    the batched read."""
    _, url = stores["float32"]
    want = tpacked.PackedSource(url, "resnet").get_batch(IDXS[0], FRAMES)
    src = tpacked.PackedSource(url, "resnet")
    monkeypatch.setattr(src._arr, "_has_cat_ranges", False)
    got = src.get_batch(IDXS[0], FRAMES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_remote_is_packed_dir_and_guards(stores):
    _, url = stores["float16"]
    assert tpacked.is_packed_dir(url) and jpacked.is_packed_dir(url)
    for missing in ("memory://torch_no_such_dir",):
        assert not tpacked.is_packed_dir(missing)
        assert not jpacked.is_packed_dir(missing)
    with pytest.raises(ValueError, match="packed frames"):
        tpacked.PackedSource(url, "resnet").get_batch(np.asarray([0]), 5)


def test_remote_url_without_fsspec_names_it(stores, monkeypatch):
    """The GPU host has no fsspec: a URL raises an ImportError that names
    it (never a read of a local path of that name); local packs still
    read."""
    local, url = stores["float32"]
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        tpacked.PackedSource(url, "resnet")
    with pytest.raises(ImportError, match="fsspec"):
        tpacked.is_packed_dir(url)
    assert tpacked.is_packed_dir(local)
    tpacked.PackedSource(local, "resnet").get(0)
