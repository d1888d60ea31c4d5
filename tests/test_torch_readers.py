"""Port parity for the data readers: ``cst_captioning_torch.data.packed``
(``pack_dataset``, ``PackedSource``), ``data.datasets.H5Dataset`` and the
packed fast path of ``data.loader.BatchIterator`` against the JAX
package's on the same files.

Labels are written by the JAX package's ``tools/prepare_data.prepare``
from a synthetic corpus (16 videos split 12 / 4, two modalities of 24
and 16 features, 6 frames), feature h5s with ``h5py``, packs by either
package's ``pack_dataset``.  Every comparison is exact: byte-identical
files, bitwise arrays of the same dtype, equal strings.
"""

import json
import os
import sys

import numpy as np
import pytest

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import datasets as jdatasets
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.data import packed as jpacked
from cst_captioning_tpu.data.vocab import Vocabulary as JaxVocabulary
from cst_captioning_tpu.tools.prepare_data import prepare
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data import datasets as tdatasets
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.data import packed as tpacked
from cst_captioning_torch.data.vocab import Vocabulary

h5py = pytest.importorskip("h5py")

DIMS = {"resnet": 24, "c3d": 16}
FRAMES = 6
N_VIDEOS = 16


def _corpora(seed=9):
    kw = dict(num_videos=N_VIDEOS, feature_dims=DIMS, max_frames=FRAMES,
              num_categories=4, seed=seed)
    return (jdatasets.make_synthetic_dataset(**kw)[0],
            tdatasets.make_synthetic_dataset(**kw)[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Label h5s (train: videos 0-11, test: 12-15), one feature h5 per
    modality, and f32 / f16 packs of every video and of the first 10."""
    root = tmp_path_factory.mktemp("readers")
    jds, _ = _corpora()
    ids = [jds.video_id(i) for i in range(len(jds))]
    ann = {"splits": {"train": ids[:12], "test": ids[12:]},
           "captions": {v: jds.references(i) for i, v in enumerate(ids)},
           "categories": {v: int(jds.category(i)) for i, v in enumerate(ids)}}
    (root / "ann.json").write_text(json.dumps(ann))
    paths = prepare(str(root / "ann.json"), "simple", str(root / "prep"),
                    max_words=10)
    h5 = {}
    for m in DIMS:
        h5[m] = str(root / f"{m}.h5")
        with h5py.File(h5[m], "w") as f:
            for i, v in enumerate(ids):
                f.create_dataset(v, data=jds.features(i)[m])
    packs = {}
    for dtype in ("float32", "float16"):
        packs[dtype] = str(root / f"packed_{dtype}")
        jpacked.pack_dataset(jds, packs[dtype], max_frames=FRAMES,
                             dtype=dtype)
    packs["short"] = str(root / "packed_short")
    short = jdatasets.InMemoryDataset(
        jds.vocab, ids[:10], {m: [jds.features(i)[m] for i in range(10)]
                              for m in DIMS},
        [jds.captions(i) for i in range(10)],
        [jds.references(i) for i in range(10)])
    jpacked.pack_dataset(short, packs["short"], max_frames=FRAMES)
    return {"root": root, "paths": paths, "h5": h5, "packs": packs}


def _layouts(files):
    """modality -> path for the three layouts the reader takes."""
    h5, f32 = files["h5"], files["packs"]["float32"]
    return {"h5": dict(h5), "packed": {m: f32 for m in DIMS},
            "mixed": {"resnet": h5["resnet"], "c3d": f32},
            "packed_f16": {m: files["packs"]["float16"] for m in DIMS}}


def _both(files, layout, split="train"):
    vocab_file = files["paths"]["vocab"]
    label = files["paths"][f"labels_{split}"]
    feats = _layouts(files)[layout]
    return (jdatasets.H5Dataset(label, feats, JaxVocabulary.load(vocab_file)),
            tdatasets.H5Dataset(label, feats, Vocabulary.load(vocab_file)))


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# ------------------------------------------------------------- packing

@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_pack_dataset_writes_the_reference_bytes(tmp_path, dtype):
    jds, tds = _corpora()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpaths = jpacked.pack_dataset(jds, jdir, max_frames=4, dtype=dtype)
    tpaths = tpacked.pack_dataset(tds, tdir, max_frames=4, dtype=dtype)
    assert sorted(tpaths) == sorted(jpaths) == sorted(DIMS)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == sorted(
        [f"{m}.npy" for m in DIMS] + [f"{m}.meta.json" for m in DIMS])
    for n in names:
        with open(os.path.join(jdir, n), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, n), "rb") as f:
            assert f.read() == want, n
    assert tpacked.is_packed_dir(tdir) and not tpacked.is_packed_dir(
        str(tmp_path))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_packed_source_reads_match(files, dtype):
    d = files["packs"][dtype]
    for m in DIMS:
        j, t = jpacked.PackedSource(d, m), tpacked.PackedSource(d, m)
        assert (t.frames, t.dim, t.video_ids) == (j.frames, j.dim,
                                                  j.video_ids)
        _same(j.frame_counts, t.frame_counts)
        assert t.meta == j.meta
        for i in (0, 5, N_VIDEOS - 1):
            _same(j.get(i), t.get(i))
        idxs = np.asarray([3, 3, 11, 0, 15])
        _same(j.get_batch(idxs, FRAMES), t.get_batch(idxs, FRAMES))
        assert t.get_batch(idxs, FRAMES)[0].dtype == np.dtype(dtype)


@pytest.mark.parametrize("bad", [FRAMES - 1, FRAMES + 1])
def test_max_frames_guard_matches(files, bad):
    d = files["packs"]["float32"]
    with pytest.raises(ValueError) as want:
        jpacked.PackedSource(d, "resnet").get_batch(np.asarray([0]), bad)
    with pytest.raises(ValueError) as got:
        tpacked.PackedSource(d, "resnet").get_batch(np.asarray([0]), bad)
    assert str(got.value) == str(want.value)
    assert "packed frames" in str(got.value)


def test_packed_source_refuses_a_meta_that_disagrees(tmp_path):
    tpacked.pack_dataset(_corpora()[1], str(tmp_path), max_frames=FRAMES)
    meta = tmp_path / "c3d.meta.json"
    m = json.loads(meta.read_text())
    m["dim"] += 1
    meta.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="its meta says"):
        tpacked.PackedSource(str(tmp_path), "c3d")


@pytest.mark.parametrize("call", ["source", "is_packed", "pack", "h5"])
def test_remote_paths_are_refused(files, call, monkeypatch):
    """Remote stores read through fsspec (tests/test_torch_packed_remote.
    py); a host without fsspec (the GPU host) refuses a URL with an
    ImportError naming it, never reads a local path of that name, and
    packing into a URL is refused (packing writes a local directory)."""
    url = "gs://bucket/packed_train"
    monkeypatch.setitem(sys.modules, "fsspec", None)
    err = (ValueError, "packing writes a local directory") if (
        call == "pack") else (ImportError, "needs the fsspec package")
    with pytest.raises(err[0], match=err[1]):
        if call == "source":
            tpacked.PackedSource(url, "resnet")
        elif call == "is_packed":
            tpacked.is_packed_dir("memory://packed")
        elif call == "pack":
            tpacked.pack_dataset(_corpora()[1], url, max_frames=FRAMES)
        else:
            tdatasets.H5Dataset(files["paths"]["labels_train"],
                                {"resnet": url},
                                Vocabulary.load(files["paths"]["vocab"]))


# ------------------------------------------------------------ H5Dataset

@pytest.mark.parametrize("layout", ["h5", "packed", "mixed", "packed_f16"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_h5_dataset_accessors_match(files, layout, split):
    j, t = _both(files, layout, split)
    assert len(t) == len(j) == (12 if split == "train" else 4)
    assert t.feature_dims == j.feature_dims == DIMS
    for i in range(len(t)):
        assert t.video_id(i) == j.video_id(i)
        _same(j.features(i), t.features(i))
        _same(j.captions(i), t.captions(i))
        _same(j.caption_weights(i), t.caption_weights(i))
        assert t.category(i) == j.category(i)
        assert t.references(i) == j.references(i)
    idxs = np.asarray([2, 0, 3, 3])
    for F in (FRAMES, FRAMES - 2):
        jb, tb = j.features_batch(idxs, F), t.features_batch(idxs, F)
        assert (tb is None) == (jb is None)
        assert (tb is None) == (layout in ("h5", "mixed") or F != FRAMES)
        if tb is not None:
            _same(jb, tb)
    j.close()
    t.close()


def test_packed_modality_missing_a_video_raises(files):
    feats = {"resnet": files["h5"]["resnet"], "c3d": files["packs"]["short"]}
    label = files["paths"]["labels_test"]   # videos 12-15: not packed
    vocab = Vocabulary.load(files["paths"]["vocab"])
    with pytest.raises(ValueError, match="missing 4 of this split's videos"):
        tdatasets.H5Dataset(label, feats, vocab)
    with pytest.raises(ValueError, match="missing 4 of this split's videos"):
        jdatasets.H5Dataset(label, feats, JaxVocabulary.load(
            files["paths"]["vocab"]))
    train = files["paths"]["labels_train"]   # videos 0-11: 10 packed
    with pytest.raises(ValueError, match="missing 2 of"):
        tdatasets.H5Dataset(train, feats, vocab)


def test_h5_reader_needs_h5py(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        tdatasets.H5Dataset(files["paths"]["labels_train"], {},
                            Vocabulary.load(files["paths"]["vocab"]))


# ---------------------------------------------------------- the loader

@pytest.mark.parametrize("layout,fast", [("h5", False), ("mixed", False),
                                         ("packed", True),
                                         ("packed_f16", True)])
@pytest.mark.parametrize("shuffle,seed", [(True, 3), (False, 0)])
def test_batch_iterator_epochs_match(files, layout, fast, shuffle, seed):
    """Batch for batch, every field bitwise (the features' dtype too: a
    float16 pack stays float16 on the fast path), two epochs, with the
    wrap-around last batch."""
    j, t = _both(files, layout)
    kw = dict(batch_size=5, seq_per_img=4, max_frames=FRAMES,
              shuffle=shuffle, seed=seed)
    ji, ti = jloader.BatchIterator(j, **kw), tloader.BatchIterator(t, **kw)
    calls = []
    inner = t.features_batch
    t.features_batch = lambda *a: calls.append(1) or inner(*a)
    for epoch in (0, 1):
        jb, tb = list(ji.epoch(epoch)), list(ti.epoch(epoch))
        assert len(tb) == len(jb) == 3
        for a, b in zip(jb, tb):
            _same(a._asdict(), b._asdict())
            want = np.float16 if layout == "packed_f16" else np.float32
            assert all(x.dtype == want for x in b.feats.values())
    assert len(calls) == 6   # asked once a batch; answered on packs only
    if not fast:
        assert inner(np.asarray([0]), FRAMES) is None


def test_packed_fast_path_equals_per_video_reads(files):
    """The fast path's float32 batches are bitwise the per-video reads of
    the same packed files (``features_batch`` hidden)."""
    _, t = _both(files, "packed")
    kw = dict(batch_size=5, seq_per_img=2, max_frames=FRAMES, seed=1)
    fast = list(tloader.BatchIterator(t, **kw).epoch(0))
    t.features_batch = lambda *a: None
    slow = list(tloader.BatchIterator(t, **kw).epoch(0))
    for a, b in zip(fast, slow):
        _same(a._asdict(), b._asdict())


# --------------------------------------------------------- build_dataset

def _h5_cfgs(files, layout="packed"):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_preset("msrvtt_resnet_c3d_xe")
        cfg.data.vocab_file = files["paths"]["vocab"]
        cfg.data.label_file = os.path.join(
            os.path.dirname(files["paths"]["labels_train"]),
            "labels_{split}.h5")
        cfg.data.feature_files = _layouts(files)[layout]
        out.append(cfg)
    return out


@pytest.mark.parametrize("kind", ["stored", "json", "npy"])
def test_build_dataset_and_consensus_file(files, tmp_path, kind):
    jc, tc = _h5_cfgs(files)
    if kind == "json":
        path = str(tmp_path / "cons.json")
        with open(path, "w") as f:
            json.dump({f"video{i}": [float(i + 1)] * 3 for i in range(12)},
                      f)
    elif kind == "npy":
        path = str(tmp_path / "cons.npy")
        np.save(path, np.arange(36, dtype=np.float32) / 7)
    if kind != "stored":
        jc.data.consensus_file = tc.data.consensus_file = path
    for split in ("train", "test"):
        jds, jv = jbuild.build_dataset(jc, split)
        tds, tv = tbuild.build_dataset(tc, split)
        assert tv.idx_to_word == jv.idx_to_word
        assert isinstance(tds, tdatasets.H5Dataset)
        overridden = kind != "stored" and split == "train"
        assert (tds._weight_override is not None) == overridden
        for i in range(len(tds)):
            _same(jds.caption_weights(i), tds.caption_weights(i))
        if overridden and kind == "json":
            np.testing.assert_array_equal(tds.caption_weights(2), [3.0] * 3)


# --------------------------------------------------- tools/pack_features

@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_pack_features_tool_writes_the_reference_bytes(files, tmp_path,
                                                       dtype):
    from cst_captioning_tpu.tools.pack_features import (
        pack_from_h5 as jax_pack,
    )
    from cst_captioning_torch.tools.pack_features import main

    label = files["paths"]["labels_train"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pack(label, files["h5"], jdir, FRAMES - 2, dtype)
    main(["--label-file", label, "--out-dir", tdir, "--max-frames",
          str(FRAMES - 2), "--dtype", dtype, "--features"]
         + [f"{m}={p}" for m, p in files["h5"].items()])
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 4
    for n in names:
        with open(os.path.join(jdir, n), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, n), "rb") as f:
            assert f.read() == want, n
    vocab = Vocabulary.load(files["paths"]["vocab"])
    ds = tdatasets.H5Dataset(label, {m: tdir for m in DIMS}, vocab)
    assert ds.features_batch(np.asarray([0, 1]), FRAMES - 2) is not None
