"""The pipeline's first step in the port: ``tools/prepare_data.py`` and
``train.tensorboard_dir``, held against the JAX package.

Both ``prepare``s run on the same generated annotations, in both input
formats, with categories and rare words that the frequency threshold
replaces by UNK.  The json and pickle outputs must be equal byte for
byte; the label h5 dataset by dataset (names, dtypes, shapes, values and
attributes: h5py writes creation times, so the files' bytes differ).

``train.tensorboard_dir``: the port's ``Trainer`` writes its events
through ``torch.utils.tensorboard``; the reference's ``Trainer._tb_log``
writes the same history entries through ``tf.summary`` (it reads only
``self._tb``, so it runs on a stub).  Tags, steps and float32 values
must be equal.  Without ``tensorboard`` the port warns and trains on.
"""

import glob
import json
import logging
import os
import sys
import types

import h5py
import numpy as np
import pytest

from cst_captioning_tpu.tools import prepare_data as jprep
from cst_captioning_tpu.training.trainer import Trainer as JaxTrainer
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.tools import prepare_data as tprep
from cst_captioning_torch.training.trainer import Trainer

COMMON = ["a", "man", "woman", "is", "playing", "guitar", "cooking", "in",
          "the", "kitchen", "dog", "runs", "on", "grass", "people", "dance"]
RARE = ["zebra", "xylophone", "quasar", "ukulele", "yak"]


def _caption(rng):
    n = int(rng.randint(3, 12))
    words = [COMMON[int(rng.randint(len(COMMON)))] for _ in range(n)]
    if rng.rand() < 0.3:
        # A word seen once in the corpus: UNK at min_freq 2.
        words[int(rng.randint(n))] = (RARE[int(rng.randint(len(RARE)))]
                                      + str(rng.randint(10 ** 9)))
    text = " ".join(words)
    # Case and punctuation for the PTB tokenizer to strip.
    return (text.capitalize() + ("." if rng.rand() < 0.5 else " !")
            if rng.rand() < 0.5 else text)


def _annotations(fmt, seed):
    rng = np.random.RandomState(seed)
    splits = {"train": [f"video{i}" for i in range(10)],
              "val": [f"video{i}" for i in range(10, 14)],
              "test": [f"video{i}" for i in range(14, 17)]}
    caps = {v: [_caption(rng) for _ in range(int(rng.randint(2, 7)))]
            for vids in splits.values() for v in vids}
    cats = {v: int(rng.randint(20)) for vids in splits.values() for v in vids}
    if fmt == "simple":
        return {"splits": splits, "captions": caps, "categories": cats}
    name = {"train": "train", "val": "validate", "test": "test"}
    return {
        "videos": [{"video_id": v, "split": name[s], "category": cats[v]}
                   for s, vids in splits.items() for v in vids],
        "sentences": [{"video_id": v, "caption": c}
                      for v, cs in caps.items() for c in cs]}


def _h5_tree(path):
    """{name: (dtype, shape, values, attrs)} of every dataset and group."""
    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            out[name] = (str(obj.dtype), obj.shape, obj[()], attrs)
        else:
            out[name] = ("group", None, None, attrs)

    with h5py.File(path, "r") as f:
        out["/"] = ("group", None, None, dict(f.attrs))
        f.visititems(visit)
    return out


@pytest.mark.parametrize("fmt", ["msrvtt", "simple"])
@pytest.mark.parametrize("min_freq,max_words", [(1, 30), (2, 8)])
def test_prepare_outputs_equal_the_reference(tmp_path, fmt, min_freq,
                                             max_words):
    src = tmp_path / "ann.json"
    src.write_text(json.dumps(_annotations(fmt, seed=min_freq)))
    mine = tprep.prepare(str(src), fmt, str(tmp_path / "port"), min_freq,
                         max_words)
    ref = jprep.prepare(str(src), fmt, str(tmp_path / "jax"), min_freq,
                        max_words)
    assert {k: os.path.basename(v) for k, v in mine.items()} == \
        {k: os.path.basename(v) for k, v in ref.items()}
    assert {"labels_train", "labels_val", "labels_test"} <= set(mine)
    vocab = json.loads(open(mine["vocab"]).read())
    if min_freq > 1:
        # Rare words fell under the threshold and encode as UNK.
        assert not [w for w in vocab["words"] if w.rstrip("0123456789")
                    in RARE]
    for k in sorted(mine):
        if k.startswith("labels_"):
            a, b = _h5_tree(mine[k]), _h5_tree(ref[k])
            assert sorted(a) == sorted(b), k
            for name in a:
                da, sa, va, aa = a[name]
                db, sb, vb, ab = b[name]
                assert (da, sa, aa) == (db, sb, ab), (k, name)
                if va is not None:
                    np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            with open(mine[k], "rb") as f1, open(ref[k], "rb") as f2:
                assert f1.read() == f2.read(), k
    with h5py.File(mine["labels_train"], "r") as f:
        caps = f["captions"][()]
        assert caps.shape[1] == max_words + 2   # BOS ... EOS
        if min_freq > 1:
            assert (caps == 3).any()   # UNK_ID


def test_cli_writes_the_same_files(tmp_path, capsys):
    src = tmp_path / "ann.json"
    src.write_text(json.dumps(_annotations("msrvtt", seed=5)))
    tprep.main(["--input", str(src), "--format", "msrvtt", "--out-dir",
                str(tmp_path / "cli"), "--min-freq", "2"])
    printed = capsys.readouterr().out
    assert "labels_val: " in printed and "vocab: " in printed
    jprep.main(["--input", str(src), "--format", "msrvtt", "--out-dir",
                str(tmp_path / "ref"), "--min-freq", "2"])
    for name in ("vocab.json", "cider_idf.pkl", "cocofmt_val.json",
                 "consensus_train.json"):
        assert (tmp_path / "cli" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


@pytest.mark.parametrize("case", ["corpus_df", "per_video_df", "lone"])
def test_consensus_weights_equal_the_reference(case):
    rng = np.random.RandomState(11)
    toks = [_caption(rng).lower().split() for _ in range(6)]
    if case == "lone":
        toks = toks[:1]
    kw = {}
    if case == "corpus_df":
        df = jprep.compute_doc_freq([[jprep.precook(t)] for t in toks])
        kw = {"df": df, "log_ref_len": float(np.log(6.0))}
    a = tprep.consensus_weights(toks, **kw)
    b = jprep.consensus_weights(toks, **kw)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_missing_captions_and_bad_format_raise(tmp_path):
    ann = _annotations("simple", seed=3)
    ann["splits"]["val"].append("ghost")
    src = tmp_path / "ann.json"
    src.write_text(json.dumps(ann))
    with pytest.raises(ValueError, match="no captions"):
        tprep.prepare(str(src), "simple", str(tmp_path / "o"))
    with pytest.raises(ValueError, match="unknown format"):
        tprep.load_annotations(str(src), "csv")


# -------------------------------------------------------- tensorboard_dir

def _events(logdir):
    """[(tag, step, float32 value)] of every scalar in ``logdir``'s event
    files, read with TensorFlow's reader (simple values and tensors)."""
    import tensorflow as tf

    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.*"))):
        for ev in tf.compat.v1.train.summary_iterator(path):
            for v in ev.summary.value:
                val = (v.simple_value if v.HasField("simple_value")
                       else float(tf.make_ndarray(v.tensor)))
                out.append((v.tag, int(ev.step), np.float32(val)))
    return sorted(out)


def _fit(tmp_path, **train):
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.train.max_epochs = 2
    cfg.name = "tb_run"
    for k, v in train.items():
        setattr(cfg.train, k, v)
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    t = Trainer(cfg, tr, va, device="cpu")
    return t, t.fit()


def test_tensorboard_events_equal_the_reference(tmp_path):
    import tensorflow as tf

    tb = tmp_path / "tb"
    trainer, history = _fit(tmp_path, tensorboard_dir=str(tb))
    mine = _events(str(tb / "tb_run"))
    stub = types.SimpleNamespace(
        _tb=tf.summary.create_file_writer(str(tmp_path / "ref")))
    for epoch, entry in sorted(history.items(), key=lambda kv: int(kv[0])):
        JaxTrainer._tb_log(stub, int(epoch), entry)
    stub._tb.close()
    ref = _events(str(tmp_path / "ref"))
    assert mine == ref
    tags = {t for t, _, _ in mine}
    assert {"train/train_loss", "val/CIDEr"} <= tags, tags
    assert {s for _, s, _ in mine} == {0, 1}


def test_tensorboard_skips_non_finite_values(tmp_path):
    import tensorflow as tf

    trainer, _ = _fit(tmp_path, max_epochs=0,
                      tensorboard_dir=str(tmp_path / "tb"))
    entry = {"loss": 1.5, "bad": float("nan"), "inf": float("inf"),
             "steps": 3, "name": "x", "val": {"CIDEr": 0.25,
                                             "Bleu_4": float("nan")}}
    trainer._tb_log(4, entry)
    stub = types.SimpleNamespace(
        _tb=tf.summary.create_file_writer(str(tmp_path / "ref")))
    JaxTrainer._tb_log(stub, 4, entry)
    stub._tb.close()
    mine = _events(str(tmp_path / "tb" / "tb_run"))
    assert mine == _events(str(tmp_path / "ref"))
    assert [t for t, _, _ in mine] == ["train/loss", "train/steps",
                                       "val/CIDEr"]


def test_tensorboard_absent_warns_and_trains_on(tmp_path, monkeypatch,
                                                caplog):
    # A None entry in sys.modules makes the import raise ImportError, as
    # on a host without the tensorboard package.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING,
                         logger="cst_captioning_torch.trainer"):
        trainer, history = _fit(tmp_path, max_epochs=1,
                                tensorboard_dir=str(tmp_path / "tb"))
    assert any("tensorboard is not importable" in r.getMessage()
               for r in caplog.records)
    assert trainer._tb is None
    assert np.isfinite(history["0"]["train_loss"])
    assert not (tmp_path / "tb").exists()
