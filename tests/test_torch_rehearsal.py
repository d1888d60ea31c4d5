"""The port's ``tools/rehearsal.py`` against the JAX package's: the
fabricated corpus byte for byte and bitwise, the analytic MLE bound,
the memory route (no ``h5py``: labels in memory beside the packed store)
against the h5 route item by item and summary for summary, and the
reference's own cases mirrored on the port (CPU, tiny sizes)."""

import contextlib
import io
import json
import logging
import os
import sys

import h5py
import numpy as np
import pytest

from cst_captioning_tpu.tools import rehearsal as jreh
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.data.datasets import PackedDataset
from cst_captioning_torch.tools import rehearsal as treh
from cst_captioning_torch.tools.prepare_data import prepare, write_label_h5

DIMS = {"resnet": 24, "c3d": 16}
TINY = ["--videos", "16", "--epochs", "1", "--batch-size", "8",
        "--max-frames", "4", "--max-words", "8", "--beam-size", "2",
        "--cst-samples", "3", "--feature-dims", "resnet=16,c3d=8"]
SWEEP = ["--videos", "16", "--epochs", "1", "--batch-size", "8",
         "--max-frames", "4", "--max-words", "6", "--beam-size", "2",
         "--cst-samples", "2", "--feature-dims", "resnet=8,c3d=8",
         "--stages", "xe"]


def _main(argv):
    """(rc, summary, stdout) of the port's main on the CPU."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = treh.main(argv, device="cpu")
    out = buf.getvalue()
    return rc, json.loads(out.strip().splitlines()[-1]), out


def _hide_h5py(monkeypatch):
    # A None entry in sys.modules makes ``import h5py`` raise ImportError,
    # as on a host without it.
    monkeypatch.setitem(sys.modules, "h5py", None)


def _files(root, suffix):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(suffix))


@pytest.mark.parametrize("kw", [
    {},
    {"corpus_kind": "branch_trap"},
    {"scene_mix": 0.5},
    {"generic_refs": 0, "seed": 7},
], ids=["v2", "branch_trap", "scene_mix", "no_generic"])
def test_fabricate_equals_the_reference(tmp_path, kw):
    j = jreh.fabricate(str(tmp_path / "j"), 14, DIMS, **kw)
    t = treh.fabricate(str(tmp_path / "t"), 14, DIMS, **kw)
    with open(j["annotations"], "rb") as a, open(t["annotations"], "rb") as b:
        assert a.read() == b.read()
    for m in DIMS:
        with h5py.File(j[m], "r") as fj, h5py.File(t[m], "r") as ft:
            assert list(fj) == list(ft)
            for v in fj:
                a, b = fj[v][()], ft[v][()]
                assert a.dtype == b.dtype == np.float32
                assert a.shape == b.shape
                assert a.tobytes() == b.tobytes(), (m, v)


@pytest.mark.parametrize("corpus_kind", ["v2", "branch_trap"])
def test_fabricate_packed_is_the_pack_of_fabricate(tmp_path, corpus_kind):
    """The memory route's generator packs straight into the store the h5
    route packs from its feature h5s: the same bytes."""
    from cst_captioning_torch.data.packed import pack_modality

    kw = dict(seed=2, corpus_kind=corpus_kind, scene_mix=0.3)
    raw = treh.fabricate(str(tmp_path / "raw"), 12, DIMS, **kw)
    vids = [f"video{i}" for i in range(12)]
    for m in DIMS:
        with h5py.File(raw[m], "r") as f:
            pack_modality(str(tmp_path / "a"), m, vids,
                          (f[v][()] for v in vids), 6, DIMS[m],
                          dtype="float16")
    got = treh.fabricate_packed(str(tmp_path / "raw2"), str(tmp_path / "b"),
                                12, DIMS, 6, dtype="float16", **kw)
    with open(raw["annotations"], "rb") as a, open(got["annotations"],
                                                   "rb") as b:
        assert a.read() == b.read()
    for name in sorted(os.listdir(tmp_path / "a")):
        with open(tmp_path / "a" / name, "rb") as a, \
                open(tmp_path / "b" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        os.listdir(tmp_path / "b"))
    assert _files(str(tmp_path / "raw2"), ".h5") == []


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("corpus_kind", ["branch_trap", "v2"])
def test_analyze_mle_optimum_equals_the_reference(tmp_path, corpus_kind,
                                                  split):
    raw = treh.fabricate(str(tmp_path / "raw"), 40, {"resnet": 6},
                         corpus_kind=corpus_kind)
    prep = prepare(raw["annotations"], "msrvtt", str(tmp_path / "prep"),
                   label_h5=False)
    cons = prep[f"consensus_{split}"]
    got = treh.analyze_mle_optimum(raw["annotations"], cons, split=split)
    assert got == jreh.analyze_mle_optimum(raw["annotations"], cons,
                                           split=split)
    if corpus_kind == "branch_trap":
        assert (got["xe_greedy_optimum_cider"]
                < got["wxe_greedy_optimum_cider"]
                < got["target_greedy_optimum_cider"])
    # Without a consensus file both fall back to uniform weights.
    assert (treh.analyze_mle_optimum(raw["annotations"], "missing.json",
                                     split=split)
            == jreh.analyze_mle_optimum(raw["annotations"], "missing.json",
                                        split=split))


def _assert_same_split(a, b, max_frames):
    assert len(a) == len(b) > 0
    assert a.feature_dims == b.feature_dims
    assert a.vocab.idx_to_word == b.vocab.idx_to_word
    for i in range(len(a)):
        assert a.video_id(i) == b.video_id(i)
        np.testing.assert_array_equal(a.captions(i), b.captions(i))
        assert a.captions(i).dtype == b.captions(i).dtype
        wa, wb = a.caption_weights(i), b.caption_weights(i)
        assert wa.dtype == wb.dtype == np.float32
        assert wa.tobytes() == wb.tobytes()
        assert a.references(i) == b.references(i)
        assert a.category(i) == b.category(i)
        for m, x in a.features(i).items():
            assert x.tobytes() == b.features(i)[m].tobytes()
    idxs = np.arange(len(a))[::-1]
    fa, ma = a.features_batch(idxs, max_frames)
    fb, mb = b.features_batch(idxs, max_frames)
    for m in fa:
        assert fa[m].dtype == fb[m].dtype == np.float16
        assert fa[m].tobytes() == fb[m].tobytes()
        np.testing.assert_array_equal(ma[m], mb[m])


def test_memory_route_splits_equal_the_h5_route(tmp_path, monkeypatch):
    """Both routes' corpora and splits: every prep output but the label
    h5 byte for byte, the packed store byte for byte, and every split's
    ``PackedDataset`` equal to ``H5Dataset`` over the h5 route's files
    item by item."""
    argv = ["--corpus", "branch-trap", "--videos", "30", "--max-frames",
            "5", "--max-words", "14", "--feature-dims", "resnet=12,c3d=9"]
    ha = treh.parser().parse_args(["--out-dir", str(tmp_path / "h5")] + argv)
    prep_h5, route = treh.build_corpus(ha)
    assert route == "h5"
    cfg = get_preset("msrvtt_resnet_c3d_xe")
    cfg.data.feature_modalities = ["resnet", "c3d"]
    cfg.data.feature_files = {m: str(tmp_path / "h5" / "packed")
                              for m in ("resnet", "c3d")}
    cfg.data.vocab_file = prep_h5["vocab"]
    cfg.data.label_file = str(tmp_path / "h5" / "prep" / "labels_{split}.h5")
    cfg.data.consensus_file = str(tmp_path / "h5" / "prep"
                                  / "consensus_{split}.json")
    h5_splits = {s: build_dataset(cfg, s)[0] for s in ("train", "val", "test")}

    ma = treh.parser().parse_args(["--out-dir", str(tmp_path / "mem")] + argv)
    with monkeypatch.context() as mp:
        _hide_h5py(mp)
        prep_mem, route = treh.build_corpus(ma)
        mem = treh.memory_splits(
            str(tmp_path / "mem" / "raw" / "videodatainfo.json"), prep_mem,
            str(tmp_path / "mem" / "packed"), ["resnet", "c3d"], 14)
    assert route == "memory"
    assert sorted(prep_mem) == sorted(k for k in prep_h5
                                      if not k.startswith("labels_"))
    for k, path in prep_mem.items():
        with open(path, "rb") as a, open(prep_h5[k], "rb") as b:
            assert a.read() == b.read(), k
    for name in sorted(os.listdir(tmp_path / "h5" / "packed")):
        with open(tmp_path / "h5" / "packed" / name, "rb") as a, \
                open(tmp_path / "mem" / "packed" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert _files(str(tmp_path / "mem"), ".h5") == []

    # Compared with h5py back: the h5 splits read through it.
    assert sorted(mem) == ["test", "train", "val"]
    for s in mem:
        assert isinstance(mem[s], PackedDataset)
        _assert_same_split(h5_splits[s], mem[s], 5)
        h5_splits[s].close()


def test_split_labels_are_the_label_h5(tmp_path):
    """``prepare``'s label h5 holds exactly ``Annotations.labels``'
    arrays, so the memory route's labels are the h5 route's."""
    from cst_captioning_torch.tools.prepare_data import read_annotations

    raw = treh.fabricate(str(tmp_path / "raw"), 20, {"resnet": 6},
                         corpus_kind="branch_trap")
    prep = prepare(raw["annotations"], "msrvtt", str(tmp_path / "prep"),
                   max_words=10)
    ann = read_annotations(raw["annotations"], "msrvtt")
    for split in ("train", "val", "test"):
        lab = ann.labels(split, 10)
        write_label_h5(str(tmp_path / f"again_{split}.h5"), lab)
        with h5py.File(prep[f"labels_{split}"], "r") as f, \
                h5py.File(str(tmp_path / f"again_{split}.h5"), "r") as g:
            for key in ("captions", "cap_start", "cap_end", "weights",
                        "category", "video_ids"):
                assert f[key].dtype == g[key].dtype
                assert f[key][()].tobytes() == g[key][()].tobytes(), key
            for vid in lab.video_ids:
                assert list(f["refs"][vid][()]) == list(g["refs"][vid][()])
        assert lab.captions.dtype == np.int32
        assert lab.weights.dtype == np.float32


def test_routes_give_the_same_summary(tmp_path, monkeypatch, caplog):
    """The reference test's tiny arguments on both routes: the summaries
    equal key for key, and one log line names each route."""
    caplog.set_level(logging.INFO, logger="cst_captioning_torch.rehearsal")
    rc, h5_summary, _ = _main(["--out-dir", str(tmp_path / "h5")] + TINY)
    assert rc == 0
    _hide_h5py(monkeypatch)
    rc, mem_summary, _ = _main(["--out-dir", str(tmp_path / "mem")] + TINY)
    assert rc == 0
    assert mem_summary == h5_summary
    routes = [r.getMessage() for r in caplog.records
              if "data route" in r.getMessage()]
    assert len(routes) == 2
    assert routes[0].startswith("rehearsal data route: h5")
    assert routes[1].startswith("rehearsal data route: memory")
    assert _files(str(tmp_path / "mem"), ".h5") == []


def test_reuse_data_on_the_memory_route(tmp_path, monkeypatch):
    """A corpus built on the h5 route reruns with ``--reuse-data`` on a
    host without h5py (labels recomputed from the annotation json) and
    trains the same; a memory-built corpus reuses on the memory route
    even where h5py imports."""
    out = str(tmp_path / "m")
    rc, first, _ = _main(["--out-dir", out] + SWEEP)
    assert rc == 0
    with monkeypatch.context() as mp:
        _hide_h5py(mp)
        rc, again, _ = _main(["--out-dir", out] + SWEEP + ["--reuse-data",
                                                           "--run-name",
                                                           "again"])
    assert rc == 0
    assert again["stages"] == first["stages"]
    assert again["test_scores"] == first["test_scores"]

    mem = str(tmp_path / "mem")
    with monkeypatch.context() as mp:
        _hide_h5py(mp)
        assert _main(["--out-dir", mem] + SWEEP)[0] == 0
    with open(os.path.join(mem, "prep", "manifest.json")) as f:
        prep = json.load(f)["prep"]
    assert treh.data_route(prep) == "memory"
    rc, reused, _ = _main(["--out-dir", mem] + SWEEP + ["--reuse-data",
                                                        "--run-name", "b"])
    assert rc == 0 and reused["stages"] == first["stages"]
    assert _files(mem, ".h5") == []


# ------------------------------------------------- the reference's cases

def test_rehearsal_end_to_end(tmp_path):
    rc, summary, _ = _main(["--out-dir", str(tmp_path / "r")] + TINY)
    assert rc == 0
    assert summary["videos"] == 16
    for stage in ("xe", "wxe", "cst"):
        assert stage in summary["stages"]
        bc = summary["stages"][stage]["best_val_cider"]
        assert bc is not None and np.isfinite(bc)
    assert np.isfinite(summary["stages"]["cst"]["final_reward"])
    scores = summary["test_scores"]
    assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(scores)
    assert scores["METEOR_backend"] in ("java", "lite", "lite+syn")
    # artifacts on disk: packed store, prep outputs, staged checkpoints
    assert (tmp_path / "r" / "packed" / "resnet.npy").exists()
    assert (tmp_path / "r" / "prep" / "consensus_train.json").exists()
    assert (tmp_path / "r" / "checkpoints" / "rehearsal_cst").exists()
    # sweep-mode manifest written last (certifies prep+pack completed)
    assert (tmp_path / "r" / "prep" / "manifest.json").exists()
    # The reference's summary keys, exactly.
    assert sorted(summary) == sorted([
        "videos", "feature_dims", "run_name", "corpus_kind", "train_seed",
        "cst_overrides", "model_overrides", "scene_mix", "stages",
        "test_scores"])


def test_branch_trap_summary_carries_the_bound(tmp_path):
    rc, summary, _ = _main(["--out-dir", str(tmp_path / "b"), "--corpus",
                            "branch-trap"] + SWEEP)
    assert rc == 0 and summary["corpus_kind"] == "branch_trap"
    for split in ("val", "test"):
        assert summary[f"mle_optimum_{split}"] == jreh.analyze_mle_optimum(
            str(tmp_path / "b" / "raw" / "videodatainfo.json"),
            str(tmp_path / "b" / "prep" / f"consensus_{split}.json"),
            split=split)


class TestFabricate:
    def test_generic_block_and_consensus_structure(self, tmp_path):
        """The corpus-v2 invariants: generic refs are corpus-wide
        identical (idf ~ 0 by construction) and every video carries
        specific refs naming its topic."""
        raw = treh.fabricate(str(tmp_path / "c"), 12, {"resnet": 24},
                             seed=3, generic_refs=8)
        with open(raw["annotations"]) as f:
            ann = json.load(f)
        per_vid = {}
        for s in ann["sentences"]:
            per_vid.setdefault(s["video_id"], []).append(s["caption"])
        generic = " ".join(treh._GENERIC)
        for vid, caps in per_vid.items():
            assert caps.count(generic) == 8
            assert len(caps) == 20
            specific = [c for c in caps if c != generic]
            # modal caption is the generic one
            assert max(specific.count(c) for c in specific) < 8

    def test_scene_mix_perturbs_only_place_slice(self, tmp_path):
        """Turning mixing ON leaves noun/verb feature slices AND the
        annotations bit-identical to the unmixed corpus (all mix
        randomness on a separate rng), while re-scening some place
        slices."""
        a = treh.fabricate(str(tmp_path / "a2"), 6, {"resnet": 24}, seed=1)
        c = treh.fabricate(str(tmp_path / "c2"), 6, {"resnet": 24}, seed=1,
                           scene_mix=0.5)
        with open(a["annotations"]) as fa, open(c["annotations"]) as fc:
            assert json.load(fa) == json.load(fc)
        d = 24
        dn = dv = d // 3
        changed = 0
        with h5py.File(a["resnet"]) as fa, h5py.File(c["resnet"]) as fc:
            for k in fa:
                va, vc = fa[k][()], fc[k][()]
                np.testing.assert_array_equal(
                    va[:, : dn + dv], vc[:, : dn + dv]
                )
                changed += int(
                    not np.array_equal(va[:, dn + dv:], vc[:, dn + dv:])
                )
        assert changed > 0  # some videos actually got a second scene


class TestSweepManifest:
    def test_reuse_rejects_mismatched_corpus(self, tmp_path):
        out = str(tmp_path / "m")
        assert _main(["--out-dir", out] + SWEEP)[0] == 0
        with pytest.raises(ValueError, match="fresh --out-dir"):
            treh.main(["--out-dir", out] + SWEEP
                      + ["--reuse-data", "--generic-refs", "2"],
                      device="cpu")

    @pytest.mark.parametrize("h5", [True, False], ids=["h5", "memory"])
    def test_reuse_without_manifest_rejected(self, tmp_path, monkeypatch,
                                             h5):
        if not h5:
            _hide_h5py(monkeypatch)
        with pytest.raises(FileNotFoundError, match="manifest"):
            treh.main(["--out-dir", str(tmp_path / "nope")] + SWEEP
                      + ["--reuse-data"], device="cpu")


@pytest.mark.parametrize("case", ["not_packed", "counts", "missing_video"])
def test_packed_dataset_refusals(tmp_path, case):
    from cst_captioning_torch.data.packed import pack_modality
    from cst_captioning_torch.data.vocab import Vocabulary

    rng = np.random.RandomState(0)
    pack_modality(str(tmp_path / "p"), "resnet", ["a", "b"],
                  (rng.randn(3, 4).astype(np.float32) for _ in range(2)),
                  3, 4)
    caps = np.ones((4, 5), np.int32)
    kw = dict(vocab=Vocabulary(["x"]), video_ids=["a", "b"], captions=caps,
              cap_start=[0, 2], cap_end=[2, 4], references=[["x"], ["x"]],
              feature_dirs={"resnet": str(tmp_path / "p")})
    ds = PackedDataset(**kw)
    assert len(ds) == 2 and ds.category(1) == 0
    assert ds.caption_weights(1).tolist() == [1.0, 1.0]
    if case == "not_packed":
        kw["feature_dirs"] = {"resnet": str(tmp_path)}
        match = "packed directories only"
    elif case == "counts":
        kw["references"] = [["x"]]
        match = "video count"
    else:
        kw["video_ids"] = ["a", "zz"]
        match = "missing 1 of this split's videos"
    with pytest.raises(ValueError, match=match):
        PackedDataset(**kw)
