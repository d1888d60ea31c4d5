"""Offline data prep (port of the JAX package's ``tools/prepare_data.py``,
the pipeline's first step): raw annotations -> vocab, label h5, cocofmt
GT, CIDEr idf table, WXE consensus weights.

Per dataset it writes:
  1. vocab json (frequency threshold, UNK replacement);
  2. per-split label h5 (encoded caption id matrix + per-video index;
     ``split_labels`` computes its arrays, which a caller can also hold
     in memory, ``prepare(..., label_h5=False)``);
  3. per-split cocofmt GT jsons for coco-caption scoring;
  4. CIDEr document-frequency pickle for idf-mode reward scoring;
  5. per-caption consensus CIDEr weights for WXE (each GT caption scored
     with CIDEr-D against its sibling references).

The json and pickle outputs are byte for byte the JAX package's, the
label h5 dataset for dataset.  Only the label h5 needs ``h5py``, which is
imported when it is written.

Input formats:
  * ``msrvtt``: the MSR-VTT ``videodatainfo.json`` layout —
    {"videos": [{"video_id", "split", "category"...}],
     "sentences": [{"video_id", "caption"}]}.
  * ``simple``: {"splits": {split: [video_id...]},
     "captions": {video_id: [caption...]},
     "categories": {video_id: int}  (optional)} — covers MSVD/yt2t given
    any csv->json conversion.

Run: ``python -m cst_captioning_torch.tools.prepare_data --input X.json
--format msrvtt --out-dir data/msrvtt [--min-freq 3] [--max-words 30]``.
Feature h5s are produced by the author-distributed extractors and are
consumed as-is (H5Dataset schema: one (F, D) dataset per video id).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.metrics.cider import (
    ciderd_score_vec,
    compute_doc_freq,
    cook_refs_vec,
    precook,
    save_df,
)
from cst_captioning_torch.metrics.tokenizer import ptb_tokenize


def load_annotations(path: str, fmt: str) -> Tuple[
    Dict[str, List[str]], Dict[str, List[str]], Dict[str, int]
]:
    """-> (splits: split->video ids, captions: vid->raw strings,
    categories: vid->int)."""
    with open(path) as f:
        raw = json.load(f)
    if fmt == "msrvtt":
        splits: Dict[str, List[str]] = defaultdict(list)
        categories: Dict[str, int] = {}
        for v in raw["videos"]:
            # The real videodatainfo.json names the split "validate";
            # the framework's canonical name is "val" (label/cocofmt
            # file templates, pipeline best-checkpoint selection).
            split = v.get("split", "train")
            split = {"validate": "val"}.get(split, split)
            splits[split].append(v["video_id"])
            categories[v["video_id"]] = int(v.get("category", 0))
        captions: Dict[str, List[str]] = defaultdict(list)
        for s in raw["sentences"]:
            captions[s["video_id"]].append(s["caption"])
        return dict(splits), dict(captions), categories
    if fmt == "simple":
        return (
            raw["splits"],
            raw["captions"],
            {k: int(v) for k, v in raw.get("categories", {}).items()},
        )
    raise ValueError(f"unknown format {fmt!r}")


def consensus_weights(
    tokenized: Sequence[Sequence[str]],
    df=None,
    log_ref_len: float = None,
    normalize: bool = True,
) -> np.ndarray:
    """CIDEr-D of each caption vs its siblings (leave-one-out), the paper's
    WXE consensus score.  ``normalize`` rescales to mean 1.0 per video so
    WXE keeps the same overall loss scale as XE.

    ``df``/``log_ref_len``: CORPUS-level document frequencies (one
    document per video's reference set), as standard CIDEr uses and the
    reference's precomputed df pickle implies.  Falling back to
    per-video df (each sibling its own document) when omitted is kept
    for lone-video corpora only — per-video df INVERTS the weighting on
    corpora with a corpus-wide generic caption: within one video the
    generic block's n-grams look rare-ish (df = #generic of 20) and its
    members validate each other, so the generic refs get the HIGHEST
    weight, while under corpus df (df = every video) they get ~0.  The
    per-video df weights collapse val CIDEr on such a corpus by
    amplifying the generic caption WXE is meant to suppress.
    """
    # ``tokenized`` may be pre-cooked n-gram counters (from a caller that
    # already cooked the split for its df table) or raw token lists.
    cooked = [
        t if isinstance(t, dict) else precook(t) for t in tokenized
    ]
    n = len(cooked)
    if n < 2:
        return np.ones((n,), np.float32)
    if df is None:
        df = compute_doc_freq([[c] for c in cooked])
        log_ref_len = math.log(max(float(n), 2.0))
    # Each caption vectorized once as a reference, then scored against
    # its siblings' vectors: ``ciderd_score_cooked`` term for term.
    vecs = cook_refs_vec(cooked, df, log_ref_len)
    w = np.array(
        [
            ciderd_score_vec(cooked[i], vecs[:i] + vecs[i + 1 :], df,
                             log_ref_len)
            for i in range(n)
        ],
        np.float32,
    )
    if normalize:
        mean = float(w.mean())
        w = w / mean if mean > 1e-8 else np.ones_like(w)
    return w


class SplitLabels(NamedTuple):
    """One split's labels, the arrays the label h5 holds
    (``write_label_h5``; ``data/datasets.py::PackedDataset`` holds them
    in memory): ``captions`` (total, T+2) int32 caption rows,
    ``cap_start`` / ``cap_end`` (V,) int64 row ranges per video,
    ``weights`` (total,) float32 consensus weights, ``category`` (V,)
    int32, ``refs`` {video id: raw reference strings}."""

    video_ids: List[str]
    captions: np.ndarray
    cap_start: np.ndarray
    cap_end: np.ndarray
    weights: np.ndarray
    category: np.ndarray
    refs: Dict[str, List[str]]

    def video_weights(self, i: int) -> np.ndarray:
        return self.weights[self.cap_start[i]: self.cap_end[i]]


def split_labels(
    vids: Sequence[str],
    tokenized: Dict[str, List[List[str]]],
    captions: Dict[str, List[str]],
    categories: Dict[str, int],
    vocab: Vocabulary,
    max_words: int,
    weights: Optional[Dict[str, Sequence[float]]] = None,
) -> SplitLabels:
    """The labels of one split: encoded caption rows and consensus
    weights under the SPLIT's corpus document frequencies (one document
    per video's reference set) — the standard-CIDEr df the paper's
    consensus score implies.  For the train split this is the same
    corpus as the idf table.  ``weights``: the split's weights computed
    before ({video id: weights}, ``consensus_<split>.json`` as
    ``prepare`` wrote it), in place of computing them again."""
    vids = list(vids)
    encoded = [
        np.stack([vocab.encode(t, max_words) for t in tokenized[vid]])
        for vid in vids
    ]
    if weights is not None:
        weights = [np.asarray(weights[vid], np.float32) for vid in vids]
    else:
        # Cook each split once; consensus_weights accepts the cooked
        # counters directly.
        split_cooked = {
            vid: [precook(t) for t in tokenized[vid]] for vid in vids
        }
        split_df = compute_doc_freq(list(split_cooked.values()))
        split_log_ref = math.log(max(float(len(vids)), 2.0))
        weights = [
            consensus_weights(split_cooked[vid], df=split_df,
                              log_ref_len=split_log_ref)
            for vid in vids
        ]
    ends = np.cumsum([e.shape[0] for e in encoded]).astype(np.int64)
    return SplitLabels(
        video_ids=vids,
        captions=np.concatenate(encoded, axis=0),
        cap_start=ends - np.asarray([e.shape[0] for e in encoded], np.int64),
        cap_end=ends,
        weights=np.concatenate(weights, axis=0),
        category=np.asarray([categories.get(v, 0) for v in vids], np.int32),
        refs={vid: captions[vid] for vid in vids},
    )


def write_label_h5(path: str, labels: SplitLabels) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("captions", data=labels.captions)
        f.create_dataset("cap_start", data=labels.cap_start)
        f.create_dataset("cap_end", data=labels.cap_end)
        f.create_dataset("weights", data=labels.weights)
        f.create_dataset("category", data=labels.category)
        f.create_dataset(
            "video_ids",
            data=np.asarray([v.encode() for v in labels.video_ids]),
        )
        g = f.create_group("refs")
        for vid in labels.video_ids:
            g.create_dataset(
                vid, data=np.asarray([r.encode() for r in labels.refs[vid]])
            )


def write_cocofmt(path: str, video_ids: List[str],
                  refs: Dict[str, List[str]]) -> None:
    """coco-caption ground-truth json (reference "cocofmt" files)."""
    images = [{"id": vid} for vid in video_ids]
    annotations = []
    k = 0
    for vid in video_ids:
        for cap in refs[vid]:
            annotations.append({"image_id": vid, "caption": cap, "id": k})
            k += 1
    with open(path, "w") as f:
        json.dump(
            {
                "images": images,
                "annotations": annotations,
                "type": "captions",
                # The reference's description, so the files are equal.
                "info": {"description": "cst_captioning_tpu prep"},
                "licenses": [],
            },
            f,
        )


class Annotations(NamedTuple):
    """Annotations read for prep: splits, raw captions, categories,
    PTB-tokenized captions and the vocabulary built over the train
    split's."""

    splits: Dict[str, List[str]]
    captions: Dict[str, List[str]]
    categories: Dict[str, int]
    tokenized: Dict[str, List[List[str]]]
    vocab: Vocabulary

    def labels(self, split: str, max_words: int,
               weights=None) -> SplitLabels:
        return split_labels(self.splits[split], self.tokenized,
                            self.captions, self.categories, self.vocab,
                            max_words, weights)


def read_annotations(input_path: str, fmt: str,
                     min_freq: int = 1) -> Annotations:
    splits, captions, categories = load_annotations(input_path, fmt)
    missing = [
        vid
        for vids in splits.values()
        for vid in vids
        if not captions.get(vid)
    ]
    if missing:
        raise ValueError(
            f"{len(missing)} video(s) in the split lists have no captions "
            f"(first few: {missing[:5]}) — fix the annotations before prep"
        )

    tokenized: Dict[str, List[List[str]]] = {
        vid: [ptb_tokenize(c) for c in caps]
        for vid, caps in captions.items()
    }
    vocab = Vocabulary.build(
        (t for vid in splits.get("train", []) for t in tokenized[vid]),
        min_freq=min_freq,
    )
    return Annotations(splits, captions, categories, tokenized, vocab)


def prepare(
    input_path: str,
    fmt: str,
    out_dir: str,
    min_freq: int = 1,
    max_words: int = 30,
    label_h5: bool = True,
) -> Dict[str, str]:
    """Run the full prep pipeline; returns the paths written.  Without
    ``label_h5`` every output but the label h5s is written (a caller
    holding the labels in memory: ``Annotations.labels``)."""
    os.makedirs(out_dir, exist_ok=True)
    ann = read_annotations(input_path, fmt, min_freq)
    paths = {"vocab": os.path.join(out_dir, "vocab.json")}
    ann.vocab.save(paths["vocab"])

    # CIDEr idf table from the training references (reference idf pickle).
    train_gts = {
        vid: [" ".join(t) for t in ann.tokenized[vid]]
        for vid in ann.splits.get("train", [])
    }
    paths["idf"] = os.path.join(out_dir, "cider_idf.pkl")
    save_df(train_gts, paths["idf"])

    for split in ann.splits:
        labels = ann.labels(split, max_words)
        vids = labels.video_ids
        lab = os.path.join(out_dir, f"labels_{split}.h5")
        coco = os.path.join(out_dir, f"cocofmt_{split}.json")
        cons = os.path.join(out_dir, f"consensus_{split}.json")
        if label_h5:
            write_label_h5(lab, labels)
            paths[f"labels_{split}"] = lab
        write_cocofmt(coco, vids, labels.refs)
        # Standalone consensus-weight artifact (reference: precomputed WXE
        # CIDEr scores distributed separately) — consumable via
        # ``data.consensus_file`` without re-reading the label h5.
        with open(cons, "w") as f:
            json.dump({v: labels.video_weights(i).tolist()
                       for i, v in enumerate(vids)}, f)
        paths[f"cocofmt_{split}"] = coco
        paths[f"consensus_{split}"] = cons
    return paths


def main(argv=None):
    p = argparse.ArgumentParser("prepare_data")
    p.add_argument("--input", required=True)
    p.add_argument("--format", default="msrvtt", choices=["msrvtt", "simple"])
    p.add_argument("--out-dir", required=True)
    p.add_argument("--min-freq", type=int, default=1)
    p.add_argument("--max-words", type=int, default=30)
    a = p.parse_args(argv)
    paths = prepare(a.input, a.format, a.out_dir, a.min_freq, a.max_words)
    for k, v in sorted(paths.items()):
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
