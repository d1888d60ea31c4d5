"""Config -> dataset construction (the port's copy of the JAX package's
``data/build.py``).  Only ``data.dataset = "synthetic"`` builds here;
the h5 and packed readers are not ported (ROADMAP.md Queue 1, item 4)."""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.datasets import (
    CaptionDataset,
    H5Dataset,
    make_synthetic_dataset,
)
from cst_captioning_torch.data.vocab import Vocabulary


def load_consensus_weights(
    path: str, ds: CaptionDataset
) -> Dict[str, np.ndarray]:
    """Load per-caption consensus weights (the reference's precomputed WXE
    CIDEr scores, SURVEY.md §3.4) and key them by video id.

    Formats: ``.json`` — {video_id: [w, ...]}; ``.npy`` — one flat float
    array aligned with the dataset's caption rows in dataset order (the
    label-h5 ``captions`` layout written by ``tools/prepare_data.py``).
    """
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        out = {k: np.asarray(v, np.float32) for k, v in raw.items()}
        # Validate counts for every covered video — a short vector would
        # otherwise IndexError (or silently misalign) at caption-sampling
        # time deep inside the training loop.
        by_id = {ds.video_id(i): i for i in range(len(ds))}
        for vid, w in out.items():
            if vid in by_id:
                n = ds.captions(by_id[vid]).shape[0]
                if w.shape[0] != n:
                    raise ValueError(
                        f"consensus file {path}: video {vid!r} has "
                        f"{w.shape[0]} weights but {n} captions"
                    )
        return out
    flat = np.load(path).astype(np.float32)
    out: Dict[str, np.ndarray] = {}
    pos = 0
    for i in range(len(ds)):
        n = ds.captions(i).shape[0]
        out[ds.video_id(i)] = flat[pos : pos + n]
        pos += n
    if pos != flat.shape[0]:
        raise ValueError(
            f"consensus file {path} has {flat.shape[0]} weights but the "
            f"dataset's caption rows total {pos}"
        )
    return out


def build_dataset(
    cfg: Config, split: str, vocab: Optional[Vocabulary] = None
) -> Tuple[CaptionDataset, Vocabulary]:
    """Build one split.  ``data.dataset == "synthetic"`` generates the toy
    corpus (split names map to different seeds so train/val differ);
    otherwise ``data.label_file`` is a path template with a ``{split}``
    placeholder (as written by ``tools/prepare_data.py``) or a literal
    path, and ``data.feature_files`` maps modality -> feature h5.

    ``data.consensus_file`` (optional, train split only; ``{split}``
    template allowed) overrides the per-caption consensus weights used by
    WXE / the weighted CST reward."""
    d = cfg.data
    if d.dataset == "synthetic":
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        ds, vb = make_synthetic_dataset(
            num_videos=max(d.batch_size * 2, 16),
            feature_dims=dict(d.feature_dims),
            max_frames=d.max_frames,
            max_words=d.max_seq_len - 2,
            num_categories=d.num_categories if cfg.model.use_category else 0,
            seed=seed,
        )
        ds_out: CaptionDataset = ds
        vocab = vocab or vb
    else:
        if vocab is None:
            if not d.vocab_file:
                raise ValueError("data.vocab_file is required for h5 datasets")
            vocab = Vocabulary.load(d.vocab_file)
        label = d.label_file.format(split=split)
        ds_out = H5Dataset(label, dict(d.feature_files), vocab)
    if d.consensus_file and split == "train":
        ds_out.set_caption_weights(
            load_consensus_weights(
                d.consensus_file.format(split=split), ds_out
            )
        )
    return ds_out, vocab
