"""Evaluation helpers (port of the JAX package's ``evaluation.py``, the
part the training loop needs): decode a split once, load cocofmt
ground truth, run the metric suite.  The beam ``evaluate_dataset`` and
``cli/test.py`` are not ported yet (ROADMAP.md Queue 1, item 4)."""

from __future__ import annotations

import json
import logging
from typing import Dict, Optional

import numpy as np
import torch

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.datasets import CaptionDataset
from cst_captioning_torch.data.loader import BatchIterator, to_device
from cst_captioning_torch.data.vocab import decode_sequence
from cst_captioning_torch.metrics.evaluator import language_eval


def decode_dataset(
    ds: CaptionDataset,
    cfg: Config,
    decode_fn,
    use_category: bool,
    device,
    vocab=None,
) -> Dict[str, str]:
    """Decode every video once -> {video_id: caption}.

    ``decode_fn(feats, feat_masks, category|None) -> tokens (B, L)`` on
    ``device``.  Batching: seq_per_img=1, no shuffle; wrap-around
    duplicates collapse through the dict.  ``vocab`` decodes ids back to
    words — pass the training vocabulary; it defaults to ``ds.vocab``."""
    vocab = vocab or ds.vocab
    device = torch.device(device)
    it = BatchIterator(
        ds,
        batch_size=cfg.data.batch_size,
        seq_per_img=1,
        max_frames=cfg.data.max_frames,
        shuffle=False,
        drop_last=False,
    )
    preds: Dict[str, str] = {}
    for host in it.epoch(0):
        batch = to_device(host, device)
        tokens = decode_fn(batch.feats, batch.feat_masks,
                           batch.category if use_category else None)
        for vid, sent in zip(host.video_ids, decode_sequence(
                vocab, np.asarray(tokens.cpu()))):
            preds[vid] = sent
    return preds


def load_cocofmt_gt(path: str) -> Dict[str, list]:
    """cocofmt ground-truth json ({"annotations": [{"image_id",
    "caption"}]}) -> {vid: [refs]}."""
    with open(path) as f:
        raw = json.load(f)
    gts: Dict[str, list] = {}
    # Keyed off annotations only: an image without annotations must not
    # yield an empty reference list.
    for ann in raw["annotations"]:
        gts.setdefault(str(ann["image_id"]), []).append(ann["caption"])
    return gts


def score_predictions(
    ds: CaptionDataset,
    preds: Dict[str, str],
    metrics,
    gts: Optional[Dict[str, list]] = None,
) -> Dict[str, float]:
    """Run the metric suite; ground truth comes from ``gts`` (e.g. a
    cocofmt file via ``data.cocofmt_files``) or the dataset's
    references."""
    if gts is None:
        gts = {ds.video_id(i): ds.references(i) for i in range(len(ds))}
    else:
        matched = {vid: gts[vid] for vid in preds if vid in gts}
        if not matched:
            raise ValueError(
                "no overlap between predicted video ids and the cocofmt "
                f"ground truth (e.g. pred {next(iter(preds), '?')!r} vs gt "
                f"{next(iter(gts), '?')!r}) — id scheme mismatch?")
        if len(matched) < len(preds):
            logging.getLogger("cst_captioning_torch.eval").warning(
                "cocofmt ground truth covers %d/%d predicted videos — "
                "scoring the covered subset only", len(matched), len(preds))
        gts = matched
    res = {vid: [preds[vid]] for vid in gts}
    return language_eval(gts, res, metrics=metrics)
