"""Evaluation (port of the JAX package's ``evaluation.py``):
decode a split once, load cocofmt ground truth, run the metric suite;
and the reference's ``test.py`` path, :func:`evaluate_dataset`: beam
decode the split through the fused ``lstm_beam`` kernel
(``attlstm_beam`` under attention fusion), write the cocofmt
predictions json, score it, write the scores json.  On the card unless
the caller asks for the CPU, where the kernels take their plain
versions."""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.datasets import CaptionDataset
from cst_captioning_torch.data.loader import BatchIterator, to_device
from cst_captioning_torch.data.vocab import decode_sequence
from cst_captioning_torch.decoding.beam import beam_backend, make_beam_search_fn
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.metrics.evaluator import language_eval

log = logging.getLogger("cst_captioning_torch.eval")


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
            log.warning(
                "cocofmt ground truth covers %d/%d predicted videos — "
                "scoring the covered subset only", len(matched), len(preds))
        gts = matched
    res = {vid: [preds[vid]] for vid in gts}
    return language_eval(gts, res, metrics=metrics)


def _eval_device(model, device) -> torch.device:
    """The device the evaluation runs on (``cuda`` unless the caller
    passes ``"cpu"``), which must be the model's."""
    want = resolve_device(device)
    have = model.device
    if have.type != want.type or (want.index is not None
                                  and have.index != want.index):
        raise ValueError(f"the model is on {have}, the evaluation on "
                         f"{want}: build the model on the evaluation's "
                         "device")
    return have


def beam_decode_dataset(model, ds: CaptionDataset, cfg: Config,
                        device=None) -> Dict[str, str]:
    """Beam-decode every video once -> {video_id: caption}, one fused
    beam call per batch of ``data.batch_size`` videos."""
    device = _eval_device(model, device)
    log.info("beam decode backend: %s", beam_backend(model))
    beam_fn = make_beam_search_fn(
        model, beam_size=cfg.eval.beam_size, max_len=cfg.eval.max_decode_len,
        length_normalize=cfg.eval.length_normalize)

    def decode(feats, feat_masks, category):
        return beam_fn(feats, feat_masks, category).tokens

    return decode_dataset(ds, cfg, decode, model.use_category, device)


def evaluate_dataset(model, ds: CaptionDataset, cfg: Config,
                     out_dir: Optional[str] = None, device=None
                     ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Full eval: beam decode + metric suite (+ json artifacts).

    Returns (scores, predictions).  Ground truth comes from
    ``data.cocofmt_files[eval.eval_split]`` when that is set, else from
    the dataset's references.  When ``out_dir`` is set, writes
    ``predictions.json`` (cocofmt results: a list of {"image_id",
    "caption"}) and ``scores.json``, as the reference writes them."""
    preds = beam_decode_dataset(model, ds, cfg, device)
    cocofmt = cfg.data.cocofmt_files.get(cfg.eval.eval_split, "")
    scores = score_predictions(
        ds, preds, cfg.eval.metrics,
        gts=load_cocofmt_gt(cocofmt) if cocofmt else None)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "predictions.json"), "w") as f:
            json.dump([{"image_id": vid, "caption": c}
                       for vid, c in preds.items()], f, indent=2)
        with open(os.path.join(out_dir, "scores.json"), "w") as f:
            json.dump(scores, f, indent=2)
    return scores, preds
