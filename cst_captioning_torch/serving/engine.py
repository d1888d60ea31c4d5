"""Warm-model inference engine for online caption serving, batch-at-a-
time ladder path (port of the JAX package's ``serving/engine.py`` with
``serving.continuous = false``).

Holds the model on its device once, and exposes a synchronous
``decode_prepared`` the micro-batcher calls with a coalesced batch.
Every served batch is padded up to the smallest ladder shape that fits
(``serving.batch_shapes``); padding rows replicate row 0, and every
decode op is row-independent, so padding cannot change a live row's
tokens.  Beam mode decodes through ``decoding/beam.py`` (the
``lstm_beam`` kernel, or ``attlstm_beam`` under attention fusion),
greedy mode through ``CaptionModel.sample`` (``lstm_sample`` or
``attlstm_sample``).  Per-request preprocessing is the reference's:
``subsample_frames`` + zero-pad + mask, and the tier-1 cache key is its
content hash under the same ``params_tag``.

Not ported yet, refused with ``NotImplementedError`` (ROADMAP.md
Queue 1): the continuous slot loop, replicas, model sharding,
low-precision serving dtypes, speculative decode, AOT artifacts and
orbax checkpoints.  Weights come from ``random_init`` or from a JAX
parameter tree / state dict through the weight bridge.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.loader import subsample_frames
from cst_captioning_torch.data.vocab import Vocabulary, decode_sequence
from cst_captioning_torch.decoding.beam import beam_search
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    model_from_config,
    not_ported,
)
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.serving.cache import TwoTierCache, content_key

_log = logging.getLogger("cst_captioning_torch.serving")


class PreparedRequest(NamedTuple):
    """A validated, preprocessed request row (host numpy)."""

    feats: Dict[str, np.ndarray]   # m -> (F, D_m) float32
    masks: Dict[str, np.ndarray]   # m -> (F,) float32
    cache_key: str                 # tier-1 caption key


class DecodedResult(NamedTuple):
    caption: str
    tokens: List[int]
    timings_ms: Dict[str, float]


def _default_ladder(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def check_ported(cfg: Config, checkpoint: str = "") -> None:
    """Refuse the configurations this slice does not serve."""
    sv, m = cfg.serving, cfg.model
    if sv.continuous:
        raise not_ported("serving.continuous=true (the slot loop)",
                         "Queue 1, item 3 (continuous serving); pass --serving.continuous false")
    if int(sv.replicas) > 1:
        raise not_ported(f"serving.replicas={sv.replicas}",
                         "Queue 1, item 7 (multi-GPU: replicas)")
    if int(sv.model_shards or 1) > 1:
        raise not_ported(f"serving.model_shards={sv.model_shards}",
                         "Queue 1, item 7 (multi-GPU)")
    if str(sv.dtype or "f32") != "f32":
        raise not_ported(f"serving.dtype={sv.dtype}",
                         "Queue 1, item 6 (serving extensions)")
    if sv.speculative:
        raise not_ported("serving.speculative",
                         "Queue 1, item 6 (serving extensions)")
    if m.feature_fusion not in ("meanpool", "attention"):
        raise ValueError(f"unknown feature_fusion {m.feature_fusion!r}")
    if m.num_layers != 1:
        raise not_ported(f"num_layers={m.num_layers}",
                         "Queue 1, item 5 (model completion)")
    if m.use_category:
        raise not_ported("use_category", "Queue 1, item 5 (model completion)")
    if checkpoint:
        raise not_ported("orbax --checkpoint restore",
                         "Queue 1, item 5 (orbax checkpoint loader)")


class InferenceEngine:
    """See module doc.  ``decode_prepared`` is called from the single
    batcher thread; ``prepare`` and the cache are safe from any number
    of front-end threads.

    ``params``: a JAX ``{"params": {...}}`` tree of numpy arrays, or a
    port state dict; ``random_init``: fresh weights from
    ``train.seed``.  ``device``: ``cuda`` unless the caller passes
    ``"cpu"``."""

    def __init__(
        self,
        cfg: Config,
        params: Optional[Mapping[str, Any]] = None,
        checkpoint: str = "",
        vocab: Optional[Vocabulary] = None,
        cache: Optional[TwoTierCache] = None,
        params_version: str = "0",
        random_init: bool = False,
        device=None,
    ):
        check_ported(cfg, checkpoint)
        self.device = resolve_device(device)
        self.cfg = cfg
        sv = cfg.serving
        self.vocab = self._resolve_vocab(vocab)
        if cfg.model.vocab_size == 0:
            cfg.model.vocab_size = len(self.vocab)
        self.serving_dtype = "f32"
        model = model_from_config(cfg, device="cpu")
        if params is not None:
            load_params(model, params)
        elif random_init:
            self._init_random(model)
        else:
            raise ValueError(
                "InferenceEngine needs `params` or random_init=True")
        # Serving never trains: the weights are frozen explicitly.
        self.model: CaptionModel = model.to(self.device).requires_grad_(False)
        self.decode_mode = sv.decode_mode
        if self.decode_mode not in ("beam", "greedy"):
            raise ValueError(f"unknown decode_mode {self.decode_mode!r}")
        self.max_batch = sv.max_batch_size or cfg.data.batch_size
        ladder = sorted(set(sv.batch_shapes or _default_ladder(self.max_batch)))
        if ladder[-1] != self.max_batch:
            raise ValueError(
                f"serving.batch_shapes top {ladder[-1]} != max_batch_size "
                f"{self.max_batch} — the coalescer would build unservable "
                "batches")
        self.ladder = ladder
        self.cache = cache or TwoTierCache(sv.caption_cache_size)
        # Everything that changes decoded tokens goes into the tier-1
        # key tag (the reference's tag, so keys agree across packages).
        self.params_tag = (
            f"{cfg.name}|{checkpoint or 'params'}|v{params_version}|"
            f"{self.decode_mode}|K{cfg.eval.beam_size}|"
            f"L{cfg.eval.max_decode_len}|ln{cfg.eval.length_normalize}"
        )
        if sv.warmup:
            self.warmup()

    # ------------------------------------------------------------ plumbing
    def _resolve_vocab(self, vocab: Optional[Vocabulary]) -> Vocabulary:
        if vocab is not None:
            return vocab
        if self.cfg.data.vocab_file:
            return Vocabulary.load(self.cfg.data.vocab_file)
        raise ValueError("no vocabulary: pass `vocab` or set data.vocab_file")

    def _init_random(self, model: CaptionModel) -> None:
        """Load-test / smoke weights (noise captions): the reference's
        initializer distributions from ``train.seed``."""
        model.init_weights(torch.Generator().manual_seed(self.cfg.train.seed))

    def bucket(self, n: int) -> int:
        for b in self.ladder:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the ladder top {self.ladder[-1]}")

    # ------------------------------------------------------- request prep
    def prepare(self, payload: Dict[str, Any]) -> PreparedRequest:
        """Validate + preprocess one request payload ``{"features":
        {modality: (F_m, D_m) array-like}}``.  Raises ``ValueError`` on
        bad input (HTTP 400).  Requests that name a cached
        ``feature_id`` instead of sending features need the reference's
        tier-2 cache, which comes with the continuous slot loop."""
        d = self.cfg.data
        raw = payload.get("features")
        if raw is None:
            raise ValueError(
                "request needs `features` (feature_id-only requests are "
                "not ported yet: ROADMAP.md Queue 1, item 3)")
        missing = [m for m in d.feature_modalities if m not in raw]
        if missing:
            raise ValueError(f"missing feature modalities: {missing}")
        F = d.max_frames
        feats: Dict[str, np.ndarray] = {}
        masks: Dict[str, np.ndarray] = {}
        for m in d.feature_modalities:
            a = np.asarray(raw[m], np.float32)
            if a.ndim == 1:
                a = a[None, :]
            dim = d.feature_dims[m]
            if a.ndim != 2 or a.shape[-1] != dim:
                raise ValueError(
                    f"modality {m!r}: expected (frames, {dim}), got {a.shape}")
            if a.shape[0] == 0:
                raise ValueError(f"modality {m!r}: zero frames")
            a = subsample_frames(a, F)
            row = np.zeros((F, dim), np.float32)
            row[: a.shape[0]] = a
            mask = np.zeros((F,), np.float32)
            mask[: a.shape[0]] = 1.0
            feats[m] = row
            masks[m] = mask
        hash_input = dict(feats)
        hash_input.update({f"__mask_{m}": v for m, v in masks.items()})
        return PreparedRequest(feats=feats, masks=masks,
                               cache_key=content_key(hash_input, self.params_tag))

    def lookup_caption(self, key: str) -> Optional[Dict[str, Any]]:
        """Tier-1 probe (content hash -> finished result)."""
        return self.cache.captions.get(key)

    # --------------------------------------------------------------- decode
    def _assemble(self, reqs: Sequence[PreparedRequest], B: int) -> Tuple[Dict, Dict]:
        """Stack request rows into a padded (B, ...) batch on the
        device; padding rows replicate row 0."""
        idx = list(range(len(reqs))) + [0] * (B - len(reqs))
        mods = self.cfg.data.feature_modalities
        feats = {m: torch.from_numpy(np.stack([reqs[i].feats[m] for i in idx]))
                 .to(self.device) for m in mods}
        masks = {m: torch.from_numpy(np.stack([reqs[i].masks[m] for i in idx]))
                 .to(self.device) for m in mods}
        return feats, masks

    def _decode(self, feats, masks) -> torch.Tensor:
        ev = self.cfg.eval
        if self.decode_mode == "beam":
            return beam_search(
                self.model, feats, masks, beam_size=ev.beam_size,
                max_len=ev.max_decode_len,
                length_normalize=ev.length_normalize).tokens
        return self.model.sample(feats, masks, max_len=ev.max_decode_len,
                                 greedy=True).tokens

    def decode_prepared(self, reqs: Sequence[PreparedRequest],
                        store: bool = True) -> List[DecodedResult]:
        """Decode one coalesced batch (the batcher's unit of work)."""
        if not reqs:
            return []
        n = len(reqs)
        B = self.bucket(n)
        t0 = time.perf_counter()
        feats, masks = self._assemble(reqs, B)
        t_pad = time.perf_counter()
        tokens = self._decode(feats, masks).cpu().numpy()[:n]
        t_dev = time.perf_counter()
        captions = decode_sequence(self.vocab, tokens)
        t_detok = time.perf_counter()
        timings = {
            "pad_ms": (t_pad - t0) * 1e3,
            "device_ms": (t_dev - t_pad) * 1e3,
            "detok_ms": (t_detok - t_dev) * 1e3,
        }
        out = []
        for i, r in enumerate(reqs):
            res = DecodedResult(caption=captions[i],
                                tokens=[int(t) for t in tokens[i]],
                                timings_ms=timings)
            if store and r.cache_key:
                self.cache.captions.put(
                    r.cache_key, {"caption": res.caption, "tokens": res.tokens})
            out.append(res)
        return out

    def template_prepared(self) -> PreparedRequest:
        """A valid all-zeros request row (warmup traffic)."""
        d = self.cfg.data
        return PreparedRequest(
            feats={m: np.zeros((d.max_frames, d.feature_dims[m]), np.float32)
                   for m in d.feature_modalities},
            masks={m: np.concatenate([np.ones((1,), np.float32),
                                      np.zeros((d.max_frames - 1,), np.float32)])
                   for m in d.feature_modalities},
            cache_key="")

    def warmup(self) -> None:
        """Decode one batch at every ladder shape, so the first request
        pays neither the kernel build nor first-launch costs."""
        t0 = time.perf_counter()
        for B in self.ladder:
            self.decode_prepared([self.template_prepared()] * B, store=False)
        _log.info("serving engine warm: ladder %s in %.1fs", self.ladder,
                  time.perf_counter() - t0)

    # ----------------------------------------------------------- info
    def fingerprint(self) -> Dict[str, Any]:
        from cst_captioning_torch import __version__

        return {
            "params_tag": self.params_tag,
            "preset": self.cfg.name,
            "version": __version__,
            "serving_dtype": self.serving_dtype,
            "device": str(self.device),
        }

    def describe(self) -> Dict[str, Any]:
        dev = self.device
        return {
            "model": self.cfg.name,
            "decode_mode": self.decode_mode,
            "beam_size": self.cfg.eval.beam_size,
            "max_decode_len": self.cfg.eval.max_decode_len,
            "batch_ladder": self.ladder,
            "continuous": False,
            "modalities": {m: self.cfg.data.feature_dims[m]
                           for m in self.cfg.data.feature_modalities},
            "max_frames": self.cfg.data.max_frames,
            "vocab_size": len(self.vocab),
            "backend": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
            "build": self.fingerprint(),
        }
