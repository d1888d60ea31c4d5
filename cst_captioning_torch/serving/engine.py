"""Warm-model inference engine for online caption serving (port of the
JAX package's ``serving/engine.py``).

Holds the model on its device once and serves two schedulers:

* the batch-at-a-time ladder (``serving.continuous = false``):
  ``decode_prepared`` decodes a coalesced batch padded up to the
  smallest ladder shape that fits (``serving.batch_shapes``; padding
  rows replicate row 0).  The encode and the static gate rows go
  through the row-invariant ``row_dot`` and the decode kernels compute
  each row in a fixed order, so padding cannot change a live row's
  tokens.  Beam mode decodes
  through ``decoding/beam.py`` (the ``lstm_beam`` kernel, or
  ``attlstm_beam`` under attention fusion), greedy mode through
  ``CaptionModel.sample`` (``lstm_sample`` or ``attlstm_sample``);
* the continuous slot loop (``serving.continuous = true``, the
  default): ``slot_decoder`` is the engine's persistent
  ``serving/slots.py::SlotDecoder``, fed by ``encode_prepared_rows``
  (the admission encode) and finished by ``result_from_tokens``.

Per-request preprocessing is the reference's: ``subsample_frames`` +
zero-pad + mask, and the tier-1 cache key is its content hash under the
same ``params_tag``.

Serving dtypes (``serving.dtype``, reference ``model_from_config``):
``f32`` serves the model as configured, ``bf16`` forces the bfloat16
compute dtype, ``int8w`` also quantizes the large weights to int8 codes
with per-channel float32 scales (``ops/quant.py``), once at boot per
``serving.quant_calibration`` unless the tree given already carries
codes.  Both schedulers then run the int8w kernels: the ladder the
``quant=`` decoders, the slot loop the int8 ``row_dot``.  A non-f32
dtype joins the tier-1 cache tag, as in the reference.

Not ported yet, refused with ``NotImplementedError`` (ROADMAP.md
Queue 1): replicas, model sharding, speculative decode, AOT artifacts,
orbax checkpoints and the tier-2 encoder-row cache.  ``serving.replicas
= 0`` (the presets' "every local device") serves one engine on the one
device it is given.  Weights come from ``random_init`` or from a JAX
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
    SERVING_DTYPES,
    CaptionModel,
    DecodeCache,
    model_from_config,
    not_ported,
)
from cst_captioning_torch.models.weights import load_params, params_to_state_dict
from cst_captioning_torch.ops.quant import is_quantized, quantize_params
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
    if int(sv.replicas) > 1:
        raise not_ported(f"serving.replicas={sv.replicas}",
                         "Queue 1, item 7 (multi-GPU: replicas)")
    if int(sv.model_shards or 1) > 1:
        raise not_ported(f"serving.model_shards={sv.model_shards}",
                         "Queue 1, item 7 (multi-GPU)")
    if str(sv.dtype or "f32") not in SERVING_DTYPES:
        raise ValueError(f"unknown serving.dtype {sv.dtype!r}; expected one "
                         f"of {SERVING_DTYPES}")
    if sv.speculative:
        raise not_ported("serving.speculative",
                         "Queue 1, item 6 (serving extensions)")
    if m.feature_fusion not in ("meanpool", "attention"):
        raise ValueError(f"unknown feature_fusion {m.feature_fusion!r}")
    if m.num_layers != 1:
        raise not_ported(f"num_layers={m.num_layers}",
                         "Queue 1, item 4 (model completion)")
    if m.use_category:
        raise not_ported("use_category", "Queue 1, item 4 (model completion)")
    if checkpoint:
        raise not_ported("orbax --checkpoint restore",
                         "Queue 1, item 4 (orbax checkpoint loader)")


class InferenceEngine:
    """See module doc.  ``decode_prepared`` is called from the single
    batcher thread; ``prepare`` and the cache are safe from any number
    of front-end threads.

    ``params``: a JAX ``{"params": {...}}`` tree of numpy arrays, or a
    port state dict, float or (for ``int8w``) already quantized;
    ``random_init``: fresh float weights from ``train.seed``.
    ``device``: ``cuda`` unless the caller passes ``"cpu"``."""

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
        self.serving_dtype = str(sv.dtype or "f32")
        model = model_from_config(cfg, serving_dtype=self.serving_dtype,
                                  device="cpu")
        if params is None:
            if not random_init:
                raise ValueError(
                    "InferenceEngine needs `params` or random_init=True")
            params = self._random_params()
        if self.serving_dtype == "int8w" and not is_quantized(params):
            # Once, at boot; a tree that already carries codes keeps them
            # (re-quantizing would round twice).
            params = quantize_params(params_to_state_dict(params),
                                     str(sv.quant_calibration or "absmax"))
        load_params(model, params)
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
        self._slot_decoder = None
        # Everything that changes decoded tokens goes into the tier-1
        # key tag (the reference's tag, so keys agree across packages).
        self.params_tag = (
            f"{cfg.name}|{checkpoint or 'params'}|v{params_version}|"
            f"{self.decode_mode}|K{cfg.eval.beam_size}|"
            f"L{cfg.eval.max_decode_len}|ln{cfg.eval.length_normalize}"
        )
        if self.serving_dtype != "f32":
            # Low precision can move tokens: the dtype keys the cache.
            self.params_tag += f"|dt{self.serving_dtype}"
        if sv.warmup:
            self.warmup()

    # ------------------------------------------------------------ plumbing
    def _resolve_vocab(self, vocab: Optional[Vocabulary]) -> Vocabulary:
        if vocab is not None:
            return vocab
        if self.cfg.data.vocab_file:
            return Vocabulary.load(self.cfg.data.vocab_file)
        raise ValueError("no vocabulary: pass `vocab` or set data.vocab_file")

    def _random_params(self) -> Dict[str, torch.Tensor]:
        """Load-test / smoke weights (noise captions): a float state dict
        with the reference's initializer distributions from
        ``train.seed``, whatever the serving dtype (int8w quantizes it
        like any float tree)."""
        model = model_from_config(self.cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(self.cfg.train.seed))
        return model.state_dict()

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
        tier-2 encoder-row cache, which is not ported yet."""
        d = self.cfg.data
        raw = payload.get("features")
        if raw is None:
            raise ValueError(
                "request needs `features` (feature_id-only requests are "
                "not ported yet: ROADMAP.md Queue 1, item 5)")
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
        """Decode one batch at every ladder shape and, in continuous
        mode, run each slot bank once, so the first request pays neither
        a kernel build nor first-launch costs."""
        t0 = time.perf_counter()
        for B in self.ladder:
            self.decode_prepared([self.template_prepared()] * B, store=False)
        if self.cfg.serving.continuous:
            self.slot_decoder().warmup()
        _log.info("serving engine warm: ladder %s%s in %.1fs", self.ladder,
                  " + slot loop" if self.cfg.serving.continuous else "",
                  time.perf_counter() - t0)

    # ------------------------------------------- continuous-mode helpers
    def encode_prepared_rows(self, reqs: Sequence[PreparedRequest]) -> DecodeCache:
        """The slot loop's admission encode: (B, ...) projected encoder
        rows for B = len(reqs) requests (the loop pads the batch to a
        bucket itself), through ``CaptionModel.init_decode``, the encode
        the offline per-step paths run."""
        mods = self.cfg.data.feature_modalities
        feats = {m: torch.from_numpy(np.stack([r.feats[m] for r in reqs]))
                 .to(self.device) for m in mods}
        masks = {m: torch.from_numpy(np.stack([r.masks[m] for r in reqs]))
                 .to(self.device) for m in mods}
        return self.model.init_decode(feats, masks)[1]

    def result_from_tokens(self, req: PreparedRequest, tokens: np.ndarray,
                           timings_ms: Dict[str, float],
                           store: bool = True) -> DecodedResult:
        """Detokenize one decoded row and store it in tier 1: the
        per-caption tail of ``decode_prepared``, shared with the slot
        loop's harvest."""
        caption = decode_sequence(self.vocab, np.asarray(tokens)[None])[0]
        res = DecodedResult(caption=caption,
                            tokens=[int(t) for t in tokens],
                            timings_ms=timings_ms)
        if store and req.cache_key:
            self.cache.captions.put(
                req.cache_key, {"caption": res.caption, "tokens": res.tokens})
        return res

    def slot_decoder(self):
        """The engine's persistent ``serving/slots.py::SlotDecoder``
        (continuous in-flight batching), built at first use."""
        if self._slot_decoder is None:
            from cst_captioning_torch.serving.slots import SlotDecoder

            self._slot_decoder = SlotDecoder(self)
        return self._slot_decoder

    # ----------------------------------------------------------- info
    def param_bytes_per_shard(self) -> int:
        """Resident weight bytes of this (one-device) engine, measured off
        the live parameters: int8 codes count one byte an element."""
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

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
            "continuous": bool(self.cfg.serving.continuous),
            "num_slots": int(self.cfg.serving.num_slots or self.max_batch),
            "dedup_cache": bool(self.cfg.serving.dedup_cache),
            "slot_bank_min": int(self.cfg.serving.slot_bank_min),
            "modalities": {m: self.cfg.data.feature_dims[m]
                           for m in self.cfg.data.feature_modalities},
            "max_frames": self.cfg.data.max_frames,
            "vocab_size": len(self.vocab),
            "backend": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
            "serving_dtype": self.serving_dtype,
            "param_bytes_per_shard": self.param_bytes_per_shard(),
            "build": self.fingerprint(),
        }
