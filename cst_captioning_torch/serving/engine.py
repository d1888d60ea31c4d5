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
zero-pad + mask (and under ``use_category`` the request's ``category``,
0 by default), and the tier-1 cache key is its content hash under the
same ``params_tag`` (the category joins the hash as ``__category``).

The tier-2 cache (``serving/cache.py``, ``serving.feature_cache_size``
entries and ``feature_cache_bytes`` bytes) keeps a request's
preprocessed rows under its ``feature_id``, and, once the slot loop has
encoded it, its encoder rows on the host.  A later request naming only
the id skips the upload and the preprocessing; in the slot loop it also
admits with no encode (``encode_prepared_rows``; ``admit_rows_cached``
/ ``admit_rows_encoded`` count both paths).  The ladder always takes the
fused decoders, the reference's branch where its fused beam is engaged:
it decodes a hit from the stored preprocessed rows and stores no encoder
rows.  As in the reference, a request that sends features under an id
already cached keeps that entry's encoder rows (it does not compare the
content keys).

Serving dtypes (``serving.dtype``, reference ``model_from_config``):
``f32`` serves the model as configured, ``bf16`` forces the bfloat16
compute dtype, ``int8w`` also quantizes the large weights to int8 codes
with per-channel float32 scales (``ops/quant.py``), once at boot per
``serving.quant_calibration`` unless the tree given already carries
codes.  Both schedulers then run the int8w kernels: the ladder the
``quant=`` decoders, the slot loop the int8 ``row_dot``.  A non-f32
dtype joins the tier-1 cache tag, as in the reference.

Weights come from a ``checkpoint`` directory of the port
(``params.pt``: a training checkpoint, or a params-only one such as
``tools/import_jax_checkpoint`` writes from a JAX-trained model), from
``random_init``, or from a JAX parameter tree / state dict through the
weight bridge, loaded strictly (``models/weights.py::load_params``).
An orbax directory is refused with the commands that convert it.

Replicas (``serving/replicas.py``): ``clone_for_device`` makes a
data-parallel replica of a loaded engine, with its own slot decoder and
CUDA stream, the shared two-tier cache and the same ``params_tag``.  On
the engine's own device a clone shares the parameter tensors (the int8w
codes too): nothing is copied or requantized.

Speculative decode (``serving.speculative``, greedy only,
``decoding/speculative.py``): the engine builds the draft tree once at
boot (``draft_params``), from the ``.npz`` that
``serving.speculative.draft_params`` names or by truncating the loaded
weights (dequantized first under int8w), and keeps it on its device; a
clone moves it to the replica's.  A draft that fails to build or load
fails the boot.  The slot loop then runs propose / verify rounds.  Fault
injection (``serving.chaos``) lives in the schedulers and the
autoscaler (``serving.autoscale``) in the server.

Serving artifacts (``serving/artifact.py``): ``cli/build_artifact.py``
publishes an engine as a versioned directory holding its params, its
vocabulary and the built kernel libraries of its serving paths
(:meth:`InferenceEngine.serving_kernels`); :meth:`InferenceEngine.
from_artifact` boots a replica from it with no ``nvcc`` run, refusing
any drift of the environment, the sources or the ladder field by field.
``fingerprint()['artifact_version']`` names the version an engine (or
the engine it was cloned from) booted from, ``"warm"`` otherwise.

Model-sharded serving (``serving.model_shards`` M > 1, reference
``engine.py``'s model-shards block): one logical engine spans a (1, M)
submesh (``parallel/mesh.py``) of ``devices`` (default the host's
cards), its vocab-sized leaves split over the M devices
(``CaptionModel.shard_vocab``), the rest and the slot state on the
first.  The slot loop's per-step selection merges the shards' top-K
candidates (``decoding/core.py::make_tp_beam_topk`` /
``make_tp_row_pick``; ``serving.shard_fused_decode = false`` gathers the
full logits instead), the ladder runs the sharded decoders
(``ops/shard_decode.py``) where ``model_from_config``'s gates engage
them.  ``serving.replicas`` x M must fit the devices (``replicas = 0``:
one sharded replica per M devices); ``ReplicaSet.from_engine`` clones
the (R, M) grid with :meth:`InferenceEngine.clone_for_submesh`, and
``clone_for_device`` refuses a sharded engine.  ``fingerprint()``
reports the engine's real mesh shape.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cst_captioning_torch.config import Config
from cst_captioning_torch.data.loader import subsample_frames
from cst_captioning_torch.data.vocab import Vocabulary, decode_sequence
from cst_captioning_torch.decoding.beam import beam_search
from cst_captioning_torch.decoding.speculative import (
    draft_to_device,
    load_draft_params,
    make_draft_params,
    spec_config,
)
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.models.captioner import (
    SERVING_DTYPES,
    CaptionModel,
    DecodeCache,
    model_from_config,
)
from cst_captioning_torch.models.weights import load_params, params_to_state_dict
from cst_captioning_torch.ops.quant import is_quantized, quantize_params
from cst_captioning_torch.serving.cache import TwoTierCache, content_key
from cst_captioning_torch.training.checkpoint import load_params_file

_log = logging.getLogger("cst_captioning_torch.serving")


class PreparedRequest(NamedTuple):
    """A validated, preprocessed request row (host memory)."""

    feats: Dict[str, np.ndarray]   # m -> (F, D_m) float32
    masks: Dict[str, np.ndarray]   # m -> (F,) float32
    cache_key: str                 # tier-1 caption key
    category: int = 0              # category id (used under use_category)
    feature_id: Optional[str] = None
    # Tier-2 encoder rows: one CPU row per DecodeCache field (None where
    # the field is), or None until the slot loop has encoded the id.
    enc_row: Optional[Tuple[Optional[torch.Tensor], ...]] = None


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


def check_ported(cfg: Config) -> None:
    """Refuse a serving configuration the engine cannot build."""
    sv, m = cfg.serving, cfg.model
    if int(sv.model_shards or 1) < 1:
        raise ValueError(f"serving.model_shards={sv.model_shards} < 1")
    if str(sv.dtype or "f32") not in SERVING_DTYPES:
        raise ValueError(f"unknown serving.dtype {sv.dtype!r}; expected one "
                         f"of {SERVING_DTYPES}")
    if m.feature_fusion not in ("meanpool", "attention"):
        raise ValueError(f"unknown feature_fusion {m.feature_fusion!r}")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device: a card without an index is the
    current card (``cuda`` and ``cuda:0`` are one device on card 0)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a == b
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def _model_on(model: CaptionModel, dev: torch.device) -> CaptionModel:
    """A copy of ``model`` whose parameters and buffers are copied to
    ``dev`` once, directly; the weight cache of ``_kernel_weights`` is
    left out (the copy rebuilds it on ``dev``)."""
    memo: Dict[int, Any] = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(dev),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = b.to(dev)
    for k in ("_kw", "_kw_layers", "_kw_cat", "_kw_key"):
        v = getattr(model, k, None)
        if v is not None:
            memo[id(v)] = None
    return copy.deepcopy(model, memo)


class InferenceEngine:
    """See module doc.  ``decode_prepared`` is called from the single
    batcher thread; ``prepare`` and the cache are safe from any number
    of front-end threads.

    ``params``: a JAX ``{"params": {...}}`` tree of numpy arrays, or a
    port state dict, float or (for ``int8w``) already quantized;
    ``checkpoint``: a port checkpoint directory (its ``params.pt``, float
    or quantized); ``random_init``: fresh float weights from
    ``train.seed``.
    ``device``: ``cuda`` unless the caller passes ``"cpu"``; ``devices``:
    the device list of a model-sharded engine (``serving.model_shards``
    > 1; a device may repeat), its first M devices this engine's submesh
    (``submesh=True``: a grid replica's own M devices, validated by the
    engine it was cloned from)."""

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
        devices=None,
        submesh: bool = False,
    ):
        check_ported(cfg)
        self.cfg = cfg
        sv = cfg.serving
        self.grid_devices = None
        self.tp_mesh = self._tp_mesh(sv, device, devices, submesh)
        if self.tp_mesh is not None:
            device = self.tp_mesh.lead
        elif device is None and devices:
            device = list(devices)[0]
        self.device = resolve_device(device)
        self.vocab = self._resolve_vocab(vocab)
        if cfg.model.vocab_size == 0:
            cfg.model.vocab_size = len(self.vocab)
        self.serving_dtype = str(sv.dtype or "f32")
        model = model_from_config(cfg, serving_dtype=self.serving_dtype,
                                  device="cpu", mesh=self.tp_mesh)
        if params is None:
            if checkpoint:
                params = load_params_file(checkpoint)
            elif random_init:
                params = self._random_params()
            else:
                raise ValueError(
                    "InferenceEngine needs `params`, a `checkpoint` path, "
                    "or random_init=True")
        if self.serving_dtype == "int8w" and not is_quantized(params):
            # Once, at boot; a tree that already carries codes keeps them
            # (re-quantizing would round twice).
            params = quantize_params(params_to_state_dict(params),
                                     str(sv.quant_calibration or "absmax"))
        load_params(model, params)
        # Serving never trains: the weights are frozen explicitly.
        self.model: CaptionModel = model.to(self.device).requires_grad_(False)
        if self.tp_mesh is not None:
            M = self.tp_mesh.shape["model"]
            if cfg.model.vocab_size % M == 0:
                self.model.shard_vocab(self.tp_mesh.model_row(0))
                self.model.vshards.requires_grad_(False)
            else:
                _log.warning(
                    "vocab %d does not split over the %d-way model axis: "
                    "the vocab leaves stay replicated on %s",
                    cfg.model.vocab_size, M, self.device)
        self.decode_mode = sv.decode_mode
        if self.decode_mode not in ("beam", "greedy"):
            raise ValueError(f"unknown decode_mode {self.decode_mode!r}")
        # Speculative decode: the draft tree, derived from the serving
        # weights (or the distilled .npz) once at boot.  It steers only
        # how many tokens a round accepts, never which, so it is not
        # part of params_tag.
        self.draft_params = None
        self.spec = spec = spec_config(sv)
        if spec is not None:
            if self.decode_mode != "greedy":
                raise ValueError(
                    "serving.speculative requires decode_mode='greedy' — the "
                    "rejection rule accepts against the model's greedy "
                    "stream, which beam search does not have")
            dp = (load_draft_params(spec.draft_params) if spec.draft_params
                  else make_draft_params(self.model.full_state_dict(),
                                         spec.draft_hidden))
            self.draft_params = draft_to_device(dp, self.device)
        self.max_batch = sv.max_batch_size or cfg.data.batch_size
        ladder = sorted(set(sv.batch_shapes or _default_ladder(self.max_batch)))
        if ladder[-1] != self.max_batch:
            raise ValueError(
                f"serving.batch_shapes top {ladder[-1]} != max_batch_size "
                f"{self.max_batch} — the coalescer would build unservable "
                "batches")
        self.ladder = ladder
        self.cache = cache or TwoTierCache(sv.caption_cache_size,
                                           sv.feature_cache_size,
                                           sv.feature_cache_bytes)
        self._slot_decoder = None
        # Admission-encode accounting (scheduler thread only): rows
        # admitted from tier-2 encoder rows vs rows that paid the encode.
        self.admit_rows_cached = 0
        self.admit_rows_encoded = 0
        # A replica's own stream and id (``clone_for_device``); this
        # engine's slot loop runs on the caller's current stream.
        self.stream = None
        self.replica_id: Optional[int] = None
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
        # Boot provenance: "warm", or the artifact version this engine
        # booted from (from_artifact; clones keep it).
        self.artifact_version = "warm"
        if sv.warmup:
            self.warmup()

    def _tp_mesh(self, sv, device, devices, submesh: bool):
        """The (1, M) submesh of a model-sharded engine (None for M = 1)
        with the reference's checks: at least M devices, and on the first
        engine of a grid ``replicas`` x M of them (``replicas = 0``: one
        replica per M devices), so a mis-sized grid fails at boot.  Keeps
        the device list in ``grid_devices`` for the grid's clones."""
        M = int(sv.model_shards or 1)
        if M <= 1:
            return None
        from cst_captioning_torch.parallel.mesh import (
            local_devices,
            make_mesh,
        )

        if devices is None:
            devices = [device] if device is not None else local_devices()
        devs = list(devices)
        if len(devs) < M:
            raise ValueError(f"serving.model_shards={M} needs that many "
                             f"devices, have {len(devs)}")
        if not submesh:
            n_rep = int(sv.replicas)
            if n_rep == 0:
                n_rep = max(1, len(devs) // M)
            if n_rep < 0 or n_rep * M > len(devs):
                raise ValueError(
                    f"serving grid replicas={sv.replicas} x model_shards={M} "
                    f"needs {max(n_rep, 0) * M} local devices, have "
                    f"{len(devs)} — shrink an axis (replicas*model_shards "
                    "must fit the host)")
        self.grid_devices = devs
        return make_mesh({"data": 1, "model": M}, devices=devs[:M])

    @classmethod
    def from_artifact(cls, path: str, replica_id: Optional[int] = None,
                      device=None, devices=None) -> "InferenceEngine":
        """Boot a replica from a serving artifact (``serving/artifact.py``,
        a version directory or a root whose newest version is taken):
        the manifest checked field by field against the live environment,
        sources and ladder (``ArtifactMismatchError`` names every
        divergent field), the kernel libraries loaded from the artifact
        with no ``nvcc`` run, the params restored, the ladder walked
        once.  ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
        from cst_captioning_torch.serving.artifact import load_engine

        return load_engine(path, engine_cls=cls, replica_id=replica_id,
                           device=device, devices=devices)

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
        {modality: (F_m, D_m) array-like}, "feature_id": str?,
        "category": int?}`` (reference ``prepare``).  ``features`` may be
        left out when ``feature_id`` names a cached request (a tier-2
        hit: its stored rows, category, tier-1 key and encoder rows come
        back).  A request with features and an id stores them under the
        id.  ``category`` defaults to 0 and matters only under
        ``use_category``, where it must lie in ``[0,
        data.num_categories)`` (the reference's gather would clamp it
        silently).  Raises ``ValueError`` on bad input (HTTP 400) and
        ``KeyError`` for an id that is not cached (HTTP 404)."""
        d = self.cfg.data
        fid = payload.get("feature_id")
        category = int(payload.get("category", 0) or 0)
        raw = payload.get("features")
        if raw is None:
            if not fid:
                raise ValueError("request needs `features` or `feature_id`")
            entry = self.cache.features.get(fid)
            if entry is None:
                raise KeyError(
                    f"feature_id {fid!r} not cached — resend `features`")
            return PreparedRequest(
                feats=entry["feats"], masks=entry["masks"],
                cache_key=entry["cache_key"], category=entry["category"],
                feature_id=fid, enc_row=entry.get("enc"))
        missing = [m for m in d.feature_modalities if m not in raw]
        if missing:
            raise ValueError(f"missing feature modalities: {missing}")
        if self.model.use_category and not (
                0 <= category < self.model.num_categories):
            raise ValueError(
                f"category {category} out of range [0, "
                f"{self.model.num_categories})")
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
        if self.model.use_category:
            hash_input["__category"] = np.float32([category])
        key = content_key(hash_input, self.params_tag)
        enc = None
        if fid:
            # The reference's behaviour, kept: an id already cached keeps
            # its encoder rows, whatever features come with it.
            entry = self.cache.features.get(fid)
            if entry is not None:
                enc = entry.get("enc")
            self.cache.features.put(fid, {
                "feats": feats, "masks": masks, "category": category,
                "cache_key": key, "enc": enc})
        return PreparedRequest(feats=feats, masks=masks, cache_key=key,
                               category=category, feature_id=fid,
                               enc_row=enc)

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

    def _categories(self, reqs: Sequence[PreparedRequest], B: int
                    ) -> Optional[torch.Tensor]:
        """The (B,) category ids of ``_assemble``'s batch (padding rows
        replicate row 0), None without ``use_category``."""
        if not self.model.use_category:
            return None
        idx = list(range(len(reqs))) + [0] * (B - len(reqs))
        return torch.tensor([reqs[i].category for i in idx],
                            dtype=torch.int64).to(self.device)

    def _decode(self, feats, masks, category=None) -> torch.Tensor:
        ev = self.cfg.eval
        if self.decode_mode == "beam":
            return beam_search(
                self.model, feats, masks, category, beam_size=ev.beam_size,
                max_len=ev.max_decode_len,
                length_normalize=ev.length_normalize).tokens
        return self.model.sample(feats, masks, category,
                                 max_len=ev.max_decode_len,
                                 greedy=True).tokens

    def decode_prepared(self, reqs: Sequence[PreparedRequest],
                        store: bool = True) -> List[DecodedResult]:
        """Decode one coalesced batch (the batcher's unit of work) from
        its preprocessed rows: a tier-2 hit brings the stored ones, and
        encoder rows are neither read nor stored here (see module doc)."""
        if not reqs:
            return []
        n = len(reqs)
        B = self.bucket(n)
        t0 = time.perf_counter()
        feats, masks = self._assemble(reqs, B)
        cat = self._categories(reqs, B)
        t_pad = time.perf_counter()
        tokens = self._decode(feats, masks, cat).cpu().numpy()[:n]
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
    def _encode_rows(self, reqs: Sequence[PreparedRequest]) -> DecodeCache:
        """Encoder rows of ``reqs`` through ``CaptionModel.init_decode``
        (the encode of the offline per-step paths, on ``row_dot``), stored
        in tier 2 for the requests with a ``feature_id``."""
        n = len(reqs)
        cache = self.model.init_decode(*self._assemble(reqs, n),
                                       self._categories(reqs, n))[1]
        self._store_enc_rows(reqs, cache)
        return cache

    def _store_enc_rows(self, reqs: Sequence[PreparedRequest],
                        cache: DecodeCache) -> None:
        """Keep each ``feature_id`` request's encoder rows in its tier-2
        entry (reference ``_store_enc_rows``): the batch is copied to the
        host once, and each row is cloned so an entry holds exactly the
        bytes it counts."""
        host = None
        for i, r in enumerate(reqs):
            if not r.feature_id or r.enc_row is not None:
                continue
            if host is None:
                host = tuple(None if f is None else f.cpu() for f in cache)
            entry = self.cache.features.get(r.feature_id)
            if entry is not None:
                entry = dict(entry)
                entry["enc"] = tuple(None if f is None else f[i].clone()
                                     for f in host)
                self.cache.features.put(r.feature_id, entry)

    def _rows_to_device(self, rows: Sequence[Tuple]) -> DecodeCache:
        """Stack host encoder rows into a (len(rows), ...) DecodeCache on
        the engine's device.  On a card the stack lands in pinned memory
        and is copied asynchronously on the current stream (the replica's
        under ``SlotDecoder``); the caching host allocator keeps the
        pinned block until that copy has run."""
        out = []
        for f in range(len(rows[0])):
            if rows[0][f] is None:
                out.append(None)
                continue
            parts = [r[f] for r in rows]
            if self.device.type != "cuda":
                out.append(torch.stack(parts))
                continue
            buf = torch.empty((len(parts),) + tuple(parts[0].shape),
                              dtype=parts[0].dtype, pin_memory=True)
            torch.stack(parts, out=buf)
            out.append(buf.to(self.device, non_blocking=True))
        return DecodeCache(*out)

    def encode_prepared_rows(self, reqs: Sequence[PreparedRequest]) -> DecodeCache:
        """The slot loop's admission encode (reference
        ``encode_prepared_rows``): (B, ...) encoder rows for B =
        len(reqs) requests (the loop pads the batch to a bucket itself).
        Tier-2 hits contribute their stored rows with no encode; only the
        misses run ``init_decode``, padded to a power-of-two bucket by
        replicating the last miss, and the rows are spliced back in
        request order.  The tier is shared across replicas, so a row
        encoded by any replica admits on every other with no encode."""
        miss = [i for i, r in enumerate(reqs) if r.enc_row is None]
        self.admit_rows_cached += len(reqs) - len(miss)
        self.admit_rows_encoded += len(miss)
        if not miss:
            return self._rows_to_device([r.enc_row for r in reqs])
        if len(miss) == len(reqs):
            return self._encode_rows(reqs)
        bm = 1
        while bm < len(miss):
            bm *= 2
        subset = [reqs[i] for i in miss]
        fresh = self._encode_rows(subset + [subset[-1]] * (bm - len(miss)))
        hit = [i for i, r in enumerate(reqs) if r.enc_row is not None]
        cached = self._rows_to_device([reqs[i].enc_row for i in hit])
        miss_ix = torch.tensor(miss, device=self.device)
        hit_ix = torch.tensor(hit, device=self.device)
        out = []
        for f_new, f_hit in zip(fresh, cached):
            if f_new is None:
                out.append(None)
                continue
            x = f_new.new_empty((len(reqs),) + tuple(f_new.shape[1:]))
            x[miss_ix] = f_new[: len(miss)]
            x[hit_ix] = f_hit
            out.append(x)
        return DecodeCache(*out)

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

    def clone_for_device(self, device, replica_id: Optional[int] = None
                         ) -> "InferenceEngine":
        """A data-parallel replica of this engine on ``device`` (reference
        ``clone_for_device``): the same weights, vocabulary, shared
        two-tier cache and ``params_tag``, but its own slot decoder,
        admission counters and, on a card, its own CUDA stream.  On this
        engine's device the clone shares the parameter tensors (and int8w
        codes) with it: nothing is copied or requantized.  On another
        device the parameters are copied there once.  Copying bytes
        cannot change a token, so which replica decodes a request cannot
        either.  The clone keeps ``artifact_version`` (and the kernels an
        artifact boot loaded).  Under ``serving.warmup`` the clone warms
        its ladder and slot loop after its identity is set.  A
        model-sharded engine spans its device group and refuses:
        :meth:`clone_for_submesh` makes its grid replicas."""
        if self.tp_mesh is not None:
            raise ValueError(
                "a model-sharded engine (serving.model_shards > 1) spans "
                "its device group and cannot be cloned per-device — "
                "replica scaling of sharded engines goes through "
                "clone_for_submesh (one (1, M) submesh per replica)")
        dev = resolve_device(device)
        eng = copy.copy(self)
        eng.cfg = copy.deepcopy(self.cfg)
        eng.device = dev
        eng.model = (self.model if _same_device(dev, self.device)
                     else _model_on(self.model, dev))
        # The bf16 copies of the weights the kernels read are cached on
        # the model at first use; fill that cache now, on this stream,
        # so replicas that share the model never race to build it.
        eng.model._kernel_weights()
        if self.draft_params is not None:
            eng.draft_params = {k: v.to(dev)
                                for k, v in self.draft_params.items()}
        eng.replica_id = replica_id
        eng._slot_decoder = None
        eng.admit_rows_cached = eng.admit_rows_encoded = 0
        eng.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        if eng.cfg.serving.warmup:
            eng.warmup()
        return eng

    def clone_for_submesh(self, devices, replica_id: Optional[int] = None
                          ) -> "InferenceEngine":
        """A model-sharded replica of this engine on its own (1, M)
        submesh of ``devices`` (reference ``clone_for_submesh``): the
        weights gathered to the host once and split again by the rule
        table onto the new devices (a layout move, never arithmetic, so
        no decoded token can change), the shared two-tier cache, the same
        ``params_tag`` and ``artifact_version``, its own slot decoder and,
        on a card, its own CUDA stream.  Under ``serving.warmup`` the
        clone warms after its identity is set."""
        if self.tp_mesh is None:
            raise ValueError(
                "clone_for_submesh needs a model-sharded engine "
                "(serving.model_shards > 1) — use clone_for_device for "
                "single-device replicas")
        M = self.tp_mesh.shape["model"]
        devices = list(devices)
        if len(devices) != M:
            raise ValueError(
                f"clone_for_submesh got {len(devices)} devices for a "
                f"{M}-way model-sharded engine — each replica submesh must "
                "hold exactly model_shards devices")
        cfg2 = copy.deepcopy(self.cfg)
        warm = cfg2.serving.warmup
        cfg2.serving.warmup = False
        eng = InferenceEngine(cfg2, params=self.model.full_state_dict(),
                              vocab=self.vocab, cache=self.cache,
                              devices=devices, submesh=True)
        eng.cfg.serving.warmup = warm
        eng.params_tag = self.params_tag
        eng.artifact_version = self.artifact_version
        if self.draft_params is not None:
            eng.draft_params = {k: v.to(eng.device)
                                for k, v in self.draft_params.items()}
        eng.replica_id = replica_id
        if eng.device.type == "cuda":
            eng.stream = torch.cuda.Stream(eng.device)
            torch.cuda.current_stream(eng.device).synchronize()
        if warm:
            eng.warmup()
        return eng

    def slot_decoder(self):
        """The engine's persistent ``serving/slots.py::SlotDecoder``
        (continuous in-flight batching), built at first use."""
        if self._slot_decoder is None:
            from cst_captioning_torch.serving.slots import SlotDecoder

            self._slot_decoder = SlotDecoder(self)
        return self._slot_decoder

    # ----------------------------------------------------------- info
    def param_bytes_per_shard(self) -> int:
        """Resident weight bytes on one shard of this engine, measured
        off the live parameters (a split vocab leaf counts its first
        shard): int8 codes count one byte an element."""
        n = sum(p.numel() * p.element_size()
                for p in self.model.parameters())
        vs = self.model.vshards
        if vs is not None:
            n += sum(xs[0].numel() * xs[0].element_size()
                     for xs in vs.leaves.values())
        return n

    def serving_kernels(self) -> List[str]:
        """The kernel libraries (``ops/_build.py::SOURCES`` names) this
        engine's serving paths launch on a card, warmup included:
        ``row_gemm`` always (every decode encode and per-step product);
        the ladder's whole-recurrence decoder, which warmup walks in
        either scheduler, on a single-layer model (``lstm_beam`` in beam
        mode, ``lstm_sample`` greedy; their ``attlstm_`` forms live in
        the same libraries, and bf16 / int8w use the same sources);
        ``context_attention`` under attention fusion wherever a step
        runs per step: the slot loop (``serving.continuous``, speculative
        rounds included) or a stack's ladder."""
        m = self.model
        names = {"row_gemm"}
        if m.num_layers == 1 and m.vshards is None:
            names.add("lstm_beam" if self.decode_mode == "beam"
                      else "lstm_sample")
        if m.fusion == "attention" and (bool(self.cfg.serving.continuous)
                                        or m.num_layers > 1):
            names.add("context_attention")
        return sorted(names)

    def _mesh_shape_str(self) -> str:
        """``"1x2"``-style mesh string when model-sharded, ``"1x1"``
        otherwise (the bench records' ``*_mesh_shape`` format)."""
        from cst_captioning_torch.parallel.partition import mesh_shape_str

        return mesh_shape_str(self.tp_mesh)

    def fingerprint(self) -> Dict[str, Any]:
        from cst_captioning_torch import __version__

        return {
            "params_tag": self.params_tag,
            "mesh_shape": self._mesh_shape_str(),
            "preset": self.cfg.name,
            "version": __version__,
            "serving_dtype": self.serving_dtype,
            "artifact_version": self.artifact_version,
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
