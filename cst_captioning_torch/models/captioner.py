"""Meanpool LSTM caption decoder (port of the JAX package's
``models/captioner.py::CaptionModel``, the meanpool single-layer
subset).

Parameters carry the reference's names (``CaptionModel.setup``), so a
``state_dict`` maps one-to-one onto the JAX ``{"params": ...}`` tree
(``models/weights.py``):

* ``word_embed`` (V, E); ``proj_<m>_w`` (D_m, E), ``proj_<m>_b`` (E,)
  per feature modality;
* ``lstm0_w`` (2E + H, 4H) stacking the rows [emb | ctx | hidden], gates
  i|f|g|o; ``lstm0_b`` (4H,);
* ``logit_w`` (H, V), ``logit_b`` (V,).

The parameters are trainable.  ``forward`` is the teacher-forced pass of
XE/WXE training (the reference ``__call__``'s fused meanpool branch):
input GEMMs batched over (rows, T), the recurrence in the
``lstm_recurrence`` kernel (``ops/lstm.py``), output dropout, float32
logits.  The port always takes that branch, whatever
``model.use_pallas_lstm`` says: it is the only teacher-forced path it
has.  Decoding goes through the fused kernels only (``ops/beam.py``,
``ops/sampler.py``): ``fused_beam`` for beam search, ``sample`` for
greedy / multinomial, both without autograd.  ``_step`` is the per-step
math the decode kernels fuse, kept for tests.  Not ported yet, and
refused with ``NotImplementedError``: attention fusion, category
embeddings, more than one LSTM layer, scheduled sampling.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.ops.beam import lstm_beam
from cst_captioning_torch.ops.lstm import lstm_recurrence
from cst_captioning_torch.ops.rnn import (
    LSTMWeights,
    dot_f32,
    lstm_bias_init,
    lstm_kernel_init,
    lstm_step,
)
from cst_captioning_torch.ops.sampler import lstm_sample

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SampleOutput(NamedTuple):
    tokens: torch.Tensor    # (B, L) int32 — sampled ids, PAD after the end
    logprobs: torch.Tensor  # (B, L) float32 — log p of each sampled token
    mask: torch.Tensor      # (B, L) float32 — 1 up to and including the end


class DecodeCache(NamedTuple):
    """Per-video tensors fixed across decode steps (meanpool)."""

    ctx_static: torch.Tensor  # (B, E) mean-pooled fused context


def _repeat_cache(cache: DecodeCache, repeat: int) -> DecodeCache:
    """Tile each per-video cache row ``repeat`` times (row i -> rows
    i*repeat..(i+1)*repeat-1): the seq_per_img fan-out after the feature
    projections, not before them (reference ``_repeat_cache``)."""
    if repeat <= 1:
        return cache
    return DecodeCache(*(x.repeat_interleave(repeat, dim=0) for x in cache))


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to cst_captioning_torch yet "
        f"(ROADMAP.md {item})"
    )


def _glorot(shape, gen: torch.Generator) -> torch.Tensor:
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return torch.rand(shape, generator=gen) * (2 * limit) - limit


class CaptionModel(nn.Module):
    """See module docstring.  Field semantics follow ``ModelConfig``."""

    def __init__(
        self,
        vocab_size: int,
        rnn_size: int = 512,
        embed_size: int = 512,
        modalities: Sequence[str] = ("resnet",),
        feature_dims: Sequence[int] = (2048,),
        compute_dtype: str = "bfloat16",
        decode_suppress_unk: bool = False,
        num_layers: int = 1,
        fusion: str = "meanpool",
        use_category: bool = False,
        drop_prob: float = 0.0,
        device=None,
    ):
        super().__init__()
        if fusion != "meanpool":
            raise not_ported(f"feature_fusion={fusion!r}",
                             "Queue 1, item 1 (attention fusion)")
        if num_layers != 1:
            raise not_ported(f"num_layers={num_layers}",
                             "Queue 1, item 5 (model completion)")
        if use_category:
            raise not_ported("use_category", "Queue 1, item 5 (model completion)")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.vocab_size = V = int(vocab_size)
        self.rnn_size = H = int(rnn_size)
        self.embed_size = E = int(embed_size)
        self.modalities = tuple(modalities)
        self.feature_dims = tuple(int(d) for d in feature_dims)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.decode_suppress_unk = bool(decode_suppress_unk)
        self.drop_prob = float(drop_prob)
        self.num_layers = 1
        self.fusion = "meanpool"
        self.use_category = False
        kw = dict(dtype=torch.float32, device=device)
        self.word_embed = nn.Parameter(torch.empty((V, E), **kw))
        for m, d in zip(self.modalities, self.feature_dims):
            setattr(self, f"proj_{m}_w", nn.Parameter(torch.empty((d, E), **kw)))
            setattr(self, f"proj_{m}_b", nn.Parameter(torch.empty((E,), **kw)))
        self.lstm0_w = nn.Parameter(torch.empty((2 * E + H, 4 * H), **kw))
        self.lstm0_b = nn.Parameter(torch.empty((4 * H,), **kw))
        self.logit_w = nn.Parameter(torch.empty((H, V), **kw))
        self.logit_b = nn.Parameter(torch.empty((V,), **kw))

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CaptionModel":
        """Fresh weights with the reference's initializer distributions
        (uniform ±0.1 embeddings, Glorot-uniform projections, the LSTM
        kernel/bias inits, zero biases), drawn from ``generator`` on the
        CPU — the streams differ from ``jax.random``'s."""
        E, H, V = self.embed_size, self.rnn_size, self.vocab_size
        g = generator
        self.word_embed.copy_(torch.rand((V, E), generator=g) * 0.2 - 0.1)
        for m, d in zip(self.modalities, self.feature_dims):
            getattr(self, f"proj_{m}_w").copy_(_glorot((d, E), g))
            getattr(self, f"proj_{m}_b").zero_()
        self.lstm0_w.copy_(lstm_kernel_init((2 * E + H, 4 * H), g))
        self.lstm0_b.copy_(lstm_bias_init((4 * H,)))
        self.logit_w.copy_(_glorot((H, V), g))
        self.logit_b.zero_()
        return self

    @property
    def device(self) -> torch.device:
        return self.word_embed.device

    # ---------------------------------------------------------- encoding
    def _encode(self, feats: Dict[str, torch.Tensor],
                feat_masks: Dict[str, torch.Tensor]) -> DecodeCache:
        """Project each modality to the embed dim, mean-pool its masked
        frames, average the modalities (reference ``_encode``, meanpool
        branch)."""
        cdt = self.compute_dtype
        means = []
        for m in self.modalities:
            v = (dot_f32(feats[m], getattr(self, f"proj_{m}_w"), cdt)
                 + getattr(self, f"proj_{m}_b").float()).to(cdt)
            fm = feat_masks[m].float()
            denom = torch.clamp(fm.sum(-1, keepdim=True), min=1.0)
            means.append((v.float() * fm[..., None]).sum(1) / denom)
        total = means[0]
        for x in means[1:]:
            total = total + x
        return DecodeCache(ctx_static=(total / len(means)).to(cdt))

    @torch.no_grad()
    def init_decode(self, feats, feat_masks) -> Tuple[Tuple[torch.Tensor, torch.Tensor], DecodeCache]:
        """(zero (h, c) state, per-video cache) — reference
        ``init_decode``."""
        cache = self._encode(feats, feat_masks)
        B = cache.ctx_static.shape[0]
        h = torch.zeros((1, B, self.rnn_size), dtype=self.compute_dtype,
                        device=self.device)
        c = torch.zeros((1, B, self.rnn_size), dtype=torch.float32,
                        device=self.device)
        return (h, c), cache

    # --------------------------------------------------------- step math
    @torch.no_grad()
    def _step(self, state, cache: DecodeCache, tokens: torch.Tensor):
        """One unfused decoder step: [emb | ctx | h] @ lstm0_w (reference
        ``_step``).  Returns ((h, c), top hidden)."""
        cdt = self.compute_dtype
        h, c = state
        emb = self.word_embed.to(cdt)[tokens]
        x = torch.cat([emb, cache.ctx_static.to(cdt)], dim=-1)
        h_new, c_new = lstm_step(LSTMWeights(self.lstm0_w, self.lstm0_b),
                                 x, h[0], c[0], compute_dtype=cdt)
        return (h_new[None], c_new[None]), h_new

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 vocab logits (reference ``_logits``)."""
        return (dot_f32(h, self.logit_w, self.compute_dtype)
                + self.logit_b.float())

    @staticmethod
    def mask_decode_logits(logits: torch.Tensor,
                           suppress_unk: bool = False) -> torch.Tensor:
        """The decode policy never emits PAD or BOS (and UNK under
        ``suppress_unk``)."""
        out = logits.clone()
        out[..., PAD_ID] = -1e30
        out[..., BOS_ID] = -1e30
        if suppress_unk:
            out[..., UNK_ID] = -1e30
        return out

    # ------------------------------------------------------------ forward
    def forward(self, feats: Dict[str, torch.Tensor],
                feat_masks: Dict[str, torch.Tensor],
                input_ids: torch.Tensor, *, ss_prob: float = 0.0,
                generator: Optional[torch.Generator] = None,
                repeat: int = 1) -> torch.Tensor:
        """Teacher-forced forward.  ``input_ids`` (R, T) starts with BOS;
        returns float32 logits (R, T, V) predicting ``input_ids`` shifted
        left.  ``feats`` holds B videos and ``input_ids`` R = B*repeat
        caption rows (row-major per video).  Output dropout is drawn
        from ``generator`` (on the model's device); without one the pass
        is deterministic.  Scheduled sampling (``ss_prob`` > 0) is not
        ported."""
        if ss_prob != 0.0:
            raise not_ported(f"scheduled sampling (ss_prob={ss_prob})",
                             "Queue 1, item 5 (model completion)")
        cache = _repeat_cache(self._encode(feats, feat_masks), repeat)
        h_seq = self._fused_forward(cache, input_ids)
        h_seq = self._output_dropout(h_seq, generator)
        return self._logits(h_seq)

    def _output_dropout(self, h_seq: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None or self.drop_prob <= 0.0:
            return h_seq
        keep = 1.0 - self.drop_prob
        mask = torch.rand(h_seq.shape, generator=generator,
                          device=h_seq.device) < keep
        return torch.where(mask, h_seq / keep, 0.0).to(h_seq.dtype)

    def _fused_forward(self, cache: DecodeCache,
                       input_ids: torch.Tensor) -> torch.Tensor:
        """Batched input GEMMs + the recurrence kernel (reference
        ``_fused_forward``, meanpool branch): ``gx = emb @ W_emb +
        (ctx @ W_ctx)[:, None] + b`` with float32 accumulation, then
        ``lstm_recurrence(gx, W_h)``.  Returns h_seq (R, T, H) in the
        compute dtype."""
        cdt, E = self.compute_dtype, self.embed_size
        w = self.lstm0_w
        emb = self.word_embed.to(cdt)[input_ids]
        gx = dot_f32(emb, w[:E], cdt)
        gstatic = dot_f32(cache.ctx_static, w[E: 2 * E], cdt)
        gx = gx + gstatic[:, None, :]
        gx = gx + self.lstm0_b.float()
        return lstm_recurrence(gx, w[2 * E:].to(cdt))

    # ------------------------------------------------------ fused decode
    @torch.no_grad()
    def _fused_gx_static(self, cache: DecodeCache) -> torch.Tensor:
        """lstm bias + the static context's gate rows, (B, 4H) f32:
        ``b + ctx_static @ lstm0_w[E:2E]`` (reference
        ``_fused_gx_static`` + the meanpool ``gctx``)."""
        E = self.embed_size
        B = cache.ctx_static.shape[0]
        gx = self.lstm0_b.float()[None, :].expand(B, -1)
        gctx = dot_f32(cache.ctx_static, self.lstm0_w[E: 2 * E],
                       self.compute_dtype)
        return (gx + gctx).contiguous()

    def _kernel_weights(self):
        """(w_x, wh, emb, w_out) in the compute dtype — the decode
        kernels' operands.  Cached per parameter version, since the
        bf16 copies of the vocab-sized weights cost a pass over them."""
        key = tuple(p._version for p in self.parameters()) + (
            self.compute_dtype, self.device)
        if getattr(self, "_kw_key", None) != key:
            cdt, E = self.compute_dtype, self.embed_size
            self._kw = tuple(x.to(cdt).contiguous() for x in (
                self.lstm0_w[:E], self.lstm0_w[2 * E:], self.word_embed,
                self.logit_w))
            self._kw_key = key
        return self._kw

    @torch.no_grad()
    def fused_beam(self, feats, feat_masks, *, beam_size: int,
                   max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode once, then the whole beam recurrence in the
        ``lstm_beam`` kernel.  Returns the raw ``(seqs (B, K, L),
        scores (B, K))`` for ``decoding.beam.finalize_beams``."""
        cache = self._encode(feats, feat_masks)
        w_x, wh, emb, w_out = self._kernel_weights()
        return lstm_beam(
            self._fused_gx_static(cache), w_x, wh, emb, w_out,
            self.logit_b.float(), beam_size=beam_size, max_len=max_len,
            suppress_unk=self.decode_suppress_unk,
        )

    @torch.no_grad()
    def sample(self, feats, feat_masks, *, max_len: int = 30,
               greedy: bool = True, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None) -> SampleOutput:
        """Greedy (``greedy=True``) or temperature-multinomial decode of
        up to ``max_len`` tokens through the ``lstm_sample`` kernel.  The
        multinomial stream's two seed words come from ``generator``
        (greedy ignores them)."""
        cache = self._encode(feats, feat_masks)
        if greedy or generator is None:
            seed = (0, 0)
        else:
            seed = tuple(int(x) for x in torch.randint(
                0, 2 ** 32, (2,), generator=generator, dtype=torch.long))
        w_x, wh, emb, w_out = self._kernel_weights()
        toks, lps, mask = lstm_sample(
            self._fused_gx_static(cache), w_x, wh, emb, w_out,
            self.logit_b.float(), seed, max_len=max_len, greedy=greedy,
            temperature=temperature, suppress_unk=self.decode_suppress_unk,
        )
        return SampleOutput(tokens=toks, logprobs=lps, mask=mask)


SERVING_DTYPES = ("f32", "bf16", "int8w")


def model_from_config(cfg, serving_dtype: Optional[str] = None,
                      device=None) -> CaptionModel:
    """Build a :class:`CaptionModel` from a ``Config`` (reference
    ``model_from_config``).  ``serving_dtype`` other than ``f32``/None
    is not ported yet.  Parameters live on ``device``: ``cuda`` unless
    the caller passes ``"cpu"``."""
    m, d = cfg.model, cfg.data
    if serving_dtype not in (None, "f32"):
        if serving_dtype not in SERVING_DTYPES:
            raise ValueError(f"unknown serving.dtype {serving_dtype!r}")
        raise not_ported(f"serving.dtype={serving_dtype}",
                         "Queue 1, item 6 (serving extensions)")
    if m.vocab_size <= 0:
        raise ValueError("model.vocab_size is not set")
    return CaptionModel(
        vocab_size=m.vocab_size,
        rnn_size=m.rnn_size,
        embed_size=m.input_encoding_size,
        modalities=tuple(d.feature_modalities),
        feature_dims=tuple(d.feature_dims[k] for k in d.feature_modalities),
        compute_dtype=m.compute_dtype,
        decode_suppress_unk=m.decode_suppress_unk,
        num_layers=m.num_layers,
        fusion=m.feature_fusion,
        use_category=m.use_category,
        drop_prob=m.drop_prob,
        device=resolve_device(device),
    )
