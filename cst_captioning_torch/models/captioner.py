"""LSTM caption decoder with meanpool or attention fusion (port of the
JAX package's ``models/captioner.py::CaptionModel``, the single-layer
subset without category embeddings).

Parameters carry the reference's names (``CaptionModel.setup``), so a
``state_dict`` maps one-to-one onto the JAX ``{"params": ...}`` tree
(``models/weights.py``):

* ``word_embed`` (V, E); ``proj_<m>_w`` (D_m, E), ``proj_<m>_b`` (E,)
  per feature modality;
* ``lstm0_w`` (2E + H, 4H) stacking the rows [emb | ctx | hidden], gates
  i|f|g|o; ``lstm0_b`` (4H,);
* ``logit_w`` (H, V), ``logit_b`` (V,);
* attention fusion adds ``att_wf`` (E, A), ``att_wh`` (H, A), ``att_b``
  (A,) and ``att_v`` (A, 1).

The parameters are trainable.  ``forward`` is the teacher-forced pass of
XE/WXE training, two ways, as the reference ``__call__`` branches:

* ``ss_prob`` a Python ``0.0`` (scheduled sampling off): the fused
  branches, input GEMMs batched over (rows, T), the recurrence in the
  ``lstm_recurrence`` kernel (meanpool, ``ops/lstm.py``) or the
  ``attlstm_recurrence`` kernel (attention, ``ops/attlstm.py``), whatever
  ``model.use_pallas_lstm`` and ``model.use_pallas_attention`` say;
* any other ``ss_prob`` (a tensor holding 0 too): the per-step loop
  (the reference's ``lax.scan`` branch) with scheduled sampling, one
  ``_step`` per token under autograd; under attention fusion its context
  goes through the ``fused_context_attention`` kernels, forward and
  backward (``ops/attention.py``), with the attention tensors kept per
  video and read ``repeat`` rows at a time.  Each step past the first
  feeds, with probability ``ss_prob`` per row, the token sampled from
  the previous step's unmasked logits instead of the ground truth;
  ``model.remat`` (``train.remat``) recomputes each step in the backward
  (``torch.utils.checkpoint``), the draws made outside it.

Both end in output dropout and float32 logits.  Decoding runs without
autograd, two ways:

* whole-recurrence kernels (``ops/beam.py``, ``ops/sampler.py``):
  ``fused_beam`` for beam search, ``sample`` for greedy / multinomial
  (the ladder engine's path);
* per step (the continuous slot loop, ``decoding/beam.py::
  beam_search_from_state`` and :meth:`CaptionModel._sample_from_cache`):
  ``init_decode`` encodes, ``decode_logits`` runs one ``_step`` (under
  attention fusion the context comes from the ``fused_context_attention``
  kernel, ``ops/attention.py``) and the masked vocab logits.  Every
  product on this path goes through ``ops/rowgemm.py::row_dot``, whose
  kernel fixes each output's order of summation over k whatever the row
  count (tensor-core chunks at bf16, one thread's chain at f32), so a
  caption decoded in a slot matrix of S*K rows is bit for bit the one
  decoded offline in B*K.

Both decode ways share the encode: with autograd off its products go
through ``row_dot`` and its frame sums through a fixed tree, so a
video's cache rows do not depend on the batch it was encoded in.

``_step`` is the one definition of a decoder step for both: under
autograd its products take ``dot_f32`` on the parameters, without it
``row_dot`` on the cached compute-dtype weights.

``weight_quant`` (``serving.dtype = int8w``, reference ``weight_quant``):
``word_embed``, ``logit_w``, ``lstm0_w``, ``att_wf`` and ``att_wh`` hold
int8 codes (frozen parameters) and each gains a float32 ``<name>_scale``
parameter (ones at init; ``ops/quant.py::quantize_params`` fills codes
and scales together).  Every product follows ``quant_matmul``: the codes
cast to the compute dtype, float32 accumulation, the per-channel scale
after it, never rounded back down; embedding rows are ``dequant_rows``.
The per-step decode runs the int8 ``row_dot`` on the codes themselves
(no float copy of the weights); the whole-recurrence decoders and the
teacher-forced forward take the int8w kernels (``quant=`` of
``ops/beam.py`` and ``ops/sampler.py``, ``lstm_recurrence_quant``,
``attlstm_recurrence_quant``), which are forward-only: a quantized
model serves, it never trains.

Not ported yet, and refused with ``NotImplementedError``: category
embeddings, more than one LSTM layer, per-step multinomial decode.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID
from cst_captioning_torch.decoding.core import (
    DecodeState,
    all_done,
    decode_step,
    init_core,
)
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.ops.attention import fused_context_attention
from cst_captioning_torch.ops.attlstm import (
    attlstm_recurrence,
    attlstm_recurrence_quant,
)
from cst_captioning_torch.ops.beam import attlstm_beam, lstm_beam
from cst_captioning_torch.ops.lstm import lstm_recurrence, lstm_recurrence_quant
from cst_captioning_torch.ops.quant import dequant_rows, quantize_per_channel
from cst_captioning_torch.ops.rnn import (
    dot_f32,
    gate_update,
    lstm_bias_init,
    lstm_kernel_init,
)
from cst_captioning_torch.ops.rowgemm import row_dot
from cst_captioning_torch.ops.sampler import attlstm_sample, lstm_sample

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SampleOutput(NamedTuple):
    tokens: torch.Tensor    # (B, L) int32 — sampled ids, PAD after the end
    logprobs: torch.Tensor  # (B, L) float32 — log p of each sampled token
    mask: torch.Tensor      # (B, L) float32 — 1 up to and including the end


class DecodeCache(NamedTuple):
    """Per-video tensors fixed across decode steps.  The attention
    tensors are None under meanpool fusion."""

    ctx_static: torch.Tensor                   # (B, E) mean-pooled context
    att_vals: Optional[torch.Tensor] = None    # (B, F, E) frames, modality order
    att_proj: Optional[torch.Tensor] = None    # (B, F, A) att_vals @ att_wf + b
    att_mask: Optional[torch.Tensor] = None    # (B, F) float32 {0, 1}


def _frame_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` (B, F, E) over frames by a fixed pairwise tree of
    elementwise adds, so a row's bits do not depend on B (a reduction
    kernel may split the frame axis differently for another B)."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def _repeat_cache(cache: DecodeCache, repeat: int) -> DecodeCache:
    """Tile each per-video cache row ``repeat`` times (row i -> rows
    i*repeat..(i+1)*repeat-1): the seq_per_img fan-out after the feature
    projections, not before them (reference ``_repeat_cache``)."""
    if repeat <= 1:
        return cache
    return DecodeCache(*(None if x is None else
                         x.repeat_interleave(repeat, dim=0) for x in cache))


# The quantized parameters (reference ops/quant.py's axis rules).
_QUANT_LEAVES = ("word_embed", "logit_w", "lstm0_w", "att_wf", "att_wh")


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
        att_hidden_size: int = 512,
        use_category: bool = False,
        drop_prob: float = 0.0,
        remat: bool = False,
        weight_quant: bool = False,
        device=None,
    ):
        super().__init__()
        if fusion not in ("meanpool", "attention"):
            raise ValueError(f"unknown feature_fusion {fusion!r}; expected "
                             "'meanpool' or 'attention'")
        if num_layers != 1:
            raise not_ported(f"num_layers={num_layers}",
                             "Queue 1, item 4 (model completion)")
        if use_category:
            raise not_ported("use_category", "Queue 1, item 4 (model completion)")
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
        self.remat = bool(remat)
        self.num_layers = 1
        self.fusion = fusion
        self.att_hidden_size = A = int(att_hidden_size)
        self.use_category = False
        self.weight_quant = bool(weight_quant)
        kw = dict(dtype=torch.float32, device=device)
        self.word_embed = nn.Parameter(torch.empty((V, E), **kw))
        for m, d in zip(self.modalities, self.feature_dims):
            setattr(self, f"proj_{m}_w", nn.Parameter(torch.empty((d, E), **kw)))
            setattr(self, f"proj_{m}_b", nn.Parameter(torch.empty((E,), **kw)))
        if fusion == "attention":
            self.att_wf = nn.Parameter(torch.empty((E, A), **kw))
            self.att_wh = nn.Parameter(torch.empty((H, A), **kw))
            self.att_b = nn.Parameter(torch.empty((A,), **kw))
            self.att_v = nn.Parameter(torch.empty((A, 1), **kw))
        self.lstm0_w = nn.Parameter(torch.empty((2 * E + H, 4 * H), **kw))
        self.lstm0_b = nn.Parameter(torch.empty((4 * H,), **kw))
        self.logit_w = nn.Parameter(torch.empty((H, V), **kw))
        self.logit_b = nn.Parameter(torch.empty((V,), **kw))
        if self.weight_quant:
            self._quantize_layout(device)

    def _quantize_layout(self, device) -> None:
        """int8 codes (frozen) for the quantized leaves and their float32
        ``<name>_scale`` parameters, ones at init (reference
        ``CaptionModel.setup`` under ``weight_quant``)."""
        for name in _QUANT_LEAVES:
            if not hasattr(self, name):
                continue
            shape = getattr(self, name).shape
            setattr(self, name, nn.Parameter(
                torch.zeros(shape, dtype=torch.int8, device=device),
                requires_grad=False))
            n = shape[0] if name == "word_embed" else shape[1]
            setattr(self, name + "_scale", nn.Parameter(
                torch.ones((n,), dtype=torch.float32, device=device)))

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CaptionModel":
        """Fresh weights with the reference's initializer distributions
        (uniform ±0.1 embeddings, Glorot-uniform projections, the LSTM
        kernel/bias inits, zero biases), drawn from ``generator`` on the
        CPU — the streams differ from ``jax.random``'s.  Under
        ``weight_quant`` the same float draws are quantized (absmax)."""
        E, H, V = self.embed_size, self.rnn_size, self.vocab_size
        g = generator
        vals = {"word_embed": torch.rand((V, E), generator=g) * 0.2 - 0.1}
        for m, d in zip(self.modalities, self.feature_dims):
            vals[f"proj_{m}_w"] = _glorot((d, E), g)
            vals[f"proj_{m}_b"] = torch.zeros((E,))
        if self.fusion == "attention":
            A = self.att_hidden_size
            vals["att_wf"] = _glorot((E, A), g)
            vals["att_wh"] = _glorot((H, A), g)
            vals["att_b"] = torch.zeros((A,))
            vals["att_v"] = _glorot((A, 1), g)
        vals["lstm0_w"] = lstm_kernel_init((2 * E + H, 4 * H), g)
        vals["lstm0_b"] = lstm_bias_init((4 * H,))
        vals["logit_w"] = _glorot((H, V), g)
        vals["logit_b"] = torch.zeros((V,))
        for name, v in vals.items():
            if self.weight_quant and name in _QUANT_LEAVES:
                axis = 0 if name == "word_embed" else 1
                v, scale = quantize_per_channel(v, axis)
                getattr(self, name + "_scale").copy_(scale)
            getattr(self, name).copy_(v)
        return self

    def _scale(self, name: str) -> Optional[torch.Tensor]:
        """The float32 scale of quantized parameter ``name`` (None for a
        float model)."""
        return getattr(self, name + "_scale") if self.weight_quant else None

    def _embed(self, ids: torch.Tensor,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embedding rows of ``ids`` in the compute dtype from ``table``
        (``_step_weights``' table; default ``word_embed``), or under
        ``weight_quant`` from the int8 codes, dequantized after the
        gather (``dequant_rows``)."""
        if table is None:
            table = self.word_embed
        if self.weight_quant:
            return dequant_rows(table, self.word_embed_scale, ids,
                                self.compute_dtype)
        return table.to(self.compute_dtype)[ids]

    @property
    def device(self) -> torch.device:
        return self.word_embed.device

    # ---------------------------------------------------------- encoding
    def _encode(self, feats: Dict[str, torch.Tensor],
                feat_masks: Dict[str, torch.Tensor]) -> DecodeCache:
        """Project each modality to the embed dim, mean-pool its masked
        frames, average the modalities (reference ``_encode``).  Under
        attention fusion the projected frames and their masks also
        concatenate along frames in modality order, and ``att_proj =
        T(att_vals @ att_wf + att_b)`` with float32 accumulation.
        Every decode encode (autograd off) takes the products through
        ``row_dot`` and the frame sum through ``_frame_sum``, so a video's
        rows do not depend on the batch it is encoded in; the
        teacher-forced forward needs gradients, which ``row_dot`` does
        not give, and takes ``dot_f32``."""
        cdt = self.compute_dtype
        row_invariant = not torch.is_grad_enabled()
        dot = row_dot if row_invariant else dot_f32
        vals, masks, means = [], [], []
        for m in self.modalities:
            v = (dot(feats[m], getattr(self, f"proj_{m}_w"), cdt)
                 + getattr(self, f"proj_{m}_b").float()).to(cdt)
            fm = feat_masks[m].float()
            denom = torch.clamp(fm.sum(-1, keepdim=True), min=1.0)
            masked = v.float() * fm[..., None]
            means.append((_frame_sum(masked) if row_invariant
                          else masked.sum(1)) / denom)
            vals.append(v)
            masks.append(fm)
        total = means[0]
        for x in means[1:]:
            total = total + x
        ctx_static = (total / len(means)).to(cdt)
        if self.fusion != "attention":
            return DecodeCache(ctx_static=ctx_static)
        att_vals = torch.cat(vals, dim=1)
        att_proj = (dot(att_vals, self.att_wf, cdt, self._scale("att_wf"))
                    + self.att_b.float()).to(cdt)
        return DecodeCache(ctx_static=ctx_static, att_vals=att_vals,
                           att_proj=att_proj,
                           att_mask=torch.cat(masks, dim=1))

    def init_state(self, batch: int) -> DecodeState:
        """Zero decoder carry for ``batch`` rows (reference
        ``_init_state``)."""
        return DecodeState(
            h=torch.zeros((1, batch, self.rnn_size), dtype=self.compute_dtype,
                          device=self.device),
            c=torch.zeros((1, batch, self.rnn_size), dtype=torch.float32,
                          device=self.device))

    @torch.no_grad()
    def init_decode(self, feats, feat_masks) -> Tuple[DecodeState, DecodeCache]:
        """(zero state, per-video cache) — reference ``init_decode``,
        the encode of the per-step decode path."""
        cache = self._encode(feats, feat_masks)
        return self.init_state(cache.ctx_static.shape[0]), cache

    # --------------------------------------------------------- step math
    def _step_weights(self):
        """(embedding table, ``lstm0_w``, ``att_wh``, ``att_v``) in the
        compute dtype for :meth:`_step` (the attention pair None under
        meanpool): under autograd the parameters' differentiable casts,
        otherwise the cached decode copies (``_kernel_weights``)."""
        cdt = self.compute_dtype
        attention = self.fusion == "attention"
        if torch.is_grad_enabled():
            # int8 codes stay codes: the products cast them themselves.
            wc = (lambda x: x) if self.weight_quant else (  # noqa: E731
                lambda x: x.to(cdt))
            att = ((wc(self.att_wh), self.att_v.to(cdt)) if attention
                   else (None, None))
            return (wc(self.word_embed), wc(self.lstm0_w)) + att
        kw = self._kernel_weights()
        return (kw[2], self._kw_full) + (kw[5:] if attention else (None, None))

    def _context(self, cache: DecodeCache, h_top: torch.Tensor, rep: int,
                 att_wh, att_v, dot) -> torch.Tensor:
        """Per-step fused context: the static mean-pool, or the Bahdanau
        attention queried by the previous hidden state through the
        ``fused_context_attention`` kernel (reference ``_context``): q =
        T(T(h) @ att_wh) with float32 accumulation, ``dot`` and the
        weights as :meth:`_step` chose them.  Row r of ``h_top`` reads
        cache row ``r // rep``."""
        if self.fusion != "attention":
            ctx = cache.ctx_static
            return ctx.repeat_interleave(rep, dim=0) if rep > 1 else ctx
        cdt = self.compute_dtype
        q = dot(h_top, att_wh, cdt, self._scale("att_wh")).to(cdt)
        return fused_context_attention(q, cache.att_proj, cache.att_mask,
                                       cache.att_vals, att_v, rep=rep)

    def _step(self, state: DecodeState, cache: DecodeCache,
              tokens: torch.Tensor, rep: int = 1, weights=None):
        """One unfused decoder step: gates = T([emb | ctx | h]) @ lstm0_w
        + b in one product with float32 accumulation (reference ``_step``
        and ``lstm_step``), then the i|f|g|o update with a float32 cell.
        ``weights``: :meth:`_step_weights`, computed here when None.
        Under autograd the products go through ``dot_f32`` (differentiable),
        otherwise through the row-invariant ``row_dot``.  Returns (new
        state, top hidden in the compute dtype)."""
        cdt = self.compute_dtype
        h, c = state
        emb_w, w, att_wh, att_v = weights or self._step_weights()
        dot = dot_f32 if torch.is_grad_enabled() else row_dot
        x = torch.cat([self._embed(tokens, emb_w),
                       self._context(cache, h[0], rep, att_wh, att_v,
                                     dot).to(cdt),
                       h[0].to(cdt)], dim=-1)
        gates = dot(x, w, cdt, self._scale("lstm0_w")) + self.lstm0_b.float()
        h_new, c_new = gate_update(gates, c[0].float())
        h_new = h_new.to(cdt)
        return DecodeState(h=h_new[None], c=c_new[None]), h_new

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 vocab logits (reference ``_logits``)."""
        return (dot_f32(h, self.logit_w, self.compute_dtype,
                               self._scale("logit_w"))
                + self.logit_b.float())

    @torch.no_grad()
    def decode_logits(self, state: DecodeState, cache: DecodeCache,
                      tokens: torch.Tensor, rep: int = 1):
        """One decode step -> (new state, float32 decode-policy logits
        (B, V), PAD/BOS masked out): the model hook of
        ``decoding/core.py::decode_step`` (reference ``decode_logits``).
        ``rep``: rows per cache row (the slot loop's deduplicated
        cache)."""
        state, h_top = self._step(state, cache, tokens, rep)
        logits = (row_dot(h_top, self._kernel_weights()[3],
                          self.compute_dtype, self._scale("logit_w"))
                  + self.logit_b.float())
        return state, self.mask_decode_logits(logits, self.decode_suppress_unk)

    @torch.no_grad()
    def _sample_from_cache(self, state: DecodeState, cache: DecodeCache, *,
                           max_len: int = 30, greedy: bool = True,
                           early_exit: bool = True) -> SampleOutput:
        """Per-step greedy decode from a pre-encoded ``(state, cache)``
        (reference ``_sample_from_cache``, greedy mode): the unified
        decode core's row mode, stopping once every row has finished
        (the steps it skips would only re-write PAD / 0 into buffers
        that start so).  The multinomial mode is not ported."""
        if not greedy:
            raise not_ported("per-step multinomial decode",
                             "Queue 1, item 1 (CST: the slot rollout)")
        B = state.h.shape[1]
        st = init_core(state, B, 1, max_len, mode="greedy")

        def step_logits(s, tok):
            return self.decode_logits(s, cache, tok)

        for _ in range(max_len):
            if early_exit and all_done(st):
                break
            st = decode_step(step_logits, st, mode="greedy")
        return SampleOutput(tokens=st.seqs[:, 0, :], logprobs=st.lps[:, 0, :],
                            mask=(st.seqs[:, 0, :] != PAD_ID).float())

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
                input_ids: torch.Tensor, *,
                ss_prob: Union[float, torch.Tensor] = 0.0,
                generator: Optional[torch.Generator] = None,
                repeat: int = 1) -> torch.Tensor:
        """Teacher-forced forward.  ``input_ids`` (R, T) starts with BOS;
        returns float32 logits (R, T, V) predicting ``input_ids`` shifted
        left.  ``feats`` holds B videos and ``input_ids`` R = B*repeat
        caption rows (row-major per video).  ``ss_prob``: scheduled
        sampling's feed probability; a Python ``0.0`` takes the fused
        branches, anything else the per-step loop (module docstring).
        Output dropout and the scheduled-sampling draws come from
        ``generator`` (on the model's device); without one dropout is off
        and the draws come from a generator seeded 0 (the reference's
        default key)."""
        cache = self._encode(feats, feat_masks)
        if not (isinstance(ss_prob, float) and ss_prob == 0.0):
            h_seq = self._per_step_forward(cache, input_ids, ss_prob,
                                           generator, repeat)
            h_seq = self._output_dropout(h_seq, generator)
            return self._logits(h_seq)
        if self.fusion == "attention":
            h_seq = self._fused_attention_forward(cache, input_ids, repeat)
        else:
            h_seq = self._fused_forward(_repeat_cache(cache, repeat),
                                        input_ids)
        h_seq = self._output_dropout(h_seq, generator)
        return self._logits(h_seq)

    def _per_step_forward(self, cache: DecodeCache, input_ids: torch.Tensor,
                          ss_prob, generator: Optional[torch.Generator],
                          repeat: int) -> torch.Tensor:
        """The reference's per-step branch (``__call__``'s scan) with
        scheduled sampling.  Step t > 0 feeds row r the token sampled
        from step t-1's logits where ``_feed_mask`` draws True, else
        ``input_ids[r, t]``; step 0 feeds BOS.  The attention tensors
        stay per video (``rep = repeat``); under meanpool the static
        context is repeated to the caption rows.  With ``self.remat``
        each step is recomputed in the backward; the draws stay outside
        the recomputed function, so the recompute feeds the same tokens.
        Returns h_seq (R, T, H) in the compute dtype."""
        R, T = input_ids.shape
        rep = repeat
        if self.fusion != "attention":
            cache, rep = _repeat_cache(cache, repeat), 1
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        weights = self._step_weights()

        def step(h, c, tok):
            state, h_top = self._step(DecodeState(h=h[None], c=c[None]),
                                      cache, tok, rep, weights)
            return h_top, state.c[0]

        state = self.init_state(R)
        h, c = state.h[0], state.c[0]
        hs, sampled = [], None
        for t in range(T):
            tok = input_ids[:, t]
            if t > 0:
                tok = torch.where(self._feed_mask(R, ss_prob, generator),
                                  sampled, tok)
            if self.remat:
                h, c = checkpoint(step, h, c, tok, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, c = step(h, c, tok)
            hs.append(h)
            if t + 1 < T:
                with torch.no_grad():
                    sampled = self._sample_tokens(self._logits(h), generator)
        return torch.stack(hs, dim=1)

    def _feed_mask(self, rows: int, ss_prob,
                   generator: torch.Generator) -> torch.Tensor:
        """(rows,) bool: which rows take the sampled token this step
        (``u < ss_prob``, the reference's Bernoulli draw)."""
        u = torch.rand(rows, generator=generator, device=self.device)
        return u < ss_prob

    @staticmethod
    def _sample_tokens(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
        """One categorical draw per row from float32 ``logits`` (R, V) by
        the Gumbel-max trick, as ``jax.random.categorical`` draws; no
        decode mask (the reference samples its unmasked logits)."""
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = u.clamp_min_(torch.finfo(torch.float32).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(-1)

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
        w, ls = self.lstm0_w, self._scale("lstm0_w")
        emb = self._embed(input_ids)
        gx = dot_f32(emb, w[:E], cdt, ls)
        gstatic = dot_f32(cache.ctx_static, w[E: 2 * E], cdt, ls)
        gx = gx + gstatic[:, None, :]
        gx = gx + self.lstm0_b.float()
        if self.weight_quant:
            self._check_forward_only(gx)
            return lstm_recurrence_quant(gx, w[2 * E:], ls, cdt)
        return lstm_recurrence(gx, w[2 * E:].to(cdt))

    def _fused_attention_forward(self, cache: DecodeCache,
                                 input_ids: torch.Tensor,
                                 repeat: int = 1) -> torch.Tensor:
        """Batched token-embedding GEMM + the attention recurrence kernel
        (reference ``_fused_attention_forward``; weight rows [emb E |
        ctx E | hidden H]): ``gx = emb @ W_emb + b`` with float32
        accumulation, then ``attlstm_recurrence(gx, W_h, W_ctx, att_wh,
        att_v, att_proj, att_mask, att_vals, repeat)``.  The attention
        tensors stay per video (``cache`` holds B videos, ``input_ids``
        B * repeat caption rows): the kernel reads row r's video r //
        repeat, where the reference repeats the cache to the rows first
        (the same forward, bitwise).  Returns h_seq (R, T, H) in the
        compute dtype."""
        cdt, E = self.compute_dtype, self.embed_size
        w, ls = self.lstm0_w, self._scale("lstm0_w")
        emb = self._embed(input_ids)
        gx = dot_f32(emb, w[:E], cdt, ls) + self.lstm0_b.float()
        if self.weight_quant:
            self._check_forward_only(gx, cache.att_proj, cache.att_vals)
            return attlstm_recurrence_quant(
                gx, w[2 * E:], w[E: 2 * E], ls, self.att_wh,
                self.att_wh_scale, self.att_v.to(cdt), cache.att_proj,
                cache.att_mask, cache.att_vals, cdt, rep=repeat)
        return attlstm_recurrence(
            gx, w[2 * E:].to(cdt), w[E: 2 * E].to(cdt), self.att_wh.to(cdt),
            self.att_v.to(cdt), cache.att_proj, cache.att_mask,
            cache.att_vals, repeat)

    @staticmethod
    def _check_forward_only(*inputs: torch.Tensor) -> None:
        """The int8w recurrences have no backward (reference: no VJP)."""
        if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
            raise RuntimeError(
                "a weight_quant model is forward-only (serving): run it "
                "under torch.no_grad() or freeze its parameters")

    # ------------------------------------------------------ fused decode
    @torch.no_grad()
    def _fused_gx_static(self, cache: DecodeCache) -> torch.Tensor:
        """The decode kernels' static gate rows, (B, 4H) f32: the lstm
        bias, plus under meanpool the static context's rows ``ctx_static
        @ lstm0_w[E:2E]`` (reference ``_fused_gx_static`` + the meanpool
        ``gctx``; row-invariant, like the encode).  Attention computes
        its context per step in the kernel."""
        E = self.embed_size
        B = cache.ctx_static.shape[0]
        gx = self.lstm0_b.float()[None, :].expand(B, -1)
        if self.fusion == "attention":
            return gx.contiguous()
        gctx = row_dot(cache.ctx_static, self._kernel_weights()[4],
                       self.compute_dtype, self._scale("lstm0_w"))
        return (gx + gctx).contiguous()

    def _kernel_weights(self):
        """(w_x, wh, emb, w_out, w_ctx), plus (att_wh, att_v) under
        attention fusion, in the compute dtype — the decode kernels'
        operands; w_x, wh and w_ctx are row blocks of ``_kw_full``, the
        whole ``lstm0_w`` in the compute dtype (the per-step gate
        product's operand).  Under ``weight_quant`` the quantized ones are
        the int8 codes themselves, never a float copy.  Cached per
        parameter version, since the bf16 copies of the vocab-sized
        weights cost a pass over them."""
        key = tuple(p._version for p in self.parameters()) + (
            self.compute_dtype, self.device)
        if getattr(self, "_kw_key", None) != key:
            cdt, E = self.compute_dtype, self.embed_size
            cast = lambda x: (x.detach() if x.dtype == torch.int8  # noqa: E731
                              else x.detach().to(cdt)).contiguous()
            full = cast(self.lstm0_w)
            ws = [full[:E], full[2 * E:]] + [
                cast(x) for x in (self.word_embed, self.logit_w)]
            ws += [full[E: 2 * E]]
            if self.fusion == "attention":
                ws += [cast(x) for x in (self.att_wh, self.att_v)]
            self._kw_full = full
            self._kw = tuple(ws)
            self._kw_key = key
        return self._kw

    def _att_operands(self, cache: DecodeCache):
        """(w_ctx, att_wh, att_v, att_proj, att_mask, att_vals): the
        attention decoders' operands after (w_x, wh)."""
        w_ctx, att_wh, att_v = self._kernel_weights()[4:]
        return (w_ctx, att_wh, att_v, cache.att_proj, cache.att_mask,
                cache.att_vals)

    def _decode_quant(self) -> Dict:
        """The fused decoders' int8w keywords (reference ``common["quant"]``
        and ``compute_dtype``): empty for a float model."""
        if not self.weight_quant:
            return {}
        quant = (self.word_embed_scale, self.logit_w_scale,
                 self.lstm0_w_scale)
        if self.fusion == "attention":
            quant += (self.att_wh_scale,)
        return dict(quant=quant, compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def fused_beam(self, feats, feat_masks, *, beam_size: int,
                   max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode once, then the whole beam recurrence in the
        ``lstm_beam`` kernel (``attlstm_beam`` under attention fusion).
        Returns the raw ``(seqs (B, K, L), scores (B, K))`` for
        ``decoding.beam.finalize_beams``."""
        cache = self._encode(feats, feat_masks)
        w_x, wh, emb, w_out = self._kernel_weights()[:4]
        common = dict(beam_size=beam_size, max_len=max_len,
                      suppress_unk=self.decode_suppress_unk,
                      **self._decode_quant())
        if self.fusion == "attention":
            return attlstm_beam(
                self._fused_gx_static(cache), w_x, wh,
                *self._att_operands(cache), emb, w_out,
                self.logit_b.float(), **common)
        return lstm_beam(
            self._fused_gx_static(cache), w_x, wh, emb, w_out,
            self.logit_b.float(), **common)

    @torch.no_grad()
    def sample(self, feats, feat_masks, *, max_len: int = 30,
               greedy: bool = True, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               repeat: int = 1) -> SampleOutput:
        """Greedy (``greedy=True``) or temperature-multinomial decode of
        up to ``max_len`` tokens through the ``lstm_sample`` kernel
        (``attlstm_sample`` under attention fusion).  ``repeat``: rollouts
        per video (CST's S samples), rows ``i*repeat..(i+1)*repeat-1``
        for video i; the cache is tiled after the feature projections
        (:func:`_repeat_cache`), so S rollouts cost S decodes and one
        encode.  The multinomial stream's two seed words come from
        ``generator`` (:func:`draw_seeds`; greedy ignores them)."""
        cache = _repeat_cache(self._encode(feats, feat_masks), repeat)
        seed = ((0, 0) if greedy or generator is None
                else draw_seeds(generator, 1)[0])
        return self.sample_cache(cache, seed, max_len=max_len, greedy=greedy,
                                 temperature=temperature)

    @torch.no_grad()
    def sample_with_baseline(self, feats, feat_masks, *,
                             generator: torch.Generator, max_len: int = 30,
                             temperature: float = 1.0, repeat: int = 1,
                             with_greedy: bool = True):
        """The multinomial rollout (``repeat`` rows per video) and the
        greedy-baseline decode from one feature encode (reference
        ``sample_with_baseline``).  Returns ``(rollout, greedy or
        None)``."""
        cache = self._encode(feats, feat_masks)
        rollout = self.sample_cache(
            _repeat_cache(cache, repeat), draw_seeds(generator, 1)[0],
            max_len=max_len, greedy=False, temperature=temperature)
        if not with_greedy:
            return rollout, None
        return rollout, self.sample_cache(cache, (0, 0), max_len=max_len,
                                          greedy=True)

    @torch.no_grad()
    def sample_cache(self, cache: DecodeCache, seed: Tuple[int, int], *,
                     max_len: int, greedy: bool,
                     temperature: float = 1.0) -> SampleOutput:
        """The fused decode of :meth:`sample` from an encoded cache, one
        row per cache row (reference ``_fused_sample``).  ``seed``: the
        hash-Gumbel stream's two 32-bit words (the reference derives them
        as ``jax.random.bits(rng, (2,), uint32)``); greedy ignores them.
        Under attention fusion the attention operands are the cache's,
        row for row."""
        w_x, wh, emb, w_out = self._kernel_weights()[:4]
        common = dict(max_len=max_len, greedy=greedy, temperature=temperature,
                      suppress_unk=self.decode_suppress_unk,
                      **self._decode_quant())
        if self.fusion == "attention":
            toks, lps, mask = attlstm_sample(
                self._fused_gx_static(cache), w_x, wh,
                *self._att_operands(cache), emb, w_out,
                self.logit_b.float(), seed, **common)
        else:
            toks, lps, mask = lstm_sample(
                self._fused_gx_static(cache), w_x, wh, emb, w_out,
                self.logit_b.float(), seed, **common)
        return SampleOutput(tokens=toks, logprobs=lps, mask=mask)


def draw_seeds(generator: torch.Generator, n: int) -> List[Tuple[int, int]]:
    """``n`` pairs of 32-bit seed words of the multinomial stream, drawn
    from ``generator`` on its own device in one call (one host read)."""
    words = torch.randint(0, 2 ** 32, (n, 2), generator=generator,
                          device=generator.device, dtype=torch.long)
    return [(int(a), int(b)) for a, b in words.tolist()]


SERVING_DTYPES = ("f32", "bf16", "int8w")


def model_from_config(cfg, serving_dtype: Optional[str] = None,
                      device=None) -> CaptionModel:
    """Build a :class:`CaptionModel` from a ``Config`` (reference
    ``model_from_config``).  ``serving_dtype`` is the serving override
    (``serving.dtype``, passed by the inference engine only): ``f32`` or
    None leaves the model as configured, ``bf16`` forces the bfloat16
    compute dtype, ``int8w`` also sets ``weight_quant``.  Parameters live
    on ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    m, d = cfg.model, cfg.data
    if serving_dtype is not None and serving_dtype not in SERVING_DTYPES:
        raise ValueError(f"unknown serving.dtype {serving_dtype!r}; "
                         f"expected one of {SERVING_DTYPES}")
    compute_dtype = m.compute_dtype
    if serving_dtype in ("bf16", "int8w"):
        compute_dtype = "bfloat16"
    if m.vocab_size <= 0:
        raise ValueError("model.vocab_size is not set")
    return CaptionModel(
        vocab_size=m.vocab_size,
        rnn_size=m.rnn_size,
        embed_size=m.input_encoding_size,
        modalities=tuple(d.feature_modalities),
        feature_dims=tuple(d.feature_dims[k] for k in d.feature_modalities),
        compute_dtype=compute_dtype,
        decode_suppress_unk=m.decode_suppress_unk,
        num_layers=m.num_layers,
        fusion=m.feature_fusion,
        att_hidden_size=m.att_hidden_size,
        use_category=m.use_category,
        drop_prob=m.drop_prob,
        remat=cfg.train.remat,
        weight_quant=serving_dtype == "int8w",
        device=resolve_device(device),
    )
