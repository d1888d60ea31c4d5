"""LSTM caption decoder with meanpool or attention fusion (port of the
JAX package's ``models/captioner.py::CaptionModel``), one LSTM layer or
a stack of ``num_layers``.

Parameters carry the reference's names (``CaptionModel.setup``), so a
``state_dict`` maps one-to-one onto the JAX ``{"params": ...}`` tree
(``models/weights.py``):

* ``word_embed`` (V, E); ``proj_<m>_w`` (D_m, E), ``proj_<m>_b`` (E,)
  per feature modality;
* ``lstm0_w`` (2E + C + H, 4H) stacking the rows [emb | ctx | cat |
  hidden], gates i|f|g|o (C = ``category_embed_size`` under
  ``use_category``, else 0); ``lstm0_b`` (4H,); each layer l > 0 of a
  stack ``lstm{l}_w`` (H + H, 4H), rows [h of layer l-1 | hidden], and
  ``lstm{l}_b`` (4H,);
* ``logit_w`` (H, V), ``logit_b`` (V,);
* attention fusion adds ``att_wf`` (E, A), ``att_wh`` (H, A), ``att_b``
  (A,) and ``att_v`` (A, 1);
* ``use_category`` adds ``cat_embed`` (num_categories, C), the MSR-VTT
  category embedding: each video's row is gathered at encode
  (``DecodeCache.cat_emb``) and enters every step's gate input.  Its
  gate rows are a per-video product, so the kernels take them in their
  static gate input: the decoders' ``gx_static`` (lstm bias + category
  rows, + the static context's rows under meanpool) and the
  teacher-forced ``gx`` (the meanpool static product over [ctx | cat],
  the attention ``gx`` plus the category rows after the bias), in the
  reference's order of sums.

The parameters are trainable.  ``forward`` is the teacher-forced pass of
XE/WXE training, two ways, as the reference ``__call__`` branches:

* ``ss_prob`` a Python ``0.0`` (scheduled sampling off): the fused
  branches, input GEMMs batched over (rows, T), the recurrence in the
  ``lstm_recurrence`` kernel (meanpool, ``ops/lstm.py``; one launch a
  layer, layer l > 0 fed the h sequence of the layer below) or the
  ``attlstm_recurrence`` kernel (attention, ``ops/attlstm.py``; one
  layer only, so a stacked attention model takes the per-step loop, as
  the reference's gate does), whatever ``model.use_pallas_lstm`` and
  ``model.use_pallas_attention`` say;
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
  (the ladder engine's path).  They cover single-layer decoders, as the
  reference's do: at ``num_layers > 1`` the same methods take the
  per-step decode below, chosen from the configuration and logged once
  a model (:meth:`CaptionModel.decodes_fused`), never after a kernel
  error.  A multinomial draw also takes the per-step decode (on JAX's
  threefry stream) where the reference's sampler gate declines:
  ``model.use_pallas_sampler`` off, or a row count that is not a
  positive multiple of 8 (:meth:`CaptionModel.fused_sampler_takes`);
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
``word_embed``, ``logit_w``, every ``lstm{l}_w``, ``att_wf`` and
``att_wh`` hold int8 codes (frozen parameters) and each gains a float32
``<name>_scale`` parameter (ones at init; ``ops/quant.py::
quantize_params`` fills codes and scales together).  Every product
follows ``quant_matmul``: the codes cast to the compute dtype, float32
accumulation, the per-channel scale after it, never rounded back down;
embedding rows are ``dequant_rows``.
The per-step decode runs the int8 ``row_dot`` on the codes themselves
(no float copy of the weights); the whole-recurrence decoders and the
teacher-forced forward take the int8w kernels (``quant=`` of
``ops/beam.py`` and ``ops/sampler.py``, ``lstm_recurrence_quant``,
``attlstm_recurrence_quant``), which are forward-only: a quantized
model serves, it never trains.

Meshes (``parallel/``, reference ``model_from_config(cfg, mesh)``):
:meth:`CaptionModel.shard_vocab` splits the vocab-sized leaves over a
mesh row's ``model`` devices (``models/vocab_shards.py``); the embedding
lookups then sum masked per-shard lookups, ``_logits`` and
``decode_logits`` return ``VocabShardedLogits`` (the losses take their
vocab-parallel log-softmax, the decode core its cross-shard merge), and
the whole-recurrence decoders run as ``ops/shard_decode.py`` where the
mesh gates engage them (``decode_mesh``); ``model.shard_frames`` splits
the attention frames over ``model`` (``frame_mesh``,
``parallel/ring.py``).
"""

from __future__ import annotations

import logging
import warnings
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
from cst_captioning_torch.parallel.collectives import VocabShardedLogits

# model.param_dtype's and model.compute_dtype's names: the three the
# kernels take (ops/decode_common.py::KERNEL_DTYPES), under both fusions.
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}

_log = logging.getLogger("cst_captioning_torch.models")


def warn_fused_decline(kind: str, reason: str) -> None:
    """One log line where a whole-recurrence decode kernel is declined
    by the configuration (reference ``warn_fused_decline``)."""
    _log.warning("%s declined: %s; using the per-step decode", kind,
                 reason)


class SampleOutput(NamedTuple):
    tokens: torch.Tensor    # (B, L) int32 — sampled ids, PAD after the end
    logprobs: torch.Tensor  # (B, L) float32 — log p of each sampled token
    mask: torch.Tensor      # (B, L) float32 — 1 up to and including the end


class DecodeCache(NamedTuple):
    """Per-video tensors fixed across decode steps.  The attention
    tensors are None under meanpool fusion, ``cat_emb`` without
    ``use_category``."""

    ctx_static: torch.Tensor                   # (B, E) mean-pooled context
    att_vals: Optional[torch.Tensor] = None    # (B, F, E) frames, modality order
    att_proj: Optional[torch.Tensor] = None    # (B, F, A) att_vals @ att_wf + b
    att_mask: Optional[torch.Tensor] = None    # (B, F) float32 {0, 1}
    cat_emb: Optional[torch.Tensor] = None     # (B, C) category embedding


def _frame_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` (B, F, E) over frames by a fixed pairwise tree of
    elementwise adds, so a row's bits do not depend on B (a reduction
    kernel may split the frame axis differently for another B)."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def sampler_batch_ok(rows: int) -> bool:
    """The batch clause of the reference's sampler gate
    (``ops/pallas_sampler.py::sampler_shapes_ok``), which declines on
    every backend: fewer than 8 rows, or a count that is not a multiple
    of 8.  Its other clauses are TPU tiling limits with no counterpart
    here."""
    return rows >= 8 and rows % 8 == 0


def _repeat_cache(cache: DecodeCache, repeat: int) -> DecodeCache:
    """Tile each per-video cache row ``repeat`` times (row i -> rows
    i*repeat..(i+1)*repeat-1): the seq_per_img fan-out after the feature
    projections, not before them (reference ``_repeat_cache``)."""
    if repeat <= 1:
        return cache
    return DecodeCache(*(None if x is None else
                         x.repeat_interleave(repeat, dim=0) for x in cache))


def _quant_leaves(num_layers: int) -> Tuple[str, ...]:
    """The quantized parameters (reference ops/quant.py's axis rules)."""
    return (("word_embed", "logit_w")
            + tuple(f"lstm{l}_w" for l in range(num_layers))
            + ("att_wf", "att_wh"))


def _resolve_dtype(knob: str, name, what: str) -> torch.dtype:
    name = str(name)
    if name == "float64":
        warnings.warn(
            f"{knob}='float64' is truncated to float32, as JAX without x64 "
            f"builds it: {what} float32", UserWarning, stacklevel=3)
        return torch.float32
    if name not in PARAM_DTYPES:
        raise ValueError(
            f"unknown {knob} {name!r}; expected one of "
            f"{tuple(PARAM_DTYPES) + ('float64',)}")
    return PARAM_DTYPES[name]


def resolve_param_dtype(name) -> torch.dtype:
    """The torch dtype of ``model.param_dtype`` as the reference builds
    its leaves (``jnp.dtype(param_dtype)``): ``float32``, ``bfloat16``
    and ``float16`` as named; ``float64`` builds float32 leaves with a
    ``UserWarning`` naming the truncation, as JAX without x64 does.  Any
    other name is refused (the reference's initializers take floating
    dtypes only)."""
    return _resolve_dtype("model.param_dtype", name, "the parameters are")


def resolve_compute_dtype(name) -> torch.dtype:
    """The torch dtype of ``model.compute_dtype`` as the reference casts
    its activations (``jnp.dtype(compute_dtype)``): ``float32``,
    ``bfloat16`` and ``float16`` as named; ``float64`` computes in
    float32 with a ``UserWarning``, as JAX without x64 does; any other
    name is refused."""
    return _resolve_dtype("model.compute_dtype", name,
                          "the activations are")


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
        num_categories: int = 20,
        category_embed_size: int = 64,
        drop_prob: float = 0.0,
        remat: bool = False,
        weight_quant: bool = False,
        use_pallas_sampler: bool = False,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if fusion not in ("meanpool", "attention"):
            raise ValueError(f"unknown feature_fusion {fusion!r}; expected "
                             "'meanpool' or 'attention'")
        if int(num_layers) < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        cdt = resolve_compute_dtype(compute_dtype)
        self.vocab_size = V = int(vocab_size)
        self.rnn_size = H = int(rnn_size)
        self.embed_size = E = int(embed_size)
        self.modalities = tuple(modalities)
        self.feature_dims = tuple(int(d) for d in feature_dims)
        self.compute_dtype = cdt
        self.param_dtype = param_dtype
        self.decode_suppress_unk = bool(decode_suppress_unk)
        self.drop_prob = float(drop_prob)
        self.remat = bool(remat)
        self.num_layers = int(num_layers)
        self.fusion = fusion
        self.att_hidden_size = A = int(att_hidden_size)
        self.use_category = bool(use_category)
        self.num_categories = int(num_categories)
        self.category_embed_size = C = (int(category_embed_size)
                                        if self.use_category else 0)
        if self.use_category and min(self.num_categories, C) < 1:
            raise ValueError("use_category needs num_categories >= 1 and "
                             "category_embed_size >= 1")
        self.weight_quant = bool(weight_quant)
        self.use_pallas_sampler = bool(use_pallas_sampler)
        self._declined = set()   # decoders whose decline was logged
        # Mesh placement (model_from_config(mesh=...), shard_vocab):
        # the vocab leaves split over a mesh row, the sharded decoders'
        # mesh, the reason a mesh declines the whole-recurrence decoders,
        # and the frame mesh of ``shard_frames``.
        self.vshards = None
        self.decode_mesh = None
        self.mesh_decline: Dict[str, str] = {}
        self.frame_mesh = None
        self.frame_batch_axis: Optional[str] = None
        # Every leaf in param_dtype but the int8w scales (float32, as
        # the reference's ``<name>_scale`` leaves whatever param_dtype).
        kw = dict(dtype=self.param_dtype, device=device)
        self.word_embed = nn.Parameter(torch.empty((V, E), **kw))
        for m, d in zip(self.modalities, self.feature_dims):
            setattr(self, f"proj_{m}_w", nn.Parameter(torch.empty((d, E), **kw)))
            setattr(self, f"proj_{m}_b", nn.Parameter(torch.empty((E,), **kw)))
        if fusion == "attention":
            self.att_wf = nn.Parameter(torch.empty((E, A), **kw))
            self.att_wh = nn.Parameter(torch.empty((H, A), **kw))
            self.att_b = nn.Parameter(torch.empty((A,), **kw))
            self.att_v = nn.Parameter(torch.empty((A, 1), **kw))
        if self.use_category:
            self.cat_embed = nn.Parameter(
                torch.empty((self.num_categories, C), **kw))
        # Layer 0's input [emb | ctx | cat], a higher layer's the h of
        # the layer below; the hidden rows follow it.
        self.in_dim = 2 * E + C
        for l in range(self.num_layers):
            d_in = self.in_dim if l == 0 else H
            setattr(self, f"lstm{l}_w", nn.Parameter(
                torch.empty((d_in + H, 4 * H), **kw)))
            setattr(self, f"lstm{l}_b", nn.Parameter(
                torch.empty((4 * H,), **kw)))
        self.logit_w = nn.Parameter(torch.empty((H, V), **kw))
        self.logit_b = nn.Parameter(torch.empty((V,), **kw))
        if self.weight_quant:
            self._quantize_layout(device)

    def _quantize_layout(self, device) -> None:
        """int8 codes (frozen) for the quantized leaves and their float32
        ``<name>_scale`` parameters, ones at init (reference
        ``CaptionModel.setup`` under ``weight_quant``)."""
        for name in _quant_leaves(self.num_layers):
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
        CPU — the streams differ from ``jax.random``'s.  ``cat_embed``
        is drawn after the single-layer model's weights, so the other
        draws do not depend on ``use_category``, and the layers past the
        first after it, so a stack's first layer and the rest are a
        single-layer model's draws.  The draws are float32, rounded once
        into ``param_dtype``; under ``weight_quant`` the rounded leaves
        are quantized (absmax), as the reference quantizes its
        ``param_dtype`` tree."""
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
        vals["lstm0_w"] = lstm_kernel_init((self.in_dim + H, 4 * H), g)
        vals["lstm0_b"] = lstm_bias_init((4 * H,))
        vals["logit_w"] = _glorot((H, V), g)
        vals["logit_b"] = torch.zeros((V,))
        if self.use_category:
            vals["cat_embed"] = (torch.rand(self.cat_embed.shape, generator=g)
                                 * 0.2 - 0.1)
        for l in range(1, self.num_layers):
            vals[f"lstm{l}_w"] = lstm_kernel_init((2 * H, 4 * H), g)
            vals[f"lstm{l}_b"] = lstm_bias_init((4 * H,))
        quant = _quant_leaves(self.num_layers)
        for name, v in vals.items():
            v = v.to(self.param_dtype)
            if self.weight_quant and name in quant:
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
        if self.vshards is not None:
            return self.vshards.embed(ids, self.compute_dtype)
        if table is None:
            table = self.word_embed
        if self.weight_quant:
            return dequant_rows(table, self.word_embed_scale, ids,
                                self.compute_dtype)
        return table.to(self.compute_dtype)[ids]

    @property
    def device(self) -> torch.device:
        return self.lstm0_b.device

    # ------------------------------------------------------ vocab shards
    def shard_vocab(self, devices) -> "CaptionModel":
        """Split the vocab-sized leaves (``word_embed`` rows, ``logit_w``
        / ``logit_b`` columns, their int8w scales) over ``devices``, one
        mesh row's ``model`` axis (``models/vocab_shards.py``); the model
        keeps every other leaf on its own device, and the split leaves
        leave its ``state_dict`` (:meth:`full_state_dict` gathers
        them)."""
        from cst_captioning_torch.models.vocab_shards import (
            VocabShards,
            is_vocab_leaf,
        )

        if self.vshards is not None:
            raise ValueError("the vocab is already sharded")
        full = {}
        grad = self.lstm0_b.requires_grad
        for name in [n for n in self._parameters if is_vocab_leaf(n)]:
            full[name] = self._parameters.pop(name).detach()
        self.vshards = VocabShards.split(full, devices, self.device, grad)
        self._kw_key = None
        return self

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The state dict with the vocab leaves gathered (a snapshot in
        CPU tensors for a sharded model; the plain ``state_dict``
        otherwise)."""
        if self.vshards is None:
            return self.state_dict()
        sd = {k: v.detach().to("cpu", copy=True)
              for k, v in self.state_dict().items()}
        sd.update(self.vshards.gather("cpu"))
        return sd

    # ---------------------------------------------------------- encoding
    def _encode(self, feats: Dict[str, torch.Tensor],
                feat_masks: Dict[str, torch.Tensor],
                category: Optional[torch.Tensor] = None) -> DecodeCache:
        """Project each modality to the embed dim, mean-pool its masked
        frames, average the modalities (reference ``_encode``).  Under
        attention fusion the projected frames and their masks also
        concatenate along frames in modality order, and ``att_proj =
        T(att_vals @ att_wf + att_b)`` with float32 accumulation.
        Every decode encode (autograd off) takes the products through
        ``row_dot`` and the frame sum through ``_frame_sum``, so a video's
        rows do not depend on the batch it is encoded in; the
        teacher-forced forward needs gradients, which ``row_dot`` does
        not give, and takes ``dot_f32``.  Under ``use_category`` the
        videos' ``cat_embed`` rows (``category`` (B,) ids) join the cache
        in the compute dtype; without a ``category`` it raises, as the
        reference does (a zero embedding would silently degrade the
        decode).  A model without categories ignores ``category``."""
        cdt = self.compute_dtype
        row_invariant = not torch.is_grad_enabled()
        dot = row_dot if row_invariant else dot_f32
        vals, masks, means = [], [], []
        for m in self.modalities:
            # Features in any float dtype (a float16 pack stays float16 up
            # to here) are rounded once to the compute dtype, as the
            # reference's ``feats[m].astype(cdt)``.
            f = feats[m].to(cdt)
            v = (dot(f, getattr(self, f"proj_{m}_w"), cdt)
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
        cat_emb = self._category_rows(category)
        if self.fusion != "attention":
            return DecodeCache(ctx_static=ctx_static, cat_emb=cat_emb)
        att_vals = torch.cat(vals, dim=1)
        att_proj = (dot(att_vals, self.att_wf, cdt, self._scale("att_wf"))
                    + self.att_b.float()).to(cdt)
        return DecodeCache(ctx_static=ctx_static, att_vals=att_vals,
                           att_proj=att_proj,
                           att_mask=torch.cat(masks, dim=1), cat_emb=cat_emb)

    def _category_rows(self, category: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
        """(B, C) ``cat_embed`` rows of ``category`` in the compute dtype
        (reference ``cat_embed.astype(cdt)[category]``), None without
        ``use_category``."""
        if not self.use_category:
            return None
        if category is None:
            raise ValueError(
                "model was built with use_category=True but no `category` "
                "ids were passed — a zeroed embedding would silently "
                "degrade decoding")
        ids = torch.as_tensor(category, device=self.device).long()
        return self.cat_embed.to(self.compute_dtype)[ids]

    def init_state(self, batch: int) -> DecodeState:
        """Zero decoder carry for ``batch`` rows, (layers, batch, H)
        (reference ``_init_state``)."""
        shape = (self.num_layers, batch, self.rnn_size)
        return DecodeState(
            h=torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
            c=torch.zeros(shape, dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def init_decode(self, feats, feat_masks, category=None
                    ) -> Tuple[DecodeState, DecodeCache]:
        """(zero state, per-video cache) — reference ``init_decode``,
        the encode of the per-step decode path."""
        cache = self._encode(feats, feat_masks, category)
        return self.init_state(cache.ctx_static.shape[0]), cache

    # --------------------------------------------------------- step math
    def _step_weights(self):
        """(embedding table, every layer's ``lstm{l}_w``, ``att_wh``,
        ``att_v``) in the compute dtype for :meth:`_step` (the attention
        pair None under meanpool): under autograd the parameters'
        differentiable casts, otherwise the cached decode copies
        (``_kernel_weights``)."""
        cdt = self.compute_dtype
        attention = self.fusion == "attention"
        if torch.is_grad_enabled():
            # int8 codes stay codes: the products cast them themselves.
            wc = (lambda x: x) if self.weight_quant else (  # noqa: E731
                lambda x: x.to(cdt))
            att = ((wc(self.att_wh), self.att_v.to(cdt)) if attention
                   else (None, None))
            layers = tuple(wc(getattr(self, f"lstm{l}_w"))
                           for l in range(self.num_layers))
            emb = None if self.vshards is not None else wc(self.word_embed)
            return (emb, layers) + att
        kw = self._kernel_weights()
        return (kw[2], self._kw_layers) + (kw[5:] if attention
                                           else (None, None))

    def _context(self, cache: DecodeCache, h_top: torch.Tensor, rep: int,
                 att_wh, att_v, dot) -> torch.Tensor:
        """Per-step fused context: the static mean-pool, or the Bahdanau
        attention queried by the previous hidden state through the
        ``fused_context_attention`` kernel (reference ``_context``): q =
        T(T(h) @ att_wh) with float32 accumulation, ``dot`` and the
        weights as :meth:`_step` chose them.  Row r of ``h_top`` reads
        cache row ``r // rep``.  Under ``shard_frames`` (``frame_mesh``
        set) the frame axis splits over the mesh's ``model`` axis
        (``parallel/ring.py``), ahead of the kernel, where the frame
        count divides it (the dense kernel otherwise, as the
        reference's fallback)."""
        if self.fusion != "attention":
            ctx = cache.ctx_static
            return ctx.repeat_interleave(rep, dim=0) if rep > 1 else ctx
        cdt = self.compute_dtype
        q = dot(h_top, att_wh, cdt, self._scale("att_wh")).to(cdt)
        mesh = self.frame_mesh
        if (mesh is not None
                and cache.att_vals.shape[1] % mesh.shape["model"] == 0):
            from cst_captioning_torch.parallel.ring import (
                sharded_context_attention,
            )

            r = (lambda x: x.repeat_interleave(rep, dim=0)) if rep > 1 else (
                lambda x: x)  # noqa: E731
            return sharded_context_attention(
                q, r(cache.att_vals), r(cache.att_proj), r(cache.att_mask),
                att_v.to(cdt), mesh, axis="model",
                batch_axis=self.frame_batch_axis)
        return fused_context_attention(q, cache.att_proj, cache.att_mask,
                                       cache.att_vals, att_v, rep=rep)

    def _step(self, state: DecodeState, cache: DecodeCache,
              tokens: torch.Tensor, rep: int = 1, weights=None):
        """One unfused decoder step (reference ``_step`` and
        ``lstm_step``): the context is queried by the top layer's h,
        then layer by layer gates = T([x | h_l]) @ lstm{l}_w + b_l in
        one product with float32 accumulation and the i|f|g|o update
        with a float32 cell; layer 0's x is [emb | ctx | cat], layer
        l's the new h of layer l-1.
        ``weights``: :meth:`_step_weights`, computed here when None.
        Under autograd the products go through ``dot_f32`` (differentiable),
        otherwise through the row-invariant ``row_dot``.  Returns (new
        state, top hidden in the compute dtype)."""
        cdt = self.compute_dtype
        h, c = state
        emb_w, ws, att_wh, att_v = weights or self._step_weights()
        dot = dot_f32 if torch.is_grad_enabled() else row_dot
        parts = [self._embed(tokens, emb_w),
                 self._context(cache, h[-1], rep, att_wh, att_v, dot).to(cdt)]
        if cache.cat_emb is not None:
            cat = cache.cat_emb
            parts.append(cat.repeat_interleave(rep, dim=0) if rep > 1
                         else cat)
        x = torch.cat(parts, dim=-1)
        hs, cs = [], []
        for l, w in enumerate(ws):
            gates = (dot(torch.cat([x, h[l].to(cdt)], dim=-1), w, cdt,
                         self._scale(f"lstm{l}_w"))
                     + getattr(self, f"lstm{l}_b").float())
            h_new, c_new = gate_update(gates, c[l].float())
            x = h_new.to(cdt)
            hs.append(x)
            cs.append(c_new)
        return DecodeState(h=torch.stack(hs), c=torch.stack(cs)), x

    def _logits(self, h: torch.Tensor):
        """float32 vocab logits (reference ``_logits``); a sharded
        vocab gives ``VocabShardedLogits``."""
        if self.vshards is not None:
            return self.vshards.logits(h, self.compute_dtype)
        return (dot_f32(h, self.logit_w, self.compute_dtype,
                               self._scale("logit_w"))
                + self.logit_b.float())

    def _decode_vocab(self, h: torch.Tensor):
        """Unmasked decode logits of ``h`` through ``row_dot``: (rows,
        V) float32, or per-shard tiles under a sharded vocab."""
        if self.vshards is not None:
            return self.vshards.logits(h, self.compute_dtype)
        return (row_dot(h, self._kernel_weights()[3], self.compute_dtype,
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
        return state, self.mask_decode_logits(self._decode_vocab(h_top),
                                              self.decode_suppress_unk)

    @torch.no_grad()
    def decode_verify(self, state: DecodeState, cache: DecodeCache,
                      tokens_k: torch.Tensor, rep: int = 1):
        """``k`` chained decode steps with one vocab product: the verify
        pass of speculative decode (``decoding/speculative.py``;
        reference ``decode_verify``).  ``tokens_k`` (k, B): row 0 each
        row's current token, rows 1.. the draft's proposals.  Returns
        ``(h_all, c_all, logits)``: the (k, layers, B, H) state snapshots
        after consuming ``tokens_k[:j+1]``, and the flat (k*B, V) float32
        decode-policy logits, row ``j*B + b`` batch row ``b``'s after its
        (j+1)-token prefix.  The steps are :meth:`decode_logits`' own and
        the vocab product is its ``row_dot`` over k*B rows, whose rows do
        not depend on the row count, so row ``j*B + b`` is bit for bit
        the plain step's logits."""
        weights = self._step_weights()
        hs, cs, tops = [], [], []
        for j in range(tokens_k.shape[0]):
            state, h_top = self._step(state, cache, tokens_k[j], rep,
                                      weights)
            hs.append(state.h)
            cs.append(state.c)
            tops.append(h_top)
        logits = self._decode_vocab(torch.cat(tops))
        return (torch.stack(hs), torch.stack(cs),
                self.mask_decode_logits(logits, self.decode_suppress_unk))

    @torch.no_grad()
    def _sample_from_cache(self, state: DecodeState, cache: DecodeCache, *,
                           max_len: int = 30, greedy: bool = True,
                           key=None, temperature: float = 1.0,
                           early_exit: bool = True) -> SampleOutput:
        """Per-step decode from a pre-encoded ``(state, cache)`` (reference
        ``_sample_from_cache`` off its fused-sampler route): the unified
        decode core's greedy or sample mode, stopping once every row has
        finished (the steps it skips would only re-write PAD / 0 into
        buffers that start so).  The multinomial mode draws from JAX's
        threefry batch stream on ``key`` (two 32-bit words, a JAX key's
        ``key_data``; None is ``PRNGKey(0)``'s, as in the reference),
        split once a step, through the ``threefry_sample`` kernel.
        ``sample()`` keeps the fused samplers' hash-Gumbel stream on a
        single-layer model and comes here on a stack."""
        B = state.h.shape[1]
        mode = "greedy" if greedy else "sample"
        st = init_core(state, B, 1, max_len, mode=mode,
                       rng=None if greedy else ((0, 0) if key is None else key))

        def step_logits(s, tok):
            return self.decode_logits(s, cache, tok)

        for _ in range(max_len):
            if early_exit and all_done(st):
                break
            st = decode_step(step_logits, st, mode=mode,
                             temperature=temperature)
        return SampleOutput(tokens=st.seqs[:, 0, :], logprobs=st.lps[:, 0, :],
                            mask=(st.seqs[:, 0, :] != PAD_ID).float())

    @staticmethod
    def mask_decode_logits(logits: torch.Tensor,
                           suppress_unk: bool = False) -> torch.Tensor:
        """The decode policy never emits PAD or BOS (and UNK under
        ``suppress_unk``)."""
        if isinstance(logits, VocabShardedLogits):
            return logits.mask_decode(suppress_unk)
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
                category: Optional[torch.Tensor] = None,
                ss_prob: Union[float, torch.Tensor] = 0.0,
                generator: Optional[torch.Generator] = None,
                repeat: int = 1,
                dropout_keep: Optional[torch.Tensor] = None):
        """Teacher-forced forward.  ``input_ids`` (R, T) starts with BOS;
        returns float32 logits (R, T, V) predicting ``input_ids`` shifted
        left.  ``feats`` holds B videos and ``input_ids`` R = B*repeat
        caption rows (row-major per video); ``category`` (B,) the videos'
        category ids under ``use_category``.  ``ss_prob``: scheduled
        sampling's feed probability; a Python ``0.0`` takes the fused
        branches (a stacked attention model the per-step loop without
        draws), anything else the per-step loop (module docstring).
        Output dropout and the scheduled-sampling draws come from
        ``generator`` (on the model's device); without one dropout is off
        and the draws come from a generator seeded 0 (the reference's
        default key).  ``dropout_keep``: the output dropout's keep mask,
        drawn by the caller (:meth:`dropout_mask`; the mesh step draws one
        for the whole batch and hands each data shard its rows), in place
        of the draw from ``generator``.  A sharded vocab returns
        ``VocabShardedLogits``."""
        cache = self._encode(feats, feat_masks, category)
        use_ss = not (isinstance(ss_prob, float) and ss_prob == 0.0)
        if use_ss or (self.fusion == "attention" and self.num_layers > 1):
            h_seq = self._per_step_forward(cache, input_ids,
                                           ss_prob if use_ss else None,
                                           generator, repeat)
        elif self.fusion == "attention":
            h_seq = self._fused_attention_forward(cache, input_ids, repeat)
        else:
            h_seq = self._fused_forward(_repeat_cache(cache, repeat),
                                        input_ids)
        h_seq = self._output_dropout(h_seq, generator, dropout_keep)
        return self._logits(h_seq)

    def _per_step_forward(self, cache: DecodeCache, input_ids: torch.Tensor,
                          ss_prob, generator: Optional[torch.Generator],
                          repeat: int) -> torch.Tensor:
        """The reference's per-step branch (``__call__``'s scan) with
        scheduled sampling.  Step t > 0 feeds row r the token sampled
        from step t-1's logits where ``_feed_mask`` draws True, else
        ``input_ids[r, t]``; step 0 feeds BOS.  ``ss_prob`` None feeds
        ``input_ids`` throughout and draws nothing.  The carry is
        (layers, R, H); the top layer's h is the output.  The attention
        tensors stay per video (``rep = repeat``); under meanpool the static
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
            state, _ = self._step(DecodeState(h=h, c=c), cache, tok, rep,
                                  weights)
            return state.h, state.c

        state = self.init_state(R)
        h, c = state.h, state.c
        hs, sampled = [], None
        for t in range(T):
            tok = input_ids[:, t]
            if t > 0 and ss_prob is not None:
                tok = torch.where(self._feed_mask(R, ss_prob, generator),
                                  sampled, tok)
            if self.remat:
                h, c = checkpoint(step, h, c, tok, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, c = step(h, c, tok)
            hs.append(h[-1])
            if t + 1 < T and ss_prob is not None:
                with torch.no_grad():
                    sampled = self._sample_tokens(self._logits(h[-1]),
                                                  generator)
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
        if isinstance(logits, VocabShardedLogits):
            logits = logits.gather()
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = u.clamp_min_(torch.finfo(torch.float32).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(-1)

    def dropout_mask(self, shape, generator: Optional[torch.Generator],
                     device=None) -> Optional[torch.Tensor]:
        """The output dropout's keep mask of ``shape`` drawn from
        ``generator`` (None when dropout is off)."""
        if generator is None or self.drop_prob <= 0.0:
            return None
        return torch.rand(shape, generator=generator,
                          device=self.device if device is None else device
                          ) < 1.0 - self.drop_prob

    def _output_dropout(self, h_seq: torch.Tensor,
                        generator: Optional[torch.Generator],
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = self.dropout_mask(h_seq.shape, generator, h_seq.device)
        if mask is None or self.drop_prob <= 0.0:
            return h_seq
        keep = 1.0 - self.drop_prob
        return torch.where(mask.to(h_seq.device), h_seq / keep,
                           0.0).to(h_seq.dtype)

    def _fused_forward(self, cache: DecodeCache,
                       input_ids: torch.Tensor) -> torch.Tensor:
        """Batched input GEMMs + the recurrence kernel, one launch a
        layer (reference ``_fused_forward``, meanpool branch): layer 0
        takes ``gx = emb @ W_emb + ([ctx | cat] @ W_static)[:, None] +
        b`` with float32 accumulation (the static rows in one product, as
        the reference's), layer l > 0 ``gx = h_seq @ W_x + b`` on the h
        sequence of the layer below; then ``lstm_recurrence(gx, W_h)``.
        Returns the top layer's h_seq (R, T, H) in the compute dtype."""
        cdt, E = self.compute_dtype, self.embed_size
        x = self._embed(input_ids)
        for l in range(self.num_layers):
            w, ls = getattr(self, f"lstm{l}_w"), self._scale(f"lstm{l}_w")
            d_x = x.shape[-1]
            gx = dot_f32(x, w[:d_x], cdt, ls)
            d_in = d_x
            if l == 0:
                d_in = self.in_dim
                static = cache.ctx_static.to(cdt)
                if cache.cat_emb is not None:
                    static = torch.cat([static, cache.cat_emb.to(cdt)],
                                       dim=-1)
                gstatic = dot_f32(static, w[E: d_in], cdt, ls)
                gx = gx + gstatic[:, None, :]
            gx = gx + getattr(self, f"lstm{l}_b").float()
            if self.weight_quant:
                self._check_forward_only(gx)
                x = lstm_recurrence_quant(gx, w[d_in:], ls, cdt)
            else:
                x = lstm_recurrence(gx, w[d_in:].to(cdt))
        return x

    def _fused_attention_forward(self, cache: DecodeCache,
                                 input_ids: torch.Tensor,
                                 repeat: int = 1) -> torch.Tensor:
        """Batched token-embedding GEMM + the attention recurrence kernel
        (reference ``_fused_attention_forward``; weight rows [emb E |
        ctx E | cat C | hidden H]): ``gx = emb @ W_emb + b`` with float32
        accumulation, plus under ``use_category`` the category rows
        ``cat @ W_cat`` after the bias, then
        ``attlstm_recurrence(gx, W_h, W_ctx, att_wh,
        att_v, att_proj, att_mask, att_vals, repeat)``.  The attention
        tensors stay per video (``cache`` holds B videos, ``input_ids``
        B * repeat caption rows): the kernel reads row r's video r //
        repeat, where the reference repeats the cache to the rows first
        (the same forward, bitwise).  Returns h_seq (R, T, H) in the
        compute dtype."""
        cdt, E, d_in = self.compute_dtype, self.embed_size, self.in_dim
        w, ls = self.lstm0_w, self._scale("lstm0_w")
        emb = self._embed(input_ids)
        gx = dot_f32(emb, w[:E], cdt, ls) + self.lstm0_b.float()
        if cache.cat_emb is not None:
            # Per caption row: the reference repeats the cache first.
            cat = cache.cat_emb.repeat_interleave(repeat, dim=0)
            gx = gx + dot_f32(cat, w[2 * E: d_in], cdt, ls)[:, None, :]
        if self.weight_quant:
            self._check_forward_only(gx, cache.att_proj, cache.att_vals)
            return attlstm_recurrence_quant(
                gx, w[d_in:], w[E: 2 * E], ls, self.att_wh,
                self.att_wh_scale, self.att_v.to(cdt), cache.att_proj,
                cache.att_mask, cache.att_vals, cdt, rep=repeat)
        return attlstm_recurrence(
            gx, w[d_in:].to(cdt), w[E: 2 * E].to(cdt), self.att_wh.to(cdt),
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
        bias, plus under ``use_category`` the category rows ``cat_emb @
        lstm0_w[2E:2E+C]`` (their own f32-accumulated product, the lstm
        scale after it under int8w), plus under meanpool the static
        context's rows ``ctx_static @ lstm0_w[E:2E]``, summed in that
        order (reference ``_fused_gx_static`` + the meanpool ``gctx``;
        row-invariant, like the encode).  Attention computes its context
        per step in the kernel."""
        cdt, ls = self.compute_dtype, self._scale("lstm0_w")
        B = cache.ctx_static.shape[0]
        kw = self._kernel_weights()
        gx = self.lstm0_b.float()[None, :].expand(B, -1)
        if cache.cat_emb is not None:
            gx = gx + row_dot(cache.cat_emb, self._kw_cat, cdt, ls)
        if self.fusion == "attention":
            return gx.contiguous()
        gctx = row_dot(cache.ctx_static, kw[4], cdt, ls)
        return (gx + gctx).contiguous()

    def _kernel_weights(self):
        """(w_x, wh, emb, w_out, w_ctx), plus (att_wh, att_v) under
        attention fusion, in the compute dtype — the decode kernels'
        operands; w_x, wh and w_ctx are row blocks of ``_kw_layers[0]``,
        the whole ``lstm0_w`` in the compute dtype, as is ``_kw_cat``,
        the category rows (None without ``use_category``).
        ``_kw_layers`` holds every layer's ``lstm{l}_w`` in the compute
        dtype (the per-step gate products' operands).  Under
        ``weight_quant`` the quantized ones are the int8 codes
        themselves, never a float copy.  Cached per parameter version,
        since the bf16 copies of the vocab-sized weights cost a pass over
        them.  Every float operand is a copy, also where the leaf is
        already in the compute dtype (bf16 leaves at a bf16 compute
        dtype, f32 at f32): a staged operand never aliases a leaf that an
        optimizer's in-place update rewrites, and the version key rebuilds
        the copies after one."""
        key = tuple(p._version for p in self.parameters()) + (
            self.compute_dtype, self.device)
        if getattr(self, "_kw_key", None) != key:
            cdt, E, d_in = self.compute_dtype, self.embed_size, self.in_dim
            cast = lambda x: (  # noqa: E731
                x.detach().contiguous() if x.dtype == torch.int8
                else x.detach().to(cdt, memory_format=torch.contiguous_format,
                                   copy=True))
            layers = tuple(cast(getattr(self, f"lstm{l}_w"))
                           for l in range(self.num_layers))
            full = layers[0]
            self._kw_cat = full[2 * E: d_in] if self.use_category else None
            # A sharded vocab keeps its tiles in ``vshards``.
            ws = [full[:E], full[d_in:]] + (
                [None, None] if self.vshards is not None else
                [cast(x) for x in (self.word_embed, self.logit_w)])
            ws += [full[E: 2 * E]]
            if self.fusion == "attention":
                ws += [cast(x) for x in (self.att_wh, self.att_v)]
            self._kw_layers = layers
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

    def decodes_fused(self, what: str) -> bool:
        """Whether the whole-recurrence ``what`` decoder (``"beam"`` or
        ``"sample"``) takes this model's decodes: a single-layer model's.
        A stack takes the per-step decode instead, as the reference's
        gates send it (``warn_fused_decline``, logged once a model and
        decoder); the choice is the configuration's alone.  On a mesh
        (``model_from_config(mesh=...)``) the whole-recurrence decoders
        run only as the sharded port of a (1, M) vocab split
        (``decode_mesh``); any other mesh declines them with
        ``mesh_decline[what]``'s reason."""
        kind = ("attlstm_" if self.fusion == "attention" else "lstm_") + what
        reason = None
        if self.num_layers != 1:
            reason = (f"num_layers={self.num_layers} (the kernel covers "
                      "single-layer decoders)")
        elif what in self.mesh_decline:
            reason = self.mesh_decline[what]
        elif self.vshards is not None and self.decode_mesh is None:
            reason = "vocab sharded with no sharded decode port engaged"
        if reason is None:
            return True
        if kind not in self._declined:
            self._declined.add(kind)
            warn_fused_decline(kind, reason)
        return False

    def _vocab_operands(self):
        """(emb, w_out, b_out, int8w keywords) of a whole-recurrence
        decoder: the full tensors, or under ``decode_mesh`` the shards
        of ``vshards`` for ``ops/shard_decode.py``."""
        if self.vshards is None:
            _, _, emb, w_out = self._kernel_weights()[:4]
            return emb, w_out, self.logit_b.float(), self._decode_quant()
        vs, cdt = self.vshards, self.compute_dtype
        embs = [x if x.dtype == torch.int8 else x.detach().to(cdt)
                for x in vs.leaves["word_embed"]]
        q = {}
        if self.weight_quant:
            quant = (vs.scales("word_embed"), vs.scales("logit_w"),
                     self.lstm0_w_scale)
            if self.fusion == "attention":
                quant += (self.att_wh_scale,)
            q = dict(quant=quant, compute_dtype=cdt)
        return (embs, vs.tiles(cdt),
                [b.detach().float() for b in vs.leaves["logit_b"]], q)

    @torch.no_grad()
    def fused_beam(self, feats, feat_masks, category=None, *, beam_size: int,
                   max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode once, then the whole beam recurrence in the
        ``lstm_beam`` kernel (``attlstm_beam`` under attention fusion);
        a stack (:meth:`decodes_fused`) runs the per-step beam from the
        encode.  Returns the raw ``(seqs (B, K, L), scores (B, K))`` for
        ``decoding.beam.finalize_beams``."""
        if not self.decodes_fused("beam"):
            from cst_captioning_torch.decoding.beam import per_step_beam

            return per_step_beam(self, *self.init_decode(
                feats, feat_masks, category), beam_size=beam_size,
                max_len=max_len)
        cache = self._encode(feats, feat_masks, category)
        w_x, wh = self._kernel_weights()[:2]
        emb, w_out, b_out, q = self._vocab_operands()
        common = dict(beam_size=beam_size, max_len=max_len,
                      suppress_unk=self.decode_suppress_unk, **q)
        att, mp = attlstm_beam, lstm_beam
        if self.decode_mesh is not None:
            from cst_captioning_torch.ops import shard_decode

            att = shard_decode.sharded_attlstm_beam
            mp = shard_decode.sharded_lstm_beam
            common["mesh"] = self.decode_mesh
        if self.fusion == "attention":
            return att(self._fused_gx_static(cache), w_x, wh,
                       *self._att_operands(cache), emb, w_out, b_out,
                       **common)
        return mp(self._fused_gx_static(cache), w_x, wh, emb, w_out, b_out,
                  **common)

    @torch.no_grad()
    def sample(self, feats, feat_masks, category=None, *, max_len: int = 30,
               greedy: bool = True, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               repeat: int = 1) -> SampleOutput:
        """Greedy (``greedy=True``) or temperature-multinomial decode of
        up to ``max_len`` tokens through the ``lstm_sample`` kernel
        (``attlstm_sample`` under attention fusion; a stack, and a
        multinomial draw the sampler gate declines, take
        :meth:`sample_cache`'s per-step route).  ``repeat``: rollouts
        per video (CST's S samples), rows ``i*repeat..(i+1)*repeat-1``
        for video i; the cache is tiled after the feature projections
        (:func:`_repeat_cache`), so S rollouts cost S decodes and one
        encode.  The multinomial stream's two seed words come from
        ``generator`` (:func:`draw_seeds`; greedy ignores them, and
        without a generator they are ``(0, 0)``)."""
        cache = _repeat_cache(self._encode(feats, feat_masks, category),
                              repeat)
        seed = ((0, 0) if greedy or generator is None
                else draw_seeds(generator, 1)[0])
        return self.sample_cache(cache, seed, max_len=max_len, greedy=greedy,
                                 temperature=temperature)

    @torch.no_grad()
    def sample_with_baseline(self, feats, feat_masks, *,
                             generator: torch.Generator, max_len: int = 30,
                             temperature: float = 1.0, repeat: int = 1,
                             with_greedy: bool = True, category=None):
        """The multinomial rollout (``repeat`` rows per video) and the
        greedy-baseline decode from one feature encode (reference
        ``sample_with_baseline``).  Returns ``(rollout, greedy or
        None)``."""
        cache = self._encode(feats, feat_masks, category)
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
        row for row.

        The per-step decode from a zero state (:meth:`_sample_from_cache`)
        takes the rows instead where the reference's gates send them
        there: a stack (:meth:`decodes_fused`), and a multinomial draw
        that the sampler gate declines (:meth:`fused_sampler_takes`:
        ``model.use_pallas_sampler`` off, or a row count that
        :func:`sampler_batch_ok` refuses).  There ``seed`` is the threefry
        key the reference hands ``_sample_from_cache`` as ``rng`` (its two
        ``key_data`` words), so one key gives both packages the same
        tokens.  A greedy decode keeps the fused kernel on a single
        layer: greedy is deterministic, so either route gives its
        tokens."""
        if not self.decodes_fused("sample") or (
                not greedy
                and not self.fused_sampler_takes(cache.ctx_static.shape[0])):
            return self._sample_from_cache(
                self.init_state(cache.ctx_static.shape[0]), cache,
                max_len=max_len, greedy=greedy,
                key=None if greedy else seed, temperature=temperature)
        w_x, wh = self._kernel_weights()[:2]
        emb, w_out, b_out, q = self._vocab_operands()
        common = dict(max_len=max_len, greedy=greedy, temperature=temperature,
                      suppress_unk=self.decode_suppress_unk, **q)
        att, mp = attlstm_sample, lstm_sample
        if self.decode_mesh is not None:
            from cst_captioning_torch.ops import shard_decode

            att = shard_decode.sharded_attlstm_sample
            mp = shard_decode.sharded_lstm_sample
            common["mesh"] = self.decode_mesh
        if self.fusion == "attention":
            toks, lps, mask = att(
                self._fused_gx_static(cache), w_x, wh,
                *self._att_operands(cache), emb, w_out, b_out, seed,
                **common)
        else:
            toks, lps, mask = mp(
                self._fused_gx_static(cache), w_x, wh, emb, w_out, b_out,
                seed, **common)
        return SampleOutput(tokens=toks, logprobs=lps, mask=mask)

    def fused_sampler_takes(self, rows: int) -> bool:
        """Whether a multinomial draw of ``rows`` rows takes the fused
        sampler (reference ``_sample_from_cache``'s gate): only with
        ``model.use_pallas_sampler`` set and ``rows`` passing
        :func:`sampler_batch_ok`; a refused row count is logged once a
        model."""
        if not self.use_pallas_sampler:
            return False
        if sampler_batch_ok(rows):
            return True
        if "use_pallas_sampler" not in self._declined:
            self._declined.add("use_pallas_sampler")
            warn_fused_decline("use_pallas_sampler",
                               f"shape gate: B={rows} is not a positive "
                               "multiple of 8")
        return False


def draw_seeds(generator: torch.Generator, n: int) -> List[Tuple[int, int]]:
    """``n`` pairs of 32-bit seed words of the multinomial stream, drawn
    from ``generator`` on its own device in one call (one host read)."""
    words = torch.randint(0, 2 ** 32, (n, 2), generator=generator,
                          device=generator.device, dtype=torch.long)
    return [(int(a), int(b)) for a, b in words.tolist()]


SERVING_DTYPES = ("f32", "bf16", "int8w")


def model_from_config(cfg, serving_dtype: Optional[str] = None,
                      device=None, mesh=None) -> CaptionModel:
    """Build a :class:`CaptionModel` from a ``Config`` (reference
    ``model_from_config``).  ``serving_dtype`` is the serving override
    (``serving.dtype``, passed by the inference engine only): ``f32`` or
    None leaves the model as configured, ``bf16`` forces the bfloat16
    compute dtype, ``int8w`` also sets ``weight_quant``;
    ``model.compute_dtype`` as :func:`resolve_compute_dtype` reads it.
    Parameters live
    on ``device``: ``cuda`` unless the caller passes ``"cpu"``, in
    ``model.param_dtype`` (:func:`resolve_param_dtype`: float32,
    bfloat16 or float16 leaves, float64 truncated to float32 with a
    warning; the int8w scales float32 whatever it says).

    ``mesh`` (``parallel/mesh.py``) sets the reference's gates; placing
    the parameters is the caller's (``CaptionModel.shard_vocab``, the
    trainer's ``training/sharded.py``, the engine's model-shards block):

    * the whole-recurrence decoders (``model.use_pallas_sampler`` /
      ``use_pallas_beam``, through ``decoding/core.py::kernel_supports``)
      decline on more than one layer and on a data-sharded mesh, and on
      a model-sharded one run as the sharded port (``decode_mesh``,
      ``ops/shard_decode.py``) where ``shard_decode_ok`` holds, each
      decline logged with the reference's reason.  A flag that is off
      declines too: its decodes take the per-step route;
    * ``model.shard_frames`` splits the attention frames over the mesh's
      ``model`` axis (``frame_mesh``), with the batch over ``data``.

    Where the reference turns ``use_pallas_attention`` off on a
    multi-device mesh (its kernel has no SPMD partitioning rule), the
    port keeps its ``fused_context_attention`` kernel: each shard's rows
    sit on the shard's own device, and the kernel's per-row results do
    not depend on the other rows."""
    m, d = cfg.model, cfg.data
    param_dtype = resolve_param_dtype(m.param_dtype)
    if serving_dtype is not None and serving_dtype not in SERVING_DTYPES:
        raise ValueError(f"unknown serving.dtype {serving_dtype!r}; "
                         f"expected one of {SERVING_DTYPES}")
    compute_dtype = m.compute_dtype
    if serving_dtype in ("bf16", "int8w"):
        compute_dtype = "bfloat16"
    # Resolved (and float64's warning given) once.
    cdt = resolve_compute_dtype(compute_dtype)
    compute_dtype = str(cdt).replace("torch.", "")
    if m.vocab_size <= 0:
        raise ValueError("model.vocab_size is not set")
    shard_frames = bool(m.shard_frames) and mesh is not None
    if shard_frames and m.feature_fusion != "attention":
        raise ValueError(
            "model.shard_frames requires feature_fusion='attention' "
            "(meanpool has no per-step frame attention to shard)")
    if shard_frames and "model" not in mesh.shape:
        raise ValueError(
            "model.shard_frames shards frames over the mesh 'model' axis, "
            f"but the mesh has axes {tuple(mesh.shape)} — add a model axis "
            "to train.mesh_shape")
    model = CaptionModel(
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
        num_categories=d.num_categories,
        category_embed_size=m.category_embed_size,
        drop_prob=m.drop_prob,
        remat=cfg.train.remat,
        weight_quant=serving_dtype == "int8w",
        use_pallas_sampler=m.use_pallas_sampler,
        param_dtype=param_dtype,
        device=resolve_device(device),
    )
    if mesh is not None and mesh.size > 1:
        _mesh_gates(model, cfg, mesh)
        if shard_frames:
            model.frame_mesh = mesh
            model.frame_batch_axis = (
                "data" if mesh.shape.get("data", 1) > 1 else None)
    return model


def _mesh_gates(model: CaptionModel, cfg, mesh) -> None:
    """The reference's decode-kernel gates on a mesh (see
    :func:`model_from_config`): sets ``decode_mesh`` and the declined
    decoders' ``mesh_decline`` reasons."""
    from cst_captioning_torch.decoding.core import kernel_supports
    from cst_captioning_torch.ops.shard_decode import shard_decode_ok

    m = cfg.model
    model_ways = mesh.shape.get("model", 1)
    data_ways = mesh.size // model_ways

    def gate(flag: str) -> Optional[str]:
        if not getattr(m, flag, False):
            return f"model.{flag} is off"
        if m.num_layers != 1:
            return (f"num_layers={m.num_layers} (kernel covers "
                    "single-layer decoders)")
        if data_ways > 1 and not kernel_supports(flag, "data"):
            return (f"{mesh.size}-device mesh with batch sharding "
                    f"({data_ways}-way data) — no sharded port covers the "
                    "batch axis")
        if model_ways > 1:
            if not kernel_supports(flag, "model"):
                return (f"vocab sharded {model_ways}-way over `model` — no "
                        "cross-shard merge port for this kernel")
            if not shard_decode_ok(m.vocab_size, model_ways,
                                   cfg.eval.beam_size):
                return (f"vocab {m.vocab_size} does not tile evenly over "
                        f"the {model_ways}-way model axis (need V % M == 0 "
                        "and V/M >= beam width) — pad the vocab for the "
                        "sharded fast path")
        return None

    for what, flag in (("sample", "use_pallas_sampler"),
                       ("beam", "use_pallas_beam")):
        reason = gate(flag)
        if reason is not None:
            model.mesh_decline[what] = reason
            if getattr(m, flag, False):
                warn_fused_decline(flag, reason)
    if model_ways > 1 and len(model.mesh_decline) < 2:
        model.decode_mesh = mesh
