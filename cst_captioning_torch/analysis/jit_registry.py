"""The port's registries, as literal data the rules read.

Each registry is guarded both ways: a live site with no entry fires,
and so does an entry that matches no live site.

* ``JIT_SITE_REGISTRY`` — the kernel-site registry: one entry per
  ``_build.load("<kernel>")`` call site, keyed ``<file>::<qualname>``,
  naming the kernel it loads; ``budget`` answers what bounds the builds
  there.  Entries with ``update_step=True`` are the in-place update
  steps CST-DON-001 and CST-DTY-004 audit (CST-DON-002 / 003).
* ``AOT_SITE_REGISTRY`` — the ahead-of-time build and install sites
  (CST-DON-004 / 005).
* ``SHARD_MAP_REGISTRY`` — every call into ``parallel/collectives.py``
  or ``parallel/ring.py`` from outside ``parallel/``, and every
  ``torch.distributed`` collective, with the collective layout it buys
  (CST-SHD-004).
* ``SHARDING_CONSTRAINT_REGISTRY`` — the placement pins: ``shard_tree``
  / ``shard_leaf`` / ``gather_tree`` call sites outside ``parallel/``
  (CST-SHD-002).
* ``CAST_REGISTRY`` — every function of the device surface that casts,
  with the parity tier its casts preserve (CST-DTY-001 / 003).
* ``SHAPE_LADDER_REGISTRY`` — the shape family every kernel site sees,
  with its bucket functions (CST-SHP-001); ``AOT_VARIANT_RUNNERS`` names
  the method that runs a slot-loop variant kind where the
  ``_<kind>_fn`` / ``<kind>`` / ``_<kind>`` convention does not
  (CST-SHP-002).
* ``DEVICE_ROOTS`` — the entry functions of the port's device surface.
  The port has no ``torch.compile`` root; the closure of these entries
  over the package call graph is the traced surface CST-DTY reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class JitSite(NamedTuple):
    budget: str
    kernels: Tuple[str, ...] = ()
    update_step: bool = False


# One nvcc run per kernel and build directory (the library is named by
# the digest of its sources and flags, so a second process finds it).
NVCC_RUNS_PER_KERNEL = 1

_KERNEL_BUDGET = (
    "at most one nvcc run per (source digest, sm_90a) and build "
    "directory, cached across processes under _kernels_build/; none "
    "under an artifact boot, which serves the artifact's copy and "
    "refuses any other name"
)

JIT_SITE_REGISTRY: Dict[str, JitSite] = {
    # ------------------------------------------------ kernel load sites
    "ops/beam.py::_bound": JitSite(
        _KERNEL_BUDGET + "; one library holds both beam decoders (lstm "
        "and attention, float and int8w)",
        ("lstm_beam",),
    ),
    "ops/sampler.py::_bound": JitSite(
        _KERNEL_BUDGET + "; one library holds both sampling decoders",
        ("lstm_sample",),
    ),
    "ops/lstm.py::_bound": JitSite(
        _KERNEL_BUDGET + "; forward, persistent bf16 cluster path and "
        "int8w variant share the library",
        ("lstm_recurrence",),
    ),
    "ops/attlstm.py::_bound": JitSite(
        _KERNEL_BUDGET + "; forward, backward and int8w variant share "
        "the library",
        ("attlstm_recurrence",),
    ),
    "ops/attention.py::_bound": JitSite(
        _KERNEL_BUDGET, ("context_attention",),
    ),
    "ops/attention.py::_bound_bwd": JitSite(
        _KERNEL_BUDGET, ("context_attention_bwd",),
    ),
    "ops/rowgemm.py::_bound": JitSite(
        _KERNEL_BUDGET + "; float and int8 weights share the library",
        ("row_gemm",),
    ),
    "ops/threefry.py::_bound": JitSite(
        _KERNEL_BUDGET, ("threefry_sample",),
    ),
    # ------------------------------------------- in-place update steps
    "training/steps.py::Optimizer.step": JitSite(
        "no kernel: the Adam / RMSprop / SGD update writes parameters and "
        "moments in place (copy_, add_), the port's donation",
        update_step=True,
    ),
    "training/sharded.py::MeshModel.broadcast": JitSite(
        "no kernel: the 2D step's owner copies are written into every "
        "other data shard's replica in place (copy_) after the update",
        update_step=True,
    ),
}


def kernel_names() -> Tuple[str, ...]:
    """Every kernel the registered load sites name, sorted."""
    return tuple(sorted({
        k for e in JIT_SITE_REGISTRY.values() for k in e.kernels
    }))


def nvcc_budget() -> int:
    """The most nvcc runs one process may start, by the registry."""
    return NVCC_RUNS_PER_KERNEL * len(kernel_names())


AOT_SITE_REGISTRY: Dict[str, str] = {
    "serving/artifact.py::build_artifact": (
        "the artifact build: one nvcc per missing library, exactly "
        "the kernels the engine's paths load (_kernel_digests), ships "
        "each library with its digest and sha256, and records the "
        "variant signatures SlotDecoder.aot_signatures enumerates from "
        "the same ladders warmup walks"
    ),
    "serving/artifact.py::load_engine": (
        "artifact boot: loads the shipped libraries only after the "
        "manifest's fingerprint, serving dtype, scale hashes, kernel "
        "digests and re-derived variant signatures equal the live "
        "engine's (ArtifactMismatchError otherwise); "
        "load_artifact_kernels checks every digest and checksum and pins "
        "the process to them, so no nvcc runs after it"
    ),
}

SHARD_MAP_REGISTRY: Dict[str, str] = {
    "decoding/core.py::_tp_log_softmax": (
        "the vocab-sharded beam log-softmax: one pmax of per-shard (rows, "
        "1) maxima and the float64 sums of exp folded by psum in shard "
        "order — (rows, 1) per shard crosses devices, never the (rows, V) "
        "logits"
    ),
    "models/captioner.py::CaptionModel._context": (
        "frames sharded over `model` (model.shard_frames): "
        "ring.sharded_context_attention scores each shard's F/M frames "
        "where they live and sums the (rows, E) contexts in shard order "
        "instead of gathering every frame onto one device"
    ),
    "models/vocab_shards.py::VocabShards.embed": (
        "embedding rows of the vocab-sharded word_embed: each shard looks "
        "up the ids in its row range and the (rows, E) partials add in "
        "shard order (embedding_rows); the table is never gathered"
    ),
    "models/vocab_shards.py::VocabShards.logits": (
        "logits stay per-shard vocab tiles (VocabShardedLogits) on their "
        "devices; consumers merge log-softmax statistics or top-K "
        "candidates instead of gathering (rows, V)"
    ),
    "ops/losses.py::_token_logprobs": (
        "the XE loss's token log-probs through token_logprobs: on vocab "
        "tiles the vocab-parallel log-softmax (per-shard max and sum of "
        "exp folded in shard order, the target's tile picked), so the "
        "loss never gathers (B, T, V)"
    ),
    "ops/shard_decode.py::_sharded_beam_impl": (
        "the sharded beam decoder's plain version: each step's token "
        "embedding from the vocab-sharded table by embedding_rows, one "
        "(rows, E) sum in shard order"
    ),
    "ops/shard_decode.py::_sharded_sample_impl": (
        "the sharded sampler's plain version: the same embedding_rows "
        "feed as the sharded beam"
    ),
    "parallel/distributed.py::all_reduce_grads": (
        "one all-reduce SUM per folded gradient across processes (the "
        "NCCL / gloo ring's order, fixed for a world size) after the "
        "single-controller mesh's own fixed-order fold"
    ),
    "parallel/distributed.py::stop_agreed": (
        "one int32 all-reduce MAX of the stop flag at a step boundary, so "
        "every rank leaves the epoch at the same step and none waits "
        "forever in the next collective"
    ),
    "training/cst.py::pg_loss": (
        "the PG loss's token log-probs through token_logprobs, the "
        "vocab-parallel log-softmax on tiles, as the XE loss"
    ),
    "training/sharded.py::_fold_and_update": (
        "per-leaf gradients of every data shard summed in shard order "
        "onto the owner copy's device (psum) before one optimizer step: "
        "the single-device gradient up to the order of its sums"
    ),
    "training/sharded.py::make_mesh_xe_train_step.train_step": (
        "the data shards' XE losses (each over the whole batch's mask "
        "sum) added in shard order on the lead device"
    ),
    "training/sharded.py::MeshPlacement.update": (
        "the PG update's per-shard losses added in shard order on the "
        "lead device, as the XE step's"
    ),
}

SHARDING_CONSTRAINT_REGISTRY: Dict[str, str] = {
    "models/vocab_shards.py::VocabShards.split": (
        "places each vocab-sized leaf by the rule table: its vocab block "
        "copied to every model-shard device, so the logit and embedding "
        "products run where their tile lives"
    ),
    "models/vocab_shards.py::VocabShards.place": (
        "lays a full tensor (a checkpoint leaf, an Adam moment) out like "
        "its parameter's shards, so loads and updates stay shard-local"
    ),
    "models/vocab_shards.py::VocabShards.gather": (
        "reassembles full leaves on one device for the one-device "
        "checkpoint format; never on a step's path"
    ),
}


# Every function of the device surface that casts, keyed
# ``<file>::<qualname>`` (lambdas folded into their def): the tier names
# what the casts there preserve against the reference, the justification
# why.  ``low_precision=True`` marks the functions that compute in the
# configurable compute dtype (bf16 under serving.dtype / the presets):
# CST-DTY-003 holds every product there to the f32-accumulating helpers.
class CastSite(NamedTuple):
    tier: str                      # a PARITY_TIERS member (docs/PARITY.md)
    justification: str
    low_precision: bool = False


# The legal parity-tier vocabulary (docs/PARITY.md), strongest first:
#   bit-exact       same bits as the reference path
#   token-exact     same decoded tokens (float association may differ)
#   relaxed-rtol    training-loss tier: agreement within an rtol
#   relaxed-serving low-precision serving (bf16 / int8w): tokens may
#                   move within the serving bounds
PARITY_TIERS = frozenset({
    "bit-exact",
    "token-exact",
    "relaxed-rtol",
    "relaxed-serving",
})

CAST_REGISTRY: Dict[str, CastSite] = {
    "decoding/core.py::_ordered_bits": CastSite(
        "bit-exact",
        "the order-preserving int64 key of a float32 score: .float() "
        "is a no-op on the f32 log-probs it is given and the int32 "
        "bit view widens exactly to int64",
    ),
    "decoding/core.py::beam_log_softmax": CastSite(
        "token-exact",
        "log-softmax in float32 of float32 logits; the float64 sum of "
        "exps rounds back once, so shards fold to the same f32 "
        "normalizer (PARITY r12)",
    ),
    "decoding/core.py::decode_step": CastSite(
        "token-exact",
        "index and mask plumbing: the write-position compare widens "
        "int32 steps to int64, emitted token ids (< V) narrow exactly "
        "to the int32 history, and sample mode's logits are already "
        "float32",
    ),
    "models/captioner.py::CaptionModel._category_rows": CastSite(
        "token-exact",
        "category ids widened to int64 for the lookup; the category "
        "table rounded to the compute dtype as the reference's "
        "T(cat_embed)",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._context": CastSite(
        "token-exact",
        "the attention query rounded to the compute dtype after the "
        "f32-accumulated product, and att_v in the compute dtype for "
        "the frame-sharded path — the reference's rounding points",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._decode_vocab": CastSite(
        "token-exact",
        "the float32 logit bias added to row_dot's float32 logits (a "
        "no-op cast of f32 parameters)",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._embed": CastSite(
        "token-exact",
        "the embedding table rounded to the compute dtype before the "
        "lookup, the reference's T(word_embed)[ids]",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._encode": CastSite(
        "token-exact",
        "features and projections rounded to the compute dtype around "
        "f32-accumulated products, the mean-pool and masks in float32 "
        "— the reference's encode rounding points",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._fused_attention_forward": CastSite(
        "token-exact",
        "the recurrence kernels' operands staged in the compute dtype "
        "(weights, att_v) beside the f32 bias, exactly the operands "
        "the reference's fused forward rounds",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._fused_forward": CastSite(
        "token-exact",
        "the static context and recurrence weights staged in the "
        "compute dtype, biases added in float32 — the reference's "
        "fused XE forward",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._fused_gx_static": CastSite(
        "token-exact",
        "the lstm0 bias widened to float32 and broadcast into the "
        "static gate input (exact from any param_dtype leaf)",
    ),
    "models/captioner.py::CaptionModel._kernel_weights": CastSite(
        "token-exact",
        "the decoders' weights rounded once to the compute dtype "
        "(int8 codes kept), the reference's T(w) in the fused kernels; "
        "a copy even where the leaf is already in it (bf16 leaves), so "
        "no staged operand aliases a leaf the update rewrites",
    ),
    "models/captioner.py::CaptionModel._logits": CastSite(
        "token-exact",
        "the logit bias widened to float32 (exact from any "
        "param_dtype leaf) and added to the f32-accumulated vocab "
        "product",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._output_dropout": CastSite(
        "relaxed-rtol",
        "the dropout mask moved to the activations' device and the "
        "kept units scaled in the activations' dtype, as the "
        "reference's training-only dropout",
    ),
    "models/captioner.py::CaptionModel._sample_from_cache": CastSite(
        "bit-exact",
        "the emitted-token mask widened from bool to float32 (exact 0 "
        "/ 1)",
    ),
    "models/captioner.py::CaptionModel._step": CastSite(
        "token-exact",
        "one decode step: layer inputs and the attention context "
        "rounded to the compute dtype before the f32-accumulated gate "
        "product, h and c kept in float32 — the reference's per-step "
        "rounding points",
        low_precision=True,
    ),
    "models/captioner.py::CaptionModel._step_weights": CastSite(
        "token-exact",
        "the step's weights rounded once to the compute dtype (int8 "
        "codes kept), reused by every step",
    ),
    "models/captioner.py::CaptionModel._vocab_operands": CastSite(
        "token-exact",
        "the decoders' vocab operands: table and tiles in the compute "
        "dtype, biases in float32 — the fused kernels' operand dtypes",
    ),
    "ops/attention.py::_launch_fwd": CastSite(
        "bit-exact",
        "the frame mask staged as float32 for the kernel (exact 0 / "
        "1)",
    ),
    "ops/attention.py::fused_context_attention_bwd_ref": CastSite(
        "token-exact",
        "the context backward's plain version: cotangents in the work "
        "dtype, rounded once to the primals' dtypes, the kernel's and "
        "the reference's VJP rounding points",
    ),
    "ops/attention.py::fused_context_attention_ref": CastSite(
        "token-exact",
        "the context kernel's plain version: scores, softmax and sum "
        "in the work dtype, the context rounded once to the compute "
        "dtype",
        low_precision=True,
    ),
    "ops/attlstm.py::_bwd_core_ref": CastSite(
        "token-exact",
        "the attention recurrence backward's plain version: residuals "
        "and cotangents in the work dtype, the query rounded to the "
        "compute dtype as the forward rounded it",
    ),
    "ops/attlstm.py::_dot": CastSite(
        "token-exact",
        "the plain recurrence's pinned product: dot_f32 for f32 / "
        "bf16 (operands rounded, f32 accumulation), float64 operands "
        "multiplied in float64 for gradcheck",
    ),
    "ops/attlstm.py::_finish_bwd": CastSite(
        "token-exact",
        "the weight cotangents contracted in the work dtype and "
        "rounded once to each primal's dtype",
    ),
    "ops/attlstm.py::_launch_fwd_tc": CastSite(
        "bit-exact",
        "the frame mask staged as float32 for the kernel (exact 0 / "
        "1)",
    ),
    "ops/attlstm.py::_launch_fwd_f32": CastSite(
        "bit-exact",
        "the frame mask staged as float32 for the kernel (exact 0 / "
        "1)",
    ),
    "ops/attlstm.py::attention_step": CastSite(
        "token-exact",
        "the attention query rounded to the compute dtype before the "
        "context, the reference's T(q)",
        low_precision=True,
    ),
    "ops/attlstm.py::attlstm_recurrence_bwd_core": CastSite(
        "bit-exact",
        "the h cotangent staged as float32 for the backward kernel "
        "(no-op on f32, exact widening of bf16)",
    ),
    "ops/attlstm.py::attlstm_recurrence_quant": CastSite(
        "relaxed-serving",
        "int8w codes widened to the bf16 the kernel reads (exact, "
        "|code| <= 127); the scales stay float32",
    ),
    "ops/attlstm.py::attlstm_recurrence_quant_ref": CastSite(
        "relaxed-serving",
        "the int8w recurrence's plain version: codes dequantized "
        "after f32 accumulation, h rounded to the compute dtype per "
        "step",
        low_precision=True,
    ),
    "ops/attlstm.py::attlstm_recurrence_ref": CastSite(
        "token-exact",
        "the attention recurrence's plain version: operands in the "
        "work dtype, the query and h rounded to the compute dtype per "
        "step, the kernel's rounding points",
        low_precision=True,
    ),
    "ops/attlstm.py::tanh_of": CastSite(
        "token-exact",
        "tanh of proj + query (in the values' dtype) taken in the working "
        "dtype, rounded to float16 at float16 as XLA runs the reference — "
        "the kernels' and the reference's attention tanh",
        low_precision=True,
    ),
    "ops/beam.py::_beam_ref": CastSite(
        "token-exact",
        "the beam decoders' plain version: operands rounded to the "
        "compute dtype around f32-accumulated products, scores and "
        "masks in float32, the emitted ids narrowed exactly to int32",
        low_precision=True,
    ),
    "ops/beam.py::_launch": CastSite(
        "bit-exact",
        "masks and the static gate input staged as float32 for the "
        "beam kernel (exact or no-op)",
    ),
    "ops/decode_common.py::decode_bias": CastSite(
        "bit-exact",
        "the logit bias copied into the padded float32 bias row (no- "
        "op on f32)",
    ),
    "ops/decode_common.py::gumbel_from_counter": CastSite(
        "bit-exact",
        "24 uniform bits to float32, exact (< 2**24), then scaled by "
        "a power of two",
    ),
    "ops/decode_common.py::masked_vocab": CastSite(
        "token-exact",
        "the vocab tile rounded to the compute dtype, the reference's "
        "T(w_out)",
        low_precision=True,
    ),
    "ops/decode_common.py::masked_vocab_q": CastSite(
        "relaxed-serving",
        "the int8w vocab scales read as float32 (their stored dtype)",
        low_precision=True,
    ),
    "ops/decode_common.py::stage_tc_weights": CastSite(
        "token-exact",
        "the tensor-core operands staged in bf16: the weights the "
        "plain version rounds to bf16, or int8 codes widened exactly",
    ),
    "ops/losses.py::reward_criterion": CastSite(
        "relaxed-rtol",
        "the PG loss's reduction in float32 whatever the activation "
        "dtype",
    ),
    "ops/losses.py::weighted_cross_entropy": CastSite(
        "relaxed-rtol",
        "the WXE reduction in float32: mask and caption weights "
        "widened",
    ),
    "ops/lstm.py::lstm_recurrence_quant_ref": CastSite(
        "relaxed-serving",
        "the int8w recurrence's plain version: codes and h rounded to "
        "the compute dtype, products accumulated in float32, scale "
        "after",
        low_precision=True,
    ),
    "ops/lstm.py::lstm_recurrence_ref": CastSite(
        "token-exact",
        "the recurrence's plain version: h rounded to the compute "
        "dtype before the f32 product, the kernel's rounding point",
        low_precision=True,
    ),
    "ops/quant.py::dequant_rows": CastSite(
        "relaxed-serving",
        "int8w rows dequantized in float32 and rounded once to the "
        "compute dtype, the reference's dequant_rows",
        low_precision=True,
    ),
    "ops/rnn.py::dot_f32": CastSite(
        "token-exact",
        "the pinned product: both operands rounded to the compute "
        "dtype, then multiplied and accumulated in float32 (bf16 "
        "products are exact in f32)",
    ),
    "ops/rowgemm.py::row_dot": CastSite(
        "token-exact",
        "the row GEMM's weight tile rounded to the compute dtype "
        "(int8 codes kept), the kernel's operand",
        low_precision=True,
    ),
    "ops/sampler.py::_launch": CastSite(
        "bit-exact",
        "masks and the static gate input staged as float32 for the "
        "sampler kernel (exact or no-op)",
    ),
    "ops/sampler.py::_sample_ref": CastSite(
        "token-exact",
        "the sampling decoders' plain version: operands rounded to "
        "the compute dtype around f32-accumulated products, noise and "
        "masks in float32, ids narrowed exactly to int32",
        low_precision=True,
    ),
    "ops/threefry.py::row_keys": CastSite(
        "bit-exact",
        "row ids and steps widened to int64 words for the threefry "
        "counters",
    ),
    "ops/threefry.py::threefry_sample": CastSite(
        "bit-exact",
        "row ids and steps narrowed to the kernel's int32 (< 2**31), "
        "the sample flags to uint8",
    ),
    "ops/threefry.py::uniform_from_bits": CastSite(
        "bit-exact",
        "the mantissa bits reinterpreted as a float32 in [1, 2): the "
        "int32 cast of a value < 2**31 is exact, jax.random.uniform's "
        "construction",
    ),
    "parallel/collectives.py::VocabParallelLogSoftmax.forward": CastSite(
        "token-exact",
        "each vocab tile's log-softmax in float32, as the one-device "
        "path",
    ),
    "parallel/collectives.py::token_logprobs": CastSite(
        "token-exact",
        "log-softmax in float32 and int64 gather indices, the one- "
        "device and tile paths alike",
    ),
    "parallel/ring.py::sharded_context_attention": CastSite(
        "token-exact",
        "frame-shard scores rounded to the compute dtype like the "
        "reference's matmul, the softmax sums and context in float32, "
        "the context rounded once",
        low_precision=True,
    ),
    "training/cst.py::pg_loss": CastSite(
        "bit-exact",
        "sampled token ids widened to int64 for the embedding and "
        "gather",
    ),
    "training/steps.py::global_norm": CastSite(
        "relaxed-rtol",
        "each leaf's squares summed with float32 accumulation and "
        "rounded once into the leaf dtype, as XLA reduces a bf16 leaf "
        "in optax.global_norm; the sums moved to the first device",
        low_precision=True,
    ),
    "training/steps.py::clip_leaf": CastSite(
        "bit-exact",
        "the global norm cast to the leaf's dtype and max_norm rounded "
        "to it before the product, optax's clip_by_global_norm "
        "(g_norm.astype(t.dtype) and a weak-typed scalar)",
        low_precision=True,
    ),
    "training/steps.py::adam_direction": CastSite(
        "bit-exact",
        "the float32 bias corrections 1 - b**n rounded to the moment "
        "dtype before the division, as optax's bias_correction casts "
        "them (bitwise the jitted chain on bf16 leaves)",
        low_precision=True,
    ),
    "training/steps.py::xe_loss": CastSite(
        "relaxed-rtol",
        "captions widened to int64 ids, the target mask to float32 "
        "for the float32 loss",
    ),
}


class ShapeLadder(NamedTuple):
    kind: str                      # fixed | enumerated | probe
    ladder: str                    # the shape family, in prose
    bucket_fns: Tuple[str, ...] = ()


_ENGINE_LADDER = ("serving/engine.py::InferenceEngine.bucket",
                  "serving/engine.py::_default_ladder")
_SLOT_LADDER = ("serving/slots.py::SlotDecoder._pad_bucket",
                "serving/slots.py::_buckets",
                "serving/slots.py::_bank_ladder",
                "serving/slots.py::SlotDecoder.warm_admit_counts")
_PG_TRIM = ("training/cst.py::_trim_len",)

SHAPE_LADDER_REGISTRY: Dict[str, ShapeLadder] = {
    "ops/beam.py::_bound": ShapeLadder(
        "enumerated",
        "offline eval runs one (B, K, L, V) per run; ladder serving "
        "reaches it only through the engine's batch ladder",
        _ENGINE_LADDER,
    ),
    "ops/sampler.py::_bound": ShapeLadder(
        "enumerated",
        "greedy ladder serving through the engine's batch ladder; CST "
        "rollout chunks and validation at the run's fixed batch",
        _ENGINE_LADDER,
    ),
    "ops/lstm.py::_bound": ShapeLadder(
        "enumerated",
        "the train batch's (B*S, T) rows per run; the PG update's T "
        "trimmed to a power-of-two length bucket",
        _PG_TRIM,
    ),
    "ops/attlstm.py::_bound": ShapeLadder(
        "enumerated",
        "as lstm_recurrence: the train batch per run, the PG update "
        "trimmed to a power-of-two length bucket",
        _PG_TRIM,
    ),
    "ops/attention.py::_bound": ShapeLadder(
        "enumerated",
        "slot-loop rows walk the bank ladder and the padded admit "
        "buckets; training rows are the run's fixed batch",
        _SLOT_LADDER,
    ),
    "ops/attention.py::_bound_bwd": ShapeLadder(
        "fixed",
        "scheduled sampling's per-step backward at the run's fixed "
        "train batch and frame count",
    ),
    "ops/rowgemm.py::_bound": ShapeLadder(
        "enumerated",
        "every decode and training product: the engine's batch ladder, "
        "the slot loop's banks and admit buckets, the trimmed PG update",
        _ENGINE_LADDER + _SLOT_LADDER + _PG_TRIM,
    ),
    "ops/threefry.py::_bound": ShapeLadder(
        "fixed",
        "the slot rollout's (n_slots, V) matrix, fixed per run by "
        "train.cst_slot_count",
    ),
}

AOT_VARIANT_RUNNERS: Dict[str, Dict[str, str]] = {
    # The freed-slot zeroing runs in _zero_slots, which harvest calls.
    "serving/slots.py::SlotDecoder": {"free": "_zero_slots"},
}

_WRAPPER = "kernel wrapper: launches on CUDA tensors, plain version on CPU"

DEVICE_ROOTS: Dict[str, str] = {
    "ops/beam.py::lstm_beam": _WRAPPER,
    "ops/beam.py::attlstm_beam": _WRAPPER,
    "ops/sampler.py::lstm_sample": _WRAPPER,
    "ops/sampler.py::attlstm_sample": _WRAPPER,
    "ops/lstm.py::lstm_recurrence": _WRAPPER,
    "ops/lstm.py::lstm_recurrence_quant": _WRAPPER,
    "ops/attlstm.py::attlstm_recurrence": _WRAPPER,
    "ops/attlstm.py::attlstm_recurrence_bwd": _WRAPPER,
    "ops/attlstm.py::attlstm_recurrence_quant": _WRAPPER,
    "ops/attention.py::fused_context_attention": _WRAPPER,
    "ops/attention.py::fused_context_attention_bwd": _WRAPPER,
    "ops/rowgemm.py::row_dot": _WRAPPER,
    "ops/threefry.py::threefry_sample": _WRAPPER,
    "decoding/core.py::decode_step": "the one per-step decode recurrence",
    "training/steps.py::xe_loss": "the XE / WXE loss",
    "training/steps.py::Optimizer.step": "the in-place update step",
    "training/cst.py::pg_loss": "the CST policy-gradient loss",
    "training/cst.py::_pg_update": "the CST update (loss, grads, step)",
    "models/captioner.py::CaptionModel.forward": "teacher-forced forward",
    "models/captioner.py::CaptionModel.init_decode": "decode encode",
    "models/captioner.py::CaptionModel.decode_logits": "one decode step",
    "models/captioner.py::CaptionModel.decode_verify": "speculative verify",
    "models/captioner.py::CaptionModel.sample": "greedy / sampled decode",
    "models/captioner.py::CaptionModel.sample_cache": "CST rollout",
    "models/captioner.py::CaptionModel.fused_beam": "beam decode",
}
