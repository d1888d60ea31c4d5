"""Typed configuration system (the port's own copy).

The same dataclasses, presets and ``--section.field`` command-line
bridge as the JAX package's ``config.py``, so one preset name or one
flag means the same thing to both packages.  The copy is kept
byte-for-byte in its fields and presets (``tests/test_torch_port.py``
holds the two ``to_dict()`` trees equal); knobs that name JAX-only
machinery (``remat``, ``profile_dir``, ``rng_impl``) are carried so a
config file loads in either package, and the port reads only the knobs
of the paths it has ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class DataConfig:
    """Data paths and batching — reference ``opts.py`` data flags + ``dataloader.py``.

    The reference opens N feature h5 files (one per modality), a label h5
    (encoded captions + per-video start/end index) and "cocofmt" ground-truth
    JSONs per split.
    """

    dataset: str = "msvd"  # msvd (yt2t) | msrvtt | synthetic
    # One h5 (or .npz shard dir) per feature modality, keyed by modality name.
    feature_files: Dict[str, str] = field(default_factory=dict)
    # Modalities actually fed to the model, in fusion order.
    feature_modalities: List[str] = field(default_factory=lambda: ["resnet"])
    label_file: str = ""          # encoded captions + per-video index
    vocab_file: str = ""          # id -> word json
    cocofmt_files: Dict[str, str] = field(default_factory=dict)  # split -> GT json
    idf_file: str = ""            # CIDEr document-frequency pickle/json
    consensus_file: str = ""      # per-caption WXE consensus CIDEr weights (npy/json)

    batch_size: int = 64          # videos per batch
    seq_per_img: int = 17         # captions sampled per video (20 msrvtt, 17 msvd)
    max_seq_len: int = 30         # tokens incl. BOS/EOS padding target
    max_frames: int = 28          # temporal length features are padded/pooled to
    feature_dims: Dict[str, int] = field(default_factory=lambda: {"resnet": 2048})
    num_categories: int = 20      # MSR-VTT category vocabulary (0 disables)
    shuffle: bool = True
    drop_last: bool = True


@dataclass
class ModelConfig:
    """Decoder architecture — reference ``model.py`` flags in ``opts.py``."""

    vocab_size: int = 0           # filled from vocab at build time
    rnn_size: int = 512           # LSTM hidden size
    num_layers: int = 1           # 1-2 layer LSTM
    input_encoding_size: int = 512  # word/feature embedding dim
    feature_fusion: str = "meanpool"  # meanpool | attention
    att_hidden_size: int = 512    # temporal-attention MLP width
    drop_prob: float = 0.5        # dropout on LM input/output
    scheduled_sampling_start: int = -1   # epoch to start ss (-1 = off)
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25
    use_category: bool = False    # MSR-VTT category embedding as extra modality
    category_embed_size: int = 64
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"   # MXU-friendly activations
    use_pallas_lstm: bool = False     # fused Pallas LSTM cell fast path
    # Fused Pallas Bahdanau attention step (attention fusion only) —
    # independent of the LSTM kernel; exact vs the dense math, falls back
    # off-TPU / on untileable batches (ops/pallas_attention.py).
    use_pallas_attention: bool = False
    # Whole-recurrence fused SAMPLER (ops/pallas_sampler.py): the CST
    # rollout / greedy-baseline decode as ONE kernel.  Greedy tokens are
    # bit-identical to the scan path; multinomial draws from the same
    # softmax(logits/T) distribution via a hash-Gumbel stream that
    # differs from the scan path's threefry stream (docs/PARITY.md).
    # model_from_config additionally gates this on a real TPU backend
    # (interpret mode would crawl) and single-device meshes.
    use_pallas_sampler: bool = False
    # Whole-recurrence fused BEAM-SEARCH kernel (ops/pallas_beam.py): the
    # eval/validation beam decode as ONE kernel — attention tensors
    # VMEM-resident across steps, vocab projection streamed in V-tiles
    # with an online per-beam top-K (no (B*K, V) logits array), beam
    # reorder in-kernel.  Token-exact vs decoding/beam.py at float32;
    # tie-order contract in docs/PARITY.md.  model_from_config gates it
    # on a real TPU backend and single-device meshes like the sampler.
    use_pallas_beam: bool = False
    # Bar UNK from the decode policy (sampling, beam search, and the CST
    # PG likelihood).  False = reference parity: the reference sampler can
    # emit UNK, and since both sides vocab-encode references with
    # OOV -> UNK, sampled UNKs can harvest in-loop reward from UNK-encoded
    # reference n-grams (docs/PARITY.md; pinned by
    # tests/test_cst.py::test_unk_reward_channel).
    decode_suppress_unk: bool = False
    # Shard the attention-fusion frame axis over the mesh "model" axis
    # (sequence/context parallelism for long feature streams; requires
    # feature_fusion="attention" and a multi-device mesh).
    shard_frames: bool = False


@dataclass
class TrainConfig:
    """Optimization + regime staging — reference ``train.py`` / ``opts.py``."""

    train_mode: str = "xe"        # xe | wxe | cst
    # CST sub-switches (reference CST_* Makefile targets):
    # greedy (SCST/CST_MS_Greedy) | scb (CST_MS_SCB: leave-one-out rollout
    # mean) | gt_consensus (SURVEY §3.2's alternative SCB reading: the
    # video's mean GT-caption consensus CIDEr-D — docs/PARITY.md) | none
    cst_baseline: str = "greedy"
    cst_num_samples: int = 20     # multinomial rollouts per video (CST_MS)
    # CST_GT_None: the "samples" are the GT captions themselves, weighted by
    # consensus — mathematically the WXE regime; train_mode="cst" with this
    # flag dispatches to the weighted-XE step (trainer._build_steps).
    cst_use_gt: bool = False
    # Weight each reference's CIDEr-D contribution to the CST reward by its
    # consensus weight (the "20-ref weighted CIDEr" reward of CST_MS).
    cst_weighted_reward: bool = False
    sample_temperature: float = 1.0
    # Split-step scoring pipeline (backends without io_callback): the
    # rollout is dispatched in this many equal batch chunks, all enqueued
    # on the device back-to-back, and the host CIDEr-D scorer consumes
    # chunk i while chunks i+1..K still compute — device idle shrinks to
    # ~1/K of the scoring time with identical math (every chunk samples
    # from the same params).  1 = unchunked (bit-matches the one-graph
    # rollout stream for a given rng).  Values that don't divide the
    # batch fall back to the largest divisor.
    cst_score_chunks: int = 4
    # Split-step dispatch layout (backends without io_callback):
    #   auto     — probe per-dispatch latency once; high-latency (tunneled)
    #              runtimes take the software-pipelined layout, low-latency
    #              hosts the chunked-scoring layout above.
    #   pipeline — force the pipelined layout: each call dispatches ONE
    #              graph holding [previous step's PG update + this step's
    #              rollout], so a step pays one dispatch round-trip instead
    #              of two (identical math, update boundaries moved; the
    #              trainer flushes the final pending update at epoch ends).
    #   chunked  — force the chunked/two-dispatch layout.
    cst_split_layout: str = "auto"
    # Parallel CIDEr-D reward pool (training/rewards.py::RewardPool):
    # rollout rows shard across this many persistent worker processes,
    # with the corpus document-frequency and cooked-reference tables
    # pickled to the workers once at pool start.  Scores are
    # BIT-IDENTICAL to serial scoring (rows are independent; shards
    # concatenate in order — docs/PARITY.md).  0/1 = serial in-process
    # scoring; ignored when the native C++ scorer (already threaded) is
    # built.
    reward_workers: int = 0
    # CST rollout decode layout:
    #   scan   — the classic fused-scan rollout (model.sample): every
    #            row pads to max_seq_len inside one jitted graph.
    #   slot   — the serving slot machinery reused in training
    #            (training/cst.py::SlotRollout via decoding/core.py):
    #            sampled-rollout and greedy-baseline rows occupy
    #            persistent device slots, exit on EOS, and stream to
    #            the reward scorer as they are harvested — total decode
    #            cost ~ sum(row lengths) instead of rows x L
    #            (docs/PERF.md r10).  Sampling is row-keyed
    #            (fold_in(fold_in(rng, row_id), t)), so slot position /
    #            admission order cannot change any sampled token.
    #   padded — the slot path's bit-twin with every row resident for
    #            the full L steps (bench baseline; same row-keyed
    #            stream, bit-identical losses/params to "slot").
    # NOTE: "scan" and the slot layouts draw from different PRNG
    # streams (batch-threefry vs row-keyed) — same policy distribution,
    # different trajectories (docs/PARITY.md).
    cst_rollout: str = "scan"
    # Decode slots for cst_rollout="slot" (rows, 1 row/slot).  0 = a
    # quarter of the rollout rows (>= 8), so freed slots keep refilling
    # while stragglers run.
    cst_slot_count: int = 0
    # Device decode steps per jitted slot-rollout call (>= 1) — the
    # serving slot_block_steps knob: amortizes dispatch overhead at the
    # price of harvest granularity (frozen rows ride at zero cost).
    cst_slot_block_steps: int = 1
    # Overlapped reward scheduling in the split CST step: feed rollout
    # chunks to the scorer the moment their tokens are fetched (scoring
    # proceeds in pool workers while the greedy-baseline decode still
    # runs on device) and block only at the PG-update dispatch — step
    # time approaches max(t_device, t_score) + t_update instead of the
    # serial sum (docs/PERF.md).  Scheduling only: rewards and updates
    # are bit-identical with this on or off.
    overlap_rewards: bool = True

    optimizer: str = "adam"
    learning_rate: float = 2e-4
    lr_decay: float = 0.5         # multiplicative decay factor
    lr_decay_every: int = 3       # epochs between decays (0 = off)
    grad_clip: float = 10.0       # global-norm clip (0 = off)
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    # PRNG implementation for all training randomness.  "rbg" rides the
    # TPU's hardware generator and partitions cleanly under SPMD —
    # threefry2x32 costs ~10ms/step generating the (B,S,T,H) dropout mask
    # alone at MSR-VTT shape (docs/PERF.md) and dominates rollout
    # sampling.  Streams are deterministic per impl but differ across
    # impls; set "threefry2x32" to reproduce older runs bit-for-bit.
    rng_impl: str = "rbg"

    max_epochs: int = 50
    max_patience: int = 5         # early stop on val CIDEr
    eval_every: int = 1           # epochs between val language evals
    save_checkpoint_every: int = 1
    checkpoint_dir: str = "checkpoints"
    start_from: str = ""          # warm-start checkpoint (XE -> WXE -> CST staging)
    resume: bool = False          # continue from <workdir>/last (preemption)
    seed: int = 213

    # Parallelism over the device mesh (reference: .cuda()/DataParallel only).
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": -1, "model": 1})
    remat: bool = False           # jax.checkpoint the decoder scan
    nan_check: bool = False       # debug nan-guard on losses/grads
    profile_dir: str = ""         # jax.profiler trace output ("" = off)
    # Steps the profiler window stays open (trace covers steps
    # 1..1+window of epoch 0) — the trainer-side twin of the serving
    # /debug/profile?ms=N knob.
    profile_window_steps: int = 10
    # Write the span tracer's Chrome-trace JSON here at the end of fit()
    # ("" = off).  PhaseClock phases are spans in the same format the
    # serving /debug/trace export uses, so a CST step and a served
    # request render in one Perfetto timeline.
    trace_file: str = ""
    tensorboard_dir: str = ""     # tf.summary event files ("" = off)
    log_every: int = 20           # steps between loss log lines
    history_file: str = "history.json"


@dataclass
class EvalConfig:
    """Decoding + metric suite — reference ``sample.py`` / ``test.py``."""

    beam_size: int = 5
    max_decode_len: int = 30
    length_normalize: bool = True   # divide beam logprob by length at finalize
    metrics: List[str] = field(
        default_factory=lambda: ["Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]
    )
    eval_split: str = "test"
    out_dir: str = "eval_out"


@dataclass
class ServingConfig:
    """Online caption-serving subsystem (``cst_captioning_torch/serving/``):
    warm-engine shape ladder, micro-batching scheduler, caches, HTTP
    front end.  No reference equivalent — the reference is batch-only."""

    host: str = "127.0.0.1"
    port: int = 8000              # 0 = ephemeral (tests)
    # Decode backend for served requests: "beam" matches the offline
    # eval path token-exactly (the serving parity contract); "greedy"
    # is the cheaper validation-style decode.
    decode_mode: str = "beam"
    # Continuous in-flight batching (serving/slots.py): a persistent
    # matrix of decode slots stepped one decode step at a time — slots
    # free as soon as their caption hits EOS (short captions exit in
    # ~length steps instead of max_decode_len) and new requests are
    # admitted at the next step boundary instead of the next batch
    # boundary.  False = the batch-at-a-time shape ladder.
    continuous: bool = True
    # Decode slots for continuous mode (greedy: 1 row/slot; beam: K
    # contiguous rows/slot).  0 = max_batch_size.  With an elastic bank
    # ladder (slot_bank_min > 0) this is the TOP bank.
    num_slots: int = 0
    # Beam-deduplicated decode-state cache (serving/slots.py): store the
    # read-only projected encoder DecodeCache ONCE per slot ((S, ...)
    # leaves) instead of once per beam row ((S*K, ...)); the jitted step
    # reads the shared copy via the row->slot index.  Cuts decode-state
    # HBM per in-flight beam request ~K x with token-exact output (the
    # replicated rows were identical copies).  False keeps the legacy
    # replicated layout (paired bench rows / regression escape hatch).
    dedup_cache: bool = True
    # Elastic slot-bank ladder: 0 = one fixed bank of num_slots.
    # > 0 pages the slot matrix through a pre-jitted
    # doubling ladder [min, 2*min, ..., num_slots]; the decoder grows
    # banks under queue pressure and shrinks after
    # slot_shrink_idle_ticks consecutive underfull ticks — capacity
    # follows traffic with no cold-retrace stall (every transition is
    # compiled at warmup).
    slot_bank_min: int = 0
    # Consecutive underfull ticks (occupancy + queue fits the next bank
    # down) before an elastic shrink; hysteresis against thrash.
    slot_shrink_idle_ticks: int = 8
    # Zero freed/evicted slots' cache + carry rows at free time (one
    # fused mask-select per harvest batch) so the live decode-state
    # byte gauges report resident state honestly, not stale rows.
    zero_freed_slots: bool = True
    # Data-parallel engine replicas (serving/replicas.py): one warm
    # engine + slot decoder per replica, weights device_put once per
    # replica, a least-loaded router in front.  1 = the single-replica
    # scheduler (ContinuousBatcher); 0 = one replica per local device;
    # N > len(devices) wraps round-robin onto the same devices.
    replicas: int = 1
    # Model-sharded serving: ONE logical replica spans this many
    # devices on a (data=1, model=N) mesh — vocab-sized params shard
    # per parallel/partition.py, decode-step logits carry a
    # with_sharding_constraint over the model axis, slot/decode state
    # stays replicated across the shard group (the data axis is 1).
    # 1 = today's per-device replica scaling, byte-identical to the
    # pre-TP engine; > 1 composes with `replicas` into an (R data-
    # parallel replicas) x (M model shards) serving grid: each replica
    # is a model-sharded engine on its own deterministic (1, M)
    # submesh of id-sorted local devices, and R*M must fit the local
    # device count (replicas=0 means one sharded replica per M
    # devices).  Decoded tokens are exact vs model_shards=1: the
    # column-sharded vocab matmul computes each logit column with the
    # same reduction order as the replicated layout (docs/PARITY.md
    # r12/r15).
    model_shards: int = 1
    # Cross-shard fused top-K for the model-sharded slot decode
    # (decoding/core.py::make_tp_beam_topk / make_tp_row_pick): each
    # shard top-Ks its own vocab tile and one O(shards*K) candidate
    # all-gather merges them — instead of the O(V) full-vocab gather
    # XLA inserts for the inline top-K over sharded logits.  Token-
    # exact incl. tie order (docs/PARITY.md r15; the tp2_fused
    # backends pin it in the shared harness).  Requires the vocab to
    # divide model_shards — uneven tiles log a warning and keep the
    # gather path.  False = the full-vocab gather path.
    shard_fused_decode: bool = True
    # Router policy across replica admission queues: "least_loaded"
    # (most free slots minus queued work wins, round-robin tiebreak) or
    # "round_robin".
    router: str = "least_loaded"
    # Double-buffered tick dispatch in each replica worker: dispatch
    # tick t+1 before harvesting tick t, overlapping host-side
    # harvest/detokenize/admission with device compute.  Costs one
    # extra (frozen, parity-neutral) tick block of latency per caption
    # tail; False = the synchronous one-sync-per-tick loop.
    double_buffer: bool = True
    # Device decode steps per jitted slot-loop call (>=1).  Raising it
    # amortizes per-call dispatch + host-sync overhead at the price of
    # admission/exit granularity (a finished slot rides frozen for up
    # to N-1 extra steps — parity-neutral, the freeze is a no-op).
    slot_block_steps: int = 1
    # Graceful-shutdown drain budget: on SIGTERM/shutdown the server
    # stops admissions (503), lets in-flight work finish for up to this
    # many seconds, then exits.
    drain_timeout_s: float = 30.0
    # Fixed batch shapes the engine pre-jits (ascending).  Empty = a
    # power-of-two ladder 1, 2, 4, ... up to max_batch_size.  Every
    # served batch is padded up to the smallest ladder shape that fits,
    # so the jit cache never grows past the ladder.
    batch_shapes: List[int] = field(default_factory=list)
    max_batch_size: int = 8       # coalescing target (ladder top)
    max_wait_ms: float = 5.0      # micro-batch coalescing window
    queue_depth: int = 256        # bounded request queue (backpressure)
    default_deadline_ms: float = 10_000.0  # per-request deadline
    retry_after_s: float = 0.25   # hint returned on queue-full rejects
    caption_cache_size: int = 4096   # tier-1: content hash -> caption
    feature_cache_size: int = 512    # tier-2: feature id -> encoder state
    # Span tracing (observability/trace.py): host-side spans over the
    # whole request path (request/queue/admit/tick/harvest/detok),
    # exported as Chrome-trace JSON at GET /debug/trace and stamped as
    # exemplar trace_ids on /stats.  Off = every tracer handle is the
    # disabled no-op tracer (the paired trace_overhead_* bench rows
    # measure the difference).
    tracing: bool = True
    # Per-thread finished-span ring size (bounded memory; the export
    # window an operator sees at /debug/trace).
    trace_buffer_spans: int = 4096
    # Flight recorder (observability/flight.py): per-replica ring of
    # recent tick/lifecycle events, live at GET /debug/flight.  Ring
    # length in events:
    flight_events: int = 256
    # Directory flight dumps are written to on worker death,
    # kill_replica, watchdog/drain timeout, and SIGTERM drain.  "" =
    # in-memory ring only (no disk writes — the test/dev default).
    flight_dir: str = ""
    # jax.profiler device-trace output dir for the opt-in
    # GET /debug/profile?ms=N window.  "" disables the endpoint.
    profile_dir: str = ""
    # Request hedging (serving/replicas.py): when a submitted request
    # has produced no result after max(hedge_ms, measured p99 of the
    # total-latency histogram) milliseconds, dispatch a duplicate onto a
    # second healthy replica — first result wins, the losing copy is
    # cancelled at admission (queued) or discarded at harvest
    # (in-flight).  Token-exact by construction: every replica holds
    # byte-identical weights, so either copy decodes the same caption
    # (pinned in tests/test_replicas.py).  0 = hedging off (default; the
    # serve path is byte-identical to the pre-hedging scheduler).
    hedge_ms: float = 0.0
    # Server-side retry budget: how many times a request may be requeued
    # onto survivors across replica deaths before it fails outright —
    # caps the requeue storm a flapping fleet could otherwise amplify
    # (`caption_requeue_overflow_total` counts the cap firing).
    requeue_budget: int = 3
    # Deterministic fault injection (serving/chaos.py).  Empty dict =
    # chaos fully OFF: no ChaosEngine is constructed and the serving
    # path is byte-identical to a chaos-free build (pinned by the
    # no-chaos parity test).  Keys: "seed" (int), "schedule" (list of
    # entries {"site": <FAULT_SITES name>, "at"|"every"|"p": trigger,
    # "replica": optional id, "value": site-specific payload}).  Every
    # site is catalogued in serving/chaos.py::FAULT_SITES and documented
    # in docs/SERVING.md; the CST-RES analysis rules machine-check the
    # call sites.
    chaos: Dict[str, Any] = field(default_factory=dict)
    # Tier-2 byte budget (0 = entry-count bound only).  Projected
    # DecodeCache rows are the largest cached objects — bound the tier
    # by what it actually holds, not how many entries it has; evictions
    # are counted and exported on /metrics.
    feature_cache_bytes: int = 0
    # Elastic autoscaler (serving/autoscaler.py).  Empty dict = OFF: no
    # control loop is constructed and the fleet is statically sized.
    # Keys (all optional, see
    # AutoscaleConfig for defaults/semantics): "min_replicas",
    # "max_replicas", "window_ticks", "scale_up_queue_depth",
    # "scale_up_shed", "scale_up_wait_p99_ms", "scale_down_occupancy",
    # "cooldown_ticks", "interval_s".  Decisions are a deterministic
    # function of the observed signal window (pinned by the
    # virtual-time replay tests); each applied decision lands as an
    # `autoscale` flight event and on the caption_autoscale_* metric
    # families.
    autoscale: Dict[str, Any] = field(default_factory=dict)
    # AOT serving artifacts (serving/artifact.py): how many artifact
    # VERSIONS the loader keeps on disk per artifact root.  Loading an
    # artifact garbage-collects older version directories beyond this
    # count — the ACTIVE (just-loaded) version is never collected.
    artifact_keep: int = 2
    # Low-precision serving fast path (ops/quant.py; docs/SERVING.md
    # "Low-precision serving").  "f32" = byte-identical to the engine
    # before this knob existed (the model's own compute_dtype rules).
    # "bf16" forces bfloat16 activations (f32 accumulation stays pinned
    # per CST-DTY-003; decode decisions stay f32).  "int8w" additionally
    # quantizes the big GEMM weights — vocab projection, embedding rows,
    # LSTM kernels, attention MLP — to int8 with per-channel f32 scales,
    # computed ONCE at engine boot or AOT artifact build; activations
    # run bf16 and every decode DECISION (top-K keys, argmax, Gumbel
    # race) still consumes f32 logits.  Rounding can move tokens: the
    # parity contract is the `relaxed-serving` tier (caption-match rate
    # vs f32 >= the pinned floor, per-caption score gap <= the pinned
    # rtol — analysis/jit_registry.py constants, docs/PARITY.md r17).
    # Serving-only: the trainer never reads this knob.
    dtype: str = "f32"
    # int8w weight calibration (ops/quant.py::quantize_per_channel):
    # "absmax" = per-channel abs-max scaling; "percentile" clips each channel at its 99.9th
    # |w| percentile before rounding — outlier channels trade a little
    # clipping error for finer resolution on the bulk of the weights.
    # Read once at quantize time (engine boot / artifact build); the
    # chosen scales travel with the quantized tree, so replicas and
    # AOT loads never re-calibrate.
    quant_calibration: str = "absmax"
    # Speculative decode on the slot runtime (decoding/speculative.py;
    # docs/SERVING.md "Speculative decode").  Empty dict = OFF: no
    # draft model is built and the slot decoder is byte-identical to a
    # speculation-free build.  Keys: "draft_k" (proposals per tick,
    # >= 2), "draft_hidden" (draft LSTM width, < model.rnn_size;
    # default 128), "draft_params" (optional .npz from
    # cli/distill_draft.py — absent means truncation-init from the
    # full checkpoint).  Greedy-only; the rejection rule keeps the
    # emitted stream token-exact vs non-speculative greedy
    # (docs/PARITY.md r18), so the knob can only change throughput,
    # never captions.
    speculative: Dict[str, Any] = field(default_factory=dict)
    warmup: bool = True           # pre-jit the whole ladder at startup


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    name: str = "default"

    # ------------------------------------------------------------------ io
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {tp.__name__}.{k}")
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            data=build(DataConfig, d.get("data", {})),
            model=build(ModelConfig, d.get("model", {})),
            train=build(TrainConfig, d.get("train", {})),
            eval=build(EvalConfig, d.get("eval", {})),
            serving=build(ServingConfig, d.get("serving", {})),
            name=d.get("name", "default"),
        )

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kv) -> "Config":
        """dotted-path override: replace(**{"train.learning_rate": 1e-4})."""
        d = self.to_dict()
        for k, v in kv.items():
            cur = d
            parts = k.split(".")
            for p in parts[:-1]:
                cur = cur[p]
            if parts[-1] not in cur:
                raise KeyError(f"unknown config key {k}")
            cur[parts[-1]] = v
        d["name"] = d.get("name", self.name)
        return Config.from_dict(d)


# --------------------------------------------------------------------------
# Presets — the five acceptance configs (BASELINE.json:6-12), plus a
# CPU-runnable synthetic smoke config used by tests and CI.
# --------------------------------------------------------------------------

def _preset_msvd_xe() -> Config:
    """1) MSVD, ResNet-152 feats only, XE loss, 1-layer LSTM-512 (tiny)."""
    c = Config(name="msvd_resnet_xe")
    c.data.dataset = "msvd"
    c.data.feature_modalities = ["resnet"]
    c.data.feature_dims = {"resnet": 2048}
    c.data.seq_per_img = 17
    c.model.num_layers = 1
    c.model.rnn_size = 512
    c.train.train_mode = "xe"
    return c


def _preset_msrvtt_xe() -> Config:
    """2) MSR-VTT, ResNet-152 + C3D feats, XE-loss pretrain."""
    c = Config(name="msrvtt_resnet_c3d_xe")
    c.data.dataset = "msrvtt"
    c.data.feature_modalities = ["resnet", "c3d"]
    c.data.feature_dims = {"resnet": 2048, "c3d": 4096}
    c.data.seq_per_img = 20
    c.train.train_mode = "xe"
    # TPU fast paths on by default for the production presets.  The
    # kernels step aside automatically on untileable shapes and on
    # multi-device meshes (model_from_config); off-TPU, however, they run
    # in Pallas INTERPRET mode — numerically equivalent but orders of
    # magnitude slower than the scan path, acceptable only for tests.
    # Any CPU run of these presets should set
    # use_pallas_lstm = use_pallas_attention = False.  The global
    # ModelConfig defaults stay False so plain CPU tests never pay for
    # interpret-mode kernels by accident.
    c.model.use_pallas_lstm = True
    c.model.use_pallas_attention = True
    c.model.use_pallas_sampler = True
    c.model.use_pallas_beam = True
    return c


def _preset_msrvtt_wxe_cst_gt() -> Config:
    """3) MSR-VTT, WXE warm-start -> CST_GT_None (GT samples, consensus weights)."""
    c = _preset_msrvtt_xe()
    c.name = "msrvtt_wxe_cst_gt_none"
    c.train.train_mode = "wxe"
    c.train.cst_baseline = "none"
    c.train.cst_use_gt = True
    c.train.learning_rate = 1e-4
    c.train.start_from = "checkpoints/msrvtt_resnet_c3d_xe/best"
    return c


def _preset_msrvtt_cst_ms() -> Config:
    """4) MSR-VTT, CST_MS multi-sample consensus (20-ref weighted CIDEr)."""
    c = _preset_msrvtt_xe()
    c.name = "msrvtt_cst_ms_scb"
    c.train.train_mode = "cst"
    c.train.cst_baseline = "scb"
    c.train.cst_num_samples = 20
    c.train.cst_weighted_reward = True  # 20-ref weighted CIDEr reward
    c.train.learning_rate = 1e-4
    c.train.start_from = "checkpoints/msrvtt_wxe_cst_gt_none/best"
    # TPU-VM hosts have many idle cores during CST; shard the in-loop
    # CIDEr-D scorer across 8 worker processes (bit-identical scores)
    # so host scoring stays well under device decode time.  No-op when
    # the native C++ scorer is built (it is already threaded).
    c.train.reward_workers = 8
    return c


def _preset_msrvtt_eval() -> Config:
    """5) MSR-VTT test eval, beam=5, full BLEU/METEOR/ROUGE/CIDEr suite."""
    c = _preset_msrvtt_xe()
    c.name = "msrvtt_eval_beam5"
    c.eval.beam_size = 5
    c.eval.eval_split = "test"
    return c


def _preset_msrvtt_serve() -> Config:
    """Online serving: MSR-VTT checkpoint behind the micro-batching HTTP
    front end (cli/serve.py), beam-5 decode for offline parity.  The
    64-wide ladder top matches the training batch so the fused beam
    kernel's shape gate sees the shapes it was calibrated for."""
    c = _preset_msrvtt_eval()
    c.name = "msrvtt_serve_beam5"
    c.serving.max_batch_size = 64
    c.serving.batch_shapes = [8, 16, 32, 64]
    c.serving.max_wait_ms = 8.0
    c.serving.queue_depth = 1024
    c.serving.caption_cache_size = 65536
    c.serving.feature_cache_size = 4096
    # ~64KB/row projected f32 DecodeCache at MSR-VTT shape; cap the tier
    # at 256MiB of host RAM regardless of entry count.
    c.serving.feature_cache_bytes = 256 * 1024 * 1024
    c.serving.num_slots = 64
    # Elastic decode-state capacity: page the slot matrix through the
    # pre-jitted 8 -> 16 -> 32 -> 64 bank ladder so quiet replicas hold
    # an 8-slot bank's worth of decode-state HBM, not 64 slots' worth.
    c.serving.slot_bank_min = 8
    # Production default: replicate the engine over every local chip
    # (serving/replicas.py) with double-buffered dispatch.
    c.serving.replicas = 0
    # Observability: flight dumps land next to the checkpoints on
    # worker death / kill / SIGTERM drain; /debug/profile is live.
    c.serving.flight_dir = "flight_dumps"
    c.serving.profile_dir = "profiles"
    return c


def _preset_msrvtt_xe_2d() -> Config:
    """MSR-VTT XE pretrain on a REAL 2D (data x model) mesh: vocab-sized
    params + Adam moments shard over a model axis of 2, batch over the
    remaining devices (parallel/partition.py rules; update steps are
    NamedSharding-in/out jits).  The 10,496-token vocab divides every
    power-of-two model axis, so the dominant logit/embedding matmuls
    actually shard instead of falling back to replication.  The fused
    Pallas decode kernels step aside on multi-device meshes
    (model_from_config gate) — docs/PERF.md r12 has the comm-volume
    arithmetic for when the trade wins."""
    c = _preset_msrvtt_xe()
    c.name = "msrvtt_xe_2d"
    c.train.mesh_shape = {"data": -1, "model": 2}
    # Vocab padded at build time stays a multiple of 256 (bench shape);
    # any preset vocab must divide the model axis for the sharding to
    # engage (shard_params falls back to replication otherwise).
    return c


def _preset_msrvtt_serve_tp() -> Config:
    """Model-sharded serving: one logical replica spanning 2 devices on
    a (data=1, model=2) mesh instead of two independent clones — halves
    the per-device vocab-param footprint, serves bigger decoders than
    one device holds.  Token-exact vs the replicated engine
    (docs/PARITY.md r12); the slot decode's per-step top-K runs the
    cross-shard fused candidate merge (shard_fused_decode, PARITY
    r15)."""
    c = _preset_msrvtt_serve()
    c.name = "msrvtt_serve_tp2"
    c.serving.replicas = 1
    c.serving.model_shards = 2
    return c


def _preset_msrvtt_serve_grid() -> Config:
    """Replica x shard serving grid: R=2 data-parallel replicas OF
    M=2-way model-sharded engines — one config, four devices, both
    axes.  Each replica lives on its own deterministic
    (1, 2) submesh of the id-sorted local devices; the router,
    hedging, requeue, and autoscaling machinery see ordinary replicas
    whose insides happen to be sharded."""
    c = _preset_msrvtt_serve_tp()
    c.name = "msrvtt_serve_r2xtp2"
    c.serving.replicas = 2
    return c


def _preset_msrvtt_serve_int8w() -> Config:
    """Low-precision serving: the TP2 grid with int8 weight-only
    quantization of the vocab/embedding/LSTM/attention GEMM weights
    (serving.dtype=int8w, ops/quant.py).  Per-device vocab-tile weight
    bytes drop to ~0.25x the f32 TP2 engine (int8 codes; the per-channel
    f32 scales shard with their columns), activations run bf16, decode
    decisions stay f32.  Parity is the `relaxed-serving` tier: caption-
    match floor + score-gap rtol vs f32 on the fixed eval set
    (docs/PARITY.md r17; the lowprec_* bench rows assert it before
    recording)."""
    c = _preset_msrvtt_serve_tp()
    c.name = "msrvtt_serve_int8w_tp2"
    c.serving.dtype = "int8w"
    return c


def _preset_synthetic_smoke() -> Config:
    """CPU-runnable synthetic tiny config (tests / CI / integration)."""
    c = Config(name="synthetic_smoke")
    c.data.dataset = "synthetic"
    c.data.feature_modalities = ["resnet"]
    c.data.feature_dims = {"resnet": 64}
    c.data.batch_size = 8
    c.data.seq_per_img = 3
    c.data.max_seq_len = 12
    c.data.max_frames = 6
    c.model.rnn_size = 32
    c.model.input_encoding_size = 32
    c.model.att_hidden_size = 32
    c.model.drop_prob = 0.0
    c.model.compute_dtype = "float32"
    c.train.max_epochs = 3
    c.train.log_every = 5
    c.eval.beam_size = 3
    c.eval.max_decode_len = 12
    c.serving.max_batch_size = 8
    c.serving.batch_shapes = [2, 4, 8]
    c.serving.max_wait_ms = 20.0
    c.serving.queue_depth = 32
    c.serving.caption_cache_size = 64
    c.serving.feature_cache_size = 16
    c.serving.feature_cache_bytes = 1024 * 1024
    c.serving.num_slots = 4
    # Block of 2 decode steps per slot-loop call: exercises the
    # frozen-ride parity path in tier-1 and halves per-call overhead.
    c.serving.slot_block_steps = 2
    c.serving.drain_timeout_s = 60.0
    return c


PRESETS = {
    "msvd_resnet_xe": _preset_msvd_xe,
    "msrvtt_resnet_c3d_xe": _preset_msrvtt_xe,
    "msrvtt_wxe_cst_gt_none": _preset_msrvtt_wxe_cst_gt,
    "msrvtt_cst_ms_scb": _preset_msrvtt_cst_ms,
    "msrvtt_eval_beam5": _preset_msrvtt_eval,
    "msrvtt_serve_beam5": _preset_msrvtt_serve,
    "msrvtt_xe_2d": _preset_msrvtt_xe_2d,
    "msrvtt_serve_tp2": _preset_msrvtt_serve_tp,
    "msrvtt_serve_r2xtp2": _preset_msrvtt_serve_grid,
    "msrvtt_serve_int8w_tp2": _preset_msrvtt_serve_int8w,
    "synthetic_smoke": _preset_synthetic_smoke,
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


# --------------------------------------------------------------------------
# argparse bridge — CLI parity with the reference's `python train.py <flags>`.
# Any dataclass field is addressable as --section.field (e.g. --train.learning_rate).
# --------------------------------------------------------------------------

def _add_section(parser: argparse.ArgumentParser, section: str, tp) -> None:
    for f in dataclasses.fields(tp):
        flag = f"--{section}.{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif f.type in ("int", int):
            parser.add_argument(flag, type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(flag, type=float, default=None)
        elif f.type in ("str", str):
            parser.add_argument(flag, type=str, default=None)
        else:  # dict/list fields take JSON literals
            parser.add_argument(flag, type=json.loads, default=None)


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """Build a Config from `--preset NAME` / `--config FILE` plus overrides."""
    parser = argparse.ArgumentParser("cst_captioning_torch")
    parser.add_argument("--preset", type=str, default=None)
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    for section, tp in (("data", DataConfig), ("model", ModelConfig),
                        ("train", TrainConfig), ("eval", EvalConfig),
                        ("serving", ServingConfig)):
        _add_section(parser, section, tp)
    args = parser.parse_args(argv)

    if args.config:
        cfg = Config.from_json(args.config)
    elif args.preset:
        cfg = get_preset(args.preset)
    else:
        cfg = Config()

    overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k not in ("preset", "config")
    }
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
