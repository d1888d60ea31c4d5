"""Continuous in-flight batching: the persistent slot-based decode loop
(port of the JAX package's ``serving/slots.py::SlotDecoder``).

The ladder engine decodes a coalesced batch to completion while later
requests wait.  This loop holds a matrix of ``S`` decode slots (greedy:
1 row per slot; beam: K contiguous rows per slot) whose state lives on
the device: the unified decode carry (``decoding/core.py::CoreState``,
flat row axis ``S*K``) plus the projected ``DecodeCache`` rows the step
reads.  Each scheduler iteration (:meth:`SlotDecoder.tick`) admits up
to ``admit_cap`` pending requests into free slots (one encode of the
admission batch, padded to a bucket, then a scatter into the slots'
rows), runs ``slot_block_steps`` decode steps over all rows, and
reports the slots whose rows all finished (or hit the length cap).
Those are harvested and freed, so a short caption leaves after about
its own length in steps and an arrival starts at the next step.

* **Deduplicated cache** (``serving.dedup_cache``, the default): a beam
  slot's K rows decode the same video, so the read-only cache is stored
  once per slot; the step reads row ``r``'s view as slot ``r // K``
  (under attention fusion the ``fused_context_attention`` kernel does so
  in place, ``rep = K``; the meanpool context is gathered).  With
  ``dedup_cache = false`` every beam row keeps its own copy.
* **Elastic banks** (``serving.slot_bank_min > 0``): the slot matrix
  pages through the doubling ladder ``[min, 2·min, ..., num_slots]``.
  At tick boundaries :meth:`SlotDecoder.maybe_resize` grows the bank
  while queued work exceeds free slots and shrinks it after
  ``slot_shrink_idle_ticks`` underfull ticks.  Admission fills the
  lowest free slot, so a shrink only drops free slots, and a resize
  copies the surviving prefix: no in-flight row moves.
* **Freed slots are zeroed** (``serving.zero_freed_slots``) back to the
  empty-slot pattern (finished, step = L, zero rows), so the byte gauges
  report what is live; empty slots ride frozen.

Parity (the bar: served captions token-exact against the offline
per-step decode, ``decoding/beam.py::beam_search_from_state`` and
``CaptionModel._sample_from_cache``): the step is the same
``decode_step`` over the same ``decode_logits``; every product of the
step and of the admission encode goes through ``ops/rowgemm.py::
row_dot``, whose rows do not depend on the row count, the context
kernel computes each row alone, and the selection is exact; so which
other requests share the matrix, the bank size and the arrival order
cannot change a row's bits.  Under ``serving.dtype = int8w`` the same
holds: every product is ``row_dot``'s int8 path on the codes (the
scale applied after the row's own sum), and the decode state keeps the
bfloat16 compute dtype, so ``expected_state_bytes`` is unchanged.  The
host epilogue mirrors ``finalize_beams`` with a stable sort.

Model-sharded engines (``serving.model_shards`` M > 1): the slot state
lives on the (1, M) submesh's first device, the vocab tiles on all M;
each step's ``decode_logits`` returns ``VocabShardedLogits`` and the
selection is the cross-shard candidate merge
(``decoding/core.py::make_tp_beam_topk`` / ``make_tp_row_pick``, the
speculative round's pick too) unless ``serving.shard_fused_decode`` is
off, which gathers the full logits first (the reference's gather path).
Each logit column is ``row_gemm``'s bits whatever the split, and the
merge is exact, so a sharded engine serves the replicated engine's
tokens.

Double-buffered dispatch (``serving/replicas.py`` workers): the tick is
split into :meth:`SlotDecoder.tick_begin` (admission and step block
enqueued on the device, no host sync; returns a :class:`TickHandle`) and
:meth:`SlotDecoder.tick_wait` / :meth:`SlotDecoder.harvest_from` (wait
for one handle and extract from it).  A worker that dispatches tick t+1
before waiting on tick t overlaps its host work (harvest, detokenize,
admission) with the device's work on tick t+1.  The slot state is
written in place, and tick t+1's admissions and zeroing run before tick
t is harvested, so two guards keep the reordering exact:

* each handle owns snapshots: at the end of its tick, on the decoder's
  stream, ``done`` / ``seqs`` / ``scores`` are copied into fresh pinned
  host buffers (``non_blocking``) and a CUDA event is recorded after
  them; ``tick_wait`` waits on that event only.  Harvesting tick t after
  tick t+1 was dispatched reads tick t's numbers, and no host read ever
  waits for a later tick's work;
* ``admit_tick`` records the tick that admitted each slot's occupant,
  and ``tick_wait(handle)`` reports only slots admitted at or before
  ``handle.seq``: a slot harvested and refilled between dispatch and wait
  is never harvested from a stale handle (which also keeps a handle's
  slot indices inside its own bank across resizes).

A finished slot rides the extra buffered tick frozen (PAD-only, a no-op
on tokens and scores, as in ``slot_block_steps`` > 1), so double
buffering cannot change a caption.  :meth:`SlotDecoder.tick` is
``tick_begin`` then ``tick_wait``.

Streams: a replica's engine carries its own CUDA stream
(``InferenceEngine.clone_for_device``); every device call of the decoder
(state, admission encode, steps, snapshots, zeroing, resizes) runs on it,
and the state is allocated on it, so two replicas on one card do not
serialize on one stream.  Without one (the single-engine scheduler) the
decoder uses the caller's current stream.

Tracing: ``tick_dispatch``, ``tick_wait`` and ``harvest`` spans (tagged
with the replica id) time the host side of each tick.

Speculative decode (``serving.speculative``, greedy only): each of a
tick's ``slot_block_steps`` iterations is a propose / verify round
(``decoding/speculative.py::spec_round``) instead of one step: the
engine's draft LSTM proposes ``draft_k`` tokens per slot from its own
(2, S, draft_hidden) float32 carry (``SlotState.draft``: zeroed at
admission and when a slot is freed, copied on a resize), and
``CaptionModel.decode_verify`` checks them with k chained steps and one
``row_dot`` over k*S rows, so a slot emits 1..k tokens a round, exactly
the plain loop's.  A (2,) device total of [emitted tokens, live
slot-rounds] grows by one device add a tick, with no host read;
:meth:`SlotDecoder.spec_stats` reads it.  A finished slot's frozen
rounds emit nothing.

Serving artifacts (``serving/artifact.py``): the variants the loop can
run are named as the reference names its compiled ones
(:meth:`SlotDecoder.aot_variant_keys`, :meth:`SlotDecoder.
aot_encode_buckets`), from the same bank ladder and admit buckets, and
each carries a signature of the state and admission shapes and dtypes it
runs at (:meth:`SlotDecoder.aot_signatures`).  An artifact records them,
and a boot refuses a ladder that drifted since the build.  Eager PyTorch
compiles nothing per shape; what a boot installs is the kernel
libraries, and ``warmup`` then pays each first launch.

Threading: a ``SlotDecoder`` is owned by one scheduler thread
(``ContinuousBatcher`` or one ``ReplicaSet`` worker); nothing here
locks.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import json
import logging
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cst_captioning_torch.constants import BOS_ID, PAD_ID
from cst_captioning_torch.decoding.core import (
    NEG_INF,
    CoreState,
    DecodeState,
    decode_step,
    make_tp_beam_topk,
    make_tp_row_pick,
)
from cst_captioning_torch.decoding.speculative import (
    draft_step,
    spec_round,
)
from cst_captioning_torch.models.captioner import DecodeCache
from cst_captioning_torch.observability.trace import service_tracer

_log = logging.getLogger("cst_captioning_torch.serving")


def _buckets(top: int) -> List[int]:
    out, b = [], 1
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return out


def _bank_ladder(lo: int, hi: int) -> List[int]:
    """Doubling ladder of slot-bank sizes ``[lo, 2·lo, ..., hi]``."""
    lo = max(1, min(int(lo), int(hi)))
    out, b = [lo], lo
    while b < hi:
        b = min(b * 2, hi)
        out.append(b)
    return out


class AdmissionError(RuntimeError):
    """The admission encode of a tick failed before any slot was
    claimed (a bad row): the slot state is untouched, and only the
    requests of that tick are lost."""


class TickHandle(NamedTuple):
    """One dispatched tick: its sequence number and host snapshots of its
    outputs, which later ticks never touch: ``done`` (S,) bool, ``seqs``
    (S, K, L) int32, ``scores`` (S, K) float32 (None greedy), filled by
    copies that complete by ``event`` (a CUDA event; None on the CPU,
    where the copies are done on return)."""

    seq: int
    done: torch.Tensor
    seqs: torch.Tensor
    scores: Optional[torch.Tensor]
    event: Any


class SlotState(NamedTuple):
    """Device state of all S slots: the decode carry (per-slot axes
    ``(S, K, ...)``, flat row axis ``S*K``), the projected cache rows,
    leading with S (deduplicated) or S*K (replicated), and under
    speculative decode the draft LSTM's (2, S, draft_hidden) float32
    carry (h row 0, c row 1; None otherwise)."""

    core: CoreState
    cache: DecodeCache
    draft: Optional[torch.Tensor] = None


class SlotDecoder:
    """See module doc.  Built by ``InferenceEngine.slot_decoder()``; the
    engine surface it uses is ``cfg``, ``model``, ``decode_mode``,
    ``max_batch``, ``device``, ``stream``, ``replica_id``,
    ``encode_prepared_rows`` and ``template_prepared``."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.cfg
        sv = cfg.serving
        self.greedy = engine.decode_mode == "greedy"
        self.K = 1 if self.greedy else int(cfg.eval.beam_size)
        self.L = int(cfg.eval.max_decode_len)
        self.S_max = int(sv.num_slots or engine.max_batch)
        if self.S_max < 1:
            raise ValueError(f"num_slots {self.S_max} < 1")
        self.dedup = bool(sv.dedup_cache)
        self.zero_freed = bool(sv.zero_freed_slots)
        bank_min = int(sv.slot_bank_min or 0)
        self.bank_ladder = (_bank_ladder(bank_min, self.S_max)
                            if bank_min > 0 else [self.S_max])
        self.shrink_after = max(1, int(sv.slot_shrink_idle_ticks))
        # Elastic mode starts at the smallest bank: capacity follows
        # traffic up.
        self.S = self.bank_ladder[0]
        self.block = max(1, int(sv.slot_block_steps))
        self.length_normalize = bool(cfg.eval.length_normalize)
        self.model = engine.model
        self.device = torch.device(engine.device)
        # Speculative decode: `slot_block_steps` propose / verify rounds a
        # tick, token-exact against the plain loop by the rejection rule.
        # The engine parsed and checked the config and built the draft.
        self.spec = engine.spec
        self.spec_k = self.spec.draft_k if self.spec else 0
        self.draft_hidden = (0 if self.spec is None else
                             int(engine.draft_params["draft_cell_b"].shape[0])
                             // 4)
        self.admit_cap = min(self.S_max, int(engine.max_batch))
        self._admit_buckets = _buckets(self.admit_cap)
        # Host-side bookkeeping (scheduler thread only).  ``free`` stays
        # sorted and admission takes the lowest index, so high slots
        # drain first and a bank shrink only drops free slots.
        self.free: List[int] = list(range(self.S))
        self.occupied: Dict[int, Any] = {}      # slot -> caller's data
        self.admit_tick: Dict[int, int] = {}    # slot -> admission tick
        self._seq = 0                           # ticks run
        self.steps_run = 0                      # decode steps run
        self.admit_ticks = 0                    # ticks that admitted
        self.resize_count = 0
        self._shrink_streak = 0
        self._last_handle: Optional[TickHandle] = None
        self.stream = getattr(engine, "stream", None)
        if self.stream is not None:
            # The weights were written on the caller's stream; the state
            # is allocated on the decoder's own, so its blocks are only
            # ever reused in that stream's order.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._st = self._init_state(self.S)
            # [emitted tokens, live slot-rounds] since warmup, on the
            # device (speculative decode only).
            self._spec_totals = (torch.zeros((2,), dtype=torch.float32,
                                             device=self.device)
                                 if self.spec is not None else None)
        self.tp_topk = self.tp_pick = None
        self._tp_hooks(engine)
        self.tracer = service_tracer(sv)
        rid = getattr(engine, "replica_id", None)
        self.span_tags: Dict[str, Any] = {} if rid is None else {"replica": rid}

    def _tp_hooks(self, engine) -> None:
        """A model-sharded engine's per-step selection (reference
        ``_build_step``): with ``serving.shard_fused_decode`` (default)
        the cross-shard candidate merge of ``decoding/core.py``, each
        shard top-K-ing its own vocab tile; off, or with a vocab that
        does not split (the leaves then stay replicated), the full
        logits."""
        tp = getattr(engine, "tp_mesh", None)
        if tp is None or tp.shape.get("model", 1) < 2:
            return
        if not bool(getattr(engine.cfg.serving, "shard_fused_decode", True)):
            return
        if self.model.vshards is None:
            _log.warning(
                "serving.shard_fused_decode requested but vocab %d does not "
                "tile over the %d-way model axis — keeping the full-vocab "
                "top-K (pad the vocab to a multiple of model_shards)",
                self.model.vocab_size, tp.shape["model"])
            return
        if self.greedy:
            self.tp_pick = make_tp_row_pick(tp)
        else:
            self.tp_topk = make_tp_beam_topk(tp)

    def _on_stream(self):
        """Context that runs device calls on the decoder's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------------------- device
    def _cache_rows(self, S: int) -> int:
        """Leading dim of the stored cache: one row per slot deduplicated,
        one per beam row replicated."""
        return S if self.dedup else S * self.K

    def _empty_cache(self, rows: int, device=None) -> DecodeCache:
        """Zero cache rows shaped like one encode output's (``cat_emb``
        under ``use_category``), on ``device`` (the decoder's by
        default)."""
        m, d = self.model, self.engine.cfg.data
        kw = dict(device=self.device if device is None else device)
        cdt = m.compute_dtype
        ctx = torch.zeros((rows, m.embed_size), dtype=cdt, **kw)
        cat = (torch.zeros((rows, m.category_embed_size), dtype=cdt, **kw)
               if m.use_category else None)
        if m.fusion != "attention":
            return DecodeCache(ctx_static=ctx, cat_emb=cat)
        F = d.max_frames * len(d.feature_modalities)
        return DecodeCache(
            ctx_static=ctx,
            att_vals=torch.zeros((rows, F, m.embed_size), dtype=cdt, **kw),
            att_proj=torch.zeros((rows, F, m.att_hidden_size), dtype=cdt,
                                 **kw),
            att_mask=torch.zeros((rows, F), dtype=torch.float32, **kw),
            cat_emb=cat)

    def _init_state(self, S: int, device=None) -> SlotState:
        """S empty slots: finished, step = L, zero rows (they ride
        frozen through every step), on ``device`` (the decoder's by
        default)."""
        m, K, L = self.model, self.K, self.L
        n = S * K
        device = self.device if device is None else device
        kw = dict(device=device)
        layers = (m.num_layers, n, m.rnn_size)
        core = CoreState(
            state=DecodeState(
                h=torch.zeros(layers, dtype=m.compute_dtype, **kw),
                c=torch.zeros(layers, dtype=torch.float32, **kw)),
            seqs=torch.full((S, K, L), PAD_ID, dtype=torch.int32, **kw),
            scores=(None if self.greedy
                    else torch.zeros((S, K), dtype=torch.float32, **kw)),
            lps=None,
            finished=torch.ones((S, K), dtype=torch.bool, **kw),
            tokens=torch.full((n,), BOS_ID, dtype=torch.int64, **kw),
            step=torch.full((S,), L, dtype=torch.int32, **kw),
        )
        draft = (None if self.spec is None
                 else torch.zeros((2, S, self.draft_hidden),
                                  dtype=torch.float32, **kw))
        return SlotState(core=core, cache=self._empty_cache(
            self._cache_rows(S), device), draft=draft)

    def _step_once(self) -> None:
        """One decode step over all S*K rows: the unified decode core
        with the slot axis as the batch axis."""
        cache, K = self._st.cache, self.K
        rep = K if self.dedup else 1

        def step_logits(state, tokens):
            return self.model.decode_logits(state, cache, tokens, rep=rep)

        core = decode_step(step_logits, self._st.core,
                           mode="greedy" if self.greedy else "beam",
                           topk_fn=self.tp_topk, pick_fn=self.tp_pick)
        self._st = self._st._replace(core=core)
        self.steps_run += 1

    def _spec_once(self) -> torch.Tensor:
        """One speculative round over all S slots (greedy: one row a
        slot, so the stored cache is the row layout).  Returns the
        round's (2,) [emitted, live] device stats."""
        cache, model = self._st.cache, self.model
        dp = self.engine.draft_params
        suppress = bool(model.decode_suppress_unk)

        def verify_fn(state, vin):
            return model.decode_verify(state, cache, vin)

        def draft_fn(c, tok):
            return draft_step(dp, c, tok, suppress)

        core, draft, stats = spec_round(verify_fn, draft_fn, self._st.core,
                                        self._st.draft, self.spec_k,
                                        pick_fn=self.tp_pick)
        self._st = self._st._replace(core=core, draft=draft)
        self.steps_run += 1
        return stats

    def _rows_of(self, slots: Sequence[int]) -> torch.Tensor:
        """Flat row indices of ``slots`` (K contiguous rows each)."""
        s = torch.as_tensor(list(slots), dtype=torch.int64)
        rows = (s[:, None] * self.K + torch.arange(self.K)[None, :])
        return rows.reshape(-1).to(self.device)

    def _admit(self, slots: Sequence[int], rows: DecodeCache) -> None:
        """Scatter admission rows (``rows`` leads with len(slots) rows,
        one per request) and a fresh carry into ``slots``."""
        K = self.K
        slot_ix = torch.as_tensor(list(slots), dtype=torch.int64,
                                  device=self.device)
        row_ix = self._rows_of(slots)
        cache_ix = slot_ix if self.dedup else row_ix
        for leaf, new in zip(self._st.cache, rows):
            if leaf is None:
                continue
            new = new[: len(slots)].to(leaf.dtype)
            if not self.dedup:
                new = new.repeat_interleave(K, dim=0)
            leaf[cache_ix] = new
        co = self._st.core
        co.state.h[:, row_ix] = 0
        co.state.c[:, row_ix] = 0
        co.seqs[slot_ix] = PAD_ID
        if co.scores is not None:
            scores0 = torch.full((K,), NEG_INF, dtype=torch.float32,
                                 device=self.device)
            scores0[0] = 0.0
            co.scores[slot_ix] = scores0
        co.finished[slot_ix] = False
        co.tokens[row_ix] = BOS_ID
        co.step[slot_ix] = 0
        if self._st.draft is not None:
            # A fresh draft carry: the previous occupant's cannot leak.
            self._st.draft[:, slot_ix] = 0

    def _zero_slots(self, slots: Sequence[int]) -> None:
        """Reset freed slots to the empty pattern (zero rows, PAD,
        finished, step = L) so the byte gauges report what is live."""
        if not self.zero_freed or not slots:
            return
        with self._on_stream():
            self._zero_rows(slots)

    def _zero_rows(self, slots: Sequence[int]) -> None:
        slot_ix = torch.as_tensor(list(slots), dtype=torch.int64,
                                  device=self.device)
        row_ix = self._rows_of(slots)
        cache_ix = slot_ix if self.dedup else row_ix
        for leaf in self._st.cache:
            if leaf is not None:
                leaf[cache_ix] = 0
        co = self._st.core
        co.state.h[:, row_ix] = 0
        co.state.c[:, row_ix] = 0
        co.seqs[slot_ix] = PAD_ID
        if co.scores is not None:
            co.scores[slot_ix] = 0.0
        co.finished[slot_ix] = True
        co.tokens[row_ix] = BOS_ID
        co.step[slot_ix] = self.L
        if self._st.draft is not None:
            self._st.draft[:, slot_ix] = 0

    def _resize(self, S_to: int) -> SlotState:
        """The state at bank ``S_to``: the surviving prefix copied (grow
        pads with empty slots; shrink drops slots >= S_to, which callers
        guarantee are free).  Rows are copied, never recomputed."""
        old, new = self._st, self._init_state(S_to)
        n = min(self.S, S_to)

        def copy(dst, src, rows, axis=0):
            if dst is None:
                return
            ix = [slice(None)] * dst.dim()
            ix[axis] = slice(0, rows)
            dst[tuple(ix)] = src[tuple(ix)]

        for d, s_ in zip(new.cache, old.cache):
            copy(d, s_, self._cache_rows(n))
        co, cn = old.core, new.core
        copy(cn.state.h, co.state.h, n * self.K, axis=1)
        copy(cn.state.c, co.state.c, n * self.K, axis=1)
        for name in ("seqs", "scores", "finished", "step"):
            copy(getattr(cn, name), getattr(co, name), n)
        copy(cn.tokens, co.tokens, n * self.K)
        copy(new.draft, old.draft, n, axis=1)
        return new

    def _pad_bucket(self, n: int) -> int:
        for b in self._admit_buckets:
            if b >= n:
                return b
        return self._admit_buckets[-1]

    # ------------------------------------------------------ elastic banks
    def _set_bank(self, S_to: int) -> None:
        S_from = self.S
        if S_to == S_from:
            return
        if S_to < S_from:
            busy = [s for s in self.occupied if s >= S_to]
            if busy:
                raise RuntimeError(f"bank shrink {S_from}->{S_to} with "
                                   f"occupied slots {busy}")
        t0 = time.perf_counter()
        with self._on_stream():
            self._st = self._resize(S_to)
        if S_to > S_from:
            self.free.extend(range(S_from, S_to))
        else:
            self.free = [s for s in self.free if s < S_to]
        self.free.sort()
        self.S = S_to
        self.resize_count += 1
        _log.info("slot bank %d -> %d (%.2fms)", S_from, S_to,
                  (time.perf_counter() - t0) * 1e3)

    def maybe_resize(self, pending: int = 0) -> int:
        """Elastic-bank policy, called at tick boundaries with the queue
        depth: grow (possibly several rungs) while pending work exceeds
        free slots; shrink one rung after ``slot_shrink_idle_ticks``
        consecutive calls in which occupancy + queue fit the next bank
        down.  Returns the (possibly new) bank size."""
        if len(self.bank_ladder) == 1:
            return self.S
        i = self.bank_ladder.index(self.S)
        grew = False
        while pending > len(self.free) and i + 1 < len(self.bank_ladder):
            i += 1
            self._set_bank(self.bank_ladder[i])
            grew = True
        if grew:
            self._shrink_streak = 0
            return self.S
        if i > 0:
            lower = self.bank_ladder[i - 1]
            fits = (self.n_occupied + pending <= lower
                    and all(s < lower for s in self.occupied))
            if fits:
                self._shrink_streak += 1
                if self._shrink_streak >= self.shrink_after:
                    self._set_bank(lower)
                    self._shrink_streak = 0
            else:
                self._shrink_streak = 0
        return self.S

    # ------------------------------------------------------ byte accounting
    @staticmethod
    def _bytes(tensors) -> int:
        return int(sum(x.numel() * x.element_size()
                       for x in tensors if x is not None))

    def state_bytes(self) -> int:
        """Bytes of the resident slot state (allocated bank), measured
        from the tensors."""
        co = self._st.core
        return self._bytes((co.state.h, co.state.c, co.seqs, co.scores,
                            co.finished, co.tokens, co.step, self._st.draft)
                           + tuple(self._st.cache))

    def cache_bytes(self) -> int:
        """Bytes of the stored read-only cache rows (the part the dedup
        divides by K)."""
        return self._bytes(self._st.cache)

    def carry_bytes(self) -> int:
        """Bytes of the per-row carry (h/c, seqs, scores, finished,
        tokens, counters)."""
        return self.state_bytes() - self.cache_bytes()

    def per_slot_bytes(self) -> int:
        """Decode-state bytes per in-flight request (every leaf scales
        linearly with S)."""
        return self.state_bytes() // self.S

    def live_state_bytes(self) -> int:
        """Bytes attributable to occupied slots."""
        return self.per_slot_bytes() * self.n_occupied

    def expected_state_bytes(self, S: Optional[int] = None) -> int:
        """Closed-form twin of :meth:`state_bytes` from config shapes:

        cache per stored row: E·cdt (ctx_static), plus under attention
          F·E·cdt (att_vals) + F·A·cdt (att_proj) + F·4 (att_mask), plus
          under ``use_category`` C·cdt (cat_emb);
          × S rows deduplicated, S·K replicated;
        carry per slot: layers·K·H·(cdt + 4) (h, c) + K·T·4 (seqs, T
          the decode length) + K·4 (beam scores) + K (finished) + K·8
          (tokens) + 4 (step) + 2·draft_hidden·4 (the speculative draft
          carry)."""
        S = self.S if S is None else S
        m, d = self.model, self.engine.cfg.data
        K, T, layers = self.K, self.L, m.num_layers
        cdt = torch.empty((), dtype=m.compute_dtype).element_size()
        E, H = m.embed_size, m.rnn_size
        row = (E + m.category_embed_size) * cdt
        if m.fusion == "attention":
            F = d.max_frames * len(d.feature_modalities)
            row += F * E * cdt + F * m.att_hidden_size * cdt + F * 4
        carry = (layers * K * H * (cdt + 4) + K * T * 4
                 + (0 if self.greedy else K * 4) + K + K * 8 + 4
                 + 2 * self.draft_hidden * 4)
        return self._cache_rows(S) * row + S * carry

    # --------------------------------------------------------------- host
    @property
    def n_occupied(self) -> int:
        return len(self.occupied)

    def tick_begin(self, prepared: Sequence[Any] = (),
                   datas: Sequence[Any] = ()) -> Optional[TickHandle]:
        """Dispatch one scheduler iteration without a host sync: admit
        ``prepared`` (at most ``admit_cap`` and the free slots; ``datas``
        are the callers' handles), enqueue ``slot_block_steps`` decode
        steps over all slots and the snapshot copies.  Returns the
        :class:`TickHandle`, or None with nothing to admit and no
        occupied slot (no device work).  Raises :class:`AdmissionError`
        if the admission encode fails (nothing claimed); any other
        failure leaves the slot state unknown."""
        n = len(prepared)
        if n == 0 and not self.occupied:
            return None
        t_begin = time.monotonic()
        if n > len(self.free) or n > self.admit_cap:
            raise RuntimeError(f"tick admitting {n} exceeds free="
                               f"{len(self.free)} cap={self.admit_cap}")
        with self._on_stream():
            slots: List[int] = []
            if n:
                A = self._pad_bucket(n)
                # Pad by replicating the last request (row-independent
                # encode); encode before claiming slots so a failed
                # encode leaks nothing.
                reqs = list(prepared) + [prepared[-1]] * (A - n)
                try:
                    rows = self.engine.encode_prepared_rows(reqs)
                except Exception as e:  # noqa: BLE001 — re-raised, typed
                    raise AdmissionError(
                        f"admission encode failed: {e}") from e
                slots = [self.free.pop(0) for _ in range(n)]
                for s in slots:
                    if s in self.occupied:  # pragma: no cover — invariant
                        raise RuntimeError(f"slot {s} double-assigned")
                self._admit(slots, rows)
                self.admit_ticks += 1
            self._seq += 1
            for s, d in zip(slots, datas):
                self.occupied[s] = d
                self.admit_tick[s] = self._seq
            if self.spec is None:
                for _ in range(self.block):
                    self._step_once()
            else:
                for _ in range(self.block):
                    # A device add: the totals are never read here.
                    self._spec_totals += self._spec_once()
            handle = self._snapshot()
        self._last_handle = handle
        self.tracer.record("tick_dispatch", t_begin, time.monotonic(),
                           tags=dict(self.span_tags, seq=self._seq, admits=n))
        return handle

    def _snapshot(self) -> TickHandle:
        """The tick's ``done`` / ``seqs`` / ``scores``, copied to the
        host: on a card into fresh pinned buffers, without a sync, with
        an event recorded after the copies."""
        co = self._st.core
        outs = (co.finished.all(dim=-1) | (co.step >= self.L), co.seqs,
                co.scores)
        if self.device.type != "cuda":
            host = [None if x is None else x.clone() for x in outs]
            return TickHandle(self._seq, *host, None)
        host = []
        for x in outs:
            if x is None:
                host.append(None)
                continue
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return TickHandle(self._seq, *host, event)

    def tick_wait(self, handle: TickHandle) -> List[int]:
        """Wait for ``handle``'s snapshots and return the occupied slots
        it reports done (all rows finished, or the length cap).  Slots
        whose occupant was admitted after the handle's tick are left out:
        their flags in it describe the previous occupant."""
        t0 = time.monotonic()
        if handle.event is not None:
            handle.event.synchronize()
        done = handle.done.numpy()
        self.tracer.record("tick_wait", t0, time.monotonic(),
                           tags=dict(self.span_tags, seq=handle.seq))
        return [s for s in self.occupied
                if self.admit_tick[s] <= handle.seq and bool(done[s])]

    def tick(self, prepared: Sequence[Any] = (),
             datas: Sequence[Any] = ()) -> List[int]:
        """One synchronous scheduler iteration: :meth:`tick_begin` then
        :meth:`tick_wait`.  Returns the occupied slots that are now
        done."""
        handle = self.tick_begin(prepared, datas)
        return [] if handle is None else self.tick_wait(handle)

    def harvest_many(self, slots: Sequence[int]
                     ) -> List[Tuple[Any, np.ndarray, float, int]]:
        """Extract done slots from the last dispatched tick (the
        synchronous loop's harvest)."""
        if not slots:
            return []
        if self._last_handle is None:
            raise RuntimeError("harvest before any tick")
        return self.harvest_from(self._last_handle, slots)

    def harvest_from(self, handle: TickHandle, slots: Sequence[int]
                     ) -> List[Tuple[Any, np.ndarray, float, int]]:
        """Extract done slots' best hypotheses from ``handle``'s
        snapshots (finalize_beams in numpy, stable sort; the handle must
        have been waited on) and free the slots.  Returns ``[(data,
        tokens (L,) int32, score, steps paid), ...]`` in ``slots``
        order."""
        if not slots:
            return []
        t_harvest = time.monotonic()
        for s in slots:
            if s not in self.occupied:
                raise RuntimeError(f"harvest of unoccupied slot {s}")
            if self.admit_tick[s] > handle.seq:
                raise RuntimeError(
                    f"slot {s} admitted at tick {self.admit_tick[s]} > "
                    f"harvest handle tick {handle.seq}")
        ix = list(slots)
        seqs = handle.seqs.numpy()[ix]                     # (n, K, L)
        if self.greedy:
            best = np.zeros((len(slots),), int)
            final = np.zeros((len(slots), 1), np.float32)
        else:
            scores = handle.scores.numpy()[ix]             # (n, K)
            if self.length_normalize:
                lengths = np.maximum((seqs != PAD_ID).sum(-1), 1)
                final = scores / lengths.astype(np.float32)
            else:
                final = scores
            best = np.argsort(-final, axis=-1, kind="stable")[:, 0]
        out = []
        for i, slot in enumerate(slots):
            data = self.occupied.pop(slot)
            # Device steps the caption paid: every tick from its
            # admission through the handle's ran `block` steps over it
            # (speculative rounds up to draft_k each: an upper bound,
            # capped at L below).
            paid = ((handle.seq - self.admit_tick.pop(slot) + 1)
                    * self.block * max(1, self.spec_k))
            bisect.insort(self.free, slot)
            out.append((data, seqs[i, best[i]], float(final[i, best[i]]),
                        min(paid, self.L)))
        self._zero_slots(list(slots))
        self.tracer.record("harvest", t_harvest, time.monotonic(),
                           tags=dict(self.span_tags, seq=handle.seq,
                                     slots=len(slots)))
        return out

    def harvest(self, slot: int) -> Tuple[np.ndarray, float, int]:
        """Single-slot harvest (tests / tools)."""
        _, tokens, score, steps = self.harvest_many([slot])[0]
        return tokens, score, steps

    def evict(self, slot: int) -> Any:
        """Free a slot without extracting (drain-deadline abandonment).
        Returns the caller data so its future can be failed."""
        data = self.occupied.pop(slot)
        self.admit_tick.pop(slot, None)
        bisect.insort(self.free, slot)
        self._zero_slots([slot])
        return data

    def drain(self) -> List[Tuple[Any, np.ndarray, float, int]]:
        """Tick with no admissions until every occupied slot finishes;
        harvest everything."""
        out = []
        while self.occupied:
            out.extend(self.harvest_many(self.tick()))
        return out

    def warmup(self) -> None:
        """Run each bank once (a template request admitted, decoded and
        harvested), so the first served request and the first regrow pay
        no kernel build or first-launch cost; then walk back down to the
        smallest bank."""
        req = self.engine.template_prepared()
        for bank in self.bank_ladder:
            self._set_bank(bank)
            self.harvest_many(self.tick([req], [None]))
            self.drain()
        for bank in reversed(self.bank_ladder[:-1]):
            self._set_bank(bank)
        self.resize_count = 0
        if self._spec_totals is not None:
            # Warmup traffic does not count toward served acceptance.
            with self._on_stream():
                self._spec_totals.zero_()

    # ----------------------------------------------- AOT artifact ladder
    # Every variant the loop can run once warm, enumerated from the same
    # bank ladder and admit buckets as the reference's SlotDecoder names
    # its compiled ones (``serving/artifact.py`` records them and refuses
    # a boot whose live ladder drifted).

    def warm_admit_counts(self, bank: int) -> List[int]:
        """Admission counts a tick can dispatch at ``bank``, with the
        pure-step tick (A = 0): the pad bucket of every n <= min(bank,
        admit_cap)."""
        return sorted({self._pad_bucket(min(b, bank))
                       for b in self._admit_buckets} | {0})

    def _variants(self):
        """``(key, (kind, banks..., admit count))`` of every variant, the
        keys the reference's: a tick per (bank, admit count),
        ``:k<draft_k>`` under speculative decode; the freed-slot zeroing
        per bank under ``zero_freed_slots``; both directions of every
        adjacent bank transition."""
        sfx = f":k{self.spec_k}" if self.spec is not None else ""
        for bank in self.bank_ladder:
            for A in self.warm_admit_counts(bank):
                yield f"tick:S{bank}:A{A}{sfx}", ("tick", bank, A)
            if self.zero_freed:
                yield f"free:S{bank}", ("free", bank)
        for a, b in zip(self.bank_ladder, self.bank_ladder[1:]):
            yield f"resize:{a}->{b}", ("resize", a, b)
            yield f"resize:{b}->{a}", ("resize", b, a)

    def aot_variant_keys(self) -> List[str]:
        """The variant keys, in the reference's order (:meth:`_variants`)."""
        return [key for key, _ in self._variants()]

    def aot_encode_buckets(self) -> List[int]:
        """Every batch the admission encode can run
        (``InferenceEngine.encode_prepared_rows``): the admit buckets
        (a full miss) and the power-of-two buckets of a mixed miss, up
        to the first power of two >= ``admit_cap``."""
        p = 1
        while p < self.admit_cap:
            p *= 2
        pow2, b = [], 1
        while b <= p:
            pow2.append(b)
            b *= 2
        return sorted(set(self._admit_buckets) | set(pow2))

    @staticmethod
    def _leaves(prefix: str, tree) -> List[List[Any]]:
        """[name, shape, dtype] of every tensor leaf of a NamedTuple."""
        out: List[List[Any]] = []
        for name, x in zip(tree._fields, tree):
            if isinstance(x, tuple):
                out += SlotDecoder._leaves(f"{prefix}{name}.", x)
            elif x is not None:
                out.append([prefix + name, list(x.shape),
                            str(x.dtype).replace("torch.", "")])
        return out

    def aot_signatures(self) -> Tuple[Dict[str, str], Dict[str, str]]:
        """``({variant key: signature}, {"encode:B<b>": signature})``: a
        signature is 16 hex digits of sha256 over the shapes and dtypes a
        variant runs on (the slot state at its banks, the admission rows
        and slot ids at its count, the encode's inputs and rows) and the
        model's parameters, the port's counterpart of the reference's
        hash of the lowered program.  Computed on the meta device:
        nothing is allocated."""
        meta = torch.device("meta")
        params = [[k, list(v.shape), str(v.dtype).replace("torch.", "")]
                  for k, v in sorted(self.model.state_dict().items())]

        def sig(*parts) -> str:
            blob = json.dumps([params, self.K, self.L, self.dedup,
                               self.spec_k, self.draft_hidden, *parts])
            return hashlib.sha256(blob.encode()).hexdigest()[:16]

        states = {S: self._leaves("", self._init_state(S, meta))
                  for S in self.bank_ladder}
        ticks: Dict[str, str] = {}
        for key, (kind, bank, *rest) in self._variants():
            if kind == "resize":
                ticks[key] = sig(kind, states[bank], states[rest[0]])
                continue
            A = rest[0] if rest else 0
            rows = (self._leaves("rows.", self._empty_cache(A, meta))
                    + [["slots", [A], "int64"]]) if A else []
            ticks[key] = sig(kind, states[bank], rows)
        d = self.engine.cfg.data
        enc: Dict[str, str] = {}
        for b in self.aot_encode_buckets():
            inputs = [[f"feats.{m}", [b, d.max_frames, d.feature_dims[m]],
                       "float32"] for m in d.feature_modalities]
            inputs += [[f"masks.{m}", [b, d.max_frames], "float32"]
                       for m in d.feature_modalities]
            if self.model.use_category:
                inputs.append(["category", [b], "int64"])
            enc[f"encode:B{b}"] = sig("encode", inputs, self._leaves(
                "rows.", self._empty_cache(b, meta)))
        return ticks, enc

    def spec_stats(self) -> Dict[str, float]:
        """Speculation since warmup (one device read of the running
        total): emitted tokens, live slot-rounds, the acceptance rate
        ((emitted - rounds) / (rounds * (k - 1)), the share of offered
        draft tokens the verify accepted) and tokens per live round (1.0
        is the plain loop's floor, k the ceiling).  Empty without
        speculation."""
        if self._spec_totals is None:
            return {}
        with self._on_stream():
            tot = self._spec_totals.cpu().numpy()
        emitted, rounds = float(tot[0]), float(tot[1])
        k = self.spec_k
        acc = (min(1.0, max(0.0, (emitted - rounds) / (rounds * (k - 1))))
               if rounds > 0 and k > 1 else 0.0)
        return {
            "draft_k": float(k),
            "emitted_tokens": emitted,
            "live_slot_rounds": rounds,
            "acceptance_rate": acc,
            "tokens_per_round": emitted / rounds if rounds > 0 else 0.0,
        }

    def describe(self) -> Dict[str, Any]:
        return {
            "slots": self.S,
            "max_slots": self.S_max,
            "bank_ladder": list(self.bank_ladder),
            "rows_per_slot": self.K,
            "block_steps": self.block,
            "max_steps": self.L,
            "mode": "greedy" if self.greedy else "beam",
            "admit_cap": self.admit_cap,
            "dedup_cache": self.dedup,
            "state_bytes": self.state_bytes(),
            "live_state_bytes": self.live_state_bytes(),
            "bytes_per_request": self.per_slot_bytes(),
            "bank_resizes": self.resize_count,
            "speculative": ({} if self.spec is None else {
                "draft_k": self.spec.draft_k,
                "draft_hidden": self.draft_hidden}),
        }
