"""Continuous in-flight batching: the persistent slot-based decode loop
(port of the JAX package's ``serving/slots.py::SlotDecoder``, the
synchronous single-device loop).

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

What the reference has and this loop does not (ROADMAP Queue 1):
``tick_begin`` / ``tick_wait`` double buffering (the replicas' path),
speculative rounds, AOT artifacts and the CST slot rollout.  There is
nothing to compile in eager PyTorch, so there are no per-shape variants;
admission still pads to a bucket, which cannot change a row.

Threading: a ``SlotDecoder`` is owned by one scheduler thread
(``serving/batcher.py::ContinuousBatcher``); nothing here locks.
"""

from __future__ import annotations

import bisect
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
)
from cst_captioning_torch.models.captioner import DecodeCache

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


class SlotState(NamedTuple):
    """Device state of all S slots: the decode carry (per-slot axes
    ``(S, K, ...)``, flat row axis ``S*K``) and the projected cache rows,
    leading with S (deduplicated) or S*K (replicated)."""

    core: CoreState
    cache: DecodeCache


class SlotDecoder:
    """See module doc.  Built by ``InferenceEngine.slot_decoder()``; the
    engine surface it uses is ``cfg``, ``model``, ``decode_mode``,
    ``max_batch``, ``device``, ``encode_prepared_rows`` and
    ``template_prepared``."""

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
        self.resize_count = 0
        self._shrink_streak = 0
        self._st = self._init_state(self.S)

    # ------------------------------------------------------------- device
    def _cache_rows(self, S: int) -> int:
        """Leading dim of the stored cache: one row per slot deduplicated,
        one per beam row replicated."""
        return S if self.dedup else S * self.K

    def _empty_cache(self, rows: int) -> DecodeCache:
        """Zero cache rows shaped like one encode output's."""
        m, d = self.model, self.engine.cfg.data
        kw = dict(device=self.device)
        cdt = m.compute_dtype
        ctx = torch.zeros((rows, m.embed_size), dtype=cdt, **kw)
        if m.fusion != "attention":
            return DecodeCache(ctx_static=ctx)
        F = d.max_frames * len(d.feature_modalities)
        return DecodeCache(
            ctx_static=ctx,
            att_vals=torch.zeros((rows, F, m.embed_size), dtype=cdt, **kw),
            att_proj=torch.zeros((rows, F, m.att_hidden_size), dtype=cdt,
                                 **kw),
            att_mask=torch.zeros((rows, F), dtype=torch.float32, **kw))

    def _init_state(self, S: int) -> SlotState:
        """S empty slots: finished, step = L, zero rows (they ride
        frozen through every step)."""
        m, K, L = self.model, self.K, self.L
        n = S * K
        kw = dict(device=self.device)
        core = CoreState(
            state=DecodeState(
                h=torch.zeros((1, n, m.rnn_size), dtype=m.compute_dtype,
                              **kw),
                c=torch.zeros((1, n, m.rnn_size), dtype=torch.float32, **kw)),
            seqs=torch.full((S, K, L), PAD_ID, dtype=torch.int32, **kw),
            scores=(None if self.greedy
                    else torch.zeros((S, K), dtype=torch.float32, **kw)),
            lps=None,
            finished=torch.ones((S, K), dtype=torch.bool, **kw),
            tokens=torch.full((n,), BOS_ID, dtype=torch.int64, **kw),
            step=torch.full((S,), L, dtype=torch.int32, **kw),
        )
        return SlotState(core=core, cache=self._empty_cache(
            self._cache_rows(S)))

    def _step_once(self) -> None:
        """One decode step over all S*K rows: the unified decode core
        with the slot axis as the batch axis."""
        cache, K = self._st.cache, self.K
        rep = K if self.dedup else 1

        def step_logits(state, tokens):
            return self.model.decode_logits(state, cache, tokens, rep=rep)

        core = decode_step(step_logits, self._st.core,
                           mode="greedy" if self.greedy else "beam")
        self._st = SlotState(core=core, cache=cache)
        self.steps_run += 1

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

    def _zero_slots(self, slots: Sequence[int]) -> None:
        """Reset freed slots to the empty pattern (zero rows, PAD,
        finished, step = L) so the byte gauges report what is live."""
        if not self.zero_freed or not slots:
            return
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
                            co.finished, co.tokens, co.step)
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
          F·E·cdt (att_vals) + F·A·cdt (att_proj) + F·4 (att_mask);
          × S rows deduplicated, S·K replicated;
        carry per slot: K·H·(cdt + 4) (h, c) + K·L·4 (seqs) + K·4 (beam
          scores) + K (finished) + K·8 (tokens) + 4 (step)."""
        S = self.S if S is None else S
        m, d = self.model, self.engine.cfg.data
        K, L = self.K, self.L
        cdt = torch.empty((), dtype=m.compute_dtype).element_size()
        E, H = m.embed_size, m.rnn_size
        row = E * cdt
        if m.fusion == "attention":
            F = d.max_frames * len(d.feature_modalities)
            row += F * E * cdt + F * m.att_hidden_size * cdt + F * 4
        carry = (K * H * (cdt + 4) + K * L * 4
                 + (0 if self.greedy else K * 4) + K + K * 8 + 4)
        return self._cache_rows(S) * row + S * carry

    # --------------------------------------------------------------- host
    @property
    def n_occupied(self) -> int:
        return len(self.occupied)

    def tick(self, prepared: Sequence[Any] = (),
             datas: Sequence[Any] = ()) -> List[int]:
        """One scheduler iteration: admit ``prepared`` (at most
        ``admit_cap`` and the free slots; ``datas`` are the callers'
        handles), run ``slot_block_steps`` decode steps over all slots,
        and return the occupied slots that are now done (all rows
        finished, or the length cap).  With nothing to admit and no
        occupied slot it does no device work.  Raises
        :class:`AdmissionError` if the admission encode fails (nothing
        claimed); any other failure leaves the slot state unknown."""
        n = len(prepared)
        if n == 0 and not self.occupied:
            return []
        if n > len(self.free) or n > self.admit_cap:
            raise RuntimeError(f"tick admitting {n} exceeds free="
                               f"{len(self.free)} cap={self.admit_cap}")
        slots: List[int] = []
        if n:
            A = self._pad_bucket(n)
            # Pad by replicating the last request (row-independent
            # encode); encode before claiming slots so a failed encode
            # leaks nothing.
            reqs = list(prepared) + [prepared[-1]] * (A - n)
            try:
                rows = self.engine.encode_prepared_rows(reqs)
            except Exception as e:  # noqa: BLE001 — re-raised, typed
                raise AdmissionError(f"admission encode failed: {e}") from e
            slots = [self.free.pop(0) for _ in range(n)]
            self._admit(slots, rows)
        self._seq += 1
        for s, d in zip(slots, datas):
            self.occupied[s] = d
            self.admit_tick[s] = self._seq
        for _ in range(self.block):
            self._step_once()
        co = self._st.core
        done = (co.finished.all(dim=-1) | (co.step >= self.L)).cpu().numpy()
        return [s for s in self.occupied if bool(done[s])]

    def harvest_many(self, slots: Sequence[int]
                     ) -> List[Tuple[Any, np.ndarray, float, int]]:
        """Extract done slots' best hypotheses from the last tick's
        state (finalize_beams in numpy, stable sort) and free the slots.
        Returns ``[(data, tokens (L,) int32, score, steps paid), ...]``
        in ``slots`` order."""
        if not slots:
            return []
        for s in slots:
            if s not in self.occupied:
                raise RuntimeError(f"harvest of unoccupied slot {s}")
        ix = torch.as_tensor(list(slots), dtype=torch.int64,
                             device=self.device)
        co = self._st.core
        seqs = co.seqs[ix].cpu().numpy()                    # (n, K, L)
        if self.greedy:
            best = np.zeros((len(slots),), int)
            final = np.zeros((len(slots), 1), np.float32)
        else:
            scores = co.scores[ix].cpu().numpy()            # (n, K)
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
            # admission through this one ran `block` steps over it.
            paid = (self._seq - self.admit_tick.pop(slot) + 1) * self.block
            bisect.insort(self.free, slot)
            out.append((data, seqs[i, best[i]], float(final[i, best[i]]),
                        min(paid, self.L)))
        self._zero_slots(list(slots))
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
        }
