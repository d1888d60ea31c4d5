"""Request scheduling over the inference engine: one bounded admission
queue, two dispatch disciplines (port of the core of the JAX package's
``serving/batcher.py``).

Requests from any number of front-end threads enter a BOUNDED queue
(``submit`` blocks the caller until its caption resolves).  One
scheduler thread drains it under one of two disciplines:

* :class:`MicroBatcher` (``serving.continuous = false``): coalesce up to
  ``max_batch_size`` requests for at most ``max_wait_ms`` after the
  first arrival, pad to the engine's ladder, decode the batch to
  completion.
* :class:`ContinuousBatcher` (``serving.continuous = true``, the
  default): the queue feeds the engine's persistent slot loop
  (``serving/slots.py``); each iteration admits pending requests into
  free slots, grows or shrinks the slot bank, ticks
  ``slot_block_steps`` decode steps over all slots, and resolves every
  caption that finished, so nothing waits for a batch boundary.

Shared semantics: tier-1 cache hits return without touching the queue;
a full queue raises :class:`BackpressureError` (HTTP 429); a request
whose deadline passes while queued fails with
:class:`DeadlineExceededError` before it costs device work; ``stop``
closes admissions and drains queued and in-flight work within
``drain_timeout_s``.

Not ported yet (ROADMAP.md Queue 1, item 5): priorities and shedding,
hedging, Retry-After jitter, chaos injection, span tracing and the
flight recorder.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.metrics import ServingMetrics
from cst_captioning_torch.serving.slots import AdmissionError

_log = logging.getLogger("cst_captioning_torch.serving")


class BackpressureError(Exception):
    """Bounded queue is full — retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"request queue full; retry after {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class DeadlineExceededError(Exception):
    """The request's deadline passed before a result was produced."""


class ShuttingDownError(Exception):
    """The server is draining — no new requests are admitted (503)."""


class _Pending:
    __slots__ = ("prepared", "future", "t_enqueue", "t_admit", "deadline")

    def __init__(self, prepared, deadline: float):
        self.prepared = prepared
        self.future: "Future[Dict[str, Any]]" = Future()
        self.t_enqueue = time.monotonic()
        self.t_admit = self.t_enqueue
        self.deadline = deadline


def _settle(p: _Pending, result=None, exc: Optional[BaseException] = None) -> bool:
    if p.future.done():
        return False
    if exc is not None:
        p.future.set_exception(exc)
    else:
        p.future.set_result(result)
    return True


class _BatcherBase:
    """The bounded queue, ``submit``, lifecycle and drain shared by both
    disciplines; a subclass supplies the scheduler loop ``_loop``."""

    _thread_name = "caption-batcher"

    def __init__(self, engine: InferenceEngine,
                 metrics: Optional[ServingMetrics] = None, *,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None):
        sv = engine.cfg.serving
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        self.max_batch = int(max_batch_size or engine.max_batch)
        self.max_wait_s = (sv.max_wait_ms if max_wait_ms is None
                           else max_wait_ms) / 1e3
        self.queue_depth = int(queue_depth or sv.queue_depth)
        self.default_deadline_s = (sv.default_deadline_ms
                                   if default_deadline_ms is None
                                   else default_deadline_ms) / 1e3
        self.retry_after_s = float(sv.retry_after_s)
        self.drain_timeout_s = (sv.drain_timeout_s if drain_timeout_s is None
                                else drain_timeout_s)
        self._q: Deque[_Pending] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._drain = True
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "_BatcherBase":
        if self._thread is None:
            self._stop = self._draining = False
            self._thread = threading.Thread(
                target=self._run, name=self._thread_name, daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut down; ``drain=True`` serves queued work first (bounded by
        ``drain_timeout_s``), ``drain=False`` fails it."""
        with self._cond:
            self._draining = True
            self._drain = drain
            self._stop = True
            t = self._thread
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=self.drain_timeout_s + 60.0)
        with self._cond:
            self._thread = None
            while self._q:
                _settle(self._q.popleft(), exc=RuntimeError("batcher stopped"))

    # -------------------------------------------------------------- submit
    def submit(self, payload: Dict[str, Any],
               deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """Blocking entry point: ``{"caption", "tokens", "cached",
        "timings_ms"}``.  Raises ``ValueError`` (bad input),
        :class:`BackpressureError`, :class:`DeadlineExceededError` or
        :class:`ShuttingDownError`."""
        if self._thread is None:
            raise RuntimeError(f"{type(self).__name__} not started")
        if self._draining:
            raise ShuttingDownError("server is draining")
        t_submit = time.monotonic()
        prepared = self.engine.prepare(payload)
        hit = (self.engine.lookup_caption(prepared.cache_key)
               if prepared.cache_key else None)
        if hit is not None:
            self.metrics.requests_total.inc()
            self.metrics.requests_served.inc()
            total_ms = (time.monotonic() - t_submit) * 1e3
            self.metrics.observe_stage("total", total_ms)
            return {"caption": hit["caption"], "tokens": hit["tokens"],
                    "cached": True, "timings_ms": {"total_ms": total_ms}}
        deadline_s = (deadline_ms / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        p = _Pending(prepared, t_submit + deadline_s)
        with self._cond:
            if self._draining:
                raise ShuttingDownError("server is draining")
            if len(self._q) >= self.queue_depth:
                self.metrics.requests_rejected.inc()
                raise BackpressureError(self.retry_after_s)
            self._q.append(p)
            self.metrics.requests_total.inc()
            self._cond.notify_all()
        try:
            return p.future.result(timeout=deadline_s + 60.0)
        finally:
            self.metrics.observe_stage(
                "total", (time.monotonic() - p.t_enqueue) * 1e3)

    # ----------------------------------------------------------- scheduler
    def _run(self) -> None:
        try:
            self._loop()
        except Exception:  # noqa: BLE001 — scheduler death is fatal
            _log.exception("scheduler thread died")
            with self._cond:
                self._draining = True
                while self._q:
                    if _settle(self._q.popleft(),
                               exc=RuntimeError("scheduler thread died")):
                        self.metrics.requests_failed.inc()

    def _loop(self) -> None:
        raise NotImplementedError

    def _expire(self, p: _Pending, now: float) -> None:
        self.metrics.requests_expired.inc()
        _settle(p, exc=DeadlineExceededError(
            f"deadline exceeded while queued "
            f"({(now - p.t_enqueue) * 1e3:.0f}ms)"))


class MicroBatcher(_BatcherBase):
    """Coalesce, pad to the ladder, decode to completion."""

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for the first request, then coalesce until the batch is
        full or ``max_wait_ms`` has passed since it arrived; while
        draining, dispatch at once and exit when the queue is empty."""
        with self._cond:
            while not self._q and not self._stop:
                self._cond.wait(timeout=0.1)
            if self._stop and (not self._q or not self._drain):
                return None
            if not self._stop:
                deadline = self._q[0].t_enqueue + self.max_wait_s
                while len(self._q) < self.max_batch and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            batch = []
            while self._q and len(batch) < self.max_batch:
                batch.append(self._q.popleft())
            return batch

    def _dispatch(self, batch: List[_Pending]) -> None:
        now = time.monotonic()
        live = []
        for p in batch:
            if now > p.deadline:
                self._expire(p, now)
            else:
                live.append(p)
                self.metrics.observe_stage("queue", (now - p.t_enqueue) * 1e3)
        if not live:
            return
        try:
            results = self.engine.decode_prepared([p.prepared for p in live])
        except Exception as e:  # noqa: BLE001 — engine failure maps to 500s
            _log.exception("batch decode failed")
            for p in live:
                if _settle(p, exc=e):
                    self.metrics.requests_failed.inc()
            return
        n = len(live)
        self.metrics.batches_total.inc()
        self.metrics.batch_rows_total.inc(n)
        self.metrics.batch_pad_rows_total.inc(self.engine.bucket(n) - n)
        t = results[0].timings_ms
        for stage in ("pad", "device", "detok"):
            self.metrics.observe_stage(stage, t[f"{stage}_ms"])
        for p, res in zip(live, results):
            if _settle(p, {
                "caption": res.caption,
                "tokens": res.tokens,
                "cached": False,
                "timings_ms": dict(res.timings_ms,
                                   queue_ms=(now - p.t_enqueue) * 1e3,
                                   batch_size=n),
            }):
                self.metrics.requests_served.inc()


class ContinuousBatcher(_BatcherBase):
    """Continuous in-flight batching: the queue feeds the engine's slot
    loop (reference ``ContinuousBatcher``).  Each iteration lets the
    slot bank follow the queue, admits pending requests into free
    slots, runs one tick of ``slot_block_steps`` decode steps over all
    slots and resolves every caption that finished."""

    _thread_name = "caption-slots"

    def _loop(self) -> None:
        decoder = self.engine.slot_decoder()
        self.metrics.slots_total.set(decoder.S)
        self.metrics.slot_bank_size.set(decoder.S)
        drain_deadline: Optional[float] = None
        while True:
            admits: List[_Pending] = []
            with self._cond:
                while not self._q and not decoder.occupied and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    if not self._drain:
                        break
                    if not self._q and not decoder.occupied:
                        return
                    if drain_deadline is None:
                        drain_deadline = time.monotonic() + self.drain_timeout_s
                # Elastic banks follow the queue at the tick boundary (a
                # no-op with one fixed bank).
                before = decoder.resize_count
                decoder.maybe_resize(len(self._q))
                if decoder.resize_count != before:
                    self.metrics.slot_bank_resizes.inc(
                        decoder.resize_count - before)
                    self.metrics.slots_total.set(decoder.S)
                    self.metrics.slot_bank_size.set(decoder.S)
                cap = min(len(decoder.free), decoder.admit_cap)
                while self._q and len(admits) < cap:
                    p = self._q.popleft()
                    if not p.future.done():
                        admits.append(p)
            if drain_deadline is not None and time.monotonic() > drain_deadline:
                self._abandon(decoder, admits, "drain deadline exceeded")
                return
            now = time.monotonic()
            live = []
            for p in admits:
                if now > p.deadline:
                    self._expire(p, now)
                else:
                    live.append(p)
            try:
                done = decoder.tick([p.prepared for p in live], live)
            except AdmissionError as e:
                # The encode failed on a bad row before any slot was
                # claimed: fail those submitters and keep serving.
                _log.exception("slot admission failed")
                for p in live:
                    if _settle(p, exc=e):
                        self.metrics.requests_failed.inc()
                continue
            except Exception:
                # After the claim (the admit or a decode step): the slot
                # state is unknown, so fail everything in flight: fatal.
                _log.exception("slot tick failed")
                self._abandon(decoder, live, "scheduler step failed")
                raise
            t_admit = time.monotonic()
            for p in live:
                p.t_admit = t_admit
                self.metrics.observe_stage(
                    "admission", (t_admit - p.t_enqueue) * 1e3)
            if live:
                self.metrics.slots_admitted_total.inc(len(live))
            if decoder.occupied or live:
                self.metrics.slot_steps_total.inc(decoder.block)
            self.metrics.slots_occupied.set(decoder.n_occupied)
            if done:
                self._resolve(decoder.harvest_many(done))
                self.metrics.slots_occupied.set(decoder.n_occupied)
            self.metrics.decode_state_bytes.set(decoder.live_state_bytes())
        # Hard stop (drain=False): fail whatever is in flight; stop()
        # fails what is still queued.
        self._abandon(decoder, [], "batcher stopped")

    def _resolve(self, harvested) -> None:
        """Detokenize, cache and resolve one harvest batch."""
        t0 = time.monotonic()
        for p, tokens, score, steps in harvested:
            if p.future.done():
                continue
            self.metrics.steps_per_caption.observe(steps)
            self.metrics.observe_stage("device", (t0 - p.t_admit) * 1e3)
            td0 = time.monotonic()
            try:
                res = self.engine.result_from_tokens(
                    p.prepared, tokens,
                    {"admission_ms": (p.t_admit - p.t_enqueue) * 1e3,
                     "device_ms": (t0 - p.t_admit) * 1e3})
            except Exception as e:  # noqa: BLE001
                if _settle(p, exc=e):
                    self.metrics.requests_failed.inc()
                continue
            t1 = time.monotonic()
            self.metrics.observe_stage("detok", (t1 - td0) * 1e3)
            if _settle(p, {
                "caption": res.caption,
                "tokens": res.tokens,
                "cached": False,
                "score": score,
                "timings_ms": dict(res.timings_ms,
                                   detok_ms=(t1 - td0) * 1e3,
                                   decode_steps=steps),
            }):
                self.metrics.requests_served.inc()

    def _abandon(self, decoder, admits: List[_Pending], why: str) -> None:
        for p in admits:
            if _settle(p, exc=RuntimeError(why)):
                self.metrics.requests_failed.inc()
        for slot in list(decoder.occupied):
            p = decoder.evict(slot)
            if p is not None and _settle(p, exc=RuntimeError(why)):
                self.metrics.requests_failed.inc()
        self.metrics.slots_occupied.set(0)
