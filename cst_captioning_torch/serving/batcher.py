"""Request scheduling over the inference engine: one bounded admission
queue, two dispatch disciplines (port of the JAX package's
``serving/batcher.py``; the multi-replica scheduler that rides on the
same machinery is ``serving/replicas.py``).

Requests from any number of front-end threads enter a BOUNDED queue
(``submit`` blocks the caller until its caption resolves).  One
scheduler thread drains it under one of two disciplines:

* :class:`MicroBatcher` (``serving.continuous = false``): coalesce up to
  ``max_batch_size`` requests for at most ``max_wait_ms`` after the
  first arrival, pad to the engine's ladder, decode the batch to
  completion.
* :class:`ContinuousBatcher` (``serving.continuous = true`` with
  ``serving.replicas = 1``): the queue feeds the engine's persistent
  slot loop (``serving/slots.py``); each iteration admits pending
  requests into free slots, grows or shrinks the slot bank, ticks
  ``slot_block_steps`` decode steps over all slots, and resolves every
  caption that finished, so nothing waits for a batch boundary.

Shared semantics:

* **Priorities and shedding**: every request carries a ``priority``
  (``interactive`` > ``batch`` > ``best_effort``; default
  ``interactive``; any other value is a ``ValueError``, HTTP 400).  When
  the queue is full, an arrival evicts the oldest queued request of the
  lowest class strictly below its own instead of being refused: the
  victim's submitter gets :class:`BackpressureError` (429), counted on
  ``caption_shed_total{priority}``, with a ``shed`` flight event and a
  zero-length ``shed`` span on its trace.  Within one class nothing
  accepted is dropped.
* **Deadlines**: a request whose deadline passes while queued is shed
  with :class:`DeadlineExceededError` before it costs device work.
* **Retry hints**: 429s and draining 503s carry a ``Retry-After`` scaled
  by the live queue depth plus a deterministic per-request crc32 jitter
  (:meth:`_BatcherBase._retry_after_value`), never a constant, so
  clients that were refused together do not come back together.
* **Settlement**: a future settles exactly once (``_settle_result`` /
  ``_settle_exception``); a hedged request's losing copy reports False.
* **Drain**: ``stop`` closes admissions (new submits raise
  :class:`ShuttingDownError`, HTTP 503) and serves queued and in-flight
  work within ``drain_timeout_s``; the flight ring records the drain.
* **Tracing**: the scheduler parents each request's ``queue``, ``admit``,
  ``decode`` and ``detok`` spans (``batch_decode`` on the ladder) under
  the HTTP root span (``observability/trace.py``), and its flight
  recorder keeps the last ticks and lifecycle events.

Tier-1 cache hits return from ``submit`` without touching the queue.

Fault injection (``serving.chaos``, ``serving/chaos.py``): with a
schedule configured, the :class:`~cst_captioning_torch.serving.chaos.
ChaosEngine` is asked at the sites ``cache_miss`` and ``deadline_skew``
on the submit path and ``queue_burst`` and ``tick_stall`` in the
:class:`ContinuousBatcher` loop; each fired fault counts on
``caption_chaos_faults_total`` and records a ``chaos_fault`` flight
event.  Every site is guarded by ``self.chaos is not None``: with the
default empty dict no engine is built and the path is the chaos-free
one.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Deque, Dict, List, Optional, Union

from cst_captioning_torch.observability.flight import flight_recorder
from cst_captioning_torch.observability.trace import service_tracer
from cst_captioning_torch.serving.chaos import ChaosEngine
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.metrics import PRIORITIES, ServingMetrics
from cst_captioning_torch.serving.slots import AdmissionError

_log = logging.getLogger("cst_captioning_torch.serving")

# Priority rank: higher is more valuable and is shed last.  The
# vocabulary is closed (metric label values): an unknown class is a 400.
PRIORITY_RANK = {p: r for r, p in enumerate(reversed(PRIORITIES))}


def _settle_result(pending: "_Pending", result: Dict[str, Any]) -> bool:
    """Resolve a future exactly once (a hedged request races two workers
    onto one future: the first result wins, the loser reports False)."""
    try:
        pending.future.set_result(result)
        return True
    except InvalidStateError:
        return False


def _settle_exception(pending: "_Pending", exc: BaseException) -> bool:
    try:
        pending.future.set_exception(exc)
        return True
    except InvalidStateError:
        return False


class BackpressureError(Exception):
    """Bounded queue is full — retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"request queue full; retry after {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class DeadlineExceededError(Exception):
    """The request's deadline passed before a result was produced."""


class ShuttingDownError(Exception):
    """The server is draining — no new requests are admitted (503).
    Carries an optional queue-depth-derived ``retry_after_s``."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _Pending:
    """One accepted request.  It belongs to one scheduler thread at a
    time, handed between queues only under the scheduler's ``_cond``
    (hedge copies, requeues, shed eviction); a hedged request may be
    decoded by two workers at once, whose only shared writes are the
    future (first result wins) and the timing field ``t_admit``."""

    __slots__ = ("prepared", "future", "t_enqueue", "t_admit", "deadline",
                 "trace", "priority", "rid", "requeues", "hedged")

    def __init__(self, prepared, deadline: float, trace=None,
                 priority: str = "interactive"):
        self.prepared = prepared
        self.future: "Future[Dict[str, Any]]" = Future()
        self.t_enqueue = time.monotonic()
        self.t_admit = self.t_enqueue
        self.deadline = deadline
        # (trace_id, root_span_id) of the HTTP root span, or None: the
        # scheduler parents this request's spans under it.
        self.trace = trace
        self.priority = priority
        self.rid = -1        # primary replica (ReplicaSet routing)
        self.requeues = 0    # times requeued after a replica drain
        self.hedged = False  # a duplicate copy was dispatched


class _BatcherBase:
    """The bounded queue, ``submit``, shedding, retry hints, lifecycle
    and drain shared by every discipline; a subclass supplies the
    scheduler loop ``_loop``."""

    _thread_name = "caption-scheduler"

    def __init__(self, engine: InferenceEngine,
                 metrics: Optional[ServingMetrics] = None, *,
                 queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 retry_after_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None):
        sv = engine.cfg.serving
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        self.queue_depth = int(queue_depth or sv.queue_depth)
        self.default_deadline_s = (sv.default_deadline_ms
                                   if default_deadline_ms is None
                                   else default_deadline_ms) / 1e3
        self.retry_after_s = float(sv.retry_after_s if retry_after_s is None
                                   else retry_after_s)
        self.drain_timeout_s = (sv.drain_timeout_s if drain_timeout_s is None
                                else drain_timeout_s)
        self._q: Deque[_Pending] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._drain = True          # serve remaining work on stop
        self._draining = False      # admissions closed
        self._drain_evented = False  # drain_start recorded once
        self._thread: Optional[threading.Thread] = None
        self.tracer = service_tracer(sv)
        self.flight = flight_recorder(sv, "scheduler", self.tracer)
        # Fault injection: None unless serving.chaos is configured; every
        # site is guarded on it, so chaos off is the chaos-free path.
        self.chaos = ChaosEngine.from_config(sv)
        # Jitter key of requests without a content hash (under _cond).
        self._retry_seq = 0

    def flight_snapshot(self) -> Dict[str, Any]:
        """Live ``/debug/flight`` view: recorder name -> ring."""
        return {self.flight.name: self.flight.snapshot()}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "_BatcherBase":
        if self._thread is None:
            self._stop = self._draining = self._drain_evented = False
            self._thread = threading.Thread(
                target=self._run, name=self._thread_name, daemon=True)
            self._thread.start()
        return self

    def _running(self) -> bool:
        return self._thread is not None

    def begin_drain(self) -> None:
        """Close admissions (new submits -> 503) without blocking; queued
        and in-flight work keeps being served."""
        with self._cond:
            self._draining = True
            evented, self._drain_evented = self._drain_evented, True
            queued = len(self._q)
            self._cond.notify_all()
        if not evented:
            self.flight.event("drain_start", queued=queued)

    @property
    def draining(self) -> bool:
        return self._draining

    def stop(self, drain: bool = True) -> None:
        """Shut down; ``drain=True`` serves queued work first (bounded by
        ``drain_timeout_s``), ``drain=False`` fails it."""
        with self._cond:
            self._draining = True
            self._drain = drain
            self._stop = True
            t = self._thread
            evented, self._drain_evented = self._drain_evented, True
            queued = len(self._q)
            self._cond.notify_all()
        if not evented:
            self.flight.event("drain_start", queued=queued, drain=drain)
        # Join outside the lock: the scheduler needs _cond to exit.
        if t is not None:
            t.join(timeout=self.drain_timeout_s + 60.0)
        with self._cond:
            self._thread = None
            while self._q:
                _settle_exception(self._q.popleft(),
                                  RuntimeError("batcher stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth_locked()

    # ------------------------------------------------- retry hints / shed
    def _depth_locked(self) -> int:
        return len(self._q)

    def _jitter_key(self, pending: Optional[_Pending]) -> str:
        """Deterministic per-request jitter key: the content hash when
        the request has one, else a reject sequence (under ``_cond``)."""
        key = (getattr(getattr(pending, "prepared", None), "cache_key", "")
               if pending is not None else "")
        if not key:
            self._retry_seq += 1
            key = f"seq{self._retry_seq}"
        return key

    def _retry_after_value(self, depth: int, key: Optional[str]) -> float:
        """The retry hint: ``retry_after_s`` scaled by how full the queue
        is (0.25 + depth / queue_depth, the fill capped at 2), plus a
        deterministic jitter of up to half of it from the key's crc32."""
        base = self.retry_after_s
        frac = min(depth / float(max(1, self.queue_depth)), 2.0)
        val = base * (0.25 + frac)
        if key:
            val += base * 0.5 * (
                (zlib.crc32(str(key).encode("utf-8", "ignore")) % 1024)
                / 1024.0)
        return round(val, 4)

    def retry_after(self, key: Optional[str] = None) -> float:
        """Retry hint for the HTTP layer's 503 paths."""
        with self._cond:
            depth = self._depth_locked()
            if key is None:
                key = self._jitter_key(None)
        return self._retry_after_value(depth, key)

    def _shed_one(self, victim: _Pending, depth: int, flight=None,
                  reason: str = "priority_evict") -> None:
        """Fail one shed victim: 429 with its retry hint, the shed
        counter of its class, a flight event and a zero-length span."""
        self.metrics.shed(victim.priority).inc()
        (flight or self.flight).event("shed", priority=victim.priority,
                                      reason=reason)
        if victim.trace is not None:
            t = time.monotonic()
            self.tracer.record(
                "shed", t, t, trace_id=victim.trace[0],
                parent_id=victim.trace[1],
                tags={"priority": victim.priority, "reason": reason})
        _settle_exception(victim, BackpressureError(
            self._retry_after_value(depth, self._jitter_key(victim))))

    @staticmethod
    def _lowest_below(candidates, rank: int):
        """The oldest of the lowest-priority live entries ranked strictly
        below ``rank``: ``candidates`` yields (pending, owner) in queue
        order; returns (pending, owner) or (None, None)."""
        victim = owner = None
        for p, o in candidates:
            if p.future.done():
                continue
            r = PRIORITY_RANK[p.priority]
            if r < rank and (victim is None
                             or r < PRIORITY_RANK[victim.priority]):
                victim, owner = p, o
        return victim, owner

    def _shed_lower_priority(self, incoming: _Pending) -> bool:
        """Queue-full overload (under ``_cond``): evict the oldest queued
        request of the lowest class below ``incoming``'s.  False when
        nothing below it is queued: the arrival itself is refused."""
        victim, _ = self._lowest_below(((p, None) for p in self._q),
                                       PRIORITY_RANK[incoming.priority])
        if victim is None:
            return False
        self._q.remove(victim)
        self._shed_one(victim, len(self._q))
        return True

    def _enqueue(self, pending: _Pending) -> None:
        """Admit one request into the bounded queue (under ``_cond``):
        under overload shed a lower class in its favour, else raise
        :class:`BackpressureError`."""
        if (len(self._q) >= self.queue_depth
                and not self._shed_lower_priority(pending)):
            self.metrics.requests_rejected.inc()
            raise BackpressureError(self._retry_after_value(
                len(self._q), self._jitter_key(pending)))
        self._q.append(pending)

    # -------------------------------------------------------------- submit
    def submit_async(self, payload: Dict[str, Any],
                     deadline_ms: Optional[float] = None, trace=None,
                     priority: Optional[str] = None
                     ) -> Union[Dict[str, Any], _Pending]:
        """The non-blocking half of :meth:`submit`: validate, prepare,
        probe tier 1, enqueue.  Returns the result dict on a cache hit,
        else the enqueued :class:`_Pending`."""
        if self._draining:
            raise ShuttingDownError("server is draining",
                                    retry_after_s=self.retry_after())
        prio = str(priority if priority is not None
                   else payload.get("priority", "interactive"))
        if prio not in PRIORITY_RANK:
            raise ValueError(f"unknown priority {prio!r}; have {PRIORITIES}")
        trace_id = trace[0] if trace else None
        t_submit = time.monotonic()
        prepared = self.engine.prepare(payload)
        # Chaos site `cache_miss`: a cache-hostile key storm; this request
        # misses both tiers and pays the full decode (same tokens).
        forced_miss = bool(self.chaos is not None
                           and self.chaos.fire("cache_miss"))
        if forced_miss:
            self.metrics.chaos_faults.inc()
            self.flight.event("chaos_fault", site="cache_miss")
            if prepared.enc_row is not None:
                prepared = prepared._replace(enc_row=None)
        hit = (self.engine.lookup_caption(prepared.cache_key)
               if prepared.cache_key and not forced_miss else None)
        if hit is not None:
            self.metrics.requests_total.inc()
            self.metrics.requests_served.inc()
            total_ms = (time.monotonic() - t_submit) * 1e3
            self.metrics.observe_stage("total", total_ms, exemplar=trace_id)
            return {"caption": hit["caption"], "tokens": hit["tokens"],
                    "cached": True, "timings_ms": {"total_ms": total_ms}}
        deadline_s = (deadline_ms / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        # Chaos site `deadline_skew`: a deadline-adjacent arrival, its
        # budget clamped to the scheduled seconds (the expiry path).
        if self.chaos is not None:
            skew = self.chaos.fire("deadline_skew")
            if skew is not False and skew is not None:
                self.metrics.chaos_faults.inc()
                self.flight.event("chaos_fault", site="deadline_skew",
                                  skew_s=float(skew))
                deadline_s = min(deadline_s, float(skew))
        pending = _Pending(prepared, t_submit + deadline_s, trace=trace,
                           priority=prio)
        with self._cond:
            if self._draining:
                raise ShuttingDownError(
                    "server is draining",
                    retry_after_s=self._retry_after_value(
                        self._depth_locked(), self._jitter_key(pending)))
            self._enqueue(pending)
            self.metrics.requests_total.inc()
            self._cond.notify_all()
        return pending

    def _await(self, pending: _Pending, deadline_s: float) -> Dict[str, Any]:
        """Block the submitter until its future resolves; the scheduler
        enforces the deadline, the slack only matters if it died.
        ``ReplicaSet`` overrides this with the hedged wait."""
        return pending.future.result(timeout=deadline_s + 60.0)

    def submit(self, payload: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               trace=None) -> Dict[str, Any]:
        """Blocking entry point: ``{"caption", "tokens", "cached",
        "timings_ms"}``.  ``trace`` is the front end's ``(trace_id,
        root_span_id)``; ``payload`` may carry ``priority``.  Raises
        ``ValueError`` (bad input), :class:`BackpressureError`,
        :class:`DeadlineExceededError` or :class:`ShuttingDownError`."""
        if not self._running():
            raise RuntimeError(f"{type(self).__name__} not started")
        trace_id = trace[0] if trace else None
        out = self.submit_async(payload, deadline_ms=deadline_ms, trace=trace)
        if isinstance(out, dict):
            return out
        try:
            return self._await(out, out.deadline - out.t_enqueue)
        finally:
            self.metrics.observe_stage(
                "total", (time.monotonic() - out.t_enqueue) * 1e3,
                exemplar=trace_id)

    # ----------------------------------------------------------- scheduler
    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 — scheduler death is fatal
            _log.exception("scheduler thread died")
            self.flight.event("worker_death", error=f"{type(e).__name__}: {e}")
            self.flight.dump("worker_death")
            with self._cond:
                self._draining = True
                while self._q:
                    if _settle_exception(self._q.popleft(), RuntimeError(
                            "scheduler thread died")):
                        self.metrics.requests_failed.inc()

    def _loop(self) -> None:
        raise NotImplementedError

    def _record_request_spans(self, live, t_tick: float, t_admit: float,
                              tags=None) -> None:
        """Per-request ``queue`` / ``admit`` spans of one admission tick,
        each under its request's root span."""
        for p in live:
            if p.trace is None:
                continue
            tid, root = p.trace
            self.tracer.record("queue", p.t_enqueue, t_tick, trace_id=tid,
                               parent_id=root, tags=tags)
            self.tracer.record("admit", t_tick, t_admit, trace_id=tid,
                               parent_id=root, tags=tags)

    def _expire(self, p: _Pending, now: float, flight=None) -> None:
        """Deadline shed: fail an expired request before it costs device
        work, counted as expired and shed, with a ``shed`` flight event."""
        self.metrics.requests_expired.inc()
        self.metrics.shed(p.priority).inc()
        (flight or self.flight).event("shed", priority=p.priority,
                                      reason="deadline", requeues=p.requeues)
        if p.trace is not None:
            t = time.monotonic()
            self.tracer.record(
                "shed", t, t, trace_id=p.trace[0], parent_id=p.trace[1],
                tags={"priority": p.priority, "reason": "deadline"})
        _settle_exception(p, DeadlineExceededError(
            f"deadline exceeded while queued "
            f"({(now - p.t_enqueue) * 1e3:.0f}ms)"))

    def _resolve_one(self, p: _Pending, engine, tokens, score, steps,
                     t0: float, tags=None) -> bool:
        """Detokenize, cache and settle one harvested caption (harvest
        time ``t0``).  Returns True if this copy settled the future,
        False if another copy had (a hedge loser), None if the
        detokenize failed (the request fails)."""
        self.metrics.steps_per_caption.observe(steps)
        self.metrics.observe_stage("device", (t0 - p.t_admit) * 1e3)
        if p.trace is not None:
            self.tracer.record("decode", p.t_admit, t0, trace_id=p.trace[0],
                               parent_id=p.trace[1],
                               tags=dict(tags or (), steps=steps))
        td0 = time.monotonic()
        try:
            res = engine.result_from_tokens(
                p.prepared, tokens,
                {"admission_ms": (p.t_admit - p.t_enqueue) * 1e3,
                 "device_ms": (t0 - p.t_admit) * 1e3})
        except Exception as e:  # noqa: BLE001
            if _settle_exception(p, e):
                self.metrics.requests_failed.inc()
            return None
        t1 = time.monotonic()
        if p.trace is not None:
            self.tracer.record("detok", td0, t1, trace_id=p.trace[0],
                               parent_id=p.trace[1], tags=tags)
        self.metrics.observe_stage("detok", (t1 - td0) * 1e3)
        out = {"caption": res.caption, "tokens": res.tokens, "cached": False,
               "score": score,
               "timings_ms": dict(res.timings_ms, detok_ms=(t1 - td0) * 1e3,
                                  decode_steps=steps)}
        if tags and "replica" in tags:
            out["replica"] = tags["replica"]
        if _settle_result(p, out):
            self.metrics.requests_served.inc()
            return True
        return False


class MicroBatcher(_BatcherBase):
    """Coalesce, pad to the ladder, decode to completion."""

    _thread_name = "caption-batcher"

    def __init__(self, engine: InferenceEngine,
                 metrics: Optional[ServingMetrics] = None, *,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None, **kw):
        super().__init__(engine, metrics, **kw)
        self.max_batch = int(max_batch_size or engine.max_batch)
        self.max_wait_s = (engine.cfg.serving.max_wait_ms
                           if max_wait_ms is None else max_wait_ms) / 1e3

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
        for p in live:
            if p.trace is not None:
                self.tracer.record("queue", p.t_enqueue, now,
                                   trace_id=p.trace[0], parent_id=p.trace[1])
        t_d0 = time.monotonic()
        try:
            results = self.engine.decode_prepared([p.prepared for p in live])
        except Exception as e:  # noqa: BLE001 — engine failure maps to 500s
            _log.exception("batch decode failed")
            for p in live:
                if _settle_exception(p, e):
                    self.metrics.requests_failed.inc()
            return
        self.tracer.record("batch_decode", t_d0, time.monotonic(),
                           tags={"batch": len(live)})
        n = len(live)
        self.metrics.batches_total.inc()
        self.metrics.batch_rows_total.inc(n)
        self.metrics.batch_pad_rows_total.inc(self.engine.bucket(n) - n)
        t = results[0].timings_ms
        for stage in ("pad", "device", "detok"):
            self.metrics.observe_stage(stage, t[f"{stage}_ms"])
        for p, res in zip(live, results):
            if _settle_result(p, {
                "caption": res.caption,
                "tokens": res.tokens,
                "cached": False,
                "timings_ms": dict(res.timings_ms,
                                   queue_ms=(now - p.t_enqueue) * 1e3,
                                   batch_size=n),
            }):
                self.metrics.requests_served.inc()


class ContinuousBatcher(_BatcherBase):
    """Continuous in-flight batching on one engine: the queue feeds the
    engine's slot loop (reference ``ContinuousBatcher``).  Each
    iteration lets the slot bank follow the queue, admits pending
    requests into free slots, runs one synchronous tick of
    ``slot_block_steps`` decode steps over all slots and resolves every
    caption that finished."""

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
                        self.flight.event("drain_exit", served_all=True)
                        self.flight.dump("drain")
                        return
                    if drain_deadline is None:
                        drain_deadline = time.monotonic() + self.drain_timeout_s
                # Elastic banks follow the queue at the tick boundary (a
                # no-op with one fixed bank).  Chaos site `queue_burst`
                # inflates the pressure signal (a burst at a grow
                # boundary).
                burst = 0
                if self.chaos is not None:
                    b = self.chaos.fire("queue_burst")
                    if b:
                        burst = int(b)
                        self.metrics.chaos_faults.inc()
                        self.flight.event("chaos_fault", site="queue_burst",
                                          burst=burst)
                before = decoder.resize_count
                decoder.maybe_resize(len(self._q) + burst)
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
                self.flight.event("watchdog", queued=len(admits),
                                  occupied=decoder.n_occupied)
                self.flight.dump("watchdog")
                self._abandon(decoder, admits, "drain deadline exceeded")
                self.flight.event("drain_exit", served_all=False)
                return
            now = time.monotonic()
            live = []
            for p in admits:
                if now > p.deadline:
                    self._expire(p, now)
                else:
                    live.append(p)
            # Chaos site `tick_stall`: a slow device step; the scheduler
            # sleeps the scheduled seconds before dispatching.
            if self.chaos is not None:
                stall = self.chaos.fire("tick_stall")
                if stall:
                    self.metrics.chaos_faults.inc()
                    self.flight.event("chaos_fault", site="tick_stall",
                                      stall_s=float(stall))
                    time.sleep(float(stall))
            t_tick = time.monotonic()
            try:
                done = decoder.tick([p.prepared for p in live], live)
            except AdmissionError as e:
                # The encode failed on a bad row before any slot was
                # claimed: fail those submitters and keep serving.
                _log.exception("slot admission failed")
                for p in live:
                    if _settle_exception(p, e):
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
            self._record_request_spans(live, t_tick, t_admit)
            if live:
                self.metrics.slots_admitted_total.inc(len(live))
            if decoder.occupied or live:
                self.metrics.slot_steps_total.inc(decoder.block)
                self.flight.event("tick", admits=len(live), done=len(done),
                                  occupied=decoder.n_occupied)
            self.metrics.slots_occupied.set(decoder.n_occupied)
            if done:
                t0 = time.monotonic()
                for p, tokens, score, steps in decoder.harvest_many(done):
                    if not p.future.done():
                        self._resolve_one(p, self.engine, tokens, score,
                                          steps, t0)
                self.metrics.slots_occupied.set(decoder.n_occupied)
            self.metrics.decode_state_bytes.set(decoder.live_state_bytes())
        # Hard stop (drain=False): fail whatever is in flight; stop()
        # fails what is still queued.
        self._abandon(decoder, [], "batcher stopped")

    def _abandon(self, decoder, admits: List[_Pending], why: str) -> None:
        for p in admits:
            if _settle_exception(p, RuntimeError(why)):
                self.metrics.requests_failed.inc()
        for slot in list(decoder.occupied):
            p = decoder.evict(slot)
            if p is not None and _settle_exception(p, RuntimeError(why)):
                self.metrics.requests_failed.inc()
        self.metrics.slots_occupied.set(0)
