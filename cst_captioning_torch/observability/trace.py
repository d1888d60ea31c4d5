"""Stdlib-only span tracer: one request's (or one train step's) journey
as a tree of timed spans, exportable as Chrome-trace-event JSON (port of
the JAX package's ``observability/trace.py``; the port keeps its own
copy, since it imports nothing of that package).

The serving metrics (``serving/metrics.py``) answer "how is the fleet
doing in aggregate"; this module answers "where did THIS request's 40 ms
go" (queue wait, admission encode, slot residency, detokenize) and
"where did THIS CST step's second go", in one format, so a served
request and a train step render side by side in Perfetto (load the
exported JSON).

* **Monotonic clocks only.**  Span times come from ``time.monotonic()``,
  never the wall clock: all emitters share one monotonic base, so
  cross-thread spans line up and no span runs backwards.
* **Every span name is registered.**  :data:`SPAN_CATALOGUE` and
  :data:`EVENT_CATALOGUE` are the single source of truth; emitting an
  unregistered name raises.  The catalogues equal the reference's but
  for the ``profile`` entry, which names ``torch.profiler``.
* **Host-side only.**  Spans time host calls; the serving loops record
  around their dispatch / wait / harvest calls, and the double-buffer
  handles (``serving/slots.py``) make the host-vs-device split honest.
* **Bounded.**  Finished spans land in per-thread ring buffers
  (``deque(maxlen=...)``): a tracer that is never exported costs O(1)
  memory, and one span costs two monotonic reads and one deque append
  (no lock on the emit path; the registry lock is taken once per
  thread, at its first emission).

Thread-safety: emission is lock-free per thread (each thread owns its
buffer); ``export`` / ``clear`` take the registry lock and snapshot every
thread's buffer.  Span and trace ids are a process-unique prefix
(``os.urandom``) plus a counter: no wall clock, no collisions across
replicas' dumps.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from fnmatch import fnmatchcase
from typing import Any, Dict, Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------
# The span-name registry.  Every name emitted anywhere in the package
# must match a family here (``*`` stands for a computed segment) and
# carry the component that emits it; ``Tracer`` refuses unregistered
# names at runtime, so a typo cannot ship silently.
SPAN_CATALOGUE: List[Tuple[str, str, str]] = [
    # (pattern, component, help)
    ("request", "serving",
     "root span of one /v1/caption request: submit -> response; its "
     "trace_id is echoed in the X-Trace-Id header and stamped as the "
     "exemplar on the total-latency histogram"),
    ("queue", "serving",
     "enqueue -> start of the admission tick that scattered the request "
     "into a decode slot (scheduler wait)"),
    ("admit", "serving",
     "admission tick start -> scatter complete (encode + slot claim)"),
    ("decode", "serving",
     "decode-slot residency: admission -> harvest fetch (device steps "
     "plus any frozen double-buffer ride)"),
    ("detok", "serving",
     "tokens -> text + tier-1 cache store for one harvested caption"),
    ("batch_decode", "serving",
     "MicroBatcher run-to-completion engine call for one coalesced "
     "batch (ladder fallback path)"),
    ("tick_dispatch", "serving",
     "host side of one slot-loop tick: admission encode + step-block "
     "dispatch; returns before device work completes"),
    ("tick_wait", "serving",
     "blocking wait on a dispatched tick's done flags — the exposed "
     "device-time residual after host/device overlap"),
    ("harvest", "serving",
     "host fetch + unpack of finished slots from one tick handle"),
    ("profile", "serving",
     "/debug/profile torch.profiler window (start -> stop)"),
    ("cst/step", "training",
     "one host-driven CST train step (PhaseClock start -> commit)"),
    ("phase/*", "training",
     "one PhaseClock lap interval inside a CST step (dispatch, "
     "sample_fetch, score, greedy_fetch, score_wait, update)"),
]

# Flight-recorder event names share the registry (an event is a
# zero-duration span in the timeline sense).
EVENT_CATALOGUE: List[Tuple[str, str, str]] = [
    ("tick", "flight",
     "one scheduler tick: admits/done/occupied counts + tick seq"),
    ("kill", "flight",
     "kill_replica was invoked on this replica"),
    ("worker_death", "flight",
     "the scheduler/worker thread died (exception recorded)"),
    ("drain_start", "flight",
     "graceful shutdown began: admissions closed, drain running"),
    ("drain_requeue", "flight",
     "requests moved off a dying replica onto survivors (counts)"),
    ("drain_exit", "flight",
     "the worker exited its loop (drain complete or hard stop)"),
    ("watchdog", "flight",
     "the drain/watchdog deadline expired with work still in flight"),
    ("dump", "flight",
     "a flight dump was written to disk (path + reason)"),
    ("shed", "flight",
     "a request was load-shed (priority eviction under overload, "
     "deadline expiry, or requeue-budget overflow); also recorded as a "
     "zero-length span on the request's trace when it carries one"),
    ("hedge", "flight",
     "a hedged duplicate of a slow request was dispatched onto a second "
     "healthy replica (first result wins, loser cancelled)"),
    ("chaos_fault", "flight",
     "a ChaosEngine injection fired at a registered FAULT_SITES site "
     "(serving/chaos.py; site + parameters in the tags)"),
    ("autoscale", "flight",
     "an elastic-autoscaler decision was applied (serving/autoscaler.py:"
     " action, reason, and the before/after replica counts in the tags;"
     " scale-downs additionally leave the PR-4 kill/drain events on the"
     " drained replica's own ring)"),
]

_ALL_PATTERNS = [p for p, _, _ in SPAN_CATALOGUE + EVENT_CATALOGUE]
_EXACT_NAMES = {p for p in _ALL_PATTERNS if "*" not in p}
_WILDCARDS = [p for p in _ALL_PATTERNS if "*" in p]

# Process-unique ID space: 4 random bytes at import + an atomic counter.
# No wall clock, and no collisions when several replicas' dumps are
# merged into one timeline.
_RUN_TAG = os.urandom(4).hex()
_IDS = itertools.count(1)


def registered(name: str) -> bool:
    """Whether ``name`` matches a catalogue family (exact or wildcard)."""
    if name in _EXACT_NAMES:
        return True
    return any(fnmatchcase(name, p) for p in _WILDCARDS)


def new_trace_id() -> str:
    return f"t{_RUN_TAG}-{next(_IDS):x}"


def new_span_id() -> str:
    return f"s{_RUN_TAG}-{next(_IDS):x}"


class _ThreadBuf:
    """One thread's bounded ring of finished spans (owned by that
    thread; export snapshots it under the tracer registry lock — deque
    append/iteration are each atomic under the GIL, and export tolerates
    the one-span race a concurrent append could cause)."""

    def __init__(self, name: str, maxlen: int, thread=None):
        self.name = name
        self.thread = thread
        self.spans: deque = deque(maxlen=maxlen)


class _LiveSpan:
    """Context-manager handle from :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "tags", "_t0")

    def __init__(self, tracer, name, trace_id, parent_id, tags):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.tags = tags
        self._t0 = time.monotonic()

    def __enter__(self) -> "_LiveSpan":
        self._tracer._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._pop(self)
        self._tracer.record(
            self.name, self._t0, time.monotonic(),
            trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, tags=self.tags,
        )


class _NullSpan:
    """Zero-cost stand-in when the tracer is disabled."""

    name = trace_id = span_id = parent_id = None
    tags: Dict[str, Any] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder with per-thread bounded buffers.

    Two emission APIs:

    * :meth:`span` — a context manager for inline scopes (opens at
      ``__enter__``, records at ``__exit__``; nests per thread, so a
      child opened inside a parent's scope links automatically);
    * :meth:`record` — a completed interval from two already-measured
      ``time.monotonic()`` readings (the serving schedulers measure
      ``t_enqueue``/``t_admit`` anyway; re-measuring would lie).

    ``enabled=False`` turns every call into a cheap no-op.
    """

    def __init__(self, buffer_spans: int = 4096, enabled: bool = True):
        self.enabled = bool(enabled)
        self.buffer_spans = int(buffer_spans)
        self._lock = threading.Lock()
        self._bufs: List[_ThreadBuf] = []
        # Spans of DEAD threads, folded into one shared bounded ring at
        # the next registration: HTTP handler threads live for one
        # request, and their request roots must survive them — while a
        # long-lived server must not leak one buffer per request served.
        self._retired: deque = deque(maxlen=self.buffer_spans)
        self._local = threading.local()
        # Monotonic origin: exported timestamps are relative to tracer
        # creation so Perfetto numbers stay small and human-scaled.
        self._t0 = time.monotonic()

    # ----------------------------------------------------------- plumbing
    def _buf(self) -> _ThreadBuf:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            t = threading.current_thread()
            buf = _ThreadBuf(t.name, self.buffer_spans, thread=t)
            self._local.buf = buf
            with self._lock:
                keep = []
                for b in self._bufs:
                    if b.thread is not None and not b.thread.is_alive():
                        self._retired.extend(
                            (b.name, s) for s in b.spans
                        )
                    else:
                        keep.append(b)
                keep.append(buf)
                self._bufs = keep
        return buf

    def _stack(self) -> List[_LiveSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: "_LiveSpan") -> None:
        self._stack().append(span)

    def _pop(self, span: "_LiveSpan") -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def _check(self, name: str) -> None:
        if not registered(name):
            raise ValueError(
                f"span name {name!r} is not registered in "
                "observability/trace.py::SPAN_CATALOGUE — register it "
                "before emitting"
            )

    # ----------------------------------------------------------- emission
    def new_trace_id(self) -> str:
        return new_trace_id()

    def new_span_id(self) -> str:
        return new_span_id()

    def current_span(self) -> Optional[_LiveSpan]:
        st = self._stack()
        return st[-1] if st else None

    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        tags: Optional[Dict[str, Any]] = None,
    ):
        """Context manager: time the enclosed scope as one span.  With
        no explicit parent, nests under the thread's innermost open
        span (same trace)."""
        if not self.enabled:
            return _NULL_SPAN
        self._check(name)
        cur = self.current_span()
        if parent_id is None and cur is not None:
            parent_id = cur.span_id
            if trace_id is None:
                trace_id = cur.trace_id
        if trace_id is None:
            trace_id = new_trace_id()
        return _LiveSpan(self, name, trace_id, parent_id, dict(tags or ()))

    def record(
        self,
        name: str,
        t0_s: float,
        t1_s: float,
        trace_id: Optional[str] = None,
        span_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        tags: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Record a completed span from two ``time.monotonic()``
        readings.  Returns the span id (``None`` when disabled)."""
        if not self.enabled:
            return None
        self._check(name)
        sid = span_id or new_span_id()
        self._buf().spans.append((
            name,
            float(t0_s), float(t1_s),
            trace_id or new_trace_id(),
            sid,
            parent_id,
            dict(tags) if tags else None,
        ))
        return sid

    # ------------------------------------------------------------- export
    def _snapshot(self) -> List[Tuple[str, List[tuple]]]:
        with self._lock:
            live = [(b.name, list(b.spans)) for b in self._bufs]
            retired = list(self._retired)
        grouped: Dict[str, List[tuple]] = {}
        for tname, s in retired:
            grouped.setdefault(tname, []).append(s)
        return list(grouped.items()) + live

    def spans(self) -> Iterator[Dict[str, Any]]:
        """All buffered finished spans as dicts (unordered across
        threads; per-thread order is emission order)."""
        for tname, spans in self._snapshot():
            for name, t0, t1, trace_id, sid, parent, tags in spans:
                yield {
                    "name": name,
                    "t0_s": t0,
                    "t1_s": t1,
                    "trace_id": trace_id,
                    "span_id": sid,
                    "parent_id": parent,
                    "thread": tname,
                    "tags": tags or {},
                }

    def export_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace-event JSON (the ``traceEvents`` array format),
        loadable in Perfetto / ``chrome://tracing``.  One complete
        ("ph": "X") event per span; timestamps are microseconds relative
        to tracer creation on the shared monotonic base; one pid per
        process, one tid per emitting thread."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        tids: Dict[str, int] = {}
        for s in self.spans():
            tid = tids.setdefault(s["thread"], len(tids) + 1)
            args = {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
            }
            if s["parent_id"]:
                args["parent_id"] = s["parent_id"]
            args.update(s["tags"])
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": round((s["t0_s"] - self._t0) * 1e6, 3),
                "dur": round(max(s["t1_s"] - s["t0_s"], 0.0) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "cat": s["name"].split("/", 1)[0],
                "args": args,
            })
        for tname, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def export_json(self) -> str:
        return json.dumps(self.export_chrome_trace())

    def set_buffer_spans(self, n: int) -> None:
        """Re-bound the rings to ``n`` spans (the
        ``serving.trace_buffer_spans`` knob): the shared retired ring
        immediately (newest spans kept), per-thread rings for threads
        that register after the call — live threads own their deques,
        so resizing them in place would race their appends."""
        n = int(n)
        if n <= 0 or n == self.buffer_spans:
            return
        with self._lock:
            self.buffer_spans = n
            self._retired = deque(self._retired, maxlen=n)

    def clear(self) -> None:
        with self._lock:
            bufs = list(self._bufs)
            self._retired.clear()
        for b in bufs:
            b.spans.clear()


# --------------------------------------------------------------------------
# Process-global default tracer.  Subsystems take their handle once at
# construction (``get_tracer() if cfg.serving.tracing else null_tracer()``)
# so the on/off decision is a constructor-time branch, not a hot-path one.

_GLOBAL = Tracer()
_NULL = Tracer(enabled=False)


def get_tracer(buffer_spans: Optional[int] = None) -> Tracer:
    """The process-global tracer.  ``buffer_spans`` (the
    ``serving.trace_buffer_spans`` knob) re-bounds the rings: the
    retired ring immediately (newest spans kept), per-thread rings for
    threads registered after the call."""
    if buffer_spans:
        _GLOBAL.set_buffer_spans(buffer_spans)
    return _GLOBAL


def null_tracer() -> Tracer:
    return _NULL


def service_tracer(sv) -> Tracer:
    """The tracer a serving component takes at construction: the process
    tracer under ``serving.tracing`` (its rings bounded by
    ``serving.trace_buffer_spans``), else the disabled one."""
    if not getattr(sv, "tracing", True):
        return _NULL
    return get_tracer(int(getattr(sv, "trace_buffer_spans", 0) or 0))


def validate_chrome_trace(obj: Any) -> Dict[str, Any]:
    """Schema-check one exported Chrome-trace object (the contract the
    export tests and the flight-dump reader rely on).  Returns ``obj``
    or raises ValueError naming the violation."""

    def fail(msg: str) -> None:
        raise ValueError(f"malformed chrome trace: {msg}")

    if not isinstance(obj, dict) or "traceEvents" not in obj:
        fail("not a dict with 'traceEvents'")
    if not isinstance(obj["traceEvents"], list):
        fail("'traceEvents' must be a list")
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            fail(f"traceEvents[{i}] is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                fail(f"traceEvents[{i}] missing {k!r}")
        if ev["ph"] == "X":
            for k in ("ts", "dur"):
                v = ev.get(k)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    fail(f"traceEvents[{i}].{k} must be a number")
            if ev["dur"] < 0:
                fail(f"traceEvents[{i}] has negative duration")
            args = ev.get("args")
            if not isinstance(args, dict) or "trace_id" not in args:
                fail(f"traceEvents[{i}].args must carry trace_id")
            if not registered(ev["name"]):
                fail(f"traceEvents[{i}] name {ev['name']!r} unregistered")
    return obj
