"""Crash flight recorder: a bounded in-memory ring of recent events per
replica / scheduler, dumped to disk as JSON at the moments that matter
(port of the JAX package's ``observability/flight.py``, own copy).

Aggregate metrics say a replica died; they cannot say what its last
twenty ticks looked like.  Each serving worker owns one
:class:`FlightRecorder`: every tick appends a small event (admits /
occupancy / tick seq), lifecycle transitions append theirs (drain start,
requeues, kill, worker death), and on a trigger (worker death,
``kill_replica``, the drain deadline, a SIGTERM drain) the ring is
written to ``serving.flight_dir`` with the tracer's recent spans of that
replica.  The live rings are readable at ``GET /debug/flight``.

Event names are registered in ``observability/trace.py::
EVENT_CATALOGUE``.  Timestamps are monotonic seconds on the tracer's
base; the one wall-clock reading is the dump's header
(``wall_time_utc``), taken at dump time.

Thread-safety: ``event`` appends under the recorder's lock (events come
from the owning worker and from control threads: ``kill_replica``,
``stop``); ``snapshot`` / ``dump`` take the same lock.  Dumping never
raises into the caller: a dump rides failure paths, and a recorder that
cannot write must not turn a drain into a crash.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from cst_captioning_torch.observability.trace import Tracer, registered

_log = logging.getLogger("cst_captioning_torch.observability")

FLIGHT_SCHEMA_VERSION = 1


class FlightRecorder:
    """See module doc.  One per replica worker / scheduler thread."""

    def __init__(
        self,
        name: str,
        max_events: int = 256,
        out_dir: str = "",
        tracer: Optional[Tracer] = None,
        tags: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.out_dir = out_dir
        self.tracer = tracer
        self.tags = dict(tags or ())
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(max_events))
        self._dumps = 0

    # ------------------------------------------------------------- record
    def event(self, name: str, **tags: Any) -> None:
        """Append one event to the ring (monotonic-stamped)."""
        if not registered(name):
            raise ValueError(
                f"flight event name {name!r} is not registered in "
                "observability/trace.py::EVENT_CATALOGUE"
            )
        with self._lock:
            self._events.append((time.monotonic(), name, tags or None))

    # ------------------------------------------------------------- read
    def snapshot(self) -> Dict[str, Any]:
        """The ring as a JSON-ready dict (live ``/debug/flight`` view)."""
        with self._lock:
            events = list(self._events)
            dumps = self._dumps
        return {
            "version": FLIGHT_SCHEMA_VERSION,
            "name": self.name,
            "tags": dict(self.tags),
            "dumps_written": dumps,
            "events": [
                {"t_s": round(t, 6), "event": n, **({"tags": g} if g else {})}
                for t, n, g in events
            ],
        }

    def _recent_spans(self) -> List[Dict[str, Any]]:
        """The tracer's buffered spans belonging to this recorder's
        replica (matched on the recorder's tags, e.g. ``replica``)."""
        if self.tracer is None or not self.tracer.enabled:
            return []
        want = self.tags.get("replica")
        out = []
        for s in self.tracer.spans():
            if want is not None and s["tags"].get("replica") != want:
                continue
            out.append(s)
        return out

    # ------------------------------------------------------------- dump
    def dump(self, reason: str) -> Optional[str]:
        """Write the ring (+ recent spans) to
        ``<out_dir>/flight-<name>-<seq>-<reason>.json``.  No-op when no
        ``out_dir`` is configured; never raises (failure paths call
        this)."""
        if not self.out_dir:
            return None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with self._lock:
                self._dumps += 1
                seq = self._dumps
            body = self.snapshot()
            body["reason"] = reason
            body["pid"] = os.getpid()
            # The single wall-clock anchor: lines the monotonic timeline
            # up with external logs.  Taken at dump time, never on the
            # event path.
            body["wall_time_utc"] = time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            )
            body["monotonic_now_s"] = round(time.monotonic(), 6)
            body["spans"] = self._recent_spans()
            safe = "".join(
                c if c.isalnum() or c in "-_" else "_" for c in reason
            )
            path = os.path.join(
                self.out_dir, f"flight-{self.name}-{seq:03d}-{safe}.json"
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f, indent=1)
            os.replace(tmp, path)
            self.event("dump", reason=reason, path=path)
            _log.warning("flight dump (%s): %s", reason, path)
            return path
        except Exception:  # noqa: BLE001 — dumps ride failure paths
            _log.exception("flight dump failed (%s)", reason)
            return None


def flight_recorder(sv, name: str, tracer: Optional[Tracer] = None,
                    tags: Optional[Dict[str, Any]] = None) -> FlightRecorder:
    """A serving component's recorder, sized and placed by
    ``serving.flight_events`` and ``serving.flight_dir``."""
    return FlightRecorder(
        name, max_events=int(getattr(sv, "flight_events", 256)),
        out_dir=str(getattr(sv, "flight_dir", "") or ""), tracer=tracer,
        tags=tags)


def validate_flight_dump(rec: Any) -> Dict[str, Any]:
    """Schema-check one flight dump / snapshot (tests + tooling).
    Returns the record or raises ValueError naming the violation."""

    def fail(msg: str) -> None:
        raise ValueError(f"malformed flight dump: {msg}")

    if not isinstance(rec, dict):
        fail("not a dict")
    for k in ("version", "name", "events"):
        if k not in rec:
            fail(f"missing required key {k!r}")
    if rec["version"] != FLIGHT_SCHEMA_VERSION:
        fail(f"unknown version {rec['version']!r}")
    if not isinstance(rec["events"], list):
        fail("'events' must be a list")
    last_t = None
    for i, ev in enumerate(rec["events"]):
        if not isinstance(ev, dict):
            fail(f"events[{i}] is not an object")
        t = ev.get("t_s")
        if isinstance(t, bool) or not isinstance(t, (int, float)):
            fail(f"events[{i}].t_s must be a number")
        if last_t is not None and t < last_t:
            fail(f"events[{i}] goes backwards in time")
        last_t = t
        if not (isinstance(ev.get("event"), str) and ev["event"]):
            fail(f"events[{i}].event must be a non-empty string")
        if not registered(ev["event"]):
            fail(f"events[{i}].event {ev['event']!r} unregistered")
    if "spans" in rec and not isinstance(rec["spans"], list):
        fail("'spans' must be a list")
    return rec
