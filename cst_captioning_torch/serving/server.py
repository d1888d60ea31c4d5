"""Stdlib-only HTTP front end for caption serving (port of the JAX
package's ``serving/server.py::CaptionServer``).  The scheduler behind
``submit`` follows ``serving.continuous`` and ``serving.replicas``, as
the reference's does: the multi-replica ``ReplicaSet``
(``serving/replicas.py``; continuous and ``replicas != 1``, which the
production preset's ``replicas = 0`` selects: one replica per local
card), the single-engine slot loop (``ContinuousBatcher``, continuous
and ``replicas = 1``) or the batch-at-a-time ladder (``MicroBatcher``).

Endpoints:

* ``POST /v1/caption`` — body ``{"features": {modality: [[...], ...]},
  "feature_id": str?, "category": int?, "deadline_ms": float?,
  "priority": "interactive"|"batch"|"best_effort"?}`` -> ``{"caption",
  "tokens", "cached", "timings_ms"}``; ``feature_id`` stores the
  request in the tier-2 cache, and a later body holding only the id is
  served from it; ``category`` (default 0) is the video's category id
  under ``model.use_category``, an id outside ``[0,
  data.num_categories)`` a 400.  Errors: 400 (bad input, an unknown
  priority), 404 (a ``feature_id`` that is not cached), 429 (queue full
  or shed under overload), 503 (draining, or no healthy replica), 504
  (deadline exceeded), 500 (engine failure).
  429 and 503 carry a ``Retry-After`` from the queue depth plus a
  per-request jitter.  Every response carries ``X-Trace-Id`` when
  ``serving.tracing`` is on: the id of the request's root span.
* ``GET /healthz`` — liveness + engine description (+ the replica
  counts under ``ReplicaSet``: 503 only when no replica is healthy).
* ``GET /metrics`` — Prometheus text (per-stage latency histograms,
  request counters, per-replica and degradation families, cache tiers).
* ``GET /stats`` — the same numbers as one JSON object, with the trace
  id exemplar of the total-latency histogram.
* ``GET /debug/trace`` — the span tracer's buffered spans as a
  Chrome trace (load in Perfetto); 404 with ``serving.tracing`` off.
* ``GET /debug/flight`` — the live flight-recorder rings.
* ``GET /debug/profile?ms=N`` — a ``torch.profiler`` window of N ms
  (on a card the kernels every thread launches; on the CPU every
  thread's operators) written as a Chrome trace into
  ``serving.profile_dir`` on a background thread: 202, 409 while a
  window runs, 400 for a bad window, 404 without
  ``serving.profile_dir``.

``ThreadingHTTPServer`` gives one thread per in-flight request, matching
the batcher's blocking ``submit``; the bounded queue is the
backpressure surface.  ``shutdown()`` (and SIGTERM under
``serve_forever``) closes admissions, drains queued work within
``serving.drain_timeout_s``, then tears the listener down.

With ``serving.autoscale`` set and a ``ReplicaSet`` behind the door, an
:class:`~cst_captioning_torch.serving.autoscaler.Autoscaler` thread
sizes the fleet between ``min_replicas`` and ``max_replicas``: it starts
with the scheduler and stops before the drain.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import torch

from cst_captioning_torch.observability.trace import service_tracer
from cst_captioning_torch.serving.autoscaler import (
    AutoscaleConfig,
    Autoscaler,
)
from cst_captioning_torch.serving.batcher import (
    BackpressureError,
    ContinuousBatcher,
    DeadlineExceededError,
    MicroBatcher,
    ShuttingDownError,
)
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.metrics import ServingMetrics

_log = logging.getLogger("cst_captioning_torch.serving")

MAX_BODY_BYTES = 64 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, content_type: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Any,
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", headers)

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        srv = self.server
        route, _, query = self.path.partition("?")
        if route == "/healthz":
            status = "draining" if srv.draining else "ok"
            info, code = srv.engine.describe(), 200
            healthy = getattr(srv.batcher, "healthy_replicas", None)
            if healthy is not None:
                # A dead replica degrades capacity, not health; only
                # zero healthy replicas fails the probe.
                info["replicas"] = {"healthy": healthy,
                                    "total": len(srv.batcher.replicas)}
                if healthy == 0:
                    status, code = "unhealthy", 503
            self._send_json(code, {"status": status, **info})
        elif route == "/metrics":
            body = srv.metrics.to_prometheus(srv.engine.cache.stats()).encode()
            self._send(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif route == "/stats":
            self._send_json(200, {
                "build": srv.engine.fingerprint(),
                **srv.metrics.to_dict(srv.engine.cache.stats()),
            })
        elif route == "/debug/trace":
            if not srv.tracer.enabled:
                self._send_json(404, {"error": "tracing disabled "
                                               "(serving.tracing)"})
                return
            self._send_json(200, srv.tracer.export_chrome_trace())
        elif route == "/debug/flight":
            self._send_json(200, {"build": srv.engine.fingerprint(),
                                  "recorders": srv.batcher.flight_snapshot()})
        elif route == "/debug/profile":
            self._profile(srv, query)
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _profile(self, srv: "_Server", query: str) -> None:
        if not srv.profile_dir:
            self._send_json(404, {"error": "profiling disabled — set "
                                           "serving.profile_dir to enable"})
            return
        try:
            ms = float(urllib.parse.parse_qs(query).get("ms", ["1000"])[0])
            if not 0 < ms <= 60_000:
                raise ValueError(f"ms={ms} outside (0, 60000]")
        except ValueError as e:
            self._send_json(400, {"error": f"bad profile window: {e}"})
            return
        if srv.start_profile(ms):
            self._send_json(202, {"profiling_ms": ms,
                                  "out_dir": srv.profile_dir})
        else:
            self._send_json(409, {"error": "a profile window is already "
                                           "running"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/caption":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        srv = self.server
        if srv.draining:
            self._send_json(503, {"error": "server is draining"}, headers={
                "Retry-After": f"{srv.batcher.retry_after():.3f}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0 or length > MAX_BODY_BYTES:
                self._send_json(400, {"error": f"bad Content-Length {length}"})
                return
            payload = json.loads(self.rfile.read(length))
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            self._send_json(400, {"error": f"bad request body: {e}"})
            return
        # The request's root span: its trace id is echoed in X-Trace-Id
        # and the scheduler parents its spans under it.
        trace = None
        hdrs: Dict[str, str] = {}
        if srv.tracer.enabled:
            trace = (srv.tracer.new_trace_id(), srv.tracer.new_span_id())
            hdrs["X-Trace-Id"] = trace[0]
        t_root = time.monotonic()
        try:
            status, body = 200, srv.batcher.submit(
                payload, deadline_ms=payload.get("deadline_ms"), trace=trace)
        except BackpressureError as e:
            status = 429
            body = {"error": str(e), "retry_after_s": e.retry_after_s}
            hdrs["Retry-After"] = f"{e.retry_after_s:.3f}"
        except ShuttingDownError as e:
            status, body = 503, {"error": str(e)}
            if e.retry_after_s:
                hdrs["Retry-After"] = f"{e.retry_after_s:.3f}"
        except DeadlineExceededError as e:
            status, body = 504, {"error": str(e)}
        except KeyError as e:
            # An uncached feature_id (tier 2).
            status, body = 404, {"error": str(e)}
        except (ValueError, TypeError) as e:
            status, body = 400, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — last-resort 500
            _log.exception("caption request failed")
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        # Recorded before the response leaves, so a client holding the
        # X-Trace-Id finds the root span at /debug/trace.
        if trace is not None:
            srv.tracer.record("request", t_root, time.monotonic(),
                              trace_id=trace[0], span_id=trace[1],
                              tags={"status": status})
        self._send_json(status, body, headers=hdrs)


def _all_threads() -> Dict[str, Any]:
    """The profiler option that records every thread's operators (the
    scheduler's and the replica workers', not only the window's own
    thread), where this PyTorch has it.  Used on a CPU engine only: with
    CUDA activity on, every worker thread's operators would also hand
    correlation ids to CUPTI while the window's thread stops it, and a
    process serving a burst on an H100 died (SIGSEGV) once with such a
    window open (``chip_smoke.py`` phase 3e.f)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog (socketserver's default is 5): a burst of more
    # concurrent connections would have the kernel drop SYNs, and each
    # dropped client retries a second later.
    request_queue_size = 1024
    engine: InferenceEngine
    batcher: Any
    metrics: ServingMetrics
    tracer: Any

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._draining_evt = threading.Event()
        # /debug/profile: handler threads race to open a window; the
        # flag lives under this lock.
        self._profile_lock = threading.Lock()
        self._profiling = False
        self.profile_dir = ""

    @property
    def draining(self) -> bool:
        return self._draining_evt.is_set()

    def start_profile(self, ms: float) -> bool:
        """Open a ``torch.profiler`` window of ``ms`` milliseconds on a
        background thread, written as a Chrome trace into
        ``profile_dir``.  On a card the window records CUDA activity,
        which is process-wide: the kernels the replica workers launch.
        On the CPU it records every thread's operators.  False when a
        window is already running (HTTP 409)."""
        with self._profile_lock:
            if self._profiling:
                return False
            self._profiling = True
        threading.Thread(target=self._window, args=(ms,),
                         name="caption-profile", daemon=True).start()
        return True

    def _window(self, ms: float) -> None:
        # The whole body is contained: an exception escaping here would
        # leave the flag set and every later window refused.
        try:
            from torch.profiler import ProfilerActivity, profile

            if torch.device(self.engine.device).type == "cuda":
                acts, kw = [ProfilerActivity.CUDA], {}
            else:
                acts, kw = [ProfilerActivity.CPU], _all_threads()
            os.makedirs(self.profile_dir, exist_ok=True)
            t0 = time.monotonic()
            with profile(activities=acts, **kw) as prof:
                time.sleep(ms / 1e3)
            path = os.path.join(
                self.profile_dir,
                f"profile-{os.getpid()}-{int(t0 * 1e3)}.json")
            prof.export_chrome_trace(path)
            self.tracer.record("profile", t0, time.monotonic(),
                               tags={"ms": ms, "path": path})
            _log.info("profiler window (%.0f ms) written to %s", ms, path)
        except Exception:  # noqa: BLE001 — a failed window is logged
            _log.exception("profiler window failed")
        finally:
            with self._profile_lock:
                self._profiling = False


class CaptionServer:
    """Engine + scheduler + HTTP listener, wired.  ``port=0`` binds
    an ephemeral port; ``serve_forever`` blocks (SIGTERM -> graceful
    shutdown), or use ``start``/``shutdown`` or the context manager."""

    def __init__(self, engine: InferenceEngine, host: Optional[str] = None,
                 port: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 batcher: Optional[Any] = None):
        sv = engine.cfg.serving
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        if batcher is None:
            if sv.continuous and int(sv.replicas) != 1:
                from cst_captioning_torch.serving.replicas import ReplicaSet

                batcher = ReplicaSet.from_engine(engine, self.metrics)
            elif sv.continuous:
                batcher = ContinuousBatcher(engine, self.metrics)
            else:
                batcher = MicroBatcher(engine, self.metrics)
        self.batcher = batcher
        # Elastic autoscaler (serving/autoscaler.py): built only when
        # `serving.autoscale` is configured and the scheduler is a
        # ReplicaSet (the single-engine schedulers have no fleet to
        # size).  A scale-up clones the loaded engine round-robin onto
        # the local cards (on one card the clones share the weights and
        # each has its own stream), or onto the engine's own device; a
        # model-sharded engine onto its (1, M) device groups
        # (replicas.py::clone_replica).
        self.autoscaler = None
        as_cfg = AutoscaleConfig.from_config(sv)
        if as_cfg is not None and hasattr(self.batcher, "add_replica"):
            def _scale_up_engine():
                from cst_captioning_torch.serving.replicas import (
                    clone_replica,
                )

                return clone_replica(engine, len(self.batcher.replicas))

            self.autoscaler = Autoscaler(as_cfg, _scale_up_engine)
        self._http = _Server(
            (host if host is not None else sv.host,
             port if port is not None else sv.port), _Handler)
        self._http.engine = engine
        self._http.batcher = self.batcher
        self._http.metrics = self.metrics
        self._http.tracer = service_tracer(sv)
        self._http.profile_dir = str(sv.profile_dir or "")
        self._thread: Optional[threading.Thread] = None
        self._shutdown_lock = threading.Lock()
        self._closed = False
        self._listening = False

    @property
    def address(self) -> Tuple[str, int]:
        return self._http.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "CaptionServer":
        self.batcher.start()
        if self.autoscaler is not None:
            self.autoscaler.start(self.batcher)
        self._listening = True
        self._thread = threading.Thread(
            target=self._http.serve_forever, name="caption-http", daemon=True)
        self._thread.start()
        _log.info("caption server listening on %s", self.url)
        return self

    def serve_forever(self) -> None:
        self.batcher.start()
        if self.autoscaler is not None:
            self.autoscaler.start(self.batcher)
        _log.info("caption server listening on %s", self.url)
        try:
            # SIGTERM -> graceful drain, on a thread of its own: shutdown()
            # on the thread blocked in serve_forever would deadlock.
            signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
                target=self._signal_shutdown, name="caption-sigterm",
                daemon=True).start())
        except ValueError:
            pass  # not the main thread — no signal handling
        self._listening = True
        try:
            self._http.serve_forever()
        finally:
            self.shutdown()

    def begin_drain(self) -> None:
        """Close admissions: new requests get 503; in-flight work keeps
        running."""
        self._http._draining_evt.set()
        self.batcher.begin_drain()

    def _signal_shutdown(self) -> None:
        """SIGTERM thread body: ``shutdown()`` with a last-resort log —
        an exception escaping a signal-spawned thread would otherwise
        vanish mid-drain with the listener half down and nothing
        recorded."""
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — a failed drain must be loud
            _log.exception("SIGTERM shutdown failed")

    def shutdown(self, drain: bool = True) -> None:
        """503 new requests, drain queued work, stop the listener."""
        with self._shutdown_lock:
            if self._closed:
                return
            self._closed = True
            self.begin_drain()
            # Stop the control loop before the drain: a scale decision
            # landing mid-teardown would race the worker joins.
            if self.autoscaler is not None:
                self.autoscaler.stop()
            self.batcher.stop(drain=drain)
            if self._listening:
                self._http.shutdown()
            self._http.server_close()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "CaptionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
