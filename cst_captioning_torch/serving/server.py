"""Stdlib-only HTTP front end for caption serving (port of the JAX
package's ``serving/server.py::CaptionServer``, single engine).  The
scheduler behind ``submit`` follows ``serving.continuous``: the
continuous slot loop (``ContinuousBatcher``, the default) or the
batch-at-a-time ladder (``MicroBatcher``).

Endpoints:

* ``POST /v1/caption`` — body ``{"features": {modality: [[...], ...]},
  "deadline_ms": float?}`` -> ``{"caption", "tokens", "cached",
  "timings_ms"}``.  Errors: 400 (bad input), 429 (queue full, with
  ``Retry-After``), 503 (draining), 504 (deadline exceeded), 500 (engine
  failure).
* ``GET /healthz`` — liveness + engine description.
* ``GET /metrics`` — Prometheus text (per-stage latency histograms,
  request counters, cache tiers).
* ``GET /stats`` — the same numbers as one JSON object.

``ThreadingHTTPServer`` gives one thread per in-flight request, matching
the batcher's blocking ``submit``; the bounded queue is the
backpressure surface.  ``shutdown()`` (and SIGTERM under
``serve_forever``) closes admissions, drains queued work within
``serving.drain_timeout_s``, then tears the listener down.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

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
        route = self.path.partition("?")[0]
        if route == "/healthz":
            status = "draining" if srv.draining else "ok"
            self._send_json(200, {"status": status, **srv.engine.describe()})
        elif route == "/metrics":
            body = srv.metrics.to_prometheus(srv.engine.cache.stats()).encode()
            self._send(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif route == "/stats":
            self._send_json(200, {
                "build": srv.engine.fingerprint(),
                **srv.metrics.to_dict(srv.engine.cache.stats()),
            })
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/caption":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        if self.server.draining:
            self._send_json(503, {"error": "server is draining"})
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
        hdrs: Dict[str, str] = {}
        try:
            status, body = 200, self.server.batcher.submit(
                payload, deadline_ms=payload.get("deadline_ms"))
        except BackpressureError as e:
            status = 429
            body = {"error": str(e), "retry_after_s": e.retry_after_s}
            hdrs["Retry-After"] = f"{e.retry_after_s:.3f}"
        except ShuttingDownError as e:
            status, body = 503, {"error": str(e)}
        except DeadlineExceededError as e:
            status, body = 504, {"error": str(e)}
        except (ValueError, TypeError) as e:
            status, body = 400, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — last-resort 500
            _log.exception("caption request failed")
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        self._send_json(status, body, headers=hdrs)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    engine: InferenceEngine
    batcher: Any
    metrics: ServingMetrics

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._draining_evt = threading.Event()

    @property
    def draining(self) -> bool:
        return self._draining_evt.is_set()


class CaptionServer:
    """Engine + scheduler + HTTP listener, wired.  ``port=0`` binds
    an ephemeral port; ``serve_forever`` blocks (SIGTERM -> graceful
    shutdown), or use ``start``/``shutdown`` or the context manager."""

    def __init__(self, engine: InferenceEngine, host: Optional[str] = None,
                 port: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None):
        sv = engine.cfg.serving
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        batcher = ContinuousBatcher if sv.continuous else MicroBatcher
        self.batcher = batcher(engine, self.metrics)
        self._http = _Server(
            (host if host is not None else sv.host,
             port if port is not None else sv.port), _Handler)
        self._http.engine = engine
        self._http.batcher = self.batcher
        self._http.metrics = self.metrics
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
        self._listening = True
        self._thread = threading.Thread(
            target=self._http.serve_forever, name="caption-http", daemon=True)
        self._thread.start()
        _log.info("caption server listening on %s", self.url)
        return self

    def serve_forever(self) -> None:
        self.batcher.start()
        _log.info("caption server listening on %s", self.url)
        try:
            signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
                target=self.shutdown, name="caption-sigterm",
                daemon=True).start())
        except ValueError:
            pass  # not the main thread — no signal handling
        self._listening = True
        try:
            self._http.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self, drain: bool = True) -> None:
        """503 new requests, drain queued work, stop the listener."""
        with self._shutdown_lock:
            if self._closed:
                return
            self._closed = True
            self._http._draining_evt.set()
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
