"""Span tracing and a crash flight recorder: one timeline format for
serving and training (port of the JAX package's ``observability/``).

* ``trace``: a stdlib-only, thread-safe span tracer (trace_id / span_id /
  parent links, monotonic clocks, bounded per-thread rings) with a
  Chrome-trace-event JSON export that Perfetto loads, and the
  ``SPAN_CATALOGUE`` every emitted span name must be in.
* ``flight``: a per-replica ring of recent events, dumped to disk on
  worker death, ``kill_replica``, the drain deadline and a SIGTERM
  drain, and readable live at ``GET /debug/flight``.

Serving opens a root span per request (``serving/server.py``) and the
slot loop records its dispatch / wait / harvest split; training's
``PhaseClock`` laps are spans too (``training/steps.py``), so a CST step
and a served request render in one timeline.
"""

from cst_captioning_torch.observability.flight import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
    validate_flight_dump,
)
from cst_captioning_torch.observability.trace import (  # noqa: F401
    EVENT_CATALOGUE,
    SPAN_CATALOGUE,
    Tracer,
    get_tracer,
    null_tracer,
    service_tracer,
    validate_chrome_trace,
)
