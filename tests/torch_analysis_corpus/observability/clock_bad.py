# corpus-rules: observability
"""Seeded wall clock inside the observability layer, and emissions
against the package's span / event catalogues: registered literal and
f-string names pass, two unregistered ones fire."""

import time


def span_with_wall_clock(tracer):
    t0 = time.time()  # expect: CST-OBS-001
    tracer.record("tick_dispatch", t0, time.monotonic())
    tracer.record(f"phase/{t0}", 0.0, 1.0)
    tracer.record("kernel_launch", 0.0, 1.0)  # expect: CST-OBS-002


def flight_events(rep):
    rep.flight.event("worker_death", error="boom")
    rep.flight.event("graph_capture")  # expect: CST-OBS-002
