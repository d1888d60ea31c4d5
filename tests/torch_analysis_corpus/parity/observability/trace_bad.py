"""Seeded CST-OBS violations: a wall clock on a span path, an
unregistered span name, a flight event off the catalogue, and a tracer
call reachable from a torch.compile root.  Parsed, never imported."""
# corpus-rules: observability

import time

import torch


def emit_with_wall_clock(tracer):
    t0 = time.time()                                 # expect: CST-OBS-001
    # negative: registered name, monotonic clocks — must NOT fire
    tracer.record("request", t0, time.monotonic())
    tracer.record("totally_unregistered_span", 0.0, 1.0)  # expect: CST-OBS-002


def flight_bad(flight):
    # negative: a registered event name is fine
    flight.event("tick", admits=1)
    flight.event("not_an_event")                     # expect: CST-OBS-002


@torch.compile
def traced_step(x, tracer):
    tracer.record("tick_dispatch", 0.0, 1.0)         # expect: CST-OBS-003
    return x
