# corpus-rules: metrics_registry
"""Corpus twin of the port's metric registry: a METRIC_HELP dict literal
whose second entry for one family silently replaces the first at
import (only the source still shows both)."""

METRIC_HELP = {
    "caption_requests_total": "Requests accepted into the pipeline.",
    "caption_latency_*_ms": "Per-stage request latency in milliseconds.",
    "caption_slots_occupied": "Decode slots occupied right now.",
    "caption_requests_total": "Requests accepted.",  # expect: CST-MET-003
}
