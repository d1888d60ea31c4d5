"""Serving metrics: per-stage latency histograms, request counters, the
continuous slot loop's counters and gauges, the per-replica label sets
of ``serving/replicas.py`` and the degradation counters (shedding,
hedging, requeues, chaos injections) and the autoscaler's families
(port of the JAX package's ``serving/metrics.py``).  The total-latency
histogram carries the trace id of its latest traced observation as an
exemplar (``/stats``).

Stdlib-only, lock-per-object.  Histograms are fixed-bucket log-spaced
(milliseconds); percentiles interpolate inside the winning bucket.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

DEFAULT_BUCKETS_MS: List[float] = [
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1_000.0, 2_000.0, 5_000.0, 10_000.0,
    30_000.0, 60_000.0,
]

# Stage names in request order: ``queue`` is enqueue -> batch pop,
# ``admission`` enqueue -> decode-slot admission (continuous mode, the
# in-flight analogue of ``queue``), ``pad`` batch assembly + ladder
# padding, ``device`` the decode (ladder: host -> device copies, the
# kernel, device -> host; slots: admission -> harvest), ``detok`` tokens
# -> text, ``total`` submit -> response.
STAGES = ("queue", "admission", "pad", "device", "detok", "total")

# Request priority classes, highest value first.  Under overload the
# admission path sheds the lowest class present before anything above it
# (serving/batcher.py); ``caption_shed_total{priority=...}`` counts the
# decisions per class.
PRIORITIES = ("interactive", "batch", "best_effort")

# Bucket upper bounds of the steps-per-caption histogram (decode steps a
# caption paid before its slot freed).
STEP_BUCKETS = [
    1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 16.0, 20.0, 24.0,
    28.0, 32.0, 48.0, 64.0,
]

METRIC_HELP = {
    "caption_requests_total": "Requests accepted into the pipeline.",
    "caption_requests_served_total": "Requests resolved with a caption.",
    "caption_requests_rejected_total":
        "Requests rejected by queue-full backpressure (HTTP 429).",
    "caption_requests_expired_total":
        "Requests whose deadline passed before a result (HTTP 504).",
    "caption_requests_failed_total":
        "Requests failed by engine or input errors (HTTP 5xx).",
    "caption_batches_total": "Coalesced batches dispatched (ladder mode).",
    "caption_batch_rows_total": "Live request rows across batches.",
    "caption_batch_pad_rows_total":
        "Padding rows dispatched (wasted device rows).",
    "caption_slots_admitted_total":
        "Requests admitted into decode slots (continuous mode).",
    "caption_slot_device_steps_total": "Device decode steps dispatched.",
    "caption_slot_bank_resizes_total":
        "Elastic slot-bank grow/shrink transitions.",
    "caption_slots_total": "Configured decode slots (current bank).",
    "caption_slots_occupied": "Decode slots occupied right now.",
    "caption_decode_state_bytes":
        "Live bytes of the resident decode-slot state.",
    "caption_slot_bank_size": "Current elastic slot-bank size.",
    "caption_replica_healthy": "1 while the replica is routed, 0 drained.",
    "caption_replica_slots_occupied": "Occupied slots on this replica.",
    "caption_replica_queue_depth": "Queued requests on this replica.",
    "caption_replica_captions_total": "Captions served by this replica.",
    "caption_replica_admitted_total":
        "Requests admitted into this replica's slots.",
    "caption_replica_device_steps_total":
        "Device decode steps run by this replica.",
    "caption_replica_decode_state_bytes":
        "Live decode-state bytes on this replica.",
    "caption_replica_slot_bank_size":
        "This replica's current elastic slot-bank size.",
    "caption_shed_total":
        "Requests load-shed per priority class (overload eviction, "
        "deadline expiry, requeue-budget overflow).",
    "caption_hedges_total":
        "Hedged duplicate dispatches onto a second healthy replica.",
    "caption_hedge_cancelled_total":
        "Hedged duplicate copies discarded (queued skip or losing "
        "in-flight copy after first-result-wins).",
    "caption_requeues_total":
        "Requests requeued onto survivors after a replica drain.",
    "caption_requeue_overflow_total":
        "Requests failed because the server-side requeue budget was "
        "exhausted (requeue-storm cap).",
    "caption_chaos_faults_total":
        "Fault injections fired by the ChaosEngine (zero unless "
        "serving.chaos is configured).",
    "caption_autoscale_decisions_total":
        "Autoscaler signal-window evaluations (zero unless "
        "serving.autoscale is configured).",
    "caption_autoscale_scale_ups_total":
        "Applied scale-up decisions (replica added to the router).",
    "caption_autoscale_scale_downs_total":
        "Applied scale-down decisions (replica drained via the "
        "requeue path).",
    "caption_autoscale_target_replicas":
        "The autoscaler's current target healthy-replica count.",
    "caption_latency_*_ms": "Per-stage request latency in milliseconds.",
    "caption_steps_per_caption":
        "Device decode steps each caption paid before its slot freed.",
    "caption_cache_*": "Two-tier cache counters (hits/misses/bytes/...).",
}


class Counter:
    """Thread-safe monotonically-increasing counter."""

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Thread-safe last-value gauge (slot occupancy, bank size)."""

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class LatencyHistogram:
    """Fixed-bucket latency histogram (milliseconds)."""

    def __init__(self, buckets_ms: Optional[List[float]] = None) -> None:
        self.bounds = list(buckets_ms or DEFAULT_BUCKETS_MS)
        if sorted(self.bounds) != self.bounds:
            raise ValueError("histogram buckets must be ascending")
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        # The trace id of the latest observation that carried one, with
        # its value: /stats shows it, so a latency leads to the
        # /debug/trace timeline that produced it.
        self._exemplar: Optional[Dict[str, float]] = None
        self._lock = threading.Lock()

    def observe(self, ms: float, exemplar: Optional[str] = None) -> None:
        ms = float(ms)
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if ms <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += ms
            self._count += 1
            self._max = max(self._max, ms)
            if exemplar is not None:
                self._exemplar = {"trace_id": exemplar,
                                  "value_ms": round(ms, 4)}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile {p} outside [0, 100]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
            mx = self._max
        if total == 0:
            return 0.0
        rank = p / 100.0 * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else mx
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return mx

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            total, s, mx = self._count, self._sum, self._max
            ex = dict(self._exemplar) if self._exemplar else None
        out = {
            "count": total,
            "mean_ms": round(s / total, 4) if total else 0.0,
            "p50_ms": round(self.percentile(50), 4),
            "p90_ms": round(self.percentile(90), 4),
            "p99_ms": round(self.percentile(99), 4),
            "max_ms": round(mx, 4),
        }
        if ex is not None:
            out["exemplar"] = ex
        return out

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)


class ReplicaMetrics:
    """One replica's label set (``serving/replicas.py``), exported as
    ``caption_replica_*{replica="<id>"}``."""

    def __init__(self) -> None:
        self.healthy = Gauge()           # 1 routed / 0 drained
        self.slots_occupied = Gauge()
        self.queue_depth = Gauge()
        self.captions_total = Counter()
        self.admitted_total = Counter()
        self.steps_total = Counter()     # device decode steps run
        self.decode_state_bytes = Gauge()
        self.slot_bank_size = Gauge()


class ServingMetrics:
    """All serving-side observability in one object, shared by the
    batcher and the HTTP front end."""

    def __init__(self) -> None:
        self.stages: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram() for s in STAGES
        }
        self.requests_total = Counter()
        self.requests_served = Counter()
        self.requests_rejected = Counter()
        self.requests_expired = Counter()
        self.requests_failed = Counter()
        self.batches_total = Counter()
        self.batch_rows_total = Counter()
        self.batch_pad_rows_total = Counter()
        # Continuous mode (the slot loop).
        self.slots_total = Gauge()            # current bank size S
        self.slots_occupied = Gauge()         # live slots right now
        self.slots_admitted_total = Counter()
        self.slot_steps_total = Counter()     # device decode steps run
        self.decode_state_bytes = Gauge()     # live slot-state bytes
        self.slot_bank_size = Gauge()
        self.slot_bank_resizes = Counter()
        self.steps_per_caption = LatencyHistogram(STEP_BUCKETS)
        # Degradation: shed decisions per priority class, hedge dispatch
        # and cancel counts, requeues after replica drains, and chaos
        # injection hits.
        self.shed_total: Dict[str, Counter] = {
            p: Counter() for p in PRIORITIES}
        self.hedges_total = Counter()
        self.hedge_cancelled = Counter()
        self.requeues_total = Counter()
        self.requeue_overflow = Counter()
        self.chaos_faults = Counter()
        # The elastic autoscaler: window evaluations, applied actions and
        # the current replica target (all zero without serving.autoscale).
        self.autoscale_decisions = Counter()
        self.autoscale_ups = Counter()
        self.autoscale_downs = Counter()
        self.autoscale_target = Gauge()
        # Per-replica label sets, created on first use.
        self._replicas: Dict[str, ReplicaMetrics] = {}
        self._replicas_lock = threading.Lock()
        self._t0 = time.monotonic()

    def replica(self, rid) -> ReplicaMetrics:
        """The label set of replica ``rid`` (created on first use)."""
        key = str(rid)
        with self._replicas_lock:
            if key not in self._replicas:
                self._replicas[key] = ReplicaMetrics()
            return self._replicas[key]

    def _replica_items(self):
        with self._replicas_lock:
            return sorted(self._replicas.items())

    def shed(self, priority: str) -> Counter:
        """The shed counter of one priority class (KeyError on an unknown
        class: priorities are a closed vocabulary)."""
        return self.shed_total[priority]

    def observe_stage(self, stage: str, ms: float,
                      exemplar: Optional[str] = None) -> None:
        self.stages[stage].observe(ms, exemplar=exemplar)

    def mean_batch_size(self) -> float:
        b = self.batches_total.value
        return self.batch_rows_total.value / b if b else 0.0

    def to_dict(self, cache_stats: Optional[Dict] = None) -> Dict:
        d = {
            "requests": {
                "total": self.requests_total.value,
                "served": self.requests_served.value,
                "rejected": self.requests_rejected.value,
                "expired": self.requests_expired.value,
                "failed": self.requests_failed.value,
            },
            "batches": {
                "total": self.batches_total.value,
                "mean_size": round(self.mean_batch_size(), 3),
                "pad_rows": self.batch_pad_rows_total.value,
            },
            "slots": {
                "total": self.slots_total.value,
                "occupied": self.slots_occupied.value,
                "admitted": self.slots_admitted_total.value,
                "device_steps": self.slot_steps_total.value,
                "steps_per_caption": self.steps_per_caption.snapshot(),
                "decode_state_bytes": self.decode_state_bytes.value,
                "bank_size": self.slot_bank_size.value,
                "bank_resizes": self.slot_bank_resizes.value,
            },
            "degradation": {
                "shed": {p: c.value for p, c in self.shed_total.items()},
                "hedges": self.hedges_total.value,
                "hedge_cancelled": self.hedge_cancelled.value,
                "requeues": self.requeues_total.value,
                "requeue_overflow": self.requeue_overflow.value,
                "chaos_faults": self.chaos_faults.value,
            },
            "autoscale": {
                "decisions": self.autoscale_decisions.value,
                "scale_ups": self.autoscale_ups.value,
                "scale_downs": self.autoscale_downs.value,
                "target_replicas": self.autoscale_target.value,
            },
            "latency_ms": {s: h.snapshot() for s, h in self.stages.items()},
        }
        reps = self._replica_items()
        if reps:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            d["replicas"] = {
                rid: {
                    "healthy": rm.healthy.value,
                    "slots_occupied": rm.slots_occupied.value,
                    "queue_depth": rm.queue_depth.value,
                    "captions": rm.captions_total.value,
                    "captions_per_sec": round(
                        rm.captions_total.value / elapsed, 3),
                    "admitted": rm.admitted_total.value,
                    "device_steps": rm.steps_total.value,
                    "decode_state_bytes": rm.decode_state_bytes.value,
                    "slot_bank_size": rm.slot_bank_size.value,
                }
                for rid, rm in reps
            }
        if cache_stats is not None:
            d["cache"] = cache_stats
        return d

    @staticmethod
    def _header(lines: List[str], name: str, family: str, typ: str) -> None:
        lines.append(f"# HELP {name} {METRIC_HELP[family]}")
        lines.append(f"# TYPE {name} {typ}")

    def to_prometheus(self, cache_stats: Optional[Dict] = None) -> str:
        """Prometheus text exposition (histograms as cumulative
        ``_bucket`` series)."""
        lines: List[str] = []
        counters = {
            "caption_requests_total": self.requests_total,
            "caption_requests_served_total": self.requests_served,
            "caption_requests_rejected_total": self.requests_rejected,
            "caption_requests_expired_total": self.requests_expired,
            "caption_requests_failed_total": self.requests_failed,
            "caption_batches_total": self.batches_total,
            "caption_batch_rows_total": self.batch_rows_total,
            "caption_batch_pad_rows_total": self.batch_pad_rows_total,
            "caption_slots_admitted_total": self.slots_admitted_total,
            "caption_slot_device_steps_total": self.slot_steps_total,
            "caption_slot_bank_resizes_total": self.slot_bank_resizes,
            "caption_hedges_total": self.hedges_total,
            "caption_hedge_cancelled_total": self.hedge_cancelled,
            "caption_requeues_total": self.requeues_total,
            "caption_requeue_overflow_total": self.requeue_overflow,
            "caption_chaos_faults_total": self.chaos_faults,
            "caption_autoscale_decisions_total": self.autoscale_decisions,
            "caption_autoscale_scale_ups_total": self.autoscale_ups,
            "caption_autoscale_scale_downs_total": self.autoscale_downs,
        }
        for name, c in counters.items():
            self._header(lines, name, name, "counter")
            lines.append(f"{name} {c.value}")
        self._header(lines, "caption_shed_total", "caption_shed_total",
                     "counter")
        for p in PRIORITIES:
            lines.append(f'caption_shed_total{{priority="{p}"}} '
                         f"{self.shed_total[p].value}")
        for name, g in (
            ("caption_slots_total", self.slots_total),
            ("caption_slots_occupied", self.slots_occupied),
            ("caption_decode_state_bytes", self.decode_state_bytes),
            ("caption_slot_bank_size", self.slot_bank_size),
            ("caption_autoscale_target_replicas", self.autoscale_target),
        ):
            self._header(lines, name, name, "gauge")
            lines.append(f"{name} {g.value}")
        reps = self._replica_items()
        if reps:
            for name, typ, read in (
                ("caption_replica_healthy", "gauge",
                 lambda rm: rm.healthy.value),
                ("caption_replica_slots_occupied", "gauge",
                 lambda rm: rm.slots_occupied.value),
                ("caption_replica_queue_depth", "gauge",
                 lambda rm: rm.queue_depth.value),
                ("caption_replica_captions_total", "counter",
                 lambda rm: rm.captions_total.value),
                ("caption_replica_admitted_total", "counter",
                 lambda rm: rm.admitted_total.value),
                ("caption_replica_device_steps_total", "counter",
                 lambda rm: rm.steps_total.value),
                ("caption_replica_decode_state_bytes", "gauge",
                 lambda rm: rm.decode_state_bytes.value),
                ("caption_replica_slot_bank_size", "gauge",
                 lambda rm: rm.slot_bank_size.value),
            ):
                self._header(lines, name, name, typ)
                for rid, rm in reps:
                    lines.append(f'{name}{{replica="{rid}"}} {read(rm)}')
        hists = {f"caption_latency_{s}_ms": ("caption_latency_*_ms", h)
                 for s, h in self.stages.items()}
        hists["caption_steps_per_caption"] = (
            "caption_steps_per_caption", self.steps_per_caption)
        for name, (family, h) in hists.items():
            self._header(lines, name, family, "histogram")
            cum = 0
            counts = h.bucket_counts()
            for bound, c in zip(h.bounds, counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{bound}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            snap = h.snapshot()
            lines.append(f"{name}_count {snap['count']}")
            lines.append(
                f"{name}_sum {round(snap['mean_ms'] * snap['count'], 4)}")
        for tier, st in (cache_stats or {}).items():
            for k in ("hits", "misses", "size", "capacity", "bytes",
                      "evictions"):
                if k in st:
                    name = f"caption_cache_{tier}_{k}"
                    self._header(lines, name, "caption_cache_*", "gauge")
                    lines.append(f"{name} {st[k]}")
        return "\n".join(lines) + "\n"
