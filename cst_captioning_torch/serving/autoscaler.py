"""Elastic replica autoscaler: the control loop that makes the fleet's
size follow traffic (own copy of the JAX package's stdlib-only
``serving/autoscaler.py``, driving the port's ``ReplicaSet``).

* **Replica add** = ``engine_factory()`` (the server passes
  ``serving/replicas.py::clone_replica``: ``clone_for_device`` onto
  ``cuda:(rid % cards)``, or for a model-sharded engine
  ``clone_for_submesh`` onto its ``rid``-th (1, M) device group, as the
  reference grows a grid; an
  artifact fleet may boot each replica with
  ``InferenceEngine.from_artifact``) +
  ``ReplicaSet.add_replica``: the new replica joins the router and its
  worker starts at once.  On one card the clones share the parameter
  tensors and each has its own CUDA stream.
* **Replica remove** = ``ReplicaSet.kill_replica``: the victim drains
  from routing and its queued and in-flight work requeues onto
  survivors, bounded by the original deadlines, so a scale-down loses
  no accepted request.
* Slot-bank resizes stay with each worker's ``SlotDecoder.maybe_resize``.

Signals (:class:`Signals`, read from the live ``ReplicaSet`` and its
``ServingMetrics``): queued work across healthy replicas, slot
occupancy, the healthy-replica count, the cumulative shed count and the
``admission`` latency histogram's p99.  **Decisions are a deterministic
function of the observed signal window**: the policy
(:meth:`Autoscaler.observe`) holds only the window and a cooldown
counter, so the virtual-time soak (``serving/chaos.py::run_soak``)
replays a recorded trace into the same decision log
(``decision_log()``).  The wall-clock p99 signal is off by default
(``scale_up_wait_p99_ms = 0``) so that virtual-time replays stay
deterministic.

Hysteresis: scale-up and scale-down use different thresholds (queue
pressure vs low occupancy), scale-down also needs a full quiet window,
and every applied action arms a shared cooldown.  The healthy count
never leaves ``[min_replicas, max_replicas]``.

Every applied decision lands as an ``autoscale`` flight event on the
scheduler ring and on the ``caption_autoscale_*`` metric families; with
the default empty ``serving.autoscale`` no autoscaler is built and the
fleet is statically sized.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

_log = logging.getLogger("cst_captioning_torch.serving")

_KNOWN_KEYS = {
    "min_replicas", "max_replicas", "window_ticks",
    "scale_up_queue_depth", "scale_up_shed", "scale_up_wait_p99_ms",
    "scale_down_occupancy", "cooldown_ticks", "interval_s",
}


class Signals(NamedTuple):
    """One observation of the fleet (one autoscaler tick)."""

    queued: int            # requests across healthy replica queues
    occupied: int          # occupied decode slots across healthy
    slots: int             # total slots across healthy (current banks)
    healthy: int           # healthy replica count
    shed: int              # CUMULATIVE shed count (all priorities)
    queue_wait_p99_ms: float  # admission-stage p99 (0 when unused)


class Decision(NamedTuple):
    """One evaluated decision.  ``action``: "up" | "down" | "hold"."""

    action: str
    reason: str
    healthy: int
    target: int


@dataclass(frozen=True)
class AutoscaleConfig:
    """Validated ``serving.autoscale`` section (empty dict = no
    autoscaler, statically-sized fleet)."""

    min_replicas: int = 1
    max_replicas: int = 2
    # Signal window length in autoscaler ticks: scale-up triggers on the
    # window MEAN, scale-down needs the window FULL and quiet.
    window_ticks: int = 8
    # Scale UP when mean queued-per-healthy-replica >= this…
    scale_up_queue_depth: float = 4.0
    # …or when this many sheds landed inside the window (0 = off)…
    scale_up_shed: int = 1
    # …or when the admission (queue-wait) p99 exceeds this many ms
    # (0 = off — the default, which keeps virtual-time replays
    # deterministic: wall latencies are not replayable signals).
    scale_up_wait_p99_ms: float = 0.0
    # Scale DOWN when occupancy/slots stayed <= this for a FULL window
    # with zero queued work throughout.
    scale_down_occupancy: float = 0.25
    # Ticks both directions stay quiet after any applied action.
    cooldown_ticks: int = 16
    # Live-loop sampling period (the thread the server runs; the
    # virtual-time soak steps the policy once per soak tick instead).
    interval_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale.min_replicas {self.min_replicas} < 1"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale.max_replicas {self.max_replicas} < "
                f"min_replicas {self.min_replicas}"
            )
        if self.window_ticks < 1:
            raise ValueError(
                f"autoscale.window_ticks {self.window_ticks} < 1"
            )
        if self.cooldown_ticks < 0:
            raise ValueError(
                f"autoscale.cooldown_ticks {self.cooldown_ticks} < 0"
            )

    @classmethod
    def from_config(cls, serving_cfg: Any) -> Optional["AutoscaleConfig"]:
        """Build from ``cfg.serving.autoscale`` — ``None`` (autoscaling
        fully off, statically-sized fleet) when the dict is empty or
        absent."""
        raw = getattr(serving_cfg, "autoscale", None)
        if not raw:
            return None
        if not isinstance(raw, dict):
            raise ValueError(
                f"serving.autoscale must be a dict, got "
                f"{type(raw).__name__}"
            )
        unknown = set(raw) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown serving.autoscale key(s) {sorted(unknown)}; "
                f"have: {sorted(_KNOWN_KEYS)}"
            )
        return cls(**raw)


class Autoscaler:
    """See module doc.  ``engine_factory`` produces the engine for each
    scale-up (``InferenceEngine.from_artifact`` for artifact fleets: a
    boot runs no ``nvcc`` and walks the ladder once; or
    ``clone_for_device``, as the server passes); scale-down always
    drains the HIGHEST-numbered healthy replica (deterministic victim
    choice, and the most recently added replica goes first)."""

    # Single-owner contract: the policy state
    # (window, cooldown, log) is driven by exactly one thread — the
    # control-loop thread in live mode, or the single-threaded soak
    # harness in virtual time.  start()/stop() hand ownership over via
    # the Event + join, never concurrently with step().
    _analysis_single_owner = True

    def __init__(
        self,
        cfg: AutoscaleConfig,
        engine_factory: Callable[[], Any],
    ):
        self.cfg = cfg
        self.engine_factory = engine_factory
        self._window: deque = deque(maxlen=cfg.window_ticks)
        self._cooldown = 0
        self._tick = 0
        self._last_shed = 0
        # Applied-action log: (tick, action, reason, healthy_before,
        # healthy_after) — the byte-identical replay record.
        self._log: List[Tuple[int, str, str, int, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ signals
    @staticmethod
    def read_signals(rs) -> Signals:
        """Snapshot the fleet's scaling signals from the live
        ``ReplicaSet`` + its metrics (under the set's lock, so queue
        depths and occupancy are one consistent cut)."""
        with rs._cond:
            healthy = [r for r in rs.replicas if r.healthy]
            queued = sum(len(r.q) for r in healthy)
            occupied = sum(r.decoder.n_occupied for r in healthy)
            slots = sum(r.decoder.S for r in healthy)
        shed = sum(c.value for c in rs.metrics.shed_total.values())
        return Signals(
            queued=queued,
            occupied=occupied,
            slots=slots,
            healthy=len(healthy),
            shed=shed,
            queue_wait_p99_ms=rs.metrics.stages["admission"].percentile(99),
        )

    # ------------------------------------------------------------- policy
    def observe(self, sig: Signals) -> Decision:
        """Fold one observation into the window and decide.  Pure in
        the signal sequence: same Signals stream in => same Decision
        stream out (the determinism contract the replay tests pin)."""
        c = self.cfg
        self._tick += 1
        shed_delta = max(0, sig.shed - self._last_shed)
        self._last_shed = sig.shed
        self._window.append(
            sig._replace(shed=shed_delta)
        )
        if self._cooldown > 0:
            self._cooldown -= 1
            return Decision("hold", "cooldown", sig.healthy, sig.healthy)
        n = len(self._window)
        mean_q = sum(
            s.queued / max(1, s.healthy) for s in self._window
        ) / n
        window_shed = sum(s.shed for s in self._window)
        if sig.healthy < c.min_replicas:
            return Decision(
                "up", "below_min", sig.healthy, sig.healthy + 1
            )
        up_reason = None
        if mean_q >= c.scale_up_queue_depth:
            up_reason = "queue_depth"
        elif c.scale_up_shed > 0 and window_shed >= c.scale_up_shed:
            up_reason = "shed"
        elif (
            c.scale_up_wait_p99_ms > 0
            and sig.queue_wait_p99_ms >= c.scale_up_wait_p99_ms
        ):
            up_reason = "queue_wait_p99"
        if up_reason is not None:
            if sig.healthy >= c.max_replicas:
                return Decision(
                    "hold", f"{up_reason}:at_max", sig.healthy,
                    sig.healthy,
                )
            return Decision(
                "up", up_reason, sig.healthy, sig.healthy + 1
            )
        quiet = n == c.window_ticks and all(
            s.queued == 0
            and s.occupied <= c.scale_down_occupancy * max(1, s.slots)
            for s in self._window
        )
        if quiet and sig.healthy > c.min_replicas:
            return Decision(
                "down", "idle_window", sig.healthy, sig.healthy - 1
            )
        return Decision("hold", "steady", sig.healthy, sig.healthy)

    # -------------------------------------------------------------- apply
    def step(self, rs, drain_inline: bool = False) -> Decision:
        """One control-loop iteration: read signals, decide, apply.
        ``drain_inline=True`` is the virtual-time mode (no worker
        threads — the harness runs the drain path itself, exactly
        like the chaos ``replica_kill`` site)."""
        sig = self.read_signals(rs)
        d = self.observe(sig)
        rs.metrics.autoscale_decisions.inc()
        rs.metrics.autoscale_target.set(d.target)
        if d.action == "hold":
            return d
        if d.action == "up":
            engine = self.engine_factory()
            rid = rs.add_replica(engine)
            rs.metrics.autoscale_ups.inc()
        else:
            victims = [r.rid for r in rs.replicas if r.healthy]
            rid = max(victims)
            rs.kill_replica(rid)
            if drain_inline:
                rs._drain_replica(
                    rs.replicas[rid], "autoscale scale-down"
                )
            rs.metrics.autoscale_downs.inc()
        self._cooldown = self.cfg.cooldown_ticks
        self._window.clear()
        self._log.append(
            (self._tick, d.action, d.reason, d.healthy, d.target)
        )
        rs.flight.event(
            "autoscale",
            action=d.action, reason=d.reason, replica=rid,
            frm=d.healthy, to=d.target,
        )
        _log.info(
            "autoscale %s (%s): replicas %d -> %d (replica %d)",
            d.action, d.reason, d.healthy, d.target, rid,
        )
        return d

    def decision_log(self) -> List[Tuple[int, str, str, int, int]]:
        """Applied actions as ``(tick, action, reason, from, to)`` —
        compared byte-for-byte across virtual-time replays."""
        return list(self._log)

    # ---------------------------------------------------------- live loop
    def start(self, rs) -> "Autoscaler":
        """Run the control loop on a daemon thread against a STARTED
        ``ReplicaSet``, sampling every ``interval_s`` (the
        CaptionServer wiring).  Idempotent."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            # Exception-contained: a dead control loop
            # must surface in the log, and a scaling failure (e.g. an
            # clone failing to boot) must not kill the fleet.
            try:
                while not self._stop.wait(self.cfg.interval_s):
                    try:
                        self.step(rs)
                    except Exception:  # noqa: BLE001 — keep looping
                        _log.exception("autoscaler step failed")
            except Exception:  # noqa: BLE001 — loop death is loud
                _log.exception("autoscaler loop died")

        self._thread = threading.Thread(
            target=_loop, name="caption-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def describe(self) -> Dict[str, Any]:
        return {
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "window_ticks": self.cfg.window_ticks,
            "cooldown_ticks": self.cfg.cooldown_ticks,
            "decisions": len(self._log),
        }
