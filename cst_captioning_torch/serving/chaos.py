"""Deterministic fault injection and the recorded-trace chaos soak for
the serving fleet (own copy of the JAX package's ``serving/chaos.py``,
which is stdlib-only; the soak drives the port's ``ReplicaSet``).

Three parts:

* :data:`FAULT_SITES`: the injection-point catalogue.  Every
  ``chaos.fire("<site>")`` call in the port's ``serving/`` names a
  registered site, sits behind an ``is not None`` guard so that chaos
  off costs nothing, and runs on the host only (``tests/
  test_torch_chaos.py`` checks the three statically, and :meth:`fire`
  refuses an unregistered site at run time).
* :class:`ChaosEngine`: the seeded decision oracle.  Serving code asks
  it at registered sites; it answers from a declarative schedule
  (``serving.chaos``).  The same seed, schedule and call sequence give
  the same fault schedule, byte for byte.  Off by default: the
  ``serving.chaos`` dict defaults empty, ``from_config`` returns
  ``None``, and every site is guarded, so the default serving path is
  the chaos-free one.
* :func:`run_soak`: the recorded-request replay: a virtual-time
  (tick-driven, single-threaded) drive of a real, unstarted
  :class:`~cst_captioning_torch.serving.replicas.ReplicaSet`'s routing,
  admission, shedding, requeue and resolve machinery against a recorded
  arrival trace (:func:`make_diurnal_trace` synthesizes diurnal-burst
  traces), with faults applied at tick boundaries.  Single-threaded,
  every per-request decision (shed, requeue, expiry, serving replica) is
  a function of (trace, seed), so two replays give the same decision
  log exactly.

Stdlib-only: chaos is a host-side decision layer and never touches
device state.
"""

from __future__ import annotations

import math
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# The injection-point catalogue.  Every entry names a fault the serving
# stack can absorb, the module(s) that host its ``fire`` call sites, and
# what a truthy decision means there.  tests/test_torch_chaos.py holds
# that (a) every ``chaos.fire`` literal in the port's serving/ matches an
# entry, (b) every entry has a live call site in the modules it names,
# and (c) every call site is guarded by ``chaos is not None``.
FAULT_SITES: List[Tuple[str, str, str]] = [
    ("replica_kill", "serving/replicas.py",
     "kill this replica at the tick boundary: the worker raises its "
     "death path, the replica drains from routing, queued + in-flight "
     "work requeues onto survivors bounded by original deadlines"),
    ("tick_stall", "serving/batcher.py, serving/replicas.py",
     "stall the scheduler for the returned number of seconds before the "
     "tick dispatch (a slow/hung device step; in the virtual-time soak "
     "the value converts to skipped ticks)"),
    ("queue_burst", "serving/batcher.py, serving/replicas.py",
     "inflate the queue-pressure signal fed to the elastic slot-bank "
     "resize by the returned count (a synthetic admission burst at a "
     "grow boundary)"),
    ("cache_miss", "serving/batcher.py",
     "force this request to miss BOTH cache tiers (tier-1 caption hit "
     "suppressed, tier-2 encoder row dropped) — a cache-hostile key "
     "storm; token-exactness is unaffected, the request just pays the "
     "full decode"),
    ("deadline_skew", "serving/batcher.py",
     "clamp this arriving request's deadline to the returned number of "
     "seconds from now (deadline-adjacent arrivals that expire in the "
     "queue or at admission)"),
]

_SITE_NAMES = {name for name, _, _ in FAULT_SITES}

_TRIGGER_KEYS = ("at", "every", "p")


def _uniform(seed: int, site: str, replica: Any, n: int) -> float:
    """Deterministic uniform [0, 1) for probabilistic schedule entries —
    crc32-keyed so it never depends on ``PYTHONHASHSEED`` or call-order
    across sites."""
    h = zlib.crc32(f"{seed}|{site}|{replica}|{n}".encode())
    return (h & 0xFFFFFFFF) / 4294967296.0


@dataclass(frozen=True)
class _Entry:
    """One validated schedule entry."""

    site: str
    at: Optional[int] = None       # fire when the site counter == at
    every: Optional[int] = None    # fire when counter % every == 0 (>0)
    p: Optional[float] = None      # fire with seeded probability p
    replica: Optional[int] = None  # only at this replica id (None = any)
    value: Any = True              # what fire() returns on a hit


class ChaosEngine:
    """Seeded, schedule-driven fault oracle (see module doc).

    ``fire(site, replica=...)`` advances a per-``(site, replica)``
    counter and answers the first matching schedule entry's value (falsy
    when nothing matches).  Counters index ACTIVE scheduler events —
    tick iterations for tick sites, arriving requests for admission
    sites — so a schedule reads as "kill replica 0 at its 6th tick",
    "stall every 4th tick for 50 ms", "skew the deadline of the 3rd
    arrival".  Every hit is appended to :attr:`log` (the decision record
    the determinism test compares byte-for-byte across replays).

    Thread-safe: live schedulers fire from worker AND submit threads.
    Per-key counter sequences are deterministic whenever each key is
    owned by one thread (replica-keyed sites under the threaded
    schedulers) or everything runs single-threaded (the soak replay —
    where full cross-site determinism is pinned).
    """

    def __init__(self, seed: int = 0, schedule: Sequence[Dict[str, Any]] = ()):
        self.seed = int(seed)
        self._entries: List[_Entry] = []
        for i, raw in enumerate(schedule):
            self._entries.append(self._validate(i, raw))
        self._by_site: Dict[str, List[_Entry]] = {}
        for e in self._entries:
            self._by_site.setdefault(e.site, []).append(e)
        self._counters: Dict[Tuple[str, Any], int] = {}
        self._lock = threading.Lock()
        # The decision record: (site, replica, counter, value) per hit.
        self.log: List[Tuple[str, Any, int, Any]] = []

    @staticmethod
    def _validate(i: int, raw: Any) -> _Entry:
        where = f"serving.chaos.schedule[{i}]"
        if not isinstance(raw, dict):
            raise ValueError(f"{where} must be an object, got {raw!r}")
        site = raw.get("site")
        if site not in _SITE_NAMES:
            raise ValueError(
                f"{where}.site {site!r} is not registered in "
                f"serving/chaos.py::FAULT_SITES (have {sorted(_SITE_NAMES)})"
            )
        triggers = [k for k in _TRIGGER_KEYS if raw.get(k) is not None]
        if len(triggers) != 1:
            raise ValueError(
                f"{where} must set exactly one of {_TRIGGER_KEYS}, "
                f"got {triggers}"
            )
        at = raw.get("at")
        every = raw.get("every")
        p = raw.get("p")
        if at is not None and (isinstance(at, bool) or not isinstance(at, int) or at < 0):
            raise ValueError(f"{where}.at must be a non-negative int")
        if every is not None and (
            isinstance(every, bool) or not isinstance(every, int) or every < 1
        ):
            raise ValueError(f"{where}.every must be a positive int")
        if p is not None and not (
            isinstance(p, (int, float)) and not isinstance(p, bool)
            and 0.0 <= p <= 1.0
        ):
            raise ValueError(f"{where}.p must be a probability in [0, 1]")
        rep = raw.get("replica")
        if rep is not None and (isinstance(rep, bool) or not isinstance(rep, int)):
            raise ValueError(f"{where}.replica must be an int replica id")
        return _Entry(
            site=site, at=at, every=every, p=p, replica=rep,
            value=raw.get("value", True),
        )

    @classmethod
    def from_config(cls, serving_cfg: Any) -> Optional["ChaosEngine"]:
        """Build from ``cfg.serving.chaos`` — ``None`` (chaos fully off,
        zero overhead, byte-identical serving) when the dict is empty or
        absent.  Keys: ``seed`` (int), ``schedule`` (list of entries,
        see :meth:`fire`)."""
        raw = getattr(serving_cfg, "chaos", None)
        if not raw:
            return None
        if not isinstance(raw, dict):
            raise ValueError(
                f"serving.chaos must be a dict, got {type(raw).__name__}"
            )
        unknown = set(raw) - {"seed", "schedule"}
        if unknown:
            raise ValueError(
                f"unknown serving.chaos key(s) {sorted(unknown)}; "
                "have: seed, schedule"
            )
        return cls(
            seed=int(raw.get("seed", 0)),
            schedule=raw.get("schedule", ()),
        )

    # ------------------------------------------------------------- firing
    def fire(self, site: str, replica: Optional[int] = None) -> Any:
        """Ask whether the fault at ``site`` (for ``replica``, when the
        site is replica-scoped) fires at this event.  Returns the
        matching entry's ``value`` (truthy) or ``False``.  Unregistered
        sites raise (the run-time twin of the static check)."""
        if site not in _SITE_NAMES:
            raise ValueError(
                f"chaos site {site!r} is not registered in "
                "serving/chaos.py::FAULT_SITES — register it before "
                "injecting"
            )
        with self._lock:
            key = (site, replica)
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
            for e in self._by_site.get(site, ()):
                if e.replica is not None and e.replica != replica:
                    continue
                hit = (
                    (e.at is not None and n == e.at)
                    or (e.every is not None and n > 0 and n % e.every == 0)
                    or (e.p is not None
                        and _uniform(self.seed, site, replica, n) < e.p)
                )
                if hit:
                    self.log.append((site, replica, n, e.value))
                    return e.value
            return False

    @property
    def fired(self) -> int:
        with self._lock:
            return len(self.log)

    def decision_log(self) -> List[Tuple[str, Any, int, Any]]:
        with self._lock:
            return list(self.log)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "entries": len(self._entries),
                "fired": len(self.log),
                "sites": sorted({e.site for e in self._entries}),
            }


# --------------------------------------------------------------------------
# Recorded-request traces.


@dataclass(frozen=True)
class RecordedRequest:
    """One recorded arrival: virtual arrival tick, feature-pool key,
    priority class, and the wall deadline it carried (the trace
    fields an operator would capture: arrival time + feature id + beam
    config, with the beam config implied by the serving preset)."""

    rid: int
    t_tick: int
    key: int
    priority: str = "interactive"
    deadline_ms: float = 120_000.0


def make_diurnal_trace(
    seed: int,
    n_requests: int,
    n_keys: int,
    *,
    base_per_tick: float = 0.5,
    burst_factor: float = 4.0,
    period_ticks: int = 64,
    priority_mix: Sequence[Tuple[str, float]] = (
        ("interactive", 0.5), ("batch", 0.25), ("best_effort", 0.25),
    ),
    deadline_ms: float = 120_000.0,
) -> List[RecordedRequest]:
    """Synthesize a deterministic diurnal-burst arrival trace: the
    offered rate swings sinusoidally between ``base_per_tick`` and
    ``base_per_tick * burst_factor`` requests/tick over ``period_ticks``
    — the "millions of users don't arrive Poisson-uniform" shape the
    ROADMAP's rehearsal item names.  Same seed => byte-identical
    trace."""
    rng = random.Random(seed)
    names = [p for p, _ in priority_mix]
    weights = [w for _, w in priority_mix]
    out: List[RecordedRequest] = []
    tick = 0
    acc = 0.0
    while len(out) < n_requests:
        swing = 0.5 * (1.0 + math.sin(2.0 * math.pi * tick / period_ticks))
        rate = base_per_tick * (1.0 + (burst_factor - 1.0) * swing)
        acc += rate
        k = int(acc)
        acc -= k
        for _ in range(k):
            if len(out) >= n_requests:
                break
            out.append(RecordedRequest(
                rid=len(out),
                t_tick=tick,
                key=rng.randrange(n_keys),
                priority=rng.choices(names, weights=weights)[0],
                deadline_ms=deadline_ms,
            ))
        tick += 1
    return out


# --------------------------------------------------------------------------
# The replay/soak harness.


@dataclass
class SoakReport:
    """Outcome of one :func:`run_soak` replay."""

    outcomes: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    decisions: List[Tuple] = field(default_factory=list)
    chaos_log: List[Tuple] = field(default_factory=list)
    ticks: int = 0
    kills: int = 0
    stall_ticks: int = 0
    completed: bool = False

    def count(self, outcome: str) -> int:
        return sum(
            1 for o in self.outcomes.values() if o["outcome"] == outcome
        )

    @property
    def served(self) -> int:
        return self.count("served") + self.count("served_cached")

    @property
    def lost(self) -> int:
        """Requests that never reached a terminal outcome — the
        zero-loss acceptance bar."""
        return sum(
            1 for o in self.outcomes.values() if o["outcome"] == "lost"
        )

    def attainment(self, slo_ticks: int) -> Dict[str, float]:
        """Fraction of requests that completed within ``slo_ticks`` of
        arrival, per priority class plus ``overall``.  Shed / expired /
        failed requests count as missed."""
        tot: Dict[str, int] = {}
        ok: Dict[str, int] = {}
        for o in self.outcomes.values():
            p = o["priority"]
            tot[p] = tot.get(p, 0) + 1
            attained = (
                o["outcome"] in ("served", "served_cached")
                and (o["done_tick"] - o["arrival_tick"]) <= slo_ticks
            )
            ok[p] = ok.get(p, 0) + (1 if attained else 0)
        out = {
            p: (ok.get(p, 0) / tot[p]) if tot[p] else 0.0 for p in tot
        }
        n = sum(tot.values())
        out["overall"] = (sum(ok.values()) / n) if n else 0.0
        return out


def _classify(exc: BaseException) -> str:
    from cst_captioning_torch.serving.batcher import (
        BackpressureError,
        DeadlineExceededError,
        ShuttingDownError,
    )

    if isinstance(exc, BackpressureError):
        return "shed"
    if isinstance(exc, DeadlineExceededError):
        return "expired"
    if isinstance(exc, ShuttingDownError):
        return "rejected"
    return f"failed:{type(exc).__name__}"


def run_soak(
    rs: Any,
    payloads: Sequence[Dict[str, Any]],
    trace: Sequence[RecordedRequest],
    *,
    chaos: Optional[ChaosEngine] = None,
    autoscaler: Any = None,
    stall_tick_s: float = 0.01,
    max_ticks: int = 20_000,
) -> SoakReport:
    """Replay ``trace`` against an (UNSTARTED) ``ReplicaSet`` in virtual
    time — see the module doc for why single-threaded: it makes every
    shed / requeue / expiry / routing decision a pure function of
    (trace, chaos seed), which is the determinism contract the replay
    test pins.

    Per tick: (0) one autoscaler control-loop step when an
    ``autoscaler`` (serving/autoscaler.py) is passed — scale-ups add
    replicas through the real ``add_replica`` router admission,
    scale-downs run the real kill/drain/requeue path inline (the
    single-threaded twin of the worker's death path), so autoscaling
    decisions are replay-deterministic exactly like the chaos schedule;
    (1) chaos ``replica_kill`` / ``tick_stall`` decisions per
    healthy replica, (2) due arrivals submitted through the real
    admission path (``submit_async`` — priorities, shedding, Retry-After
    and deadline bookkeeping all live), (3) one scheduler iteration per
    healthy un-stalled replica (admission pop with hedge-cancel skip,
    deadline expiry, decoder tick, harvest + resolve through the real
    ``_resolve``).  ``tick_stall`` values (seconds) convert to skipped
    ticks via ``stall_tick_s``.
    """
    report = SoakReport()
    if chaos is not None:
        # One engine for the WHOLE stack: the harness drives the
        # tick-boundary sites itself, while the admission-path sites
        # (cache_miss, deadline_skew) fire inside the batcher's own
        # submit_async — same oracle, one decision log.
        rs.chaos = chaos
    clock = {"t": 0}
    arrivals = sorted(trace, key=lambda r: (r.t_tick, r.rid))
    unresolved: Dict[int, Any] = {}
    stalled = {rep.rid: 0 for rep in rs.replicas}

    def _settle(rid: int, outcome: str, arrival: int, **extra: Any) -> None:
        report.outcomes[rid] = {
            "outcome": outcome,
            "priority": extra.pop("priority"),
            "arrival_tick": arrival,
            "done_tick": clock["t"],
            **extra,
        }
        report.decisions.append(
            (rid, outcome, arrival, clock["t"],
             extra.get("replica"), extra.get("requeues"))
        )
        unresolved.pop(rid, None)

    def _callback(req: RecordedRequest, pending: Any):
        def cb(fut) -> None:
            exc = fut.exception()
            if exc is None:
                res = fut.result()
                _settle(
                    req.rid, "served", req.t_tick,
                    priority=req.priority,
                    replica=res.get("replica"),
                    requeues=pending.requeues,
                )
            else:
                _settle(
                    req.rid, _classify(exc), req.t_tick,
                    priority=req.priority,
                    replica=pending.rid,
                    requeues=pending.requeues,
                )
        return cb

    def _step_replica(rep: Any) -> None:
        decoder = rep.decoder
        admits: List[Any] = []
        with rs._cond:
            burst = 0
            if chaos is not None:
                b = chaos.fire("queue_burst", replica=rep.rid)
                if b:
                    burst = int(b)
                    rs.metrics.chaos_faults.inc()
                    rep.flight.event("chaos_fault", site="queue_burst",
                                     burst=burst)
            decoder.maybe_resize(len(rep.q) + burst)
            cap = min(
                len(decoder.free), min(decoder.admit_cap, decoder.S)
            )
            while rep.q and len(admits) < cap:
                p = rep.q.popleft()
                if p.future.done():
                    rs.metrics.hedge_cancelled.inc()
                    continue
                admits.append(p)
        now = time.monotonic()
        live = []
        for p in admits:
            if now > p.deadline:
                rs._expire(p, now, flight=rep.flight)
            else:
                live.append(p)
        handle = decoder.tick_begin([p.prepared for p in live], live)
        t_admit = time.monotonic()
        for p in live:
            p.t_admit = t_admit
        if handle is None:
            return
        done = decoder.tick_wait(handle)
        if done:
            rs._resolve(
                rep, rs.metrics.replica(rep.rid),
                decoder.harvest_from(handle, done),
            )

    i = 0
    for tick in range(max_ticks):
        clock["t"] = tick
        report.ticks = tick + 1
        # (0) autoscaler control-loop step (scale-downs drain inline —
        # there are no worker threads in virtual time)
        if autoscaler is not None:
            autoscaler.step(rs, drain_inline=True)
        # (1) chaos at the tick boundary (replicas the autoscaler just
        # added get a stall counter on first sight)
        for rep in rs.replicas:
            stalled.setdefault(rep.rid, 0)
            if not rep.healthy:
                continue
            if chaos is not None:
                if chaos.fire("replica_kill", replica=rep.rid):
                    rs.metrics.chaos_faults.inc()
                    rep.flight.event("chaos_fault", site="replica_kill")
                    report.kills += 1
                    rs.kill_replica(rep.rid)
                    rs._drain_replica(rep, "chaos replica_kill")
                    continue
                st = chaos.fire("tick_stall", replica=rep.rid)
                if st:
                    rs.metrics.chaos_faults.inc()
                    rep.flight.event(
                        "chaos_fault", site="tick_stall",
                        stall_s=float(st),
                    )
                    stalled[rep.rid] += max(
                        1, int(round(float(st) / stall_tick_s))
                    )
        # (2) due arrivals through the real admission path
        while i < len(arrivals) and arrivals[i].t_tick <= tick:
            req = arrivals[i]
            i += 1
            try:
                out = rs.submit_async(
                    dict(payloads[req.key]),
                    deadline_ms=req.deadline_ms,
                    priority=req.priority,
                )
            except Exception as e:  # noqa: BLE001 — classified outcome
                _settle(
                    req.rid, _classify(e), req.t_tick,
                    priority=req.priority, replica=None, requeues=0,
                )
                continue
            if isinstance(out, dict):
                _settle(
                    req.rid, "served_cached", req.t_tick,
                    priority=req.priority, replica=None, requeues=0,
                )
                continue
            unresolved[req.rid] = out
            out.future.add_done_callback(_callback(req, out))
        # (3) one scheduler iteration per healthy, un-stalled replica
        for rep in rs.replicas:
            if not rep.healthy:
                continue
            if stalled[rep.rid] > 0:
                stalled[rep.rid] -= 1
                report.stall_ticks += 1
                continue
            _step_replica(rep)
        if i >= len(arrivals) and not unresolved:
            report.completed = True
            break
    # Anything still pending at the tick cap is LOST — the exact failure
    # the zero-loss bar exists to catch.
    for rid, p in list(unresolved.items()):
        report.outcomes[rid] = {
            "outcome": "lost",
            "priority": "unknown",
            "arrival_tick": -1,
            "done_tick": clock["t"],
        }
        report.decisions.append((rid, "lost", -1, clock["t"], None, None))
    if chaos is not None:
        report.chaos_log = chaos.decision_log()
    return report
