"""Multi-replica data-parallel serving: N warm engines behind one door
(port of the JAX package's ``serving/replicas.py``).

* :class:`ReplicaSet`: the multi-replica scheduler, a drop-in batcher
  for ``CaptionServer``.  It holds one :class:`Replica` per engine
  (``InferenceEngine.clone_for_device``: the same weights, shared on the
  source engine's device and copied once to any other, the shared
  two-tier cache, so encoder rows any replica stored admit on every
  other with no encode, its own ``SlotDecoder`` and CUDA stream) and
  runs one worker thread per replica.  :meth:`ReplicaSet.from_engine`
  places replica i on
  ``cuda:(i % device_count)`` (or on the engine's own device, e.g. the
  CPU in tests); ``serving.replicas = 0`` means one replica per local
  card, and more replicas than cards wrap round-robin onto the same
  cards.
* :class:`Router`: in front of the per-replica queues.
  ``least_loaded`` routes each accepted request to the replica with the
  most free capacity (free slots less queued work), ties broken round
  robin; ``round_robin`` ignores load.  Routing happens at accept time
  under the shared lock, so a request is assigned to one replica.
* **Double-buffered dispatch** (``serving.double_buffer``): each worker
  dispatches tick t+1 (``SlotDecoder.tick_begin``) before it waits on
  tick t (``tick_wait`` + ``harvest_from``), so the host work of tick t
  (harvest, detokenize, cache, admission) overlaps the device's work on
  tick t+1.  The synchronous loop pays host work and device step in
  series.  A finished slot rides the extra tick frozen (PAD-only), so
  buffering cannot change a caption.  Two replicas' threads share the
  interpreter lock: buffering overlaps host work with device work, not
  two replicas' host work with each other.
* **Replica failure**: a worker whose tick raises marks its replica
  unhealthy, drains it from routing and requeues its queued and
  in-flight requests onto survivors, bounded by each request's original
  deadline (an expired one is shed with ``DeadlineExceededError``, never
  served late) and by ``serving.requeue_budget`` (a request already
  requeued that many times fails outright).  Requeued work restarts from
  step 0 on the survivor; the per-step math is row-independent, so the
  caption is the same.  ``kill_replica`` is the operational handle for
  the same path.  With no healthy replica, ``submit`` raises
  :class:`NoHealthyReplicasError` (503) and ``/healthz`` degrades.
* **Hedging** (``serving.hedge_ms``): a submitter whose request has no
  result after ``max(hedge_ms, p99 of the total latency)`` enqueues a
  duplicate onto a second healthy replica.  The first result settles
  the future; the loser is dropped at admission if still queued, or its
  harvest is discarded.  Every replica computes the same rows, so
  hedging can change which replica answers, never the tokens.
* **Priorities** ride the shared batcher machinery
  (``serving/batcher.py``): under overload an arrival sheds the lowest
  queued class below its own across every replica's queue.

Each replica keeps a flight recorder (``observability/flight.py``) of
its ticks and lifecycle, dumped to ``serving.flight_dir`` on worker
death, ``kill_replica``, the drain deadline and a completed drain.

Fault injection (``serving.chaos``, ``serving/chaos.py``): each worker
asks the shared ``ChaosEngine`` at the sites ``replica_kill`` (the
replica dies through the real death path: ``_ReplicaDied``, then
``_drain_replica`` requeues its queued and in-flight work onto
survivors), ``queue_burst`` and ``tick_stall``, keyed by its replica id;
every site is guarded by ``self.chaos is not None``.  The virtual-time
soak (``chaos.run_soak``) drives the same machinery single-threaded, and
the autoscaler (``serving/autoscaler.py``) grows the set through
:meth:`ReplicaSet.add_replica` and shrinks it through
:meth:`ReplicaSet.kill_replica`.

Model-sharded replicas (``serving.model_shards`` M > 1): the set is an
(R, M) grid, each replica an engine on its own (1, M) device group
(:meth:`ReplicaSet.from_engine`, :func:`clone_replica`); its worker
thread drives M devices on the replica's stream.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Deque, List, Optional, Sequence

import torch

from cst_captioning_torch.observability.flight import flight_recorder
from cst_captioning_torch.parallel.mesh import submesh_groups
from cst_captioning_torch.serving.batcher import (
    PRIORITY_RANK,
    BackpressureError,
    ShuttingDownError,
    _BatcherBase,
    _Pending,
    _settle_exception,
)
from cst_captioning_torch.serving.metrics import ServingMetrics
from cst_captioning_torch.serving.slots import AdmissionError

_log = logging.getLogger("cst_captioning_torch.serving")

ROUTER_POLICIES = ("least_loaded", "round_robin")


def clone_replica(engine, rid: int):
    """The engine of a new replica ``rid`` (the autoscaler's scale-up):
    a model-sharded engine's clone on the ``rid``-th (1, M) group of its
    device list, round-robin; otherwise a ``clone_for_device`` onto card
    ``rid % cards`` (or the engine's own device off the card)."""
    tp = getattr(engine, "tp_mesh", None)
    M = tp.shape.get("model", 1) if tp is not None else 1
    if M > 1:
        groups = submesh_groups(engine.grid_devices, M)
        return engine.clone_for_submesh(groups[rid % len(groups)],
                                        replica_id=rid)
    dev = torch.device(engine.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rid % torch.cuda.device_count())
    return engine.clone_for_device(dev, replica_id=rid)

class NoHealthyReplicasError(ShuttingDownError):
    """Every replica is unhealthy — the server cannot serve (503)."""


class _ReplicaDied(Exception):
    """Raised inside a worker loop when its replica was marked unhealthy
    (``kill_replica``)."""


class Router:
    """Replica selection policy; ``pick`` is called under the replica
    set's lock with the healthy candidates."""

    def __init__(self, policy: str = "least_loaded"):
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r}; have {ROUTER_POLICIES}")
        self.policy = policy
        self._rr = 0

    def pick(self, replicas: Sequence["Replica"]) -> "Replica":
        """One of ``replicas`` (non-empty, all healthy)."""
        if not replicas:
            raise ValueError("router.pick with no candidates")
        if self.policy == "round_robin":
            r = replicas[self._rr % len(replicas)]
        else:
            best = max(r.free_capacity() for r in replicas)
            tied = [r for r in replicas if r.free_capacity() == best]
            r = tied[self._rr % len(tied)]
        self._rr += 1
        return r


class Replica:
    """One engine + slot decoder + admission queue + worker thread."""

    def __init__(self, rid: int, engine, tracer):
        self.rid = rid
        self.engine = engine
        self.decoder = engine.slot_decoder()
        self.q: Deque[_Pending] = deque()
        self.healthy = True
        self.thread: Optional[threading.Thread] = None
        # This replica's ticks and lifecycle, tagged with its id so a
        # dump also carries its recent spans.
        self.flight = flight_recorder(engine.cfg.serving, f"replica{rid}",
                                      tracer, tags={"replica": rid})

    def free_capacity(self) -> int:
        """Free slots net of queued work (may go negative: the router
        prefers the least oversubscribed replica)."""
        return self.decoder.S - self.decoder.n_occupied - len(self.q)


class ReplicaSet(_BatcherBase):
    """Multi-replica continuous-batching scheduler (see module doc).

    Built from engines (``ReplicaSet(engines, ...)``, each a distinct
    object with its own slot decoder) or from one loaded engine by
    :meth:`from_engine`.  ``engines[0]`` is the front engine for
    ``prepare`` and cache lookups (the replicas share the cache and the
    ``params_tag``)."""

    _thread_name = "caption-replicas"

    def __init__(self, engines: Sequence[Any],
                 metrics: Optional[ServingMetrics] = None, *,
                 router: Optional[str] = None,
                 double_buffer: Optional[bool] = None,
                 hedge_ms: Optional[float] = None,
                 requeue_budget: Optional[int] = None, **kw):
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        super().__init__(engines[0], metrics, **kw)
        sv = engines[0].cfg.serving
        self.router = Router(router if router is not None else sv.router)
        self.double_buffer = bool(sv.double_buffer if double_buffer is None
                                  else double_buffer)
        # Hedge threshold floor in ms (0 = off) and the requeue budget.
        self.hedge_ms = float(sv.hedge_ms if hedge_ms is None else hedge_ms)
        self.requeue_budget = int(sv.requeue_budget if requeue_budget is None
                                  else requeue_budget)
        self.replicas = [Replica(i, e, self.tracer)
                         for i, e in enumerate(engines)]
        self._threads: List[threading.Thread] = []
        for rep in self.replicas:
            self._init_gauges(rep.rid)
        self.metrics.slots_total.set(sum(r.decoder.S for r in self.replicas))

    def _init_gauges(self, rid: int) -> None:
        rm = self.metrics.replica(rid)
        rm.healthy.set(1)
        rm.slots_occupied.set(0)
        rm.queue_depth.set(0)

    @classmethod
    def from_engine(cls, engine, metrics: Optional[ServingMetrics] = None, *,
                    n_replicas: Optional[int] = None,
                    devices: Optional[Sequence[Any]] = None,
                    **kw) -> "ReplicaSet":
        """Clone ``engine`` into N replicas (``serving.replicas``; 0 = one
        per device of ``devices``).  ``devices`` defaults to every local
        card when the engine is on one, else the engine's own device.
        More replicas than devices wrap round-robin onto them (on one
        card the workers still overlap their host work).

        A model-sharded engine (``serving.model_shards`` M > 1) makes the
        (R, M) serving grid: ``devices`` (default the engine's own device
        list) sorted as ``make_mesh`` sorts them and cut into contiguous
        groups of M (``parallel/mesh.py::submesh_groups``), replica i a
        ``clone_for_submesh`` engine on group i; 0 = one sharded replica
        per group, and R groups must exist."""
        n = engine.cfg.serving.replicas if n_replicas is None else n_replicas
        tp = getattr(engine, "tp_mesh", None)
        M = tp.shape.get("model", 1) if tp is not None else 1
        if M > 1:
            devs = list(devices if devices is not None
                        else engine.grid_devices)
            groups = submesh_groups(devs, M)
            if int(n) <= 0:
                n = len(groups)
            if int(n) < 1 or int(n) > len(groups):
                raise ValueError(
                    f"serving grid replicas={n} x model_shards={M} needs "
                    f"{max(int(n), 0) * M} local devices, have {len(devs)} "
                    "— shrink an axis")
            return cls([engine.clone_for_submesh(groups[i], replica_id=i)
                        for i in range(int(n))], metrics, **kw)
        if devices is None:
            dev = torch.device(engine.device)
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
        devs = list(devices)
        if int(n) <= 0:
            n = len(devs)
        engines = [engine.clone_for_device(devs[i % len(devs)], replica_id=i)
                   for i in range(int(n))]
        return cls(engines, metrics, **kw)

    # ----------------------------------------------------------- lifecycle
    def _running(self) -> bool:
        return bool(self._threads)

    def _spawn(self, rep: Replica) -> threading.Thread:
        t = threading.Thread(target=self._worker, args=(rep,),
                             name=f"caption-replica-{rep.rid}", daemon=True)
        rep.thread = t
        return t

    def start(self) -> "ReplicaSet":
        if self._threads:
            return self
        self._stop = self._draining = self._drain_evented = False
        for rep in self.replicas:
            self._threads.append(self._spawn(rep))
            rep.thread.start()
        return self

    def flight_snapshot(self):
        """Live ``/debug/flight`` view: one ring per replica."""
        return {rep.flight.name: rep.flight.snapshot()
                for rep in self.replicas}

    def begin_drain(self) -> None:
        with self._cond:
            self._draining = True
            evented, self._drain_evented = self._drain_evented, True
            depths = [len(r.q) for r in self.replicas]
            self._cond.notify_all()
        if not evented:
            for rep, d in zip(self.replicas, depths):
                rep.flight.event("drain_start", queued=d)

    def stop(self, drain: bool = True) -> None:
        with self._cond:
            self._draining = True
            self._drain = drain
            self._stop = True
            threads = list(self._threads)
            evented, self._drain_evented = self._drain_evented, True
            depths = [len(r.q) for r in self.replicas]
            self._cond.notify_all()
        if not evented:
            for rep, d in zip(self.replicas, depths):
                rep.flight.event("drain_start", queued=d, drain=drain)
        # Join outside the lock: workers need _cond to drain out.
        for t in threads:
            t.join(timeout=self.drain_timeout_s + 60.0)
        # Fail anything still queued (drain off, deadline blown, or
        # worker death) so no submitter blocks.
        with self._cond:
            self._threads = []
            for rep in self.replicas:
                while rep.q:
                    _settle_exception(rep.q.popleft(),
                                      RuntimeError("replica set stopped"))
                self.metrics.replica(rep.rid).queue_depth.set(0)

    @property
    def healthy_replicas(self) -> int:
        return sum(1 for r in self.replicas if r.healthy)

    def kill_replica(self, rid: int) -> None:
        """Operational drain of one replica: mark it unhealthy and stop
        routing to it; its worker requeues its queued and in-flight
        requests onto survivors (deadline- and budget-bounded)."""
        self.replicas[rid].flight.event("kill")
        with self._cond:
            self.replicas[rid].healthy = False
            self._cond.notify_all()

    def add_replica(self, engine) -> int:
        """Admit a booted engine to the router as a new replica.  Replica
        ids only grow (dead replicas keep their place), so metric labels
        and flight-ring names stay stable; a running set starts its
        worker at once."""
        with self._cond:
            rid = len(self.replicas)
            engine.replica_id = rid
            rep = Replica(rid, engine, self.tracer)
            self.replicas.append(rep)
            self._init_gauges(rid)
            self.metrics.slots_total.set(
                sum(r.decoder.S for r in self.replicas if r.healthy))
            if self._threads:
                self._threads.append(self._spawn(rep))
                rep.thread.start()
            self._cond.notify_all()
        return rid

    # ------------------------------------------------------------- routing
    def _depth_locked(self) -> int:
        return sum(len(r.q) for r in self.replicas)

    def _shed_lower_priority(self, incoming: _Pending) -> bool:
        """Overload shed across every replica queue (under ``_cond``)."""
        victim, rep = self._lowest_below(
            ((p, r) for r in self.replicas for p in r.q),
            PRIORITY_RANK[incoming.priority])
        if victim is None:
            return False
        rep.q.remove(victim)
        self.metrics.replica(rep.rid).queue_depth.set(len(rep.q))
        self._shed_one(victim, self._depth_locked(), flight=rep.flight)
        return True

    def _enqueue(self, pending: _Pending) -> None:
        healthy = [r for r in self.replicas if r.healthy]
        if not healthy:
            raise NoHealthyReplicasError(
                "no healthy replicas",
                retry_after_s=self._retry_after_value(
                    self._depth_locked(), None))
        if (self._depth_locked() >= self.queue_depth
                and not self._shed_lower_priority(pending)):
            self.metrics.requests_rejected.inc()
            raise BackpressureError(self._retry_after_value(
                self._depth_locked(), self._jitter_key(pending)))
        rep = self.router.pick(healthy)
        pending.rid = rep.rid
        rep.q.append(pending)
        self.metrics.replica(rep.rid).queue_depth.set(len(rep.q))

    # ------------------------------------------------------------- hedging
    def _hedge_threshold_s(self) -> Optional[float]:
        """Hedge threshold in seconds, None with hedging off: ``hedge_ms``
        until the total-latency histogram holds 32 requests, then
        ``max(hedge_ms, its p99)``, so only slow requests hedge."""
        if self.hedge_ms <= 0:
            return None
        h = self.metrics.stages["total"]
        ms = self.hedge_ms
        if h.count >= 32:
            ms = max(ms, h.percentile(99))
        return ms / 1e3

    def _hedge(self, pending: _Pending) -> None:
        """Enqueue a duplicate of a slow request onto a second healthy
        replica (both copies share one future, settled once)."""
        with self._cond:
            if pending.future.done() or pending.hedged:
                return
            survivors = [r for r in self.replicas
                         if r.healthy and r.rid != pending.rid]
            if not survivors:
                return
            rep = self.router.pick(survivors)
            pending.hedged = True
            rep.q.append(pending)
            self.metrics.hedges_total.inc()
            self.metrics.replica(rep.rid).queue_depth.set(len(rep.q))
            self._cond.notify_all()
        rep.flight.event("hedge", frm=pending.rid, to=rep.rid)
        if pending.trace is not None:
            t = time.monotonic()
            self.tracer.record("hedge", t, t, trace_id=pending.trace[0],
                               parent_id=pending.trace[1],
                               tags={"from": pending.rid, "to": rep.rid})

    def _await(self, pending: _Pending, deadline_s: float):
        hedge_s = self._hedge_threshold_s()
        if hedge_s is None or hedge_s >= deadline_s:
            return super()._await(pending, deadline_s)
        try:
            return pending.future.result(timeout=hedge_s)
        except FutureTimeoutError:
            pass
        self._hedge(pending)
        remaining = pending.deadline - time.monotonic()
        return pending.future.result(timeout=max(remaining, 0.0) + 60.0)

    # ------------------------------------------------------------- workers
    def _worker(self, rep: Replica) -> None:
        try:
            self._worker_loop(rep)
        except _ReplicaDied:
            self._drain_replica(rep, f"replica {rep.rid} killed")
        except Exception as e:  # noqa: BLE001 — any worker death drains it
            _log.exception("replica %d worker died", rep.rid)
            rep.flight.event("worker_death", error=f"{type(e).__name__}: {e}")
            self._drain_replica(rep, f"replica {rep.rid} worker died")

    def _worker_loop(self, rep: Replica) -> None:
        decoder = rep.decoder
        rm = self.metrics.replica(rep.rid)
        rm.slot_bank_size.set(decoder.S)
        outstanding = None          # the un-waited handle (double buffer)
        drain_deadline: Optional[float] = None
        while True:
            # Chaos site `replica_kill`: die through the real death path
            # (counted per scheduler iteration of this replica).
            if self.chaos is not None and self.chaos.fire(
                    "replica_kill", replica=rep.rid):
                self.metrics.chaos_faults.inc()
                rep.flight.event("chaos_fault", site="replica_kill")
                raise _ReplicaDied()
            admits: List[_Pending] = []
            with self._cond:
                while (not rep.q and not decoder.occupied
                       and outstanding is None and not self._stop
                       and rep.healthy):
                    self._cond.wait(timeout=0.1)
                if not rep.healthy:
                    raise _ReplicaDied()
                if self._stop:
                    if not self._drain:
                        break
                    if (not rep.q and not decoder.occupied
                            and outstanding is None):
                        rep.flight.event("drain_exit", served_all=True)
                        rep.flight.dump("drain")
                        return
                    if drain_deadline is None:
                        drain_deadline = time.monotonic() + self.drain_timeout_s
                # Elastic banks follow this replica's queue at the tick
                # boundary; outstanding handles stay harvestable (they
                # own their snapshots, and the admit-tick guard bounds
                # their slot indices).
                burst = 0
                if self.chaos is not None:
                    b = self.chaos.fire("queue_burst", replica=rep.rid)
                    if b:
                        burst = int(b)
                        self.metrics.chaos_faults.inc()
                        rep.flight.event("chaos_fault", site="queue_burst",
                                         burst=burst)
                before = decoder.resize_count
                decoder.maybe_resize(len(rep.q) + burst)
                if decoder.resize_count != before:
                    self.metrics.slot_bank_resizes.inc(
                        decoder.resize_count - before)
                    rm.slot_bank_size.set(decoder.S)
                    self.metrics.slots_total.set(sum(
                        r.decoder.S for r in self.replicas if r.healthy))
                cap = min(len(decoder.free), decoder.admit_cap)
                while rep.q and len(admits) < cap:
                    p = rep.q.popleft()
                    if p.future.done():
                        # The other copy of a hedged request won (or it
                        # was shed) before this copy reached a slot.
                        self.metrics.hedge_cancelled.inc()
                        continue
                    admits.append(p)
                rm.queue_depth.set(len(rep.q))
            if drain_deadline is not None and time.monotonic() > drain_deadline:
                rep.flight.event("watchdog", queued=len(admits),
                                 occupied=decoder.n_occupied)
                rep.flight.dump("watchdog")
                self._abandon(rep, admits, "drain deadline exceeded")
                rep.flight.event("drain_exit", served_all=False)
                return
            now = time.monotonic()
            live: List[_Pending] = []
            for p in admits:
                if now > p.deadline:
                    self._expire(p, now, flight=rep.flight)
                else:
                    live.append(p)
            # Chaos site `tick_stall`: a slow device step on this replica;
            # the worker sleeps before dispatching (hedging and the
            # router route around it).
            if self.chaos is not None:
                stall = self.chaos.fire("tick_stall", replica=rep.rid)
                if stall:
                    self.metrics.chaos_faults.inc()
                    rep.flight.event("chaos_fault", site="tick_stall",
                                     stall_s=float(stall))
                    time.sleep(float(stall))
            # Dispatch tick t+1 first (double buffer), so the harvest of
            # tick t below overlaps its device work.
            t_tick = time.monotonic()
            try:
                handle = decoder.tick_begin([p.prepared for p in live], live)
            except AdmissionError as e:
                # A bad row failed the encode before any slot was
                # claimed: fail those submitters, keep serving.
                _log.exception("replica %d admission failed", rep.rid)
                for p in live:
                    if _settle_exception(p, e):
                        self.metrics.requests_failed.inc()
                continue
            except Exception:
                # The step itself failed: the replica dies.  Requests of
                # this tick that hold no slot go back to its queue, so
                # the drain requeues them with the rest.
                held = list(decoder.occupied.values())
                with self._cond:
                    rep.q.extendleft(reversed([
                        p for p in live if all(p is not d for d in held)]))
                raise
            t_admit = time.monotonic()
            for p in live:
                p.t_admit = t_admit
                self.metrics.observe_stage(
                    "admission", (t_admit - p.t_enqueue) * 1e3)
            self._record_request_spans(live, t_tick, t_admit,
                                       tags={"replica": rep.rid})
            if live:
                self.metrics.slots_admitted_total.inc(len(live))
                rm.admitted_total.inc(len(live))
            if handle is not None:
                self.metrics.slot_steps_total.inc(decoder.block)
                rm.steps_total.inc(decoder.block)
                rep.flight.event("tick", seq=handle.seq, admits=len(live),
                                 occupied=decoder.n_occupied)
            rm.slots_occupied.set(decoder.n_occupied)
            self.metrics.slots_occupied.set(
                sum(r.decoder.n_occupied for r in self.replicas))
            if self.double_buffer:
                to_wait, outstanding = outstanding, handle
            else:
                to_wait, outstanding = handle, None
            if to_wait is not None:
                done = decoder.tick_wait(to_wait)
                if done:
                    self._resolve(rep, rm, decoder.harvest_from(to_wait, done))
                    rm.slots_occupied.set(decoder.n_occupied)
            rm.decode_state_bytes.set(decoder.live_state_bytes())
        # Hard stop (drain=False): fail what is in flight; stop() fails
        # what is still queued.
        self._abandon(rep, [], "replica set stopped")

    def _resolve(self, rep: Replica, rm, harvested) -> None:
        """Detokenize, cache and settle one harvest batch; a hedge
        loser's copy is discarded."""
        t0 = time.monotonic()
        for p, tokens, score, steps in harvested:
            if p.future.done():
                self.metrics.hedge_cancelled.inc()
                continue
            settled = self._resolve_one(p, rep.engine, tokens, score, steps,
                                        t0, tags={"replica": rep.rid})
            if settled:
                rm.captions_total.inc()
            elif settled is False:
                self.metrics.hedge_cancelled.inc()

    def _abandon(self, rep: Replica, admits: List[_Pending], why: str) -> None:
        for p in admits:
            if _settle_exception(p, RuntimeError(why)):
                self.metrics.requests_failed.inc()
        for slot in list(rep.decoder.occupied):
            p = rep.decoder.evict(slot)
            if p is not None and _settle_exception(p, RuntimeError(why)):
                self.metrics.requests_failed.inc()
        self.metrics.replica(rep.rid).slots_occupied.set(0)

    # -------------------------------------------------------- failure path
    def _drain_replica(self, rep: Replica, why: str) -> None:
        """Mark ``rep`` unhealthy, drain it from routing and requeue its
        queued and in-flight requests onto survivors, bounded by each
        request's deadline and the requeue budget.  Runs on the dying
        worker's thread (the decoder's one owner)."""
        requeued = expired = failed = overflowed = 0
        with self._cond:
            rep.healthy = False
            rm = self.metrics.replica(rep.rid)
            rm.healthy.set(0)
            pendings: List[Optional[_Pending]] = list(rep.q)
            rep.q.clear()
            rm.queue_depth.set(0)
            for slot in list(rep.decoder.occupied):
                pendings.append(rep.decoder.evict(slot))
            rm.slots_occupied.set(0)
            survivors = [r for r in self.replicas if r.healthy]
            now = time.monotonic()
            for p in pendings:
                if p is None or p.future.done():
                    continue
                if now > p.deadline:
                    # Shed, never served late: the original deadline
                    # rides through every requeue.
                    self._expire(p, now, flight=rep.flight)
                    expired += 1
                elif not survivors:
                    if _settle_exception(p, RuntimeError(
                            f"{why}; no healthy replicas left")):
                        self.metrics.requests_failed.inc()
                    failed += 1
                elif p.requeues >= self.requeue_budget:
                    # A request bounced across this many replica deaths
                    # fails instead of feeding a requeue storm.
                    self.metrics.requeue_overflow.inc()
                    self.metrics.shed(p.priority).inc()
                    rep.flight.event("shed", priority=p.priority,
                                     reason="requeue_budget",
                                     requeues=p.requeues)
                    if _settle_exception(p, RuntimeError(
                            f"{why}; requeue budget "
                            f"({self.requeue_budget}) exhausted")):
                        self.metrics.requests_failed.inc()
                    overflowed += 1
                else:
                    # Accepted work is never dropped: requeue even past
                    # queue_depth (the bound gates new admissions only).
                    p.requeues += 1
                    self.metrics.requeues_total.inc()
                    r2 = self.router.pick(survivors)
                    p.rid = r2.rid
                    r2.q.append(p)
                    self.metrics.replica(r2.rid).queue_depth.set(len(r2.q))
                    requeued += 1
            self.metrics.slots_total.set(
                sum(r.decoder.S for r in self.replicas if r.healthy))
            self._cond.notify_all()
        rep.flight.event("drain_requeue", requeued=requeued, expired=expired,
                         failed=failed, overflowed=overflowed,
                         survivors=self.healthy_replicas)
        rep.flight.dump(why)
        _log.warning("%s: drained from routing (%d requeued, %d expired, "
                     "%d failed, %d over budget; %d healthy replicas remain)",
                     why, requeued, expired, failed, overflowed,
                     self.healthy_replicas)

    # ----------------------------------------------------------------- info
    def describe(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "healthy": self.healthy_replicas,
            "router": self.router.policy,
            "double_buffer": self.double_buffer,
            "devices": [str(getattr(r.engine, "device", None))
                        for r in self.replicas],
            "slots_per_replica": [r.decoder.S for r in self.replicas],
            # "warm", or the artifact version each replica booted from.
            "artifact_versions": [
                str(getattr(r.engine, "artifact_version", "warm"))
                for r in self.replicas],
        }
