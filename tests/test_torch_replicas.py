"""The port's multi-replica scheduler (``serving/replicas.py``), the
double-buffered slot tick and the batcher machinery it rides on, held
against the JAX package.

Parity runs use ``test_torch_slots.py``'s setup: ``synthetic_smoke`` on
the CPU in float32, the JAX engine's random init through the weight
bridge with ``_spread`` (so captions differ and end at different
steps), one module-scoped JAX ``SlotDecoder`` run per fusion and mode as
the reference.  The port's ``ReplicaSet`` (one replica double-buffered,
one synchronous, two wrapped onto the CPU device, and two hedged) serves
the same requests from threads with fuzzed arrival times: every
caption's tokens must equal the JAX run's and the port's offline
per-step decode's, scores within rtol 1e-5.

Scheduler semantics (requeue budget, deadlines, zero healthy replicas,
concurrent stop) run on a stub decoder whose requests carry a tick
budget, as the reference's tests do.  The retry hint must equal the
JAX batcher's ``_retry_after_value`` for the same inputs, an unknown
priority is a 400, and shedding evicts the lowest class first.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from collections import namedtuple

import numpy as np
import pytest

import test_torch_slots as ts
from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.serving import batcher as jbatcher
from cst_captioning_tpu.serving import replicas as jreplicas
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import beam_search_from_state
from cst_captioning_torch.serving.batcher import (
    BackpressureError,
    ContinuousBatcher,
    DeadlineExceededError,
    MicroBatcher,
)
from cst_captioning_torch.serving.cache import TwoTierCache
from cst_captioning_torch.serving.engine import (
    DecodedResult,
    InferenceEngine,
    PreparedRequest,
)
from cst_captioning_torch.serving.replicas import (
    NoHealthyReplicasError,
    ReplicaSet,
    Router,
)
from cst_captioning_torch.serving.server import CaptionServer

CASES, N_REQ = ts.CASES, ts.N_REQ
refs = ts.refs          # the module-scoped JAX reference runs


# ------------------------------------------------------------------ router

class _FakeRep:
    def __init__(self, cap):
        self.cap = cap

    def free_capacity(self):
        return self.cap


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_router_picks_like_the_reference(policy):
    """The same fake replicas, the same capacity sequence (ties
    included): the port's Router and the JAX Router pick the same
    replica every time."""
    rng = np.random.RandomState(3)
    mine, ref = Router(policy), jreplicas.Router(policy)
    reps = [_FakeRep(0) for _ in range(4)]
    for _ in range(200):
        for r in reps:
            r.cap = int(rng.randint(-1, 3))
        cand = [r for r in reps if rng.rand() < 0.8] or reps[:1]
        assert mine.pick(cand) is ref.pick(cand)
    a, b = _FakeRep(2), _FakeRep(2)
    assert [Router("least_loaded").pick([a, b]) for _ in range(1)] == [a]
    r = Router("least_loaded")
    assert [r.pick([a, b]) for _ in range(4)] == [a, b, a, b]
    with pytest.raises(ValueError):
        Router("fifo")
    with pytest.raises(ValueError):
        Router(policy).pick([])


# ------------------------------------------------------- parity (real)

VARIANTS = {
    "one_double_buffered": dict(n=1, double_buffer=True, seed=31),
    "one_synchronous": dict(n=1, double_buffer=False, seed=7),
    "two_wrapped": dict(n=2, double_buffer=True, seed=5),
}


def _engine(jeng, fusion, mode, **serving):
    return ts._port_engine(jeng, fusion, mode, default_deadline_ms=120_000.0,
                           **serving)


_OFFLINE = {}


def _offline(jeng, fusion, mode):
    """The port's offline per-step decode of the requests, encoded
    together: tokens (N, L)."""
    if (fusion, mode) not in _OFFLINE:
        peng = _engine(jeng, fusion, mode)
        reqs = [peng.prepare(p) for p in ts._payloads()]
        m, ev = peng.model, peng.cfg.eval
        cache = peng.encode_prepared_rows(reqs)
        state = m.init_state(N_REQ)
        if mode == "beam":
            toks = beam_search_from_state(
                m, state, cache, beam_size=ev.beam_size,
                max_len=ev.max_decode_len,
                length_normalize=ev.length_normalize).tokens.numpy()
        else:
            toks = m._sample_from_cache(
                state, cache, max_len=ev.max_decode_len).tokens.numpy()
        _OFFLINE[(fusion, mode)] = toks
    return _OFFLINE[(fusion, mode)]


def _fuzz(rs, idx, rng, jitter_s=0.03):
    """Submit ``idx`` from one thread each after a random delay; returns
    ({index: result}, [errors])."""
    payloads = ts._payloads()
    delays = rng.rand(len(idx)) * jitter_s
    results, errors = {}, []
    lock = threading.Lock()

    def client(i, d):
        time.sleep(d)
        try:
            out = rs.submit(dict(payloads[i]))
            with lock:
                results[i] = out
        except Exception as e:  # noqa: BLE001 — asserted below
            with lock:
                errors.append((i, repr(e)))

    ths = [threading.Thread(target=client, args=(i, d))
           for i, d in zip(idx, delays)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths)
    return results, errors


def _assert_exact(results, want, offline, mode):
    assert sorted(results) == list(range(N_REQ))
    for i in range(N_REQ):
        got = np.asarray(results[i]["tokens"])
        np.testing.assert_array_equal(got, want[i][0], err_msg=f"req {i}")
        np.testing.assert_array_equal(got, offline[i], err_msg=f"req {i}")
        if mode == "beam":
            np.testing.assert_allclose(results[i]["score"], want[i][1],
                                       rtol=1e-5, atol=1e-6)


def _assert_clean(rs):
    for rep in rs.replicas:
        assert not rep.decoder.occupied
        assert sorted(rep.decoder.free) == list(range(rep.decoder.S))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fusion,mode", CASES)
def test_replica_set_matches_jax_and_offline(refs, fusion, mode, variant):
    v = VARIANTS[variant]
    jeng, want, _ = refs[(fusion, mode)]
    rs = ReplicaSet.from_engine(_engine(jeng, fusion, mode),
                                n_replicas=v["n"],
                                double_buffer=v["double_buffer"])
    assert [str(r.engine.device) for r in rs.replicas] == ["cpu"] * v["n"]
    rng = np.random.RandomState(v["seed"])
    with rs:
        results, errors = _fuzz(rs, list(rng.permutation(N_REQ)), rng)
    assert not errors, errors
    _assert_exact(results, want, _offline(jeng, fusion, mode), mode)
    admitted = [rs.metrics.replica(r.rid).admitted_total.value
                for r in rs.replicas]
    assert sum(admitted) == N_REQ and min(admitted) > 0, admitted
    assert rs.metrics.requests_served.value == N_REQ
    assert rs.metrics.requests_failed.value == 0
    _assert_clean(rs)
    for rep in rs.replicas:
        ring = rs.flight_snapshot()[rep.flight.name]["events"]
        assert any(e["event"] == "tick" for e in ring)


def test_replicas_share_the_weights_on_one_device(refs):
    """A clone on the engine's device shares its parameter tensors and
    the tier-1 cache; its slot decoder is its own."""
    jeng, _, _ = refs[("meanpool", "greedy")]
    eng = _engine(jeng, "meanpool", "greedy")
    a = eng.clone_for_device("cpu", replica_id=0)
    b = eng.clone_for_device("cpu", replica_id=1)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert pa.data_ptr() == pb.data_ptr()
    assert a.model is eng.model and a.cache is eng.cache is b.cache
    assert a.params_tag == eng.params_tag and a.cfg is not eng.cfg
    assert a.slot_decoder() is not b.slot_decoder()
    assert a.slot_decoder().span_tags == {"replica": 0}
    assert a.stream is None and (a.replica_id, b.replica_id) == (0, 1)


def test_kill_replica_mid_traffic_completes_on_survivor(refs):
    jeng, want, _ = refs[("attention", "beam")]
    rs = ReplicaSet.from_engine(_engine(jeng, "attention", "beam"),
                                n_replicas=2)
    dec0 = rs.replicas[0].decoder
    wait0 = dec0.tick_wait

    def slow_wait(h):   # keep replica 0 busy long enough to be killed
        time.sleep(0.003)
        return wait0(h)

    dec0.tick_wait = slow_wait
    payloads = ts._payloads()
    results, errors = {}, []
    lock = threading.Lock()

    def client(i):
        try:
            out = rs.submit(dict(payloads[i]))
            with lock:
                results[i] = out
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append((i, repr(e)))

    with rs:
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(N_REQ)]
        for t in ths:
            t.start()
        t0 = time.monotonic()
        while not dec0.occupied and time.monotonic() - t0 < 30:
            time.sleep(0.001)
        rs.kill_replica(0)
        for t in ths:
            t.join(timeout=120)
    assert not errors, errors
    _assert_exact(results, want, _offline(jeng, "attention", "beam"), "beam")
    assert rs.metrics.requeues_total.value >= 1
    assert rs.healthy_replicas == 1 and not rs.replicas[0].healthy
    assert rs.metrics.replica(0).healthy.value == 0
    assert any(r["replica"] == 1 for r in results.values())
    _assert_clean(rs)
    events = [e["event"] for e in rs.flight_snapshot()["replica0"]["events"]]
    assert "kill" in events and "drain_requeue" in events


def test_hedged_requests_stay_token_exact(refs):
    jeng, want, _ = refs[("meanpool", "beam")]
    rs = ReplicaSet.from_engine(_engine(jeng, "meanpool", "beam"),
                                n_replicas=2, hedge_ms=1.0)
    rng = np.random.RandomState(17)
    with rs:
        results, errors = _fuzz(rs, list(rng.permutation(N_REQ)), rng)
    assert not errors, errors
    _assert_exact(results, want, _offline(jeng, "meanpool", "beam"), "beam")
    assert rs.metrics.hedges_total.value >= 1
    assert rs.metrics.requests_served.value == N_REQ
    assert rs.metrics.requests_failed.value == 0
    _assert_clean(rs)


def test_http_replica_server_degrades_only_at_zero_healthy(refs):
    """/healthz carries the replica counts and stays 200 with one
    replica down; with none healthy it is 503, and so is a fresh
    request; /metrics carries the per-replica families."""
    jeng, want, _ = refs[("meanpool", "greedy")]
    eng = _engine(jeng, "meanpool", "greedy", replicas=2)
    srv = CaptionServer(eng, port=0).start()
    assert isinstance(srv.batcher, ReplicaSet)

    def get(path):
        try:
            with urllib.request.urlopen(srv.url + path, timeout=60) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def post(i):
        body = json.dumps({"features": {
            k: v.tolist() for k, v in ts._payloads()[i]["features"].items()
        }}).encode()
        req = urllib.request.Request(srv.url + "/v1/caption", data=body,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, out = post(3)
        assert code == 200 and out["tokens"] == [int(x) for x in want[3][0]]
        code, text = get("/healthz")
        assert code == 200
        assert json.loads(text)["replicas"] == {"healthy": 2, "total": 2}
        _, text = get("/metrics")
        for fam in ('caption_replica_healthy{replica="1"} 1',
                    'caption_replica_captions_total{replica=',
                    'caption_shed_total{priority="batch"} 0',
                    "caption_hedges_total 0", "caption_requeues_total 0"):
            assert fam in text, fam
        srv.batcher.kill_replica(0)
        t0 = time.monotonic()
        while srv.batcher.replicas[0].healthy or \
                srv.metrics.replica(0).healthy.value:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        assert get("/healthz")[0] == 200
        srv.batcher.kill_replica(1)
        t0 = time.monotonic()
        while srv.metrics.replica(1).healthy.value:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        code, text = get("/healthz")
        assert code == 503 and json.loads(text)["status"] == "unhealthy"
        assert post(4)[0] == 503
        assert post(3)[0] == 200      # a tier-1 hit needs no replica
    finally:
        srv.shutdown()


# ------------------------------------------------ double-buffer guards

def test_a_handle_keeps_its_own_tick_after_the_next_dispatch(refs):
    jeng, _, _ = refs[("attention", "beam")]
    dec = _engine(jeng, "attention", "beam").slot_decoder()
    reqs = [dec.engine.prepare(p) for p in ts._payloads()[:2]]
    h1 = dec.tick_begin(reqs, [0, 1])
    co = dec._st.core
    want = ((co.finished.all(-1) | (co.step >= dec.L)).clone(),
            co.seqs.clone(), co.scores.clone())
    h2 = dec.tick_begin()
    assert h2.seq == h1.seq + 1
    for got, w in zip((h1.done, h1.seqs, h1.scores), want):
        assert got.equal(w)
    assert not h1.seqs.equal(dec._st.core.seqs)     # the state moved on
    assert not h1.scores.equal(h2.scores)
    assert dec.tick_wait(h1) == [s for s in (0, 1) if bool(want[0][s])]


def test_a_refilled_slot_is_not_harvested_from_a_stale_handle(refs):
    """The double-buffered order: harvest slot s from handle t while
    handle t+1 is outstanding, refill s; handle t+1 still flags s done
    (its previous occupant) but does not report it, nor lets it be
    harvested; the new occupant decodes as the synchronous loop does."""
    jeng, want, _ = refs[("meanpool", "greedy")]
    dec = _engine(jeng, "meanpool", "greedy").slot_decoder()
    reqs = [dec.engine.prepare(p) for p in ts._payloads()]
    prev = dec.tick_begin([reqs[0]], [0])
    while True:
        cur = dec.tick_begin()
        done = dec.tick_wait(prev)
        if done:
            break
        prev = cur
    assert done == [0]
    ((_, tokens, _, _),) = dec.harvest_from(prev, done)
    np.testing.assert_array_equal(tokens, want[0][0])
    nxt = dec.tick_begin([reqs[5]], [5])
    assert dec.admit_tick[0] == nxt.seq > cur.seq
    assert bool(cur.done[0])
    assert dec.tick_wait(cur) == []
    with pytest.raises(RuntimeError, match="admitted at tick"):
        dec.harvest_from(cur, [0])
    while 0 not in dec.tick_wait(nxt):
        nxt = dec.tick_begin()
    ((i, tokens, _, _),) = dec.harvest_from(nxt, [0])
    assert i == 5
    np.testing.assert_array_equal(tokens, want[5][0])


# ------------------------------------------------------- stub scheduler

_StubHandle = namedtuple("_StubHandle", "seq done")


class _StubDecoder:
    """Async-API slot decoder double: each request carries a tick budget
    (in ``prepared.category``); a tick decrements every occupant, done
    at zero.  Asserts on slot double-assignment."""

    def __init__(self, S=2):
        self.S, self.K, self.L, self.block = S, 1, 10_000, 1
        self.admit_cap = S
        self.free = list(range(S))
        self.occupied = {}
        self._left = {}
        self._admit_seq = {}
        self._seq = 0
        self.fail_next = False
        self.resize_count = 0

    @property
    def n_occupied(self):
        return len(self.occupied)

    def maybe_resize(self, pending=0):
        return self.S

    def live_state_bytes(self):
        return 64 * self.n_occupied

    def tick_begin(self, prepared=(), datas=()):
        if self.fail_next:
            raise RuntimeError("injected decoder failure")
        for req, data in zip(prepared, datas):
            slot = self.free.pop()
            assert slot not in self.occupied, "slot double-assigned"
            self.occupied[slot] = data
            self._left[slot] = req.category
            self._admit_seq[slot] = self._seq + 1
        if not self.occupied:
            return None
        self._seq += 1
        for s in self.occupied:
            self._left[s] -= 1
        return _StubHandle(self._seq, tuple(
            s for s in self.occupied if self._left[s] <= 0))

    def tick_wait(self, handle):
        time.sleep(0.001)
        return [s for s in handle.done
                if s in self.occupied and self._admit_seq[s] <= handle.seq]

    def harvest_from(self, handle, slots):
        out = []
        for s in slots:
            data = self.occupied.pop(s)
            steps = handle.seq - self._admit_seq.pop(s) + 1
            self._left.pop(s, None)
            self.free.append(s)
            out.append((data, np.asarray([5, 2], np.int32), 0.0, steps))
        return out

    def evict(self, slot):
        data = self.occupied.pop(slot)
        self._left.pop(slot, None)
        self._admit_seq.pop(slot, None)
        self.free.append(slot)
        return data


class _StubEngine:
    def __init__(self, S=2, **serving):
        self.cfg = tcfg.get_preset("synthetic_smoke")
        for k, v in serving.items():
            setattr(self.cfg.serving, k, v)
        self.cache = TwoTierCache(8)
        self._decoder = _StubDecoder(S=S)
        self.device = "cpu"

    def prepare(self, payload):
        return PreparedRequest(feats=None, masks=None,
                               cache_key=payload.get("key", ""),
                               category=int(payload.get("steps", 3)))

    def lookup_caption(self, key):
        return None

    def slot_decoder(self):
        return self._decoder

    def result_from_tokens(self, req, tokens, timings_ms, store=True):
        return DecodedResult(caption="stub", tokens=[int(t) for t in tokens],
                             timings_ms=timings_ms)


def _submit_bg(rs, payload, results, errors, lock, deadline_ms=None):
    def go():
        try:
            out = rs.submit(payload, deadline_ms=deadline_ms)
            with lock:
                results.append(out)
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(e)

    t = threading.Thread(target=go)
    t.start()
    return t


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.002)


def test_worker_death_requeues_in_flight_work():
    engines = [_StubEngine(S=1), _StubEngine(S=1)]
    rs = ReplicaSet(engines)
    results, errors, lock = [], [], threading.Lock()
    with rs:
        ths = [_submit_bg(rs, {"steps": 100}, results, errors, lock)
               for _ in range(2)]
        _wait_for(lambda: all(e._decoder.occupied for e in engines))
        engines[0]._decoder.fail_next = True
        for t in ths:
            t.join(timeout=30)
    assert not errors and len(results) == 2
    assert rs.healthy_replicas == 1 and rs.metrics.requests_failed.value == 0
    assert rs.metrics.requeues_total.value == 1
    assert not engines[0]._decoder.occupied


def test_requeue_budget_fails_a_request_bounced_too_often():
    """Budget 1 over three replicas: the request survives one replica
    death (requeued once) and fails at the second."""
    engines = [_StubEngine(S=1) for _ in range(3)]
    rs = ReplicaSet(engines, requeue_budget=1)
    results, errors, lock = [], [], threading.Lock()
    with rs:
        t = _submit_bg(rs, {"steps": 10 ** 6}, results, errors, lock)
        first = None
        while first is None:
            first = next((r for r in rs.replicas if r.decoder.occupied), None)
            time.sleep(0.002)
        rs.kill_replica(first.rid)
        _wait_for(lambda: any(r.decoder.occupied for r in rs.replicas
                              if r is not first))
        second = next(r for r in rs.replicas if r.decoder.occupied)
        rs.kill_replica(second.rid)
        t.join(timeout=30)
    assert not results and len(errors) == 1
    assert "requeue budget (1) exhausted" in str(errors[0])
    assert rs.metrics.requeues_total.value == 1
    assert rs.metrics.requeue_overflow.value == 1
    assert rs.metrics.shed("interactive").value == 1
    events = [e["event"] for e in
              rs.flight_snapshot()[second.flight.name]["events"]]
    assert "shed" in events


def test_requeue_sheds_expired_requests():
    """A request queued behind a killed replica past its deadline fails
    with DeadlineExceededError, not served late."""
    engines = [_StubEngine(S=1), _StubEngine(S=1)]
    rs = ReplicaSet(engines)
    results, errors, lock = [], [], threading.Lock()
    rs.start()
    try:
        blockers = [_submit_bg(rs, {"steps": 10 ** 6}, results, errors, lock)
                    for _ in range(2)]
        _wait_for(lambda: all(e._decoder.occupied for e in engines))
        t3 = _submit_bg(rs, {"steps": 1}, results, errors, lock,
                        deadline_ms=40.0)
        _wait_for(lambda: any(r.q for r in rs.replicas))
        holder = next(r for r in rs.replicas if r.q)
        time.sleep(0.1)
        rs.kill_replica(holder.rid)
        t3.join(timeout=20)
    finally:
        rs.stop(drain=False)
        for t in blockers:
            t.join(timeout=20)
    expired = [e for e in errors if isinstance(e, DeadlineExceededError)]
    assert len(expired) == 1, errors
    assert rs.metrics.requests_expired.value == 1


def test_zero_healthy_replicas_rejects_submit():
    rs = ReplicaSet([_StubEngine(S=1)])
    with rs:
        rs.kill_replica(0)
        _wait_for(lambda: rs.metrics.replica(0).healthy.value == 0)
        assert rs.healthy_replicas == 0
        with pytest.raises(NoHealthyReplicasError) as ei:
            rs.submit({"steps": 1})
        assert ei.value.retry_after_s > 0


def test_concurrent_stop_is_idempotent():
    rs = ReplicaSet([_StubEngine(S=1), _StubEngine(S=1)]).start()
    results, errors, lock = [], [], threading.Lock()
    _submit_bg(rs, {"steps": 1}, results, errors, lock).join(10)
    stop_errors = []

    def stopper():
        try:
            rs.stop()
        except Exception as e:  # noqa: BLE001
            stop_errors.append(e)

    ths = [threading.Thread(target=stopper) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=15)
    assert not any(t.is_alive() for t in ths)
    assert not stop_errors and not rs._running() and rs._threads == []
    assert results and not errors


# --------------------------------------- retry hints, priorities, knobs

def _pair(queue_depth=8, retry_after_s=0.5):
    mine = ReplicaSet([_StubEngine(S=1)], queue_depth=queue_depth,
                      retry_after_s=retry_after_s)
    ref = jbatcher._BatcherBase(
        types.SimpleNamespace(cfg=jax_preset("synthetic_smoke")),
        queue_depth=queue_depth, retry_after_s=retry_after_s)
    return mine, ref


@pytest.mark.parametrize("queue_depth,retry_after_s", [(8, 0.5), (1, 2.0),
                                                       (1024, 1.0)])
def test_retry_after_equals_the_reference(queue_depth, retry_after_s):
    mine, ref = _pair(queue_depth, retry_after_s)
    for depth in (0, 1, 3, queue_depth, 2 * queue_depth, 7 * queue_depth):
        for key in (None, "", "seq1", "abc", "f" * 64, "ünï"):
            assert (mine._retry_after_value(depth, key)
                    == ref._retry_after_value(depth, key)), (depth, key)
    for _ in range(3):
        assert mine._jitter_key(None) == ref._jitter_key(None)


def _blocked_batcher(engine, **kw):
    """A ContinuousBatcher whose first tick blocks on the returned event,
    so later arrivals stay queued."""
    b = ContinuousBatcher(engine, **kw)
    dec = engine.slot_decoder()
    gate = threading.Event()
    inner = dec.tick_begin

    def gated(*a, **k):
        gate.wait(timeout=60)
        return inner(*a, **k)

    dec.tick_begin = gated
    return b, gate


def _small_engine(**serving):
    cfg = tcfg.get_preset("synthetic_smoke")
    sv = cfg.serving
    sv.continuous, sv.replicas, sv.warmup = True, 1, False
    sv.num_slots, sv.caption_cache_size = 4, 0
    for k, v in serving.items():
        setattr(sv, k, v)
    return InferenceEngine(cfg, random_init=True,
                           vocab=Vocabulary([f"w{i}" for i in range(40)]),
                           device="cpu")


def _payload(seed, **extra):
    rng = np.random.RandomState(seed)
    return {"features": {"resnet": rng.randn(3, 64).round(3).tolist()},
            **extra}


def test_http_429_retry_after_and_unknown_priority():
    """A full queue answers 429 with the reference's jittered
    Retry-After for that request; an unknown priority is a 400."""
    eng = _small_engine(queue_depth=1, retry_after_s=0.5)
    b, gate = _blocked_batcher(eng)
    srv = CaptionServer(eng, port=0, batcher=b).start()
    ref = jbatcher._BatcherBase(
        types.SimpleNamespace(cfg=jax_preset("synthetic_smoke")),
        queue_depth=1, retry_after_s=0.5)

    def post(payload):
        req = urllib.request.Request(
            srv.url + "/v1/caption", data=json.dumps(payload).encode(),
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)

    out = {}
    try:
        code, body, _ = post(_payload(0, priority="urgent"))
        assert code == 400 and "unknown priority" in body["error"]
        with pytest.raises(ValueError, match="unknown priority"):
            b.submit(_payload(0, priority="low"))
        ths = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, post(_payload(i)))) for i in (1, 2)]
        ths[0].start()
        _wait_for(lambda: b.metrics.requests_total.value == 1
                  and b.depth == 0)
        ths[1].start()
        _wait_for(lambda: b.depth == 1)
        p3 = _payload(3)
        code, body, hdrs = post(p3)
        key = eng.prepare(p3).cache_key
        want = ref._retry_after_value(1, key)
        assert code == 429
        assert body["retry_after_s"] == want == b._retry_after_value(1, key)
        assert hdrs["Retry-After"] == f"{want:.3f}"
        gate.set()
        for t in ths:
            t.join(timeout=60)
        assert out[1][0] == out[2][0] == 200
    finally:
        gate.set()
        srv.shutdown()


def test_shedding_evicts_the_lowest_class_first():
    eng = _small_engine(queue_depth=2)
    b, gate = _blocked_batcher(eng)
    b.start()
    outcomes, lock = {}, threading.Lock()

    seeds = {n: i for i, n in enumerate(
        ("head", "be", "batch", "i1", "i2", "i3", "b2"))}

    def submit(name, prio):
        try:
            r = b.submit(_payload(seeds[name], priority=prio))
            res = "served" if isinstance(r, dict) else r
        except BackpressureError:
            res = "shed"
        with lock:
            outcomes[name] = res

    def start(name, prio, depth=None):
        t = threading.Thread(target=submit, args=(name, prio))
        t.start()
        if depth is not None:
            _wait_for(lambda: b.depth == depth or name in outcomes)
        return t

    try:
        ths = [start("head", "interactive")]
        _wait_for(lambda: b.metrics.requests_total.value == 1
                  and b.depth == 0)
        ths.append(start("be", "best_effort", 1))
        ths.append(start("batch", "batch", 2))
        ths.append(start("i1", "interactive"))
        _wait_for(lambda: "be" in outcomes)
        assert outcomes == {"be": "shed"}
        ths.append(start("i2", "interactive"))
        _wait_for(lambda: "batch" in outcomes)
        assert outcomes["batch"] == "shed"
        ths.append(start("i3", "interactive"))
        _wait_for(lambda: "i3" in outcomes)
        ths.append(start("b2", "batch"))
        _wait_for(lambda: "b2" in outcomes)
        assert outcomes["i3"] == outcomes["b2"] == "shed"
        assert b.metrics.shed("best_effort").value == 1
        assert b.metrics.shed("batch").value == 1
        assert b.metrics.shed("interactive").value == 0
        assert b.metrics.requests_rejected.value == 2
        gate.set()
        for t in ths:
            t.join(timeout=60)
    finally:
        gate.set()
        b.stop()
    assert [outcomes[k] for k in ("head", "i1", "i2")] == ["served"] * 3
    assert [e["event"] for e in b.flight.snapshot()["events"]].count(
        "shed") == 2


@pytest.mark.parametrize("knob,value", [
    ("chaos", {"seed": 1, "schedule": [{"site": "tick_stall", "at": 2}]}),
    ("autoscale", {"min_replicas": 1, "max_replicas": 2})])
def test_chaos_and_autoscale_are_refused(knob, value):
    """Refused until the serving extensions were ported: now the engine
    boots, the scheduler carries the ChaosEngine and the server the
    autoscaler."""
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.serving.warmup = False
    cfg.serving.replicas = 0
    setattr(cfg.serving, knob, value)
    eng = InferenceEngine(cfg, random_init=True, device="cpu",
                          vocab=Vocabulary(["a", "b"]))
    srv = CaptionServer(eng, port=0)
    try:
        assert type(srv.batcher) is ReplicaSet
        assert (srv.batcher.chaos is not None) == (knob == "chaos")
        assert (srv.autoscaler is not None) == (knob == "autoscale")
    finally:
        srv.shutdown(drain=False)


@pytest.mark.parametrize("overrides,kind", [
    ({"replicas": 0}, ReplicaSet), ({"replicas": 2}, ReplicaSet),
    ({"replicas": 1}, ContinuousBatcher),
    ({"replicas": 0, "continuous": False}, MicroBatcher)])
def test_server_picks_the_reference_scheduler(overrides, kind):
    srv = CaptionServer(_small_engine(**overrides), port=0)
    try:
        assert type(srv.batcher) is kind
        if kind is ReplicaSet:
            n = overrides["replicas"] or 1
            assert len(srv.batcher.replicas) == n
            assert srv.batcher.double_buffer is True
    finally:
        srv.shutdown()
    assert tcfg.get_preset("msrvtt_serve_beam5").serving.replicas == 0
