"""The tier-2 encoder-row cache (``feature_id`` requests): the port's
``serving/cache.py`` and engine against the JAX package's.

The caches run the same operations on both sides and must report the
same stats.  The engines run ``test_torch_slots.py``'s setup
(``synthetic_smoke`` on the CPU in float32, the JAX engine's random init
through the weight bridge, spread so captions differ); one module-scoped
JAX run per fusion and mode sends the requests with a ``feature_id``,
then again by id alone.  Tolerance: decode is token-exact everywhere.
The port is held to the JAX run on the ladder, in the slot loop (hits,
mixed admissions, fuzzed arrivals) and in a two-replica ``ReplicaSet``;
a hit must admit with no encode (``row_dot`` not called, the
``admit_rows_*`` counters).  bf16 and ``use_category`` are held hit
against miss.  The reference's stale-rows behaviour (a resent id with new
features decodes the rows stored first) is pinned on both sides.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import test_torch_category as tcat
import test_torch_slots as ts
from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.serving import cache as jcache
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import beam_search_from_state
from cst_captioning_torch.models import captioner
from cst_captioning_torch.serving import cache as tcache
from cst_captioning_torch.serving.batcher import ContinuousBatcher
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.replicas import ReplicaSet
from cst_captioning_torch.serving.server import CaptionServer

CASES, N_REQ = ts.CASES, ts.N_REQ
MODULES = {"port": tcache, "jax": jcache}


def _ids(payloads, prefix="f"):
    return [dict(p, feature_id=f"{prefix}{i}") for i, p in enumerate(payloads)]


@pytest.fixture(scope="module")
def world():
    """Per (fusion, mode): the JAX engine (its tier 2 holds ``f0..f11``),
    its tokens for the requests sent with features and an id, and its
    tokens for the same ids sent alone."""
    out = {}
    for fusion, mode in CASES:
        jeng = JaxEngine(ts._cfg(jax_preset, fusion, mode), random_init=True)
        ts._spread(jeng, mode)
        reqs = [jeng.prepare(p) for p in _ids(ts._payloads())]
        want = ts._drive(jeng.slot_decoder(), reqs, range(N_REQ))
        hits = [jeng.prepare({"feature_id": f"f{i}"}) for i in range(N_REQ)]
        assert all(h.enc_row is not None for h in hits)
        jhit = ts._drive(jeng.slot_decoder(), hits, range(N_REQ))
        out[(fusion, mode)] = (jeng, want, jhit)
    return out


class _RowDotCalls:
    """Counts the captioner's ``row_dot`` calls (the encode's products)."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = captioner.row_dot

        def counting(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(captioner, "row_dot", counting)


def _encode_calls(fusion):
    # synthetic_smoke has one modality: its projection, plus att_wf.
    return 2 if fusion == "attention" else 1


# ------------------------------------------------------------- the cache

def _row(kb):
    return {"enc": np.zeros((kb, 256), np.float32)}  # kb KiB


def _scenario(mod, name):
    """The reference's byte-budget tests as one op sequence; returns what
    each step saw."""
    seen = []
    if name == "two_tier":
        t = mod.TwoTierCache(4, 4, feature_max_bytes=1024)
        seen.append((t.features.max_bytes, t.captions.max_bytes))
        t.features.put("f1", _row(2))
        return seen + [t.stats()]
    c = mod.LRUCache(capacity=100, max_bytes={
        "lru_first": 3 * 1024 + 256, "oversized": 2 * 1024,
        "replace": 10 * 1024}[name])
    if name == "lru_first":
        for k in "abc":
            c.put(k, _row(1))
        seen.append(len(c))
        seen.append(c.get("a") is not None)
        c.put("d", _row(1))
        seen += [c.get("b") is None, c.get("a") is not None,
                 "d" in c, "b" in c]
    elif name == "oversized":
        c.put("big", _row(8))
        seen.append(c.get("big"))
    else:
        c.put("k", _row(4))
        seen.append(c.stats()["bytes"])
        c.put("k", _row(1))
        seen.append(len(c))
    return seen + [c.stats()]


@pytest.mark.parametrize("name", ["lru_first", "oversized", "replace",
                                  "two_tier"])
def test_byte_budget_as_the_reference(name):
    mine, ref = _scenario(tcache, name), _scenario(jcache, name)
    assert mine == ref
    st = mine[-1]["features"] if name == "two_tier" else mine[-1]
    assert st["bytes"] <= st["max_bytes"]
    if name in ("lru_first", "oversized", "two_tier"):
        assert st["evictions"] >= 1


def test_admission_eviction_fuzz_as_the_reference():
    """A random stream of puts (sizes 0-6 KiB, some replacing), gets,
    probes and clears on both caches: every answer and every stats dict
    equal, the byte bound held after every put."""
    rng = np.random.RandomState(7)
    caches = {k: m.LRUCache(capacity=9, max_bytes=12 * 1024)
              for k, m in MODULES.items()}
    for step in range(600):
        op = rng.choice(["put", "put", "get", "probe", "clear"],
                        p=[0.4, 0.2, 0.25, 0.13, 0.02])
        key = f"k{rng.randint(14)}"
        kb = int(rng.randint(0, 7))
        got = {}
        for name, c in caches.items():
            if op == "put":
                got[name] = c.put(key, _row(kb))
            elif op == "get":
                v = c.get(key)
                got[name] = None if v is None else v["enc"].shape
            elif op == "probe":
                got[name] = (key in c, len(c))
            else:
                got[name] = c.clear()
            st = c.stats()
            assert st["bytes"] <= st["max_bytes"] and st["size"] <= 9
        assert got["port"] == got["jax"], (step, op)
        assert caches["port"].stats() == caches["jax"].stats(), step


def test_entry_nbytes_counts_the_bytes_held():
    entry = {"feats": {"resnet": np.zeros((6, 64), np.float32)},
             "masks": {"resnet": np.zeros((6,), np.float32)},
             "category": 3, "cache_key": "ab", "enc": None}
    assert tcache.entry_nbytes(entry) == jcache.entry_nbytes(entry)
    rows = (torch.randn(32).to(torch.bfloat16), None,
            torch.randn(6, 32), torch.ones(6))
    assert tcache.entry_nbytes(rows) == 32 * 2 + 64 + 6 * 32 * 4 + 6 * 4 + 64
    assert tcache.entry_nbytes(dict(entry, enc=rows)) == \
        jcache.entry_nbytes(entry) - 64 + tcache.entry_nbytes(rows)
    c = tcache.LRUCache(4, max_bytes=1 << 20)
    c.put("x", {"enc": rows})
    back = c.get("x")["enc"]
    assert back[0].dtype == torch.bfloat16
    assert torch.equal(back[0].view(torch.int16), rows[0].view(torch.int16))


def test_engine_builds_the_presets_tier():
    cfg = get_preset("msrvtt_serve_beam5")
    jc = jax_preset("msrvtt_serve_beam5")
    for c in (cfg, jc):
        assert (c.serving.feature_cache_size,
                c.serving.feature_cache_bytes) == (4096, 256 * 1024 * 1024)
    cfg = get_preset("synthetic_smoke")
    cfg.serving.warmup = False
    cfg.serving.feature_cache_size = 4096
    cfg.serving.feature_cache_bytes = 256 * 1024 * 1024
    eng = InferenceEngine(cfg, random_init=True,
                          vocab=Vocabulary([f"w{i}" for i in range(20)]),
                          device="cpu")
    st = eng.cache.stats()
    ref = jcache.TwoTierCache(65536, 4096, 256 * 1024 * 1024).stats()
    assert sorted(st) == sorted(ref) == ["captions", "features"]
    assert sorted(st["features"]) == sorted(ref["features"])
    assert (st["features"]["capacity"], st["features"]["max_bytes"]) == \
        (4096, 256 * 1024 * 1024)


def test_feature_tier_byte_bound_on_the_engine():
    """Entries of the engine's own requests under a small byte budget:
    the bound holds, evictions are counted, an evicted id is a
    ``KeyError``."""
    cfg = get_preset("synthetic_smoke")
    cfg.serving.warmup = False
    cfg.serving.feature_cache_bytes = 6 * 1024
    eng = InferenceEngine(cfg, random_init=True,
                          vocab=Vocabulary([f"w{i}" for i in range(20)]),
                          device="cpu")
    for i, p in enumerate(_ids(ts._payloads())):
        eng.prepare(p)
        st = eng.cache.features.stats()
        assert st["bytes"] <= st["max_bytes"]
    assert 0 < st["size"] < N_REQ and st["evictions"] == N_REQ - st["size"]
    with pytest.raises(KeyError, match="f0"):
        eng.prepare({"feature_id": "f0"})
    assert eng.prepare({"feature_id": f"f{N_REQ - 1}"}).feats is not None


# ------------------------------------------------------------ the ladder

@pytest.mark.parametrize("mode", ["beam", "greedy"])
@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_ladder_id_only_repeat_matches_features_and_jax(fusion, mode):
    """Ladder engines (``continuous = false``): requests with features
    and an id, then by id alone, on both sides.  The port's id-only
    tokens equal its features tokens and the JAX engine's id-only tokens;
    the port's ladder reads no encoder rows and stores none."""
    cfgs = [ts._cfg(g, fusion, mode, continuous=False)
            for g in (jax_preset, get_preset)]
    jeng = JaxEngine(cfgs[0], random_init=True)
    ts._spread(jeng, mode)
    peng = ts._port_engine(jeng, fusion, mode, continuous=False)
    payloads = _ids(ts._payloads()[:6])
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        first = eng.decode_prepared([eng.prepare(p) for p in payloads])
        hits = [eng.prepare({"feature_id": p["feature_id"]})
                for p in payloads]
        again = eng.decode_prepared(hits, store=False)
        out[name] = ([r.tokens for r in first], [r.tokens for r in again],
                     hits)
    ptok, phit, preqs = out["port"]
    assert phit == ptok
    assert phit == out["jax"][1] == out["jax"][0]
    assert len({tuple(t) for t in ptok}) > 1
    assert all(r.enc_row is None for r in preqs)
    assert peng.admit_rows_encoded == peng.admit_rows_cached == 0


# ---------------------------------------------------------- the slot loop

@pytest.mark.parametrize("fusion,mode", CASES)
def test_slot_id_only_hits_match_jax_with_zero_encode(world, fusion, mode,
                                                      monkeypatch):
    jeng, want, jhit = world[(fusion, mode)]
    peng = ts._port_engine(jeng, fusion, mode)
    dec = peng.slot_decoder()
    got = ts._drive(dec, [peng.prepare(p) for p in _ids(ts._payloads())],
                    range(N_REQ))
    ts._assert_same(got, want, mode)
    enc0, hit0 = peng.admit_rows_encoded, peng.admit_rows_cached
    assert enc0 >= N_REQ and hit0 == 0
    hits = [peng.prepare({"feature_id": f"f{i}"}) for i in range(N_REQ)]
    assert all(h.enc_row is not None for h in hits)
    for h in hits:
        assert all(x is None or x.device.type == "cpu" for x in h.enc_row)
        assert (h.enc_row[1] is None) == (fusion == "meanpool")
    calls = _RowDotCalls(monkeypatch)
    rows = peng.encode_prepared_rows(hits)
    assert calls.n == 0
    assert peng.admit_rows_cached == hit0 + N_REQ
    monkeypatch.undo()
    again = ts._drive(dec, hits, range(N_REQ))
    ts._assert_same(again, want, mode)
    ts._assert_same(again, jhit, mode)
    assert peng.admit_rows_encoded == enc0
    assert peng.admit_rows_cached >= hit0 + 2 * N_REQ
    # The hit rows are the encode's rows, bit for bit.
    fresh = peng.encode_prepared_rows([peng.prepare(p)
                                       for p in ts._payloads()])
    for a, b in zip(rows, fresh):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("fusion,mode", CASES)
def test_mixed_admission_encodes_only_the_misses(world, fusion, mode,
                                                 monkeypatch):
    """Hits and misses interleaved in one admission: only the misses run
    the encode (once, padded to a power-of-two bucket), rows come back in
    request order, every caption is the JAX run's."""
    jeng, want, _ = world[(fusion, mode)]
    peng = ts._port_engine(jeng, fusion, mode)
    payloads = ts._payloads()
    peng.encode_prepared_rows([peng.prepare(p) for p in _ids(payloads)])
    # Even requests by id, odd ones as features only (misses).
    reqs = [peng.prepare({"feature_id": f"f{i}"}) if i % 2 == 0
            else peng.prepare(payloads[i]) for i in range(N_REQ)]
    sub = [0, 1, 3, 4, 5]          # two hits, three misses -> bucket 4
    calls = _RowDotCalls(monkeypatch)
    enc0, hit0 = peng.admit_rows_encoded, peng.admit_rows_cached
    rows = peng.encode_prepared_rows([reqs[i] for i in sub])
    assert calls.n == _encode_calls(fusion)
    assert peng.admit_rows_encoded - enc0 == 3
    assert peng.admit_rows_cached - hit0 == 2
    monkeypatch.undo()
    full = peng.encode_prepared_rows([peng.prepare(payloads[i]) for i in sub])
    for a, b in zip(rows, full):
        if a is not None:
            assert torch.equal(a, b)
    got = ts._drive(peng.slot_decoder(), reqs, range(N_REQ))
    ts._assert_same(got, want, mode)


@pytest.mark.parametrize("fusion,mode", [("meanpool", "beam"),
                                         ("attention", "greedy")])
def test_slot_fuzz_with_feature_ids(world, fusion, mode):
    """The reference's admission / eviction fuzz: a continuous batcher on
    a 4-slot bank (2 under greedy's elastic ladder), requests with
    features and an id, id alone, or features alone, from threads in a
    random order with jitter; every caption equals the JAX run's, the
    bank ends clean."""
    jeng, want, _ = world[(fusion, mode)]
    # Tier 1 off, so every request reaches the slot loop.
    peng = ts._port_engine(jeng, fusion, mode, default_deadline_ms=120_000.0,
                           caption_cache_size=0)
    payloads = _ids(ts._payloads())
    peng.encode_prepared_rows([peng.prepare(p) for p in payloads[::2]])
    rng = np.random.RandomState(31)
    bodies = []
    for i in rng.permutation(N_REQ):
        kind = ("id" if i % 2 == 0 and rng.rand() < 0.7 else
                "features" if rng.rand() < 0.5 else "both")
        body = {"features": payloads[i]["features"]}
        if kind != "features":
            body["feature_id"] = f"f{i}"
        if kind == "id":
            del body["features"]
        bodies.append((int(i), body, float(rng.rand()) * 0.05))
    results, errors, lock = {}, [], threading.Lock()

    def client(i, body, delay):
        threading.Event().wait(delay)
        try:
            out = b.submit(body)
            with lock:
                results[i] = out
        except Exception as e:  # noqa: BLE001 — reported below
            with lock:
                errors.append((i, repr(e)))

    with ContinuousBatcher(peng) as b:
        ths = [threading.Thread(target=client, args=x) for x in bodies]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120.0)
    assert not errors and len(results) == N_REQ
    for i in range(N_REQ):
        np.testing.assert_array_equal(results[i]["tokens"], want[i][0],
                                      err_msg=f"request {i}")
    dec = peng.slot_decoder()
    assert not dec.occupied and sorted(dec.free) == list(range(dec.S))
    assert peng.admit_rows_cached > 0


def _hit_vs_miss(eng, payloads):
    """Tokens of ``payloads`` sent with features and an id (misses),
    then by id alone (hits), then mixed, through the slot loop."""
    dec = eng.slot_decoder()
    n = len(payloads)
    miss = ts._drive(dec, [eng.prepare(p) for p in _ids(payloads, "b")],
                     range(n))
    enc = eng.admit_rows_encoded
    hit = ts._drive(dec, [eng.prepare({"feature_id": f"b{i}"})
                          for i in range(n)], range(n))
    assert eng.admit_rows_encoded == enc
    mixed = ts._drive(dec, [eng.prepare({"feature_id": f"b{i}"}) if i % 2
                            else eng.prepare(payloads[i]) for i in range(n)],
                      range(n))
    for i in range(n):
        np.testing.assert_array_equal(hit[i][0], miss[i][0], err_msg=str(i))
        np.testing.assert_array_equal(mixed[i][0], miss[i][0], err_msg=str(i))
    return miss


@pytest.mark.parametrize("fusion,mode", CASES)
def test_bf16_hit_equals_miss(world, fusion, mode):
    jeng, _, _ = world[(fusion, mode)]
    peng = ts._port_engine(jeng, fusion, mode, dtype="bf16")
    miss = _hit_vs_miss(peng, ts._payloads())
    h = peng.prepare({"feature_id": "b0"}).enc_row
    assert h[0].dtype == torch.bfloat16
    assert len({tuple(miss[i][0]) for i in range(N_REQ)}) > 1


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_category_hit_equals_miss_and_offline(fusion):
    """``use_category``: the entry keeps the category (an id-only request's
    own ``category`` is ignored, as the reference's), the stored rows
    carry ``cat_emb``, hits decode as misses and as the offline per-step
    decode."""
    eng = tcat._port_engine(fusion, "beam", True)
    payloads = tcat._payloads(6, 2)
    miss = _hit_vs_miss(eng, payloads)
    stored = payloads[1].get("category", 0)
    hit = eng.prepare({"feature_id": "b1",
                       "category": (stored + 1) % tcat.NCAT})
    assert hit.category == stored
    assert hit.enc_row[4] is not None and hit.enc_row[4].shape == (tcat.C,)
    reqs = [eng.prepare(p) for p in payloads]
    cache = eng.encode_prepared_rows(reqs)
    r = beam_search_from_state(eng.model, eng.model.init_state(len(reqs)),
                               cache, beam_size=3, max_len=8)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(miss[i][0], r.tokens[i].numpy())


# -------------------------------------------------------------- replicas

@pytest.mark.parametrize("fusion,mode", [("meanpool", "beam"),
                                         ("attention", "greedy")])
def test_cross_replica_hit_admits_with_zero_encode(world, fusion, mode,
                                                   monkeypatch):
    """Reference ``test_cross_replica_cache_hit_admits_with_zero_encode``:
    replica 0 encodes an id, replica 1 admits it with no encode and
    decodes the JAX run's caption."""
    jeng, want, _ = world[(fusion, mode)]
    peng = ts._port_engine(jeng, fusion, mode)
    rs = ReplicaSet.from_engine(peng, n_replicas=2)
    c0, c1 = rs.replicas[0].engine, rs.replicas[1].engine
    assert c0.cache is c1.cache is peng.cache
    body = _ids(ts._payloads())[3]
    req = c0.prepare(dict(body, feature_id="xrep3"))
    c0.encode_prepared_rows([req])
    assert c0.admit_rows_encoded == 1
    req1 = c1.prepare({"feature_id": "xrep3"})
    assert req1.enc_row is not None
    calls = _RowDotCalls(monkeypatch)
    c1.encode_prepared_rows([req1])
    assert calls.n == 0
    assert (c1.admit_rows_encoded, c1.admit_rows_cached) == (0, 1)
    monkeypatch.undo()
    dec = c1.slot_decoder()
    done = dec.tick([req1], ["x"])
    while not done:
        done = dec.tick()
    _, tokens, _, _ = dec.harvest_many(done)[0]
    np.testing.assert_array_equal(tokens, want[3][0])


def test_replica_set_serves_id_only_requests(world):
    """Two replicas behind the ``ReplicaSet``: requests with features and
    an id, then the same ids alone from threads; every caption is the
    JAX run's, and the second pass encodes nothing on either replica."""
    jeng, want, _ = world[("attention", "beam")]
    peng = ts._port_engine(jeng, "attention", "beam",
                           default_deadline_ms=120_000.0,
                           caption_cache_size=0)
    rs = ReplicaSet.from_engine(peng, n_replicas=2)
    results = {}

    def run(bodies):
        lock = threading.Lock()

        def client(i):
            out = rs.submit(bodies[i])
            with lock:
                results[i] = out

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(N_REQ)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120.0)

    with rs:
        run(_ids(ts._payloads()))
        first = dict(results)
        encoded = [r.engine.admit_rows_encoded for r in rs.replicas]
        results.clear()
        run([{"feature_id": f"f{i}"} for i in range(N_REQ)])
    assert len(first) == len(results) == N_REQ
    for i in range(N_REQ):
        assert first[i]["tokens"] == results[i]["tokens"] == \
            want[i][0].tolist()
    assert [r.engine.admit_rows_encoded for r in rs.replicas] == encoded
    assert sum(r.engine.admit_rows_cached for r in rs.replicas) >= N_REQ


# ------------------------------------------------------------------ HTTP

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("tier1", [0, 4096])
def test_http_feature_id_and_unknown_id_404(world, tier1):
    """Over HTTP: an unknown id answers 404; an id-only repeat answers
    the features request's caption (from tier 1 when it is on, else
    decoded from tier 2); ``/metrics`` and ``/stats`` export the features
    tier under the reference's names."""
    jeng, want, _ = world[("meanpool", "beam")]
    peng = ts._port_engine(jeng, "meanpool", "beam",
                           caption_cache_size=tier1)
    body = {"features": {"resnet": ts._payloads()[2]["features"]["resnet"]
                         .tolist()}, "feature_id": "h2"}
    with CaptionServer(peng, port=0) as srv:
        url = srv.url + "/v1/caption"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"feature_id": "ghost"})
        assert ei.value.code == 404
        assert "ghost" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"category": 1})
        assert ei.value.code == 400
        s1, first = _post(url, body)
        s2, again = _post(url, {"feature_id": "h2"})
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    assert s1 == s2 == 200
    assert first["tokens"] == again["tokens"] == want[2][0].tolist()
    assert again["cached"] is bool(tier1)
    for k in ("hits", "misses", "size", "capacity", "bytes", "evictions"):
        assert f"caption_cache_features_{k} " in metrics, k
    feats = stats["cache"]["features"]
    assert sorted(feats) == sorted(jcache.LRUCache(1).stats())
    assert feats["size"] == 1 and feats["hits"] >= 1
    assert feats["misses"] >= 1          # the unknown id


# ------------------------------------------ the reference's stale rows

@pytest.mark.parametrize("fusion,mode", [("meanpool", "beam"),
                                         ("attention", "greedy")])
def test_resent_id_with_new_features_keeps_old_rows(world, fusion, mode):
    """Kept from the reference, not fixed: ``prepare`` reuses a cached
    id's encoder rows without comparing content keys, so a request with
    new features under that id decodes the old rows (and stores them
    beside the new features).  Both engines, the slot loop: the resent
    request decodes video A's caption, not video B's."""
    jeng, _, _ = world[(fusion, mode)]
    peng = ts._port_engine(jeng, fusion, mode)
    pa, pb = ts._payloads()[4], ts._payloads()[7]
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        dec = eng.slot_decoder()
        a = eng.prepare(dict(pa, feature_id="stale"))
        eng.encode_prepared_rows([a])          # stores A's rows
        b_fresh = eng.prepare(pb)
        b = eng.prepare(dict(pb, feature_id="stale"))
        assert b.enc_row is not None
        assert b.cache_key == b_fresh.cache_key
        entry = eng.cache.features.get("stale")
        np.testing.assert_array_equal(entry["feats"]["resnet"],
                                      b_fresh.feats["resnet"])
        got = ts._drive(dec, [a, b, b_fresh], range(3))
        out[name] = [got[i][0] for i in range(3)]
    for name in out:
        ta, tb, tb_fresh = out[name]
        np.testing.assert_array_equal(tb, ta, err_msg=name)
        assert not np.array_equal(tb, tb_fresh), name
    for x, y in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(x, y)
