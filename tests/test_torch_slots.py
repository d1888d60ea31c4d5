"""The continuous slot loop: the port's ``SlotDecoder`` against the JAX
package's, the port's offline per-step decode, and the HTTP front end
over ``ContinuousBatcher``.

Both engines run ``synthetic_smoke`` on the CPU in float32 on the same
weights (the JAX engine's random init through the weight bridge) and
the same prepared requests.  The random init decodes one repeated word
to the length cap, so its embeddings, recurrence and vocab projection
are scaled up and EOS is favoured (``_spread``): captions then differ
and end at different steps, and slots free at different ticks.  The
JAX model has
``use_pallas_attention=True``; beam width 4 with banks of 2 and 4 slots
(8 and 16 rows) and greedy banks of 8 and 16 rows keep its step batch a
multiple of 8, so its ``fused_context_attention`` kernel runs (interpret
mode) rather than the dense fallback.  One JAX run per fusion and mode
is the reference: its tokens do not depend on arrival order, cache
layout or bank size (the reference's own parity tests).  The port is
held to it token for token, scores within float32 rounding (rtol 1e-5),
under fuzzed arrival orders, with the deduplicated and the replicated
cache, with elastic and fixed banks, and with 1 and 2 steps per tick.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.ops import pallas_attention as jpa
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import beam_search_from_state
from cst_captioning_torch.serving.batcher import (
    ContinuousBatcher,
    ShuttingDownError,
)
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.server import CaptionServer
from cst_captioning_torch.serving.slots import AdmissionError, SlotDecoder

N_REQ = 12
CASES = [(f, m) for f in ("attention", "meanpool") for m in ("beam", "greedy")]


def _cfg(get, fusion, mode, **serving):
    c = get("synthetic_smoke")
    c.model.feature_fusion = fusion
    c.model.use_pallas_attention = True
    c.eval.beam_size = 4
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode = True, False, mode
    if mode == "beam":
        sv.num_slots, sv.slot_bank_min = 4, 2
    else:
        sv.num_slots, sv.slot_bank_min = 16, 8
    sv.slot_shrink_idle_ticks = 2
    for k, v in serving.items():
        setattr(sv, k, v)
    return c


def _payloads(seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 10)), 64)
                                     * 2.0).astype(np.float32)}}
            for _ in range(N_REQ)]


def _drive(dec, reqs, order, rng=None):
    """Decode ``reqs`` through ``dec``, admitting in ``order``: 1-2 per
    tick (staggered), or a fuzzed 0..cap per tick with ``rng``.  Returns
    {index: (tokens, score, steps)}."""
    got = {}
    pending = list(order)
    k = 0
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        cap = min(len(pending), len(dec.free), dec.admit_cap)
        if rng is None:
            n = min(1 + k % 2, cap)
        else:
            n = int(rng.randint(0, cap + 1)) if cap else 0
            if n == 0 and not dec.occupied:
                n = min(1, cap)
        k += 1
        adm = [pending.pop(0) for _ in range(n)]
        for i, tokens, score, steps in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            assert 0 < steps <= dec.L
            got[i] = (np.asarray(tokens), score, steps)
    assert sorted(got) == sorted(order)
    return got


def _spread(jeng, mode):
    """Scale the JAX engine's random weights (embeddings x10, LSTM x2,
    vocab projection x3) and raise the EOS bias (beam 1.0, greedy
    0.6)."""
    pp = dict(jax.tree.map(np.asarray, jax.device_get(jeng.params))["params"])
    pp["word_embed"] = pp["word_embed"] * 10.0
    pp["lstm0_w"] = pp["lstm0_w"] * 2.0
    pp["logit_w"] = pp["logit_w"] * 3.0
    b = pp["logit_b"].copy()
    b[2] += 1.0 if mode == "beam" else 0.6
    pp["logit_b"] = b
    jeng.params = jax.tree.map(jnp.asarray, {"params": pp})


@pytest.fixture(scope="module")
def refs():
    """Per (fusion, mode): the JAX engine, its slot-loop results, and
    how often its context kernel was traced."""
    out = {}
    traced = []
    inner = jpa._fused_fwd_call

    def counting(*a, **kw):
        traced.append(1)
        return inner(*a, **kw)

    jpa._fused_fwd_call = counting
    try:
        for fusion, mode in CASES:
            del traced[:]
            jeng = JaxEngine(_cfg(jax_preset, fusion, mode), random_init=True)
            _spread(jeng, mode)
            reqs = [jeng.prepare(p) for p in _payloads()]
            got = _drive(jeng.slot_decoder(), reqs, range(N_REQ))
            out[(fusion, mode)] = (jeng, got, len(traced))
    finally:
        jpa._fused_fwd_call = inner
    return out


def _port_engine(jeng, fusion, mode, **serving):
    params = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    vocab = Vocabulary(jeng.vocab.idx_to_word[4:])
    return InferenceEngine(_cfg(get_preset, fusion, mode, **serving),
                           params=params, vocab=vocab, device="cpu")


def _assert_same(got, want, mode):
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], want[i][0],
                                      err_msg=f"request {i}")
        if mode == "beam":
            np.testing.assert_allclose(got[i][1], want[i][1], rtol=1e-5,
                                       atol=1e-6)


def test_jax_reference_runs_its_kernel(refs):
    for fusion, mode in CASES:
        jeng, got, n = refs[(fusion, mode)]
        assert (n > 0) == (fusion == "attention"), (fusion, mode, n)
        steps = {got[i][2] for i in range(N_REQ)}
        assert len(steps) > 1 or fusion == "meanpool", (fusion, mode, steps)


VARIANTS = {
    "staggered": dict(),
    "fuzz7": dict(fuzz=7),
    "fuzz19_reversed": dict(fuzz=19, reverse=True),
    "replicated_cache": dict(fuzz=3, serving=dict(dedup_cache=False)),
    "fixed_bank": dict(fuzz=11, serving=dict(slot_bank_min=0)),
    "block1": dict(fuzz=5, serving=dict(slot_block_steps=1)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fusion,mode", CASES)
def test_slot_loop_matches_jax(refs, fusion, mode, variant):
    v = VARIANTS[variant]
    jeng, want, _ = refs[(fusion, mode)]
    peng = _port_engine(jeng, fusion, mode, **v.get("serving", {}))
    dec = peng.slot_decoder()
    reqs = [peng.prepare(p) for p in _payloads()]
    order = list(range(N_REQ))[::-1] if v.get("reverse") else range(N_REQ)
    rng = np.random.RandomState(v["fuzz"]) if "fuzz" in v else None
    got = _drive(dec, reqs, order, rng)
    _assert_same(got, want, mode)
    if len(dec.bank_ladder) > 1:
        assert dec.resize_count >= 1
    assert dec.state_bytes() == dec.expected_state_bytes()
    assert dec.live_state_bytes() == 0 and not dec.occupied


@pytest.mark.parametrize("fusion,mode", CASES)
def test_slot_loop_equals_offline_per_step_decode(refs, fusion, mode):
    """The served rows are the offline per-step decode's
    (``beam_search_from_state`` / ``_sample_from_cache``) of the same
    requests, encoded together."""
    jeng, _, _ = refs[(fusion, mode)]
    peng = _port_engine(jeng, fusion, mode)
    reqs = [peng.prepare(p) for p in _payloads()]
    got = _drive(peng.slot_decoder(), reqs, range(N_REQ),
                 np.random.RandomState(23))
    m, ev = peng.model, peng.cfg.eval
    cache = peng.encode_prepared_rows(reqs)
    state = m.init_state(N_REQ)
    if mode == "beam":
        r = beam_search_from_state(m, state, cache, beam_size=ev.beam_size,
                                   max_len=ev.max_decode_len,
                                   length_normalize=ev.length_normalize)
        toks, scores = r.tokens.numpy(), r.score.numpy()
    else:
        toks = m._sample_from_cache(state, cache,
                                    max_len=ev.max_decode_len).tokens.numpy()
        scores = None
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], toks[i])
        if scores is not None:
            assert got[i][1] == pytest.approx(float(scores[i]), rel=1e-6)


def test_bank_resizes_keep_in_flight_rows(refs):
    """Grow under a burst, shrink after idle ticks: the served tokens
    stay the reference's, and a shrink never drops an occupied slot."""
    jeng, want, _ = refs[("attention", "beam")]
    peng = _port_engine(jeng, "attention", "beam")
    dec = peng.slot_decoder()
    reqs = [peng.prepare(p) for p in _payloads()]
    got = {}
    dec.maybe_resize(8)
    assert dec.S == 4
    for i, tokens, score, _ in dec.harvest_many(
            dec.tick(reqs[:4], [0, 1, 2, 3])):
        got[i] = (tokens, score)
    while dec.occupied:
        for slot in dec.tick():
            i = dec.occupied[slot]
            tokens, score, steps = dec.harvest(slot)
            got[i] = (tokens, score)
            assert 0 < steps <= dec.L
        dec.maybe_resize(0)
    for _ in range(dec.shrink_after):
        dec.maybe_resize(0)
    assert dec.S == 2 and dec.resize_count == 2
    for i in range(4):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    with pytest.raises(RuntimeError, match="exceeds"):
        dec.tick(reqs[:3], [0, 1, 2])


def test_dedup_stores_one_cache_row_per_slot(refs):
    """The deduplicated layout stores a beam slot's cache once: its cache
    bytes are the replicated layout's over K, its carry bytes the same."""
    jeng, _, _ = refs[("attention", "beam")]
    dedup = _port_engine(jeng, "attention", "beam").slot_decoder()
    repl = _port_engine(jeng, "attention", "beam",
                        dedup_cache=False).slot_decoder()
    assert repl.cache_bytes() == dedup.K * dedup.cache_bytes()
    assert repl.carry_bytes() == dedup.carry_bytes()
    for d in (dedup, repl):
        assert d.state_bytes() == d.expected_state_bytes()
        assert d.per_slot_bytes() * d.S == d.state_bytes()


def test_engine_describes_the_slot_loop(refs):
    jeng, _, _ = refs[("attention", "greedy")]
    peng = _port_engine(jeng, "attention", "greedy")
    d = peng.describe()
    assert d["continuous"] is True and d["num_slots"] == 16
    s = peng.slot_decoder().describe()
    assert s["bank_ladder"] == [8, 16] and s["rows_per_slot"] == 1
    assert s["state_bytes"] == peng.slot_decoder().expected_state_bytes()
    assert isinstance(peng.slot_decoder(), SlotDecoder)


def _post(url, payload):
    body = json.dumps({"features": {
        k: v.tolist() for k, v in payload["features"].items()}}).encode()
    req = urllib.request.Request(url + "/v1/caption", data=body,
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_http_continuous_serving_and_drain(refs, mode):
    """ContinuousBatcher behind CaptionServer: concurrent requests come
    back with the reference's tokens; a shutdown while requests are in
    flight drains them (every one answered); /metrics carries the slot
    families."""
    jeng, want, _ = refs[("attention", mode)]
    peng = _port_engine(jeng, "attention", mode, warmup=True)
    payloads = _payloads()
    out = [None] * N_REQ
    srv = CaptionServer(peng, port=0).start()

    def worker(i):
        out[i] = _post(srv.url, payloads[i])

    try:
        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(N_REQ - 4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        late = [threading.Thread(target=worker, args=(i,))
                for i in range(N_REQ - 4, N_REQ)]
        for t in late:
            t.start()
        while srv.metrics.requests_total.value < N_REQ:
            threading.Event().wait(0.005)
    finally:
        srv.shutdown()
    for t in late:
        t.join()
    for i in range(N_REQ):
        assert out[i]["cached"] is False
        assert out[i]["tokens"] == [int(x) for x in want[i][0]], i
        assert isinstance(out[i]["caption"], str)
    assert health["continuous"] is True
    for fam in ("caption_slots_admitted_total", "caption_slot_bank_size",
                "caption_latency_admission_ms_bucket",
                "caption_steps_per_caption_bucket",
                "caption_decode_state_bytes"):
        assert fam in metrics, fam
    assert srv.metrics.requests_served.value == N_REQ
    assert srv.metrics.slots_admitted_total.value == N_REQ


def test_admission_failure_is_not_fatal_but_a_step_failure_is(refs):
    """A failed admission encode fails only its request and claims no
    slot; a decode step that fails after slots are claimed fails what is
    in flight and stops the scheduler."""
    jeng, want, _ = refs[("meanpool", "greedy")]
    peng = _port_engine(jeng, "meanpool", "greedy")
    payloads = _payloads()
    encode = peng.encode_prepared_rows
    calls = []

    def bad_once(reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise ValueError("bad row")
        return encode(reqs)

    peng.encode_prepared_rows = bad_once
    b = ContinuousBatcher(peng).start()
    try:
        with pytest.raises(AdmissionError, match="bad row"):
            b.submit(payloads[0])
        dec = peng.slot_decoder()
        assert not dec.occupied and len(dec.free) == dec.S
        assert b.submit(payloads[1])["tokens"] == [int(x) for x in want[1][0]]

        def lost():
            raise RuntimeError("device lost")

        dec._step_once = lost
        with pytest.raises(RuntimeError, match="scheduler step failed"):
            b.submit(payloads[2])
        b._thread.join(timeout=30)
        assert not b._thread.is_alive() and not dec.occupied
        with pytest.raises(ShuttingDownError):
            b.submit(payloads[3])
        assert b.metrics.requests_failed.value == 2
    finally:
        b.stop()
