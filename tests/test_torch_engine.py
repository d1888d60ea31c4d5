"""The serving slice as a whole: the port's ladder engine against the JAX
package's, on the same weights and the same requests.

A JAX ``InferenceEngine`` (``synthetic_smoke``, ``continuous=False``,
``random_init=True``) provides the parameters; the port's engine gets
them through the weight bridge, on the CPU, where its decode kernels take
their plain versions.  At float32, captions and tokens must match
exactly in beam and greedy mode.  The HTTP front end is driven once over
a real socket.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest

from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.server import CaptionServer


def _cfgs(mode):
    jc = jax_preset("synthetic_smoke")
    pc = get_preset("synthetic_smoke")
    for c in (jc, pc):
        c.serving.continuous = False
        c.serving.warmup = False
        c.serving.decode_mode = mode
    return jc, pc


@pytest.fixture(scope="module")
def jax_engines():
    out = {}
    for mode in ("beam", "greedy"):
        jc, _ = _cfgs(mode)
        out[mode] = JaxEngine(jc, random_init=True)
    return out


def _port_engine(jeng, mode):
    _, pc = _cfgs(mode)
    params = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    vocab = Vocabulary(jeng.vocab.idx_to_word[4:])
    return InferenceEngine(pc, params=params, vocab=vocab, device="cpu")


def _payloads(n, dim=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        frames = int(rng.choice([1, 3, 6, 9]))   # 9 > max_frames: subsample
        out.append({"features": {
            "resnet": (rng.randn(frames, dim) * 2.0).astype(np.float32)}})
    return out


@pytest.mark.parametrize("mode", ["beam", "greedy"])
@pytest.mark.parametrize("n", [3, 8])
def test_engine_token_exact_vs_jax(jax_engines, mode, n):
    jeng = jax_engines[mode]
    peng = _port_engine(jeng, mode)
    assert peng.params_tag == jeng.params_tag
    payloads = _payloads(n, seed=n)
    jreqs = [jeng.prepare(p) for p in payloads]
    preqs = [peng.prepare(p) for p in payloads]
    for a, b in zip(jreqs, preqs):
        assert a.cache_key == b.cache_key
    jres = jeng.decode_prepared(jreqs, store=False)
    pres = peng.decode_prepared(preqs, store=False)
    assert [r.tokens for r in pres] == [r.tokens for r in jres]
    assert [r.caption for r in pres] == [r.caption for r in jres]
    assert any(r.caption for r in pres)


def test_http_server_serves_and_caches(jax_engines):
    peng = _port_engine(jax_engines["beam"], "beam")
    payload = _payloads(1, seed=3)[0]
    body = json.dumps({"features": {
        "resnet": payload["features"]["resnet"].tolist()}}).encode()
    with CaptionServer(peng, port=0) as srv:
        def post():
            req = urllib.request.Request(
                srv.url + "/v1/caption", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        first, second = post(), post()
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    assert first["cached"] is False and second["cached"] is True
    assert first["tokens"] == second["tokens"]
    assert isinstance(first["caption"], str)
    assert len(first["tokens"]) == peng.cfg.eval.max_decode_len
    assert "caption_latency_queue_ms_bucket" in metrics
    assert "caption_latency_device_ms_bucket" in metrics
    assert "caption_requests_served_total 2" in metrics
    assert health["status"] == "ok" and health["continuous"] is False


def test_bad_request_is_a_value_error(jax_engines):
    peng = _port_engine(jax_engines["greedy"], "greedy")
    with pytest.raises(ValueError):
        peng.prepare({"features": {"resnet": np.zeros((3, 5))}})
    with pytest.raises(ValueError):
        peng.prepare({"features": {}})
    with pytest.raises(ValueError, match="ROADMAP"):
        peng.prepare({"feature_id": "never-seen"})


def test_caption_cache_lru_bounds():
    from cst_captioning_torch.serving.cache import LRUCache

    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # a is now most recent
    c.put("c", 3)                   # evicts b
    assert c.get("b") is None and c.get("c") == 3
    st = c.stats()
    assert (st["hits"], st["misses"], st["evictions"], st["size"]) == (2, 1, 1, 2)
