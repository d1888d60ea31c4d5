"""int8w serving, end to end on the CPU: the port's weight_quant model
against the JAX package's on the same quantized weights, and the port's
int8w engine (ladder and slot loop) against the JAX package's
``InferenceEngine`` at ``serving.dtype = int8w`` and against its own f32
build.

Tolerances:

* model at float32 compute with int8 weights (``_encode``'s att_proj,
  one ``_step`` with its context and ``_logits``, the teacher-forced
  forward through the two int8w recurrences): rtol / atol 1e-5 — the
  float paths' tier (tests/test_torch_attdecode.py): float32 products
  summed in another library's order;
* served captions at int8w (bfloat16 compute), ladder and slot loop,
  against the JAX int8w engine's ladder and against the port's own f32
  engine: the reference's relaxed-serving caption-match floor (>= 0.75,
  ``analysis/jit_registry.py``; the engines return no scores, and the
  decoders' scores are held in tests/test_torch_quant_kernels.py).  On
  these spread random weights the port reads 1.0 against the JAX int8w
  engine and 0.75-1.0 against its own f32;
* the int8w slot loop against the port's offline per-step decode of the
  same requests: token-exact (the loop's rows do not depend on which
  other rows share a step);
* declines: an int8w build refuses exactly what the f32 build refuses
  (the reference's pin in tests/test_quant_fused.py);
* quantize once: an engine given an already quantized tree keeps its
  codes and scales (scale hashes equal, no second quantization).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
)
from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.models.captioner import CaptionModel as JaxModel
from cst_captioning_tpu.ops import quant as jq
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import beam_search_from_state
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.ops import quant as tq
from cst_captioning_torch.serving import engine as engine_mod
from cst_captioning_torch.serving.engine import InferenceEngine

MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
E, H, A, V, D1, D2, FR = 16, 16, 24, 40, 24, 32, 5
N_REQ = 12
FUSIONS = ("meanpool", "attention")


# ------------------------------------------------------------- model

def _models(fusion):
    kw = dict(vocab_size=V, rnn_size=H, embed_size=E,
              modalities=("resnet", "c3d"), feature_dims=(D1, D2),
              fusion=fusion, att_hidden_size=A, compute_dtype="float32")
    jm = JaxModel(drop_prob=0.0, weight_quant=True, use_pallas=True,
                  use_pallas_attention=True, **kw)
    pm = CaptionModel(weight_quant=True, device="cpu", **kw)
    return jm, pm


def _feats(B, seed):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(B, FR, D1).astype(np.float32),
             "c3d": rng.randn(B, FR, D2).astype(np.float32)}
    masks = {m: (rng.rand(B, FR) > 0.3).astype(np.float32) for m in feats}
    for m in masks:
        masks[m][:, 0] = 1.0
    masks["resnet"][1, 2:] = 0.0
    return feats, masks


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=FUSIONS)
def quant_model(request):
    """(fusion, JAX model, its int8w params, the port model loaded with
    them): a float init quantized by the JAX quantizer."""
    fusion = request.param
    jm, pm = _models(fusion)
    float_m = JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                       modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                       fusion=fusion, att_hidden_size=A,
                       compute_dtype="float32")
    feats, masks = _feats(8, 0)
    params = float_m.init(jax.random.PRNGKey(1), _j(feats), _j(masks),
                          jnp.zeros((8, 2), jnp.int32))
    qp = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(np.asarray, params)))
    load_params(pm, qp)
    pm.requires_grad_(False)
    return fusion, jm, qp, pm


def test_model_layout_matches_reference(quant_model):
    fusion, _, qp, pm = quant_model
    sd = pm.state_dict()
    assert set(sd) == set(qp["params"])
    for name in ("word_embed", "logit_w", "lstm0_w"):
        assert sd[name].dtype == torch.int8
        assert not getattr(pm, name).requires_grad
    assert ("att_wh" in sd) == (fusion == "attention")
    if fusion == "attention":
        assert sd["att_wh"].dtype == sd["att_wf"].dtype == torch.int8
        assert sd["att_v"].dtype == torch.float32
    fresh = _models(fusion)[1]
    assert all(torch.equal(fresh.get_parameter(n).detach(),
                           torch.ones_like(sd[n]))
               for n in sd if n.endswith("_scale"))


def test_encode_step_logits_match_jax(quant_model):
    _, jm, qp, pm = quant_model
    feats, masks = _feats(3, 2)
    state, cache = jm.apply(qp, _j(feats), _j(masks), method="init_decode")
    tokens = jnp.asarray([1, 7, 12], jnp.int32)
    _, jlogits = jm.apply(qp, state, cache, tokens, method="decode_logits")
    pstate, pcache = pm.init_decode(_t(feats), _t(masks))
    np.testing.assert_allclose(pcache.ctx_static.numpy(),
                               np.asarray(cache.ctx_static), **MODEL_TOL)
    if pcache.att_proj is not None:
        np.testing.assert_allclose(pcache.att_proj.numpy(),
                                   np.asarray(cache.att_proj), **MODEL_TOL)
    _, plogits = pm.decode_logits(pstate, pcache, torch.tensor([1, 7, 12]))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    # the same step under autograd's products (dot_f32) and _logits
    with torch.enable_grad():
        _, h_top = pm._step(pstate, pcache, torch.tensor([1, 7, 12]))
        glogits = pm.mask_decode_logits(pm._logits(h_top))
    np.testing.assert_allclose(glogits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)


@pytest.mark.parametrize("B,repeat,T", [(4, 2, 6), (8, 1, 5)])
def test_teacher_forced_forward_matches_jax(quant_model, B, repeat, T):
    """The JAX ``__call__`` under ``weight_quant`` (its int8w recurrence
    kernels in interpret mode) against the port's forward, which runs
    ``lstm_recurrence_quant`` / ``attlstm_recurrence_quant``."""
    _, jm, qp, pm = quant_model
    feats, masks = _feats(B, B)
    ids = np.random.RandomState(T).randint(4, V, (B * repeat, T))
    ids[:, 0] = 1
    want = jm.apply(qp, _j(feats), _j(masks),
                    jnp.asarray(ids, jnp.int32), repeat=repeat)
    got = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
             repeat=repeat)
    assert got.shape == (B * repeat, T, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_quantized_forward_refuses_autograd(quant_model):
    _, _, _, pm = quant_model
    feats, masks = _feats(2, 3)
    pm.proj_resnet_w.requires_grad_(True)
    try:
        with pytest.raises(RuntimeError, match="forward-only"):
            pm(_t(feats), _t(masks), torch.ones((2, 3), dtype=torch.long))
    finally:
        pm.proj_resnet_w.requires_grad_(False)


# ------------------------------------------------------------ engines

def _cfg(get, fusion, mode, dtype, continuous):
    c = get("synthetic_smoke")
    c.model.feature_fusion = fusion
    c.eval.beam_size = 3
    sv = c.serving
    sv.warmup, sv.decode_mode, sv.dtype = False, mode, dtype
    sv.continuous = continuous
    sv.num_slots, sv.slot_bank_min = 8, 4
    return c


def _spread(params, mode):
    """Spread the random init's captions (embeddings x10, LSTM x2, vocab
    x3, an EOS bias) so they differ and end at different steps, as
    tests/test_torch_slots.py does."""
    pp = dict(jax.tree.map(np.asarray, jax.device_get(params))["params"])
    pp["word_embed"] = pp["word_embed"] * 10.0
    pp["lstm0_w"] = pp["lstm0_w"] * 2.0
    pp["logit_w"] = pp["logit_w"] * 3.0
    b = pp["logit_b"].copy()
    b[2] += 1.0 if mode == "beam" else 0.6
    pp["logit_b"] = b
    return {"params": pp}


def _payloads(seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 10)), 64)
                                     * 2.0).astype(np.float32)}}
            for _ in range(N_REQ)]


def _ladder(eng, payloads):
    reqs = [eng.prepare(p) for p in payloads]
    out = []
    for i in range(0, len(reqs), eng.max_batch):
        out += eng.decode_prepared(reqs[i:i + eng.max_batch], store=False)
    return [np.asarray(r.tokens) for r in out]


def _slots(eng, payloads):
    dec = eng.slot_decoder()
    reqs = [eng.prepare(p) for p in payloads]
    got, pending = {}, list(range(len(reqs)))
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(2, len(pending), len(dec.free), dec.admit_cap)
        adm = [pending.pop(0) for _ in range(n)]
        for i, tokens, score, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = (np.asarray(tokens), score)
    return [got[i][0] for i in range(len(reqs))], got


def _match(a, b):
    n = max(len(a[0]), len(b[0]))
    pad = lambda t: np.pad(t, (0, n - len(t)))  # noqa: E731
    return float(np.mean([np.array_equal(pad(x), pad(y))
                          for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def worlds():
    """Per (fusion, mode): the spread float weights, the JAX int8w
    engine's ladder tokens, and the vocabulary."""
    out = {}
    for fusion in FUSIONS:
        for mode in ("beam", "greedy"):
            base = JaxEngine(_cfg(jax_preset, fusion, mode, "f32", False),
                             random_init=True)
            params = _spread(base.params, mode)
            jeng = JaxEngine(_cfg(jax_preset, fusion, mode, "int8w", False),
                             params=jax.tree.map(jnp.asarray, params),
                             vocab=base.vocab)
            out[(fusion, mode)] = dict(
                params=params, vocab=Vocabulary(base.vocab.idx_to_word[4:]),
                jax_tokens=_ladder(jeng, _payloads()),
                jax_hashes=jq.scale_hashes(jeng.params))
    return out


def _port(world, fusion, mode, dtype, continuous, params=None):
    return InferenceEngine(
        _cfg(tcfg.get_preset, fusion, mode, dtype, continuous),
        params=world["params"] if params is None else params,
        vocab=world["vocab"], device="cpu")


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_served_captions_relaxed_vs_jax_and_own_f32(worlds, fusion, mode):
    w = worlds[(fusion, mode)]
    ladder = _port(w, fusion, mode, "int8w", False)
    assert ladder.model.weight_quant
    assert ladder.model.compute_dtype == torch.bfloat16
    assert tq.scale_hashes(ladder.model.state_dict()) == w["jax_hashes"]
    lt = _ladder(ladder, _payloads())
    st, _ = _slots(_port(w, fusion, mode, "int8w", True), _payloads())
    f32 = _ladder(_port(w, fusion, mode, "f32", False), _payloads())
    for got in (lt, st):
        assert _match(got, w["jax_tokens"]) >= RELAXED_SERVING_MATCH_FLOOR
        assert _match(got, f32) >= RELAXED_SERVING_MATCH_FLOOR


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_int8w_slot_loop_equals_offline_per_step_decode(worlds, fusion,
                                                        mode):
    w = worlds[(fusion, mode)]
    eng = _port(w, fusion, mode, "int8w", True)
    toks, got = _slots(eng, _payloads())
    m, ev = eng.model, eng.cfg.eval
    reqs = [eng.prepare(p) for p in _payloads()]
    cache = eng.encode_prepared_rows(reqs)
    state = m.init_state(N_REQ)
    if mode == "beam":
        r = beam_search_from_state(m, state, cache, beam_size=ev.beam_size,
                                   max_len=ev.max_decode_len,
                                   length_normalize=ev.length_normalize)
        want = r.tokens.numpy()
    else:
        want = m._sample_from_cache(state, cache,
                                    max_len=ev.max_decode_len).tokens.numpy()
    for i in range(N_REQ):
        np.testing.assert_array_equal(toks[i], want[i], err_msg=f"req {i}")
    dec = eng.slot_decoder()
    assert dec.state_bytes() == dec.expected_state_bytes()


# --------------------------------------------------- declines and boot

@pytest.mark.parametrize("override", [
    {},
    {"model.feature_fusion": "attention"},
    {"serving.decode_mode": "greedy", "serving.continuous": True},
    {"serving.model_shards": 2},
    {"serving.replicas": 2},
    {"serving.speculative": {"draft_k": 2, "draft_hidden": 8},
     "serving.decode_mode": "greedy"},
    {"model.num_layers": 2},
    {"model.use_category": True},
])
def test_int8w_refuses_nothing_f32_serves(override):
    """The reference's decline-equality pin: an int8w build and an f32
    build of the same configuration either both build or both refuse,
    with the same message (no refusal mentions quantization)."""
    vocab = Vocabulary([f"w{i}" for i in range(40)])
    outcome = {}
    for dtype in ("f32", "int8w"):
        cfg = tcfg.get_preset("synthetic_smoke").replace(
            **{"serving.continuous": False, "serving.warmup": False,
               **override, "serving.dtype": dtype})
        try:
            InferenceEngine(cfg, random_init=True, vocab=vocab, device="cpu")
            outcome[dtype] = "served"
        except (NotImplementedError, ValueError) as e:
            outcome[dtype] = str(e)
            assert "quant" not in str(e)
    assert outcome["f32"] == outcome["int8w"]
    if "serving.model_shards" in override:
        # A sharded engine needs its devices: one CPU device refuses.
        assert "needs that many devices" in outcome["int8w"]


def test_quantize_once_keeps_a_quantized_tree(monkeypatch):
    """An engine given an already quantized tree (percentile scales)
    keeps its codes and scales: an absmax requantization would change
    the scales; no quantization runs at boot."""
    vocab = Vocabulary([f"w{i}" for i in range(40)])
    cfg = tcfg.get_preset("synthetic_smoke").replace(
        **{"serving.continuous": False, "serving.warmup": False,
           "serving.dtype": "int8w"})
    float_eng = InferenceEngine(cfg.replace(**{"serving.dtype": "f32"}),
                                random_init=True, vocab=vocab, device="cpu")
    tree = tq.quantize_params(float_eng.model.state_dict(), "percentile")
    absmax = tq.quantize_params(float_eng.model.state_dict(), "absmax")
    assert tq.scale_hashes(tree) != tq.scale_hashes(absmax)
    calls = []
    monkeypatch.setattr(engine_mod, "quantize_params",
                        lambda *a, **k: calls.append(1) or absmax)
    eng = InferenceEngine(cfg, params=tree, vocab=vocab, device="cpu")
    assert calls == []
    assert tq.scale_hashes(eng.model.state_dict()) == tq.scale_hashes(tree)
    assert torch.equal(eng.model.logit_w, tree["logit_w"])
    # a float tree is quantized exactly once, per serving.quant_calibration
    InferenceEngine(cfg, params=float_eng.model.state_dict(), vocab=vocab,
                    device="cpu")
    assert calls == [1]


@pytest.mark.parametrize("fusion", FUSIONS)
def test_describe_reports_dtype_and_param_bytes(fusion):
    vocab = Vocabulary([f"w{i}" for i in range(40)])
    out = {}
    for dtype in ("f32", "bf16", "int8w"):
        cfg = tcfg.get_preset("synthetic_smoke").replace(
            **{"serving.continuous": False, "serving.warmup": False,
               "serving.dtype": dtype, "model.feature_fusion": fusion})
        eng = InferenceEngine(cfg, random_init=True, vocab=vocab,
                              device="cpu")
        d = eng.describe()
        assert d["serving_dtype"] == dtype == d["build"]["serving_dtype"]
        assert (dtype == "f32") == ("|dt" not in eng.params_tag)
        out[dtype] = (d["param_bytes_per_shard"], eng.model)
    assert out["bf16"][1].compute_dtype == torch.bfloat16
    f32_bytes, f32_model = out["f32"]
    q_bytes, q_model = out["int8w"]
    want = 0
    for name, p in f32_model.state_dict().items():
        axis = tq.quant_axis(name)
        if axis is None:
            want += p.numel() * 4
        else:
            codes, scales = tq.quantized_leaf_bytes(tuple(p.shape), axis)
            want += codes + scales
            assert codes == p.numel() * 4 // 4
    assert q_bytes == want and f32_bytes == out["bf16"][0]
    assert q_bytes < f32_bytes
