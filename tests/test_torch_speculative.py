"""Speculative greedy decode in the port (``decoding/speculative.py``,
``CaptionModel.decode_verify``, the spec rounds of ``serving/
slots.py``) against the JAX package's, on the CPU.

* ``spec_round`` on synthetic draft / verify functions (every branch of
  the rejection rule: full, partial and no acceptance, EOS inside the
  accepted prefix and at the disagreement, rows out of room, finished
  and full rows) equals the JAX ``spec_round`` on the same numbers;
* ``decode_verify`` and ``draft_step`` on the bridged weights equal the
  JAX twins (f32 rtol 1e-5), and the verify's rows are the port's own k
  chained ``decode_logits`` steps;
* the spec ``SlotDecoder`` (``synthetic_smoke`` widths, 1 and 2 layers,
  both fusions, f32 at the spread init of ``test_torch_slots``) is
  token-exact against the JAX spec ``SlotDecoder`` (k = 3, with its
  acceptance totals equal) and against the port's plain greedy slot
  loop under fuzzed staggered arrivals, for k in {2, 3, 4}, 1 and 2
  rounds a tick, fixed and elastic banks, and int8w;
* the truncation draft bitwise the JAX one for f32 and int8w trees, the
  ``.npz`` read and written by either package, the refusals, and
  warmup left out of the totals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.decoding import core as jcore
from cst_captioning_tpu.decoding import speculative as jspec
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding import core as tcore
from cst_captioning_torch.decoding import speculative as tspec
from cst_captioning_torch.serving.engine import InferenceEngine

from test_torch_slots import N_REQ, _cfg, _drive, _payloads, _spread

K_REF = 3
HIDDEN = 8


def _spec_cfg(get, fusion, layers=1, k=K_REF, dtype="f32", **serving):
    c = _cfg(get, fusion, "greedy", **serving)
    c.model.num_layers = layers
    c.serving.dtype = dtype
    c.serving.speculative = {"draft_k": k, "draft_hidden": HIDDEN}
    return c


def _spread_layers(jeng, layers):
    _spread(jeng, "greedy")
    if layers > 1:
        pp = dict(jax.tree.map(np.asarray,
                               jax.device_get(jeng.params))["params"])
        pp["lstm1_w"] = pp["lstm1_w"] * 4.0
        jeng.params = jax.tree.map(jnp.asarray, {"params": pp})
        jeng.draft_params = {k: jnp.asarray(v) for k, v in
                             jspec.make_draft_params(jeng.params,
                                                     HIDDEN).items()}


def _port(jeng, fusion, layers=1, k=K_REF, dtype="f32", spec=True,
          **serving):
    params = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    cfg = _spec_cfg(get_preset, fusion, layers, k, dtype, **serving)
    if not spec:
        cfg.serving.speculative = {}
    return InferenceEngine(cfg, params=params, device="cpu",
                           vocab=Vocabulary(jeng.vocab.idx_to_word[4:]))


CASES = [("attention", 1), ("meanpool", 1), ("meanpool", 2),
         ("attention", 2)]


@pytest.fixture(scope="module")
def refs():
    """Per (fusion, layers): the JAX spec engine (spread weights, its
    draft re-truncated from them) and its spec slot loop's results and
    acceptance totals."""
    out = {}
    for fusion, layers in CASES:
        jeng = JaxEngine(_spec_cfg(jax_preset, fusion, layers),
                         random_init=True)
        _spread_layers(jeng, layers)
        jeng.draft_params = {k: jnp.asarray(v) for k, v in
                             jspec.make_draft_params(jeng.params,
                                                     HIDDEN).items()}
        dec = jeng.slot_decoder()
        reqs = [jeng.prepare(p) for p in _payloads()]
        got = _drive(dec, reqs, range(N_REQ))
        out[(fusion, layers)] = (jeng, got, dec.spec_stats())
    return out


# ----------------------------------------------------- the rejection rule

G, KR, L, V, HD, H = 7, 4, 7, 12, 3, 2
# Per row: the model's picks m (k positions) and the draft's proposals.
_M = np.array([
    [5, 6, 7, 8],     # full acceptance
    [5, 6, 9, 8],     # two accepted, disagreement at 2
    [5, 6, 7, 8],     # none accepted
    [5, 2, 7, 8],     # EOS inside the accepted prefix
    [5, 6, 2, 8],     # EOS at the disagreement position
    [5, 6, 7, 8],     # a finished row
    [5, 6, 7, 8],     # no room left past two tokens
], np.int64)
_P = np.array([
    [5, 6, 7, 4],
    [5, 6, 7, 4],
    [4, 6, 7, 8],
    [5, 2, 7, 8],
    [5, 6, 9, 8],
    [5, 6, 7, 8],
    [5, 6, 7, 8],
], np.int64)
_STEP = np.array([0, 2, 6, 0, 1, 3, 5], np.int32)
_FIN = np.array([0, 0, 0, 0, 0, 1, 0], bool)


def _toy_numbers():
    rng = np.random.RandomState(0)
    logits = rng.randn(KR * G, V).astype(np.float32)
    for j in range(KR):
        logits[j * G + np.arange(G), _M[:, j]] += 10.0
    h_all = rng.randn(KR, 1, G, H).astype(np.float32)
    c_all = rng.randn(KR, 1, G, H).astype(np.float32)
    seqs = rng.randint(4, V, (G, 1, L)).astype(np.int32)
    carry = rng.randn(2, G, HD).astype(np.float32)
    return logits, h_all, c_all, seqs, carry


def _run_toy(xp):
    logits, h_all, c_all, seqs, carry = _toy_numbers()
    calls = []
    if xp == "jax":
        arr = jnp.asarray
        st = jcore.CoreState(
            state=jcore.DecodeState(jnp.zeros((1, G, H)), jnp.zeros((1, G, H))),
            seqs=arr(seqs), scores=None, lps=jnp.zeros((G, 1, L)),
            finished=arr(_FIN[:, None]), tokens=jnp.full((G,), 9, jnp.int32),
            step=arr(_STEP), rng=None)

        def draft_fn(c, tok):
            j = len(calls)
            calls.append(np.asarray(tok))
            return c + (j + 1), arr(_P[:, j].astype(np.int32))

        def verify_fn(state, vin):
            calls.append(np.asarray(vin))
            return arr(h_all), arr(c_all), arr(logits)

        new, cr, stats = jspec.spec_round(verify_fn, draft_fn, st,
                                          arr(carry), KR)
        out = {k: np.asarray(getattr(new, k)) for k in
               ("seqs", "lps", "finished", "tokens", "step")}
        out.update(h=np.asarray(new.state.h), c=np.asarray(new.state.c),
                   carry=np.asarray(cr), stats=np.asarray(stats))
    else:
        t = torch.from_numpy
        st = tcore.CoreState(
            state=tcore.DecodeState(torch.zeros(1, G, H), torch.zeros(1, G, H)),
            seqs=t(seqs), scores=None, lps=torch.zeros(G, 1, L),
            finished=t(_FIN[:, None]),
            tokens=torch.full((G,), 9, dtype=torch.int64), step=t(_STEP))

        def draft_fn(c, tok):
            j = len(calls)
            calls.append(tok.numpy())
            return c + (j + 1), t(_P[:, j])

        def verify_fn(state, vin):
            calls.append(vin.numpy())
            return t(h_all), t(c_all), t(logits)

        new, cr, stats = tspec.spec_round(verify_fn, draft_fn, st,
                                          t(carry), KR)
        out = {k: getattr(new, k).numpy() for k in
               ("seqs", "lps", "finished", "tokens", "step")}
        out.update(h=new.state.h.numpy(), c=new.state.c.numpy(),
                   carry=cr.numpy(), stats=stats.numpy())
    out["calls"] = [np.asarray(x, np.int64) for x in calls]
    return out


def test_spec_round_rejection_rule_equals_jax():
    got, want = _run_toy("torch"), _run_toy("jax")
    for a, b in zip(got["calls"], want["calls"]):
        np.testing.assert_array_equal(a, b)
    for k in ("seqs", "finished", "tokens", "step", "h", "c", "carry",
              "stats"):
        np.testing.assert_array_equal(got[k].astype(want[k].dtype), want[k],
                                      err_msg=k)
    np.testing.assert_allclose(got["lps"], want["lps"], rtol=1e-6, atol=1e-7)
    # The branches the toy covers: emitted 4, 3, 1, 2 (EOS), 3 (EOS), 0, 2.
    assert got["stats"].tolist() == [15.0, 6.0]
    assert got["step"].tolist() == [4, 5, 7, 2, 4, 3, 7]
    assert got["finished"][:, 0].tolist() == [0, 0, 0, 1, 1, 1, 0]


# ------------------------------------------------ model-level twins

def _init(jeng, peng, n=8, seed=1):
    rng = np.random.RandomState(seed)
    feats = {"resnet": (rng.randn(n, 6, 64) * 2).astype(np.float32)}
    masks = {"resnet": np.ones((n, 6), np.float32)}
    masks["resnet"][1, 3:] = 0
    jst, jc = jeng.model.apply(jeng.params, {m: jnp.asarray(v) for m, v in
                                             feats.items()},
                               {m: jnp.asarray(v) for m, v in masks.items()},
                               None, method="init_decode")
    pst, pc = peng.model.init_decode(
        {m: torch.from_numpy(v) for m, v in feats.items()},
        {m: torch.from_numpy(v) for m, v in masks.items()})
    return (jst, jc), (pst, pc)


@pytest.mark.parametrize("fusion,layers", CASES)
def test_decode_verify_and_draft_step_equal_jax(refs, fusion, layers):
    jeng, _, _ = refs[(fusion, layers)]
    peng = _port(jeng, fusion, layers)
    (jst, jc), (pst, pc) = _init(jeng, peng)
    rng = np.random.RandomState(2)
    vin = rng.randint(4, peng.model.vocab_size, (4, 8))
    vin[0] = 1
    jh, jcc, jl = jeng.model.apply(jeng.params, jst, jc, jnp.asarray(vin),
                                   method="decode_verify")
    ph, pcc, pl = peng.model.decode_verify(pst, pc, torch.from_numpy(vin))
    assert ph.shape == (4, layers, 8, peng.model.rnn_size)
    for got, want in ((ph, jh), (pcc, jcc), (pl, jl)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # The verify rows are the port's own chained decode steps.
    s = pst
    for j in range(4):
        s, lg = peng.model.decode_logits(s, pc, torch.from_numpy(vin[j]))
        np.testing.assert_allclose(pl[j * 8:(j + 1) * 8].numpy(), lg.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(tcore.greedy_pick(pl[j * 8:(j + 1) * 8])[0],
                           tcore.greedy_pick(lg)[0])
        assert torch.equal(ph[j], s.h) and torch.equal(pcc[j], s.c)
    # One draft step on the same carry and tokens.
    carry = rng.randn(2, 8, HIDDEN).astype(np.float32)
    tok = rng.randint(0, peng.model.vocab_size, (8,))
    jc2, jp = jspec.draft_step(jeng.draft_params, jnp.asarray(carry),
                               jnp.asarray(tok))
    pc2, pp = tspec.draft_step(peng.draft_params, torch.from_numpy(carry),
                               torch.from_numpy(tok))
    np.testing.assert_allclose(pc2.numpy(), np.asarray(jc2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("fusion,layers", CASES)
def test_spec_round_on_the_model_equals_jax(refs, fusion, layers):
    """Two rounds of ``spec_round`` over the bridged model and draft,
    from the same encoded rows: the port's state, buffers and stats are
    the JAX round's."""
    jeng, _, _ = refs[(fusion, layers)]
    peng = _port(jeng, fusion, layers)
    (jst, jc), (pst, pc) = _init(jeng, peng)
    L = peng.cfg.eval.max_decode_len
    js = jcore.init_core(jst, 8, 1, L, mode="greedy")
    ps = tcore.init_core(pst, 8, 1, L, mode="greedy")
    jcar = jnp.zeros((2, 8, HIDDEN), jnp.float32)
    pcar = torch.zeros(2, 8, HIDDEN)
    for _ in range(2):
        js, jcar, jstats = jspec.spec_round(
            lambda s, v: jeng.model.apply(jeng.params, s, jc, v,
                                          method="decode_verify"),
            lambda c, t: jspec.draft_step(jeng.draft_params, c, t),
            js, jcar, K_REF)
        ps, pcar, pstats = tspec.spec_round(
            lambda s, v: peng.model.decode_verify(s, pc, v),
            lambda c, t: tspec.draft_step(peng.draft_params, c, t),
            ps, pcar, K_REF)
        np.testing.assert_array_equal(ps.seqs.numpy(), np.asarray(js.seqs))
        np.testing.assert_array_equal(ps.step.numpy(), np.asarray(js.step))
        np.testing.assert_array_equal(ps.finished.numpy(),
                                      np.asarray(js.finished))
        np.testing.assert_array_equal(ps.tokens.numpy(),
                                      np.asarray(js.tokens))
        np.testing.assert_array_equal(pstats.numpy(), np.asarray(jstats))
        np.testing.assert_allclose(ps.lps.numpy(), np.asarray(js.lps),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ps.state.h.numpy(), np.asarray(js.state.h),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pcar.numpy(), np.asarray(jcar),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- slot loop

VARIANTS = {
    "k2_block1_elastic_fuzz7": dict(k=2, fuzz=7),
    "k3_staggered": dict(k=3),
    "k3_block2_elastic_fuzz11": dict(k=3, fuzz=11,
                                     serving=dict(slot_block_steps=2)),
    "k4_block1_fixed_fuzz3": dict(k=4, fuzz=3,
                                  serving=dict(slot_bank_min=0,
                                               slot_block_steps=1)),
    "k4_block2_fixed_fuzz19_reversed": dict(
        k=4, fuzz=19, reverse=True,
        serving=dict(slot_bank_min=0, slot_block_steps=2)),
}


def _run(peng, v):
    dec = peng.slot_decoder()
    reqs = [peng.prepare(p) for p in _payloads()]
    order = list(range(N_REQ))[::-1] if v.get("reverse") else range(N_REQ)
    rng = np.random.RandomState(v["fuzz"]) if "fuzz" in v else None
    return _drive(dec, reqs, order, rng), dec


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fusion,layers", CASES)
def test_spec_slot_loop_matches_jax_and_plain(refs, fusion, layers, variant):
    v = VARIANTS[variant]
    jeng, want, jstats = refs[(fusion, layers)]
    serving = v.get("serving", {})
    spec = _port(jeng, fusion, layers, k=v["k"], **serving)
    plain = _port(jeng, fusion, layers, spec=False, **serving)
    got, dec = _run(spec, v)
    base, _ = _run(plain, v)
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], want[i][0], err_msg=f"{i}")
        np.testing.assert_array_equal(got[i][0], base[i][0], err_msg=f"{i}")
        assert got[i][1] == base[i][1] == want[i][1]
    st = dec.spec_stats()
    assert st["draft_k"] == v["k"] and st["live_slot_rounds"] > 0
    assert 1.0 <= st["tokens_per_round"] <= v["k"]
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    # Every emitted token, frozen rounds excluded, is a caption token.
    emitted = sum(int((got[i][0] != 0).sum()) for i in range(N_REQ))
    assert st["emitted_tokens"] == emitted
    if v["k"] == K_REF and not serving:
        assert st == jstats
    assert dec.state_bytes() == dec.expected_state_bytes()
    assert dec.live_state_bytes() == 0 and not dec.occupied
    # Empty slots ride the rounds frozen (their draft carry drifts, as in
    # the reference); admission gives the next occupant a zero carry.
    s = dec.free[-1]
    dec._admit([s], spec.encode_prepared_rows(
        [spec.prepare(_payloads()[0])]))
    assert float(dec._st.draft[:, s].abs().sum()) == 0.0
    d = dec.describe()["speculative"]
    assert d == {"draft_k": v["k"], "draft_hidden": HIDDEN}


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_int8w_spec_slot_loop_is_the_plain_int8w_loop(refs, fusion):
    jeng, _, _ = refs[(fusion, 1)]
    v = dict(fuzz=5, k=3)
    got, dec = _run(_port(jeng, fusion, dtype="int8w"), v)
    base, _ = _run(_port(jeng, fusion, dtype="int8w", spec=False), v)
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], base[i][0])
    assert dec.spec_stats()["live_slot_rounds"] > 0


def test_int8w_spec_slot_loop_matches_jax_int8w():
    jeng = JaxEngine(_spec_cfg(jax_preset, "meanpool", dtype="int8w"),
                     random_init=True)
    want = _drive(jeng.slot_decoder(), [jeng.prepare(p) for p in _payloads()],
                  range(N_REQ))
    peng = _port(jeng, "meanpool", dtype="int8w")
    got, dec = _run(peng, {})
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    assert dec.spec_stats() == jeng.slot_decoder().spec_stats()


# ------------------------------------------------------------- drafts

@pytest.mark.parametrize("dtype", ["f32", "int8w"])
def test_truncation_draft_is_bitwise_the_jax_one(dtype):
    jeng = JaxEngine(_spec_cfg(jax_preset, "attention", dtype=dtype),
                     random_init=True)
    peng = _port(jeng, "attention", dtype=dtype)
    assert peng.model.logit_w.dtype == (torch.int8 if dtype == "int8w"
                                        else torch.float32)
    want = jspec.make_draft_params(jeng.params, HIDDEN)
    got = tspec.make_draft_params(peng.model.state_dict(), HIDDEN)
    assert set(got) == set(want) == set(tspec.DRAFT_LEAVES)
    for k in tspec.DRAFT_LEAVES:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(peng.draft_params[k].numpy(),
                                      np.asarray(jeng.draft_params[k]))
    # The JAX tree itself (numpy leaves) truncates the same way.
    tree = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    for k, a in tspec.make_draft_params(tree, HIDDEN).items():
        np.testing.assert_array_equal(a, want[k])


def test_draft_npz_crosses_both_ways(tmp_path, refs):
    jeng, _, _ = refs[("meanpool", 1)]
    rng = np.random.RandomState(4)
    dp = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.1)
          for k, v in jspec.make_draft_params(jeng.params, HIDDEN).items()}
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jspec.save_draft_params(a, {k: jnp.asarray(v) for k, v in dp.items()})
    tspec.save_draft_params(b, {k: torch.from_numpy(v) for k, v in dp.items()})
    for path in (a, b):
        for load in (jspec.load_draft_params, tspec.load_draft_params):
            got = load(path)
            for k in tspec.DRAFT_LEAVES:
                np.testing.assert_array_equal(got[k], dp[k])
    # An engine booted on the file carries it, and still serves exactly.
    peng = _port(jeng, "meanpool", 1, draft_params=None)
    cfg = peng.cfg
    cfg.serving.speculative = {"draft_k": 3, "draft_hidden": HIDDEN,
                               "draft_params": a}
    eng = InferenceEngine(cfg, params=jax.tree.map(
        np.asarray, jax.device_get(jeng.params)), device="cpu",
        vocab=peng.vocab)
    for k in tspec.DRAFT_LEAVES:
        np.testing.assert_array_equal(eng.draft_params[k].numpy(), dp[k])
    _, want, _ = refs[("meanpool", 1)]
    got, _ = _run(eng, {"fuzz": 2})
    for i in range(N_REQ):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, draft_embed=dp["draft_embed"])
    with pytest.raises(ValueError, match="missing leaves"):
        tspec.load_draft_params(bad)
    cfg.serving.speculative = {"draft_k": 3, "draft_params": bad}
    with pytest.raises(ValueError, match="missing leaves"):
        InferenceEngine(cfg, random_init=True, device="cpu", vocab=peng.vocab)


@pytest.mark.parametrize("spec,mode,match", [
    ({"draft_k": 3, "draft_hidden": HIDDEN}, "beam", "greedy"),
    ({"draft_k": 3, "depth": 2}, "greedy", "unknown serving.speculative"),
    ({"draft_k": 1}, "greedy", "at least 2"),
    ({"draft_k": 3, "draft_hidden": 0}, "greedy", ">= 1"),
    ({"draft_k": 3, "draft_hidden": 4096}, "greedy", "must lie in"),
])
def test_refusals(spec, mode, match):
    cfg = get_preset("synthetic_smoke").replace(
        **{"serving.decode_mode": mode, "serving.warmup": False,
           "serving.speculative": spec})
    with pytest.raises(ValueError, match=match):
        InferenceEngine(cfg, random_init=True, device="cpu",
                        vocab=Vocabulary([f"w{i}" for i in range(40)]))
    with pytest.raises(ValueError, match=match):
        jcfg = jax_preset("synthetic_smoke").replace(
            **{"serving.decode_mode": mode, "serving.warmup": False,
               "serving.speculative": spec})
        JaxEngine(jcfg, random_init=True)


def test_warmup_is_not_counted(refs):
    jeng, _, _ = refs[("meanpool", 1)]
    peng = _port(jeng, "meanpool", 1, warmup=True)
    dec = peng.slot_decoder()
    assert dec.steps_run > 0
    assert dec.spec_stats() == {
        "draft_k": 3.0, "emitted_tokens": 0.0, "live_slot_rounds": 0.0,
        "acceptance_rate": 0.0, "tokens_per_round": 0.0}
    assert _port(jeng, "meanpool", 1, spec=False).slot_decoder(
        ).spec_stats() == {}
