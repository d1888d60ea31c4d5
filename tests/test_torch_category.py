"""Port parity for ``model.use_category`` (the MSR-VTT category
embedding): the port's captioner, decoders, training steps, eval and
serving against the JAX package on the same weights.

The JAX model's parameters (E = H = 16, A = 24, V = 40, 6 categories,
C = 8) cross the weight bridge; both sides get the same numpy inputs and
category ids.  The JAX side runs its Pallas kernels in interpret mode
(8 or 16 rows), as the JAX package's own tests run them; the port's
kernels take their plain versions on CPU tensors.  Tolerances, stated
where they are held:

* decode at float32: tokens (and the sampler's mask) exact, beam scores
  within 1e-4, log-probs within 1e-4 (the tiers of
  ``tests/test_torch_attdecode.py`` and ``tests/test_torch_cst.py``);
* encode rows: the category rows exact (a gather), the rest rtol / atol
  1e-5; one step's logits and the static gate rows rtol 1e-5 / atol
  1e-5 (or 1e-6);
* teacher-forced logits rtol 1e-4 / atol 1e-5, fused and per step, and
  under int8w at float32 compute (the existing f32 tiers);
* one XE step: loss rtol 1e-5, parameters rtol 2e-5 / atol 1e-5; the PG
  update: loss rtol 1e-5, grad norm rtol 1e-4, parameters rtol 2e-5 /
  atol 1e-7;
* ``evaluate_dataset``'s files byte for byte;
* served captions token-exact (ladder vs the JAX fused beam; the slot
  loop vs the port's offline per-step decode, scores rtol 1e-6).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.decoding.beam import finalize_beams as jfinalize
from cst_captioning_tpu.evaluation import evaluate_dataset as jax_evaluate
from cst_captioning_tpu.models.captioner import (
    CaptionModel as JaxModel,
    model_from_config as jax_model_from_config,
)
from cst_captioning_tpu.ops import quant as jquant
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_tpu.training import cst as jcst
from cst_captioning_tpu.training import rewards as jrewards
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import (
    beam_search,
    beam_search_from_state,
)
from cst_captioning_torch.evaluation import evaluate_dataset
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    _repeat_cache,
    model_from_config,
)
from cst_captioning_torch.models.weights import (
    load_params,
    params_to_state_dict,
    state_dict_to_params,
)
from cst_captioning_torch.ops import quant as tquant
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import steps as tsteps

E, H, A, V, D1, D2, FR, NCAT, C = 16, 16, 24, 40, 24, 32, 5, 6, 8
FUSIONS = ("meanpool", "attention")
B = 8


def _kw(fusion):
    return dict(vocab_size=V, rnn_size=H, embed_size=E,
                modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                fusion=fusion, att_hidden_size=A, compute_dtype="float32",
                use_category=True, num_categories=NCAT,
                category_embed_size=C)


def _jax_model(fusion, **kw):
    return JaxModel(drop_prob=0.0, **_kw(fusion), **kw)


def _port_model(fusion, **kw):
    return CaptionModel(device="cpu", **_kw(fusion), **kw)


def _feats(n, seed):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(n, FR, D1).astype(np.float32),
             "c3d": rng.randn(n, FR, D2).astype(np.float32)}
    masks = {m: (rng.rand(n, FR) > 0.3).astype(np.float32) for m in feats}
    for m in masks:
        masks[m][:, 0] = 1.0
    masks["resnet"][1, 2:] = 0.0
    return feats, masks


def _cats(n, seed):
    return np.random.RandomState(100 + seed).randint(0, NCAT, n).astype(
        np.int32)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _params(fusion):
    """JAX init spread as ``tests/test_torch_slots.py`` spreads it
    (embeddings x10, LSTM x2, vocab projection x3) and ``cat_embed``
    x10, so captions differ, end at varied lengths and move with the
    category."""
    feats, masks = _feats(B, 0)
    p = _jax_model(fusion).init(jax.random.PRNGKey(0), _j(feats), _j(masks),
                                jnp.zeros((B, 2), jnp.int32),
                                category=jnp.asarray(_cats(B, 0)))
    return _spread(jax.tree.map(np.array, p))


def _spread(p):
    pp = p["params"]
    for name, scale in (("word_embed", 10.0), ("lstm0_w", 2.0),
                        ("logit_w", 3.0), ("cat_embed", 10.0)):
        pp[name] = pp[name] * scale
    return p


def _jp(fusion):
    return jax.tree.map(jnp.asarray, _params(fusion))


def _ported(fusion, **kw):
    return load_params(_port_model(fusion, **kw), _params(fusion))


# ------------------------------------------------- parameters, bridge

@pytest.mark.parametrize("fusion", FUSIONS)
def test_layout_bridge_and_quant_keep_cat_embed(fusion):
    """``cat_embed`` (NCAT, C) and ``lstm0_w`` rows [emb | ctx | cat |
    hidden] on both sides, the bridge name for name and exact both ways,
    and ``cat_embed`` left float by both quantizers (not in their axis
    rules) while every other leaf quantizes to the same codes."""
    jp = _params(fusion)["params"]
    assert jp["cat_embed"].shape == (NCAT, C)
    assert jp["lstm0_w"].shape == (2 * E + C + H, 4 * H)
    pm = _ported(fusion)
    assert tuple(pm.cat_embed.shape) == (NCAT, C) and pm.in_dim == 2 * E + C
    back = state_dict_to_params(pm.state_dict())["params"]
    assert set(back) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert tquant.quant_axis("cat_embed") is None
    assert jquant.quant_axis("cat_embed") is None
    tq = tquant.quantize_params(params_to_state_dict(_params(fusion)))
    jq = jax.tree.map(np.asarray, jquant.quantize_params(_jp(fusion)))
    assert set(tq) == set(jq["params"])
    assert tq["cat_embed"].dtype == torch.float32
    np.testing.assert_array_equal(tq["cat_embed"].numpy(), jp["cat_embed"])
    for k, v in jq["params"].items():
        np.testing.assert_array_equal(tq[k].numpy(), v, err_msg=k)
    qm = load_params(_port_model(fusion, weight_quant=True), tq)
    assert qm.cat_embed.dtype == torch.float32
    assert not hasattr(qm, "cat_embed_scale")


def test_init_draws_cat_embed_last():
    """``init_weights`` draws ``cat_embed`` after every other draw: the
    draws before ``lstm0_w`` (whose shape grows by C rows) are those of
    a model without categories; ``cat_embed`` is uniform in ±0.1."""
    kw = dict(_kw("attention"))
    with_cat = CaptionModel(device="cpu", **kw).init_weights(
        torch.Generator().manual_seed(0))
    kw.update(use_category=False)
    without = CaptionModel(device="cpu", **kw).init_weights(
        torch.Generator().manual_seed(0))
    assert not hasattr(without, "cat_embed")
    assert tuple(without.lstm0_w.shape) == (2 * E + H, 4 * H)
    for name in ("word_embed", "proj_resnet_w", "proj_c3d_w", "att_wf",
                 "att_wh", "att_v"):
        assert torch.equal(getattr(with_cat, name), getattr(without, name))
    cat = with_cat.cat_embed.detach()
    assert float(cat.abs().max()) <= 0.1 and float(cat.abs().max()) > 0.05


# ------------------------------------------------------ encode, step

@pytest.mark.parametrize("fusion", FUSIONS)
def test_encode_matches_jax_and_needs_a_category(fusion):
    feats, masks = _feats(3, 1)
    cats = np.array([4, 0, 4], np.int32)
    jm = _jax_model(fusion)
    _, jc = jm.apply(_jp(fusion), _j(feats), _j(masks),
                     jnp.asarray(cats), method="init_decode")
    pm = _ported(fusion)
    _, pc = pm.init_decode(_t(feats), _t(masks), torch.from_numpy(cats))
    np.testing.assert_array_equal(pc.cat_emb.numpy(), np.asarray(jc.cat_emb))
    np.testing.assert_allclose(pc.ctx_static.numpy(),
                               np.asarray(jc.ctx_static), rtol=1e-5,
                               atol=1e-5)
    if fusion == "attention":
        for k in ("att_vals", "att_proj", "att_mask"):
            np.testing.assert_allclose(getattr(pc, k).numpy(),
                                       np.asarray(getattr(jc, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="no `category`"):
        pm.init_decode(_t(feats), _t(masks))
    with pytest.raises(ValueError, match="no `category`"):
        jm.apply(_jp(fusion), _j(feats), _j(masks), method="init_decode")


@pytest.mark.parametrize("fusion", FUSIONS)
def test_step_and_static_gate_rows_match_jax(fusion):
    """One unfused step's decode logits (cat_emb concatenated into the
    gate input, at rep 1 and read per video at rep 2), and the decoders'
    ``gx_static``: the reference's ``_fused_gx_static`` plus, under
    meanpool, its ``gctx`` in the same order.  Two categories of the
    same video give different static rows."""
    feats, masks = _feats(3, 2)
    cats = np.array([1, 5, 3], np.int32)
    jm = _jax_model(fusion)
    jp = _jp(fusion)
    state, jcache = jm.apply(jp, _j(feats), _j(masks), jnp.asarray(cats),
                             method="init_decode")
    tokens = np.array([1, 7, 12], np.int32)
    _, jlogits = jm.apply(jp, state, jcache, jnp.asarray(tokens),
                          method="decode_logits")
    pm = _ported(fusion)
    pstate, pcache = pm.init_decode(_t(feats), _t(masks),
                                    torch.from_numpy(cats))
    _, plogits = pm.decode_logits(pstate, pcache,
                                  torch.from_numpy(tokens).long())
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    # rep 2: rows 2i and 2i+1 read video i's cache rows.
    rstate = pm.init_state(6)
    _, rlogits = pm.decode_logits(rstate, pcache,
                                  torch.from_numpy(np.repeat(tokens, 2)).long(),
                                  rep=2)
    np.testing.assert_allclose(rlogits.numpy(),
                               np.repeat(plogits.numpy(), 2, axis=0),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(jm.apply(jp, jcache, method="_fused_gx_static"))
    if fusion == "meanpool":
        w = jp["params"]["lstm0_w"]
        want = want + np.asarray(jnp.einsum(
            "be,eg->bg", jcache.ctx_static, jnp.asarray(w[E: 2 * E]),
            preferred_element_type=jnp.float32))
    got = pm._fused_gx_static(pcache).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _, other = pm.init_decode(_t(feats), _t(masks),
                              torch.from_numpy((cats + 1) % NCAT))
    assert not np.allclose(pm._fused_gx_static(other).numpy(), got)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("repeat,per_step", [(1, False), (2, False),
                                             (2, True)])
def test_teacher_forced_logits_match_jax(fusion, repeat, per_step):
    """The fused forward (meanpool: the static product over [ctx | cat];
    attention: the category rows after the bias) against the JAX fused
    paths (Pallas recurrences in interpret mode), and the per-step loop
    (a tensor ``ss_prob`` of 0) against the JAX scan."""
    feats, masks = _feats(4, 3)
    cats = _cats(4, 3)
    rng = np.random.RandomState(repeat)
    ids = rng.randint(4, V, (4 * repeat, 6)).astype(np.int32)
    ids[:, 0] = 1
    jm = _jax_model(fusion, use_pallas=not per_step,
                    use_pallas_attention=not per_step)
    want = jm.apply(_jp(fusion), _j(feats), _j(masks), jnp.asarray(ids),
                    category=jnp.asarray(cats), repeat=repeat)
    pm = _ported(fusion)
    ss = torch.tensor(0.0) if per_step else 0.0
    got = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
             category=torch.from_numpy(cats), ss_prob=ss, repeat=repeat)
    assert got.shape == (4 * repeat, 6, V)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_int8w_matches_jax(fusion):
    """int8w at float32 compute (the category rows: ``lstm0_w`` codes
    under the lstm scale, after the sum): the teacher-forced logits, one
    step, the static gate rows and the fused beam's tokens."""
    jq = jquant.quantize_params(_jp(fusion))
    feats, masks = _feats(B, 4)
    cats = _cats(B, 4)
    jm = _jax_model(fusion, weight_quant=True, use_pallas=True,
                    use_pallas_attention=True)
    ids = np.random.RandomState(9).randint(4, V, (B, 5)).astype(np.int32)
    ids[:, 0] = 1
    want = jm.apply(jq, _j(feats), _j(masks), jnp.asarray(ids),
                    category=jnp.asarray(cats))
    pm = load_params(_port_model(fusion, weight_quant=True),
                     jax.tree.map(np.asarray, jq))
    with torch.no_grad():
        got = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
                 category=torch.from_numpy(cats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    state, jcache = jm.apply(jq, _j(feats), _j(masks), jnp.asarray(cats),
                             method="init_decode")
    _, jlogits = jm.apply(jq, state, jcache, jnp.asarray(ids[:, 1]),
                          method="decode_logits")
    pstate, pcache = pm.init_decode(_t(feats), _t(masks),
                                    torch.from_numpy(cats))
    _, plogits = pm.decode_logits(pstate, pcache,
                                  torch.from_numpy(ids[:, 1]).long())
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    jgx = np.asarray(jm.apply(jq, jcache, method="_fused_gx_static"))
    if fusion == "attention":
        np.testing.assert_allclose(pm._fused_gx_static(pcache).numpy(), jgx,
                                   rtol=1e-5, atol=1e-6)
    seqs, scores = jm.clone(use_pallas_beam=True).apply(
        jq, _j(feats), _j(masks), jnp.asarray(cats), method="fused_beam",
        beam_size=3, max_len=6)
    r = beam_search(pm, _t(feats), _t(masks), torch.from_numpy(cats),
                    beam_size=3, max_len=6)
    np.testing.assert_array_equal(r.tokens.numpy(),
                                  np.asarray(jfinalize(seqs, scores).tokens))


# ---------------------------------------------------------- decoders

@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy", "multinomial"])
def test_decoders_match_jax(fusion, mode):
    """The port's decoders (plain versions on the CPU) against the JAX
    model's fused ones (Pallas in interpret mode) on the same category
    ids; the multinomial stream from the two seed words the reference
    derives from its key.  The per-step offline decodes give the fused
    ones' tokens."""
    feats, masks = _feats(B, 5)
    cats = _cats(B, 5)
    jm = _jax_model(fusion, use_pallas_beam=True, use_pallas_sampler=True)
    jp = _jp(fusion)
    pm = _ported(fusion, use_pallas_sampler=True)
    tf, tm, tc = _t(feats), _t(masks), torch.from_numpy(cats)
    L = 7
    if mode == "beam":
        seqs, scores = jm.apply(jp, _j(feats), _j(masks), jnp.asarray(cats),
                                method="fused_beam", beam_size=3, max_len=L)
        want = jfinalize(seqs, scores)
        got = beam_search(pm, tf, tm, tc, beam_size=3, max_len=L)
        np.testing.assert_array_equal(got.all_tokens.numpy(),
                                      np.asarray(want.all_tokens))
        np.testing.assert_allclose(got.all_scores.numpy(),
                                   np.asarray(want.all_scores), rtol=0,
                                   atol=1e-4)
        per_step = beam_search_from_state(
            pm, *pm.init_decode(tf, tm, tc), beam_size=3, max_len=L)
        np.testing.assert_array_equal(per_step.tokens.numpy(),
                                      got.tokens.numpy())
        return
    greedy = mode == "greedy"
    key = jax.random.PRNGKey(7)
    want = jm.apply(jp, _j(feats), _j(masks), rng=key,
                    category=jnp.asarray(cats), max_len=L, greedy=greedy,
                    repeat=1 if greedy else 2, method="sample")
    if greedy:
        got = pm.sample(tf, tm, tc, max_len=L, greedy=True)
        per_step = pm._sample_from_cache(*pm.init_decode(tf, tm, tc),
                                         max_len=L)
        np.testing.assert_array_equal(per_step.tokens.numpy(),
                                      got.tokens.numpy())
    else:
        words = tuple(int(x) for x in np.asarray(
            jax.random.bits(key, (2,), jnp.uint32)))
        with torch.no_grad():
            cache = _repeat_cache(pm._encode(tf, tm, tc), 2)
        got = pm.sample_cache(cache, words, max_len=L, greedy=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), rtol=0, atol=1e-4)
    # Every video is decoded under its own category: another category
    # changes some video's rollout.
    other = pm.sample(tf, tm, (tc + 1) % NCAT, max_len=L, greedy=True)
    assert not torch.equal(other.tokens, pm.sample(
        tf, tm, tc, max_len=L, greedy=True).tokens)


# ---------------------------------------------------------- training

def _train_cfgs(fusion):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.get_preset("synthetic_smoke")
        c.model.feature_fusion = fusion
        c.model.use_category = True
        c.model.category_embed_size = C
        out.append(c)
    out[0].model.use_pallas_lstm = True
    out[0].model.use_pallas_attention = True
    return out


def _first_batches(jc, tc):
    jds, vocab = jbuild.build_dataset(jc, "train")
    tds, _ = tbuild.build_dataset(tc, "train")
    jc.model.vocab_size = tc.model.vocab_size = len(vocab)
    kw = dict(batch_size=jc.data.batch_size, seq_per_img=jc.data.seq_per_img,
              max_frames=jc.data.max_frames, seed=5)
    jb = next(iter(jloader.BatchIterator(jds, **kw).epoch(0)))
    tb = next(iter(tloader.BatchIterator(tds, **kw).epoch(0)))
    np.testing.assert_array_equal(jb.category, tb.category)
    assert len(set(tb.category.tolist())) > 1
    return jds, tds, jb, tloader.to_device(tb, torch.device("cpu"))


@pytest.mark.parametrize("fusion", FUSIONS)
def test_xe_step_matches_jax(fusion):
    """One XE step on ``synthetic_smoke`` with ``use_category`` (the
    batch's category ids into both steps): loss rtol 1e-5, grad norm
    rtol 1e-4, parameters after the update rtol 2e-5 / atol 1e-5."""
    jc, tc = _train_cfgs(fusion)
    _, _, jb, tb = _first_batches(jc, tc)
    jm = jax_model_from_config(jc)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), jm,
                                      jsteps.make_optimizer(jc.train, 4),
                                      jb._asdict())
    init = jax.tree.map(np.array, state.params)
    new_state, metrics = jsteps.make_xe_train_step(jm)(
        state, jb.feats, jb.feat_masks, jb.captions, jb.weights,
        jnp.asarray(jb.category), jb.video_idx, jax.random.PRNGKey(1), 0.0)
    tm = load_params(model_from_config(tc, device="cpu"), init)
    opt = tsteps.make_optimizer(tc.train, 4, dict(tm.named_parameters()))
    out = tsteps.make_xe_train_step(tm, opt)(
        tb.feats, tb.feat_masks, tb.captions, tb.weights, tb.category,
        tb.video_idx, None, 0.0)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    for k, v in new_state.params["params"].items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    assert not np.array_equal(tm.cat_embed.detach().numpy(),
                              init["params"]["cat_embed"])


@pytest.mark.parametrize("fusion", FUSIONS)
def test_cst_step_matches_jax(fusion, monkeypatch):
    """One CST split step (scb, S = 2, 2 chunks) with the category ids
    reaching the rollout chunks and the PG update's teacher forcing: the
    reference's rewarder, ``_baseline_from`` and ``_pg_update`` (with the
    same category) on the tokens the port drew reproduce its advantage
    bitwise and its parameters at the PG tier."""
    jc, tc = _train_cfgs(fusion)
    for c in (jc, tc):
        c.train.train_mode = "cst"
        c.train.cst_baseline = "scb"
        c.train.cst_num_samples = 2
        c.train.cst_score_chunks = 2
    jds, tds, jb, tb = _first_batches(jc, tc)
    jm = jax_model_from_config(jc)
    jparams = jax.tree.map(np.array, jm.init(
        jax.random.PRNGKey(2), {m: jnp.asarray(v[:1]) for m, v in
                                jb.feats.items()},
        {m: jnp.asarray(v[:1]) for m, v in jb.feat_masks.items()},
        jnp.zeros((1, 2), jnp.int32), category=jnp.asarray(jb.category[:1])))
    jparams["params"]["cat_embed"] *= 10.0
    seen = {}
    real = tcst._pg_update

    def spy(model, optimizer, feats, feat_masks, S_, tokens, mask, adv, *a):
        seen.update(tokens=tokens.numpy().copy(), mask=mask.numpy().copy(),
                    adv=adv.numpy().copy(), category=a[-1])
        return real(model, optimizer, feats, feat_masks, S_, tokens, mask,
                    adv, *a)

    monkeypatch.setattr(tcst, "_pg_update", spy)
    # The rollout on the fused sampler, the route this check was set on
    # (the synthetic preset leaves the flag off, which now draws on the
    # threefry stream as the reference's gate does).
    tc.model.use_pallas_sampler = True
    tm = load_params(model_from_config(tc, device="cpu"), jparams)
    opt = tsteps.make_optimizer(tc.train, 1, dict(tm.named_parameters()))
    step = tcst.make_cst_train_step(tm, opt, tc, tds)
    metrics = step(tb.feats, tb.feat_masks, None, None, tb.category,
                   tb.video_idx, torch.Generator().manual_seed(3), 0.0)
    assert torch.equal(seen["category"], tb.category)
    vid = np.asarray(jb.video_idx)
    ref = jrewards.CiderDRewarder(jds, df_mode="corpus",
                                  weighted_refs=jc.train.cst_weighted_reward)
    rewards = ref.score_ids(np.repeat(vid, 2), seen["tokens"])
    adv = rewards - jcst._baseline_from(rewards, None, 2, "scb")
    np.testing.assert_array_equal(seen["adv"], adv)
    state = jsteps.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, jparams),
        tx=jsteps.make_optimizer(jc.train, 1))
    state, jloss, jnorm = jax.jit(
        lambda s, f, m, c, t, k, a: jcst._pg_update(
            s, f, m, c, 2, t, k, a, jc.train.sample_temperature))(
        state, _j(jb.feats), _j(jb.feat_masks), jnp.asarray(jb.category),
        jnp.asarray(seen["tokens"]), jnp.asarray(seen["mask"]),
        jnp.asarray(adv))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    for k, v in state.params["params"].items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_cst_step_matches_jax_flag_off(fusion, monkeypatch):
    """The CST split step of :func:`test_cst_step_matches_jax` on its
    preset's own route (``use_pallas_sampler`` off: the rollout on the
    threefry stream), held under the exact-order update witness of
    ``tests/test_torch_param_dtype.py``: the advantage bitwise the
    reference's on the tokens the port drew; the loss rtol 1e-5; the
    gradients within 1e-4 of each leaf's largest element against the
    reference's ``_pg_update`` on those tokens (its gradients captured,
    nothing amplifies them); the port's Adam step on its own gradients
    within 4 float32 ulps of the update plus 4 of the leaf against the
    reference's jitted chain fed the same gradients (the chain's norm
    sums in XLA's order)."""
    from test_torch_param_dtype import (
        Recording,
        hold_grads,
        pg_reference,
        update_witness,
    )

    jc, tc = _train_cfgs(fusion)
    for c in (jc, tc):
        c.train.train_mode = "cst"
        c.train.cst_baseline = "scb"
        c.train.cst_num_samples = 2
        c.train.cst_score_chunks = 2
    jds, tds, jb, tb = _first_batches(jc, tc)
    assert not tc.model.use_pallas_sampler
    jm = jax_model_from_config(jc)
    jparams = jax.tree.map(np.array, jm.init(
        jax.random.PRNGKey(2), {m: jnp.asarray(v[:1]) for m, v in
                                jb.feats.items()},
        {m: jnp.asarray(v[:1]) for m, v in jb.feat_masks.items()},
        jnp.zeros((1, 2), jnp.int32), category=jnp.asarray(jb.category[:1])))
    jparams["params"]["cat_embed"] *= 10.0
    seen = {}
    real = tcst._pg_update

    def spy(model, optimizer, feats, feat_masks, S_, tokens, mask, adv, *a):
        seen.update(tokens=tokens.numpy().copy(), mask=mask.numpy().copy(),
                    adv=adv.numpy().copy(),
                    before={k: v.clone() for k, v in
                            model.state_dict().items()})
        return real(model, optimizer, feats, feat_masks, S_, tokens, mask,
                    adv, *a)

    monkeypatch.setattr(tcst, "_pg_update", spy)
    tm = load_params(model_from_config(tc, device="cpu"), jparams)
    opt = Recording(dict(tm.named_parameters()), tc.train, 1)
    step = tcst.make_cst_train_step(tm, opt, tc, tds)
    metrics = step(tb.feats, tb.feat_masks, None, None, tb.category,
                   tb.video_idx, torch.Generator().manual_seed(3), 0.0)
    vid = np.asarray(jb.video_idx)
    ref = jrewards.CiderDRewarder(jds, df_mode="corpus",
                                  weighted_refs=jc.train.cst_weighted_reward)
    rewards = ref.score_ids(np.repeat(vid, 2), seen["tokens"])
    adv = rewards - jcst._baseline_from(rewards, None, 2, "scb")
    np.testing.assert_array_equal(seen["adv"], adv)
    jloss, _, jgrads = pg_reference(jc, jb, jparams, 2, seen["tokens"],
                                    seen["mask"], adv)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-5)
    hold_grads(opt.seen, jgrads, 1e-4, f"CST {fusion} flag off")
    update_witness(jsteps.make_optimizer(jc.train, 1), seen["before"],
                   opt.seen, dict(tm.state_dict()), ulp=4)


# -------------------------------------------------------------- eval

@pytest.mark.parametrize("fusion", FUSIONS)
def test_evaluate_dataset_files_match_jax(fusion, tmp_path):
    """``evaluate_dataset`` with ``use_category`` (the split's category
    ids into the beam): the JAX eval's files byte for byte."""
    cfgs = []
    for mod in (jcfg, tcfg):
        c = mod.get_preset("synthetic_smoke")
        c.model.feature_fusion = fusion
        c.model.use_category = True
        c.model.category_embed_size = C
        c.model.rnn_size = c.model.input_encoding_size = 16
        c.model.att_hidden_size = 16
        c.eval.metrics = ["Bleu_4", "CIDEr"]
        c.eval.beam_size = 3
        c.eval.max_decode_len = 8
        cfgs.append(c)
    jc, tc = cfgs
    jds, vocab = jbuild.build_dataset(jc, "test")
    tds, _ = tbuild.build_dataset(tc, "test")
    jc.model.vocab_size = tc.model.vocab_size = len(vocab)
    jm = jax_model_from_config(jc)
    d = jc.data
    zf = {m: jnp.zeros((1, d.max_frames, d.feature_dims[m]))
          for m in d.feature_modalities}
    params = jm.init(jax.random.PRNGKey(0), zf,
                     {m: jnp.ones((1, d.max_frames)) for m in zf},
                     jnp.zeros((1, 2), jnp.int32),
                     category=jnp.zeros((1,), jnp.int32))
    params = _spread(jax.tree.map(np.array, params))
    jax_evaluate(jm, params, jds, jc, out_dir=str(tmp_path / "jax"))
    tm = load_params(model_from_config(tc, device="cpu"), params)
    evaluate_dataset(tm, tds, tc, out_dir=str(tmp_path / "port"),
                     device="cpu")
    for name in ("predictions.json", "scores.json"):
        with open(tmp_path / "jax" / name) as f:
            want = f.read()
        with open(tmp_path / "port" / name) as f:
            assert f.read() == want, name
    with open(tmp_path / "port" / "predictions.json") as f:
        preds = json.load(f)
    assert len({p["caption"] for p in preds}) > 1


# ----------------------------------------------------------- serving

def _serve_cfg(get, fusion, mode, continuous):
    c = get("synthetic_smoke")
    c.model.feature_fusion = fusion
    c.model.use_category = True
    c.model.category_embed_size = C
    c.data.num_categories = NCAT
    c.eval.beam_size = 3
    c.eval.max_decode_len = 8
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode = continuous, False, mode
    sv.num_slots, sv.slot_bank_min = 4, 2
    return c


@functools.lru_cache(maxsize=None)
def _serve_params(fusion):
    """The JAX engine's random init for the serving config, spread."""
    jeng = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, "beam", False),
                     random_init=True)
    return jeng.vocab, _spread(jax.tree.map(np.array,
                                            jax.device_get(jeng.params)))


def _payloads(n, seed, cats=True):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = {"features": {"resnet": (rng.randn(int(rng.randint(1, 9)), 64)
                                     * 2.0).astype(np.float32).tolist()}}
        if cats and i % 4:
            p["category"] = int(rng.randint(0, NCAT))
        out.append(p)
    return out


def _port_engine(fusion, mode, continuous):
    jvocab, params = _serve_params(fusion)
    return InferenceEngine(
        _serve_cfg(tcfg.get_preset, fusion, mode, continuous), params=params,
        vocab=Vocabulary(jvocab.idx_to_word[4:]), device="cpu")


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_served_ladder_with_category_vs_jax_fused(fusion, mode):
    """The ladder engine's captions for payloads carrying ``category``
    (a quarter without: 0 by default) against the JAX model's fused
    decoders on the same padded batch and ids."""
    eng = _port_engine(fusion, mode, False)
    reqs = [eng.prepare(p) for p in _payloads(6, 1)]
    assert [r.category for r in reqs][:2] == [0, reqs[1].category]
    got = [r.tokens for r in eng.decode_prepared(reqs, store=False)]
    Bb = eng.bucket(len(reqs))
    feats, masks = eng._assemble(reqs, Bb)
    cat = eng._categories(reqs, Bb)
    jvocab, params = _serve_params(fusion)
    jc = _serve_cfg(jcfg.get_preset, fusion, mode, False)
    jc.model.vocab_size = len(jvocab)
    jm = jax_model_from_config(jc).clone(use_pallas_beam=True,
                                         use_pallas_sampler=True)
    jf = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    jmk = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    jcat = jnp.asarray(cat.numpy().astype(np.int32))
    if mode == "beam":
        seqs, scores = jm.apply(params, jf, jmk, jcat, method="fused_beam",
                                beam_size=3, max_len=8)
        want = np.asarray(jfinalize(seqs, scores).tokens)
    else:
        want = np.asarray(jm.apply(params, jf, jmk, category=jcat,
                                   max_len=8, greedy=True,
                                   method="sample").tokens)
    assert got == want[:len(reqs)].tolist()
    assert len({tuple(t) for t in got}) > 1


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_served_continuous_with_category_equals_offline(fusion, mode):
    """The slot loop (cache rows carry ``cat_emb``; elastic banks of 2
    and 4 slots, staggered arrivals) against the port's offline
    per-step decode of the same requests with their categories; the
    state bytes equal the closed form with C·itemsize a stored row."""
    eng = _port_engine(fusion, mode, True)
    reqs = [eng.prepare(p) for p in _payloads(7, 2)]
    dec = eng.slot_decoder()
    got, pending = {}, list(range(len(reqs)))
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(1, len(pending), len(dec.free))
        adm = [pending.pop(0) for _ in range(n)]
        for i, toks, score, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = (toks, score)
    m, ev = eng.model, eng.cfg.eval
    cache = eng.encode_prepared_rows(reqs)
    assert cache.cat_emb.shape == (len(reqs), C)
    state = m.init_state(len(reqs))
    if mode == "beam":
        r = beam_search_from_state(m, state, cache, beam_size=3, max_len=8)
        want, scores = r.tokens.numpy(), r.score.numpy()
    else:
        want = m._sample_from_cache(state, cache, max_len=8).tokens.numpy()
        scores = None
    for i in range(len(reqs)):
        np.testing.assert_array_equal(got[i][0], want[i], err_msg=str(i))
        if scores is not None:
            assert got[i][1] == pytest.approx(float(scores[i]), rel=1e-6)
    assert dec.state_bytes() == dec.expected_state_bytes()
    assert dec.cache_bytes() > 0 and dec._st.cache.cat_emb is not None


def test_tier1_key_per_category_as_the_jax_engine():
    """The tier-1 key hashes ``__category`` under ``use_category``: one
    video under two categories keys twice, under the same category once,
    and the keys equal the JAX engine's for the same tag.  An id out of
    range is a 400 (``ValueError``) where JAX's gather would clamp; a
    model without categories ignores the field, as the reference."""
    jvocab, params = _serve_params("meanpool")
    eng = _port_engine("meanpool", "beam", False)
    jeng = JaxEngine(_serve_cfg(jcfg.get_preset, "meanpool", "beam", False),
                     params=jax.tree.map(jnp.asarray, params), vocab=jvocab)
    base = _payloads(1, 3, cats=False)[0]
    keys = {}
    for c in (0, 2, 5):
        p = dict(base, category=c)
        keys[c] = eng.prepare(p).cache_key
        assert keys[c] == jeng.prepare(p).cache_key
    assert len(set(keys.values())) == 3
    assert eng.prepare(base).cache_key == keys[0]
    for bad in (-1, NCAT, 99):
        with pytest.raises(ValueError, match="category"):
            eng.prepare(dict(base, category=bad))
    cfg = _serve_cfg(tcfg.get_preset, "meanpool", "beam", False)
    cfg.model.use_category = False
    plain = InferenceEngine(cfg, random_init=True,
                            vocab=Vocabulary(jvocab.idx_to_word[4:]),
                            device="cpu")
    assert (plain.prepare(dict(base, category=3)).cache_key
            == plain.prepare(base).cache_key)
    assert plain.prepare(dict(base, category=99)).category == 99
