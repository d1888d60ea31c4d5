"""Port parity for stacked LSTM decoders (``model.num_layers = 2``)
against the JAX package on the CPU: the weight bridge, teacher forcing,
the per-step decodes a stack takes (greedy, beam-5, multinomial on the
threefry batch stream), one CST split step, the slot / padded rollout,
the ladder and slot-loop engines, the beam-5 eval and ``cli/test``, the
exporter / importer pair and warm starts.

Sizes: E = H = 32, A = 24, V = 40 (36 words), 4 videos of 5 frames per
modality (resnet 24, c3d 32), S = 2 rollouts, max_len 8; the engines and
the eval run ``synthetic_smoke`` (E = H = 32) with two layers.  Inputs
come from numpy seeds; the JAX tree is carried over by
``models/weights.py``.  The JAX model runs its recurrence kernel (one
launch a layer under meanpool) and its context kernel (every step under
attention) in interpret mode where the teacher-forced forward and the
PG update run; its whole-recurrence decoders decline stacks, so its
decodes are its per-step (scan) ones, as the port's are.

Tolerances, stated where they are held:

* logits, the XE loss and every gradient rtol 1e-4 / atol 1e-5
  (``tests/test_torch_train.py``'s tier);
* decoded, rolled-out and served tokens exact (greedy, beam and the
  threefry streams replayed bit for bit); beam scores and sample
  log-probs rtol 1e-5 / atol 1e-6;
* the CST split step at ``tests/test_torch_cst.py``'s tier: rewards,
  baseline and advantage bitwise, PG loss rtol 1e-5, parameters after
  the Adam step rtol 2e-5 / atol 1e-7;
* int8w served captions at the reference's relaxed-serving floor
  (>= 0.75) against the JAX int8w engine.
"""

import functools
import importlib.util
import json
import logging
import os
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.analysis.jit_registry import (
    RELAXED_SERVING_MATCH_FLOOR,
)
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data.datasets import InMemoryDataset as JaxDataset
from cst_captioning_tpu.data.vocab import Vocabulary as JaxVocabulary
from cst_captioning_tpu.decoding import beam as jbeam
from cst_captioning_tpu.evaluation import evaluate_dataset as jax_evaluate
from cst_captioning_tpu.models import captioner as jcap
from cst_captioning_tpu.ops import losses as jlosses
from cst_captioning_tpu.ops import quant as jquant
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_tpu.training import checkpoint as jckpt
from cst_captioning_tpu.training import cst as jcst
from cst_captioning_tpu.training import rewards as jrewards
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.cli import serve as tcli_serve
from cst_captioning_torch.cli import test as tcli_test
from cst_captioning_torch.cli import train as tcli_train
from cst_captioning_torch.constants import PAD_ID
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data.datasets import InMemoryDataset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import (
    beam_backend,
    beam_search,
    beam_search_from_state,
)
from cst_captioning_torch.evaluation import evaluate_dataset
from cst_captioning_torch.models import captioner as tcap
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    _glorot,
    _repeat_cache,
    draw_seeds,
    model_from_config,
)
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.ops import losses as tlosses
from cst_captioning_torch.ops import quant as tquant
from cst_captioning_torch.ops.rnn import lstm_bias_init, lstm_kernel_init
from cst_captioning_torch.serving import server as tserver
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.tools import import_jax_checkpoint as importer
from cst_captioning_torch.training import checkpoint as tckpt
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import steps as tsteps
from cst_captioning_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, H, A, D1, D2, F, L = 32, 32, 24, 24, 32, 5, 8
LAYERS = 2
WORDS = [f"w{i}" for i in range(36)]
V = len(WORDS) + 4
NVID, B, S = 8, 4, 2
VID = np.array([5, 1, 6, 2], np.int32)
FUSIONS = ("meanpool", "attention")
N_REQ = 10


# ---------------------------------------------------------------- inputs

def _corpus_parts():
    """NVID videos over 4 topics of 8 words, 5 references of 3-6 words
    each, features at (F, D1) / (F, D2), random consensus weights."""
    rng = np.random.RandomState(0)
    topics = rng.choice(len(WORDS), (4, 8), replace=False)
    feats = {"resnet": [], "c3d": []}
    refs, weights = [], []
    for v in range(NVID):
        t = topics[v % 4]
        refs.append([" ".join(WORDS[w] for w in rng.choice(t, rng.randint(3, 7)))
                     for _ in range(5)])
        weights.append(rng.uniform(0.2, 2.0, 5).astype(np.float32))
        feats["resnet"].append(rng.randn(F, D1).astype(np.float32))
        feats["c3d"].append(rng.randn(F, D2).astype(np.float32))
    return topics, feats, refs, weights


def _dataset(vocab_cls, ds_cls):
    _, feats, refs, weights = _corpus_parts()
    vocab = vocab_cls(WORDS)
    caps = [np.stack([vocab.encode(r.split(), L - 2) for r in rs])
            for rs in refs]
    ds = ds_cls(vocab, [f"v{i}" for i in range(NVID)], feats, caps, refs)
    ds.set_caption_weights({f"v{i}": w for i, w in enumerate(weights)})
    return ds


@pytest.fixture(scope="module")
def corpora():
    return (_dataset(Vocabulary, InMemoryDataset),
            _dataset(JaxVocabulary, JaxDataset))


def _batch():
    """Videos VID's features, frame masks with tails."""
    _, feats, _, _ = _corpus_parts()
    f = {m: np.stack([feats[m][v] for v in VID]) for m in feats}
    rng = np.random.RandomState(1)
    masks = {m: (rng.rand(B, F) > 0.3).astype(np.float32) for m in f}
    for m in masks:
        masks[m][:, 0] = 1.0
    return f, masks


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _kd(key):
    """A JAX key's two ``key_data`` words, the port's threefry key."""
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@functools.lru_cache(maxsize=None)
def _jax_model(fusion, kernels=False, layers=LAYERS):
    """The JAX model; ``kernels``: its recurrence and context kernels in
    interpret mode (its fused decoders decline stacks either way)."""
    return jcap.CaptionModel(
        vocab_size=V, rnn_size=H, num_layers=layers, embed_size=E,
        modalities=("resnet", "c3d"), feature_dims=(D1, D2), fusion=fusion,
        att_hidden_size=A, compute_dtype="float32", drop_prob=0.0,
        use_pallas=kernels, use_pallas_attention=kernels,
        use_pallas_sampler=kernels)


@functools.lru_cache(maxsize=None)
def _params(fusion):
    """JAX init of the stack, with the topic words' and EOS's logit
    biases raised so rows earn rewards and end at varied lengths."""
    feats, masks = _batch()
    p = _jax_model(fusion).init(jax.random.PRNGKey(0), _j(feats), _j(masks),
                                jnp.zeros((B, 2), jnp.int32))
    p = jax.tree.map(np.array, p)
    p["params"]["logit_b"][np.unique(_corpus_parts()[0]) + 4] += 2.0
    p["params"]["logit_b"][2] += 3.0
    return p


def _jparams(fusion):
    return jax.tree.map(jnp.asarray, _params(fusion))


def _port_model(fusion, weight_quant=False, layers=LAYERS):
    return CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                        modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                        fusion=fusion, att_hidden_size=A,
                        compute_dtype="float32", num_layers=layers,
                        weight_quant=weight_quant, device="cpu")


def _port(fusion):
    return load_params(_port_model(fusion), _params(fusion))


# ---------------------------------------------------------- the bridge

@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("quant", [False, True])
def test_stacked_tree_loads_strictly(fusion, quant):
    """A two-layer JAX tree loads name for name, float and int8w (the
    JAX quantizer's codes and scales, which the port's quantizer
    reproduces bitwise); a single-layer port model refuses it."""
    tree = _params(fusion)
    if quant:
        tree = jax.tree.map(np.asarray,
                            jquant.quantize_params(_jparams(fusion)))
        mine = tquant.quantize_params(_port(fusion).state_dict())
        assert set(mine) == set(tree["params"])
        for k, v in mine.items():
            np.testing.assert_array_equal(v.numpy(), tree["params"][k],
                                          err_msg=k)
    pm = load_params(_port_model(fusion, weight_quant=quant), tree)
    sd = pm.state_dict()
    assert set(sd) == set(tree["params"])
    assert tuple(sd["lstm1_w"].shape) == (2 * H, 4 * H)
    assert (sd["lstm1_w"].dtype == torch.int8) == quant
    assert ("lstm1_w_scale" in sd) == quant
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    with pytest.raises(KeyError, match="unexpected .*lstm1_b"):
        load_params(_port_model(fusion, weight_quant=quant, layers=1), tree)


def _single_layer_draws(m: CaptionModel, g: torch.Generator) -> dict:
    """The single-layer model's draws in their order, written out:
    word_embed, the projections, the attention weights, lstm0, the
    vocab projection, then cat_embed."""
    E_, H_, V_ = m.embed_size, m.rnn_size, m.vocab_size
    vals = {"word_embed": torch.rand((V_, E_), generator=g) * 0.2 - 0.1}
    for name, d in zip(m.modalities, m.feature_dims):
        vals[f"proj_{name}_w"] = _glorot((d, E_), g)
        vals[f"proj_{name}_b"] = torch.zeros((E_,))
    if m.fusion == "attention":
        A_ = m.att_hidden_size
        vals["att_wf"] = _glorot((E_, A_), g)
        vals["att_wh"] = _glorot((H_, A_), g)
        vals["att_b"] = torch.zeros((A_,))
        vals["att_v"] = _glorot((A_, 1), g)
    vals["lstm0_w"] = lstm_kernel_init((m.in_dim + H_, 4 * H_), g)
    vals["lstm0_b"] = lstm_bias_init((4 * H_,))
    vals["logit_w"] = _glorot((H_, V_), g)
    vals["logit_b"] = torch.zeros((V_,))
    if m.use_category:
        vals["cat_embed"] = (torch.rand(m.cat_embed.shape, generator=g)
                             * 0.2 - 0.1)
    return vals


@pytest.mark.parametrize("fusion,category", [("meanpool", False),
                                             ("meanpool", True),
                                             ("attention", False),
                                             ("attention", True)])
def test_init_weights_single_layer_unchanged(fusion, category):
    """A single-layer model draws bitwise what it drew before stacks were
    ported, float and int8w; a stack's shared parameters are those
    draws, its layers past the first drawn after them."""
    kw = dict(vocab_size=V, rnn_size=H, embed_size=E,
              modalities=("resnet", "c3d"), feature_dims=(D1, D2),
              fusion=fusion, att_hidden_size=A, use_category=category,
              num_categories=6, category_embed_size=8, device="cpu")
    one = CaptionModel(**kw).init_weights(torch.Generator().manual_seed(7))
    want = _single_layer_draws(one, torch.Generator().manual_seed(7))
    assert set(want) == set(one.state_dict())
    for k, v in want.items():
        assert torch.equal(one.state_dict()[k], v), k
    q = CaptionModel(weight_quant=True, **kw).init_weights(
        torch.Generator().manual_seed(7))
    for k, v in want.items():
        if tquant.quant_axis(k) is None:
            assert torch.equal(q.state_dict()[k], v), k
            continue
        codes, scale = tquant.quantize_per_channel(v, tquant.quant_axis(k))
        assert torch.equal(q.state_dict()[k], codes), k
        assert torch.equal(q.state_dict()[k + "_scale"], scale), k
    g = torch.Generator().manual_seed(7)
    two = CaptionModel(num_layers=2, **kw).init_weights(g)
    for k, v in want.items():
        assert torch.equal(two.state_dict()[k], v), k
    w1 = lstm_kernel_init((2 * H, 4 * H), torch.Generator().manual_seed(7))
    assert not torch.equal(two.lstm1_w, w1)  # drawn after, not first
    assert torch.equal(two.lstm1_b, lstm_bias_init((4 * H,)))
    assert float(two.lstm1_w.detach().abs().max()) <= 1.0 / H ** 0.5


# ------------------------------------------------------ teacher forcing

def _tf_inputs(repeat=2, T=6):
    feats, masks = _batch()
    rng = np.random.RandomState(3)
    ids = rng.randint(4, V, (B * repeat, T)).astype(np.int32)
    ids[:, 0] = 1
    targets = np.concatenate([ids[:, 1:], np.full((B * repeat, 1), 2,
                                                  np.int32)], axis=1)
    mask = (rng.rand(B * repeat, T) > 0.2).astype(np.float32)
    return feats, masks, ids, targets, mask


@pytest.mark.parametrize("fusion", FUSIONS)
def test_teacher_forced_logits_loss_grads_vs_jax(fusion, monkeypatch):
    """The stacked teacher-forced forward (meanpool: one recurrence
    launch a layer, layer 1 on layer 0's h sequence; attention: the
    per-step loop, one context launch a step, queried by the top layer):
    logits, XE loss and the gradient of every parameter vs the JAX model
    (its kernels in interpret mode), rtol 1e-4 / atol 1e-5."""
    feats, masks, ids, targets, mask = _tf_inputs()
    rep = 2
    jm = _jax_model(fusion, kernels=True)

    def jloss(p):
        lg = jm.apply(p, _j(feats), _j(masks), jnp.asarray(ids), repeat=rep)
        return jlosses.masked_cross_entropy(lg, jnp.asarray(targets),
                                            jnp.asarray(mask)), lg

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        _jparams(fusion))

    calls = {"lstm_recurrence": 0, "fused_context_attention": 0,
             "attlstm_recurrence": 0}
    for name in calls:
        inner = getattr(tcap, name)

        def counting(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(tcap, name, counting)
    pm = _port(fusion)
    logits = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
                repeat=rep)
    loss = tlosses.masked_cross_entropy(logits, torch.from_numpy(targets),
                                        torch.from_numpy(mask))
    names, params = zip(*pm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    T = ids.shape[1]
    assert calls == ({"lstm_recurrence": LAYERS, "fused_context_attention": 0,
                      "attlstm_recurrence": 0} if fusion == "meanpool" else
                     {"lstm_recurrence": 0, "fused_context_attention": T,
                      "attlstm_recurrence": 0})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    jg = jax.tree.map(np.asarray, jgrads)["params"]
    assert set(names) == set(jg)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert float(grads[names.index("lstm1_w")].abs().max()) > 0


@pytest.mark.parametrize("fusion", FUSIONS)
def test_per_step_forward_stacked_remat_and_ss(fusion):
    """The per-step loop carries (layers, R, H): under scheduled sampling
    (``ss_prob`` 0.5) remat gives bitwise the logits and gradients of the
    plain loop on the same generator; at a tensor ``ss_prob`` of 0 the
    loop is the fused forward (meanpool) / the draw-free stacked
    attention forward, rtol 1e-5."""
    feats, masks, ids, targets, mask = _tf_inputs()
    out = []
    for remat in (False, True):
        pm = _port(fusion)
        pm.remat = remat
        lg = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
                ss_prob=torch.tensor(0.5), repeat=2,
                generator=torch.Generator().manual_seed(3))
        loss = tlosses.masked_cross_entropy(lg, torch.from_numpy(targets),
                                            torch.from_numpy(mask))
        out.append((lg.detach(), torch.autograd.grad(loss, [pm.lstm1_w,
                                                             pm.lstm0_w])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    pm = _port(fusion)
    with torch.no_grad():
        fused = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
                   repeat=2)
        loop = pm(_t(feats), _t(masks), torch.from_numpy(ids).long(),
                  ss_prob=torch.tensor(0.0), repeat=2,
                  generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(loop.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("fusion", FUSIONS)
def test_greedy_and_beam5_token_exact_vs_jax(fusion, caplog):
    """A stack's greedy ``sample`` and ``beam_search`` take the per-step
    decode (logged once each); tokens exact vs JAX's ``sample`` /
    ``beam_search`` at L = 2, beam scores rtol 1e-5."""
    feats, masks = _batch()
    jm, jp = _jax_model(fusion), _jparams(fusion)
    jgreedy = jm.apply(jp, _j(feats), _j(masks), max_len=L, greedy=True,
                       method="sample")
    jres = jbeam.beam_search(jm, jp, _j(feats), _j(masks), beam_size=5,
                             max_len=L)
    pm = _port(fusion)
    with caplog.at_level(logging.WARNING,
                         logger="cst_captioning_torch.models"):
        greedy = pm.sample(_t(feats), _t(masks), max_len=L, greedy=True)
        res = beam_search(pm, _t(feats), _t(masks), beam_size=5, max_len=L)
        again = beam_search(pm, _t(feats), _t(masks), beam_size=5, max_len=L)
        raw = pm.fused_beam(_t(feats), _t(masks), beam_size=5, max_len=L)
    np.testing.assert_array_equal(greedy.tokens.numpy(),
                                  np.asarray(jgreedy.tokens))
    np.testing.assert_allclose(greedy.logprobs.numpy(),
                               np.asarray(jgreedy.logprobs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(res.all_tokens.numpy(),
                                  np.asarray(jres.all_tokens))
    np.testing.assert_allclose(res.all_scores.numpy(),
                               np.asarray(jres.all_scores), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(again.tokens, res.tokens)
    state, cache = pm.init_decode(_t(feats), _t(masks))
    assert tuple(state.h.shape) == (LAYERS, B, H)
    direct = beam_search_from_state(pm, state, cache, beam_size=5, max_len=L)
    assert torch.equal(direct.all_tokens, res.all_tokens)
    assert raw[0].shape == (B, 5, L)
    kind = "attlstm_" if fusion == "attention" else "lstm_"
    for what in ("sample", "beam"):
        assert caplog.text.count(f"{kind}{what} declined: num_layers=2") == 1
    assert beam_backend(pm).startswith("per-step beam (num_layers=2")
    lengths = (res.tokens != PAD_ID).sum(1)
    assert lengths.min() < L


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("temperature,seed", [(1.0, 5), (0.7, 9)])
def test_multinomial_sample_token_exact_vs_jax(fusion, temperature, seed):
    """``sample_cache`` of a stack draws from the threefry batch stream
    on its two seed words, the key the reference hands
    ``_sample_from_cache``: JAX's ``sample(rng=key, repeat=S)`` vs the
    port on the key's words, tokens and masks exact, log-probs rtol
    1e-5; ``sample`` and ``sample_with_baseline`` draw their words from
    the generator."""
    feats, masks = _batch()
    key = jax.random.PRNGKey(seed)
    want = _jax_model(fusion).apply(
        _jparams(fusion), _j(feats), _j(masks), rng=key, max_len=L,
        greedy=False, temperature=temperature, repeat=S, method="sample")
    pm = _port(fusion)
    with torch.no_grad():
        cache = pm._encode(_t(feats), _t(masks))
    got = pm.sample_cache(_repeat_cache(cache, S), _kd(key), max_len=L,
                          greedy=False, temperature=temperature)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=1e-5, atol=1e-6)
    m = got.mask.numpy()
    assert 0 < m.sum() < m.size
    words = draw_seeds(torch.Generator().manual_seed(4), 1)[0]
    ref = pm.sample_cache(_repeat_cache(cache, S), words, max_len=L,
                          greedy=False, temperature=temperature)
    via = pm.sample(_t(feats), _t(masks), max_len=L, greedy=False,
                    temperature=temperature, repeat=S,
                    generator=torch.Generator().manual_seed(4))
    roll, greedy = pm.sample_with_baseline(
        _t(feats), _t(masks), generator=torch.Generator().manual_seed(4),
        max_len=L, temperature=temperature, repeat=S)
    for out in (via, roll):
        assert torch.equal(out.tokens, ref.tokens)
        assert torch.equal(out.logprobs, ref.logprobs)
    assert torch.equal(greedy.tokens, pm.sample(
        _t(feats), _t(masks), max_len=L, greedy=True).tokens)


# ------------------------------------------------------------------ CST

def _cfgs(baseline="scb", **train):
    out = []
    for mod in (tcfg, jcfg):
        c = mod.get_preset("synthetic_smoke")
        c.data.max_seq_len = L
        c.model.num_layers = LAYERS
        c.train.train_mode = "cst"
        c.train.cst_baseline = baseline
        c.train.cst_num_samples = S
        c.train.cst_weighted_reward = True
        c.train.cst_score_chunks = 2
        for k, v in train.items():
            setattr(c.train, k, v)
        out.append(c)
    return out


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("baseline", ["scb", "greedy"])
def test_cst_split_step_vs_reference(fusion, baseline, corpora,
                                     monkeypatch):
    """One split step at L = 2 (2 chunks, the chunks' seed words set to
    two JAX keys): each chunk's rollout is JAX's ``sample(rng=key_c)`` of
    its videos token for token (the per-step route); from those tokens
    the reference's rewarder, ``_baseline_from`` and ``_pg_update`` (its
    recurrence / context kernels in interpret mode, through both layers)
    give the port's reward, baseline and advantage bitwise, its PG loss
    rtol 1e-5 and its parameters rtol 2e-5 / atol 1e-7."""
    pds, jds = corpora
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    monkeypatch.setattr(tcst, "draw_seeds",
                        lambda g, n: [_kd(k) for k in keys][:n])
    seen = {}
    real = tcst._pg_update

    def spy(model, optimizer, feats, feat_masks, S_, tokens, mask, adv, *a):
        seen.update(tokens=tokens.numpy().copy(), mask=mask.numpy().copy(),
                    adv=adv.numpy().copy())
        return real(model, optimizer, feats, feat_masks, S_, tokens, mask,
                    adv, *a)

    monkeypatch.setattr(tcst, "_pg_update", spy)
    tc, jc = _cfgs(baseline)
    pm = _port(fusion)
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    step = tcst.make_cst_train_step(pm, opt, tc, pds)
    assert step.layout == "split"
    feats, masks = _batch()
    metrics = step(_t(feats), _t(masks), None, None, None,
                   torch.from_numpy(VID), torch.Generator().manual_seed(3),
                   0.0)

    jm = _jax_model(fusion, kernels=True)
    jp = _jparams(fusion)
    half = B // 2
    for c, key in enumerate(keys):
        sl = slice(c * half, (c + 1) * half)
        want = jm.apply(jp, {k: jnp.asarray(v[sl]) for k, v in feats.items()},
                        {k: jnp.asarray(v[sl]) for k, v in masks.items()},
                        rng=key, max_len=L, greedy=False, repeat=S,
                        method="sample")
        np.testing.assert_array_equal(
            seen["tokens"][c * half * S: (c + 1) * half * S],
            np.asarray(want.tokens), err_msg=f"chunk {c}")
    ref = jrewards.CiderDRewarder(jds, weighted_refs=True)
    rewards = ref.score_ids(np.repeat(VID, S), seen["tokens"])
    greedy = None
    if baseline == "greedy":
        g = jm.apply(jp, _j(feats), _j(masks), max_len=L, greedy=True,
                     method="sample")
        greedy = ref.score_ids(VID, np.asarray(g.tokens))
    base = jcst._baseline_from(rewards, greedy, S, baseline,
                               gt_rows=ref.gt_consensus()[VID])
    adv = rewards - base
    assert rewards.max() > 0.0
    np.testing.assert_array_equal(seen["adv"], adv)
    assert metrics["reward"] == float(rewards.mean())
    assert metrics["advantage"] == float(adv.mean())

    state = jsteps.TrainState.create(apply_fn=jm.apply, params=jp,
                                     tx=jsteps.make_optimizer(jc.train, 1))
    state, jloss, _ = jax.jit(
        lambda st, f, m, t, k, a: jcst._pg_update(st, f, m, None, S, t, k, a,
                                                  1.0))(
        state, _j(feats), _j(masks), jnp.asarray(seen["tokens"]),
        jnp.asarray(seen["mask"]), jnp.asarray(adv))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    for k, v in state.params["params"].items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


ROLLOUT_CASES = [("padded", 0, 1), ("slot", 3, 1), ("slot", 5, 2)]


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("layout,n_slots,block", ROLLOUT_CASES)
def test_slot_rollout_vs_jax(fusion, layout, n_slots, block):
    """``SlotRollout`` over (layers, slots, H) carries: the port vs the
    reference's on the same params, batch and key (sampled and greedy
    rows in one matrix), tokens and stats equal; the port's slot runs
    bitwise its padded run."""
    feats, masks = _batch()
    key = jax.random.PRNGKey(13)
    ro = jcst.SlotRollout(_jax_model(fusion), max_len=L, temperature=0.8,
                          n_slots=n_slots, block=block,
                          padded=layout == "padded")
    want, wstats = ro.run(_jparams(fusion), _j(feats), _j(masks), None, key,
                          repeat=S, need_greedy=True)
    runs = {}
    for lay, n, b in (("padded", 0, 1), (layout, n_slots, block)):
        pro = tcst.SlotRollout(_port(fusion), max_len=L, temperature=0.8,
                               n_slots=n, block=b, padded=lay == "padded")
        runs[lay] = pro.run(_t(feats), _t(masks), None, _kd(key), repeat=S,
                            need_greedy=True)
    got, stats = runs[layout]
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == wstats
    np.testing.assert_array_equal(runs["padded"][0], got)
    lengths = (got != PAD_ID).sum(1)
    assert lengths.min() < L and len(set(lengths.tolist())) > 1


# -------------------------------------------------------------- serving

def _serve_cfg(get, fusion, mode, continuous, dtype="f32"):
    c = get("synthetic_smoke")
    c.model.num_layers = LAYERS
    c.model.feature_fusion = fusion
    c.model.use_pallas_attention = True
    c.eval.beam_size = 4
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode, sv.dtype = (
        continuous, False, mode, dtype)
    if mode == "beam":
        sv.num_slots, sv.slot_bank_min = 4, 2
    else:
        sv.num_slots, sv.slot_bank_min = 16, 8
    return c


def _spread(params, mode):
    """Spread the random init's captions (embeddings x10, layer 0 x2,
    layer 1 x4, vocab x3, an EOS bias) so they differ and end at
    different steps."""
    pp = dict(jax.tree.map(np.asarray, jax.device_get(params))["params"])
    pp["word_embed"] = pp["word_embed"] * 10.0
    pp["lstm0_w"] = pp["lstm0_w"] * 2.0
    pp["lstm1_w"] = pp["lstm1_w"] * 4.0
    pp["logit_w"] = pp["logit_w"] * 3.0
    b = pp["logit_b"].copy()
    b[2] += 0.6 if mode == "beam" else 0.4
    pp["logit_b"] = b
    return {"params": pp}


def _payloads(seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 10)), 64)
                                     * 2.0).astype(np.float32)}}
            for _ in range(N_REQ)]


def _ladder(eng):
    reqs = [eng.prepare(p) for p in _payloads()]
    out = []
    for i in range(0, len(reqs), eng.max_batch):
        out += eng.decode_prepared(reqs[i:i + eng.max_batch], store=False)
    return [[int(t) for t in r.tokens] for r in out]


def _slots(eng):
    dec = eng.slot_decoder()
    reqs = [eng.prepare(p) for p in _payloads()]
    got, pending, k = {}, list(range(len(reqs))), 0
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(1 + k % 2, len(pending), len(dec.free), dec.admit_cap)
        k += 1
        adm = [pending.pop(0) for _ in range(n)]
        for i, tokens, _, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = [int(t) for t in tokens]
    assert dec.state_bytes() == dec.expected_state_bytes()
    return [got[i] for i in range(len(reqs))], dec


@pytest.fixture(scope="module")
def serve_worlds():
    """Per (fusion, mode): spread two-layer weights, the JAX engine's
    ladder and slot-loop tokens, and the vocabulary."""
    out = {}
    for fusion in FUSIONS:
        for mode in ("beam", "greedy"):
            base = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, False),
                             random_init=True)
            params = _spread(base.params, mode)
            jp = jax.tree.map(jnp.asarray, params)
            lad = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, False),
                            params=jp, vocab=base.vocab)
            slot = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, True),
                             params=jp, vocab=base.vocab)
            out[(fusion, mode)] = types.SimpleNamespace(
                params=params, jvocab=base.vocab,
                vocab=Vocabulary(base.vocab.idx_to_word[4:]),
                ladder=_ladder(lad), slots=_slots(slot)[0])
    return out


def _port_engine(w, fusion, mode, continuous, dtype="f32"):
    return InferenceEngine(_serve_cfg(tcfg.get_preset, fusion, mode,
                                      continuous, dtype),
                           params=w.params, vocab=w.vocab, device="cpu")


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_engines_token_exact_vs_jax(serve_worlds, fusion, mode):
    """The ladder and the slot loop at L = 2 vs the JAX engines on the
    same spread weights, token for token; the slot loop is the port's
    offline per-step decode of the same requests, and its carry bytes
    gain the layer factor (``expected_state_bytes``)."""
    w = serve_worlds[(fusion, mode)]
    assert len({tuple(t) for t in w.ladder}) > 1
    ladder = _port_engine(w, fusion, mode, False)
    assert ladder.model.num_layers == LAYERS
    assert _ladder(ladder) == w.ladder
    eng = _port_engine(w, fusion, mode, True)
    toks, dec = _slots(eng)
    assert toks == w.slots
    m, ev = eng.model, eng.cfg.eval
    reqs = [eng.prepare(p) for p in _payloads()]
    cache = eng.encode_prepared_rows(reqs)
    state = m.init_state(N_REQ)
    if mode == "beam":
        want = beam_search_from_state(
            m, state, cache, beam_size=ev.beam_size,
            max_len=ev.max_decode_len,
            length_normalize=ev.length_normalize).tokens.numpy()
    else:
        want = m._sample_from_cache(state, cache,
                                    max_len=ev.max_decode_len).tokens.numpy()
    for i in range(N_REQ):
        np.testing.assert_array_equal(toks[i], want[i], err_msg=f"req {i}")
    assert tuple(dec._st.core.state.h.shape)[0] == LAYERS
    single = dec.expected_state_bytes()
    m.num_layers = 1
    try:
        one = dec.expected_state_bytes()
    finally:
        m.num_layers = LAYERS
    cdt = 4
    assert single - one == dec.S * dec.K * m.rnn_size * (cdt + 4)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_tier2_id_only_hits_at_two_layers(serve_worlds, fusion):
    """The tier-2 encoder rows are per video, whatever the layer count:
    at L = 2 the slot loop serves ``feature_id``-only repeats with no
    encode, token for token the features requests (the JAX slot loop's
    tokens)."""
    w = serve_worlds[(fusion, "beam")]
    eng = _port_engine(w, fusion, "beam", True)
    first = [{**p, "feature_id": f"f{i}"} for i, p in enumerate(_payloads())]
    dec = eng.slot_decoder()

    def drive(reqs):
        got, pending = {}, list(range(len(reqs)))
        while pending or dec.occupied:
            n = min(2, len(pending), len(dec.free), dec.admit_cap)
            adm = [pending.pop(0) for _ in range(n)]
            for i, tokens, _, _ in dec.harvest_many(
                    dec.tick([reqs[i] for i in adm], adm)):
                got[i] = [int(t) for t in tokens]
        return [got[i] for i in range(len(reqs))]

    assert drive([eng.prepare(p) for p in first]) == w.slots
    enc0, hit0 = eng.admit_rows_encoded, eng.admit_rows_cached
    hits = [eng.prepare({"feature_id": f"f{i}"}) for i in range(N_REQ)]
    assert all(h.enc_row is not None for h in hits)
    assert drive(hits) == w.slots
    assert eng.admit_rows_encoded == enc0
    assert eng.admit_rows_cached == hit0 + N_REQ
    assert dec.state_bytes() == dec.expected_state_bytes()


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_int8w_and_bf16_serve_stacks(serve_worlds, fusion, mode):
    """int8w and bf16 at L = 2: the int8w ladder and slot loop against
    the JAX int8w engine's ladder at the relaxed-serving floor, the
    int8w slot loop equal to its own offline per-step decode, and the
    bf16 slot loop to its ladder at the same floor."""
    w = serve_worlds[(fusion, mode)]
    jeng = JaxEngine(_serve_cfg(jcfg.get_preset, fusion, mode, False,
                                "int8w"),
                     params=jax.tree.map(jnp.asarray, w.params),
                     vocab=w.jvocab)
    want = _ladder(jeng)
    lad = _port_engine(w, fusion, mode, False, "int8w")
    assert lad.model.weight_quant and lad.model.lstm1_w.dtype == torch.int8
    got_l = _ladder(lad)
    got_s, _ = _slots(_port_engine(w, fusion, mode, True, "int8w"))
    for got in (got_l, got_s):
        assert np.mean([a == b for a, b in zip(got, want)]) >= \
            RELAXED_SERVING_MATCH_FLOOR
    b_l = _ladder(_port_engine(w, fusion, mode, False, "bf16"))
    b_s, _ = _slots(_port_engine(w, fusion, mode, True, "bf16"))
    assert np.mean([a == b for a, b in zip(b_l, b_s)]) >= \
        RELAXED_SERVING_MATCH_FLOOR


# ---------------------------------------------------------------- eval

WIDTH = 32
METRICS = ["Bleu_4", "CIDEr"]


def _eval_cfgs(fusion):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_preset("synthetic_smoke")
        cfg.data.feature_modalities = ["resnet", "c3d"]
        cfg.data.feature_dims = {"resnet": 24, "c3d": 40}
        cfg.model.num_layers = LAYERS
        cfg.model.feature_fusion = fusion
        cfg.eval.metrics = list(METRICS)
        cfg.eval.beam_size = 5
        cfg.eval.max_decode_len = 8
        out.append(cfg)
    return out


def _eval_models(jc, tc):
    jds, jvocab = jbuild.build_dataset(jc, "test")
    tds, _ = tbuild.build_dataset(tc, "test")
    jc.model.vocab_size = tc.model.vocab_size = len(jvocab)
    jm = jcap.model_from_config(jc)
    Fr = jc.data.max_frames
    feats = {m: jnp.zeros((1, Fr, d)) for m, d in jc.data.feature_dims.items()}
    masks = {m: jnp.ones((1, Fr)) for m in feats}
    params = jm.init(jax.random.PRNGKey(0), feats, masks,
                     jnp.zeros((1, 2), jnp.int32))
    tm = model_from_config(tc, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm, jds, tds


def _files(d):
    out = {}
    for n in ("predictions.json", "scores.json"):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


@pytest.mark.parametrize("fusion", FUSIONS)
def test_evaluate_dataset_stacked_matches_jax(tmp_path, fusion, caplog):
    """The beam-5 eval at L = 2: ``predictions.json`` and ``scores.json``
    byte for byte the JAX eval's, the backend line naming the per-step
    beam; ``cli/test`` with ``--model.num_layers 2`` writes the same
    files from a port checkpoint."""
    jc, tc = _eval_cfgs(fusion)
    jm, params, tm, jds, tds = _eval_models(jc, tc)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_evaluate(jm, params, jds, jc, out_dir=jdir)
    with caplog.at_level(logging.INFO, logger="cst_captioning_torch.eval"):
        evaluate_dataset(tm, tds, tc, out_dir=tdir, device="cpu")
    assert _files(tdir) == _files(jdir)
    assert "beam decode backend: per-step beam (num_layers=2" in caplog.text
    ck = str(tmp_path / "ck" / "best")
    os.makedirs(ck)
    torch.save(tm.state_dict(), os.path.join(ck, tckpt.PARAMS_FILE))
    out = str(tmp_path / "cli")
    argv = ["--checkpoint", ck, "--preset", "synthetic_smoke",
            "--data.feature_modalities",
            json.dumps(tc.data.feature_modalities),
            "--data.feature_dims", json.dumps(tc.data.feature_dims),
            "--model.num_layers", str(LAYERS),
            "--model.feature_fusion", fusion,
            "--eval.beam_size", "5", "--eval.max_decode_len", "8",
            "--eval.metrics", json.dumps(METRICS), "--eval.out_dir", out]
    assert tcli_test.main(argv, device="cpu") == 0
    assert _files(out) == _files(jdir)


# ------------------------------------------- checkpoints, warm starts

def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint",
        os.path.join(REPO, "scripts", "export_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quant", [False, True])
def test_export_import_round_trip_stacked(tmp_path, quant):
    """A two-layer JAX train state saved by orbax (quantized or not)
    exports and imports under ``--model.num_layers 2`` into exactly its
    tree; the imported checkpoint serves."""
    over = ["--preset", "synthetic_smoke", "--model.num_layers", "2",
            "--eval.beam_size", "3", "--eval.max_decode_len", "8"]
    if quant:
        over += ["--serving.dtype", "int8w"]
    jc = jcfg.parse_cli(over)
    ds, jvocab = jbuild.build_dataset(jc, "train")
    jc.model.vocab_size = len(jvocab)
    jm = jcap.model_from_config(jc)
    Fr = jc.data.max_frames
    feats = {m: jnp.zeros((1, Fr, d)) for m, d in jc.data.feature_dims.items()}
    masks = {m: jnp.ones((1, Fr)) for m in feats}
    params = jm.init(jax.random.PRNGKey(2), feats, masks,
                     jnp.zeros((1, 2), jnp.int32))
    if quant:
        params = jquant.quantize_params(params)
    tx = jsteps.make_optimizer(jc.train, 2)
    state = types.SimpleNamespace(params=params,
                                  opt_state=tx.init(params), step=2)
    orbax = str(tmp_path / "orbax")
    jckpt.save_checkpoint(orbax, state, {"epoch": 1})
    export, port = str(tmp_path / "export"), str(tmp_path / "port")
    assert _exporter().main(["--checkpoint", orbax, "--out", export]
                            + over) == 0
    assert importer.main(["--export", export, "--out", port] + over) == 0
    sd = tckpt.load_params_file(port)
    tree = jax.tree.map(np.asarray, params)["params"]
    assert set(sd) == set(tree) and "lstm1_w" in sd
    for k, v in tree.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert tckpt.load_infos(port)["quantized"] is quant
    tc = tcfg.parse_cli(over)
    tc.serving.continuous = tc.serving.warmup = False
    eng = InferenceEngine(tc, checkpoint=port,
                          vocab=Vocabulary(jvocab.idx_to_word[4:]),
                          device="cpu")
    assert eng.model.num_layers == LAYERS
    out = eng.decode_prepared([eng.prepare(p) for p in _payloads()[:3]],
                              store=False)
    assert len(out) == 3


def test_trainer_checkpoints_and_warm_starts_stacked(tmp_path):
    """An XE epoch at L = 2 writes its checkpoint; ``start_from`` loads
    both layers exactly into a CST trainer, which trains an epoch
    through the slot rollout."""
    cfg = tcfg.get_preset("synthetic_smoke").replace(
        **{"model.num_layers": 2, "train.max_epochs": 1})
    cfg.train.checkpoint_dir = str(tmp_path / "xe")
    ds, _ = tbuild.build_dataset(cfg, "train")
    tr = Trainer(cfg, ds, device="cpu")
    hist = tr.fit()
    assert np.isfinite(hist["0"]["train_loss"])
    best = os.path.join(tr.workdir, "last")
    sd = tckpt.load_params_file(best)
    assert tuple(sd["lstm1_w"].shape) == (64, 128)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    cst = tcfg.get_preset("synthetic_smoke").replace(
        **{"model.num_layers": 2, "train.max_epochs": 1,
           "train.train_mode": "cst", "train.cst_rollout": "slot",
           "train.start_from": best})
    cst.train.checkpoint_dir = str(tmp_path / "cst")
    tr2 = Trainer(cst, ds, device="cpu")
    for k, v in sd.items():
        assert torch.equal(tr2.model.state_dict()[k], v), k
    assert tr2._train_step.layout == "slot:slot"
    hist2 = tr2.fit()
    assert np.isfinite(hist2["0"]["train_loss"])


def test_cli_train_then_serve_stacked(tmp_path, monkeypatch):
    """``cli/train.py --model.num_layers 2`` trains and checkpoints a
    stack (its trainer on the CPU); ``cli/serve.py --checkpoint ...
    --model.num_layers 2`` serves it over HTTP with the engine's own
    caption."""
    monkeypatch.setattr(tcli_train, "Trainer", lambda cfg, **kw: Trainer(
        cfg, **{**kw, "device": "cpu"}))
    ck = str(tmp_path / "ck")
    over = ["--preset", "synthetic_smoke", "--model.num_layers", "2"]
    assert tcli_train.main(over + ["--train.max_epochs", "1",
                                   "--train.checkpoint_dir", ck]) == 0
    last = os.path.join(ck, "synthetic_smoke", "last")
    assert tuple(tckpt.load_params_file(last)["lstm1_w"].shape) == (64, 128)
    _, vocab = tbuild.build_dataset(tcfg.get_preset("synthetic_smoke"),
                                    "train")
    vocab_file = str(tmp_path / "vocab.json")
    vocab.save(vocab_file)
    made = []

    class Recording(tserver.CaptionServer):
        def __init__(self, engine, **kw):
            super().__init__(engine, port=0, **kw)
            made.append(self)

    monkeypatch.setattr(tserver, "CaptionServer", Recording)
    argv = over + ["--checkpoint", last, "--data.vocab_file", vocab_file,
                   "--serving.warmup", "false"]
    rc = []
    t = threading.Thread(target=lambda: rc.append(
        tcli_serve.main(argv, device="cpu")), daemon=True)
    t.start()
    for _ in range(600):
        if made and made[0]._listening:
            break
        threading.Event().wait(0.05)
    srv = made[0]
    payload = {"features": {"resnet": _payloads()[2]["features"]["resnet"]
                            .tolist()}}
    req = urllib.request.Request(
        srv.url + "/v1/caption", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
    srv.shutdown()
    t.join(timeout=30)
    assert rc == [0]
    eng = srv.engine
    assert eng.model.num_layers == LAYERS
    want = eng.decode_prepared([eng.prepare(payload)], store=False)[0]
    assert body["tokens"] == want.tokens and body["caption"] == want.caption
