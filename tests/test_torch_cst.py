"""Port parity for CST training: the rollout, the policy-gradient (PG)
update, the baselines and whole split steps of ``cst_captioning_torch``
against the JAX package's ``training/cst.py`` on the same numpy-seeded
inputs, plus the port's own scheduling, refusals and ``Trainer`` runs.

Sizes: 4 videos, S = 2 rollouts each, V = 300, max_len 8, both fusions.
The JAX model runs its Pallas kernels in interpret mode (the sampler at
8 rows, the recurrences), as the JAX package's own tests run them.
Tolerances, stated where they are held:

* rollout tokens and masks exact, log-probs within 1e-4 (the tier of
  ``tests/test_torch_sampler.py``);
* PG loss rtol 1e-5, grad norm rtol 1e-4, parameters after the Adam step
  rtol 2e-5 / atol 1e-7;
* rewards, baselines and advantages bitwise (the same scorer backend on
  both sides; ``_baseline_from`` the same float32 numpy ops);
* overlap on and off bitwise.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data.datasets import InMemoryDataset as JaxDataset
from cst_captioning_tpu.data.vocab import Vocabulary as JaxVocabulary
from cst_captioning_tpu.models.captioner import CaptionModel as JaxModel
from cst_captioning_tpu.training import cst as jcst
from cst_captioning_tpu.training import rewards as jrewards
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data.datasets import InMemoryDataset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.models.captioner import (
    CaptionModel,
    _repeat_cache,
    draw_seeds,
)
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import steps as tsteps
from cst_captioning_torch.training.rewards import CiderDRewarder, RewardPool
from cst_captioning_torch.training.trainer import Trainer

E, H, A, D1, D2, F, L = 16, 16, 24, 24, 32, 5, 8
WORDS = [f"w{i}" for i in range(296)]
V = len(WORDS) + 4
NVID, B, S = 8, 4, 2
VID = np.array([5, 1, 6, 2], np.int32)
BASELINES = ("greedy", "scb", "none", "gt_consensus")
FUSIONS = ("meanpool", "attention")
PHASES = {"dispatch_ms", "sample_fetch_ms", "score_ms", "score_wait_ms",
          "update_ms", "total_ms"}


# ---------------------------------------------------------------- inputs

def _corpus_parts():
    """NVID videos over 4 topics of 12 words, 5 references of 3-6 words
    each, features at (F, D1) / (F, D2), random consensus weights."""
    rng = np.random.RandomState(0)
    topics = rng.choice(len(WORDS), (4, 12), replace=False)
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
    """The step's batch: videos VID's features, frame masks with tails."""
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


@functools.lru_cache(maxsize=None)
def _jax_model(fusion):
    return JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                    modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                    fusion=fusion, att_hidden_size=A, compute_dtype="float32",
                    drop_prob=0.0, use_pallas=True, use_pallas_attention=True,
                    use_pallas_sampler=True)


@functools.lru_cache(maxsize=None)
def _params(fusion):
    """JAX init, with the topic words' and EOS's logit biases raised so
    the rollouts earn non-zero rewards and end at varied lengths."""
    feats, masks = _batch()
    p = _jax_model(fusion).init(jax.random.PRNGKey(0), _j(feats), _j(masks),
                                jnp.zeros((B, 2), jnp.int32))
    p = jax.tree.map(np.array, p)
    topics = _corpus_parts()[0]
    p["params"]["logit_b"][np.unique(topics) + 4] += 4.0
    p["params"]["logit_b"][2] += 6.0
    return p


def _jparams(fusion):
    return jax.tree.map(jnp.asarray, _params(fusion))


def _port_model(fusion):
    m = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                     modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                     fusion=fusion, att_hidden_size=A, compute_dtype="float32",
                     device="cpu")
    return load_params(m, _params(fusion))


def _cfgs(baseline="scb", **train):
    """(port, JAX) ``synthetic_smoke`` configs for a CST run at L."""
    out = []
    for mod in (tcfg, jcfg):
        c = mod.get_preset("synthetic_smoke")
        c.data.max_seq_len = L
        c.train.train_mode = "cst"
        c.train.cst_baseline = baseline
        c.train.cst_num_samples = S
        c.train.cst_weighted_reward = True
        c.train.cst_score_chunks = 2
        for k, v in train.items():
            setattr(c.train, k, v)
        out.append(c)
    return out


# ---------------------------------------------------------------- rollout

@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_rollout_token_exact_vs_jax(fusion, temperature):
    """``sample(repeat=S, greedy=False)``: the JAX fused sampler (interpret
    mode, 8 rows) with rng k vs the port with the two words the reference
    derives from k (``jax.random.bits(k, (2,), uint32)``)."""
    feats, masks = _batch()
    key = jax.random.PRNGKey(11)
    jm = _jax_model(fusion)
    want = jm.apply(_params(fusion), _j(feats), _j(masks), rng=key,
                    max_len=L, greedy=False, temperature=temperature,
                    repeat=S, method="sample")
    words = tuple(int(x) for x in np.asarray(
        jax.random.bits(key, (2,), jnp.uint32)))
    pm = _port_model(fusion)
    with torch.no_grad():
        cache = _repeat_cache(pm._encode(_t(feats), _t(masks)), S)
    got = pm.sample_cache(cache, words, max_len=L, greedy=False,
                          temperature=temperature)
    assert got.tokens.shape == (B * S, L)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=0, atol=1e-4)
    m = got.mask.numpy()
    assert 0 < m.sum() < m.size  # rows end at varied lengths


@pytest.mark.parametrize("fusion", FUSIONS)
def test_sample_with_baseline_one_encode(fusion):
    """``sample(repeat, generator)`` draws its words from the generator;
    ``sample_with_baseline`` gives that rollout and the greedy decode,
    which is the JAX model's greedy decode token for token."""
    feats, masks = _batch()
    pm = _port_model(fusion)
    words = draw_seeds(torch.Generator().manual_seed(4), 1)[0]
    with torch.no_grad():
        cache = pm._encode(_t(feats), _t(masks))
    want = pm.sample_cache(_repeat_cache(cache, S), words, max_len=L,
                           greedy=False)
    got = pm.sample(_t(feats), _t(masks), max_len=L, greedy=False,
                    generator=torch.Generator().manual_seed(4), repeat=S)
    rollout, greedy = pm.sample_with_baseline(
        _t(feats), _t(masks), generator=torch.Generator().manual_seed(4),
        max_len=L, repeat=S)
    for out in (got, rollout):
        assert torch.equal(out.tokens, want.tokens)
        assert torch.equal(out.logprobs, want.logprobs)
    assert torch.equal(greedy.tokens, pm.sample(
        _t(feats), _t(masks), max_len=L, greedy=True).tokens)
    jgreedy = _jax_model(fusion).apply(
        _jparams(fusion), _j(feats), _j(masks), max_len=L, greedy=True,
        method="sample")
    np.testing.assert_array_equal(greedy.tokens.numpy(),
                                  np.asarray(jgreedy.tokens))
    assert pm.sample_with_baseline(
        _t(feats), _t(masks), generator=torch.Generator().manual_seed(4),
        max_len=L, repeat=S, with_greedy=False)[1] is None


# ------------------------------------------------------------- PG update

@functools.lru_cache(maxsize=None)
def _jax_pg(fusion, temperature):
    """(initial train state, jitted reference ``_pg_update``): one
    compile per (fusion, temperature), the optimizer the ports' configs
    build."""
    jm = _jax_model(fusion)
    state = jsteps.TrainState.create(
        apply_fn=jm.apply, params=_jparams(fusion),
        tx=jsteps.make_optimizer(_cfgs()[1].train, 1))

    @jax.jit
    def run(state, feats, masks, tokens, mask, adv):
        return jcst._pg_update(state, feats, masks, None, S, tokens, mask,
                               adv, temperature)

    return state, run


def _hold_params(pm, jparams, what):
    for k, v in jparams["params"].items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-7, err_msg=f"{what} {k}")


def _rollout_rows(fusion, seed=3):
    """Tokens and mask of a JAX rollout (varied lengths, PAD tails)."""
    feats, masks = _batch()
    out = _jax_model(fusion).apply(
        _params(fusion), _j(feats), _j(masks), rng=jax.random.PRNGKey(seed),
        max_len=L, greedy=False, repeat=S, method="sample")
    return np.asarray(out.tokens), np.asarray(out.mask)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_pg_update_matches_jax(fusion, temperature):
    """The port's ``_pg_update`` vs the reference's on identical tokens,
    mask and advantage: loss rtol 1e-5, grad norm rtol 1e-4, parameters
    after the Adam step rtol 2e-5 / atol 1e-7."""
    feats, masks = _batch()
    tokens, mask = (x.copy() for x in _rollout_rows(fusion))
    assert (tokens == 0).any()  # PAD tails, fed as EOS
    adv = np.random.RandomState(2).randn(B * S).astype(np.float32)
    tc, _ = _cfgs(sample_temperature=temperature)
    state0, run = _jax_pg(fusion, temperature)
    state, jloss, jnorm = run(state0, _j(feats), _j(masks),
                              jnp.asarray(tokens), jnp.asarray(mask),
                              jnp.asarray(adv))
    pm = _port_model(fusion)
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    loss, gnorm = tcst._pg_update(
        pm, opt, _t(feats), _t(masks), S, torch.from_numpy(tokens),
        torch.from_numpy(mask), torch.from_numpy(adv), temperature)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-4)
    _hold_params(pm, state.params, fusion)


def test_pg_loss_ignores_post_eos_slots():
    """Post-EOS slots hold PAD, whose masked log-prob is -1e30: they
    carry no loss and no gradient, never NaN."""
    feats, masks = _batch()
    tokens, mask = (x.copy() for x in _rollout_rows("meanpool"))
    pm = _port_model("meanpool")
    adv = torch.ones(B * S)
    loss = tcst.pg_loss(pm, _t(feats), _t(masks), S, torch.from_numpy(tokens),
                        torch.from_numpy(mask), adv, 1.0)
    other = tokens.copy()
    other[mask == 0] = 7  # whatever the tail holds
    loss2 = tcst.pg_loss(pm, _t(feats), _t(masks), S, torch.from_numpy(other),
                         torch.from_numpy(mask), adv, 1.0)
    assert torch.isfinite(loss) and float(loss.detach()) == float(loss2.detach())
    g = torch.autograd.grad(loss, [pm.logit_w])[0]
    assert torch.isfinite(g).all()


# -------------------------------------------------------------- baselines

@pytest.mark.parametrize("kind", BASELINES)
def test_baseline_from_bitwise(kind):
    rng = np.random.RandomState(5)
    rewards = rng.rand(B * 3).astype(np.float32) * 3
    greedy = rng.rand(B).astype(np.float32)
    gt = rng.rand(B).astype(np.float32)
    want = jcst._baseline_from(rewards, greedy, 3, kind, gt_rows=gt)
    got = tcst._baseline_from(rewards, greedy, 3, kind, gt_rows=gt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_validate_and_chunk_count_match_reference():
    for b, k in ((64, 4), (64, 5), (6, 4), (7, 3), (1, 4), (4, 0)):
        assert tcst._chunk_count(k, b) == jcst._chunk_count(k, b)
    for baseline, n in (("scb", 20), ("greedy", 1), ("none", 0)):
        tc, jc = _cfgs(baseline, cst_num_samples=n)
        assert tcst._validate(tc) == jcst._validate(jc)
    for baseline, n in (("scb", 1), ("typo", 4)):
        tc, jc = _cfgs(baseline, cst_num_samples=n)
        with pytest.raises(ValueError):
            tcst._validate(tc)
        with pytest.raises(ValueError):
            jcst._validate(jc)


# ------------------------------------------------------------ whole step

def _port_step(fusion, tc, corpus, scorer=None):
    """(model, step) of the port on bridged parameters: the trainer's
    factory, or the split step on ``scorer``."""
    pm = _port_model(fusion)
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    if scorer is None:
        return pm, tcst.make_cst_train_step(pm, opt, tc, corpus)
    return pm, tcst._make_split_step(pm, opt, tc, scorer)


def _run(step, gen_seed=3):
    feats, masks = _batch()
    return step(_t(feats), _t(masks), None, None, None, torch.from_numpy(VID),
                torch.Generator().manual_seed(gen_seed), 0.0)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("baseline", BASELINES)
def test_whole_step_vs_reference(fusion, baseline, corpora, monkeypatch):
    """One split step (2 chunks, weighted 5-ref reward): from the tokens
    the port drew, the reference's rewarder, ``_baseline_from`` and
    ``_pg_update`` on the bridged parameters give the port's reward,
    baseline and advantage bitwise and its parameters at the PG tier."""
    pds, jds = corpora
    seen = {}
    real = tcst._pg_update

    def spy(model, optimizer, feats, feat_masks, S_, tokens, mask, adv, *a):
        seen.update(tokens=tokens.numpy().copy(), mask=mask.numpy().copy(),
                    adv=adv.numpy().copy())
        return real(model, optimizer, feats, feat_masks, S_, tokens, mask,
                    adv, *a)

    monkeypatch.setattr(tcst, "_pg_update", spy)
    tc, _ = _cfgs(baseline)
    pm, step = _port_step(fusion, tc, pds)
    assert step.scorer.backend == "native"
    metrics = _run(step)

    ref = jrewards.CiderDRewarder(jds, weighted_refs=True)
    assert ref.backend == "native"
    rewards = ref.score_ids(np.repeat(VID, S), seen["tokens"])
    greedy = None
    feats, masks = _batch()
    if baseline == "greedy":
        g = _jax_model(fusion).apply(_jparams(fusion), _j(feats), _j(masks),
                                     max_len=L, greedy=True, method="sample")
        greedy = ref.score_ids(VID, np.asarray(g.tokens))
    base = jcst._baseline_from(rewards, greedy, S, baseline,
                               gt_rows=ref.gt_consensus()[VID])
    adv = rewards - base
    assert rewards.max() > 0.0
    np.testing.assert_array_equal(seen["adv"], adv)
    assert metrics["reward"] == float(rewards.mean())
    assert metrics["baseline"] == float(base.mean())
    assert metrics["advantage"] == float(adv.mean())

    state0, run = _jax_pg(fusion, 1.0)
    state, jloss, _ = run(state0, _j(feats), _j(masks),
                          jnp.asarray(seen["tokens"]),
                          jnp.asarray(seen["mask"]), jnp.asarray(adv))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    _hold_params(pm, state.params, f"{fusion} {baseline}")
    keys = PHASES | ({"greedy_fetch_ms"} if baseline == "greedy" else set())
    assert set(step.phase_ms) == keys


@pytest.mark.parametrize("pooled", [False, True])
def test_overlap_is_scheduling_only(pooled, corpora):
    """Overlap on and off from the same state and seed: bitwise the same
    metrics and parameters, on the native scorer and on a 2-worker pool
    of the Python scorer (greedy baseline: streamed rollout chunks and
    submitted greedy rows)."""
    pds = corpora[0]
    out = []
    with RewardPool(CiderDRewarder(pds, backend="python",
                                   weighted_refs=True), 2) as pool:
        for overlap in (True, False):
            tc, _ = _cfgs("greedy", overlap_rewards=overlap)
            pm, step = _port_step("meanpool", tc, pds,
                                  pool if pooled else None)
            m = _run(step)
            out.append((m, pm.state_dict()))
    (m1, p1), (m2, p2) = out
    for k in ("reward", "baseline", "advantage"):
        assert m1[k] == m2[k], k
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in p1.items():
        assert torch.equal(v, p2[k]), k


def test_phase_keys_are_the_reference_split_steps(corpora):
    """The port's ``phase_ms`` keys are those the reference's split step
    records (greedy baseline: every phase)."""
    pds, jds = corpora
    feats, masks = _batch()
    tc, jc = _cfgs("greedy")
    jm = _jax_model("meanpool").clone(use_pallas=False,
                                      use_pallas_sampler=False)
    state = jsteps.TrainState.create(
        apply_fn=jm.apply, params=_jparams("meanpool"),
        tx=jsteps.make_optimizer(jc.train, 1))
    jstep = jcst._make_split_step(jm, jc, jrewards.CiderDRewarder(jds))
    jstep(state, _j(feats), _j(masks), None, None, None, jnp.asarray(VID),
          jax.random.PRNGKey(0), 0.0)
    _, step = _port_step("meanpool", tc, pds)
    _run(step)
    assert set(step.phase_ms) == set(jstep.phase_ms) == PHASES | {
        "greedy_fetch_ms"}


# --------------------------------------------------------------- refusals

def test_cst_use_gt_dispatches_to_wxe(corpora):
    tc, _ = _cfgs("none", cst_use_gt=True)
    pm = _port_model("meanpool")
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    step = tcst.make_cst_train_step(pm, opt, tc, corpora[0])
    assert not hasattr(step, "phase_ms")
    feats, masks = _batch()
    caps = torch.from_numpy(np.stack(
        [corpora[0].captions(int(v))[:3] for v in VID]))
    w = torch.rand(B, 3)
    out = step(_t(feats), _t(masks), caps, w, None, torch.from_numpy(VID),
               None, 0.0)
    want = tsteps.xe_loss(_port_model("meanpool"), _t(feats), _t(masks),
                          caps, w)
    assert float(out["loss"]) == float(want.detach())


@pytest.mark.parametrize("override,exc,match", [
    ({"cst_rollout": "slot"}, NotImplementedError, "Queue 1, item 1"),
    ({"cst_rollout": "padded"}, NotImplementedError, "Queue 1, item 1"),
    ({"cst_split_layout": "pipeline"}, NotImplementedError, "Queue 1, item 1"),
    ({"cst_split_layout": "onegraph"}, ValueError, "cst_split_layout"),
    ({"cst_rollout": "beam"}, ValueError, "cst_rollout"),
])
def test_refusals(override, exc, match, corpora, tmp_path):
    tc, _ = _cfgs(**override)
    tc.train.checkpoint_dir = str(tmp_path)
    pm = _port_model("meanpool")
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    with pytest.raises(exc, match=match):
        tcst.make_cst_train_step(pm, opt, tc, corpora[0])
    with pytest.raises(exc, match=match):
        Trainer(tc, corpora[0], device="cpu")


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def xe_checkpoints(tmp_path_factory):
    """A 1-epoch XE run per fusion on ``synthetic_smoke``: the warm start
    of the CST runs."""
    root = tmp_path_factory.mktemp("xe")
    out = {}
    for fusion in FUSIONS:
        cfg = tcfg.get_preset("synthetic_smoke")
        cfg.model.feature_fusion = fusion
        cfg.train.checkpoint_dir = str(root)
        cfg.train.max_epochs = 1
        cfg.name = f"xe_{fusion}"
        tr, vocab = tbuild.build_dataset(cfg, "train")
        t = Trainer(cfg, tr, None, device="cpu")
        t.fit()
        out[fusion] = (os.path.join(t.workdir, "last"),
                       {k: v.clone() for k, v in t.model.state_dict().items()})
    return out


@pytest.mark.parametrize("fusion,baseline,overlap", [
    ("meanpool", "scb", True), ("meanpool", "greedy", False),
    ("meanpool", "none", True), ("meanpool", "gt_consensus", False),
    ("attention", "scb", False), ("attention", "greedy", True),
    ("attention", "none", False), ("attention", "gt_consensus", True)])
def test_trainer_cst_fit_from_xe_checkpoint(fusion, baseline, overlap,
                                            xe_checkpoints, tmp_path):
    """A 1-epoch CST fit warm-started from the port's XE checkpoint:
    ``history.json`` holds the reward, baseline, advantage and the
    epoch means of every phase; the parameters moved."""
    start, xe_params = xe_checkpoints[fusion]
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.feature_fusion = fusion
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = 1
    cfg.train.train_mode = "cst"
    cfg.train.cst_baseline = baseline
    cfg.train.cst_num_samples = 3
    cfg.train.overlap_rewards = overlap
    cfg.train.start_from = start
    cfg.name = "cst"
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    t = Trainer(cfg, tr, va, device="cpu")
    for k, v in xe_params.items():
        assert torch.equal(t.model.state_dict()[k], v), k
    hist = t.fit()
    with open(os.path.join(t.workdir, "history.json")) as f:
        assert json.load(f) == json.loads(json.dumps(hist))
    e = hist["0"]
    for k in ("train_loss", "grad_norm", "reward", "baseline", "advantage"):
        assert np.isfinite(e[k]), k
    phases = {f"phase_{k}" for k in PHASES}
    if baseline == "greedy":
        phases.add("phase_greedy_fetch_ms")
    assert phases <= set(e) and all(e[k] >= 0.0 for k in phases)
    assert "CIDEr" in e["val"]
    assert any(not torch.equal(t.model.state_dict()[k], v)
               for k, v in xe_params.items())
