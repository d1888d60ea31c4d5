"""Port parity for the per-step multinomial decode and CST's slot /
padded rollout against the JAX package (``CaptionModel.
_sample_from_cache(greedy=False)``, ``training/cst.py::SlotRollout`` and
``_make_slot_step``), on the same numpy-seeded inputs, bridged weights
and JAX keys (the port takes a key's two ``key_data`` words).

Sizes: 4 videos, S = 2 rollouts each, V = 300, max_len 8, float32, both
fusions; the JAX model runs without its Pallas kernels (the slot
rollout and the per-step decode are XLA paths in the reference).
Tolerances, stated where they are held:

* tokens, harvest stats and masks exact (the threefry streams are
  replayed bit for bit); per-step log-probs rtol 1e-5 / atol 1e-6;
* rewards rtol 1e-5 (the scorer pair's tier), PG loss rtol 1e-5,
  parameters after two Adam steps rtol 2e-5 / atol 1e-7
  (``test_torch_cst.py``'s training tier);
* the port's padded and slot layouts bitwise equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data.datasets import InMemoryDataset as JaxDataset
from cst_captioning_tpu.data.vocab import Vocabulary as JaxVocabulary
from cst_captioning_tpu.models import captioner as jcap
from cst_captioning_tpu.training import cst as jcst
from cst_captioning_tpu.training import rewards as jrewards
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.constants import PAD_ID
from cst_captioning_torch.data.datasets import InMemoryDataset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.models.captioner import CaptionModel, _repeat_cache
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.training import cst as tcst
from cst_captioning_torch.training import steps as tsteps

E, H, A, D1, D2, F, L = 16, 16, 24, 24, 32, 5, 8
WORDS = [f"w{i}" for i in range(296)]
V = len(WORDS) + 4
NVID, B, S = 8, 4, 2
VID = np.array([5, 1, 6, 2], np.int32)
FUSIONS = ("meanpool", "attention")


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
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@functools.lru_cache(maxsize=None)
def _jax_model(fusion):
    return jcap.CaptionModel(
        vocab_size=V, rnn_size=H, embed_size=E, modalities=("resnet", "c3d"),
        feature_dims=(D1, D2), fusion=fusion, att_hidden_size=A,
        compute_dtype="float32", drop_prob=0.0, use_pallas=False,
        use_pallas_attention=False, use_pallas_sampler=False)


@functools.lru_cache(maxsize=None)
def _params(fusion):
    """JAX init with the topic words' and EOS's logit biases raised, so
    rows earn rewards and end at varied lengths."""
    feats, masks = _batch()
    p = _jax_model(fusion).init(jax.random.PRNGKey(0), _j(feats), _j(masks),
                                jnp.zeros((B, 2), jnp.int32))
    p = jax.tree.map(np.array, p)
    p["params"]["logit_b"][np.unique(_corpus_parts()[0]) + 4] += 4.0
    p["params"]["logit_b"][2] += 6.0
    return p


def _port_model(fusion):
    m = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                     modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                     fusion=fusion, att_hidden_size=A, compute_dtype="float32",
                     device="cpu")
    return load_params(m, _params(fusion))


def _cfgs(baseline="scb", **train):
    out = []
    for mod in (tcfg, jcfg):
        c = mod.get_preset("synthetic_smoke")
        c.data.max_seq_len = L
        c.train.train_mode = "cst"
        c.train.cst_baseline = baseline
        c.train.cst_num_samples = S
        c.train.cst_weighted_reward = True
        for k, v in train.items():
            setattr(c.train, k, v)
        out.append(c)
    return out


# ------------------------------------------------- per-step multinomial

@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("temperature,seed", [(1.0, 5), (0.7, 9), (1.0, None)])
def test_sample_from_cache_vs_jax(fusion, temperature, seed):
    """``_sample_from_cache(greedy=False)`` on the batch stream: the
    reference on key k (``PRNGKey(0)`` when None) vs the port on k's
    words; tokens and masks exact, log-probs rtol 1e-5."""
    feats, masks = _batch()
    jm = _jax_model(fusion)
    params = jax.tree.map(jnp.asarray, _params(fusion))
    jstate, jcache = jm.apply(params, _j(feats), _j(masks), None,
                              method="init_decode")
    jcache = jcap._repeat_cache(jcache, S)
    jstate = jm.apply(params, B * S, method="_init_state")
    key = None if seed is None else jax.random.PRNGKey(seed)
    want = jm.apply(params, jstate, jcache, rng=key, max_len=L, greedy=False,
                    temperature=temperature, method="_sample_from_cache")
    pm = _port_model(fusion)
    with torch.no_grad():
        cache = _repeat_cache(pm._encode(_t(feats), _t(masks)), S)
    got = pm._sample_from_cache(pm.init_state(B * S), cache, max_len=L,
                                greedy=False, temperature=temperature,
                                key=None if key is None else _kd(key))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=1e-5, atol=1e-6)
    m = got.mask.numpy()
    assert 0 < m.sum() < m.size


# --------------------------------------------------------- slot rollout

ROLLOUT_CASES = [("padded", 0, 1), ("padded", 0, 2), ("slot", 3, 1),
                 ("slot", 3, 2), ("slot", 5, 1), ("slot", 5, 2)]


def _port_rollout(fusion, layout, n_slots, block, key, temperature=1.0,
                  need_greedy=True):
    feats, masks = _batch()
    ro = tcst.SlotRollout(_port_model(fusion), max_len=L,
                          temperature=temperature, n_slots=n_slots,
                          block=block, padded=layout == "padded")
    seen = []
    toks, stats = ro.run(_t(feats), _t(masks), None, key, repeat=S,
                         need_greedy=need_greedy,
                         on_harvest=lambda ids, t: seen.append((list(ids), t)))
    return toks, stats, seen


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("layout,n_slots,block", ROLLOUT_CASES)
def test_slot_rollout_vs_jax(fusion, layout, n_slots, block):
    """The port's ``SlotRollout`` vs the reference's on the same params,
    batch and key (sampled rows and greedy-baseline rows in one matrix):
    tokens and stats equal; every row harvested once, with its tokens."""
    feats, masks = _batch()
    key = jax.random.PRNGKey(13)
    ro = jcst.SlotRollout(_jax_model(fusion), max_len=L, temperature=0.8,
                          n_slots=n_slots, block=block,
                          padded=layout == "padded")
    want, wstats = ro.run(jax.tree.map(jnp.asarray, _params(fusion)),
                          _j(feats), _j(masks), None, key, repeat=S,
                          need_greedy=True)
    got, stats, seen = _port_rollout(fusion, layout, n_slots, block,
                                     _kd(key), temperature=0.8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == wstats
    ids = [r for h, _ in seen for r in h]
    assert sorted(ids) == list(range(B * S + B))
    for h, t in seen:
        np.testing.assert_array_equal(t, got[h])
    lengths = (got != PAD_ID).sum(1)
    assert lengths.min() < L and len(set(lengths.tolist())) > 1


@pytest.mark.parametrize("fusion", FUSIONS)
def test_slot_layouts_bitwise(fusion):
    """The port's padded run and slot runs at several geometries give
    bitwise the same tokens; a second run reuses the slot state."""
    key = (0x12345678, 0x9ABCDEF0)
    want, wstats, _ = _port_rollout(fusion, "padded", 0, 1, key)
    assert wstats["rollout_ticks"] == L
    for n_slots, block in ((1, 1), (4, 3), (0, 1), (7, 2)):
        got, stats, _ = _port_rollout(fusion, "slot", n_slots, block, key)
        np.testing.assert_array_equal(got, want, err_msg=f"{n_slots} {block}")
        assert stats["rollout_slots"] == (n_slots or 8)
    feats, masks = _batch()
    ro = tcst.SlotRollout(_port_model(fusion), max_len=L, temperature=1.0,
                          n_slots=3)
    first = ro.run(_t(feats), _t(masks), None, key, repeat=S,
                   need_greedy=True)[0]
    again = ro.run(_t(feats), _t(masks), None, key, repeat=S,
                   need_greedy=True)[0]
    assert 3 in ro._sst_cache
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(again, want)


def test_trim_len_matches_reference():
    for longest in (0, 3, 7, 8, 15, 16, 29, 30):
        toks = np.full((3, 30), PAD_ID, np.int32)
        toks[1, :longest] = 7
        assert tcst._trim_len(toks, 30) == min(8 * 2 ** max(
            0, int(np.ceil(np.log2((longest + 1) / 8)))), 30)
        assert tcst._trim_len(toks[:, :20], 20) <= 20


# ------------------------------------------------------------ slot step

def _jax_state(fusion, jc):
    jm = _jax_model(fusion)
    return jsteps.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, _params(fusion)),
        tx=jsteps.make_optimizer(jc.train, 1))


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("baseline", ["greedy", "scb"])
def test_slot_step_vs_reference(fusion, baseline, corpora, monkeypatch):
    """Two ``cst_rollout="slot"`` steps (3 slots) of the port vs the
    reference's ``_make_slot_step`` with the same keys: rollout stats,
    trim length and phase keys equal, rewards and loss rtol 1e-5,
    parameters at the training tier."""
    pds, jds = corpora
    tc, jc = _cfgs(baseline, cst_rollout="slot", cst_slot_count=3)
    keys = [jax.random.PRNGKey(31), jax.random.PRNGKey(32)]
    feats, masks = _batch()
    jstep = jcst._make_slot_step(
        _jax_model(fusion), jc, jrewards.CiderDRewarder(jds, weighted_refs=True),
        "slot")
    state = _jax_state(fusion, jc)
    jout = []
    for k in keys:
        state, m = jstep(state, _j(feats), _j(masks), None, None, None,
                         jnp.asarray(VID), k, 0.0)
        jout.append((m, dict(jstep.rollout_stats)))

    pm = _port_model(fusion)
    opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
    step = tcst.make_cst_train_step(pm, opt, tc, pds)
    assert step.layout == "slot:slot"
    words = iter([_kd(k) for k in keys])
    monkeypatch.setattr(tcst, "draw_seeds", lambda g, n: [next(words)])
    for (jm, jstats) in jout:
        m = step(_t(feats), _t(masks), None, None, None, torch.from_numpy(VID),
                 torch.Generator(), 0.0)
        assert step.rollout_stats == jstats
        for k in ("reward", "baseline", "advantage"):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert m["rollout_steps_per_row"] == float(jm["rollout_steps_per_row"])
    assert jout[0][0]["reward"] > 0.0
    assert set(step.phase_ms) == set(jstep.phase_ms) == {
        "dispatch_ms", "score_wait_ms", "update_ms", "total_ms"}
    for k, v in state.params["params"].items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("baseline", ["greedy", "scb"])
def test_slot_and_padded_steps_bitwise(baseline, corpora):
    """A padded-layout step and a slot-layout step from the same
    parameters and seed: metrics, rollout tokens and parameters bitwise
    equal (every op of the tick is row-independent)."""
    out = []
    for layout, extra in (("padded", {}),
                          ("slot", {"cst_slot_count": 5,
                                    "cst_slot_block_steps": 2})):
        tc, _ = _cfgs(baseline, cst_rollout=layout, **extra)
        pm = _port_model("meanpool")
        opt = tsteps.make_optimizer(tc.train, 1, dict(pm.named_parameters()))
        step = tcst.make_cst_train_step(pm, opt, tc, corpora[0])
        assert step.layout == f"slot:{layout}"
        feats, masks = _batch()
        ms = [step(_t(feats), _t(masks), None, None, None,
                   torch.from_numpy(VID), torch.Generator().manual_seed(s), 0.0)
              for s in (3, 4)]
        out.append((ms, pm.state_dict(), dict(step.rollout_stats)))
    (a, pa, sa), (b, pb, sb) = out
    for ma, mb in zip(a, b):
        for k in ("reward", "baseline", "advantage"):
            assert ma[k] == mb[k], k
        assert float(ma["loss"]) == float(mb["loss"])
    for k, v in pa.items():
        assert torch.equal(v, pb[k]), k
    assert sa["update_trim_len"] == sb["update_trim_len"]
    assert sa["rollout_ticks"] == L and sb["rollout_slots"] == 5
