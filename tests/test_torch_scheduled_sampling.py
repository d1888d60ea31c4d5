"""Scheduled-sampling training in the port: the model's per-step
teacher-forced loop (the reference ``CaptionModel.__call__``'s scan
branch) against the JAX model on the same numpy-seeded weights and
inputs, in both fusions; the fed-sample draws; ``remat``; the schedule;
and the ``Trainer`` over epochs that switch from the fused recurrence to
the per-step loop.

The JAX model runs at float32 with ``use_pallas_attention`` on, so its
context goes through the Pallas kernel and its custom VJP in interpret
mode (caption rows are multiples of 8; other counts take the dense
fallback, whose gradient differs).  The random streams of the two
frameworks cannot match, so the sampled feedback is held either where it
is certain (``ss_prob`` a tensor holding 0: never fed; ``ss_prob = 1``
with a +1e3 bias on one token's logit: every draw is that token) or at
the distribution level (the fed share within 5 binomial sigmas).
Tolerances: logits and every parameter gradient within 1e-5 x their
max |value| (float32, sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models.captioner import CaptionModel as JaxModel
from cst_captioning_tpu.training import trainer as jtrainer
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.constants import BOS_ID, PAD_ID
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.ops import attention as tat
from cst_captioning_torch.training import trainer as ttrainer

E, H, A, V, D1, D2, FR = 16, 16, 24, 40, 24, 32, 5
FUSIONS = ("meanpool", "attention")


def _kw(fusion):
    return dict(vocab_size=V, rnn_size=H, embed_size=E,
                modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                fusion=fusion, att_hidden_size=A, compute_dtype="float32")


def _feats(B, seed):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(B, FR, D1).astype(np.float32),
             "c3d": rng.randn(B, FR, D2).astype(np.float32)}
    masks = {m: (rng.rand(B, FR) > 0.3).astype(np.float32) for m in feats}
    for m in masks:
        masks[m][:, 0] = 1.0
    masks["resnet"][1, 2:] = 0.0
    return feats, masks


def _ids(R, T, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, V, (R, T)).astype(np.int32)
    ids[:, 0] = BOS_ID
    return ids


@pytest.fixture(scope="module", params=FUSIONS)
def models(request):
    """(fusion, JAX model, its numpy params, the port model on them)."""
    fusion = request.param
    feats, masks = _feats(8, 0)
    jm = JaxModel(**_kw(fusion), drop_prob=0.0, use_pallas_attention=True)
    p = jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()},
                {k: jnp.asarray(v) for k, v in masks.items()},
                jnp.zeros((8, 2), jnp.int32))
    params = jax.tree.map(np.asarray, p)
    pm = load_params(CaptionModel(**_kw(fusion), device="cpu"), params)
    return fusion, jm, params, pm


def _close_rel(got, want, what, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _jax_logits_and_grads(jm, params, feats, masks, ids, ct, ss_prob, repeat):
    j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731

    def f(p):
        logits = jm.apply(p, j(feats), j(masks), jnp.asarray(ids),
                          ss_prob=ss_prob, rng=jax.random.PRNGKey(3),
                          repeat=repeat)
        return jnp.sum(logits * ct), logits

    (_, logits), grads = jax.value_and_grad(f, has_aux=True)(params)
    return np.asarray(logits), jax.tree.map(np.asarray, grads["params"])


def _port_logits_and_grads(pm, feats, masks, ids, ct, ss_prob, repeat,
                           generator=None):
    pm.zero_grad()
    t = lambda x: {k: torch.from_numpy(v) for k, v in x.items()}  # noqa: E731
    logits = pm(t(feats), t(masks), torch.from_numpy(ids).long(),
                ss_prob=ss_prob, repeat=repeat, generator=generator)
    (logits * torch.from_numpy(ct)).sum().backward()
    return (logits.detach().numpy(),
            {k: p.grad.numpy().copy() for k, p in pm.named_parameters()})


@pytest.mark.parametrize("B,repeat,T", [(4, 2, 6), (8, 1, 5), (4, 4, 4)])
def test_per_step_path_matches_jax_at_tensor_zero(models, B, repeat, T):
    """A tensor ``ss_prob`` of 0 takes the per-step loop on both sides
    (never fed a sample): logits and all gradients within 1e-5 x max."""
    fusion, jm, params, pm = models
    feats, masks = _feats(B, B + T)
    ids = _ids(B * repeat, T, seed=T)
    ct = np.random.RandomState(1).randn(B * repeat, T, V).astype(np.float32)
    jl, jg = _jax_logits_and_grads(jm, params, feats, masks, ids, ct,
                                   jnp.asarray(0.0, jnp.float32), repeat)
    pl, pg = _port_logits_and_grads(pm, feats, masks, ids, ct,
                                    torch.tensor(0.0), repeat)
    _close_rel(pl, jl, "logits")
    assert set(pg) == set(jg)
    for k in jg:
        _close_rel(pg[k], jg[k], k)


@pytest.mark.parametrize("forced", [7, PAD_ID])
def test_forced_feedback_matches_jax(models, forced):
    """``ss_prob = 1`` with a +1e3 bias on one token's logit: every
    draw, on both sides, is that token, so every step past the first is
    fed it (PAD too: the draws come from the unmasked logits, not the
    decode policy's).  Logits (the forced column at rtol 1e-6, the
    others within 1e-5 x their max) and all gradients within 1e-5 x
    max."""
    fusion, jm, params, _ = models
    params = jax.tree.map(np.copy, params)
    params["params"]["logit_b"][forced] += 1e3
    pm = load_params(CaptionModel(**_kw(fusion), device="cpu"), params)
    B, repeat, T = 4, 2, 6
    feats, masks = _feats(B, 11)
    ids = _ids(B * repeat, T, seed=12)
    ct = np.random.RandomState(2).randn(B * repeat, T, V).astype(np.float32)
    jl, jg = _jax_logits_and_grads(jm, params, feats, masks, ids, ct, 1.0,
                                   repeat)
    fed = []
    step = pm._step

    def recording_step(state, cache, tokens, *a):
        fed.append(tokens.clone())
        return step(state, cache, tokens, *a)

    pm._step = recording_step
    pl, pg = _port_logits_and_grads(pm, feats, masks, ids, ct, 1.0, repeat,
                                    torch.Generator().manual_seed(5))
    assert (fed[0] == BOS_ID).all()
    assert all((x == forced).all() for x in fed[1:])
    others = np.arange(V) != forced
    _close_rel(pl[..., others], jl[..., others], "logits")
    np.testing.assert_allclose(pl[..., forced], jl[..., forced], rtol=1e-6)
    for k in jg:
        _close_rel(pg[k], jg[k], k)


def test_feed_share_and_bos(models):
    """At ``ss_prob = 0.3``: step 0 feeds BOS, step t > 0 feeds the
    sample exactly where the draw says so, and the fed share lies within
    5 binomial sigmas of 0.3."""
    fusion, _, _, pm = models
    B, repeat, T, p = 16, 4, 9, 0.3
    feats, masks = _feats(B, 21)
    ids = torch.from_numpy(_ids(B * repeat, T, seed=22)).long()
    fed, draws = [], []
    step, feed_mask = pm._step, pm._feed_mask

    def recording_step(state, cache, tokens, *a):
        fed.append(tokens.clone())
        return step(state, cache, tokens, *a)

    def recording_mask(*a):
        m = feed_mask(*a)
        draws.append(m.clone())
        return m

    pm._step, pm._feed_mask = recording_step, recording_mask
    t = lambda x: {k: torch.from_numpy(v) for k, v in x.items()}  # noqa: E731
    try:
        pm(t(feats), t(masks), ids, ss_prob=p, repeat=repeat,
           generator=torch.Generator().manual_seed(0))
    finally:
        del pm._step, pm._feed_mask
    assert len(fed) == T and len(draws) == T - 1
    assert (fed[0] == BOS_ID).all()
    for tt in range(1, T):
        keep = ~draws[tt - 1]
        assert torch.equal(fed[tt][keep], ids[keep, tt])
    n = draws[0].numel() * len(draws)
    share = float(torch.stack(draws).float().mean())
    assert abs(share - p) <= 5 * (p * (1 - p) / n) ** 0.5, share


@pytest.mark.parametrize("repeat", [1, 3])
def test_per_step_path_equals_fused_path(models, repeat):
    """Scheduled sampling off, the per-step loop (``ss_prob`` a tensor 0)
    and the fused recurrence (``ss_prob`` 0.0) are one function summed in
    another order: logits and gradients within 1e-5 x max (float32)."""
    _, _, _, pm = models
    B, T = 4, 7
    feats, masks = _feats(B, 31)
    ids = _ids(B * repeat, T, seed=32)
    ct = np.random.RandomState(3).randn(B * repeat, T, V).astype(np.float32)
    fl, fg = _port_logits_and_grads(pm, feats, masks, ids, ct, 0.0, repeat)
    sl, sg = _port_logits_and_grads(pm, feats, masks, ids, ct,
                                    torch.tensor(0.0), repeat)
    _close_rel(sl, fl, "logits")
    for k in fg:
        _close_rel(sg[k], fg[k], k)


def test_attention_per_step_path_runs_the_context_function(models):
    """Under attention fusion each step's context goes through the
    ``ContextAttention`` Function (forward and backward), with the
    attention tensors per video: ``rep`` = the captions per video."""
    fusion, _, _, pm = models
    calls = []
    apply = tat.ContextAttention.apply

    def recording_apply(*args):
        calls.append((args[0].shape[0], args[1].shape[0], args[5]))
        return apply(*args)

    tat.ContextAttention.apply = recording_apply
    try:
        feats, masks = _feats(4, 41)
        t = lambda x: {k: torch.from_numpy(v) for k, v in x.items()}  # noqa: E731
        pm(t(feats), t(masks), torch.from_numpy(_ids(12, 5, 42)).long(),
           ss_prob=torch.tensor(0.5), repeat=3).sum().backward()
    finally:
        tat.ContextAttention.apply = apply
    assert calls == ([(12, 4, 3)] * 5 if fusion == "attention" else [])


def test_remat_gradients_equal(models):
    """``remat`` recomputes each step in the backward; the draws stay
    outside, so the recompute feeds the same tokens: logits and
    gradients bitwise those without remat."""
    _, _, _, pm = models
    B, repeat, T = 4, 2, 6
    feats, masks = _feats(B, 51)
    ids = _ids(B * repeat, T, seed=52)
    ct = np.random.RandomState(4).randn(B * repeat, T, V).astype(np.float32)
    out = []
    for remat in (False, True):
        pm.remat = remat
        try:
            out.append(_port_logits_and_grads(
                pm, feats, masks, ids, ct, 0.5, repeat,
                torch.Generator().manual_seed(9)))
        finally:
            pm.remat = False
    (l0, g0), (l1, g1) = out
    np.testing.assert_array_equal(l1, l0)
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def test_schedule_matches_reference():
    cfg = tcfg.get_preset("synthetic_smoke").model
    for start in (-1, 0, 2):
        for every in (1, 3):
            for inc, cap in ((0.05, 0.25), (0.25, 0.6)):
                cfg.scheduled_sampling_start = start
                cfg.scheduled_sampling_increase_every = every
                cfg.scheduled_sampling_increase_prob = inc
                cfg.scheduled_sampling_max_prob = cap
                for epoch in range(13):
                    got = ttrainer.scheduled_sampling_prob(cfg, epoch)
                    assert isinstance(got, float)
                    assert got == jtrainer.scheduled_sampling_prob(cfg, epoch)


@pytest.mark.parametrize("fusion,remat", [("meanpool", False),
                                          ("attention", False),
                                          ("attention", True)])
def test_trainer_trains_with_scheduled_sampling(tmp_path, fusion, remat):
    """Two epochs on ``synthetic_smoke`` with the schedule starting at
    epoch 0 (+0.25 per epoch): epoch 0 (``ss_prob`` 0) trains through
    the fused path, epoch 1 (0.25) through the per-step loop; finite
    losses, checkpoints written, ``history`` carrying ``ss_prob``."""
    cfg = tcfg.get_preset("synthetic_smoke").replace(**{
        "model.feature_fusion": fusion,
        "model.scheduled_sampling_start": 0,
        "model.scheduled_sampling_increase_every": 1,
        "model.scheduled_sampling_increase_prob": 0.25,
        "train.remat": remat,
        "train.max_epochs": 2})
    cfg.train.checkpoint_dir = str(tmp_path)
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    t = ttrainer.Trainer(cfg, tr, va, device="cpu")
    assert t.model.remat == remat
    per_step = []
    inner = t.model._per_step_forward

    def counting(cache, input_ids, ss_prob, *a):
        per_step.append(ss_prob)
        return inner(cache, input_ids, ss_prob, *a)

    t.model._per_step_forward = counting
    hist = t.fit()
    steps = t.train_iter.num_batches()
    assert [hist[e]["ss_prob"] for e in ("0", "1")] == [0.0, 0.25]
    assert per_step == [0.25] * steps
    for e in hist.values():
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["grad_norm"])
    for d in ("best", "last"):
        assert os.path.exists(os.path.join(t.workdir, d, "params.pt"))
