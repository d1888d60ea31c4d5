"""Port parity for the XE/WXE training slice: the teacher-forced model,
the losses, the optimizer, one train step, the LR schedule and the batch
iterator against the JAX package on the same numpy-seeded inputs, plus
the port's own ``Trainer`` (fit, checkpoints, resume) on the CPU.

JAX runs without a mesh (``make_xe_train_step`` / ``create_train_state``
directly, never the JAX ``Trainer``), with ``use_pallas_lstm`` on so
its recurrence runs the Pallas kernel in interpret mode (R >= 8 rows).
Tolerances are stated beside each check.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.models.captioner import (
    CaptionModel as JaxModel,
    model_from_config as jax_model_from_config,
)
from cst_captioning_tpu.ops import losses as jlosses
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.models.captioner import CaptionModel, model_from_config
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.ops import losses as tlosses
from cst_captioning_torch.training import steps as tsteps
from cst_captioning_torch.training.trainer import Trainer

E, H, V, D1, D2, F = 16, 16, 40, 24, 32, 5


def _feats(B, seed):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(B, F, D1).astype(np.float32),
             "c3d": rng.randn(B, F, D2).astype(np.float32)}
    masks = {m: (rng.rand(B, F) > 0.3).astype(np.float32) for m in feats}
    for m in masks:
        masks[m][:, 0] = 1.0
    return feats, masks


def _ids(R, T, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, V, (R, T)).astype(np.int32)
    ids[:, 0] = 1
    return ids


def _jax_tree(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _torch_tree(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("B,repeat,T", [(3, 3, 7), (4, 2, 5), (8, 1, 6)])
def test_teacher_forced_logits_match_jax(B, repeat, T):
    """Fused meanpool forward with ``repeat`` caption rows per video:
    rtol 1e-4 / atol 1e-5 at f32 (the reference's own fused-path tier,
    tests/test_pallas_lstm.py)."""
    feats, masks = _feats(B, seed=B)
    ids = _ids(B * repeat, T, seed=T)
    jm = JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                  modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                  compute_dtype="float32", drop_prob=0.0, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0), _jax_tree(feats),
                     _jax_tree(masks), jnp.asarray(ids[:B]))
    want = jm.apply(params, _jax_tree(feats), _jax_tree(masks),
                    jnp.asarray(ids), repeat=repeat)
    pm = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                      modalities=("resnet", "c3d"), feature_dims=(D1, D2),
                      compute_dtype="float32", device="cpu")
    load_params(pm, jax.tree.map(np.asarray, params))
    got = pm(_torch_tree(feats), _torch_tree(masks),
             torch.from_numpy(ids).long(), repeat=repeat)
    assert got.shape == (B * repeat, T, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_output_dropout_is_seeded_and_scaled():
    pm = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                      feature_dims=(D1,), compute_dtype="float32",
                      drop_prob=0.5, device="cpu")
    h = torch.ones(4, 3, H)
    a = pm._output_dropout(h, torch.Generator().manual_seed(1))
    b = pm._output_dropout(h, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
    assert torch.equal(pm._output_dropout(h, None), h)


# --------------------------------------------------------------- losses

def _loss_inputs(seed=0, B=6, T=5, Vs=11):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, Vs) * 2).astype(np.float32)
    targets = rng.randint(0, Vs, (B, T)).astype(np.int32)
    mask = (rng.rand(B, T) > 0.3).astype(np.float32)
    w = rng.rand(B).astype(np.float32)
    return logits, targets, mask, w


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_cross_entropy_matches(smoothing):
    lg, tg, mk, _ = _loss_inputs(1)
    want = jlosses.masked_cross_entropy(jnp.asarray(lg), jnp.asarray(tg),
                                        jnp.asarray(mk),
                                        label_smoothing=smoothing)
    got = tlosses.masked_cross_entropy(torch.from_numpy(lg),
                                       torch.from_numpy(tg),
                                       torch.from_numpy(mk),
                                       label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_weighted_cross_entropy_matches():
    lg, tg, mk, w = _loss_inputs(2)
    want = jlosses.weighted_cross_entropy(jnp.asarray(lg), jnp.asarray(tg),
                                          jnp.asarray(mk), jnp.asarray(w))
    got = tlosses.weighted_cross_entropy(torch.from_numpy(lg),
                                         torch.from_numpy(tg),
                                         torch.from_numpy(mk),
                                         torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_reward_criterion_matches_and_stops_gradient():
    rng = np.random.RandomState(3)
    lp = -rng.rand(5, 7).astype(np.float32)
    mk = (rng.rand(5, 7) > 0.2).astype(np.float32)
    adv = rng.randn(5).astype(np.float32)
    want = jlosses.reward_criterion(jnp.asarray(lp), jnp.asarray(mk),
                                    jnp.asarray(adv))
    tadv = torch.from_numpy(adv).requires_grad_()
    got = tlosses.reward_criterion(torch.from_numpy(lp),
                                   torch.from_numpy(mk), tadv)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert not got.requires_grad


# ------------------------------------------------------------ optimizer

def _train_cfgs(**kw):
    j, t = jcfg.TrainConfig(), tcfg.TrainConfig()
    for k, v in kw.items():
        setattr(j, k, v)
        setattr(t, k, v)
    return j, t


OPTIMIZER_CASES = {
    "adam_clip": dict(optimizer="adam", grad_clip=1.0, learning_rate=1e-2),
    "adamw": dict(optimizer="adam", weight_decay=0.1, learning_rate=1e-2),
    "sgd": dict(optimizer="sgd", grad_clip=0.0, learning_rate=0.1),
    "rmsprop": dict(optimizer="rmsprop", learning_rate=1e-2),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax_chain(case):
    """5 updates with the LR decaying every 2 steps: params rtol 1e-5 /
    atol 1e-7 (float32 bias corrections and powers rounded in another
    order)."""
    jc, tc = _train_cfgs(lr_decay=0.5, lr_decay_every=1,
                         **OPTIMIZER_CASES[case])
    rng = np.random.RandomState(7)
    init = {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    tx = jsteps.make_optimizer(jc, 2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = tsteps.make_optimizer(tc, 2, tp)
    clipped = 0
    for step in range(5):
        g = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
             for k, v in init.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        clipped += float(optax.global_norm(jg)) >= tc.grad_clip > 0
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case} step {step} {k}")
    assert opt.count == 5
    if case == "adam_clip":
        assert clipped == 5


def test_optimizer_state_round_trip():
    _, tc = _train_cfgs(optimizer="adam")
    p = {"w": torch.ones(3)}
    opt = tsteps.make_optimizer(tc, 1, p)
    opt.step({"w": torch.full((3,), 0.5)})
    q = {"w": p["w"].clone()}
    other = tsteps.make_optimizer(tc, 1, q)
    other.load_state_dict(copy.deepcopy(opt.state_dict()))
    opt.step({"w": torch.full((3,), -0.25)})
    other.step({"w": torch.full((3,), -0.25)})
    assert other.count == opt.count == 2
    assert torch.equal(p["w"], q["w"])


@pytest.mark.parametrize("decay,every,steps_per_epoch", [
    (0.5, 3, 4), (0.8, 1, 1), (0.5, 0, 4), (1.0, 2, 3)])
def test_lr_schedule_matches(decay, every, steps_per_epoch):
    """rtol 1e-5: the reference takes the power in float32, the port in
    float64 (then rounds once to float32 in the update)."""
    jc, tc = _train_cfgs(learning_rate=2e-4, lr_decay=decay,
                         lr_decay_every=every)
    js = jsteps.make_lr_schedule(jc, steps_per_epoch)
    ts = tsteps.make_lr_schedule(tc, steps_per_epoch)
    for step in range(0, 40, 3):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=1e-5)


# ------------------------------------------------------------ data

def _both_datasets(split="train", **over):
    jc = jcfg.get_preset("synthetic_smoke").replace(**over)
    tc = tcfg.get_preset("synthetic_smoke").replace(**over)
    jds, jv = jbuild.build_dataset(jc, split)
    tds, tv = tbuild.build_dataset(tc, split)
    return jds, tds


def test_synthetic_corpus_matches():
    jds, tds = _both_datasets("val")
    assert len(jds) == len(tds)
    assert jds.vocab.idx_to_word == tds.vocab.idx_to_word
    for i in range(len(jds)):
        assert jds.video_id(i) == tds.video_id(i)
        assert jds.references(i) == tds.references(i)
        np.testing.assert_array_equal(jds.captions(i), tds.captions(i))
        for m, a in jds.features(i).items():
            np.testing.assert_array_equal(a, tds.features(i)[m])


@pytest.mark.parametrize("shuffle,drop_last,batch_size,spi", [
    (True, True, 8, 3), (True, False, 5, 4), (False, False, 6, 2)])
def test_batch_iterator_matches(shuffle, drop_last, batch_size, spi):
    jds, tds = _both_datasets()
    kw = dict(batch_size=batch_size, seq_per_img=spi, max_frames=4,
              shuffle=shuffle, drop_last=drop_last, seed=213)
    ji = jloader.BatchIterator(jds, **kw)
    ti = tloader.BatchIterator(tds, **kw)
    assert ji.num_batches() == ti.num_batches()
    for epoch in (0, 1):
        jb = list(ji.epoch(epoch))
        tb = list(ti.epoch(epoch))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            for field in ("captions", "weights", "category", "video_idx"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            for m in a.feats:
                np.testing.assert_array_equal(a.feats[m], b.feats[m])
                np.testing.assert_array_equal(a.feat_masks[m],
                                              b.feat_masks[m])
            assert a.video_ids == b.video_ids


def test_prefetch_to_device_reraises_and_joins():
    _, tds = _both_datasets()
    it = tloader.BatchIterator(tds, batch_size=4, seq_per_img=2,
                               max_frames=3)

    def batches():
        yield from it.epoch(0)
        raise RuntimeError("boom")

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in tloader.prefetch_to_device(batches(), "cpu"):
            got.append(b)
            assert isinstance(b.captions, torch.Tensor)
    assert len(got) == it.num_batches()


def test_consensus_weights_loader(tmp_path):
    _, tds = _both_datasets()
    n = sum(tds.captions(i).shape[0] for i in range(len(tds)))
    flat = np.arange(n, dtype=np.float32)
    p = str(tmp_path / "w.npy")
    np.save(p, flat)
    w = tbuild.load_consensus_weights(p, tds)
    np.testing.assert_array_equal(w[tds.video_id(1)],
                                  flat[tds.captions(0).shape[0]:][:tds.captions(1).shape[0]])
    with open(tmp_path / "w.json", "w") as f:
        json.dump({tds.video_id(0): [1.0]}, f)
    with pytest.raises(ValueError, match="weights but"):
        tbuild.load_consensus_weights(str(tmp_path / "w.json"), tds)


# ------------------------------------------------------------ train step

def test_xe_step_matches_jax_step():
    """One XE step from bridged params on ``synthetic_smoke`` (f32,
    drop_prob 0): loss rtol 1e-5; params after the Adam update rtol 2e-5
    / atol 1e-5 (the r12 tier of docs/PARITY.md)."""
    jc = jcfg.get_preset("synthetic_smoke")
    jc.model.use_pallas_lstm = True
    tc = tcfg.get_preset("synthetic_smoke")
    jds, vocab = jbuild.build_dataset(jc, "train")
    tds, _ = tbuild.build_dataset(tc, "train")
    jc.model.vocab_size = tc.model.vocab_size = len(vocab)
    kw = dict(batch_size=jc.data.batch_size, seq_per_img=jc.data.seq_per_img,
              max_frames=jc.data.max_frames, seed=5)
    jb = next(iter(jloader.BatchIterator(jds, **kw).epoch(0)))
    tb = next(iter(tloader.BatchIterator(tds, **kw).epoch(0)))

    jm = jax_model_from_config(jc)
    tx = jsteps.make_optimizer(jc.train, 4)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), jm, tx,
                                      jb._asdict())
    init_params = jax.tree.map(np.array, state.params)  # the step donates
    step = jsteps.make_xe_train_step(jm)
    new_state, metrics = step(state, jb.feats, jb.feat_masks, jb.captions,
                              jb.weights, None, jb.video_idx,
                              jax.random.PRNGKey(1), 0.0)

    tm = model_from_config(tc, device="cpu")
    load_params(tm, init_params)
    opt = tsteps.make_optimizer(tc.train, 4, dict(tm.named_parameters()))
    tstep = tsteps.make_xe_train_step(tm, opt)
    tb = tloader.to_device(tb, torch.device("cpu"))
    out = tstep(tb.feats, tb.feat_masks, tb.captions, tb.weights, None,
                tb.video_idx, None, 0.0)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    for k, v in new_state.params["params"].items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), np.asarray(v),
                                   rtol=2e-5, atol=1e-5, err_msg=k)


def test_decode_weights_follow_optimizer_updates():
    """The decode kernels' cached compute-dtype weights see in-place
    optimizer updates (validation never decodes stale weights)."""
    tc = tcfg.get_preset("synthetic_smoke")
    tc.model.vocab_size = 40
    tm = model_from_config(tc, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    before = [w.clone() for w in tm._kernel_weights()]
    opt = tsteps.make_optimizer(tc.train, 1, dict(tm.named_parameters()))
    opt.step({k: torch.ones_like(p) for k, p in tm.named_parameters()})
    after = tm._kernel_weights()
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert torch.equal(after[3], tm.logit_w)


# --------------------------------------------------------------- trainer

def _fit(tmp_path, name, max_epochs, resume=False, drop_prob=0.3):
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = max_epochs
    cfg.train.resume = resume
    cfg.model.drop_prob = drop_prob
    cfg.name = name
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    t = Trainer(cfg, tr, va, device="cpu")
    return t, t.fit()


def test_trainer_fit_writes_history_and_checkpoints(tmp_path):
    t, hist = _fit(tmp_path, "fit", 3)
    assert sorted(hist) == ["0", "1", "2"]
    for e in hist.values():
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["grad_norm"])
        assert "CIDEr" in e["val"] and e["steps_per_sec"] > 0
    with open(os.path.join(t.workdir, "history.json")) as f:
        assert json.load(f) == json.loads(json.dumps(hist))
    for d in ("best", "last"):
        assert sorted(os.listdir(os.path.join(t.workdir, d))) == [
            "infos.json", "opt.pt", "params.pt"]
    assert t.optimizer.count == 3 * t.train_iter.num_batches()


def test_trainer_resume_equals_uninterrupted(tmp_path):
    full, hist_full = _fit(tmp_path, "full", 3)
    _fit(tmp_path, "split", 2)
    resumed, hist = _fit(tmp_path, "split", 3, resume=True)
    assert resumed.start_epoch == 2
    assert sorted(hist) == ["0", "1", "2"]
    assert hist["2"]["train_loss"] == hist_full["2"]["train_loss"]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_warm_start_loads_params(tmp_path):
    first, _ = _fit(tmp_path, "xe", 1)
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.train_mode = "wxe"
    cfg.train.start_from = os.path.join(first.workdir, "last")
    cfg.name = "wxe"
    tr, _ = tbuild.build_dataset(cfg, "train")
    t = Trainer(cfg, tr, None, device="cpu")
    for k, v in first.model.state_dict().items():
        assert torch.equal(t.model.state_dict()[k], v), k
    assert t.optimizer.count == 0


def test_trainer_mid_epoch_preemption_resume(tmp_path, monkeypatch):
    """SIGTERM after one step: ``last`` records steps_done, the resumed
    run skips those batches and ends bit-identical to an uninterrupted
    run (the per-(seed, epoch, step) dropout stream replays)."""
    from cst_captioning_torch.training import preemption

    full, hist_full = _fit(tmp_path, "full", 2)

    class StopAfterOneStep:
        trainer = None

        @property
        def triggered(self):
            t = self.trainer
            return t is not None and t._epoch_steps_done >= 1

    guard = StopAfterOneStep()
    monkeypatch.setattr(preemption.PreemptionGuard, "install",
                        classmethod(lambda cls, *a, **k: guard))
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.train.max_epochs = 2
    cfg.model.drop_prob = 0.3
    cfg.name = "cut"
    tr, vocab = tbuild.build_dataset(cfg, "train")
    va, _ = tbuild.build_dataset(cfg, "val", vocab=vocab)
    cut = Trainer(cfg, tr, va, device="cpu")
    guard.trainer = cut
    cut.fit()
    assert cut.preempted and cut.optimizer.count == 1
    with open(os.path.join(cut.workdir, "last", "infos.json")) as f:
        infos = json.load(f)
    assert infos["steps_done"] == 1 and infos["epoch"] == 0
    monkeypatch.undo()
    resumed, hist = _fit(tmp_path, "cut", 2, resume=True)
    assert resumed.start_epoch == 0 and resumed._resume_skip_steps == 1
    assert resumed.optimizer.count == full.optimizer.count
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
