"""The sharded update step, the checkpoint reshard and model-sharded
serving of the port (``training/sharded.py``, ``training/checkpoint.py``,
``serving/engine.py``'s model-shards block, the (R, M) grid of
``serving/replicas.py``) against the JAX package's
``tests/test_partition.py`` and the port's own single-device paths.

Tiers (docs/PARITY.md r12): the 2D step's loss rtol 1e-5 and its
parameters rtol 2e-5 / atol 1e-5 against JAX's NamedSharding step and
the port's one-device step; a reshard bitwise; a sharded engine's
tokens exact against the replicated engine's (beam scores rtol 1e-4);
the (2, 2) grid token-exact against the offline decode.  The port's
meshes stand on repeated ``cpu`` devices, JAX's on the forced CPU
devices of ``tests/conftest.py``.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from cst_captioning_torch import config as tcfg
from cst_captioning_torch.data import loader as tloader
from cst_captioning_torch.data.build import build_dataset as tbuild_dataset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding.beam import beam_search_from_state
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.parallel import make_mesh
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.serving.replicas import ReplicaSet
from cst_captioning_torch.training import checkpoint as tckpt
from cst_captioning_torch.training import sharded
from cst_captioning_torch.training import steps as tsteps
from cst_captioning_torch.training.trainer import Trainer
from cst_captioning_tpu.config import get_preset as jpreset
from cst_captioning_tpu.data import BatchIterator as JBatchIterator
from cst_captioning_tpu.data import make_synthetic_dataset
from cst_captioning_tpu.models import model_from_config as jmodel_from_config
from cst_captioning_tpu.parallel import batch_sharding, shard_batch
from cst_captioning_tpu.parallel import make_mesh as jmake_mesh
from cst_captioning_tpu.training import steps as jsteps

from test_torch_slots import _drive

CPU = lambda n: ["cpu"] * n  # noqa: E731


# ------------------------------------------------------ the 2D XE step

@pytest.fixture(scope="module")
def jax_steps():
    """JAX's one-device and (2, 4) NamedSharding XE steps from one init
    (the reference's ``TestShardedUpdateStep``), and the batch."""
    cfg = jpreset("synthetic_smoke")
    ds, _ = make_synthetic_dataset(num_videos=16,
                                   max_frames=cfg.data.max_frames, seed=7)
    cfg.model.vocab_size = (len(ds.vocab) + 3) // 4 * 4
    batch = next(iter(JBatchIterator(ds, batch_size=8, seq_per_img=2,
                                     max_frames=cfg.data.max_frames,
                                     shuffle=False).epoch(0)))
    model = jmodel_from_config(cfg)
    tx = jsteps.make_optimizer(cfg.train, 10)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), model, tx,
                                      batch._asdict())
    init = jax.tree.map(np.array, state.params)
    ones = np.ones_like(np.asarray(batch.weights))
    mesh = jmake_mesh({"data": 2, "model": 4})
    s2 = jsteps.create_train_state(jax.random.PRNGKey(0), model, tx,
                                   batch._asdict(), mesh=mesh)
    step2 = jsteps.make_xe_train_step(model, mesh=mesh, state_template=s2)
    sh = batch_sharding(mesh)
    s2b, m2 = step2(s2, shard_batch(batch.feats, mesh),
                    shard_batch(batch.feat_masks, mesh),
                    jax.device_put(batch.captions, sh),
                    jax.device_put(ones, sh), None,
                    jax.device_put(batch.video_idx, sh),
                    jax.random.PRNGKey(1), 0.0)
    want = {k: np.asarray(v) for k, v in s2b.params["params"].items()}
    return cfg.model.vocab_size, batch, init, want, float(m2["loss"])


def _port_batch(batch):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return ({k: t(v) for k, v in batch.feats.items()},
            {k: t(v) for k, v in batch.feat_masks.items()},
            t(batch.captions), torch.ones(np.asarray(batch.weights).shape),
            None, t(batch.video_idx))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_2d_step_matches_jax_and_the_single_device_step(jax_steps, shape):
    V, batch, init, want, want_loss = jax_steps
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = V
    args = _port_batch(batch)
    one = model_from_config(cfg, device="cpu")
    load_params(one, init)
    out1 = tsteps.make_xe_train_step(one, tsteps.make_optimizer(
        cfg.train, 10, dict(one.named_parameters())))(*args, None, 0.0)
    template = model_from_config(cfg, device="cpu")
    load_params(template, init)
    mesh = make_mesh({"data": shape[0], "model": shape[1]},
                     devices=CPU(shape[0] * shape[1]))
    mm = sharded.MeshModel(cfg, mesh, template)
    assert mm.split == (shape[1] > 1)
    opt = sharded.MeshOptimizer(mm, cfg.train, 10)
    out2 = sharded.make_mesh_xe_train_step(mm, opt)(*args, None, 0.0)
    np.testing.assert_allclose(float(out2["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(out2["loss"]), float(out1["loss"]),
                               rtol=1e-5)
    got = mm.gathered_state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=2e-5, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(),
                                   one.state_dict()[k].numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=k)
    if shape[1] > 1:
        # The vocab leaves and their Adam moments are split over model.
        rep = mm.replicas[0]
        assert rep.vshards.leaves["word_embed"][1].shape[0] == V // 2
        assert tuple(opt.mu["word_embed#1"].shape) == (V // 2, 32)
    # Every data shard's replica holds the owners' values.
    for d in range(1, mm.D):
        for (k, a), (_, b) in zip(mm.named_tensors(0), mm.named_tensors(d)):
            assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def jax_wxe_step(jax_steps):
    """JAX's (2, 4) NamedSharding step on :func:`jax_steps`' batch and
    init with non-unit caption weights (the WXE regime): (weights,
    parameters after the step, loss)."""
    V, batch, _, _, _ = jax_steps
    cfg = jpreset("synthetic_smoke")
    cfg.model.vocab_size = V
    model = jmodel_from_config(cfg)
    tx = jsteps.make_optimizer(cfg.train, 10)
    w = np.random.RandomState(3).uniform(
        0.2, 2.0, np.asarray(batch.weights).shape).astype(np.float32)
    mesh = jmake_mesh({"data": 2, "model": 4})
    s2 = jsteps.create_train_state(jax.random.PRNGKey(0), model, tx,
                                   batch._asdict(), mesh=mesh)
    step2 = jsteps.make_xe_train_step(model, mesh=mesh, state_template=s2)
    sh = batch_sharding(mesh)
    s2b, m2 = step2(s2, shard_batch(batch.feats, mesh),
                    shard_batch(batch.feat_masks, mesh),
                    jax.device_put(batch.captions, sh),
                    jax.device_put(w, sh), None,
                    jax.device_put(batch.video_idx, sh),
                    jax.random.PRNGKey(1), 0.0)
    want = {k: np.asarray(v) for k, v in s2b.params["params"].items()}
    return w, want, float(m2["loss"])


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_2d_wxe_step_with_caption_weights(jax_steps, jax_wxe_step, shape):
    """The WXE step (non-unit caption weights, each shard's rows weighted
    by its own slice) on the mesh against JAX's NamedSharding step and
    the port's one-device step: loss rtol 1e-5, parameters rtol 2e-5 /
    atol 1e-5."""
    V, batch, init, _, _ = jax_steps
    w, want, want_loss = jax_wxe_step
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = V
    args = _port_batch(batch)[:3] + (torch.from_numpy(w),) + \
        _port_batch(batch)[4:]
    one = model_from_config(cfg, device="cpu")
    load_params(one, init)
    out1 = tsteps.make_xe_train_step(one, tsteps.make_optimizer(
        cfg.train, 10, dict(one.named_parameters())))(*args, None, 0.0)
    template = model_from_config(cfg, device="cpu")
    load_params(template, init)
    mm = sharded.MeshModel(cfg, make_mesh(
        {"data": shape[0], "model": shape[1]},
        devices=CPU(shape[0] * shape[1])), template)
    out2 = sharded.make_mesh_xe_train_step(
        mm, sharded.MeshOptimizer(mm, cfg.train, 10))(*args, None, 0.0)
    np.testing.assert_allclose(float(out2["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(out2["loss"]), float(out1["loss"]),
                               rtol=1e-5)
    # The weights matter: the unit-weight loss is another number.
    assert abs(float(out1["loss"]) - jax_steps[4]) > 1e-3 * abs(want_loss)
    got = mm.gathered_state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=2e-5, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(),
                                   one.state_dict()[k].numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=k)


def test_2d_steps_on_one_mesh_are_bitwise_equal(jax_steps):
    V, batch, init, _, _ = jax_steps
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = V
    cfg.model.drop_prob = 0.5
    outs = []
    for _ in range(2):
        t = model_from_config(cfg, device="cpu")
        load_params(t, init)
        mm = sharded.MeshModel(cfg, make_mesh({"data": 2, "model": 2},
                                              devices=CPU(4)), t)
        step = sharded.make_mesh_xe_train_step(
            mm, sharded.MeshOptimizer(mm, cfg.train, 10))
        for i in range(2):
            step(*_port_batch(batch), torch.Generator().manual_seed(i), 0.0)
        outs.append(mm.gathered_state_dict())
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# ----------------------------------------------------- reshard / trainer

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 1x1 trainer stepped once and checkpointed (params + Adam)."""
    root = str(tmp_path_factory.mktemp("reshard"))
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.train.checkpoint_dir = root
    ds, vocab = tbuild_dataset(cfg, "train")
    cfg.model.vocab_size = (len(vocab) + 1) // 2 * 2
    tr = Trainer(cfg, ds, device="cpu")
    b = tloader.to_device(next(iter(tr.train_iter.epoch(0))),
                          torch.device("cpu"))
    tr._train_step(b.feats, b.feat_masks, b.captions, b.weights, None,
                   b.video_idx, None, 0.0)
    path = os.path.join(root, "ck")
    tckpt.save_checkpoint(path, tr.model, tr.optimizer, {"epoch": 0})
    return cfg, ds, path, tr.model.state_dict(), tr.optimizer.state_dict()


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_1x1_checkpoint_loads_on_2d_meshes(saved, shape, tmp_path):
    cfg0, ds, path, ref, ref_opt = saved
    cfg = cfg0.replace(**{"train.mesh_shape": {"data": shape[0],
                                               "model": shape[1]}})
    cfg.train.checkpoint_dir = str(tmp_path)
    tr = Trainer(cfg, ds, devices=CPU(shape[0] * shape[1]))
    tckpt.restore_checkpoint(path, tr._ckpt_model, tr.optimizer)
    got = tr.mesh_model.gathered_state_dict()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    opt = tr.optimizer.state_dict()
    for k, v in ref_opt["mu"].items():
        assert torch.equal(opt["mu"][k], v) and torch.equal(
            opt["nu"][k], ref_opt["nu"][k]), k
    # A green next step on the new topology, saved back in the one-device
    # format with the mesh in the sidecar, and loaded on 1x1 bitwise.
    b = tloader.to_device(next(iter(tr.train_iter.epoch(1))),
                          torch.device("cpu"))
    out = tr._train_step(b.feats, b.feat_masks, b.captions, b.weights, None,
                         b.video_idx, None, 0.0)
    assert np.isfinite(float(out["loss"]))
    back = os.path.join(str(tmp_path), "back")
    tckpt.save_checkpoint(back, tr._ckpt_model, tr.optimizer, {})
    meta = tckpt.saved_sharding(back)
    assert meta["mesh_shape"] == f"{shape[0]}x{shape[1]}"
    assert meta["mesh_axes"] == ["data", "model"]
    assert meta["specs"]["word_embed"] == (["model", None] if shape[1] > 1
                                           else [])
    one = model_from_config(cfg0, device="cpu")
    tckpt.restore_params(back, one)
    now = tr.mesh_model.gathered_state_dict()
    for k, v in one.state_dict().items():
        assert torch.equal(v, now[k]), k
    assert tckpt.saved_sharding(path)["mesh_shape"] == "1x1"


def test_batch_not_divisible_by_data_raises(saved, tmp_path):
    cfg0, ds, _, _, _ = saved
    cfg = cfg0.replace(**{"train.mesh_shape": {"data": 3, "model": 1}})
    cfg.train.checkpoint_dir = str(tmp_path)
    with pytest.raises(ValueError, match="not divisible by the data mesh"):
        Trainer(cfg, ds, devices=CPU(3))


def test_msrvtt_xe_2d_trains_on_a_2x2_mesh(tmp_path):
    """The preset's mesh (``{"data": -1, "model": 2}``) over four devices,
    at the smoke widths: one XE epoch and one CST epoch train and
    validate (through the mesh gates)."""
    for mode in ("xe", "cst"):
        cfg = tcfg.get_preset("msrvtt_xe_2d").replace(**{
            "data.dataset": "synthetic", "data.feature_modalities": ["resnet"],
            "data.feature_dims": {"resnet": 16}, "data.batch_size": 4,
            "data.seq_per_img": 2, "data.max_seq_len": 8,
            "data.max_frames": 4, "model.rnn_size": 16,
            "model.input_encoding_size": 16, "model.att_hidden_size": 16,
            "train.max_epochs": 1, "train.train_mode": mode,
            "train.cst_num_samples": 2, "train.cst_baseline": "scb",
            "train.checkpoint_dir": str(tmp_path / mode),
            "eval.max_decode_len": 8})
        ds, vocab = tbuild_dataset(cfg, "train")
        vds, _ = tbuild_dataset(cfg, "val", vocab=vocab)
        cfg.model.vocab_size = (len(vocab) + 1) // 2 * 2
        tr = Trainer(cfg, ds, vds, devices=CPU(4))
        assert tr.mesh.shape == {"data": 2, "model": 2}
        hist = tr.fit()
        assert np.isfinite(hist["0"]["train_loss"]) and "val" in hist["0"]


# ----------------------------------------------------- sharded serving

N = 10
WORDS = [f"w{i}" for i in range(36)]        # V = 40 with the specials


def _scfg(fusion, mode, shards=1, replicas=1, **serving):
    c = tcfg.get_preset("synthetic_smoke")
    c.model.feature_fusion = fusion
    c.model.use_pallas_beam = c.model.use_pallas_sampler = True
    c.eval.beam_size = 3
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode = True, False, mode
    sv.num_slots, sv.model_shards, sv.replicas = 8, shards, replicas
    for k, v in serving.items():
        setattr(sv, k, v)
    return c


_PARAMS = {}


def _params(fusion):
    """Spread random weights (embeddings x10, LSTM x2, head x3) so the
    captions vary."""
    if fusion not in _PARAMS:
        e = InferenceEngine(_scfg(fusion, "beam"), random_init=True,
                            vocab=Vocabulary(WORDS), device="cpu")
        sd = {k: v.clone() for k, v in e.model.state_dict().items()}
        sd["word_embed"] *= 10.0
        sd["lstm0_w"] *= 2.0
        sd["logit_w"] *= 3.0
        sd["logit_b"][2] += 0.8
        _PARAMS[fusion] = sd
    return _PARAMS[fusion]


def _payloads(seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 7)), 64)
                                     * 2.0).astype(np.float32)}}
            for _ in range(N)]


def _serve(eng):
    reqs = [eng.prepare(p) for p in _payloads()]
    slot = _drive(eng.slot_decoder(), reqs, range(N))
    ladder = eng.decode_prepared(reqs[:8], store=False)
    return slot, [r.tokens for r in ladder]


@pytest.mark.parametrize("fusion,mode,dtype,fused", [
    ("meanpool", "beam", "f32", True),
    ("meanpool", "beam", "f32", False),
    ("attention", "beam", "int8w", True),
    ("attention", "greedy", "f32", True),
    ("meanpool", "greedy", "bf16", True),
])
def test_tp_engine_tokens_match_replicated(fusion, mode, dtype, fused):
    one = InferenceEngine(_scfg(fusion, mode, dtype=dtype),
                          params=_params(fusion), vocab=Vocabulary(WORDS),
                          device="cpu")
    tp = InferenceEngine(_scfg(fusion, mode, 2, dtype=dtype,
                               shard_fused_decode=fused),
                         params=_params(fusion), vocab=Vocabulary(WORDS),
                         devices=CPU(2))
    assert tp.model.vshards is not None and tp.model.decode_mesh is not None
    assert tp.fingerprint()["mesh_shape"] == "1x2"
    assert (tp.slot_decoder().tp_topk is not None
            or tp.slot_decoder().tp_pick is not None) == fused
    assert tp.param_bytes_per_shard() < one.param_bytes_per_shard()
    s1, l1 = _serve(one)
    s2, l2 = _serve(tp)
    assert l1 == l2
    for i in range(N):
        np.testing.assert_array_equal(s2[i][0], s1[i][0], err_msg=str(i))
        if mode == "beam":
            np.testing.assert_allclose(s2[i][1], s1[i][1], rtol=1e-4,
                                       atol=1e-6)


def test_tp_engine_refuses_clone_for_device():
    tp = InferenceEngine(_scfg("meanpool", "beam", 2), params=_params(
        "meanpool"), vocab=Vocabulary(WORDS), devices=CPU(2))
    with pytest.raises(ValueError, match="cannot be cloned per-device"):
        tp.clone_for_device("cpu")
    with pytest.raises(ValueError, match="exactly model_shards"):
        tp.clone_for_submesh(CPU(3))
    one = InferenceEngine(_scfg("meanpool", "beam"), params=_params(
        "meanpool"), vocab=Vocabulary(WORDS), device="cpu")
    with pytest.raises(ValueError, match="needs a model-sharded engine"):
        one.clone_for_submesh(CPU(2))


@pytest.mark.parametrize("replicas,n", [(2, 3), (3, 4), (0, 1)])
def test_grid_larger_than_the_devices_raises(replicas, n):
    with pytest.raises(ValueError, match="needs"):
        InferenceEngine(_scfg("meanpool", "beam", 2, replicas),
                        params=_params("meanpool"), vocab=Vocabulary(WORDS),
                        devices=CPU(n))


def test_2x2_grid_serves_token_exact_vs_offline():
    eng = InferenceEngine(_scfg("attention", "beam", 2, 2,
                                default_deadline_ms=120_000.0),
                          params=_params("attention"),
                          vocab=Vocabulary(WORDS), devices=CPU(4))
    reqs = [eng.prepare(p) for p in _payloads()]
    m, ev = eng.model, eng.cfg.eval
    offline = beam_search_from_state(
        m, m.init_state(N), eng.encode_prepared_rows(reqs),
        beam_size=ev.beam_size, max_len=ev.max_decode_len,
        length_normalize=ev.length_normalize).tokens.numpy()
    rs = ReplicaSet.from_engine(eng)
    assert len(rs.replicas) == 2
    assert all(r.engine.fingerprint()["mesh_shape"] == "1x2"
               for r in rs.replicas)
    results, lock = {}, threading.Lock()

    def client(i):
        out = rs.submit(dict(_payloads()[i]))
        with lock:
            results[i] = out

    with rs:
        ths = [threading.Thread(target=client, args=(i,)) for i in range(N)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
    assert sorted(results) == list(range(N))
    for i in range(N):
        np.testing.assert_array_equal(np.asarray(results[i]["tokens"]),
                                      offline[i], err_msg=str(i))
    admitted = [rs.metrics.replica(r.rid).admitted_total.value
                for r in rs.replicas]
    assert sum(admitted) == N


@pytest.mark.parametrize("preset", ["msrvtt_serve_tp2", "msrvtt_serve_r2xtp2",
                                    "msrvtt_serve_int8w_tp2"])
def test_serving_presets_build_and_serve(preset):
    """The three sharded serving presets at the smoke widths on four
    devices: the engine (and the preset's grid) builds and serves."""
    cfg = tcfg.get_preset(preset).replace(**{
        "data.feature_modalities": ["resnet"],
        "data.feature_dims": {"resnet": 64}, "data.max_frames": 6,
        "model.rnn_size": 16, "model.input_encoding_size": 16,
        "model.att_hidden_size": 16, "eval.max_decode_len": 8,
        "serving.warmup": False, "serving.max_batch_size": 8,
        "serving.batch_shapes": [8], "serving.num_slots": 8,
        "serving.slot_bank_min": 0, "serving.flight_dir": "",
        "serving.feature_cache_bytes": 1 << 20})
    eng = InferenceEngine(cfg, params=None, random_init=True,
                          vocab=Vocabulary(WORDS), devices=CPU(4))
    assert eng.fingerprint()["mesh_shape"] == "1x2"
    rs = ReplicaSet.from_engine(eng)
    assert len(rs.replicas) == cfg.serving.replicas
    with rs:
        out = rs.submit(dict(_payloads()[0]))
    assert len(out["tokens"]) == 8
