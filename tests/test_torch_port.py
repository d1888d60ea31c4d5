"""Port scaffolding: import isolation, the weight bridge, the copied
config, device rules, refusals of unported features, and the model's
encode / step math against the JAX model on the same weights."""

import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jax_config
from cst_captioning_tpu.models.captioner import (
    CaptionModel as JaxModel,
    DecodeState,
)
from cst_captioning_torch import config as port_config
from cst_captioning_torch.device import resolve_device
from cst_captioning_torch.models.captioner import CaptionModel, model_from_config
from cst_captioning_torch.models.weights import (
    load_params,
    params_to_state_dict,
    state_dict_to_params,
)
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

E, H, V, D, F = 16, 16, 40, 24, 5


def _jax_model(**kw):
    return JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                    modalities=("resnet", "c3d"), feature_dims=(D, D + 8),
                    compute_dtype="float32", drop_prob=0.0, **kw)


def _inputs(seed=0, B=3):
    rng = np.random.RandomState(seed)
    feats = {"resnet": rng.randn(B, F, D).astype(np.float32),
             "c3d": rng.randn(B, F, D + 8).astype(np.float32)}
    masks = {m: (rng.rand(B, F) > 0.3).astype(np.float32) for m in feats}
    return feats, masks


@pytest.fixture(scope="module")
def jax_params():
    feats, masks = _inputs()
    p = _jax_model().init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()},
        {k: jnp.asarray(v) for k, v in masks.items()},
        jnp.zeros((3, 2), jnp.int32))
    return jax.tree.map(np.asarray, p)


def _port_model(jax_params):
    m = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                     modalities=("resnet", "c3d"), feature_dims=(D, D + 8),
                     compute_dtype="float32", device="cpu")
    return load_params(m, jax_params)


def test_import_leaves_jax_out():
    code = (
        "import sys, cst_captioning_torch, cst_captioning_torch.cli.serve, "
        "cst_captioning_torch.serving.server, cst_captioning_torch.ops.beam, "
        "cst_captioning_torch.ops.sampler, cst_captioning_torch.models, "
        "cst_captioning_torch.ops.lstm, cst_captioning_torch.cli.train, "
        "cst_captioning_torch.ops.attlstm, cst_captioning_torch.ops.attention, "
        "cst_captioning_torch.ops.rowgemm, cst_captioning_torch.ops.threefry, "
        "cst_captioning_torch.decoding.core, "
        "cst_captioning_torch.decoding.beam, cst_captioning_torch.serving.slots, "
        "cst_captioning_torch.serving.batcher, "
        "cst_captioning_torch.serving.replicas, "
        "cst_captioning_torch.serving.chaos, "
        "cst_captioning_torch.serving.autoscaler, "
        "cst_captioning_torch.decoding.speculative, "
        "cst_captioning_torch.cli.distill_draft, "
        "cst_captioning_torch.observability, "
        "cst_captioning_torch.training.trainer, cst_captioning_torch.metrics, "
        "cst_captioning_torch.training.cst, cst_captioning_torch.training.rewards, "
        "cst_captioning_torch.metrics.reward_worker, cst_captioning_torch.native, "
        "cst_captioning_torch.evaluation, cst_captioning_torch.data, "
        "cst_captioning_torch.data.packed, cst_captioning_torch.cli.test, "
        "cst_captioning_torch.cli.pipeline, "
        "cst_captioning_torch.tools.pack_features, "
        "cst_captioning_torch.tools.import_jax_checkpoint, "
        "cst_captioning_torch.tools.rehearsal, "
        "cst_captioning_torch.tools.overlap_sim, "
        "cst_captioning_torch.tools.rehearsal_seeds, "
        "cst_captioning_torch.serving.artifact, "
        "cst_captioning_torch.cli.build_artifact; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('cst_captioning_tpu') or m == 'fsspec' "
        "or m.startswith('fsspec.')]; print(bad); "
        "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_bridge_round_trip_exact(jax_params):
    sd = params_to_state_dict(jax_params)
    back = state_dict_to_params(sd)
    assert set(back["params"]) == set(jax_params["params"])
    for k, v in jax_params["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)
    model = _port_model(jax_params)
    again = state_dict_to_params(model.state_dict())
    for k, v in jax_params["params"].items():
        np.testing.assert_array_equal(again["params"][k], v)


def test_bridge_rejects_mismatched_names(jax_params):
    bad = {"params": dict(jax_params["params"])}
    bad["params"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        _port_model(bad)


def test_config_copy_matches_reference():
    for name in jax_config.PRESETS:
        assert (port_config.get_preset(name).to_dict()
                == jax_config.get_preset(name).to_dict()), name
    argv = ["--preset", "msrvtt_serve_beam5", "--serving.continuous",
            "false", "--eval.beam_size", "3", "--serving.batch_shapes",
            "[4, 8]"]
    assert (port_config.parse_cli(argv).to_dict()
            == jax_config.parse_cli(argv).to_dict())


def test_encode_and_step_match_jax(jax_params):
    feats, masks = _inputs(seed=1)
    jm = _jax_model()
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    jmk = {k: jnp.asarray(v) for k, v in masks.items()}
    state, cache = jm.apply(jax_params, jf, jmk, method="init_decode")
    tokens = jnp.asarray([1, 7, 12], jnp.int32)
    _, jlogits = jm.apply(jax_params, state, cache, tokens,
                          method="decode_logits")
    pm = _port_model(jax_params)
    pf = {k: torch.from_numpy(v) for k, v in feats.items()}
    pmk = {k: torch.from_numpy(v) for k, v in masks.items()}
    pstate, pcache = pm.init_decode(pf, pmk)
    np.testing.assert_allclose(pcache.ctx_static.numpy(),
                               np.asarray(cache.ctx_static), atol=1e-5)
    _, h_top = pm._step(pstate, pcache, torch.tensor([1, 7, 12]))
    plogits = pm.mask_decode_logits(pm._logits(h_top))
    np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    assert isinstance(state, DecodeState)


def test_fused_gx_static_matches_unfused_gates(jax_params):
    """gx_static + emb@W_x + h@W_h equals the unfused [emb|ctx|h] @ W
    gate sum (the row layout the kernels rely on)."""
    pm = _port_model(jax_params)
    feats, masks = _inputs(seed=2)
    _, cache = pm.init_decode({k: torch.from_numpy(v) for k, v in feats.items()},
                              {k: torch.from_numpy(v) for k, v in masks.items()})
    gx = pm._fused_gx_static(cache)
    tok = torch.tensor([4, 5, 6])
    x = torch.cat([pm.word_embed[tok], cache.ctx_static,
                   torch.zeros(3, H)], dim=-1)
    want = x @ pm.lstm0_w + pm.lstm0_b
    got = gx + pm.word_embed[tok] @ pm.lstm0_w[:E]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_init_distributions():
    m = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                     feature_dims=(D,), compute_dtype="float32", device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    assert float(m.word_embed.abs().max()) <= 0.1
    assert float(m.lstm0_w.abs().max()) <= 1.0 / H ** 0.5
    b = m.lstm0_b
    assert torch.all(b[H:2 * H] == 1.0) and torch.all(b[:H] == 0.0)
    assert float(m.proj_resnet_w.abs().max()) <= (6.0 / (D + E)) ** 0.5
    assert torch.all(m.logit_b == 0.0)


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = port_config.get_preset("synthetic_smoke")
    cfg.serving.continuous = False
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, random_init=True)
    cfg.model.vocab_size = 40
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_from_config(cfg)
    assert model_from_config(cfg, device="cpu").device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    ds, _ = build_dataset(cfg, "train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, ds)
    # The tools refuse before they write anything.
    from cst_captioning_torch.tools import overlap_sim, rehearsal, rehearsal_seeds

    out = os.path.join(str(tmp_path), "rehearsal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rehearsal.main(["--out-dir", out])
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rehearsal_seeds.main(["--out-dir", out])
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overlap_sim.simulate()


@pytest.mark.parametrize("override", [
    {"serving.continuous": True, "serving.dtype": "int8w",
     "serving.model_shards": 2},
    {"serving.chaos": {"seed": 0, "schedule": [
        {"site": "replica_kill", "at": 1}]}, "serving.model_shards": 2},
    {"serving.model_shards": 2},
    {"serving.dtype": "bf16", "serving.autoscale": {"max_replicas": 2},
     "serving.model_shards": 2},
    {"serving.speculative": {"draft_k": 2}, "serving.decode_mode": "greedy",
     "serving.model_shards": 2},
])
def test_unported_features_raise(override):
    """Model sharding is ported (``tests/test_torch_partition.py``) and
    needs its devices: on one device it refuses with the reference's
    message, also beside the serving extensions (``test_serving_
    extensions_are_accepted``), and never falls back to fewer."""
    cfg = port_config.get_preset("synthetic_smoke").replace(
        **{"serving.continuous": False, **override})
    with pytest.raises(ValueError, match="model_shards=2 needs that many "
                                         "devices, have 1"):
        InferenceEngine(cfg, random_init=True, device="cpu")


@pytest.mark.parametrize("override", [
    {"serving.chaos": {"seed": 0, "schedule": [
        {"site": "replica_kill", "at": 1}]}},
    {"serving.dtype": "bf16", "serving.autoscale": {"max_replicas": 2}},
    {"serving.speculative": {"draft_k": 2, "draft_hidden": 8},
     "serving.decode_mode": "greedy"},
])
def test_serving_extensions_are_accepted(override):
    cfg = port_config.get_preset("synthetic_smoke").replace(
        **{"serving.continuous": False, "serving.warmup": False, **override})
    eng = InferenceEngine(cfg, random_init=True, device="cpu",
                          vocab=Vocabulary([f"w{i}" for i in range(36)]))
    assert (eng.draft_params is not None) == (
        "serving.speculative" in override)


def test_own_copies_of_the_stdlib_serving_modules():
    """``serving/chaos.py`` and ``serving/autoscaler.py`` are the port's
    own copies of the reference's stdlib-only modules: no torch, no jax,
    no JAX package, and the reference's public surface."""
    import ast

    from cst_captioning_tpu.serving import autoscaler as jas, chaos as jch
    from cst_captioning_torch.serving import autoscaler as tas, chaos as tch

    for mine, ref in ((tch, jch), (tas, jas)):
        tree = ast.parse(open(mine.__file__).read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert not {m for m in mods if m.split(".")[0] in (
            "torch", "jax", "cst_captioning_tpu", "numpy")}, mods
        public = {k for k in vars(ref) if not k.startswith("_")
                  and getattr(vars(ref)[k], "__module__", None)
                  == ref.__name__}
        assert public <= set(vars(mine)), public - set(vars(mine))


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_stacked_model_serves(fusion, continuous):
    """``model.num_layers = 2`` (refused until stacks were ported): the
    engine builds a two-layer model and captions requests on the ladder
    and the slot loop, whose carry holds both layers."""
    cfg = port_config.get_preset("synthetic_smoke").replace(
        **{"model.num_layers": 2, "model.feature_fusion": fusion,
           "serving.continuous": continuous, "serving.warmup": False})
    eng = InferenceEngine(cfg, random_init=True, device="cpu",
                          vocab=Vocabulary([f"w{i}" for i in range(36)]))
    assert eng.model.num_layers == 2
    rng = np.random.RandomState(0)
    reqs = [eng.prepare({"features": {"resnet": rng.randn(n, 64).astype(
        np.float32)}}) for n in (2, 6, 4)]
    if continuous:
        dec = eng.slot_decoder()
        assert dec._st.core.state.h.shape[0] == 2
        got = {}
        pending = list(range(len(reqs)))
        while pending or dec.occupied:
            n = min(len(pending), len(dec.free), dec.admit_cap)
            adm = [pending.pop(0) for _ in range(n)]
            for i, tokens, _, _ in dec.harvest_many(
                    dec.tick([reqs[i] for i in adm], adm)):
                got[i] = list(tokens)
        assert sorted(got) == [0, 1, 2]
        assert dec.state_bytes() == dec.expected_state_bytes()
    else:
        out = eng.decode_prepared(reqs, store=False)
        assert len(out) == 3
        assert all(len(r.tokens) == cfg.eval.max_decode_len for r in out)


@pytest.mark.parametrize("override", [
    {"train.mesh_shape": {"data": 2, "model": 1}},
    {"train.mesh_shape": {"data": -1, "model": 2}},
    {"train.mesh_shape": {"data": 2, "model": 2}},
    {"train.mesh_shape": {"data": 1, "model": 2}},
])
def test_unported_training_features_raise(override, tmp_path):
    """Meshes are ported (``tests/test_torch_partition.py``); a mesh
    larger than the one device given refuses with the reference's
    message and never shrinks onto it."""
    cfg = port_config.get_preset("synthetic_smoke").replace(**override)
    cfg.train.checkpoint_dir = str(tmp_path)
    ds, _ = build_dataset(port_config.get_preset("synthetic_smoke"), "train")
    with pytest.raises(ValueError, match=r"needs \d devices, have 1|cannot "
                                         "absorb"):
        Trainer(cfg, ds, device="cpu")


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_stacked_model_trains(fusion, tmp_path):
    """``model.num_layers = 2`` (refused until stacks were ported): the
    trainer builds a two-layer model and an XE epoch moves every layer's
    weights."""
    cfg = port_config.get_preset("synthetic_smoke").replace(
        **{"model.num_layers": 2, "model.feature_fusion": fusion,
           "train.max_epochs": 1})
    cfg.train.checkpoint_dir = str(tmp_path)
    ds, _ = build_dataset(port_config.get_preset("synthetic_smoke"), "train")
    tr = Trainer(cfg, ds, device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    hist = tr.fit()
    assert np.isfinite(hist["0"]["train_loss"])
    for k in ("lstm0_w", "lstm1_w", "lstm1_b"):
        assert not torch.equal(tr.model.state_dict()[k], before[k]), k


@pytest.mark.parametrize("override,layout", [
    ({"train.train_mode": "cst", "train.cst_rollout": "slot"}, "slot:slot"),
    ({"train.train_mode": "cst", "train.cst_rollout": "padded"},
     "slot:padded"),
    ({"train.train_mode": "cst", "train.cst_split_layout": "pipeline"},
     "split"),
])
def test_ported_cst_layouts_train(override, layout, tmp_path):
    """The CST layouts refused until the slot rollout was ported: the
    trainer builds their steps."""
    cfg = port_config.get_preset("synthetic_smoke").replace(**override)
    cfg.train.checkpoint_dir = str(tmp_path)
    ds, _ = build_dataset(port_config.get_preset("synthetic_smoke"), "train")
    assert Trainer(cfg, ds, device="cpu")._train_step.layout == layout


def test_unported_data_and_checkpoints_raise(tmp_path, monkeypatch):
    cfg = port_config.get_preset("msrvtt_resnet_c3d_xe")
    cfg.data.vocab_file = os.path.join(str(tmp_path), "vocab.json")
    Vocabulary(["a", "b"]).save(cfg.data.vocab_file)
    # Remote packed stores read through fsspec; without it (the GPU
    # host) a URL raises an ImportError naming it.
    cfg.data.feature_files = {"resnet": "gs://bucket/packed_train",
                              "c3d": str(tmp_path)}
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        build_dataset(cfg, "train")
    orbax_dir = tmp_path / "orbax_best"
    (orbax_dir / "params").mkdir(parents=True)
    smoke = port_config.get_preset("synthetic_smoke")
    smoke.train.checkpoint_dir = str(tmp_path)
    smoke.train.start_from = str(orbax_dir)
    ds, _ = build_dataset(smoke, "train")
    with pytest.raises(NotImplementedError,
                       match="orbax checkpoint .*export_jax_checkpoint.py"
                             ".*import_jax_checkpoint"):
        Trainer(smoke, ds, device="cpu")
    smoke.model.vocab_size = len(ds.vocab)
    smoke.model.num_layers = 2
    model = model_from_config(smoke, device="cpu")
    H2 = smoke.model.rnn_size
    assert model.num_layers == 2
    assert tuple(model.lstm1_w.shape) == (2 * H2, 4 * H2)


def test_checkpoint_and_artifact_raise(tmp_path, monkeypatch, capsys):
    """A port checkpoint serves (its weights loaded exactly, its path in
    the tier-1 tag).  ``--artifact`` boots: ``cli/build_artifact.py``
    publishes the checkpoint, ``cli/serve.py --artifact`` serves it over
    HTTP with the engine's own caption and ``/healthz`` names the
    version; a directory with no artifact raises ``ArtifactError``."""
    import json
    import threading
    import urllib.request

    from cst_captioning_torch.cli import build_artifact as tbuild_cli
    from cst_captioning_torch.cli.serve import main
    from cst_captioning_torch.serving import server as tserver
    from cst_captioning_torch.serving.artifact import ArtifactError
    from cst_captioning_torch.training.checkpoint import save_params

    cfg = port_config.get_preset("synthetic_smoke")
    cfg.serving.continuous = False
    cfg.serving.warmup = False
    vocab = Vocabulary([f"w{i}" for i in range(36)])
    cfg.model.vocab_size = len(vocab)
    model = model_from_config(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(5))
    ck = str(tmp_path / "ckpt" / "best")
    save_params(ck, model)
    eng = InferenceEngine(cfg, checkpoint=ck, vocab=vocab, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(eng.model.state_dict()[k], v), k
    assert f"|{ck}|" in eng.params_tag
    out = eng.decode_prepared([eng.template_prepared()], store=False)
    assert len(out) == 1 and len(out[0].tokens) == cfg.eval.max_decode_len

    vocab_file = str(tmp_path / "vocab.json")
    vocab.save(vocab_file)
    argv = ["--preset", "synthetic_smoke", "--data.vocab_file", vocab_file,
            "--serving.continuous", "false"]
    capsys.readouterr()
    assert tbuild_cli.main(argv + ["--checkpoint", ck, "--out",
                                   str(tmp_path / "art")], device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["rebuilt"] and summary["path"].startswith(
        str(tmp_path / "art"))
    made = []

    class Recording(tserver.CaptionServer):
        def __init__(self, engine, **kw):
            super().__init__(engine, port=0, **kw)
            made.append(self)

    monkeypatch.setattr(tserver, "CaptionServer", Recording)
    rc = []
    t = threading.Thread(target=lambda: rc.append(main(
        ["--artifact", str(tmp_path / "art")], device="cpu")), daemon=True)
    t.start()
    for _ in range(600):
        if made and made[0]._listening:
            break
        threading.Event().wait(0.05)
    srv = made[0]
    payload = {"features": {"resnet": np.ones((3, 64), np.float32).tolist()}}
    req = urllib.request.Request(
        srv.url + "/v1/caption", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
    with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    srv.shutdown()
    t.join(timeout=30)
    assert rc == [0]
    assert health["build"]["artifact_version"] == summary["artifact_version"]
    assert srv.engine.params_tag == eng.params_tag
    want = eng.decode_prepared([eng.prepare(payload)], store=False)[0]
    assert body["tokens"] == want.tokens
    with pytest.raises(ArtifactError, match="no artifact"):
        main(["--artifact", str(tmp_path / "some" / "dir")], device="cpu")


def _config_model(jax_params, use_pallas_sampler):
    """The module's port model built the way the entry points build it,
    from a config carrying ``model.use_pallas_sampler``."""
    cfg = port_config.get_preset("synthetic_smoke")
    cfg.data.feature_modalities = ["resnet", "c3d"]
    cfg.data.feature_dims = {"resnet": D, "c3d": D + 8}
    cfg.model.vocab_size, cfg.model.rnn_size = V, H
    cfg.model.input_encoding_size = E
    cfg.model.compute_dtype, cfg.model.drop_prob = "float32", 0.0
    cfg.model.use_pallas_sampler = use_pallas_sampler
    return load_params(model_from_config(cfg, device="cpu"), jax_params)


def _spy_sampler(monkeypatch):
    """Record the model's calls of the fused ``lstm_sample`` wrapper."""
    from cst_captioning_torch.models import captioner

    calls = []
    real = captioner.lstm_sample

    def spy(gx, *a, **kw):
        calls.append(gx.shape[0])
        return real(gx, *a, **kw)

    monkeypatch.setattr(captioner, "lstm_sample", spy)
    return calls


@pytest.mark.parametrize("flag,B", [(False, 8), (True, 4)])
def test_multinomial_sample_follows_the_sampler_gate(jax_params, flag, B,
                                                     monkeypatch):
    """Where the reference's sampler gate declines (``use_pallas_sampler``
    off, or B not a positive multiple of 8), ``sample(greedy=False)``
    runs the per-step decode on JAX's threefry stream: the port on the
    key's two ``key_data`` words vs JAX's ``sample(rng=key)`` (its scan
    route), tokens and masks exact, log-probs rtol 1e-5, and the fused
    sampler is not called."""
    L = 6
    feats, masks = _inputs(seed=2, B=B)
    key = jax.random.PRNGKey(7)
    want = _jax_model(use_pallas_sampler=flag).apply(
        jax.tree.map(jnp.asarray, jax_params), {k: jnp.asarray(v) for k, v in feats.items()},
        {k: jnp.asarray(v) for k, v in masks.items()}, rng=key, max_len=L,
        greedy=False, method="sample")
    pm = _config_model(jax_params, flag)
    calls = _spy_sampler(monkeypatch)
    with torch.no_grad():
        cache = pm._encode({k: torch.from_numpy(v) for k, v in feats.items()},
                           {k: torch.from_numpy(v) for k, v in masks.items()})
    words = tuple(int(x) for x in np.asarray(jax.random.key_data(key)))
    got = pm.sample_cache(cache, words, max_len=L, greedy=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=1e-5, atol=1e-6)
    assert calls == []
    # Greedy keeps the fused kernel (deterministic: either route).
    pm.sample_cache(cache, (0, 0), max_len=L, greedy=True)
    assert calls == [B]


def test_multinomial_sample_keeps_the_fused_route_at_b8(jax_params,
                                                        monkeypatch):
    """With the flag on and B = 8 the gate passes: the fused sampler runs
    on the hash-Gumbel stream, token-exact vs the JAX fused sampler in
    interpret mode on the words the reference derives from the key; the
    config flag reaches the model."""
    L = 6
    feats, masks = _inputs(seed=2, B=8)
    key = jax.random.PRNGKey(7)
    want = _jax_model(use_pallas_sampler=True).apply(
        jax_params, {k: jnp.asarray(v) for k, v in feats.items()},
        {k: jnp.asarray(v) for k, v in masks.items()}, rng=key, max_len=L,
        greedy=False, method="sample")
    pm = _config_model(jax_params, True)
    calls = _spy_sampler(monkeypatch)
    words = tuple(int(x) for x in np.asarray(
        jax.random.bits(key, (2,), jnp.uint32)))
    with torch.no_grad():
        cache = pm._encode({k: torch.from_numpy(v) for k, v in feats.items()},
                           {k: torch.from_numpy(v) for k, v in masks.items()})
    got = pm.sample_cache(cache, words, max_len=L, greedy=False)
    assert calls == [8]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for name, flag in (("synthetic_smoke", False), ("msrvtt_cst_ms_scb", True)):
        cfg = port_config.get_preset(name)
        cfg.model.vocab_size = V
        assert cfg.model.use_pallas_sampler is flag
        assert model_from_config(cfg, device="cpu").use_pallas_sampler is flag


def test_kernel_build_is_lazy():
    """Importing the ops never builds or loads a kernel library."""
    from cst_captioning_torch.ops import (
        _build,
        attention,
        attlstm,
        beam,
        lstm,
        rowgemm,
        sampler,
        threefry,
    )

    assert beam._lib is None and sampler._lib is None and lstm._lib is None
    assert threefry._lib is None
    assert attlstm._lib is None
    assert attention._lib is None and attention._bwd_lib is None
    assert rowgemm._lib is None
    assert _build._libs == {}
    assert _build.library_path("lstm_beam").endswith(".so")
    assert set(_build.SOURCES) == {"lstm_beam", "lstm_sample",
                                   "lstm_recurrence", "attlstm_recurrence",
                                   "context_attention",
                                   "context_attention_bwd", "row_gemm",
                                   "threefry_sample"}
