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
        "cst_captioning_torch.ops.rowgemm, cst_captioning_torch.decoding.core, "
        "cst_captioning_torch.decoding.beam, cst_captioning_torch.serving.slots, "
        "cst_captioning_torch.serving.batcher, "
        "cst_captioning_torch.training.trainer, cst_captioning_torch.metrics, "
        "cst_captioning_torch.training.cst, cst_captioning_torch.training.rewards, "
        "cst_captioning_torch.metrics.reward_worker, cst_captioning_torch.native, "
        "cst_captioning_torch.evaluation, cst_captioning_torch.data; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('cst_captioning_tpu')]; print(bad); "
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


def test_entry_points_raise_without_cuda():
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


@pytest.mark.parametrize("override", [
    {"serving.continuous": True, "serving.dtype": "int8w",
     "serving.model_shards": 2},
    {"serving.replicas": 2},
    {"serving.model_shards": 2},
    {"serving.dtype": "bf16", "serving.replicas": 2},
    {"serving.speculative": {"draft_k": 2}},
    {"model.feature_fusion": "attention", "model.num_layers": 2},
    {"model.num_layers": 2},
    {"model.use_category": True},
])
def test_unported_features_raise(override):
    cfg = port_config.get_preset("synthetic_smoke").replace(
        **{"serving.continuous": False, **override})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(cfg, random_init=True, device="cpu")


@pytest.mark.parametrize("override", [
    {"train.train_mode": "cst", "train.cst_rollout": "slot"},
    {"train.mesh_shape": {"data": 2, "model": 1}},
    {"train.mesh_shape": {"data": -1, "model": 2}},
    {"train.tensorboard_dir": "tb"},
    {"train.profile_dir": "prof"},
    {"train.trace_file": "trace.json"},
    {"train.train_mode": "cst", "train.cst_rollout": "padded"},
    {"train.train_mode": "cst", "train.cst_split_layout": "pipeline"},
])
def test_unported_training_features_raise(override, tmp_path):
    cfg = port_config.get_preset("synthetic_smoke").replace(**override)
    cfg.train.checkpoint_dir = str(tmp_path)
    ds, _ = build_dataset(port_config.get_preset("synthetic_smoke"), "train")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, ds, device="cpu")


def test_unported_data_and_checkpoints_raise(tmp_path):
    cfg = port_config.get_preset("msrvtt_resnet_c3d_xe")
    cfg.data.vocab_file = os.path.join(str(tmp_path), "vocab.json")
    Vocabulary(["a", "b"]).save(cfg.data.vocab_file)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_dataset(cfg, "train")
    orbax_dir = tmp_path / "orbax_best"
    (orbax_dir / "params").mkdir(parents=True)
    smoke = port_config.get_preset("synthetic_smoke")
    smoke.train.checkpoint_dir = str(tmp_path)
    smoke.train.start_from = str(orbax_dir)
    ds, _ = build_dataset(smoke, "train")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(smoke, ds, device="cpu")
    smoke.model.vocab_size = len(ds.vocab)
    smoke.model.num_layers = 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_from_config(smoke, device="cpu")


def test_checkpoint_and_artifact_raise():
    cfg = port_config.get_preset("synthetic_smoke")
    cfg.serving.continuous = False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(cfg, checkpoint="ckpt/best", device="cpu")
    from cst_captioning_torch.cli.serve import main

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--artifact", "some/dir"])


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
    )

    assert beam._lib is None and sampler._lib is None and lstm._lib is None
    assert attlstm._lib is None
    assert attention._lib is None and attention._bwd_lib is None
    assert rowgemm._lib is None
    assert _build._libs == {}
    assert _build.library_path("lstm_beam").endswith(".so")
    assert set(_build.SOURCES) == {"lstm_beam", "lstm_sample",
                                   "lstm_recurrence", "attlstm_recurrence",
                                   "context_attention",
                                   "context_attention_bwd", "row_gemm"}
