"""Port parity for stage 4 of the main path: ``cst_captioning_torch``'s
``evaluation.evaluate_dataset`` (beam-5 eval), ``_encode`` on float16
features, ``cli/test.py`` and the staged ``cli/pipeline.py``.

A JAX model at init scale (E = H = A = 16, the synthetic vocabulary,
meanpool and attention fusion) is carried over with
``models/weights.py``; both packages build the same synthetic test split
(16 videos, 2 batches of 8, the last one wrapped).  The JAX eval runs
its scan beam (and, in one case, the fused Pallas beam in interpret
mode); the port's runs on the CPU, where ``lstm_beam`` /
``attlstm_beam`` take their plain versions.  Held exactly:
``predictions.json`` token for token (the files byte for byte) and
``scores.json`` byte for byte (both sides score the same strings with
copies of the same metric code).  The pipeline runs at the size of the
JAX package's ``tests/test_aux.py::TestPipeline``.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu import config as jcfg
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.evaluation import evaluate_dataset as jax_evaluate
from cst_captioning_tpu.models.captioner import (
    model_from_config as jax_model_from_config,
)
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.cli import pipeline as tpipeline
from cst_captioning_torch.cli import test as tcli_test
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.evaluation import evaluate_dataset
from cst_captioning_torch.models import captioner as tcaptioner
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.models.weights import load_params
from cst_captioning_torch.training import checkpoint as tckpt

WIDTH = 16
METRICS = ["Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]


def _cfgs(fusion, **model):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_preset("synthetic_smoke")
        cfg.data.feature_modalities = ["resnet", "c3d"]
        cfg.data.feature_dims = {"resnet": 24, "c3d": 40}
        cfg.model.rnn_size = cfg.model.input_encoding_size = WIDTH
        cfg.model.att_hidden_size = WIDTH
        cfg.model.feature_fusion = fusion
        cfg.eval.metrics = list(METRICS)
        cfg.eval.beam_size = 3
        cfg.eval.max_decode_len = 8
        for k, v in model.items():
            setattr(cfg.model, k, v)
        out.append(cfg)
    return out


def _models(jc, tc):
    """(JAX model, its params, the port's model with those params,
    the two test splits)."""
    jds, jvocab = jbuild.build_dataset(jc, "test")
    tds, tvocab = tbuild.build_dataset(tc, "test")
    assert tvocab.idx_to_word == jvocab.idx_to_word
    jc.model.vocab_size = tc.model.vocab_size = len(tvocab)
    jm = jax_model_from_config(jc)
    F = jc.data.max_frames
    feats = {m: jnp.zeros((1, F, d)) for m, d in jc.data.feature_dims.items()}
    masks = {m: jnp.ones((1, F)) for m in feats}
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


def _cocofmt(ds, path, skip_last: bool):
    """A cocofmt ground-truth file of the split: each video's first two
    references, the last video left out (a subset to score)."""
    n = len(ds) - int(skip_last)
    anns = [{"image_id": ds.video_id(i), "caption": c, "id": 10 * i + k}
            for i in range(n) for k, c in enumerate(ds.references(i)[:2])]
    with open(path, "w") as f:
        json.dump({"images": [{"id": ds.video_id(i)} for i in range(n)],
                   "annotations": anns}, f)


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
@pytest.mark.parametrize("gt", ["references", "cocofmt"])
def test_evaluate_dataset_matches_jax(tmp_path, fusion, gt, caplog):
    jc, tc = _cfgs(fusion)
    jm, params, tm, jds, tds = _models(jc, tc)
    if gt == "cocofmt":
        path = str(tmp_path / "cocofmt_test.json")
        _cocofmt(tds, path, skip_last=True)
        jc.data.cocofmt_files = {"test": path}
        tc.data.cocofmt_files = {"test": path}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jscores, jpreds = jax_evaluate(jm, params, jds, jc, out_dir=jdir)
    with caplog.at_level(logging.INFO, logger="cst_captioning_torch.eval"):
        tscores, tpreds = evaluate_dataset(tm, tds, tc, out_dir=tdir,
                                           device="cpu")
    assert tpreds == jpreds and len(tpreds) == len(tds) == 16
    assert tscores == jscores and set(tscores) >= set(METRICS)
    assert _files(tdir) == _files(jdir)
    name = "attlstm_beam" if fusion == "attention" else "lstm_beam"
    assert f"beam decode backend: {name}_ref" in caplog.text
    if gt == "cocofmt":
        assert "covers 15/16 predicted videos" in caplog.text


def test_evaluate_dataset_matches_jax_fused_beam_interpret(tmp_path):
    """The JAX eval through its fused Pallas beam (interpret mode)."""
    from cst_captioning_tpu.decoding.beam import fused_beam_engaged

    jc, tc = _cfgs("meanpool")
    for c in (jc, tc):
        c.eval.metrics = ["Bleu_4", "CIDEr"]
        c.eval.max_decode_len = 6
    jm, params, tm, jds, tds = _models(jc, tc)
    # model_from_config gates the kernel off the TPU; the JAX package's
    # own kernel tests build the model with it on, as here.
    jm = jm.clone(use_pallas_beam=True)
    probe = {m: np.zeros((jc.data.batch_size, jc.data.max_frames, d),
                         np.float32)
             for m, d in jc.data.feature_dims.items()}
    assert fused_beam_engaged(jm, probe, jc.eval.beam_size) == (True, "")
    js, jp = jax_evaluate(jm, params, jds, jc, out_dir=str(tmp_path / "j"))
    ts, tp = evaluate_dataset(tm, tds, tc, out_dir=str(tmp_path / "t"),
                              device="cpu")
    assert tp == jp and ts == js
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_encode_casts_float16_features_once(fusion, cdt, monkeypatch):
    """``_encode`` on float16 features (a float16 pack's batch): each
    projection's input is bitwise the JAX ``_encode``'s
    (``feats[m].astype(cdt)``): exact widening at float32, one rounding
    at bfloat16; and the whole cache equals the encode of the same
    values handed over as float32."""
    jc, tc = _cfgs(fusion, compute_dtype=cdt)
    jm, params, tm, _, _ = _models(jc, tc)
    rng = np.random.RandomState(3)
    F = jc.data.max_frames
    f16 = {m: (rng.randn(4, F, d) * 3).astype(np.float16)
           for m, d in jc.data.feature_dims.items()}
    masks = {m: np.ones((4, F), np.float32) for m in f16}

    seen_j, seen_t = [], []
    matmul = jnp.matmul

    def spy_matmul(a, b, **kw):
        seen_j.append(np.asarray(a))
        return matmul(a, b, **kw)

    monkeypatch.setattr(jnp, "matmul", spy_matmul)
    jm.apply(params, {m: jnp.asarray(v) for m, v in f16.items()},
             {m: jnp.asarray(v) for m, v in masks.items()},
             method="init_decode")
    monkeypatch.setattr(jnp, "matmul", matmul)
    inner = tcaptioner.row_dot

    def spy_row_dot(x, w, cdt_, scale=None):
        seen_t.append(x)
        return inner(x, w, cdt_, scale)

    monkeypatch.setattr(tcaptioner, "row_dot", spy_row_dot)
    with torch.no_grad():
        cache16 = tm._encode({m: torch.from_numpy(v) for m, v in f16.items()},
                             {m: torch.from_numpy(v) for m, v in masks.items()})
    want_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cdt]
    for i, m in enumerate(f16):
        x, want = seen_t[i], seen_j[i]
        assert x.dtype == want_dt and str(want.dtype) == cdt
        np.testing.assert_array_equal(
            x.float().numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(
            x.float().numpy(),
            torch.from_numpy(f16[m]).to(want_dt).float().numpy())
    with torch.no_grad():
        cache32 = tm._encode(
            {m: torch.from_numpy(v.astype(np.float32)) for m, v in f16.items()},
            {m: torch.from_numpy(v) for m, v in masks.items()})
    for a, b in zip(cache16, cache32):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_evaluate_dataset_refusals():
    _, tc = _cfgs("meanpool")
    tds, vocab = tbuild.build_dataset(tc, "test")
    tc.model.vocab_size = len(vocab)
    tm = model_from_config(tc, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate_dataset(tm, tds, tc)
    # use_category is served: the split's category ids reach the model.
    tc.model.use_category = True
    tds, _ = tbuild.build_dataset(tc, "test")
    tm = model_from_config(tc, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert tm.use_category
    scores, preds = evaluate_dataset(tm, tds, tc, device="cpu")
    assert len(preds) == len(tds) and np.isfinite(scores["CIDEr"])


# ------------------------------------------------------------ cli/test

def _cli_args(tc, ckpt, out_dir):
    return ["--checkpoint", ckpt, "--preset", "synthetic_smoke",
            "--data.feature_modalities", json.dumps(tc.data.feature_modalities),
            "--data.feature_dims", json.dumps(tc.data.feature_dims),
            "--model.rnn_size", str(WIDTH),
            "--model.input_encoding_size", str(WIDTH),
            "--eval.beam_size", "3", "--eval.max_decode_len", "8",
            "--eval.metrics", json.dumps(METRICS), "--eval.out_dir", out_dir]


def test_cli_test_writes_both_files(tmp_path, capsys):
    jc, tc = _cfgs("meanpool")
    jm, params, tm, jds, tds = _models(jc, tc)
    ck = str(tmp_path / "ck" / "best")
    os.makedirs(ck)
    torch.save(tm.state_dict(), os.path.join(ck, tckpt.PARAMS_FILE))
    out = str(tmp_path / "eval_out")
    assert tcli_test.main(_cli_args(tc, ck, out), device="cpu") == 0
    printed = capsys.readouterr().out
    jax_evaluate(jm, params, jds, jc, out_dir=str(tmp_path / "jax"))
    assert _files(out) == _files(str(tmp_path / "jax"))
    with open(os.path.join(out, "scores.json")) as f:
        scores = json.load(f)
    assert f"CIDEr: {scores['CIDEr']:.4f}" in printed


def test_cli_test_refuses_an_orbax_checkpoint(tmp_path):
    _, tc = _cfgs("meanpool")
    orbax = tmp_path / "orbax_best"
    (orbax / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError,
                       match=r"orbax checkpoint .*export_jax_checkpoint.py"
                             r".*import_jax_checkpoint"):
        tcli_test.main(_cli_args(tc, str(orbax), str(tmp_path / "o")),
                       device="cpu")


# ------------------------------------------------------------ pipeline

PIPELINE_ARGS = ["--preset", "synthetic_smoke", "--data.batch_size", "8",
                 "--data.seq_per_img", "2", "--data.max_seq_len", "11",
                 "--train.max_epochs", "1", "--train.max_patience", "0",
                 "--train.cst_num_samples", "2",
                 "--eval.metrics", '["CIDEr"]', "--eval.beam_size", "2",
                 "--eval.max_decode_len", "11"]
STAGES = ["xe", "wxe", "cst_greedy"]


@pytest.fixture
def restores(monkeypatch):
    """Every ``restore_params`` call's checkpoint path, in order (the
    trainer's warm starts and the pipeline's eval)."""
    seen = []
    inner = tckpt.restore_params

    def spy(path, model):
        seen.append(os.path.abspath(path))
        return inner(path, model)

    monkeypatch.setattr(tckpt, "restore_params", spy)
    return seen


def test_pipeline_chains_stages_and_evaluates(tmp_path, restores):
    cfg = tcfg.parse_cli(PIPELINE_ARGS + [
        "--train.checkpoint_dir", str(tmp_path / "ck")])
    results = tpipeline.run_pipeline(cfg, STAGES, eval_split="test",
                                     device="cpu")
    assert set(results) == {*STAGES, "eval"}
    root = str(tmp_path / "ck")
    ck = {}
    for s in STAGES:
        wd = os.path.join(root, f"{cfg.name}_{s}")
        best = os.path.join(wd, "best")
        ck[s] = best if os.path.exists(best) else os.path.join(wd, "last")
        assert os.path.exists(os.path.join(ck[s], tckpt.PARAMS_FILE))
        assert sorted(results[s]) == ["0"]
    # xe starts fresh; each later stage and the eval restore the
    # previous stage's checkpoint.
    assert restores == [ck["xe"], ck["wxe"], ck["cst_greedy"]]
    ev = results["eval"]
    assert ev["split"] == "test" and set(ev["scores"]) == {"CIDEr"}
    assert ev["out_dir"] == os.path.join(root, cfg.name, "eval")

    # The eval is evaluate_dataset run afresh on the final checkpoint.
    ds, vocab = tbuild.build_dataset(cfg, "test")
    cfg.model.vocab_size = len(vocab)
    model = model_from_config(cfg, device="cpu")
    tckpt.restore_params(ck["cst_greedy"], model)
    fresh = str(tmp_path / "fresh")
    scores, _ = evaluate_dataset(model, ds, cfg, out_dir=fresh, device="cpu")
    assert scores == ev["scores"]
    assert _files(fresh) == _files(ev["out_dir"])


def test_pipeline_main_writes_pipeline_json(tmp_path, capsys):
    root = str(tmp_path / "ck")
    rc = tpipeline.main(PIPELINE_ARGS + ["--train.checkpoint_dir", root,
                                         "--stages", "xe,cst"],
                        device="cpu")
    assert rc == 0
    with open(os.path.join(root, "synthetic_smoke", "pipeline.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"xe", "cst", "eval"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == saved["eval"]


def test_pipeline_unknown_stage_raises(tmp_path):
    cfg = tcfg.parse_cli(PIPELINE_ARGS + [
        "--train.checkpoint_dir", str(tmp_path)])
    with pytest.raises(KeyError, match="unknown stage 'xx'"):
        tpipeline.run_pipeline(cfg, ["xe", "xx"], device="cpu")


def test_pipeline_preempted_stage_returns_75(tmp_path, monkeypatch):
    from cst_captioning_torch.training.preemption import PreemptionGuard

    guard = PreemptionGuard()
    guard._event.set()
    monkeypatch.setattr(PreemptionGuard, "install",
                        classmethod(lambda cls, *a, **k: guard))
    root = str(tmp_path / "ck")
    rc = tpipeline.main(PIPELINE_ARGS + ["--train.checkpoint_dir", root],
                        device="cpu")
    assert rc == 75
    with open(os.path.join(root, "synthetic_smoke", "pipeline.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"xe", "preempted"}
    assert saved["preempted"] == {
        "stage": "xe",
        "checkpoint": os.path.join(root, "synthetic_smoke_xe", "last")}
    assert os.path.exists(os.path.join(saved["preempted"]["checkpoint"],
                                       tckpt.PARAMS_FILE))
