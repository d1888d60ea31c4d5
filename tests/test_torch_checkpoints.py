"""Trained checkpoints into the port: a JAX-trained orbax checkpoint
through ``scripts/export_jax_checkpoint.py`` and
``cst_captioning_torch.tools.import_jax_checkpoint`` into the port's
engine, ``cli/serve.py --checkpoint``, ``cli/test.py`` and a warm start
of its trainer; the params-only layout and the refusals.

A ``synthetic_smoke`` JAX model (meanpool and attention) trains two XE
steps at a learning rate of 0.05 (so its weights leave the init and its
captions differ) and is saved by the JAX package's ``save_checkpoint``
(orbax).  The JAX engine restores that directory itself; the port's
engine serves the import.  Tolerances, stated where held:

* f32 serving: the port's captions and tokens equal the JAX engine's
  token for token, on the ladder (beam and greedy) and in the
  continuous slot loop; ``cli/test``'s files equal the JAX
  ``evaluate_dataset``'s byte for byte (scores included);
* the import: every array exactly the orbax tree's;
* int8w from a quantized orbax save: codes and scales exactly the JAX
  quantizer's, tokens exactly those of the float import quantized at
  the port's boot, and the JAX int8w engine's within the relaxed-serving
  tier (bf16 compute on both sides).
"""

import functools
import importlib.util
import json
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
from cst_captioning_tpu.analysis.jit_registry import RELAXED_SERVING_MATCH_FLOOR
from cst_captioning_tpu.data import build as jbuild
from cst_captioning_tpu.data import loader as jloader
from cst_captioning_tpu.evaluation import evaluate_dataset as jax_evaluate
from cst_captioning_tpu.models.captioner import (
    model_from_config as jax_model_from_config,
)
from cst_captioning_tpu.ops import quant as jquant
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_tpu.training import checkpoint as jckpt
from cst_captioning_tpu.training import steps as jsteps
from cst_captioning_torch import config as tcfg
from cst_captioning_torch.cli import serve as tserve
from cst_captioning_torch.cli import test as tcli_test
from cst_captioning_torch.data import build as tbuild
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.serving import server as tserver
from cst_captioning_torch.serving.engine import InferenceEngine
from cst_captioning_torch.tools import import_jax_checkpoint as importer
from cst_captioning_torch.training import checkpoint as tckpt
from cst_captioning_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSIONS = ("meanpool", "attention")
N_REQ = 10


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint",
        os.path.join(REPO, "scripts", "export_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _overrides(fusion):
    return ["--preset", "synthetic_smoke", "--model.feature_fusion", fusion,
            "--eval.beam_size", "3", "--eval.max_decode_len", "8",
            "--eval.metrics", json.dumps(["Bleu_4", "CIDEr"])]


def _cfg(mod, fusion, mode="beam", continuous=False, dtype="f32"):
    c = mod.parse_cli(_overrides(fusion))
    sv = c.serving
    sv.continuous, sv.warmup, sv.decode_mode, sv.dtype = (
        continuous, False, mode, dtype)
    sv.num_slots, sv.slot_bank_min = 4, 2
    return c


@functools.lru_cache(maxsize=None)
def _world(fusion, root):
    """Train two JAX XE steps, save them (orbax), export and import.
    Returns the paths, the trained tree and the vocabularies."""
    jc = _cfg(jcfg, fusion)
    jc.train.learning_rate = 0.05
    ds, jvocab = jbuild.build_dataset(jc, "train")
    jc.model.vocab_size = len(jvocab)
    it = jloader.BatchIterator(ds, batch_size=jc.data.batch_size,
                               seq_per_img=jc.data.seq_per_img,
                               max_frames=jc.data.max_frames, seed=1)
    batches = iter(it.epoch(0))
    first = next(batches)
    jm = jax_model_from_config(jc)
    state = jsteps.create_train_state(jax.random.PRNGKey(0), jm,
                                      jsteps.make_optimizer(jc.train, 2),
                                      first._asdict())
    step = jsteps.make_xe_train_step(jm)
    for i, b in enumerate((first, next(batches))):
        state, _ = step(state, b.feats, b.feat_masks, b.captions, b.weights,
                        None, b.video_idx, jax.random.PRNGKey(i), 0.0)
    base = os.path.join(root, fusion)
    orbax = os.path.join(base, "orbax_best")
    jckpt.save_checkpoint(orbax, state, {"epoch": 1})
    trained = jax.tree.map(np.array, state.params)
    export = os.path.join(base, "export")
    assert _exporter().main(["--checkpoint", orbax, "--out", export]
                            + _overrides(fusion)) == 0
    port = os.path.join(base, "port")
    assert importer.main(["--export", export, "--out", port]
                         + _overrides(fusion)) == 0
    vocab_file = os.path.join(base, "vocab.json")
    pvocab = Vocabulary(jvocab.idx_to_word[4:])
    pvocab.save(vocab_file)
    return types.SimpleNamespace(orbax=orbax, export=export, port=port,
                                 trained=trained, jvocab=jvocab,
                                 vocab=pvocab, vocab_file=vocab_file,
                                 state=state)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpts"))


def _payloads(seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"resnet": (rng.randn(int(rng.randint(1, 9)), 64)
                                     * 2.0).astype(np.float32).tolist()}}
            for _ in range(N_REQ)]


def _ladder(eng):
    reqs = [eng.prepare(p) for p in _payloads()]
    out = []
    for i in range(0, len(reqs), eng.max_batch):
        out += eng.decode_prepared(reqs[i:i + eng.max_batch], store=False)
    return [(r.caption, list(r.tokens)) for r in out]


def _slots(eng):
    dec = eng.slot_decoder()
    reqs = [eng.prepare(p) for p in _payloads()]
    got, pending = {}, list(range(len(reqs)))
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(2, len(pending), len(dec.free), dec.admit_cap)
        adm = [pending.pop(0) for _ in range(n)]
        for i, tokens, _, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = [int(t) for t in tokens]
    return [got[i] for i in range(len(reqs))]


# ------------------------------------------------------ the round trip

@pytest.mark.parametrize("fusion", FUSIONS)
def test_import_is_the_orbax_tree_exactly(fusion, root):
    w = _world(fusion, root)
    sd = tckpt.load_params_file(w.port)
    assert set(sd) == set(w.trained["params"])
    for k, v in w.trained["params"].items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert not os.path.exists(os.path.join(w.port, tckpt.OPT_FILE))
    infos = tckpt.load_infos(w.port)
    assert infos["epoch"] == 1 and infos["quantized"] is False
    assert infos["imported_from"] == os.path.abspath(w.export)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_served_ladder_token_exact_vs_jax_engine(fusion, mode, root):
    """The port's engine on the import and the JAX engine on the orbax
    directory, f32 ladder: the same captions and tokens."""
    w = _world(fusion, root)
    jeng = JaxEngine(_cfg(jcfg, fusion, mode), checkpoint=w.orbax,
                     vocab=w.jvocab)
    peng = InferenceEngine(_cfg(tcfg, fusion, mode), checkpoint=w.port,
                           vocab=w.vocab, device="cpu")
    want, got = _ladder(jeng), _ladder(peng)
    assert got == [(c, [int(t) for t in toks]) for c, toks in want]
    assert len({c for c, _ in got}) > 1
    assert f"|{w.port}|" in peng.params_tag


@pytest.mark.parametrize("fusion", FUSIONS)
def test_served_continuous_token_exact_vs_jax_engine(fusion, root):
    w = _world(fusion, root)
    jeng = JaxEngine(_cfg(jcfg, fusion, "beam", True), checkpoint=w.orbax,
                     vocab=w.jvocab)
    peng = InferenceEngine(_cfg(tcfg, fusion, "beam", True),
                           checkpoint=w.port, vocab=w.vocab, device="cpu")
    want = [[int(t) for t in toks] for toks in _slots(jeng)]
    assert _slots(peng) == want


@pytest.mark.parametrize("fusion", FUSIONS)
def test_cli_test_scores_equal_the_jax_eval(fusion, root, tmp_path, capsys):
    """``cli/test.py --checkpoint`` on the import: the JAX eval of the
    trained tree's files (predictions and scores) byte for byte."""
    w = _world(fusion, root)
    jc = _cfg(jcfg, fusion)
    jds, _ = jbuild.build_dataset(jc, "test")
    jc.model.vocab_size = len(w.jvocab)
    jax_evaluate(jax_model_from_config(jc), w.trained, jds, jc,
                 out_dir=str(tmp_path / "jax"))
    out = str(tmp_path / "port")
    assert tcli_test.main(["--checkpoint", w.port, "--eval.out_dir", out]
                          + _overrides(fusion), device="cpu") == 0
    assert "CIDEr" in capsys.readouterr().out
    for name in ("predictions.json", "scores.json"):
        with open(tmp_path / "jax" / name) as f, \
                open(os.path.join(out, name)) as g:
            assert g.read() == f.read(), name


def test_cli_serve_checkpoint_serves(root, monkeypatch):
    """``cli/serve.py --checkpoint`` boots the engine on the import and
    answers over HTTP with the engine's own caption."""
    w = _world("meanpool", root)
    made = []

    class Recording(tserver.CaptionServer):
        def __init__(self, engine, **kw):
            super().__init__(engine, port=0, **kw)
            made.append(self)

    monkeypatch.setattr(tserver, "CaptionServer", Recording)
    argv = ["--checkpoint", w.port, "--data.vocab_file", w.vocab_file,
            "--serving.continuous", "false", "--serving.warmup", "false",
            ] + _overrides("meanpool")
    rc = []
    t = threading.Thread(target=lambda: rc.append(
        tserve.main(argv, device="cpu")), daemon=True)
    t.start()
    for _ in range(600):
        if made and made[0]._listening:
            break
        threading.Event().wait(0.05)
    srv = made[0]
    payload = _payloads()[3]
    req = urllib.request.Request(
        srv.url + "/v1/caption", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
    srv.shutdown()
    t.join(timeout=30)
    assert rc == [0]
    eng = srv.engine
    want = eng.decode_prepared([eng.prepare(payload)], store=False)[0]
    assert body["caption"] == want.caption and body["tokens"] == want.tokens
    assert srv.engine.params_tag.split("|")[1] == w.port


def test_int8w_from_a_quantized_orbax_save(root, tmp_path):
    """A quantized tree saved by orbax exports as int8 codes, imports as
    a quantized params-only checkpoint, and serves at int8w with the
    JAX quantizer's codes and scales, the tokens of the float import
    quantized at boot, and the JAX int8w engine's captions within the
    relaxed-serving tier."""
    w = _world("meanpool", root)
    q = jquant.quantize_params(jax.tree.map(jnp.asarray, w.trained))
    orbax = str(tmp_path / "orbax_q")
    jckpt.save_checkpoint(orbax, types.SimpleNamespace(
        params=q, opt_state=w.state.opt_state, step=2))
    over = _overrides("meanpool") + ["--serving.dtype", "int8w"]
    export = str(tmp_path / "export_q")
    assert _exporter().main(["--checkpoint", orbax, "--out", export]
                            + over) == 0
    with np.load(os.path.join(export, "params.npz")) as z:
        assert z["lstm0_w"].dtype == np.int8 and "lstm0_w_scale" in z.files
    port = str(tmp_path / "port_q")
    assert importer.main(["--export", export, "--out", port] + over) == 0
    assert tckpt.load_infos(port)["quantized"] is True
    qeng = InferenceEngine(_cfg(tcfg, "meanpool", dtype="int8w"),
                           checkpoint=port, vocab=w.vocab, device="cpu")
    beng = InferenceEngine(_cfg(tcfg, "meanpool", dtype="int8w"),
                           checkpoint=w.port, vocab=w.vocab, device="cpu")
    qn = jax.tree.map(np.asarray, q)["params"]
    for k, v in qeng.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), qn[k], err_msg=k)
        assert torch.equal(v, beng.model.state_dict()[k]), k
    got = _ladder(qeng)
    assert got == _ladder(beng)
    jeng = JaxEngine(_cfg(jcfg, "meanpool", dtype="int8w"), checkpoint=orbax,
                     vocab=w.jvocab)
    want = _ladder(jeng)
    match = np.mean([g[1] == [int(t) for t in x[1]]
                     for g, x in zip(got, want)])
    assert match >= RELAXED_SERVING_MATCH_FLOOR
    # A quantized save is refused by a float engine (strict names).
    with pytest.raises(KeyError, match="unexpected .*_scale"):
        InferenceEngine(_cfg(tcfg, "meanpool"), checkpoint=port,
                        vocab=w.vocab, device="cpu")


# ------------------------------------------------ warm start, refusals

@pytest.mark.parametrize("fusion", FUSIONS)
def test_trainer_warm_starts_from_the_import(fusion, root, tmp_path):
    """``train.start_from`` an imported checkpoint: the trainer starts
    from its weights with a fresh optimizer (count 0) and trains."""
    w = _world(fusion, root)
    tc = _cfg(tcfg, fusion)
    tc.train.start_from = w.port
    tc.train.max_epochs = 1
    tc.train.checkpoint_dir = str(tmp_path)
    ds, _ = tbuild.build_dataset(tc, "train")
    tr = Trainer(tc, ds, device="cpu")
    for k, v in w.trained["params"].items():
        np.testing.assert_array_equal(tr.model.state_dict()[k].numpy(), v,
                                      err_msg=k)
    assert tr.optimizer.count == 0
    hist = tr.fit()
    assert np.isfinite(hist["0"]["train_loss"])


def test_params_only_checkpoints_resume_refusal(tmp_path):
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = 30
    m = model_from_config(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    ck = str(tmp_path / "p")
    os.makedirs(ck)
    open(os.path.join(ck, tckpt.OPT_FILE), "w").close()  # a stale opt.pt
    tckpt.save_params(ck, m, {"note": "params only"})
    assert sorted(os.listdir(ck)) == [tckpt.INFOS_FILE, tckpt.PARAMS_FILE]
    m2 = model_from_config(cfg, device="cpu")
    tckpt.restore_params(ck, m2)
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v)
    with pytest.raises(ValueError, match="holds no optimizer state"):
        tckpt.restore_checkpoint(ck, m2, None)
    with pytest.raises(FileNotFoundError, match="params.pt"):
        tckpt.restore_params(str(tmp_path), m2)


def test_orbax_directory_refused_with_the_conversion_commands(root):
    w = _world("meanpool", root)
    match = (r"orbax checkpoint .*python scripts/export_jax_checkpoint.py "
             r".*python -m cst_captioning_torch.tools.import_jax_checkpoint")
    cfg = _cfg(tcfg, "meanpool")
    with pytest.raises(NotImplementedError, match=match):
        InferenceEngine(cfg, checkpoint=w.orbax, vocab=w.vocab, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        tserve.main(["--checkpoint", w.orbax, "--data.vocab_file",
                     w.vocab_file] + _overrides("meanpool"), device="cpu")
    cfg.model.vocab_size = len(w.vocab)
    with pytest.raises(NotImplementedError, match=match):
        tckpt.restore_params(w.orbax, model_from_config(cfg, device="cpu"))


def test_importer_holds_the_export_against_the_config(root, tmp_path):
    """A configuration other than the checkpoint's fails the strict load
    before anything is written."""
    w = _world("meanpool", root)
    out = str(tmp_path / "wrong")
    with pytest.raises(ValueError, match="shape"):
        importer.main(["--export", w.export, "--out", out,
                       "--model.rnn_size", "48"] + _overrides("meanpool"))
    with pytest.raises(KeyError, match="att_wf"):
        importer.main(["--export", w.export, "--out", out]
                      + _overrides("attention"))
    assert not os.path.exists(out)
