"""``cli/distill_draft.py`` of the port against the JAX package's, on the
CPU: the teacher's greedy stream token-exact on the bridged weights (the
spread init of ``test_torch_slots``, so captions end at varied steps),
one ``_make_update`` step (teacher-forced XE through ``draft_logits``
plus Adam) equal to the JAX step on the same teacher batch (loss, teacher
match and every updated leaf, f32 rtol 1e-5), over two steps so the
moments and the bias correction are both exercised, with and without
``decode_suppress_unk``; and the CLI end to end: its one JSON line, its
``.npz`` loadable by both packages, and the refusal without weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cst_captioning_tpu.cli import distill_draft as jdd
from cst_captioning_tpu.config import get_preset as jax_preset
from cst_captioning_tpu.decoding import speculative as jspec
from cst_captioning_tpu.serving.engine import InferenceEngine as JaxEngine
from cst_captioning_torch.cli import distill_draft as tdd
from cst_captioning_torch.config import get_preset
from cst_captioning_torch.data.vocab import Vocabulary
from cst_captioning_torch.decoding import speculative as tspec
from cst_captioning_torch.serving.engine import InferenceEngine

from test_torch_slots import _spread

HIDDEN = 8
BATCH = 6
MAX_LEN = 8


def _cfg(get, fusion, suppress=False):
    c = get("synthetic_smoke")
    c.model.feature_fusion = fusion
    c.model.decode_suppress_unk = suppress
    c.serving.decode_mode = "greedy"
    c.serving.warmup = False
    c.serving.continuous = False
    return c


def _engines(fusion, suppress=False):
    jeng = JaxEngine(_cfg(jax_preset, fusion, suppress), random_init=True)
    _spread(jeng, "greedy")
    params = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    peng = InferenceEngine(_cfg(get_preset, fusion, suppress), params=params,
                           device="cpu",
                           vocab=Vocabulary(jeng.vocab.idx_to_word[4:]))
    return jeng, peng


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_teacher_stream_is_token_exact(fusion):
    jeng, peng = _engines(fusion)
    want = np.asarray(jdd._teacher_batch(jeng, np.random.default_rng(3),
                                         BATCH, MAX_LEN))
    got = tdd._teacher_batch(peng, np.random.default_rng(3), BATCH, MAX_LEN)
    assert got.shape == (BATCH, MAX_LEN + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    # Some row ends (PAD after its EOS: the dead-row feed ran), the rest
    # run varied words to the length cap.
    assert (want == 0).any() and len(np.unique(want)) > 5


@pytest.mark.parametrize("fusion,suppress", [("meanpool", False),
                                             ("attention", True)])
def test_update_step_equals_jax(fusion, suppress):
    jeng, peng = _engines(fusion, suppress)
    rng = np.random.default_rng(5)
    seqs = np.asarray(jdd._teacher_batch(jeng, rng, BATCH, MAX_LEN))
    dp0 = jspec.make_draft_params(jeng.params, HIDDEN)
    lr = 1e-2
    opt = optax.adam(lr)
    jdp = {k: jnp.asarray(v) for k, v in dp0.items()}
    jstate = opt.init(jdp)
    jupdate = jdd._make_update(opt, suppress)
    tdp = tspec.draft_to_device(dp0, "cpu")
    for v in tdp.values():
        v.requires_grad_(True)
    tupdate = tdd._make_update(tdd.adam(tdp, lr), suppress)
    for step in range(2):
        batch = seqs if step == 0 else seqs[::-1].copy()
        jdp, jstate, jloss, jagree = jupdate(jdp, jstate, jnp.asarray(batch))
        tloss, tagree = tupdate(torch.from_numpy(batch).long())
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert float(tagree) == pytest.approx(float(jagree), abs=1e-6)
        for k in tspec.DRAFT_LEAVES:
            np.testing.assert_allclose(tdp[k].detach().numpy(),
                                       np.asarray(jdp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {step}")
    moved = max(float(np.abs(tdp[k].detach().numpy() - dp0[k]).max())
                for k in tspec.DRAFT_LEAVES)
    assert moved > 1e-3


def test_cli_writes_its_json_line_and_npz(tmp_path, capsys):
    out = str(tmp_path / "draft.npz")
    vocab = str(tmp_path / "vocab.json")
    Vocabulary([f"w{i}" for i in range(40)]).save(vocab)
    rc = tdd.main(["--preset", "synthetic_smoke", "--random-init",
                   "--data.vocab_file", vocab,
                   "--serving.decode_mode", "greedy", "--out", out,
                   "--draft-hidden", str(HIDDEN), "--steps", "3", "--batch",
                   "4", "--max-len", "6", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"out", "steps", "draft_hidden", "final_loss",
                         "teacher_match_first", "teacher_match_final"}
    assert line["out"] == out and line["steps"] == 3
    assert line["draft_hidden"] == HIDDEN
    assert np.isfinite(line["final_loss"])
    for v in ("teacher_match_first", "teacher_match_final"):
        assert 0.0 <= line[v] <= 1.0
    for load in (tspec.load_draft_params, jspec.load_draft_params):
        dp = load(out)
        assert dp["draft_cell_w"].shape == (2 * HIDDEN, 4 * HIDDEN)
    assert tdd.main(["--preset", "synthetic_smoke", "--out", out]) == 2


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    out = str(tmp_path / "draft.npz")
    vocab = str(tmp_path / "vocab.json")
    Vocabulary([f"w{i}" for i in range(40)]).save(vocab)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdd.main(["--preset", "synthetic_smoke", "--random-init",
                  "--data.vocab_file", vocab, "--out", out])
    assert not (tmp_path / "draft.npz").exists()
