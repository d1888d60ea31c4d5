"""``tools/rehearsal_seeds.py``: the rehearsal over several training
seeds on one corpus, with the plain beam's decode of each best
checkpoint beside the pipeline's (CPU, tiny sizes)."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from cst_captioning_torch.tools import rehearsal_seeds

TINY = ["--corpus", "branch-trap", "--videos", "20", "--batch-size", "8",
        "--max-frames", "4", "--max-words", "8", "--beam-size", "2",
        "--cst-samples", "2", "--feature-dims", "resnet=8,c3d=8"]


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rehearsal_seeds.main(argv, device="cpu")
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("route", ["h5", "memory"])
def test_two_seeds_with_the_plain_beam(tmp_path, monkeypatch, route):
    if route == "memory":
        monkeypatch.setitem(sys.modules, "h5py", None)
    out = str(tmp_path / "s")
    rc, got = _main(["--out-dir", out, "--train-seeds", "3,4",
                     "--mle-epochs", "1", "--cst-epochs", "2",
                     "--plain-beam"] + TINY)
    assert rc == 0
    assert [r["seed"] for r in got["rows"]] == [3, 4]
    for row in got["rows"]:
        assert len(row["xe_val_per_epoch"]) == len(row["wxe_val_per_epoch"]) == 1
        assert len(row["cst_val_per_epoch"]) == 2
        assert row["cst_val"] == pytest.approx(
            max(row["cst_val_per_epoch"]), abs=5e-5)
        assert 0 <= row["cst_best_epoch"] < 2
        # On the CPU both decodes are the plain beam's: the same captions.
        n = row["test_captions"]
        assert n > 0
        for st in ("wxe", "cst"):
            assert row[f"{st}_plain_same_captions"] == n
            assert row[f"{st}_plain_test_cider"] == row[f"{st}_test_cider"]
            assert np.isfinite(row[f"{st}_test_bleu4"])
        # Each seed has its own checkpoints and eval.
        for run in (f"s{row['seed']}", f"s{row['seed']}c"):
            assert os.path.exists(os.path.join(
                out, "checkpoints", run, "eval", "predictions.json"))
    # One corpus, built by the first seed.
    assert os.path.exists(os.path.join(out, "prep", "manifest.json"))
    assert got["mean"]["cst_val"] == pytest.approx(
        np.mean([r["cst_val"] for r in got["rows"]]))
    assert "xe_val_per_epoch" not in got["mean"]


def test_table_mean_and_sd():
    rows = [{"seed": 1, "a": 1.0, "n": 3, "l": [1]},
            {"seed": 2, "a": 3.0, "n": 5, "l": [2]}]
    t = rehearsal_seeds.table(rows)
    assert t["rows"] == rows
    assert t["mean"] == {"a": 2.0, "n": 4.0}
    # ddof 1, as the reference's multi-seed table.
    assert t["sd"]["a"] == pytest.approx(np.sqrt(2.0))
    assert rehearsal_seeds.table(rows[:1])["sd"] == {"a": 0.0, "n": 0.0}


def test_stage_history_reads_val_and_reward(tmp_path):
    run = tmp_path / "checkpoints" / "r_cst"
    run.mkdir(parents=True)
    hist = {"1": {"val": {"CIDEr": 0.5}, "reward": 2.0},
            "0": {"val": {"CIDEr": 0.25}, "reward": 1.0},
            "10": {"val": {"CIDEr": 0.75}}}
    (run / "history.json").write_text(json.dumps(hist))
    got = rehearsal_seeds.stage_history(str(tmp_path), "r_cst")
    assert got == {"val": [0.25, 0.5, 0.75], "reward": [1.0, 2.0]}
