"""Port parity for the CST reward scorer: the port's ``CiderDRewarder``,
``RewardPool`` and native C++ scorer against the JAX package's
``training/rewards.py`` and ``native/`` on the same generated corpus
and token rows (as ``tests/test_reward_pool.py`` holds the reference).

Every comparison is bitwise: the same backend on both sides runs the same
arithmetic.  The two backends differ from each other by a float32 ulp
(the C++ scorer keeps reference vectors in float32; the reference holds
them at rtol 1e-5, ``tests/test_native_ciderd.py``), so each is held
against its own twin.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cst_captioning_tpu.data import make_synthetic_dataset as jax_synthetic
from cst_captioning_tpu.training import rewards as jrewards
from cst_captioning_torch import native
from cst_captioning_torch.constants import EOS_ID, PAD_ID
from cst_captioning_torch.data import make_synthetic_dataset
from cst_captioning_torch.metrics.cider import save_df
from cst_captioning_torch.training.rewards import (
    CiderDRewarder,
    RewardPool,
    make_reward_scorer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = dict(num_videos=12, max_frames=6, max_words=10, seed=5)


def _weights(ds):
    rng = np.random.RandomState(3)
    return {ds.video_id(i): rng.uniform(0.2, 2.0, size=len(ds.references(i)))
            .astype(np.float32) for i in range(len(ds))}


@pytest.fixture(scope="module")
def corpora():
    """(port dataset, reference dataset, vocab), the same corpus, each
    with the same per-reference consensus weights set."""
    pds, vocab = make_synthetic_dataset(**CORPUS)
    jds, _ = jax_synthetic(**CORPUS)
    w = _weights(pds)
    pds.set_caption_weights(w)
    jds.set_caption_weights(w)
    return pds, jds, vocab


def make_rows(ds, vocab, n_rows: int, L: int = 9, seed: int = 7):
    """Reference prefixes (non-zero scores), random ids, an all-PAD row
    and an all-EOS row."""
    rng = np.random.RandomState(seed)
    vids = rng.randint(0, len(ds), size=(n_rows,)).astype(np.int32)
    toks = rng.randint(4, len(vocab), size=(n_rows, L)).astype(np.int32)
    for b in range(0, n_rows, 2):
        ids = [vocab.word_to_idx[w]
               for w in ds.references(int(vids[b]))[b % 3].split()][:L - 1]
        toks[b, :] = PAD_ID
        toks[b, :len(ids)] = ids
        toks[b, len(ids)] = EOS_ID
    toks[0, :] = PAD_ID
    toks[1, :] = EOS_ID
    return vids, toks


@pytest.fixture(scope="module")
def serial(corpora):
    return CiderDRewarder(corpora[0], backend="python")


@pytest.fixture(scope="module")
def pool2(serial):
    with RewardPool(serial, 2) as pool:
        yield pool


def test_native_builds_from_the_repo_source():
    """g++ builds the repo's ``ciderd.cpp`` into ``_kernels_build/``,
    named by a digest of source and flags; the source below its header is
    the reference's, line for line."""
    path = native.build_ciderd()
    assert path == native.library_path() and os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(
        REPO, "cst_captioning_torch", "_kernels_build")
    assert native._SRC == os.path.join(REPO, "cst_captioning_torch", "native",
                                       "ciderd.cpp")
    with open(native._SRC) as f:
        mine = f.read()
    with open(os.path.join(REPO, "cst_captioning_tpu", "native",
                           "ciderd.cpp")) as f:
        ref = f.read()
    body = mine[mine.index("#include <algorithm>"):]
    assert body == ref[ref.index("#include <algorithm>"):]
    assert native.build_ciderd() == path  # cached: no second build


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("weighted", [False, True])
def test_scores_bitwise_vs_reference(corpora, backend, weighted):
    """``score_ids`` and ``gt_consensus`` bitwise the reference
    rewarder's on the same backend, weighted refs or not."""
    pds, jds, vocab = corpora
    mine = CiderDRewarder(pds, backend=backend, weighted_refs=weighted)
    ref = jrewards.CiderDRewarder(jds, backend=backend,
                                  weighted_refs=weighted)
    assert mine.backend == ref.backend == backend
    vids, toks = make_rows(pds, vocab, 40)
    got = mine.score_ids(vids, toks)
    assert got.dtype == np.float32 and got.shape == (40,)
    assert got.max() > 0.0
    np.testing.assert_array_equal(got, ref.score_ids(vids, toks))
    np.testing.assert_array_equal(mine.gt_consensus(), ref.gt_consensus())


def test_idf_table_mode_bitwise_vs_reference(corpora, tmp_path):
    """``df_mode`` = a saved idf table, re-keyed to id n-grams."""
    pds, jds, vocab = corpora
    path = str(tmp_path / "df.p")
    save_df({pds.video_id(i): pds.references(i) for i in range(len(pds))},
            path)
    vids, toks = make_rows(pds, vocab, 12, seed=8)
    for backend in ("python", "native"):
        mine = CiderDRewarder(pds, df_mode=path, backend=backend)
        ref = jrewards.CiderDRewarder(jds, df_mode=path, backend=backend)
        np.testing.assert_array_equal(mine.score_ids(vids, toks),
                                      ref.score_ids(vids, toks))


@pytest.mark.parametrize("backend", ["python", "native"])
def test_all_pad_or_eos_rows_score_zero(corpora, backend):
    pds, _, vocab = corpora
    vids, toks = make_rows(pds, vocab, 4)
    got = CiderDRewarder(pds, backend=backend).score_ids(vids, toks)
    np.testing.assert_array_equal(got[:2], [0.0, 0.0])


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_pool_bitwise_vs_serial_and_reference(corpora, serial, workers):
    """Rows sharded over 1, 2 and 4 forkserver workers (13 rows: shard
    remainders) concatenate back to the serial scores, which are the
    reference's; the weighted tables cross the process boundary too."""
    pds, jds, vocab = corpora
    vids, toks = make_rows(pds, vocab, 13)
    want = jrewards.CiderDRewarder(jds, backend="python").score_ids(vids, toks)
    np.testing.assert_array_equal(serial.score_ids(vids, toks), want)
    weighted = CiderDRewarder(pds, backend="python", weighted_refs=True)
    wwant = jrewards.CiderDRewarder(jds, backend="python",
                                    weighted_refs=True).score_ids(vids, toks)
    with RewardPool(serial, workers) as pool, \
            RewardPool(weighted, workers) as wpool:
        assert pool.backend == f"python-pool{workers}"
        np.testing.assert_array_equal(pool.score_ids(vids, toks), want)
        np.testing.assert_array_equal(wpool.score_ids(vids, toks), wwant)


def test_stream_keeps_feed_order(corpora, serial, pool2):
    """Uneven streamed chunks come back in feed order, from the pool and
    from the serial rewarder's eager stream."""
    pds, _, vocab = corpora
    vids, toks = make_rows(pds, vocab, 11)
    want = serial.score_ids(vids, toks)
    for scorer in (pool2, serial):
        st = scorer.stream()
        for lo, hi in ((0, 3), (3, 4), (4, 11)):
            st.feed(vids[lo:hi], toks[lo:hi])
        np.testing.assert_array_equal(st.finish(), want)
    assert serial.stream().finish().shape == (0,)


def test_submit_matches_sync(corpora, serial, pool2):
    pds, _, vocab = corpora
    vids, toks = make_rows(pds, vocab, 7)
    want = serial.score_ids(vids, toks)
    handles = [pool2.submit(vids, toks) for _ in range(3)]
    for h in handles:
        np.testing.assert_array_equal(h.wait(), want)
    np.testing.assert_array_equal(serial.submit(vids, toks).wait(), want)
    np.testing.assert_array_equal(pool2.gt_consensus(), serial.gt_consensus())
    out = pool2.score_ids(np.zeros((0,), np.int32), np.zeros((0, 9), np.int32))
    assert out.shape == (0,) and out.dtype == np.float32


def test_make_reward_scorer_gating(corpora, serial):
    """The pool only for the Python backend with more than one worker;
    the native scorer is threaded already."""
    assert make_reward_scorer(serial, 0) is serial
    assert make_reward_scorer(serial, 1) is serial
    nat = CiderDRewarder(corpora[0], backend="native")
    assert make_reward_scorer(nat, 8) is nat
    scorer = make_reward_scorer(serial, 2)
    try:
        assert isinstance(scorer, RewardPool) and scorer.num_workers == 2
    finally:
        scorer.close()


def test_backend_refusals(corpora, serial):
    pds = corpora[0]
    with pytest.raises(ValueError, match="backend"):
        CiderDRewarder(pds, backend="gpu")
    with pytest.raises(native.NativeUnavailable):
        CiderDRewarder(pds, use_d=False, backend="native")
    assert CiderDRewarder(pds, use_d=False, backend="auto").backend == "python"
    with pytest.raises(ValueError, match="fork"):
        RewardPool(serial, 2, start_method="fork")


def test_worker_module_imports_no_torch():
    """Pool workers import ``metrics/reward_worker.py``: its chain never
    imports torch (a worker never touches the card) or the JAX package."""
    code = ("import sys, cst_captioning_torch.metrics.reward_worker; "
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.') or m == 'jax' or "
            "m.startswith('cst_captioning_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
