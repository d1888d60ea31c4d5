"""In-loop CIDEr-D reward scoring for CST — the host side (port of the
JAX package's ``training/rewards.py``).

* Scoring works on **token ids**: every video's references are
  vocab-encoded once at start, so n-grams are tuples of ints and the
  per-step ids -> string -> re-tokenize round trip is gone (id n-grams and
  word n-grams are in bijection under a fixed vocab, so scores equal
  string scoring).
* Reference n-gram vectors are cooked per video at start
  (``cook_refs_vec``); per step only the candidates are cooked.
* The C++ scorer (``native/``), built by g++ at first use, replaces the
  Python inner loop with the same results; a multiprocess pool
  (:class:`RewardPool`) shards the Python scorer's rows when the native
  one is not available.

The CST step (``training/cst.py``) reaches every scorer through one
surface: ``score_ids`` (blocking), ``submit`` (a :class:`PendingScores`
handle) and ``stream`` (a :class:`RewardStream` fed chunk by chunk).
"""

from __future__ import annotations

import atexit
import logging
import math
import multiprocessing
import pickle
from typing import List, Optional

import numpy as np

from cst_captioning_torch.constants import UNK_ID
from cst_captioning_torch.data.datasets import CaptionDataset
from cst_captioning_torch.metrics.cider import (
    _CiderBase,
    ciderd_score_rows,
    ciderd_score_vec,
    compute_doc_freq,
    cook_refs_vec,
    precook,
)
from cst_captioning_torch.metrics.reward_worker import (
    ids_until_end,
    pool_init,
    pool_score,
)
from cst_captioning_torch.metrics.tokenizer import ptb_tokenize

log = logging.getLogger("cst_captioning_torch.rewards")

BACKENDS = ("auto", "native", "python")


class CiderDRewarder:
    """CIDEr-D over token-id sequences with start-time cooked references."""

    def __init__(
        self,
        dataset: CaptionDataset,
        df_mode: str = "corpus",
        use_d: bool = True,
        backend: str = "auto",
        weighted_refs: bool = False,
    ):
        """``df_mode="corpus"``: document frequencies over this dataset's
        reference sets (the reference's train-corpus idf option);
        otherwise a path to a saved idf table, whose *string* n-grams are
        re-encoded through the vocab so they match id n-grams.

        ``backend``: "auto" builds the C++ scorer (``native/ciderd.cpp``)
        and falls back to Python when g++ or the packing bound does not
        allow it; "native" raises instead of falling back; "python" skips
        the native path.

        ``weighted_refs``: weight each reference's CIDEr-D contribution by
        the dataset's per-caption consensus weight (``caption_weights``) —
        the paper's weighted consensus reward ("20-ref weighted CIDEr").
        Videos whose weight count does not match their reference count
        fall back to the uniform mean."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown reward backend {backend!r}; expected "
                             f"one of {BACKENDS}")
        self.vocab = dataset.vocab
        self.use_d = use_d
        w2i = self.vocab.word_to_idx

        def encode_tokens(tokens: List[str]) -> List[int]:
            return [w2i.get(t, UNK_ID) for t in tokens]

        # Vocab-encode every video's references (tokenized like the metric
        # pipeline, so idf tables and eval tokenization agree).
        self._encoded_refs: List[List[List[int]]] = []
        self._cooked_refs = []
        self._ref_weights: Optional[List[Optional[np.ndarray]]] = (
            [] if weighted_refs else None)
        n_mismatch = 0
        for i in range(len(dataset)):
            refs = dataset.references(i)
            encoded = [encode_tokens(ptb_tokenize(r)) for r in refs]
            self._encoded_refs.append(encoded)
            self._cooked_refs.append([precook(e) for e in encoded])
            if weighted_refs:
                w = np.asarray(dataset.caption_weights(i), np.float32)
                if w.shape[0] == len(refs):
                    self._ref_weights.append(w)
                else:
                    self._ref_weights.append(None)
                    n_mismatch += 1
        if n_mismatch:
            log.warning(
                "weighted_refs: %d/%d videos have a caption-weight count "
                "that does not match their reference count — those score "
                "with the uniform mean", n_mismatch, len(dataset))

        if df_mode == "corpus":
            self.doc_freq = compute_doc_freq(self._cooked_refs)
            self.log_ref_len = math.log(float(max(len(dataset), 2)))
            self._df_external = None
        else:
            base = _CiderBase(df_mode=df_mode)
            # Re-key string n-grams to id n-grams.
            self.doc_freq = {}
            for ngram, df in base._df.items():
                key = tuple(w2i.get(w, UNK_ID) for w in ngram)
                # Collisions (via UNK) keep the max df — conservative idf.
                self.doc_freq[key] = max(df, self.doc_freq.get(key, 0.0))
            self.log_ref_len = base._log_ref_len
            self._df_external = self.doc_freq

        self._native = None
        self.backend = "python"
        if backend in ("auto", "native"):
            from cst_captioning_torch.native import NativeCiderD, NativeUnavailable

            try:
                if not use_d:
                    raise NativeUnavailable(
                        "plain CIDEr (use_d=False) has no native scorer")
                self._native = NativeCiderD(
                    self._encoded_refs,
                    df=self._df_external,
                    log_ref_len=self.log_ref_len,
                    vocab_size=len(self.vocab),
                    ref_weights=self._ref_weights,
                )
                self.backend = "native"
            except (NativeUnavailable, OSError) as e:
                if backend == "native":
                    raise
                log.info("native CiderD unavailable (%s); using the python "
                         "scorer", e)
        # Python tf-idf ref vectors: cooked only when scoring in Python
        # (the native finalize does the same cooking in C++).
        self._ref_vecs = (
            None if self._native is not None
            else [cook_refs_vec(refs, self.doc_freq, self.log_ref_len)
                  for refs in self._cooked_refs])

    def gt_consensus(self) -> np.ndarray:
        """(num_videos,) mean leave-one-out CIDEr-D of each video's GT
        captions, under this rewarder's df table, scale and reference
        weighting — in the units of ``score_ids`` rewards.  With
        ``weighted_refs`` each leave-one-out score weights the remaining
        siblings as ``score_ids`` weights them for rollouts.  Distinct
        from the dataset's ``caption_weights`` (normalized to mean 1 per
        video for the WXE loss, not reward units)."""
        if self._native is not None:
            return self._native.gt_consensus()
        out = np.zeros((len(self._cooked_refs),), np.float32)
        for i, cooked in enumerate(self._cooked_refs):
            if len(cooked) < 2:
                continue
            # Each reference's tf-idf vector is cooked once; every
            # leave-one-out score slices the vector list.
            vecs = cook_refs_vec(cooked, self.doc_freq, self.log_ref_len)
            w = None if self._ref_weights is None else self._ref_weights[i]
            scores = []
            for j, c in enumerate(cooked):
                loo_w = (None if w is None
                         else np.concatenate([w[:j], w[j + 1:]]))
                scores.append(ciderd_score_vec(
                    c, vecs[:j] + vecs[j + 1:], self.doc_freq,
                    self.log_ref_len, use_d=self.use_d, ref_weights=loo_w))
            out[i] = float(np.mean(scores))
        return out

    def score_ids(self, video_idx: np.ndarray,
                  token_ids: np.ndarray) -> np.ndarray:
        """(B,) video dataset indices + (B, L) sampled ids -> (B,) float32
        CIDEr-D scores (x10 scale, like the reference scorer)."""
        video_idx = np.asarray(video_idx)
        token_ids = np.asarray(token_ids)
        if self._native is not None:
            return self._native.score_ids(video_idx, token_ids)
        vids = [int(v) for v in video_idx]
        cands = [precook(ids_until_end(token_ids[b]))
                 for b in range(token_ids.shape[0])]
        return ciderd_score_rows(
            cands, [self._ref_vecs[v] for v in vids], self.doc_freq,
            self.log_ref_len, use_d=self.use_d,
            ref_weights_rows=(None if self._ref_weights is None
                              else [self._ref_weights[v] for v in vids]))

    # The asynchronous surface, eager here: the serial rewarder scores at
    # the call site; the RewardPool overlaps scoring with device work.
    def submit(self, video_idx, token_ids) -> "PendingScores":
        return PendingScores([self.score_ids(video_idx, token_ids)])

    def stream(self) -> "RewardStream":
        return RewardStream(self)


class PendingScores:
    """Handle for in-flight reward scoring.  ``wait()`` concatenates the
    per-shard results in submission order — the order the serial scorer
    produces — so asynchronous delivery cannot permute rows."""

    def __init__(self, parts: list):
        self._parts = parts

    def wait(self) -> np.ndarray:
        out = [p.get() if hasattr(p, "get") else p for p in self._parts]
        if not out:
            return np.zeros((0,), np.float32)
        return np.concatenate(out).astype(np.float32, copy=False)


class RewardStream:
    """Streaming scorer front end: ``feed()`` takes rollout token rows as
    they come off the device (chunk by chunk), ``finish()`` blocks once
    and returns the concatenated scores in feed order."""

    def __init__(self, scorer):
        self._scorer = scorer
        self._pending: List[PendingScores] = []

    def feed(self, video_idx, token_ids) -> None:
        self._pending.append(self._scorer.submit(video_idx, token_ids))

    def finish(self) -> np.ndarray:
        out = [p.wait() for p in self._pending]
        self._pending = []
        if not out:
            return np.zeros((0,), np.float32)
        return np.concatenate(out)


# ----------------------------------------------------- multiprocess pool

class RewardPool:
    """Persistent multiprocess CIDEr-D reward pool.

    Wraps a python-backend :class:`CiderDRewarder`: rollout rows are
    sharded contiguously across ``num_workers`` worker processes and the
    per-shard results concatenated in order — bit-identical to serial
    scoring, because rows are independent and the workers run the same
    :func:`~cst_captioning_torch.metrics.cider.ciderd_score_rows` loop.
    The corpus document-frequency table and the cooked reference sets
    are pickled to the workers once at pool start; per call only the
    token rows cross the process boundary.

    Workers start from a ``forkserver`` (``metrics/reward_worker.py``
    says why), never by forking the trainer, so none inherits its CUDA
    context.
    """

    def __init__(self, rewarder: CiderDRewarder, num_workers: int,
                 start_method: Optional[str] = None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._inner = rewarder
        self.num_workers = num_workers
        self.backend = f"python-pool{num_workers}"
        payload = pickle.dumps(
            {
                "cooked_refs": rewarder._cooked_refs,
                "doc_freq": dict(rewarder.doc_freq),
                "log_ref_len": rewarder.log_ref_len,
                "use_d": rewarder.use_d,
                "ref_weights": rewarder._ref_weights,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        if start_method is None:
            methods = multiprocessing.get_all_start_methods()
            start_method = "forkserver" if "forkserver" in methods else "spawn"
        if start_method == "fork":
            raise ValueError("a reward pool never forks the trainer: use "
                             "'forkserver' or 'spawn'")
        ctx = multiprocessing.get_context(start_method)
        self._pool = ctx.Pool(num_workers, initializer=pool_init,
                              initargs=(payload,))
        self._closed = False
        atexit.register(self.close)

    # ------------------------------------------------------------- scoring
    def _shards(self, video_idx, token_ids):
        n = token_ids.shape[0]
        k = min(self.num_workers, n)
        bounds = np.linspace(0, n, k + 1).round().astype(int)
        return [(video_idx[lo:hi], token_ids[lo:hi])
                for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]

    def submit(self, video_idx, token_ids) -> PendingScores:
        """Shard rows across the workers; returns at once."""
        video_idx = np.asarray(video_idx)
        token_ids = np.asarray(token_ids)
        return PendingScores([
            self._pool.apply_async(pool_score, (shard,))
            for shard in self._shards(video_idx, token_ids)])

    def score_ids(self, video_idx, token_ids) -> np.ndarray:
        return self.submit(video_idx, token_ids).wait()

    def stream(self) -> RewardStream:
        return RewardStream(self)

    def gt_consensus(self) -> np.ndarray:
        return self._inner.gt_consensus()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.terminate()
            self._pool.join()

    def __enter__(self) -> "RewardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_reward_scorer(rewarder: CiderDRewarder, num_workers: int):
    """Wrap ``rewarder`` in a :class:`RewardPool` when it would help:
    ``num_workers > 1`` and the Python backend.  The native C++ backend
    is already threaded, so pooling it would only add IPC."""
    if num_workers <= 1:
        return rewarder
    if rewarder.backend != "python":
        log.info("reward_workers=%d ignored: the %s scorer backend is "
                 "already parallel", num_workers, rewarder.backend)
        return rewarder
    return RewardPool(rewarder, num_workers)
