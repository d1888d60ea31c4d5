"""CIDEr and CIDEr-D, matching the reference's ``cider`` submodule.

Reference: cider/pyciderevalcap/ciderD/ciderD_scorer.py — n-gram (n=1..4)
TF-IDF vectors; IDF weight = log(N_refs) - log(max(df, 1)); CIDEr-D clips
candidate counts to reference counts, applies a Gaussian length penalty
(sigma=6) and scales by 10.  Document frequencies come either from the
evaluation corpus itself (``df_mode="corpus"``) or from a precomputed
dataset-level table (``df_mode=<path or dict>``), exactly like the
reference's "coco-val" pickle option.

Two front ends share the math:

* :class:`Cider` / :class:`CiderD` — string-based, coco-caption-compatible
  ``compute_score(gts, res)`` for evaluation.
* ``CiderDRewarder`` (the JAX package's ``training/rewards.py``; the
  port's CST slice) — the CST hot path over token-id arrays, which calls :func:`precook_ids` /
  :func:`ciderd_score_cooked` here (and has a C++ twin in ``native/``).
"""

from __future__ import annotations

import json
import math
import pickle
from collections import Counter, defaultdict
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

NGRAMS = 4
SIGMA = 6.0


# ----------------------------------------------------------------- cooking

def precook(words: Sequence[Hashable], n: int = NGRAMS) -> Counter:
    """n-gram counts for one sentence; works on word strings or token ids."""
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def precook_ids(ids: Sequence[int], n: int = NGRAMS) -> Counter:
    return precook(list(ids), n)


def compute_doc_freq(crefs: List[List[Counter]]) -> Dict[tuple, float]:
    """df[ngram] = number of videos whose reference set contains the ngram."""
    df: Dict[tuple, float] = defaultdict(float)
    for refs in crefs:
        for ngram in set(ng for ref in refs for ng in ref):
            df[ngram] += 1
    return df


# ------------------------------------------------------------------ scoring

def _counts2vec(cnts: Counter, doc_freq, log_ref_len: float):
    """TF-IDF vector per n-gram order + L2 norms + unigram length."""
    vec = [defaultdict(float) for _ in range(NGRAMS)]
    norm = [0.0] * NGRAMS
    length = 0
    for ngram, term_freq in cnts.items():
        df = math.log(max(1.0, doc_freq.get(ngram, 0.0)))
        n = len(ngram) - 1
        vec[n][ngram] = float(term_freq) * (log_ref_len - df)
        norm[n] += vec[n][ngram] ** 2
        if n == 0:
            length += term_freq
    return vec, [math.sqrt(x) for x in norm], length


def _sim_d(vec_h, vec_r, norm_h, norm_r, len_h, len_r) -> np.ndarray:
    """CIDEr-D similarity: count-clipped cosine + Gaussian length penalty."""
    delta = float(len_h - len_r)
    val = np.zeros(NGRAMS)
    for n in range(NGRAMS):
        for ngram, w in vec_h[n].items():
            val[n] += min(w, vec_r[n][ngram]) * vec_r[n][ngram]
        if norm_h[n] != 0 and norm_r[n] != 0:
            val[n] /= norm_h[n] * norm_r[n]
        val[n] *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
    return val


def _sim_plain(vec_h, vec_r, norm_h, norm_r) -> np.ndarray:
    """Plain CIDEr similarity: unclipped cosine, no length penalty."""
    val = np.zeros(NGRAMS)
    for n in range(NGRAMS):
        for ngram, w in vec_h[n].items():
            val[n] += w * vec_r[n][ngram]
        if norm_h[n] != 0 and norm_r[n] != 0:
            val[n] /= norm_h[n] * norm_r[n]
    return val


def cook_refs_vec(crefs: List[Counter], doc_freq, log_ref_len: float):
    """Pre-vectorize a reference set once (vec, norm, length per ref).

    The CST hot path scores ~cst_num_samples+1 candidates per video per
    step against the same references; vectorizing refs once per video at
    startup removes that factor from the host scorer.
    """
    return [_counts2vec(r, doc_freq, log_ref_len) for r in crefs]


def ciderd_score_vec(
    ctest: Counter,
    ref_vecs,
    doc_freq,
    log_ref_len: float,
    use_d: bool = True,
    ref_weights=None,
) -> float:
    """Score one cooked candidate against pre-vectorized refs. Scale x10.

    ``ref_weights``: optional per-reference weights (the paper's weighted
    consensus reward — each reference's similarity counts proportionally
    to its consensus score).  They are normalized to sum 1 here; ``None``
    is the uniform 1/N mean.
    """
    if not ref_vecs:  # no references registered: reward 0, not div-by-zero
        return 0.0
    vec, norm, length = _counts2vec(ctest, doc_freq, log_ref_len)
    score = np.zeros(NGRAMS)
    if ref_weights is None:
        w = np.full(len(ref_vecs), 1.0 / len(ref_vecs))
    else:
        w = np.asarray(ref_weights, np.float64)
        total = w.sum()
        w = w / total if total > 1e-12 else np.full_like(w, 1.0 / len(w))
    for w_r, (vec_r, norm_r, len_r) in zip(w, ref_vecs):
        if use_d:
            score += w_r * _sim_d(vec, vec_r, norm, norm_r, length, len_r)
        else:
            score += w_r * _sim_plain(vec, vec_r, norm, norm_r)
    return float(np.mean(score) * 10.0)


def ciderd_score_cooked(
    ctest: Counter,
    crefs: List[Counter],
    doc_freq,
    log_ref_len: float,
    use_d: bool = True,
) -> float:
    """Score one cooked candidate against cooked references. Scale x10."""
    ref_vecs = cook_refs_vec(crefs, doc_freq, log_ref_len)
    return ciderd_score_vec(ctest, ref_vecs, doc_freq, log_ref_len, use_d)


def ciderd_score_rows(
    cands: List[Counter],
    ref_vecs_rows: List[list],
    doc_freq,
    log_ref_len: float,
    use_d: bool = True,
    ref_weights_rows=None,
) -> np.ndarray:
    """Row-wise batch scoring: candidate ``i`` against ``ref_vecs_rows[i]``.

    This is the single inner loop shared by the serial
    ``CiderDRewarder`` and the ``RewardPool`` workers (the JAX package's
    ``training/rewards.py``) —
    rows are independent, so any contiguous sharding of this loop
    concatenates back to the exact serial result bit-for-bit (the parity
    contract the reward pool relies on, docs/PARITY.md).
    """
    out = np.zeros((len(cands),), np.float32)
    for i, cand in enumerate(cands):
        out[i] = ciderd_score_vec(
            cand,
            ref_vecs_rows[i],
            doc_freq,
            log_ref_len,
            use_d=use_d,
            ref_weights=(
                None if ref_weights_rows is None else ref_weights_rows[i]
            ),
        )
    return out


# ------------------------------------------------------- string-based API

class _CiderBase:
    use_d = True

    def __init__(self, df_mode: str = "corpus", df=None):
        """df_mode: "corpus", or a path to a pickle/json with
        {"document_frequency": {ngram: df}, "ref_len": log(N)}; or pass the
        dict directly via `df`."""
        self.df_mode = df_mode
        self._df = None
        self._log_ref_len = None
        if df is not None:
            self._load_df(df)
        elif df_mode != "corpus":
            with open(df_mode, "rb") as f:
                if df_mode.endswith(".json"):
                    self._load_df(json.load(f))
                else:
                    self._load_df(pickle.load(f))

    def _load_df(self, d):
        df = d["document_frequency"]
        # JSON round-trips tuple keys as strings; re-tuple them.
        if df and isinstance(next(iter(df)), str):
            df = {tuple(k.split("␟")): v for k, v in df.items()}
        self._df = df
        # Reference idf pickles store the RAW corpus size N; the log is
        # applied at load time (ciderD_scorer: ref_len = np.log(pkl['ref_len'])).
        self._log_ref_len = math.log(float(d["ref_len"]))

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys(), "gts/res key mismatch"
        keys = sorted(gts.keys(), key=str)
        crefs = [[precook(gts[k][i].split()) for i in range(len(gts[k]))] for k in keys]
        ctests = [precook(res[k][0].split()) for k in keys]
        if self.df_mode == "corpus" and self._df is None:
            doc_freq = compute_doc_freq(crefs)
            # max(N, 2): matches CiderDRewarder and avoids the degenerate
            # log(1)=0 idf scale on a 1-video corpus.
            log_ref_len = math.log(max(float(len(crefs)), 2.0))
        else:
            doc_freq, log_ref_len = self._df, self._log_ref_len
        scores = np.array([
            ciderd_score_cooked(ct, cr, doc_freq, log_ref_len, use_d=self.use_d)
            for ct, cr in zip(ctests, crefs)
        ])
        return float(np.mean(scores)), scores


class CiderD(_CiderBase):
    use_d = True


class Cider(_CiderBase):
    use_d = False


def save_df(gts: Dict[str, List[str]], path: str) -> None:
    """Precompute a dataset-level document-frequency table (the reference's
    CIDEr idf pickle, e.g. its "coco-val"/dataset idf option)."""
    crefs = [[precook(c.split()) for c in caps] for caps in gts.values()]
    df = compute_doc_freq(crefs)
    # Store RAW N (reference-pickle convention); loaders apply the log.
    payload = {"document_frequency": dict(df), "ref_len": float(len(crefs))}
    if path.endswith(".json"):
        payload["document_frequency"] = {
            "␟".join(k): v for k, v in payload["document_frequency"].items()
        }
        with open(path, "w") as f:
            json.dump(payload, f)
    else:
        with open(path, "wb") as f:
            pickle.dump(payload, f)
