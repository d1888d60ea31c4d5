"""Corpus BLEU-1..4, matching coco-caption's ``Bleu`` scorer semantics.

Reference: coco-caption/pycocoevalcap/bleu/ (bleu_scorer.py, option
"closest"): corpus-level clipped n-gram precision, geometric mean over
orders 1..n, brevity penalty from the closest reference length.  Returns
both corpus scores and per-segment scores (the per-segment score uses the
same formula on that segment's counts, as coco-caption does in
``compute_score``'s second return value).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + k]) for k in range(1, n + 1)
                   for i in range(len(tokens) - k + 1))


def _closest_ref_len(ref_lens: List[int], cand_len: int) -> int:
    return min(ref_lens, key=lambda r: (abs(r - cand_len), r))


class Bleu:
    """``compute_score(gts, res)`` -> ([Bleu_1..Bleu_n], [per-segment lists])."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[List[float], List[List[float]]]:
        assert gts.keys() == res.keys(), "gts/res key mismatch"
        n = self.n
        total_match = [0] * n
        total_count = [0] * n
        total_c = 0
        total_r = 0
        seg_scores: List[List[float]] = [[] for _ in range(n)]

        for k in sorted(gts.keys(), key=str):
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            hyp_counts = _ngram_counts(hyp, n)
            max_ref: Counter = Counter()
            for ref in refs:
                for ng, c in _ngram_counts(ref, n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            match = [0] * n
            count = [0] * n
            for ng, c in hyp_counts.items():
                order = len(ng) - 1
                count[order] += c
                match[order] += min(c, max_ref.get(ng, 0))
            c_len = len(hyp)
            r_len = _closest_ref_len([len(r) for r in refs], c_len)
            total_c += c_len
            total_r += r_len
            for i in range(n):
                total_match[i] += match[i]
                total_count[i] += count[i]
            # per-segment score: same tiny/small formula as the corpus level
            # (coco-caption's bleu_scorer uses no extra smoothing here either).
            seg_bp = 1.0 if c_len >= r_len else math.exp(1 - r_len / max(c_len, 1))
            logsum = 0.0
            for i in range(n):
                p = (match[i] + _TINY) / (count[i] + _SMALL)
                logsum += math.log(max(p, _TINY))
                seg_scores[i].append(seg_bp * math.exp(logsum / (i + 1)))

        bp = 1.0 if total_c >= total_r else math.exp(1 - total_r / max(total_c, 1))
        scores: List[float] = []
        logsum = 0.0
        for i in range(n):
            # tiny in the numerator, small in the denominator (as in
            # coco-caption's bleu_scorer): 0-count orders collapse to ~0.
            p = (total_match[i] + _TINY) / (total_count[i] + _SMALL)
            logsum += math.log(max(p, _TINY))
            scores.append(bp * math.exp(logsum / (i + 1)))
        return scores, seg_scores
