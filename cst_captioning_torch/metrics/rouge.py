"""ROUGE-L, matching coco-caption's ``Rouge`` scorer.

Reference: coco-caption/pycocoevalcap/rouge/rouge.py — LCS-based F-measure
with beta = 1.2, taking the max precision/recall over references per segment
and averaging segment scores over the corpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BETA = 1.2


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Length of the longest common subsequence (O(len(a)*len(b)))."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: Sequence[str], refs: List[Sequence[str]]) -> float:
    prec, rec = [], []
    for ref in refs:
        lcs = _lcs_len(hyp, ref)
        prec.append(lcs / len(hyp) if hyp else 0.0)
        rec.append(lcs / len(ref) if ref else 0.0)
    p, r = max(prec), max(rec)
    if p + r == 0:
        return 0.0
    return ((1 + BETA**2) * p * r) / (r + BETA**2 * p)


class Rouge:
    """``compute_score(gts, res)`` -> (mean ROUGE_L, per-segment array)."""

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys(), "gts/res key mismatch"
        scores = [
            rouge_l_sentence(res[k][0].split(), [r.split() for r in gts[k]])
            for k in sorted(gts.keys(), key=str)
        ]
        return float(np.mean(scores)), np.array(scores)
