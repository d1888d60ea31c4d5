"""Metric-suite orchestration — the reference's ``COCOEvalCap`` +
``language_eval`` (test.py / train.py validation hook), rebuilt without the
pycocotools dependency.

``language_eval(gts, res)`` takes raw (untokenized) caption dicts, runs the
PTB tokenization pipeline once, then every requested scorer, and returns a
flat ``{metric: value}`` dict, e.g. ``{"Bleu_4": .., "METEOR": ..,
"ROUGE_L": .., "CIDEr": ..}`` exactly as the reference writes into its
scores json.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from cst_captioning_torch.metrics.bleu import Bleu
from cst_captioning_torch.metrics.cider import Cider, CiderD
from cst_captioning_torch.metrics.meteor import Meteor
from cst_captioning_torch.metrics.rouge import Rouge
from cst_captioning_torch.metrics.tokenizer import tokenize_corpus

DEFAULT_METRICS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                   "METEOR", "ROUGE_L", "CIDEr"]

# One shared Meteor instance: the Java backend holds a subprocess with a 2G
# heap, so per-call construction would leak a JVM per evaluation.
_METEOR: Meteor | None = None


def get_meteor() -> Meteor:
    global _METEOR
    if _METEOR is None:
        _METEOR = Meteor()
    return _METEOR


def meteor_backend_name() -> str:
    """Which METEOR backend scored ("java" jar or pure-Python "lite")."""
    return get_meteor().backend_name


def language_eval(
    gts: Dict[str, List[str]],
    res: Dict[str, List[str]],
    metrics: Optional[List[str]] = None,
    tokenized: bool = False,
    cider_df: str = "corpus",
    include_ciderd: bool = False,
) -> Dict[str, float]:
    """Score predictions against references.

    gts: {video_id: [ref caption, ...]};  res: {video_id: [prediction]}.
    Keys must match.  Returns {metric_name: score}.
    """
    metrics = metrics or DEFAULT_METRICS
    if not tokenized:
        gts = tokenize_corpus(gts)
        res = tokenize_corpus(res)
    out: Dict[str, float] = {}

    if any(m.startswith("Bleu") for m in metrics):
        n = max(int(m.split("_")[1]) for m in metrics if m.startswith("Bleu"))
        scores, _ = Bleu(n=max(n, 4)).compute_score(gts, res)
        for m in metrics:
            if m.startswith("Bleu"):
                out[m] = scores[int(m.split("_")[1]) - 1]
    if "ROUGE_L" in metrics:
        out["ROUGE_L"], _ = Rouge().compute_score(gts, res)
    if "METEOR" in metrics:
        out["METEOR"], _ = get_meteor().compute_score(gts, res)
        # Record WHICH backend scored (java jar vs pure-Python lite) — a
        # scores.json is otherwise silent about the absolute-value shift
        # between them (SURVEY.md §7 hard part #3).
        out["METEOR_backend"] = meteor_backend_name()
    if "CIDEr" in metrics:
        out["CIDEr"], _ = Cider(df_mode=cider_df).compute_score(gts, res)
    if "CIDEr-D" in metrics or include_ciderd:
        out["CIDEr-D"], _ = CiderD(df_mode=cider_df).compute_score(gts, res)
    return out
