"""METEOR jar-vs-lite parity harness for the port's scorer
(``metrics/meteor.py``): one command once a JRE and the jar are present.

The published captioning evaluation scores METEOR through
``meteor-1.5.jar`` (a Java subprocess); hosts without a JRE score it
with :class:`~cst_captioning_torch.metrics.meteor.MeteorLite`.  This
harness measures how far the two disagree:

    METEOR_JAR=/path/to/meteor-1.5.jar \\
    python -m cst_captioning_torch.tools.meteor_jar_diff [preds.json refs.json]

With no arguments it runs a built-in battery of caption-like segment
pairs spanning the matcher stages (exact, stem, synonym, function-word
weighting, fragmentation) plus degenerate cases; with two JSON files
({video_id: caption} and {video_id: [refs...]}) it diffs a real
prediction set.  Output: one JSON line with corpus scores from both
backends, per-segment |delta| stats, and the worst offenders — the
headline number is ``corpus_abs_delta``.  The line is key for key the
JAX package's tool's on the same inputs.

Exit codes: 0 = diff computed; 2 = blocked (no JRE or no jar), with the
blocked reason printed so automation can tell "parity unmeasured" from
"parity failed".
"""

from __future__ import annotations

import json
import shutil
import sys

import numpy as np

from cst_captioning_torch.metrics.meteor import (
    METEOR_JAR_ENV,
    MeteorJava,
    MeteorLite,
    _find_jar,
)

# Caption-like battery: (hypothesis, [references]).  Cases target the
# matcher stages where lite-vs-jar drift is plausible: stemming, the
# vendored synonym subset vs WordNet, function-word delta weighting,
# chunk fragmentation, and length extremes.
BATTERY = [
    ("a man is playing a guitar", ["a man plays the guitar"]),
    ("a woman is slicing vegetables",
     ["a lady cuts vegetables", "a woman is cutting some vegetables"]),
    ("kids are running in the park",
     ["children run through a park", "young children are jogging outside"]),
    ("a cat sits on the sofa", ["a kitten is sitting on a couch"]),
    ("someone is cooking food in a kitchen",
     ["a person prepares a meal", "a chef cooks food"]),
    ("the quick brown fox", ["the quick brown fox"]),
    ("completely unrelated words here", ["a man is swimming in a pool"]),
    ("a a a a a", ["a man is talking"]),
    ("man guitar", ["a man is playing a guitar loudly on a stage"]),
    ("a man is playing a guitar loudly on a stage at night",
     ["man guitar"]),
    ("a group of people are dancing", ["people dance together"]),
    ("a car is driving down the road fast",
     ["an automobile speeds down a street"]),
]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    jar = _find_jar()
    if jar is None:
        reason = (
            "no JRE on PATH" if shutil.which("java") is None
            else f"no jar (set {METEOR_JAR_ENV})"
        )
        print(json.dumps({"blocked": reason}))
        return 2

    if len(argv) == 2:
        with open(argv[0]) as f:
            preds = json.load(f)
        with open(argv[1]) as f:
            refs = json.load(f)
        gts = {k: list(refs[k]) for k in preds}
        res = {k: [preds[k]] for k in preds}
    else:
        gts = {f"seg{i}": r for i, (_, r) in enumerate(BATTERY)}
        res = {f"seg{i}": [h] for i, (h, _) in enumerate(BATTERY)}

    java = MeteorJava(jar)
    try:
        corpus_j, seg_j = java.compute_score(gts, res)
    finally:
        java.close()
    corpus_l, seg_l = MeteorLite.meteor15_en().compute_score(gts, res)

    delta = np.abs(seg_j - seg_l)
    keys = sorted(gts.keys(), key=str)
    worst = sorted(zip(delta, keys), reverse=True)[:5]
    print(json.dumps({
        "jar": jar,
        "segments": len(keys),
        "corpus_java": round(float(corpus_j), 6),
        "corpus_lite": round(float(corpus_l), 6),
        "corpus_abs_delta": round(abs(float(corpus_j - corpus_l)), 6),
        "seg_abs_delta_mean": round(float(delta.mean()), 6),
        "seg_abs_delta_max": round(float(delta.max()), 6),
        "worst_segments": [
            {"id": k, "delta": round(float(d), 6),
             "hyp": res[k][0], "refs": gts[k]}
            for d, k in worst
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
