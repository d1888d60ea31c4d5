"""METEOR scorer (the port's copy of the JAX package's
``metrics/meteor.py``; the scores are the same bit for bit).

The original coco-caption code scores METEOR through the Java
``meteor-1.5.jar`` subprocess.  This module provides:

* :class:`MeteorJava` — that subprocess path, used when a JRE and the
  jar (``METEOR_JAR``) are available;
* :class:`MeteorLite` — a pure-Python port of the METEOR algorithm with
  *exact*, *synonym* and *stem* (Porter) matchers, METEOR-1.5 English
  alpha/gamma (0.85/0.6) and the classic fragmentation exponent 3.0.
  Alignment is a beam search over one-to-one word alignments maximising
  (match count, weighted matches, -chunk count), the jar's own
  objective.  ``MeteorLite.meteor15_en()`` enables the tuned English
  configuration (alpha=0.85, beta=0.2, gamma=0.6, delta=0.75) with the
  vendored function-word list.

The synonym matcher loads the vendored caption-domain table
(``data/meteor_synonyms_en.json``, far smaller than WordNet) by default;
override it with the ``METEOR_SYNONYMS`` env var (a {word: [synonyms...]}
json), or set it to ``none`` to disable the stage.  Every
``language_eval`` result carries a ``METEOR_backend`` stamp so jar- and
lite-scored runs are never conflated.

:class:`Meteor` picks the best available backend.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from cst_captioning_torch.metrics.porter import porter_stem

ALPHA = 0.85
GAMMA = 0.6
# Fragmentation-penalty exponent: classic METEOR's 3.0 by default.
# METEOR 1.3/1.5's tuned English beta=0.2 belongs with the function-word
# (delta) weighting it was tuned alongside — the meteor15_en() preset
# enables both together (Denkowski & Lavie 2011/2014 English `rank`
# parameters: alpha=0.85, beta=0.2, gamma=0.6, delta=0.75).
FRAG_EXP = 3.0
# METEOR 1.3/1.5 en: content-word weight delta; function words weigh 1-delta.
DELTA_EN = 0.75
# Match-stage weights (METEOR 1.5 en defaults for exact / stem / synonym).
W_EXACT = 1.0
W_STEM = 0.6
W_SYN = 0.8

METEOR_SYNONYMS_ENV = "METEOR_SYNONYMS"
# Vendored caption-domain synonym table, loaded when the env var is unset.
DEFAULT_SYNONYMS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "data",
    "meteor_synonyms_en.json",
)
# Vendored English function-word list for the delta weighting.
DEFAULT_FUNCTION_WORDS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "data",
    "meteor_function_words_en.txt",
)


def load_function_words(path: str) -> frozenset:
    """One word per line; ``#`` comments (even indented) and blanks
    skipped — strip BEFORE the comment check so an indented comment line
    is never ingested as a function word."""
    with open(path) as f:
        stripped = (w.strip() for w in f)
        return frozenset(
            s for s in stripped if s and not s.startswith("#")
        )


def load_synonyms(path: str) -> Dict[str, frozenset]:
    """Load a {word: [synonym words...]} json into a symmetric lookup:
    word -> frozenset of words it may match at the synonym stage.
    Keys starting with ``_`` are metadata (e.g. ``_comment``), skipped."""
    with open(path) as f:
        raw = json.load(f)
    table: Dict[str, set] = {}
    for w, syns in raw.items():
        if w.startswith("_"):
            continue
        for s in syns:
            table.setdefault(w, set()).add(s)
            table.setdefault(s, set()).add(w)
    return {w: frozenset(s) for w, s in table.items()}


# ------------------------------------------------------------------ alignment

# Beam width for the alignment search.  On <=30-token captions with few
# duplicate words the beam is effectively exhaustive; the jar uses the
# same construction (beam search over one-to-one alignments).
ALIGN_BEAM = 64


def _pair_weight(hw, rw, hs, rs, synonyms) -> float:
    """Best matcher weight for a (hyp word, ref word) pair, or 0.
    Priority exact (1.0) > synonym (0.8) > stem (0.6) — a
    surface-identical pair is always an exact match, never a synonym one
    (per-pair max over matchers, the METEOR 1.3+ formulation)."""
    if hw == rw:
        return W_EXACT
    if synonyms is not None and rw in synonyms.get(hw, ()):
        return W_SYN
    if hs == rs:
        return W_STEM
    return 0.0


def _align(
    hyp: List[str],
    ref: List[str],
    synonyms: Optional[Dict[str, frozenset]] = None,
    beam: int = ALIGN_BEAM,
    word_weight=None,
) -> Tuple[float, float, int, int]:
    """Align hypothesis to one reference.

    Returns (weighted_matches_hyp, weighted_matches_ref, n_matches,
    n_chunks).  Beam search over one-to-one alignments, hyp position by
    hyp position; objective (lexicographic, the jar's): maximize match
    count, then total matcher weight, then MINIMIZE chunk count.  A
    chunk is a run of consecutive hyp positions mapped to consecutive
    ref positions; an unmatched hyp word breaks the run.

    ``word_weight``: optional word -> weight map (METEOR 1.3/1.5 delta:
    content words delta, function words 1-delta).  Each match's
    contribution to the hyp/ref side is the matcher weight times that
    SIDE's word weight; the alignment objective itself stays on the
    unweighted matcher sum, as in the jar.
    """
    hyp_stem = [porter_stem(w) for w in hyp]
    ref_stem = [porter_stem(w) for w in ref]
    cands: List[List[Tuple[int, float]]] = []
    for i, hw in enumerate(hyp):
        row = []
        for j, rw in enumerate(ref):
            w = _pair_weight(hw, rw, hyp_stem[i], ref_stem[j], synonyms)
            if w > 0.0:
                row.append((j, w))
        cands.append(row)

    def rank(v):
        m, ws, ch = v[:3]
        return (m, ws, -ch)

    # state: (used_ref_bitmask, last_matched_ref_j) ->
    #        (matches, wsum, chunks, wsum_hyp_side, wsum_ref_side)
    states = {(0, -2): (0, 0.0, 0, 0.0, 0.0)}
    for i in range(len(hyp)):
        new: Dict[Tuple[int, int], Tuple[int, float, int, float, float]] = {}

        def offer(key, val):
            old = new.get(key)
            if old is None or rank(val) > rank(old):
                new[key] = val

        hw_weight = 1.0 if word_weight is None else word_weight(hyp[i])
        for (mask, last_j), (m, ws, ch, wh, wr) in states.items():
            offer((mask, -2), (m, ws, ch, wh, wr))  # hyp[i] unmatched
            for j, w in cands[i]:
                if mask >> j & 1:
                    continue
                rw_weight = (
                    1.0 if word_weight is None else word_weight(ref[j])
                )
                offer(
                    (mask | (1 << j), j),
                    (
                        m + 1,
                        ws + w,
                        ch + (0 if j == last_j + 1 else 1),
                        wh + w * hw_weight,
                        wr + w * rw_weight,
                    ),
                )
        if len(new) > beam:
            new = dict(
                sorted(new.items(), key=lambda kv: rank(kv[1]),
                       reverse=True)[:beam]
            )
        states = new

    m, ws, ch, wh, wr = max(states.values(), key=rank)
    if m == 0:
        return 0.0, 0.0, 0, 0
    return wh, wr, m, ch


def _segment_stats(hyp: List[str], refs: List[List[str]], synonyms=None,
                   alpha=ALPHA, gamma=GAMMA, frag_exp=FRAG_EXP,
                   word_weight=None):
    """Best-reference METEOR statistics for one segment.  With
    ``word_weight``, P/R denominators are the summed word weights of the
    hyp/ref (METEOR 1.3/1.5 delta semantics) instead of plain lengths."""
    def total(words):
        if word_weight is None:
            return float(len(words))
        return float(sum(word_weight(w) for w in words))

    best = None
    lh = total(hyp)
    for ref in refs:
        wm_h, wm_r, m, ch = _align(hyp, ref, synonyms,
                                   word_weight=word_weight)
        lr = total(ref)
        p = wm_h / lh if lh else 0.0
        r = wm_r / lr if lr else 0.0
        score = _score_from(p, r, m, ch, alpha, gamma, frag_exp)
        stats = (wm_h, wm_r, m, ch, lh, lr, score)
        if best is None or score > best[6]:
            best = stats
    return best


def _score_from(p: float, r: float, matches: int, chunks: int,
                alpha=ALPHA, gamma=GAMMA, frag_exp=FRAG_EXP) -> float:
    if p == 0 or r == 0 or matches == 0:
        return 0.0
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    frag = chunks / matches
    penalty = gamma * (frag ** frag_exp)
    return fmean * (1.0 - penalty)


class MeteorLite:
    def __init__(
        self,
        synonym_file: Optional[str] = None,
        alpha: float = ALPHA,
        gamma: float = GAMMA,
        frag_exp: float = FRAG_EXP,
        delta: Optional[float] = None,
        function_words_file: Optional[str] = None,
    ):
        """``synonym_file`` resolution: explicit arg > ``METEOR_SYNONYMS``
        env var > vendored caption-domain table; the literal ``"none"``
        disables the synonym matcher.  The scoring constants are
        parameters so published worked examples under OTHER METEOR
        versions' constants can serve as external goldens.

        ``delta``: METEOR 1.3/1.5 function-word weighting — content
        words weigh ``delta``, function words (vendored English list, or
        ``function_words_file``) weigh ``1 - delta``, in both the match
        contributions and the P/R denominators.  None (default) keeps
        the unweighted classic behavior.  Use :meth:`meteor15_en` for
        the published English configuration."""
        synonym_file = (
            synonym_file
            or os.environ.get(METEOR_SYNONYMS_ENV, "")
            or (DEFAULT_SYNONYMS if os.path.exists(DEFAULT_SYNONYMS) else "")
        )
        if synonym_file == "none":
            synonym_file = ""
        self.synonyms = (
            load_synonyms(synonym_file) if synonym_file else None
        )
        self.alpha = alpha
        self.gamma = gamma
        self.frag_exp = frag_exp
        self.delta = delta
        self._word_weight = None
        if delta is not None:
            fw = load_function_words(
                function_words_file or DEFAULT_FUNCTION_WORDS
            )
            d = float(delta)

            def word_weight(w, _fw=fw, _d=d):
                return (1.0 - _d) if w in _fw else _d

            self._word_weight = word_weight

    @classmethod
    def meteor15_en(cls, **kw) -> "MeteorLite":
        """The METEOR 1.3/1.5 tuned English ``rank`` configuration
        (Denkowski & Lavie 2011 §4 / 2014): alpha=0.85, beta=0.2,
        gamma=0.6, delta=0.75, exact/stem/synonym weights 1.0/0.6/0.8
        (module defaults).  beta (the fragmentation exponent) and delta
        were tuned TOGETHER — enabling beta=0.2 without the
        function-word discount over-penalizes fragmentation."""
        kw.setdefault("alpha", 0.85)
        kw.setdefault("gamma", 0.6)
        kw.setdefault("frag_exp", 0.2)
        kw.setdefault("delta", DELTA_EN)
        return cls(**kw)

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys(), "gts/res key mismatch"
        keys = sorted(gts.keys(), key=str)
        seg_scores = []
        agg = np.zeros(6)
        for k in keys:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            wm_h, wm_r, m, ch, lh, lr, score = _segment_stats(
                hyp, refs, self.synonyms,
                self.alpha, self.gamma, self.frag_exp,
                word_weight=self._word_weight,
            )
            seg_scores.append(score)
            agg += np.array([wm_h, wm_r, m, ch, lh, lr])
        # Corpus score from aggregated statistics (as the jar's EVAL does).
        wm_h, wm_r, m, ch, lh, lr = agg
        p = wm_h / lh if lh else 0.0
        r = wm_r / lr if lr else 0.0
        corpus = _score_from(p, r, int(m), int(ch),
                             self.alpha, self.gamma, self.frag_exp)
        return float(corpus), np.array(seg_scores)


# ------------------------------------------------------------- java backend

METEOR_JAR_ENV = "METEOR_JAR"


class MeteorJava:
    """Reference-compatible wrapper around meteor-1.5.jar (stdin protocol)."""

    def __init__(self, jar: str):
        self.jar = jar
        self.lock = threading.Lock()
        self.proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1,
        )

    def compute_score(self, gts, res):
        keys = sorted(gts.keys(), key=str)
        with self.lock:
            eval_line = "EVAL"
            for k in keys:
                stat = self._stat(res[k][0], gts[k])
                eval_line += " ||| {}".format(stat)
            self.proc.stdin.write(eval_line + "\n")
            seg = [float(self.proc.stdout.readline().strip()) for _ in keys]
            final = float(self.proc.stdout.readline().strip())
        return final, np.array(seg)

    def _stat(self, hyp: str, refs: List[str]) -> str:
        hyp = hyp.replace("|||", "").replace("  ", " ")
        line = " ||| ".join(("SCORE", " ||| ".join(refs), hyp))
        self.proc.stdin.write(line + "\n")
        return self.proc.stdout.readline().strip()

    def close(self):
        with self.lock:
            if self.proc:
                self.proc.kill()
                self.proc = None


def _find_jar():
    jar = os.environ.get(METEOR_JAR_ENV, "")
    if jar and os.path.exists(jar) and shutil.which("java"):
        return jar
    return None


class Meteor:
    """Best-available METEOR: Java jar when present, else MeteorLite."""

    def __init__(self):
        jar = _find_jar()
        if jar:
            self.backend = MeteorJava(jar)
            self.backend_name = "java"
        else:
            lite = MeteorLite()
            self.backend = lite
            self.backend_name = "lite+syn" if lite.synonyms else "lite"

    def compute_score(self, gts, res):
        return self.backend.compute_score(gts, res)
