"""PTB-style tokenization, matching coco-caption's ``PTBTokenizer`` behavior.

The reference pipes every prediction and ground-truth caption through the
Stanford CoreNLP ``PTBTokenizer`` jar (``-preserveLines -lowerCase``) and then
drops a fixed punctuation list before scoring
(reference: coco-caption/pycocoevalcap/tokenizer/ptbtokenizer.py).  CIDEr is
tokenization-sensitive, so this re-implementation follows the same pipeline:

1. PTB tokenization (contraction splitting, punctuation isolation, bracket
   normalization) — implemented in pure Python below;
2. lowercasing;
3. removal of the exact ``PUNCTUATIONS`` list coco-caption uses.

Captions in MSR-VTT/MSVD are short, already-clean English sentences, so the
CoreNLP corner cases that matter here are contractions, punctuation and
brackets — all covered, with golden tests in ``tests/test_tokenizer.py``.
"""

from __future__ import annotations

import re
from typing import Dict, List

# The exact punctuation list coco-caption strips after tokenization.
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]
_PUNCT_SET = frozenset(PUNCTUATIONS)

# --- PTB tokenization rules (ordered) --------------------------------------
# A compact re-implementation of the classic Penn Treebank sed script /
# CoreNLP defaults, sufficient for caption text.

_RULES_PRE = [
    # directional quotes at start or after space -> ``
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"([ (\[{<])\""), r"\1 `` "),
    # separate out ellipses first so later dot rules don't break them
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"([,;:@#$%&])"), r" \1 "),
    # final period (possibly followed by closing quotes/brackets at end)
    (re.compile(r"([^.])(\.)([\]\)}>\"']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"([?!])"), r" \1 "),
    (re.compile(r"([\]\[(){}<>])"), r" \1 "),
    (re.compile(r"--"), r" -- "),
]

_RULES_QUOTES = [
    (re.compile(r"\""), r" '' "),
    (re.compile(r"(\S)('')"), r"\1 \2 "),
]

# Possessives and contractions (applied after quote handling).
_RULES_CONTRACTIONS = [
    (re.compile(r"([^' ])('[sSmMdD]|')\s"), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T)\s"), r"\1 \2 "),
    # Common irregular contractions.
    (re.compile(r"\b(can)(not)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(gon|wan)(na)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(got)(ta)\b", re.IGNORECASE), r"\1 \2"),
]

_BRACKETS = {
    "(": "-LRB-", ")": "-RRB-",
    "{": "-LCB-", "}": "-RCB-",
    "[": "-LSB-", "]": "-RSB-",
}


def ptb_word_tokenize(text: str) -> List[str]:
    """Tokenize one sentence with PTB rules (no lowercasing, no punct removal)."""
    s = " " + text + " "
    for pat, rep in _RULES_PRE:
        s = pat.sub(rep, s)
    for pat, rep in _RULES_QUOTES:
        s = pat.sub(rep, s)
    # pad so the contraction lookahead-space always exists
    s = s + " "
    for pat, rep in _RULES_CONTRACTIONS:
        s = pat.sub(rep, s)
    toks = s.split()
    return [_BRACKETS.get(t, t) for t in toks]


def ptb_tokenize(text: str) -> List[str]:
    """Full coco-caption pipeline for one caption: PTB + lowercase + strip punct."""
    return [t.lower() for t in ptb_word_tokenize(text) if t not in _PUNCT_SET]


def tokenize_corpus(captions: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Tokenize a {key: [caption, ...]} mapping into {key: ["tok tok ...", ...]}.

    Mirrors ``PTBTokenizer.tokenize`` which returns space-joined token strings.
    """
    return {
        k: [" ".join(ptb_tokenize(c)) for c in caps]
        for k, caps in captions.items()
    }
