"""Vocabulary: word <-> id mapping, caption encode/decode.

Reference equivalents: vocab-building in the offline prep scripts (frequency
threshold + UNK replacement, SURVEY.md §3.4) and ``utils.py``'s
``decode_sequence`` (ids -> words, stopping at the end token).

Framework-wide token convention (models/captioner.py): 0=PAD, 1=BOS, 2=EOS,
3=UNK, real words from 4.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence

import numpy as np

from cst_captioning_torch.constants import (
    BOS_ID,
    EOS_ID,
    NUM_SPECIAL_TOKENS,
    PAD_ID,
    UNK_ID,
)

SPECIAL_TOKENS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocabulary:
    """Immutable word<->id table with encode/decode helpers."""

    def __init__(self, words: Sequence[str]):
        """``words``: the non-special vocabulary, in fixed order."""
        self.idx_to_word: List[str] = list(SPECIAL_TOKENS) + list(words)
        self.word_to_idx: Dict[str, int] = {
            w: i for i, w in enumerate(self.idx_to_word)
        }
        if len(self.word_to_idx) != len(self.idx_to_word):
            raise ValueError("duplicate words in vocabulary")

    def __len__(self) -> int:
        return len(self.idx_to_word)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_idx

    # ------------------------------------------------------------ building
    @classmethod
    def build(
        cls, tokenized_captions: Iterable[Sequence[str]], min_freq: int = 1
    ) -> "Vocabulary":
        """Frequency-thresholded vocab (reference prep: words below the
        threshold become UNK).  Order: descending frequency, then lexical —
        deterministic across runs."""
        counts = Counter()
        for caption in tokenized_captions:
            counts.update(caption)
        kept = [w for w, c in counts.items() if c >= min_freq]
        kept.sort(key=lambda w: (-counts[w], w))
        return cls(kept)

    # ------------------------------------------------------------ encoding
    def encode(self, tokens: Sequence[str], max_len: int) -> np.ndarray:
        """[BOS, w1..wn, EOS, PAD...] of length ``max_len + 2``; captions
        longer than ``max_len`` words are truncated."""
        ids = np.full((max_len + 2,), PAD_ID, np.int32)
        ids[0] = BOS_ID
        toks = list(tokens)[:max_len]
        for i, t in enumerate(toks):
            ids[1 + i] = self.word_to_idx.get(t, UNK_ID)
        ids[1 + len(toks)] = EOS_ID
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """ids -> sentence, stopping at PAD/EOS, skipping BOS.  Ids beyond
        the table (model.vocab_size padded above len(vocab) for TP-friendly
        shapes) decode as <unk> instead of crashing."""
        words = []
        n = len(self.idx_to_word)
        for i in ids:
            i = int(i)
            if i in (PAD_ID, EOS_ID):
                break
            if i == BOS_ID:
                continue
            words.append(self.idx_to_word[i] if 0 <= i < n else "<unk>")
        return " ".join(words)

    # ------------------------------------------------------------------ io
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"words": self.idx_to_word[NUM_SPECIAL_TOKENS:]}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls(json.load(f)["words"])


def decode_sequence(vocab: Vocabulary, seqs: np.ndarray) -> List[str]:
    """Batch ids (B, T) -> list of sentences (reference ``utils.py``
    ``decode_sequence``)."""
    return [vocab.decode(row) for row in np.asarray(seqs)]
