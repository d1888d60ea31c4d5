"""Dataset backends: in-memory and a learnable synthetic corpus (the
port's copy of the JAX package's ``data/datasets.py``).

A dataset object is one split; the vocabulary is shared across splits.
The synthetic backend draws the same seeded numpy streams as the
reference, so both packages build identical corpora.  ``H5Dataset``
(and the packed feature layout behind it) is not ported: it needs
``h5py``, which the port does not depend on yet (ROADMAP.md Queue 1,
item 4).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cst_captioning_torch.data.vocab import Vocabulary


class CaptionDataset:
    """Interface: one split of a captioning dataset."""

    vocab: Vocabulary
    feature_dims: Dict[str, int]
    # Externally-supplied per-caption consensus weights (video_id -> (N,)),
    # e.g. from ``data.consensus_file`` — takes precedence over whatever
    # the backend stores (reference: precomputed WXE consensus scores
    # distributed separately from the label file).
    _weight_override: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        raise NotImplementedError

    def video_id(self, idx: int) -> str:
        raise NotImplementedError

    def features(self, idx: int) -> Dict[str, np.ndarray]:
        """modality -> (num_frames, dim) float32 (variable frame count)."""
        raise NotImplementedError

    def captions(self, idx: int) -> np.ndarray:
        """(num_captions, T+2) int32 encoded [BOS..EOS PAD...] rows."""
        raise NotImplementedError

    def set_caption_weights(self, weights: Dict[str, np.ndarray]) -> None:
        """Override consensus weights ({video_id: (num_captions,)})."""
        self._weight_override = {
            k: np.asarray(v, np.float32) for k, v in weights.items()
        }

    def caption_weights(self, idx: int) -> np.ndarray:
        """(num_captions,) float32 consensus weights (ones when absent)."""
        if self._weight_override is not None:
            w = self._weight_override.get(self.video_id(idx))
            if w is not None:
                return w
        return self._stored_caption_weights(idx)

    def _stored_caption_weights(self, idx: int) -> np.ndarray:
        return np.ones((self.captions(idx).shape[0],), np.float32)

    def category(self, idx: int) -> int:
        return 0

    def references(self, idx: int) -> List[str]:
        """Raw reference strings (for eval ground truth / CST rewards)."""
        raise NotImplementedError


class InMemoryDataset(CaptionDataset):
    def __init__(
        self,
        vocab: Vocabulary,
        video_ids: Sequence[str],
        features: Dict[str, List[np.ndarray]],
        captions: List[np.ndarray],
        references: List[List[str]],
        weights: Optional[List[np.ndarray]] = None,
        categories: Optional[Sequence[int]] = None,
    ):
        self.vocab = vocab
        self._ids = list(video_ids)
        self._feats = features
        self._caps = captions
        self._refs = references
        self._weights = weights
        self._cats = list(categories) if categories is not None else None
        self.feature_dims = {
            m: int(arrs[0].shape[-1]) for m, arrs in features.items()
        }
        n = len(self._ids)
        for m, arrs in features.items():
            assert len(arrs) == n, f"modality {m}: {len(arrs)} != {n} videos"
        assert len(captions) == n and len(references) == n

    def __len__(self) -> int:
        return len(self._ids)

    def video_id(self, idx: int) -> str:
        return self._ids[idx]

    def features(self, idx: int) -> Dict[str, np.ndarray]:
        return {m: arrs[idx] for m, arrs in self._feats.items()}

    def captions(self, idx: int) -> np.ndarray:
        return self._caps[idx]

    def _stored_caption_weights(self, idx: int) -> np.ndarray:
        if self._weights is None:
            return super()._stored_caption_weights(idx)
        return self._weights[idx]

    def category(self, idx: int) -> int:
        return self._cats[idx] if self._cats is not None else 0

    def references(self, idx: int) -> List[str]:
        return self._refs[idx]


class H5Dataset(CaptionDataset):
    """The reference's HDF5-backed split: not ported yet."""

    def __init__(self, label_file: str, feature_files: Dict[str, str],
                 vocab: Vocabulary):
        raise NotImplementedError(
            "H5Dataset (h5 and packed feature readers) is not ported to "
            "cst_captioning_torch yet (ROADMAP.md Queue 1, item 4 "
            "(data readers)); train from data.dataset=synthetic or an "
            "InMemoryDataset")


# --------------------------------------------------------------- synthetic

_SYNTH_NOUNS = [
    "cat", "dog", "man", "woman", "car", "ball", "bird", "horse", "child",
    "robot", "chef", "dancer", "player", "singer", "train",
]
_SYNTH_VERBS = [
    "runs", "jumps", "sings", "drives", "cooks", "plays", "walks", "flies",
    "dances", "sleeps",
]
_SYNTH_ADVS = ["quickly", "slowly", "happily", "loudly", "quietly", "gracefully"]


def make_synthetic_dataset(
    num_videos: int = 50,
    refs_per_video: int = 3,
    feature_dims: Optional[Dict[str, int]] = None,
    max_frames: int = 6,
    max_words: int = 10,
    noise: float = 0.1,
    num_categories: int = 0,
    seed: int = 0,
) -> Tuple[InMemoryDataset, Vocabulary]:
    """Learnable toy corpus.  Video ``i`` has a topic (noun, verb); its
    features are a fixed random embedding of the topic plus per-frame noise;
    its references are "<noun> <verb> [<adverb>]" with the adverb varying
    across references (so consensus scoring has real variance)."""
    feature_dims = feature_dims or {"resnet": 64}
    rng = np.random.RandomState(seed)
    topics = [
        (rng.randint(len(_SYNTH_NOUNS)), rng.randint(len(_SYNTH_VERBS)))
        for _ in range(num_videos)
    ]
    per_video_refs: List[List[str]] = []
    for n_i, v_i in topics:
        refs = []
        for r in range(refs_per_video):
            words = [_SYNTH_NOUNS[n_i], _SYNTH_VERBS[v_i]]
            if r > 0:
                words.append(_SYNTH_ADVS[(n_i + v_i + r) % len(_SYNTH_ADVS)])
            refs.append(" ".join(words))
        per_video_refs.append(refs)
    # Seed-INDEPENDENT vocabulary over the full synthetic word lists: any
    # split (train/val/test at different seeds) shares one id<->word table,
    # so decoding val predictions with the train vocab is always correct.
    vocab = Vocabulary(_SYNTH_NOUNS + _SYNTH_VERBS + _SYNTH_ADVS)

    # Topic embeddings from a seed-independent generator so every split
    # maps topic t to the same feature cluster.
    topic_rng = np.random.RandomState(20260729)
    topic_embed = {
        m: topic_rng.randn(len(_SYNTH_NOUNS) * len(_SYNTH_VERBS), d).astype(
            np.float32
        )
        for m, d in feature_dims.items()
    }
    feats: Dict[str, List[np.ndarray]] = {m: [] for m in feature_dims}
    caps: List[np.ndarray] = []
    for n_i, v_i in topics:
        t = n_i * len(_SYNTH_VERBS) + v_i
        nf = rng.randint(max_frames // 2 + 1, max_frames + 1)
        for m in feature_dims:
            base = topic_embed[m][t]
            frames = base[None, :] + noise * rng.randn(nf, base.shape[0]).astype(
                np.float32
            )
            feats[m].append(frames.astype(np.float32))
    for refs in per_video_refs:
        caps.append(
            np.stack([vocab.encode(r.split(), max_words) for r in refs])
        )
    cats = (
        [rng.randint(num_categories) for _ in range(num_videos)]
        if num_categories
        else None
    )
    ds = InMemoryDataset(
        vocab=vocab,
        video_ids=[f"video{i}" for i in range(num_videos)],
        features=feats,
        captions=caps,
        references=per_video_refs,
        categories=cats,
    )
    return ds, vocab
