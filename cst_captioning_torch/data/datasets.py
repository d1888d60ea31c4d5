"""Dataset backends: in-memory, HDF5 (with packed feature directories),
labels in memory beside packed features (``PackedDataset``, no h5 file)
and a learnable synthetic corpus (the port's copy of the JAX package's
``data/datasets.py``).

A dataset object is one split; the vocabulary is shared across splits.
The synthetic backend draws the same seeded numpy streams as the
reference, so both packages build identical corpora.  ``H5Dataset``
reads the reference's on-disk layout and imports ``h5py`` only when it
is built.
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
    """HDF5-backed split, the reference's on-disk layout: one feature
    file per modality plus a label file.

    Schema (written by the JAX package's ``tools/prepare_data.py``):
      feature file ``<modality>.h5``: one dataset per video id, (F, D).
      label file: ``captions`` (total, T+2) int32; ``cap_start``/``cap_end``
      (V,) int64 index ranges per video; ``weights`` (total,) float32;
      ``category`` (V,) int32; ``video_ids`` (V,) utf-8 strings; plus a
      ``refs`` group: per-video raw reference strings for eval/rewards.

    Each modality's path is either a per-video feature h5 or a packed
    directory (``data/packed.py``).
    """

    def __init__(self, label_file: str, feature_files: Dict[str, str],
                 vocab: Vocabulary):
        from cst_captioning_torch.data.packed import is_packed_dir

        # Route every modality first: a remote store without fsspec is
        # refused before any file opens.
        packed = {m: is_packed_dir(p) for m, p in feature_files.items()}
        try:
            import h5py  # deferred: the h5 path only
        except ImportError as e:
            raise ImportError(
                "the h5 label reader (H5Dataset) needs h5py, which is not "
                "installed") from e

        self.vocab = vocab
        self._lab = h5py.File(label_file, "r")
        self._ids = [v.decode() if isinstance(v, bytes) else str(v)
                     for v in self._lab["video_ids"][()]]
        self._start = self._lab["cap_start"][()]
        self._end = self._lab["cap_end"][()]
        self._h5 = {m: h5py.File(p, "r") for m, p in feature_files.items()
                    if not packed[m]}
        self._packed, self._packed_remap = _open_packed(
            {m: p for m, p in feature_files.items() if packed[m]}, self._ids)
        self.feature_dims = {m: int(f[self._ids[0]].shape[-1])
                             for m, f in self._h5.items()}
        self.feature_dims.update({m: src.dim
                                  for m, src in self._packed.items()})

    def __len__(self) -> int:
        return len(self._ids)

    def video_id(self, idx: int) -> str:
        return self._ids[idx]

    def features(self, idx: int) -> Dict[str, np.ndarray]:
        vid = self._ids[idx]
        out = {m: f[vid][()].astype(np.float32) for m, f in self._h5.items()}
        for m, src in self._packed.items():
            out[m] = src.get(int(self._packed_remap[m][idx]))
        return out

    def features_batch(self, idxs: np.ndarray, max_frames: int):
        """Vectorized batch gather, offered when every modality is packed
        at ``max_frames`` frames: (feats {m: (B, F, D) stored dtype},
        masks {m: (B, F)}), else None (the loader then reads per video,
        whose uniform subsample stays exact)."""
        if self._h5:
            return None
        return _packed_batch(self._packed, self._packed_remap, idxs,
                             max_frames)

    def captions(self, idx: int) -> np.ndarray:
        return self._lab["captions"][self._start[idx]: self._end[idx]].astype(
            np.int32)

    def _stored_caption_weights(self, idx: int) -> np.ndarray:
        if "weights" not in self._lab:
            return super()._stored_caption_weights(idx)
        return self._lab["weights"][self._start[idx]: self._end[idx]].astype(
            np.float32)

    def category(self, idx: int) -> int:
        if "category" not in self._lab:
            return 0
        return int(self._lab["category"][idx])

    def references(self, idx: int) -> List[str]:
        refs = self._lab["refs"][self.video_id(idx)][()]
        return [r.decode() if isinstance(r, bytes) else str(r) for r in refs]

    def close(self) -> None:
        for f in self._h5.values():
            f.close()
        self._lab.close()


def _open_packed(feature_dirs: Dict[str, str], ids: Sequence[str]):
    """({modality: PackedSource}, {modality: (V,) int64 rows of ``ids``
    in its store}): a split's videos looked up by id in a packed store
    that may hold more videos than the split."""
    from cst_captioning_torch.data.packed import PackedSource

    srcs, remap = {}, {}
    for m, p in feature_dirs.items():
        src = PackedSource(p, m)
        order = {v: i for i, v in enumerate(src.video_ids)}
        missing = [v for v in ids if v not in order]
        if missing:
            raise ValueError(
                f"packed modality {m!r} at {p} is missing "
                f"{len(missing)} of this split's videos "
                f"(first: {missing[:3]})")
        srcs[m] = src
        remap[m] = np.asarray([order[v] for v in ids], np.int64)
    return srcs, remap


def _packed_batch(srcs, remap, idxs, max_frames: int):
    """One gather a modality, or None when a store's frame count is not
    ``max_frames`` (``H5Dataset.features_batch``)."""
    if not srcs or any(s.frames != max_frames for s in srcs.values()):
        return None
    feats, masks = {}, {}
    for m, src in srcs.items():
        feats[m], masks[m] = src.get_batch(remap[m][np.asarray(idxs)],
                                           max_frames)
    return feats, masks


class PackedDataset(CaptionDataset):
    """A split with its labels in memory and its features in packed
    directories (``data/packed.py``): the label h5's arrays without the
    h5 file, for a host without ``h5py``.

    ``captions`` (total, T+2) int32 caption rows, ``cap_start`` /
    ``cap_end`` (V,) each video's row range, ``weights`` (total,)
    float32 consensus weights (ones when None), ``categories`` (V,)
    (zeros when None), ``references`` one list of raw strings a video —
    what ``tools/prepare_data.py::split_labels`` returns and
    ``write_label_h5`` writes.  Each video is found by id in every
    modality's store, and ``features_batch`` is one gather a modality,
    as ``H5Dataset``'s over packed directories."""

    def __init__(
        self,
        vocab: Vocabulary,
        video_ids: Sequence[str],
        captions: np.ndarray,
        cap_start: np.ndarray,
        cap_end: np.ndarray,
        references: Sequence[List[str]],
        feature_dirs: Dict[str, str],
        weights: Optional[np.ndarray] = None,
        categories: Optional[np.ndarray] = None,
    ):
        from cst_captioning_torch.data.packed import is_packed_dir

        not_packed = [p for p in feature_dirs.values()
                      if not is_packed_dir(p)]
        if not_packed:
            raise ValueError(f"PackedDataset reads packed directories only; "
                             f"not packed: {not_packed}")
        self.vocab = vocab
        self._ids = list(video_ids)
        n = len(self._ids)
        self._caps = np.asarray(captions, np.int32)
        self._start = np.asarray(cap_start, np.int64)
        self._end = np.asarray(cap_end, np.int64)
        self._refs = [list(r) for r in references]
        self._weights = (None if weights is None
                         else np.asarray(weights, np.float32))
        self._cats = (np.zeros((n,), np.int32) if categories is None
                      else np.asarray(categories, np.int32))
        if not (len(self._start) == len(self._end) == len(self._refs)
                == len(self._cats) == n):
            raise ValueError("PackedDataset: per-video arrays disagree on "
                             f"the video count {n}")
        self._packed, self._remap = _open_packed(feature_dirs, self._ids)
        self.feature_dims = {m: src.dim for m, src in self._packed.items()}

    def __len__(self) -> int:
        return len(self._ids)

    def video_id(self, idx: int) -> str:
        return self._ids[idx]

    def features(self, idx: int) -> Dict[str, np.ndarray]:
        return {m: src.get(int(self._remap[m][idx]))
                for m, src in self._packed.items()}

    def features_batch(self, idxs: np.ndarray, max_frames: int):
        return _packed_batch(self._packed, self._remap, idxs, max_frames)

    def captions(self, idx: int) -> np.ndarray:
        return self._caps[self._start[idx]: self._end[idx]]

    def _stored_caption_weights(self, idx: int) -> np.ndarray:
        if self._weights is None:
            return super()._stored_caption_weights(idx)
        return self._weights[self._start[idx]: self._end[idx]]

    def category(self, idx: int) -> int:
        return int(self._cats[idx])

    def references(self, idx: int) -> List[str]:
        return self._refs[idx]


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
