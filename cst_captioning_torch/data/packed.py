"""Packed contiguous feature storage (the port's copy of the JAX
package's ``data/packed.py``, local paths only).

One contiguous array per modality instead of one h5 dataset per video:

* layout: ``<dir>/<modality>.npy`` shaped (V, F, D), every video
  uniformly subsampled / zero-padded to F frames at pack time, plus
  ``<dir>/<modality>.meta.json`` ({"modality", "num_videos", "frames",
  "dim", "dtype", "frame_counts", "video_ids"});
* reads are fancy-indexed gathers from ``np.load(mmap_mode="r")``:
  assembling a (B, F, D) batch is one vectorized copy out of the page
  cache;
* ``dtype="float16"`` halves the bytes on disk and in flight.  Such a
  batch keeps the stored dtype up to the model, which casts it to its
  compute dtype (``CaptionModel._encode``).

``H5Dataset`` accepts a packed directory anywhere a feature h5 path is
expected (``data.feature_files``), and ``BatchIterator`` takes the
batched gather when every modality is packed
(``H5Dataset.features_batch``).  ``tools/pack_features.py`` converts
per-video h5s; :func:`pack_dataset` packs any ``CaptionDataset``.  The
files are byte for byte the JAX package's.

Remote stores (an fsspec URL, any path holding ``://``) are refused:
their ranged-read reader is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

REMOTE_ITEM = "Queue 1, item 2 (remote packed stores)"


def _refuse_remote(path: str) -> None:
    if "://" in path:
        from cst_captioning_torch.models.captioner import not_ported

        raise not_ported(f"the remote packed store {path}", REMOTE_ITEM)


def _meta_path(directory: str, modality: str) -> str:
    return os.path.join(directory, f"{modality}.meta.json")


def _arr_path(directory: str, modality: str) -> str:
    return os.path.join(directory, f"{modality}.npy")


def pack_modality(
    directory: str,
    modality: str,
    video_ids: List[str],
    frames_iter,
    max_frames: int,
    dim: int,
    dtype: str = "float32",
) -> str:
    """Write one modality's packed array.

    ``frames_iter`` yields one (F_i, D) array per video in ``video_ids``
    order; each is uniformly subsampled / zero-padded to ``max_frames``.
    Streams straight into the memmap: peak memory is one video."""
    from cst_captioning_torch.data.loader import subsample_frames

    _refuse_remote(directory)
    os.makedirs(directory, exist_ok=True)
    path = _arr_path(directory, modality)
    V = len(video_ids)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.dtype(dtype), shape=(V, max_frames, dim))
    counts = np.zeros((V,), np.int32)
    for i, frames in enumerate(frames_iter):
        fr = subsample_frames(np.asarray(frames), max_frames)
        out[i, : fr.shape[0]] = fr
        out[i, fr.shape[0]:] = 0
        counts[i] = fr.shape[0]
    out.flush()
    del out
    with open(_meta_path(directory, modality), "w") as f:
        json.dump({
            "modality": modality,
            "num_videos": V,
            "frames": max_frames,
            "dim": dim,
            "dtype": dtype,
            "frame_counts": counts.tolist(),
            "video_ids": video_ids,
        }, f)
    return path


def pack_dataset(
    ds,
    directory: str,
    max_frames: int,
    modalities: Sequence[str] = (),
    dtype: str = "float32",
) -> Dict[str, str]:
    """Pack every (or the named) modalities of a ``CaptionDataset``."""
    modalities = list(modalities) or list(ds.feature_dims)
    vids = [ds.video_id(i) for i in range(len(ds))]
    return {m: pack_modality(directory, m, vids,
                             (ds.features(i)[m] for i in range(len(ds))),
                             max_frames, int(ds.feature_dims[m]), dtype=dtype)
            for m in modalities}


class PackedSource:
    """Reader for one packed modality, memmap-backed (reads hit the OS
    page cache)."""

    def __init__(self, directory: str, modality: str):
        _refuse_remote(directory)
        with open(_meta_path(directory, modality)) as f:
            self.meta = json.load(f)
        self._arr = np.load(_arr_path(directory, modality), mmap_mode="r")
        self.modality = modality
        self.frames = int(self.meta["frames"])
        self.dim = int(self.meta["dim"])
        self.frame_counts = np.asarray(self.meta["frame_counts"], np.int32)
        self.video_ids = list(self.meta["video_ids"])
        want = (len(self.video_ids), self.frames, self.dim)
        if self._arr.shape != want:
            raise ValueError(f"{_arr_path(directory, modality)}: shape "
                             f"{self._arr.shape}, its meta says {want}")

    def get(self, idx: int) -> np.ndarray:
        """(F_i, D) float32, trimmed to the video's true frame count
        (the ``CaptionDataset.features`` contract)."""
        n = int(self.frame_counts[idx])
        return np.asarray(self._arr[idx][:n], np.float32)

    def get_batch(self, idxs: np.ndarray,
                  max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """One vectorized gather -> ((B, F, D) in the stored dtype, (B, F)
        float32 mask).  Requires ``max_frames`` equal to the packed frame
        count: a silent leading-frames crop would diverge from the
        per-video path's uniform subsample."""
        if max_frames != self.frames:
            raise ValueError(
                f"loader max_frames={max_frames} != packed frames="
                f"{self.frames} for modality {self.modality!r} — repack "
                "at the training max_frames")
        feats = self._arr[idxs]
        counts = np.minimum(self.frame_counts[idxs], max_frames)
        mask = (np.arange(max_frames)[None, :]
                < counts[:, None]).astype(np.float32)
        return feats, mask


def is_packed_dir(path: str) -> bool:
    """Whether ``path`` is a directory holding at least one
    ``*.meta.json`` packed modality (``H5Dataset``'s routing test)."""
    _refuse_remote(path)
    if not os.path.isdir(path):
        return False
    return any(n.endswith(".meta.json") for n in os.listdir(path))
